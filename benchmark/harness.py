"""One run of one cell: set-up, the measured window of back-to-back passes,
the comparison with the plain reference, and the metrics.

Everything that belongs to one cell is found by name, so that a later cell
adds files and entries and edits none:

- ``BENCHMARK.json``'s workload entry names the configuration and the
  traffic mix;
- ``configs/<config>.json``: the month's draws (``assumed.month``), its grid
  and each step's settings (``settings.<step>``);
- ``workloads/<traffic>.json``: the pass, as steps by name, each with the
  stage it is timed under (and ``params`` that add to the configuration's
  settings), the warm passes and the traced seconds;
- ``steps/<step>.py``: the step's call into the program (``run(ctx, p)``);
- ``reference/<step>.py``: the step in plain PyTorch (``run(r, p)``);
- ``limits/<workload>.json``: the limit of each number ``judge.py`` compares;
- ``metrics/<metric>.py``: a reader ``read(run) -> number or None``;
- ``bytecounts/<stage>.py``: a stage's bytes, ``count(run)``, for its
  roofline.
"""
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from contextlib import nullcontext
from pathlib import Path

import torch

import judge
import month as month_mod
import peaks
from refbase import Precision, RefRun

BENCH_DIR = Path(__file__).resolve().parent
SPEC = BENCH_DIR.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "finmlkit_tpu")   # top-level module names
_MODULES = {}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def module(bench_dir: Path, kind: str, name: str):
    """``<bench_dir>/<kind>/<name>.py``, loaded once."""
    path = Path(bench_dir) / kind / f"{name}.py"
    key = str(path.resolve())
    if key not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
        spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}".replace(".", "_"),
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


class Cell:
    """A workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, name: str, spec: dict, bench_dir: Path = BENCH_DIR):
        entries = {w["name"]: w for w in spec["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in the benchmark; it has {sorted(entries)}")
        self.name, self.entry, self.bench_dir = name, entries[name], Path(bench_dir)
        self.config = load_json(self.bench_dir / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(self.bench_dir / "workloads" / f"{self.entry['traffic']}.json")
        self.limits = load_json(self.bench_dir / "limits" / f"{name}.json")["limits"]
        self.chips = int(self.entry["chips"])
        settings = self.config.get("settings", {})
        self.steps = [(s["step"], s.get("stage", s["step"]), s.get("clock", "device"),
                       {**settings.get(s["step"], {}), **s.get("params", {})})
                      for s in self.traffic["steps"]]
        self.metrics = {trace: [m for m in spec["end_to_end" if not trace else "per_layer"]
                                if name in m.get("workloads", [name])]
                        for trace in (False, True)}

    def step(self, name: str):
        return module(self.bench_dir, "steps", name)

    def reference(self, name: str):
        return module(self.bench_dir, "reference", name)


class PassContext:
    """What the program's steps read and write in one pass: the resident
    trades, the month's first and last timestamps, the thresholds, and the
    outputs by name (``out``, judged) and by step (``aux``)."""

    def __init__(self, trades, ts_first: int, ts_last: int, thr: dict):
        self.trades, self.ts_first, self.ts_last, self.thr = trades, ts_first, ts_last, thr
        self.out, self.aux = {}, {}


class Run:
    """What a metric reader reads: the run's counts, clocks and trace."""

    def __init__(self, cell: Cell, n_trades: int):
        self.cell, self.n_trades = cell, n_trades
        self.setup_s = None
        self.pass_s = []              # each pass of the window, host clock
        self.window_s = None
        self.peak_bytes = None        # over the window
        self.setup_peak_bytes = 0     # over set-up
        self.stage_s = {}             # stage -> seconds summed over the window's passes
        self.trace = None             # profile_trace.summarize of the traced passes
        self.outputs = {}             # the judged pass's outputs

    @property
    def passes(self) -> int:
        return len(self.pass_s)

    def stage_ms(self, stage: str):
        """A stage's mean milliseconds a pass over the window, or None."""
        if stage not in self.stage_s or not self.pass_s:
            return None
        return self.stage_s[stage] / self.passes * 1e3

    def count_bytes(self, stage: str) -> int:
        return module(self.cell.bench_dir, "bytecounts", stage).count(self)


def percentile(values, q: float) -> float:
    """The linear-interpolation percentile (numpy's default) of ``values``."""
    x = sorted(values)
    pos = q / 100.0 * (len(x) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(x) - 1)
    return x[lo] + (x[hi] - x[lo]) * (pos - lo)


def roofline_share(run: Run, stage: str) -> float | None:
    """A stage's bytes at the card's published bandwidth over its time, in %."""
    ms = run.stage_ms(stage)
    if not ms:
        return None
    return 100.0 * run.count_bytes(stage) / peaks.HBM_BYTES_PER_S / (ms / 1e3)


def run_pass(cell: Cell, ctx: PassContext, device, timer=None, wrap=None):
    """One pass of the cell's steps; returns after the card has finished.
    ``timer(stage, seconds)`` receives each step's time (CUDA events, or the
    host clock around a host step after a synchronize); ``wrap(stage)`` is a
    context around each step (the profiler's labels)."""
    ctx.out, ctx.aux = {}, {}
    cuda = torch.device(device).type == "cuda"
    for step, stage, clock, params in cell.steps:
        fn = cell.step(step).run
        with (wrap(stage) if wrap else nullcontext()):
            if timer is None:
                fn(ctx, params)
            elif clock == "host" or not cuda:
                sync(device)
                t0 = time.perf_counter()
                fn(ctx, params)
                timer(stage, time.perf_counter() - t0)
            else:
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fn(ctx, params)
                b.record()
                timer(stage, (a, b))
    sync(device)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_query(device):
    """``nvidia-smi`` started on the card's name and power limit (it runs
    beside the set-up), or None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    try:
        return subprocess.Popen(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        return e


def card_line(device, query=None) -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them
    (``query`` from :func:`card_query`, waited for here)."""
    if torch.device(device).type != "cuda":
        return "no card (cpu)"
    query = card_query(device) if query is None else query
    if isinstance(query, OSError):
        line = f"nvidia-smi failed: {query}"
    else:
        try:
            out = query.communicate(timeout=60)[0].strip()
        except subprocess.TimeoutExpired:
            query.kill()
            out = query.communicate()[0].strip() + " (timed out)"
        line = out.splitlines()[0] if out else "?"
    return f"{torch.cuda.get_device_name(0)}; nvidia-smi: {line}"


def set_up(cell: Cell, seed: int, device, n_trades=None):
    """The month from the seed, quantized and copied to the card as a kit's
    constructor does it: ``(month, thresholds, PassContext, seconds by
    part)``."""
    from finmlkit_tpu_torch import interop
    from finmlkit_tpu_torch.bar.quantize import quantize_trades
    t0 = time.perf_counter()
    m = month_mod.synthesize(cell.config["assumed"]["month"], seed, device, n_trades)
    thr = month_mod.thresholds(m, cell.config.get("settings", {}))
    t1 = time.perf_counter()
    q = quantize_trades(m.price, m.amount)
    if q is None:
        raise RuntimeError("the month's prices sit on no tick grid")
    t2 = time.perf_counter()
    trades = interop.from_numpy(q, None, m.side, m.amount, device, timestamps=m.ts)
    sync(device)
    del q
    times = {"month": t1 - t0, "quantize": t2 - t1, "copy": time.perf_counter() - t2}
    return m, thr, PassContext(trades, int(m.ts[0]), int(m.ts[-1]), thr), times


def reference_outputs(cell: Cell, m, thr: dict, device, control: bool = False):
    """The plain reference's outputs of the cell's pass, and its scales."""
    r = RefRun(m, cell.config["grid"], thr, device, Precision(control))
    for step, _, _, params in cell.steps:
        cell.reference(step).run(r, params)
    return r.out, r.aux.get("scales", {})


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, n_trades=None, log=print):
    """Set-up, the window and (with ``trace``) the traced passes; returns the
    ``Run`` and the month, with the judged pass's outputs in ``run.outputs``
    and the program's state freed."""
    t_import = time.perf_counter()
    m, thr, ctx, times = set_up(cell, seed, device, n_trades)
    run = Run(cell, m.n)
    t0 = time.perf_counter()
    for _ in range(int(cell.traffic.get("warm_passes", 2))):
        run_pass(cell, ctx, device)
    times["warm passes"] = time.perf_counter() - t0
    log("setup: start to set-up {:.3f} s, ".format(t_import - t_start)
        + ", ".join(f"{k} {v:.3f} s" for k, v in times.items()))
    gc.collect()
    sync(device)
    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t_start
    events = []

    def timer(stage, t):
        events.append((stage, t))

    t0 = time.perf_counter()
    while True:
        ctx.out = ctx.aux = None
        a = time.perf_counter()
        run_pass(cell, ctx, device, timer if trace else None)
        b = time.perf_counter()
        run.pass_s.append(b - a)
        for stage, t in events:
            s = t if isinstance(t, float) else t[0].elapsed_time(t[1]) / 1e3
            run.stage_s[stage] = run.stage_s.get(stage, 0.0) + s
        events.clear()
        if b - t0 >= seconds:
            break
    run.window_s = b - t0
    log(f"window: {run.passes} passes in {run.window_s:.3f} s; pass ms p5 "
        f"{percentile(run.pass_s, 5) * 1e3:.3f}, p50 {percentile(run.pass_s, 50) * 1e3:.3f}, "
        f"p95 {percentile(run.pass_s, 95) * 1e3:.3f}, max {max(run.pass_s) * 1e3:.3f}")
    run.peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    run.setup_peak_bytes = setup_peak
    run.outputs = ctx.out
    if trace:
        import profile_trace
        run.trace = profile_trace.traced_passes(
            lambda wrap: run_pass(cell, PassContext(ctx.trades, ctx.ts_first, ctx.ts_last, thr),
                                  device, wrap=wrap),
            float(cell.traffic.get("profile_seconds", 8.0)), cuda)
    ctx.trades = None
    del ctx
    gc.collect()
    return run, m, thr


def result(cell: Cell, run: Run, numbers: dict, correct: bool, trace: bool, device) -> dict:
    """The result line: the cell's metrics of this mode, the device, and the
    numbers compared with their limits (last)."""
    metrics = {}
    for m in cell.metrics[trace]:
        v = module(cell.bench_dir, "metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(max(run.peak_bytes, run.setup_peak_bytes))}
    out = {"correct": bool(correct), "attempted": run.passes, "failed": 0 if correct else 1,
           "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in numbers.items()}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             spec: dict | None = None, bench_dir: Path = BENCH_DIR, n_trades=None,
             log=None) -> dict:
    """One run of cell ``name``: its result line (a dict), or an exception.
    ``n_trades`` shrinks the month (the CPU tests); ``log`` takes lines for
    standard error."""
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    cell = Cell(name, load_json(SPEC) if spec is None else spec, bench_dir)
    query = card_query(device)
    run, m, thr = measure(cell, seed, seconds, trace, device, t_start, n_trades, log)
    log(f"card: {card_line(device, query)}")
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(f"modules of {bad} are loaded after the window")
    want, scales = reference_outputs(cell, m, thr, device)
    numbers = judge.compare(run.outputs, want, scales)
    correct = judge.verdict(numbers, cell.limits)
    res = result(cell, run, numbers, correct, trace, device)
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(f"modules of {bad} are loaded after the reference and the metrics")
    for k, v in res["checks"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    return res


class ForbiddenImport(RuntimeError):
    """JAX or the JAX package was loaded in the process that measures."""
