"""Passes under ``torch.profiler``, reduced to the device's busy time, the
traced window, the device operations that took most time and the idle gaps
by the stage the host was in.

Each traced pass runs under a ``bench.pass`` label and each of its steps
under ``bench.stage.<stage>``; the window runs from the first pass's start
to the last one's end (each ends after a synchronize). The device is busy
where any kernel, copy or set runs (the union of their intervals; the
labels' own spans on the device are not work); an idle
gap is named by the stage whose label spans its midpoint on the host, or
``between passes``.
"""
import bisect
import time

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

PASS, STAGE = "bench.pass", "bench.stage."
TOP = 10


def traced_passes(run_pass, seconds: float, cuda: bool, min_passes: int = 3) -> dict:
    """Run ``run_pass(wrap)`` for ``seconds`` (at least ``min_passes``
    passes) under the profiler; returns :func:`summarize` of its events."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def wrap(stage):
        return record_function(STAGE + stage)

    with profile(activities=acts) as prof:
        t0, k = time.perf_counter(), 0
        while k < min_passes or time.perf_counter() - t0 < seconds:
            with record_function(PASS):
                run_pass(wrap)
            k += 1
    return summarize(prof.events(), cuda, k)


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events, cuda: bool, passes: int) -> dict:
    """``busy_s``, ``window_s``, ``passes``, ``device_ops`` and ``idle_gaps``
    (lists of ``[name, seconds]``, at most 10 each, largest first) of the
    profiler's events. On the CPU (the tests) the top-level ``aten`` calls
    stand in for the device's operations."""
    passes_iv, stages, dev = [], [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith("bench."):    # the labels' own spans on the device
                dev.append((_short(e.name), a, b))
        elif e.name == PASS:
            passes_iv.append((a, b))
        elif e.name.startswith(STAGE):
            stages.append((a, b, e.name[len(STAGE):]))
        elif not cuda and e.name.startswith("aten::") and e.cpu_parent is not None \
                and e.cpu_parent.name.startswith(STAGE):
            dev.append((e.name, a, b))
    if not passes_iv:
        return None
    w0, w1 = min(a for a, _ in passes_iv), max(b for _, b in passes_iv)
    ops = {}
    for name, a, b in dev:
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
    busy = _union([(max(a, w0), min(b, w1)) for _, a, b in dev if b > w0 and a < w1])
    busy_s = sum(b - a for a, b in busy) / 1e6
    stages.sort()
    starts = [s0 for s0, _, _ in stages]
    gaps, t = {}, w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            mid = (a + t) / 2
            k = bisect.bisect_right(starts, mid) - 1    # the stages follow one another
            name = stages[k][2] if k >= 0 and stages[k][1] >= mid else "between passes"
            gaps[name] = gaps.get(name, 0.0) + (a - t) / 1e6
        t = max(t, b)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e6, "passes": passes,
            "device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}
