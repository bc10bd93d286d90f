"""The readings that a cell's limits are set from: the numbers of
``judge.py`` for sound runs of the program on many seeds (the lower
readings), and for the control on a few (the upper ones).

    python3 benchmark/control.py --workload <name> --seeds 1,2,... --control-seeds 7,8,9

Sound: set-up as a run makes it, a warm pass and then the pass that is
judged, through the same steps as the window, against the reference. The
control: the reference computed one precision step below the
configuration's (``refbase.Precision(control=True)``) put in the program's
place, against the reference. One JSON line a reading, then a summary line:
the largest sound reading and the smallest control reading of each number.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness  # noqa: E402
import judge  # noqa: E402
import month as month_mod  # noqa: E402


def sound(cell, seed, device, n_trades=None) -> dict:
    """The numbers of one sound run of the program on ``seed``."""
    m, thr, ctx, _ = harness.set_up(cell, seed, device, n_trades)
    for _ in range(2):
        harness.run_pass(cell, ctx, device)
    got = ctx.out
    ctx.trades = None
    gc.collect()
    want, scales = harness.reference_outputs(cell, m, thr, device)
    return judge.compare(got, want, scales)


def control(cell, seed, device, n_trades=None) -> dict:
    """The numbers of the control on ``seed``."""
    m = month_mod.synthesize(cell.config["assumed"]["month"], seed, device, n_trades)
    thr = month_mod.thresholds(m, cell.config.get("settings", {}))
    got, _ = harness.reference_outputs(cell, m, thr, device, control=True)
    want, scales = harness.reference_outputs(cell, m, thr, device)
    return judge.compare(got, want, scales)


def readings(cell, seeds, control_seeds, device, n_trades=None, emit=print) -> dict:
    """Every reading, and the summary: ``{"sound": {number: largest},
    "control": {number: smallest}}``."""
    rows = {"sound": [], "control": []}
    for kind, fn, ss in (("sound", sound, seeds), ("control", control, control_seeds)):
        for s in ss:
            t = time.perf_counter()
            nums = fn(cell, s, device, n_trades)
            rows[kind].append(nums)
            emit(json.dumps({"workload": cell.name, "kind": kind, "seed": s, **nums,
                             "seconds": time.perf_counter() - t}))
    summary = {kind: {k: (max if kind == "sound" else min)(r.get(k, 0) for r in rows[kind])
                      for k in sorted({k for r in rows[kind] for k in r})}
               for kind in rows}
    emit(json.dumps({"workload": cell.name, "summary": summary, "limits": cell.limits}))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-trades", type=int, default=None)
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 3
    cell = harness.Cell(args.workload, harness.load_json(harness.SPEC))
    print(f"# card: {harness.card_line(args.device)}", flush=True)

    def ints(s):
        return [int(x) for x in s.split(",") if x]
    readings(cell, ints(args.seeds), ints(args.control_seeds), args.device, args.n_trades,
             emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
