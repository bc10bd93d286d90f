"""Run one cell of the benchmark of ``finmlkit_tpu_torch`` once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the result
(JSON): ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or its per-layer ones with ``--trace 1``), ``device``,
``breakdown`` (traced runs) and ``checks`` (each number compared, with its
limit), which also end standard error. Without a card, or with fewer than
the cell asks for, it exits 3 and prints no result; if JAX or the JAX
package is loaded after the window, 4.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache of the program and of torch at a fixed place in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(HERE), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    import harness
    spec = harness.load_json(harness.SPEC)
    chips = harness.Cell(args.workload, spec).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    try:
        res = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               "cuda", T_START, spec=spec)
    except harness.ForbiddenImport as e:
        print(f"no result: {e}", file=sys.stderr)
        return 4
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
