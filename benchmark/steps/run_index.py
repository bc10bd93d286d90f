"""Tick run bars with an EMA threshold (``RunBarKit(mode="tick", ...)``):
``bar/indexers.py run_bar_indexer`` on the int8 sides, with the event scan
the kits take by default (read from ``bar/kit.py``'s signature)."""
import inspect

from finmlkit_tpu_torch.bar import kit
from finmlkit_tpu_torch.bar.indexers import run_bar_indexer
from finmlkit_tpu_torch.ops import event_scan

_PLAIN = inspect.signature(kit.BarBuilderBase.__init__).parameters["plain"].default
SCAN = getattr(event_scan, "info_scan_plain" if _PLAIN else "info_scan")


def run(ctx, p):
    if p["mode"] != "tick":
        raise ValueError(f"the step runs tick run bars, not {p['mode']!r}")
    tr = ctx.trades
    _, ci = run_bar_indexer(tr.timestamps, tr.sides, None,
                            expected_ticks_init=float(p["expected_ticks_init"]),
                            expected_rate_init=float(p["expected_rate_init"]),
                            alpha_ticks=float(p["alpha_ticks"]),
                            alpha_rate=float(p["alpha_rate"]), scan=SCAN)
    ctx.out["run.ci"] = ci
