"""Tick imbalance bars at a fixed theta (``ImbalanceBarKit(mode="tick",
threshold=theta)``): ``bar/indexers.py imbalance_bar_indexer`` on the int8
sides, with the event scan the kits take by default (read from
``bar/kit.py``'s signature)."""
import inspect

from finmlkit_tpu_torch.bar import kit
from finmlkit_tpu_torch.bar.indexers import imbalance_bar_indexer
from finmlkit_tpu_torch.ops import event_scan

_PLAIN = inspect.signature(kit.BarBuilderBase.__init__).parameters["plain"].default
SCAN = getattr(event_scan, "info_scan_plain" if _PLAIN else "info_scan")


def run(ctx, p):
    if p["mode"] != "tick":
        raise ValueError(f"the step runs tick imbalance bars, not {p['mode']!r}")
    tr = ctx.trades
    _, ci = imbalance_bar_indexer(tr.timestamps, tr.sides, None, threshold=float(p["theta"]),
                                  scan=SCAN)
    ctx.out["imbalance.ci"] = ci
