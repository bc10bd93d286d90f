"""Volume bars in integer units (``VolumeBarKit``): ``bar/indexers.py
volume_bar_indexer_q`` at the configuration's threshold, with the event scan
the kits take by default (read from ``bar/kit.py``'s signature)."""
import inspect

from finmlkit_tpu_torch.bar import kit
from finmlkit_tpu_torch.bar.indexers import volume_bar_indexer_q
from finmlkit_tpu_torch.ops import event_scan

_PLAIN = inspect.signature(kit.BarBuilderBase.__init__).parameters["plain"].default
SCAN = getattr(event_scan, "volume_scan_plain" if _PLAIN else "volume_scan")


def run(ctx, p):
    tr = ctx.trades
    _, ci = volume_bar_indexer_q(tr.timestamps, tr.units, float(p["threshold"]),
                                 tr.amount_scale, scan=SCAN)
    ctx.out["volume.ci"] = ci
