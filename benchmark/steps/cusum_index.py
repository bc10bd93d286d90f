"""CUSUM bars (``CUSUMBarKit``): ``bar/indexers.py cusum_bar_indexer`` with
the forward fill and the event scan the kits take by default (read from
``bar/kit.py``'s signature). As the kit, the step gives the indexer float64
prices, here the resident ticks over ``1 / tick`` (IEEE division, so bit for
bit the month's rounded prices), and a sigma column, one constant."""
import inspect

import torch

from finmlkit_tpu_torch.bar import kit
from finmlkit_tpu_torch.bar.indexers import cusum_bar_indexer
from finmlkit_tpu_torch.ops import event_scan, prefix_scan

_PLAIN = inspect.signature(kit.BarBuilderBase.__init__).parameters["plain"].default
SCAN = getattr(event_scan, "cusum_scan_plain" if _PLAIN else "cusum_scan")
FFILL = prefix_scan.fast_ffill_plain if _PLAIN else prefix_scan.fast_ffill


def run(ctx, p):
    tr = ctx.trades
    prices = tr.ticks.to(torch.float64) / (1.0 / tr.tick_size)
    sigma = torch.full_like(prices, float(p["sigma"]))
    _, ci, _ = cusum_bar_indexer(tr.timestamps, prices, sigma, float(p["sigma_floor"]),
                                 float(p["mult"]), ffill=FFILL, scan=SCAN)
    ctx.out["cusum.ci"] = ci
