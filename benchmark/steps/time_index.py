"""Time bars: ``bar/indexers.py time_bar_indexer`` on the resident
timestamps."""
from finmlkit_tpu_torch.bar.indexers import time_bar_indexer


def run(ctx, p):
    clock, ci = time_bar_indexer(ctx.trades.timestamps, float(p["interval_s"]),
                                 ts_first=ctx.ts_first, ts_last_i=ctx.ts_last)
    ctx.out["clock"], ctx.out["ci"] = clock, ci
    ctx.aux["bar_ts"] = clock[1:ci.shape[0]]
