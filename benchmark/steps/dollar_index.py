"""Dollar bars in integer units: ``bar/indexers.py dollar_bar_indexer_q``
at the month's dollar volume over the configuration's bar count."""
from finmlkit_tpu_torch.bar.indexers import dollar_bar_indexer_q


def run(ctx, p):
    tr = ctx.trades
    close_ts, ci = dollar_bar_indexer_q(tr.timestamps, tr.ticks, tr.units,
                                        ctx.thr["dollar"], tr.tick_size, tr.amount_scale)
    ctx.out["close_ts"], ctx.out["ci"] = close_ts, ci
    ctx.aux["bar_ts"] = close_ts[1:]
