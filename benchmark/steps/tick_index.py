"""Tick bars (``TickBarKit``): ``bar/indexers.py tick_bar_indexer``, a close
every ``ticks`` trades in closed form."""
from finmlkit_tpu_torch.bar.indexers import tick_bar_indexer


def run(ctx, p):
    _, ci = tick_bar_indexer(ctx.trades.timestamps, int(p["ticks"]))
    ctx.out["tick.ci"] = ci
