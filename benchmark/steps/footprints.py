"""Footprints: ``bar/footprint_q.py bar_footprints`` on the bars' lows and
highs at the configuration's footprint tick and imbalance factor."""
from finmlkit_tpu_torch.bar.footprint_q import bar_footprints


def run(ctx, p):
    tr = ctx.trades
    fp = bar_footprints(tr.ticks, tr.amounts, ctx.out["ci"], tr.sides, ctx.aux["ohlcv"],
                        tick_size=tr.tick_size, price_tick_size=float(p["price_tick"]),
                        imbalance_factor=float(p["imbalance_factor"]))
    for k, v in fp.items():
        ctx.out[f"footprints.{k}"] = v
