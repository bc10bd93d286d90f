"""Trade-size features: ``bar/aggregate_q.py bar_trade_size_features`` with
theta the bars' column the configuration names (their median trade size)."""
from finmlkit_tpu_torch.bar.aggregate_q import bar_trade_size_features


def run(ctx, p):
    tr = ctx.trades
    tsf = bar_trade_size_features(tr.units, tr.amounts, ctx.out["ci"],
                                  ctx.out[f"ohlcv.{p['theta']}"],
                                  theta_mult=float(p["theta_mult"]),
                                  amount_scale=tr.amount_scale)
    for k, v in tsf.items():
        ctx.out[f"trade_size.{k}"] = v
