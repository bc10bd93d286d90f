"""Sample weights: ``label/weights.py average_uniqueness`` and
``return_attribution`` of the labelled events."""
from finmlkit_tpu_torch.label.weights import average_uniqueness, return_attribution


def run(ctx, p):
    ev, touch = ctx.out["events"], ctx.out["labels.touch"]
    uniq, conc = average_uniqueness(ctx.aux["bar_ts"], ev, touch)
    ctx.out["weights.uniqueness"], ctx.out["weights.concurrency"] = uniq, conc
    ctx.out["weights.attribution"] = return_attribution(ev, touch, ctx.out["ohlcv.close"], conc)
