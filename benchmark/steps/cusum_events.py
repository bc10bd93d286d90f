"""CUSUM events on the bars' closes: ``sampling/filters.py cusum_filter``
(a loop on the host, the closes read back first), then the events that
leave the labels room: those before bar ``max(n_bars - keep_last, n_bars //
2)``, or every 97th bar from bar 10 where none is left."""
import torch

from finmlkit_tpu_torch.sampling.filters import cusum_filter


def run(ctx, p):
    close = ctx.out["ohlcv.close"]
    nb = close.shape[0]
    ev = cusum_filter(close, [float(p["threshold"])])
    cut = max(nb - int(p["keep_last"]), nb // 2)
    ev = ev[ev < cut]
    if ev.shape[0] == 0:
        ev = torch.arange(10, cut, 97, device=close.device)
    ctx.out["events"] = ev
