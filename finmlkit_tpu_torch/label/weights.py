"""AFML ch. 4 sample weights: average uniqueness and return attribution.

Counterpart of ``finmlkit_tpu/label/weights.py``, with the float64 semantics of
its CPU path (``weights.py:69-74,103-113``) and no fixed point: the concurrency
is an int32 prefix sum of +1/-1 increments and the per-event window sums are
differences of float64 prefixes, both through kernel S
(``ops.prefix_scan.fast_cumsum``). A window sum is the difference of two
prefixes, so its rounding error scales with the prefix, not with the window.
"""
import torch

from ..ops.prefix_scan import fast_cumsum

__all__ = ["average_uniqueness", "return_attribution"]


def _concurrency(event_idxs, touch_idxs, n: int, cumsum):
    inc = torch.zeros(n + 1, dtype=torch.int32, device=event_idxs.device)
    ones = torch.ones(event_idxs.shape[0], dtype=torch.int32, device=inc.device)
    inc.index_add_(0, event_idxs, ones)
    inc.index_add_(0, touch_idxs + 1, -ones)
    return cumsum(inc)[:-1].to(torch.int16)


def _window_sums(values, event_idxs, touch_idxs, cumsum):
    p = torch.cat([torch.zeros(1, dtype=values.dtype, device=values.device),
                   cumsum(values)])
    return p[touch_idxs + 1] - p[event_idxs]


def average_uniqueness(timestamps, event_idxs, touch_idxs, *,
                       cumsum=fast_cumsum):
    """Uniqueness weights and concurrency (AFML ch. 4 p. 61).

    Returns ``(weights float64 per event, concurrency int16 per timestamp)``.
    ``cumsum`` defaults to kernel S.
    """
    if len(event_idxs) != len(touch_idxs):
        raise ValueError("Timestamps and lookahead indices must have the same length.")
    ev = event_idxs.to(torch.int64)
    tch = touch_idxs.to(torch.int64)
    conc = _concurrency(ev, tch, len(timestamps), cumsum)
    c64 = conc.to(torch.float64)
    inv = torch.where(conc > 0, 1.0 / c64, torch.zeros_like(c64))
    cnt = (tch - ev + 1).to(torch.float64)
    return _window_sums(inv, ev, tch, cumsum) / cnt, conc


def return_attribution(event_idxs, touch_idxs, close, concurrency,
                       normalize: bool = True, *, cumsum=fast_cumsum):
    """Return-attribution weights (AFML ch. 4 p. 68), float64 per event.

    ``cumsum`` defaults to kernel S.
    """
    ev = event_idxs.to(torch.int64)
    tch = touch_idxs.to(torch.int64)
    close = close.to(torch.float64)
    lr = torch.log(close[1:] / close[:-1])
    nan = torch.full_like(lr, float("nan"))
    log_rets = torch.cat([close.new_full((1,), float("nan")),
                          torch.where(close[:-1] != 0.0, lr, nan)])
    contrib = torch.where((concurrency > 0) & ~torch.isnan(log_rets),
                          log_rets / concurrency.clamp(min=1).to(torch.float64),
                          torch.zeros_like(log_rets))
    w = _window_sums(contrib, ev, tch, cumsum).abs()
    if normalize:
        s = float(w.sum())
        if s <= 0.0:
            raise ValueError("Sum of weights is zero or negative, cannot normalize.")
        w = w * (len(event_idxs) / s)
    return w
