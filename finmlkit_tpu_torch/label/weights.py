"""AFML ch. 4 sample weights: average uniqueness, return attribution, time
decay and class balance.

Counterpart of ``finmlkit_tpu/label/weights.py``, with the float64 semantics of
its CPU path (``weights.py:69-74,103-113``) and no fixed point: the concurrency
is an int32 prefix sum of +1/-1 increments and the per-event window sums are
differences of float64 prefixes, both through kernel S
(``ops.prefix_scan.fast_cumsum``). A window sum is the difference of two
prefixes, so its rounding error scales with the prefix, not with the window.
The time decay takes its cumulative uniqueness from kernel S too; the class
sums are one masked ``torch.sum`` a class, so they add in the same order on
every run (no float atomics).
"""
import torch

from ..ops.prefix_scan import fast_cumsum
from ..utils import trace

__all__ = ["average_uniqueness", "return_attribution", "time_decay",
           "class_balance_weights"]


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


@trace.span("average_uniqueness")
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


@trace.span("return_attribution")
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
        s = trace.host_read(float, w.sum())
        if s <= 0.0:
            raise ValueError("Sum of weights is zero or negative, cannot normalize.")
        w = w * (len(event_idxs) / s)
    return w


def time_decay(avg_uniqueness, last_weight: float, *, cumsum=fast_cumsum):
    """Linear time decay over the cumulative uniqueness (AFML ch. 4 p. 70),
    float64 per event on the device of ``avg_uniqueness``.

    The newest event weighs 1 and the oldest ``last_weight``, in [-1, 1]; a
    negative ``last_weight`` sets the oldest share of the events to 0.
    ``cumsum`` defaults to kernel S.
    """
    if not -1.0 <= last_weight <= 1.0:
        raise ValueError("last_weight must lie in [-1, 1]")
    cum = cumsum(avg_uniqueness.to(torch.float64).contiguous())
    total = cum[-1]
    if trace.host_read(float, total) == 0.0:
        raise ValueError("The sum of all average uniqueness weights must be greater than 0.")
    one = torch.ones((), dtype=torch.float64, device=cum.device)
    if last_weight >= 0.0:
        slope = (one - last_weight) / total
    else:   # at -1 the slope is infinite and every weight NaN, as in the JAX package
        slope = one / ((last_weight + 1.0) * total)
    const = 1.0 - slope * total
    w = const + slope * cum
    if last_weight < 0.0:
        w = torch.clamp(w, min=0.0)
    return w


def class_balance_weights(labels, base_w):
    """Class-balance multipliers from the weighted class counts.

    ``labels`` (any integer dtype) and ``base_w`` are per event on one device.
    Each class weighs ``total / (n_classes * its sum)``, and 0 where its sum
    is not positive. Returns ``(unique_labels, class_weights, sum_w_class,
    final_weights)``: the sorted classes, and float64 tensors.
    """
    base = base_w.to(labels.device, torch.float64)
    uniq = torch.unique(labels, sorted=True)
    label_idx = torch.searchsorted(uniq, labels)
    zero = torch.zeros((), dtype=torch.float64, device=base.device)
    sum_w_class = torch.stack([torch.where(label_idx == k, base, zero).sum()
                               for k in range(len(uniq))])
    total = sum_w_class.sum()
    pos = sum_w_class > 0.0
    class_w = torch.where(pos, total / (len(uniq) * torch.where(pos, sum_w_class, 1.0)),
                          zero)
    return uniq, class_w, sum_w_class, base * class_w[label_idx]
