"""Segment operations over contiguous trade ranges (bars).

Counterpart of ``finmlkit_tpu/ops/segment.py``. Bar *i* covers trades
``(ci[i], ci[i+1]]``. Order statistics (medians, quantiles) come from one
``torch.sort`` of the composite key ``(bar_id << 32) | sortable_bits(value)``:
each bar's values then sit ascending at offset ``ci[i] - ci[0]``, and a
statistic is a gather at a closed-form position.
"""
from fractions import Fraction

import torch

from .prefix_scan import fast_cumsum

__all__ = ["bar_ids_from_close_indices", "sorted_segments",
           "segment_median_pair", "segment_quantile_pair",
           "segment_quantile_sorted"]

_LOW32 = 0xFFFFFFFF


def bar_ids_from_close_indices(ci: torch.Tensor, n_trades: int, *,
                               cumsum=fast_cumsum):
    """``(bar_id, valid)`` of every trade: int64 bar ids clipped to
    ``[0, n_bars)`` and the mask of trades inside some bar.

    The bar id is the prefix sum (``cumsum``, kernel S by default) of ones
    ADD-scattered at the bar-open positions ``ci[1:] + 1``: empty bars share
    an open position but still advance the id, and opens past the last trade
    drop out.
    """
    dev = ci.device
    nb = ci.shape[0] - 1
    marks = torch.zeros(n_trades + 1, dtype=torch.int32, device=dev)
    marks.index_add_(0, (ci[1:] + 1).clamp(0, n_trades),
                     torch.ones(nb, dtype=torch.int32, device=dev))
    bar_id = cumsum(marks[:n_trades]).clamp(0, nb - 1).to(torch.int64)
    idx = torch.arange(n_trades, device=dev)
    return bar_id, (idx > ci[0]) & (idx <= ci[-1])


def _sortable_bits(x32: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32) that orders as the floats do."""
    bits = x32.view(torch.int32).to(torch.int64) & _LOW32
    return torch.where(bits >> 31 == 1, ~bits & _LOW32, bits | 0x80000000)


def _from_sortable_bits(key: torch.Tensor) -> torch.Tensor:
    bits = torch.where(key >> 31 == 1, key & 0x7FFFFFFF, ~key & _LOW32)
    return bits.to(torch.int32).view(torch.float32)


def sorted_segments(values_f32: torch.Tensor, bar_id: torch.Tensor,
                    valid: torch.Tensor, n_bars: int) -> torch.Tensor:
    """float32 values reordered so that each bar's are contiguous, at offset
    ``ci[i] - ci[0]``, and ascending; trades outside every bar go last.
    One int64 sort."""
    bid = torch.where(valid, bar_id, torch.full_like(bar_id, n_bars))
    skey = torch.sort((bid << 32) | _sortable_bits(values_f32)).values
    return _from_sortable_bits(skey & _LOW32)


def segment_median_pair(sorted_vals, offsets, counts):
    """The two middle values of every bar (``np.median`` averages them).
    Empty bars read a clamped position, which callers mask."""
    n = sorted_vals.shape[0]
    lo = offsets + ((counts - 1).clamp(min=0) >> 1)
    hi = offsets + (counts.clamp(min=1) >> 1)
    return sorted_vals[lo.clamp(0, n - 1)], sorted_vals[hi.clamp(0, n - 1)]


def segment_quantile_pair(sorted_vals, offsets, counts, q: float):
    """Bracketing values and the integer position ``lo`` of a per-bar
    quantile. ``lo = floor(q * (c - 1))`` in exact integer arithmetic, with
    ``q`` as the rational ``qnum / qden`` of ``segment.py:153-160``."""
    fr = Fraction(q).limit_denominator(10**6)
    cm1 = counts.clamp(min=1) - 1
    lo = (cm1 * fr.numerator) // fr.denominator
    n = sorted_vals.shape[0]
    a = sorted_vals[(offsets + lo).clamp(0, n - 1)]
    b = sorted_vals[(offsets + torch.minimum(lo + 1, cm1)).clamp(0, n - 1)]
    return a, b, lo


def segment_quantile_sorted(sorted_vals, offsets, counts, q: float):
    """Per-bar linear-interpolation quantile (``np.percentile``'s default),
    in float64."""
    a, b, lo = segment_quantile_pair(sorted_vals, offsets, counts, q)
    pos = q * (counts.clamp(min=1) - 1).to(torch.float64)
    frac = pos - lo.to(torch.float64)
    return a.to(torch.float64) * (1.0 - frac) + b.to(torch.float64) * frac
