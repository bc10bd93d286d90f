"""Trade-size features of every bar.

Counterpart of ``comp_bar_trade_size_features_q`` in
``finmlkit_tpu/bar/aggregate_q.py`` and of the kit's
``build_trade_size_features`` (``finmlkit_tpu/bar/kit.py:246-282``), with the
semantics of the f64 path (``comp_bar_trade_size_features`` in
``finmlkit_tpu/bar/aggregate.py``):

- one launch of kernel C (``ops.prefix_scan.fast_cumsum_cols``) over the int64
  ``(2, n)`` stack ``[amount units, block units]`` gives each bar's exact
  total and block volume as differences at the closes; a trade is a block
  trade when its float amount exceeds its bar's ``theta * theta_mult``,
  compared in float64 after a gather by bar id (the TPU forward-filled a
  float32 threshold by a rounding float32 prefix instead, to avoid gathers);
- the sum of squared amounts in float64 per bar (``torch.segment_reduce``
  over the bars' contiguous trades; the ``_q`` path sums float32), of the
  quantized amounts ``units * amount_scale``: the totals' basis, so that
  ``gini = 1 - sum(s^2) / V^2`` does not mix two roundings of the amounts
  (mixing them costs about 1e-7 * (1 - gini) absolute, a relative 1e-4 at
  a gini of 1e-3);
- the 95th percentile from the within-bar sort of ``ops/segment.py``;
- the finals in float64 on the device, returned as float32.
"""
import torch

from ..ops.prefix_scan import fast_cumsum, fast_cumsum_cols
from ..ops.segment import (bar_ids_from_close_indices, segment_quantile_sorted,
                           sorted_segments)

__all__ = ["comp_bar_trade_size_features_q", "bar_trade_size_features"]


def _range_sums(P, ci):
    """Per-bar sums over ``(ci[k], ci[k+1]]`` of each row of the inclusive
    prefix ``P`` (``aggregate_q.py _rsum``)."""
    n = P.shape[1]
    hi = P[:, ci[1:].clamp(0, n - 1)]
    lo = P[:, ci[:-1].clamp(0, n - 1)]
    return hi - torch.where(ci[:-1] >= 0, lo, torch.zeros_like(lo))


def comp_bar_trade_size_features_q(amount_units, amounts_f32, theta, ci,
                                   theta_mult, amount_scale, *,
                                   cumsum=fast_cumsum,
                                   cumsum_cols=fast_cumsum_cols):
    """Relative trade-size features per bar: ``mean_size_rel`` and
    ``size_95_rel`` (log1p of the mean and the 95th percentile over
    ``theta * theta_mult``), ``pct_block`` (share of the volume in block
    trades) and ``size_gini`` (``1 - sum(s^2) / V^2``), float32.

    ``amount_units`` int64 and ``amounts_f32`` float32 per trade; ``theta``
    float64 per bar, on the trades' device. NaN for empty bars and where
    ``theta == 0``; ``pct_block`` and ``size_gini`` also where the volume is
    0, and ``size_gini`` is 0 for single-trade bars. ``cumsum`` (bar ids,
    kernel S) and ``cumsum_cols`` (the unit sums, kernel C) select the
    kernels or their plain versions.
    """
    n, nb = amount_units.shape[0], ci.shape[0] - 1
    f64 = torch.float64
    thr = theta.to(f64) * float(theta_mult)
    bar_id, valid = bar_ids_from_close_indices(ci, n, cumsum=cumsum)
    amt = amounts_f32.to(f64)
    block = torch.where(amt > thr[bar_id], amount_units,
                        torch.zeros_like(amount_units))
    del amt
    total_u, block_u = _range_sums(
        cumsum_cols(torch.stack([amount_units, block])), ci)
    del block
    counts = ci[1:] - ci[:-1]
    asc = float(amount_scale)
    qamt = amount_units.to(f64) * asc
    # segments: the trades before bar 0, the bars, the trades after the last
    lengths = torch.cat([(ci[:1] + 1), counts, (n - 1 - ci[-1:])])
    sumsq = torch.segment_reduce(qamt * qamt, "sum", lengths=lengths)[1:-1]
    del qamt
    sorted_amt = sorted_segments(amounts_f32, bar_id, valid, nb)
    del bar_id, valid
    p95 = segment_quantile_sorted(sorted_amt, ci[:-1] - ci[0], counts, 0.95)

    nan = torch.full((nb,), float("nan"), dtype=f64, device=ci.device)
    total = total_u.to(f64) * asc
    mean = total / counts.clamp(min=1)
    base_nan = (counts == 0) | (theta == 0.0)
    safe_thr = torch.where(thr > 0, thr, 1.0)
    mean_size_rel = torch.where(base_nan, nan, torch.log1p(mean / safe_thr))
    size_95_rel = torch.where(base_nan, nan, torch.log1p(p95 / safe_thr))
    vol_nan = base_nan | (total_u == 0)
    safe_total = torch.where(total > 0, total, 1.0)
    pct_block = torch.where(vol_nan, nan, block_u.to(f64) * asc / safe_total)
    # a single trade gives exactly 0: sumsq and total * total are one product
    gini = torch.where(vol_nan, nan, 1.0 - sumsq / (safe_total * safe_total))
    return {
        "mean_size_rel": mean_size_rel.to(torch.float32),
        "size_95_rel": size_95_rel.to(torch.float32),
        "pct_block": pct_block.to(torch.float32),
        "size_gini": gini.to(torch.float32),
    }


def bar_trade_size_features(amount_units, amounts_f32, ci, theta, *,
                            theta_mult: float = 5.0, amount_scale,
                            cumsum=fast_cumsum, cumsum_cols=fast_cumsum_cols):
    """Trade-size features of every bar, as ``build_trade_size_features`` of
    the kit computes them, as a dict of float32 tensors.

    ``theta`` is one typical trade size or one per bar (a tensor or an array
    of ``n_bars`` values, e.g. ``ohlcv["median_trade_size"]``).
    """
    nb = ci.shape[0] - 1
    theta = torch.as_tensor(theta, dtype=torch.float64, device=ci.device)
    if theta.dim() == 0:
        theta = theta.expand(nb)
    if theta.shape != (nb,):
        raise ValueError("Theta should match the number of bars.")
    return comp_bar_trade_size_features_q(
        amount_units, amounts_f32, theta, ci, theta_mult, amount_scale,
        cumsum=cumsum, cumsum_cols=cumsum_cols)
