"""Dense footprints from integer tick data.

Counterpart of ``finmlkit_tpu/bar/footprint_q.py`` and of the kit's
``build_footprints`` (``finmlkit_tpu/bar/kit.py:284-337``), with the
semantics of the f64 path (``finmlkit_tpu/bar/footprint.py``):

1. one launch of kernel C (``ops.prefix_scan.fast_cumsum_cols``) over the
   int32 ``(2, n)`` stack ``[bar-open marks, low-tick deltas at bar starts]``
   gives every trade its bar id and its bar's low tick;
2. the level grid ``(n_bars, L)``: float64 volume sums per cell, rounded to
   float32 once, and two int32 tick counters. The JAX ``_q`` path packs both
   counters into one int32 and is wrong from 2^15 trades of one side in a
   cell (ROADMAP fault R1); the port keeps two counters;
3. the features of ``bar/footprint.py``.

The volume sums are ``index_put_(..., accumulate=True)``: in trade order on a
CPU tensor, and on a CUDA tensor through PyTorch's sort-based accumulation,
whose result does not depend on the order in which the card runs its threads,
so that repeated runs, and the kernel and plain paths, agree bit for bit.
"""
import torch

from ..ops.prefix_scan import fast_cumsum_cols
from ..ops.scan import next_bucket
from .footprint import footprint_features_from_tensors

__all__ = ["comp_bar_footprints_q", "bar_footprints"]


def _fp_rows(ci, low_t, n: int):
    """int32 ``(2, n)``: ones at the bar opens ``ci[1:] + 1`` and the change
    of the bar low at each bar start ``ci[:-1] + 1``, ADD-scattered, so that
    their prefix sums are each trade's bar id and bar low. Empty bars share
    a start, and positions past the last trade are dropped.

    The JAX package clips a trailing empty bar's start onto trade n-1 and
    adds its low there (``footprint_q.py:24-26``), which moves trade n-1 to
    the wrong level of its bar (ROADMAP fault R6); the port drops it, as the
    f64 path's bar ids do.
    """
    dev = ci.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    opens = ci[1:] + 1
    starts = ci[:-1] + 1
    deltas = torch.diff(low_t, prepend=zero.reshape(1))
    rows = torch.zeros((2, n), dtype=torch.int32, device=dev)
    rows[0].index_add_(0, opens.clamp(0, n - 1), (opens < n).to(torch.int32))
    rows[1].index_add_(0, starts.clamp(0, n - 1),
                       torch.where(starts < n, deltas, zero))
    return rows


def comp_bar_footprints_q(price_ticks, amounts_f32, ci, sides, low_t, high_t,
                          imbalance_factor, *, max_levels: int,
                          cumsum_cols=fast_cumsum_cols):
    """Dense footprints and their features from integer ticks.

    ``price_ticks`` int32, ``amounts_f32`` float32 and ``sides`` int8 per
    trade; ``ci`` int64 close indices; ``low_t``/``high_t`` int32 per-bar tick
    extrema on the same grid as ``price_ticks``. ``max_levels`` must be at
    least ``max(high_t - low_t + 1)``. ``cumsum_cols`` defaults to kernel C.
    Returns the dict of :func:`footprint_features_from_tensors`.
    """
    dev = price_ticks.device
    n, nb, L = price_ticks.shape[0], ci.shape[0] - 1, int(max_levels)
    n_levels = high_t - low_t + 1
    P = cumsum_cols(_fp_rows(ci, low_t, n))
    bar_id = P[0].clamp(0, nb - 1).to(torch.int64)
    lvl = price_ticks - P[1]
    del P
    idx = torch.arange(n, device=dev)
    valid = (idx > ci[0]) & (idx <= ci[-1])
    is_sell = sides == -1
    keep = (valid & ((sides == 1) | is_sell) & (lvl >= 0) & (lvl < L)
            & (lvl < n_levels[bar_id]))
    # cell (bar, level, side) of every buy and sell; the rest go to slot 2*nb*L
    cell = (bar_id * L + lvl) * 2 + is_sell
    cell = torch.where(keep, cell, 2 * nb * L)
    del bar_id, lvl, idx, valid, is_sell, keep
    vol = torch.zeros(2 * nb * L + 1, dtype=torch.float64, device=dev)
    vol.index_put_((cell,), amounts_f32.to(torch.float64), accumulate=True)
    vol = vol[:-1].view(nb, L, 2).to(torch.float32)
    cnt = torch.zeros(2 * nb * L + 1, dtype=torch.int32, device=dev)
    cnt.index_add_(0, cell, torch.ones(n, dtype=torch.int32, device=dev))
    cnt = cnt[:-1].view(nb, L, 2)
    del cell
    return footprint_features_from_tensors(
        low_t, n_levels, vol[..., 0].contiguous(), vol[..., 1].contiguous(),
        cnt[..., 0].contiguous(), cnt[..., 1].contiguous(), imbalance_factor)


def bar_footprints(ticks, amounts_f32, ci, sides, ohlcv, *, tick_size,
                   price_tick_size=None, imbalance_factor: float = 3.0,
                   cumsum_cols=fast_cumsum_cols):
    """Dense footprints of every bar, as ``build_footprints`` of the kit
    computes them, as a dict of tensors.

    ``ticks`` are the int32 price ticks of ``tick_size`` (``interop``'s
    ``TradeTensors.ticks``); ``ohlcv`` is the dict of ``bar_products_final``,
    whose ``low``/``high`` give each bar's levels (empty bars take the
    close). The footprint grid ``price_tick_size`` (default ``tick_size``)
    must refine the quantization grid by an integer ratio; the JAX kit falls
    back to its f64 path otherwise, which the port does not have, so it
    raises. ``L = next_bucket(max n_levels, 8)`` from one device read.
    """
    if price_tick_size is None:
        price_tick_size = tick_size
    r = float(tick_size) / float(price_tick_size)
    if not (abs(r - round(r)) < 1e-9 and round(r) >= 1):
        raise ValueError(f"footprint tick {price_tick_size} does not refine the "
                         f"trade tick {tick_size} by an integer ratio")
    ratio = int(round(r))
    low_t = torch.round(ohlcv["low"] / price_tick_size).to(torch.int64)
    high_t = torch.round(ohlcv["high"] / price_tick_size).to(torch.int64)
    # every trade's tick is refined, also those outside every bar
    t_min, t_max, nl_max = (int(v) for v in torch.stack([
        torch.minimum(ticks.min().to(torch.int64) * ratio, low_t.min()),
        torch.maximum(ticks.max().to(torch.int64) * ratio, high_t.max()),
        (high_t - low_t + 1).max()]).cpu())
    if t_min < -2**31 or t_max >= 2**31:
        raise ValueError("footprint ticks overflow int32")
    max_levels = next_bucket(max(nl_max, 1), 8)
    return comp_bar_footprints_q(
        ticks * ratio, amounts_f32, ci, sides, low_t.to(torch.int32),
        high_t.to(torch.int32), imbalance_factor, max_levels=max_levels,
        cumsum_cols=cumsum_cols)
