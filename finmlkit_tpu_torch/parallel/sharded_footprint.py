"""Time-sharded footprints and the rolling volume profile over a process group.

Counterpart of ``finmlkit_tpu/parallel/sharded_footprint.py``:

- **footprints**: each rank adds its trades into partial ``(n_bars, L)``
  grids (float64 volumes and int32 tick counts of each side, the cells of
  ``bar/footprint.py comp_bar_footprints``); one all-reduce sums the partials,
  and ``footprint_features_from_tensors`` computes the features from them on
  every rank. The volumes and ticks are sums, so the dense grid is the carry.
- **rolling volume profile**: the bar axis is cut into contiguous slabs, one a
  rank; each rank runs kernel G (``feature/kernels/volume.py``) over its slab
  with the preceding bars as a halo, as deep as the longest window in bars
  (``sharded_footprint.py:197-215``); the warm-up rule stays the stream's: a
  slab's first window is not the stream's first. The footprints are on every
  rank already, so the halo is a slice.
"""
import numpy as np
import torch

from ..bar.footprint import (_tick, bar_levels, check_grid_fits,
                             footprint_features_from_tensors)
from ..feature.kernels.volume import _footprint_tensors, _rolling, _rolling_sizes
from ..ops.segment import bar_ids_from_close_indices
from .mesh import TimeMesh, all_reduce
from .sharded import TradeShard, gather_ragged

__all__ = ["sharded_bar_footprints", "sharded_volume_profile_rolling"]


def sharded_bar_footprints(trades: TradeShard, ci, bar_lows, bar_highs,
                           price_tick_size: float, imbalance_factor: float, mesh: TimeMesh,
                           max_levels: int | None = None) -> dict:
    """Dense footprints and their features across the ranks, as
    ``bar/footprint.py comp_bar_footprints`` gives them (the float64 level
    grid: each trade on ``round(price / tick)``).

    ``trades`` holds float64 ``price``, float32 ``amount`` and int8 ``side``
    (``shard_trades``); ``ci`` the global close indices; ``bar_lows`` and
    ``bar_highs`` each bar's price extrema (the products'). ``max_levels``
    defaults to the bars' largest level count. A bar whose levels leave int32
    raises ``ValueError``, as the single-device grid does (ROADMAP R16; the
    JAX function casts ``round(x / tick)`` to int32 unchecked,
    ``sharded_footprint.py:86-87, 91``: R19). Each rank's partial grid is
    summed by one all-reduce of ``(n_bars, L, 2)`` float64 volumes and as
    many int32 counts; the tick counts are exact, the volumes float64 sums
    rounded to float32 once. Returns the features' dict on every rank."""
    dev = mesh.device
    ci = torch.as_tensor(np.asarray(ci.cpu() if torch.is_tensor(ci) else ci, np.int64),
                         device=dev)
    lows = torch.as_tensor(bar_lows, dtype=torch.float64).to(dev)
    highs = torch.as_tensor(bar_highs, dtype=torch.float64).to(dev)
    low, high = bar_levels(lows, highs, price_tick_size)
    n_levels = high - low + 1
    nb = ci.shape[0] - 1
    L = int(n_levels.max()) if max_levels is None and nb else int(max_levels or 1)
    check_grid_fits(nb, L, dev)
    px, amt, sides = trades["price"], trades["amount"], trades["side"]
    m = px.shape[0]
    # the bars in this rank's coordinates; trades outside every bar drop out
    ci_l = (ci - trades.lo).clamp(-1, max(m - 1, -1))
    vol = torch.zeros(2 * nb * L + 1, dtype=torch.float64, device=dev)
    cnt = torch.zeros(2 * nb * L + 1, dtype=torch.int32, device=dev)
    if m:
        bar_id, valid = bar_ids_from_close_indices(ci_l, m)
        tick = _tick(price_tick_size, dev)
        level = torch.round(px / tick).clamp(-2.0**62, 2.0**62).to(torch.int64)
        lvl = level - low[bar_id]
        is_sell = sides == -1
        keep = (valid & ((sides == 1) | is_sell) & (lvl >= 0) & (lvl < L)
                & (lvl < n_levels[bar_id]))
        cell = torch.where(keep, (bar_id * L + lvl) * 2 + is_sell, 2 * nb * L)
        vol.index_put_((cell,), amt.to(torch.float64), accumulate=True)
        cnt.index_add_(0, cell, torch.ones(m, dtype=torch.int32, device=dev))
    vol = all_reduce(mesh, vol[:-1], "sum").view(nb, L, 2).to(torch.float32)
    cnt = all_reduce(mesh, cnt[:-1], "sum").view(nb, L, 2)
    return footprint_features_from_tensors(
        low.to(torch.int32), n_levels.to(torch.int32), vol[..., 0].contiguous(),
        vol[..., 1].contiguous(), cnt[..., 0].contiguous(), cnt[..., 1].contiguous(),
        imbalance_factor)


def sharded_volume_profile_rolling(ts, low_level, n_levels, buy_dense, sell_dense,
                                   window_size_sec, mesh: TimeMesh, n_bins=None,
                                   va_pct: float = 68.34, max_levels: int | None = None):
    """Rolling POC, HVA, LVA (int32) and the share of volume above the POC
    (float64) of every bar's trailing window, with the bar axis cut into one
    slab a rank: ``volume_profile_rolling`` bit for bit. The footprints (the
    whole stream's, as :func:`sharded_bar_footprints` returns them on every
    rank) give each rank its slab and the halo of bars its first window
    reaches back to; kernel G runs over the slab from its first bar (or the
    stream's first full window, if later), and one gather of every slab's
    rows returns the profile on every rank."""
    dev = mesh.device
    ts, low, nlev, buy, sell = _footprint_tensors(ts, low_level, n_levels, buy_dense,
                                                  sell_dense, dev)
    n = ts.shape[0]
    if n == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z, z.clone(), z.clone(), torch.zeros(0, dtype=torch.float64, device=dev)
    start, first, m = _rolling_sizes(ts, low, nlev, buy.shape[1],
                                     int(window_size_sec * 1e9), max_levels)
    b0, b1 = mesh.span(n)
    out = [torch.zeros(0, dtype=torch.int32, device=dev)] * 3 + [
        torch.zeros(0, dtype=torch.float64, device=dev)]
    if b1 > b0:
        base = int(start[b0])                 # the halo: the first window's bars
        rows = slice(base, b1)
        got = _rolling(start[rows] - base, max(first, b0) - base, low[rows], nlev[rows],
                       buy[rows], sell[rows], m, n_bins, va_pct / 100.0)
        out = [x[b0 - base:] for x in got]
    pct = gather_ragged(mesh, out[3])
    poc, hva, lva = (gather_ragged(mesh, x) for x in out[:3])
    return poc, hva, lva, pct
