"""Dense footprints: the float64 level grid, and the per-bar order-flow
features of dense footprints.

Counterpart of ``finmlkit_tpu/bar/footprint.py``.

:func:`comp_bar_footprints` builds the grid of trades whose prices sit on no
tick grid, or whose footprint tick does not refine the trades' tick: every
trade's level is ``round(price / tick)``, its bar id kernel S's prefix of the
bar-open marks (``ops.segment.bar_ids_from_close_indices``), and the cells
are float64 volume sums rounded to float32 once and two int32 tick counters,
as ``bar/footprint_q.py`` keeps them (ROADMAP R1). Levels are int64; a bar
whose levels leave int32 raises, where the JAX function saturates its int32
cast and puts the bar's trades on one level (ROADMAP R16).

:func:`footprint_features_from_tensors` derives from the dense
``(n_bars, L)`` volume and tick-count grids, per bar:

- the diagonal imbalance flags: ``sell[l] > buy[l+1] * f`` flags level l,
  ``buy[l+1] > sell[l] * f`` flags level l+1, compared in float64 from the
  float32 volumes;
- the longest run of equal nonzero flag signs, signed, the first of equal
  runs winning; the JAX package scans the levels, the port takes the closed
  form of ``finmlkit_tpu/bar/footprint_q.py:75-90`` (a ``cummax`` of the last
  restart along the levels), which gives the same first maximal run;
- the level of most volume (first on ties), ``vp_skew`` (the first moment of
  the volume profile about its own volume-weighted mean, as the reference
  computes it) and ``vp_gini``, in float64 over absolute tick levels.
"""
import os

import torch

from ..ops.prefix_scan import fast_cumsum
from ..ops.segment import bar_ids_from_close_indices
from ..utils import trace

__all__ = ["comp_bar_footprints", "bar_levels", "footprint_features_from_tensors",
           "check_grid_fits"]

# bytes a cell of the (n_bars, L) grid takes at the peak of a build: the
# float64 and int32 cell sums of both sides, their float32 and int32 grids,
# and the features' float64 and boolean temporaries
GRID_CELL_BYTES = 96
_INT32 = (-2**31, 2**31 - 1)


def _free_bytes(device: torch.device) -> int:
    """Bytes a new allocation on ``device`` can take: the card's free memory
    and PyTorch's cached blocks, or the host's available memory."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


@trace.span("check_grid_fits")
def check_grid_fits(n_bars: int, n_levels: int, device) -> None:
    """Raise ``ValueError`` before a footprint grid of ``n_bars`` x
    ``n_levels`` cells is allocated where it would not fit: a stream off
    every tick grid infers a tiny tick (``comp_price_tick_size``) and can ask
    for millions of levels a bar."""
    need = n_bars * n_levels * GRID_CELL_BYTES
    free = _free_bytes(torch.device(device))
    if need > free:
        raise ValueError(
            f"a footprint grid of {n_bars:,} bars x {n_levels:,} levels needs about "
            f"{need / 2**30:.1f} GiB and {free / 2**30:.1f} GiB are free on "
            f"{device}; choose a coarser price_tick_size")


def _tick(price_tick_size, device) -> torch.Tensor:
    """The tick as a float64 tensor on ``device``: a division by it is a true
    division, where on the card a division by a Python number multiplies by
    its reciprocal, which rounds otherwise."""
    return torch.tensor(float(price_tick_size), dtype=torch.float64, device=device)


def bar_levels(bar_lows, bar_highs, price_tick_size):
    """int64 ``(round(low / tick), round(high / tick))`` of every bar; raises
    ``ValueError`` when one is not an int32 (ROADMAP R16), from one device
    read."""
    tick = _tick(price_tick_size, bar_lows.device)
    low = torch.round(bar_lows.to(torch.float64) / tick)
    high = torch.round(bar_highs.to(torch.float64) / tick)
    if low.numel() and not trace.host_read(
            bool, ((low >= _INT32[0]) & (high <= _INT32[1])).all()):
        raise ValueError(f"footprint levels at tick {float(price_tick_size)} leave int32")
    return low.to(torch.int64), high.to(torch.int64)


def comp_bar_footprints(prices, amounts_f32, ci, sides, price_tick_size,
                        bar_lows, bar_highs, imbalance_factor, *, max_levels: int,
                        cumsum=fast_cumsum):
    """Dense footprints and their features on the float64 level grid
    (``footprint.py:24-66``).

    ``prices`` float64, ``amounts_f32`` float32 and ``sides`` int8 per trade;
    ``ci`` int64 close indices; ``bar_lows``/``bar_highs`` float64 per bar
    (the OHLCV's). A bar's levels run from ``round(low / tick)`` to
    ``round(high / tick)``; a trade of the bar lands on ``round(price / tick)``
    and counts where that lies among them and below ``max_levels``, which must
    be at least the bars' largest level count. ``cumsum`` gives the bar ids
    (kernel S by default). Raises ``ValueError`` when a bar's lowest or
    highest level is not an int32 (one device read). Returns the dict of
    :func:`footprint_features_from_tensors`.
    """
    dev = prices.device
    n, nb, L = prices.shape[0], ci.shape[0] - 1, int(max_levels)
    tick = _tick(price_tick_size, dev)
    low, high = bar_levels(bar_lows, bar_highs, price_tick_size)
    n_levels = high - low + 1
    bar_id, valid = bar_ids_from_close_indices(ci, n, cumsum=cumsum)
    # a trade outside every bar may lie anywhere: clamp before the cast
    level = torch.round(prices / tick).clamp(-2.0**62, 2.0**62).to(torch.int64)
    lvl = level - low[bar_id]
    del level
    is_sell = sides == -1
    keep = (valid & ((sides == 1) | is_sell) & (lvl >= 0) & (lvl < L)
            & (lvl < n_levels[bar_id]))
    # cell (bar, level, side) of every buy and sell; the rest go to slot 2*nb*L
    cell = torch.where(keep, (bar_id * L + lvl) * 2 + is_sell, 2 * nb * L)
    del bar_id, valid, lvl, is_sell, keep
    vol = torch.zeros(2 * nb * L + 1, dtype=torch.float64, device=dev)
    vol.index_put_((cell,), amounts_f32.to(torch.float64), accumulate=True)
    vol = vol[:-1].view(nb, L, 2).to(torch.float32)
    cnt = torch.zeros(2 * nb * L + 1, dtype=torch.int32, device=dev)
    cnt.index_add_(0, cell, torch.ones(n, dtype=torch.int32, device=dev))
    cnt = cnt[:-1].view(nb, L, 2)
    del cell
    return footprint_features_from_tensors(
        low.to(torch.int32), n_levels.to(torch.int32), vol[..., 0].contiguous(),
        vol[..., 1].contiguous(), cnt[..., 0].contiguous(), cnt[..., 1].contiguous(),
        imbalance_factor)


def footprint_features_from_tensors(low, n_levels, buy_vol, sell_vol,
                                    buy_ticks, sell_ticks, imbalance_factor):
    """Footprint features from dense grids; returns a dict of tensors with
    the JAX package's keys and dtypes (``low`` and ``n_levels`` int32 per bar,
    volumes float32 and ticks int32 of shape ``(n_bars, L)``)."""
    n_bars, L = buy_vol.shape
    dev = buy_vol.device
    f = float(imbalance_factor)
    lgrid = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    lmask = lgrid < n_levels[:, None]
    pair_ok = (lgrid[:, :-1] + 1) < n_levels[:, None]

    bv, sv = buy_vol.to(torch.float64), sell_vol.to(torch.float64)
    sell_imb = torch.zeros((n_bars, L), dtype=torch.bool, device=dev)
    buy_imb = torch.zeros((n_bars, L), dtype=torch.bool, device=dev)
    sell_imb[:, :-1] = (sv[:, :-1] > bv[:, 1:] * f) & pair_ok
    buy_imb[:, 1:] = (bv[:, 1:] > sv[:, :-1] * f) & pair_ok

    # longest signed run: a run restarts where the sign is 0 or differs from
    # the level below; its length is the distance to the last restart
    zero8 = torch.zeros((), dtype=torch.int8, device=dev)
    sign = torch.where(buy_imb, 1, torch.where(sell_imb, -1, zero8))
    sign = torch.where(lmask, sign, zero8)
    prev = torch.cat([torch.zeros((n_bars, 1), dtype=torch.int8, device=dev),
                      sign[:, :-1]], dim=1)
    pos = lgrid.expand(n_bars, L)
    restart = (sign != prev) | (sign == 0)
    last_restart = torch.cummax(torch.where(restart, pos, -1), dim=1).values
    run = torch.where(sign != 0, pos - last_restart + 1, 0)
    first_max = torch.argmax(run, dim=1, keepdim=True)  # first maximal run
    max_run = run.gather(1, first_max)[:, 0]
    max_sign = sign.gather(1, first_max)[:, 0].to(torch.int32)
    imb_max_run_signed = (max_run * max_sign).to(torch.int16)
    del sign, prev, restart, last_restart, run

    total = torch.where(lmask, bv + sv, 0.0)
    cot_price_levels = low + torch.argmax(total, dim=1).to(torch.int32)
    levels = (low[:, None] + lgrid).to(torch.float64)
    sum_total = total.sum(dim=1)
    pos_vol = sum_total > 0
    safe = torch.where(pos_vol, sum_total, 1.0)
    vwap = (levels * total).sum(dim=1) / safe
    vp_skew = torch.where(
        pos_vol, ((levels - vwap[:, None]) * total).sum(dim=1) / safe, 0.0)
    prop = total / safe[:, None]
    vp_gini = torch.where(pos_vol, 1.0 - (prop * prop).sum(dim=1), 0.0)

    return {
        "low_level": low,
        "n_levels": n_levels,
        "buy_volumes": buy_vol,
        "sell_volumes": sell_vol,
        "buy_ticks": buy_ticks,
        "sell_ticks": sell_ticks,
        "buy_imbalances": buy_imb,
        "sell_imbalances": sell_imb,
        "buy_imbalances_sum": buy_imb.sum(dim=1).to(torch.uint16),
        "sell_imbalances_sum": sell_imb.sum(dim=1).to(torch.uint16),
        "cot_price_levels": cot_price_levels,
        "imb_max_run_signed": imb_max_run_signed,
        "vp_skew": vp_skew,
        "vp_gini": vp_gini,
    }
