"""Per-bar aggregations of trades in float64: the kits' path for prices that sit
on no tick grid.

Counterpart of ``finmlkit_tpu/bar/aggregate.py`` (``comp_bar_ohlcv``,
``comp_bar_directional_features``, ``comp_bar_trade_size_features``), on
float64 prices and float32 amounts. Bar *i* covers trades ``(ci[i], ci[i+1]]``;
an empty bar takes the close at ``ci[i+1]``, and a negative index wraps as
NumPy's does (``_wrap_idx``). Every output is a segment reduction over the
trade axis:

- sums are differences of float64 prefixes at the closes: kernel S
  (``ops.prefix_scan.fast_cumsum``) for the OHLCV and trade-size sums, one
  launch of kernel C (``fast_cumsum_cols``) over the ``(7, n)`` stack of the
  directional sums and one over the ``(3, n)`` stack of the signed imbalance
  contributions;
- the bar ids are kernel S's prefix of the int32 bar-open marks
  (``ops.segment.bar_ids_from_close_indices``);
- extrema are ``torch.segment_reduce`` over the bars' contiguous trades;
- medians and the 95th percentile come from one ``torch.sort`` of the
  ``(bar id, amount)`` keys (``ops.segment.sorted_segments``).

Each function takes ``cumsum`` and ``cumsum_cols`` (kernels S and C by default;
their plain versions with ``ops.prefix_scan.fast_cumsum_plain`` and
``fast_cumsum_cols_plain``). The kernels add in another order than
``torch.cumsum``, so their float64 sums differ from the plain path's within
about ``n * eps * max|P|``, ``P`` the prefix; counts and the signed tick
extrema are sums of small integers and exact.
"""
import torch

from ..ops.prefix_scan import fast_cumsum, fast_cumsum_cols
from ..ops.segment import (bar_ids_from_close_indices,
                           range_count, range_sum, range_sums,
                           segment_max_ranges, segment_median_sorted,
                           segment_min_ranges, segment_quantile_sorted,
                           sorted_segments)

__all__ = ["comp_bar_ohlcv", "comp_bar_directional_features",
           "comp_bar_trade_size_features", "trade_size_final"]

_F64 = torch.float64


def _wrap_idx(idx: torch.Tensor, n: int) -> torch.Tensor:
    """NumPy's wraparound of negative gather indices."""
    return torch.where(idx < 0, idx + n, idx)


def comp_bar_ohlcv(prices, amounts, ci, *, cumsum=fast_cumsum):
    """OHLCV, VWAP, trade count and median trade size of every bar
    (``aggregate.py:45-93``).

    ``prices`` float64 and ``amounts`` float32 per trade, ``ci`` int64 close
    indices (``n_bars + 1``). Returns open, high, low and close (float64),
    volume (float32), vwap (float64), trades (int64) and median_trade_size
    (float64); an empty bar has the close as its four prices and zero volume,
    vwap and median.
    """
    n, nb = prices.shape[0], ci.shape[0] - 1
    bar_id, valid = bar_ids_from_close_indices(ci, n, cumsum=cumsum)
    counts = range_count(ci)
    empty = counts == 0
    close_p = prices[_wrap_idx(ci[1:], n)]
    open_p = torch.where(empty, close_p,
                         prices[_wrap_idx(torch.clamp(ci[:-1] + 1, max=n - 1), n)])
    high = torch.where(empty, close_p, segment_max_ranges(prices, ci))
    low = torch.where(empty, close_p, segment_min_ranges(prices, ci))

    amt = amounts.to(_F64)
    vol = range_sum(amt, ci, cumsum=cumsum)
    dollars = range_sum(prices * amt, ci, cumsum=cumsum)
    del amt
    pos = vol > 0.0
    vwap = torch.where(pos, dollars / torch.where(pos, vol, 1.0), 0.0)

    sorted_amt = sorted_segments(amounts.to(torch.float32), bar_id, valid, nb)
    del bar_id, valid
    median = segment_median_sorted(sorted_amt, ci[:-1] - ci[0], counts)
    return {
        "open": open_p,
        "high": high,
        "low": low,
        "close": close_p,
        "volume": torch.where(empty, 0.0, vol).to(torch.float32),
        "vwap": torch.where(empty, 0.0, vwap),
        "trades": counts,
        "median_trade_size": torch.where(empty, 0.0, median),
    }


def comp_bar_directional_features(prices, amounts, ci, sides, *,
                                  cumsum=fast_cumsum,
                                  cumsum_cols=fast_cumsum_cols):
    """Buy and sell ticks, volumes and dollars, spreads and the in-bar
    cumulative imbalance extrema of every bar (``aggregate.py:96-178``).

    The reference's quirks are kept: a sign-change spread is taken against
    the previous trade of the stream (``roll``: trade 0 against the last
    trade); a single-trade bar compares its side with side 0; the imbalance
    extrema count only trades with a nonzero side and start at -1e9 and +1e9;
    ``mean_spread`` is 0/0 = NaN on an empty bar.
    """
    n, nb = prices.shape[0], ci.shape[0] - 1
    bar_id, valid = bar_ids_from_close_indices(ci, n, cumsum=cumsum)
    counts = range_count(ci)

    s = sides.to(torch.int64)
    is_buy = (s == 1).to(_F64)
    is_sell = (s == -1).to(_F64)
    amt = amounts.to(_F64)
    dollars = prices * amt
    single = valid & (counts[bar_id] == 1)
    sign_change = torch.where(single, s != 0, s != torch.roll(s, 1))
    spread = torch.where(sign_change, torch.abs(prices - torch.roll(prices, 1)), 0.0)
    del single, sign_change
    sums = range_sums(torch.stack([is_buy, is_sell, is_buy * amt, is_sell * amt,
                                   is_buy * dollars, is_sell * dollars, spread]),
                      ci, cumsum_cols=cumsum_cols)
    del is_buy, is_sell
    ticks_buy, ticks_sell = sums[0].to(torch.int64), sums[1].to(torch.int64)
    max_spread = torch.maximum(segment_max_ranges(spread, ci),
                               torch.zeros((), dtype=_F64, device=ci.device))
    mean_spread = sums[6] / (ticks_buy + ticks_sell).to(_F64)
    del spread

    # the running imbalance after each trade of a bar: its inclusive prefix
    # less the prefix before the bar's first trade
    signed = s.to(_F64)
    P = cumsum_cols(torch.stack([signed, signed * amt, signed * dollars]))
    del amt, dollars
    start = ci[:-1]
    base = torch.where(start >= 0, P[:, start.clamp(0, n - 1)], 0.0)
    local = P - base[:, bar_id]
    del P, base, bar_id
    m = valid & (s != 0)
    inf = torch.tensor(float("inf"), dtype=_F64, device=ci.device)
    mx = torch.stack([segment_max_ranges(torch.where(m, row, -inf), ci) for row in local])
    mn = torch.stack([segment_min_ranges(torch.where(m, row, inf), ci) for row in local])
    del local
    mx, mn = mx.clamp(min=-1e9), mn.clamp(max=1e9)

    f32 = torch.float32
    return {
        "ticks_buy": ticks_buy,
        "ticks_sell": ticks_sell,
        "volume_buy": sums[2].to(f32),
        "volume_sell": sums[3].to(f32),
        "dollars_buy": sums[4].to(f32),
        "dollars_sell": sums[5].to(f32),
        "mean_spread": mean_spread.to(f32),
        "max_spread": max_spread.to(f32),
        "cum_ticks_min": mn[0].to(torch.int64),
        "cum_ticks_max": mx[0].to(torch.int64),
        "cum_volume_min": mn[1].to(f32),
        "cum_volume_max": mx[1].to(f32),
        "cum_dollars_min": mn[2].to(f32),
        "cum_dollars_max": mx[2].to(f32),
    }


def comp_bar_trade_size_features(amounts, theta, ci, theta_mult, *,
                                 cumsum=fast_cumsum):
    """Trade sizes of every bar relative to a typical size ``theta`` (float64,
    one per bar): log1p of the mean and of the 95th percentile (NumPy's
    linear interpolation) over ``theta * theta_mult``, the share of the volume
    in block trades above that, and the size Gini ``1 - sum((s/V)^2)``, as
    float32 (``aggregate.py:181-228``). NaN on an empty bar and where
    ``theta == 0``; ``pct_block`` and ``size_gini`` also where the volume is
    0; ``size_gini`` is 0 for a single-trade bar.
    """
    n, nb = amounts.shape[0], ci.shape[0] - 1
    bar_id, valid = bar_ids_from_close_indices(ci, n, cumsum=cumsum)
    counts = range_count(ci)

    amt = amounts.to(_F64)
    total = range_sum(amt, ci, cumsum=cumsum)
    sumsq = range_sum(amt * amt, ci, cumsum=cumsum)
    mean = total / counts.clamp(min=1).to(_F64)
    thr = theta.to(_F64) * float(theta_mult)
    block = range_sum(torch.where(amt > thr[bar_id], amt, 0.0), ci, cumsum=cumsum)
    del amt

    sorted_amt = sorted_segments(amounts.to(torch.float32), bar_id, valid, nb)
    del bar_id, valid
    p95 = segment_quantile_sorted(sorted_amt, ci[:-1] - ci[0], counts, 0.95)
    return trade_size_final(counts, theta, thr, mean, total, sumsq, block, p95)


def trade_size_final(counts, theta, thr, mean, total, sumsq, block, p95):
    """The trade-size features of :func:`comp_bar_trade_size_features` from
    each bar's count, ``theta``, block threshold ``thr``, mean, float64 sums
    (total, squares, block volume) and 95th percentile."""
    nb = counts.shape[0]
    empty = counts == 0
    nan = torch.full((nb,), float("nan"), dtype=_F64, device=counts.device)
    base_nan = empty | (theta == 0.0)
    safe_thr = torch.where(thr > 0, thr, 1.0)
    mean_size_rel = torch.where(base_nan, nan, torch.log1p(mean / safe_thr))
    size_95_rel = torch.where(base_nan, nan, torch.log1p(p95 / safe_thr))
    vol_nan = base_nan | (total == 0.0)
    safe_total = torch.where(total > 0, total, 1.0)
    pct_block = torch.where(vol_nan, nan, block / safe_total)
    gini = torch.where(vol_nan, nan, 1.0 - sumsq / (safe_total * safe_total))
    gini = torch.where(vol_nan, nan, torch.where(counts == 1, 0.0, gini))
    f32 = torch.float32
    return {
        "mean_size_rel": mean_size_rel.to(f32),
        "size_95_rel": size_95_rel.to(f32),
        "pct_block": pct_block.to(f32),
        "size_gini": gini.to(f32),
    }
