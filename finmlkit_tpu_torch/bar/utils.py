"""Trade utilities (numpy, on the host).

Counterpart of ``finmlkit_tpu/bar/utils.py``: tick-rule sides, the merge of
split executions, the tick-size estimate, sorting and order checks, the
helpers of ``TradesData``'s preprocessing (``bar/data_model.py``). Each is the
port's own copy of the JAX package's numpy code, so that the port never
imports that package; both give the same arrays bit for bit.
``footprint_to_dataframe`` needs pandas; its counterpart
:func:`footprint_to_columns` returns the same columns as numpy arrays.
"""
import numpy as np

__all__ = ["comp_trade_side_vector", "merge_split_trades", "comp_price_tick_size",
           "comp_trade_side", "median3", "check_timestamps_order",
           "fast_sort_trades", "footprint_to_columns"]


def comp_trade_side_vector(prices: np.ndarray) -> np.ndarray:
    """Tick-rule trade side: sign of price change, carrying the previous
    side through unchanged prices (changes of at most 1e-12 count as none).
    Element 0 is 0 (no previous trade). Returns int8."""
    n = len(prices)
    sides = np.zeros(n, dtype=np.int8)
    if n < 2:
        return sides
    dp = np.diff(prices.astype(np.float64))
    sgn = np.sign(dp).astype(np.int8)
    nz = np.abs(dp) > 1e-12
    # forward-fill the last nonzero sign
    idx = np.where(nz, np.arange(n - 1), -1)
    np.maximum.accumulate(idx, out=idx)
    sides[1:] = np.where(idx >= 0, sgn[np.clip(idx, 0, None)], 0)
    return sides


def merge_split_trades(timestamps, prices, amounts, is_buyer_maker=None):
    """Merge split executions (same timestamp, price and side) by summing
    their amounts. Inputs must be ordered by (timestamp, id).

    A trade joins its group when it has the group's timestamp and side and
    its price lies within 1e-8 of the group's first price (its anchor), not
    of its neighbour's: a price drifting by sub-1e-8 steps opens a new group
    once it strays 1e-8 from the anchor. Groups are found from adjacent
    pairs; the runs of one (timestamp, side) with a nonzero step below 2e-8
    are walked again with the anchor rule (only sub-tolerance noise, never a
    price on a tick grid, takes that walk). The amounts of a group add in
    float32, in order (``np.add.reduceat``). Sides come from
    ``is_buyer_maker``: a maker buyer is a market sell (-1), else a buy (+1).

    Returns ``(timestamps, prices, amounts float32, sides int8)``; the sides
    are empty without ``is_buyer_maker``.
    """
    n = len(timestamps)
    if n == 0:
        return timestamps, prices, amounts, np.empty(0, dtype=np.int8)
    with_side = is_buyer_maker is not None
    px64 = prices.astype(np.float64, copy=False)

    same_run = np.zeros(n, dtype=bool)  # same (ts, side) as the predecessor
    same_run[1:] = timestamps[1:] == timestamps[:-1]
    if with_side:
        same_run[1:] &= is_buyer_maker[1:] == is_buyer_maker[:-1]
    dp = np.zeros(n)
    dp[1:] = np.abs(px64[1:] - px64[:-1])

    new_group = np.empty(n, dtype=bool)
    new_group[0] = True
    new_group[1:] = ~same_run[1:] | (dp[1:] >= 1e-8)

    # the adjacent-pair groups equal the anchor walk's unless a pair of one
    # run differs by a nonzero step below 2e-8: walk those runs again
    tiny = same_run & (dp > 0.0) & (dp < 2e-8)
    if tiny.any():
        run_start = np.flatnonzero(~same_run)
        run_end = np.append(run_start[1:], n)
        affected = np.unique(np.searchsorted(run_start, np.flatnonzero(tiny),
                                             side="right") - 1)
        for r in affected:
            s, e = run_start[r], run_end[r]
            anchor = px64[s]
            new_group[s + 1:e] = False
            for i in range(s + 1, e):
                if abs(px64[i] - anchor) >= 1e-8:
                    new_group[i] = True
                    anchor = px64[i]

    starts = np.flatnonzero(new_group)
    merged_ts = timestamps[starts]
    merged_px = prices[starts]
    merged_amt = np.add.reduceat(amounts.astype(np.float32), starts)
    if with_side:
        merged_side = np.where(is_buyer_maker[starts], -1, 1).astype(np.int8)
    else:
        merged_side = np.empty(0, dtype=np.int8)
    return merged_ts, merged_px, merged_amt, merged_side


def comp_price_tick_size(prices: np.ndarray) -> float:
    """Estimate the smallest price increment via GCD of scaled unique diffs.

    Same arithmetic as ``finmlkit_tpu.bar.utils.comp_price_tick_size``.
    """
    if len(prices) == 0:
        raise ValueError("Empty prices array")
    sample = np.round(prices[: min(10000, len(prices))], decimals=12)
    uniq = np.unique(sample)
    if len(uniq) <= 1:
        return 0.0
    diffs = np.diff(uniq)
    pos = diffs[diffs > 0]
    scale = 10.0 ** (-np.floor(np.log10(np.min(pos))))
    int_px = np.round(uniq * scale).astype(np.int64)
    int_diffs = np.diff(int_px)
    tick_int = int(np.gcd.reduce(int_diffs[int_diffs > 0])) if np.any(int_diffs > 0) else 0
    return tick_int / scale


def comp_trade_side(price: float, prev_price: float, prev_tick: int) -> int:
    """Tick-rule side of one trade: the sign of the price change, or
    ``prev_tick`` when the price moved by at most 1e-12."""
    dp = price - prev_price
    if abs(dp) > 1e-12:
        return int(np.sign(dp))
    return prev_tick


def median3(a, b, c):
    """Median of three values."""
    if a > b:
        a, b = b, a
    if b > c:
        b, c = c, b
    if a > b:
        a, b = b, a
    return b


def check_timestamps_order(timestamps) -> bool:
    """Whether the timestamps never decrease."""
    ts = np.asarray(timestamps)
    return bool(np.all(ts[1:] >= ts[:-1]))


def fast_sort_trades(timestamps, prices, amounts, is_buyer_maker=None):
    """The trades in timestamp order (a stable argsort: equal timestamps
    keep their order)."""
    idx = np.argsort(timestamps, kind="stable")
    return (timestamps[idx], prices[idx], amounts[idx],
            is_buyer_maker[idx] if is_buyer_maker is not None else None)


def sorted_footprint_columns(columns: dict, bar_idx, bar_ns) -> dict:
    """Footprint rows in the order of the JAX package's DataFrames: bar time
    ascending, price level descending, ties kept in row order (pandas'
    multi-column ``sort_values`` is a stable lexsort). ``bar_idx`` and
    ``bar_datetime_idx`` (int64 ns) join the columns as the index arrays."""
    order = np.lexsort((-columns["price_level"], bar_ns))
    out = {k: np.asarray(v)[order] for k, v in columns.items()}
    out["bar_idx"] = np.asarray(bar_idx, np.int64)[order]
    out["bar_datetime_idx"] = np.asarray(bar_ns, np.int64)[order]
    return out


def footprint_to_columns(bar_timestamps, price_levels, buy_volumes, sell_volumes,
                         buy_ticks, sell_ticks, buy_imbalance, sell_imbalance,
                         price_tick) -> dict:
    """Ragged per-bar footprint lists as a dict of numpy columns: the columns
    and the row order of ``footprint_to_dataframe`` (``utils.py:152-181``),
    with its MultiIndex as the arrays ``bar_idx`` and ``bar_datetime_idx``
    (int64 ns). ``bar_timestamps`` are int64 ns."""
    bar_ts = np.asarray(bar_timestamps).astype(np.int64)
    n_levels = np.array([len(p) for p in price_levels], dtype=np.int64)
    bar_idx = np.repeat(np.arange(len(bar_ts)), n_levels)

    def cat(parts):
        return np.concatenate([np.asarray(p) for p in parts]) if len(parts) \
            else np.empty(0)

    columns = {
        "price_level": cat(price_levels) * price_tick,
        "sell_ticks": cat(sell_ticks),
        "buy_ticks": cat(buy_ticks),
        "sell_volume": cat(sell_volumes),
        "buy_volume": cat(buy_volumes),
        "sell_imbalance": cat(sell_imbalance),
        "buy_imbalance": cat(buy_imbalance),
    }
    return sorted_footprint_columns(columns, bar_idx, np.repeat(bar_ts, n_levels))
