"""Bytes of the bar products stage (``bar/fused.py``: the bar scan, the
median engine and the finals), each input read once and each output
written once, whatever the kernels read again:

- per trade: the int32 tick, int64 units, int8 side and float32 amount;
- the int64 close indices, one per bar and one more;
- per bar, the stated columns: OHLC, VWAP and median in float64 (6), the
  trade count, the two tick counts and the two tick imbalance extrema in
  int64 (5), and the volume, the buy and sell volumes and dollars, the mean
  and maximum spread and the four volume and dollar imbalance extrema in
  float32 (11).
"""
TRADE_IN = 4 + 8 + 1 + 4
BAR_OUT = 6 * 8 + 5 * 8 + 11 * 4


def bytes_of(n_trades: int, n_bars: int) -> int:
    return n_trades * TRADE_IN + (n_bars + 1) * 8 + n_bars * BAR_OUT


def count(run) -> int:
    return bytes_of(run.n_trades, run.outputs["ci"].shape[0] - 1)
