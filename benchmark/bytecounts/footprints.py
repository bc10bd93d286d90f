"""Bytes of the footprints stage (``bar/footprint_q.py``), each input read
once and each output written once:

- per trade: the int32 tick, float32 amount and int8 side;
- the int64 close indices, one per bar and one more, and each bar's
  float64 low and high;
- per cell of the ``(n_bars, L)`` grid, ``L`` the grid's width in this pass:
  the buy and sell float32 volumes, int32 tick counts and boolean
  imbalance flags;
- per bar: the int32 low level, level count and level of most volume, the
  two uint16 imbalance counts, the int16 longest run and the float64
  profile skew and gini.
"""
TRADE_IN = 4 + 4 + 1
BAR_IN = 2 * 8
CELL_OUT = 2 * 4 + 2 * 4 + 2 * 1
BAR_OUT = 3 * 4 + 2 * 2 + 2 + 2 * 8


def bytes_of(n_trades: int, n_bars: int, width: int) -> int:
    return (n_trades * TRADE_IN + (n_bars + 1) * 8 + n_bars * BAR_IN
            + n_bars * width * CELL_OUT + n_bars * BAR_OUT)


def count(run) -> int:
    n_bars, width = run.outputs["footprints.buy_volumes"].shape
    return bytes_of(run.n_trades, n_bars, width)
