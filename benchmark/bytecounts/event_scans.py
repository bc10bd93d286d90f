"""Least bytes of the four kernel-E stages (the volume, CUSUM, imbalance and
run indexes), whatever implements them: each stage's inputs read once from
the resident month, its closes written once.

- volume: the int64 units, 8 B a trade;
- CUSUM: the int32 ticks, int64 timestamps and float64 sigma, 20 B a trade;
- imbalance and run: the int8 sides, 1 B a trade each;
- each stage's closes, int64, 8 B a close (the anchor at trade 0 not
  counted).
"""
TRADE_IN = 8 + (4 + 8 + 8) + 1 + 1
CLOSE_OUT = 8
KINDS = ("volume", "cusum", "imbalance", "run")


def bytes_of(n_trades: int, n_closes: int) -> int:
    return n_trades * TRADE_IN + n_closes * CLOSE_OUT


def count(run) -> int:
    return bytes_of(run.n_trades, sum(run.outputs[f"{k}.ci"].shape[0] - 1 for k in KINDS))
