"""Quantization of trades to exact integer grids (numpy, on the host).

Counterpart of ``finmlkit_tpu/bar/quantize.py``, with the same arithmetic and
the same ``QuantizedTrades`` record. Prices become int32 ticks of the
GCD-inferred tick size; amounts become int64 units of 1e-8, so that every bar
sum and extremum downstream is exact integer arithmetic. A single amount of
21.5 at 1e-8 is already above 2^31 units: units and dollars (ticks * units)
stay int64 end to end.
"""
from typing import NamedTuple, Optional

import numpy as np

from .utils import comp_price_tick_size

__all__ = ["AMOUNT_SCALE", "QuantizedTrades", "quantize_prices",
           "quantize_amounts", "quantize_trades"]

AMOUNT_SCALE = 1e-8


class QuantizedTrades(NamedTuple):
    price_ticks: np.ndarray     # int32
    amount_units: np.ndarray    # int64
    tick_size: float
    amount_scale: float
    exact: bool                 # price quantization verified exact


def quantize_prices(prices: np.ndarray, tick_size: Optional[float] = None):
    """Quantize prices to integer ticks; returns (ticks i32, tick, exact)."""
    if tick_size is None:
        tick_size = comp_price_tick_size(prices)
    if not tick_size or tick_size <= 0:
        return None, 0.0, False
    ticks = np.round(prices / tick_size)
    exact = bool(np.max(np.abs(ticks * tick_size - prices))
                 < 1e-9 * np.maximum(1.0, np.max(np.abs(prices))))
    if not exact or np.max(np.abs(ticks)) >= 2**31 - 1:
        return None, tick_size, False
    return ticks.astype(np.int32), float(tick_size), True


def quantize_amounts(amounts: np.ndarray, scale: float = AMOUNT_SCALE):
    """Quantize (float32) amounts to int64 units of ``scale``."""
    units = np.round(amounts.astype(np.float64) / scale)
    if np.max(np.abs(units)) >= 2**62:
        return None, scale, False
    return units.astype(np.int64), float(scale), True


def quantize_trades(prices: np.ndarray, amounts: np.ndarray,
                    tick_size: Optional[float] = None) -> Optional[QuantizedTrades]:
    """Quantize prices and amounts; None when prices do not sit on a tick grid."""
    ticks, tick, ok_p = quantize_prices(prices, tick_size)
    if not ok_p:
        return None
    units, scale, ok_a = quantize_amounts(amounts)
    if not ok_a:
        return None
    return QuantizedTrades(ticks, units, tick, scale, True)
