"""Hand numpy trade state to the port as tensors of the dtypes its kernels take.

The JAX package keeps trades as numpy arrays on the host (its
``QuantizedTrades``, int64 close indices, int8 sides, float32 amounts); this
module copies them onto one device, so that both packages can be fed the same
inputs. Trades whose prices sit on no tick grid have a float form
(:func:`from_floats`): float64 prices on the device, and no ticks or units.
"""
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["TradeTensors", "from_numpy", "from_floats"]


class TradeTensors(NamedTuple):
    ticks: Optional[torch.Tensor]  # int32 price ticks; None in the float form
    units: Optional[torch.Tensor]  # int64 amount units; None in the float form
    sides: torch.Tensor            # int8: +1 buy, -1 sell, 0 unknown
    amounts: torch.Tensor          # float32 trade sizes
    ci: Optional[torch.Tensor]     # int64 close indices, or None
    timestamps: Optional[torch.Tensor]  # int64 ns, or None
    tick_size: Optional[float]     # None in the float form
    amount_scale: Optional[float]  # None in the float form
    prices: Optional[torch.Tensor] = None  # float64; the float form only


def _t(a, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def from_numpy(quantized, ci, sides, amounts, device, timestamps=None) -> TradeTensors:
    """Copy quantized trades (anything with ``price_ticks``, ``amount_units``,
    ``tick_size`` and ``amount_scale``), close indices, sides, amounts and
    optionally timestamps to ``device``."""
    return TradeTensors(
        ticks=_t(quantized.price_ticks, np.int32, device),
        units=_t(quantized.amount_units, np.int64, device),
        sides=_t(sides, np.int8, device),
        amounts=_t(amounts, np.float32, device),
        ci=None if ci is None else _t(ci, np.int64, device),
        timestamps=None if timestamps is None else _t(timestamps, np.int64, device),
        tick_size=float(quantized.tick_size),
        amount_scale=float(quantized.amount_scale),
    )


def from_floats(prices, ci, sides, amounts, device, timestamps=None) -> TradeTensors:
    """The float form: float64 ``prices``, close indices, sides, amounts and
    optionally timestamps copied to ``device``; ``ticks``, ``units``,
    ``tick_size`` and ``amount_scale`` are None."""
    return TradeTensors(
        ticks=None, units=None,
        sides=_t(sides, np.int8, device),
        amounts=_t(amounts, np.float32, device),
        ci=None if ci is None else _t(ci, np.int64, device),
        timestamps=None if timestamps is None else _t(timestamps, np.int64, device),
        tick_size=None, amount_scale=None,
        prices=_t(prices, np.float64, device),
    )
