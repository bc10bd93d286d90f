"""Momentum indicators.

Counterpart of ``finmlkit_tpu/feature/kernels/momentum.py``.
"""
import torch

from ...ops.scan import linear_recurrence
from ._inputs import device_of, f64, nan_like
from ._rolling import roll_max, roll_min, warmup_nan

__all__ = ["roc", "rsi_wilder", "stoch_k"]


def roc(price, period: int, *, device="cuda") -> torch.Tensor:
    """Rate of change (%)."""
    price = f64(price, device_of(device, price))
    lag = torch.roll(price, period)
    out = (price - lag) / lag * 100.0
    out[:max(period, 0)] = torch.nan
    return out


def rsi_wilder(close, window: int, *, device="cuda") -> torch.Tensor:
    """Wilder-smoothed RSI: the average gain and loss as two rows of one
    kernel R launch, each seeded with the mean of its first window."""
    close = f64(close, device_of(device, close))
    if close.shape[0] <= window:
        return nan_like(close)
    diff = torch.diff(close)
    moves = torch.stack([diff.clamp(min=0.0), (-diff).clamp(min=0.0)])
    seeds = moves[:, :window].sum(1) / window
    tail = moves[:, window:]
    if tail.shape[1] > 0:
        # avg_t = ((w-1) avg_{t-1} + x_t) / w from index window on
        tail = linear_recurrence((window - 1.0) / window, tail / window, y0=seeds)
    avg_gain, avg_loss = torch.cat([seeds[:, None], tail], 1)
    rsi = 100.0 - 100.0 / (1.0 + avg_gain / avg_loss)
    rsi = torch.where(avg_loss > 0.0, rsi, torch.nan)
    return torch.cat([close.new_full((window,), torch.nan), rsi])


def stoch_k(close, low, high, length: int, *, device="cuda") -> torch.Tensor:
    """Stochastic %K from rolling min and max."""
    dev = device_of(device, close, low, high)
    close = f64(close, dev)
    if close.shape[0] < length:
        return nan_like(close)
    lo = roll_min(f64(low, dev), length)
    hi = roll_max(f64(high, dev), length)
    out = torch.where(hi > lo, 100.0 * (close - lo) / (hi - lo), torch.nan)
    return warmup_nan(out, length)
