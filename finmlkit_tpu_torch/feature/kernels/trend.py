"""Trend indicators (ADX).

Counterpart of ``finmlkit_tpu/feature/kernels/trend.py``: true range and the
directional moves, Wilder's running sums (``s_t = (1 - 1/L) s_{t-1} + x_t``,
three rows of one kernel R launch), DI and DX, and the ADX's Wilder average
(kernel R again).
"""
import torch

from ...ops.scan import linear_recurrence
from ._inputs import device_of, f64

__all__ = ["adx"]


def adx(high, low, close, length: int, *, device="cuda") -> torch.Tensor:
    """Average Directional Index."""
    dev = device_of(device, high, low, close)
    high = f64(high, dev)
    n = high.shape[0]
    if n < 2 * length or n < length + 1:  # the ADX has no seed window
        return torch.zeros_like(high)
    low, close = f64(low, dev), f64(close, dev)
    pc = close[:-1]
    tr = torch.maximum(high[1:] - low[1:],
                       torch.maximum(torch.abs(high[1:] - pc), torch.abs(low[1:] - pc)))
    hd = high[1:] - high[:-1]
    ld = low[:-1] - low[1:]
    plus_dm = torch.where((hd > ld) & (hd > 0), hd, 0.0)
    minus_dm = torch.where((ld > hd) & (ld > 0), ld, 0.0)
    # index 0 is zero; s_L = sum(x[1:L+1]), s_t = s_{t-1} (1 - 1/L) + x_t for t > L
    x = torch.cat([high.new_zeros((3, 1)), torch.stack([tr, plus_dm, minus_dm])], 1)
    seeds = x[:, 1:length + 1].sum(1)
    rest = x[:, length + 1:]
    if rest.shape[1] > 0:
        rest = linear_recurrence(1.0 - 1.0 / length, rest, y0=seeds)
    s_tr, s_pdm, s_mdm = torch.cat([high.new_zeros((3, length)), seeds[:, None], rest], 1)

    idx = torch.arange(n, device=dev)
    valid = (idx >= length) & (s_tr > 0)
    safe_tr = torch.where(s_tr > 0, s_tr, 1.0)
    plus_di = torch.where(valid, 100.0 * s_pdm / safe_tr, 0.0)
    minus_di = torch.where(valid, 100.0 * s_mdm / safe_tr, 0.0)
    di_sum = plus_di + minus_di
    dx = torch.where((idx >= length) & (di_sum > 0),
                     100.0 * torch.abs(plus_di - minus_di)
                     / torch.where(di_sum > 0, di_sum, 1.0), 0.0)
    seed = dx[length:2 * length].mean()
    tail = dx[2 * length:]
    if tail.shape[0] > 0:
        tail = linear_recurrence((length - 1.0) / length, tail / length, y0=seed)
    return torch.cat([high.new_zeros(2 * length - 1), seed[None], tail])
