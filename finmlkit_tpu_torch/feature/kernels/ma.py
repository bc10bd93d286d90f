"""Moving averages.

Counterpart of ``finmlkit_tpu/feature/kernels/ma.py``.
"""
import torch

from ...ops.scan import linear_recurrence
from ._inputs import device_of, f64
from ._rolling import roll_sum, warmup_nan

__all__ = ["ewma", "sma"]


def ewma(y, span: int, *, device="cuda") -> torch.Tensor:
    """pandas ``ewm(span).mean()`` with adjust=True: the numerator by kernel R,
    the denominator in its closed geometric form (``ma.py:22-24``). A NaN
    poisons every later value, as in the sequential recurrence."""
    if span < 1:
        raise ValueError("span size is less than or equal to 1. Please provide a "
                         "span size greater than 1.")
    y = f64(y, device_of(device, y))
    alpha = 2.0 / (span + 1.0)
    u = linear_recurrence(1.0 - alpha, y)
    t = torch.arange(y.shape[0], dtype=torch.float64, device=y.device)
    v = (1.0 - (1.0 - alpha) ** (t + 1.0)) / alpha
    return u / v


def sma(array, window: int, *, device="cuda") -> torch.Tensor:
    """Rolling mean; NaN for the first window-1 points (windowed sums, so a
    NaN only affects the windows that hold it)."""
    y = f64(array, device_of(device, array))
    return warmup_nan(roll_sum(y, window) / window, window)
