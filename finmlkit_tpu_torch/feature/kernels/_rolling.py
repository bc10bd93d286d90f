"""Causal rolling-window primitives.

Counterpart of ``finmlkit_tpu/feature/kernels/_rolling.py``, which reduces with
``lax.reduce_window``. Position i reduces the trailing window
``[i-window+1, i]``, left-padded with the reduction's identity; the caller
masks the warm-up. Each window is summed directly, left to right (one
elementwise add of the shifted series per window position), never as a
difference of prefix sums: such differences cancel in the callers' variances
(``s2 - w * mean^2``) and carry a NaN into every later window. The order is
the same on every device, so a window sum on the card equals its CPU value bit
for bit, and it is XLA:CPU's order for windows of up to 42.
"""
import torch


def _padded(x: torch.Tensor, window: int, fill: float) -> torch.Tensor:
    return torch.cat([x.new_full((window - 1,), fill), x])


def roll_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    n = x.shape[0]
    xp = _padded(x, window, 0.0)
    s = xp[:n].clone()
    for j in range(1, window):
        s += xp[j:j + n]
    return s


def roll_max(x: torch.Tensor, window: int) -> torch.Tensor:
    return sliding_windows(x, window, -torch.inf).amax(1)


def roll_min(x: torch.Tensor, window: int) -> torch.Tensor:
    return sliding_windows(x, window, torch.inf).amin(1)


def roll_nansum_count(x: torch.Tensor, window: int):
    """(sum of non-NaN, count of non-NaN) over trailing windows."""
    valid = ~torch.isnan(x)
    return (roll_sum(torch.where(valid, x, 0.0), window),
            roll_sum(valid.to(x.dtype), window))


def warmup_nan(y: torch.Tensor, window: int) -> torch.Tensor:
    """The first window-1 positions set to NaN (reference convention)."""
    y = y.clone()
    y[:max(window - 1, 0)] = torch.nan
    return y


def sliding_windows(x: torch.Tensor, window: int, fill=torch.nan) -> torch.Tensor:
    """The ``(n, window)`` trailing windows as a view of the padded series
    (column j is ``x[i-window+1+j]``)."""
    return _padded(x, window, fill).unfold(0, window, 1)
