"""Mean-reversion features (VWAP distance).

Counterpart of ``finmlkit_tpu/feature/kernels/reversion.py``.
"""
import torch

from ._inputs import device_of, f64, nan_like
from ._rolling import roll_sum, warmup_nan

__all__ = ["vwap_distance"]


def vwap_distance(close, volume, n_periods: int, is_log: bool, *,
                  device="cuda") -> torch.Tensor:
    """Distance of the price from its rolling VWAP."""
    dev = device_of(device, close, volume)
    close = f64(close, dev)
    if close.shape[0] < n_periods:
        return nan_like(close)
    volume = f64(volume, dev)
    wsum = roll_sum(close * volume, n_periods)
    vsum = roll_sum(volume, n_periods)
    pos = vsum > 0
    vwap = wsum / torch.where(pos, vsum, 1.0)
    out = torch.log(close / vwap) if is_log else close / vwap - 1.0
    out = torch.where(pos, out, torch.nan)
    # the reference forward-fills the (rare) window without volume
    idx = torch.arange(close.shape[0], device=dev)
    last_ok = torch.cummax(torch.where(pos, idx, -1), 0).values
    out = torch.where(pos, out, out[last_ok.clamp(min=0)])
    # reference quirk: index n_periods-1 takes the simple return even when
    # is_log is true
    p = n_periods - 1
    out[p] = torch.where(pos[p], close[p] / vwap[p] - 1.0, torch.nan)
    return warmup_nan(out, n_periods)
