"""Volume-flow kernels: flow acceleration and VPIN.

Counterpart of ``finmlkit_tpu/feature/kernels/volume.py`` without the volume
profile (``volume_profile_rolling``, ``volume_profile_developing``), which is
not ported yet.
"""
import torch

from ._inputs import device_of, f64, nan_like
from ._rolling import roll_sum, warmup_nan

__all__ = ["comp_flow_acceleration", "vpin"]


def comp_flow_acceleration(volumes, window: int, recent_periods: int, *,
                           device="cuda") -> torch.Tensor:
    """log(recent volume sum / past volume sum)."""
    volumes = f64(volumes, device_of(device, volumes))
    if volumes.shape[0] < window or recent_periods >= window:
        return nan_like(volumes)
    eps = 1e-12
    recent = roll_sum(volumes, recent_periods)
    past = roll_sum(volumes, window) - recent
    return warmup_nan(torch.log((recent + eps) / (past + eps)), window)


def vpin(volume_buy, volume_sell, window: int, *, device="cuda") -> torch.Tensor:
    """Rolling |buy - sell| / (buy + sell), NaN for a window that holds a NaN;
    float32, as the reference returns it."""
    dev = device_of(device, volume_buy, volume_sell)
    vb, vs = f64(volume_buy, dev), f64(volume_sell, dev)
    isnan = torch.isnan(vb) | torch.isnan(vs)
    buy = roll_sum(torch.where(isnan, 0.0, vb), window)
    sell = roll_sum(torch.where(isnan, 0.0, vs), window)
    imb = roll_sum(torch.where(isnan, 0.0, torch.abs(vb - vs)), window)
    nan_cnt = roll_sum(isnan.to(torch.float64), window)
    tot = buy + sell
    out = torch.where((nan_cnt == 0) & (tot > 1e-9), imb / tot, torch.nan)
    return warmup_nan(out, window).to(torch.float32)
