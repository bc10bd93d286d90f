"""Rolling price-volume correlation.

Counterpart of ``finmlkit_tpu/feature/kernels/correlation.py``: the rolling
Pearson correlation of simple returns and volume over windows of the pairs
where both are defined (pandas' semantics, not the reference's test-data
special case).
"""
import torch

from ._inputs import device_of, f64
from ._rolling import roll_sum

__all__ = ["rolling_price_volume_correlation"]


def rolling_price_volume_correlation(price, volume, window: int, *,
                                     device="cuda") -> torch.Tensor:
    """Rolling corr(pct-change returns, volume)."""
    dev = device_of(device, price, volume)
    price, volume = f64(price, dev), f64(volume, dev)
    n = price.shape[0]
    p0, p1 = price[:-1], price[1:]
    bad = torch.isnan(p1) | torch.isnan(p0) | (p0 == 0)
    r = torch.where(bad, torch.nan, (p1 - p0) / torch.where(p0 == 0, 1.0, p0))
    returns = torch.cat([price.new_full((1,), torch.nan), r])

    pair_ok = ~torch.isnan(returns) & ~torch.isnan(volume)
    rz = torch.where(pair_ok, returns, 0.0)
    vz = torch.where(pair_ok, volume, 0.0)
    cnt = roll_sum(pair_ok.to(torch.float64), window)
    sr = roll_sum(rz, window)
    sv = roll_sum(vz, window)
    srv = roll_sum(rz * vz, window)
    srr = roll_sum(rz * rz, window)
    svv = roll_sum(vz * vz, window)

    mean_r = sr / cnt
    mean_v = sv / cnt
    cov = srv - cnt * mean_r * mean_v
    var_r = srr - cnt * mean_r * mean_r
    var_v = svv - cnt * mean_v * mean_v
    corr = cov / torch.sqrt(torch.where(var_r > 0, var_r, 1.0)
                            * torch.where(var_v > 0, var_v, 1.0))
    corr = corr.clamp(-1.0, 1.0)
    ok = (cnt >= 2) & (var_r > 0) & (var_v > 0)
    out = torch.where(ok & pair_ok, corr, torch.nan)
    # the reference starts at index `window` (not window-1)
    out[:window] = torch.nan
    return out
