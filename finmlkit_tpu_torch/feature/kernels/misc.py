"""General-purpose kernels: lagged returns, z-score, burst ratio, percent
change.

Counterpart of ``finmlkit_tpu/feature/kernels/misc.py``.
"""
import torch

from ._inputs import device_of, f64, i64
from ._rolling import roll_sum, sliding_windows, warmup_nan

__all__ = ["comp_lagged_returns", "comp_zscore", "comp_burst_ratio", "pct_change"]


def comp_lagged_returns(timestamps, close, return_window_sec, is_log: bool, *,
                        device="cuda") -> torch.Tensor:
    """Returns over a time window on an irregular series: each close against
    the last close at or before ``t - window``. The search runs on the
    float64-rounded timestamps, as the reference's does: nanosecond epochs lie
    above 2^53, so an int64 search differs at near ties."""
    if return_window_sec <= 0:
        raise ValueError("The return window must be greater than zero.")
    dev = device_of(device, timestamps, close)
    ts = i64(timestamps, dev).to(torch.float64)
    close = f64(close, dev)
    window_ns = float(return_window_sec * 1e9)
    n = close.shape[0]
    lag_idx = torch.searchsorted(ts, ts - window_ns, right=True) - 1
    idx = torch.arange(n, device=dev)
    ok = (lag_idx >= 0) & (lag_idx < idx)
    base = close[lag_idx.clamp(0, max(n - 1, 0))]
    safe = torch.where(base != 0.0, base, 1.0)
    ret = torch.log(close / safe) if is_log else close / safe - 1.0
    ret = torch.where(base != 0.0, ret, torch.inf)
    ret = torch.where(ok, ret, torch.nan)
    # warm-up: indices before the first fully-contained window stay NaN
    start = torch.searchsorted(ts, ts[:1] + window_ns)
    return torch.where(idx >= start, ret, torch.nan)


def comp_zscore(x, window: int, ddof: int = 0, *, device="cuda") -> torch.Tensor:
    """Rolling z-score from windowed sums and sums of squares."""
    x = f64(x, device_of(device, x))
    s = roll_sum(x, window)
    s2 = roll_sum(x * x, window)
    # The reference's var = (s2 - w * mean^2) / (w - ddof) cancels most of its
    # digits on a price level, so the port rounds as the JAX package's compiled
    # form does: XLA turns a division by a constant into a product with its
    # reciprocal, and w * mean into s.
    mean = s * (1.0 / window)
    var = (s2 - s * mean) * (1.0 / (window - ddof))
    std = torch.sqrt(var.clamp(min=0.0))
    out = torch.where(std != 0.0, (x - mean) / std, torch.nan)
    return warmup_nan(out, window)


def _median_rows(w: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of each row: NaN where the row holds a NaN, else the
    mean of the two middle values, ``(lo + hi) * 0.5`` (odd rows: lo == hi).
    ``torch.median`` returns the lower middle and is not this."""
    k = w.shape[1]
    srt = torch.sort(w, 1).values
    med = (srt[:, (k - 1) // 2] + srt[:, k // 2]) * 0.5
    return torch.where(torch.isnan(w).any(1), torch.nan, med)


def comp_burst_ratio(series, window: int, *, device="cuda") -> torch.Tensor:
    """x / rolling median, the median over the ``(n, window)`` trailing
    windows (bar-level series, modest windows)."""
    series = f64(series, device_of(device, series))
    med = _median_rows(sliding_windows(series, window))
    out = torch.where(med > 0, series / med, torch.nan)
    return warmup_nan(out, window)


def pct_change(x, periods: int, *, device="cuda") -> torch.Tensor:
    """Lagged percent change, NaN where the base is <= 0."""
    x = f64(x, device_of(device, x))
    base = torch.roll(x, periods)
    pos = base > 0
    out = torch.where(pos, (x - base) / torch.where(pos, base, 1.0), torch.nan)
    out[:max(periods, 0)] = torch.nan
    return out
