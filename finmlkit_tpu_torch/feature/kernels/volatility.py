"""Volatility estimators.

Counterpart of ``finmlkit_tpu/feature/kernels/volatility.py``: the EWM
recurrences run on kernel R (several rows in one launch), the windowed loops
as direct window sums.
"""
import math

import torch

from ...ops.scan import linear_recurrence
from ._inputs import device_of, f64, i64, nan_like
from ._rolling import roll_nansum_count, roll_sum, warmup_nan

__all__ = ["ewms", "ewmst", "ewmst_mean0", "true_range", "realized_vol",
           "bollinger_percent_b", "parkinson_range", "atr", "rolling_variance",
           "variance_ratio_1_4"]


def ewms(y, span: int, *, device="cuda") -> torch.Tensor:
    """EWM standard deviation, adjust=True bias=False: four decayed running
    sums (one launch of kernel R); NaN samples decay the sums without
    contributing."""
    y = f64(y, device_of(device, y))
    if span <= 1:
        return nan_like(y)
    alpha = 2.0 / (span + 1.0)
    oma = 1.0 - alpha
    nan = torch.isnan(y)
    one = (~nan).to(torch.float64)
    yz = torch.where(nan, 0.0, y)
    a = torch.full((4, 1), oma, dtype=torch.float64, device=y.device)
    a[1] = oma * oma
    s_w, s_w2, s_y, s_y2 = linear_recurrence(a, torch.stack([one, one, yz, yz * yz]))
    mean = s_y / s_w
    denom = s_w - s_w2 / s_w
    var = (s_y2 / s_w - mean * mean) * s_w / denom
    out = torch.sqrt(var.clamp(min=0.0))
    out = torch.where(denom > 0.0, out, torch.nan)
    return torch.where(s_w > 0.0, out, torch.nan)


def _ewmst(timestamps, y, half_life, sigma_floor, mean0: bool, device):
    dev = device_of(device, timestamps, y)
    ts, y = i64(timestamps, dev), f64(y, dev)
    dt = torch.diff(ts).to(torch.float64) / 1e9
    alpha = 1.0 - torch.exp(-dt / float(half_life))  # per-step decay from dt
    oma = 1.0 - alpha
    yi = y[1:]
    nan = torch.isnan(yi)
    yz = torch.where(nan, 0.0, yi)
    floor = float(sigma_floor)
    if mean0:
        v, u = linear_recurrence(oma, torch.stack([
            torch.where(nan, 0.0, alpha), torch.where(nan, 0.0, alpha * yz * yz)]))
        var = torch.where(v > 0.0, u / v, torch.nan).clamp(min=0.0)
        out_tail = torch.sqrt(var).clamp(min=floor)
    else:
        # the reference updates the weight sums with alpha even on NaN samples
        v, v2, sy, syy = linear_recurrence(torch.stack([oma, oma * oma, oma, oma]),
                                           torch.stack([
            alpha, alpha * alpha, torch.where(nan, 0.0, alpha * yz),
            torch.where(nan, 0.0, alpha * yz * yz)]))
        mean = sy / v
        var_raw = syy / v - mean * mean
        denom = v - v2 / v
        var = torch.where((denom > 0.0) & (var_raw > 0.0), var_raw * v / denom, 0.0)
        sigma = torch.sqrt(var).clamp(min=floor)
        out_tail = torch.where(v > 0.0, sigma, torch.nan)
    return torch.cat([out_tail.new_full((1,), torch.nan), out_tail])


def ewmst(timestamps, y, half_life, sigma_floor: float = 1e-12, *,
          device="cuda") -> torch.Tensor:
    """Time-decay (wall-clock half-life) EWM std for irregular series: a
    per-step alpha from the timestamps' gaps (int64 ns), adjust=True
    bias=False; NaN samples decay the y-sums but the weight sums still receive
    alpha (a reference quirk, kept)."""
    return _ewmst(timestamps, y, half_life, sigma_floor, False, device)


def ewmst_mean0(timestamps, y, half_life, sigma_floor: float = 1e-12, *,
                device="cuda") -> torch.Tensor:
    """Zero-mean time-decay EWM std."""
    return _ewmst(timestamps, y, half_life, sigma_floor, True, device)


def _true_range(high, low, close):
    pc = torch.cat([close.new_full((1,), torch.nan), close[:-1]])
    tr = torch.maximum(high - low,
                       torch.maximum(torch.abs(high - pc), torch.abs(low - pc)))
    tr[0] = high[0] - low[0]
    bad = torch.isnan(high) | torch.isnan(low)
    bad[1:] |= torch.isnan(close[:-1])
    return torch.where(bad, torch.nan, tr)


def true_range(high, low, close, *, device="cuda") -> torch.Tensor:
    """True range with NaN propagation."""
    dev = device_of(device, high, low, close)
    return _true_range(f64(high, dev), f64(low, dev), f64(close, dev))


def realized_vol(r, window: int, is_sample: bool, *, device="cuda") -> torch.Tensor:
    """Rolling sqrt(nansum(r^2) / n)."""
    r = f64(r, device_of(device, r))
    s2, cnt = roll_nansum_count(r * r, window)
    out = torch.sqrt(s2 / (cnt - 1.0 if is_sample else cnt))
    out = torch.where(cnt > 1, out, torch.nan)
    return warmup_nan(out, window)


def bollinger_percent_b(close, window: int, num_std: float, *,
                        device="cuda") -> torch.Tensor:
    """Bollinger %B from windowed sums and sums of squares."""
    close = f64(close, device_of(device, close))
    num_std = float(num_std)
    s = roll_sum(close, window)
    s2 = roll_sum(close * close, window)
    mean = s * (1.0 / window)  # as XLA compiles it (see misc.comp_zscore)
    var = (s2 - s * mean) * (1.0 / (window - 1))
    sd = torch.sqrt(var.clamp(min=0.0))
    lower = mean - num_std * sd
    upper = mean + num_std * sd
    out = torch.where(upper > lower, (close - lower) / (upper - lower), torch.nan)
    return warmup_nan(out, window)


def parkinson_range(high, low, *, device="cuda") -> torch.Tensor:
    """ln(h/l)^2 / (4 ln 2)."""
    dev = device_of(device, high, low)
    lr = torch.log(f64(high, dev) / f64(low, dev))
    return lr * lr / (4.0 * math.log(2.0))


def atr(high, low, close, window: int, ema_based: bool = False,
        normalize: bool = False, *, device="cuda") -> torch.Tensor:
    """Average True Range, SMA-based or Wilder-EMA-based (kernel R, seeded
    with the mean of the first window's valid true ranges)."""
    dev = device_of(device, high, low, close)
    high = f64(high, dev)
    if high.shape[0] < window:
        return nan_like(high)
    low, close = f64(low, dev), f64(close, dev)
    tr = _true_range(high, low, close)
    if ema_based:
        head = tr[:window]
        valid = ~torch.isnan(head)
        cnt = valid.sum()
        seed = torch.where(cnt > 0, torch.where(valid, head, 0.0).sum() / cnt,
                           torch.nan)
        tail = tr[window:]
        if tail.shape[0] > 0:
            tail = linear_recurrence((window - 1.0) / window, tail / window, y0=seed)
        out = torch.cat([tr.new_full((window - 1,), torch.nan), seed[None], tail])
    else:
        s, cnt = roll_nansum_count(tr, window)
        out = warmup_nan(torch.where(cnt > 0, s / cnt, torch.nan), window)
        # reference quirk: index 2 is NaN when high, low and close are all NaN
        if high.shape[0] > 2:
            all_nan2 = torch.isnan(high[2]) & torch.isnan(low[2]) & torch.isnan(close[2])
            out[2] = torch.where(all_nan2, torch.nan, out[2])
    if normalize:
        mid = (high + low) / 2.0
        out = torch.where(~torch.isnan(out) & ~torch.isnan(mid) & (mid > 0),
                          out / mid, out)
    return out


def _rolling_variance(x, window: int, ddof: int, min_periods: int):
    s, cnt = roll_nansum_count(x, window)
    s2, _ = roll_nansum_count(x * x, window)
    mean = s / cnt
    var = (s2 / cnt - mean * mean) * (cnt / (cnt - ddof))
    var = var.clamp(min=0.0)
    ok = (cnt >= min_periods) & (cnt > ddof)
    return warmup_nan(torch.where(ok, var, torch.nan), window)


def rolling_variance(series, window: int, ddof: int = 1, min_periods: int = 1, *,
                     device="cuda") -> torch.Tensor:
    """NaN-aware rolling variance."""
    x = f64(series, device_of(device, series))
    if x.shape[0] < window:
        return nan_like(x)
    return _rolling_variance(x, window, ddof, min_periods)


def variance_ratio_1_4(price, window: int, ddof: int = 1, ret_type: str = "log", *,
                       device="cuda") -> torch.Tensor:
    """var(1-bar return) / (var(4-bar return) / 4)."""
    price = f64(price, device_of(device, price))
    n = price.shape[0]
    if n < window + 4:
        return nan_like(price)
    p0, p1 = price[:-1], price[1:]
    if ret_type == "log":
        bad = torch.isnan(p0) | torch.isnan(p1) | (p0 <= 0) | (p1 <= 0)
        r = torch.where(bad, torch.nan, torch.log(p1 / p0))
    else:
        bad = torch.isnan(p0) | torch.isnan(p1) | (p0 <= 0)
        r = torch.where(bad, torch.nan, p1 / p0 - 1.0)
    r1 = torch.cat([r.new_full((1,), torch.nan), r])
    var1 = _rolling_variance(r1, window, ddof, 1)
    # 4-bar returns as sums of 4 consecutive 1-bar returns
    r4 = r1 + torch.roll(r1, 1) + torch.roll(r1, 2) + torch.roll(r1, 3)
    r4[:4] = torch.nan
    var4 = _rolling_variance(r4, window, ddof, 1)
    ok = ~torch.isnan(var1) & ~torch.isnan(var4) & (var4 > 0)
    return torch.where(ok, var1 / (var4 / 4.0), torch.nan)
