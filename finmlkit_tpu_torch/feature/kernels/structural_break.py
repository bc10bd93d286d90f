"""Chu-Stinchcombe-White CUSUM structural-break test (Homm and Breitung 2011).

Counterpart of ``finmlkit_tpu/feature/kernels/structural_break.py``. For each
t the statistic is the supremum over earlier points of
``(y_t - y_{t-k}) / (sigma_t * sqrt(k))``, an O(w) loop over the lags k, so
O(n * w) in all. Kernel W (``csrc/csw.cu``) takes one warp per t: a pass
without division bounds each side's largest quotient from below, and only the
lags that a division-free test cannot rule out take the exact quotient (its
header argues why the result is the same bit for bit).
:func:`_sup_stat_plain` is the plain version, the JAX package's ``(block,
lags)`` matrices over blocks of t's. Both read ``sqrt(k)`` and
``sqrt(4.6 + log k)`` from tables computed once on the host, so they do the
same float operations and agree bit for bit.

Ties keep the largest lag, as the reference's loop does (it walks the lags
downward and replaces its maximum only on a strictly greater value); the
critical value is ``sqrt(4.6 + log k*)`` at that lag.
"""
import functools

import numpy as np
import torch

from ... import _build
from ._inputs import device_of, f64

__all__ = ["cusum_test_rolling", "cusum_test_developing", "cusum_test_last"]

LAUNCHES = 0  # kernel W launches in this process

_PLAIN_ELEMENTS = 1 << 20  # the plain version's (block, lags) matrices


def _tables(w: int, device):
    """``sqrt(k)`` and ``sqrt(4.6 + log k)`` for k < w (0 at k = 0), computed
    on the host so that every device reads the same bits; kept for the last
    few ``(w, device)``, so a call copies nothing."""
    return _all_tables(w, _device_key(device))[:2]


def _device_key(device) -> str:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


@functools.lru_cache(maxsize=16)
def _all_tables(w: int, device: str):
    """:func:`_tables`, and kernel W's filter table ``isq[k] = 2^100 /
    sqrt_k[k]`` rounded to nearest (``inf`` at k = 0), all from the same host
    bits."""
    k = torch.arange(w, dtype=torch.float64)
    crit = torch.sqrt(4.6 + torch.log(k))
    crit[:1] = 0.0
    sqrt_k = k.sqrt()
    with np.errstate(divide="ignore"):
        isq = np.ldexp(1.0 / sqrt_k.numpy(), 100)
    return sqrt_k.to(device), crit.to(device), torch.from_numpy(isq).to(device)


def _sup_stat_plain(y, sigma, w: int, sqrt_k, crit):
    """Plain PyTorch version of kernel W, on any device: ``(up, down, cu, cd)``
    for every t, over blocks of t's as ``(block, w - 1)`` matrices of lags
    (``structural_break.py:23-52``)."""
    n = y.shape[0]
    out = [torch.empty_like(y) for _ in range(4)]
    lag = torch.arange(1, w, device=y.device)
    if n == 0 or lag.numel() == 0:
        for o, fill in zip(out, (-1e-6, -1e-6, 0.0, 0.0)):
            o.fill_(fill)
        return tuple(out)
    block = max(1, _PLAIN_ELEMENTS // lag.numel())
    sq = sqrt_k[lag]
    for t0 in range(0, n, block):
        t = torch.arange(t0, min(t0 + block, n), device=y.device)
        t_loc = torch.clamp(t, max=w)
        denom = sigma[t, None] * sq[None, :]
        ok = (lag[None, :] >= 2) & (lag[None, :] <= t_loc[:, None] - 1) & (denom > 1e-16)
        dyn = y[t, None] - y[(t[:, None] - lag[None, :]).clamp(0, n - 1)]
        s = dyn.abs() / denom
        nan = torch.isnan(dyn)
        for side, pick in enumerate(((dyn > 0) | nan, (dyn < 0) | nan)):
            v = torch.where(ok, torch.where(pick, s, 0.0), -torch.inf)
            best = v.amax(1)
            fin = torch.isfinite(best)
            lag_best = torch.where((v == best[:, None]) & fin[:, None], lag, -1).amax(1)
            has = fin & (best > -1e-6)
            out[side][t0:t0 + len(t)] = torch.where(has, best, -1e-6)
            out[side + 2][t0:t0 + len(t)] = torch.where(
                has & (lag_best > 0), crit[lag_best.clamp(min=0)], 0.0)
    return tuple(out)


def _sup_stat(y, sigma, w: int, sqrt_k, crit, *, stats=None):
    """``(up, down, cu, cd)`` for every t: kernel W on a CUDA tensor,
    :func:`_sup_stat_plain` on a CPU tensor; ``sqrt_k`` and ``crit`` are
    :func:`_tables` on ``y``'s device (kernel W reads the filter table kept
    beside them). ``stats``, if given, is an int32
    tensor of ``(n, 4)`` that receives, for each t, the admissible lags, the
    lags walked in pass 2, the quotients taken and the path (``csw.cu``)."""
    global LAUNCHES
    if y.device.type == "cpu":
        return _sup_stat_plain(y, sigma, w, sqrt_k, crit)
    if y.device.type != "cuda":
        raise ValueError(f"the CSW statistic runs on cpu or cuda, not {y.device}")
    y, sigma = y.contiguous(), sigma.contiguous()
    out = [torch.empty_like(y) for _ in range(4)]
    if y.shape[0] == 0:
        return tuple(out)
    isq = _all_tables(w, _device_key(y.device))[2]
    lib = _build.library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.fmk_csw_sup_stat(y.data_ptr(), sigma.data_ptr(), sqrt_k.data_ptr(),
                                  isq.data_ptr(), crit.data_ptr(), y.shape[0], w,
                                  *(o.data_ptr() for o in out),
                                  None if stats is None else stats.data_ptr(), stream)
    _build.check(rc, "cusum_test_rolling")
    LAUNCHES += 1
    return tuple(out)


def _sigma(y, w: int):
    """Per-t window length ``min(t, w)`` and the std of the log-price changes
    over that window (``structural_break.py:63-73``)."""
    n = y.shape[0]
    d = torch.diff(y)
    dy2 = torch.cat([y.new_zeros(1), d * d])
    cum = torch.cumsum(dy2, 0)
    idx = torch.arange(n, device=y.device)
    t_loc = torch.clamp(idx, max=w)
    s = cum - cum[(idx - t_loc).clamp(0, max(n - 1, 0))]
    return t_loc, torch.sqrt(s / torch.clamp(t_loc - 1, min=1))


def _csw(y, w: int, warmup_period: int):
    t_loc, sigma = _sigma(y, w)
    up, down, cu, cd = _sup_stat(y, sigma, w, *_tables(w, y.device))
    bad = (t_loc < 1) | (sigma <= 0.0)
    warm = torch.arange(y.shape[0], device=y.device) < warmup_period
    return (torch.where(warm, torch.nan, torch.where(bad, -1e-6, up)),
            torch.where(warm, torch.nan, torch.where(bad, -1e-6, down)),
            torch.where(warm, torch.nan, torch.where(bad, 0.0, cu)),
            torch.where(warm, torch.nan, torch.where(bad, 0.0, cd)))


def cusum_test_rolling(close_prices, window_size: int = 1000, warmup_period: int = 30,
                       *, device="cuda"):
    """Rolling CSW test on log prices: expanding inside the first window,
    fixed-window afterwards, NaN before the warm-up period. Returns
    ``(up, down, crit_up, crit_down)``."""
    close = f64(close_prices, device_of(device, close_prices))
    if bool((close <= 0).any()):
        raise ValueError("All close prices must be positive.")
    n = close.shape[0]
    window_size = max(window_size, warmup_period + 2)
    if n < warmup_period + 2:
        return tuple(torch.full_like(close, torch.nan) for _ in range(4))
    return _csw(torch.log(close), min(window_size, n), warmup_period)


def cusum_test_developing(y_prices, warmup_period: int = 30, *, device="cuda"):
    """Expanding-window CSW test (the window is the whole series)."""
    y = f64(y_prices, device_of(device, y_prices))
    return _csw(torch.log(y), y.shape[0], warmup_period)


def cusum_test_last(y_prices, *, device="cuda"):
    """The CSW test's ``(up, down, crit_up, crit_down)`` at the last
    observation, as floats."""
    out = cusum_test_developing(y_prices, warmup_period=0, device=device)
    return tuple(float(o[-1]) for o in out)
