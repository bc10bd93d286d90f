"""The feature kernels of finmlkit_tpu_torch (``feature/kernels``, plain path on
the CPU) against the JAX package's ``finmlkit_tpu.feature.kernels`` on
XLA:CPU, float64.

Floats agree within ``rtol 1e-12, atol 1e-12``, NaN positions are equal, and
boolean flags are equal. Both sides sum the same terms: the window sums in the
same order (left to right, XLA:CPU's order for windows of up to 42), the
recurrences in another (kernel R's plain version is a doubling scan, the JAX
package's an associative scan), so they differ by a few roundings. The EWM
deviations get return-like series, as users feed them: on a price level their
raw-moment variance ``E[y^2] - E[y]^2`` cancels about 10 digits, and any two
orders of summation then differ by about 1e-7 relative, the port's from the
JAX package's as much as either from a sequential loop. The z-score and
Bollinger %B take the same raw-moment variance over a window of a price
level; XLA:CPU rounds it in one fused multiply-add, which the port does not,
so their series moves 1% a bar, where the bound holds, and
``test_zscore_on_a_calm_level_within_its_conditioning`` holds both packages to
the exact value on a calm level, where they differ by about 1e-9.

The JAX kernels compile once per input shape and static argument, so the
cases share one length and a few windows.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from finmlkit_tpu.feature import kernels as jk
from finmlkit_tpu_torch.feature import kernels as pk
from finmlkit_tpu_torch.testing import assert_close, assert_exact

RTOL = ATOL = 1e-12
N = 600
NAN_AT = (3, 40, 41, 300, 597)
T0 = 1_704_067_200 * 10**9      # 2024-01-01 00:00:00 UTC in ns


def _data(nans: bool, n: int = N, seed: int = 0) -> dict:
    r = np.random.default_rng(seed)
    close = 100.0 * np.exp(np.cumsum(r.normal(0.0, 1e-2, n)))
    high = close * (1.0 + np.abs(r.normal(0.0, 5e-3, n)))
    low = close * (1.0 - np.abs(r.normal(0.0, 5e-3, n)))
    volume = r.lognormal(2.0, 1.0, n)
    buy = volume * r.uniform(0.0, 1.0, n)
    ts = T0 + np.cumsum(r.integers(1, 120, n) * 10**9 + r.integers(0, 10**9, n))
    ret = np.concatenate([[np.nan], np.diff(np.log(close))])
    d = dict(close=close, high=high, low=low, volume=volume, buy=buy,
             sell=volume - buy, ts=ts.astype(np.int64), ret=ret)
    if nans:
        for key in ("close", "high", "low", "volume", "buy", "ret"):
            d[key] = d[key].copy()
            d[key][list(NAN_AT)] = np.nan
    return d


# name -> f(kernels, data, **device) for both packages; windows shared
FEATURES = {
    "ewma": lambda k, d, **kw: k.ewma(d["close"], 20, **kw),
    "sma": lambda k, d, **kw: k.sma(d["close"], 20, **kw),
    "ewms": lambda k, d, **kw: k.ewms(d["ret"], 20, **kw),
    "ewmst": lambda k, d, **kw: k.ewmst(d["ts"], d["ret"], 600.0, **kw),
    "ewmst_mean0": lambda k, d, **kw: k.ewmst_mean0(d["ts"], d["ret"], 600.0, **kw),
    "true_range": lambda k, d, **kw: k.true_range(d["high"], d["low"], d["close"], **kw),
    "realized_vol": lambda k, d, **kw: k.realized_vol(d["ret"], 30, True, **kw),
    "realized_vol_pop": lambda k, d, **kw: k.realized_vol(d["ret"], 30, False, **kw),
    "bollinger_percent_b": lambda k, d, **kw: k.bollinger_percent_b(d["close"], 20, 2.0, **kw),
    "parkinson_range": lambda k, d, **kw: k.parkinson_range(d["high"], d["low"], **kw),
    "atr": lambda k, d, **kw: k.atr(d["high"], d["low"], d["close"], 14, **kw),
    "atr_ema_normalized": lambda k, d, **kw: k.atr(d["high"], d["low"], d["close"], 14,
                                                   ema_based=True, normalize=True, **kw),
    "rolling_variance": lambda k, d, **kw: k.rolling_variance(d["ret"], 20, **kw),
    "variance_ratio_1_4": lambda k, d, **kw: k.variance_ratio_1_4(d["close"], 20, **kw),
    "variance_ratio_1_4_simple": lambda k, d, **kw: k.variance_ratio_1_4(
        d["close"], 20, ret_type="simple", **kw),
    "roc": lambda k, d, **kw: k.roc(d["close"], 10, **kw),
    "rsi_wilder": lambda k, d, **kw: k.rsi_wilder(d["close"], 14, **kw),
    "stoch_k": lambda k, d, **kw: k.stoch_k(d["close"], d["low"], d["high"], 14, **kw),
    "adx": lambda k, d, **kw: k.adx(d["high"], d["low"], d["close"], 14, **kw),
    "comp_lagged_returns": lambda k, d, **kw: k.comp_lagged_returns(
        d["ts"], d["close"], 300, True, **kw),
    "comp_lagged_returns_simple": lambda k, d, **kw: k.comp_lagged_returns(
        d["ts"], d["close"], 300, False, **kw),
    "comp_zscore": lambda k, d, **kw: k.comp_zscore(d["close"], 20, **kw),
    "comp_zscore_ddof1": lambda k, d, **kw: k.comp_zscore(d["close"], 20, ddof=1, **kw),
    "comp_burst_ratio_even": lambda k, d, **kw: k.comp_burst_ratio(d["volume"], 10, **kw),
    "comp_burst_ratio_odd": lambda k, d, **kw: k.comp_burst_ratio(d["volume"], 7, **kw),
    "pct_change": lambda k, d, **kw: k.pct_change(d["close"], 5, **kw),
    "time_cues": lambda k, d, **kw: k.time_cues(d["ts"], **kw),
    "vwap_distance": lambda k, d, **kw: k.vwap_distance(d["close"], d["volume"], 20, True, **kw),
    "vwap_distance_simple": lambda k, d, **kw: k.vwap_distance(
        d["close"], d["volume"], 20, False, **kw),
    "rolling_price_volume_correlation": lambda k, d, **kw:
        k.rolling_price_volume_correlation(d["close"], d["volume"], 20, **kw),
    "comp_flow_acceleration": lambda k, d, **kw: k.comp_flow_acceleration(
        d["volume"], 20, 5, **kw),
    "vpin": lambda k, d, **kw: k.vpin(d["buy"], d["sell"], 20, **kw),
}


def _compare(got, want, what: str) -> None:
    """Tensors against JAX arrays: same dtype, flags equal, floats close."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _compare(g, w, f"{what}[{i}]")
        return
    assert torch.is_tensor(got) and got.device.type == "cpu", what
    w = np.asarray(want)
    g = got.numpy()
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype)
    if w.dtype == np.bool_:
        assert_exact(g, w, what)
    else:
        assert_close(g, w, rtol=RTOL, atol=ATOL, what=what)


@pytest.mark.parametrize("nans", [False, True], ids=["clean", "nans"])
@pytest.mark.parametrize("name", list(FEATURES))
def test_feature_matches_jax(name, nans):
    d = _data(nans)
    f = FEATURES[name]
    _compare(f(pk, d, device="cpu"), f(jk, d), name)


def test_numpy_and_tensor_inputs_agree():
    d = _data(True)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    for name, f in FEATURES.items():
        a, b = f(pk, d, device="cpu"), f(pk, t)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert_exact(x, y, name)


# series shorter than the window: the early returns (volatility.py:202, 223,
# 232, momentum.py:58, volume.py:33 and the like)
SHORT = {
    "ewms_span1": lambda k, d, **kw: k.ewms(d["ret"], 1, **kw),
    "atr": lambda k, d, **kw: k.atr(d["high"], d["low"], d["close"], 14, **kw),
    "rolling_variance": lambda k, d, **kw: k.rolling_variance(d["ret"], 14, **kw),
    "variance_ratio_1_4": lambda k, d, **kw: k.variance_ratio_1_4(d["close"], 8, **kw),
    "rsi_wilder": lambda k, d, **kw: k.rsi_wilder(d["close"], 10, **kw),
    "stoch_k": lambda k, d, **kw: k.stoch_k(d["close"], d["low"], d["high"], 14, **kw),
    "adx_short": lambda k, d, **kw: k.adx(d["high"], d["low"], d["close"], 10, **kw),
    "adx_no_seed": lambda k, d, **kw: k.adx(d["high"], d["low"], d["close"], 6, **kw),
    "vwap_distance": lambda k, d, **kw: k.vwap_distance(d["close"], d["volume"], 14, True, **kw),
    "flow_acceleration": lambda k, d, **kw: k.comp_flow_acceleration(d["volume"], 14, 5, **kw),
    "flow_acceleration_recent": lambda k, d, **kw: k.comp_flow_acceleration(
        d["volume"], 5, 5, **kw),
    "sma": lambda k, d, **kw: k.sma(d["close"], 14, **kw),
    "comp_zscore": lambda k, d, **kw: k.comp_zscore(d["close"], 14, **kw),
    "cusum_test_rolling": lambda k, d, **kw: k.cusum_test_rolling(d["close"], 50, **kw),
}


@pytest.mark.parametrize("name", list(SHORT))
def test_short_series_matches_jax(name):
    d = _data(False, n=10)
    f = SHORT[name]
    _compare(f(pk, d, device="cpu"), f(jk, d), name)


ERRORS = {
    "ewma_span": lambda k, d, **kw: k.ewma(d["close"], 0, **kw),
    "lagged_returns_window": lambda k, d, **kw: k.comp_lagged_returns(
        d["ts"], d["close"], 0, True, **kw),
    "cusum_nonpositive": lambda k, d, **kw: k.cusum_test_rolling(
        np.where(np.arange(len(d["close"])) == 5, 0.0, d["close"]), **kw),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_errors_match_jax(name):
    d = _data(False, n=64)
    with pytest.raises(ValueError) as want:
        ERRORS[name](jk, d)
    with pytest.raises(ValueError) as got:
        ERRORS[name](pk, d, device="cpu")
    assert str(got.value) == str(want.value)


def test_lagged_returns_search_float64_rounded_timestamps():
    """A tie that only float64 rounding creates: at 2024 epochs a float64
    holds the nanoseconds to 256 ns, so ts[j] = grid + 1 ns rounds onto the
    grid, and the target ts[j+1] - 60 s lands on it exactly. The reference
    searches the rounded values (misc.py:18-19), so the lag is j; an int64
    search would give j - 1."""
    n, j = 64, 30
    ts = T0 + 60 * 10**9 * np.arange(n, dtype=np.int64)
    ts[j] += 1
    close = 100.0 + np.arange(n, dtype=np.float64)
    want = np.asarray(jk.comp_lagged_returns(ts, close, 60, False))
    got = pk.comp_lagged_returns(ts, close, 60, False, device="cpu")
    assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert float(got[j + 1]) == close[j + 1] / close[j] - 1.0
    int_lag = np.searchsorted(ts, ts[j + 1] - 60 * 10**9, side="right") - 1
    assert int_lag == j - 1


def test_burst_ratio_even_window_is_not_torch_median():
    """jnp.median averages the two middle values of an even window;
    torch.median takes the lower one."""
    x = np.array([1.0, 4.0, 2.0, 8.0, 16.0, 3.0])
    got = pk.comp_burst_ratio(x, 4, device="cpu")
    want = np.asarray(jk.comp_burst_ratio(x, 4))
    assert_close(got, want, rtol=RTOL, atol=ATOL)
    lower = torch.from_numpy(x).unfold(0, 4, 1).median(1).values
    assert not np.allclose(got.numpy()[3:], x[3:] / lower.numpy())


def test_catalog_matches_jax():
    assert sorted(pk.__all__) == sorted(jk.__all__)


def test_zscore_on_a_calm_level_within_its_conditioning():
    """On a calm price level (0.06% a bar at 107,000) the z-score's variance,
    ``E[x^2] - E[x]^2`` over the window, cancels about 8 digits, and XLA:CPU
    rounds it in one fused multiply-add that the port does not use: the two
    then differ by about 1e-9. Both are as close to the exact z-score
    (Decimal arithmetic, 50 digits) as the conditioning allows:
    ``|z - exact| <= 4 eps cond (1 + |z|)``, ``cond = E[x^2] / var``."""
    from decimal import Decimal, localcontext
    r = np.random.default_rng(0)
    n, w = 300, 20
    x = 107_000.0 * np.exp(np.cumsum(r.normal(0.0, 6e-4, n)))
    exact, cond = np.full(n, np.nan), np.full(n, np.nan)
    with localcontext() as ctx:
        ctx.prec = 50
        for i in range(w - 1, n):
            win = [Decimal(v) for v in x[i - w + 1:i + 1]]
            m = sum(win) / w
            m2 = sum(v * v for v in win) / w
            exact[i] = float((Decimal(x[i]) - m) / (m2 - m * m).sqrt())
            cond[i] = float(m2 / (m2 - m * m))
    bound = 4 * np.finfo(np.float64).eps * cond * (1.0 + np.abs(exact))
    for what, z in (("port", pk.comp_zscore(x, w, device="cpu").numpy()),
                    ("jax", np.asarray(jk.comp_zscore(x, w)))):
        assert np.array_equal(np.isnan(z), np.isnan(exact)), what
        assert np.all(np.abs(z - exact)[w - 1:] <= bound[w - 1:]), what


def test_import_leaves_out_jax_pandas_and_scipy():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import finmlkit_tpu_torch.feature, finmlkit_tpu_torch.feature.kernels\n"
        "import finmlkit_tpu_torch.ops.scan\n"
        "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
        "bad = new & {'jax', 'jaxlib', 'pandas', 'scipy', 'finmlkit_tpu'}\n"
        "assert 'torch' in sys.modules and not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
