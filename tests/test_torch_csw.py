"""The CSW CUSUM structural-break test of finmlkit_tpu_torch (plain path of
kernel W, ``feature/kernels/structural_break.py``) against the JAX package on
XLA:CPU and against a transcription of the reference's loop in numpy.

``up`` and ``down`` are quotients of the same float operations on the same
sigma: equal within rtol 1e-12. The critical values ``sqrt(4.6 + log k*)``
differ by at least 1e-5 from one lag to the next, so agreeing within rtol
1e-12 means the same lag k* was chosen. The series cover flat runs (ties at
0, where the largest lag wins; a window of one price, where sigma is 0 and
the ``bad`` mask applies), the warm-up, and NaN prices.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finmlkit_tpu.feature.kernels import structural_break as jsb
from finmlkit_tpu_torch.feature.kernels import structural_break as psb
from finmlkit_tpu_torch.testing import assert_close

RTOL = ATOL = 1e-12
N, W = 400, 100


def _prices(kind: str, n: int = N, seed: int = 0) -> np.ndarray:
    r = np.random.default_rng(seed)
    if kind == "walk":
        return 100.0 * np.exp(np.cumsum(r.normal(0.0, 1e-3, n)))
    # a tick grid with many unchanged prices, and a flat run longer than W
    steps = r.choice([-1, 0, 0, 0, 1], n).astype(np.float64)
    steps[150:150 + W + 20] = 0.0
    p = 100.0 + 0.5 * np.cumsum(steps)
    if kind == "nan":
        p[250] = np.nan
    return p


KINDS = ["walk", "flat", "nan"]


def _check(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, np.asarray(w), rtol=RTOL, atol=ATOL, what=f"{what}[{i}]")


@pytest.mark.parametrize("kind", KINDS)
def test_sup_stat_plain_matches_jax(kind):
    """The statistic alone, before the masks, on one (n, w - 1) block."""
    y = torch.log(torch.from_numpy(_prices(kind)))
    t_loc, sigma = psb._sigma(y, W)
    sqrt_k, crit = psb._tables(W, "cpu")
    got = psb._sup_stat_plain(y, sigma, W, sqrt_k, crit)
    t = np.arange(N)
    lag = np.arange(1, W, dtype=np.int64)
    yn = y.numpy()
    valid = (lag[None, :] >= 2) & (lag[None, :] <= t_loc.numpy()[:, None] - 1)
    want = jsb._sup_stat(jnp.asarray(yn), jnp.asarray(yn[np.clip(t[:, None] - lag, 0, N - 1)]),
                         jnp.asarray(lag), jnp.asarray(sigma.numpy()), jnp.asarray(valid))
    _check(got, want, kind)


def _reference_loop(y, window, warmup):
    """The reference's loop (structural_break/cusum.py:179-274 as the JAX
    package documents it): for each t, the lags from t_loc - 1 down to 2, a
    running maximum from -1e-6 replaced only by a strictly greater value;
    finite inputs only (a NaN compares false there, where the JAX package
    floors the whole t)."""
    n = len(y)
    _, sigma = psb._sigma(torch.from_numpy(y), window)
    sigma = sigma.numpy()
    out = np.full((4, n), np.nan)
    for t in range(warmup, n):
        t_loc = min(t, window)
        if t_loc < 1 or sigma[t] <= 0.0:
            out[:, t] = (-1e-6, -1e-6, 0.0, 0.0)
            continue
        best = [-1e-6, -1e-6]
        lag = [0, 0]
        for k in range(t_loc - 1, 1, -1):
            denom = sigma[t] * np.sqrt(np.float64(k))
            if not denom > 1e-16:
                continue
            dyn = y[t] - y[t - k]
            for side, s in enumerate((max(dyn, 0.0) / denom, -min(dyn, 0.0) / denom)):
                if s > best[side]:
                    best[side], lag[side] = s, k
        crit = [np.sqrt(4.6 + np.log(k)) if k > 0 else 0.0 for k in lag]
        out[:, t] = (best[0], best[1], crit[0], crit[1])
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_rolling_matches_jax(kind):
    p = _prices(kind)
    got = psb.cusum_test_rolling(p, W, 30, device="cpu")
    _check(got, jsb.cusum_test_rolling(p, W, 30), kind)
    if kind != "nan":
        _check(got, _reference_loop(np.log(p), W, 30), f"{kind} vs loop")


@pytest.mark.parametrize("kind", KINDS)
def test_developing_and_last_match_jax(kind):
    p = _prices(kind, n=300)
    _check(psb.cusum_test_developing(p, 30, device="cpu"),
           jsb.cusum_test_developing(p, 30), kind)
    got, want = psb.cusum_test_last(p, device="cpu"), jsb.cusum_test_last(p)
    assert_close(np.array(got), np.array(want), rtol=RTOL, atol=ATOL, what=kind)


def test_flat_ties_keep_the_largest_lag():
    """Where y_t is the window's minimum no lag moves up: every admissible
    lag gives up = 0, and up's critical value must be that of the largest
    lag, t_loc - 1."""
    p = np.full(N, 100.0)
    p[::7] += 0.5           # sigma > 0, many exact ties at 0
    up, _, cu, _ = psb.cusum_test_rolling(p, W, 30, device="cpu")
    t = np.arange(N)
    low = (p == 100.0) & (t >= W)
    assert low.sum() > 100
    want = np.full(N, np.sqrt(4.6 + np.log(W - 1.0)))   # t_loc = W
    assert np.array_equal(up.numpy()[low], np.zeros(low.sum()))
    assert_close(cu.numpy()[low], want[low], rtol=RTOL, atol=ATOL)


def test_window_and_warmup_edges_match_jax():
    p = _prices("walk", n=40)
    for window, warmup in ((5, 30), (1000, 10)):
        _check(psb.cusum_test_rolling(p, window, warmup, device="cpu"),
               jsb.cusum_test_rolling(p, window, warmup), f"w {window}")
