"""``z_score_peak_filter`` (``finmlkit_tpu_torch/sampling/filters.py``),
``time_decay`` and ``class_balance_weights`` (``label/weights.py``) against the
JAX package.

The filter is held to ``tests/sampling/test_z_score_peak_filter.py``'s numpy
oracle, and to the JAX function, over windows 1, 5 and 50 and thresholds 0.5
and 3, on normal noise and on rounded prices with flat runs. Indices are
exact, except those whose z-score (the oracle's) lies within 1e-9 relative of
the threshold: there the two prefix sums' rounding decides. The JAX function
also signals at flat windows, whose variance its prefix differences leave
positive (ROADMAP.md, Queue 3, R14): its extra indices must all be flat
windows. The weights: within rtol 1e-12; the class balance's labels exact.
"""
import numpy as np
import pytest
import torch

from finmlkit_tpu.label import weights as jweights
from finmlkit_tpu.sampling import z_score_peak_filter as jz
from finmlkit_tpu_torch.label import weights
from finmlkit_tpu_torch.ops import prefix_scan
from finmlkit_tpu_torch.sampling import z_score_peak_filter
from finmlkit_tpu_torch.testing import assert_close, assert_exact
from tests.sampling.test_z_score_peak_filter import oracle

TIE = 1e-9


def _series(name):
    r = np.random.default_rng(3)
    if name == "noise":
        y = r.normal(0, 1, 2000)
        y[500] += 8.0
        y[1200] -= 9.0
        return y
    return np.round(100 + np.cumsum(r.normal(0, 0.3, 3000)), 0)   # "stale" prices


def _zscores(y, window):
    z = np.full(len(y), np.nan)
    for i in range(window, len(y)):
        w = y[i - window:i]
        s = w.std()
        if s > 0:
            z[i] = abs(y[i] - w.mean()) / s
    return z


def _flat(y, window):
    return {i for i in range(window, len(y)) if np.all(y[i - window:i] == y[i - 1])}


@pytest.mark.parametrize("series", ["noise", "stale"])
@pytest.mark.parametrize("threshold", [0.5, 3.0])
@pytest.mark.parametrize("window", [1, 5, 50])
def test_z_score_matches_oracle_and_jax(series, window, threshold):
    y = _series(series)
    got = z_score_peak_filter(torch.from_numpy(y), window, threshold)
    assert got.dtype == torch.int64
    z = _zscores(y, window)
    ties = set(np.flatnonzero(np.abs(z - threshold) <= TIE * threshold).tolist())
    g = set(got.tolist())
    want = set(oracle(y, window, threshold).tolist())
    assert g - ties == want - ties
    assert g or window == 1
    j = set(np.asarray(jz(y, window, threshold)).tolist())
    assert g - ties <= j
    assert (j - g) - ties <= _flat(y, window)


def test_z_score_flat_series_and_numpy_input():
    assert len(z_score_peak_filter(np.ones(100), 10, 3.0, device="cpu")) == 0
    assert len(jz(np.ones(100), 10, 3.0)) == 0
    y = _series("noise")
    assert_exact(z_score_peak_filter(y, 50, 3.0, device="cpu"),
                 z_score_peak_filter(torch.from_numpy(y), 50, 3.0), "numpy input")


def test_z_score_plain_cumsum_and_errors():
    y = torch.from_numpy(_series("noise"))
    assert_exact(z_score_peak_filter(y, 50, 3.0, cumsum=prefix_scan.fast_cumsum_plain),
                 z_score_peak_filter(y, 50, 3.0), "cumsum")
    for fn in (lambda *a: z_score_peak_filter(torch.ones(50, dtype=torch.float64), *a),
               lambda *a: jz(np.ones(50), *a)):
        with pytest.raises(ValueError, match="window must be >= 1"):
            fn(0, 3.0)
    for fn in (lambda *a: z_score_peak_filter(torch.ones(5, dtype=torch.float64), *a),
               lambda *a: jz(np.ones(5), *a)):
        with pytest.raises(ValueError, match="at least window \\+ 2 observations"):
            fn(10, 3.0)


def _uniqueness(n=400, seed=1):
    return np.random.default_rng(seed).uniform(0.05, 1.0, n)


@pytest.mark.parametrize("last_weight", [-1.0, -0.5, 0.0, 0.5, 1.0])
def test_time_decay_matches_jax(last_weight):
    u = _uniqueness()
    want = np.asarray(jweights.time_decay(u, last_weight))
    got = weights.time_decay(torch.from_numpy(u), last_weight)
    assert got.dtype == torch.float64
    assert_close(got, want, rtol=1e-12, what="time decay")
    if last_weight < 0 and last_weight > -1:
        assert bool((got == 0).any()) and bool((got > 0).any())


def test_time_decay_errors_match_jax():
    u = torch.from_numpy(_uniqueness())
    for fn in (weights.time_decay, jweights.time_decay):
        with pytest.raises(ValueError, match=r"last_weight must lie in \[-1, 1\]"):
            fn(u if fn is weights.time_decay else u.numpy(), 1.5)
        with pytest.raises(ValueError, match="must be greater than 0"):
            fn(u * 0 if fn is weights.time_decay else u.numpy() * 0, 0.5)


@pytest.mark.parametrize("case", ["three", "zero_weight_class", "one_class", "int64_labels"])
def test_class_balance_matches_jax(case):
    r = np.random.default_rng(7)
    labels = r.choice(np.array([-1, 0, 1], np.int8), 500)
    base = r.uniform(0.1, 2.0, 500)
    if case == "zero_weight_class":
        base[labels == 0] = 0.0
    elif case == "one_class":
        labels[:] = 1
    elif case == "int64_labels":
        labels = labels.astype(np.int64) * 7
    want = jweights.class_balance_weights(labels, base)
    got = weights.class_balance_weights(torch.from_numpy(labels), torch.from_numpy(base))
    assert_exact(got[0], np.asarray(want[0]), "classes")
    for g, w, what in zip(got[1:], want[1:], ("class weights", "class sums", "final")):
        assert_close(g, np.asarray(w), rtol=1e-12, what=what)
    if case == "zero_weight_class":
        assert float(got[1][1]) == 0.0 and bool((got[3][torch.from_numpy(labels) == 0] == 0).all())
