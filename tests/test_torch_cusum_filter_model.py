"""Kernel Z's scheme on the CPU (``sampling/filters.py
_cusum_filter_walk_model``: chunks, guess walks, lockstep rounds, scan and
write) against the CUSUM filter's loop, event for event.

The loop is ``cusum_filter`` on a CPU tensor where the series is a price
series, and ``_loop``, its transcription on given log returns, where the
returns are chosen directly (dyadic returns, whose sums meet the thresholds
exactly). The walker counts run from one walker (the loop itself) to one a
return. R11's series (``test_torch_cusum_filter_nonfinite.py``) carry a NaN
and a zero price; a monotone series under a threshold no sum reaches gives
walks that never meet, the rounds' worst case: one round a walker.
"""
import numpy as np
import pytest
import torch

from finmlkit_tpu_torch.sampling.filters import _cusum_filter_walk_model, cusum_filter

WALKERS = [1, 2, 7, 64, 1024, "n-1"]
R11 = {"nan": (703, 5990), "zero": (705, 5990)}   # events, the last one


def _loop(log_ret, thr, seen=None):
    """The filter's loop (``sampling/filters.py``) on given log returns.
    ``seen``, a dict, counts the steps where a sum lies on its threshold
    (``"tie"``) and where both lie beyond it (``"both"``)."""
    h = np.broadcast_to(np.asarray(thr, np.float64).reshape(-1), (len(log_ret) + 1,)).tolist()
    events, s_pos, s_neg = [], 0.0, 0.0
    for i, r in enumerate(np.asarray(log_ret, np.float64).tolist(), start=1):
        sp, sn = s_pos + r, s_neg + r
        s_pos = sp if sp > 0.0 else 0.0
        s_neg = sn if sn < 0.0 else 0.0
        if seen is not None:
            seen["tie"] += s_neg == -h[i] or s_pos == h[i]
            seen["both"] += s_neg < -h[i] and s_pos > h[i]
        if s_neg < -h[i]:
            s_neg = 0.0
            events.append(i)
        elif s_pos > h[i]:
            s_pos = 0.0
            events.append(i)
    return events


def _walk(n, seed):
    return 100.0 * np.exp(np.cumsum(np.random.default_rng(seed).normal(0.0, 2e-3, n)))


def _case(name):
    """``(prices or None, log returns, thresholds)`` of a named series."""
    if name in R11:
        p = _walk(6000, 0)
        p[1000] = np.nan if name == "nan" else 0.0
        return p, None, [6e-3]
    if name == "random":
        return _walk(4001, 1), None, [6e-3]
    if name == "per_sample":
        rng = np.random.default_rng(2)
        return _walk(4001, 3), None, 6e-3 * rng.uniform(0.5, 1.5, 4001)
    # dyadic: returns of -3 .. 3 units of 2^-9 and thresholds of 8 or 2 units
    # a sample, so sums land on a threshold exactly and a threshold that drops
    # can find both sums beyond it at once (s_neg is checked first)
    rng = np.random.default_rng(4)
    unit = 2.0 ** -9
    return None, rng.integers(-3, 4, 4000) * unit, rng.choice([8, 2], 4001) * unit


def _returns(p):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log(p[1:] / p[:-1])


@pytest.mark.parametrize("walkers", WALKERS)
@pytest.mark.parametrize("name", ["random", "nan", "zero", "per_sample", "dyadic"])
def test_model_matches_the_loop(name, walkers):
    p, log_ret, thr = _case(name)
    if p is not None:
        log_ret = _returns(p)
        with np.errstate(divide="ignore", invalid="ignore"):
            host = cusum_filter(torch.from_numpy(p), thr).tolist()
        assert host == _loop(log_ret, thr)
    want = _loop(log_ret, thr)
    w = len(log_ret) if walkers == "n-1" else walkers
    got, rounds = _cusum_filter_walk_model(log_ret, thr, w)
    assert got == want
    assert 1 <= rounds <= w
    if name in R11:
        assert (len(got), got[-1]) == R11[name]
    if name == "dyadic":   # the strict comparisons and the order were put to the test
        seen = {"tie": 0, "both": 0}
        _loop(log_ret, thr, seen)
        assert len(want) > 100 and seen["tie"] > 10 and seen["both"] > 0


@pytest.mark.parametrize("walkers", [1, 2, 7, 64, 1024])
def test_walks_that_never_meet_take_a_round_a_walker(walkers):
    p = np.arange(1.0, 1026.0)        # every return positive; s_pos reaches log(1025)
    log_ret = _returns(p)
    assert cusum_filter(torch.from_numpy(p), [10.0]).tolist() == _loop(log_ret, [10.0]) == []
    got, rounds = _cusum_filter_walk_model(log_ret, [10.0], walkers)
    assert got == [] and rounds == walkers


@pytest.mark.parametrize("walkers", [1, 1024])
@pytest.mark.parametrize("p, want", [([1.0, 2.0], [1]), ([2.0, 1.0], [1]), ([1.0, 1.5], []),
                                     ([1.0, np.nan], [])])
def test_two_values(p, want, walkers):
    p = np.asarray(p)
    log_ret = _returns(p)
    with np.errstate(invalid="ignore"):
        assert cusum_filter(torch.from_numpy(p), 0.5).tolist() == want
    assert _cusum_filter_walk_model(log_ret, 0.5, walkers) == (want, 1)
