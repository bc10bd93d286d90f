"""CUSUM events, triple-barrier labels and sample weights of
finmlkit_tpu_torch against the JAX package's CPU (float64) path.

Events, labels, touch indices and concurrency must be exact. Returns, barrier
ratios and weights are differences of two prefix sums (of log prices, or of
per-bar contributions) whose terms the two packages round differently (their
log functions, the order of their float64 scans): they must agree within
rtol 1e-12 of the prefix magnitude, i.e. ``|diff| <= 1e-12 * (|want| + scale)``.
"""
import numpy as np
import pytest
import torch

from finmlkit_tpu.label import tbm as jtbm
from finmlkit_tpu.label import weights as jweights
from finmlkit_tpu.sampling import filters as jfilters
from finmlkit_tpu_torch.label import tbm, weights
from finmlkit_tpu_torch.sampling import filters
from finmlkit_tpu_torch.testing import assert_exact, assert_window_close

RTOL = 1e-12


def _bars(seed=0, n=3000):
    r = np.random.default_rng(seed)
    close = 107_000.0 * np.exp(np.cumsum(r.normal(0, 6e-4, n)))
    ts = 1_751_328_000 * 10**9 + 60 * 10**9 * np.arange(1, n + 1, dtype=np.int64)
    return ts, close


@pytest.mark.parametrize("thr", [0.002, 0.0005, "vector"])
def test_cusum_filter_matches_jax(thr):
    _, close = _bars()
    if thr == "vector":
        thr = np.random.default_rng(1).uniform(5e-4, 3e-3, len(close))
    else:
        thr = np.array([thr])
    want = jfilters.cusum_filter(close, thr)
    got = filters.cusum_filter(torch.from_numpy(close), thr)
    assert got.dtype == torch.int64 and len(got) > 10
    assert_exact(got, np.asarray(want, np.int64), "events")


def test_cusum_filter_validates():
    with pytest.raises(ValueError):
        filters.cusum_filter(torch.ones(1, dtype=torch.float64), [0.1])
    with pytest.raises(ValueError):
        filters.cusum_filter(torch.ones(5, dtype=torch.float64), [0.1, 0.2])


def _events(close):
    ev = np.asarray(jfilters.cusum_filter(close, np.array([0.002])), np.int64)
    ev = np.concatenate([ev, [len(close) - 1]])  # last bar: skipped event
    return ev


CONFIGS = {
    "side": dict(horizontal_barriers=(1.0, 1.0), vertical_barrier=3600.0),
    "asymmetric_min_close": dict(horizontal_barriers=(2.0, 0.5),
                                 vertical_barrier=1800.0,
                                 min_close_time_sec=300.0),
    "upper_disabled": dict(horizontal_barriers=(1.0, 0.0),
                           vertical_barrier=3600.0),
    "meta": dict(horizontal_barriers=(1.0, 1.0), vertical_barrier=3600.0,
                 min_ret=0.001, side=True),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_triple_barrier_matches_jax(name):
    ts, close = _bars()
    ev = _events(close)
    tg = np.random.default_rng(2).uniform(0.002, 0.004, len(ev))
    kw = dict(CONFIGS[name])
    side = None
    if kw.pop("side", False):
        side = np.where(np.random.default_rng(3).random(len(ev)) < 0.5, 1.0, -1.0)
    want = jtbm.triple_barrier(ts, close, ev, tg, side=side, **kw)
    got = tbm.triple_barrier(torch.from_numpy(ts), torch.from_numpy(close),
                             torch.from_numpy(ev), torch.from_numpy(tg),
                             side=None if side is None else torch.from_numpy(side),
                             **kw)
    lab, touch, ret, rbr = (np.asarray(x) for x in want)
    assert_exact(got[0], lab.astype(np.int8), "labels")
    assert_exact(got[1], touch.astype(np.int64), "touch")
    scale = float(np.max(np.abs(np.log(close))))
    assert_window_close(got[2], ret, scale, RTOL, "rets")
    # ratios are returns over targets of ~1e-3
    assert_window_close(got[3], rbr, scale / 1e-3, RTOL, "max_rb_ratios")


def _labeled(seed=0):
    ts, close = _bars(seed)
    ev = _events(close)
    tg = np.full(len(ev), 0.003)
    touch = np.array(jtbm.triple_barrier(ts, close, ev, tg, (1.0, 1.0),
                                         3600.0)[1], np.int64)
    return ts, close, ev, touch


def test_average_uniqueness_matches_jax():
    ts, close, ev, touch = _labeled()
    w_j, conc_j = (np.array(x) for x in jweights.average_uniqueness(ts, ev, touch))
    w, conc = weights.average_uniqueness(torch.from_numpy(ts), torch.from_numpy(ev),
                                         torch.from_numpy(touch))
    assert_exact(conc, conc_j.astype(np.int16), "concurrency")
    inv = np.where(conc_j > 0, 1.0 / np.maximum(conc_j, 1), 0.0)
    assert_window_close(w, w_j, np.cumsum(inv).max(), RTOL, "uniqueness")


@pytest.mark.parametrize("normalize", [False, True])
def test_return_attribution_matches_jax(normalize):
    ts, close, ev, touch = _labeled(1)
    _, conc_j = jweights.average_uniqueness(ts, ev, touch)
    conc_j = np.array(conc_j)
    want = np.asarray(jweights.return_attribution(ev, touch, close, conc_j,
                                                  normalize=normalize))
    got = weights.return_attribution(torch.from_numpy(ev), torch.from_numpy(touch),
                                     torch.from_numpy(close),
                                     torch.from_numpy(conc_j), normalize=normalize)
    lr = np.diff(np.log(close)) / np.maximum(conc_j[1:], 1)
    scale = np.abs(np.cumsum(np.where(conc_j[1:] > 0, lr, 0.0))).max()
    if normalize:
        raw = np.asarray(jweights.return_attribution(ev, touch, close, conc_j,
                                                     normalize=False))
        scale *= len(ev) / raw.sum()
    assert_window_close(got, want, scale, RTOL, "return attribution")


def test_weights_validate():
    ev = torch.tensor([1, 2])
    with pytest.raises(ValueError):
        weights.average_uniqueness(torch.arange(5), ev, ev[:1])
    with pytest.raises(ValueError):
        weights.return_attribution(ev, ev, torch.ones(5, dtype=torch.float64),
                                   torch.zeros(5, dtype=torch.int16))
