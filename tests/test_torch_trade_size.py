"""Trade-size features of finmlkit_tpu_torch (``bar/aggregate_q.py``, plain
paths of kernels S and C) against the JAX package on the CPU.

Against the f64 path ``comp_bar_trade_size_features``: NaN masks equal and
values within rtol 1e-6 (two float32 roundings apart: the port sums the
quantized amounts ``units * 1e-8``, the f64 path the float32 amounts), plus
the f64 path's own rounding: it takes each bar's sums (volume, block volume,
squares) as differences of float64 prefixes over all trades, whose error is
about ``eps * max|prefix|`` whatever the bar's size. With ``P`` the largest
prefix of amounts, ``B`` of block amounts and ``S`` of squares, a bar of
volume V gets ``1e-14 * P / V`` in ``mean_size_rel``, ``1e-14 * (P + B) / V``
in ``pct_block`` and ``1e-14 * (S / V^2 + 2 P / V)`` in ``size_gini``. The
port sums each bar on its own. Reached: on the JAX tests' trades all four
features are equal; on the adversarial trades (amounts from 1e-8 to 1e4)
``mean_size_rel`` is within 2.5e-7 and ``size_95_rel`` equal, while 20-33
of some 500 bars exceed rtol 1e-6 in ``size_gini`` (one in ``pct_block``),
all inside the f64 path's rounding: against exact per-bar sums
(``math.fsum``) the port's gini is within 1e-7, the f64 path's off by up to
1.3e-3.

Against ``comp_bar_trade_size_features_q``: rtol 3e-5, atol 1e-6, the JAX
package's own bound (``tests/bars/test_aggregate_q.py``), except
``pct_block``
- of bars that hold a trade within 1e-4 of their block threshold: the
  ``_q`` path's float32 threshold, forward-filled by a float32 prefix, may
  classify the trade the other way (ROADMAP R5);
- of every bar after a bar with ``theta == 0``: the ``_q`` path fills that
  bar's threshold with 3e38, and the float32 prefix that forward-fills the
  thresholds loses every later threshold to cancellation (ROADMAP R7); the
  test pins that those bars differ.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finmlkit_tpu.bar import aggregate, aggregate_q
from finmlkit_tpu.bar.indexers import time_bar_indexer as jax_time_bar_indexer
from finmlkit_tpu.bar.quantize import quantize_trades
from finmlkit_tpu_torch.bar.aggregate_q import bar_trade_size_features
from finmlkit_tpu_torch.ops import prefix_scan
from finmlkit_tpu_torch.testing import adversarial_trades
from tests.conftest import generate_trades

THETA_MULT = 5.0
KEYS = ("mean_size_rel", "size_95_rel", "pct_block", "size_gini")


def _bar_medians(amounts, ci):
    return np.array([np.median(amounts[s + 1:e + 1].astype(np.float64))
                     if e > s else 0.0 for s, e in zip(ci[:-1], ci[1:])])


def _case(name):
    if name == "time_bars_scalar_theta":  # the JAX test's trades and theta
        ts, px, amt, _ = generate_trades(n=5000, seed=1)
        amt = amt.astype(np.float32)
        q = quantize_trades(px, amt)
        ci = np.array(jax_time_bar_indexer(jnp.asarray(ts), 60.0)[1])
        return q.amount_units, amt, ci, 0.05
    first = 25 if name == "first_after_0" else -1
    _, units, _, amt, ci = adversarial_trades(n=20_000, seed=11, first=first,
                                              mean_bar=40)
    theta = _bar_medians(amt, ci)
    if name == "theta_zero":
        theta[::4] = 0.0
    else:  # empty bars take the theta of the bar before
        for k in np.flatnonzero(theta == 0):
            theta[k] = theta[k - 1] if k else np.median(amt)
    return units, amt, ci, theta


CASES = ["time_bars_scalar_theta", "per_bar_theta", "first_after_0",
         "theta_zero"]


@pytest.fixture(scope="module", params=CASES)
def ts_case(request):
    units, amt, ci, theta = _case(request.param)
    n_bars = len(ci) - 1
    theta_bars = np.broadcast_to(np.asarray(theta, np.float64), (n_bars,)).copy()
    f64 = aggregate.comp_bar_trade_size_features(
        jnp.asarray(amt), jnp.asarray(theta_bars), jnp.asarray(ci), THETA_MULT)
    q = aggregate_q.comp_bar_trade_size_features_q(
        jnp.asarray(units), jnp.asarray(amt), theta_bars, jnp.asarray(ci),
        THETA_MULT, 1e-8)
    before = (prefix_scan.LAUNCHES, prefix_scan.COLS_LAUNCHES)
    got = bar_trade_size_features(torch.from_numpy(units), torch.from_numpy(amt),
                                  torch.from_numpy(ci), theta,
                                  theta_mult=THETA_MULT, amount_scale=1e-8)
    assert (prefix_scan.LAUNCHES, prefix_scan.COLS_LAUNCHES) == before
    return dict(name=request.param, units=units, amt=amt, ci=ci,
                theta=theta_bars, got=got,
                f64={k: np.asarray(v) for k, v in f64.items()},
                q={k: np.asarray(v) for k, v in q.items()})


def _f64_atol(amt, ci, thr):
    """The f64 path's prefix rounding, per bar and key (see the module note)."""
    a = amt.astype(np.float64)
    bar = np.searchsorted(ci[1:], np.arange(len(a)))  # bar of each trade
    over = (bar < len(thr)) & (a > thr[np.minimum(bar, len(thr) - 1)])
    P, B, S = (np.abs(np.cumsum(x)).max() for x in (a, np.where(over, a, 0.0), a * a))
    vol = np.array([a[s + 1:e + 1].sum() for s, e in zip(ci[:-1], ci[1:])])
    vol = np.where(vol > 0, vol, 1.0)
    return {"mean_size_rel": 1e-14 * P / vol, "size_95_rel": 0.0 * vol,
            "pct_block": 1e-14 * (P + B) / vol,
            "size_gini": 1e-14 * (S / vol**2 + 2 * P / vol)}


def test_matches_f64_path(ts_case):
    got, want = ts_case["got"], ts_case["f64"]
    atol = _f64_atol(ts_case["amt"], ts_case["ci"], ts_case["theta"] * THETA_MULT)
    for k in KEYS:
        assert got[k].dtype == torch.float32
        g, w = got[k].numpy().astype(np.float64), want[k]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        m = ~np.isnan(w)
        bad = np.abs(g - w)[m] > 1e-6 * np.abs(w[m]) + atol[k][m]
        assert not bad.any(), (k, np.flatnonzero(m)[bad][:5])
    counts = np.diff(ts_case["ci"])
    assert np.isnan(got["mean_size_rel"].numpy()[counts == 0]).all()
    assert np.isnan(got["mean_size_rel"].numpy()[ts_case["theta"] == 0]).all()
    gini = got["size_gini"].numpy()
    single = (counts == 1) & (ts_case["theta"] != 0)
    assert (gini[single] == 0).all()
    if ts_case["name"] != "time_bars_scalar_theta":
        assert (counts == 0).any() and single.any()


def test_gini_matches_exact_sums(ts_case):
    amt, ci = ts_case["amt"], ts_case["ci"]
    got = ts_case["got"]["size_gini"].numpy()
    for k, (s, e) in enumerate(zip(ci[:-1], ci[1:])):
        a = amt[s + 1:e + 1].astype(np.float64)
        if len(a) < 2 or ts_case["theta"][k] == 0:
            continue
        vol = math.fsum(a)
        want = 1.0 - math.fsum(a * a) / (vol * vol)
        assert abs(got[k] - want) <= 1e-6 * want, (k, got[k], want)


def _near_threshold_bars(amt, ci, thr):
    near = np.zeros(len(ci) - 1, bool)
    for k, (s, e) in enumerate(zip(ci[:-1], ci[1:])):
        a = amt[s + 1:e + 1].astype(np.float64)
        near[k] = thr[k] > 0 and np.any(np.abs(a - thr[k]) <= 1e-4 * thr[k])
    return near


def test_matches_q_path(ts_case):
    got, q = ts_case["got"], ts_case["q"]
    near = _near_threshold_bars(ts_case["amt"], ts_case["ci"],
                                ts_case["theta"] * THETA_MULT)
    assert near.mean() < 0.05
    zero = np.flatnonzero(ts_case["theta"] == 0)
    if len(zero):  # R7: every threshold after the first zero theta is lost
        after = np.arange(len(near)) > zero[0]
        a, b = got["pct_block"].numpy()[after], q["pct_block"][after]
        m = ~(np.isnan(a) | np.isnan(b))
        assert np.mean(np.abs(a[m] - b[m]) > 3e-5 * np.abs(b[m]) + 1e-6) > 0.5
        near |= after
    for k in KEYS:
        keep = ~near if k == "pct_block" else np.ones_like(near)
        a, b = got[k].numpy()[keep], q[k][keep]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        m = ~np.isnan(b)
        np.testing.assert_allclose(a[m], b[m], rtol=3e-5, atol=1e-6, err_msg=k)


def test_scalar_theta_equals_per_bar_theta():
    _, units, _, amt, ci = adversarial_trades(n=3000, seed=12, mean_bar=30)
    args = (torch.from_numpy(units), torch.from_numpy(amt), torch.from_numpy(ci))
    a = bar_trade_size_features(*args, 0.01, amount_scale=1e-8)
    b = bar_trade_size_features(*args, np.full(len(ci) - 1, 0.01),
                                amount_scale=1e-8)
    for k in KEYS:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)
    with pytest.raises(ValueError):
        bar_trade_size_features(*args, np.full(len(ci), 0.01), amount_scale=1e-8)
