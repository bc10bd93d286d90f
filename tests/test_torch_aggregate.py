"""The float64 bar products of finmlkit_tpu_torch (``bar/aggregate.py``, plain
path of kernels S and C) against ``finmlkit_tpu.bar.aggregate`` on the CPU,
on prices that sit on no tick grid.

The cases: the unaligned anchor ``ci[0] = -1``, an anchor inside the stream
with trailing trades after the last bar, an empty bar at the anchor (its
close wraps to the last trade), empty bars, single-trade bars, side-0 trades,
``theta == 0`` and bars of zero volume.

Exact: open, high, low, close, trades, the median trade size, ticks_buy and
ticks_sell, cum_ticks_min and cum_ticks_max, max_spread (an extremum of exact
differences) and the NaN positions. The float64 sums are differences of
prefixes that both packages add in their own order, so each is held within
``B = n * eps * sum|x|`` of its terms ``x`` (``testing.prefix_bound``), and
the outputs built on them as ``testing.hold_float_path`` sets out: vwap
within ``(B_dollars + |vwap| B_volume) / volume``, the float32 outputs within
one float32 ulp of the JAX value or ``B`` where that is larger (a sum that
nearly cancels), the trade-size ratios within one ulp or ``4 B / volume``.
The largest errors seen, as shares of these bounds (printed with ``-s``):
vwap 4.2e-4, dollars_buy 2.6e-5, every other output 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finmlkit_tpu.bar import aggregate as jagg
from finmlkit_tpu_torch.bar import aggregate
from finmlkit_tpu_torch.ops import prefix_scan
from finmlkit_tpu_torch.testing import assert_exact, hold_float_path

N = 3000


def _trades(seed=5):
    g = np.random.default_rng(seed)
    px = 100.0 * np.exp(np.cumsum(g.normal(0, 2e-4, N))) + g.random(N) * 1e-6
    amt = np.maximum(g.lognormal(-2.5, 1.2, N), 1e-5).astype(np.float32)
    side = g.choice(np.array([-1, 0, 1], np.int8), N, p=[0.45, 0.1, 0.45])
    amt[1200:1210] = 0.0        # bar "zero volume" below
    return px, amt, side


def _ci(name, seed=6):
    """Close indices of a case: bars of 1-40 trades, some empty, some of one
    trade, and the case's own anchor and ends."""
    g = np.random.default_rng(seed)
    first = {"anchor": -1, "inside": 99, "empty_first": -1}[name]
    ci, pos = [first], first
    if name == "empty_first":
        ci.append(-1)
    end = N - 1 if name != "inside" else N - 60
    while pos < end:
        u = g.random()
        prev = pos
        pos = pos if u < 0.08 else pos + (1 if u < 0.2 else int(g.integers(2, 40)))
        pos = min(pos, end)
        if prev < 1199 < pos:
            pos = 1199
        elif prev == 1199:
            pos = 1209          # one bar of exactly the ten zero amounts
        ci.append(pos)
    ci = np.asarray(ci, np.int64)
    assert (np.diff(ci) == 0).any() and (np.diff(ci) == 1).any()
    return ci


CASES = ["anchor", "inside", "empty_first"]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    px, amt, side = _trades()
    ci = _ci(request.param)
    t = dict(px=torch.from_numpy(px), amt=torch.from_numpy(amt),
             side=torch.from_numpy(side), ci=torch.from_numpy(ci))
    j = dict(px=jnp.asarray(px), amt=jnp.asarray(amt), side=jnp.asarray(side),
             ci=jnp.asarray(ci))
    return request.param, px, amt, side, ci, t, j


def _want(fn, *args):
    return {k: np.asarray(v) for k, v in fn(*args).items()}


def test_ohlcv_matches_jax(case):
    name, px, amt, side, ci, t, j = case
    want = _want(jagg.comp_bar_ohlcv, j["px"], j["amt"], j["ci"])
    got = aggregate.comp_bar_ohlcv(t["px"], t["amt"], t["ci"])
    plain = aggregate.comp_bar_ohlcv(t["px"], t["amt"], t["ci"],
                                     cumsum=prefix_scan.fast_cumsum_plain)
    assert set(got) == set(want)   # a jitted dict comes back with sorted keys
    for k in got:
        assert_exact(got[k], plain[k], f"ohlcv.{k} vs plain")
    shares = hold_float_path(got, want, px, amt, want["volume"], "ohlcv")
    assert (np.diff(ci)[want["volume"] == 0] > 0).any()   # a bar of zero volume
    if name == "empty_first":
        assert want["close"][0] == px[-1]                  # the wrapped close
    print(name, "shares of the bounds:", shares)


def test_directional_matches_jax(case):
    name, px, amt, side, ci, t, j = case
    want = _want(jagg.comp_bar_directional_features, j["px"], j["amt"], j["ci"],
                 j["side"])
    got = aggregate.comp_bar_directional_features(t["px"], t["amt"], t["ci"], t["side"])
    plain = aggregate.comp_bar_directional_features(
        t["px"], t["amt"], t["ci"], t["side"], cumsum=prefix_scan.fast_cumsum_plain,
        cumsum_cols=prefix_scan.fast_cumsum_cols_plain)
    assert set(got) == set(want)
    for k in got:
        assert_exact(got[k], plain[k], f"directional.{k} vs plain")
    vol = _want(jagg.comp_bar_ohlcv, j["px"], j["amt"], j["ci"])["volume"]
    shares = hold_float_path(got, want, px, amt, vol, "directional")
    assert np.isnan(want["mean_spread"][np.diff(ci) == 0]).all()
    assert (want["cum_ticks_max"] == -10**9).any()   # bars without a signed trade
    print(name, "shares of the bounds:", shares)


@pytest.mark.parametrize("theta_kind", ["median", "zeros"])
def test_trade_size_matches_jax(case, theta_kind):
    name, px, amt, side, ci, t, j = case
    g = np.random.default_rng(8)
    theta = g.uniform(0.02, 0.2, len(ci) - 1)
    if theta_kind == "zeros":
        theta[::5] = 0.0
    want = _want(jagg.comp_bar_trade_size_features, j["amt"], jnp.asarray(theta),
                 j["ci"], 5.0)
    th = torch.from_numpy(theta)
    got = aggregate.comp_bar_trade_size_features(t["amt"], th, t["ci"], 5.0)
    plain = aggregate.comp_bar_trade_size_features(t["amt"], th, t["ci"], 5.0,
                                                   cumsum=prefix_scan.fast_cumsum_plain)
    assert set(got) == set(want)
    for k in got:
        assert_exact(got[k], plain[k], f"trade_size.{k} vs plain")
    vol = _want(jagg.comp_bar_ohlcv, j["px"], j["amt"], j["ci"])["volume"]
    shares = hold_float_path(got, want, px, amt, vol, "trade size")
    if theta_kind == "zeros":
        assert np.isnan(want["mean_size_rel"][::5]).all()
    assert np.isnan(want["size_gini"][np.diff(ci) == 0]).all()
    print(name, theta_kind, "shares of the bounds:", shares)
