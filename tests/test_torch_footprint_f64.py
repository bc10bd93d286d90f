"""The float64 footprint grid of finmlkit_tpu_torch (``bar/footprint.py
comp_bar_footprints``, plain path of kernel S) and the routes to it through
``bar/footprint_q.py bar_footprints``, against
``finmlkit_tpu.bar.footprint.comp_bar_footprints`` on the CPU.

Levels, level counts and tick counts are exact, volumes within one float32
ulp (both sum a cell's float64 amounts and round once; the order of the adds
may differ). Where no volume differs, every flag and feature is held to the
JAX output (exact, ``vp_skew`` and ``vp_gini`` within 1e-9 as in
``tests/test_torch_footprint.py``); where one does, to the JAX features of the
port's own grids. The routes: trades on a 0.1 tick with a footprint tick of
0.25, which does not refine it, and trades on no tick grid (``ticks`` None,
the kits' float form). ROADMAP R16: a bar whose levels leave int32 raises,
where the JAX function saturates its int32 cast.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finmlkit_tpu.bar import aggregate as jagg
from finmlkit_tpu.bar.footprint import comp_bar_footprints as jax_fp
from finmlkit_tpu.bar.footprint import footprint_features_from_tensors as jax_features
from finmlkit_tpu.ops.scan import next_bucket
from finmlkit_tpu_torch.bar.footprint import comp_bar_footprints
from finmlkit_tpu_torch.bar.footprint_q import bar_footprints
from finmlkit_tpu_torch.ops import prefix_scan
from finmlkit_tpu_torch.testing import assert_exact
from finmlkit_tpu_torch.utils import trace
from tests.test_torch_footprint import _compare

N = 4000
GRID_KEYS = ("low_level", "n_levels", "buy_ticks", "sell_ticks")


def _stream(kind, seed=3):
    g = np.random.default_rng(seed)
    px = 100.0 * np.exp(np.cumsum(g.normal(0, 3e-4, N)))
    if kind == "grid_0.1":
        px = np.round(px, 1)
    else:
        px = px + g.random(N) * 1e-7          # on no tick grid
    amt = np.maximum(g.lognormal(-2.5, 1.2, N), 1e-5).astype(np.float32)
    side = g.choice(np.array([-1, 0, 1], np.int8), N, p=[0.45, 0.1, 0.45])
    pos, ci = -1, [-1]
    while pos < N - 30:
        u = g.random()
        pos = min(pos + (0 if u < 0.05 else 1 if u < 0.12 else int(g.integers(2, 120))),
                  N - 30)
        ci.append(pos)
    return px, amt, side, np.asarray(ci, np.int64)


def _ohlcv(px, amt, ci):
    o = jagg.comp_bar_ohlcv(jnp.asarray(px), jnp.asarray(amt), jnp.asarray(ci))
    return np.array(o["low"]), np.array(o["high"])


def _want(px, amt, side, ci, tick, low, high, L):
    out = jax_fp(jnp.asarray(px), jnp.asarray(amt), jnp.asarray(ci), jnp.asarray(side),
                 tick, jnp.asarray(low), jnp.asarray(high), 3.0, max_levels=L)
    return {k: np.asarray(v) for k, v in out.items()}


def _hold(got, want, what):
    """Grids exact, volumes within a float32 ulp; the flags and features
    against the JAX output, or against the JAX features of the port's grids
    where a volume differs. Returns the number of volume cells that differ."""
    for k in GRID_KEYS:
        assert_exact(got[k], want[k], f"{what} {k}")
    off = 0
    for k in ("buy_volumes", "sell_volumes"):
        w = want[k]
        d = np.abs(got[k].numpy().astype(np.float64) - w)
        assert np.all(d <= np.spacing(np.abs(w))), f"{what} {k}: beyond one ulp"
        off += int((d > 0).sum())
    if off == 0:
        _compare(got, want, what)
    else:
        ref = jax_features(*(jnp.asarray(got[k].numpy()) for k in (
            "low_level", "n_levels", "buy_volumes", "sell_volumes", "buy_ticks",
            "sell_ticks")), 3.0)
        _compare(got, {k: np.asarray(v) for k, v in ref.items()}, f"{what}, own grids")
    return off


@pytest.mark.parametrize("tick", [0.01, 0.05, 0.25])
def test_float_grid_matches_jax(tick):
    px, amt, side, ci = _stream("off_grid")
    low, high = _ohlcv(px, amt, ci)
    nl = np.round(high / tick) - np.round(low / tick) + 1
    L = next_bucket(int(nl.max()), 8)
    want = _want(px, amt, side, ci, tick, low, high, L)
    t = [torch.from_numpy(a) for a in (px, amt, ci, side)]
    before = trace.counter("launch.S")
    got = comp_bar_footprints(*t, tick, torch.from_numpy(low), torch.from_numpy(high),
                              3.0, max_levels=L)
    assert trace.counter("launch.S") == before   # CPU tensors: the plain scan
    plain = comp_bar_footprints(*t, tick, torch.from_numpy(low), torch.from_numpy(high),
                                3.0, max_levels=L, cumsum=prefix_scan.fast_cumsum_plain)
    for k in got:
        assert_exact(got[k], plain[k], f"{k} vs plain")
    _hold(got, want, f"tick {tick}")
    assert int(got["buy_ticks"].sum() + got["sell_ticks"].sum()) == int(
        (side[ci[0] + 1:ci[-1] + 1] != 0).sum())


@pytest.mark.parametrize("route", ["not_refining", "no_grid"])
def test_bar_footprints_routes_to_the_float_grid(route):
    if route == "not_refining":
        # trades on a 0.1 grid, footprints on 0.25: 0.1 / 0.25 is no integer
        px, amt, side, ci = _stream("grid_0.1")
        ticks = torch.from_numpy(np.round(px / 0.1).astype(np.int32))
        kw = dict(tick_size=0.1, price_tick_size=0.25)
        tick = 0.25
    else:
        px, amt, side, ci = _stream("off_grid")
        ticks, kw, tick = None, dict(tick_size=None, price_tick_size=0.05), 0.05
    low, high = _ohlcv(px, amt, ci)
    ohlcv = {"low": torch.from_numpy(low), "high": torch.from_numpy(high)}
    t = [torch.from_numpy(a) for a in (amt, ci, side)]
    got = bar_footprints(ticks, *t[:2], t[2], ohlcv, prices=torch.from_numpy(px), **kw)
    nl = np.round(high / tick) - np.round(low / tick) + 1
    want = _want(px, amt, side, ci, tick, low, high, next_bucket(int(nl.max()), 8))
    _hold(got, want, route)
    if route == "not_refining":
        # without the prices the route takes ticks * tick_size
        again = bar_footprints(ticks, *t[:2], t[2], ohlcv, **kw)
        for k in got:
            assert_exact(again[k], got[k], f"{k}, prices from the ticks")
    else:
        with pytest.raises(ValueError, match="price_tick_size"):
            bar_footprints(None, *t[:2], t[2], ohlcv, tick_size=None,
                           prices=torch.from_numpy(px))


def test_r16_levels_outside_int32_raise():
    # ROADMAP R16: a BTC-like price at a 1e-5 footprint tick is 1.07e10 levels
    # from zero; the JAX function casts round(price / tick) to int32 unchecked
    # and saturates (XLA:CPU gives 2**31 - 1), the port raises
    g = np.random.default_rng(16)
    n = 200
    px = 107_000.0 + np.cumsum(g.normal(0, 1e-4, n))
    amt = np.full(n, 0.01, np.float32)
    side = np.where(g.random(n) < 0.5, 1, -1).astype(np.int8)
    ci = np.array([-1, 99, n - 1], np.int64)
    low, high = _ohlcv(px, amt, ci)
    tick = 1e-5
    want = _want(px, amt, side, ci, tick, low, high, 8)
    assert (want["low_level"] == 2**31 - 1).all()
    with pytest.raises(ValueError, match="int32"):
        comp_bar_footprints(*(torch.from_numpy(a) for a in (px, amt, ci, side)), tick,
                            torch.from_numpy(low), torch.from_numpy(high), 3.0,
                            max_levels=8)
    with pytest.raises(ValueError, match="int32"):
        bar_footprints(None, torch.from_numpy(amt), torch.from_numpy(ci),
                       torch.from_numpy(side),
                       {"low": torch.from_numpy(low), "high": torch.from_numpy(high)},
                       tick_size=None, price_tick_size=tick, prices=torch.from_numpy(px))


def test_grid_beyond_free_memory_raises_before_it_allocates():
    # a tick far below the prices' spread asks for about 1.9e9 levels in each
    # of 1000 bars: about 1.8e14 bytes, which no device holds (were the check
    # gone, the first allocation would fail at once, untouched)
    g = np.random.default_rng(9)
    n = 4000
    px = np.where(np.arange(n) % 2 == 0, 0.1, 2.0) + g.random(n) * 1e-7
    amt = np.full(n, 0.01, np.float32)
    side = np.where(g.random(n) < 0.5, 1, -1).astype(np.int8)
    ci = np.arange(-1, n, 4, dtype=np.int64)
    low, high = _ohlcv(px, amt, ci)
    ohlcv = {"low": torch.from_numpy(low), "high": torch.from_numpy(high)}
    with pytest.raises(ValueError, match="coarser"):
        bar_footprints(None, torch.from_numpy(amt), torch.from_numpy(ci),
                       torch.from_numpy(side), ohlcv, tick_size=None,
                       price_tick_size=1e-9, prices=torch.from_numpy(px))
