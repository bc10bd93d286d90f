"""Kernel D's warp step and chunked volume walk, modelled on the CPU on exact
integers (``ops/float_walk.py walk_warp`` and ``walk_chunked``), against the
unfused loop of ``native/seg_stats.cpp:183-211`` (``unfused_oracle``) and the
port's plain loops, close for close, on ``testing.FLOAT_WALK_CASES``: the
off-grid draws at thresholds total / K, dyadic streams with ties on many
steps, sums that reach the threshold exactly, trades above the threshold, a
first trade above it, one and two trades and ``max_bars`` reached; the volume
walk at 1, 2, 7 and 64 chunks, of the kernel's tiles of 768 trades and of
tiles of 128.

The identity the warp step rests on is checked alone: ``fl(g + x)`` for a
state g of one binade against its grid step (``grid_step``), ties included,
with ``fractions.Fraction``, and the kernel's float64 form of the step
(``grid_step_magic``) against the exact one; so is the condition of the
exact-sum case (``exact_unit``), which the volume draws meet: their walks
are kernel E's volume scan of the values in units (kernel D's units route),
held to the loops through E's chunked model.
"""
import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from chip_smoke import synth_trades
from finmlkit_tpu_torch.ops import event_scan, float_walk
from finmlkit_tpu_torch.testing import (FLOAT_WALK_CASES, assert_exact, float_walk_case,
                                       offgrid_trades)
from tests.test_torch_float_walk import unfused_oracle


def _values(name, mode):
    px, v, thr_v, thr_d, cap = float_walk_case(name)
    if mode == "volume":
        return px, v, v.astype(np.float64), thr_v, cap
    return px, v, px * v.astype(np.float64), thr_d, cap


@pytest.mark.parametrize("mode", ["volume", "dollar"])
@pytest.mark.parametrize("name", FLOAT_WALK_CASES)
def test_warp_model_matches_loops(name, mode):
    px, v, x, thr, cap = _values(name, mode)
    want = unfused_oracle(x, thr, cap, reset=mode == "volume")
    if mode == "volume":
        plain = float_walk.volume_walk_plain(torch.from_numpy(v), thr, cap)
    else:
        plain = float_walk.dollar_walk_plain(torch.from_numpy(px), torch.from_numpy(v), thr,
                                             cap)
    assert_exact(plain, want, f"{name} {mode} plain vs the unfused loop")
    got, st = float_walk.walk_warp(x, thr, cap, reset=mode == "volume")
    assert_exact(got, want, f"{name} {mode} warp step vs the unfused loop")
    assert st["closes"] == len(want)
    if name == "cap":
        assert len(got) == cap
    if name == "n2":
        assert got.tolist() == [1]


@pytest.mark.parametrize("tile", [float_walk.TILE, 128])
@pytest.mark.parametrize("chunks", [1, 2, 7, 64])
@pytest.mark.parametrize("name", FLOAT_WALK_CASES)
def test_chunked_volume_model_matches_loops(name, chunks, tile):
    _, _, x, thr, cap = _values(name, "volume")
    want = unfused_oracle(x, thr, cap, reset=True)
    got, st = float_walk.walk_chunked(x, thr, cap, chunks, tile=tile)
    assert_exact(got, want, f"{name} at {chunks} chunks of {tile}-trade tiles")
    per, count = float_walk.chunk_bounds(len(x), chunks, tile)
    assert st["chunks"] == count and per % tile == 0
    assert 0 <= st["unmerged"] <= count - 1 and 0 <= st["fixed"] <= count - 1
    if count == 1:
        assert st["unmerged"] == st["fixed"] == 0


def test_streams_are_the_smoke_runs_draws():
    _, price, amount, _ = synth_trades(3000, seed=2, rounded=False)
    px, v = offgrid_trades(3000, 2)
    assert_exact(px, price, "prices")
    assert_exact(v, amount, "amounts")


def test_warp_counts_name_the_work():
    # the volume draws sum exactly in float64 (no ties, binade crossings
    # besides the closes); the dollar products tie at about 0.5% of the
    # trades, the dyadic stream on many; the first trade above the threshold
    # walks serially until the carry falls below it
    _, _, x, thr, cap = _values("synth0", "volume")
    st = float_walk.walk_warp(x, thr, cap, True)[1]
    assert st["ties"] == 0 and st["crossings"] > st["closes"] > 0
    assert float_walk.exact_unit(x, thr) is not None
    _, _, x, thr, cap = _values("ties", "volume")
    assert float_walk.exact_unit(x, thr) is None
    _, _, x, thr, cap = _values("synth0", "dollar")
    st = float_walk.walk_warp(x, thr, cap, False)[1]
    assert 0.002 < st["ties"] / len(x) < 0.01 and st["steps"] < len(x) / 32
    for mode in ("volume", "dollar"):
        _, _, x, thr, cap = _values("ties", mode)
        assert float_walk.walk_warp(x, thr, cap, mode == "volume")[1]["ties"] > len(x) // 50
    _, _, x, thr, cap = _values("first_above", "dollar")
    st = float_walk.walk_warp(x, thr, cap, False)[1]
    assert st["serial"] >= 3 and st["crossings"] > 0


@pytest.mark.parametrize("values,thr,ok", [
    ([1.0, 2.0], 1.0, True), ([0.0, -0.0, 3.0], 1.0, True), ([1.0, -1.0], 1.0, False),
    ([1.0, float("nan")], 1.0, False), ([1.0, float("inf")], 1.0, False),
    ([1.0], 0.0, False), ([1.0], float("inf"), False), ([1.0], float("nan"), False),
    ([1.0], 2.0 ** -961, False), ([1.0], 2.0 ** -960, True), ([1.0], 2.0 ** 1000, False)])
def test_warp_domain(values, thr, ok):
    assert float_walk.in_warp_domain(np.array(values), thr) is ok


@pytest.mark.parametrize("values,thr,unit", [
    ([0.5, 0.25, 0.75], 1.0, -2), ([3.0, 5.0], 7.0, 0), ([0.0, -0.0, 2.0 ** -30], 1.0, -30),
    ([2.0 ** -60, 1.0], 1.0, None),            # 2^60 units to the threshold
    ([1.0, 2.0 ** 52], 1.0, None),             # the largest value at 2^52 units
    ([0.0, 0.0], 1.0, None), ([0.1], 1.0, None), ([2.0 ** -1001], 1.0, None),
    ([2.0 ** -1000, 2.0 ** -990], 2.0 ** -960, -1000),
    ([3 * 2.0 ** -1074], 1.0, None),           # a subnormal: 2^-1074 units
    ([np.float32(0.1), np.float32(3.0)], 5.0, -27)])
def test_exact_unit(values, thr, unit):
    # the exact-sum case: every value a multiple of 2^u, the threshold and the
    # largest value below 2^52 units (0.1 is a multiple of 2^-56 only)
    assert float_walk.exact_unit(np.array(values), thr) == unit


@pytest.mark.parametrize("chunks", [1, 2, 7, 64])
@pytest.mark.parametrize("name", FLOAT_WALK_CASES)
def test_units_route_matches_loops(name, chunks):
    # a volume walk of the exact-sum case is an integer walk: kernel E's
    # volume scan of the values in units of 2^u at ceil(thr / 2^u), modelled
    # at each chunk count, and its plain version, close for close
    _, _, x, thr, cap = _values(name, "volume")
    u = float_walk.exact_unit(x, thr)
    if name == "ties":
        assert u is None
        return
    assert u is not None
    units = torch.tensor([int(Fraction(xi) / Fraction(2) ** u) for xi in x.tolist()],
                         dtype=torch.int64)
    assert_exact(units.double() * 2.0 ** u, x, f"{name} units")
    t = float_walk.units_threshold(thr, u)
    assert (t - 1) * Fraction(2) ** u < Fraction(thr) <= t * Fraction(2) ** u
    want = unfused_oracle(x, thr, cap, reset=True)
    assert_exact(event_scan.volume_scan_plain(units, t, cap), want, f"{name} units plain")
    got, st = event_scan._chunked_scan_model(event_scan._VOLUME, len(x), 1, cap, chunks,
                                             units=units, thr=t)
    assert_exact(got, want, f"{name} units at {chunks} chunks")


def _identity_pairs(kind, e, g):
    """States g = S 2^(e-52) of binade e and values x >= 0 of one kind."""
    u = 2.0 ** (e - 52)
    s = g.integers(2 ** 52, 2 ** 53, 400, dtype=np.int64)
    if kind == "top":
        s = 2 ** 53 - g.integers(1, 2 ** 12, 400, dtype=np.int64)
    states = [math.ldexp(int(si), e - 52) for si in s]
    if kind in ("random", "top"):
        x = 2.0 ** (e - g.uniform(1, 30, 400))
    elif kind == "ties":      # odd multiples of half an ulp
        x = (2 * g.integers(0, 2 ** 40, 400) + 1) * (u / 2)
    elif kind == "tiny":      # far below an ulp, down to the subnormals
        x = 2.0 ** (e - 52 - g.uniform(1, 1100, 400))
    elif kind == "large":     # at or above the binade's width
        x = 2.0 ** (e + g.uniform(0, 3, 400))
    else:                     # zeros and exact multiples of the ulp
        x = np.where(np.arange(400) % 2 == 0, -0.0, g.integers(0, 2 ** 30, 400) * u)
    return states, [float(xi) for xi in x]


@pytest.mark.parametrize("e", [-30, 22, 200])
@pytest.mark.parametrize("kind", ["random", "ties", "tiny", "large", "top", "exact"])
def test_grid_step_identity(kind, e):
    g = np.random.default_rng(abs(e) * 7 + len(kind))
    states, xs = _identity_pairs(kind, e, g)
    u = Fraction(2) ** (e - 52)
    ties = 0
    for gs, x in zip(states, xs):
        s = int(Fraction(gs) / u)
        k, tie = float_walk.grid_step(x, e)
        r = (s + k) & 1 if tie else 0
        ties += tie
        got = gs + x                                   # one IEEE rounding
        want = Fraction(gs) + Fraction(x)
        # got is the nearest double to the exact sum, ties to even
        lo, hi = math.nextafter(got, -math.inf), math.nextafter(got, math.inf)
        assert abs(Fraction(got) - want) <= abs(Fraction(lo) - want)
        assert abs(Fraction(got) - want) <= abs(Fraction(hi) - want)
        if s + k + r < 2 ** 53:
            assert Fraction(got) == (s + k + r) * u, (gs, x)
        else:
            assert got >= 2.0 ** (e + 1), (gs, x)
        assert k <= 2 ** 52 and (not tie or k < 2 ** 52)
    if kind == "ties":
        assert ties == len(xs)
    mk, mt = float_walk.grid_step_magic(np.array(xs), e)
    exact = [float_walk.grid_step(x, e) for x in xs]
    assert mk.tolist() == [k for k, _ in exact] and mt.tolist() == [t for _, t in exact]
