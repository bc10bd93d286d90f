"""Kernel V's tiled decomposition of the full planes (K1c), modelled on the
CPU (``ops/fused_scan.py bar_scan_planes_tiles``), against the plain planes
(``bar_scan_planes_plain``), bit for bit.

The model builds the planes as ``csrc/bar_planes.cu`` does: tile summaries,
a segmented scan of them, each tile's float extrema from its exact entry
sums, a scan of those, and a re-walk of every tile from its entry state. The
cases cover tiles of one trade up to more than the stream, ``ci[0] = -1`` and
an anchor inside the stream, runs of empty bars, a bar over many tiles, opens
on the tile edges, trades after the last bar, a stream shorter than one tile,
and in-bar sums that wrap past 2^63 and cross -2^56.

``pair_to_f32`` (int64 -> float32 in two steps, as the TPU kernel rounds) is
non-decreasing on (-inf, -2^56) and on [-2^56, inf) but drops at -2^56. So
the running float extrema of a segment that crosses tiles cannot be carried
as int64 extrema and rounded once; the kernel carries the exact in-bar sums
instead, and these tests pin both facts.
"""
import numpy as np
import pytest
import torch

from finmlkit_tpu_torch.ops import fused_scan
from finmlkit_tpu_torch.testing import adversarial_trades, assert_exact

TILES = [1, 2, 3, 7, 64, 1000]


def _trades(n, seed, sides_p=(0.45, 0.1, 0.45), units_hi=10**7):
    g = np.random.default_rng(seed)
    ticks = (1_070_000 + np.cumsum(g.integers(-3, 4, n))).astype(np.int32)
    units = g.integers(1, units_hi, n).astype(np.int64)
    sides = g.choice(np.array([-1, 0, 1], np.int8), n, p=list(sides_p))
    return ticks, units, sides


def _case(name, tile):
    if name in ("adversarial", "anchor_inside", "long_bar"):
        kw = {"adversarial": dict(n=300, seed=1, first=-1, mean_bar=6),
              "anchor_inside": dict(n=300, seed=2, first=9, mean_bar=4),
              "long_bar": dict(n=400, seed=3, first=-1, long_bar=310,
                               mean_bar=5)}[name]
        ticks, units, sides, _, ci = adversarial_trades(**kw)
        return ticks, units, sides, ci
    if name == "empty_runs":
        ticks, units, sides = _trades(120, 4)
        ci = [-1, 5, 5, 5, 5, 17, 17, 40, 40, 40, 41, 42, 42, 90, 90, 90, 100]
    elif name == "tile_edge_opens":
        n = max(4 * tile + 3, 40)
        ticks, units, sides = _trades(n, 5)
        edges = list(range(tile - 1, n - 4, tile))   # opens at every tile start
        ci = [-1] + edges + edges[1:2] + [n - 4]     # one edge twice: an empty bar
        ci = sorted(ci)
    elif name == "short_stream":
        ticks, units, sides = _trades(5, 6)
        ci = [0, 1, 1, 3]
    elif name == "wraps":
        # units near 2^40 at ticks near 2^20: a dollar sum passes -2^56 in one
        # trade and wraps past 2^63 within 16; mostly sells, then buys
        ticks, units, sides = _trades(200, 7, sides_p=(0.8, 0.05, 0.15),
                                      units_hi=2**41)
        units[::3] += 2**40
        sides[120:] = 1
        ci = [-1, 150, 151, 195]
    else:
        raise KeyError(name)
    return ticks, units, sides, np.asarray(ci, np.int64)


CASES = ["adversarial", "anchor_inside", "long_bar", "empty_runs",
         "tile_edge_opens", "short_stream", "wraps"]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", CASES)
def test_tiled_planes_equal_plain(name, tile):
    args = [torch.from_numpy(a) for a in _case(name, tile)]
    want = fused_scan.bar_scan_planes_plain(*args)
    got = fused_scan.bar_scan_planes_tiles(*args, tile=tile)
    for what, a, b in zip(("pre64", "pre32", "ext32", "extf"), got, want):
        assert_exact(a, b, f"{name} tile {tile} {what}")


def test_wraps_case_needs_the_exact_carry():
    # the in-bar dollar imbalance of the long bar wraps past 2^63 and crosses
    # -2^56: for some tile edge k, the min of the trades after it, carried as
    # the int64 min of their sums relative to k and rounded once, is not the
    # min of their rounded sums
    ticks, units, sides, ci = (torch.from_numpy(a) for a in _case("wraps", 1))
    in64, _ = fused_scan.planes_prefix_inputs(ticks, units, sides, ci)
    cd = torch.cumsum(in64[2] - in64[3], 0)[:151]
    exact = [int(x) for x in (in64[2] - in64[3])[:151]]
    assert any(abs(sum(exact[:k + 1])) >= 2**63 for k in range(151)), "no wrap"
    assert bool((cd < -2**56).any()) and bool((cd >= -2**56).any())
    f = fused_scan.pair_to_f32(cd)
    traded = sides[:151] != 0
    carried = [(float(fused_scan.pair_to_f32(cd[k] + (cd[k + 1:] - cd[k])[traded[k + 1:]].min())),
                float(f[k + 1:][traded[k + 1:]].min())) for k in range(140)]
    assert any(a != b for a, b in carried)


def _pair_f32_np(x):
    return fused_scan.pair_to_f32(torch.from_numpy(np.asarray(x, np.int64))).numpy()


def _his():
    """Every hi around the float32 rounding steps of hi (2^24 to 2^31), and
    around 0."""
    his = set(range(-8, 9))
    for k in range(24, 32):
        for c in (2**k, -(2**k)):
            his.update(h for h in range(c - 6, c + 7) if -2**31 <= h < 2**31)
    return sorted(his)


@pytest.mark.parametrize("part", ["hi_steps", "lo_sign_changes"])
def test_pair_f32_monotone_but_for_one_drop(part):
    # exhaustive over 2 * 512 values around each point, in int64 order
    his = np.array(_his(), np.int64)
    centre = his << 32 if part == "hi_steps" else (his << 32) + 2**31
    x = (centre[:, None] + np.arange(-512, 512)[None, :]).reshape(-1)
    x = np.unique(x)
    f = _pair_f32_np(x)
    drops = np.nonzero(f[1:] < f[:-1])[0]
    assert len(drops) == 1                     # one drop, and it straddles -2^56
    assert x[drops[0]] < -2**56 <= x[drops[0] + 1]
    if part == "hi_steps":
        assert _pair_f32_np([-2**56 - 1])[0] == -2.0**56 + 2.0**32
        assert _pair_f32_np([-2**56])[0] == -2.0**56


def test_pair_f32_monotone_on_random_pairs():
    g = np.random.default_rng(0)
    x = np.concatenate([g.integers(-2**63, 2**63 - 1, 200_000, dtype=np.int64),
                        g.integers(-2**58, 2**58, 200_000, dtype=np.int64)])
    y = x + g.integers(0, 2**40, len(x), dtype=np.int64)
    keep = y >= x                                     # no int64 wrap
    x, y = x[keep], y[keep]
    fx, fy = _pair_f32_np(x), _pair_f32_np(y)
    same_side = (x >= -2**56) == (y >= -2**56)
    assert bool((fx[same_side] <= fy[same_side]).all())
