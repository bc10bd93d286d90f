"""Kernel B's tiled decomposition of the per-bar products (K1a, K1b, K1d),
modelled on the CPU (``ops/fused_scan.py bar_scan_products_tiles``), against
the plain products (``bar_scan_products_plain``), bit for bit.

The model builds the products as ``csrc/bar_products.cu`` does: tile
summaries of the in-bar sums, their exclusive scan (the kernel's look-back),
every segment (a bar's part in one tile) walked once from its entry sums into
a record of sums and max-taken extrema, records stored where a bar opens and
closes in one tile and joined by add and max elsewhere, then decoded. The
cases cover tiles of one trade up to more than the stream: ``ci[0] = -1`` and
an anchor inside the stream, a bar over many tiles, runs of empty bars (1,000
in a row among them), opens on every tile edge, single-trade bars at a tile's
first and last trade and at trade 0, trades after the last bar, a stream
shorter than one tile, and in-bar dollar sums that cross -2^56 and wrap past
2^63 across tile edges. One case runs the model through the finals against
the JAX package's v2 chain.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finmlkit_tpu.bar import fused as jfused
from finmlkit_tpu.bar.quantize import quantize_trades
from finmlkit_tpu_torch import interop
from finmlkit_tpu_torch.bar import fused
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
        ci = [-1, 5, 5, 5, 5, 17, 17, 40, 40, 40, 41, 42, 42] + [90] * 1000 + [100]
    elif name == "tile_edge_opens":
        n = max(4 * tile + 3, 40)
        ticks, units, sides = _trades(n, 5)
        edges = list(range(tile - 1, n - 4, tile))   # opens at every tile start
        ci = sorted([-1] + edges + edges[1:2] + [n - 4])  # one edge twice: an empty bar
    elif name == "single_trade_edges":
        # single-trade bars at trade 0, at the last trade of tile 0 and the
        # first of tile 1, and at the last and first trades around tile 2
        n = max(3 * tile + 5, 30)
        ticks, units, sides = _trades(n, 8)
        ci = sorted([-1, 0, tile - 2, tile - 1, tile, 2 * tile - 2, 2 * tile - 1,
                     2 * tile, n - 3])
    elif name == "after_last_bar":
        ticks, units, sides = _trades(60, 9)
        ci = [-1, 10, 30]
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
         "tile_edge_opens", "single_trade_edges", "after_last_bar",
         "short_stream", "wraps"]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", CASES)
def test_tiled_products_equal_plain(name, tile):
    args = [torch.from_numpy(a) for a in _case(name, tile)]
    want = fused_scan.bar_scan_products_plain(*args)
    got = fused_scan.bar_scan_products_tiles(*args, tile=tile)
    for what, a, b in zip(("p64", "p32", "pf"), got, want):
        assert_exact(a, b, f"{name} tile {tile} {what}")


def test_cases_hold_what_they_name():
    # the wraps case's long bar (trades 0-150) crosses -2^56 and wraps past
    # 2^63 in its dollar imbalance; the single-trade case has single-trade
    # bars at trade 0 and on both sides of a tile edge
    ticks, units, sides, ci = _case("wraps", 7)
    exact = list(itertools.accumulate(
        int(t) * int(u) * int(s) for t, u, s in zip(ticks[:151], units[:151], sides[:151])))
    wrapped = [(x + 2**63) % 2**64 - 2**63 for x in exact]
    assert any(abs(x) >= 2**63 for x in exact)
    assert any(x < -2**56 for x in wrapped) and any(x >= -2**56 for x in wrapped)
    for tile in TILES:
        ci = _case("single_trade_edges", tile)[3]
        singles = set(ci[1:][np.diff(ci) == 1])
        assert {0, tile - 1, tile} <= singles, tile


def _jax_case():
    """A small stream of the kind of tests/test_torch_fused.py: side-0 trades,
    single-trade bars, an empty bar and a bar over many 64-trade tiles."""
    n = 2048
    r = np.random.default_rng(11)
    price = np.round(100 + np.cumsum(r.normal(0, 0.05, n)), 2)
    amount = np.maximum(np.round(r.lognormal(-2.5, 1.2, n), 5), 1e-5).astype(np.float32)
    side = r.choice(np.array([-1, 1], np.int8), n)
    side[::13] = 0
    q = quantize_trades(price, amount)
    inner = np.sort(r.choice(np.arange(1, 1200), 40, replace=False))
    ci = np.concatenate([[-1], inner, [1201, 1202, 1202], [n - 1]]).astype(np.int64)
    return amount, side, q, ci


def test_tiled_products_finals_match_jax_v2():
    amount, side, q, ci = _jax_case()
    o_j, d_j = jfused.bar_products_final_device(
        jnp.asarray(q.price_ticks), jnp.asarray(q.amount_units), jnp.asarray(ci),
        jnp.asarray(side), tick_size=q.tick_size, amount_scale=q.amount_scale,
        amounts_f32=jnp.asarray(amount), ci_host=ci, interpret=True, kernel="v2")
    t = interop.from_numpy(q, ci, side, amount, "cpu")
    o, d = fused.bar_products_final(
        t.ticks, t.units, t.ci, t.sides, tick_size=t.tick_size,
        amount_scale=t.amount_scale, amounts_f32=t.amounts,
        scan=lambda *a: fused_scan.bar_scan_products_tiles(*a, tile=64))
    assert set(o) == set(o_j) and set(d) == set(d_j)
    for k in o_j:
        assert_exact(o[k], np.asarray(o_j[k]), k)
    for k in d_j:
        assert_exact(d[k], np.asarray(d_j[k]), k)
