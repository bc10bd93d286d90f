"""Kernel F's single-pass look-back, modelled on the CPU (``ops/prefix_scan.py
ffill_tiles``), against the plain fills bit for bit: ``fast_ffill_plain``
(float32 and float64, NaN payloads included) and ``fill_last_plain`` (int32,
0 before the first mark), at tiles of 1 to 1000 values in vectors of 1 to 16,
look-back windows of 1 to 32 tiles and blocks in flight that have published
only their first status, on masks all false, all true, one valid value at a
tile's first or last slot, the select engine's sparse opens and random ones,
at n = 1, at tile multiples +-1 and over 40 tiles (more than one look-back
round).

The fill is a selection, so every layout must equal the plain fill's bits.
"""
import numpy as np
import pytest
import torch

from finmlkit_tpu_torch.ops import prefix_scan as ps
from finmlkit_tpu_torch.testing import assert_exact

# (values a tile, values a vector): a tile may end inside a vector
TILES = [(1, 1), (7, 2), (64, 4), (1000, 2), (1000, 16)]
WINDOWS = (1, 3, 32)
MASKS = ["all_false", "all_true", "tile_first", "tile_last", "sparse_opens", "random"]
DTYPES = {"float32": torch.float32, "float64": torch.float64, "int32": torch.int32}


def _lengths(tile):
    return sorted({1, 3 * tile - 1, 3 * tile, 3 * tile + 1, 40 * tile + 3})


def _values(n, dtype, seed):
    """Values whose floats hold NaNs of distinct payloads, signs included."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32))
    word = np.int32 if dtype == torch.float32 else np.int64
    top = 0x7FC00000 if word is np.int32 else 0x7FF8000000000000
    v = rng.normal(size=n).astype(np.float32 if word is np.int32 else np.float64)
    bits = v.view(word)
    k = np.arange(0, n, 5)
    bits[k] = top | (k + 1)
    bits[k[1::2]] |= np.array(-1 << (31 if word is np.int32 else 63), word)  # -NaN
    return torch.from_numpy(v)


def _mask(kind, n, tile, seed):
    rng = np.random.default_rng(seed)
    m = np.zeros(n, bool)
    if kind == "all_true":
        m[:] = True
    elif kind == "tile_first":        # one valid value, at a tile's first slot
        m[min(2 * tile, n - 1)] = True
    elif kind == "tile_last":         # and at a tile's last
        m[min(3 * tile - 1, n - 1)] = True
    elif kind == "sparse_opens":      # the select engine's bar opens: most tiles none
        m[rng.random(n) < 1.0 / (3 * tile)] = True
    elif kind == "random":
        m[rng.random(n) < 0.3] = True
    return torch.from_numpy(m)


def _bits(t):
    """The values' bits: ``assert_exact`` takes any NaN for any other, and a
    selection must keep each payload."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


def _plain(values, mask):
    if values.dtype == torch.int32:
        return ps.fill_last_plain(values, mask)
    return ps.fast_ffill_plain(values, mask)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("tile,vec", TILES)
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_model_matches_plain(dtype, mask, tile, vec, window):
    for n in _lengths(tile):
        v = _values(n, DTYPES[dtype], n)
        m = _mask(mask, n, tile, n + 1)
        want = _plain(v, m)
        for lag in (0, 5, n):
            got, stats = ps.ffill_tiles(v, m, dtype == "int32", tile=tile, vec=vec,
                                        window=window, lag=lag)
            assert_exact(_bits(got), _bits(want), f"{dtype} {mask} n={n} lag={lag}")
            assert stats["tiles"] == -(-n // tile)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("tile", [1, 7, 64])
def test_look_back_rounds(tile, window):
    """No valid value: every tile after the first looks back. With every
    earlier block still in flight, tile k reads all k tiles before it,
    ``window`` a round, down to tile 0, which publishes its result at once;
    with none in flight, one round reaches the tile before it."""
    n = 40 * tile + 3
    v, m = _values(n, torch.float64, 3), torch.zeros(n, dtype=torch.bool)
    tiles = -(-n // tile)
    _, stats = ps.ffill_tiles(v, m, tile=tile, window=window, lag=n)
    assert stats["carries"] == tiles
    assert stats["rounds"] == sum(-(-k // window) for k in range(1, tiles))
    _, stats = ps.ffill_tiles(v, m, tile=tile, window=window, lag=0)
    assert stats["rounds"] == tiles - 1


def test_model_at_kernel_tiles():
    """The kernel's own tiles (4096 values, vectors of 16 bytes, 32 tiles a
    look-back round) on the select engine's kind of marks and on the CUSUM
    sigma's kind of mask (NaN at the first 1000 and at 1% of the trades),
    across 20 tiles."""
    n = 20 * 4096 + 17
    rng = np.random.default_rng(5)
    opens = torch.from_numpy(rng.random(n) < 1.0 / 857)
    vals = torch.from_numpy(rng.integers(0, 2**31, n).astype(np.int32))
    got, stats = ps.ffill_tiles(vals, opens, True, lag=3)
    assert_exact(got, ps.fill_last_plain(vals, opens), "fill_last")
    assert stats["tiles"] == 21 and stats["carries"] >= 19
    sigma = rng.normal(size=n) * 1e-5
    sigma[:1000] = np.nan
    sigma[rng.random(n) < 0.01] = np.nan
    sigma = torch.from_numpy(sigma)
    got, _ = ps.ffill_tiles(sigma, ~torch.isnan(sigma), lag=3)
    assert_exact(_bits(got), _bits(ps.fast_ffill_plain(sigma, ~torch.isnan(sigma))), "ffill")
