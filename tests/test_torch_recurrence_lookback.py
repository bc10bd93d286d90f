"""Kernel R's single-pass look-back (``csrc/recurrence.cu``), modelled on the
CPU by ``ops/scan.py lookback_model``: each tile's map composed in a fixed
order, the maps of a group's tiles by the kernel's fixed warp scan, and each
group's end y found by a look-back that stops at a group drawn from a seeded
generator and applies the group maps from there to the scalar y, oldest
first.

Whatever the stops, the bits are those of the look-back that always stops at
the group just before (the chain Y(G) = S(G) Y(G - 1)), and the result is
within 1e-12 of ``linear_recurrence_plain`` at the terms' magnitude; a NaN in
b reaches every later y of its row and no earlier one. The design the kernel
rejects, composing the group maps into one map before applying it, changes
the bits with the stops. The kernel's groups hold 32 tiles; groups of 4 give
the stops more room on a small input.
"""
import numpy as np
import pytest
import torch

from finmlkit_tpu_torch.ops import scan
from finmlkit_tpu_torch.testing import assert_exact, assert_window_close

TILES = [1, 7, 16, 64]
GROUPS = [4, 32]
SEEDS = [0, 1, 2, 3]


def _case(kind: str, n: int = 3000, seed: int = 0):
    """(a, b, y0) of one kind: decays near 1, so the tiles' maps carry."""
    r = np.random.default_rng(seed)
    b = torch.from_numpy(r.normal(0.0, 1.0, n))
    a = torch.from_numpy(1.0 - r.random(n) * 0.02)
    if kind == "const":
        return 0.995, b, None
    if kind == "varying":
        return a, b, None
    if kind == "y0":
        return a, b, 7.5
    if kind == "nan":
        b[n // 2] = torch.nan
        return a, b, None
    # rows: one a a row and one y0 a row
    rows = torch.stack([b, -b, 2.0 * b + 1.0])
    return (torch.tensor([[0.9], [0.995], [0.999]], dtype=torch.float64), rows,
            torch.tensor([1.0, -2.0, 3.0], dtype=torch.float64))


KINDS = ["const", "varying", "y0", "nan", "rows"]


def _scale(a, b, y0):
    """The recurrence of |a| and |b|: the magnitude of the terms summed."""
    aa = a.abs() if torch.is_tensor(a) else abs(a)
    y0a = None if y0 is None else (y0.abs() if torch.is_tensor(y0) else abs(y0))
    return float(scan.linear_recurrence_plain(aa, torch.nan_to_num(b.abs()), y0=y0a).max())


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("kind", KINDS)
def test_stops_do_not_change_the_bits(kind, tile, group):
    a, b, y0 = _case(kind)
    want, walked = scan.lookback_model(a, b, y0=y0, tile=tile, group=group)
    assert max(walked) < 2 * group
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        got, walked = scan.lookback_model(a, b, y0=y0, tile=tile, group=group, rng=rng)
        assert_exact(got, want, f"{kind}, tile {tile}, group {group}, stops of seed {seed}")
        assert max(walked) < 33 * group


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("kind", KINDS)
def test_model_within_plain(kind, tile):
    a, b, y0 = _case(kind)
    got, _ = scan.lookback_model(a, b, y0=y0, tile=tile, group=4,
                                 rng=np.random.default_rng(tile))
    want = scan.linear_recurrence_plain(a, b, y0=y0)
    assert_window_close(got, want, _scale(a, b, y0), 1e-12, f"{kind}, tile {tile}")


@pytest.mark.parametrize("tile", TILES)
def test_nan_reaches_exactly_the_later_values(tile):
    a, b, _ = _case("nan")
    n = b.shape[0]
    got, _ = scan.lookback_model(a, b, tile=tile, group=4, rng=np.random.default_rng(5))
    assert bool(torch.isnan(got[n // 2:]).all()) and not bool(torch.isnan(got[:n // 2]).any())


def test_composing_first_changes_the_bits():
    """The rejected design: the group maps composed into one map before they
    are applied. Its bits depend on where the look-back stopped."""
    a, b, y0 = _case("varying")
    want, _ = scan.lookback_model(a, b, y0=y0, tile=4, group=4)
    differs = [not torch.equal(scan.lookback_model(a, b, y0=y0, tile=4, group=4, compose=True,
                                                   rng=np.random.default_rng(s))[0], want)
               for s in SEEDS]
    assert any(differs)


def test_walked_counts_the_tiles_back():
    """The look-back lengths the model reports, as the kernel counts them: a
    tile's place in its group, plus 4 (the group) for each group map applied,
    at most the 32 groups before or back to the row's start."""
    a, b, y0 = _case("rows")
    n_tiles = -(-b.shape[1] // 16)
    _, walked = scan.lookback_model(a, b, y0=y0, tile=16, group=4,
                                    rng=np.random.default_rng(9))
    assert len(walked) == 3 * n_tiles
    for r in range(3):
        row = walked[r * n_tiles:(r + 1) * n_tiles]
        for i, d in enumerate(row):
            grp, place = divmod(i, 4)
            assert d % 4 == place and d // 4 <= min(31, grp)
