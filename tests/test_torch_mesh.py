"""The port's process groups (``finmlkit_tpu_torch/parallel/mesh.py``) on the
CPU over gloo: a rank's view of the mesh and its collectives at 1 and 4
ranks, the (symbol x time) grid, and the failures, each within its deadline:
a rank that raises, a rank that hangs while the others wait in a collective
(the group's timeout fails them), and a rank that hangs past the deadline
(the parent kills it). The rank functions live in the port
(``parallel/dryrun.py mesh_check``), so the spawned ranks import neither JAX
nor this file.
"""
import time

import pytest

from finmlkit_tpu_torch.parallel.dryrun import mesh_check
from finmlkit_tpu_torch.parallel.mesh import TimeMesh, spawn_mesh


@pytest.mark.parametrize("world", [1, 4])
def test_ranks_see_the_mesh(world):
    got = spawn_mesh(mesh_check, world, device="cpu", timeout=60)
    assert [g["rank"] for g in got] == list(range(world))
    for g in got:
        assert (g["size"], g["backend"], g["device"]) == (world, "gloo", "cpu")
        assert g["sum"] == sum(range(world)) and g["max"] == world - 1
        assert g["from_last"] == world - 1
        assert g["gathered"] == [float(r) for r in range(world)]


def test_symbol_time_grid():
    got = spawn_mesh(mesh_check, 4, args=("grid",), device="cpu", timeout=60)
    assert [(g["symbol"], g["row_rank"], g["row_sum"]) for g in got] == [
        (0, 0, 1.0), (0, 1, 1.0), (1, 0, 5.0), (1, 1, 5.0)]


def test_a_rank_that_raises_fails_the_call():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 2 raised:(.|\n)*raises on purpose"):
        spawn_mesh(mesh_check, 3, args=("raise",), device="cpu", timeout=60, deadline=60)
    assert time.monotonic() - t0 < 60


def test_a_hang_fails_within_the_group_timeout():
    """The last rank never enters the collective: the others' wait ends at
    the group's timeout (3 s), and the call fails, well before gloo's
    default of 30 minutes."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="raised"):
        spawn_mesh(mesh_check, 2, args=("hang",), device="cpu", timeout=3, deadline=60)
    assert time.monotonic() - t0 < 40


def test_a_hang_past_the_deadline_is_killed():
    """With a group timeout longer than the deadline, the parent kills every
    rank at the deadline (6 s) and fails the call."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish within the deadline"):
        spawn_mesh(mesh_check, 2, args=("hang",), device="cpu", timeout=300, deadline=6)
    assert time.monotonic() - t0 < 30


def test_span_is_an_even_contiguous_split():
    m = TimeMesh(None, 0, 3, None, "gloo")
    assert [m.span(10, r) for r in range(3)] == [(0, 3), (3, 6), (6, 10)]
    assert [m.span(2, r) for r in range(3)] == [(0, 0), (0, 1), (1, 2)]
