"""The full-plane bar scan (K1c), the K1d chain and the streaming-floor probes
(P1-P3) of finmlkit_tpu_torch against the JAX package on the CPU.

- ``prep_planes_plain`` against ``prep_planes`` and the planes
  (``bar_scan_planes``, plain on the CPU) against the TPU kernel
  ``bar_scan_planes(..., interpret=True)``: hi/lo pairs combined into int64,
  the first n positions, exact, on the cases of ``tests/test_torch_fused.py``
  (ci[0] >= 0, empty and single-trade bars, units above 2^31, a bar longer
  than one TPU block);
- the planes' products against ``fused_packed_device(..., interpret=True)``
  and against kernel B's (plain) on non-empty bars, exact; the finals of
  every median engine through the planes against the default's on every
  bar, exact;
- K1d: the JAX ``bar_scan_rowtails_v3`` equals ``bar_scan_rowtails`` at one
  shape, and the port's B products equal ``fused_packed_v2_device``: kernel B
  serves both;
- P1-P3: ``io_floor_plain`` against the three JAX probes, exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finmlkit_tpu.bar import fused as jfused
from finmlkit_tpu.ops import fused_scan as jfs
from finmlkit_tpu_torch import interop
from finmlkit_tpu_torch.bar import fused
from finmlkit_tpu_torch.ops import fused_scan
from finmlkit_tpu_torch.testing import assert_exact
from finmlkit_tpu_torch.utils import trace
from tests.test_torch_fused import CASES, _case, _jax_args


def _port(name):
    amount, side, q, ci = _case(name)
    return ci, interop.from_numpy(q, ci, side, amount, "cpu"), _jax_args(q, side, ci)


def _jax_planes_in(jargs):
    ticks, units, ci, sides = jargs
    return jfused.prep_planes(ticks, units, sides, ci)


@pytest.mark.parametrize("name", CASES)
def test_prep_planes_match_jax(name):
    _, t, jargs = _port(name)
    planes_in, n = _jax_planes_in(jargs)
    got = fused_scan.prep_planes_plain(t.ticks, t.units, t.sides, t.ci)
    assert len(got) == len(planes_in) == 8
    for k, (a, b) in enumerate(zip(got, planes_in)):
        assert_exact(a, np.asarray(b).reshape(-1)[:n], f"stream {k}")


@pytest.mark.parametrize("name", CASES)
def test_planes_match_jax_kernel(name):
    _, t, jargs = _port(name)
    planes_in, n = _jax_planes_in(jargs)
    jp = [np.asarray(x).reshape(-1)[:n] for x in
          jfs.bar_scan_planes(*planes_in, interpret=True)]
    pre64, pre32, ext32, extf = fused_scan.bar_scan_planes(t.ticks, t.units, t.sides, t.ci)
    for k in range(6):   # bu, su, bd, sd, tu, td as (hi, lo) pairs
        hi, lo = jp[2 * k].astype(np.int64), jp[2 * k + 1].view(np.uint32)
        want = (hi << 32) | lo.astype(np.int64)
        assert_exact(pre64[k], want, f"pair prefix {k}")
    for k in range(3):   # tb, ts, spread
        assert_exact(pre32[k], jp[12 + k], f"int32 prefix {k}")
    for k in range(5):   # high, low, spmax, ctmin, ctmax
        assert_exact(ext32[k], jp[15 + k], f"int32 extremum {k}")
    for k in range(4):   # cvmin, cvmax, cdmin, cdmax
        assert_exact(extf[k], jp[20 + k], f"float32 extremum {k}")


@pytest.mark.parametrize("name", CASES)
def test_planes_products_match_jax_and_b(name):
    ci, t, jargs = _port(name)
    want = [np.asarray(x) for x in jfused.fused_packed_device(*jargs, interpret=True)]
    got = fused.planes_products(t.ticks, t.units, t.sides, t.ci)
    b = fused_scan.bar_scan_products(t.ticks, t.units, t.sides, t.ci)
    ne = np.diff(ci) > 0
    for k, what in enumerate(("p64", "p32", "pf")):
        assert_exact(got[k].numpy()[:, ne], want[k][:, ne], f"{what} vs JAX")
        assert_exact(got[k][:, ne], b[k][:, ne], f"{what} vs B")


@pytest.mark.parametrize("name", CASES)
def test_finals_through_planes_equal_default(name):
    _, t, _ = _port(name)
    kw = dict(tick_size=t.tick_size, amount_scale=t.amount_scale, amounts_f32=t.amounts)
    ref = fused.bar_products_final(t.ticks, t.units, t.ci, t.sides, **kw)
    for medians in ("sort", "hist", "select"):
        got = fused.bar_products_final(t.ticks, t.units, t.ci, t.sides, **kw,
                                       scan=fused.planes_products, medians=medians)
        for part, want in zip(got, ref):
            for key in want:
                assert_exact(part[key], want[key], f"{medians} {key}")


def test_empty_first_bar_sums_zero():
    # an empty bar at the open anchor -1: its prefix differences are 0, not
    # trade 0's (the JAX gather clamps -1 to 0), so the finals agree with B's
    amount, side, q, ci = _case("mk")
    ci = np.concatenate([[-1], ci]).astype(np.int64)
    t = interop.from_numpy(q, ci, side, amount, "cpu")
    p64, p32, _ = fused.planes_products(t.ticks, t.units, t.sides, t.ci)
    assert (p64[:, 0] == 0).all() and (p32[4:7, 0] == 0).all()
    kw = dict(tick_size=t.tick_size, amount_scale=t.amount_scale, amounts_f32=t.amounts)
    ref = fused.bar_products_final(t.ticks, t.units, t.ci, t.sides, **kw)
    got = fused.bar_products_final(t.ticks, t.units, t.ci, t.sides, **kw,
                                   scan=fused.planes_products)
    for part, want in zip(got, ref):
        for key in want:
            assert_exact(part[key], want[key], key)


def test_k1d_chain_v3_equals_v2_and_b():
    amount, side, q, ci = _case("single_trade_bars_and_side0")
    jargs = _jax_args(q, side, ci)
    planes_in, _ = _jax_planes_in(jargs)
    v2 = np.asarray(jfs.bar_scan_rowtails(*planes_in, interpret=True))
    v3 = np.asarray(jfs.bar_scan_rowtails_v3(*planes_in, interpret=True))
    assert_exact(v3, v2, "v3 rowtails vs v2")
    want = [np.asarray(x) for x in jfused.fused_packed_v2_device(
        *jargs, interpret=True, kernel="v2")]
    t = interop.from_numpy(q, ci, side, amount, "cpu")
    got = fused_scan.bar_scan_products(t.ticks, t.units, t.sides, t.ci)
    ne = np.diff(ci) > 0
    for k in range(3):
        assert_exact(got[k].numpy()[:, ne], want[k][:, ne], f"B vs v2 products {k}")


def test_io_floor_probes_match_jax():
    _, t, _ = _port("units_above_2p31_and_ties")
    streams = fused_scan.prep_planes_plain(t.ticks, t.units, t.sides, t.ci)
    n = streams[0].shape[0]
    rows = -(-n // (512 * 128)) * 512        # the probes' block of 512 rows
    padded = [np.concatenate([s.numpy(), np.zeros(rows * 128 - n, np.int32)])
              .reshape(rows, 128) for s in streams]
    jp = [jnp.asarray(p) for p in padded]
    want1 = np.asarray(jfs.bar_scan_io_floor(*jp, interpret=True)).reshape(-1)[:n]
    assert_exact(fused_scan.bar_scan_io_floor(*streams), want1, "P1")
    assert_exact(fused_scan.io_floor_plain(streams), want1, "P1 plain")
    for k in (1, 2, 4, 8):
        want = np.asarray(jfs.bar_scan_io_floor_k(jp[3], k=k, interpret=True))
        want = want.reshape(-1)[:n]
        assert_exact(fused_scan.bar_scan_io_floor_k(streams[3], k), want, f"P2 k={k}")
    want3 = np.asarray(jfs.bar_scan_io_floor_stacked(jnp.stack(jp), interpret=True))
    want3 = want3.reshape(-1)[:n]
    stack = torch.stack(streams)
    assert_exact(fused_scan.bar_scan_io_floor_stacked(stack), want3, "P3")
    assert_exact(fused_scan.io_floor_plain(stack), want3, "P3 plain")


def test_probes_and_planes_check_inputs():
    x = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_scan.bar_scan_io_floor_k(x, 9)
    with pytest.raises(ValueError):
        fused_scan.bar_scan_io_floor_stacked(torch.zeros((7, 16), dtype=torch.int32))
    with pytest.raises(TypeError):
        fused_scan.bar_scan_io_floor(*([x] * 7), x.long())
    _, t, _ = _port("mk")
    with pytest.raises(TypeError):
        fused_scan.bar_scan_planes(t.ticks.long(), t.units, t.sides, t.ci)
    before = (trace.counter("launch.V"), trace.counter("launch.P"))
    fused_scan.bar_scan_planes(t.ticks, t.units, t.sides, t.ci)
    fused_scan.bar_scan_io_floor_k(x, 2)
    assert (trace.counter("launch.V"), trace.counter("launch.P")) == before
