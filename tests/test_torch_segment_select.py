"""The radix-select median engine of finmlkit_tpu_torch (``ops/segment_select.py``
with ``fill_last``, kernel F's int32 mode, on the CPU) against the JAX engine
as its own tests run it: ``median_select_device(..., interpret=True)``, which
runs the TPU kernel ``_fill_last_planes`` (L1) in interpret mode.

Brackets must be equal bit for bit on non-empty bars (empty bars get garbage
in both; the finals mask them) on the scenarios of
``tests/ops/test_segment_hist.py``; ``fill_last_plain`` must equal the JAX
kernel exactly on inputs padded to one ``ROWS * 128`` block.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finmlkit_tpu.bar import fused as jfused
from finmlkit_tpu.ops.fused_scan import BLOCK
from finmlkit_tpu.ops.segment_select import _fill_last_planes
from finmlkit_tpu_torch.ops import prefix_scan
from finmlkit_tpu_torch.ops.segment_select import segment_median_pair_select
from finmlkit_tpu_torch.testing import assert_exact
from finmlkit_tpu_torch.utils import trace
from tests.ops.test_segment_hist import _case


@pytest.mark.parametrize("n,n_bars,ci0,seed", [
    (6000, 70, -1, 3), (4000, 40, 7, 4), (3000, 25, -1, 5), (513, 3, -1, 6)])
def test_engine_matches_jax_select(n, n_bars, ci0, seed):
    amount, ci = _case(n, n_bars, ci0, seed)
    ja, jb = (np.asarray(x) for x in jfused.median_select_device(
        jnp.asarray(amount), jnp.asarray(ci), interpret=True))
    a, b = segment_median_pair_select(torch.from_numpy(amount), torch.from_numpy(ci))
    ne = np.diff(ci) > 0
    assert_exact(a.numpy()[ne], ja[ne], "med_a")
    assert_exact(b.numpy()[ne], jb[ne], "med_b")
    med = (a.numpy().astype(np.float64) + b.numpy().astype(np.float64)) / 2
    for k in np.flatnonzero(ne):
        assert med[k] == np.median(amount[ci[k] + 1:ci[k + 1] + 1].astype(np.float64)), k


def test_single_trade_bars():
    n = 600
    amount = np.abs(np.random.default_rng(9).normal(1, 0.3, n)).astype(np.float32) + 0.01
    ci = np.arange(-1, n, 1).astype(np.int64)
    a, b = segment_median_pair_select(torch.from_numpy(amount), torch.from_numpy(ci))
    assert_exact(a, amount, "med_a")
    assert_exact(b, amount, "med_b")


@pytest.mark.parametrize("marks", ["random", "none", "first", "leading_gap"])
def test_fill_last_plain_matches_jax_kernel(marks):
    r = np.random.default_rng(len(marks))
    vals = r.integers(0, 2**31 - 1, BLOCK).astype(np.int32)
    m = np.zeros(BLOCK, np.int32)
    if marks == "random":
        m[r.random(BLOCK) < 0.01] = 1
    elif marks == "first":
        m[0] = 1
    elif marks == "leading_gap":
        m[5000::777] = 1
    want = np.asarray(_fill_last_planes(jnp.asarray(vals.reshape(-1, 128)),
                                        jnp.asarray(m.reshape(-1, 128)),
                                        interpret=True)).reshape(-1)
    v, mk = torch.from_numpy(vals), torch.from_numpy(m != 0)
    assert_exact(prefix_scan.fill_last_plain(v, mk), want, marks)
    before = trace.counter("launch.F.fill_last")
    assert_exact(prefix_scan.fill_last(v, mk), want, f"{marks}, CPU dispatch")
    assert trace.counter("launch.F.fill_last") == before


def test_fill_last_checks_inputs():
    v = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        prefix_scan.fill_last(v.float(), torch.zeros(8, dtype=torch.bool))
    with pytest.raises(ValueError):
        prefix_scan.fill_last(v, torch.zeros(8, dtype=torch.int32))
    assert prefix_scan.fill_last(v[:0], torch.zeros(0, dtype=torch.bool)).numel() == 0
