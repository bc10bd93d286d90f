"""The hist median engine of finmlkit_tpu_torch (``ops/segment_hist.py``, the
plain versions of kernel H on the CPU) against the JAX engine run as its own
tests run it (``segment_median_pair_hist(..., interpret=True)``, kernels H1
and H2 in interpret mode), on the scenarios of ``tests/ops/test_segment_hist.py``
(ties, an empty bar, ci[0] >= 0, small bars, bars across row boundaries, one
trade a bar).

Brackets must be equal bit for bit on non-empty bars (empty bars get garbage
in both engines; the finals mask them) and average to ``np.median``; the
first pass's per-bar histogram must equal the JAX kernel's row tails turned
into per-bar counts by ``_hist_fix`` and ``bar_hist``, exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finmlkit_tpu.ops import segment_hist as jsh
from finmlkit_tpu_torch.ops import segment_hist as sh
from finmlkit_tpu_torch.testing import assert_exact
from finmlkit_tpu_torch.utils import trace
from tests.ops.test_segment_hist import _case

SCENARIOS = [(6000, 70, -1, 3), (4000, 40, 7, 4), (3000, 25, -1, 5), (513, 3, -1, 6)]


@pytest.mark.parametrize("n,n_bars,ci0,seed", SCENARIOS)
def test_engine_matches_jax_hist(n, n_bars, ci0, seed):
    amount, ci = _case(n, n_bars, ci0, seed)
    ja, jb = (np.asarray(x) for x in jsh.segment_median_pair_hist(
        jnp.asarray(amount), jnp.asarray(ci), interpret=True))
    a, b = sh.segment_median_pair_hist(torch.from_numpy(amount), torch.from_numpy(ci))
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
    a, b = sh.segment_median_pair_hist(torch.from_numpy(amount), torch.from_numpy(ci))
    ja, jb = jsh.segment_median_pair_hist(jnp.asarray(amount), jnp.asarray(ci),
                                          interpret=True)
    assert_exact(a, np.asarray(ja), "med_a")
    assert_exact(b, np.asarray(jb), "med_b")
    assert_exact(a, amount, "med_a is the trade")


def _jax_first_pass(amount, ci):
    """Per-bar counts of the first pass (s = 28, base 0) from the JAX kernel's
    row tails, as ``_median_hist_whole_jit`` forms them."""
    n = len(amount)
    n_pad = jsh._n_rows(n) * 128
    bits_p = jnp.asarray(np.concatenate(
        [amount, np.zeros(n_pad - n, np.float32)]).view(np.int32).reshape(-1, 128))
    idx = np.arange(n_pad)
    valid = (idx > ci[0]) & (idx <= ci[-1])
    marks = np.zeros(n_pad + 1, np.int32)
    marks[np.where(ci + 1 < n, np.clip(ci + 1, 0, n_pad), n_pad)] = 1
    flags_p = jnp.asarray((valid.astype(np.int32) | (marks[:n_pad] << 1)).reshape(-1, 128))
    bscat = jnp.zeros_like(bits_p)
    rt = jsh._hist_pass(28, bits_p, bscat, flags_p, interpret=True)
    pos = jnp.asarray(np.concatenate([np.clip(ci[1:], 0, n_pad - 1),
                                      [np.clip(ci[0], 0, n_pad - 1)]]).astype(np.int32))
    H = np.asarray(jsh._hist_fix(rt, bits_p, bscat, flags_p, pos, 28))
    start = np.concatenate([[H[-1] if ci[0] >= 0 else np.zeros(16, np.int32)], H[:-2]])
    return H[:-1] - start


@pytest.mark.parametrize("n,n_bars,ci0,seed", SCENARIOS[:2])
def test_first_pass_histogram_matches_jax(n, n_bars, ci0, seed):
    amount, ci = _case(n, n_bars, ci0, seed)
    want = _jax_first_pass(amount, ci)
    got = sh.hist_pass(torch.from_numpy(amount).view(torch.int32), torch.from_numpy(ci),
                       torch.zeros(len(ci) - 1, dtype=torch.int32), 28)
    ne = np.diff(ci) > 0
    assert_exact(got.numpy()[ne], want[ne], "first pass")
    assert (got.numpy()[~ne] == 0).all()
    assert int(got.sum()) == int(ci[-1] - ci[0])   # every trade in one bucket


def test_passes_on_cpu_run_the_plain_versions():
    amount, ci = _case(3000, 25, -1, 5)
    bits, ci_t = torch.from_numpy(amount).view(torch.int32), torch.from_numpy(ci)
    base = bits[(ci_t[:-1] + 1).clamp(max=len(bits) - 1)] - 1000
    before = trace.counter("launch.H")
    for s in sh.SHIFTS:
        assert_exact(sh.hist_pass(bits, ci_t, base, s),
                     sh.hist_pass_plain(bits, ci_t, base, s), f"s={s}")
    for got, want in zip(sh.less_pass(bits, ci_t, base),
                         sh.less_pass_plain(bits, ci_t, base)):
        assert_exact(got, want, "less")
    assert trace.counter("launch.H") == before
    with pytest.raises(TypeError):
        sh.hist_pass(bits.long(), ci_t, base, 0)
    with pytest.raises(TypeError):
        sh.less_pass(bits, ci_t, base[:-1])
