"""Bar products of finmlkit_tpu_torch (plain path of kernel B, the median
brackets and the finals) against the JAX package on the CPU.

Oracles: ``fused_packed_v2_device(..., interpret=True, kernel="v2")`` for the
per-bar products (non-empty bars: the JAX package leaves stale extrema in empty
bars), ``bar_products_final_device(..., interpret=True, kernel="v2")`` for the
finals on every bar, bit for bit, and ``median_sort_device`` in interpret mode
plus ``np.median`` for the medians. Integers, bars, medians and finals must be
exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finmlkit_tpu.bar import fused as jfused
from finmlkit_tpu.bar.quantize import quantize_trades
from finmlkit_tpu_torch import interop
from finmlkit_tpu_torch.bar import fused
from finmlkit_tpu_torch.ops import fused_scan, prefix_scan
from finmlkit_tpu_torch.testing import assert_exact


N = 34000      # one trade count and
N_CI = 73      # one close-index count for every case: the JAX oracles
               # compile once per shape


def _mk(seed, zero_side_every=97, extra=(), first=-1, pool_lo=1):
    """The trade generator of tests/bars/test_fused.py:12-28 at N trades,
    with 70 inner close indices (``extra`` among them), the open anchor
    ``first`` and one empty bar."""
    r = np.random.default_rng(seed)
    price = np.round(100 + np.cumsum(r.normal(0, 0.05, N)), 2)
    amount = np.maximum(np.round(r.lognormal(-2.5, 1.2, N), 5),
                        1e-5).astype(np.float32)
    side = r.choice(np.array([-1, 1], np.int8), N)
    if zero_side_every:
        side[::zero_side_every] = 0
    q = quantize_trades(price, amount)
    extra = np.asarray(extra, np.int64)
    pool = np.setdiff1d(np.arange(max(pool_lo, first + 1), N - 1), extra)
    inner = np.concatenate([r.choice(pool, 70 - len(extra), replace=False),
                            extra])
    ci = np.sort(np.concatenate([[first], inner, [N - 1]])).astype(np.int64)
    ci = np.sort(np.concatenate([ci, [ci[5]]]))  # an empty bar
    assert len(ci) == N_CI and len(np.unique(ci)) == N_CI - 1
    return amount, side, q, ci


def _case(name):
    if name == "mk":
        return _mk(3)
    if name == "mk_seed31":
        return _mk(31)
    if name == "unaligned_first_bar":  # ci[0] >= 0
        return _mk(32, first=7)
    if name == "single_trade_bars_and_side0":
        return _mk(33, zero_side_every=5, extra=(100, 101, 102, 1500, 1501))
    if name == "units_above_2p31_and_ties":
        amount, side, q, ci = _mk(34)
        amount = amount.copy()
        amount[::4] = amount[1]               # ties
        amount[::3] = np.float32(30.0)        # 3e9 units
        amount[1::7] = np.float32(5.0e3)      # 5e11 units
        return amount, side, quantize_trades(
            np.asarray(q.price_ticks, np.float64) * q.tick_size, amount), ci
    if name == "bar_over_32768":  # trades 51..>33000 form one bar
        return _mk(35, extra=(50,), pool_lo=33100)
    raise KeyError(name)


CASES = ["mk", "mk_seed31", "unaligned_first_bar",
         "single_trade_bars_and_side0", "units_above_2p31_and_ties",
         "bar_over_32768"]


def _jax_args(q, side, ci):
    return (jnp.asarray(q.price_ticks), jnp.asarray(q.amount_units),
            jnp.asarray(ci), jnp.asarray(side))


@pytest.mark.parametrize("name", CASES)
def test_products_plain_matches_jax_v2(name):
    amount, side, q, ci = _case(name)
    p64_j, p32_j, pf_j = (np.asarray(x) for x in jfused.fused_packed_v2_device(
        *_jax_args(q, side, ci), interpret=True, kernel="v2"))
    t = interop.from_numpy(q, ci, side, amount, "cpu")
    p64, p32, pf = fused_scan.bar_scan_products(t.ticks, t.units, t.sides, t.ci)
    ne = np.diff(ci) > 0
    assert_exact(p64.numpy()[:, ne], p64_j[:, ne], "p64")
    assert_exact(p32.numpy()[:, ne], p32_j[:, ne], "p32")
    assert_exact(pf.numpy()[:, ne], pf_j[:, ne], "pf")
    # empty bars: zero sums, the close tick
    assert (p64.numpy()[:, ~ne] == 0).all()
    assert_exact(p32.numpy()[3], p32_j[3], "close_t on every bar")


@pytest.mark.parametrize("name", CASES)
def test_finals_bit_identical_to_jax(name):
    amount, side, q, ci = _case(name)
    o_j, d_j = jfused.bar_products_final_device(
        *_jax_args(q, side, ci), tick_size=q.tick_size,
        amount_scale=q.amount_scale, amounts_f32=jnp.asarray(amount),
        ci_host=ci, interpret=True, kernel="v2")
    t = interop.from_numpy(q, ci, side, amount, "cpu")
    o, d = fused.bar_products_final(t.ticks, t.units, t.ci, t.sides,
                                    tick_size=t.tick_size,
                                    amount_scale=t.amount_scale,
                                    amounts_f32=t.amounts)
    assert set(o) == set(o_j) and set(d) == set(d_j)
    for k in o_j:
        assert_exact(o[k], np.asarray(o_j[k]), k)
    for k in d_j:
        assert_exact(d[k], np.asarray(d_j[k]), k)


@pytest.mark.parametrize("name", CASES)
def test_median_pairs_match_jax_and_np_median(name):
    amount, _, _, ci = _case(name)
    a_j, b_j = jfused.median_sort_device(jnp.asarray(amount), jnp.asarray(ci),
                                         interpret=True)
    a, b = fused.median_pairs(torch.from_numpy(amount), torch.from_numpy(ci))
    ne = np.diff(ci) > 0
    assert_exact(a.numpy()[ne], np.asarray(a_j)[ne], "med_a")
    assert_exact(b.numpy()[ne], np.asarray(b_j)[ne], "med_b")
    med = (a.numpy().astype(np.float64) + b.numpy().astype(np.float64)) * 0.5
    for k in np.flatnonzero(ne):
        want = np.median(amount[ci[k] + 1:ci[k + 1] + 1].astype(np.float64))
        assert med[k] == want, k


def test_cpu_path_launches_no_kernel():
    amount, side, q, ci = _case("mk")
    t = interop.from_numpy(q, ci, side, amount, "cpu")
    before = (fused_scan.LAUNCHES, prefix_scan.LAUNCHES)
    fused.bar_products_final(t.ticks, t.units, t.ci, t.sides,
                             tick_size=t.tick_size, amount_scale=t.amount_scale,
                             amounts_f32=t.amounts)
    assert (fused_scan.LAUNCHES, prefix_scan.LAUNCHES) == before


def test_products_reject_bad_dtypes():
    amount, side, q, ci = _case("mk")
    t = interop.from_numpy(q, ci, side, amount, "cpu")
    with pytest.raises(TypeError):
        fused_scan.bar_scan_products(t.ticks.long(), t.units, t.sides, t.ci)
    with pytest.raises(ValueError):
        fused_scan.bar_scan_products(t.ticks, t.units[:-1], t.sides, t.ci)
