"""Kernels B, S and C on the card against their plain versions.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip. The card's
host has no JAX, so run them there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import pytest
import torch

from finmlkit_tpu_torch.bar.aggregate_q import bar_trade_size_features
from finmlkit_tpu_torch.bar.footprint_q import comp_bar_footprints_q
from finmlkit_tpu_torch.bar.fused import median_pairs
from finmlkit_tpu_torch.bar.indexers import dollar_bar_indexer_q
from finmlkit_tpu_torch.ops import fused_scan, prefix_scan
from finmlkit_tpu_torch.testing import adversarial_trades, assert_close, assert_exact

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 8193, 5_000_001])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32,
                                   torch.float64])
def test_scan_matches_plain(cuda, dtype, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    if dtype.is_floating_point:
        x = torch.rand(n, dtype=dtype, device=cuda, generator=g)
    else:
        x = torch.randint(-1000, 1000, (n,), dtype=dtype, device=cuda, generator=g)
        x[::3] = torch.iinfo(dtype).max // 2  # wraps
    before = prefix_scan.LAUNCHES
    got = prefix_scan.fast_cumsum(x)
    assert prefix_scan.LAUNCHES == before + 1
    want = prefix_scan.fast_cumsum_plain(x)
    if dtype.is_floating_point:
        assert_close(got, want, rtol=1e-5 if dtype == torch.float32 else 1e-12)
    else:
        assert_exact(got, want)


@pytest.mark.parametrize("case", [
    dict(n=300_000, seed=1, first=-1, long_bar=100_000),
    dict(n=50_000, seed=2, first=9, mean_bar=3),
    dict(n=7, seed=3, first=-1, mean_bar=2),
])
def test_bar_products_and_medians_match_plain(cuda, case):
    arrs = adversarial_trades(**case)
    ticks, units, sides, amounts, ci = (torch.from_numpy(a).to(cuda) for a in arrs)
    before = fused_scan.LAUNCHES
    got = fused_scan.bar_scan_products(ticks, units, sides, ci)
    assert fused_scan.LAUNCHES == before + 1
    want = fused_scan.bar_scan_products_plain(ticks, units, sides, ci)
    for a, b in zip(got, want):
        assert_exact(a, b)
    for a, b in zip(median_pairs(amounts, ci),
                    median_pairs(amounts, ci, cumsum=prefix_scan.fast_cumsum_plain)):
        assert_exact(a, b)


def test_bar_products_reject_unsorted_ci(cuda):
    arrs = adversarial_trades(n=1000, seed=4)
    ticks, units, sides, _, ci = (torch.from_numpy(a).to(cuda) for a in arrs)
    with pytest.raises(ValueError):
        fused_scan.bar_scan_products(ticks, units, sides, ci.flip(0))


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 5_000_001])
@pytest.mark.parametrize("c", [1, 2, 5])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32,
                                   torch.float64])
def test_cols_scan_matches_plain(cuda, dtype, c, n):
    g = torch.Generator(device=cuda).manual_seed(n + c)
    if dtype.is_floating_point:
        x = torch.rand((c, n), dtype=dtype, device=cuda, generator=g)
    else:
        x = torch.randint(-1000, 1000, (c, n), dtype=dtype, device=cuda, generator=g)
        x[0, ::3] = torch.iinfo(dtype).max // 2  # row 0 wraps, the others not
    before = prefix_scan.COLS_LAUNCHES
    got = prefix_scan.fast_cumsum_cols(x)
    assert prefix_scan.COLS_LAUNCHES == before + 1
    want = prefix_scan.fast_cumsum_cols_plain(x)
    if dtype.is_floating_point:
        assert_close(got, want, rtol=1e-5 if dtype == torch.float32 else 1e-12)
    else:
        assert_exact(got, want)


@pytest.mark.parametrize("case", [
    dict(n=300_000, seed=5, first=0, mean_bar=800),
    dict(n=50_000, seed=6, first=-1, mean_bar=3),
])
def test_order_flow_matches_plain(cuda, case):
    ticks, units, sides, amounts, ci = (
        torch.from_numpy(a).to(cuda) for a in adversarial_trades(**case))
    ts = torch.arange(len(ticks), device=cuda)
    small = units.clamp(max=10**8)  # keeps the dollar prefix inside int64
    before = prefix_scan.LAUNCHES
    _, dci = dollar_bar_indexer_q(ts, ticks, small, 5e4, 0.1, 1e-8)
    assert prefix_scan.LAUNCHES == before + 1
    _, dci_plain = dollar_bar_indexer_q(ts, ticks, small, 5e4, 0.1, 1e-8,
                                        cumsum=prefix_scan.fast_cumsum_plain)
    assert_exact(dci, dci_plain)
    assert len(dci) > 100
    p32 = fused_scan.bar_scan_products_plain(ticks, units, sides, ci)[1]
    low, high = p32[2].clone(), p32[1].clone()
    empty = ci[1:] == ci[:-1]
    low[empty], high[empty] = p32[3][empty], p32[3][empty]
    L = 8
    while L < int((high - low + 1).max()):
        L *= 2
    before = prefix_scan.COLS_LAUNCHES
    got = comp_bar_footprints_q(ticks, amounts, ci, sides, low, high, 3.0,
                                max_levels=L)
    assert prefix_scan.COLS_LAUNCHES == before + 1
    want = comp_bar_footprints_q(ticks, amounts, ci, sides, low, high, 3.0,
                                 max_levels=L,
                                 cumsum_cols=prefix_scan.fast_cumsum_cols_plain)
    for k in want:
        assert_exact(got[k], want[k], k)
    theta = amounts[:len(ci) - 1].double()
    got = bar_trade_size_features(units, amounts, ci, theta, amount_scale=1e-8)
    want = bar_trade_size_features(units, amounts, ci, theta, amount_scale=1e-8,
                                   cumsum=prefix_scan.fast_cumsum_plain,
                                   cumsum_cols=prefix_scan.fast_cumsum_cols_plain)
    for k in want:
        assert_exact(got[k], want[k], k)
