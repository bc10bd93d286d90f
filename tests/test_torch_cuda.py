"""Kernels B and S on the card against their plain versions.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip. The card's
host has no JAX, so run them there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import pytest
import torch

from finmlkit_tpu_torch.bar.fused import median_pairs
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
