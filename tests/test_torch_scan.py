"""Prefix sums of finmlkit_tpu_torch (plain path of kernel S) against the TPU
kernels of the JAX package, run in interpret mode on the CPU: ``_cumsum_2d``
(int32, float32) and ``_cumsum_2d_i64`` (int64 as hi/lo pairs, wrapping past
2^63), and ``jnp.cumsum`` for float64 (the JAX package's off-TPU path).

Integers must be exact; float32 within rtol 1e-5 and float64 within rtol
1e-12 (the sums are taken in another order), on positive values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finmlkit_tpu.ops import pallas_scan
from finmlkit_tpu_torch.ops import prefix_scan
from finmlkit_tpu_torch.testing import assert_close, assert_exact

LENGTHS = [1, 8191, 8193, 20000]
_BLOCK = 64 * 128  # the Pallas kernel's grid step


def _pad(x):
    return np.concatenate([x, np.zeros((-len(x)) % _BLOCK, x.dtype)])


def _data(dtype, n, seed=0):
    r = np.random.default_rng(seed + n)
    if dtype == np.int32:
        x = r.integers(-1000, 1000, n).astype(np.int32)
        x[::97] = 2**31 - 1  # the prefix wraps past 2^31
        return x
    if dtype == np.int64:
        x = r.integers(-2**40, 2**40, n, dtype=np.int64)
        x[::5] = 2**62 + r.integers(0, 2**40, len(x[::5]))  # wraps past 2^63
        return x
    return r.random(n).astype(dtype)


def _jax_oracle(x):
    n = len(x)
    if x.dtype == np.int64:
        xp = _pad(x)
        hi = jnp.asarray((xp >> 32).astype(np.int32).reshape(-1, 128))
        lo = jnp.asarray(xp.astype(np.uint32).view(np.int32).reshape(-1, 128))
        ohi, olo = pallas_scan._cumsum_2d_i64(hi, lo, interpret=True)
        out = np.asarray(pallas_scan.combine_i64(ohi, olo)).reshape(-1)
        return out[:n]
    if x.dtype == np.float64:
        return np.asarray(jnp.cumsum(jnp.asarray(x)))
    out = pallas_scan._cumsum_2d(jnp.asarray(_pad(x).reshape(-1, 128)),
                                 interpret=True)
    return np.asarray(out).reshape(-1)[:n]


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32, np.float64])
def test_plain_scan_matches_jax(dtype, n):
    x = _data(dtype, n)
    got = prefix_scan.fast_cumsum(torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype
    want = _jax_oracle(x)
    if dtype in (np.int32, np.int64):
        assert_exact(got, want, f"{np.dtype(dtype).name} n={n}")
    else:
        rtol = 1e-5 if dtype == np.float32 else 1e-12
        assert_close(got, want, rtol=rtol, what=f"{np.dtype(dtype).name} n={n}")


def test_cpu_wrapper_is_plain_and_launches_nothing():
    x = torch.from_numpy(_data(np.int64, 5000))
    before = prefix_scan.LAUNCHES
    assert_exact(prefix_scan.fast_cumsum(x), prefix_scan.fast_cumsum_plain(x))
    assert prefix_scan.LAUNCHES == before


def test_rejects_bad_input():
    with pytest.raises(ValueError):
        prefix_scan.fast_cumsum(torch.zeros(4, 4, dtype=torch.int32))
    with pytest.raises(TypeError):
        prefix_scan.fast_cumsum(torch.zeros(4, dtype=torch.uint8))
