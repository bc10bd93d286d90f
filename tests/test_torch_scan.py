"""Prefix sums of finmlkit_tpu_torch (plain paths of kernels S and C) against
the TPU kernels of the JAX package, run in interpret mode on the CPU:
``_cumsum_2d`` (int32, float32) and ``_cumsum_2d_i64`` (int64 as hi/lo pairs,
wrapping past 2^63) for S; ``fast_cumsum_cols``, i.e. ``_cumsum_3d`` (K4a) and
``_cumsum_3d_i64`` (K4b, combined and as the raw hi/lo pair) for C; and
``jnp.cumsum`` for float64 (the JAX package's off-TPU path).

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


def _rows(dtype, c, n):
    x = np.stack([_data(dtype, n, seed=1000 * r) for r in range(c)])
    if c > 1 and dtype == np.int64:
        x[1] = np.random.default_rng(n).integers(-1000, 1000, n)  # beside a wrapping row
    return x


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32, np.float64])
def test_plain_cols_scan_matches_jax(dtype, c, n):
    x = _rows(dtype, c, n)
    before = prefix_scan.COLS_LAUNCHES
    got = prefix_scan.fast_cumsum_cols(torch.from_numpy(x))
    assert prefix_scan.COLS_LAUNCHES == before
    what = f"{np.dtype(dtype).name} C={c} n={n}"
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == x.shape
    if dtype == np.float64:
        want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=1))
    else:
        want = np.asarray(pallas_scan.fast_cumsum_cols(jnp.asarray(x),
                                                       interpret=True))
    if dtype == np.int64:
        hi, lo = pallas_scan.fast_cumsum_cols(jnp.asarray(x), interpret=True,
                                              as_pair=True)
        assert_exact(got, np.asarray(pallas_scan.combine_i64(hi, lo)), what)
    if dtype in (np.int32, np.int64):
        assert_exact(got, want, what)
    else:
        rtol = 1e-5 if dtype == np.float32 else 1e-12
        assert_close(got, want, rtol=rtol, what=what)


def test_cols_rejects_bad_input():
    with pytest.raises(ValueError):
        prefix_scan.fast_cumsum_cols(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        prefix_scan.fast_cumsum_cols(torch.zeros(2, 4, dtype=torch.int16))
    with pytest.raises(ValueError):
        prefix_scan.fast_cumsum_cols(torch.zeros(70000, 1, dtype=torch.int32))
