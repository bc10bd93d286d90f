"""Forward fill of finmlkit_tpu_torch (the plain path of kernel F) against the
JAX package on the CPU: float32 against the TPU kernel ``_ffill_2d`` (K5) run
in interpret mode through ``fast_ffill(..., interpret=True)``; float64
against the JAX package's off-TPU path, the running max of the valid
positions and a gather. The output is a selection: bit-exact, NaN included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finmlkit_tpu.ops.pallas_scan import fast_ffill as jax_fast_ffill
from finmlkit_tpu_torch.ops import prefix_scan
from finmlkit_tpu_torch.testing import assert_exact

LENGTHS = [1, 8191, 8192, 8193, 20000]   # across the Pallas kernel's 8192 tiles


def _case(mask: str, n: int, dtype, seed: int = 0):
    r = np.random.default_rng(seed + n)
    v = r.normal(size=n).astype(dtype)
    v[::7] = np.nan                      # NaN payloads move as they are
    if mask == "leading_invalid":
        m = r.random(n) < 0.3
        m[:min(n, 4000)] = False
    elif mask == "all_invalid":
        m = np.zeros(n, bool)
    elif mask == "all_valid":
        m = np.ones(n, bool)
    else:
        m = r.random(n) < 0.3
    return v, m


MASKS = ["leading_invalid", "all_invalid", "all_valid", "random_30"]


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("mask", MASKS)
def test_plain_ffill_matches_pallas_f32(mask, n):
    v, m = _case(mask, n, np.float32)
    want = np.asarray(jax_fast_ffill(jnp.asarray(v), jnp.asarray(m),
                                     interpret=True))
    got = prefix_scan.fast_ffill_plain(torch.from_numpy(v), torch.from_numpy(m))
    assert_exact(got.numpy().view(np.int32), want.view(np.int32), f"{mask} {n}")


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("mask", MASKS)
def test_plain_ffill_matches_jax_f64(mask, n):
    v, m = _case(mask, n, np.float64)
    want = np.asarray(jax_fast_ffill(jnp.asarray(v), jnp.asarray(m)))
    got = prefix_scan.fast_ffill(torch.from_numpy(v), torch.from_numpy(m))
    assert_exact(got.numpy().view(np.int64), want.view(np.int64), f"{mask} {n}")


def test_ffill_semantics_and_checks():
    v = torch.tensor([5.0, 1.0, 2.0, 3.0, 4.0], dtype=torch.float64)
    m = torch.tensor([False, False, True, False, True])
    # before the first valid position: values[0]
    assert prefix_scan.fast_ffill(v, m).tolist() == [5.0, 5.0, 2.0, 2.0, 4.0]
    empty = torch.empty(0, dtype=torch.float32)
    assert prefix_scan.fast_ffill(empty, empty.bool()).shape == (0,)
    with pytest.raises(TypeError):
        prefix_scan.fast_ffill(v.to(torch.int64), m)
    with pytest.raises(ValueError):
        prefix_scan.fast_ffill(v, m[:3])
