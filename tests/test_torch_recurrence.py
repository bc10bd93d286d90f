"""The plain path of kernel R (``ops/scan.py linear_recurrence_plain``, a
doubling scan) against the JAX package's ``ops/scan.py linear_recurrence``
(an associative scan) on XLA:CPU and against a sequential loop in numpy.

The three sum the same terms in three orders, so they agree within a rounding
bound, not bit for bit. That bound scales with the magnitude of the terms
summed, not with the result (a recurrence over signed terms can cancel to
near 0): ``|diff| <= 1e-12 * (|want| + scale)``, ``scale`` the largest
recurrence of ``|a|`` and ``|b|``. NaN positions must be equal: a NaN in ``b``
reaches every later ``y`` and no earlier one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finmlkit_tpu.ops.scan import linear_recurrence as jax_linear_recurrence
from finmlkit_tpu.ops.scan import next_bucket as jax_next_bucket
from finmlkit_tpu_torch.ops import scan
from finmlkit_tpu_torch.testing import assert_exact, assert_window_close

RTOL = 1e-12
LENGTHS = [1, 2, 2047, 2048, 2049]


def _sequential(a, b, y0=None):
    y = np.empty_like(b)
    prev = 0.0 if y0 is None else y0
    for t in range(len(b)):
        prev = a[t] * prev + b[t]
        y[t] = prev
    return y


def _case(kind: str, n: int, seed: int = 0):
    """(a as passed, a per value, b, y0) in numpy, float64."""
    r = np.random.default_rng(seed + n)
    b = r.normal(0.0, 1.0, n)
    y0 = None
    if kind == "const":
        a = 0.95
    elif kind == "varying":                 # ewmst's per-step decay
        a = np.exp(-r.exponential(0.05, n))
    elif kind == "y0":
        a, y0 = 13.0 / 14.0, 2.5
    elif kind == "nan":
        a = r.uniform(0.5, 1.0, n)
        b[n // 3] = np.nan
    else:
        raise ValueError(kind)
    a_full = np.full(n, a) if np.isscalar(a) else a
    return a, a_full, b, y0


def _scale(a_full, b):
    return float(np.nanmax(np.abs(_sequential(np.abs(a_full), np.nan_to_num(np.abs(b))))))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", ["const", "varying", "y0", "nan"])
def test_plain_matches_jax_and_loop(kind, n):
    a, a_full, b, y0 = _case(kind, n)
    a_t = a if np.isscalar(a) else torch.from_numpy(a)
    got = scan.linear_recurrence_plain(a_t, torch.from_numpy(b), y0=y0)
    jy0 = None if y0 is None else jnp.float64(y0)
    want = np.asarray(jax_linear_recurrence(jnp.asarray(a_full), jnp.asarray(b), y0=jy0))
    seq = _sequential(a_full, b, y0)
    scale = _scale(a_full, b) + (0.0 if y0 is None else abs(y0))
    assert_window_close(got, want, scale, RTOL, f"{kind} vs jax")
    assert_window_close(got, seq, scale, RTOL, f"{kind} vs loop")
    if kind == "nan":
        assert np.array_equal(np.isnan(got.numpy()), np.arange(n) >= n // 3)


@pytest.mark.parametrize("n", LENGTHS)
def test_wrapper_on_cpu_is_plain(n):
    a, a_full, b, _ = _case("varying", n)
    got = scan.linear_recurrence(torch.from_numpy(a), torch.from_numpy(b), y0=-1.0)
    assert_exact(got, scan.linear_recurrence_plain(torch.from_numpy(a),
                                                   torch.from_numpy(b), y0=-1.0))


@pytest.mark.parametrize("a_shape", ["float", "row", "rows_by_1", "full"])
def test_rows_match_one_row_at_a_time(a_shape):
    r = np.random.default_rng(3)
    rows, n = 3, 2049
    b = torch.from_numpy(r.normal(size=(rows, n)))
    per_row = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64)
    a = {"float": 0.9, "row": torch.from_numpy(r.uniform(0.5, 1.0, n)),
         "rows_by_1": per_row[:, None],
         "full": torch.from_numpy(r.uniform(0.5, 1.0, (rows, n)))}[a_shape]
    y0 = torch.tensor([1.0, -2.0, 3.0], dtype=torch.float64)
    got = scan.linear_recurrence(a, b, y0=y0)
    for i in range(rows):
        a_i = a if not torch.is_tensor(a) else (a if a.dim() == 1 else a[i])
        if torch.is_tensor(a_i) and a_i.numel() == 1:
            a_i = float(a_i)
        assert_exact(got[i], scan.linear_recurrence(a_i, b[i].clone(), y0=y0[i]),
                     f"row {i}")


def test_rejects_bad_operands():
    b = torch.zeros(5, dtype=torch.float64)
    with pytest.raises(TypeError):
        scan.linear_recurrence(0.5, b.float())
    with pytest.raises(ValueError):
        scan.linear_recurrence(torch.zeros(4, dtype=torch.float64), b)
    with pytest.raises(ValueError):
        scan.linear_recurrence(0.5, torch.zeros((2, 5), dtype=torch.float64),
                               y0=torch.zeros(3))


def test_empty():
    assert scan.linear_recurrence(0.5, torch.zeros(0, dtype=torch.float64)).shape == (0,)


@pytest.mark.parametrize("n,min_bucket", [(1, 8), (8, 8), (9, 8), (1000, 1024),
                                          (1025, 1024), (5000, 1024)])
def test_next_bucket_matches_jax(n, min_bucket):
    assert scan.next_bucket(n, min_bucket) == jax_next_bucket(n, min_bucket)
