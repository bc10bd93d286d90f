"""Inclusive prefix sums: kernels S and C (``csrc/prefix_scan.cu``).

Counterpart of ``finmlkit_tpu/ops/pallas_scan.py`` (renamed: it holds no Pallas
code). Kernel S replaces the TPU kernels ``_cumsum_2d`` (K2, int32/float32) and
``_cumsum_2d_i64`` (K3, int64 as hi/lo int32 pairs) with one templated scan over
native int32, int64, float32 and float64 streams. Kernel C is the same scan
with a row index in the grid: it replaces ``_cumsum_3d`` (K4a) and
``_cumsum_3d_i64`` (K4b), the prefix sums of every row of a ``(C, n)`` stack in
one launch. The TPU's ``(rows, 128)`` planes, block padding and hi/lo pairs
(``as_pair=True``) are gone: the wrappers take the tensor as it is.

Integer prefixes wrap modulo 2^32 or 2^64 (two's complement), as the TPU pair
scans' do.
"""
import torch

from .. import _build

__all__ = ["fast_cumsum", "fast_cumsum_plain", "fast_cumsum_cols",
           "fast_cumsum_cols_plain"]

LAUNCHES = 0       # kernel S launches by fast_cumsum in this process
COLS_LAUNCHES = 0  # kernel C launches by fast_cumsum_cols in this process

_DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
               torch.float64: 3}
_MAX_ROWS = 65535  # kernel C's grid takes the row from blockIdx.y


def _plain(x: torch.Tensor, dim: int) -> torch.Tensor:
    if x.dtype == torch.float32:
        return torch.cumsum(x, dim, dtype=torch.float64).to(torch.float32)
    return torch.cumsum(x, dim, dtype=x.dtype)


def fast_cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fast_cumsum`, on any device.

    A float32 stream is accumulated in float64 and rounded once, so that a
    comparison with the kernel measures the kernel's own rounding.
    """
    return _plain(x, 0)


def fast_cumsum_cols_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fast_cumsum_cols`, on any device:
    ``torch.cumsum(x, 1)``, float32 accumulated in float64 and rounded once."""
    return _plain(x, 1)


def _check(x: torch.Tensor, dim: int, what: str) -> None:
    if x.dim() != dim:
        raise ValueError(f"{what} takes a {dim}-D tensor, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} does not take {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")


def _launch(x: torch.Tensor, rows: int, n: int, what: str) -> torch.Tensor:
    """Launch the scan over ``rows`` contiguous rows of ``n`` values."""
    x = x.contiguous()
    out = torch.empty_like(x)
    if n == 0 or rows == 0:
        return out
    lib = _build.library()
    tile = lib.fmk_scan_tile()
    tiles = (n + tile - 1) // tile
    partial = torch.empty(rows * tiles, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fmk_prefix_scan_rows(_DTYPE_CODE[x.dtype], x.data_ptr(),
                                      out.data_ptr(), partial.data_ptr(),
                                      rows, n, stream)
    _build.check(rc, what)
    return out


def fast_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D int32, int64, float32 or float64 tensor.

    On a CUDA tensor this launches kernel S; on a CPU tensor it runs
    :func:`fast_cumsum_plain`.
    """
    global LAUNCHES
    _check(x, 1, "fast_cumsum")
    if x.device.type == "cpu":
        return fast_cumsum_plain(x)
    if x.numel():
        LAUNCHES += 1
    return _launch(x, 1, x.numel(), "fast_cumsum")


def fast_cumsum_cols(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of every row of a ``(C, n)`` int32, int64,
    float32 or float64 tensor, in one launch.

    On a CUDA tensor this launches kernel C; on a CPU tensor it runs
    :func:`fast_cumsum_cols_plain`. int64 rows come back as int64 that wraps
    modulo 2^64, bit-equal to ``combine_i64`` of the TPU's hi/lo pair.
    """
    global COLS_LAUNCHES
    _check(x, 2, "fast_cumsum_cols")
    if x.shape[0] > _MAX_ROWS:
        raise ValueError(f"fast_cumsum_cols takes at most {_MAX_ROWS} rows, "
                         f"got {x.shape[0]}")
    if x.device.type == "cpu":
        return fast_cumsum_cols_plain(x)
    if x.numel():
        COLS_LAUNCHES += 1
    return _launch(x, x.shape[0], x.shape[1], "fast_cumsum_cols")
