"""Inclusive prefix sums: kernels S and C (``csrc/prefix_scan.cu``).

Counterpart of ``finmlkit_tpu/ops/pallas_scan.py`` (renamed: it holds no Pallas
code). Kernel S replaces the TPU kernels ``_cumsum_2d`` (K2, int32/float32) and
``_cumsum_2d_i64`` (K3, int64 as hi/lo int32 pairs) with one templated scan over
native int32, int64, float32 and float64 streams. Kernel C is the same scan
with a row index in the grid: it replaces ``_cumsum_3d`` (K4a) and
``_cumsum_3d_i64`` (K4b), the prefix sums of every row of a ``(C, n)`` stack in
one launch. The TPU's ``(rows, 128)`` planes, block padding and hi/lo pairs
(``as_pair=True``) are gone: the wrappers take the tensor as it is.

An integer stream or stack is ONE launch, a single-pass scan with a decoupled
look-back; its prefixes wrap modulo 2^32 or 2^64 (two's complement), as the
TPU pair scans' do. A float stream keeps three launches in a fixed order, so
that it repeats bit for bit from run to run.

Kernel F (``csrc/ffill.cu``) is the forward fill of ``fast_ffill``: it
replaces ``_ffill_2d`` (K5), which moved float32 values as int32 bits through
``(rows, 128)`` planes; here float32 and float64 move as their own bits. With
its zero-before flag it is also ``fill_last``, the segmented last-fill of
int32 values at marks of the radix-select median engine: it replaces
``_fill_last_planes`` (L1, ``finmlkit_tpu/ops/segment_select.py``).
"""
import torch

from .. import _build

__all__ = ["fast_cumsum", "fast_cumsum_plain", "fast_cumsum_cols",
           "fast_cumsum_cols_plain", "fast_ffill", "fast_ffill_plain",
           "fill_last", "fill_last_plain"]

LAUNCHES = 0        # kernel S launches in this process: fast_cumsum's, and the
                    # one in each kernel E scan (ops/event_scan.py)
FLOAT_LAUNCHES = 0  # of fast_cumsum's, those on float streams (three passes)
COLS_LAUNCHES = 0   # kernel C launches by fast_cumsum_cols in this process
FFILL_LAUNCHES = 0  # kernel F launches by fast_ffill in this process
FILL_LAST_LAUNCHES = 0  # kernel F launches by fill_last in this process

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
    code = _DTYPE_CODE[x.dtype]
    scratch = torch.empty(lib.fmk_scan_scratch_bytes(code, rows, n),
                          dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fmk_prefix_scan_rows(code, x.data_ptr(), out.data_ptr(),
                                      scratch.data_ptr(), rows, n, stream)
    _build.check(rc, what)
    return out


def fast_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D int32, int64, float32 or float64 tensor.

    On a CUDA tensor this launches kernel S; on a CPU tensor it runs
    :func:`fast_cumsum_plain`.
    """
    global LAUNCHES, FLOAT_LAUNCHES
    _check(x, 1, "fast_cumsum")
    if x.device.type == "cpu":
        return fast_cumsum_plain(x)
    if x.numel():
        LAUNCHES += 1
        FLOAT_LAUNCHES += x.dtype.is_floating_point
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


def fast_ffill_plain(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fast_ffill`, on any device: the running
    max of the valid positions and a gather (``finmlkit_tpu/bar/indexers.py:
    633-635``)."""
    n = values.shape[0]
    if n == 0:
        return values.clone()
    idx = torch.arange(n, device=values.device)
    last = torch.cummax(torch.where(valid, idx, -1), 0).values
    return values[last.clamp(0, n - 1)]


def _launch_ffill(values, valid, zero_before: bool, what: str) -> torch.Tensor:
    """Kernel F over a CUDA ``values`` tensor of 4- or 8-byte elements."""
    if values.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {values.device}")
    values, valid = values.contiguous(), valid.contiguous()
    out = torch.empty_like(values)
    n = values.shape[0]
    if n == 0:
        return out
    lib = _build.library()
    tiles = (n + lib.fmk_ffill_tile() - 1) // lib.fmk_ffill_tile()
    scratch = torch.empty(tiles, dtype=torch.int64, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.fmk_ffill(values.element_size(), values.data_ptr(),
                           valid.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                           n, int(zero_before), stream)
    _build.check(rc, what)
    return out


def _check_mask(values, valid, what: str) -> None:
    if valid.shape != values.shape or valid.dtype != torch.bool \
            or valid.device != values.device:
        raise ValueError(f"{what}: the mask must be a bool tensor of the "
                         "values' shape and device")


def fast_ffill(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Forward fill: ``out[i] = values[j]``, ``j`` the last position ``<= i``
    where ``valid`` is true; positions before the first valid one take
    ``values[0]`` (the reference's ``sig[clip(last_valid, 0, n - 1)]``).

    ``values`` is a 1-D float32 or float64 tensor, ``valid`` a bool tensor of
    its length. The output is a selection, equal to the input's bits. On a
    CUDA tensor this launches kernel F; on a CPU tensor it runs
    :func:`fast_ffill_plain`.
    """
    global FFILL_LAUNCHES
    if values.dim() != 1 or values.dtype not in (torch.float32, torch.float64):
        raise TypeError("fast_ffill takes a 1-D float32 or float64 tensor, got "
                        f"{values.dtype} of shape {tuple(values.shape)}")
    _check_mask(values, valid, "fast_ffill")
    if values.device.type == "cpu":
        return fast_ffill_plain(values, valid)
    out = _launch_ffill(values, valid, False, "fast_ffill")
    if values.numel():
        FFILL_LAUNCHES += 1
    return out


def fill_last_plain(values: torch.Tensor, marks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fill_last`, on any device: the running
    max of the position-tagged marks and a gather, 0 before the first mark
    (``finmlkit_tpu/ops/segment_select.py:95-100``)."""
    n = values.shape[0]
    if n == 0:
        return values.clone()
    idx = torch.arange(n, device=values.device)
    last = torch.cummax(torch.where(marks, idx, -1), 0).values
    return torch.where(last >= 0, values[last.clamp(min=0)],
                       torch.zeros((), dtype=values.dtype, device=values.device))


def fill_last(values: torch.Tensor, marks: torch.Tensor) -> torch.Tensor:
    """Segmented last-fill: ``out[j] = values[i]``, ``i`` the last position
    ``<= j`` where ``marks`` is true, and 0 before the first mark.

    ``values`` is a 1-D int32 tensor, ``marks`` a bool tensor of its length.
    On a CUDA tensor this launches kernel F with its zero-before flag (the
    int32 values move as 4-byte bits); on a CPU tensor it runs
    :func:`fill_last_plain`.
    """
    global FILL_LAST_LAUNCHES
    if values.dim() != 1 or values.dtype != torch.int32:
        raise TypeError("fill_last takes a 1-D int32 tensor, got "
                        f"{values.dtype} of shape {tuple(values.shape)}")
    _check_mask(values, marks, "fill_last")
    if values.device.type == "cpu":
        return fill_last_plain(values, marks)
    out = _launch_ffill(values, marks, True, "fill_last")
    if values.numel():
        FILL_LAST_LAUNCHES += 1
    return out
