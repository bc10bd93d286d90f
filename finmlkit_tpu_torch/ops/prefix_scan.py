"""Inclusive prefix sums: kernel S (``csrc/prefix_scan.cu``).

Counterpart of ``finmlkit_tpu/ops/pallas_scan.py`` (renamed: it holds no Pallas
code). Kernel S replaces the TPU kernels ``_cumsum_2d`` (K2, int32/float32) and
``_cumsum_2d_i64`` (K3, int64 as hi/lo int32 pairs) with one templated scan over
native int32, int64, float32 and float64 streams. The TPU's ``(rows, 128)``
planes, block padding and hi/lo pairs are gone: the wrapper takes the 1-D
tensor as it is.

Integer prefixes wrap modulo 2^32 or 2^64 (two's complement), as the TPU pair
scan's do.
"""
import torch

from .. import _build

__all__ = ["fast_cumsum", "fast_cumsum_plain"]

LAUNCHES = 0  # kernel launches by fast_cumsum in this process

_DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
               torch.float64: 3}


def fast_cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fast_cumsum`, on any device.

    A float32 stream is accumulated in float64 and rounded once, so that a
    comparison with the kernel measures the kernel's own rounding.
    """
    if x.dtype == torch.float32:
        return torch.cumsum(x, 0, dtype=torch.float64).to(torch.float32)
    return torch.cumsum(x, 0, dtype=x.dtype)


def fast_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D int32, int64, float32 or float64 tensor.

    On a CUDA tensor this launches kernel S; on a CPU tensor it runs
    :func:`fast_cumsum_plain`.
    """
    global LAUNCHES
    if x.dim() != 1:
        raise ValueError(f"fast_cumsum takes a 1-D tensor, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fast_cumsum does not take {x.dtype}")
    if x.device.type == "cpu":
        return fast_cumsum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"fast_cumsum runs on cpu or cuda, not {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    lib = _build.library()
    tile = lib.fmk_scan_tile()
    partial = torch.empty((n + tile - 1) // tile, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fmk_prefix_scan(_DTYPE_CODE[x.dtype], x.data_ptr(),
                                 out.data_ptr(), partial.data_ptr(), n, stream)
    LAUNCHES += 1
    _build.check(rc, "fast_cumsum")
    return out
