"""First-order linear recurrences: kernel R (``csrc/recurrence.cu``).

Counterpart of ``finmlkit_tpu/ops/scan.py``. The feature kernels' sequential
loops of the form ``y_t = a_t * y_{t-1} + b_t`` (EWMA, the EWM variances,
Wilder's RSI, ATR and ADX smoothing) compose as affine maps,
``(a1, b1) then (a2, b2) = (a1 * a2, b1 * a2 + b2)``, and the JAX package runs
them as ``jax.lax.associative_scan`` over those maps. Kernel R replaces that
XLA scan (it is not a TPU kernel): three launches in a fixed association order,
so a result repeats bit for bit from run to run. :func:`linear_recurrence_plain`
is the plain version, a log-depth doubling scan in PyTorch.

``padded_to_bucket`` (an XLA recompile workaround) does not cross to the port;
``next_bucket`` does, for the footprint grid's level count.
"""
import torch

from .. import _build

__all__ = ["linear_recurrence", "linear_recurrence_plain", "next_bucket"]

LAUNCHES = 0  # kernel R launches in this process

_MAX_ROWS = 65535  # kernel R's grid takes the row from blockIdx.y


def next_bucket(n: int, min_bucket: int = 1024) -> int:
    """The first ``min_bucket * 2^k`` at or above ``n``."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


def _operands(a, b, y0):
    """Check the arguments; return ``b`` and ``a`` and ``y0`` as tensors on
    ``b``'s device (``a`` may stay a Python float), ``y0`` one value a row."""
    if not torch.is_tensor(b) or b.dtype != torch.float64 or b.dim() not in (1, 2):
        raise TypeError("linear_recurrence takes b as a 1-D or 2-D float64 tensor")
    if b.device.type not in ("cpu", "cuda"):
        raise ValueError(f"linear_recurrence runs on cpu or cuda, not {b.device}")
    rows = b.shape[0] if b.dim() == 2 else 1
    if torch.is_tensor(a):
        n = b.shape[-1]
        shapes = [(n,), tuple(b.shape)] + ([(rows, 1)] if b.dim() == 2 else [])
        if a.dtype != torch.float64 or tuple(a.shape) not in shapes \
                or a.device != b.device:
            raise ValueError(f"a must be a float, or a float64 tensor on b's device "
                             f"of shape {' or '.join(map(str, shapes))}, got "
                             f"{a.dtype} {tuple(a.shape)}")
    else:
        a = float(a)
    if y0 is not None:
        if torch.is_tensor(y0):
            y0 = y0.to(device=b.device, dtype=torch.float64).reshape(-1).contiguous()
            if y0.numel() != rows:
                raise ValueError(f"y0 must hold one value a row ({rows}), got "
                                 f"{y0.numel()}")
        else:
            y0 = torch.full((rows,), float(y0), dtype=torch.float64, device=b.device)
    return a, b, y0


def _fold_y0(a, b, y0):
    """``b`` with ``y0`` folded into each row's first value, as
    ``finmlkit_tpu/ops/scan.py:28-29`` does: ``b_0 + a_0 * y0``."""
    b = b.clone()
    a0 = a[..., :1] if torch.is_tensor(a) else a
    b[..., :1] += a0 * y0.reshape(b.shape[:-1] + (1,))
    return b


def linear_recurrence_plain(a, b, y0=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`linear_recurrence`, on any device: a
    doubling scan of the affine maps, about ``log2(n)`` rounds of four
    elementwise operations."""
    a, b, y0 = _operands(a, b, y0)
    if b.shape[-1] == 0:
        return b.clone()
    if y0 is not None:
        b = _fold_y0(a, b, y0)
    A = a.expand_as(b).clone() if torch.is_tensor(a) else torch.full_like(b, a)
    B = b.clone()
    n, k = b.shape[-1], 1
    while k < n:
        # element i composes the map of (i-2k, i-k] before its own (i-k, i]
        B[..., k:] = B[..., :-k] * A[..., k:] + B[..., k:]
        A[..., k:] = A[..., :-k] * A[..., k:]
        k *= 2
    return B


def linear_recurrence(a, b, y0=None) -> torch.Tensor:
    """``y_t = a_t * y_{t-1} + b_t`` along the last axis of ``b``.

    ``b`` is a float64 tensor of shape ``(n,)`` or ``(rows, n)``; ``a`` a
    Python float, or a float64 tensor of shape ``(n,)`` (the same for every
    row), of ``b``'s shape, or ``(rows, 1)`` (one a a row). ``y_{-1}`` is
    ``y0`` (default 0): a float, or one value a row. On a CUDA tensor this
    launches kernel R; on a CPU tensor it runs :func:`linear_recurrence_plain`.
    A NaN in ``b`` makes every later ``y`` of its row NaN and no earlier one.
    """
    global LAUNCHES
    a, b, y0 = _operands(a, b, y0)
    if b.device.type == "cpu":
        return linear_recurrence_plain(a, b, y0)
    rows, n = (b.shape[0], b.shape[1]) if b.dim() == 2 else (1, b.shape[0])
    if rows > _MAX_ROWS:
        raise ValueError(f"linear_recurrence takes at most {_MAX_ROWS} rows, got {rows}")
    b = b.contiguous()
    out = torch.empty_like(b)
    if out.numel() == 0:
        return out
    a_ptr, a_const, a_rs, a_cs = 0, 0.0, 0, 0
    if torch.is_tensor(a):
        a = a.contiguous()
        a_ptr = a.data_ptr()
        if tuple(a.shape) == (n,):
            a_rs, a_cs = 0, 1             # one a a value, shared by the rows
        elif a.shape[-1] == n:
            a_rs, a_cs = n, 1             # one a a value of each row
        else:
            a_rs, a_cs = 1, 0             # (rows, 1): one a a row
    else:
        a_const = a
    lib = _build.library()
    scratch = torch.empty(lib.fmk_recurrence_scratch_bytes(rows, n),
                          dtype=torch.uint8, device=b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = lib.fmk_linear_recurrence(a_ptr or None, a_const, a_rs, a_cs,
                                       b.data_ptr(),
                                       None if y0 is None else y0.data_ptr(),
                                       out.data_ptr(), scratch.data_ptr(), rows, n,
                                       stream)
    _build.check(rc, "linear_recurrence")
    LAUNCHES += 1
    return out
