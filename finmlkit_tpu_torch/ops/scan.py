"""First-order linear recurrences: kernel R (``csrc/recurrence.cu``).

Counterpart of ``finmlkit_tpu/ops/scan.py``. The feature kernels' sequential
loops of the form ``y_t = a_t * y_{t-1} + b_t`` (EWMA, the EWM variances,
Wilder's RSI, ATR and ADX smoothing) compose as affine maps,
``(a1, b1) then (a2, b2) = (a1 * a2, b1 * a2 + b2)``, and the JAX package runs
them as ``jax.lax.associative_scan`` over those maps. Kernel R replaces that
XLA scan (it is not a TPU kernel): one single-pass launch over tiles of 2048
values (8192 where a is a float or one a row) with a decoupled look-back, its
carries fixed by one association (a warp scan of the tiles' maps within
groups of 32 tiles, and the groups' maps applied to a scalar y, oldest
first), so a result repeats bit for bit from run to run whichever group a
look-back stops at. :func:`lookback_model` is that scheme on the CPU, with
the look-backs' stops drawn at random. :func:`linear_recurrence_plain` is the
plain version, a log-depth doubling scan in PyTorch.

``padded_to_bucket`` (an XLA recompile workaround) does not cross to the port;
``next_bucket`` does, for the footprint grid's level count.
"""
import numpy as np
import torch

from .. import _build

__all__ = ["linear_recurrence", "linear_recurrence_plain", "lookback_model", "next_bucket"]

LAUNCHES = 0  # kernel R launches in this process

TILE = 2048  # kernel R's tile, in values of a row, where a comes a value an element
TILE_WIDE = 8192  # its tile where a is a float or one value a row


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


def _then(x, y):
    """Map x, then map y."""
    return x[0] * y[0], x[1] * y[0] + y[1]


def _warp_scan(maps):
    """The inclusive 32-lane Hillis-Steele scan of kernel R's groups: lane l
    composes lanes l - o and l at offsets o = 1, 2, ..., 16."""
    x, o = list(maps), 1
    while o < 32:
        x = [x[i] if i < o else _then(x[i - o], x[i]) for i in range(len(x))]
        o *= 2
    return x


def lookback_model(a, b, y0=None, tile: int = TILE, group: int = 32, rng=None,
                   compose: bool = False):
    """Kernel R's scheme on the CPU, in Python floats: each row cut into tiles
    of ``tile`` values and the tiles into groups of ``group``; each tile's map
    composed in order; a tile's carry is its group's maps before it composed
    by the kernel's fixed warp scan, applied to the y at the end of the group
    before. That y comes from a look-back over the groups that stops at a
    group drawn from ``rng`` among those the kernel's warp can stop at (one of
    the 32 before, or the row's start within them; the group just before with
    no ``rng``) and applies the group maps from there to the scalar y, oldest
    first, from the end y that group's last tile computed in its own
    look-back. ``compose=True`` is the design the kernel rejects: those group
    maps composed into one map first, then applied. Returns ``(y, walked)``,
    ``walked`` each tile's look-back length as the kernel counts it (its place
    in its group, plus ``group`` for each group map applied). Arguments as
    :func:`linear_recurrence`."""
    a, b, y0 = _operands(a, b, y0)
    if y0 is not None:
        b = _fold_y0(a, b, y0)
    bb = b.reshape(-1, b.shape[-1]).numpy()
    aa = (a.expand_as(b) if torch.is_tensor(a) else torch.full_like(b, a)).reshape(
        bb.shape).numpy()
    out, walked = np.empty_like(bb), []
    for r_ in range(bb.shape[0]):
        maps, gmaps, gends = [], [], []
        for i, s0 in enumerate(range(0, bb.shape[1], tile)):
            ta, tb = aa[r_, s0:s0 + tile].tolist(), bb[r_, s0:s0 + tile].tolist()
            m = (1.0, 0.0)
            for ai, bi in zip(ta, tb):
                m = _then(m, (ai, bi))
            maps.append(m)
            grp, r = divmod(i, group)
            scan = _warp_scan(maps[grp * group:i + 1])
            back = 1 if rng is None or grp == 0 else 1 + int(rng.integers(0, min(32, grp + 1)))
            stop = grp - back                       # -1: the row's start, y = 0
            y = gends[stop] if stop >= 0 else 0.0
            if compose:
                c = (1.0, 0.0)
                for gm in gmaps[stop + 1:grp]:
                    c = _then(c, gm)
                y = c[0] * y + c[1]
            else:
                for gm in gmaps[stop + 1:grp]:      # oldest first
                    y = gm[0] * y + gm[1]
            if r == group - 1:                      # the group's map and end y
                gmaps.append(scan[r])
                gends.append(scan[r][0] * y + scan[r][1])
            walked.append(r + group * (back - 1 if grp > 0 else 0))
            y = scan[r - 1][0] * y + scan[r - 1][1] if r > 0 else y
            for t, (ai, bi) in enumerate(zip(ta, tb)):
                y = ai * y + bi
                out[r_, s0 + t] = y
    return torch.from_numpy(out.reshape(b.shape)), walked


def linear_recurrence(a, b, y0=None) -> torch.Tensor:
    """``y_t = a_t * y_{t-1} + b_t`` along the last axis of ``b``.

    ``b`` is a float64 tensor of shape ``(n,)`` or ``(rows, n)``; ``a`` a
    Python float, or a float64 tensor of shape ``(n,)`` (the same for every
    row), of ``b``'s shape, or ``(rows, 1)`` (one a a row). ``y_{-1}`` is
    ``y0`` (default 0): a float, or one value a row. On a CUDA tensor this
    launches kernel R; on a CPU tensor it runs :func:`linear_recurrence_plain`.
    A NaN in ``b`` makes every later ``y`` of its row NaN and no earlier one.
    """
    a, b, y0 = _operands(a, b, y0)
    if b.device.type == "cpu":
        return linear_recurrence_plain(a, b, y0)
    return _kernel(a, b, y0)


def tile_of(a, n: int) -> int:
    """Kernel R's tile for ``a`` over rows of ``n`` values."""
    per_value = torch.is_tensor(a) and (tuple(a.shape) == (n,) or a.shape[-1] == n)
    return TILE if per_value else TILE_WIDE


def _kernel(a, b, y0, dist=None) -> torch.Tensor:
    """Kernel R on checked operands (CUDA). ``dist``, if given, is an int32
    tensor of one value a tile (``rows * ceil(n / tile_of(a, n))``) that
    receives each tile's look-back length."""
    global LAUNCHES
    rows, n = (b.shape[0], b.shape[1]) if b.dim() == 2 else (1, b.shape[0])
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
                                       None if dist is None else dist.data_ptr(),
                                       stream)
    _build.check(rc, "linear_recurrence")
    LAUNCHES += 1
    return out
