"""Histogram-select per-bar medians: the ``medians="hist"`` engine, with
kernel H (``csrc/segment_hist.cu``).

Counterpart of ``finmlkit_tpu/ops/segment_hist.py``. The upper-middle value
of every bar is found by 4-bit radix refinement on the raw bits of the
amounts, most significant nibble first: 8 passes (``_SHIFTS``), each one
histogram of the 16 buckets ``(bits - B[bar]) >> s`` per bar, and a choice
of bucket per bar on the ``(n_bars, 16)`` counts. One "less" pass then gives
the count and the largest of the bits below it, which settles the lower
middle exactly under ties.

Kernel H replaces the TPU kernels ``_hist_pass`` (H1) and ``_less_pass``
(H2): one block per bar reads its trades ``(ci[k], ci[k+1]]`` and writes one
row, so the TPU's row tails, flag and scatter planes, in-kernel base fill and
XLA boundary fixups (``_hist_fix``, ``_less_fix``, ``bar_hist``) do not
cross, nor does the log-shift prefix over the 16 buckets (``torch.cumsum``
here).

Precondition: the amounts are nonnegative (their float32 bits then order as
the values do). Empty bars get garbage brackets, which callers mask.
"""
import torch

from .. import _build

__all__ = ["segment_median_pair_hist", "hist_pass", "hist_pass_plain",
           "less_pass", "less_pass_plain", "SHIFTS"]

LAUNCHES = 0  # kernel H launches by hist_pass and less_pass in this process

SHIFTS = (28, 24, 20, 16, 12, 8, 4, 0)
_NB = 16
_I32MIN = -2147483648


def _bar_of_trade(ci: torch.Tensor, n: int):
    """Bar id of every trade (``n_bars`` for the trades outside every bar)."""
    nb = ci.shape[0] - 1
    idx = torch.arange(n, device=ci.device)
    valid = (idx > ci[0]) & (idx <= ci[-1])
    bar = torch.searchsorted(ci[1:].contiguous(), idx)
    return torch.where(valid, bar, nb)


def hist_pass_plain(bits, ci, base, s: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`hist_pass`, on any device: bar ids,
    then one ``torch.bincount`` of ``bar * 16 + bucket``."""
    nb = ci.shape[0] - 1
    bar = _bar_of_trade(ci, bits.shape[0])
    bucket = (bits - base[bar.clamp(max=nb - 1)]) >> s
    keep = (bar < nb) & (bucket >= 0) & (bucket < _NB)
    key = torch.where(keep, bar * _NB + bucket, nb * _NB)
    return torch.bincount(key, minlength=nb * _NB + 1)[:nb * _NB] \
        .view(nb, _NB).to(torch.int32)


def less_pass_plain(bits, ci, v):
    """Plain PyTorch version of :func:`less_pass`, on any device."""
    nb = ci.shape[0] - 1
    bar = _bar_of_trade(ci, bits.shape[0])
    less = (bar < nb) & (bits < v[bar.clamp(max=nb - 1)])
    slot = torch.where(less, bar, nb)
    cnt = torch.zeros(nb + 1, dtype=torch.int32, device=bits.device)
    cnt.index_add_(0, slot, less.to(torch.int32))
    mx = torch.full((nb + 1,), _I32MIN, dtype=torch.int32, device=bits.device)
    mx.scatter_reduce_(0, slot, bits, "amax")
    return cnt[:nb], mx[:nb]


def _check(bits, ci, per_bar, what):
    if bits.dim() != 1 or bits.dtype != torch.int32:
        raise TypeError(f"{what}: bits must be a 1-D int32 tensor")
    if ci.dim() != 1 or ci.dtype != torch.int64 or ci.shape[0] < 2:
        raise TypeError(f"{what}: ci must be a 1-D int64 tensor of at least 2")
    if per_bar is not None and (per_bar.dtype != torch.int32
                                or per_bar.shape != (ci.shape[0] - 1,)):
        raise TypeError(f"{what}: the per-bar values must be int32, one a bar")
    if ci.device != bits.device or (per_bar is not None
                                    and per_bar.device != bits.device):
        raise ValueError(f"{what}: the tensors lie on different devices")
    if bits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {bits.device}")


def _check_ci(bits, ci, what):
    """Contiguous ``bits`` and ``ci``, after checking that ``ci`` keeps the
    kernel inside the trades: one wait for the card."""
    if ci.shape[0] - 1 >= 2**31:
        raise ValueError(f"{what}: {ci.shape[0] - 1} bars exceed the kernel's grid")
    bits, ci = bits.contiguous(), ci.contiguous()
    ok = (ci[0] >= -1) & (ci[-1] < bits.shape[0]) & torch.all(ci[1:] >= ci[:-1])
    if not bool(ok):
        raise ValueError(f"{what}: ci must be sorted with -1 <= ci[0] and ci[-1] < n")
    return bits, ci


def _launch_hist(bits, ci, base, s: int) -> torch.Tensor:
    """Kernel H's histogram pass on contiguous CUDA tensors and a checked
    ``ci``."""
    global LAUNCHES
    nb = ci.shape[0] - 1
    base = base.contiguous()
    out = torch.empty((nb, _NB), dtype=torch.int32, device=bits.device)
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream(bits.device).cuda_stream
        rc = _build.library().fmk_hist_pass(bits.data_ptr(), ci.data_ptr(),
                                            base.data_ptr(), int(s), nb,
                                            out.data_ptr(), stream)
    LAUNCHES += 1
    _build.check(rc, "hist_pass")
    return out


def _launch_less(bits, ci, v):
    """Kernel H's less pass on contiguous CUDA tensors and a checked ``ci``."""
    global LAUNCHES
    nb = ci.shape[0] - 1
    v = v.contiguous()
    cnt = torch.empty(nb, dtype=torch.int32, device=bits.device)
    mx = torch.empty(nb, dtype=torch.int32, device=bits.device)
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream(bits.device).cuda_stream
        rc = _build.library().fmk_less_pass(bits.data_ptr(), ci.data_ptr(),
                                            v.data_ptr(), nb, cnt.data_ptr(),
                                            mx.data_ptr(), stream)
    LAUNCHES += 1
    _build.check(rc, "less_pass")
    return cnt, mx


def hist_pass(bits, ci, base, s: int) -> torch.Tensor:
    """``(n_bars, 16)`` int32 counts of ``(bits - base[k]) >> s`` in
    ``[0, 16)`` over bar k's trades ``(ci[k], ci[k+1]]`` (int32 arithmetic
    that wraps). On CUDA tensors this checks ``ci`` and launches kernel H; on
    CPU tensors it runs :func:`hist_pass_plain`."""
    _check(bits, ci, base, "hist_pass")
    if bits.device.type == "cpu":
        return hist_pass_plain(bits, ci, base, s)
    return _launch_hist(*_check_ci(bits, ci, "hist_pass"), base, s)


def less_pass(bits, ci, v):
    """Per bar, the count of its trades with ``bits < v[k]`` and the largest
    of those bits (``I32MIN`` if none), both int32. On CUDA tensors this
    checks ``ci`` and launches kernel H; on CPU tensors it runs
    :func:`less_pass_plain`."""
    _check(bits, ci, v, "less_pass")
    if bits.device.type == "cpu":
        return less_pass_plain(bits, ci, v)
    return _launch_less(*_check_ci(bits, ci, "less_pass"), v)


def segment_median_pair_hist(amounts_f32: torch.Tensor, ci: torch.Tensor, *,
                             hist=None, less=None):
    """Per-bar ``np.median`` brackets ``(med_a, med_b)`` (float32) by
    histogram select: the 8 passes of ``hist`` and one of ``less``, the
    bucket choice in torch (``segment_hist.py:299-333``). Each left as None
    is kernel H on CUDA tensors, with ``ci`` checked once for all nine
    launches, and its plain version on CPU tensors."""
    if amounts_f32.dtype != torch.float32 or amounts_f32.dim() != 1:
        raise TypeError("amounts_f32 must be a 1-D float32 tensor")
    bits = amounts_f32.view(torch.int32)
    _check(bits, ci, None, "segment_median_pair_hist")
    on_card = bits.device.type == "cuda"
    if on_card and (hist is None or less is None):
        bits, ci = _check_ci(bits, ci, "segment_median_pair_hist")
    hist = hist or (_launch_hist if on_card else hist_pass_plain)
    less = less or (_launch_less if on_card else less_pass_plain)
    counts = ci[1:] - ci[:-1]
    k = counts.to(torch.int32) // 2                  # upper-middle rank
    B = torch.zeros(ci.shape[0] - 1, dtype=torch.int32, device=bits.device)
    for s in SHIFTS:
        cum = torch.cumsum(hist(bits, ci, B, s), 1, dtype=torch.int32)
        bsel = (cum <= k[:, None]).sum(1, dtype=torch.int32).clamp(max=_NB - 1)
        cum_excl = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)
        k = (k - torch.gather(cum_excl, 1, bsel[:, None].long())[:, 0]).clamp(min=0)
        B = B + (bsel << s)
    cnt, mx = less(bits, ci, B)
    lower = (counts % 2 == 0) & (cnt == counts.to(torch.int32) // 2) & (counts > 0)
    return torch.where(lower, mx, B).view(torch.float32), B.view(torch.float32)
