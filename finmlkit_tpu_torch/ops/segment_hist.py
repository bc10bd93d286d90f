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
(H2) with one pass over fixed tiles of 4096 trades, whatever the bars: a
block finds its tile's close indices, each thread counts 16 consecutive
trades bar by bar in registers, the pieces of a bar that spans threads are
summed across the warp and joined to the output by atomics, and a bar inside
one thread is stored whole (:func:`hist_pass_tiles` and
:func:`less_pass_tiles` model it on the CPU). So the TPU's row tails, flag
and scatter planes, in-kernel base fill and XLA boundary fixups
(``_hist_fix``, ``_less_fix``, ``bar_hist``) do not cross, nor does the
log-shift prefix over the 16 buckets (``torch.cumsum`` here).

Precondition: the amounts are nonnegative (their float32 bits then order as
the values do). Empty bars get garbage brackets, which callers mask.
"""
import numpy as np
import torch

from .. import _build
from ..utils import trace

__all__ = ["segment_median_pair_hist", "hist_pass", "hist_pass_plain",
           "hist_pass_tiles", "less_pass", "less_pass_plain", "less_pass_tiles",
           "SHIFTS"]

# kernel H's launches by hist_pass and less_pass: launch.H in the trace registry

SHIFTS = (28, 24, 20, 16, 12, 8, 4, 0)
_NB = 16
_I32MIN = -2147483648
_ITEMS, _THREADS = 16, 256   # kernel H's trades a thread and threads a tile
_TILE = _ITEMS * _THREADS
_WARP = 32


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


def _tiles_model(bits, ci, key, add, empty, items, threads):
    """Kernel H's pass over fixed tiles, in numpy: tiles of ``items *
    threads`` trades, ``items`` consecutive trades a thread, warps of 32
    threads. A thread walks its trades bar by bar (bar k: ``(ci[k],
    ci[k+1]]``, the key ``key[k]``) with ``add(acc, x, key)``; a bar that
    opens and closes inside it is stored, its first piece (head) and a last
    piece that runs on (tail) are partial; a tail joins the next thread's
    head, or the output where it leaves the warp; the heads of a warp are
    summed by bar. Joins add, and take the max of the field ``"m"``."""
    bits, ci, key = (t.cpu().numpy() for t in (bits, ci, key))
    n, nb = len(bits), len(ci) - 1
    out = [empty() for _ in range(nb)]

    def join(b, acc):
        for f, v in acc.items():
            out[b][f] = max(out[b][f], v) if f == "m" else out[b][f] + v

    def plus(a, b):
        return {f: max(a[f], b[f]) if f == "m" else a[f] + b[f] for f in a}

    def close(j):                        # ci[j]; none past the last bar
        return int(ci[j]) if j <= nb else np.iinfo(np.int64).max

    tile = items * threads
    for tile0 in range(0, n, tile):
        lo = int(np.searchsorted(ci, tile0 - 1, "right"))   # closes before
        heads, tails = [], []
        for r in range(threads):
            i0 = tile0 + r * items
            iend = min(i0 + items, n)
            if i0 >= n:
                heads.append((nb + 1, empty()))
                tails.append(None)
                continue
            b = lo + int(np.searchsorted(ci[lo:], i0, "left")) - 1
            hb, cur, head, tail = b, empty(), None, None
            for i in range(i0, iend):
                while i > close(b + 1):
                    if head is None:
                        head = cur
                    elif b < nb:
                        out[b] = cur     # it opened and closed in this thread
                    cur, b = empty(), b + 1
                if 0 <= b < nb:
                    add(cur, int(bits[i]), int(key[b]))
            if head is None:
                head = cur
            elif close(b + 1) >= iend:
                tail = (b, cur) if b < nb else None
            elif b < nb:
                out[b] = cur
            heads.append((hb, head))
            tails.append(tail)
        for w0 in range(0, threads, _WARP):
            hs = heads[w0:w0 + _WARP]
            for r in range(_WARP):
                t = tails[w0 + r]
                if t is not None and r == _WARP - 1:
                    join(*t)
                elif t is not None:
                    hs[r + 1] = (hs[r + 1][0], plus(t[1], hs[r + 1][1]))
            for r, (hb, acc) in enumerate(hs):
                last = r == _WARP - 1 or hs[r + 1][0] != hb
                if 0 <= hb < nb:
                    if r > 0 and hs[r - 1][0] == hb:
                        acc = plus(hs[r - 1][1], acc)
                        hs[r] = (hb, acc)
                    if last:
                        join(hb, acc)
    return out


def hist_pass_tiles(bits, ci, base, s: int, *, items: int = _ITEMS,
                    threads: int = _THREADS) -> torch.Tensor:
    """Kernel H's histogram pass over fixed tiles, modelled on the CPU at any
    tile (``items`` trades a thread, ``threads`` a tile, a multiple of 32);
    for the tests. Equals :func:`hist_pass_plain` bit for bit."""
    def add(acc, x, key):
        f = ((x - key + 2**31) % 2**32 - 2**31) >> s     # int32 arithmetic
        # the kernel's one bit in its two words of 4-bit fields: f read as
        # uint32 and clamped to 16, a shift of 4f into the low word and of
        # 4f - 32 (uint32) into the high one; a shift of 32 or more gives 0
        sh = 4 * min(f % 2**32, _NB)
        for word, shift in ((0, sh), (1, (sh - 32) % 2**32)):
            if shift < 32:
                acc[8 * word + shift // 4] += 1
    rows = _tiles_model(bits, ci, base, add, lambda: dict.fromkeys(range(_NB), 0),
                        items, threads)
    return torch.tensor([[r[f] for f in range(_NB)] for r in rows],
                        dtype=torch.int32).view(len(rows), _NB)


def less_pass_tiles(bits, ci, v, *, items: int = _ITEMS, threads: int = _THREADS):
    """Kernel H's less pass over fixed tiles, modelled on the CPU as
    :func:`hist_pass_tiles`. Equals :func:`less_pass_plain` bit for bit."""
    def add(acc, x, key):
        if x < key:
            acc["c"] += 1
            acc["m"] = max(acc["m"], x)
    rows = _tiles_model(bits, ci, v, add, lambda: {"c": 0, "m": _I32MIN},
                        items, threads)
    return (torch.tensor([r["c"] for r in rows], dtype=torch.int32),
            torch.tensor([r["m"] for r in rows], dtype=torch.int32))


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


def _tile_lo(bits):
    """Kernel H's scratch: each tile's first close index, and one past."""
    return torch.empty(-(-bits.shape[0] // _TILE) + 1, dtype=torch.int64,
                       device=bits.device)


def _launch_hist(bits, ci, base, s: int) -> torch.Tensor:
    """Kernel H's histogram pass on contiguous CUDA tensors and a checked
    ``ci``."""
    nb = ci.shape[0] - 1
    base = base.contiguous()
    out = torch.empty((nb, _NB), dtype=torch.int32, device=bits.device)
    tile_lo = _tile_lo(bits)
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream(bits.device).cuda_stream
        rc = _build.library().fmk_hist_pass(bits.data_ptr(), ci.data_ptr(),
                                            base.data_ptr(), int(s),
                                            bits.shape[0], nb, out.data_ptr(),
                                            tile_lo.data_ptr(), stream)
    trace.count("launch.H")
    _build.check(rc, "hist_pass")
    return out


def _launch_less(bits, ci, v):
    """Kernel H's less pass on contiguous CUDA tensors and a checked ``ci``."""
    nb = ci.shape[0] - 1
    v = v.contiguous()
    cnt = torch.empty(nb, dtype=torch.int32, device=bits.device)
    mx = torch.empty(nb, dtype=torch.int32, device=bits.device)
    tile_lo = _tile_lo(bits)
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream(bits.device).cuda_stream
        rc = _build.library().fmk_less_pass(bits.data_ptr(), ci.data_ptr(),
                                            v.data_ptr(), bits.shape[0], nb,
                                            cnt.data_ptr(), mx.data_ptr(),
                                            tile_lo.data_ptr(), stream)
    trace.count("launch.H")
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
