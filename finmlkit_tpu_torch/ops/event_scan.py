"""Event-jump boundary scans of the information-driven bars: kernel E
(``csrc/event_scan.cu``).

The JAX package runs these scans as XLA ``while_loop``s in
``finmlkit_tpu/bar/indexers.py`` (``_volume_boundaries``,
``_cusum_boundaries``, ``_info_bar_boundaries``). They are not TPU kernels,
but PyTorch has no loop that stays on the device: a loop in Python reads the
card once per chunk and once per bar. Kernel E runs each scan in one call
and the host reads the number of bars once. It cuts the stream into chunks of
whole 2048-trade tiles, walks them all at once from guessed states, walks
each again from its predecessor's end state until the two walks meet, and
walks serially only what never meets (``csrc/event_scan.cu``);
:func:`_chunked_scan_model` is that scheme on the CPU, for the tests.

Each scan has a plain PyTorch version beside it: the chunked closed forms of
the JAX code, driven by a host loop, on any device. They are the CPU path and
the reference the kernel is held against on the card.

Every scan returns the close indices it found, at most ``max_bars`` of them,
as an int64 tensor on the input's device; the indexers grow ``max_bars`` and
run again when a scan fills it.
"""
import struct

import numpy as np
import torch

from .. import _build
from . import prefix_scan

__all__ = ["cusum_scan", "cusum_scan_plain", "info_scan", "info_scan_plain",
           "volume_scan", "volume_scan_plain"]

LAUNCHES = 0  # kernel E launches in this process
MODE_LAUNCHES = [0, 0, 0, 0]  # of them by mode: CUSUM, imbalance, run, volume

_CUSUM, _IMBALANCE, _RUN, _VOLUME = 0, 1, 2, 3
_CUSUM_CHUNK = 8192        # the JAX scans' chunk sizes and in-chunk event
_CUSUM_EVENTS_PER_CHUNK = 4  # extractions (indexers.py:504-505, 677)
_INFO_CHUNK = 2048
_TILE = 2048           # kernel E's tile (csrc/event_scan.cu kTile)


def _check(t: torch.Tensor, dtype, name: str, like: torch.Tensor) -> None:
    if t.dim() != 1 or t.dtype != dtype:
        raise TypeError(f"{name} must be a 1-D {dtype} tensor, got {t.dtype} "
                        f"of shape {tuple(t.shape)}")
    if t.shape != like.shape or t.device != like.device:
        raise ValueError(f"{name} must match the stream's length and device")


def _default_chunks(mode: int, device) -> int:
    """Kernel E's chunks for a scan, from the chunk sweep on the month in
    ``PERF.md``: CUSUM walks meet within a few bars (both sides clamp to 0),
    so 4 chunks per streaming multiprocessor; volume walks meet where one
    large trade closes both, so a chunk per 4 multiprocessors; imbalance and
    run walks, one chunk: the sequential walk. Tick imbalance walks never
    met there (their sums keep their offset modulo theta) and ran slower
    chunked, and walks whose EMA thresholds move never meet bit for bit."""
    if mode in (_IMBALANCE, _RUN):
        return 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 4 * sms if mode == _CUSUM else max(sms // 4, 1)


def _launch(mode: int, n: int, start: int, max_bars: int, device, *, x=None,
            lam=None, can_close=None, units=None, e_t=0.0, e_r=0.0,
            alpha_t=0.0, alpha_r=0.0, thr=0, chunks=None,
            stats=None) -> torch.Tensor:
    """Launch kernel E over trades ``start .. n-1`` and return its closes.

    ``chunks`` is the number of chunks the stream is cut into (default
    :func:`_default_chunks`; 1 is the sequential walk); the closes do not
    depend on it. ``stats``, a zeroed int64 tensor of 4 on the device, receives
    the 256-trade segments the walks skipped and scanned, the pass-2 chunks
    that did not merge and the chunks the fix-up walked again.
    """
    global LAUNCHES
    out = torch.empty(max(max_bars, 1), dtype=torch.int64, device=device)
    if start >= n or max_bars <= 0:
        return out[:0]
    if device.type != "cuda":
        raise ValueError(f"kernel E runs on cuda, not {device}")
    if chunks is None:
        chunks = _default_chunks(mode, device)
    if chunks < 1:
        raise ValueError(f"kernel E takes at least one chunk, got {chunks}")
    if stats is not None and (stats.shape != (4,) or stats.dtype != torch.int64
                              or stats.device != out.device):
        raise ValueError("stats must be an int64 tensor of 4 on the stream's device")
    count = torch.empty(1, dtype=torch.int64, device=device)
    ins = [None if t is None else t.contiguous() for t in (x, lam, can_close, units)]
    ptrs = [None if t is None else t.data_ptr() for t in ins]
    lib = _build.library()
    scratch = torch.empty(lib.fmk_event_scratch_bytes(mode, n, start, chunks),
                          dtype=torch.uint8, device=device)
    LAUNCHES += 1
    MODE_LAUNCHES[mode] += 1
    prefix_scan.LAUNCHES += 1   # E compacts its closes with one launch of S
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fmk_event_scan(mode, *ptrs, n, start, e_t, e_r, alpha_t,
                                alpha_r, thr, scratch.data_ptr(), chunks,
                                out.data_ptr(), max_bars, count.data_ptr(),
                                None if stats is None else stats.data_ptr(),
                                stream)
    _build.check(rc, "event scan")
    return out[:int(count)]


def _same(a, b) -> bool:
    """Bitwise equality of two walk states (tuples of floats and ints)."""
    bits = [struct.pack("<d", v) if isinstance(v, float) else v for v in a]
    return bits == [struct.pack("<d", v) if isinstance(v, float) else v for v in b]


def _tile_walker(mode, x, lam, can_close, units, e_t, e_r, alpha_t, alpha_r, thr):
    """The plain sequential walk over trades lo .. hi-1 from a state, in numpy:
    ``(init, reset, step)``, ``step(lo, hi, state) -> (closes, state)``."""
    if mode == _VOLUME:
        u = units.numpy()

        def step(lo, hi, carry):
            closes = []
            while lo < hi:
                c = carry[0] + np.cumsum(u[lo:hi])
                ev = c >= thr
                if not ev.any():
                    return closes, (int(c[-1]),)
                e = int(np.argmax(ev))
                closes.append(lo + e)
                carry, lo = (0,), lo + e + 1
            return closes, carry
        return (lambda: (int(u[0]),)), (lambda g: (0,)), step
    if mode == _CUSUM:
        r, lm, cc = x.numpy(), lam.numpy(), can_close.numpy()

        def step(lo, hi, st):
            sp, sn = st
            closes = []
            while lo < hi:
                d = np.cumsum(r[lo:hi])
                s_pos = np.maximum(sp + d, d - np.minimum.accumulate(d))
                s_neg = np.minimum(sn + d, d - np.maximum.accumulate(d))
                pos_hit = s_pos >= lm[lo:hi]
                ev = cc[lo:hi] & (pos_hit | (s_neg <= -lm[lo:hi]))
                if not ev.any():
                    return closes, (float(s_pos[-1]), float(s_neg[-1]))
                e = int(np.argmax(ev))
                closes.append(lo + e)
                sp, sn = (0.0, float(s_neg[e])) if pos_hit[e] else (float(s_pos[e]), 0.0)
                lo += e + 1
            return closes, (sp, sn)
        return (lambda: (0.0, 0.0)), (lambda g: (0.0, 0.0)), step
    w, run = x.numpy(), mode == _RUN

    def step(lo, hi, st):
        cb, cs, et, er, op = st
        closes = []
        while lo < hi:
            r = w[lo:hi]
            if run:
                sb = cb + np.cumsum(np.where(r > 0, r, 0.0))
                ss = cs + np.cumsum(np.where(r < 0, -r, 0.0))
                stat = np.maximum(sb, ss)
            else:
                sb = cb + np.cumsum(r)
                ss, stat = None, np.abs(sb)
            ev = stat >= et * er
            if not ev.any():
                return closes, (float(sb[-1]), float(ss[-1]) if run else 0.0, et, er, op)
            e = int(np.argmax(ev))
            g = lo + e
            t_bar = float(g - op)
            rate = float(stat[e]) / max(t_bar, 1.0)
            et = (1 - alpha_t) * et + alpha_t * t_bar
            er = (1 - alpha_r) * er + alpha_r * rate
            closes.append(g)
            cb, cs, op, lo = 0.0, 0.0, g, g + 1
        return closes, (cb, cs, et, er, op)
    return ((lambda: (0.0, 0.0, e_t, e_r, 0)),
            (lambda g: (0.0, 0.0, e_t, e_r, g - 1)), step)


def _chunked_scan_model(mode: int, n: int, start: int, max_bars: int,
                        chunks: int, *, x=None, lam=None, can_close=None,
                        units=None, e_t=0.0, e_r=0.0, alpha_t=0.0, alpha_r=0.0,
                        thr=0):
    """Kernel E's chunked walk on the CPU, for the tests: the arguments of
    :func:`_launch` (CPU tensors), over the plain sequential walk in numpy.

    Trades ``start .. n-1`` are cut into tiles of 2048 and ``chunks`` chunks of
    whole tiles. Pass 1 walks every chunk from the mode's initial (chunk 0) or
    reset state, recording each tile's closes and end state; pass 2 walks each
    chunk c > 0 from chunk c-1's pass-1 end state until a tile end where its
    state equals the recorded one bit for bit; the fix-up walks, in order,
    each chunk whose last walk began elsewhere than at its predecessor's final
    end state, with the same stop rule. Returns the first ``max_bars`` closes
    and ``{"tiles", "chunks", "unmerged", "fixed"}``: the pass-2 chunks that
    did not merge and the chunks fixed up. The walker's float sums start at
    each tile, so on data whose sums round the closes may differ from the
    plain scans' at near ties; on data whose sums are exact they may not.
    """
    init, reset, step = _tile_walker(mode, x, lam, can_close, units, e_t, e_r,
                                     alpha_t, alpha_r, thr)
    tiles = max(-(-(n - start) // _TILE), 0)
    per = max(-(-tiles // chunks), 1)
    n_chunks = -(-tiles // per)
    closes, states, used = [None] * tiles, [None] * tiles, [None] * n_chunks

    def walk(c, s, merge):
        for t in range(c * per, min((c + 1) * per, tiles)):
            lo = start + t * _TILE
            closes[t], s = step(lo, min(lo + _TILE, n), s)
            if merge and _same(s, states[t]):
                return True
            states[t] = s
        return False

    def last(c):
        return min((c + 1) * per, tiles) - 1

    for c in range(n_chunks):                   # pass 1
        used[c] = init() if c == 0 else reset(start + c * per * _TILE)
        walk(c, used[c], False)
    end1 = [states[last(c)] for c in range(n_chunks)]
    unmerged = 0
    for c in range(1, n_chunks):                # pass 2, one parallel round
        used[c] = end1[c - 1]
        unmerged += not walk(c, used[c], True)
    fixed = 0
    for c in range(1, n_chunks):                # the serial fix-up
        if not _same(states[last(c - 1)], used[c]):
            used[c] = states[last(c - 1)]
            walk(c, used[c], True)
            fixed += 1
    out = [g for t in range(tiles) for g in closes[t]][:max(max_bars, 0)]
    return (torch.tensor(out, dtype=torch.int64),
            {"tiles": tiles, "chunks": n_chunks, "unmerged": unmerged,
             "fixed": fixed})


# ---------------------------------------------------------------------------
# CUSUM bars
# ---------------------------------------------------------------------------

def cusum_scan_plain(rets, lam, can_close, start: int, max_bars: int):
    """Plain PyTorch version of :func:`cusum_scan`: ``_cusum_boundaries``
    (``indexers.py:508-597``) with a host loop. Each chunk of 8192 trades is
    solved in closed form, ``s+ = max(s0 + D, D - running min of D)`` and
    ``s- = min(s0 + D, D - running max of D)`` over the prefix ``D`` from the
    last event; up to four events are taken per chunk before it moves on."""
    n, dev = rets.shape[0], rets.device
    zero = torch.zeros((), dtype=rets.dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=rets.dtype, device=dev)
    sp, sn = zero, zero
    out, pos = [], start + 1
    while pos < n and len(out) < max_bars:
        r = rets[pos:pos + _CUSUM_CHUNK]
        lm = lam[pos:pos + _CUSUM_CHUNK]
        cc = can_close[pos:pos + _CUSUM_CHUNK]
        m = r.shape[0]
        iota = torch.arange(m, device=dev)
        big = torch.cumsum(r, 0)
        last_e, found = -1, False
        for _ in range(_CUSUM_EVENTS_PER_CHUNK):
            mask = iota > last_e
            base = big[last_e] if last_e >= 0 else zero
            d = big - base
            runmin = torch.cummin(torch.where(mask, big, inf), 0).values - base
            runmax = torch.cummax(torch.where(mask, big, -inf), 0).values - base
            s_pos = torch.maximum(sp + d, d - runmin)
            s_neg = torch.minimum(sn + d, d - runmax)
            pos_hit = s_pos >= lm
            ev = mask & cc & (pos_hit | (s_neg <= -lm))
            first = torch.argmax(ev.to(torch.uint8))
            found, e = torch.stack([ev[first].to(torch.int64), first]).tolist()
            found = bool(found) and len(out) < max_bars
            if not found:
                break
            out.append(pos + e)
            trig = pos_hit[e]
            sp = torch.where(trig, zero, s_pos[e])
            sn = torch.where(trig, s_neg[e], zero)
            last_e = e
        if found:   # the last extraction found an event: re-enter after it
            pos += last_e + 1
        else:       # the chunk is done: its last state is the carry
            sp, sn = s_pos[m - 1], s_neg[m - 1]
            pos += _CUSUM_CHUNK
    return torch.tensor(out, dtype=torch.int64, device=dev)


def cusum_scan(rets, lam, can_close, start: int, max_bars: int):
    """Close indices of the CUSUM bars (at most ``max_bars``): from trade
    ``start + 1`` on, ``s+ = max(0, s+ + rets[i])`` and ``s- = min(0, s- +
    rets[i])``; trade i closes a bar when ``can_close[i]`` and ``s+ >=
    lam[i]`` (then s+ resets) or else ``s- <= -lam[i]`` (then s- resets).

    ``rets`` and ``lam`` are float64, ``can_close`` bool. On a CUDA tensor
    this launches kernel E; on a CPU tensor it runs :func:`cusum_scan_plain`.
    The kernel's in-tile sums round otherwise than the plain version's, so
    a close where a statistic ties ``lam`` to about 1e-12 may move.
    """
    _check(rets, torch.float64, "rets", rets)
    _check(lam, torch.float64, "lam", rets)
    _check(can_close, torch.bool, "can_close", rets)
    if rets.device.type == "cpu":
        return cusum_scan_plain(rets, lam, can_close, start, max_bars)
    return _launch(_CUSUM, rets.shape[0], start + 1, max_bars, rets.device,
                   x=rets, lam=lam, can_close=can_close)


# ---------------------------------------------------------------------------
# Imbalance and run bars
# ---------------------------------------------------------------------------

def info_scan_plain(w, e_ticks0: float, e_rate0: float, alpha_t: float,
                    alpha_r: float, max_bars: int, run_mode: bool):
    """Plain PyTorch version of :func:`info_scan`: ``_info_bar_boundaries``
    (``indexers.py:680-753``) with a host loop, one chunk of 2048 trades or
    one event per step; the expectations update in float64 on the host."""
    n, dev = w.shape[0], w.device
    zero = torch.zeros((), dtype=w.dtype, device=dev)
    cb = cs = zero
    e_t, e_r = float(e_ticks0), float(e_rate0)
    out, pos, open_pos = [], 1, 0
    while pos < n and len(out) < max_bars:
        r = w[pos:pos + _INFO_CHUNK]
        if run_mode:
            sb = cb + torch.cumsum(torch.where(r > 0, r, zero), 0)
            ss = cs + torch.cumsum(torch.where(r < 0, -r, zero), 0)
            stat = torch.maximum(sb, ss)
        else:
            sb = cb + torch.cumsum(r, 0)
            stat = torch.abs(sb)
        ev = stat >= e_t * e_r
        first = torch.argmax(ev.to(torch.uint8))
        has, e, st = torch.stack([ev[first].to(w.dtype), first.to(w.dtype),
                                  stat[first]]).tolist()
        if has:
            e = int(e)
            t_bar = float(pos + e - open_pos)
            rate = st / max(t_bar, 1.0)
            e_t = (1 - alpha_t) * e_t + alpha_t * t_bar
            e_r = (1 - alpha_r) * e_r + alpha_r * rate
            out.append(pos + e)
            cb = cs = zero
            open_pos = pos + e
            pos += e + 1
        else:
            cb = sb[-1]
            if run_mode:
                cs = ss[-1]
            pos += _INFO_CHUNK
    return torch.tensor(out, dtype=torch.int64, device=dev)


def info_scan(w, e_ticks0: float, e_rate0: float, alpha_t: float,
              alpha_r: float, max_bars: int, run_mode: bool):
    """Close indices of the imbalance bars (``run_mode=False``: ``|in-bar sum
    of w|``) or run bars (``max(in-bar sum of the positive w, in-bar sum of
    the negative |w|)``), at most ``max_bars``. Trade 0 opens the first bar
    and checks start at trade 1; a bar closes where its statistic reaches
    ``theta = E[T] * E[rate]``, and at each close ``E[T] <- (1 - alpha_t)
    E[T] + alpha_t T`` and ``E[rate] <- (1 - alpha_r) E[rate] + alpha_r
    stat / max(T, 1)``, T the bar's length.

    ``w`` is float64. On a CUDA tensor this launches kernel E; on a CPU
    tensor it runs :func:`info_scan_plain`.
    """
    _check(w, torch.float64, "w", w)
    if w.device.type == "cpu":
        return info_scan_plain(w, e_ticks0, e_rate0, alpha_t, alpha_r,
                               max_bars, run_mode)
    return _launch(_RUN if run_mode else _IMBALANCE, w.shape[0], 1, max_bars,
                   w.device, x=w, e_t=float(e_ticks0), e_r=float(e_rate0),
                   alpha_t=float(alpha_t), alpha_r=float(alpha_r))


# ---------------------------------------------------------------------------
# Volume bars
# ---------------------------------------------------------------------------

def volume_scan_plain(units, thr: int, max_bars: int):
    """Plain PyTorch version of :func:`volume_scan`: ``_volume_boundaries``
    (``indexers.py:368-404``) with a host loop, one ``searchsorted`` jump
    over the int64 prefix of the units per bar."""
    n, dev = units.shape[0], units.device
    c = torch.cumsum(units, 0)
    out, pos, base = [], 0, 0
    while pos < n and len(out) < max_bars:
        at = torch.searchsorted(c, torch.tensor([base + thr], device=dev))[0]
        nxt = torch.clamp(at, min=pos + 1)
        nxt, val = torch.stack([nxt, c[nxt.clamp(max=n - 1)]]).tolist()
        if nxt > n - 1:
            break
        out.append(nxt)
        pos, base = nxt, val
    return torch.tensor(out, dtype=torch.int64, device=dev)


def volume_scan(units, thr: int, max_bars: int):
    """Close indices of the volume bars (at most ``max_bars``): the in-bar sum
    of the int64 ``units`` starts with trade 0's, checks start at trade 1, a
    bar closes at the first trade where the sum reaches the integer ``thr``,
    and the sum resets to zero (the overshoot is dropped).

    On a CUDA tensor this launches kernel E; on a CPU tensor it runs
    :func:`volume_scan_plain`.
    """
    _check(units, torch.int64, "units", units)
    if units.device.type == "cpu":
        return volume_scan_plain(units, thr, max_bars)
    return _launch(_VOLUME, units.shape[0], 1, max_bars, units.device,
                   units=units, thr=int(thr))
