"""Event-jump boundary scans of the information-driven bars: kernel E
(``csrc/event_scan.cu``).

The JAX package runs these scans as XLA ``while_loop``s in
``finmlkit_tpu/bar/indexers.py`` (``_volume_boundaries``,
``_cusum_boundaries``, ``_info_bar_boundaries``). They are not TPU kernels,
but PyTorch has no loop that stays on the device: a loop in Python reads the
card once per chunk and once per bar. Kernel E runs each scan in one launch
and the host reads the number of bars once.

Each scan has a plain PyTorch version beside it: the chunked closed forms of
the JAX code, driven by a host loop, on any device. They are the CPU path and
the reference the kernel is held against on the card.

Every scan returns the close indices it found, at most ``max_bars`` of them,
as an int64 tensor on the input's device; the indexers grow ``max_bars`` and
run again when a scan fills it.
"""
import torch

from .. import _build

__all__ = ["cusum_scan", "cusum_scan_plain", "info_scan", "info_scan_plain",
           "volume_scan", "volume_scan_plain"]

LAUNCHES = 0  # kernel E launches in this process

_CUSUM, _IMBALANCE, _RUN, _VOLUME = 0, 1, 2, 3
_CUSUM_CHUNK = 8192        # the JAX scans' chunk sizes and in-chunk event
_CUSUM_EVENTS_PER_CHUNK = 4  # extractions (indexers.py:504-505, 677)
_INFO_CHUNK = 2048


def _check(t: torch.Tensor, dtype, name: str, like: torch.Tensor) -> None:
    if t.dim() != 1 or t.dtype != dtype:
        raise TypeError(f"{name} must be a 1-D {dtype} tensor, got {t.dtype} "
                        f"of shape {tuple(t.shape)}")
    if t.shape != like.shape or t.device != like.device:
        raise ValueError(f"{name} must match the stream's length and device")


def _launch(mode: int, n: int, start: int, max_bars: int, device, *, x=None,
            lam=None, can_close=None, units=None, e_t=0.0, e_r=0.0,
            alpha_t=0.0, alpha_r=0.0, thr=0) -> torch.Tensor:
    """Launch kernel E over trades ``start .. n-1`` and return its closes."""
    global LAUNCHES
    out = torch.empty(max(max_bars, 1), dtype=torch.int64, device=device)
    if start >= n or max_bars <= 0:
        return out[:0]
    if device.type != "cuda":
        raise ValueError(f"kernel E runs on cuda, not {device}")
    count = torch.zeros(1, dtype=torch.int64, device=device)
    ins = [None if t is None else t.contiguous() for t in (x, lam, can_close, units)]
    ptrs = [None if t is None else t.data_ptr() for t in ins]
    lib = _build.library()
    LAUNCHES += 1
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fmk_event_scan(mode, *ptrs, n, start, e_t, e_r, alpha_t,
                                alpha_r, thr, out.data_ptr(), max_bars,
                                count.data_ptr(), stream)
    _build.check(rc, "event scan")
    return out[:int(count)]


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
