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
Imbalance bars at a fixed threshold on integer weights (tick imbalance among
them) take another path of the kernel: the in-bar sum then has few states, so
each tile's effect is a map of states and the maps compose as a parallel scan
(:func:`_map_scan_model` on the CPU). Run bars on weights of -1, 0 and +1
(tick run bars) take a third: the in-bar sums are then counts, so each close
is a search in bit-packed prefix counts, not a walk over every trade
(:func:`_run_count_model` on the CPU).

Each scan has a plain PyTorch version beside it: the chunked closed forms of
the JAX code, driven by a host loop, on any device. They are the CPU path and
the reference the kernel is held against on the card.

Every scan returns the close indices it found, at most ``max_bars`` of them,
as an int64 tensor on the input's device; the indexers grow ``max_bars`` and
run again when a scan fills it.

Entry and exit states. Every scan, kernel and plain, takes the state the
stream enters with (``state=``) and can return the state after its last trade
(``exit_state=True``: a pair ``(closes, state)``), so that the time shards of
one stream scan in turn, each from the state the one before it left
(``parallel/sharded_indexers.py``). The states are host values: CUSUM
``(s+, s-)``; volume the carried units (an int); imbalance and run ``(cb, cs,
E[T], E[rate], open)``, the in-bar sums, the expectations and the trade the
open bar opened at, relative to the stream (a negative index opens it in an
earlier shard; the JAX ring carries it absolute and subtracts the shard's
offset, ``sharded_indexers.py:436-442``). The CUSUM scan's ``start=-1`` and the
others' ``first_closes=True`` let trade 0 close, as the JAX ring's
``pos_init=-1`` does on every shard after the first. With no entry state the
closes are those of the whole-stream scans. An exit state is that of the
stream's end only where fewer than ``max_bars`` closes were found.
"""
import ctypes
import math
import struct

import numpy as np
import torch

from .. import _build
from ..utils import trace

__all__ = ["cusum_scan", "cusum_scan_plain", "info_scan", "info_scan_plain",
           "volume_scan", "volume_scan_plain"]

_CUSUM, _IMBALANCE, _RUN, _VOLUME, _IMBALANCE_MAP, _RUN_COUNT = 0, 1, 2, 3, 4, 5
# kernel E's launches in the trace registry (utils/trace.py): launch.E, and
# by mode launch.E.<MODE_NAMES[mode]>; each also counts one launch.S (E
# compacts its closes with one launch of kernel S; the count search scans its
# blocks' counts with it)
MODE_NAMES = ("cusum", "imbalance", "run", "volume", "imbalance_map", "run_count")
_MAP_STATES = 127      # the most in-bar states of the map path (kMapStates)
_MAP_GROUP = 128       # tiles a block of its scan composes (kGroup)
_CUSUM_CHUNK = 8192        # the JAX scans' chunk sizes and in-chunk event
_CUSUM_EVENTS_PER_CHUNK = 4  # extractions (indexers.py:504-505, 677)
_INFO_CHUNK = 2048
_TILE = 2048           # kernel E's tile (csrc/event_scan.cu kTile)
_COUNT_CHUNK = 4096    # table entries a chunk of the count search's rings holds (kChunk)
_COUNT_CHUNKS = 2      # chunks a ring holds
_WHOLE = 2.0 ** 52     # the largest entry sum the count search takes


def mode_launches() -> list:
    """Kernel E's launches so far by mode, in the order of ``MODE_NAMES``."""
    return [trace.counter("launch.E." + m) for m in MODE_NAMES]


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
    if mode in (_IMBALANCE, _RUN, _IMBALANCE_MAP, _RUN_COUNT):
        return 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 4 * sms if mode == _CUSUM else max(sms // 4, 1)


# each mode's state as the kernel's State: 8-byte words, d a double, q an int64
_LAYOUT = {_CUSUM: "dd", _IMBALANCE: "ddddq", _RUN: "ddddq", _VOLUME: "q",
           _IMBALANCE_MAP: "ddddq", _RUN_COUNT: "ddddq"}


def _initial(mode: int, e_t: float = 0.0, e_r: float = 0.0) -> tuple:
    """The state a stream enters with by default."""
    if mode == _CUSUM:
        return 0.0, 0.0
    if mode == _VOLUME:
        return (0,)
    return 0.0, 0.0, float(e_t), float(e_r), 0


def _words(mode: int, state) -> tuple:
    fmt = _LAYOUT[mode]
    return struct.unpack(f"<{len(fmt)}q", struct.pack(f"<{fmt}", *state))


def _unwords(mode: int, words) -> tuple:
    fmt = _LAYOUT[mode]
    return struct.unpack(f"<{fmt}", struct.pack(f"<{len(fmt)}q", *words[:len(fmt)]))


def _launch(mode: int, n: int, start: int, max_bars: int, device, *, x=None,
            lam=None, can_close=None, units=None, e_t=0.0, e_r=0.0,
            alpha_t=0.0, alpha_r=0.0, thr=0, chunks=None,
            stats=None, entry=None, exit_state=False):
    """Launch kernel E over trades ``start .. n-1`` and return its closes.

    ``chunks`` is the number of chunks the stream is cut into (default
    :func:`_default_chunks`; 1 is the sequential walk); the closes do not
    depend on it. ``stats``, a zeroed int64 tensor of 4 on the device, receives
    the 256-trade segments the walks skipped and scanned, the pass-2 chunks
    that did not merge and the chunks the fix-up walked again. The map path
    (``_IMBALANCE_MAP``, on weights :func:`_map_states` admits) has no chunks
    and leaves the stats at 0. The count search (``_RUN_COUNT``) has no
    chunks either; its stats are the table chunks its rings requested, the
    entries it read past them, its closes at the trade after the last, and
    the walker's nanoseconds.

    ``entry`` is the state entering trade ``start`` as a tuple in the mode's
    layout (:data:`_LAYOUT`; default :func:`_initial`); volume bars that start
    at trade 1 add trade 0's units to its carry. With ``exit_state`` the
    return is ``(closes, state after trade n-1)``, read with the count. The
    count search returns None where a weight is not -1, 0 or +1 (the kernel
    then writes a count of -1 and nothing else).
    """
    entry = _initial(mode, e_t, e_r) if entry is None else tuple(entry)
    out = torch.empty(max(max_bars, 1), dtype=torch.int64, device=device)
    if start >= n or (max_bars <= 0 and not exit_state):
        if not exit_state:
            return out[:0]
        if mode == _VOLUME and start == 1 and n >= 1:
            entry = (entry[0] + trace.host_read(int, units[0]),)
        return out[:0], entry
    if device.type != "cuda":
        raise ValueError(f"kernel E runs on cuda, not {device}")
    if chunks is None:
        chunks = _default_chunks(mode, device)
    if chunks < 1:
        raise ValueError(f"kernel E takes at least one chunk, got {chunks}")
    if stats is not None and (stats.shape != (4,) or stats.dtype != torch.int64
                              or stats.device != out.device):
        raise ValueError("stats must be an int64 tensor of 4 on the stream's device")
    io = torch.empty(6, dtype=torch.int64, device=device)   # the count, the exit state
    words = (ctypes.c_longlong * 5)(*_words(mode, entry))
    ins = [None if t is None else t.contiguous() for t in (x, lam, can_close, units)]
    ptrs = [None if t is None else t.data_ptr() for t in ins]
    lib = _build.library()
    scratch = torch.empty(lib.fmk_event_scratch_bytes(mode, n, start, chunks),
                          dtype=torch.uint8, device=device)
    trace.count("launch.E")
    trace.count("launch.E." + MODE_NAMES[mode])
    trace.count("launch.S")     # E compacts its closes with one launch of S
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fmk_event_scan(mode, *ptrs, n, start, e_t, e_r, alpha_t,
                                alpha_r, thr, words, scratch.data_ptr(), chunks,
                                out.data_ptr(), max(max_bars, 1), io.data_ptr(),
                                None if stats is None else stats.data_ptr(),
                                io.data_ptr() + 8 if exit_state else None, stream)
    _build.check(rc, "event scan")
    got = (trace.host_read(torch.Tensor.tolist, io) if exit_state
           else [trace.host_read(int, io[0])])
    if got[0] < 0:
        return None
    if not exit_state:
        return out[:got[0]]
    return out[:min(got[0], max(max_bars, 0))], _unwords(mode, got[1:])


def _map_k(e_t: float, e_r: float):
    """K of the map path for the threshold ``e_t * e_r`` (float64, as the walk
    rounds it): the largest integer below it, or None where it is not finite
    and positive or its ``2K + 1`` states exceed ``_MAP_STATES``."""
    theta = float(e_t) * float(e_r)
    if not (math.isfinite(theta) and theta > 0):
        return None
    k = math.ceil(theta) - 1
    return k if 2 * k + 1 <= _MAP_STATES else None


def _map_states(w, e_t, e_r, alpha_t, alpha_r, integral: bool = False,
                entry_sum: float = 0.0):
    """K where the imbalance scan of ``w`` takes the map path, else None.

    The path needs both alphas 0 (theta never moves), :func:`_map_k`, an
    entry sum that is one of its states (an integer of at most K in
    magnitude), and every weight a finite integer (the in-bar sum then stays
    an integer of at most K in magnitude). ``integral=True`` says the caller
    knows that (the int8 sides of tick imbalance); otherwise the device is
    asked once (one read of a reduction over ``w``)."""
    if alpha_t != 0 or alpha_r != 0:
        return None
    k = _map_k(e_t, e_r)
    if k is None or not (abs(entry_sum) <= k and entry_sum == math.trunc(entry_sum)):
        return None
    if not integral:
        integral = trace.host_read(bool, torch.all(torch.isfinite(w) & (w == torch.trunc(w))))
    return k if integral else None


def _map_scan_model(n: int, start: int, max_bars: int, tile: int, *, x, e_t,
                    e_r, group: int = _MAP_GROUP, entry=None, exit_state=False):
    """Kernel E's map path on the CPU, for the tests: the arguments of
    :func:`_launch` (``x`` a CPU tensor of finite integer weights, alphas 0)
    at any tile size, in numpy.

    Trades ``start .. n-1`` are cut into tiles of ``tile``; weights clamp to
    ``[-(2K+1), 2K+1]`` and states are biased, ``u = s + K`` in ``[0, 2K]``,
    a trade closing where ``u + w`` leaves it (u then resets to K). Pass 1
    maps every entry state of every tile to its exit state; pass 2 composes
    the maps in groups of ``group`` tiles, follows the stream's empty bar
    (state K) through the groups' maps and then through each group's tiles
    for every tile's entry state; pass 3 walks each tile from it. Returns the
    first ``max_bars`` closes and ``{"states", "tiles", "groups"}``, and with
    ``exit_state`` the state after trade n-1. ``entry`` is the imbalance state
    entering trade ``start`` (:func:`_launch`), its sum one of the states."""
    cb0, cs0, et0, er0, open0 = _initial(_IMBALANCE, e_t, e_r) if entry is None else entry
    k = _map_k(e_t, e_r)
    m = 2 * k
    tiles = max(-(-(n - start) // tile), 0)
    groups = -(-tiles // group)
    w = np.zeros(tiles * tile, np.int64)
    w[:n - start] = np.clip(x.numpy()[start:n], -(m + 1), m + 1)
    w = w.reshape(tiles, tile)

    def step(u, wj):
        v = u + wj
        closes = (v < 0) | (v > m)
        return np.where(closes, k, v), closes

    maps = np.tile(np.arange(m + 1), (tiles, 1))          # pass 1
    for j in range(tile):
        maps = step(maps, w[:, j:j + 1])[0]
    gmaps = np.tile(np.arange(m + 1), (groups, 1))        # pass 2
    for g in range(groups):
        for t in range(g * group, min((g + 1) * group, tiles)):
            gmaps[g] = maps[t][gmaps[g]]
    gentry, u = np.zeros(groups, np.int64), k + int(cb0)
    for g in range(groups):
        gentry[g], u = u, gmaps[g][u]
    tentry = np.zeros(tiles, np.int64)
    for g in range(groups):
        u = gentry[g]
        for t in range(g * group, min((g + 1) * group, tiles)):
            tentry[t], u = u, maps[t][u]
    flags = np.zeros((tiles, tile), bool)                  # pass 3
    u = tentry
    for j in range(tile):
        u, flags[:, j] = step(u, w[:, j])
    every = start + np.flatnonzero(flags.ravel())
    out = (torch.from_numpy(every[:max(max_bars, 0)].astype(np.int64)),
           {"states": m + 1, "tiles": tiles, "groups": groups})
    if not exit_state:
        return out
    end = (float(u[-1] - k) if tiles else float(cb0), cs0, et0, er0,
           int(every[-1]) if every.size else open0)
    return out + (end,)


def _count_route(run_mode: bool, integral: bool, state, n: int) -> bool:
    """Whether a scan takes the count search (``_RUN_COUNT``): run bars
    whose caller knows the weights are integers (``integral=True``: the int8
    sides of tick run bars), whose entry sums ``cb`` and ``cs`` are whole
    numbers of at most 2^52 (every sum then stays exact), over fewer than
    2^31 trades. The kernel still checks that each weight is -1, 0 or +1,
    and :func:`info_scan` walks where one is not."""
    if not (run_mode and integral) or n >= 2 ** 31:
        return False
    return all(math.isfinite(v) and v == math.trunc(v) and abs(v) <= _WHOLE
               for v in map(float, state[:2]))


def _run_count_model(n: int, start: int, max_bars: int, *, x, e_t, e_r,
                     alpha_t=0.0, alpha_r=0.0, chunks: int = _COUNT_CHUNKS,
                     entry=None, exit_state=False):
    """Kernel E's count search on the CPU, for the tests: the arguments of
    :func:`_launch` (``x`` a CPU tensor), in numpy, with rings of ``chunks``
    chunks.

    The pack and the tables: the trades of ``start .. n-1`` whose weight is
    +1 (buys) and -1 (sells) in order; a weight that is not -1, 0 or +1
    returns None (the kernel's flag). The walker: from the last close c
    (``start - 1`` before the first) with the prefix counts B(c) and S(c),
    the next close is the nearer of the buy that brings B to B(c) +
    ceil(theta) - cb and the sell that brings S to S(c) + ceil(theta) - cs
    (cb, cs the entry sums, 0 after the first close; the statistic is then
    ceil(theta)), or c + 1 where one of those is met already. Each table's
    ring holds ``chunks`` chunks of 4096 entries from the one of its count at
    the last close; an entry past it is a miss. The EMA step is the walk's.
    Returns the first ``max_bars`` closes and ``{"requested", "misses",
    "next", "closes"}`` (the kernel's stats: the chunks the rings requested,
    and every close counted), and with ``exit_state`` the state after trade
    n-1."""
    cb0, cs0, e_t, e_r, op = _initial(_RUN, e_t, e_r) if entry is None else entry
    w = x.numpy()[:n]
    live = np.arange(n) >= start
    if (live & ~((w == 0) | (w == 1) | (w == -1))).any():
        return None
    trades = {"b": np.flatnonzero(live & (w == 1)), "s": np.flatnonzero(live & (w == -1))}
    pre = {k: np.cumsum(live & (w == v)) for k, v in (("b", 1), ("s", -1))}
    total = {k: len(v) for k, v in trades.items()}
    lo = {"b": 0, "s": 0}
    stats = {"requested": 2 * chunks, "misses": 0, "next": 0}

    def read(k, idx):           # the trade of the (idx + 1)-th buy or sell
        stats["misses"] += idx // _COUNT_CHUNK >= lo[k] + chunks
        return int(trades[k][idx])

    cb, cs = int(cb0), int(cs0)
    st = (float(cb0), float(cs0), float(e_t), float(e_r), int(op))
    c, bc, sc, out = start - 1, 0, 0, []
    while c + 1 < n:
        theta = st[2] * st[3]
        if not theta < math.inf:
            break
        k = -2 ** 62 if theta < -2.0 ** 62 else math.ceil(theta)
        if k > 2 ** 62:
            break
        tb, ts = bc + k - cb, sc + k - cs
        if tb <= bc or ts <= sc:
            j = c + 1
            stats["next"] += 1
            bj, sj = int(pre["b"][j]), int(pre["s"][j])
            stat = max(st[0] + float(bj - bc), st[1] + float(sj - sc))
        else:
            fb, fs = tb <= total["b"], ts <= total["s"]
            if not fb and not fs:
                break
            j = min(read("b", tb - 1) if fb else n, read("s", ts - 1) if fs else n)
            bj, sj = int(pre["b"][j]), int(pre["s"][j])
            stat = float(k)
        t_bar = float(j - st[4])
        rate = stat / max(t_bar, 1.0)
        st = (0.0, 0.0, (1.0 - alpha_t) * st[2] + alpha_t * t_bar,
              (1.0 - alpha_r) * st[3] + alpha_r * rate, j)
        out.append(j)
        c, bc, sc, cb, cs = j, bj, sj, 0, 0
        for key, count in (("b", bc), ("s", sc)):
            new = count // _COUNT_CHUNK
            stats["requested"] += max(min(new - lo[key], chunks), 0)
            lo[key] = max(lo[key], new)
    stats["closes"] = len(out)
    res = (torch.tensor(out[:max(max_bars, 0)], dtype=torch.int64), stats)
    if not exit_state:
        return res
    return res + ((st[0] + float(total["b"] - bc), st[1] + float(total["s"] - sc),
                   st[2], st[3], st[4]),)


def _same(a, b) -> bool:
    """Bitwise equality of two walk states (tuples of floats and ints)."""
    bits = [struct.pack("<d", v) if isinstance(v, float) else v for v in a]
    return bits == [struct.pack("<d", v) if isinstance(v, float) else v for v in b]


def _tile_walker(mode, x, lam, can_close, units, e_t, e_r, alpha_t, alpha_r, thr,
                 start=1, entry=None):
    """The plain sequential walk over trades lo .. hi-1 from a state, in numpy:
    ``(init, reset, step)``, ``step(lo, hi, state) -> (closes, state)``;
    ``init()`` is the state entering trade ``start`` (``entry``, see
    :func:`_launch`)."""
    entry = _initial(mode, e_t, e_r) if entry is None else tuple(entry)
    if mode == _VOLUME:
        u = units.numpy()
        carry = entry[0] + (int(u[0]) if start > 0 else 0)

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
        return (lambda: (carry,)), (lambda g: (0,)), step
    if mode == _CUSUM:
        r, lm, cc = x.numpy(), lam.numpy(), can_close.numpy()
        stops = np.flatnonzero(~np.isfinite(r))

        def finite(lo, hi, sp, sn, closes):
            while lo < hi:
                d = np.cumsum(r[lo:hi])
                s_pos = np.maximum(sp + d, d - np.minimum.accumulate(d))
                s_neg = np.minimum(sn + d, d - np.maximum.accumulate(d))
                pos_hit = s_pos >= lm[lo:hi]
                ev = cc[lo:hi] & (pos_hit | (s_neg <= -lm[lo:hi]))
                if not ev.any():
                    return float(s_pos[-1]), float(s_neg[-1])
                e = int(np.argmax(ev))
                closes.append(lo + e)
                sp, sn = (0.0, float(s_neg[e])) if pos_hit[e] else (float(s_pos[e]), 0.0)
                lo += e + 1
            return sp, sn

        def step(lo, hi, st):
            closes = []
            for g in stops[np.searchsorted(stops, lo):np.searchsorted(stops, hi)]:
                st = _cusum_stop(*finite(lo, g, *st, closes), r[g], lm[g], cc[g], g,
                                 closes)
                lo = g + 1
            return closes, finite(lo, hi, *st, closes)
        return (lambda: entry), (lambda g: (0.0, 0.0)), step
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
    return ((lambda: entry), (lambda g: (0.0, 0.0, e_t, e_r, g - 1)), step)


def _chunked_scan_model(mode: int, n: int, start: int, max_bars: int,
                        chunks: int, *, x=None, lam=None, can_close=None,
                        units=None, e_t=0.0, e_r=0.0, alpha_t=0.0, alpha_r=0.0,
                        thr=0, entry=None, exit_state=False):
    """Kernel E's chunked walk on the CPU, for the tests: the arguments of
    :func:`_launch` (CPU tensors), over the plain sequential walk in numpy.

    Trades ``start .. n-1`` are cut into tiles of 2048 and ``chunks`` chunks of
    whole tiles. Pass 1 walks every chunk from the entry state (chunk 0;
    ``entry`` as in :func:`_launch`) or the mode's reset state, recording each tile's closes and end state; pass 2 walks each
    chunk c > 0 from chunk c-1's pass-1 end state until a tile end where its
    state equals the recorded one bit for bit; the fix-up walks, in order,
    each chunk whose last walk began elsewhere than at its predecessor's final
    end state, with the same stop rule. Returns the first ``max_bars`` closes
    and ``{"tiles", "chunks", "unmerged", "fixed"}``: the pass-2 chunks that
    did not merge and the chunks fixed up; with ``exit_state`` also the state
    after trade n-1 (the last tile's, after the fix-up). The walker's float sums start at
    each tile, so on data whose sums round the closes may differ from the
    plain scans' at near ties; on data whose sums are exact they may not.
    """
    init, reset, step = _tile_walker(mode, x, lam, can_close, units, e_t, e_r,
                                     alpha_t, alpha_r, thr, start, entry)
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
    res = (torch.tensor(out, dtype=torch.int64),
           {"tiles": tiles, "chunks": n_chunks, "unmerged": unmerged,
            "fixed": fixed})
    return res + (states[tiles - 1] if tiles else init(),) if exit_state else res


# ---------------------------------------------------------------------------
# CUSUM bars
# ---------------------------------------------------------------------------

def _cusum_stop(sp, sn, r, lam, can_close, g, closes):
    """The scalar CUSUM step at trade g (``seg_stats.cpp:159-176``): the
    sums add r and clamp at 0 by a compare that keeps a NaN; a close at g is
    appended to ``closes``. Returns the state after it, as floats."""
    sp, sn = float(sp) + float(r), float(sn) + float(r)
    sp, sn = (0.0 if sp < 0.0 else sp), (0.0 if sn > 0.0 else sn)
    if can_close and sp >= lam:
        closes.append(g)
        sp = 0.0
    elif can_close and sn <= -lam:
        closes.append(g)
        sn = 0.0
    return sp, sn


def cusum_scan_plain(rets, lam, can_close, start: int, max_bars: int, *,
                     state=None, exit_state=False):
    """Plain PyTorch version of :func:`cusum_scan`: ``_cusum_boundaries``
    (``indexers.py:508-597``) with a host loop. Each chunk of 8192 trades is
    solved in closed form, ``s+ = max(s0 + D, D - running min of D)`` and
    ``s- = min(s0 + D, D - running max of D)`` over the prefix ``D`` from the
    last event; up to four events are taken per chunk before it moves on.

    The closed form holds over finite returns only (``D`` cancels ``inf -
    inf``), so a chunk ends before each non-finite return, found in one pass
    over the stream, and the scalar step of the host loop is taken there.
    """
    n, dev = rets.shape[0], rets.device
    zero = torch.zeros((), dtype=rets.dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=rets.dtype, device=dev)
    stops = (torch.nonzero(~torch.isfinite(rets[start + 1:])).flatten()
             + (start + 1)).tolist()
    stops.append(n)
    sp, sn = (zero, zero) if state is None else (
        torch.tensor(float(v), dtype=rets.dtype, device=dev) for v in state)
    out, pos, k = [], start + 1, 0
    while pos < n and len(out) < max_bars:
        while stops[k] < pos:
            k += 1
        if stops[k] == pos:     # a non-finite return: the scalar step
            st = _cusum_stop(sp, sn, *torch.stack([
                rets[pos], lam[pos], can_close[pos].to(rets.dtype)]).tolist(), pos, out)
            sp, sn = (torch.tensor(v, dtype=rets.dtype, device=dev) for v in st)
            pos += 1
            continue
        r = rets[pos:min(pos + _CUSUM_CHUNK, stops[k])]
        m = r.shape[0]
        lm = lam[pos:pos + m]
        cc = can_close[pos:pos + m]
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
            pos += m
    out = torch.tensor(out, dtype=torch.int64, device=dev)
    return (out, tuple(torch.stack([sp, sn]).tolist())) if exit_state else out


def cusum_scan(rets, lam, can_close, start: int, max_bars: int, *, state=None,
               exit_state=False):
    """Close indices of the CUSUM bars (at most ``max_bars``): from trade
    ``start + 1`` on, ``s+ = max(0, s+ + rets[i])`` and ``s- = min(0, s- +
    rets[i])``; trade i closes a bar when ``can_close[i]`` and ``s+ >=
    lam[i]`` (then s+ resets) or else ``s- <= -lam[i]`` (then s- resets).
    The sums enter at ``state = (s+, s-)`` (default 0 and 0); ``start=-1``
    lets trade 0 close (a shard after the first). With ``exit_state`` the
    return is ``(closes, (s+, s-) after the last trade)``.

    Sums and compares are IEEE doubles, and the clamps keep a NaN, as the
    reference's host loop (``finmlkit_tpu/native/seg_stats.cpp:159-176``): a
    NaN return (a NaN price) makes both sums NaN, and no bar closes after
    it; an infinite return closes on its side, so a zero price (a return of
    -inf, then +inf) closes at both where it may, or, in one same-timestamp
    block, leaves s+ at +inf (it closes at the block's end) and s- NaN for
    good; a NaN ``lam[i]`` never closes. (The JAX package's device form
    closes nothing after an infinite return: ROADMAP fault R10.)

    ``rets`` and ``lam`` are float64, ``can_close`` bool. On a CUDA tensor
    this launches kernel E; on a CPU tensor it runs :func:`cusum_scan_plain`.
    The kernel's in-tile sums round otherwise than the plain version's, so
    a close where a statistic ties ``lam`` to about 1e-12 may move.
    """
    _check(rets, torch.float64, "rets", rets)
    _check(lam, torch.float64, "lam", rets)
    _check(can_close, torch.bool, "can_close", rets)
    if rets.device.type == "cpu":
        return cusum_scan_plain(rets, lam, can_close, start, max_bars, state=state,
                                exit_state=exit_state)
    return _launch(_CUSUM, rets.shape[0], start + 1, max_bars, rets.device,
                   x=rets, lam=lam, can_close=can_close, entry=state,
                   exit_state=exit_state)


# ---------------------------------------------------------------------------
# Imbalance and run bars
# ---------------------------------------------------------------------------

def info_scan_plain(w, e_ticks0: float, e_rate0: float, alpha_t: float,
                    alpha_r: float, max_bars: int, run_mode: bool, *, state=None,
                    first_closes=False, exit_state=False):
    """Plain PyTorch version of :func:`info_scan`: ``_info_bar_boundaries``
    (``indexers.py:680-753``) with a host loop, one chunk of 2048 trades or
    one event per step; the expectations update in float64 on the host."""
    n, dev = w.shape[0], w.device
    cb0, cs0, e_t, e_r, open_pos = (_initial(_IMBALANCE, e_ticks0, e_rate0)
                                    if state is None else state)
    cb, cs = (torch.tensor(float(v), dtype=w.dtype, device=dev) for v in (cb0, cs0))
    zero = torch.zeros((), dtype=w.dtype, device=dev)
    e_t, e_r, open_pos = float(e_t), float(e_r), int(open_pos)
    out, pos = [], 0 if first_closes else 1
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
    out = torch.tensor(out, dtype=torch.int64, device=dev)
    if not exit_state:
        return out
    cb, cs = torch.stack([cb, cs if run_mode else zero]).tolist()
    return out, (cb, cs, e_t, e_r, open_pos)


def info_scan(w, e_ticks0: float, e_rate0: float, alpha_t: float,
              alpha_r: float, max_bars: int, run_mode: bool, *,
              integral: bool = False, state=None, first_closes=False,
              exit_state=False):
    """Close indices of the imbalance bars (``run_mode=False``: ``|in-bar sum
    of w|``) or run bars (``max(in-bar sum of the positive w, in-bar sum of
    the negative |w|)``), at most ``max_bars``. Trade 0 opens the first bar
    and checks start at trade 1; a bar closes where its statistic reaches
    ``theta = E[T] * E[rate]``, and at each close ``E[T] <- (1 - alpha_t)
    E[T] + alpha_t T`` and ``E[rate] <- (1 - alpha_r) E[rate] + alpha_r
    stat / max(T, 1)``, T the bar's length.

    ``state = (cb, cs, E[T], E[rate], open)`` is the state the stream enters
    with (default ``(0, 0, e_ticks0, e_rate0, 0)``; ``cs`` is unused by
    imbalance bars and returns 0); ``first_closes=True`` lets trade 0 close,
    else trade 0 only opens the bar. With ``exit_state`` the return is
    ``(closes, state after the last trade)``, ``open`` relative to the stream.

    ``w`` is float64. On a CUDA tensor this launches kernel E: imbalance
    bars whose weights, threshold and entry sum :func:`_map_states` admits
    (``integral=True``: the caller knows the weights are finite integers) by
    its map path, run bars that :func:`_count_route` admits by its count
    search (walked again where a weight turns out not to be -1, 0 or +1), all
    others by its walk. On a CPU tensor it runs :func:`info_scan_plain`.
    """
    _check(w, torch.float64, "w", w)
    if w.device.type == "cpu":
        return info_scan_plain(w, e_ticks0, e_rate0, alpha_t, alpha_r,
                               max_bars, run_mode, state=state,
                               first_closes=first_closes, exit_state=exit_state)
    state = _initial(_IMBALANCE, e_ticks0, e_rate0) if state is None else tuple(state)
    e_t, e_r = float(state[2]), float(state[3])
    mode = _RUN if run_mode else _IMBALANCE
    start = 0 if first_closes else 1
    if not run_mode and w.shape[0] > start and _map_states(
            w, e_t, e_r, alpha_t, alpha_r, integral, float(state[0])) is not None:
        mode = _IMBALANCE_MAP
    kw = dict(x=w, e_t=e_t, e_r=e_r, alpha_t=float(alpha_t), alpha_r=float(alpha_r),
              entry=state, exit_state=exit_state)
    if _count_route(run_mode, integral, state, w.shape[0]):
        got = _launch(_RUN_COUNT, w.shape[0], start, max_bars, w.device, **kw)
        if got is not None:
            return got
    return _launch(mode, w.shape[0], start, max_bars, w.device, **kw)


# ---------------------------------------------------------------------------
# Volume bars
# ---------------------------------------------------------------------------

def volume_scan_plain(units, thr: int, max_bars: int, *, state=None,
                      first_closes=False, exit_state=False):
    """Plain PyTorch version of :func:`volume_scan`: ``_volume_boundaries``
    (``indexers.py:368-404``) with a host loop, one ``searchsorted`` jump
    over the int64 prefix of the units per bar; the in-bar sum at trade j is
    ``c[j] - base``, the entry carry a negative base (``base_init`` there)."""
    n, dev = units.shape[0], units.device
    c = torch.cumsum(units, 0)
    carry = 0 if state is None else int(state)
    out, pos, base = [], -1 if first_closes else 0, -carry
    while pos < n and len(out) < max_bars:
        at = torch.searchsorted(c, torch.tensor([base + thr], device=dev))[0]
        nxt = torch.clamp(at, min=pos + 1)
        nxt, val = torch.stack([nxt, c[nxt.clamp(max=n - 1)]]).tolist()
        if nxt > n - 1:
            break
        out.append(nxt)
        pos, base = nxt, val
    out = torch.tensor(out, dtype=torch.int64, device=dev)
    if not exit_state:
        return out
    return out, (int(c[n - 1]) if n else 0) - base


def volume_scan(units, thr: int, max_bars: int, *, state=None, first_closes=False,
                exit_state=False):
    """Close indices of the volume bars (at most ``max_bars``): the in-bar sum
    of the int64 ``units`` starts with trade 0's, checks start at trade 1, a
    bar closes at the first trade where the sum reaches the integer ``thr``,
    and the sum resets to zero (the overshoot is dropped).

    ``state`` is the carried units of the bar open before trade 0 (default
    0), to which trade 0 adds unchecked, or, with ``first_closes=True``, from
    which trade 0 is checked. With ``exit_state`` the return is ``(closes,
    units carried after the last trade)``. (The JAX ring carries the volume
    since the last close as a float and seeds ``base_init=-carry``,
    ``sharded_indexers.py:281-289``; here it is the same integer.)

    On a CUDA tensor this launches kernel E; on a CPU tensor it runs
    :func:`volume_scan_plain`.
    """
    _check(units, torch.int64, "units", units)
    if units.device.type == "cpu":
        return volume_scan_plain(units, thr, max_bars, state=state,
                                 first_closes=first_closes, exit_state=exit_state)
    got = _launch(_VOLUME, units.shape[0], 0 if first_closes else 1, max_bars,
                  units.device, units=units, thr=int(thr),
                  entry=None if state is None else (int(state),), exit_state=exit_state)
    return (got[0], got[1][0]) if exit_state else got
