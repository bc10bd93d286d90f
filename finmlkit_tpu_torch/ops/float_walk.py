"""The exact float64 volume and dollar bar walks: kernel D (``csrc/float_walk.cu``).

Kernel D replaces no TPU kernel. The JAX kits build volume and dollar bars of
trades whose prices sit on no tick grid with host C++ loops
(``finmlkit_tpu/native/seg_stats.cpp:183-211``); these walks are those loops,
close for close: the running sum starts with trade 0's value, the checks start
at trade 1, a bar closes at the first trade where the sum reaches the
threshold, and then volume restarts at 0 while dollar subtracts the threshold
(``cum -= thr``); at most ``max_bars`` closes are written.

Every step rounds once, as the source is written: ``p * (double)v`` is one
rounded product and the add another. A host build of the loops with
``-march=native`` fuses the dollar step into one FMA (ROADMAP R15), which can
move a close when the running sum lies within an ulp of the threshold; the
port follows the unfused source on the card and in the plain versions.

Kernel D has three routes. A pass over the stream on the card finds what
picks one, and the host reads it once:

- the warp step, for values that are all finite and >= 0 and a threshold in
  ``[2^-960, 2^1000)``: while the sum stays in one binade below the
  threshold, a float64 add is an integer add on that binade's grid, so the
  walk finds its next binade crossing, close or tie with two ballots over
  tables of grid values that other warps build ahead (:func:`walk_warp` is
  its scheme on the CPU, on exact integers). Volume bars restart at 0 at each
  close, so their stream is cut into chunks that walk at once and merge
  (:func:`walk_chunked`); dollar bars carry a remainder and walk once.
- units, for a volume walk of the warp step's domain whose values are all
  multiples of one unit small enough that no sum of a bar rounds
  (:func:`exact_unit`): the walk is then an integer walk, kernel E's volume
  scan (``event_scan.volume_scan``) of the values in units.
- the block walk, for any other stream (a negative or non-finite value, a
  threshold outside that range): one thread adds 16 values before one
  compare (:func:`walk_blocks` on the CPU).

Entry and exit sums. Every walk, kernel, plain loop and CPU model, takes
``state=``, the running float64 sum before trade 0 (the volume since the last
close, or the dollar remainder): trade 0 is then checked like any other, as
in a time shard after the first. ``exit_state=True`` returns ``(closes, the
sum after the last trade)``; it is the stream's end only where fewer than
``max_bars`` closes were found. The walk is the loop, so a stream cut anywhere
and walked in turn gives its closes bit for bit. An entry sum that is
negative or not finite goes to the block walk, as such a value does; the
units route takes one only where it is a whole number of the unit (it is
then one more value of the route pass's); the warp step takes any other.

The trace registry (``utils/trace.py``) counts walks, one a call, as
``launch.D``, and by route as ``launch.D.<ROUTE_NAMES[route]>``. On the
device a walk is the route pass (one launch, two memsets) and then: the warp
step 4 launches and a memset (6 launches where a volume walk
has chunks), the block walk 1 launch, units 1 launch and kernel E's call
(counted as E's).

The plain versions are Python loops over ``.tolist()``: a serial float
recurrence has no vectorized form. They run in the tests and in
``chip_smoke.py``, not on the kits' path.
"""
import math
import struct
from fractions import Fraction
from itertools import accumulate, islice

import numpy as np
import torch

from .. import _build
from ..utils import trace
from . import event_scan

__all__ = ["volume_walk", "volume_walk_plain", "dollar_walk", "dollar_walk_plain",
           "walk_blocks", "walk_warp", "walk_chunked", "grid_step", "in_warp_domain",
           "exact_unit", "units_threshold", "route_of"]

WARP, BLOCK, UNITS = 0, 1, 2
ROUTE_NAMES = ("warp", "block", "units")   # launch.D.<name> in the trace registry
STATS = ("searches", "steps", "ties", "crossings", "serial", "closes", "unmerged",
         "fixed", "cycles", "wait", "producer_wait")   # the warp step's counters (Stat)
_VOLUME, _DOLLAR = 0, 1
_CHUNK, _BLOCK = 2048, 16   # the block walk (csrc/float_walk.cu)
TILE = 768                # the warp step's buffer of trades (kTile)
BINADES = 7               # binades below the threshold with grid tables (kBinades)
SERIAL_RUN = 4            # values a serial step adds before one compare (kRun)
_TWO52, _TWO53 = 1 << 52, 1 << 53
_TIE = _TWO52 + 1         # added to a tie's floor in the tables (kTie)
_THR_LO, _THR_HI = 2.0 ** -960, 2.0 ** 1000


def route_launches() -> list:
    """Kernel D's walks so far by route, in the order of ``ROUTE_NAMES``."""
    return [trace.counter("launch.D." + r) for r in ROUTE_NAMES]


def _walk_plain(values: torch.Tensor, thr: float, max_bars: int, reset: bool,
                state=None, exit_state=False):
    """The loop of ``seg_stats.cpp:183-211`` over float64 ``values`` (one per
    trade), from the sum ``state`` before trade 0 where given; returns the
    close indices as int64 on the values' device (and the sum after the last
    trade)."""
    x = values.tolist()
    out = []
    cum = 0.0 if state is None else float(state)
    if x and max_bars > 0:
        thr = float(thr)
        if state is None:
            cum = x[0]
        for i, xi in enumerate(islice(x, 0 if state is not None else 1, None),
                               0 if state is not None else 1):
            cum += xi
            if cum >= thr:
                out.append(i)
                cum = 0.0 if reset else cum - thr
                if len(out) == max_bars:
                    break
    out = torch.tensor(out, dtype=torch.int64, device=values.device)
    return (out, cum) if exit_state else out


def volume_walk_plain(volumes: torch.Tensor, thr: float, max_bars: int, *, state=None,
                      exit_state=False):
    """Plain version of :func:`volume_walk`, on any device."""
    return _walk_plain(volumes.to(torch.float64), thr, max_bars, True, state, exit_state)


def dollar_walk_plain(prices: torch.Tensor, volumes: torch.Tensor, thr: float,
                      max_bars: int, *, state=None, exit_state=False):
    """Plain version of :func:`dollar_walk`, on any device. The products
    ``prices * volumes`` are formed first, each rounded once, as the kernel
    forms them."""
    return _walk_plain(prices.to(torch.float64) * volumes.to(torch.float64), thr,
                       max_bars, False, state, exit_state)


def walk_blocks(values, thr: float, max_bars: int, reset: bool, *, chunk: int = _CHUNK,
                block: int = _BLOCK, state=None, exit_state=False):
    """Kernel D's block walk on the CPU, for the tests: float64 ``values``
    (numpy) cut into chunks of ``chunk`` and each chunk's values after the
    first trade into blocks of ``block``. A block whose values are all >= 0
    and whose in-order sum stays below ``thr`` after its last value is added
    in one go; any other block, and a chunk's tail, is walked again a step at
    a time from the sum before it. Returns the closes and the number of
    blocks walked twice (and with ``exit_state`` the sum after the last
    trade; ``state`` as in :func:`_walk_plain`)."""
    out, again = [], 0
    n = len(values)
    cum = 0.0 if state is None else float(state)

    def result():
        res = np.asarray(out, np.int64), again
        return res + (cum,) if exit_state else res

    if n == 0 or max_bars <= 0:
        return result()
    x = values.tolist()
    if state is None:
        cum = x[0]

    def step(i):
        nonlocal cum
        cum += x[i]
        if cum >= thr:
            out.append(i)
            cum = 0.0 if reset else cum - thr
        return len(out) == max_bars

    for base in range(0, n, chunk):
        m = min(chunk, n - base)
        j = 1 if base == 0 and state is None else 0
        while j + block <= m:
            xs = x[base + j:base + j + block]
            total = cum
            for xi in xs:
                total += xi
            if all(xi >= 0.0 for xi in xs) and total < thr:
                cum = total
            else:
                again += 1
                if any(step(base + j + u) for u in range(block)):
                    return result()
            j += block
        for i in range(base + j, base + m):
            if step(i):
                return result()
    return result()


# --- the warp step on the CPU, on exact integers --------------------------


def in_warp_domain(values, thr: float) -> bool:
    """Whether the warp step takes a stream: every value finite and >= 0
    (-0.0 included), the threshold in ``[2^-960, 2^1000)``."""
    x = np.asarray(values, np.float64)
    return bool(_THR_LO <= thr < _THR_HI and np.all(np.isfinite(x)) and np.all(x >= 0.0))


def _binade(g: float) -> int:
    """e with ``2^e <= g < 2^(e+1)``, for a normal g > 0."""
    return math.frexp(g)[1] - 1


def grid_step(x: float, e: int):
    """``x >= 0`` on the grid of binade e (ulp ``2^(e-52)``): ``(k, tie)``
    with k the nearest integer to ``x / 2^(e-52)`` (its floor at a tie,
    ``tie`` True), capped at 2^52. A state ``g = S 2^(e-52)`` of that binade
    (``2^52 <= S < 2^53``) then steps to ``fl(g + x) = (S + k + r) 2^(e-52)``,
    r the parity of ``S + k`` at a tie and 0 elsewhere, wherever
    ``S + k + r < 2^53``."""
    num, den = x.as_integer_ratio()
    s = 52 - e
    if s >= 0:
        num <<= s
    else:
        den <<= -s
    k, rem = divmod(num, den)
    if k >= _TWO52:
        return _TWO52, False
    twice = 2 * rem
    if twice == den:
        return k, True
    return k + (twice > den), False


def grid_step_magic(x: np.ndarray, e: int):
    """:func:`grid_step` as kernel D's producer warps compute it, in float64:
    ``q = x 2^(52-e)`` (exact), ``t = min(q + 2^52, 2^53)`` rounds q to the
    nearest integer (to even at a tie), ``(t - 2^52) - q`` is -0.5 or +0.5
    exactly at a tie. Returns ``(k, tie)`` arrays."""
    q = np.asarray(x, np.float64) * 2.0 ** (52 - e)
    t = np.minimum(q + 2.0 ** 52, 2.0 ** 53)
    diff = (t - 2.0 ** 52) - q
    k = t.view(np.int64) - np.int64(0x4330000000000000)
    tie = np.abs(diff) == 0.5
    return k - (tie & (diff > 0)), tie


def _window(thr: float, binades: int):
    """(e_lo, 2^e_lo, L): the lowest binade with a table and each
    table's limit ``L_d = min(2^53, ceil(thr / 2^(e_lo + d - 52)))``; a state
    ``S`` of binade ``e_lo + d`` is below the threshold and in its binade
    exactly while ``S < L_d``."""
    e_lo = _binade(thr) - binades + 1
    t = Fraction(thr)
    lims = [min(_TWO53, math.ceil(t / Fraction(2) ** (e_lo + d - 52)))
            for d in range(binades)]
    return e_lo, math.ldexp(1.0, e_lo), lims


def _units_exponent(low_bit, top: float, thr: float):
    """u = ``low_bit`` where the values' lowest set bit and largest value
    ``top`` put a volume walk in the exact-sum case at ``thr``, else None."""
    if low_bit is None or not -1000 <= low_bit <= 1000:
        return None
    unit = Fraction(2) ** low_bit
    if units_threshold(thr, low_bit) < _TWO52 and Fraction(top) / unit < _TWO52:
        return low_bit
    return None


def units_threshold(thr: float, u: int) -> int:
    """``ceil(thr / 2^u)``: a sum of multiples of 2^u reaches ``thr`` exactly
    where its count of units reaches this."""
    return math.ceil(Fraction(thr) / Fraction(2) ** u)


def exact_unit(values, thr: float):
    """The exponent u of the unit ``2^u`` in which a volume walk of
    ``values`` adds without rounding, or None: every value a multiple of
    ``2^u`` (u the lowest set bit over the values > 0, in [-1000, 1000]),
    ``ceil(thr / 2^u)`` and the largest value below ``2^52`` units. Each add
    of the loop starts from a state below thr, 0 or trade 0's value, so its
    sum is below ``2^53`` units and every add and compare is exact: the walk
    is kernel E's volume scan of the values in units at
    :func:`units_threshold` (kernel D's units route)."""
    pos = np.asarray(values, np.float64)
    pos = pos[pos > 0.0]
    if not pos.size:
        return None
    # as the route pass finds it: the exponent and the significand's lowest bit
    b = pos.view(np.int64)
    e = b >> 52
    m = (b & (_TWO52 - 1)) | np.where(e > 0, _TWO52, 0)
    low = np.frexp((m & -m).astype(np.float64))[1] - 1 + np.maximum(e, 1) - 1075
    return _units_exponent(int(low.min()), float(pos.max()), thr)


def _tables(x, e_lo: int, binades: int):
    """Each binade's grid values of every trade, a tie's floor plus
    ``_TIE`` (so that a tie stops the search as a crossing does)."""
    cols = []
    for d in range(binades):
        col = []
        for xi in x:
            k, tie = grid_step(xi, e_lo + d)
            col.append(k + _TIE if tie else k)
        cols.append(col)
    return cols


def _bits(g: float) -> int:
    return struct.unpack("<q", struct.pack("<d", g))[0]


def _from_bits(b: int) -> float:
    return struct.unpack("<d", struct.pack("<q", b))[0]


def _segment(x, kap, win, thr, reset, lo, hi, start, g, old, cap, tile, st, closes):
    """Kernel D's walker over trades ``start .. hi-1`` (buffers of ``tile``
    trades from ``lo``) from the state ``g`` entering trade ``start``.
    Appends the closes to ``closes``; stops at the first close that ``old``
    (a predicate on the trade index, or None) also holds, or at ``cap``
    closes. Returns ``(end state, merge trade or None)``."""
    e_lo, lo_bound, lims = win
    inwin, d, lim = False, 0, 0

    def enter(prefix, q):
        # the state g after buffer position q: its binade's table, if any
        nonlocal inwin, d, lim
        inwin = lo_bound <= g < thr
        if inwin:
            e = _binade(g)
            d = e - e_lo
            s = int(math.ldexp(g, 52 - e))
            lim = lims[d] - s + (prefix[d][q] if q >= 0 else 0)
            assert 0 <= lim < 1 << 64

    def close(i):
        nonlocal g
        closes.append(i)
        st["closes"] += 1
        g = 0.0 if reset else g - thr
        if old is not None and old(i):
            return "merge"
        return "cap" if len(closes) >= cap else None

    for cb in range(lo, hi, tile):
        ln = min(tile, hi - cb)
        nsteps = -(-ln // 32)
        prefix = [list(accumulate(col[cb:cb + ln])) for col in kap]
        assert all(p[-1] < 1 << 64 for p in prefix)
        pos = 0
        if cb == lo:
            pos = start - lo
            enter(prefix, pos - 1)
        while pos < ln:
            if not inwin:
                # below the lowest table (or at or above the threshold): real
                # adds, SERIAL_RUN at once where their sum stays below it
                if pos + SERIAL_RUN <= ln:
                    s = g
                    for u in range(SERIAL_RUN):
                        s += x[cb + pos + u]
                    if s < lo_bound:
                        g = s
                        pos += SERIAL_RUN
                        st["serial"] += SERIAL_RUN
                        continue
                g += x[cb + pos]
                st["serial"] += 1
                if g >= thr:
                    why = close(cb + pos)
                    if why:
                        return g, (cb + pos if why == "merge" else None)
                enter(prefix, pos)
                pos += 1
                continue
            p = prefix[d]
            # a step: one round of ballots over the 32 trades from pos and
            # over the ends of the buffer's later steps of 32
            st["steps"] += 1
            m = next((pos + u for u in range(32) if pos + u < ln and p[pos + u] >= lim), None)
            if m is None:
                s0 = (pos + 32) >> 5
                f = next((s for s in range(s0, nsteps) if p[min(32 * s + 31, ln - 1)] >= lim),
                         None)
                if f is None:
                    break
                # a search: a second round, in the step whose end stops the walk
                st["searches"] += 1
                m = next(32 * f + u for u in range(32) if 32 * f + u < ln and p[32 * f + u] >= lim)
            pm, pp = p[m], (p[m - 1] if m else 0)
            s1 = lims[d] - lim + pp                   # the state before trade m, exact
            assert _TWO52 <= s1 < lims[d]
            kap_m = pm - pp
            if kap_m > _TWO52:                        # a tie: to the even neighbour
                st["ties"] += 1
                kf = kap_m - _TIE
                r = (s1 + kf) & 1
                if s1 + kf + r < lims[d]:
                    lim += _TIE - r
                    pos = m + 1
                    continue
            st["crossings"] += 1                      # the real add from the exact state
            g = math.ldexp(s1, e_lo + d - 52) + x[cb + m]
            if g >= thr:
                why = close(cb + m)
                if why:
                    return g, (cb + m if why == "merge" else None)
            enter(prefix, m)
            pos = m + 1
        if inwin:
            lim -= prefix[d][ln - 1]
    if inwin:
        g = math.ldexp(lims[d] - lim, e_lo + d - 52)
    return g, None


def _new_stats():
    return dict.fromkeys(STATS, 0)


def walk_warp(values, thr: float, max_bars: int, reset: bool, *, binades: int = BINADES,
              tile: int = TILE, state=None, exit_state=False):
    """Kernel D's warp step on the CPU, for the tests: the walk of float64
    ``values`` (numpy, in :func:`in_warp_domain`) from trade 0, as one walker
    over tables of ``binades`` binades in buffers of ``tile`` trades.

    Returns the closes (the first ``max_bars``) and the walker's counts:
    ``steps`` (rounds of ballots over the next 32 trades and the ends of the
    buffer's later steps of 32), ``searches`` (second rounds, in the step
    found), ``ties``, ``crossings`` (real adds from a table's
    exact state: binade crossings and closes), ``serial`` (real adds below the
    lowest table or above the threshold) and ``closes``; with ``exit_state``
    also the sum after the last trade (``state`` as in :func:`_walk_plain`)."""
    assert tile % 32 == 0 and tile <= 1024 and in_warp_domain(values, thr)
    st = _new_stats()
    x = np.asarray(values, np.float64).tolist()
    closes = []
    end = 0.0 if state is None else float(state)
    if x and max_bars > 0:
        win = _window(thr, binades)
        kap = _tables(x, win[0], binades)
        end = _segment(x, kap, win, thr, reset, 0, len(x), 1 if state is None else 0,
                       x[0] if state is None else end, None, max_bars, tile, st, closes)[0]
    res = np.asarray(closes, np.int64), st
    return res + (end,) if exit_state else res


def chunk_bounds(n: int, chunks: int, tile: int = TILE):
    """Kernel D's chunks of whole tiles: ``(per, count)``."""
    tiles = -(-n // tile)
    per = -(-tiles // max(chunks, 1)) * tile
    return per, -(-n // per)


def walk_chunked(values, thr: float, max_bars: int, chunks: int, *,
                 binades: int = BINADES, tile: int = TILE, state=None, exit_state=False):
    """Kernel D's volume walk in chunks on the CPU, for the tests (the sum
    restarts at 0 at each close, so two walks that close at one trade agree
    from there on).

    Pass 1 walks every chunk from a bar that opens at its first trade (chunk 0
    from trade 0's value, at trade 1). Pass 2 walks each chunk c > 0 from
    chunk c-1's pass-1 end state until it closes at a trade where pass 1 also
    closed. The fix-up walks, in chunk order, each chunk whose last walk began
    elsewhere than at its predecessor's final end state, until it closes where
    that last walk closed. A chunk's closes are the fix-up's before its merge,
    pass 2's before its merge, pass 1's after. Returns the first ``max_bars``
    closes and :func:`walk_warp`'s counts with ``chunks``, ``unmerged`` (pass-2
    walks that never merged) and ``fixed`` (chunks the fix-up walked); with
    ``exit_state`` also the sum after the last trade, the last chunk's final
    end state (``state``, chunk 0's entry sum, as in :func:`_walk_plain`)."""
    assert tile % 32 == 0 and tile <= 1024 and in_warp_domain(values, thr)
    st = _new_stats()
    x = np.asarray(values, np.float64).tolist()
    n = len(x)
    if n == 0 or max_bars <= 0:
        res = np.zeros(0, np.int64), dict(st, chunks=0)
        return res + (0.0 if state is None else float(state),) if exit_state else res
    win = _window(thr, binades)
    kap = _tables(x, win[0], binades)
    per, nch = chunk_bounds(n, chunks, tile)
    bounds = [(c * per, min(c * per + per, n)) for c in range(nch)]

    def walk(c, g, old, closes, first=False):
        lo, hi = bounds[c]
        return _segment(x, kap, win, thr, True, lo, hi, lo + first, g, old, math.inf,
                        tile, st, closes)

    a, end1 = set(), []
    for c in range(nch):
        got = []
        first = c == 0 and state is None
        g0 = (x[0] if first else float(state)) if c == 0 else 0.0
        end1.append(walk(c, g0, None, got, first)[0])
        a.update(got)
    b, m2, end2 = set(), [lo for lo, _ in bounds], list(end1)
    for c in range(1, nch):
        if _bits(end1[c - 1]) == _bits(0.0):
            continue                                  # pass 1's own entry
        got = []
        end2[c], merged = walk(c, end1[c - 1], a.__contains__, got)
        b.update(got)
        m2[c] = bounds[c][1] if merged is None else merged
        st["unmerged"] += merged is None
    f, m3 = set(), [lo for lo, _ in bounds]
    final_end = end1[0]
    for c in range(1, nch):
        last_end = end1[c] if m2[c] < bounds[c][1] else end2[c]
        if _bits(final_end) != _bits(end1[c - 1]):   # its last walk's entry
            got = []
            end, merged = walk(c, final_end,
                               lambda i, c=c: i in b if i < m2[c] else i in a, got)
            f.update(got)
            m3[c] = bounds[c][1] if merged is None else merged
            if merged is None:
                last_end = end
            st["fixed"] += 1
        final_end = last_end
    closes = sorted(i for c, (lo, hi) in enumerate(bounds)
                    for i in range(lo, hi)
                    if (i in f if i < m3[c] else i in b if i < m2[c] else i in a))
    res = np.asarray(closes[:max_bars], np.int64), dict(st, chunks=nch)
    return res + (final_end,) if exit_state else res


# --- the wrappers ----------------------------------------------------------


def _check(what, volumes, prices=None):
    if volumes.dim() != 1 or volumes.dtype != torch.float32:
        raise TypeError(f"{what} takes 1-D float32 volumes, got {volumes.dtype} "
                        f"of shape {tuple(volumes.shape)}")
    if prices is not None and (prices.shape != volumes.shape
                               or prices.dtype != torch.float64
                               or prices.device != volumes.device):
        raise TypeError(f"{what} takes float64 prices of the volumes' shape and device")
    if volumes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {volumes.device}")


def _default_chunks(device) -> int:
    """Chunks of a volume walk of the warp step: 12, from the chunk sweep in
    ``PERF.md`` (1 to 132 chunks, the month and unrounded draws whose walks
    merge at every 997th trade), where the slower stream was fastest; at
    most one a streaming multiprocessor. More chunks walk less each, but on
    the month more of them end before they merge, and the fix-up walks those
    one after another."""
    return min(12, torch.cuda.get_device_properties(device).multi_processor_count)


def _aligned(t):
    """``t`` contiguous at a 16-byte address (the producers' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _entry_low_bit(state: float):
    """The exponent of an entry sum's lowest set bit, or None for 0."""
    if state == 0.0:
        return None
    num, den = Fraction(state).as_integer_ratio()
    return (num & -num).bit_length() - 1 - (den.bit_length() - 1)


def route_of(mode: int, flag: int, low_bit: int, top: int, thr: float, state=None):
    """The route of a walk from what the route pass found (``flag``: a value
    negative or not finite; ``low_bit`` and ``top``: the lowest set bit over
    the values > 0, 2^62 or more where none, and the largest value's bits) and
    the entry sum ``state`` (None: a fresh stream). The entry sum is one more
    value: negative or not finite, it sends the walk to the block walk, and
    the units route takes it where it is a whole number of the unit. Returns
    ``(route, u)``, u the units route's exponent."""
    entered = state is not None
    if flag or (entered and not (math.isfinite(state) and state >= 0.0)) \
            or not _THR_LO <= thr < _THR_HI:
        return BLOCK, None
    u = None
    if mode == _VOLUME:
        lows = [b for b in (low_bit if low_bit < 1 << 62 else None,
                            _entry_low_bit(state) if entered else None) if b is not None]
        if lows:
            u = _units_exponent(min(lows), max(_from_bits(top), state or 0.0), thr)
    return (WARP, None) if u is None else (UNITS, u)


def _launch(mode: int, prices, volumes, thr: float, max_bars: int, *, chunks=None,
            stats=None, state=None, exit_state=False):
    """Kernel D over CUDA tensors: the route pass, one device read of what it
    found, then the route's launches and one device read of the number of
    closes. ``chunks`` cuts a volume walk of the warp step (default
    :func:`_default_chunks`; a dollar walk is one chunk); the closes do not
    depend on it. ``stats``, a zeroed int64 tensor of ``len(STATS)`` on the
    device, receives the warp step's counts (``STATS``; the last three in SM
    clock cycles: the walkers', their waits for a tile, the producers' waits
    for room); other routes leave it at 0. ``state`` and ``exit_state`` as in
    :func:`volume_walk`; the exit sum is read with the count."""
    dev = volumes.device
    n, max_bars = volumes.shape[0], int(max_bars)
    if n == 0 or max_bars <= 0:
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        if not exit_state:
            return empty
        if n == 0 or state is not None:   # an empty stream, or no walk from its entry
            return empty, (0.0 if state is None else float(state))
        return empty, None
    entered = state is not None
    state = float(state) if entered else 0.0
    if chunks is None:
        chunks = 1 if mode == _DOLLAR else _default_chunks(dev)
    if chunks < 1:
        raise ValueError(f"kernel D takes at least one chunk, got {chunks}")
    if mode == _DOLLAR:
        chunks = 1
    if stats is not None and (stats.shape != (len(STATS),) or stats.dtype != torch.int64
                              or stats.device != dev):
        raise ValueError(f"stats must be an int64 tensor of {len(STATS)} on the stream's "
                         "device")
    volumes = _aligned(volumes)
    prices = None if prices is None else _aligned(prices)
    p = None if prices is None else prices.data_ptr()
    lib = _build.library()
    info = torch.empty(3, dtype=torch.int64, device=dev)   # flag, lowest bit, largest value
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.fmk_float_walk_route(mode, p, volumes.data_ptr(), n, info.data_ptr(),
                                              stream), "float_walk route")
        route, u = route_of(mode, *info.tolist(), thr, state if entered else None)
        if route == UNITS:
            units = torch.empty(n, dtype=torch.int64, device=dev)
            _build.check(lib.fmk_float_walk_units(volumes.data_ptr(), n, u, units.data_ptr(),
                                                  stream), "float_walk units")
        else:
            out = torch.empty(max_bars, dtype=torch.int64, device=dev)
            io = torch.empty(2, dtype=torch.int64, device=dev)   # the count, the exit sum
            scratch = torch.empty(lib.fmk_float_walk_scratch_bytes(n, chunks) if route == WARP
                                  else 0, dtype=torch.uint8, device=dev)
            _build.check(lib.fmk_float_walk(mode, route, p, volumes.data_ptr(), n, float(thr),
                                            max_bars, chunks, int(entered), state,
                                            scratch.data_ptr(), out.data_ptr(), io.data_ptr(),
                                            io.data_ptr() + 8 if exit_state else None,
                                            None if stats is None else stats.data_ptr(),
                                            stream), "float_walk")
    if route == UNITS:
        got = event_scan.volume_scan(
            units, units_threshold(thr, u), max_bars,
            state=int(Fraction(state) / Fraction(2) ** u) if entered else None,
            first_closes=entered, exit_state=exit_state)
        if exit_state:
            out, carry = got
            end = math.ldexp(float(carry), u)   # exact: below 2^53 units
        else:
            out = got
    elif exit_state:
        count, bits = io.tolist()
        out, end = out[:count], _from_bits(bits)
    else:
        out = out[:int(io[0])]
    trace.count("launch.D")
    trace.count("launch.D." + ROUTE_NAMES[route])
    return (out, end) if exit_state else out


def volume_walk(volumes: torch.Tensor, thr: float, max_bars: int, *, state=None,
                exit_state=False):
    """Close indices (int64) of volume bars over float32 ``volumes``: the sum
    in float64 restarts at 0 at each close. ``state`` is the volume since the
    last close before trade 0 (a float64; trade 0 is then checked, as in a
    time shard after the first); by default trade 0's volume starts the sum.
    With ``exit_state`` the return is ``(closes, the sum after the last
    trade)``. (The JAX ring carries the same sum and seeds ``base_init =
    -carry`` into a prefix-sum search, ``sharded_indexers.py:281-289``; the
    walk adds it as the loop does.) On a CUDA tensor this launches kernel D;
    on a CPU tensor it runs :func:`volume_walk_plain`."""
    _check("volume_walk", volumes)
    if volumes.device.type == "cpu":
        return volume_walk_plain(volumes, thr, max_bars, state=state, exit_state=exit_state)
    return _launch(_VOLUME, None, volumes, thr, max_bars, state=state, exit_state=exit_state)


def dollar_walk(prices: torch.Tensor, volumes: torch.Tensor, thr: float,
                max_bars: int, *, state=None, exit_state=False):
    """Close indices (int64) of dollar bars over float64 ``prices`` times
    float32 ``volumes``: the sum carries its remainder past each close.
    ``state`` is the remainder carried into trade 0 (trade 0 is then
    checked); with ``exit_state`` the return is ``(closes, the remainder after
    the last trade)``. On CUDA tensors this launches kernel D; on CPU tensors
    it runs :func:`dollar_walk_plain`."""
    _check("dollar_walk", volumes, prices)
    if volumes.device.type == "cpu":
        return dollar_walk_plain(prices, volumes, thr, max_bars, state=state,
                                 exit_state=exit_state)
    return _launch(_DOLLAR, prices, volumes, thr, max_bars, state=state,
                   exit_state=exit_state)
