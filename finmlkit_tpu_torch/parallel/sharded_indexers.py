"""Time-sharded bar indexers: bar boundaries found across a process group.

Counterpart of ``finmlkit_tpu/parallel/sharded_indexers.py``, for all seven bar
types. Every function runs on each rank of a group (:mod:`.mesh`), takes the
stream's host columns (or this rank's span and its ``offset``, see
:func:`.sharded.shard_trades`) and returns host ``(close_ts, ci)`` in the
single-device convention (element 0 the open anchor), the same on every rank:

- **time bars**: each rank counts its trades at or before every clock
  instant (``torch.searchsorted`` on the single-device indexer's float64
  clock) and one all-reduce sums the counts; any interval the single-device
  indexer takes (the JAX function's float32 binning needs integer-ns ones);
- **tick bars**: the closed form of the stream's length;
- **integer dollar bars**: each rank's prefix of its dollar units (kernel S),
  the exclusive sum of the spans' totals before it, a local search of the
  single-device targets ``ceil(m * thr)``, the first candidate over the ranks
  (a MIN all-reduce) and the single-device ``cummax`` bump;
- **volume, float dollar, CUSUM, imbalance and run bars**: a ring. Rank k
  scans its span with the port's single-device scan from the state rank k-1
  left (kernel E with an entry state for integer volume, CUSUM, imbalance and
  run; kernel D with an entry sum for float volume and dollar), then
  broadcasts its exit state. The ring is the sequential chain of the local
  scans, the trades staying where they are.

The closes are the single-device indexers' bit for bit where the scan's sums
are exact: integer units always; kernel D's float walks always, since the walk
is the loop whatever the cut (the JAX ring searches prefix sums and
re-associates them, ``sharded_indexers.py:26-31``, ROADMAP D1); and kernel E's
float64 CUSUM, imbalance and run sums wherever they add without rounding (as
on dyadic data). Where they round, a span edge cuts E's in-tile sums as the
whole scan does not, so a close can move only where a statistic ties its
threshold within that rounding, as between kernel E and its plain version.
CUSUM closes follow the host loop after an infinite return (R10).

A rank whose scan fills its buffer grows it and scans again before it hands
its exit state on, as the single-device indexers do. Each ring is the trace
registry's span ``ring.<indexer>`` (``utils/trace.py``), this rank's scan in
it ``ring.<indexer>.scan``; with tracing on, the scan waits for the card, so
that its span holds the scan's time.
"""
import math
import struct

import numpy as np
import torch

from ..bar.indexers import _DOLLAR_SHIFT, _walk_cap, time_bar_indexer
from ..ops.event_scan import cusum_scan, info_scan, volume_scan
from ..ops.float_walk import dollar_walk, volume_walk
from ..ops.prefix_scan import fast_cumsum, fast_ffill
from .mesh import TimeMesh, all_gather, all_reduce, broadcast
from .sharded import TradeShard, gather_ragged, shard_trades, values_at
from ..utils import trace

__all__ = [
    "sharded_time_bar_indexer", "sharded_tick_bar_indexer",
    "sharded_volume_bar_indexer", "sharded_dollar_bar_indexer",
    "sharded_cusum_bar_indexer", "sharded_imbalance_bar_indexer",
    "sharded_run_bar_indexer",
]

def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ring(mesh: TimeMesh, name: str, fmt: str, carry, step):
    """Rank k runs ``step(carry) -> (closes, exit state)`` at ring step k and
    broadcasts its exit state (a tuple packed as int64 words by the struct
    format ``fmt``, bit for bit); returns this rank's closes and the state
    after the last rank."""
    mine = None
    with trace.span(f"ring.{name}"):
        for k in range(mesh.size):
            if mesh.rank == k:
                with trace.span(f"ring.{name}.scan"):
                    mine, carry = step(carry)
                    if trace.enabled():
                        _sync(mesh.device)
            words = torch.tensor(struct.unpack(f"<{len(fmt)}q",
                                               struct.pack(f"<{fmt}", *carry)),
                                 dtype=torch.int64, device=mesh.device)
            words = broadcast(mesh, words, k)
            carry = struct.unpack(f"<{fmt}", struct.pack(f"<{len(fmt)}q", *words.tolist()))
    return mine, carry


def _grown(scan, cap: int, m: int):
    """``scan(cap)`` with the buffer grown (four times a round) until it is not
    full or holds every trade: the exit state is then the span's end."""
    while True:
        closes, state = scan(cap)
        if len(closes) < cap or cap >= m:
            return closes, state
        cap = min(cap * 4, m)


def _assemble(mesh: TimeMesh, shard: TradeShard, closes, anchor: int, max_bars=None):
    """The global ``(close_ts, ci)`` on the host from every rank's closes
    (global indices), ``ci[0] = anchor``."""
    dev = mesh.device
    ci = gather_ragged(mesh, closes.to(device=dev, dtype=torch.int64))
    if max_bars is not None:
        ci = ci[:int(max_bars)]
    ci = torch.cat([torch.tensor([anchor], dtype=torch.int64, device=dev), ci])
    ts = values_at(mesh, shard, shard["ts"], ci)
    return ts.cpu().numpy(), ci.cpu().numpy()


def _shard(mesh, offset, **cols) -> TradeShard:
    return shard_trades({k: v for k, v in cols.items() if v is not None}, mesh,
                        offset=offset)


# --- time and tick bars ---------------------------------------------------------


def sharded_time_bar_indexer(timestamps, interval_seconds: float, mesh: TimeMesh, *,
                             offset: int | None = None):
    """Time bars across the ranks: ``(clock, ci)`` of
    ``bar.indexers.time_bar_indexer`` bit for bit. Each rank counts its trades
    at or before each instant of the float64 clock; one all-reduce of the
    ``n_clock`` counts sums them."""
    sh = _shard(mesh, offset, ts=timestamps)
    ts = sh["ts"].to(torch.int64)
    m = ts.shape[0]
    big = np.iinfo(np.int64).max
    ends = torch.tensor([int(ts[0]) if m else big, -int(ts[-1]) if m else big],
                        dtype=torch.int64, device=mesh.device)
    first, neg_last = all_reduce(mesh, ends, "min").tolist()
    clock, ci_local = time_bar_indexer(ts, interval_seconds, ts_first=first,
                                       ts_last_i=-neg_last)
    ci = all_reduce(mesh, ci_local + 1, "sum") - 1
    return clock.cpu().numpy(), ci.cpu().numpy()


def sharded_tick_bar_indexer(timestamps, threshold: int, mesh: TimeMesh, *,
                             offset: int | None = None):
    """Tick bars: the closed form of the stream's length (``tick_bar_indexer``);
    the close timestamps come from the ranks that hold them."""
    sh = _shard(mesh, offset, ts=timestamps)
    step, first = max(int(threshold), 1), max(int(threshold) - 1, 1)
    ci = torch.cat([torch.zeros(1, dtype=torch.int64, device=mesh.device),
                    torch.arange(first, sh.n, step, dtype=torch.int64, device=mesh.device)])
    return values_at(mesh, sh, sh["ts"], ci).cpu().numpy(), ci.cpu().numpy()


# --- dollar bars -----------------------------------------------------------------


def _dollar_q(mesh, sh, threshold, tick_size, amount_scale):
    """The integer dollar rule of ``dollar_bar_indexer_q`` across the ranks."""
    dev = mesh.device
    thr_scaled = float(threshold) / (tick_size * amount_scale) / (1 << _DOLLAR_SHIFT)
    d = (sh["ticks"].to(torch.int64) * sh["units"].to(torch.int64)) >> _DOLLAR_SHIFT
    c = fast_cumsum(d) if d.numel() else d
    total = c[-1:] if d.numel() else torch.zeros(1, dtype=torch.int64, device=dev)
    totals = all_gather(mesh, total).flatten()
    carry = int(totals[:mesh.rank].sum())
    grand = int(totals.sum())
    n = sh.n
    max_bars = min(max(int(float(grand) / thr_scaled) + 1, 1), n)
    mm = torch.arange(1, max_bars + 1, dtype=torch.int64, device=dev)
    u = torch.ceil(mm.to(torch.float64) * thr_scaled).to(torch.int64)
    # the first trade of this span whose global prefix reaches each target
    p = torch.searchsorted(c, u - carry)
    cand = torch.where(p < c.shape[0], p + sh.lo, torch.full_like(p, n))
    naive = all_reduce(mesh, cand, "min").clamp(min=1)
    b = mm + torch.cummax(naive - mm, 0).values
    ci = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), b[b <= n - 1]])
    return values_at(mesh, sh, sh["ts"], ci).cpu().numpy(), ci.cpu().numpy()


def _float_ring(mesh, sh, name, walk, values, threshold):
    """Volume or dollar bars of kernel D's walks in a ring: rank k walks its
    span from the sum the span before it left."""
    threshold = float(threshold)
    m = sh.hi - sh.lo
    total = float(values().sum()) if m else 0.0

    def step(carry):
        (s,) = carry
        entered = sh.lo > 0          # the stream started before this span
        if m == 0:
            return torch.zeros(0, dtype=torch.int64, device=mesh.device), (s,)
        cap = _walk_cap(total + (s if entered and math.isfinite(s) else 0.0), threshold, m)
        closes, end = _grown(lambda c: walk(c, s if entered else None), cap, m)
        return closes + sh.lo, (end,)

    closes, _ = _ring(mesh, name, "d", (0.0,), step)
    return _assemble(mesh, sh, closes, 0)


def sharded_dollar_bar_indexer(timestamps, prices, volumes, threshold: float,
                               mesh: TimeMesh, *, price_ticks=None, amount_units=None,
                               tick_size=None, amount_scale=None, offset: int | None = None):
    """Dollar bars across the ranks (the remainder carried past each close).

    With quantized inputs (``price_ticks``, ``amount_units``, ``tick_size``,
    ``amount_scale``) this is ``dollar_bar_indexer_q``'s integer rule, fully
    parallel (module docstring); otherwise ``dollar_bar_indexer``'s float64
    walk (float64 prices, float32 volumes) in a ring of kernel D's dollar walks,
    each rank from the remainder the span before it left. Bit for bit the
    single-device closes either way."""
    if price_ticks is not None and amount_units is not None:
        sh = _shard(mesh, offset, ts=timestamps, ticks=price_ticks, units=amount_units)
        return _dollar_q(mesh, sh, threshold, tick_size, amount_scale)
    sh = _shard(mesh, offset, ts=timestamps, px=prices, v=volumes)
    px, v = sh["px"].to(torch.float64), sh["v"].to(torch.float32)
    return _float_ring(
        mesh, sh, "dollar", lambda cap, s: dollar_walk(px, v, threshold, cap, state=s,
                                                       exit_state=True),
        lambda: px * v.to(torch.float64), threshold)


# --- volume bars -------------------------------------------------------------------


def sharded_volume_bar_indexer(timestamps, volumes, threshold: float, mesh: TimeMesh, *,
                               amount_units=None, amount_scale=None,
                               offset: int | None = None):
    """Volume bars across the ranks (the sum restarts at 0 at each close): a
    ring of kernel E's volume scans on the int64 ``amount_units`` where given
    (``volume_bar_indexer_q``), else of kernel D's volume walks on the float32
    ``volumes`` (``volume_bar_indexer``), each rank from the volume carried
    since the last close. Bit for bit the single-device closes."""
    if amount_units is not None:
        sh = _shard(mesh, offset, ts=timestamps, units=amount_units)
        units = sh["units"].to(torch.int64)
        m = units.shape[0]
        thr_units = float(threshold) / float(amount_scale)
        thr = math.ceil(thr_units)
        total = float(int(units.sum())) if m else 0.0

        def step(carry):
            (c,) = carry
            if m == 0:
                return torch.zeros(0, dtype=torch.int64, device=mesh.device), (c,)
            first = sh.lo > 0        # a span after the first: trade 0 may close
            cap = m if thr_units <= 0 else min(max(int((total + c) / thr_units) + 2, 2), m)
            closes, end = _grown(lambda mb: volume_scan(
                units, thr, mb, state=c, first_closes=first, exit_state=True), cap, m)
            return closes + sh.lo, (end,)

        closes, _ = _ring(mesh, "volume", "q", (0,), step)
        return _assemble(mesh, sh, closes, 0)
    sh = _shard(mesh, offset, ts=timestamps, v=volumes)
    v = sh["v"].to(torch.float32)
    return _float_ring(
        mesh, sh, "volume", lambda cap, s: volume_walk(v, threshold, cap, state=s,
                                                       exit_state=True),
        lambda: v.to(torch.float64), threshold)


# --- CUSUM bars ----------------------------------------------------------------------


def _neighbour(mesh, value: torch.Tensor, has: bool, before: bool):
    """The value (an 8-byte scalar) of the nearest rank before (or after) this
    one that has one (``has``), None where there is none: one all-gather of
    every rank's value, bit for bit."""
    word = value.reshape(1).view(torch.int64)
    got = all_gather(mesh, torch.cat([word, torch.tensor([int(has)], dtype=torch.int64,
                                                         device=word.device)]))
    ranks = range(mesh.rank - 1, -1, -1) if before else range(mesh.rank + 1, mesh.size)
    for r in ranks:
        if got[r, 1] > 0:
            return got[r, :1].view(value.dtype)[0]
    return None


def sharded_cusum_bar_indexer(timestamps, prices, sigma, sigma_floor: float,
                              sigma_mult: float, mesh: TimeMesh, *,
                              max_bars: int | None = None, offset: int | None = None):
    """CUSUM bars across the ranks: ``cusum_bar_indexer`` bit for bit where the
    returns' sums are exact (module docstring).

    The inputs of each span follow from two halos, the last price of the span
    before (the first log return) and the first timestamp of the span after
    (the same-print-block rule), and from the sigma forward fill (kernel F on
    each span, from the last valid sigma of the spans before it). The first
    valid sigma is the stream's. Then a ring of kernel E's CUSUM scans carries
    ``(s+, s-)``. Returns ``(close_ts, ci, filled_sigma)``, the filled sigma of
    this rank's span (a tensor on its device; the JAX function gathers the
    whole stream's to the host)."""
    sh = _shard(mesh, offset, ts=timestamps, px=prices, sig=sigma)
    dev, m, lo, n = mesh.device, sh.hi - sh.lo, sh.lo, sh.n
    ts = sh["ts"].to(torch.int64)
    px, sig = sh["px"].to(torch.float64), sh["sig"].to(torch.float64).clone()
    valid = ~torch.isnan(sig)
    has = bool(valid.any()) if m else False
    local_first = int(torch.argmax(valid.to(torch.uint8))) + lo if has else n
    first_valid = int(all_reduce(mesh, torch.tensor([local_first], device=dev), "min"))
    first_valid = 0 if first_valid >= n else first_valid
    # the fill from the last valid sigma of the spans before
    last_valid = sig[valid][-1] if has else torch.zeros((), dtype=torch.float64, device=dev)
    carried = _neighbour(mesh, last_valid, has, before=True)
    if carried is not None and m and not bool(valid[0]):
        sig[0], valid[0] = carried, True
    # the halos: the price before the span, the timestamp after it
    prev_px = _neighbour(mesh, px[-1] if m else torch.zeros((), dtype=torch.float64,
                                                            device=dev), m > 0, before=True)
    next_ts = _neighbour(mesh, ts[0] if m else torch.zeros((), dtype=torch.int64, device=dev),
                         m > 0, before=False)
    # the single-device inputs (cusum_scan_inputs) of this span's trades
    sig_filled = fast_ffill(sig, valid) if m else sig
    lam = torch.maximum(sig_filled * float(sigma_mult),
                        torch.tensor(float(sigma_floor), dtype=torch.float64, device=dev))
    if m:
        log_p = torch.log(px)
        before = log_p[:1] if prev_px is None else torch.log(prev_px.reshape(1))
        rets = log_p - torch.cat([before, log_p[:-1]])
        if prev_px is None:
            rets[0] = 0.0                  # the stream's first trade
        nxt = ts[1:] if next_ts is None else torch.cat([ts[1:], next_ts.reshape(1)])
        can_close = torch.cat([ts[:nxt.shape[0]] != nxt,
                               torch.ones(m - nxt.shape[0], dtype=torch.bool, device=dev)])
    start = max(first_valid - lo, -1)      # the scan checks trades after it

    def step(carry):
        if m == 0 or start + 1 >= m:
            return torch.zeros(0, dtype=torch.int64, device=dev), carry
        cap = max(min(m, 1 << 16), 2)
        closes, end = _grown(lambda mb: cusum_scan(rets, lam, can_close, start, mb,
                                                   state=carry, exit_state=True), cap, m)
        return closes + lo, end

    closes, _ = _ring(mesh, "cusum", "dd", (0.0, 0.0), step)
    close_ts, ci = _assemble(mesh, sh, closes, first_valid, max_bars)
    return close_ts, ci, sig_filled


# --- imbalance and run bars ---------------------------------------------------------


def _sharded_info_bar(timestamps, sides, weights, threshold, expected_ticks_init,
                      expected_rate_init, alpha_ticks, alpha_rate, mesh, run_mode,
                      max_bars, offset):
    if threshold is not None:
        if alpha_ticks or alpha_rate:
            raise ValueError("threshold= selects fixed mode; EMA alphas must be 0")
        expected_ticks_init, expected_rate_init = 1.0, float(threshold)
    if expected_ticks_init is None or expected_rate_init is None:
        raise ValueError("provide either threshold= or both "
                         "expected_ticks_init= and expected_rate_init=")
    sh = _shard(mesh, offset, ts=timestamps, side=sides, w=weights)
    dev, m, lo, n = mesh.device, sh.hi - sh.lo, sh.lo, sh.n
    s = sh["side"]
    w = s.to(torch.float64) if weights is None else s.to(torch.float64) * sh["w"].to(
        torch.float64)
    # tick imbalance: the int8 sides are finite integers (as the single-device
    # indexer tells kernel E's map path)
    integral = weights is None and not s.dtype.is_floating_point
    e_t0, e_r0 = float(expected_ticks_init), float(expected_rate_init)
    a_t, a_r = float(alpha_ticks), float(alpha_rate)

    def step(carry):
        cb, cs, e_t, e_r, open_g = carry
        if m == 0:
            return torch.zeros(0, dtype=torch.int64, device=dev), carry
        first = lo > 0           # a span after the first: trade 0 may close

        def scan(mb):
            got, st = info_scan(w, e_t0, e_r0, a_t, a_r, mb, run_mode, integral=integral,
                                state=(cb, cs, e_t, e_r, open_g - lo), first_closes=first,
                                exit_state=True)
            return got, st
        closes, (cb2, cs2, et2, er2, op2) = _grown(scan, max(min(m, 1 << 16), 2), m)
        return closes + lo, (cb2, cs2, et2, er2, op2 + lo)

    closes, _ = _ring(mesh, "run" if run_mode else "imbalance", "ddddq",
                      (0.0, 0.0, e_t0, e_r0, 0), step)
    total = int(all_reduce(mesh, torch.tensor([len(closes)], device=dev), "sum"))
    if max_bars is None:
        # the single-device indexer's buffer growth, decided on the global count
        mb = max(min(n, 1 << 16), 2)
        while not (total < mb or mb >= n):
            if mb >= max(n // 8, 2):
                raise ValueError(
                    f"info-bar threshold adapted into the every-trade "
                    f"regime (> {mb} bars over {n} trades); raise the "
                    f"initial expectations/alphas or pass max_bars=")
            mb = min(mb * 4, n)
    return _assemble(mesh, sh, closes, 0, max_bars)


def sharded_imbalance_bar_indexer(timestamps, sides, weights=None, *, threshold=None,
                                  expected_ticks_init=None, expected_rate_init=None,
                                  alpha_ticks=0.0, alpha_rate=0.0, mesh: TimeMesh = None,
                                  max_bars=None, offset: int | None = None):
    """Imbalance bars across the ranks (``imbalance_bar_indexer``'s rule and
    arguments): a ring of kernel E's imbalance scans carrying ``(cb, cs, E[T],
    E[rate], open)``, the open carried as a global trade index and taken
    relative to each span (as the JAX ring shifts it by the shard's offset,
    ``sharded_indexers.py:436-442``). Raises on the single-device indexer's
    every-trade condition, decided on the global count."""
    return _sharded_info_bar(timestamps, sides, weights, threshold, expected_ticks_init,
                             expected_rate_init, alpha_ticks, alpha_rate, mesh, False,
                             max_bars, offset)


def sharded_run_bar_indexer(timestamps, sides, weights=None, *, threshold=None,
                            expected_ticks_init=None, expected_rate_init=None,
                            alpha_ticks=0.0, alpha_rate=0.0, mesh: TimeMesh = None,
                            max_bars=None, offset: int | None = None):
    """Run bars across the ranks (``run_bar_indexer``'s rule and arguments),
    as :func:`sharded_imbalance_bar_indexer`."""
    return _sharded_info_bar(timestamps, sides, weights, threshold, expected_ticks_init,
                             expected_rate_init, alpha_ticks, alpha_rate, mesh, True,
                             max_bars, offset)
