"""Bar close-index computation (the "indexer" layer).

Counterpart of ``finmlkit_tpu/bar/indexers.py``. Ported: the time, tick,
integer dollar and integer volume indexers, the float64 volume and dollar
indexers (for prices off a tick grid, on kernel D), the CUSUM indexer
(float64) and the imbalance and run indexers (float64). The native host
indexers do not cross (kernels E and D run the same recurrences on the card),
nor do the TPU's float32 scans and the JAX device forms of the float64 volume
and dollar indexers (prefix-sum searches that can move a close by one trade).
Indexers return ``(close_ts, close_indices)``: element 0 is the open anchor of
the first bar, and bar *i* spans trades ``(ci[i], ci[i+1]]``.

The scans under the volume, dollar, CUSUM, imbalance and run indexers (kernels
E and D) also take the state a stream enters with and return the state after
its last trade (``state=``, ``exit_state=``); ``parallel/sharded_indexers.py``
runs them span by span, each from the state the span before left, and gets
these indexers' closes.
"""
import math

import numpy as np
import torch

from ..ops.event_scan import cusum_scan, info_scan, volume_scan
from ..ops.float_walk import dollar_walk, volume_walk
from ..ops.prefix_scan import fast_cumsum, fast_ffill
from ..utils import trace

__all__ = ["time_bar_indexer", "tick_bar_indexer", "dollar_bar_indexer_q",
           "volume_bar_indexer_q", "volume_bar_indexer", "dollar_bar_indexer",
           "cusum_scan_inputs", "cusum_bar_indexer",
           "imbalance_bar_indexer", "run_bar_indexer"]

_DOLLAR_SHIFT = 6  # >>6 keeps a month of tick*unit dollars inside int64
_FIRST_BUFFER = 1 << 16  # closes the CUSUM, imbalance and run scans first make room for


@trace.span("time_bar_indexer")
def time_bar_indexer(timestamps: torch.Tensor, interval_seconds: float,
                     ts_first: int | None = None, ts_last_i: int | None = None):
    """Time-bar indexer over sorted int64 ns ``timestamps``.

    The bar clock is built in float64 exactly as the JAX package builds it
    (``indexers.py:88-111``): ``start + arange(n_clock, f64) * step``, then
    truncated to int64. ``ci[k] = #{ts <= clock[k]} - 1``, i.e. a left
    ``searchsorted`` of ``clock + 1`` minus one. ``ts_first``/``ts_last_i``
    (host ints) spare two device reads. Returns ``(clock, ci)`` as int64
    tensors on the device of ``timestamps``.
    """
    if timestamps.dim() != 1 or timestamps.dtype != torch.int64:
        raise TypeError("timestamps must be a 1-D int64 tensor")
    step = float(interval_seconds) * 1e9
    ts0 = trace.host_read(float, timestamps[0]) if ts_first is None else float(ts_first)
    ts_last = (trace.host_read(float, timestamps[-1])
               if ts_last_i is None else float(ts_last_i))
    start = math.floor(ts0 / step) * step
    last = math.ceil(ts_last / step) * step
    stop = last + step + 1.0
    n_clock = int(np.ceil((stop - start) / step))
    dev = timestamps.device
    k = torch.arange(n_clock, dtype=torch.float64, device=dev)
    clock = (start + k * step).to(torch.int64)
    ci = torch.searchsorted(timestamps.contiguous(), clock + 1) - 1
    return clock, ci


@trace.span("tick_bar_indexer")
def tick_bar_indexer(timestamps: torch.Tensor, threshold: int):
    """Tick-bar indexer in closed form (``indexers.py:136-148``): the first
    close at trade ``max(threshold - 1, 1)``, then every ``max(threshold, 1)``
    trades. Returns ``(close_ts, ci)`` on the device of ``timestamps``."""
    n = timestamps.shape[0]
    step = max(int(threshold), 1)
    first = max(int(threshold) - 1, 1)
    dev = timestamps.device
    ci = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                    torch.arange(first, n, step, dtype=torch.int64, device=dev)])
    return timestamps[ci], ci


@trace.span("dollar_bar_indexer_q")
def dollar_bar_indexer_q(timestamps, price_ticks, amount_units, threshold,
                         tick_size, amount_scale, *, cumsum=fast_cumsum):
    """Integer-exact dollar-bar indexer over quantized trades.

    Same rule as ``finmlkit_tpu.bar.indexers.dollar_bar_indexer_q``: per-trade
    dollar units ``(ticks * units) >> 6`` (int64), their inclusive prefix ``c``
    (``cumsum``, kernel S by default), and bar m closes at the first trade
    where ``c >= ceil(m * thr)``, moved to at least one trade after the
    previous close (``b = m + cummax(rank - m)``). The TPU's blocked rank and
    ``(rows, 128)`` layout give the same ranks as ``torch.searchsorted``.
    Bar 0 opens after trade 0, so ``ci[0] == 0``; trades after the last
    crossing belong to no bar.

    The number of targets, ``total / thr + 1``, comes from one read of the
    total, so no bar is left out. Returns ``(close_ts, ci)`` as int64 tensors
    on the device of the trades.
    """
    thr_scaled = float(threshold) / (tick_size * amount_scale) / (1 << _DOLLAR_SHIFT)
    n = int(price_ticks.shape[0])
    dev = price_ticks.device
    d = (price_ticks.to(torch.int64) * amount_units) >> _DOLLAR_SHIFT
    c = cumsum(d)
    total = trace.host_read(int, c[n - 1])
    max_bars = min(max(int(float(total) / thr_scaled) + 1, 1), n)
    m = torch.arange(1, max_bars + 1, dtype=torch.int64, device=dev)
    u = torch.ceil(m.to(torch.float64) * thr_scaled).to(torch.int64)
    naive = torch.searchsorted(c, u).clamp(min=1)  # #{c < u}; checks start at trade 1
    b = m + torch.cummax(naive - m, 0).values
    count = trace.host_read(int, (b <= n - 1).sum())
    ci = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), b[:count]])
    return timestamps[ci], ci


@trace.span("volume_bar_indexer_q")
def volume_bar_indexer_q(timestamps, amount_units, threshold, amount_scale, *,
                         scan=volume_scan):
    """Integer-exact volume-bar indexer with reset-to-zero semantics
    (``indexers.py:352-404``; the host loop ``native/seg_stats.cpp:183-194``):
    the in-bar sum of the int64 ``amount_units`` starts with trade 0's, checks
    start at trade 1, a bar closes at the first trade where the sum reaches
    ``threshold / amount_scale`` units (compared exactly, as the integer
    ``ceil`` of that), and the sum restarts at zero. ``scan`` defaults to
    kernel E (``ops.event_scan.volume_scan``). Returns ``(close_ts, ci)``.
    """
    n = int(amount_units.shape[0])
    dev = amount_units.device
    thr_units = float(threshold) / float(amount_scale)
    thr = math.ceil(thr_units)
    total = float(trace.host_read(int, amount_units.sum()))
    # every bar holds at least thr units, so the buffer never fills
    max_bars = n if thr_units <= 0 else min(max(int(total / thr_units) + 2, 2), n)
    out = scan(amount_units, thr, max_bars)
    ci = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), out])
    return timestamps[ci], ci


def _walk_ci(timestamps, closes):
    ci = torch.cat([torch.zeros(1, dtype=torch.int64, device=closes.device), closes])
    return timestamps[ci], ci


def _walk_cap(total: float, threshold: float, n: int) -> int:
    """``int(total / threshold) + 2`` closes (``indexers.py:440, 453``), at
    most ``n``; ``n`` for a threshold of at most 0, where the JAX helpers
    divide by zero or ask for a negative buffer."""
    if threshold <= 0:
        return n
    return min(int(total / threshold) + 2, n)


def volume_bar_indexer(timestamps, volumes, threshold, *, walk=volume_walk):
    """Volume bars of float32 ``volumes`` with the exact float64 loop
    (``volume_bar_indexer_host``, ``indexers.py:434-444``, and
    ``native/seg_stats.cpp:183-194``): the sum starts with trade 0's volume,
    the checks start at trade 1, and it restarts at 0 at each close, the
    overshoot dropped. ``walk`` defaults to kernel D
    (``ops.float_walk.volume_walk``). At most ``int(total / threshold) + 2``
    closes, ``total`` the float64 sum of the volumes (one device read).

    The JAX package's device form (``indexers.py:407``) searches the prefix
    sum for each close and can close a bar one trade away from the loop's
    close near the threshold; it is not ported. Returns ``(close_ts, ci)``,
    ``ci[0] == 0``.
    """
    threshold = float(threshold)
    n = int(volumes.shape[0])
    total = float(volumes.to(torch.float64).sum())
    closes = walk(volumes, threshold, _walk_cap(total, threshold, n))
    return _walk_ci(timestamps, closes)


def dollar_bar_indexer(timestamps, prices, volumes, threshold, *, walk=dollar_walk):
    """Dollar bars of float64 ``prices`` times float32 ``volumes`` with the
    exact float64 loop (``dollar_bar_indexer_host``, ``indexers.py:447-458``,
    and ``native/seg_stats.cpp:199-211``): the sum starts with trade 0's
    dollars, the checks start at trade 1, and each close subtracts the
    threshold, the remainder carried. Each product and each add rounds once,
    as the source loop is written (ROADMAP R15). ``walk`` defaults to kernel D
    (``ops.float_walk.dollar_walk``). At most ``int(total / threshold) + 2``
    closes (one device read of the total).

    The JAX package's device form (``indexers.py:168``) searches the prefix
    sum for each multiple of the threshold and can move a close by one trade;
    it is not ported. Returns ``(close_ts, ci)``, ``ci[0] == 0``.
    """
    threshold = float(threshold)
    n = int(volumes.shape[0])
    total = float((prices.to(torch.float64) * volumes.to(torch.float64)).sum())
    closes = walk(prices, volumes, threshold, _walk_cap(total, threshold, n))
    return _walk_ci(timestamps, closes)


def cusum_scan_inputs(timestamps, prices, sigma, sigma_floor: float,
                      sigma_mult: float, *, ffill=fast_ffill):
    """The inputs of the CUSUM scan (``indexers.py:621-642``), in float64:
    ``(rets, lam, can_close, first_valid, filled_sigma)``. ``rets[0] = 0``,
    ``can_close[i]`` is false while ``timestamps[i] == timestamps[i+1]``, and
    ``first_valid`` (a host int) is the first non-NaN sigma, 0 when there is
    none."""
    f64 = torch.float64
    sig = sigma.to(f64)
    isnan = torch.isnan(sig)
    first_valid = trace.host_read(int, torch.argmin(isnan.to(torch.uint8)))
    sig_filled = ffill(sig, ~isnan)
    lam = torch.maximum(sig_filled * float(sigma_mult),
                        torch.full((), float(sigma_floor), dtype=f64, device=sig.device))
    log_p = torch.log(prices.to(f64))
    rets = torch.cat([torch.zeros(1, dtype=f64, device=log_p.device),
                      torch.diff(log_p)])
    can_close = torch.cat([timestamps[:-1] != timestamps[1:],
                           torch.ones(1, dtype=torch.bool, device=timestamps.device)])
    return rets, lam, can_close, first_valid, sig_filled


@trace.span("cusum_bar_indexer")
def cusum_bar_indexer(timestamps, prices, sigma, sigma_floor: float,
                      sigma_mult: float, max_bars: int | None = None, *,
                      ffill=fast_ffill, scan=cusum_scan):
    """CUSUM bar indexer with adaptive threshold and the same-print-block rule
    (``indexers.py:600-657``; reference ``logic.py:152-221``), in float64.

    NaN sigmas are forward-filled (``ffill``, kernel F by default) from the
    first valid one; ``lam = max(sigma_mult * sigma, sigma_floor)``; the
    symmetric CUSUM of the log returns starts after the first valid sigma; a
    bar cannot close while ``timestamps[i] == timestamps[i+1]``; when s+
    triggers only s+ resets, and vice versa (``scan``, kernel E by default).
    ``max_bars`` caps the number of bars (a truncation); without it the
    event buffer grows until every bar fits, each scan again counted as
    ``event_scan.regrow`` in the trace registry.

    The sums follow the reference's exact host loop in IEEE doubles
    (``cusum_bar_indexer_host``): a NaN price gives two NaN returns, after
    which no bar closes; a zero price gives a return of -inf, then one of
    +inf, which close where they may (in one same-timestamp block s+ jumps to
    +inf and closes at the block's end, and s- turns NaN for good), and bars
    go on closing. The JAX package's device form closes nothing after an
    infinite return (ROADMAP fault R10).

    Returns ``(close_ts, ci, filled_sigma)``, ``ci[0]`` the first valid sigma.
    """
    n = prices.shape[0]
    rets, lam, can_close, first_valid, sig_filled = cusum_scan_inputs(
        timestamps, prices, sigma, sigma_floor, sigma_mult, ffill=ffill)
    user_cap = max_bars is not None
    mb = int(max_bars) if user_cap else max(min(n, _FIRST_BUFFER), 2)
    while True:
        out = scan(rets, lam, can_close, first_valid, mb)
        if user_cap or len(out) < mb or mb >= n:
            break
        mb = min(mb * 4, n)  # the buffer filled: grow it and scan again
        trace.count("event_scan.regrow")
    ci = torch.cat([torch.full((1,), first_valid, dtype=torch.int64,
                               device=timestamps.device), out])
    return timestamps[ci], ci, sig_filled


def _info_bar_indexer(timestamps, sides, weights, expected_ticks_init,
                      expected_rate_init, alpha_ticks, alpha_rate, threshold,
                      max_bars, run_mode, scan):
    if threshold is not None:
        if alpha_ticks or alpha_rate:
            raise ValueError("threshold= selects fixed mode; EMA alphas must be 0")
        expected_ticks_init, expected_rate_init = 1.0, float(threshold)
    if expected_ticks_init is None or expected_rate_init is None:
        raise ValueError("provide either threshold= or both "
                         "expected_ticks_init= and expected_rate_init=")
    f64 = torch.float64
    w = sides.to(f64) if weights is None else sides.to(f64) * weights.to(f64)
    n = w.shape[0]
    user_cap = max_bars is not None
    mb = int(max_bars) if user_cap else max(min(n, _FIRST_BUFFER), 2)
    # tick imbalance on kernel E: the int8 sides are finite integers, known
    # without a read of the card
    known = (scan is info_scan and weights is None
             and not sides.dtype.is_floating_point)
    kw = {"integral": True} if known else {}
    while True:
        out = scan(w, float(expected_ticks_init), float(expected_rate_init),
                   float(alpha_ticks), float(alpha_rate), mb, run_mode, **kw)
        count = len(out)
        if user_cap or count < mb or mb >= n:
            break   # a user max_bars is an explicit truncation
        if mb >= max(n // 8, 2):
            # theta = E[T] * E[rate] can adapt down to a bar per trade on
            # driftless data; fail instead of scanning on (indexers.py:780-790)
            raise ValueError(
                f"info-bar threshold adapted into the every-trade "
                f"regime (> {mb} bars over {n} trades); raise the "
                f"initial expectations/alphas or pass max_bars=")
        mb = min(mb * 4, n)
        trace.count("event_scan.regrow")
    ci = torch.cat([torch.zeros(1, dtype=torch.int64, device=w.device), out])
    return timestamps[ci], ci


@trace.span("imbalance_bar_indexer")
def imbalance_bar_indexer(timestamps, sides, weights=None, *, threshold=None,
                          expected_ticks_init=None, expected_rate_init=None,
                          alpha_ticks=0.0, alpha_rate=0.0, max_bars=None,
                          scan=info_scan):
    """Imbalance bars (tick, volume or dollar; ``indexers.py:796-820``): a bar
    closes when the in-bar signed imbalance ``|sum(side * w)|`` reaches theta,
    in float64.

    ``sides`` are the ±1 signs (int8); ``weights`` None for tick imbalance,
    the amounts for volume imbalance, price times amount for dollar
    imbalance. ``threshold`` fixes theta (the alphas must be 0); otherwise
    theta = E[T] * E[rate] from ``expected_ticks_init`` and
    ``expected_rate_init``, EMA-updated at each close with ``alpha_ticks`` and
    ``alpha_rate``. ``max_bars`` truncates; without it the close buffer grows
    (each scan again counted as ``event_scan.regrow``) and a ValueError is
    raised once the bars pass n / 8. ``scan`` defaults to kernel E. Returns
    ``(close_ts, ci)``.
    """
    return _info_bar_indexer(timestamps, sides, weights, expected_ticks_init,
                             expected_rate_init, alpha_ticks, alpha_rate,
                             threshold, max_bars, False, scan)


@trace.span("run_bar_indexer")
def run_bar_indexer(timestamps, sides, weights=None, *, threshold=None,
                    expected_ticks_init=None, expected_rate_init=None,
                    alpha_ticks=0.0, alpha_rate=0.0, max_bars=None,
                    scan=info_scan):
    """Run bars (``indexers.py:823-835``): a bar closes when ``max(sum of the
    buy w, sum of the sell w)`` within the bar reaches theta. Parameters as
    in :func:`imbalance_bar_indexer`."""
    return _info_bar_indexer(timestamps, sides, weights, expected_ticks_init,
                             expected_rate_init, alpha_ticks, alpha_rate,
                             threshold, max_bars, True, scan)
