"""Bar close-index computation (the "indexer" layer).

Counterpart of ``finmlkit_tpu/bar/indexers.py``; the time-bar indexer and
the integer dollar-bar indexer are ported so far. Indexers return
``(close_ts, close_indices)``: element 0 is the open anchor of the first bar,
and bar *i* spans trades ``(ci[i], ci[i+1]]``.
"""
import math

import numpy as np
import torch

from ..ops.prefix_scan import fast_cumsum

__all__ = ["time_bar_indexer", "dollar_bar_indexer_q"]

_DOLLAR_SHIFT = 6  # >>6 keeps a month of tick*unit dollars inside int64


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
    ts0 = float(timestamps[0]) if ts_first is None else float(ts_first)
    ts_last = float(timestamps[-1]) if ts_last_i is None else float(ts_last_i)
    start = math.floor(ts0 / step) * step
    last = math.ceil(ts_last / step) * step
    stop = last + step + 1.0
    n_clock = int(np.ceil((stop - start) / step))
    dev = timestamps.device
    k = torch.arange(n_clock, dtype=torch.float64, device=dev)
    clock = (start + k * step).to(torch.int64)
    ci = torch.searchsorted(timestamps.contiguous(), clock + 1) - 1
    return clock, ci


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
    max_bars = min(max(int(float(int(c[n - 1])) / thr_scaled) + 1, 1), n)
    m = torch.arange(1, max_bars + 1, dtype=torch.int64, device=dev)
    u = torch.ceil(m.to(torch.float64) * thr_scaled).to(torch.int64)
    naive = torch.searchsorted(c, u).clamp(min=1)  # #{c < u}; checks start at trade 1
    b = m + torch.cummax(naive - m, 0).values
    count = int((b <= n - 1).sum())
    ci = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), b[:count]])
    return timestamps[ci], ci
