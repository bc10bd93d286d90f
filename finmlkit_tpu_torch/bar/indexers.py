"""Bar close-index computation (the "indexer" layer).

Counterpart of ``finmlkit_tpu/bar/indexers.py``; the time-bar indexer is
ported so far. Indexers return ``(close_ts, close_indices)``: element 0 is the
open anchor of the first bar, and bar *i* spans trades ``(ci[i], ci[i+1]]``.
"""
import math

import numpy as np
import torch

__all__ = ["time_bar_indexer"]


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
