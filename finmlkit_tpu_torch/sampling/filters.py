"""Event sampling filters.

Counterpart of ``finmlkit_tpu/sampling/filters.py``; the symmetric CUSUM filter
is ported so far.
"""
import numpy as np
import torch

__all__ = ["cusum_filter"]


def cusum_filter(raw_time_series: torch.Tensor, threshold) -> torch.Tensor:
    """Symmetric CUSUM event filter on log returns (AFML snippet 2.4).

    The event loop is sequential and branchy over a bar series, so it runs on
    the host, as the JAX package runs it (``filters.py:88-103``,
    ``native/seg_stats.cpp:137-150``): float64 log returns from numpy, strict
    threshold comparisons, ``s_neg`` checked before ``s_pos``, and only the
    triggered side resets. ``threshold`` is one value or one per sample.
    Returns int64 event indices on the device of ``raw_time_series``.
    """
    x = raw_time_series.detach().to("cpu", torch.float64).numpy()
    thr = np.asarray(threshold.cpu() if torch.is_tensor(threshold) else threshold,
                     dtype=np.float64).reshape(-1)
    n = len(x)
    if n <= 1:
        raise ValueError("Input time series must have at least 2 elements.")
    if len(thr) != 1 and len(thr) != n:
        raise ValueError("Threshold array must either contain 1 const. element "
                         "or len(raw_time_series) elements.")
    if len(thr) == 1:
        thr = np.full(n, thr[0])
    log_ret = np.log(x[1:] / x[:-1]).tolist()
    h = thr.tolist()
    events = []
    s_pos = s_neg = 0.0
    for i in range(1, n):
        r = log_ret[i - 1]
        sp, sn = s_pos + r, s_neg + r
        s_pos = sp if sp > 0.0 else 0.0
        s_neg = sn if sn < 0.0 else 0.0
        if s_neg < -h[i]:
            s_neg = 0.0
            events.append(i)
        elif s_pos > h[i]:
            s_pos = 0.0
            events.append(i)
    return torch.tensor(events, dtype=torch.int64, device=raw_time_series.device)
