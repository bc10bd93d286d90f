"""Event sampling filters: the symmetric CUSUM filter and the z-score peak
filter.

Counterpart of ``finmlkit_tpu/sampling/filters.py``. The JAX z-score filter's
``dtype=`` (a float32 fast path for the TPU) does not cross: the port's filter
works in float64.
"""
import numpy as np
import torch

from ..ops.prefix_scan import fast_cumsum
from ..utils import trace

__all__ = ["cusum_filter", "z_score_peak_filter"]


@trace.span("cusum_filter")
def cusum_filter(raw_time_series: torch.Tensor, threshold) -> torch.Tensor:
    """Symmetric CUSUM event filter on log returns (AFML snippet 2.4).

    The event loop is sequential and branchy over a bar series, so it runs on
    the host, as the JAX package runs it (``filters.py:88-103``,
    ``native/seg_stats.cpp:137-150``): float64 log returns from numpy, strict
    threshold comparisons, ``s_neg`` checked before ``s_pos``, and only the
    triggered side resets. ``threshold`` is one value or one per sample.
    Returns int64 event indices on the device of ``raw_time_series``.
    """
    x = trace.host_read(_to_host, raw_time_series.detach()).numpy()
    thr = np.asarray(trace.host_read(_to_host, threshold)
                     if torch.is_tensor(threshold) else threshold,
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
    with trace.span("cusum_filter.loop"):
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
    dev = raw_time_series.device
    return trace.host_read(lambda e: torch.tensor(e, dtype=torch.int64, device=dev), events)


def _to_host(x):
    return x.to("cpu", torch.float64)


def z_score_peak_filter(y, window: int, threshold: float = 3, *, cumsum=fast_cumsum,
                        device="cuda") -> torch.Tensor:
    """Causal z-score peak filter (``filters.py:121-169``).

    Index ``i`` is an event iff ``i >= window``, the ``window`` observations
    before ``i`` are not all equal and their population std is positive, and
    ``|y[i] - mean| > threshold * std`` over them. The series is centred on
    its mean first (z-scores do not move with a shift), and the window means
    and variances are differences of two float64 prefix sums (``cumsum``,
    kernel S by default).

    Whether a window is flat is decided exactly, from an int32 prefix sum of
    the places where ``y`` changes: a flat window never signals. The JAX
    function decides it from its variance alone, which the rounding of the
    prefix differences leaves positive on flat windows (every window of one
    observation, a run of equal prices), so it signals there (ROADMAP.md,
    Queue 3, R14).

    ``y`` is a 1-D tensor, or an array that goes to ``device``. Returns the
    events' int64 indices on the device of ``y``.
    """
    if not torch.is_tensor(y):
        y = torch.from_numpy(np.asarray(y, dtype=np.float64)).to(device)
    if window < 1:
        raise ValueError("window must be >= 1")
    if y.shape[0] < window + 2:
        raise ValueError("y must have at least window + 2 observations")
    y = y.to(torch.float64).contiguous()
    yc = y - y.mean()
    zero = yc.new_zeros(1)
    c = torch.cat([zero, cumsum(yc)])
    c2 = torch.cat([zero, cumsum(yc * yc)])
    changes = torch.cat([torch.zeros(1, dtype=torch.int32, device=y.device),
                         cumsum((y[1:] != y[:-1]).to(torch.int32))])
    i = torch.arange(yc.shape[0], device=yc.device)
    lo = torch.clamp(i - window, min=0)
    w = torch.tensor(float(window), dtype=torch.float64, device=yc.device)
    mean = (c[i] - c[lo]) / w
    var = torch.clamp((c2[i] - c2[lo]) / w - mean * mean, min=0.0)
    std = torch.sqrt(var)
    varies = changes[torch.clamp(i - 1, min=0)] > changes[lo]
    thr = torch.tensor(float(threshold), dtype=torch.float64, device=yc.device)
    mask = (i >= window) & varies & (std > 0.0) & (torch.abs(yc - mean) > thr * std)
    return torch.nonzero(mask).reshape(-1)
