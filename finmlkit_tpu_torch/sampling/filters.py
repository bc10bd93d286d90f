"""Event sampling filters: the symmetric CUSUM filter and the z-score peak
filter.

Counterpart of ``finmlkit_tpu/sampling/filters.py``. The JAX z-score filter's
``dtype=`` (a float32 fast path for the TPU) does not cross: the port's filter
works in float64.
"""
import struct

import numpy as np
import torch

from .. import _build
from ..ops.prefix_scan import fast_cumsum
from ..utils import trace

__all__ = ["cusum_filter", "z_score_peak_filter"]

WALKERS = 1024  # kernel Z's walkers: one block of threads (csrc/cusum_filter.cu)


@trace.span("cusum_filter")
def cusum_filter(raw_time_series: torch.Tensor, threshold) -> torch.Tensor:
    """Symmetric CUSUM event filter on log returns (AFML snippet 2.4).

    The JAX package's native loop (``filters.py:88-103``,
    ``native/seg_stats.cpp:137-150``) defines it: float64 log returns, strict
    threshold comparisons, ``s_neg`` checked before ``s_pos``, a NaN sum reset
    to 0, and only the triggered side resets. ``threshold`` is one value or
    one per sample: a float, a sequence, or a tensor.

    On a CUDA tensor this is one launch of kernel Z (``csrc/cusum_filter.cu``;
    :func:`_cusum_filter_walk_model` is its scheme on the CPU) and one read of
    the event count: its returns are an IEEE division and CUDA's ``log``,
    which may lie 1 ulp from numpy's, so an event could move only where a
    running sum lies within about 1e-18 of its threshold. A threshold that is
    not a CUDA tensor goes to the card without a read. On a CPU tensor it is
    the loop on the host, over numpy's log returns. Returns int64 event
    indices, ascending, on the device of ``raw_time_series``.
    """
    if raw_time_series.device.type == "cuda":
        return _filter_on_card(raw_time_series, threshold)
    x = trace.host_read(_to_host, raw_time_series.detach()).numpy()
    thr = np.asarray(trace.host_read(_to_host, threshold)
                     if torch.is_tensor(threshold) else threshold,
                     dtype=np.float64).reshape(-1)
    n = len(x)
    _check_lengths(n, len(thr))
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


def _check_lengths(n: int, n_thr: int) -> None:
    if n <= 1:
        raise ValueError("Input time series must have at least 2 elements.")
    if n_thr != 1 and n_thr != n:
        raise ValueError("Threshold array must either contain 1 const. element "
                         "or len(raw_time_series) elements.")


def _filter_on_card(raw_time_series, threshold):
    """:func:`cusum_filter` on a CUDA tensor: kernel Z, then one read of the
    event count and the rounds, which go to the counter
    ``cusum_filter.rounds`` (1 a call where every walk meets at once)."""
    x = raw_time_series.detach()
    if x.dim() != 1:
        raise ValueError("raw_time_series must be 1-D")
    dev = x.device
    on_card = torch.is_tensor(threshold) and threshold.device.type == "cuda"
    if on_card:
        h = threshold.detach().to(dev, torch.float64).reshape(-1)
        n_thr = h.numel()
    else:
        a = np.asarray(threshold.detach().numpy() if torch.is_tensor(threshold)
                       else threshold, dtype=np.float64).reshape(-1)
        n_thr = len(a)
    _check_lengths(x.shape[0], n_thr)
    if not on_card:
        # a fill kernel for one value; for one a value, a copy from pinned
        # memory, which does not wait for the card
        h = (torch.full((1,), float(a[0]), dtype=torch.float64, device=dev) if n_thr == 1
             else torch.from_numpy(a).pin_memory().to(dev, non_blocking=True))
    events, info, _ = _kernel(x.to(torch.float64), h)
    count, rounds = trace.host_read(torch.Tensor.tolist, info)
    trace.count("cusum_filter.rounds", rounds)
    return events[:count]


def _kernel(x, h):
    """One launch of kernel Z on the float64 series ``x`` (n >= 2) and the
    float64 thresholds ``h`` (one, or one a value) on its device; returns,
    unread, the events (capacity n - 1), ``[count, rounds]`` and the n - 1 log
    returns the kernel computed."""
    x, h = x.contiguous(), h.contiguous()
    n, dev = x.shape[0], x.device
    r = torch.empty(n - 1, dtype=torch.float64, device=dev)
    events = torch.empty(n - 1, dtype=torch.int64, device=dev)
    info = torch.empty(2, dtype=torch.int64, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fmk_cusum_filter(x.data_ptr(), h.data_ptr(), int(h.numel() > 1), n,
                                  r.data_ptr(), events.data_ptr(), info.data_ptr(), stream)
    _build.check(rc, "cusum_filter")
    trace.count("launch.Z")
    return events, info, r


def _step(s, r, h):
    """The filter's step from sums ``s = (s_pos, s_neg)`` on return ``r`` with
    threshold ``h``: the new sums, and whether it records an event."""
    sp, sn = s[0] + r, s[1] + r
    pos = sp if sp > 0.0 else 0.0
    neg = sn if sn < 0.0 else 0.0
    if neg < -h:
        return (pos, 0.0), True
    if pos > h:
        return (0.0, neg), True
    return (pos, neg), False


def _bits(s) -> bytes:
    return struct.pack("<2d", *s)


def _cusum_filter_walk_model(log_ret, thr, walkers: int = WALKERS):
    """Kernel Z's scheme on the CPU, in Python floats: ``log_ret`` the n - 1
    returns (return ``j`` is index ``j + 1``'s), ``thr`` one threshold or one
    a sample (n). Walker ``t`` owns returns ``[t L, (t + 1) L)``, ``L =
    ceil((n - 1) / walkers)``, and walks them from the guess (0, 0), counting
    its events. Then rounds: every walker with returns whose predecessor's
    end state (as the round began) differs bitwise from its entry walks again
    from it, in
    lockstep with its walk from the old entry, until the two states are
    bitwise equal (its end stands, its count moves by the prefixes'
    difference) or the chunk ends (its end changes); the rounds stop when no
    end changed. An exclusive scan of the counts, and a last walk from each
    true entry writes the events. Returns ``(events, rounds)``."""
    r = [float(v) for v in log_ret]
    h = np.asarray(thr, dtype=np.float64).reshape(-1).tolist()
    m = len(r)
    at = (lambda j: h[0]) if len(h) == 1 else (lambda j: h[j + 1])
    size = -(-m // walkers)
    spans = [(min(m, t * size), min(m, (t + 1) * size)) for t in range(walkers)]
    entry, end, count = [(0.0, 0.0)] * walkers, [], []
    for lo, hi in spans:
        s, c = (0.0, 0.0), 0
        for j in range(lo, hi):
            s, e = _step(s, r[j], at(j))
            c += e
        end.append(s)
        count.append(c)
    rounds = 0
    while True:
        rounds += 1
        ins = [(0.0, 0.0)] + end[:-1]
        changed = False
        for t, (lo, hi) in enumerate(spans):
            if lo == hi or _bits(ins[t]) == _bits(entry[t]):
                continue
            a, b, ca, cb, met = ins[t], entry[t], 0, 0, False
            for j in range(lo, hi):
                a, ea = _step(a, r[j], at(j))
                b, eb = _step(b, r[j], at(j))
                ca, cb = ca + ea, cb + eb
                if _bits(a) == _bits(b):
                    met = True
                    break
            count[t] += ca - cb
            entry[t] = ins[t]
            if not met:
                end[t] = a
                changed = True
        if not changed:
            break
    events = []
    for t, (lo, hi) in enumerate(spans):
        s = entry[t]
        for j in range(lo, hi):
            s, e = _step(s, r[j], at(j))
            if e:
                events.append(j + 1)
        assert len(events) == sum(count[:t + 1])
    return events, rounds


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
