"""Volume-flow kernels: flow acceleration, VPIN, and the rolling and
developing volume profiles with ``VolumePro``.

Counterpart of ``finmlkit_tpu/feature/kernels/volume.py``. The volume profile
works on the dense footprints of ``bar/footprint_q.py`` (``low_level``,
``n_levels``, float32 ``(n_bars, L)`` buy and sell volumes). For each bar (or
each row of a given grid) it sums the footprints of the bar's trailing time
window onto one level grid of ``max_levels`` float64 volumes, may bucket that
grid into odd-width bins, and walks the value area out from the point of
control. Kernel G (``csrc/volume_profile.cu``) forms each profile a block on
its window's own level span and walks the value areas apart, a thread or a
warp a profile; :func:`volume_profile_rolling_plain` and
:func:`_profile_rows_plain` are its plain versions, batched PyTorch over the
bars of a call, with the value-area walk as a masked step over every bar until
all are done. Both add in the same order, so they agree bit for bit.

The semantics are the JAX package's, quirks included: bars before the first
full window are 0 (``VolumePro.compute`` turns them, and a real POC at level
0, into NaN); a window column past ``max_levels - 1`` lands on
``max_levels - 1``; the first of equal maxima is the POC; bin labels wrap in
int32 as ``jnp`` computes them. Where the JAX package works in float32 (the
developing grid and its cumulative sum, the returned ``pct``) the port works in
float64 (ROADMAP R5).
"""
import torch

from ... import _build
from ...utils import trace
from ._inputs import device_of, f64, i64, nan_like
from ._rolling import roll_max, roll_min, roll_sum, warmup_nan

__all__ = ["comp_flow_acceleration", "vpin", "volume_profile_rolling",
           "volume_profile_rolling_plain", "volume_profile_developing", "VolumePro"]

# kernel G's launches: launch.G in the trace registry (utils/trace.py)

_THREADS = 256               # kernel G's block: the partial sums' stride
_SCRATCH_BLOCKS_PER_SM = 4   # blocks of the global-grid path a streaming multiprocessor
_LISTED_BLOCKS_PER_SM = 8    # blocks of a launch over a list of profiles, a multiprocessor
_SPLIT_LEVELS = 6144         # kernel G's first rolling launch: spans up to this many levels
_WARP_WALKS_PER_SM = 64      # fewer profiles than this a multiprocessor: a warp walks each
_PLAIN_CELLS = 1 << 26       # the plain version's (bars, max_levels) grid per chunk
_I32_MIN, _I32_MAX = -2**31, 2**31 - 1


def comp_flow_acceleration(volumes, window: int, recent_periods: int, *,
                           device="cuda") -> torch.Tensor:
    """log(recent volume sum / past volume sum)."""
    volumes = f64(volumes, device_of(device, volumes))
    if volumes.shape[0] < window or recent_periods >= window:
        return nan_like(volumes)
    eps = 1e-12
    recent = roll_sum(volumes, recent_periods)
    past = roll_sum(volumes, window) - recent
    return warmup_nan(torch.log((recent + eps) / (past + eps)), window)


def vpin(volume_buy, volume_sell, window: int, *, device="cuda") -> torch.Tensor:
    """Rolling |buy - sell| / (buy + sell), NaN for a window that holds a NaN;
    float32, as the reference returns it."""
    dev = device_of(device, volume_buy, volume_sell)
    vb, vs = f64(volume_buy, dev), f64(volume_sell, dev)
    isnan = torch.isnan(vb) | torch.isnan(vs)
    buy = roll_sum(torch.where(isnan, 0.0, vb), window)
    sell = roll_sum(torch.where(isnan, 0.0, vs), window)
    imb = roll_sum(torch.where(isnan, 0.0, torch.abs(vb - vs)), window)
    nan_cnt = roll_sum(isnan.to(torch.float64), window)
    tot = buy + sell
    out = torch.where((nan_cnt == 0) & (tot > 1e-9), imb / tot, torch.nan)
    return warmup_nan(out, window).to(torch.float32)


# ---------------------------------------------------------------------------
# The volume profile
# ---------------------------------------------------------------------------

def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 (two's complement), as jnp's int32
    arithmetic wraps; kept in int64."""
    return torch.remainder(x + 2**31, 2**32) - 2**31


def _canonical_sum(v: torch.Tensor) -> torch.Tensor:
    """Row sums of ``(rows, M)`` in kernel G's order: partial ``t`` adds
    columns ``t, t + 256, ...`` left to right, then a tree halves the 256
    partials."""
    rows, m = v.shape
    acc = v.new_zeros(rows, _THREADS)
    for r0 in range(0, m, _THREADS):
        cnt = min(_THREADS, m - r0)
        acc[:, :cnt] = acc[:, :cnt] + v[:, r0:r0 + cnt]
    s = _THREADS
    while s > 1:
        s //= 2
        acc[:, :s] = acc[:, :s] + acc[:, s:2 * s]
    return acc[:, 0]


def _bucket_plain(grid, lo, n_bins: int):
    """``_bucket_profile`` (``volume.py:117-145``) of every row: binned volumes
    ``(rows, M)`` and their int32 level labels (as int64)."""
    rows, m = grid.shape
    k = torch.arange(m, device=grid.device)
    pos = grid > 0
    has = pos.any(1)
    kmin = torch.where(pos, k, m).amin(1)
    kmax = torch.where(pos, k, -1).amax(1)
    min_price = torch.where(has, _wrap32(lo + kmin), _I32_MAX)
    max_price = torch.where(has, _wrap32(lo + kmax), _I32_MIN)
    rng = _wrap32(max_price - min_price)
    bw = torch.div(rng, n_bins, rounding_mode="floor").clamp(min=1)
    bw = torch.where(bw % 2 == 0, _wrap32(bw + 1), bw)
    n_full = torch.div(_wrap32(rng + bw - 1), bw, rounding_mode="floor").clamp(min=1)
    # bin b adds its positive levels [kmin + b*bw, kmin + (b+1)*bw) in order
    k0 = torch.where(has, kmin, 0)[:, None] + k[None, :] * bw[:, None]
    k1 = torch.clamp(k0 + bw[:, None], max=m)
    bins = torch.zeros_like(grid)
    width = int(bw[has].max()) if bool(has.any()) else 0
    for e in range(width):
        kk = k0 + e
        v = grid.gather(1, kk.clamp(max=m - 1))
        bins = bins + torch.where((kk < k1) & has[:, None] & (v > 0), v, 0.0)
    edges = _wrap32(min_price[:, None] + _wrap32(k[None, :] * bw[:, None]))
    mid = _wrap32(edges + torch.div(bw - 1, 2, rounding_mode="floor")[:, None])
    labels = torch.where(k[None, :] < n_full[:, None], mid,
                         torch.where(k[None, :] == n_full[:, None], max_price[:, None], edges))
    return bins, labels


def _profile_rows_plain(grid, lo, n_bins, va_frac: float):
    """Plain version of kernel G's profile of each row of ``grid`` (float64
    ``(rows, M)``, level k of row r at ``lo[r] + k``; ``lo`` int64, one a row
    or one for all): ``(poc, hva, lva)`` int32 and ``pct`` float64."""
    rows, m = grid.shape
    dev = grid.device
    lo = torch.as_tensor(lo, dtype=torch.int64, device=dev).expand(rows)
    k = torch.arange(m, device=dev)
    if n_bins:
        vol, labels = _bucket_plain(grid, lo, int(n_bins))
    else:
        vol, labels = grid, _wrap32(lo[:, None] + k[None, :])
    total = _canonical_sum(vol)
    pidx = torch.argmax(vol, dim=1)
    poc = labels.gather(1, pidx[:, None])[:, 0]
    above = _canonical_sum(torch.where(labels > poc[:, None], vol, 0.0))
    pct = torch.where((total > 0) & (above > 0), above / total, 0.0)

    def at(i):
        return vol.gather(1, i.clamp(0, m - 1)[:, None])[:, 0]

    thr = total * va_frac
    cum = at(pidx)
    up, down, hv, lv = pidx + 1, pidx - 1, pidx.clone(), pidx.clone()
    active = cum < thr
    while bool(active.any()):
        cu = torch.where(up < m, at(up) + torch.where(up + 1 < m, at(up + 1), 0.0), -1.0)
        cd = torch.where(down >= 0, at(down) + torch.where(down - 1 >= 0, at(down - 1), 0.0),
                         -1.0)
        go_up, go_down = cu > cd, cu < cd
        both = (cu == cd) & (cu != -1.0)
        step = active & (go_up | go_down | both)
        cum = torch.where(step, cum + torch.where(go_up, cu, torch.where(go_down, cd, cu + cd)),
                          cum)
        u, d = step & (go_up | both), step & (go_down | both)
        hv = torch.where(u, torch.clamp(up + 1, max=m - 1), hv)
        up = torch.where(u, up + 2, up)
        lv = torch.where(d, torch.clamp(down - 1, min=0), lv)
        down = torch.where(d, down - 2, down)
        active = step & (cum < thr)
    out = [labels.gather(1, i[:, None])[:, 0].to(torch.int32) for i in (pidx, hv, lv)]
    return (*out, pct)


def _window_grid_plain(bars, start, low, nlev, buy, sell, m: int):
    """The ``(len(bars), m)`` float64 grid of each bar's window ``[start[i],
    i]`` and the windows' lowest levels, in kernel G's order: bar by bar, each
    column ``off + c`` adds ``buy + sell`` of column c; a column past ``m - 1``
    lands on ``m - 1`` in ascending column order."""
    dev = buy.device
    L = buy.shape[1]
    s = start[bars]
    span = bars - s
    depth = int(span.max()) + 1
    lo = low[bars].to(torch.int64)
    for d in range(depth):
        j = torch.where(s + d <= bars, s + d, bars)
        lo = torch.minimum(lo, low[j].to(torch.int64))
    grid = torch.zeros(bars.shape[0], m, dtype=torch.float64, device=dev)
    g = torch.arange(m, device=dev)
    flat_b, flat_s = buy.reshape(-1), sell.reshape(-1)

    def cells(j, c, ok):
        idx = j[:, None] * L + c.clamp(0, L - 1)
        v = flat_b[idx].to(torch.float64) + flat_s[idx].to(torch.float64)
        return torch.where(ok, v, 0.0)

    for d in range(depth):
        valid = s + d <= bars
        j = torch.where(valid, s + d, bars)
        off = low[j].to(torch.int64) - lo
        nl = nlev[j].to(torch.int64).clamp(0, L)
        c = g[None, :] - off[:, None]
        ok = valid[:, None] & (c >= 0) & (c < nl[:, None]) & (g[None, :] < m - 1)
        grid = grid + cells(j, c, ok)
        c0 = torch.clamp(m - 1 - off, min=0)
        cnt = torch.where(valid, torch.clamp(nl - c0, min=0), 0)
        for e in range(int(cnt.max())):
            grid[:, m - 1] = grid[:, m - 1] + cells(j, (c0 + e)[:, None],
                                                    (e < cnt)[:, None])[:, 0]
    return grid, lo


def volume_profile_rolling_plain(start, first: int, low, nlev, buy, sell, max_levels: int,
                                 n_bins, va_frac: float):
    """Plain version of kernel G's rolling mode, on any device: batched over
    chunks of bars. Arguments as :func:`_rolling`."""
    n = low.shape[0]
    dev = buy.device
    poc, hva, lva = (torch.zeros(n, dtype=torch.int32, device=dev) for _ in range(3))
    pct = torch.zeros(n, dtype=torch.float64, device=dev)
    chunk = max(1, _PLAIN_CELLS // max_levels)
    for b0 in range(first, n, chunk):
        bars = torch.arange(b0, min(b0 + chunk, n), device=dev)
        grid, lo = _window_grid_plain(bars, start, low, nlev, buy, sell, max_levels)
        out = _profile_rows_plain(grid, lo, n_bins, va_frac)
        for dst, src in zip((poc, hva, lva, pct), out):
            dst[b0:b0 + bars.shape[0]] = src
    return poc, hva, lva, pct


def _launch(lib, mode: str, args, first: int, n_out: int, m: int, dev, shared_cap, split,
            slots=None, walk_warp=None):
    """Kernel G over the profiles ``[first, n_out)`` of ``m`` levels (``args``
    the mode's leading C arguments); returns ``(poc, hva, lva, pct)``, zeros
    below ``first``. Kernel A forms each profile and leaves its pair volumes
    in a pool (profile o at the exclusive prefix sum of ``slots`` when given,
    else at ``o * (m // 2 + 1)``) and its walk record; kernel B walks every
    profile, a thread each, or a warp each where the profiles are fewer than
    ``_WARP_WALKS_PER_SM`` a multiprocessor (``walk_warp`` forces either).
    With ``split`` levels below ``m``, kernel A runs from small shared grids to
    the full one: the first launch takes the profiles whose span fits
    ``split`` levels (more blocks a multiprocessor) and lists the others for
    the next, whose grid is twice as large, and so on; the last takes what is
    left with the full grid. ``shared_cap`` caps every shared-memory grid
    (None: the device's room), so that a caller can force the global-scratch
    path."""
    if m >= 2**31:
        raise ValueError(f"max_levels {m} too large for kernel G")
    outs = [torch.zeros(n_out, dtype=torch.int32, device=dev) for _ in range(3)]
    outs.append(torch.zeros(n_out, dtype=torch.float64, device=dev))
    rows = n_out - first
    if rows <= 0:
        return tuple(outs)
    room = int(lib.fmk_profile_shared_levels())
    if shared_cap is not None:
        room = min(room, int(shared_cap))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = getattr(lib, f"fmk_volume_profile_{mode}")
    caps, cap = [], int(split or 0)
    while 0 < cap < m and cap <= room:
        caps.append(cap)
        cap *= 2
    walks = torch.empty(n_out * int(lib.fmk_profile_walk_bytes()), dtype=torch.uint8, device=dev)
    if slots is None:
        pool = torch.empty(n_out * (m // 2 + 1), dtype=torch.float64, device=dev)
        tail = (pool.data_ptr(), walks.data_ptr())
    else:
        ends = torch.cumsum(slots, 0)
        offsets = ends - slots
        pool = torch.empty(max(int(ends[-1]), 1), dtype=torch.float64, device=dev)
        tail = (pool.data_ptr(), offsets.data_ptr(), walks.data_ptr())
    poc, hva, lva, pct = outs
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        listed = None
        for cap in caps:
            defer = torch.zeros(rows + 1, dtype=torch.int64, device=dev)
            blocks = min(rows, 1 << 20) if listed is None else min(rows, _LISTED_BLOCKS_PER_SM * sms)
            rc = fn(*args, cap, 1, blocks, None, None if listed is None else listed.data_ptr(),
                    defer.data_ptr(), *tail, poc.data_ptr(), pct.data_ptr(), stream)
            _build.check(rc, f"kernel G ({mode}, spans up to {cap} levels)")
            trace.count("launch.G")
            listed = defer
        shared = m <= room
        if shared and listed is None:
            blocks = min(rows, 1 << 20)
        else:
            per_sm = _LISTED_BLOCKS_PER_SM if shared else _SCRATCH_BLOCKS_PER_SM
            blocks = min(rows, per_sm * sms)
        scratch = None if shared else torch.empty(max(blocks, 1) * m, dtype=torch.float64,
                                                  device=dev)
        rc = fn(*args, m, int(shared), blocks, None if scratch is None else scratch.data_ptr(),
                None if listed is None else listed.data_ptr(), None, *tail, poc.data_ptr(),
                pct.data_ptr(), stream)
        _build.check(rc, f"kernel G ({mode})")
        trace.count("launch.G")
        warp = rows < _WARP_WALKS_PER_SM * sms if walk_warp is None else bool(walk_warp)
        rc = lib.fmk_profile_walk(walks.data_ptr(), pool.data_ptr(), first, n_out, m, int(warp),
                                  hva.data_ptr(), lva.data_ptr(), stream)
        _build.check(rc, f"kernel G ({mode}, the walks)")
        trace.count("launch.G")
    return tuple(outs)


def _rolling(start, first: int, low, nlev, buy, sell, max_levels: int, n_bins,
             va_frac: float, shared_cap=None, split=_SPLIT_LEVELS, lib=None, walk_warp=None):
    """The rolling profile of bars ``[first, n)``, bar i's window ``[start[i],
    i]``: kernel G on CUDA tensors, :func:`volume_profile_rolling_plain` on
    CPU tensors. ``low``, ``nlev`` int32, ``buy``, ``sell`` float32 ``(n, L)``,
    ``start`` int64. Bars before ``first`` are 0. ``shared_cap``, ``split``
    and ``walk_warp`` as in :func:`_launch`; ``lib`` another build of the
    kernels (the package's by default)."""
    dev = buy.device
    if dev.type == "cpu":
        return volume_profile_rolling_plain(start, first, low, nlev, buy, sell, max_levels,
                                            n_bins, va_frac)
    if dev.type != "cuda":
        raise ValueError(f"the volume profile runs on cpu or cuda, not {dev}")
    lib = lib or _build.library()
    n, L = buy.shape
    start = start.contiguous()
    slots = torch.empty(n, dtype=torch.int64, device=dev)
    if first < n:
        with torch.cuda.device(dev):
            rc = lib.fmk_profile_slots(start.data_ptr(), low.data_ptr(), nlev.data_ptr(), L,
                                       first, n, max_levels, slots.data_ptr(),
                                       torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "kernel G (the pool's slots)")
        trace.count("launch.G")
    args = (start.data_ptr(), low.data_ptr(), nlev.data_ptr(), buy.data_ptr(),
            sell.data_ptr(), L, first, n, max_levels, int(n_bins or 0), float(va_frac))
    return _launch(lib, "rolling", args, first, n, max_levels, dev, shared_cap, split,
                   slots=slots, walk_warp=walk_warp)


def _profile_rows(grid, lo: int, n_bins, va_frac: float, shared_cap=None, split=None,
                  lib=None, walk_warp=None):
    """The profile of each row of ``grid`` (float64 ``(rows, M)``, level k at
    ``lo + k``): kernel G's rows mode on a CUDA tensor, :func:`_profile_rows_plain`
    on a CPU tensor. Returns ``(poc, hva, lva)`` int32 and ``pct``. A
    developing profile's rows span most of their grid, so ``split`` is off by
    default."""
    dev = grid.device
    if dev.type == "cpu":
        return _profile_rows_plain(grid, lo, n_bins, va_frac)
    if dev.type != "cuda":
        raise ValueError(f"the volume profile runs on cpu or cuda, not {dev}")
    grid = grid.to(torch.float64).contiguous()
    rows, m = grid.shape
    args = (grid.data_ptr(), int(lo), rows, m, int(n_bins or 0), float(va_frac))
    return _launch(lib or _build.library(), "rows", args, 0, rows, m, dev, shared_cap, split,
                   walk_warp=walk_warp)


def _footprint_tensors(ts, low_level, n_levels, buy_dense, sell_dense, device):
    dev = device_of(device, ts, low_level, n_levels, buy_dense, sell_dense)

    def t(x, dtype):
        x = x if torch.is_tensor(x) else torch.as_tensor(x)
        return x.to(device=dev, dtype=dtype).contiguous()

    ts = i64(ts, dev)
    low, nlev = t(low_level, torch.int32), t(n_levels, torch.int32)
    buy, sell = t(buy_dense, torch.float32), t(sell_dense, torch.float32)
    if buy.dim() != 2 or buy.shape != sell.shape or buy.shape[0] != low.shape[0] \
            or nlev.shape != low.shape or ts.shape != low.shape:
        raise ValueError("timestamps, low_level and n_levels must hold one value a bar, "
                         "and the buy and sell volumes one (n_bars, L) row a bar")
    return ts, low, nlev, buy, sell


def _rolling_sizes(ts, low, nlev, L: int, window_ns: int, max_levels):
    """Each bar's window start, the first bar with a full window, and
    ``max_levels`` (``volume.py:214-229``): the widest level span of any
    ``max_window_bars`` consecutive bars, at least ``L``. The window extrema
    are ``roll_max``/``roll_min`` on the device; two small reads give the
    sizes."""
    n = ts.shape[0]
    start = torch.searchsorted(ts, ts - window_ns)
    first_t = torch.searchsorted(ts, ts[:1] + window_ns)
    w_t = (torch.arange(n, device=ts.device) - start + 1).max()
    first, w = (int(v) for v in torch.stack([first_t[0], w_t]).cpu())
    if max_levels is None:
        lo = low.to(torch.float64)
        span = roll_max(lo + nlev.to(torch.float64), w) - roll_min(lo, w)
        max_levels = max(int(span.max()), L)
    return start, first, int(max_levels)


def volume_profile_rolling(ts, low_level, n_levels, buy_dense, sell_dense,
                           window_size_sec, n_bins=None, va_pct: float = 68.34,
                           max_levels: int | None = None, *, device="cuda"):
    """Rolling POC, HVA, LVA (int32 levels) and the share of volume above the
    POC (float64) of each bar's trailing window of ``window_size_sec``
    seconds over dense footprints (``volume.py:201-233``): bars ``[j : ts[j]
    >= ts[i] - window]`` up to i. Bars before the first full window are 0.
    ``n_bins`` buckets each window's grid into about that many odd-width bins.
    Kernel G on the card; the plain version on the CPU."""
    ts, low, nlev, buy, sell = _footprint_tensors(ts, low_level, n_levels, buy_dense,
                                                  sell_dense, device)
    n = ts.shape[0]
    if n == 0:
        z = torch.zeros(0, dtype=torch.int32, device=ts.device)
        return z, z.clone(), z.clone(), torch.zeros(0, dtype=torch.float64, device=ts.device)
    start, first, m = _rolling_sizes(ts, low, nlev, buy.shape[1],
                                     int(window_size_sec * 1e9), max_levels)
    return _rolling(start, first, low, nlev, buy, sell, m, n_bins, va_pct / 100.0)


def _developing_grid(low, nlev, buy, sell):
    """The developing profile's float64 grid (``volume.py:319-337``): each
    bar's ``buy + sell`` on the range's level grid, summed over the bars so
    far (``torch.cumsum`` along the bars). Returns ``(grid, lowest level)``."""
    lo = low.to(torch.int64)
    g_lo, g_hi = (int(v) for v in torch.stack([lo.min(), (lo + nlev).max() - 1]).cpu())
    nb, L = buy.shape
    grid = torch.zeros(nb, g_hi - g_lo + 1, dtype=torch.float64, device=buy.device)
    cols = torch.arange(L, device=buy.device)[None, :]
    mask = cols < nlev[:, None]
    rows = torch.arange(nb, device=buy.device)[:, None].expand(nb, L)
    grid[rows[mask], (lo[:, None] - g_lo + cols)[mask]] = \
        (buy.to(torch.float64) + sell.to(torch.float64))[mask]
    return torch.cumsum(grid, 0), g_lo


def volume_profile_developing(ts, low_level, n_levels, buy_dense, sell_dense,
                              start_ts: int, end_ts: int, n_bins=None,
                              va_pct: float = 68.34, *, device="cuda"):
    """Developing (cumulative) volume profile between two int64 ns timestamps
    (``volume.py:302-349``): POC, HVA and LVA (int32 levels) after each bar of
    ``[start_ts, end_ts]``, as footprints accumulate on one grid over the
    range. Returns ``(timestamps, poc, hva, lva)``. The grid and its sums are
    float64 (the JAX package's are float32)."""
    ts, low, nlev, buy, sell = _footprint_tensors(ts, low_level, n_levels, buy_dense,
                                                  sell_dense, device)
    bounds = torch.tensor([int(start_ts), int(end_ts)], dtype=torch.int64, device=ts.device)
    s = torch.searchsorted(ts, bounds[:1])
    e = torch.searchsorted(ts, bounds[1:], right=True)
    s, e = (int(v) for v in torch.cat([s, e]).cpu())
    if e <= s:
        z = torch.zeros(0, dtype=torch.int32, device=ts.device)
        return ts[0:0], z, z.clone(), z.clone()
    grid, g_lo = _developing_grid(low[s:e], nlev[s:e], buy[s:e], sell[s:e])
    poc, hva, lva, _ = _profile_rows(grid, g_lo, n_bins, va_pct / 100.0)
    return ts[s:e], poc, hva, lva


class VolumePro:
    """Rolling volume-profile calculator over the port's footprint dict
    (``bar/kit.py build_footprints``: ``timestamp``, ``low_level``,
    ``n_levels``, ``buy_volumes``, ``sell_volumes``); counterpart of
    ``volume.py:236-299``. ``window_size`` in seconds or a ``timedelta``."""

    def __init__(self, window_size, n_bins: int = 27, va_pct: float = 68.34):
        seconds = getattr(window_size, "total_seconds", None)
        self.window_size_sec = seconds() if seconds else float(window_size)
        self.n_bins = n_bins
        self.va_pct = va_pct

    def reset_parameters(self, window_size_sec=None, n_bins=None, va_pct=None):
        if window_size_sec is not None:
            self.window_size_sec = window_size_sec
        if n_bins is not None:
            self.n_bins = n_bins
        if va_pct is not None:
            self.va_pct = va_pct

    def compute(self, fp: dict, price_tick: float, *, device="cuda"):
        """POC, HVA and LVA prices (level times ``price_tick``, the footprint
        grid's tick) and the share of volume above the POC, per bar, as float64
        tensors; the warm-up bars (and a POC at level 0) are NaN."""
        poc, hva, lva, pct = volume_profile_rolling(
            fp["timestamp"], fp["low_level"], fp["n_levels"], fp["buy_volumes"],
            fp["sell_volumes"], window_size_sec=self.window_size_sec, n_bins=self.n_bins,
            va_pct=self.va_pct, device=device)
        prices = []
        for v in (poc, hva, lva):
            p = v.to(torch.float64) * price_tick
            prices.append(torch.where(p == 0, torch.nan, p))
        return (*prices, pct)

    def compute_range(self, fp: dict, price_tick: float, start: int, end: int, *,
                      device="cuda"):
        """The rolling profile of the bars in ``[start - window, end]`` (int64
        ns; the JAX package takes pandas timestamps), the window's warm-up
        included (``volume.py:286-299``). Returns ``(timestamps, poc, hva, lva,
        pct)``."""
        ts = i64(fp["timestamp"], device_of(device, fp["timestamp"]))
        lo_ts = int(start) - round(self.window_size_sec * 1e9)
        bounds = torch.tensor([lo_ts, int(end)], dtype=torch.int64, device=ts.device)
        s, e = (int(v) for v in torch.cat([torch.searchsorted(ts, bounds[:1]),
                                           torch.searchsorted(ts, bounds[1:], right=True)]).cpu())
        keys = ("low_level", "n_levels", "buy_volumes", "sell_volumes")
        sub = {"timestamp": ts[s:e], **{k: fp[k][s:e] for k in keys}}
        return (ts[s:e], *self.compute(sub, price_tick, device=device))
