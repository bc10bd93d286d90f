"""Per-bar products of the trade stream: kernel B (``csrc/bar_products.cu``).

Counterpart of ``finmlkit_tpu/ops/fused_scan.py``. Kernel B replaces the TPU
rowtail scans ``bar_scan_rowtails_v4`` (K1a) and ``bar_scan_rowtails`` (K1b,
v2), and absorbs the plane preparation and the boundary fixup that surround
them in ``finmlkit_tpu/bar/fused.py`` (``_prep_planes``, ``_boundary_state``).
It reads the trade arrays as they are (int32 ticks, int64 units, int8 sides,
int64 close indices) and writes, per bar, what ``_fused_packed_v2_jit``
returns:

- ``p64`` int64 (6, n_bars): vol_u, dollar_u, vol_buy_u, vol_sell_u,
  dol_buy_u, dol_sell_u;
- ``p32`` int32 (10, n_bars): open_raw, high_t, low_t, close_t, ticks_buy,
  ticks_sell, cum_spread_t, max_spread_t, ct_min, ct_max;
- ``pf`` float32 (4, n_bars): cv_min, cv_max, cd_min, cd_max.

Bar k holds trades ``(ci[k], ci[k+1]]``. An empty bar gets zero sums and
counts, sentinel extrema (``I32MIN``/``I32MAX``/``±F32BIG``) and the ticks at
the clamped positions ``ci[k]+1`` and ``ci[k+1]``; the JAX package leaves the
previous bar's extrema there instead, and the finals mask both.
"""
import torch

from .. import _build

__all__ = ["bar_scan_products", "bar_scan_products_plain", "pair_to_f32",
           "I32MIN", "I32MAX", "F32BIG"]

LAUNCHES = 0  # kernel launches by bar_scan_products in this process

I32MIN = -2147483648
I32MAX = 2147483647
F32BIG = 3.0e38


def pair_to_f32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> float32 rounded in two steps, ``hi * 2^32 + f32(lo)``, as the
    TPU kernel's ``_pair_to_f32`` (``finmlkit_tpu/bar/fused.py:249-257``)."""
    hi = (x >> 32).to(torch.int32).to(torch.float32)
    lo = (x & 0xFFFFFFFF).to(torch.int32)  # low word as signed int32
    lo_f = lo.to(torch.float32) + (lo < 0).to(torch.float32) * 4294967296.0
    return hi * 4294967296.0 + lo_f


def _check_inputs(ticks, units, sides, ci):
    want = ((ticks, torch.int32, "ticks"), (units, torch.int64, "units"),
            (sides, torch.int8, "sides"), (ci, torch.int64, "ci"))
    for t, dt, name in want:
        if t.dim() != 1 or t.dtype != dt:
            raise TypeError(f"{name} must be a 1-D {dt} tensor, got "
                            f"{t.dtype} of shape {tuple(t.shape)}")
        if t.device != ticks.device:
            raise ValueError(f"{name} is on {t.device}, ticks on {ticks.device}")
    n = ticks.shape[0]
    if units.shape[0] != n or sides.shape[0] != n:
        raise ValueError("ticks, units and sides must have the same length")
    if ci.shape[0] < 2 or n == 0:
        raise ValueError("need at least one trade and one bar (len(ci) >= 2)")


def bar_scan_products_plain(ticks, units, sides, ci):
    """Plain PyTorch version of :func:`bar_scan_products`, on any device.

    Sums are int64 prefix differences at the bar boundaries; extrema are
    ``scatter_reduce`` over the trade -> bar id; the in-bar running imbalances
    are global prefixes minus the prefix just before the bar's first trade.
    """
    _check_inputs(ticks, units, sides, ci)
    dev = ticks.device
    n, nb = ticks.shape[0], ci.shape[0] - 1
    i64 = torch.int64
    idx = torch.arange(n, device=dev)
    valid = (idx > ci[0]) & (idx <= ci[-1])
    # bar k holds (ci[k], ci[k+1]]: the first k with ci[k+1] >= i
    bar = torch.searchsorted(ci[1:].contiguous(), idx)
    bar = torch.where(valid, bar, nb)  # slot nb collects the outside trades
    bar_c = bar.clamp(max=nb - 1)
    starts = ci[:-1] + 1
    counts = ci[1:] - ci[:-1]
    zero64 = torch.zeros((), dtype=i64, device=dev)

    is_buy = valid & (sides == 1)
    is_sell = valid & (sides == -1)
    traded = valid & (sides != 0)
    u = torch.where(valid, units, zero64)
    d = ticks.to(i64) * u

    def prefix(v):
        return torch.cat([zero64.reshape(1), torch.cumsum(v, 0)])

    def bar_sum(v):
        p = prefix(v)
        return p[ci[1:] + 1] - p[starts]

    def in_bar_running(v):
        p = prefix(v)
        return p[1:] - p[starts[bar_c]]

    def bar_ext(v, init, how):
        out = torch.full((nb + 1,), init, dtype=v.dtype, device=dev)
        return out.scatter_reduce_(0, bar, v, how, include_self=True)[:nb]

    ub = torch.where(is_buy, u, zero64)
    us = torch.where(is_sell, u, zero64)
    db = torch.where(is_buy, d, zero64)
    ds = torch.where(is_sell, d, zero64)
    p64 = torch.stack([bar_sum(u), bar_sum(d), bar_sum(ub), bar_sum(us),
                       bar_sum(db), bar_sum(ds)])

    # tick-sign-change spread (bar/fused.py _prep_planes): the previous trade
    # wraps to trade n-1 and does not reset at bar starts; a single-trade
    # bar compares its side with 0
    single = valid & (counts == 1)[bar_c]
    change = torch.where(single, sides != 0, sides != torch.roll(sides, 1))
    zero32 = torch.zeros((), dtype=torch.int32, device=dev)
    spread = torch.where(valid & change, (ticks - torch.roll(ticks, 1)).abs(),
                         zero32)

    ct = in_bar_running(is_buy.to(i64) - is_sell.to(i64)).to(torch.int32)
    cv = pair_to_f32(in_bar_running(ub - us))
    cd = pair_to_f32(in_bar_running(db - ds))
    p32 = torch.stack([
        ticks[starts.clamp(0, n - 1)],
        bar_ext(ticks, I32MIN, "amax"),
        bar_ext(ticks, I32MAX, "amin"),
        ticks[ci[1:].clamp(0, n - 1)],
        bar_sum(is_buy.to(i64)).to(torch.int32),
        bar_sum(is_sell.to(i64)).to(torch.int32),
        bar_sum(spread.to(i64)).to(torch.int32),  # wraps mod 2^32 like the TPU
        bar_ext(spread, I32MIN, "amax"),
        bar_ext(torch.where(traded, ct, I32MAX), I32MAX, "amin"),
        bar_ext(torch.where(traded, ct, I32MIN), I32MIN, "amax"),
    ])
    pf = torch.stack([
        bar_ext(torch.where(traded, cv, F32BIG), F32BIG, "amin"),
        bar_ext(torch.where(traded, cv, -F32BIG), -F32BIG, "amax"),
        bar_ext(torch.where(traded, cd, F32BIG), F32BIG, "amin"),
        bar_ext(torch.where(traded, cd, -F32BIG), -F32BIG, "amax"),
    ])
    return p64, p32, pf


def bar_scan_products(ticks, units, sides, ci):
    """Per-bar products ``(p64, p32, pf)`` of the trade stream.

    On CUDA tensors this launches kernel B; on CPU tensors it runs
    :func:`bar_scan_products_plain`. ``ci`` must be sorted, with
    ``-1 <= ci[0]`` and ``ci[-1] < len(ticks)``.
    """
    global LAUNCHES
    _check_inputs(ticks, units, sides, ci)
    if ticks.device.type == "cpu":
        return bar_scan_products_plain(ticks, units, sides, ci)
    if ticks.device.type != "cuda":
        raise ValueError(f"bar_scan_products runs on cpu or cuda, not {ticks.device}")
    dev = ticks.device
    n, nb = ticks.shape[0], ci.shape[0] - 1
    if nb >= 2**31:
        raise ValueError(f"{nb} bars exceed the kernel's grid")
    ticks, units, sides, ci = (t.contiguous() for t in (ticks, units, sides, ci))
    ok = (ci[0] >= -1) & (ci[-1] < n) & torch.all(ci[1:] >= ci[:-1])
    if not bool(ok):
        raise ValueError("ci must be sorted with -1 <= ci[0] and ci[-1] < n")
    out64 = torch.empty((6, nb), dtype=torch.int64, device=dev)
    out32 = torch.empty((10, nb), dtype=torch.int32, device=dev)
    outf = torch.empty((4, nb), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fmk_bar_products(ticks.data_ptr(), units.data_ptr(),
                                  sides.data_ptr(), ci.data_ptr(), n, nb,
                                  out64.data_ptr(), out32.data_ptr(),
                                  outf.data_ptr(), stream)
    LAUNCHES += 1
    _build.check(rc, "bar_scan_products")
    return out64, out32, outf
