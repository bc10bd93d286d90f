"""Bar products: OHLCV, VWAP, trade counts, median trade size and the
directional features of every bar, in one call.

Counterpart of ``bar_products_final_device`` in ``finmlkit_tpu/bar/fused.py``,
with the same ``(ohlcv, directional)`` dictionaries, as tensors on the device
of the trades. Its stages:

1. the bar scan (``scan``) reads the trades and writes the per-bar integer
   and float32 products: kernel B (``ops.fused_scan.bar_scan_products``) by
   default, or :func:`planes_products`, the full running state of every
   trade (kernel V) gathered at the bar boundaries, as the JAX
   package's ``scan="planes"`` (``fused_packed_device``);
2. a median engine (``medians``) gives the two middle trade sizes of every
   bar: ``"sort"`` (:func:`median_pairs`: bar ids from kernel S over the
   bar-open marks, one ``torch.sort`` of the composite key ``(bar_id << 32)
   | sortable_bits(amount)``, two closed-form gathers; ``ops/segment.py``),
   ``"hist"`` (``ops/segment_hist.py``, kernel H), ``"select"``
   (``ops/segment_select.py``, kernel F's int32 fill) or ``"host"`` (the
   threaded ``nth_element`` of ``native/``, on the host);
3. :func:`bar_finals` converts to float64 and float32 units over the n_bars
   values, in the expression order of ``_fused_packed_final_jit`` and
   ``_assemble_final`` (``finmlkit_tpu/bar/fused.py:526-637``), so the finals
   are bit-identical to the JAX package's, whatever the scan and the engine.

There are no packed readback buffers and no row widths: the TPU needed them,
this device does not.
"""
from functools import partial

import torch

from ..ops import fused_scan, prefix_scan, segment_hist
from ..ops.fused_scan import F32BIG, I32MAX, I32MIN, bar_scan_products
from ..ops.prefix_scan import fast_cumsum
from ..ops.segment import (bar_ids_from_close_indices, segment_median_pair,
                           sorted_segments)
from ..ops.segment_select import segment_median_pair_select
from ..utils import trace

__all__ = ["bar_products_final", "median_pairs", "bar_finals", "median_engine",
           "median_sort_device", "median_rowsort_device", "median_select_device",
           "median_hist_device", "median_host", "gather_planes", "planes_products",
           "planes_products_plain", "MEDIAN_ENGINES", "bar_scan", "SCANS"]

def median_pairs(amounts_f32: torch.Tensor, ci: torch.Tensor, *,
                 cumsum=fast_cumsum):
    """Per-bar ``np.median`` brackets ``(med_a, med_b)`` (float32).

    The median of bar k is ``(f64(med_a) + f64(med_b)) / 2``. Empty bars get
    a value from a clamped position, which callers mask. ``cumsum`` computes
    the bar ids; it defaults to kernel S.
    """
    if amounts_f32.dtype != torch.float32 or amounts_f32.dim() != 1:
        raise TypeError("amounts_f32 must be a 1-D float32 tensor")
    n, nb = amounts_f32.shape[0], ci.shape[0] - 1
    bar_id, valid = bar_ids_from_close_indices(ci, n, cumsum=cumsum)
    svals = sorted_segments(amounts_f32, bar_id, valid, nb)
    return segment_median_pair(svals, ci[:-1] - ci[0], ci[1:] - ci[:-1])


def bar_finals(p64, p32, pf, med, ci, tick_size: float, amount_scale: float):
    """Finals from the kernel-B products and the median brackets.

    Same operations, in the same order, as ``_fused_packed_final_jit`` plus
    ``_assemble_final``. Empty bars take the close as OHLC and zero volume,
    VWAP and median, and the 1e9 sentinels for the imbalance extrema.
    """
    f64, f32 = torch.float64, torch.float32
    ts, asc = float(tick_size), float(amount_scale)
    vol_u, dollar_u, vol_buy_u, vol_sell_u, dol_buy_u, dol_sell_u = p64
    (open_raw, high_t, low_t, close_t, ticks_buy, ticks_sell,
     cum_spread_t, max_spread_t, ct_min, ct_max) = p32
    cv_min, cv_max, cd_min, cd_max = pf
    med_a, med_b = med
    counts = ci[1:] - ci[:-1]
    empty = counts == 0

    def where0(cond, x):
        return torch.where(cond, torch.zeros_like(x), x)

    open_t = torch.where(empty, close_t, open_raw)
    high = torch.where(empty, close_t, high_t)
    low = torch.where(empty, close_t, low_t)

    total_ticks = ticks_buy.to(torch.int64) + ticks_sell.to(torch.int64)
    mean_spread = (cum_spread_t.to(f64) * ts / total_ticks.to(f64)).to(f32)

    def minmax_f32(mn, mx, factor):
        big = F32BIG / 2
        mn64, mx64 = mn.to(f64), mx.to(f64)
        mnf = torch.where(empty | (mn64 >= big), torch.full_like(mn64, 1e9),
                          torch.clamp(mn64 * factor, max=1e9))
        mxf = torch.where(empty | (mx64 <= -big), torch.full_like(mx64, -1e9),
                          torch.clamp(mx64 * factor, min=-1e9))
        return mnf.to(f32), mxf.to(f32)

    cv_min_o, cv_max_o = minmax_f32(cv_min, cv_max, asc)
    cd_min_o, cd_max_o = minmax_f32(cd_min, cd_max, asc * ts)
    ct_min_o = torch.where(empty | (ct_min == I32MAX),
                           torch.full_like(ct_min, 10**9),
                           torch.clamp(ct_min, max=10**9))
    ct_max_o = torch.where(empty | (ct_max == I32MIN),
                           torch.full_like(ct_max, -(10**9)),
                           torch.clamp(ct_max, min=-(10**9)))
    msp = where0(empty, max_spread_t)
    max_spread_f = (torch.clamp(msp, min=0).to(f64) * ts).to(f32)

    median = (med_a.to(f64) + med_b.to(f64)) * 0.5
    vol = vol_u.to(f64) * asc
    pos = vol_u > 0
    vwap = torch.where(
        pos, dollar_u.to(f64) / torch.where(pos, vol_u, torch.ones_like(vol_u)).to(f64) * ts,
        torch.zeros_like(vol))
    ohlcv = {
        "open": open_t.to(f64) * ts,
        "high": high.to(f64) * ts,
        "low": low.to(f64) * ts,
        "close": close_t.to(f64) * ts,
        "volume": where0(empty, vol).to(f32),
        "vwap": where0(empty, vwap),
        "trades": counts,
        "median_trade_size": where0(empty, median),
    }
    directional = {
        "ticks_buy": ticks_buy.to(torch.int64),
        "ticks_sell": ticks_sell.to(torch.int64),
        "volume_buy": (vol_buy_u.to(f64) * asc).to(f32),
        "volume_sell": (vol_sell_u.to(f64) * asc).to(f32),
        "dollars_buy": (dol_buy_u.to(f64) * asc * ts).to(f32),
        "dollars_sell": (dol_sell_u.to(f64) * asc * ts).to(f32),
        "mean_spread": mean_spread,
        "max_spread": max_spread_f,
        "cum_ticks_min": ct_min_o.to(torch.int64),
        "cum_ticks_max": ct_max_o.to(torch.int64),
        "cum_volume_min": cv_min_o,
        "cum_volume_max": cv_max_o,
        "cum_dollars_min": cd_min_o,
        "cum_dollars_max": cd_max_o,
    }
    return ohlcv, directional


def median_sort_device(amounts_f32, ci, *, plain=False):
    """The one-sort engine (:func:`median_pairs`): kernel S for the bar ids,
    or its plain version with ``plain=True``."""
    return median_pairs(amounts_f32, ci, cumsum=prefix_scan.fast_cumsum_plain
                        if plain else fast_cumsum)


def median_rowsort_device(amounts_f32, ci, *, plain=False):
    """The JAX package's default engine sorts independent rows of the trades
    with an adaptive width, a workaround for the TPU's comparator-network
    sort, and gives the same brackets as one flat sort. Here it is the
    one-sort engine, :func:`median_sort_device`."""
    return median_sort_device(amounts_f32, ci, plain=plain)


def median_hist_device(amounts_f32, ci, *, plain=False):
    """The histogram-select engine (``ops/segment_hist.py``): kernel H, or
    its plain versions with ``plain=True``. Exact for nonnegative amounts."""
    if plain:
        return segment_hist.segment_median_pair_hist(
            amounts_f32, ci, hist=segment_hist.hist_pass_plain,
            less=segment_hist.less_pass_plain)
    return segment_hist.segment_median_pair_hist(amounts_f32, ci)


def median_select_device(amounts_f32, ci, *, plain=False):
    """The radix-select engine (``ops/segment_select.py``): kernel F's int32
    fill and kernel S, or their plain versions with ``plain=True``. Exact for
    nonnegative amounts."""
    if plain:
        return segment_median_pair_select(amounts_f32, ci,
                                          fill=prefix_scan.fill_last_plain,
                                          cumsum=prefix_scan.fast_cumsum_plain)
    return segment_median_pair_select(amounts_f32, ci)


def median_host(amounts_f32, ci, *, plain=False):
    """The host engine (``native.seg_median_pair``, C++ built by ``g++``): the
    amounts and ``ci`` copied to the host, one ``nth_element`` a bar on its
    threads, the pair copied back to the amounts' device. It gives the sort
    engine's brackets on non-empty bars of non-NaN amounts, and 0 on empty
    bars. It has no plain version: ``plain`` changes nothing."""
    from .. import native
    med_a, med_b = native.seg_median_pair(amounts_f32.cpu().numpy(), ci.cpu().numpy())
    dev = amounts_f32.device
    return torch.from_numpy(med_a).to(dev), torch.from_numpy(med_b).to(dev)


_ENGINES = {"sort": median_sort_device, "rowsort": median_rowsort_device,
            "hist": median_hist_device, "select": median_select_device,
            "host": median_host}
MEDIAN_ENGINES = tuple(_ENGINES)


def median_engine(name: str, *, plain: bool = False):
    """The median engine called ``name``, as a function ``(amounts_f32, ci)
    -> (med_a, med_b)``: ``"sort"`` (the default; exact for any float),
    ``"rowsort"`` (the same sort), ``"hist"`` or ``"select"`` (exact for
    nonnegative amounts), or ``"host"`` (:func:`median_host`, exact for
    non-NaN amounts). ``plain=True`` runs the engine's plain versions. Any
    other name raises."""
    if name not in _ENGINES:
        raise ValueError(f"unknown median engine {name!r}; choose one of "
                         f"{MEDIAN_ENGINES}")
    return partial(_ENGINES[name], plain=plain)


def gather_planes(planes, ticks, ci):
    """Per-bar products ``(p64, p32, pf)``, in kernel B's layout, from the
    running state of every trade (:func:`ops.fused_scan.bar_scan_planes`):
    prefix differences at the bar boundaries and the running extrema at each
    bar's last trade. Counterpart of ``_gather_post``
    (``finmlkit_tpu/bar/fused.py:99-154``).

    An empty bar gathers the running extrema of the trade before it, as the
    JAX package does (kernel B writes sentinels there); the finals mask both.
    Its sums are 0: a prefix at close index -1 counts as 0, where the JAX
    gather clamps it to trade 0.
    """
    pre64, pre32, ext32, extf = planes
    n = ticks.shape[0]
    a, e = ci[:-1], ci[1:]
    ec = e.clamp(0, n - 1)

    def at(p, pos):
        return torch.where(pos >= 0, p[:, pos.clamp(0, n - 1)],
                           torch.zeros((), dtype=p.dtype, device=p.device))

    s64 = at(pre64, e) - at(pre64, a)     # bu, su, bd, sd, tu, td
    s32 = at(pre32, e) - at(pre32, a)     # tb, ts, sp (int32, wrapping)
    x32 = ext32[:, ec]                    # high, low, spmax, ctmin, ctmax
    p64 = s64[[4, 5, 0, 1, 2, 3]]
    p32 = torch.stack([ticks[(a + 1).clamp(0, n - 1)], x32[0], x32[1],
                       ticks[ec], s32[0], s32[1], s32[2], x32[2], x32[3],
                       x32[4]])
    return p64, p32, extf[:, ec]


def planes_products(ticks, units, sides, ci):
    """Per-bar products through the full planes (kernel V on CUDA
    tensors), with :func:`bar_scan_products`'s signature and layout: the
    ``scan`` of :func:`bar_products_final` that the kits call ``"planes"``."""
    return gather_planes(fused_scan.bar_scan_planes(ticks, units, sides, ci),
                         ticks, ci)


def planes_products_plain(ticks, units, sides, ci):
    """:func:`planes_products` through the plain planes, on any device."""
    return gather_planes(fused_scan.bar_scan_planes_plain(ticks, units, sides, ci),
                         ticks, ci)


_ROWTAIL = (bar_scan_products, fused_scan.bar_scan_products_plain)
_SCANS = {"rowtail": _ROWTAIL, "rowtail4": _ROWTAIL,
          "planes": (planes_products, planes_products_plain)}
SCANS = tuple(_SCANS)


def bar_scan(name: str, *, plain: bool = False):
    """The bar scan called ``name``, a function ``(ticks, units, sides, ci)
    -> (p64, p32, pf)``: "rowtail" (the default) or "rowtail4" (both kernel
    B, as the JAX package's two rowtail kernels compute one function) or
    "planes" (:func:`planes_products`, kernel V). ``plain=True`` gives its
    plain version. Any other name raises."""
    if name not in _SCANS:
        raise ValueError(f"unknown bar scan {name!r}; choose one of {SCANS}")
    return _SCANS[name][plain]


@trace.span("bar_products_final")
def bar_products_final(ticks, units, ci, sides, *, tick_size, amount_scale,
                       amounts_f32, scan=bar_scan_products, medians="sort"):
    """OHLCV + directional features of every bar, as two dicts of tensors.

    ``ticks`` int32, ``units`` int64, ``sides`` int8 and ``amounts_f32``
    float32 are per trade; ``ci`` int64 holds the close indices (bar k spans
    trades ``(ci[k], ci[k+1]]``). ``scan`` computes the per-bar products:
    kernel B by default, :func:`planes_products` for the full planes, or
    either's plain version. ``medians`` is an engine function ``(amounts_f32,
    ci) -> (med_a, med_b)``, such as ``median_engine(name, plain=True)``, or
    the name of an engine's kernel path (:func:`median_engine`). On CPU
    tensors every kernel entry point runs its plain version; passing the
    plain versions runs the plain path on any device. Trades on no tick grid
    (the float form of ``interop``, ``ticks`` None) take ``bar/aggregate.py``
    instead; here they raise.
    """
    if ticks is None or units is None:
        raise ValueError("bar_products_final takes integer ticks and units; trades "
                         "on no tick grid take bar/aggregate.py")
    p64, p32, pf = scan(ticks, units, sides, ci)
    engine = median_engine(medians) if isinstance(medians, str) else medians
    return bar_finals(p64, p32, pf, engine(amounts_f32, ci), ci, tick_size,
                      amount_scale)
