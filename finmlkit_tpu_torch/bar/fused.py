"""Bar products: OHLCV, VWAP, trade counts, median trade size and the
directional features of every bar, in one call.

Counterpart of ``bar_products_final_device`` in ``finmlkit_tpu/bar/fused.py``,
with the same ``(ohlcv, directional)`` dictionaries, as tensors on the device
of the trades. Its stages:

1. kernel B (``ops.fused_scan.bar_scan_products``) reads the trades and writes
   the per-bar integer and float32 products;
2. :func:`median_pairs` gives the two middle trade sizes of every bar: bar ids
   from kernel S over the bar-open marks, one ``torch.sort`` of the composite
   key ``(bar_id << 32) | sortable_bits(amount)``, and two closed-form gathers
   (``ops/segment.py``);
3. :func:`bar_finals` converts to float64 and float32 units over the n_bars
   values, in the expression order of ``_fused_packed_final_jit`` and
   ``_assemble_final`` (``finmlkit_tpu/bar/fused.py:526-637``), so the finals
   are bit-identical to the JAX package's.

There are no ``(rows, 128)`` planes, no packed readback buffers and no row
widths: the TPU needed them, this device does not.
"""
import torch

from ..ops.fused_scan import F32BIG, I32MAX, I32MIN, bar_scan_products
from ..ops.prefix_scan import fast_cumsum
from ..ops.segment import (bar_ids_from_close_indices, segment_median_pair,
                           sorted_segments)

__all__ = ["bar_products_final", "median_pairs", "bar_finals"]


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


def bar_products_final(ticks, units, ci, sides, *, tick_size, amount_scale,
                       amounts_f32, scan=bar_scan_products, cumsum=fast_cumsum):
    """OHLCV + directional features of every bar, as two dicts of tensors.

    ``ticks`` int32, ``units`` int64, ``sides`` int8 and ``amounts_f32``
    float32 are per trade; ``ci`` int64 holds the close indices (bar k spans
    trades ``(ci[k], ci[k+1]]``). ``scan`` and ``cumsum`` are the two kernel
    entry points; they default to kernels B and S (their plain versions on
    CPU tensors), and passing ``bar_scan_products_plain`` and
    ``fast_cumsum_plain`` runs the plain path on any device.
    """
    p64, p32, pf = scan(ticks, units, sides, ci)
    med = median_pairs(amounts_f32, ci, cumsum=cumsum)
    return bar_finals(p64, p32, pf, med, ci, tick_size, amount_scale)
