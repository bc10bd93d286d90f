"""Reference bar products: OHLCV, VWAP, trade counts, median trade size and
the directional features of every bar of ``r.out["ci"]``.

Each is its definition over the bar's trades: prices are ticks times the
tick; volumes and dollars are exact integer sums of units (and ticks times
units), scaled once; the median is ``np.median`` of the float32 amounts. The
directional columns: buy and sell counts, volumes and dollars; the tick
spread at each side change (the previous trade is the one before in the
stream, wrapping from trade 0 to the last, a single-trade bar comparing its
side with none), its in-bar mean over the buys and sells and its maximum;
the extrema of the running in-bar tick, volume and dollar imbalances over
trades with a side, the volume and dollar ones rounded to float32 in steps
(``refbase.pair_to_f32``) and held within +-1e9 (+-1e9 where a bar has
none). An empty bar takes its close index's price as OHLC and zero volume,
VWAP, median and maximum spread.
"""
import torch

from refbase import bars_of, pair_to_f32, seg_ext, seg_sum, sorted_in_bars

I64MAX, I64MIN = 2**63 - 1, -2**63
BIG = 1e9


def run(r, p):
    pr, f, i64 = r.prec, r.prec.f, torch.int64
    ci, n = r.out["ci"], r.n
    nb = ci.shape[0] - 1
    first, counts, bar = bars_of(ci)
    sl = slice(first, first + bar.shape[0])
    tk, u, sd, amt = r.ticks[sl], r.units[sl], r.side[sl], r.amount[sl]
    empty = counts == 0
    zero = torch.zeros((), dtype=f, device=r.device)

    close_t = r.ticks[ci[1:].clamp(0, n - 1)]
    open_t = torch.where(empty, close_t, r.ticks[(ci[:-1] + 1).clamp(0, n - 1)])
    high_t = torch.where(empty, close_t, seg_ext(tk, bar, nb, "amax", I64MIN))
    low_t = torch.where(empty, close_t, seg_ext(tk, bar, nb, "amin", I64MAX))

    def price(t):
        return pr.out64(t.to(f) * r.tick)

    vol_u = seg_sum(u, bar, nb)
    dol_u = seg_sum(tk * u, bar, nb)
    pos = vol_u > 0
    vwap = torch.where(pos, dol_u.to(f) / torch.where(pos, vol_u, 1).to(f) * r.tick, zero)

    s = sorted_in_bars(amt, bar)
    off = ci[:-1] - ci[0]
    m = max(s.shape[0] - 1, 0)
    lo = (off + (counts - 1).clamp(min=0) // 2).clamp(0, m)
    hi = (off + counts.clamp(min=1) // 2).clamp(0, m)
    if s.shape[0]:
        med = (s[lo].to(f) + s[hi].to(f)) / 2
    else:
        med = torch.zeros(nb, dtype=f, device=r.device)

    ohlcv = {
        "open": price(open_t), "high": price(high_t), "low": price(low_t),
        "close": price(close_t),
        "volume": pr.out32(torch.where(empty, zero, vol_u.to(f) * r.unit)),
        "vwap": pr.out64(torch.where(empty, zero, vwap)),
        "trades": counts,
        "median_trade_size": pr.out64(torch.where(empty, zero, med)),
    }

    buy, sell = (sd == 1).to(i64), (sd == -1).to(i64)
    idx = torch.arange(sl.start, sl.stop, device=r.device)
    prev = (idx - 1) % n
    single = counts[bar] == 1
    change = torch.where(single, sd != 0, sd != r.side[prev])
    spread = torch.where(change, (tk - r.ticks[prev]).abs(), 0)
    n_bs = seg_sum(buy + sell, bar, nb)

    def scaled(x, factor):
        return pr.out32(x.to(f) * factor)

    traded = sd != 0
    has_side = seg_sum(traded.to(i64), bar, nb) > 0

    def running_ext(v):
        cs = torch.cumsum(v, 0)
        start = torch.cat([torch.zeros(1, dtype=i64, device=r.device), cs])[off]
        run_v = cs - start[bar]
        mn = seg_ext(torch.where(traded, run_v, I64MAX), bar, nb, "amin", I64MAX)
        mx = seg_ext(torch.where(traded, run_v, I64MIN), bar, nb, "amax", I64MIN)
        return mn, mx

    none = empty | ~has_side
    ct_min, ct_max = running_ext(buy - sell)

    def ext_f32(v, factor):
        mn, mx = running_ext(v)
        mn = torch.clamp(pair_to_f32(mn).to(f) * factor, max=BIG)
        mx = torch.clamp(pair_to_f32(mx).to(f) * factor, min=-BIG)
        return (pr.out32(torch.where(none, torch.full_like(mn, BIG), mn)),
                pr.out32(torch.where(none, torch.full_like(mx, -BIG), mx)))

    cv_min, cv_max = ext_f32(u * (buy - sell), r.unit)
    cd_min, cd_max = ext_f32(tk * u * (buy - sell), r.unit * r.tick)
    max_spread = torch.where(empty, 0, seg_ext(spread, bar, nb, "amax", I64MIN)).clamp(min=0)
    directional = {
        "ticks_buy": seg_sum(buy, bar, nb),
        "ticks_sell": seg_sum(sell, bar, nb),
        "volume_buy": scaled(seg_sum(u * buy, bar, nb), r.unit),
        "volume_sell": scaled(seg_sum(u * sell, bar, nb), r.unit),
        "dollars_buy": pr.out32(seg_sum(tk * u * buy, bar, nb).to(f) * r.unit * r.tick),
        "dollars_sell": pr.out32(seg_sum(tk * u * sell, bar, nb).to(f) * r.unit * r.tick),
        "mean_spread": pr.out32(seg_sum(spread, bar, nb).to(f) * r.tick / n_bs.to(f)),
        "max_spread": scaled(max_spread, r.tick),
        "cum_ticks_min": torch.where(none, int(BIG), ct_min.clamp(max=int(BIG))),
        "cum_ticks_max": torch.where(none, -int(BIG), ct_max.clamp(min=-int(BIG))),
        "cum_volume_min": cv_min, "cum_volume_max": cv_max,
        "cum_dollars_min": cd_min, "cum_dollars_max": cd_max,
    }
    for k, v in ohlcv.items():
        r.out[f"ohlcv.{k}"] = v
    for k, v in directional.items():
        r.out[f"directional.{k}"] = v
    r.aux.update(ohlcv=ohlcv, low_t=low_t, high_t=high_t)
