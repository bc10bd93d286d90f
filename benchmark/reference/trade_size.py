"""Reference trade-size features of every bar, relative to ``theta *
theta_mult`` with theta the bar's median trade size: the log1p of the mean
trade size and of the 95th percentile (``np.percentile``'s linear rule) over
it, the share of the volume in trades above it, and ``1 - sum(size^2) /
volume^2``; sizes and volumes from the exact units, the percentile and the
block test from the float32 amounts. NaN for an empty bar or a theta of 0,
and the share and gini also for a bar of no volume."""
import torch

from refbase import bars_of, seg_sum, sorted_in_bars


def run(r, p):
    pr, f, dev = r.prec, r.prec.f, r.device
    ci = r.out["ci"]
    nb = ci.shape[0] - 1
    first, counts, bar = bars_of(ci)
    sl = slice(first, first + bar.shape[0])
    u, amt = r.units[sl], r.amount[sl]
    theta = r.out[f"ohlcv.{p['theta']}"].to(f)
    thr = theta * float(p["theta_mult"])
    total_u = seg_sum(u, bar, nb)
    block_u = seg_sum(torch.where(amt.to(f) > thr[bar], u, 0), bar, nb)
    q = u.to(f) * r.unit
    sumsq = seg_sum(q * q, bar, nb)
    s = sorted_in_bars(amt, bar).to(f)
    off = ci[:-1] - ci[0]
    top = max(s.shape[0] - 1, 0)
    pos = 0.95 * (counts.clamp(min=1) - 1).to(f)
    lo = torch.floor(pos).to(torch.int64)
    a = s[(off + lo).clamp(0, top)]
    b = s[(off + torch.minimum(lo + 1, counts.clamp(min=1) - 1)).clamp(0, top)]
    p95 = a + (b - a) * (pos - lo.to(f))
    total = total_u.to(f) * r.unit
    nan = torch.full((nb,), float("nan"), dtype=f, device=dev)
    bad = (counts == 0) | (theta == 0)
    no_vol = bad | (total_u == 0)
    safe_thr = torch.where(thr > 0, thr, 1.0)
    safe_total = torch.where(total > 0, total, 1.0)
    r.out.update({
        "trade_size.mean_size_rel": pr.out32(torch.where(
            bad, nan, torch.log1p(total / counts.clamp(min=1).to(f) / safe_thr))),
        "trade_size.size_95_rel": pr.out32(torch.where(bad, nan, torch.log1p(p95 / safe_thr))),
        "trade_size.pct_block": pr.out32(torch.where(
            no_vol, nan, block_u.to(f) * r.unit / safe_total)),
        "trade_size.size_gini": pr.out32(torch.where(
            no_vol, nan, 1.0 - sumsq / (safe_total * safe_total))),
    })
