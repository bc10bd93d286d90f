"""Reference footprints: every bar's grid of price levels, from its low to
its high on the footprint tick, ``L`` levels wide (the first ``8 * 2^k`` at or
above the widest bar's count), with each level's buy and sell volume (the
float32 amounts summed in float64, rounded once) and trade counts. Per bar:
the diagonal imbalances (level l's sell volume above ``factor`` times level
l + 1's buy volume flags l as a sell imbalance; the reverse flags l + 1 as
a buy one; compared in float64), their counts, the longest run of adjacent
levels with the same imbalance side (a buy flag outranks a sell flag on a
level; the first of the longest wins; signed by the side), the level of
most volume (the lowest on ties), and the volume profile's first moment
about its own mean (``vp_skew``) and ``1 - sum(share^2)`` (``vp_gini``) over
absolute levels."""
import torch

from refbase import bars_of


def run(r, p):
    pr, f, dev = r.prec, r.prec.f, r.device
    ratio = round(r.tick / float(p["price_tick"]))
    ci = r.out["ci"]
    nb = ci.shape[0] - 1
    first, counts, bar = bars_of(ci)
    sl = slice(first, first + bar.shape[0])
    low, high = r.aux["low_t"] * ratio, r.aux["high_t"] * ratio
    nl = high - low + 1
    widest = int(nl.max())
    L = 8
    while L < widest:
        L *= 2
    sd = r.side[sl]
    keep = (sd == 1) | (sd == -1)
    cell = ((bar * L + r.ticks[sl] * ratio - low[bar]) * 2 + (sd == -1))[keep]
    vol = torch.zeros(nb * L * 2, dtype=f, device=dev)
    vol.index_add_(0, cell, r.amount[sl][keep].to(f))
    vol = pr.out32(vol).view(nb, L, 2)
    cnt = torch.zeros(nb * L * 2, dtype=torch.int32, device=dev)
    cnt.index_add_(0, cell, torch.ones_like(cell, dtype=torch.int32))
    cnt = cnt.view(nb, L, 2)
    del cell
    buy, sell = vol[..., 0].contiguous(), vol[..., 1].contiguous()
    fct = float(p["imbalance_factor"])
    lg = torch.arange(L, device=dev)
    inside = lg[None, :] < nl[:, None]
    pair = (lg[None, :-1] + 1) < nl[:, None]
    bv, sv = buy.to(f), sell.to(f)
    sell_imb = torch.zeros((nb, L), dtype=torch.bool, device=dev)
    buy_imb = torch.zeros((nb, L), dtype=torch.bool, device=dev)
    sell_imb[:, :-1] = (sv[:, :-1] > bv[:, 1:] * fct) & pair
    buy_imb[:, 1:] = (bv[:, 1:] > sv[:, :-1] * fct) & pair

    side = torch.where(buy_imb, 1, torch.where(sell_imb, -1, 0)) * inside
    best = torch.zeros(nb, dtype=torch.int64, device=dev)
    best_side = torch.zeros_like(best)
    run_len, run_side = torch.zeros_like(best), torch.zeros_like(best)
    for level in range(widest):
        s = side[:, level]
        run_len = torch.where(s == 0, 0, torch.where(s == run_side, run_len + 1, 1))
        run_side = s
        longer = run_len > best
        best = torch.where(longer, run_len, best)
        best_side = torch.where(longer, s, best_side)

    zero = torch.zeros((), dtype=f, device=dev)
    total = torch.where(inside, bv + sv, zero)
    levels = (low[:, None] + lg[None, :]).to(f)
    vsum = total.sum(1)
    has = vsum > 0
    safe = torch.where(has, vsum, 1.0)
    mean = (levels * total).sum(1) / safe
    share = total / safe[:, None]
    r.out.update({
        "footprints.low_level": low.to(torch.int32),
        "footprints.n_levels": nl.to(torch.int32),
        "footprints.buy_volumes": buy,
        "footprints.sell_volumes": sell,
        "footprints.buy_ticks": cnt[..., 0].contiguous(),
        "footprints.sell_ticks": cnt[..., 1].contiguous(),
        "footprints.buy_imbalances": buy_imb,
        "footprints.sell_imbalances": sell_imb,
        "footprints.buy_imbalances_sum": buy_imb.sum(1).to(torch.uint16),
        "footprints.sell_imbalances_sum": sell_imb.sum(1).to(torch.uint16),
        "footprints.cot_price_levels": (low + total.argmax(1)).to(torch.int32),
        "footprints.imb_max_run_signed": (best * best_side).to(torch.int16),
        "footprints.vp_skew": pr.out64(torch.where(
            has, ((levels - mean[:, None]) * total).sum(1) / safe, zero)),
        "footprints.vp_gini": pr.out64(torch.where(has, 1.0 - (share * share).sum(1), zero)),
    })
    # the skew is a difference of moments of levels about 1e6 ticks: its
    # rounding scales with the levels, not with the skew
    r.aux.setdefault("scales", {})["footprints.vp_skew"] = float(high.abs().max())
