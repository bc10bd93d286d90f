"""Per-bar order-flow features of dense footprints.

Counterpart of ``footprint_features_from_tensors`` in
``finmlkit_tpu/bar/footprint.py`` (the f64 path). From the dense
``(n_bars, L)`` volume and tick-count grids it derives, per bar:

- the diagonal imbalance flags: ``sell[l] > buy[l+1] * f`` flags level l,
  ``buy[l+1] > sell[l] * f`` flags level l+1, compared in float64 from the
  float32 volumes;
- the longest run of equal nonzero flag signs, signed, the first of equal
  runs winning; the JAX package scans the levels, the port takes the closed
  form of ``finmlkit_tpu/bar/footprint_q.py:75-90`` (a ``cummax`` of the last
  restart along the levels), which gives the same first maximal run;
- the level of most volume (first on ties), ``vp_skew`` (the first moment of
  the volume profile about its own volume-weighted mean, as the reference
  computes it) and ``vp_gini``, in float64 over absolute tick levels.
"""
import torch

__all__ = ["footprint_features_from_tensors"]


def footprint_features_from_tensors(low, n_levels, buy_vol, sell_vol,
                                    buy_ticks, sell_ticks, imbalance_factor):
    """Footprint features from dense grids; returns a dict of tensors with
    the JAX package's keys and dtypes (``low`` and ``n_levels`` int32 per bar,
    volumes float32 and ticks int32 of shape ``(n_bars, L)``)."""
    n_bars, L = buy_vol.shape
    dev = buy_vol.device
    f = float(imbalance_factor)
    lgrid = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    lmask = lgrid < n_levels[:, None]
    pair_ok = (lgrid[:, :-1] + 1) < n_levels[:, None]

    bv, sv = buy_vol.to(torch.float64), sell_vol.to(torch.float64)
    sell_imb = torch.zeros((n_bars, L), dtype=torch.bool, device=dev)
    buy_imb = torch.zeros((n_bars, L), dtype=torch.bool, device=dev)
    sell_imb[:, :-1] = (sv[:, :-1] > bv[:, 1:] * f) & pair_ok
    buy_imb[:, 1:] = (bv[:, 1:] > sv[:, :-1] * f) & pair_ok

    # longest signed run: a run restarts where the sign is 0 or differs from
    # the level below; its length is the distance to the last restart
    zero8 = torch.zeros((), dtype=torch.int8, device=dev)
    sign = torch.where(buy_imb, 1, torch.where(sell_imb, -1, zero8))
    sign = torch.where(lmask, sign, zero8)
    prev = torch.cat([torch.zeros((n_bars, 1), dtype=torch.int8, device=dev),
                      sign[:, :-1]], dim=1)
    pos = lgrid.expand(n_bars, L)
    restart = (sign != prev) | (sign == 0)
    last_restart = torch.cummax(torch.where(restart, pos, -1), dim=1).values
    run = torch.where(sign != 0, pos - last_restart + 1, 0)
    first_max = torch.argmax(run, dim=1, keepdim=True)  # first maximal run
    max_run = run.gather(1, first_max)[:, 0]
    max_sign = sign.gather(1, first_max)[:, 0].to(torch.int32)
    imb_max_run_signed = (max_run * max_sign).to(torch.int16)
    del sign, prev, restart, last_restart, run

    total = torch.where(lmask, bv + sv, 0.0)
    cot_price_levels = low + torch.argmax(total, dim=1).to(torch.int32)
    levels = (low[:, None] + lgrid).to(torch.float64)
    sum_total = total.sum(dim=1)
    pos_vol = sum_total > 0
    safe = torch.where(pos_vol, sum_total, 1.0)
    vwap = (levels * total).sum(dim=1) / safe
    vp_skew = torch.where(
        pos_vol, ((levels - vwap[:, None]) * total).sum(dim=1) / safe, 0.0)
    prop = total / safe[:, None]
    vp_gini = torch.where(pos_vol, 1.0 - (prop * prop).sum(dim=1), 0.0)

    return {
        "low_level": low,
        "n_levels": n_levels,
        "buy_volumes": buy_vol,
        "sell_volumes": sell_vol,
        "buy_ticks": buy_ticks,
        "sell_ticks": sell_ticks,
        "buy_imbalances": buy_imb,
        "sell_imbalances": sell_imb,
        "buy_imbalances_sum": buy_imb.sum(dim=1).to(torch.uint16),
        "sell_imbalances_sum": sell_imb.sum(dim=1).to(torch.uint16),
        "cot_price_levels": cot_price_levels,
        "imb_max_run_signed": imb_max_run_signed,
        "vp_skew": vp_skew,
        "vp_gini": vp_gini,
    }
