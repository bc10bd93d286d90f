"""The slices of finmlkit_tpu_torch against the JAX package on the CPU, on
the same inputs (the synthetic trade generator of bench.py, ``chip_smoke.
synth_trades``).

Time bars, at about 20k trades: quantize -> time bars -> bar products and
medians -> CUSUM events -> triple-barrier labels -> uniqueness and
return-attribution weights, with 1-second bars so that 20k trades give some
1400 bars. Bars and finals must be bit-identical; events, labels and touch
indices exact; returns and weights within rtol 1e-12 of the prefix magnitude
they are differences of (see tests/test_torch_labels.py).

Dollar bars and order flow, at 200k trades: dollar bars of about 1000 trades
(the month's threshold, total dollars / 40000, gives 979 a bar) -> bar
products and medians -> dense footprints -> trade-size features with theta
the bar's median trade size. Close indices, close timestamps, bars and
finals bit-identical; footprints against the f64 path exact (volumes bit for
bit), ``vp_skew``/``vp_gini`` within 1e-9 absolute, and against the ``_q``
path within the JAX package's tolerances, except where the ``_q`` path rounds
in float32 (ROADMAP R5): the flags and runs of bars with a level pair within
1e-5 of the imbalance threshold, and ``vp_skew`` within
``max(2e-4, 2e-7 * n_levels)``; trade-size features within rtol
1e-6 of the f64 path and rtol 3e-5 / atol 1e-6 of the ``_q`` path, except
``pct_block`` of bars with a trade within 1e-4 of the block threshold
(ROADMAP R5; see tests/test_torch_trade_size.py).
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import check_footprints_numpy, check_trade_size_numpy, synth_trades
from finmlkit_tpu.bar import aggregate, aggregate_q
from finmlkit_tpu.bar import fused as jfused
from finmlkit_tpu.bar.footprint import comp_bar_footprints
from finmlkit_tpu.bar.footprint_q import comp_bar_footprints_q
from finmlkit_tpu.bar.indexers import dollar_bar_indexer_q as jax_dollar_bar_indexer_q
from finmlkit_tpu.bar.indexers import time_bar_indexer as jax_time_bar_indexer
from finmlkit_tpu.bar.quantize import quantize_trades as jax_quantize_trades
from finmlkit_tpu.label.tbm import triple_barrier as jax_triple_barrier
from finmlkit_tpu.label.weights import average_uniqueness as jax_uniqueness
from finmlkit_tpu.label.weights import return_attribution as jax_attribution
from finmlkit_tpu.sampling import cusum_filter as jax_cusum_filter
from finmlkit_tpu_torch import interop
from finmlkit_tpu.ops.scan import next_bucket
from finmlkit_tpu_torch.bar.aggregate_q import bar_trade_size_features
from finmlkit_tpu_torch.bar.footprint_q import bar_footprints
from finmlkit_tpu_torch.bar.fused import bar_products_final
from finmlkit_tpu_torch.bar.indexers import dollar_bar_indexer_q, time_bar_indexer
from finmlkit_tpu_torch.bar.quantize import quantize_trades
from finmlkit_tpu_torch.label.tbm import triple_barrier
from finmlkit_tpu_torch.label.weights import average_uniqueness, return_attribution
from finmlkit_tpu_torch.sampling.filters import cusum_filter
from finmlkit_tpu_torch.testing import assert_close, assert_exact, assert_window_close

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-12
N = 20_000
INTERVAL_S, CUSUM_THR, TARGET, VERTICAL_S = 1.0, 3e-4, 5e-4, 60.0


def _cut(close):
    # events this close to the end have no room for a path (bench.py:557)
    n_bars = len(close)
    return max(n_bars - 200, n_bars // 2)


def _jax_slice(ts, price, amount, side):
    q = jax_quantize_trades(price, amount)
    clock, ci = jax_time_bar_indexer(jnp.asarray(ts), INTERVAL_S,
                                     ts_first=int(ts[0]), ts_last_i=int(ts[-1]))
    ci_h = np.asarray(ci)
    o, d = jfused.bar_products_final_device(
        jnp.asarray(q.price_ticks), jnp.asarray(q.amount_units), ci,
        jnp.asarray(side), tick_size=q.tick_size, amount_scale=q.amount_scale,
        amounts_f32=jnp.asarray(amount), ci_host=ci_h, interpret=True,
        kernel="v2")
    n_bars = len(ci_h) - 1
    close, bar_ts = o["close"], np.asarray(clock)[1:n_bars + 1]
    ev = np.asarray(jax_cusum_filter(close, np.array([CUSUM_THR])), np.int64)
    ev = ev[ev < _cut(close)]
    tg = np.full(len(ev), TARGET)
    lab = [np.array(x) for x in jax_triple_barrier(
        bar_ts, close, ev, tg, (1.0, 1.0), VERTICAL_S, min_close_time_sec=0.0)]
    w_u, conc = (np.array(x) for x in jax_uniqueness(bar_ts, ev, lab[1]))
    w_r = np.asarray(jax_attribution(ev, lab[1], close, conc))
    return dict(q=q, ci=ci_h, clock=np.asarray(clock), ohlcv=o, directional=d,
                events=ev, labels=lab, w_u=w_u, conc=conc, w_r=w_r)


def _port_slice(ts, price, amount, side, device="cpu"):
    q = quantize_trades(price, amount)
    t = interop.from_numpy(q, None, side, amount, device, timestamps=ts)
    clock, ci = time_bar_indexer(t.timestamps, INTERVAL_S,
                                 ts_first=int(ts[0]), ts_last_i=int(ts[-1]))
    o, d = bar_products_final(t.ticks, t.units, ci, t.sides,
                              tick_size=t.tick_size,
                              amount_scale=t.amount_scale, amounts_f32=t.amounts)
    n_bars = ci.shape[0] - 1
    close, bar_ts = o["close"], clock[1:n_bars + 1]
    ev = cusum_filter(close, [CUSUM_THR])
    ev = ev[ev < _cut(close)]
    tg = torch.full((len(ev),), TARGET, dtype=torch.float64, device=device)
    lab = triple_barrier(bar_ts, close, ev, tg, (1.0, 1.0), VERTICAL_S,
                         min_close_time_sec=0.0)
    w_u, conc = average_uniqueness(bar_ts, ev, lab[1])
    w_r = return_attribution(ev, lab[1], close, conc)
    return dict(q=q, ci=ci, clock=clock, ohlcv=o, directional=d, events=ev,
                labels=lab, w_u=w_u, conc=conc, w_r=w_r)


def test_slice_matches_jax():
    trades = synth_trades(N)
    want = _jax_slice(*trades)
    got = _port_slice(*trades)
    assert_exact(got["q"].price_ticks, want["q"].price_ticks, "ticks")
    assert_exact(got["q"].amount_units, want["q"].amount_units, "units")
    assert_exact(got["clock"], want["clock"], "clock")
    assert_exact(got["ci"], want["ci"], "ci")
    assert len(want["ci"]) > 1000
    for part in ("ohlcv", "directional"):
        for k, v in want[part].items():
            assert_exact(got[part][k], np.asarray(v), f"{part}.{k}")
    assert len(want["events"]) > 20
    assert_exact(got["events"], want["events"], "events")
    lab_g, lab_w = got["labels"], want["labels"]
    assert_exact(lab_g[0], lab_w[0].astype(np.int8), "labels")
    assert_exact(lab_g[1], lab_w[1].astype(np.int64), "touch")
    log_scale = float(np.max(np.abs(np.log(want["ohlcv"]["close"]))))
    assert_window_close(lab_g[2], lab_w[2], log_scale, RTOL, "rets")
    assert_window_close(lab_g[3], lab_w[3], log_scale / TARGET, RTOL, "max_rb")
    assert_exact(got["conc"], want["conc"].astype(np.int16), "concurrency")
    assert_window_close(got["w_u"], want["w_u"], len(want["conc"]), RTOL,
                        "uniqueness")
    raw = np.asarray(jax_attribution(want["events"], lab_w[1],
                                     want["ohlcv"]["close"], want["conc"],
                                     normalize=False))
    assert_window_close(got["w_r"], want["w_r"],
                        log_scale * len(raw) / raw.sum(), RTOL, "attribution")


def test_import_leaves_out_jax_and_pandas():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import finmlkit_tpu_torch, finmlkit_tpu_torch.interop, finmlkit_tpu_torch.testing\n"
        "import finmlkit_tpu_torch.bar.fused, finmlkit_tpu_torch.bar.indexers\n"
        "import finmlkit_tpu_torch.bar.quantize, finmlkit_tpu_torch.sampling.filters\n"
        "import finmlkit_tpu_torch.label.tbm, finmlkit_tpu_torch.label.weights\n"
        "import finmlkit_tpu_torch.bar.footprint_q, finmlkit_tpu_torch.bar.aggregate_q\n"
        "import finmlkit_tpu_torch.ops.segment\n"
        "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
        "bad = new & {'jax', 'jaxlib', 'pandas', 'finmlkit_tpu'}\n"
        "assert 'torch' in sys.modules and not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


N_DOLLAR = 200_000
BARS_DOLLAR = 200


def _dollar_jax(ts, price, amount, side, thr):
    q = jax_quantize_trades(price, amount)
    close_ts, ci = jax_dollar_bar_indexer_q(
        jnp.asarray(ts), jnp.asarray(q.price_ticks), jnp.asarray(q.amount_units),
        thr, q.tick_size, q.amount_scale)
    ci_h = np.asarray(ci)
    o, d = jfused.bar_products_final_device(
        jnp.asarray(q.price_ticks), jnp.asarray(q.amount_units), ci,
        jnp.asarray(side), tick_size=q.tick_size, amount_scale=q.amount_scale,
        amounts_f32=jnp.asarray(amount), ci_host=ci_h, interpret=True,
        kernel="v2")
    low_t = np.round(o["low"] / q.tick_size).astype(np.int32)
    high_t = np.round(o["high"] / q.tick_size).astype(np.int32)
    L = next_bucket(int((high_t - low_t + 1).max()), 8)
    fp64 = comp_bar_footprints(
        jnp.asarray(price), jnp.asarray(amount), ci, jnp.asarray(side),
        q.tick_size, jnp.asarray(o["low"]), jnp.asarray(o["high"]), 3.0,
        max_levels=L)
    fpq = comp_bar_footprints_q(
        jnp.asarray(q.price_ticks), jnp.asarray(amount), ci, jnp.asarray(side),
        jnp.asarray(low_t), jnp.asarray(high_t), 3.0, max_levels=L)
    theta = np.asarray(o["median_trade_size"], np.float64)
    ts64 = aggregate.comp_bar_trade_size_features(
        jnp.asarray(amount), jnp.asarray(theta), ci, 5.0)
    tsq = aggregate_q.comp_bar_trade_size_features_q(
        jnp.asarray(q.amount_units), jnp.asarray(amount), theta, ci, 5.0,
        q.amount_scale)

    def host(x):
        return {k: np.asarray(v) for k, v in x.items()}
    return dict(close_ts=np.asarray(close_ts), ci=ci_h, ohlcv=o, directional=d,
                fp64=host(fp64), fpq=host(fpq), ts64=host(ts64), tsq=host(tsq))


def _dollar_port(ts, price, amount, side, thr, device="cpu"):
    q = quantize_trades(price, amount)
    t = interop.from_numpy(q, None, side, amount, device, timestamps=ts)
    close_ts, ci = dollar_bar_indexer_q(t.timestamps, t.ticks, t.units, thr,
                                        t.tick_size, t.amount_scale)
    o, d = bar_products_final(t.ticks, t.units, ci, t.sides,
                              tick_size=t.tick_size,
                              amount_scale=t.amount_scale, amounts_f32=t.amounts)
    fp = bar_footprints(t.ticks, t.amounts, ci, t.sides, o,
                        tick_size=t.tick_size, imbalance_factor=3.0)
    tsf = bar_trade_size_features(t.units, t.amounts, ci, o["median_trade_size"],
                                  theta_mult=5.0, amount_scale=t.amount_scale)
    return dict(q=q, close_ts=close_ts, ci=ci, ohlcv=o, directional=d, fp=fp,
                ts=tsf)


def test_dollar_slice_matches_jax():
    ts, price, amount, side = synth_trades(N_DOLLAR, seed=1)
    thr = float((price * amount.astype(np.float64)).sum()) / BARS_DOLLAR
    want = _dollar_jax(ts, price, amount, side, thr)
    got = _dollar_port(ts, price, amount, side, thr)
    assert_exact(got["ci"], want["ci"], "ci")
    assert_exact(got["close_ts"], want["close_ts"], "close_ts")
    assert len(want["ci"]) > BARS_DOLLAR * 0.9 and want["ci"][0] == 0
    for part in ("ohlcv", "directional"):
        for k, v in want[part].items():
            assert_exact(got[part][k], np.asarray(v), f"{part}.{k}")
    fp, fp64, fpq = got["fp"], want["fp64"], want["fpq"]
    assert fp["buy_volumes"].shape == fp64["buy_volumes"].shape
    assert fp["buy_volumes"].shape[1] >= 1024   # ~1000 trades over ~1000 levels
    for k, v in fp64.items():
        if k in ("vp_skew", "vp_gini"):
            assert_close(fp[k], v, rtol=0.0, atol=1e-9, what=k)
        else:
            assert_exact(fp[k], v, k)
    # the _q path flags in float32 from float32 sums (ROADMAP R5): leave out
    # the bars with a pair within the volumes' rtol 1e-5 of the threshold
    bv, sv = fp["buy_volumes"].double().numpy(), fp["sell_volumes"].double().numpy()
    up, dn = bv[:, 1:], sv[:, :-1]
    tie = ((np.abs(up - 3 * dn) <= 1e-5 * np.maximum(up, 3 * dn))
           | (np.abs(dn - 3 * up) <= 1e-5 * np.maximum(dn, 3 * up))) & (up + dn > 0)
    keep = ~tie.any(axis=1)
    assert keep.mean() > 0.9
    assert_exact(fp["buy_ticks"], fpq["buy_ticks"], "_q buy_ticks")
    assert_exact(fp["sell_ticks"], fpq["sell_ticks"], "_q sell_ticks")
    assert_exact(fp["cot_price_levels"], fpq["cot_price_levels"], "_q cot")
    for k in ("buy_imbalances", "sell_imbalances", "imb_max_run_signed"):
        assert_exact(fp[k].numpy()[keep], fpq[k][keep], f"_q {k}")
    for k in ("buy_volumes", "sell_volumes"):
        assert_close(fp[k], fpq[k], rtol=1e-5, atol=1e-5, what=f"_q {k}")
    # the _q path's centred float32 vp_skew rounds by about 1e-7 per level
    # (ROADMAP R5); the JAX package's 2e-4 is for bars of a few levels
    skew_atol = np.maximum(2e-4, 2e-7 * fp["n_levels"].numpy())
    assert np.all(np.abs(fp["vp_skew"].numpy() - fpq["vp_skew"]) <= skew_atol)
    assert_close(fp["vp_gini"], fpq["vp_gini"], rtol=0.0, atol=2e-5, what="_q gini")
    theta = np.asarray(want["ohlcv"]["median_trade_size"]) * 5.0
    ci = want["ci"]
    near = np.array([np.any(np.abs(amount[s + 1:e + 1] - theta[k]) <= 1e-4 * theta[k])
                     for k, (s, e) in enumerate(zip(ci[:-1], ci[1:]))])
    assert near.mean() < 0.05
    for k, v in want["ts64"].items():
        assert_close(got["ts"][k], v, rtol=1e-6, what=f"trade size {k}")
        keep = ~near if k == "pct_block" else np.ones_like(near)
        assert_close(got["ts"][k].numpy()[keep], want["tsq"][k][keep],
                     rtol=3e-5, atol=1e-6, what=f"_q trade size {k}")


def test_dollar_host_checks_pass_on_the_port():
    # chip_smoke.py phase 6 holds the card's outputs to these numpy checks;
    # on the CPU the port adds every cell in trade order, as np.add.at does
    ts, price, amount, side = synth_trades(N_DOLLAR, seed=1)
    thr = float((price * amount.astype(np.float64)).sum()) / BARS_DOLLAR
    got = _dollar_port(ts, price, amount, side, thr)
    out = dict(ci=got["ci"], ohlcv=got["ohlcv"], footprints=got["fp"],
               trade_size=got["ts"])
    cells, off = check_footprints_numpy(out, got["q"], amount, side)
    assert cells > 0 and off == 0
    check_trade_size_numpy(out, got["q"], amount)
