"""The whole slice of finmlkit_tpu_torch against the JAX package on the CPU,
at about 20k trades: quantize -> time bars -> bar products and medians ->
CUSUM events -> triple-barrier labels -> uniqueness and return-attribution
weights, on the same inputs (the synthetic trade generator of bench.py, with
1-second bars so that 20k trades give some 1400 bars).

Bars and finals must be bit-identical; events, labels and touch indices
exact; returns and weights within rtol 1e-12 of the prefix magnitude they are
differences of (see tests/test_torch_labels.py).
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from finmlkit_tpu.bar import fused as jfused
from finmlkit_tpu.bar.indexers import time_bar_indexer as jax_time_bar_indexer
from finmlkit_tpu.bar.quantize import quantize_trades as jax_quantize_trades
from finmlkit_tpu.label.tbm import triple_barrier as jax_triple_barrier
from finmlkit_tpu.label.weights import average_uniqueness as jax_uniqueness
from finmlkit_tpu.label.weights import return_attribution as jax_attribution
from finmlkit_tpu.sampling import cusum_filter as jax_cusum_filter
from finmlkit_tpu_torch import interop
from finmlkit_tpu_torch.bar.fused import bar_products_final
from finmlkit_tpu_torch.bar.indexers import time_bar_indexer
from finmlkit_tpu_torch.bar.quantize import quantize_trades
from finmlkit_tpu_torch.label.tbm import triple_barrier
from finmlkit_tpu_torch.label.weights import average_uniqueness, return_attribution
from finmlkit_tpu_torch.sampling.filters import cusum_filter
from finmlkit_tpu_torch.testing import assert_exact, assert_window_close

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-12
N = 20_000
INTERVAL_S, CUSUM_THR, TARGET, VERTICAL_S = 1.0, 3e-4, 5e-4, 60.0


def synth_trades(n, seed=0):
    # the generator of bench.py:78-86
    r = np.random.default_rng(seed)
    dt = (r.exponential(70.0, n) * 1e6).astype(np.int64)
    ts = 1_751_328_000_000_000_000 + np.cumsum(dt)
    price = np.round(107_000.0 * np.exp(np.cumsum(r.normal(0, 2e-5, n))), 1)
    amount = np.maximum(np.round(r.lognormal(-4.0, 1.5, n), 5), 1e-5).astype(np.float32)
    side = np.where(r.random(n) < 0.5, 1, -1).astype(np.int8)
    return ts, price, amount, side


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
        "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
        "bad = new & {'jax', 'jaxlib', 'pandas', 'finmlkit_tpu'}\n"
        "assert 'torch' in sys.modules and not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
