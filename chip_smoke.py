#!/usr/bin/env python3
"""Smoke run of finmlkit_tpu_torch on one NVIDIA GPU.

Builds the package's CUDA kernels from ``finmlkit_tpu_torch/csrc`` and drives
the port's two paths once at full size on a month of synthetic trades (the
generator of ``bench.py``, 39,171,929 trades at seed 0): the time-bar path
(1-minute time bars -> bar products and medians -> CUSUM events ->
triple-barrier labels -> uniqueness and return-attribution weights) and the
order-flow path of ``bench.py`` config 2 (dollar bars at total dollars /
40000 -> bar products and medians -> dense footprints -> trade-size
features). Phases:

1. environment: torch, CUDA, nvcc, triton, the card's name and power limit;
2. build the kernels (``build/finmlkit_tpu_torch/``);
3. kernel S against its plain version (lengths 1, 8191, 8193, 39,171,930) and
   kernel C against its plain version (1, 2 and 5 rows of 1, 2047, 2049 and
   39,171,930 values): int32 and int64 exact (int64 rows that wrap past 2^63
   beside rows that do not), float32 rtol 1e-5, float64 rtol 1e-12;
4. kernel B and the medians against their plain versions on adversarial
   streams (empty, single-trade and side-0 trades, ci[0] >= 0, units above
   2^31, a bar of about 1M trades): exact;
5. the time-bar path through the kernels and through the plain versions on
   the card: bars, integers, medians and finals exact, labels and touch
   indices exact, weights within rtol 1e-12 of their prefix magnitude; each
   kernel launched on the path; a numpy check of sampled bars; stage and
   end-to-end times from CUDA events;
6. the order-flow path on the same month, through the kernels and through the
   plain versions: close indices, bars, footprints and trade-size features
   equal bit for bit, and the kernel path's footprints and trade-size
   features equal from run to run; the close indices against numpy's
   recomputation of the integer rule; sampled footprint bars against
   ``np.add.at`` and sampled bars' trade-size features against numpy; C
   launched at least twice, S and B at least once; stage and end-to-end
   times, peak device memory. Without phase 5, B and S are timed here.

Run from the repository root: ``python3 chip_smoke.py``; ``--phases 1,2,6``
runs only the order-flow path, and ``--profile`` adds, after phase 6, the
footprint features' own time, a ``torch.profiler`` table of one run of the
order-flow path and its device idle share. Any failure exits non-zero
before the last line. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np

N_MONTH = 39_171_929
SCAN_LENGTHS = (1, 8191, 8193, N_MONTH + 1)
COLS_ROWS = (1, 2, 5)
COLS_LENGTHS = (1, 2047, 2049, N_MONTH + 1)
DOLLAR_BARS = 40_000      # bench.py config 2: threshold = total dollars / 40000


def say(msg):
    print(msg, flush=True)


def fail(msg):
    say(f"FAIL: {msg}")
    sys.exit(1)


def synth_trades(n, seed=0):
    """The synthetic month of bench.py:78-86 (about 32 days at 70 ms mean
    spacing for 39.17M trades)."""
    r = np.random.default_rng(seed)
    dt = (r.exponential(70.0, n) * 1e6).astype(np.int64)
    ts = 1_751_328_000_000_000_000 + np.cumsum(dt)  # 2025-07-01 epoch ns
    price = np.round(107_000.0 * np.exp(np.cumsum(r.normal(0, 2e-5, n))), 1)
    amount = np.maximum(np.round(r.lognormal(-4.0, 1.5, n), 5), 1e-5).astype(np.float32)
    side = np.where(r.random(n) < 0.5, 1, -1).astype(np.int8)
    return ts, price, amount, side


def cuda_ms(fn, reps=5):
    """Mean milliseconds per call from CUDA events, after one warm call."""
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_env():
    import torch
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    from finmlkit_tpu_torch import _build
    try:
        nvcc = _build.nvcc_path()
        ver = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        say(f"nvcc {nvcc}: {ver[-1] if ver else '?'}")
    except RuntimeError as e:
        fail(str(e))
    try:
        import triton
        say(f"triton {triton.__version__} imports")
    except ImportError as e:
        say(f"triton does not import ({e})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    say(card)
    say(f"device: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"visible, capability {torch.cuda.get_device_capability(0)}")
    return card


def phase_build():
    from finmlkit_tpu_torch import _build
    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    say(f"build: {secs:.2f} s (nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'}) "
        f"-> {_build.library_path()}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"  ptxas: {line.strip()}")
    return secs


def phase_scan():
    import torch
    from finmlkit_tpu_torch.ops.prefix_scan import fast_cumsum, fast_cumsum_plain
    from finmlkit_tpu_torch.testing import assert_close, assert_exact
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for n in SCAN_LENGTHS:
        x32 = torch.randint(-1000, 1000, (n,), dtype=torch.int32, device="cuda",
                            generator=g)
        x32[::97] = 2**31 - 1                               # wraps past 2^31
        x64 = torch.randint(-2**40, 2**40, (n,), dtype=torch.int64,
                            device="cuda", generator=g)
        x64[::5] = 2**62          # from 11 elements on the prefix wraps past 2^63
        f32 = torch.rand(n, dtype=torch.float32, device="cuda", generator=g)
        f64 = torch.rand(n, dtype=torch.float64, device="cuda", generator=g)
        for x, tol in ((x32, None), (x64, None), (f32, 1e-5), (f64, 1e-12)):
            got, want = fast_cumsum(x), fast_cumsum_plain(x)
            torch.cuda.synchronize()
            what = f"S {x.dtype} n={n}"
            if tol is None:
                assert_exact(got, want, what)
            else:
                err = assert_close(got, want, rtol=tol, what=what)
                worst = max(worst, err / max(float(want.abs().max()), 1e-300))
    say(f"phase 3 ok: S == plain on int32/int64 exact, float32/float64 within "
        f"rtol (largest error relative to the prefix {worst:.3g}), lengths "
        f"{list(SCAN_LENGTHS)}")
    from finmlkit_tpu_torch.ops.prefix_scan import (fast_cumsum_cols,
                                                    fast_cumsum_cols_plain)
    worst = 0.0
    for c in COLS_ROWS:
        for n in COLS_LENGTHS:
            x32 = torch.randint(-1000, 1000, (c, n), dtype=torch.int32,
                                device="cuda", generator=g)
            x32[:, ::97] = 2**31 - 1                        # wraps past 2^31
            x64 = torch.randint(-2**40, 2**40, (c, n), dtype=torch.int64,
                                device="cuda", generator=g)
            x64[0, ::5] = 2**62   # row 0 wraps past 2^63, the others do not
            f32 = torch.rand((c, n), dtype=torch.float32, device="cuda", generator=g)
            f64 = torch.rand((c, n), dtype=torch.float64, device="cuda", generator=g)
            for x, tol in ((x32, None), (x64, None), (f32, 1e-5), (f64, 1e-12)):
                got, want = fast_cumsum_cols(x), fast_cumsum_cols_plain(x)
                torch.cuda.synchronize()
                what = f"C {x.dtype} ({c}, {n})"
                if tol is None:
                    assert_exact(got, want, what)
                else:
                    err = assert_close(got, want, rtol=tol, what=what)
                    worst = max(worst, err / max(float(want.abs().max()), 1e-300))
            del x32, x64, f32, f64, got, want
    say(f"phase 3 ok: C == plain on int32/int64 exact, float32/float64 within "
        f"rtol (largest error relative to the prefix {worst:.3g}), rows "
        f"{list(COLS_ROWS)} x lengths {list(COLS_LENGTHS)}")


def phase_products():
    import torch
    from finmlkit_tpu_torch.bar.fused import median_pairs
    from finmlkit_tpu_torch.ops.fused_scan import (bar_scan_products,
                                                   bar_scan_products_plain)
    from finmlkit_tpu_torch.ops.prefix_scan import fast_cumsum_plain
    from finmlkit_tpu_torch.testing import adversarial_trades, assert_exact
    cases = [dict(n=3_000_000, seed=1, first=-1, long_bar=1_000_000),
             dict(n=400_000, seed=2, first=17, long_bar=40_000),
             dict(n=200_000, seed=3, first=0, mean_bar=3),
             dict(n=12, seed=4, first=-1, mean_bar=2)]
    for c in cases:
        arrs = adversarial_trades(**c)
        ticks, units, sides, amounts, ci = (torch.from_numpy(a).cuda() for a in arrs)
        got = bar_scan_products(ticks, units, sides, ci)
        want = bar_scan_products_plain(ticks, units, sides, ci)
        for name, a, b in zip(("p64", "p32", "pf"), got, want):
            assert_exact(a, b, f"B {name} {c}")
        ma, mb = median_pairs(amounts, ci)
        pa, pb = median_pairs(amounts, ci, cumsum=fast_cumsum_plain)
        assert_exact(ma, pa, f"median a {c}")
        assert_exact(mb, pb, f"median b {c}")
        counts = np.diff(arrs[4])
        say(f"  B case {c}: {len(counts)} bars ({int((counts == 0).sum())} "
            f"empty, {int((counts == 1).sum())} single, longest "
            f"{int(counts.max())}), units max {int(arrs[1].max())}: exact")
    say("phase 4 ok: B and medians == plain on every adversarial case")


def run_slice(tr, ts_first, ts_last, plain=False):
    """The main path on device tensors; returns outputs and stage times (ms)."""
    import torch
    from finmlkit_tpu_torch.bar.fused import bar_products_final
    from finmlkit_tpu_torch.bar.indexers import time_bar_indexer
    from finmlkit_tpu_torch.label.tbm import triple_barrier
    from finmlkit_tpu_torch.label.weights import average_uniqueness, return_attribution
    from finmlkit_tpu_torch.ops import fused_scan, prefix_scan
    from finmlkit_tpu_torch.sampling.filters import cusum_filter
    scan = fused_scan.bar_scan_products_plain if plain else fused_scan.bar_scan_products
    cumsum = prefix_scan.fast_cumsum_plain if plain else prefix_scan.fast_cumsum
    marks = []

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append(e)

    mark()
    clock, ci = time_bar_indexer(tr.timestamps, 60.0, ts_first=ts_first,
                                 ts_last_i=ts_last)
    mark()
    ohlcv, direc = bar_products_final(tr.ticks, tr.units, ci, tr.sides,
                                      tick_size=tr.tick_size,
                                      amount_scale=tr.amount_scale,
                                      amounts_f32=tr.amounts, scan=scan,
                                      cumsum=cumsum)
    mark()
    n_bars = ci.shape[0] - 1
    close, bar_ts = ohlcv["close"], clock[1:n_bars + 1]
    ev = cusum_filter(close, [0.002])
    cut = max(n_bars - 2000, n_bars // 2)           # bench.py:557-560
    ev = ev[ev < cut]
    if len(ev) == 0:
        ev = torch.arange(10, cut, 97, device=close.device)
    mark()
    tg = torch.full((len(ev),), 0.003, dtype=torch.float64, device=close.device)
    labels = triple_barrier(bar_ts, close, ev, tg, (1.0, 1.0), 3600.0,
                            min_close_time_sec=0.0)
    mark()
    w_u, conc = average_uniqueness(bar_ts, ev, labels[1], cumsum=cumsum)
    w_r = return_attribution(ev, labels[1], close, conc, cumsum=cumsum)
    mark()
    torch.cuda.synchronize()
    names = ("index", "products+medians", "cusum", "tbm", "weights")
    stages = {k: marks[i].elapsed_time(marks[i + 1]) for i, k in enumerate(names)}
    stages["total"] = marks[0].elapsed_time(marks[-1])
    out = dict(clock=clock, ci=ci, ohlcv=ohlcv, directional=direc, events=ev,
               labels=labels, w_u=w_u, conc=conc, w_r=w_r)
    return out, stages


def check_bars_numpy(out, ts, q, amount, side, n_sample=200):
    """Sampled bars against plain numpy on the host arrays."""
    ci = out["ci"].cpu().numpy()
    o = {k: v.cpu().numpy() for k, v in out["ohlcv"].items()}
    d = {k: v.cpu().numpy() for k, v in out["directional"].items()}
    g = np.random.default_rng(5)
    nonempty = np.flatnonzero(np.diff(ci) > 0)
    for k in g.choice(nonempty, min(n_sample, len(nonempty)), replace=False):
        s, e = ci[k] + 1, ci[k + 1] + 1
        tk = q.price_ticks[s:e].astype(np.float64) * q.tick_size
        want = {"open": tk[0], "high": tk.max(), "low": tk.min(), "close": tk[-1],
                "trades": e - s,
                "volume": np.float32(q.amount_units[s:e].sum() * q.amount_scale),
                "median_trade_size": np.median(amount[s:e].astype(np.float64))}
        for key, v in want.items():
            if o[key][k] != v:
                fail(f"bar {k} {key}: {o[key][k]!r} vs numpy {v!r}")
        for key, sd in (("ticks_buy", 1), ("ticks_sell", -1)):
            if d[key][k] != int((side[s:e] == sd).sum()):
                fail(f"bar {k} {key} differs from numpy")
    if not (ts[ci[1]] <= out["clock"][1].item() < ts[ci[1] + 1]):
        fail("first close index does not bracket the first clock value")


def make_month(n_trades):
    """The synthetic month, quantized on the host and copied to the card once;
    phases 5 and 6 share it."""
    from finmlkit_tpu_torch import interop
    from finmlkit_tpu_torch.bar.quantize import quantize_trades
    t0 = time.perf_counter()
    ts, price, amount, side = synth_trades(n_trades)
    t_synth = time.perf_counter() - t0
    t0 = time.perf_counter()
    q = quantize_trades(price, amount)
    t_quant = time.perf_counter() - t0
    if q is None:
        fail("synthetic prices do not quantize")
    say(f"month: {n_trades:,} trades synthesized in {t_synth:.1f} s, quantized "
        f"in {t_quant * 1e3:.0f} ms on the host (tick {q.tick_size})")
    tr = interop.from_numpy(q, None, side, amount, "cuda", timestamps=ts)
    return dict(n=n_trades, ts=ts, price=price, amount=amount, side=side, q=q,
                tr=tr)


def phase_month(card, month):
    import torch
    from finmlkit_tpu_torch import interop
    from finmlkit_tpu_torch.label.weights import return_attribution
    from finmlkit_tpu_torch.ops import fused_scan, prefix_scan
    from finmlkit_tpu_torch.testing import assert_exact, assert_window_close

    n_trades, ts, amount, side, q, tr = (month[k] for k in
                                         ("n", "ts", "amount", "side", "q", "tr"))

    def to_device():
        return interop.from_numpy(q, None, side, amount, "cuda", timestamps=ts)

    args = (tr, int(ts[0]), int(ts[-1]))
    run_slice(*args)                      # warm: allocator, build, caches
    run_slice(*args, plain=True)
    fused_scan.LAUNCHES = 0
    prefix_scan.LAUNCHES = 0
    k_out, st = run_slice(*args)          # the main path's counted run
    launches = {"B": fused_scan.LAUNCHES, "S": prefix_scan.LAUNCHES}
    if launches["B"] < 1 or launches["S"] < 1:
        fail(f"a kernel of the main path did not launch: {launches}")
    stages = {False: [st], True: []}
    p_out, st = run_slice(*args, plain=True)
    stages[True].append(st)
    for plain in (True, False, False, True):   # alternate kernel and plain
        stages[plain].append(run_slice(*args, plain=plain)[1])
    k_st, p_st = ({k: float(np.median([r[k] for r in stages[p]])) for k in st}
                  for p in (False, True))

    # --- kernel path == plain path ---
    for key in ("clock", "ci", "events", "conc"):
        assert_exact(k_out[key], p_out[key], key)
    for part in ("ohlcv", "directional"):
        for key in k_out[part]:
            assert_exact(k_out[part][key], p_out[part][key], f"{part}.{key}")
    assert_exact(k_out["labels"][0], p_out["labels"][0], "labels")
    assert_exact(k_out["labels"][1], p_out["labels"][1], "touch")
    assert_exact(k_out["labels"][2], p_out["labels"][2], "rets")
    assert_exact(k_out["labels"][3], p_out["labels"][3], "max_rb_ratios")
    conc = p_out["conc"].to(torch.float64)
    inv_scale = float(torch.where(conc > 0, 1.0 / conc.clamp(min=1), 0.0).sum())
    err_u = assert_window_close(k_out["w_u"], p_out["w_u"], inv_scale, 1e-12,
                                "uniqueness")
    # attribution: prefix of log returns over concurrency, times the
    # normalisation factor len(events) / sum(raw weights)
    close = p_out["ohlcv"]["close"]
    c = conc[1:]
    lr = torch.where(c > 0, torch.log(close[1:] / close[:-1]) / c.clamp(min=1), 0.0)
    raw = return_attribution(p_out["events"], p_out["labels"][1], close,
                             p_out["conc"], normalize=False,
                             cumsum=prefix_scan.fast_cumsum_plain)
    lr_scale = float(torch.cumsum(lr, 0).abs().max()) / float(raw.mean())
    err_r = assert_window_close(k_out["w_r"], p_out["w_r"], lr_scale, 1e-12,
                                "attribution")

    # --- the outputs are right: shapes, finite values, numpy on sampled bars ---
    ci = k_out["ci"]
    n_bars, n_ev = ci.shape[0] - 1, len(k_out["events"])
    o = k_out["ohlcv"]
    for key in ("open", "high", "low", "close", "volume", "vwap", "median_trade_size"):
        if o[key].shape != (n_bars,) or not bool(torch.isfinite(o[key]).all()):
            fail(f"ohlcv[{key}] is not {n_bars} finite values")
    if not bool(((o["low"] <= o["close"]) & (o["close"] <= o["high"])).all()):
        fail("close outside [low, high]")
    if int(ci[0]) != -1 or int(ci[-1]) != n_trades - 1 \
            or int(o["trades"].sum()) != n_trades:
        fail("the bars do not cover every trade exactly once")
    lab = k_out["labels"][0]
    if n_ev == 0 or not bool(((lab >= -1) & (lab <= 1)).all()):
        fail("no events or labels outside {-1, 0, 1}")
    for key in ("w_u", "w_r"):
        if not bool(torch.isfinite(k_out[key]).all()):
            fail(f"{key} not finite")
    check_bars_numpy(k_out, ts, q, amount, side)
    say(f"month: n_trades {n_trades:,}, n_bars {n_bars:,}, n_events {n_ev:,}, "
        f"launches {launches}; kernel path == plain path (bars, finals, "
        f"medians, events, labels exact; weights max abs diff {err_u:.3g} / "
        f"{err_r:.3g}); 200 bars == numpy")

    # --- kernels alone at the main path's shapes ---
    inv = torch.where(conc > 0, 1.0 / conc.clamp(min=1), 0.0)
    kernels = kernels_b_s(card, tr, ci, launches, s_inputs=(inv,))
    say("stage ms, median of 3 (kernel | plain): " + ", ".join(
        f"{k} {k_st[k]:.2f} | {p_st[k]:.2f}" for k in k_st) + f" [{card}]")

    # --- end to end, with and without the host->device copy ---
    def e2e(copy):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        t = to_device() if copy else tr
        inner = run_slice(t, int(ts[0]), int(ts[-1]))[1]["total"]
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b), inner
    e2e(True)
    for copy, what in ((False, "device-resident"), (True, "with the host->device copy")):
        t, inner = np.array([e2e(copy) for _ in range(7)]).T
        med = float(np.median(t))
        say(f"end to end (index -> weights), {what}: median {med:.2f} ms "
            f"(min {t.min():.2f}, max {t.max():.2f}, 7 runs; index -> weights "
            f"inside: median {np.median(inner):.2f} ms) = "
            f"{n_trades / med * 1e3:,.0f} trades/s [{card}]")
    return kernels


def kernels_b_s(card, tr, ci, launches, s_inputs=()):
    """Kernels B and S alone at a path's shapes: CUDA-event times against
    their plain versions and the largest difference from them (S on the
    path's bar-open marks and on ``s_inputs``). Returns their entries of the
    ``kernels`` line, with the path's ``launches``."""
    import torch
    from finmlkit_tpu_torch.ops.fused_scan import bar_scan_products, bar_scan_products_plain
    from finmlkit_tpu_torch.ops.prefix_scan import fast_cumsum, fast_cumsum_plain
    from finmlkit_tpu_torch.testing import assert_close
    n_trades, n_bars = tr.ticks.shape[0], ci.shape[0] - 1
    pargs = (tr.ticks, tr.units, tr.sides, ci)
    b_ms, b_plain = cuda_ms(lambda: bar_scan_products(*pargs)), \
        cuda_ms(lambda: bar_scan_products_plain(*pargs))
    marks = torch.zeros(n_trades, dtype=torch.int32, device="cuda")
    marks.index_add_(0, (ci[1:] + 1).clamp(0, n_trades - 1),
                     torch.ones(n_bars, dtype=torch.int32, device="cuda"))
    s_ms, s_plain = cuda_ms(lambda: fast_cumsum(marks)), \
        cuda_ms(lambda: fast_cumsum_plain(marks))
    s_err = max(assert_close(fast_cumsum(x), fast_cumsum_plain(x), rtol=1e-12,
                             what="S at the path's shapes") for x in (marks, *s_inputs))
    b_err = max(float((a.double() - b.double()).abs().max()) for a, b in
                zip(bar_scan_products(*pargs), bar_scan_products_plain(*pargs)))
    say(f"kernel B ({n_bars:,} bars) {b_ms:.3f} ms vs plain {b_plain:.3f} ms; "
        f"kernel S (int32, {n_trades:,}) {s_ms:.3f} ms vs plain {s_plain:.3f} "
        f"ms [{card}]")
    return {
        "B": {"name": "B bar_products (replaces K1a v4 and K1b v2)",
              "route": "cuda", "source": "finmlkit_tpu_torch/csrc/bar_products.cu",
              "replaces": "finmlkit_tpu/ops/fused_scan.py:1261",
              "launches": launches["B"], "max_abs_err": b_err, "ms": b_ms,
              "plain_ms": b_plain},
        "S": {"name": "S prefix_scan (replaces K2 and K3)", "route": "cuda",
              "source": "finmlkit_tpu_torch/csrc/prefix_scan.cu",
              "replaces": "finmlkit_tpu/ops/pallas_scan.py:141",
              "launches": launches["S"], "max_abs_err": s_err, "ms": s_ms,
              "plain_ms": s_plain},
    }


def run_dollar(tr, thr, plain=False):
    """The order-flow path on device tensors; returns outputs and stage times."""
    import torch
    from finmlkit_tpu_torch.bar.aggregate_q import bar_trade_size_features
    from finmlkit_tpu_torch.bar.footprint_q import bar_footprints
    from finmlkit_tpu_torch.bar.fused import bar_products_final
    from finmlkit_tpu_torch.bar.indexers import dollar_bar_indexer_q
    from finmlkit_tpu_torch.ops import fused_scan, prefix_scan
    scan = fused_scan.bar_scan_products_plain if plain else fused_scan.bar_scan_products
    cumsum = prefix_scan.fast_cumsum_plain if plain else prefix_scan.fast_cumsum
    cols = prefix_scan.fast_cumsum_cols_plain if plain else prefix_scan.fast_cumsum_cols
    marks = []

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append(e)

    mark()
    close_ts, ci = dollar_bar_indexer_q(tr.timestamps, tr.ticks, tr.units, thr,
                                        tr.tick_size, tr.amount_scale,
                                        cumsum=cumsum)
    mark()
    ohlcv, direc = bar_products_final(tr.ticks, tr.units, ci, tr.sides,
                                      tick_size=tr.tick_size,
                                      amount_scale=tr.amount_scale,
                                      amounts_f32=tr.amounts, scan=scan,
                                      cumsum=cumsum)
    mark()
    fp = bar_footprints(tr.ticks, tr.amounts, ci, tr.sides, ohlcv,
                        tick_size=tr.tick_size, imbalance_factor=3.0,
                        cumsum_cols=cols)
    mark()
    tsf = bar_trade_size_features(tr.units, tr.amounts, ci,
                                  ohlcv["median_trade_size"], theta_mult=5.0,
                                  amount_scale=tr.amount_scale, cumsum=cumsum,
                                  cumsum_cols=cols)
    mark()
    torch.cuda.synchronize()
    names = ("dollar index", "products+medians", "footprints", "trade size")
    stages = {k: marks[i].elapsed_time(marks[i + 1]) for i, k in enumerate(names)}
    stages["total"] = marks[0].elapsed_time(marks[-1])
    out = dict(close_ts=close_ts, ci=ci, ohlcv=ohlcv, directional=direc,
               footprints=fp, trade_size=tsf)
    return out, stages


def dollar_ci_numpy(q, thr):
    """The dollar-bar rule recomputed with numpy on the host arrays."""
    n = len(q.price_ticks)
    c = np.cumsum((q.price_ticks.astype(np.int64) * q.amount_units) >> 6)
    thr_s = float(thr) / (q.tick_size * q.amount_scale) / 64
    max_bars = min(max(int(float(c[-1]) / thr_s) + 1, 1), n)
    m = np.arange(1, max_bars + 1)
    u = np.ceil(m.astype(np.float64) * thr_s).astype(np.int64)
    naive = np.maximum(np.searchsorted(c, u, side="left"), 1)
    b = m + np.maximum.accumulate(naive - m)
    return np.concatenate([[0], b[b <= n - 1]])


def check_footprints_numpy(out, q, amount, side, n_sample=40):
    """Sampled footprint bars against np.add.at on the host arrays: ticks
    exact, volumes within rtol 1e-6 (the card may add a cell's float64
    amounts in another order). Returns (cells compared, cells not
    bit-equal)."""
    import torch
    from finmlkit_tpu_torch.testing import assert_close, assert_exact
    ci = out["ci"].cpu().numpy()
    fp = out["footprints"]
    low, nlev = fp["low_level"].cpu().numpy(), fp["n_levels"].cpu().numpy()
    L = fp["buy_volumes"].shape[1]
    ks = np.random.default_rng(6).choice(len(ci) - 1, n_sample, replace=False)
    at = torch.as_tensor(ks, device=fp["buy_volumes"].device)
    rows = {k: fp[k][at].cpu().numpy() for k in
            ("buy_volumes", "sell_volumes", "buy_ticks", "sell_ticks")}
    cells = off = 0
    for j, k in enumerate(ks):
        s, e = ci[k] + 1, ci[k + 1] + 1
        lvl = q.price_ticks[s:e].astype(np.int64) - low[k]
        if lvl.min() < 0 or lvl.max() >= nlev[k]:
            fail(f"bar {k}: a trade outside [low, low + n_levels)")
        for sd, vk, tk in ((1, "buy_volumes", "buy_ticks"),
                           (-1, "sell_volumes", "sell_ticks")):
            sel = side[s:e] == sd
            vol = np.zeros(L)
            np.add.at(vol, lvl[sel], amount[s:e][sel].astype(np.float64))
            assert_exact(rows[tk][j], np.bincount(lvl[sel], minlength=L).astype(np.int32),
                         f"bar {k} {tk}")
            assert_close(rows[vk][j], vol.astype(np.float32), rtol=1e-6,
                         what=f"bar {k} {vk}")
            cells += L
            off += int((rows[vk][j] != vol.astype(np.float32)).sum())
    return cells, off


def check_trade_size_numpy(out, q, amount, theta_mult=5.0, n_sample=40):
    """Sampled bars' median trade size (exact) and trade-size features with
    theta that median (rtol 1e-6 of the float32 outputs) against numpy in
    float64 on the host arrays."""
    import torch
    from finmlkit_tpu_torch.testing import assert_close, assert_exact
    ci = out["ci"].cpu().numpy()
    ks = np.random.default_rng(7).choice(len(ci) - 1, n_sample, replace=False)
    at = torch.as_tensor(ks, device=out["ci"].device)
    med = out["ohlcv"]["median_trade_size"][at].cpu().numpy()
    got = {k: v[at].cpu().numpy() for k, v in out["trade_size"].items()}
    want = {k: np.empty(n_sample) for k in got}
    want_med = np.empty(n_sample)
    asc = q.amount_scale
    for j, k in enumerate(ks):
        s, e = ci[k] + 1, ci[k + 1] + 1
        a, u = amount[s:e].astype(np.float64), q.amount_units[s:e]
        want_med[j] = np.median(a)
        thr = want_med[j] * theta_mult
        total = float(u.sum()) * asc
        qa = u * asc
        want["mean_size_rel"][j] = np.log1p(total / (e - s) / thr)
        want["size_95_rel"][j] = np.log1p(np.percentile(a, 95) / thr)
        want["pct_block"][j] = float(u[a > thr].sum()) * asc / total
        want["size_gini"][j] = 1.0 - (qa * qa).sum() / (total * total)
    assert_exact(med, want_med, "median_trade_size vs numpy")
    for key, v in want.items():
        assert_close(got[key], v.astype(np.float32), rtol=1e-6,
                     what=f"trade_size.{key} vs numpy")


def phase_dollar(card, month, with_bs=False, profile=False):
    import torch
    from finmlkit_tpu_torch.ops import fused_scan, prefix_scan
    from finmlkit_tpu_torch.ops.prefix_scan import (fast_cumsum_cols,
                                                    fast_cumsum_cols_plain)
    from finmlkit_tpu_torch.testing import assert_exact
    n_trades, price, amount, side, q, tr = (month[k] for k in
                                            ("n", "price", "amount", "side", "q", "tr"))
    thr = float((price * amount).sum()) / DOLLAR_BARS      # bench.py:784-786

    warm, _ = run_dollar(tr, thr)                  # warm: allocator, caches
    run_dollar(tr, thr, plain=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_scan.LAUNCHES = 0
    prefix_scan.LAUNCHES = 0
    prefix_scan.COLS_LAUNCHES = 0
    k_out, st = run_dollar(tr, thr)                # the path's counted run
    launches = {"B": fused_scan.LAUNCHES, "S": prefix_scan.LAUNCHES,
                "C": prefix_scan.COLS_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    if launches["C"] < 2 or launches["S"] < 1 or launches["B"] < 1:
        fail(f"a kernel of the order-flow path did not launch enough: {launches}")
    stages = {False: [st], True: []}
    p_out, st = run_dollar(tr, thr, plain=True)
    stages[True].append(st)
    for plain in (True, False, False, True):
        stages[plain].append(run_dollar(tr, thr, plain=plain)[1])
    k_st, p_st = ({k: float(np.median([r[k] for r in stages[p]])) for k in st}
                  for p in (False, True))

    # --- kernel path == plain path, and repeatable ---
    assert_exact(k_out["ci"], p_out["ci"], "dollar ci")
    assert_exact(k_out["close_ts"], p_out["close_ts"], "dollar close_ts")
    for part in ("ohlcv", "directional", "footprints", "trade_size"):
        for key in p_out[part]:
            assert_exact(k_out[part][key], p_out[part][key], f"{part}.{key}")
    for part in ("footprints", "trade_size"):
        for key in warm[part]:
            assert_exact(k_out[part][key], warm[part][key],
                         f"{part}.{key}, run to run")
    del warm, p_out

    # --- the outputs are right ---
    ci = k_out["ci"]
    ci_h = ci.cpu().numpy()
    assert_exact(ci_h, dollar_ci_numpy(q, thr), "dollar ci vs numpy")
    n_bars = len(ci_h) - 1
    o, fp, tsf = k_out["ohlcv"], k_out["footprints"], k_out["trade_size"]
    if not (0.9 * DOLLAR_BARS < n_bars <= DOLLAR_BARS) or ci_h[0] != 0:
        fail(f"{n_bars} dollar bars, ci[0] = {ci_h[0]}")
    if int(o["trades"].sum()) != int(ci_h[-1] - ci_h[0]) or int(o["trades"].min()) < 1:
        fail("dollar bars do not cover (ci[0], ci[-1]] once, or a bar is empty")
    L = fp["buy_volumes"].shape[1]
    if fp["buy_volumes"].shape != (n_bars, L) or int(fp["n_levels"].max()) > L:
        fail(f"footprint grid {tuple(fp['buy_volumes'].shape)}")
    n_counted = int(fp["buy_ticks"].sum() + fp["sell_ticks"].sum())
    sides_h = side[ci_h[0] + 1:ci_h[-1] + 1]
    if n_counted != int((sides_h != 0).sum()):
        fail(f"footprints count {n_counted} trades, the bars hold "
             f"{int((sides_h != 0).sum())} buys and sells")
    for key in ("vp_skew", "vp_gini"):
        if not bool(torch.isfinite(fp[key]).all()):
            fail(f"footprints.{key} not finite")
    for key, v in tsf.items():
        if v.shape != (n_bars,) or not bool(torch.isfinite(v).all()):
            fail(f"trade_size.{key} is not {n_bars} finite values")
    cells, off = check_footprints_numpy(k_out, q, amount, side)
    check_trade_size_numpy(k_out, q, amount)
    say(f"dollar: n_bars {n_bars:,} (ci[0] 0, {n_trades - 1 - int(ci_h[-1]):,} "
        f"trailing trades), L {L}, grid {n_bars * L:,} cells, launches "
        f"{launches}; kernel path == plain path (ci, bars, footprints, trade "
        f"size exact), footprints and trade size equal run to run, ci == "
        f"numpy, 40 bars' footprints == np.add.at ({off} of {cells:,} volume "
        f"cells differ in the last bit), 40 bars' trade size == numpy")
    say(f"dollar path peak device memory {peak / 2**30:.2f} GiB allocated "
        f"({(peak - base) / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB held "
        f"before the run) [{card}]")

    # --- kernel C alone at the path's shapes ---
    from finmlkit_tpu_torch.bar.footprint_q import _fp_rows
    low_t = fp["low_level"]
    rows32 = _fp_rows(ci, low_t, n_trades)
    rows64 = torch.stack([tr.units, tr.units])
    c_ms, c_plain, c_err = {}, {}, 0.0
    for name, x in (("int32", rows32), ("int64", rows64)):
        c_ms[name] = cuda_ms(lambda: fast_cumsum_cols(x))
        c_plain[name] = cuda_ms(lambda: fast_cumsum_cols_plain(x))
        c_err = max(c_err, float((fast_cumsum_cols(x) - fast_cumsum_cols_plain(x))
                                 .abs().max()))
    del rows32, rows64
    say(f"kernel C (2, {n_trades:,}): int32 {c_ms['int32']:.3f} ms vs "
        f"torch.cumsum {c_plain['int32']:.3f} ms; int64 {c_ms['int64']:.3f} ms "
        f"vs torch.cumsum {c_plain['int64']:.3f} ms [{card}]")
    kernels = {"C": {
        "name": "C prefix_scan_rows (replaces K4a and K4b)", "route": "cuda",
        "source": "finmlkit_tpu_torch/csrc/prefix_scan.cu",
        "replaces": "finmlkit_tpu/ops/pallas_scan.py:249 and :287",
        "launches": launches["C"], "max_abs_err": c_err, "ms": c_ms["int64"],
        "plain_ms": c_plain["int64"]}}
    if with_bs:       # phase 5 did not run: B and S at this path's shapes
        dollars = (tr.ticks.to(torch.int64) * tr.units) >> 6
        kernels.update(kernels_b_s(card, tr, ci, launches, s_inputs=(dollars,)))
        del dollars
    say("dollar stage ms, median of 3 (kernel | plain): " + ", ".join(
        f"{k} {k_st[k]:.2f} | {p_st[k]:.2f}" for k in k_st) + f" [{card}]")
    fp = fp if profile else None
    del k_out, o, tsf
    t = []
    for _ in range(7):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        run_dollar(tr, thr)
        b.record()
        torch.cuda.synchronize()
        t.append(a.elapsed_time(b))
    t = np.array(t)
    med = float(np.median(t))
    say(f"end to end (dollar index -> trade size), device-resident: median "
        f"{med:.2f} ms (min {t.min():.2f}, max {t.max():.2f}, 7 runs) = "
        f"{n_trades / med * 1e3:,.0f} trades/s [{card}]")
    if profile:
        profile_dollar(card, tr, thr, fp, med)
    return launches, kernels


def profile_dollar(card, tr, thr, fp, e2e_ms):
    """The footprint features alone (CUDA events), and one warm run of the
    order-flow path under torch.profiler: its 15 ops of most device time and
    the device's busy time against the end-to-end median."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from finmlkit_tpu_torch.bar.footprint import footprint_features_from_tensors
    keys = ("low_level", "n_levels", "buy_volumes", "sell_volumes", "buy_ticks",
            "sell_ticks")
    f_ms = cuda_ms(lambda: footprint_features_from_tensors(
        *(fp[k] for k in keys), 3.0))
    say(f"footprint features alone on the {tuple(fp['buy_volumes'].shape)} "
        f"grid: {f_ms:.2f} ms [{card}]")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_dollar(tr, thr)
    events = prof.key_averages()
    say(events.table(sort_by="self_device_time_total", row_limit=15))
    # the device's own events: the torch ops' rows repeat their kernels' time
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    say(f"profiled run: device busy {busy:.2f} ms against the end-to-end "
        f"median {e2e_ms:.2f} ms, idle share about "
        f"{max(0.0, 1 - busy / e2e_ms):.1%} [{card}]")


def main():
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--profile", action="store_true",
                    help="after phase 6, time the footprint features alone "
                         "and profile one run of the order-flow path")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    try:
        import torch
    except ImportError as e:
        fail(f"torch does not import: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an "
             "NVIDIA GPU")
    try:
        import finmlkit_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"finmlkit_tpu_torch does not import ({e}): run from the repository root")
    card = phase_env()
    phase_build()
    if 3 in phases:
        phase_scan()
    if 4 in phases:
        phase_products()
    kernels = {}
    month = make_month(N_MONTH) if phases & {5, 6} else None
    if 5 in phases:
        kernels = phase_month(card, month)
        for k in kernels.values():
            k["launches_by_path"] = {"time": k["launches"]}
    if 6 in phases:
        launches, dollar = phase_dollar(card, month, with_bs=5 not in phases,
                                        profile=args.profile)
        for name, n in launches.items():
            if name in kernels:                 # B and S, timed in phase 5
                kernels[name]["launches"] += n
            else:
                kernels[name] = dict(dollar[name], launches_by_path={})
            kernels[name]["launches_by_path"]["dollar"] = n
    say(f"smoke run: {time.perf_counter() - t_start:.1f} s, the kernels' build "
        f"included")
    if kernels:
        say(json.dumps({"kernels": list(kernels.values())}))
    leaked = [m for m in ("jax", "pandas", "finmlkit_tpu") if m in sys.modules]
    if leaked:
        fail(f"imported {leaked}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
