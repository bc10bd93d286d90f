#!/usr/bin/env python3
"""Smoke run of finmlkit_tpu_torch on one NVIDIA GPU.

Builds the package's CUDA kernels from ``finmlkit_tpu_torch/csrc`` and drives
the port's paths once at full size on a month of synthetic trades (the
generator of ``bench.py``, 39,171,929 trades at seed 0): the time-bar path
(1-minute time bars -> bar products and medians -> CUSUM events ->
triple-barrier labels -> uniqueness and return-attribution weights), the
order-flow path of ``bench.py`` config 2 (dollar bars at total dollars /
40000 -> bar products and medians -> dense footprints -> trade-size
features), the information-driven bars of config 6 through the kits, the
time bars' products through every median engine and bar scan, and the time
bars' features. Phases:

1. environment: torch, CUDA, nvcc, triton, the card's name and power limit;
2. build the kernels (``build/finmlkit_tpu_torch/``);
3. kernel S against its plain version (lengths 1, 4097, 8191, 8193,
   39,171,930) and kernel C against its plain version (1, 2 and 5 rows of 1,
   2047, 2049, 4097 and 39,171,930 values): int32 and int64 exact (int64
   rows that wrap past 2^63 beside rows that do not), float32 rtol 1e-5,
   float64 rtol 1e-12, floats equal from run to run;
4. kernel B and the medians against their plain versions on adversarial
   streams (empty, single-trade and side-0 trades, ci[0] >= 0, units above
   2^31, a bar of about 1M trades, bars that open on B's tile edges, 10,000
   empty bars inside one tile): exact; the hist and select engines
   (kernels H and F) against their plain versions and their brackets against
   the sort engine's on non-empty bars, the full planes (kernel V) against
   their plain version and their products against B's on non-empty bars,
   every engine and scan's finals against the default's: exact; B (alone
   and the call), H (held to its plain version there) and the planes call
   timed on one bar of the 1M trades alone;
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
   times, peak device memory. Without phase 5, B and S are timed here
   (B alone, with ``ci`` checked outside the timed window, each of its
   passes, and the call);
7. the information-driven bars on the same month through the kits, through
   the kernels and through the plain versions: tick bars of 1000 trades,
   volume bars at total volume / 40000, CUSUM bars (sigma 2e-5 with NaNs at
   the first 1,000 and at 1% of the trades, floor 1e-9, mult 60; also their
   trade-size features and footprints), imbalance bars (tick, theta 30) and
   run bars (tick, E0[T] 1000, E0[rate] 0.5, alphas 0.05), with OHLCV and
   directional features each. Close indices, bars, features and the filled
   sigma equal bit for bit (CUSUM closes may differ only at near ties, within
   1e-12 of lam); tick closes against arange, volume and imbalance closes
   against their integer rules and CUSUM closes against the float64 rule in
   numpy; F launched once and each of E's four scans at least once, the
   imbalance scan by E's map path and never by its walk; kernel F
   against its plain version on the month's sigma and phase 3's lengths,
   kernel E's four scans alone at their default chunk counts and at 1, 33,
   132 and 528 chunks (the same closes at each, timed), the imbalance scan
   by its map path and by the walk forced; kernel E against its plain
   version on volume-imbalance weights with a NaN or an infinite weight,
   and its CUSUM mode on non-finite returns and thresholds;
   stage times, peak device memory. B, S and C are timed here
   when phases 5 and 6 are skipped;
8. the engines on the month's 1-minute time bars (phase 5's close indices,
   or recomputed): ``bar_products_final`` with the median engines sort, hist
   and select times the scans rowtail (kernel B) and planes (kernel V),
   finals bit-identical to the default's; H launched 9 times a hist call,
   F 4 times a select call, V once and C never a planes call; kernel H
   against its plain version on every pass of the run, F's int32 fill on
   every fill of the select engine, the planes against the plain planes and
   their products against B's on non-empty bars, all exact; the floor probes
   P1, P2 (k = 1, 2, 4, 8) and P3 (kernel P) against ``torch.sum``, exact;
   each kernel alone timed with its bound (V's six passes and H's nine
   launches also one by one),
   each engine and scan's stage time and peak device memory. B, S and C are timed here when no earlier phase
   timed them;
9. the feature kernels on the month's 45,705 time bars (phase 5's, or built
   here): BASELINE config 4's six features (EWMA 20, Wilder RSI 14, ATR 14,
   the 1-bar log return, realized volatility 30, z-score 50) and every other
   function of ``feature/kernels`` once, the CSW test at window 1000 and its
   expanding form on the last 1,440 bars; each held to the same function run
   on the CPU (the plain path) from the same inputs: NaN positions, flags and
   the CSW critical values equal, floats within rtol and atol 1e-12; R and W
   launched; kernel R against its plain version (EWMA's recurrence at 1M
   points and span 100, a time-varying decay, y0, a NaN, lengths 1, 2047,
   2049 and the month's trade count; rtol 1e-12, equal run to run and beside
   another stream that keeps the SMs busy; its look-back distances, a call's
   wall and host time on the bars' count) and kernel W against its plain
   version bit for bit (50,000 log prices at window 500, the month's bars at
   1000, flat runs, the filter's adversarial series of
   ``testing.csw_filter_case``; the share of lags its pass 2 walks and
   divides), each timed with its bound; the six-feature pass as one stage,
   each function's time, peak device memory;
10. the feature framework and the volume profile: BASELINE config 4's kit
   (``FeatureKit``, topo order) on the month's time bars and its planned
   graph (``fuse.FusedGraph.run_device``), each output equal bit for bit to
   phase 9's direct call, both timed against the six functions; every
   transform class once through a kit rebuilt from its JSON config, each
   output held to the same kit run on the CPU (floats within rtol and atol
   1e-12, NaN positions, flags and integers exact; TrendSlope and the CSW
   scores within the conditioning of their closed forms, each one's largest
   share of its bound printed), each class's time; ``VolumePro`` (600 s window, 27 bins and none) on the
   dollar bars' footprints, rebuilt as phase 6 builds them: the windows'
   level spans and the value-area walks' step counts; kernel G against its
   plain version (levels exact, pct within rtol 1e-12) on the whole month or a
   leading run of bars, its global-scratch grid forced and its walks a warp
   each against its shared-memory grid and its walks a thread each, 20 bars
   against a numpy emulation, the developing profile over the last day by G's
   rows mode against plain (its walks a thread each too), the adversarial
   profiles of ``testing`` against plain; G timed with its bound, rolling and
   rows mode, at 27 bins and none; B, S, C, R, W and G launched on the
   phase's path; peak device memory.

Run from the repository root: ``python3 chip_smoke.py``; ``--phases 1,2,6``
runs only the order-flow path, ``--phases 1,2,7`` only the information-driven
bars, ``--phases 1,2,8`` only the engines, ``--phases 1,2,9`` only the
features, ``--phases 1,2,10`` only the framework and the profile, and
``--profile`` adds, after phase 6, the
footprint features' own time, a ``torch.profiler`` table of one run of the
order-flow path and its device idle share. Any failure exits non-zero
before the last line. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

N_MONTH = 39_171_929
SCAN_LENGTHS = (1, 4097, 8191, 8193, N_MONTH + 1)
COLS_ROWS = (1, 2, 5)
COLS_LENGTHS = (1, 2047, 2049, 4097, N_MONTH + 1)
DOLLAR_BARS = 40_000      # bench.py config 2: threshold = total dollars / 40000
# phase 7: bench.py config 6 (bench.py:852-958), plus tick and volume bars
INFO_TICKS = 1000         # tick bars of 1000 trades
VOLUME_BARS = 40_000      # volume bars at total volume / 40000
CUSUM_SIGMA, CUSUM_FLOOR, CUSUM_MULT = 2e-5, 1e-9, 60.0   # bench.py:861-865
IMB_THETA = 30.0          # imbalance bars, tick mode, fixed theta (:914-915)
RUN_EMA = dict(expected_ticks_init=1000.0, expected_rate_init=0.5,
               alpha_ticks=0.05, alpha_rate=0.05)          # run bars (:935-938)
FFILL_MASKS = ("all_valid", "none_valid", "leading_invalid")
# phase 8: the median engines and bar scans of bar_products_final
ENGINES = ("sort", "hist", "select")
SCANS = ("rowtail", "planes")
IO_FLOOR_K = (1, 2, 4, 8)
E_MODES = {"cusum": 0, "imbalance": 1, "run": 2, "volume": 3}  # kernel E's modes
E_CHUNKS = (1, 33, 132, 528)   # kernel E's chunk counts timed and held to its default
# the least time of a kernel: its bytes (each input read once, each output
# written once) at the H100 SXM's 3.35 TB/s, or its operations at its float32
# vector peak of 67 TFLOP/s (NVIDIA's data sheet), whichever is larger; every
# kernel here does so few operations a byte that the bytes bound it
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_F64_OPS_PER_S = 34e12   # the float64 vector peak (NVIDIA's data sheet)
# phase 9: the feature kernels on the month's time bars
FEATURE_RTOL = FEATURE_ATOL = 1e-12
CSW_WINDOW = 1000            # cusum_test_rolling's default window
DAY_BARS = 1440              # cusum_test_developing on the last day (O(n^2))
R_LENGTHS = (1, 2047, 2049, 1_000_000, N_MONTH)   # kernel R: around its tile
# phase 10: the feature framework and the volume profile
PROFILE_WINDOW = 600.0       # seconds (tests/features/test_volume_profile.py:100)
PROFILE_BINS = (27, None)    # VolumePro's default bins, and none
PROFILE_VA = 68.34           # VolumePro's default value-area share
PROFILE_PLAIN_S = 60.0       # the plain profile runs on the whole month if it takes less
PROFILE_SHARED_CAP = 64      # levels: forces kernel G's global-scratch grid


# name, source in finmlkit_tpu_torch/csrc and the functions it replaces (the
# TPU kernels' defs, file:line) of each kernel of the ``kernels`` line
KERNELS = {
    "B": ("B bar_products, a pass over tiles with an exact carry (replaces K1a v4 "
          "and K1b v2; serves K1d v3)",
          "bar_products.cu", "finmlkit_tpu/ops/fused_scan.py:1261, :1319 and :1288"),
    "S": ("S prefix_scan (replaces K2 and K3)", "prefix_scan.cu",
          "finmlkit_tpu/ops/pallas_scan.py:141 and :182"),
    "C": ("C prefix_scan_rows (replaces K4a and K4b)",
          "prefix_scan.cu", "finmlkit_tpu/ops/pallas_scan.py:249 and :287"),
    "F": ("F ffill, one look-back pass (replaces K5; L1 in its int32 mode)", "ffill.cu",
          "finmlkit_tpu/ops/pallas_scan.py:84 and finmlkit_tpu/ops/segment_select.py:73"),
    **{f"E {scan}": (f"E event_scan, {scan} bars{how} (replaces an XLA "
                     "while_loop, not a TPU kernel)", "event_scan.cu",
                     f"finmlkit_tpu/bar/indexers.py:{line}")
       for scan, line, how in (("cusum", 508, ""),
                               ("imbalance", 680, ", a scan of tile maps at a fixed "
                                "theta on integer weights"),
                               ("run", 680, ""), ("volume", 368, ""))},
    "H": ("H segment_hist, a pass over tiles (replaces H1 and H2)", "segment_hist.cu",
          "finmlkit_tpu/ops/segment_hist.py:106 and :167"),
    "V": ("V bar_planes, a segmented scan over tiles (replaces K1c)", "bar_planes.cu",
          "finmlkit_tpu/ops/fused_scan.py:1342"),
    "P": ("P io_floor (replaces P1, P2 and P3)", "io_floor.cu",
          "finmlkit_tpu/ops/fused_scan.py:1185, :1213 and :1236"),
    "R": ("R recurrence, one pass over tiles of affine maps with a look-back whose "
          "carries a warp scan a group of 32 tiles and a scalar chain over the groups fix "
          "(replaces an XLA associative_scan, not a TPU kernel)", "recurrence.cu",
          "finmlkit_tpu/ops/scan.py:21"),
    "W": ("W csw, the CSW sup statistic, a warp per t: a division-free pass bounds "
          "each side, then the exact quotients of the lags that may win (replaces an XLA "
          "lax.map, not a TPU kernel)", "csw.cu",
          "finmlkit_tpu/feature/kernels/structural_break.py:23 and :55"),
    "G": ("G volume_profile, the rolling and developing value area: a block a profile on "
          "its span, then the walks a thread or a warp each (replaces an XLA lax.map, not a "
          "TPU kernel)", "volume_profile.cu",
          "finmlkit_tpu/feature/kernels/volume.py:191 and :347"),
}


def say(msg):
    print(msg, flush=True)


def kernel_entry(key, launches, err, ms, plain_ms, bound_ms, library_ms, **extra):
    """One kernel's entry of the ``kernels`` line; ``bound_ms`` is a
    ``bound()`` pair."""
    name, source, replaces = KERNELS[key]
    return {"name": name, "route": "cuda",
            "source": f"finmlkit_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms[0], "bound_by": bound_ms[1],
            "library_ms": library_ms, **extra}


def bound(nbytes, ops, peak=PEAK_OPS_PER_S):
    """``(bound_ms, bound_by)`` of the ``kernels`` line; ``peak`` is the
    operations' rate (float32 unless given)."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


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
                assert_exact(fast_cumsum(x), got, f"{what} run to run")
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
                    assert_exact(fast_cumsum_cols(x), got, f"{what} run to run")
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
    from finmlkit_tpu_torch.ops.fused_scan import _TILE
    from finmlkit_tpu_torch.ops.prefix_scan import fast_cumsum_plain
    from finmlkit_tpu_torch.testing import adversarial_trades, assert_exact, tile_closes
    cases = [dict(n=3_000_000, seed=1, first=-1, long_bar=1_000_000),
             dict(n=400_000, seed=2, first=17, long_bar=40_000),
             dict(n=200_000, seed=3, first=0, mean_bar=3),
             dict(n=12, seed=4, first=-1, mean_bar=2),
             # bars that open on kernel B's tile edges; 10,000 empty bars in a tile
             dict(n=5 * _TILE + 13, seed=5, closes="edges"),
             dict(n=5 * _TILE + 13, seed=6, closes="empty_run")]
    for c in cases:
        kw = {k: v for k, v in c.items() if k != "closes"}
        arrs = list(adversarial_trades(**kw))
        if "closes" in c:
            arrs[4] = tile_closes(c["closes"], c["n"], _TILE)
        ticks, units, sides, amounts, ci = (torch.from_numpy(a).cuda() for a in arrs)
        got = bar_scan_products(ticks, units, sides, ci)
        want = bar_scan_products_plain(ticks, units, sides, ci)
        for name, a, b in zip(("p64", "p32", "pf"), got, want):
            assert_exact(a, b, f"B {name} {c}")
        ma, mb = median_pairs(amounts, ci)
        pa, pb = median_pairs(amounts, ci, cumsum=fast_cumsum_plain)
        assert_exact(ma, pa, f"median a {c}")
        assert_exact(mb, pb, f"median b {c}")
        check_engines_and_planes(ticks, units, sides, amounts, ci, str(c))
        counts = np.diff(arrs[4])
        say(f"  B case {c}: {len(counts)} bars ({int((counts == 0).sum())} "
            f"empty, {int((counts == 1).sum())} single, longest "
            f"{int(counts.max())}), units max {int(arrs[1].max())}: exact")
    # bars whose base at the hist engine's last shift lies 2^30 from their
    # zeros or their 2.0: kernel H's bucket of +-2^30 counts nowhere
    from finmlkit_tpu_torch.bar.fused import median_engine
    from finmlkit_tpu_torch.testing import zeros_and_twos
    amounts, ci = (t.cuda() for t in zeros_and_twos(2000))
    for m in ("hist", "select"):
        for name, a, b, c in zip(("a", "b"), median_engine(m)(amounts, ci),
                                 median_engine(m, plain=True)(amounts, ci),
                                 median_pairs(amounts, ci)):
            assert_exact(a, b, f"{m} med_{name} vs plain, zeros and twos")
            assert_exact(a, c, f"{m} med_{name} vs sort, zeros and twos")
    say("phase 4 ok: B and medians == plain, the hist and select engines and the "
        "full planes == plain and == sort / B, every engine and scan's finals "
        "== the default's, on every adversarial case and on bars of 0.0 and 2.0")
    long_bar_times(cases[0]["long_bar"])


def check_engines_and_planes(ticks, units, sides, amounts, ci, what):
    """The hist and select engines and the full planes on one stream: against
    their plain versions everywhere, the brackets against the sort engine's
    and the planes' products against kernel B's on non-empty bars, and every
    engine and scan's finals against the default's. All exact."""
    from finmlkit_tpu_torch.bar.fused import (bar_products_final, median_engine,
                                              median_pairs, planes_products)
    from finmlkit_tpu_torch.ops.fused_scan import (bar_scan_planes,
                                                   bar_scan_planes_plain,
                                                   bar_scan_products)
    from finmlkit_tpu_torch.testing import assert_exact
    ne = ci[1:] > ci[:-1]
    sort = median_pairs(amounts, ci)
    for m in ("hist", "select"):
        got = median_engine(m)(amounts, ci)
        want = median_engine(m, plain=True)(amounts, ci)
        for name, a, b, c in zip(("a", "b"), got, want, sort):
            assert_exact(a, b, f"{m} med_{name} vs plain, {what}")
            assert_exact(a[ne], c[ne], f"{m} med_{name} vs sort, {what}")
    planes = bar_scan_planes(ticks, units, sides, ci)
    for name, a, b in zip(("pre64", "pre32", "ext32", "extf"), planes,
                          bar_scan_planes_plain(ticks, units, sides, ci)):
        assert_exact(a, b, f"planes {name} vs plain, {what}")
    del planes
    for a, b in zip(planes_products(ticks, units, sides, ci),
                    bar_scan_products(ticks, units, sides, ci)):
        assert_exact(a[:, ne], b[:, ne], f"planes products vs B, {what}")
    kw = dict(tick_size=0.1, amount_scale=1e-8, amounts_f32=amounts)
    ref = bar_products_final(ticks, units, ci, sides, **kw)
    for m in ENGINES:
        for sc in SCANS:
            scan = planes_products if sc == "planes" else bar_scan_products
            got = bar_products_final(ticks, units, ci, sides, medians=m, scan=scan, **kw)
            for part, want in zip(got, ref):
                for key in want:
                    assert_exact(part[key], want[key], f"{m}/{sc} finals {key}, {what}")


def long_bar_times(n_long):
    """Kernel B (alone and the call), the planes call (kernel V) and kernel H
    (one histogram pass, one less pass, each held to its plain version), all
    over fixed tiles of trades, on one bar of ``n_long`` trades."""
    import torch
    from finmlkit_tpu_torch.ops import fused_scan as fs
    from finmlkit_tpu_torch.ops import segment_hist as sh
    from finmlkit_tpu_torch.testing import adversarial_trades, assert_exact
    ticks, units, sides, amounts, _ = (torch.from_numpy(a).cuda() for a in
                                       adversarial_trades(n=n_long, seed=1))
    ci = torch.tensor([-1, n_long - 1], device="cuda")
    bits = amounts.view(torch.int32)
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    args = fs._cuda_inputs(ticks, units, sides, ci, "phase 4")
    bufs = fs._products_buffers(n_long, 1, ci.device)
    assert_exact(sh.hist_pass(bits, ci, zero, 28), sh.hist_pass_plain(bits, ci, zero, 28),
                 "H hist pass on the long bar")
    for a, b in zip(sh.less_pass(bits, ci, bits[:1]), sh.less_pass_plain(bits, ci, bits[:1])):
        assert_exact(a, b, "H less pass on the long bar")
    # B and H without the wrappers' check of ci (the engine checks once)
    t = {"B alone": cuda_ms(lambda: fs._products_kernel(*args, bufs), reps=20),
         "B call": cuda_ms(lambda: fs.bar_scan_products(ticks, units, sides, ci), reps=20),
         "H hist pass": cuda_ms(lambda: sh._launch_hist(bits, ci, zero, 28)),
         "H less pass": cuda_ms(lambda: sh._launch_less(bits, ci, bits[:1])),
         "V planes call": cuda_ms(lambda: fs.bar_scan_planes(ticks, units, sides, ci))}
    say(f"one bar of {n_long:,} trades (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in t.items()) + f"; B's bytes bound "
        f"{bound(13 * n_long, 0)[0]:.4f} ms, an H pass's {bound(4 * n_long, 0)[0]:.4f} "
        f"ms; H == plain on both passes")


def run_slice(tr, ts_first, ts_last, plain=False):
    """The main path on device tensors; returns outputs and stage times (ms)."""
    import torch
    from finmlkit_tpu_torch.bar.fused import bar_products_final, median_engine
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
                                      medians=median_engine("sort", plain=plain))
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
    prefix_scan.LAUNCHES = prefix_scan.FLOAT_LAUNCHES = 0
    k_out, st = run_slice(*args)          # the main path's counted run
    launches = {"B": fused_scan.LAUNCHES, "S": prefix_scan.LAUNCHES,
                "S float": prefix_scan.FLOAT_LAUNCHES}
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
    month["ci_time"] = ci                 # phases 8 and 9 take the same bars
    month["bars_time"] = (k_out["ohlcv"], k_out["directional"],
                          k_out["clock"][1:ci.shape[0]])
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
    return launches, kernels


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
    from finmlkit_tpu_torch.ops import fused_scan as fs
    pargs = (tr.ticks, tr.units, tr.sides, ci)
    # B alone: ci checked once and the buffers made once, outside the timed
    # window; then each of its passes on the state the passes before it left
    b_args = fs._cuda_inputs(*pargs, "kernel B alone")
    bufs = fs._products_buffers(n_trades, n_bars, ci.device)
    b_ms = cuda_ms(lambda: fs._products_kernel(*b_args, bufs))
    b_pass = {name: cuda_ms(lambda p=p: fs._products_kernel(*b_args, bufs, passes=1 << p))
              for p, name in enumerate(fs.PRODUCTS_PASSES)}
    del bufs
    b_call, b_plain = cuda_ms(lambda: bar_scan_products(*pargs)), \
        cuda_ms(lambda: bar_scan_products_plain(*pargs))
    marks = torch.zeros(n_trades, dtype=torch.int32, device="cuda")
    marks.index_add_(0, (ci[1:] + 1).clamp(0, n_trades - 1),
                     torch.ones(n_bars, dtype=torch.int32, device="cuda"))
    s_ms, s_plain = cuda_ms(lambda: fast_cumsum(marks)), \
        cuda_ms(lambda: fast_cumsum_plain(marks))
    s_lib = cuda_ms(lambda: torch.cumsum(marks, 0, dtype=marks.dtype))
    units = tr.units                                    # the int64 month stream
    s64_ms, s64_lib, s64_plain = cuda_ms(lambda: fast_cumsum(units)), \
        cuda_ms(lambda: torch.cumsum(units, 0)), cuda_ms(lambda: fast_cumsum_plain(units))
    # B reads 13 bytes a trade and the close indices, writes 104 bytes a bar
    b_bound = bound(13 * n_trades + 8 * (n_bars + 1) + 104 * n_bars,
                    40 * n_trades)
    s_bound = bound(8 * n_trades, n_trades)
    s_err = max(assert_close(fast_cumsum(x), fast_cumsum_plain(x), rtol=1e-12,
                             what="S at the path's shapes")
                for x in (marks, units, *s_inputs))
    b_err = max(float((a.double() - b.double()).abs().max()) for a, b in
                zip(bar_scan_products(*pargs), bar_scan_products_plain(*pargs)))
    say(f"kernel B ({n_bars:,} bars) alone {b_ms:.3f} ms (passes " + ", ".join(
        f"{k} {v:.3f}" for k, v in b_pass.items()) + f"), the call {b_call:.3f} ms "
        f"vs plain {b_plain:.3f} ms, bound {b_bound[0]:.3f} ms; kernel S (int32, {n_trades:,}) {s_ms:.3f} "
        f"ms vs plain {s_plain:.3f} ms, torch.cumsum {s_lib:.3f} ms, bound "
        f"{s_bound[0]:.3f} ms; S (int64) {s64_ms:.3f} ms vs plain {s64_plain:.3f} ms, "
        f"torch.cumsum {s64_lib:.3f} ms, bound {2 * s_bound[0]:.3f} ms [{card}]")
    return {
        "B": kernel_entry("B", launches["B"], b_err, b_ms, b_plain, b_bound, None,
                          call_ms=b_call, pass_ms=b_pass),
        "S": kernel_entry("S", launches["S"], s_err, s_ms, s_plain, s_bound, s_lib,
                          int64_ms=s64_ms, int64_plain_ms=s64_plain,
                          int64_library_ms=s64_lib, int64_bound_ms=2 * s_bound[0]),
    }


def kernel_c(card, tr, ci, low_t, launches):
    """Kernel C alone at a path's shapes (the footprints' int32 rows and the
    trade size's int64 unit rows): its ``kernels`` entry, with the int64
    time."""
    import torch
    from finmlkit_tpu_torch.bar.footprint_q import _fp_rows
    from finmlkit_tpu_torch.ops.prefix_scan import (fast_cumsum_cols,
                                                    fast_cumsum_cols_plain)
    n_trades = tr.ticks.shape[0]
    rows32 = _fp_rows(ci, low_t, n_trades)
    rows64 = torch.stack([tr.units, tr.units])
    c_ms, c_plain, c_err = {}, {}, 0.0
    for name, x in (("int32", rows32), ("int64", rows64)):
        c_ms[name] = cuda_ms(lambda: fast_cumsum_cols(x))
        c_plain[name] = cuda_ms(lambda: fast_cumsum_cols_plain(x))
        c_err = max(c_err, float((fast_cumsum_cols(x) - fast_cumsum_cols_plain(x))
                                 .abs().max()))
    c_lib = cuda_ms(lambda: torch.cumsum(rows64, 1))
    del rows32, rows64
    c_bound = bound(2 * 16 * n_trades, 2 * n_trades)   # int64 (2, n) in and out
    say(f"kernel C (2, {n_trades:,}): int32 {c_ms['int32']:.3f} ms vs "
        f"plain {c_plain['int32']:.3f} ms; int64 {c_ms['int64']:.3f} ms vs "
        f"plain {c_plain['int64']:.3f} ms, torch.cumsum(x, 1) {c_lib:.3f} ms, "
        f"bound {c_bound[0]:.3f} ms [{card}]")
    return kernel_entry("C", launches["C"], c_err, c_ms["int64"], c_plain["int64"],
                        c_bound, c_lib, int32_ms=c_ms["int32"])


def run_dollar(tr, thr, plain=False):
    """The order-flow path on device tensors; returns outputs and stage times."""
    import torch
    from finmlkit_tpu_torch.bar.aggregate_q import bar_trade_size_features
    from finmlkit_tpu_torch.bar.footprint_q import bar_footprints
    from finmlkit_tpu_torch.bar.fused import bar_products_final, median_engine
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
                                      medians=median_engine("sort", plain=plain))
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
    prefix_scan.LAUNCHES = prefix_scan.FLOAT_LAUNCHES = 0
    prefix_scan.COLS_LAUNCHES = 0
    k_out, st = run_dollar(tr, thr)                # the path's counted run
    launches = {"B": fused_scan.LAUNCHES, "S": prefix_scan.LAUNCHES,
                "S float": prefix_scan.FLOAT_LAUNCHES,
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

    kernels = {"C": kernel_c(card, tr, ci, fp["low_level"], launches)}
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

def trace_device_ms(fn):
    """One warm call of ``fn`` under torch.profiler: the device time of each
    kernel it launched (ms, by name, largest first) and their sum."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    times = {e.key[:60]: e.self_device_time_total / 1e3 for e in dev}
    return times, sum(times.values())


def info_sigma(n, seed=0):
    """The CUSUM bars' sigma: 2e-5 a trade (bench.py:861), NaN at the first
    1,000 trades and at 1% of the trades drawn from the seed, so that kernel
    F has gaps to fill."""
    sigma = np.full(n, CUSUM_SIGMA)
    sigma[:1000] = np.nan
    sigma[np.random.default_rng(seed).random(n) < 0.01] = np.nan
    return sigma


def info_kits(month, device="cuda", plain=False):
    """The five kits of phase 7 on the month; each quantizes the trades on
    the host and copies them to ``device`` once."""
    from finmlkit_tpu_torch.bar import kit
    cols = tuple(month[k] for k in ("ts", "price", "amount", "side"))
    kw = dict(device=device, plain=plain)
    vol_thr = float(month["amount"].astype(np.float64).sum()) / VOLUME_BARS
    return {
        "tick": kit.TickBarKit(*cols, INFO_TICKS, **kw),
        "volume": kit.VolumeBarKit(*cols, vol_thr, **kw),
        "cusum": kit.CUSUMBarKit(*cols, month["sigma"], CUSUM_FLOOR, CUSUM_MULT,
                                 **kw),
        "imbalance": kit.ImbalanceBarKit(*cols, threshold=IMB_THETA, **kw),
        "run": kit.RunBarKit(*cols, **RUN_EMA, **kw),
    }


def run_info(kits, event):
    """The information-driven bar path through the kits: close indices, bar
    products, and for the CUSUM bars trade-size features (theta the bar's
    median trade size, mult 5), footprints and the filled sigma at the
    closes. ``event()`` returns a recorded timing event. Returns outputs and
    stage times (ms) per bar type."""
    out, marks = {}, {}
    for name, k in kits.items():
        m = [event()]
        res = {"closes": k.bar_close_indices}
        m.append(event())
        res["ohlcv"] = k.build_ohlcv()
        res["directional"] = k.build_directional_features()
        m.append(event())
        if name == "cusum":
            res["trade_size"] = k.build_trade_size_features(
                res["ohlcv"]["median_trade_size"], 5.0)
            res["footprints"] = k.build_footprints()
            res["sigma"] = k.get_sigma()
            m.append(event())
        out[name], marks[name] = res, m
    stages = {}
    for name, m in marks.items():
        m[-1].synchronize()
        names = ("index", "products", "trade size+footprints")
        stages[name] = {names[i]: m[i].elapsed_time(m[i + 1])
                        for i in range(len(m) - 1)}
    return out, stages


def _inner_max(x, starts, ends):
    """max of x[starts[k]:ends[k]] for each k (-inf where empty), by
    np.maximum.reduceat; the ranges are ascending and disjoint."""
    out = np.full(len(starts), -np.inf)
    ne = ends > starts
    if ne.any():
        idx = np.stack([starts[ne], ends[ne]], 1).ravel()  # ends < len(x)
        out[ne] = np.maximum.reduceat(x, idx)[::2]
    return out


def threshold_rule_numpy(prefix, ci, thr, what, absolute=False, base0=None):
    """Close indices ``ci`` (bar k holds trades (ci[k], ci[k+1]]) against a
    reset-at-close threshold rule, vectorised over all bars on the host: the
    in-bar statistic ``prefix[t] - prefix[ci[k]]`` (``base0`` in place of the
    first bar's base; its absolute value if ``absolute``) reaches ``thr`` at
    every close and at no earlier trade of the bar, and not after the last
    close."""
    n = len(prefix)
    closes = ci[1:]
    bar = np.searchsorted(closes, np.arange(n), side="left")
    base = prefix[ci[np.minimum(bar, len(ci) - 1)]]
    if base0 is not None:
        base[bar == 0] = base0
    stat = prefix - base
    del bar, base
    if absolute:
        stat = np.abs(stat)
    if not bool((stat[closes] >= thr).all()):
        fail(f"{what}: a bar closes below the threshold")
    inner = _inner_max(stat, ci[:-1] + 1, closes)
    if bool((inner >= thr).any()):
        fail(f"{what}: a bar reaches the threshold before its close")
    if ci[-1] + 1 < n and stat[ci[-1] + 1:].max() >= thr:
        fail(f"{what}: the trades after the last close reach the threshold")


def cusum_rule_numpy(ts, price, sigma, ci, tol=1e-12):
    """CUSUM close indices against the rule in float64 on the host, bar by
    bar in closed form (``s+ = max(s0 + R, R - cummin R)``, ``s- = min(s0 +
    R, R - cummax R)`` over the bar's prefix R of log returns): every close
    crosses ``lam`` and no earlier trade of its bar does, except where a
    statistic lies within ``tol`` relative of ``lam`` (a near tie, where sums
    taken in another order may decide otherwise). Returns the near ties."""
    n = len(price)
    isnan = np.isnan(sigma)
    last = np.maximum.accumulate(np.where(isnan, -1, np.arange(n)))
    lam = np.maximum(CUSUM_MULT * sigma[np.clip(last, 0, n - 1)], CUSUM_FLOOR)
    rets = np.concatenate([[0.0], np.diff(np.log(price))])
    can = np.concatenate([ts[:-1] != ts[1:], [True]])
    if ci[0] != int(np.argmin(isnan)):
        fail(f"cusum ci[0] = {ci[0]}, not the first valid sigma")
    sp = sn = 0.0
    ties = 0
    bounds = np.concatenate([ci, [n - 1]]) if ci[-1] < n - 1 else ci
    for k in range(len(bounds) - 1):
        a, b = bounds[k], bounds[k + 1]
        r, lm, cc = rets[a + 1:b + 1], lam[a + 1:b + 1], can[a + 1:b + 1]
        big = np.cumsum(r)
        s_pos = np.maximum(sp + big, big - np.minimum.accumulate(big))
        s_neg = np.minimum(sn + big, big - np.maximum.accumulate(big))
        up, dn = (s_pos - lm) / lm, (-s_neg - lm) / lm
        hit = cc & ((up >= 0) | (dn >= 0))
        near = cc & ((np.abs(up) <= tol) | (np.abs(dn) <= tol))
        closing = k < len(ci) - 1
        inner_hit = hit[:-1] if closing else hit
        if bool((inner_hit & ~near[:len(inner_hit)]).any()):
            fail(f"cusum bar {k}: the statistic crosses lam before the close")
        ties += int(inner_hit.sum())
        if closing:
            if not (hit[-1] or near[-1]):
                fail(f"cusum bar {k}: the close at {b} does not cross lam")
            ties += int(near[-1] and not hit[-1])
            if up[-1] >= -tol:
                sp, sn = 0.0, s_neg[-1]
            else:
                sp, sn = s_pos[-1], 0.0
    return ties


def phase_info(card, month, need):
    """Phase 7: tick, volume, CUSUM, imbalance and run bars through the
    kits on the month, kernel path against plain path, host rule checks,
    kernels F and E alone. ``need`` names the kernels of B, S and C that no
    earlier phase timed. Returns the path's launches and ``kernels``
    entries."""
    import torch
    from finmlkit_tpu_torch.ops import event_scan, fused_scan, prefix_scan
    from finmlkit_tpu_torch.testing import assert_exact
    n = month["n"]
    month["sigma"] = info_sigma(n)

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def counters():
        return {"B": fused_scan.LAUNCHES, "S": prefix_scan.LAUNCHES,
                "S float": prefix_scan.FLOAT_LAUNCHES,
                "C": prefix_scan.COLS_LAUNCHES, "F": prefix_scan.FFILL_LAUNCHES,
                **{f"E {scan}": event_scan.MODE_LAUNCHES[mode]
                   + (event_scan.MODE_LAUNCHES[event_scan._IMBALANCE_MAP]
                      if mode == event_scan._IMBALANCE else 0)
                   for scan, mode in E_MODES.items()}}

    kits = info_kits(month)
    run_info(kits, event)                      # warm: allocator, caches
    del kits
    kits = info_kits(month)                    # host quantization, copies
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_scan.LAUNCHES = prefix_scan.LAUNCHES = prefix_scan.COLS_LAUNCHES = 0
    prefix_scan.FLOAT_LAUNCHES = prefix_scan.FFILL_LAUNCHES = event_scan.LAUNCHES = 0
    event_scan.MODE_LAUNCHES[:] = [0] * len(event_scan.MODE_LAUNCHES)
    k_out, k_st = run_info(kits, event)        # the path's counted run
    launches = counters()
    imb_paths = {"map": event_scan.MODE_LAUNCHES[event_scan._IMBALANCE_MAP],
                 "walk": event_scan.MODE_LAUNCHES[event_scan._IMBALANCE]}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    tr = kits["cusum"].trades
    del kits
    if launches["F"] != 1 or min(launches[k] for k in (
            "B", "S", "C", *(f"E {scan}" for scan in E_MODES))) < 1:
        fail(f"a kernel of the information-bar path did not launch as it "
             f"should (F once, each of E's scans at least once): {launches}")
    if launches["S"] < sum(launches[f"E {scan}"] for scan in E_MODES):
        fail(f"kernel S launched fewer times than kernel E, whose every scan "
             f"compacts its closes with S: {launches}")
    if imb_paths["map"] < 1 or imb_paths["walk"] != 0:
        fail(f"the tick imbalance bars did not take kernel E's map path: "
             f"launches by path {imb_paths}")
    t0 = time.perf_counter()
    p_out, p_st = run_info(info_kits(month, plain=True), event)
    t_plain = time.perf_counter() - t0

    # --- kernel path == plain path ---
    ties_kp = 0
    for name in k_out:
        kc, pc = k_out[name]["closes"], p_out[name]["closes"]
        same = kc.shape == pc.shape and bool((kc == pc).all())
        if not same and name != "cusum":
            assert_exact(kc, pc, f"{name} close indices")
        if not same:                           # CUSUM near ties only
            m = min(len(kc), len(pc))
            first = int(torch.nonzero(kc[:m] != pc[:m])[0]) if bool(
                (kc[:m] != pc[:m]).any()) else m
            ties_kp = len(kc) + len(pc) - 2 * first
            say(f"cusum close indices differ from bar {first} on "
                f"(kernel {len(kc):,} bars, plain {len(pc):,})")
            continue                           # both are held to the rule below
        for part in ("ohlcv", "directional", "trade_size", "footprints"):
            for key, v in k_out[name].get(part, {}).items():
                assert_exact(v, p_out[name][part][key], f"{name} {part}.{key}")
        if name == "cusum":
            assert_exact(k_out[name]["sigma"], p_out[name]["sigma"],
                         "cusum filled sigma at the closes")

    # --- the outputs are right: host rules, shapes, finite values ---
    ts, price, amount, side, q = (month[k] for k in
                                  ("ts", "price", "amount", "side", "q"))
    cis = {name: np.concatenate([[0], r["closes"].cpu().numpy()])
           for name, r in k_out.items()}
    assert_exact(cis["tick"], np.concatenate(
        [[0], np.arange(INFO_TICKS - 1, n, INFO_TICKS)]), "tick ci")
    thr_units = math.ceil(float(amount.astype(np.float64).sum()) / VOLUME_BARS
                          / q.amount_scale)
    threshold_rule_numpy(np.cumsum(q.amount_units), cis["volume"], thr_units,
                         "volume bars", base0=0)
    threshold_rule_numpy(np.cumsum(side.astype(np.int64)), cis["imbalance"],
                         IMB_THETA, "imbalance bars", absolute=True)
    first_valid = int(np.argmin(np.isnan(month["sigma"])))
    cis["cusum"][0] = first_valid
    ties = {}
    ties["kernel"] = cusum_rule_numpy(ts, price, month["sigma"], cis["cusum"])
    if ties_kp:
        p_ci = np.concatenate([[first_valid], p_out["cusum"]["closes"].cpu().numpy()])
        ties["plain"] = cusum_rule_numpy(ts, price, month["sigma"], p_ci)
        if ties["kernel"] + ties["plain"] == 0:
            fail("cusum close indices differ without a near tie")
    for name, r in k_out.items():
        nb = len(cis[name]) - 1
        o = r["ohlcv"]
        for key in ("open", "high", "low", "close", "vwap", "median_trade_size"):
            if o[key].shape != (nb,) or not bool(torch.isfinite(o[key]).all()):
                fail(f"{name} ohlcv[{key}] is not {nb} finite values")
        if int(o["trades"].sum()) != int(cis[name][-1] - cis[name][0]):
            fail(f"{name} bars do not cover (ci[0], ci[-1]] once")
    for key, v in k_out["cusum"]["trade_size"].items():
        if not bool(torch.isfinite(v).all()):
            fail(f"cusum trade_size.{key} not finite")
    counts = {name: len(c) - 1 for name, c in cis.items()}
    say(f"info bars: {counts}, launches {launches} (E imbalance by path "
        f"{imb_paths}); kernel path == plain path "
        f"(close indices, bars, CUSUM trade size, footprints and filled "
        f"sigma exact; CUSUM near-tie differences {ties_kp}); tick ci == "
        f"arange, volume and imbalance ci == the integer rules in numpy, "
        f"CUSUM ci == the float64 rule in numpy ({ties['kernel']} near ties)")
    say(f"info path peak device memory {peak / 2**30:.2f} GiB allocated "
        f"({(peak - base) / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB "
        f"held before the run) [{card}]")
    for label, st in (("kernel", k_st), ("plain", p_st)):
        say(f"info stage ms, {label} path: " + "; ".join(
            f"{name} " + ", ".join(f"{k} {v:.2f}" for k, v in d.items())
            for name, d in st.items()) + f" [{card}]")
    say(f"plain path wall time {t_plain:.1f} s (host loops of the plain scans)")
    del p_out

    sig = torch.from_numpy(month["sigma"]).cuda()
    kernels = {"F": kernel_f(card, sig, launches),
               **kernel_e(card, tr, torch.from_numpy(price).cuda(), sig,
                          thr_units, counts, launches,
                          cusum_may_differ=bool(ties_kp))}
    kernels["E imbalance"]["launches_by_mode"] = imb_paths
    check_e_nonfinite(card)
    check_e_cusum_nonfinite(card)
    del sig
    ci_cusum = torch.from_numpy(cis["cusum"]).cuda()
    if "C" in need:
        kernels["C"] = kernel_c(card, tr, ci_cusum,
                                k_out["cusum"]["footprints"]["low_level"], launches)
    if need & {"B", "S"}:
        kernels.update(kernels_b_s(card, tr, ci_cusum, launches))
    return launches, kernels


def kernel_f(card, sigma, launches):
    """Kernel F alone: against its plain version bit for bit on the month's
    sigma and on phase 3's lengths (float32 and float64, three masks), and
    timed on the sigma. Returns its ``kernels`` entry."""
    import torch
    from finmlkit_tpu_torch.ops.prefix_scan import fast_ffill, fast_ffill_plain
    from finmlkit_tpu_torch.testing import assert_exact
    n = sigma.shape[0]
    valid = ~torch.isnan(sigma)
    assert_exact(fast_ffill(sigma, valid), fast_ffill_plain(sigma, valid),
                 "F on the month's sigma")
    f_ms = cuda_ms(lambda: fast_ffill(sigma, valid), reps=20)
    f_plain = cuda_ms(lambda: fast_ffill_plain(sigma, valid))
    f_bound = bound(17 * n, n)             # float64 values and mask in, out
    g = torch.Generator(device="cuda").manual_seed(7)
    for length in SCAN_LENGTHS:
        for dtype in (torch.float32, torch.float64):
            v = torch.randn(length, dtype=dtype, device="cuda", generator=g)
            v[::7] = float("nan")
            for mask in FFILL_MASKS:
                m = torch.full((length,), mask == "all_valid", device="cuda")
                if mask == "leading_invalid":
                    m = torch.rand(length, device="cuda", generator=g) < 0.3
                    m[:min(length, 5000)] = False
                assert_exact(fast_ffill(v, m), fast_ffill_plain(v, m),
                             f"F {dtype} n={length} {mask}")
    say(f"kernel F == plain bit for bit on the month's sigma and on lengths "
        f"{list(SCAN_LENGTHS)} x float32/float64 x {list(FFILL_MASKS)}; F on "
        f"the month {f_ms:.3f} ms vs plain {f_plain:.3f} ms, bound "
        f"{f_bound[0]:.3f} ms [{card}]")
    return kernel_entry("F", launches["F"], 0.0, f_ms, f_plain, f_bound, None)


def kernel_e(card, tr, price, sigma, thr_units, counts, launches,
             cusum_may_differ):
    """Kernel E alone: its four scans at phase 7's inputs, each at its default
    chunk count and at each of ``E_CHUNKS`` (1 is the sequential walk), every
    one timed (three calls) with the walk's counts and giving the same closes,
    and held to its plain version (one timed call; CUSUM closes may differ
    only where phase 7 found near ties). The imbalance scan takes the map
    path (its states reported); the walk, forced, is timed and held to the
    same closes beside it. Returns one ``kernels`` entry a scan, with the
    default's counts: 256-trade segments skipped and scanned, pass-2 chunks
    that did not merge, chunks fixed up."""
    import torch
    from finmlkit_tpu_torch.bar.indexers import cusum_scan_inputs
    from finmlkit_tpu_torch.ops import event_scan as es
    from finmlkit_tpu_torch.testing import assert_exact
    n, dev = tr.ticks.shape[0], tr.ticks.device
    rets, lam, can_close, fv, _ = cusum_scan_inputs(
        tr.timestamps, price, sigma, CUSUM_FLOOR, CUSUM_MULT)
    w = tr.sides.to(torch.float64)
    run = tuple(RUN_EMA[k] for k in ("expected_ticks_init", "expected_rate_init",
                                     "alpha_ticks", "alpha_rate"))
    imb_k = es._map_states(w, 1.0, IMB_THETA, 0.0, 0.0, integral=True)
    if imb_k is None:
        fail("the tick imbalance scan is not admitted to kernel E's map path")
    scans = {   # plain version, its arguments (every buffer holds n closes),
        # kernel E's modes (the first is the default path), start and inputs,
        # bytes read a trade
        "cusum": (es.cusum_scan_plain, (rets, lam, can_close, fv, n),
                  {"walk": es._CUSUM}, fv + 1,
                  dict(x=rets, lam=lam, can_close=can_close), 17),
        "imbalance": (es.info_scan_plain, (w, 1.0, IMB_THETA, 0.0, 0.0, n, False),
                      {"map": es._IMBALANCE_MAP, "walk": es._IMBALANCE}, 1,
                      dict(x=w, e_t=1.0, e_r=IMB_THETA), 8),
        "run": (es.info_scan_plain, (w, *run, n, True), {"walk": es._RUN}, 1,
                dict(x=w, **dict(zip(("e_t", "e_r", "alpha_t", "alpha_r"), run))), 8),
        "volume": (es.volume_scan_plain, (tr.units, thr_units, n),
                   {"walk": es._VOLUME}, 1, dict(units=tr.units, thr=thr_units), 8),
    }
    entries = {}
    for name, (plain, args, modes, start, kw, nbytes) in scans.items():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        want = plain(*args)
        b.record()
        b.synchronize()
        runs = {}
        for path, mode in modes.items():
            def scan(c, stats=None):
                return es._launch(mode, n, start, n, dev, chunks=c, stats=stats, **kw)
            chunks = es._default_chunks(mode, dev)
            stats = torch.zeros(4, dtype=torch.int64, device=dev)
            got = scan(chunks, stats)
            ms = cuda_ms(lambda: scan(chunks), reps=3)
            sweep = {}
            for c in E_CHUNKS:
                st = torch.zeros(4, dtype=torch.int64, device=dev)
                assert_exact(scan(c, st), got, f"E {name} {path}: {c} chunks against {chunks}")
                sweep[str(c)] = [cuda_ms(lambda: scan(c), reps=3), *st.tolist()]
            same = got.shape == want.shape and bool((got == want).all())
            if not same and (name != "cusum" or not cusum_may_differ):
                fail(f"E {name} alone ({path}): {len(got)} closes differ from the "
                     f"plain version's {len(want)}")
            runs[path] = (got, ms, chunks, stats.tolist(), sweep)
        got, ms, chunks, (skipped, scanned, unmerged, fixed), sweep = runs[next(iter(modes))]
        # some 10 operations a trade; 8 bytes a close written
        e_bound = bound(nbytes * n + 8 * counts[name], 10 * n)
        m = min(len(got), len(want))    # the error: closes that differ
        err = float(int((got[:m] != want[:m]).sum()) + abs(len(got) - len(want)))
        extra = {}
        if name == "imbalance":
            w_ms, w_chunks, w_stats, w_sweep = runs["walk"][1:]
            extra = dict(path="map", states=2 * imb_k + 1, walk_ms=w_ms,
                         walk_chunks=w_chunks, walk_by_chunks=w_sweep)
            say(f"kernel E imbalance, the walk forced: {w_ms:.3f} ms at {w_chunks} "
                f"chunk(s), the same closes; ms [skipped, scanned, unmerged, fixed "
                f"up] by chunks: " + ", ".join(f"{c}: {v[0]:.3f} {v[1:]}"
                                               for c, v in w_sweep.items())
                + f" [{card}]")
        entries[f"E {name}"] = kernel_entry(
            f"E {name}", launches[f"E {name}"], err, ms, a.elapsed_time(b),
            e_bound, None, chunks=chunks, segments_skipped=skipped,
            segments_scanned=scanned, pass2_unmerged=unmerged,
            chunks_fixed_up=fixed, by_chunks=sweep, **extra)
        path = (f"the map path ({2 * imb_k + 1} states)" if name == "imbalance"
                else f"{chunks} chunks (default)")
        say(f"kernel E {name}: {ms:.3f} ms by {path}, plain "
            f"{a.elapsed_time(b):.1f} ms, bound {e_bound[0]:.3f} ms; segments "
            f"skipped {skipped:,} of {skipped + scanned:,} walked, pass-2 chunks "
            f"unmerged {unmerged}, chunks fixed up {fixed}; same closes at every "
            f"count, ms [skipped, scanned, unmerged, fixed up] by chunks: "
            + ", ".join(f"{c}: {v[0]:.3f} {v[1:]}" for c, v in sweep.items())
            + f" [{card}]")
    return entries


def check_e_nonfinite(card):
    """Kernel E against its plain version on volume-imbalance weights with a
    NaN or an infinite weight at trade 1000 (3,000 trades, theta 8): a NaN
    sum never closes, and an infinite weight closes once and makes theta NaN
    at alpha 0, so no bar closes after trade 1000."""
    import torch
    from finmlkit_tpu_torch.ops import event_scan as es
    from finmlkit_tpu_torch.testing import assert_exact
    r = np.random.default_rng(8)
    w0 = np.where(r.random(3000) < 0.5, 1.0, -1.0) * r.lognormal(0.0, 1.0, 3000)
    found = {}
    for bad in ("nan", "inf", "-inf"):
        w = torch.from_numpy(w0.copy()).cuda()
        w[1000] = float(bad)
        got = es.info_scan(w, 1.0, 8.0, 0.0, 0.0, 3000, False)
        want = es.info_scan_plain(w, 1.0, 8.0, 0.0, 0.0, 3000, False)
        assert_exact(got, want, f"E imbalance with a {bad} weight")
        last = int(want[-1]) if len(want) else -1
        if len(want) < 3 or last > 1000 or (bad != "nan") != (last == 1000):
            fail(f"E imbalance with a {bad} weight: closes {want.tolist()}")
        found[bad] = (len(got), last)
    say(f"kernel E == plain on volume-imbalance weights with a non-finite weight "
        f"at trade 1000 (closes, last): {found} [{card}]")


def check_e_cusum_nonfinite(card):
    """Kernel E's CUSUM mode against its plain version on 300,000 trades of
    ``testing.cusum_bad_inputs`` (sums exact on a grid) with a NaN, an
    infinite or a zero-price pair of returns, or NaN thresholds, near trade
    150,000, at the default chunk count, at 528 and in one chunk: the same
    closes. A NaN return stops every later close; an infinite one closes and
    closes go on."""
    import torch
    from finmlkit_tpu_torch.ops import event_scan as es
    from finmlkit_tpu_torch.testing import CUSUM_BAD, assert_exact, cusum_bad_inputs
    n, at = 300_000, 150_000
    found = {}
    for name in CUSUM_BAD:
        inputs = cusum_bad_inputs(name, n, at)
        bad = int(np.flatnonzero(~np.isfinite(inputs[0]) | ~np.isfinite(inputs[1]))[0])
        rets, lam, cc = (torch.from_numpy(a).cuda() for a in inputs[:3])
        want = es.cusum_scan_plain(rets, lam, cc, 0, n)
        got = es.cusum_scan(rets, lam, cc, 0, n)
        assert_exact(got, want, f"E cusum, {name}: default chunks")
        for chunks in (528, 1):
            assert_exact(es._launch(es._CUSUM, n, 1, n, rets.device, x=rets, lam=lam,
                                    can_close=cc, chunks=chunks),
                         want, f"E cusum, {name}: {chunks} chunks")
        last = int(want[-1]) if len(want) else -1
        nan_return = name in ("nan", "nan_tile_last", "nan_tile_first", "nan_segment_last")
        if len(want) < 100 or (last < bad) != nan_return:
            fail(f"E cusum, {name}: {len(want)} closes, the last at {last}")
        found[name] = (len(got), last)
    say(f"kernel E cusum == plain at {es._default_chunks(es._CUSUM, torch.device('cuda'))}, "
        f"528 and 1 chunks on {n:,} trades with non-finite inputs near trade {at:,} "
        f"(closes, last): {found} [{card}]")


def phase_engines(card, month, need):
    """Phase 8: the month's time bars through every median engine and bar
    scan, the kernels of each against their plain versions, each kernel
    alone, and the floor probes. ``need`` names the kernels of B, S and C
    that no earlier phase timed. Returns the engines path's launches, the
    ``kernels`` entries, and the floor probes' launches."""
    import torch
    from finmlkit_tpu_torch.bar.fused import (bar_products_final, gather_planes,
                                              planes_products)
    from finmlkit_tpu_torch.bar.indexers import time_bar_indexer
    from finmlkit_tpu_torch.ops import fused_scan as fs
    from finmlkit_tpu_torch.ops import prefix_scan as ps
    from finmlkit_tpu_torch.ops import segment_hist as sh
    from finmlkit_tpu_torch.ops.segment_select import segment_median_pair_select
    from finmlkit_tpu_torch.testing import assert_exact
    tr, ts = month["tr"], month["ts"]
    ci = month.get("ci_time")
    if ci is None:
        ci = time_bar_indexer(tr.timestamps, 60.0, ts_first=int(ts[0]),
                              ts_last_i=int(ts[-1]))[1]
    n, nb = tr.ticks.shape[0], ci.shape[0] - 1
    trade_args = (tr.ticks, tr.units, tr.sides, ci)
    kw = dict(tick_size=tr.tick_size, amount_scale=tr.amount_scale,
              amounts_f32=tr.amounts)
    scans = {"rowtail": fs.bar_scan_products, "planes": planes_products}
    combos = [(m, sc) for m in ENGINES for sc in SCANS]

    def run(m, sc):
        return bar_products_final(tr.ticks, tr.units, ci, tr.sides, medians=m,
                                  scan=scans[sc], **kw)

    def counters():
        return {"B": fs.LAUNCHES, "S": ps.LAUNCHES, "S float": ps.FLOAT_LAUNCHES,
                "C": ps.COLS_LAUNCHES, "F": ps.FFILL_LAUNCHES + ps.FILL_LAST_LAUNCHES,
                "H": sh.LAUNCHES, "V": fs.PLANES_LAUNCHES}

    def timed(m, sc):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = run(m, sc)
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    for m, sc in combos:                       # warm: allocator, caches
        run(m, sc)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    fs.LAUNCHES = fs.PLANES_LAUNCHES = sh.LAUNCHES = 0
    ps.LAUNCHES = ps.FLOAT_LAUNCHES = ps.COLS_LAUNCHES = 0
    ps.FFILL_LAUNCHES = ps.FILL_LAST_LAUNCHES = 0
    outs, per, peak, ms = {}, {}, {}, {}
    for m, sc in combos:                       # the path's counted run
        before = counters()
        torch.cuda.reset_peak_memory_stats()
        outs[(m, sc)], t = timed(m, sc)
        ms[(m, sc)] = [t]
        peak[(m, sc)] = torch.cuda.max_memory_allocated()
        per[(m, sc)] = {k: v - before[k] for k, v in counters().items()}
    launches = counters()
    for (m, sc), got in per.items():
        want = {"B": int(sc == "rowtail"), "S": int(m in ("sort", "select")),
                "S float": 0, "C": 0, "F": 4 * (m == "select"),
                "H": 9 * (m == "hist"), "V": int(sc == "planes")}
        if got != want:
            fail(f"engines {m}/{sc} launched {got}, expected {want}")
    ref = outs[("sort", "rowtail")]
    for key_ in combos[1:]:
        for part, want in zip(outs[key_], ref):
            for key in want:
                assert_exact(part[key], want[key], f"{key_[0]}/{key_[1]} finals {key}")
    o = ref[0]
    if int(o["trades"].sum()) != n \
            or not bool(torch.isfinite(o["median_trade_size"]).all()):
        fail("engine finals do not cover the month or have non-finite medians")
    del outs
    for _ in range(2):                         # stage times, median of 3
        for key_ in combos:
            ms[key_].append(timed(*key_)[1])
    say(f"engines: {nb:,} time bars, launches {launches} (per call as expected: "
        f"H 9 a hist call, F 4 a select call, V 1 and C 0 a planes call); every "
        f"engine and scan's finals == sort/rowtail's bit for bit")
    say("engine stage ms (bar_products_final, median of 3) and peak device "
        "memory above the trades: " + "; ".join(
            f"{m}/{sc} {float(np.median(ms[(m, sc)])):.2f} ms "
            f"{(peak[(m, sc)] - base_mem) / 2**30:.2f} GiB" for m, sc in combos)
        + f" [{card}]")

    # --- kernel H on every pass of the month's hist engine, exact ---
    bits = tr.amounts.view(torch.int32)
    passes, less_v = [], []

    def hist_checked(bits_, ci_, base, s_):
        got = sh.hist_pass(bits_, ci_, base, s_)
        assert_exact(got, sh.hist_pass_plain(bits_, ci_, base, s_), f"H pass s={s_}")
        passes.append((base.clone(), s_))
        return got

    def less_checked(bits_, ci_, v):
        got = sh.less_pass(bits_, ci_, v)
        for a, b in zip(got, sh.less_pass_plain(bits_, ci_, v)):
            assert_exact(a, b, "H less pass")
        less_v.append(v.clone())
        return got

    sh.segment_median_pair_hist(tr.amounts, ci, hist=hist_checked, less=less_checked)

    def h_all(hist, less):
        for base, s_ in passes:
            hist(bits_c, ci_c, base, s_)
        less(bits_c, ci_c, less_v[0])

    # the kernel alone: ci checked once here, outside the timed window, as the
    # engine does once a call; the checked wrappers wait for the card each time
    bits_c, ci_c = sh._check_ci(bits, ci, "phase 8")
    h_ms = cuda_ms(lambda: h_all(sh._launch_hist, sh._launch_less))
    h_pass_ms = {**{f"hist s={s_}": cuda_ms(lambda p=(base, s_): sh._launch_hist(
                        bits_c, ci_c, *p)) for base, s_ in passes},
                 "less pass": cuda_ms(lambda: sh._launch_less(bits_c, ci_c, less_v[0]))}
    h_wrapped = cuda_ms(lambda: h_all(sh.hist_pass, sh.less_pass))
    h_plain = cuda_ms(lambda: h_all(sh.hist_pass_plain, sh.less_pass_plain), reps=2)
    bar_of = torch.searchsorted(ci[1:].contiguous(), torch.arange(n, device=ci.device))
    keys = [bar_of * 16 + (((bits - base[bar_of]) >> s_) & 15) for base, s_ in passes]
    del bar_of
    h_lib = cuda_ms(lambda: [torch.bincount(k_, minlength=nb * 16) for k_ in keys])
    del keys
    h_bound = bound(9 * 4 * n + 9 * 8 * (nb + 1) + 8 * 64 * nb + 8 * nb, 17 * 8 * n)
    say(f"kernel H == plain on all 8 passes and the less pass of the month; the "
        f"9 launches {h_ms:.3f} ms (the passes " + ", ".join(
            f"{k} {v:.3f}" for k, v in h_pass_ms.items())
        + f"; through the wrappers, which "
        f"check ci each time, {h_wrapped:.3f}) vs plain {h_plain:.3f} ms, 8 "
        f"torch.bincount of precomputed keys {h_lib:.3f} ms, bound "
        f"{h_bound[0]:.3f} ms [{card}]")

    # --- kernel F's int32 fill on every fill of the select engine, exact ---
    fills = []

    def fill_checked(v, m_):
        got = ps.fill_last(v, m_)
        assert_exact(got, ps.fill_last_plain(v, m_), f"F int32 fill {len(fills)}")
        fills.append((v, m_))
        return got

    segment_median_pair_select(tr.amounts, ci, fill=fill_checked)
    fv, fm = fills[-1]
    f_ms = cuda_ms(lambda: ps.fill_last(fv, fm), reps=20)
    f_all = cuda_ms(lambda: [ps.fill_last(v, m_) for v, m_ in fills], reps=20)
    f_plain = cuda_ms(lambda: ps.fill_last_plain(fv, fm))
    f_bound = bound(9 * n, n)
    n_fills = len(fills)
    del fills, fv, fm
    say(f"kernel F int32 == fill_last_plain on the select engine's {n_fills} fills; "
        f"one fill {f_ms:.3f} ms (the {n_fills} {f_all:.3f} ms) vs plain {f_plain:.3f} "
        f"ms, bound {f_bound[0]:.3f} ms [{card}]")

    # --- the planes (kernel V) against the plain planes, exact ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    planes = fs.bar_scan_planes(*trade_args)
    torch.cuda.synchronize()
    planes_peak = torch.cuda.max_memory_allocated()
    plain = fs.bar_scan_planes_plain(*trade_args)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated()
    for name, a, b in zip(("pre64", "pre32", "ext32", "extf"), planes, plain):
        assert_exact(a, b, f"V planes {name}")
    del plain
    ne = ci[1:] > ci[:-1]
    for a, b in zip(gather_planes(planes, tr.ticks, ci), fs.bar_scan_products(*trade_args)):
        assert_exact(a[:, ne], b[:, ne], "planes products vs B")
    del planes
    v_ms = cuda_ms(lambda: fs.bar_scan_planes(*trade_args))
    v_plain = cuda_ms(lambda: fs.bar_scan_planes_plain(*trade_args), reps=2)
    # the kernel alone (ci checked once, buffers made once), then each of its
    # passes alone on the state the passes before it left
    v_args = fs._cuda_inputs(*trade_args, "phase 8")
    bufs = fs._planes_buffers(n, ci.device)
    fs._planes_kernel(*v_args, bufs)
    v_kernel = cuda_ms(lambda: fs._planes_kernel(*v_args, bufs))
    v_pass = {name: cuda_ms(lambda p=p: fs._planes_kernel(*v_args, bufs, passes=1 << p))
              for p, name in enumerate(fs.PLANES_PASSES)}
    del bufs
    v_trace, v_busy = trace_device_ms(lambda: fs.bar_scan_planes(*trade_args))
    # the planes: 13 bytes a trade in, 6 int64 + 3 int32 prefixes and 5 int32 +
    # 4 float32 extrema out (96 bytes a trade)
    v_bound = bound(13 * n + 8 * (nb + 1) + 96 * n, 60 * n)
    planes_gib = (planes_peak - base_mem) / 2**30
    say(f"planes == plain planes bit for bit, products == B on {int(ne.sum()):,} "
        f"non-empty bars; bar_scan_planes (V once) {v_ms:.3f} ms vs plain "
        f"{v_plain:.3f} ms, bound {v_bound[0]:.3f} ms; the kernel alone "
        f"{v_kernel:.3f} ms, its passes " + ", ".join(
            f"{k} {v:.3f}" for k, v in v_pass.items())
        + f" ms; peak device memory {planes_gib:.2f} GiB above the trades for "
        f"the planes, {(plain_peak - base_mem) / 2**30:.2f} GiB with the plain "
        f"planes [{card}]")
    say(f"one planes call under torch.profiler: device busy {v_busy:.3f} ms; "
        "device ms by kernel: " + ", ".join(f"{k} {v:.3f}" for k, v in v_trace.items())
        + f" [{card}]")

    kernels = {
        "H": kernel_entry("H", launches["H"], 0.0, h_ms, h_plain, h_bound, h_lib,
                          h_pass_ms=h_pass_ms, h_wrapped_ms=h_wrapped),
        "V": kernel_entry("V", launches["V"], 0.0, v_ms, v_plain, v_bound, None,
                          kernel_alone_ms=v_kernel, pass_ms=v_pass,
                          traced_ms=v_trace, peak_gib_above_trades=planes_gib),
        "F": kernel_entry("F", launches["F"], 0.0, f_ms, f_plain, f_bound, None,
                          int32_fill_ms=f_ms, int32_fill_plain_ms=f_plain,
                          int32_fill_bound_ms=f_bound[0], int32_engine_fills_ms=f_all),
    }
    if "C" in need:
        in64, _ = fs.planes_prefix_inputs(*trade_args)
        c_ms = cuda_ms(lambda: ps.fast_cumsum_cols(in64))
        c_plain = cuda_ms(lambda: ps.fast_cumsum_cols_plain(in64), reps=2)
        c_lib = cuda_ms(lambda: torch.cumsum(in64, 1), reps=2)
        c_err = float((ps.fast_cumsum_cols(in64) - ps.fast_cumsum_cols_plain(in64))
                      .abs().max())
        del in64
        c_bound = bound(2 * 48 * n, 6 * n)
        say(f"kernel C (6, {n:,}) int64: {c_ms:.3f} ms vs plain {c_plain:.3f} ms, "
            f"torch.cumsum(x, 1) {c_lib:.3f} ms, bound {c_bound[0]:.3f} ms [{card}]")
        kernels["C"] = kernel_entry("C", launches["C"], c_err, c_ms, c_plain,
                                    c_bound, c_lib)
    if need & {"B", "S"}:
        kernels.update(kernels_b_s(card, tr, ci, launches))

    # --- the floor probes (kernel P): their own path, then alone ---
    streams = fs.prep_planes_plain(*trade_args)
    stack = torch.stack(streams)
    torch.cuda.synchronize()
    fs.IO_FLOOR_LAUNCHES = 0
    got = {"P1": fs.bar_scan_io_floor(*streams),
           **{f"P2 k={k}": fs.bar_scan_io_floor_k(streams[0], k) for k in IO_FLOOR_K},
           "P3": fs.bar_scan_io_floor_stacked(stack)}
    floor_launches = {"P": fs.IO_FLOOR_LAUNCHES}
    if floor_launches["P"] != 2 + len(IO_FLOOR_K):
        fail(f"the floor probes launched P {floor_launches['P']} times")
    want = {"P1": fs.io_floor_plain(streams),
            **{f"P2 k={k}": fs.io_floor_plain([streams[0]] * k) for k in IO_FLOOR_K},
            "P3": fs.io_floor_plain(stack)}
    for key in want:
        assert_exact(got[key], want[key], key)
    del got, want
    p_ms = {"P1": cuda_ms(lambda: fs.bar_scan_io_floor(*streams)),
            **{f"P2 k={k}": cuda_ms(lambda k=k: fs.bar_scan_io_floor_k(streams[0], k))
               for k in IO_FLOOR_K},
            "P3": cuda_ms(lambda: fs.bar_scan_io_floor_stacked(stack))}
    # the bytes that reach device memory: P2 reads its one stream k times, but
    # the repeats of a 16-byte load come from cache, so it moves 8 bytes a trade
    p_bytes = {"P1": 36 * n, **{f"P2 k={k}": 8 * n for k in IO_FLOOR_K},
               "P3": 36 * n}
    p_plain = cuda_ms(lambda: fs.io_floor_plain(streams))
    p_lib = cuda_ms(lambda: torch.sum(stack, 0, dtype=torch.int32))
    p2_plain = {k: cuda_ms(lambda k=k: fs.io_floor_plain([streams[0]] * k))
                for k in IO_FLOOR_K}
    p2_lib = {k: cuda_ms(lambda k=k: torch.sum(streams[0].expand(k, n), 0,
                                               dtype=torch.int32))
              for k in IO_FLOOR_K}
    p_bound = bound(36 * n, 8 * n)
    say("kernel P == torch.sum on P1, P2 (k = " + ", ".join(map(str, IO_FLOOR_K))
        + ") and P3; ms (and GB/s): " + ", ".join(
            f"{k} {v:.3f} ({p_bytes[k] / v / 1e6:,.0f})" for k, v in p_ms.items())
        + "; P2's plain (ms) " + ", ".join(f"{v:.3f}" for v in p2_plain.values())
        + ", torch.sum of the expanded stream " + ", ".join(
            f"{v:.3f}" for v in p2_lib.values())
        + f"; P1's plain {p_plain:.3f} ms, torch.sum(x, 0) on the (8, n) stack "
        f"{p_lib:.3f} ms ({36 * n / p_lib / 1e6:,.0f} GB/s), bound {p_bound[0]:.3f} "
        f"ms at the data sheet's 3.35 TB/s [{card}]")
    del streams, stack
    kernels["P"] = kernel_entry(
        "P", floor_launches["P"], 0.0, p_ms["P1"], p_plain, p_bound, p_lib,
        p2_ms={str(k): p_ms[f"P2 k={k}"] for k in IO_FLOOR_K}, p3_ms=p_ms["P3"],
        p3_library_ms=p_lib,
        p2_plain_ms={str(k): v for k, v in p2_plain.items()},
        p2_library_ms={str(k): v for k, v in p2_lib.items()})
    return launches, kernels, floor_launches


def month_bars(month):
    """The month's 1-minute time bars as float64 series and int64 bar close
    times: phase 5's, or built here as phase 5 builds them."""
    import torch
    if "bars_time" in month:
        ohlcv, direc, bar_ts = month["bars_time"]
    else:
        from finmlkit_tpu_torch.bar.fused import bar_products_final
        from finmlkit_tpu_torch.bar.indexers import time_bar_indexer
        tr, ts = month["tr"], month["ts"]
        clock, ci = time_bar_indexer(tr.timestamps, 60.0, ts_first=int(ts[0]),
                                     ts_last_i=int(ts[-1]))
        ohlcv, direc = bar_products_final(tr.ticks, tr.units, ci, tr.sides,
                                          tick_size=tr.tick_size,
                                          amount_scale=tr.amount_scale,
                                          amounts_f32=tr.amounts)
        month.setdefault("ci_time", ci)
        bar_ts = clock[1:ci.shape[0]]
    f64 = torch.float64
    b = dict(close=ohlcv["close"], high=ohlcv["high"], low=ohlcv["low"],
             volume=ohlcv["volume"].to(f64), buy=direc["volume_buy"].to(f64),
             sell=direc["volume_sell"].to(f64), ts=bar_ts, open=ohlcv["open"],
             vwap=ohlcv["vwap"].to(f64))
    b["ret"] = log_return(b["close"])
    return b


def log_return(close):
    """The 1-bar log return of BASELINE config 4 (``Return(1, is_log=True)``),
    NaN at bar 0."""
    import torch
    return torch.cat([close.new_full((1,), torch.nan), torch.log(close[1:] / close[:-1])])


def feature_calls(b):
    """Every function of the feature slice once on bars ``b`` (tensors on one
    device): name -> call. The first six are BASELINE config 4's feature pass
    (bench.py:595-602, ``SIX_FEATURES``); the rest run at the JAX package's
    defaults, with windows a bar user would pick."""
    from finmlkit_tpu_torch.feature import kernels as K
    c, h, l, v, ts, ret = (b[k] for k in ("close", "high", "low", "volume", "ts", "ret"))
    day = c[-DAY_BARS:]
    return {
        "ewma": lambda: K.ewma(c, 20),
        "rsi_wilder": lambda: K.rsi_wilder(c, 14),
        "atr": lambda: K.atr(h, l, c, 14),
        "log_return": lambda: log_return(c),
        "realized_vol": lambda: K.realized_vol(ret, 30, False),
        "comp_zscore": lambda: K.comp_zscore(c, 50),
        "sma": lambda: K.sma(c, 20),
        "ewms": lambda: K.ewms(ret, 20),
        "ewmst": lambda: K.ewmst(ts, ret, 3600.0),
        "ewmst_mean0": lambda: K.ewmst_mean0(ts, ret, 3600.0),
        "true_range": lambda: K.true_range(h, l, c),
        "bollinger_percent_b": lambda: K.bollinger_percent_b(c, 20, 2.0),
        "parkinson_range": lambda: K.parkinson_range(h, l),
        "atr_ema_normalized": lambda: K.atr(h, l, c, 14, ema_based=True, normalize=True),
        "rolling_variance": lambda: K.rolling_variance(ret, 20),
        "variance_ratio_1_4": lambda: K.variance_ratio_1_4(c, 20),
        "roc": lambda: K.roc(c, 10),
        "stoch_k": lambda: K.stoch_k(c, l, h, 14),
        "adx": lambda: K.adx(h, l, c, 14),
        "comp_lagged_returns": lambda: K.comp_lagged_returns(ts, c, 300, True),
        "comp_burst_ratio": lambda: K.comp_burst_ratio(v, 20),
        "pct_change": lambda: K.pct_change(c, 5),
        "time_cues": lambda: K.time_cues(ts),
        "vwap_distance": lambda: K.vwap_distance(c, v, 20, True),
        "rolling_price_volume_correlation": lambda: K.rolling_price_volume_correlation(c, v, 20),
        "comp_flow_acceleration": lambda: K.comp_flow_acceleration(v, 20, 5),
        "vpin": lambda: K.vpin(b["buy"], b["sell"], 50),
        "cusum_test_rolling": lambda: K.cusum_test_rolling(c, CSW_WINDOW),
        "cusum_test_developing": lambda: K.cusum_test_developing(day),
        "cusum_test_last": lambda: K.cusum_test_last(day),
    }


SIX_FEATURES = ("ewma", "rsi_wilder", "atr", "log_return", "realized_vol", "comp_zscore")
CSW_FEATURES = ("cusum_test_rolling", "cusum_test_developing", "cusum_test_last")


def hold_feature(name, got, want):
    """A feature on the card against its CPU run: NaN positions equal, floats
    within rtol and atol 1e-12, flags and the CSW critical values (the chosen
    lags) equal. Returns the largest absolute deviation."""
    import torch
    from finmlkit_tpu_torch.testing import assert_close, assert_exact
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        what = f"{name}[{i}] card vs cpu"
        if not torch.is_tensor(g):                       # cusum_test_last
            g, w = torch.tensor([g]), torch.tensor([w])
        if g.dtype == torch.bool or (name in CSW_FEATURES and i >= 2):
            assert_exact(g, w, what)
        else:
            worst = max(worst, assert_close(g, w, rtol=FEATURE_RTOL,
                                            atol=FEATURE_ATOL, what=what))
    return worst


def phase_features(card, month):
    """Phase 9: the feature slice on the month's time bars. Returns the
    path's launches (R, W) and the ``kernels`` entries of R and W."""
    import torch
    from finmlkit_tpu_torch.feature.kernels import structural_break
    from finmlkit_tpu_torch.ops import scan
    b = month_bars(month)
    n_bars = b["close"].shape[0]
    calls = feature_calls(b)
    for f in calls.values():               # warm: allocator, tables, the build
        f()
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    scan.LAUNCHES = structural_break.LAUNCHES = 0
    got = {name: f() for name, f in calls.items()}     # the path's counted run
    torch.cuda.synchronize()
    launches = {"R": scan.LAUNCHES, "W": structural_break.LAUNCHES}
    peak_gib = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    if launches["R"] < 1 or launches["W"] < 1:
        fail(f"a kernel of the feature path did not launch: {launches}")

    # --- every feature on the card against its CPU run (the plain path) ---
    b_cpu = {k: v.cpu() for k, v in b.items()}
    t0 = time.perf_counter()
    want = {name: f() for name, f in feature_calls(b_cpu).items()}
    cpu_s = time.perf_counter() - t0
    worst = {name: hold_feature(name, got[name], want[name]) for name in calls}
    for name, out in got.items():
        length = DAY_BARS if name == "cusum_test_developing" else n_bars
        for o in out if isinstance(out, tuple) else (out,):
            if torch.is_tensor(o) and (o.shape != (length,) or
                                       float(torch.isfinite(o).double().mean()) < 0.5):
                fail(f"{name}: not {length} values, or mostly not finite")
    say(f"features: {len(calls)} functions on {n_bars:,} bars, launches {launches}; "
        f"every one equal to its CPU run (NaN positions, flags and CSW lags "
        f"exact, floats within rtol {FEATURE_RTOL}, largest deviation "
        f"{max(worst.values()):.3g}); the CPU run {cpu_s:.2f} s; peak device "
        f"memory {peak_gib:.3f} GiB above the bars [{card}]")

    # --- times: the six-feature pass as a stage, each function alone ---
    def six_ms():
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for name in SIX_FEATURES:
            calls[name]()
        e.record()
        torch.cuda.synchronize()
        return a.elapsed_time(e)
    six_ms()
    six = [six_ms() for _ in range(5)]
    each = {name: cuda_ms(f, reps=3) for name, f in calls.items()}
    say(f"BASELINE config 4's six features on {n_bars:,} bars: median "
        f"{float(np.median(six)):.3f} ms (min {min(six):.3f}, max {max(six):.3f}, "
        f"5 runs) [{card}]")
    say("feature ms (CUDA events, mean of 3): " + ", ".join(
        f"{k} {v:.3f}" for k, v in each.items()) + f" [{card}]")

    return launches, {"R": kernel_r(card, launches["R"], n_bars),
                      "W": kernel_w(card, b, launches["W"])}


def kernel_r(card, launches, n_bars=45_705):
    """Kernel R alone against its plain version on the card: EWMA's
    recurrence at 1M points and span 100 (BASELINE.md row 3), ewmst's
    time-varying decay, y0, a NaN in b, lengths around the 2048-value tile
    and the month's trade count; within rtol 1e-12 of the terms' magnitude,
    equal from run to run, also beside another stream that keeps the SMs
    busy; timed with its bound; its look-back lengths (a tile's place in its
    group plus 32 for each group map applied) at the month's count and at the
    bars' count, and a call's wall and host time on ``n_bars`` values."""
    import torch
    from finmlkit_tpu_torch.ops import scan
    from finmlkit_tpu_torch.testing import assert_exact, assert_window_close
    g = torch.Generator(device="cuda").manual_seed(11)
    oma = 1.0 - 2.0 / 101.0                             # span 100
    worst, times, dists = 0.0, {}, {}

    def walk(n):
        return 107_000.0 * torch.exp(torch.cumsum(
            torch.randn(n, dtype=torch.float64, device="cuda", generator=g) * 2e-5, 0))

    def distances(what, a, bb):
        n_ = bb.shape[-1]
        d = torch.zeros(-(-n_ // scan.tile_of(a, n_)), dtype=torch.int32, device="cuda")
        out = scan._kernel(a, bb, None, d)
        d = d[1:].double()
        dists[what] = (float(d.median()) if d.numel() else 0.0,
                       float(d.max()) if d.numel() else 0.0)
        return out
    for n in R_LENGTHS:
        prices = walk(n)
        dt = torch.rand(n, dtype=torch.float64, device="cuda", generator=g) * 0.14
        a_var = torch.exp(-dt / 60.0)                 # ewmst: a per step from the gaps
        nan_b = prices.clone()
        nan_b[n // 2] = torch.nan
        cases = {"ewma": (oma, prices, None), "ewmst": (a_var, (1.0 - a_var) * prices, None),
                 "y0": (13.0 / 14.0, prices / 14.0, prices[0]), "nan": (oma, nan_b, None)}
        for what, (a, bb, y0) in cases.items():
            got = scan.linear_recurrence(a, bb, y0=y0)
            want = scan.linear_recurrence_plain(a, bb, y0=y0)
            mag = float(torch.nan_to_num(want).abs().max())   # positive terms
            worst = max(worst, assert_window_close(got, want, mag, 1e-12,
                                                   f"R {what} n={n}"))
            assert_exact(scan.linear_recurrence(a, bb, y0=y0), got, f"R {what} run to run")
            if what == "nan" and not bool(torch.isnan(got[n // 2:]).all() &
                                          ~torch.isnan(got[:n // 2]).any()):
                fail(f"R: the NaN at {n // 2} of {n} does not reach exactly the later values")
        if n in (1_000_000, N_MONTH):
            for what in ("ewma", "ewmst"):
                a, bb, _ = cases[what]
                nb = (16 if what == "ewma" else 24) * n
                times[f"{what} n={n}"] = (
                    cuda_ms(lambda: scan.linear_recurrence(a, bb), reps=20),
                    cuda_ms(lambda: scan.linear_recurrence_plain(a, bb), reps=2),
                    bound(nb, 2 * n, PEAK_F64_OPS_PER_S))
        if n == N_MONTH:
            for what in ("ewma", "ewmst"):
                a, bb, _ = cases[what]
                assert_exact(distances(f"{what} n={n}", a, bb), scan.linear_recurrence(a, bb),
                             f"R {what} with its distances counted")
            # beside a stream that keeps the SMs busy: the stops move, the bits do not
            a, bb, _ = cases["ewmst"]
            quiet = scan.linear_recurrence(a, bb)
            x = torch.randn(4096, 4096, device="cuda", generator=g)
            side = torch.cuda.Stream()
            for i in range(3):
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    for _ in range(6):
                        x = torch.tanh(x @ x * 1e-3)
                assert_exact(distances(f"ewmst n={n}, beside a busy stream ({i + 1})", a, bb),
                             quiet, "R beside a busy stream")
            torch.cuda.synchronize()
            del x
        del prices, dt, a_var, nan_b, cases
    # a call on the bars' count: wall time (synchronized) and host time (enqueue)
    bars = walk(n_bars)
    distances(f"ewma n={n_bars}", 1.0 - 2.0 / 21.0, bars)
    scan.linear_recurrence(1.0 - 2.0 / 21.0, bars)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        scan.linear_recurrence(1.0 - 2.0 / 21.0, bars)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        scan.linear_recurrence(1.0 - 2.0 / 21.0, bars)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / 200 * 1e6
    bars_ms = cuda_ms(lambda: scan.linear_recurrence(1.0 - 2.0 / 21.0, bars), reps=200)
    say(f"kernel R == plain within rtol 1e-12 (largest |diff| {worst:.3g}) at n = "
        + ", ".join(map(str, R_LENGTHS)) + " (constant and time-varying a, y0, a NaN), "
        "equal run to run and beside a busy stream; ms (kernel | plain | bound): " + ", ".join(
            f"{k} {t:.4f} | {p:.3f} | {bd[0]:.4f}" for k, (t, p, bd) in times.items())
        + f"; on {n_bars:,} values a call {wall_us:.1f} us wall, {host_us:.1f} us host, "
        f"{bars_ms * 1e3:.2f} us a call by CUDA events over 200 calls (the host's rate "
        "where it is slower than the card's); look-back tiles (median, largest): " + ", ".join(f"{k} {m:g}, {x:g}" for k, (m, x) in dists.items())
        + f" [{card}]")
    t, p, bd = times[f"ewmst n={N_MONTH}"]
    return kernel_entry("R", launches, worst, t, p, bd, None,
                        times_ms={k: {"kernel": v[0], "plain": v[1], "bound": v[2][0]}
                                  for k, v in times.items()},
                        lookback_tiles={k: {"median": m, "largest": x}
                                        for k, (m, x) in dists.items()},
                        bars_call_us={"wall": wall_us, "host": host_us,
                                      "events": bars_ms * 1e3})


def w_series(bars):
    """Kernel W's timed inputs: ``name -> (prices, window)`` on the card."""
    import torch
    r = np.random.default_rng(12)
    walk = 100.0 * np.exp(np.cumsum(r.normal(0.0, 1e-3, 50_000)))
    steps = r.choice([-1, 0, 0, 0, 1], 50_000).astype(np.float64)
    steps[20_000:21_000] = 0.0
    return {"50,000 log prices, window 500": (torch.from_numpy(walk).cuda(), 500),
            f"the month's {bars['close'].shape[0]:,} bars, window {CSW_WINDOW}":
                (bars["close"], CSW_WINDOW),
            "flat runs, window 500": (torch.from_numpy(100.0 + 0.5 * np.cumsum(steps)).cuda(),
                                      500)}


def w_shares(stats):
    """From kernel W's ``stats`` (n, 4): the shares of the admissible lags
    walked in pass 2 and divided there, the t's on the exact path, and the
    lanes walked again a t."""
    st = stats.double()
    lags = float(st[:, 0].sum())
    return {"walked": float(st[:, 1].sum()) / max(lags, 1.0),
            "exact": float(st[:, 2].sum()) / max(lags, 1.0),
            "exact_path_t": int((stats[:, 3] < 0).sum() - (stats[:, 3] == -3).sum()),
            "lanes_again_mean": float(st[:, 3].clamp(min=0).mean())}


def kernel_w(card, bars, launches):
    """Kernel W alone against its plain version on the card, bit for bit:
    50,000 log prices at window 500 (BASELINE.md row 5), the month's bars at
    window 1000, a tick-grid series with flat runs (ties at 0, where the
    largest lag must win), and the filter's adversarial series of
    ``testing.csw_filter_case``; timed with its bound; the share of lags that
    pass 2 walks and divides on each timed input."""
    import torch
    from finmlkit_tpu_torch.feature.kernels import structural_break as sb
    from finmlkit_tpu_torch.testing import CSW_FILTER_CASES, assert_exact, csw_filter_case
    for case in CSW_FILTER_CASES:
        yn, sn, w = csw_filter_case(case)
        y, sigma = torch.from_numpy(yn).cuda(), torch.from_numpy(sn).cuda()
        tables = sb._tables(w, y.device)
        for i, (gg, ww) in enumerate(zip(sb._sup_stat(y, sigma, w, *tables),
                                          sb._sup_stat_plain(y, sigma, w, *tables))):
            assert_exact(gg, ww, f"W on the filter series {case}, output {i}")
    cases = w_series(bars)
    times, shares = {}, {}
    for what, (p, w) in cases.items():
        y = torch.log(p)
        n = y.shape[0]
        _, sigma = sb._sigma(y, w)
        tables = sb._tables(w, y.device)
        stats = torch.zeros(n, 4, dtype=torch.int32, device="cuda")
        got = sb._sup_stat(y, sigma, w, *tables, stats=stats)
        for i, (gg, ww) in enumerate(zip(got, sb._sup_stat_plain(y, sigma, w, *tables))):
            assert_exact(gg, ww, f"W {what} output {i}")
        shares[what] = w_shares(stats)
        t_loc = np.minimum(np.arange(n), w)
        pairs = float(np.maximum(t_loc - 2, 0).sum())
        times[what] = (cuda_ms(lambda: sb._sup_stat(y, sigma, w, *tables), reps=10),
                       cuda_ms(lambda: sb._sup_stat_plain(y, sigma, w, *tables), reps=2),
                       bound(48 * n + 16 * w, 4 * pairs, PEAK_F64_OPS_PER_S))
    say("kernel W == plain bit for bit (up, down, critical values) on " + ", ".join(cases)
        + " and the filter series " + ", ".join(CSW_FILTER_CASES)
        + "; ms (kernel | plain | bound): " + ", ".join(
            f"{k} {t:.4f} | {p:.3f} | {bd[0]:.4f} ({bd[1]})" for k, (t, p, bd) in times.items())
        + "; lags walked in pass 2 | divided there (shares of the admissible lags; each "
        "lane also divides once a side, at its best lag), t's on the exact path, lanes "
        "walked again a t: " + ", ".join(
            f"{k} {v['walked']:.4%} | {v['exact']:.4%}, {v['exact_path_t']}, "
            f"{v['lanes_again_mean']:.2f}" for k, v in shares.items()) + f" [{card}]")
    key = next(k for k in times if k.startswith("the month"))
    t, p, bd = times[key]
    return kernel_entry("W", launches, 0.0, t, p, bd, None,
                        times_ms={k: {"kernel": v[0], "plain": v[1], "bound": v[2][0]}
                                  for k, v in times.items()},
                        pass2=shares)


def config4_kit():
    """BASELINE config 4's feature kit (bench.py:595-602) and, for each of its
    outputs, phase 9's direct call of the same function."""
    from finmlkit_tpu_torch.feature import Feature, FeatureKit
    from finmlkit_tpu_torch.feature import transforms as T
    kit = FeatureKit([
        Feature(T.EWMA(20, "close")),
        Feature(T.RSIWilder(14, "close")),
        Feature(T.ATR(14)),
        Feature(T.Return(1, "close", is_log=True)),
        Feature(T.RealizedVolatility(30, input_col="close_ret1")),
        Feature(T.ZScore(50, "close")),
    ], retain=["close"])
    direct = {"close_ewma20": "ewma", "close_rsiw14": "rsi_wilder", "atr14": "atr",
              "close_ret1": "log_return", "close_ret1_rv30": "realized_vol",
              "close_z50": "comp_zscore"}
    return kit, direct


def all_transforms_kit():
    """Every transform class once at the JAX package's defaults (or windows a
    user of 1-minute bars picks), rebuilt from its JSON config."""
    import datetime
    from finmlkit_tpu_torch.feature import Feature, FeatureKit
    from finmlkit_tpu_torch.feature import transforms as T
    td = datetime.timedelta
    r1 = "close_ret1"
    feats = [T.Identity("close"), T.Lag(1, "close"), T.ReturnT(td(minutes=5), True, "close"),
             T.Return(1, "close", is_log=True), T.ROC(10, "close"), T.PctChange(5, "close"),
             T.RSIWilder(14, "close"), T.StochK(14), T.EWMST(td(hours=1), r1),
             T.ZScore(50, "close"), T.BurstRatio(20, "volume"), T.VWAPDistance(20, True),
             T.TimeCues("close"), T.RealizedVolatility(30, input_col=r1),
             T.BollingerPercentB(20, 2.0, "close"), T.ParkinsonRange(), T.SMA(20, "close"),
             T.EWMA(20, "close"), T.FlowAcceleration(20, 5), T.CUSUMTest(), T.ATR(14),
             T.PriceVolumeCorrelation(), T.VPIN(), T.VarianceRatio14(),
             T.KurtosisTransform(input_col=r1), T.TrendSlope(), T.ADX(),
             T.MeanReversionZScore(), T.DailyGap(), T.ORBBreak(), T.BarRate(td(hours=1)),
             T.CandleShape(), T.HurstExponent(input_col=r1),
             T.ApproximateEntropy(input_col=r1), T.BarDurationEWMA(), T.BarDuration(),
             T.BiPowerVariation(input_col=r1), T.DirRunLen(input_col=r1),
             T.ExternalFunction("torch.log1p", "volume"),
             T.ExternalFunction("numpy.sqrt", "volume", "volume_sqrt", pass_numpy=True)]
    kit = FeatureKit([Feature(t) for t in feats], retain=["close"])
    return FeatureKit.from_dict(json.loads(json.dumps(kit.to_config())))


def framework_frame(b):
    """The time bars as a frame of the feature framework."""
    return {"open": b["open"], "high": b["high"], "low": b["low"], "close": b["close"],
            "volume": b["volume"], "vwap": b["vwap"], "volume_buy": b["buy"],
            "volume_sell": b["sell"], "timestamp": b["ts"]}


def hold_transform(name, got, want, close):
    """A transform's output on the card against the same kit on the CPU:
    NaN positions, flags and integers exact, floats within rtol and atol
    1e-12, but for two closed forms whose rounding grows with the series:
    TrendSlope subtracts window sums of index times log price, ``sum_k_y =
    s1 - (i - w + 1) s0``, whose terms reach ``n w log(close)``, so a last-bit
    difference of a log price moves it by rounding units of those terms: its
    bound is 4 of them, carried through ``degrees(arctan(. / denom))``. The
    CSW scores divide by sigma_t, whose square is a difference of two prefix
    sums of squared log returns (``structural_break._sigma``, the JAX
    package's form), each up to their total C, and the card's prefix sums add
    in another order: each score's bound adds ``4 eps C / S_t`` of it, S_t its
    window's sum. Returns the largest absolute deviation and the largest
    share of its bound that a value's deviation takes."""
    import torch
    from finmlkit_tpu_torch.feature.kernels import structural_break as sb
    from finmlkit_tpu_torch.testing import assert_exact, to_numpy
    what = f"{name} card vs cpu"
    if not got.dtype.is_floating_point:
        assert_exact(got, want, what)
        return 0.0, 0.0
    g, v = to_numpy(got).astype(np.float64), to_numpy(want).astype(np.float64)
    if not np.array_equal(np.isnan(g), np.isnan(v)):
        raise AssertionError(f"{what}: NaN at different positions")
    ok = ~np.isnan(v)
    g, v = g[ok], v[ok]
    eps = 2.0**-52
    atol, rtol = FEATURE_ATOL, FEATURE_RTOL
    if name.startswith("close_trend_slope_"):
        w = int(name.rsplit("_", 1)[1])
        terms = close.shape[0] * w * float(torch.log(close).abs().max())
        atol = 4 * eps * terms / (w * (w * w - 1) / 12.0) * (180.0 / math.pi)
    elif name.startswith("cumote_") and name.endswith("_score"):
        w = min(int(name.split("_")[1].lstrip("updown")), close.shape[0])
        y = torch.log(close)
        t_loc, sigma = sb._sigma(y, w)
        total = float(torch.cumsum(torch.diff(y) ** 2, 0)[-1])
        window = (sigma ** 2 * (t_loc - 1).clamp(min=1)).numpy()[ok]
        with np.errstate(divide="ignore"):
            rtol = rtol + 4 * eps * total / window
    lim = atol + rtol * np.abs(v)
    d = np.abs(g - v)
    if (d > lim).any():
        i = int(np.argmax(d - lim))
        raise AssertionError(f"{what}: |diff| {d[i]!r} above {lim[i]!r}")
    if not d.size:
        return 0.0, 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        share = np.where(d == 0, 0.0, d / lim)
    return float(d.max()), float(share.max())


def profile_numpy(fp, i, start, m, va_pct=PROFILE_VA):
    """Bar i's rolling profile (no bins) in numpy on the host: its window's
    float64 grid of m levels, the first maximum, the value-area walk
    (``finmlkit_tpu/feature/kernels/volume.py:64-114``)."""
    s = int(start[i])
    lo = int(fp["low"][s:i + 1].min())
    g = np.zeros(m)
    for j in range(s, i + 1):
        nl, off = int(fp["nl"][j]), int(fp["low"][j]) - lo
        v = fp["buy"][j, :nl].astype(np.float64) + fp["sell"][j, :nl]
        g[off:off + nl] += v
    total = g.sum()
    p = int(np.argmax(g))
    cum, up, down, hv, lv = g[p], p + 1, p - 1, p, p
    while cum < total * (va_pct / 100.0):
        cu = g[up] + (g[up + 1] if up + 1 < m else 0.0) if up < m else -1.0
        cd = g[down] + (g[down - 1] if down >= 1 else 0.0) if down >= 0 else -1.0
        if cu > cd:
            cum, hv, up = cum + cu, min(up + 1, m - 1), up + 2
        elif cu < cd:
            cum, lv, down = cum + cd, max(down - 1, 0), down - 2
        elif cu == cd and cu != -1.0:
            cum, hv, lv, up, down = cum + cu + cd, min(up + 1, m - 1), max(down - 1, 0), \
                up + 2, down - 2
        else:
            break
    return lo + p, lo + hv, lo + lv


def window_spans(start, first, low, nl, L, m):
    """Each full window's level span, ``max_j(low_j + n_levels_j) - min_j
    low_j`` over its bars, within [1, m]: the levels kernel G works on."""
    import torch
    n = low.shape[0]
    i = torch.arange(first, n, device=low.device)
    s = start[first:]
    lo = low[i].long()
    hi = lo + nl[i].long().clamp(0, L)
    for d in range(int((i - s).max()) + 1 if n > first else 0):
        j = torch.where(s + d <= i, s + d, i)
        lo = torch.minimum(lo, low[j].long())
        hi = torch.maximum(hi, low[j].long() + nl[j].long().clamp(0, L))
    return (hi - lo).clamp(1, m)


def walk_stats(grid, lo, n_bins, va):
    """The plain value-area walk (``volume._profile_rows_plain``) on each row
    of ``grid``, counted: the row's span (one past its last nonzero level,
    after bucketing), its steps, its steps that move both sides, those at zero
    pairs, and the levels from LVA to HVA."""
    import torch
    from finmlkit_tpu_torch.feature.kernels import volume
    m = grid.shape[1]
    vol = volume._bucket_plain(grid, lo, n_bins)[0] if n_bins else grid
    k = torch.arange(m, device=grid.device)
    span = torch.where(vol != 0, k + 1, 1).amax(1)
    total = volume._canonical_sum(vol)
    pidx = torch.argmax(vol, dim=1)

    def at(i):
        return vol.gather(1, i.clamp(0, m - 1)[:, None])[:, 0]

    thr = total * va
    cum = at(pidx)
    up, down, hv, lv = pidx + 1, pidx - 1, pidx.clone(), pidx.clone()
    steps, both_n, zero_n = (torch.zeros_like(pidx) for _ in range(3))
    active = cum < thr
    while bool(active.any()):
        cu = torch.where(up < m, at(up) + torch.where(up + 1 < m, at(up + 1), 0.0), -1.0)
        cd = torch.where(down >= 0, at(down) + torch.where(down - 1 >= 0, at(down - 1), 0.0),
                         -1.0)
        go_up, go_down = cu > cd, cu < cd
        both = (cu == cd) & (cu != -1.0)
        step = active & (go_up | go_down | both)
        steps += step
        both_n += step & both
        zero_n += step & both & (cu == 0)
        cum = torch.where(step, cum + torch.where(go_up, cu, torch.where(go_down, cd, cu + cd)),
                          cum)
        u, d = step & (go_up | both), step & (go_down | both)
        hv = torch.where(u, torch.clamp(up + 1, max=m - 1), hv)
        up = torch.where(u, up + 2, up)
        lv = torch.where(d, torch.clamp(down - 1, min=0), lv)
        down = torch.where(d, down - 2, down)
        active = step & (cum < thr)
    return {"span": span, "steps": steps, "both": both_n, "zero both": zero_n,
            "levels crossed": hv - lv}


def quantiles(x):
    """Mean, median, 90th and 99th percentiles and maximum of a tensor."""
    import torch
    x = x.to(torch.float64)
    q = torch.quantile(x, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=x.device))
    return {"mean": float(x.mean()), "p50": float(q[0]), "p90": float(q[1]),
            "p99": float(q[2]), "max": float(x.max())}


def check_g_cases(card):
    """Kernel G against its plain version on the adversarial profiles of
    ``testing.profile_rows_case`` and ``profile_case``, with bins and without,
    at va_pct 68.34 and 100, in one launch and split over launches of 4, 8,
    16, ... levels. Returns the number of runs, each equal bit for bit."""
    import torch
    from finmlkit_tpu_torch.feature.kernels import volume
    from finmlkit_tpu_torch.testing import (PROFILE_CASES, PROFILE_EXTRA_CASES,
                                           PROFILE_ROW_CASES, PROFILE_TS, PROFILE_WINDOW,
                                           assert_exact, profile_case, profile_rows_case)
    runs = 0
    for nb in (None, 27):
        for va in (0.6834, 1.0):
            for split in (None, 4):
                for name in PROFILE_ROW_CASES:
                    grid, lo = profile_rows_case(name)
                    g = torch.from_numpy(grid).cuda()
                    got = volume._profile_rows(g, lo, nb, va, split=split)
                    for x, y in zip(got, volume._profile_rows_plain(g, lo, nb, va)):
                        assert_exact(x, y, f"G rows {name} bins {nb} va {va} split {split}")
                    runs += 1
                for name in PROFILE_CASES + PROFILE_EXTRA_CASES:
                    low, nl, buy, sell, m = profile_case(name)
                    t = volume._footprint_tensors(PROFILE_TS, low, nl, buy, sell, "cuda")
                    start, first, m = volume._rolling_sizes(t[0], t[1], t[2], buy.shape[1],
                                                            PROFILE_WINDOW * 10**9, m)
                    args = (start, first, *t[1:], m, nb, va)
                    got = volume._rolling(*args, split=split)
                    for x, y in zip(got, volume.volume_profile_rolling_plain(*args)):
                        assert_exact(x, y, f"G rolling {name} bins {nb} va {va} split {split}")
                    runs += 1
    torch.cuda.synchronize()
    say(f"kernel G == plain bit for bit on {runs} runs of the adversarial profiles (pair ties, "
        f"equal running minima, NaN levels, walks to either end and into the zeros past the "
        f"span, no volume, one level, the clip column, max_levels above every span) [{card}]")
    return runs


def phase_framework(card, month, need):
    """Phase 10: config 4's kit and every transform on the month's time bars,
    VolumePro on its dollar bars' footprints. Returns the path's launches and
    the ``kernels`` entries of G and of those of ``need`` that no earlier
    phase timed."""
    import torch
    from finmlkit_tpu_torch import _build
    from finmlkit_tpu_torch.feature import fuse
    from finmlkit_tpu_torch.feature.kernels import VolumePro, structural_break, volume
    from finmlkit_tpu_torch.ops import fused_scan, prefix_scan, scan
    from finmlkit_tpu_torch.testing import assert_close, assert_exact
    t_phase = time.perf_counter()
    b = month_bars(month)
    frame = framework_frame(b)
    n_bars = b["close"].shape[0]
    kit4, direct = config4_kit()
    kit_all = all_transforms_kit()
    tr, price, amount = month["tr"], month["price"], month["amount"]
    thr = float((price * amount).sum()) / DOLLAR_BARS
    pros = {nb: VolumePro(PROFILE_WINDOW, n_bins=nb, va_pct=PROFILE_VA) for nb in PROFILE_BINS}
    # the planned graph's device entry (``fuse.FusedGraph.run_device``) on config 4
    cols = {k: v for k, v in frame.items() if k != "timestamp"}
    topo = {str(f.name): f for f in kit4.features}
    graph4 = fuse.build_fused_from_specs([topo[n] for n in kit4.topological_order()], cols,
                                         frame["timestamp"])

    def path():
        got4 = kit4.build(frame, order="topo")
        got4f = kit4.build(frame, order="topo", fuse=True)  # the JAX signature's switch
        got4g = graph4.run_device(cols, frame["timestamp"])
        got_all = kit_all.build(frame, order="topo")
        dollar, _ = run_dollar(tr, thr)
        fp = {"timestamp": dollar["close_ts"][1:], **dollar["footprints"]}
        prof = {nb: pro.compute(fp, tr.tick_size) for nb, pro in pros.items()}
        return got4, got4f, got4g, got_all, dollar, fp, prof

    path()                                   # warm: allocator, tables, the build
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_scan.LAUNCHES = prefix_scan.LAUNCHES = prefix_scan.FLOAT_LAUNCHES = 0
    prefix_scan.COLS_LAUNCHES = scan.LAUNCHES = structural_break.LAUNCHES = 0
    volume.LAUNCHES = 0
    got4, got4f, got4g, got_all, dollar, fp, prof = path()   # the path's counted run
    torch.cuda.synchronize()
    launches = {"B": fused_scan.LAUNCHES, "S": prefix_scan.LAUNCHES,
                "S float": prefix_scan.FLOAT_LAUNCHES, "C": prefix_scan.COLS_LAUNCHES,
                "R": scan.LAUNCHES, "W": structural_break.LAUNCHES, "G": volume.LAUNCHES}
    peak_gib = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    if min(launches[k] for k in ("B", "S", "C", "R", "W", "G")) < 1:
        fail(f"a kernel of the framework path did not launch: {launches}")

    # --- config 4's kit: each output equal to phase 9's direct call ---
    calls = feature_calls(b)
    for name, fn in direct.items():
        want = calls[fn]()
        assert_exact(got4[name], want, f"kit {name} vs {fn}")
        assert_exact(got4f[name], want, f"kit with fuse=True {name} vs {fn}")
        assert_exact(got4g[name], want, f"planned graph {name} vs {fn}")
    if set(got4) != {"close", "timestamp", *direct} or list(got4f) != list(got4) \
            or set(got4g) != set(direct):
        fail(f"config 4's kit returned the columns {list(got4)}")

    def ms_of(fn):
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        return a.elapsed_time(e)

    def six():
        for name in SIX_FEATURES:
            calls[name]()

    stages = {"kit": lambda: kit4.build(frame, order="topo"),
              "planned graph": lambda: graph4.run_device(cols, frame["timestamp"]),
              "six functions": six}
    times = {k: [] for k in stages}
    for _ in range(5):
        for k, fn in stages.items():
            times[k].append(ms_of(fn))
    say(f"framework: config 4's kit (topo order) on {n_bars:,} bars == phase 9's direct "
        f"calls bit for bit, with fuse=True too, and so is its planned graph (run_device); "
        f"ms, median (min-max) of 5: " + ", ".join(
            f"{k} {float(np.median(v)):.3f} ({min(v):.3f}-{max(v):.3f})"
            for k, v in times.items()) + "; the framework's cost (kit - six functions, "
        f"medians) {float(np.median(times['kit']) - np.median(times['six functions'])):.3f}"
        f" ms [{card}]")

    # --- every transform on the card against the same kit on the CPU ---
    frame_cpu = {k: v.cpu() for k, v in frame.items()}
    t0 = time.perf_counter()
    want_all = kit_all.build(frame_cpu, order="topo", device="cpu")
    cpu_s = time.perf_counter() - t0
    if list(want_all) != list(got_all):
        fail("the transforms' kit returned other columns on the card than on the CPU")
    worst, share, problems = {}, {}, []
    for name, g in got_all.items():
        if g.shape != (n_bars,):
            fail(f"{name}: not {n_bars} values")
        try:
            worst[name], share[name] = hold_transform(name, g, want_all[name],
                                                      frame_cpu["close"])
        except AssertionError as e:     # every transform is held before the phase fails
            problems.append(str(e))
    cache = dict(got_all, **frame)
    each = {}
    for feat in kit_all.features:
        each[type(feat.transform).__name__ + ("" if not getattr(
            feat.transform, "pass_numpy", False) else " (numpy)")] = \
            cuda_ms(lambda f=feat: f(cache), reps=3)
    for p in problems:
        say(f"FAIL: {p}")
    say(f"framework: every transform class ({len(kit_all.features)} features, "
        f"{len(got_all)} columns) through a kit rebuilt from JSON vs its CPU run: "
        f"{len(got_all) - len(problems)} equal (largest deviation "
        f"{max(worst.values(), default=0.0):.3g}), {len(problems)} not; CPU run "
        f"{cpu_s:.2f} s [{card}]")
    say("framework: the two conditioning bounds, largest |diff| and its largest share of "
        "the bound: " + ", ".join(
            f"{k} {worst[k]:.3g} ({share[k]:.3g})" for k in worst
            if k.startswith("close_trend_slope_")
            or (k.startswith("cumote_") and k.endswith("_score"))) + f" [{card}]")
    say("transform ms (CUDA events, mean of 3): " + ", ".join(
        f"{k} {v:.3f}" for k, v in each.items()) + f" [{card}]")
    del got_all, want_all, cache

    # --- VolumePro: kernel G against its plain version ---
    ts, low, nl, buy, sell = volume._footprint_tensors(
        fp["timestamp"], fp["low_level"], fp["n_levels"], fp["buy_volumes"],
        fp["sell_volumes"], "cuda")
    n_dollar, L = buy.shape
    start, first, m = volume._rolling_sizes(ts, low, nl, L, int(PROFILE_WINDOW * 1e9), None)
    w_bars = int((torch.arange(n_dollar, device="cuda") - start + 1).max())
    va = PROFILE_VA / 100.0
    spans = window_spans(start, first, low, nl, L, m)
    say(f"G's work: the {n_dollar - first:,} full windows span (levels) {quantiles(spans)}; "
        f"share at most {volume._SPLIT_LEVELS:,} levels (its first launch) "
        f"{float((spans <= volume._SPLIT_LEVELS).double().mean()):.4f} [{card}]")
    pick = torch.from_numpy(np.sort(np.random.default_rng(13).choice(
        np.arange(first, n_dollar), min(2048, n_dollar - first), replace=False))).cuda()
    sample, s_lo = volume._window_grid_plain(pick, start, low, nl, buy, sell, m)
    for nb in PROFILE_BINS:
        st = {k: quantiles(v) for k, v in walk_stats(sample, s_lo, nb, va).items()}
        say(f"G's walk on {pick.shape[0]:,} bars drawn with seed 13, bins {nb}: "
            + "; ".join(f"{k} {v}" for k, v in st.items()) + f" [{card}]")
    del sample
    g_cases = check_g_cases(card)
    runs, plain_ms, g_ms, scratch_ms, plain_bars = {}, {}, {}, {}, n_dollar
    for nb in PROFILE_BINS:
        runs[nb] = volume._rolling(start, first, low, nl, buy, sell, m, nb, va)
        for i, (x, y) in enumerate(zip(prof[nb][:3], runs[nb][:3])):
            yp = y.to(torch.float64) * tr.tick_size
            assert_exact(x, torch.where(yp == 0, torch.nan, yp), f"VolumePro {nb} output {i}")
        assert_exact(prof[nb][3], runs[nb][3], f"VolumePro {nb} pct")
    # the plain version on the whole month if it takes under PROFILE_PLAIN_S,
    # estimated from one chunk of its bars a bins setting
    k0 = min(n_dollar, max(first + 1, volume._PLAIN_CELLS // m))
    t0 = time.perf_counter()
    for nb in PROFILE_BINS:
        volume.volume_profile_rolling_plain(start[:k0], first, low[:k0], nl[:k0], buy[:k0],
                                            sell[:k0], m, nb, va)
    torch.cuda.synchronize()
    est = (time.perf_counter() - t0) * n_dollar / k0
    if est > PROFILE_PLAIN_S:
        plain_bars = max(k0, int(n_dollar * PROFILE_PLAIN_S / 2 / est))
    pct_err, pct_off = 0.0, 0
    for nb in PROFILE_BINS:
        k = plain_bars
        t0 = time.perf_counter()
        want = volume.volume_profile_rolling_plain(start[:k], first, low[:k], nl[:k],
                                                   buy[:k], sell[:k], m, nb, va)
        torch.cuda.synchronize()
        plain_ms[nb] = (time.perf_counter() - t0) * 1e3
        for i in range(3):
            assert_exact(runs[nb][i][:k], want[i], f"G {nb} bins output {i} vs plain")
        pct_err = max(pct_err, assert_close(runs[nb][3][:k], want[3], rtol=1e-12,
                                            what=f"G {nb} bins pct vs plain"))
        pct_off += int((runs[nb][3][:k] != want[3]).sum())
        # the global-scratch grid, forced, against the shared-memory grid; the
        # walks a warp each (by default a thread each at this count)
        forced = volume._rolling(start, first, low, nl, buy, sell, m, nb, va,
                                 shared_cap=PROFILE_SHARED_CAP)
        warped = volume._rolling(start, first, low, nl, buy, sell, m, nb, va, walk_warp=True)
        for i in range(4):
            assert_exact(forced[i], runs[nb][i], f"G {nb} bins scratch grid output {i}")
            assert_exact(warped[i], runs[nb][i], f"G {nb} bins walks a warp each, output {i}")
        g_ms[nb] = cuda_ms(lambda: volume._rolling(start, first, low, nl, buy, sell, m, nb, va))
        scratch_ms[nb] = cuda_ms(lambda: volume._rolling(start, first, low, nl, buy, sell, m,
                                                         nb, va, shared_cap=PROFILE_SHARED_CAP))
    # the outputs are right: 20 bars against numpy, and their order
    host = {"low": low.cpu().numpy(), "nl": nl.cpu().numpy(), "buy": buy.cpu().numpy(),
            "sell": sell.cpu().numpy()}
    start_h = start.cpu().numpy()
    poc, hva, lva, pct = (x.cpu().numpy() for x in runs[None])
    for i in np.random.default_rng(10).choice(np.arange(first, n_dollar), 20, replace=False):
        if profile_numpy(host, int(i), start_h, m) != (poc[i], hva[i], lva[i]):
            fail(f"G: bar {i}'s profile differs from numpy's")
    done = np.arange(n_dollar) >= first
    if not ((lva[done] <= poc[done]) & (poc[done] <= hva[done])).all() or \
            not ((pct[done] >= 0) & (pct[done] <= 1)).all() or poc[~done].any():
        fail("G: a POC outside its value area, a share outside [0, 1] or a warm-up value")
    # bound: each bar's levels read once (float32 pairs), 20 bytes a bar
    # written; one float64 add a level of each window
    nl64 = nl.to(torch.int64).clamp(max=L)
    pre = torch.cat([nl64.new_zeros(1), torch.cumsum(nl64, 0)])
    idx = torch.arange(n_dollar, device="cuda")
    adds = float((pre[idx + 1] - pre[start])[first:].sum())
    g_bound = bound(8 * float(nl64.sum()) + 20 * n_dollar, adds, PEAK_F64_OPS_PER_S)

    # the developing profile over the last day, by G's rows mode
    day_s = int(torch.searchsorted(ts, ts[-1:] - 86_400 * 10**9)[0])
    grid, g_lo = volume._developing_grid(low[day_s:], nl[day_s:], buy[day_s:], sell[day_s:])
    room = int(_build.library().fmk_profile_shared_levels())
    dev_ms = {}
    for nb in PROFILE_BINS:
        st = {k: quantiles(v) for k, v in walk_stats(grid, g_lo, nb, va).items()}
        say(f"G's walk on the last day's {grid.shape[0]:,} developing rows, bins {nb}: "
            + "; ".join(f"{k} {v}" for k, v in st.items()) + f" [{card}]")
        got = volume._profile_rows(grid, g_lo, nb, va)
        want = volume._profile_rows_plain(grid, g_lo, nb, va)
        forced = volume._profile_rows(grid, g_lo, nb, va, shared_cap=PROFILE_SHARED_CAP)
        threads = volume._profile_rows(grid, g_lo, nb, va, walk_warp=False)
        for i in range(3):
            assert_exact(got[i], want[i], f"developing {nb} bins output {i}")
            assert_exact(forced[i], got[i], f"developing {nb} bins scratch grid output {i}")
            assert_exact(threads[i], got[i], f"developing {nb} bins walks a thread each {i}")
        pct_err = max(pct_err, assert_close(got[3], want[3], rtol=1e-12,
                                            what=f"developing {nb} bins pct"))
        pub = volume.volume_profile_developing(ts, low, nl, buy, sell,
                                               int(ts[day_s]), int(ts[-1]), n_bins=nb)
        for i in range(3):
            assert_exact(pub[i + 1], got[i], f"volume_profile_developing {nb} output {i}")
        dev_ms[nb] = cuda_ms(lambda: volume._profile_rows(grid, g_lo, nb, va))
    say(f"VolumePro on {n_dollar:,} dollar bars (window {PROFILE_WINDOW:.0f} s: "
        f"max_window_bars {w_bars}, max_levels {m}, L {L}, first full window at bar "
        f"{first}; G's shared grid takes up to {room:,} levels): kernel G == plain "
        f"(POC, HVA, LVA exact, pct within rtol 1e-12, {pct_off} not bit-equal) on "
        f"{'the whole month' if plain_bars == n_dollar else f'the first {plain_bars:,} bars'}"
        f" at bins {PROFILE_BINS}; the global-scratch grid (cap {PROFILE_SHARED_CAP}) and the "
        f"walks a warp each == the shared grid and the walks a thread each; 20 bars == numpy; "
        f"developing over the last day "
        f"({grid.shape[0]:,} bars x {grid.shape[1]:,} levels, "
        f"{'shared' if grid.shape[1] <= room else 'global-scratch'} grid, and the "
        f"global-scratch grid forced, and the walks a thread each) by G's rows mode == plain "
        f"[{card}]")
    # bound of rows mode: each row's levels read once, 20 bytes a row written
    rows_bound = bound(8 * grid.numel() + 20 * grid.shape[0], grid.numel(), PEAK_F64_OPS_PER_S)
    say("kernel G ms (CUDA events, mean of 5 | plain, one call on the bars compared | "
        "bound): " + ", ".join(
            f"bins {nb}: {g_ms[nb]:.3f} (scratch grid {scratch_ms[nb]:.3f}) | "
            f"{plain_ms[nb]:.1f} | {g_bound[0]:.4f} ({g_bound[1]})" for nb in PROFILE_BINS)
        + "; developing rows: " + ", ".join(f"bins {nb} {v:.3f}" for nb, v in dev_ms.items())
        + f" | bound {rows_bound[0]:.4f} ({rows_bound[1]}); adds {adds:.4g} [{card}]")
    say(f"framework phase: peak device memory {peak_gib:.3f} GiB above its inputs; wall "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    if problems:
        fail(f"{len(problems)} transform outputs differ from their CPU run")

    entries = {"G": kernel_entry(
        "G", launches["G"], pct_err, g_ms[PROFILE_BINS[0]], plain_ms[PROFILE_BINS[0]],
        g_bound, None, plain_bars=plain_bars, n_bars=n_dollar, max_levels=m,
        adversarial_runs=g_cases, developing_rows_bound_ms=rows_bound[0],
        times_ms={str(nb): {"kernel": g_ms[nb], "scratch_grid": scratch_ms[nb],
                            "plain": plain_ms[nb], "developing_rows": dev_ms[nb]}
                  for nb in PROFILE_BINS})}
    del runs, grid, host
    if need & {"B", "S"}:      # no earlier phase timed them: at this path's shapes
        dollars = (tr.ticks.to(torch.int64) * tr.units) >> 6
        entries.update(kernels_b_s(card, tr, dollar["ci"], launches, s_inputs=(dollars,)))
        del dollars
    if "C" in need:
        entries["C"] = kernel_c(card, tr, dollar["ci"], dollar["footprints"]["low_level"],
                                launches)
    if "R" in need:
        entries["R"] = kernel_r(card, launches["R"], b["close"].shape[0])
    if "W" in need:
        entries["W"] = kernel_w(card, b, launches["W"])
    return launches, entries


def main():
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10",
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

    def merge(path, launches, entries):
        launches = dict(launches)
        s_float = launches.pop("S float", None)  # S's launches on float streams
        for name, n in launches.items():
            if name in kernels:                 # timed by an earlier phase
                kernels[name]["launches"] += n
                for key, value in entries.get(name, {}).items():
                    kernels[name].setdefault(key, value)  # e.g. F's int32 fill
            else:
                kernels[name] = dict(entries[name], launches_by_path={})
            kernels[name]["launches_by_path"][path] = n
        if s_float is not None:
            kernels["S"].setdefault("float_launches_by_path", {})[path] = s_float

    month = make_month(N_MONTH) if phases & {5, 6, 7, 8, 9, 10} else None
    if 5 in phases:
        merge("time", *phase_month(card, month))
    if 6 in phases:
        merge("dollar", *phase_dollar(card, month, with_bs=5 not in phases,
                                      profile=args.profile))
    if 7 in phases:
        need = {"B", "S", "C"} - set(kernels)
        merge("info", *phase_info(card, month, need))
    if 8 in phases:
        need = {"B", "S", "C"} - set(kernels)
        launches, entries, floor_launches = phase_engines(card, month, need)
        merge("engines", launches, entries)
        merge("floor", floor_launches, entries)
    if 9 in phases:
        merge("features", *phase_features(card, month))
    if 10 in phases:
        need = {"B", "S", "C", "R", "W"} - set(kernels)
        merge("framework", *phase_framework(card, month, need))
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
