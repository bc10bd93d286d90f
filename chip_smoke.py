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
time bars' products through every median engine and bar scan, the time
bars' features, the chain from raw trades to final sample weights, the
same month with its prices off every tick grid through the kits' float64 path,
and the month's 1-second klines with their resample and the host medians.
Phases:

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
   phase's path; peak device memory;
11. the chain, ``examples/quickstart.py``'s flow on the month: a
   ``TradesData`` from the raw trades (ids 0..n-1, the sides as
   ``is_buyer_maker``; its host seconds; equal to the input columns, since the
   month has no split trades), ``TimeBarKit`` on it (1-minute bars), the
   pipeline (``bar_feature_dispatch`` and ``bar_feature_drain``) with BASELINE
   config 4's six features as a planned graph, ``cusum_filter`` on the closes
   (0.002), ``TBMLabel`` on the features frame at the events (target realized
   volatility 30, its leading NaNs trimmed by the kit; a 30-minute vertical
   barrier over every trade), ``compute_weights`` and
   ``SampleWeights.compute_final_weights`` (intercept 0.5, the attribution,
   the vertical-touch weights and the labels), ``z_score_peak_filter`` on the
   closes' log returns (window 50, threshold 3); through the kernels and
   through the plain versions. The pipeline's bars equal the kit's
   ``build_ohlcv`` and ``build_directional_features`` and its features
   config 4's kit build, bit for bit; kernel path against plain path: bars,
   features, events (kernel Z against the host loop on the closes read back),
   event and touch indices and labels exact, uniqueness,
   attribution and final weights within rtol 1e-12 of their prefix
   magnitude, the final weights equal between two kernel runs, the z-score
   events equal but for z-scores within 1e-9 of the threshold (counted);
   B, S and R launched, Z once; each stage's time, the chain end to end, peak
   device memory. B, S, R and Z are timed here when no earlier phase timed
   them;
12. the off-grid month: the same draws with the prices left off the 0.1 grid
   (``quantize_trades`` gives None), through the kits' float64 path:
   ``TimeBarKit`` (1-minute bars: OHLCV, directional features, trade-size
   features with theta the bars' median trade size, footprints on the 0.1
   grid), ``VolumeBarKit`` at total volume / 40000 and ``DollarBarKit`` at
   total dollars / 40000, with the launches of S, C, D and E volume counted
   on that run, the dollar walk by D's warp step and the volume walk in
   units through E's volume scan; then the same path through the
   functions the kits call, through the
   kernels and through the plain versions: the kits equal those functions
   and the kernel path equals itself run to run, bit for bit; kernel path
   against plain path: close indices (kernel D against its plain loop on the
   whole month, both modes) and footprints exact, the products within
   ``testing.hold_float_path``'s bounds; sampled bars against numpy, sampled
   footprint bars against ``np.add.at``; kernel D alone with its bound on
   each route against its plain loop on the whole month: the kits' two
   walks, the volume walk with one dust trade (the warp step in chunks) and
   both walks with one amount negated (the block walk), each with its route
   and counts (rounds of ballots, ties, binade crossings, serial adds, the
   walker's cycles; the volume walk's chunks, merges and fix-ups), its plain
   loop timed on the host; stage and end-to-end times, peak device memory.
   S, C and E volume are timed here, S and C on float64 streams, when no
   earlier phase timed them;
13. the host-only layers on the month: its 1-second klines as
   ``data/klines.py AddTimeBarH5`` builds them (``build_klines``, the kit:
   kernels B and S), through the kernels and through the plain versions, exact,
   200 bars against numpy, stage times; their resample to 1min, 1h and 1D
   (``resample``, kernel S twice a call) against its plain version (exact) and
   a numpy oracle of the JAX resample (OHLC, trades and median exact, volume
   and vwap within 2^-22), CUDA-event medians of 3 and row counts;
   ``medians="host"`` (``native/``, g++) against ``"sort"`` on the 1-minute
   bars, pairs, finals and the kit bit for bit, both timed with the host's
   thread count; the CLI's parse (``cli/binance2h5.py load_csv_from_zip``
   and its preprocessing) of a local spot-layout ZIP of the month's first
   ``--cli-trades`` trades (default 1M; 39171929 is the whole month) in a
   process of its own, its columns against the text written, exact, with its
   host seconds and its peak resident memory; where h5py imports, the month
   saved as its two store months and loaded back equal,
   ``H5Inspector.inspect_gaps``, ``AddTimeBarH5`` over both months, a
   ``TimeBarReader.read`` across the month boundary and the CLI offline on
   that ZIP, each step's host seconds (else one line says h5py does not
   import). B and S are timed here when no earlier phase timed them;
14. the parallel layer (``finmlkit_tpu_torch/parallel``): kernel E from the
   adversarial entry states of ``testing.E_ENTRY_CASES`` at 1, the default and
   132 chunks and kernel D from entry sums on each route (the exit sum of a
   stream's first third, one ulp below the threshold), against their plain
   versions, closes and exit states bit for bit; E's four scans and D's two
   walks on the month cut at the ranks' span edges, each span from the state
   the kernel left, against plain from the same states (CUSUM's states
   within 1e-12 of lam) and against one scan; then the month through the
   sharded layer on ``--ranks`` (default 4) gloo ranks sharing the card
   (``parallel/dryrun.py month_path``): the seven indexers (time, tick,
   volume in units and in float64, dollar in units and in float64, CUSUM,
   imbalance, run), the time bars' products, trade-size features and
   medians, an EWMA, the triple barrier sharded over CUSUM events with its
   weights, and the footprints and rolling profile of the first 7 days'
   dollar bars, each stage timed on every rank, the ring's wall beside one
   device's scan, the collectives' bytes; rank 0 holds every output to one
   device (closes, integers, prices, medians, footprints, labels, weights
   bit for bit, the float sums within ``testing.hold_float_path``'s bounds,
   the profile's pct within 1e-12), every rank's outputs equal, the time
   indexer and the volume ring again with every collective staged through
   pinned host memory; one nccl rank's closes equal the gloo ranks'. Four
   ranks sharing one card measure no scaling.

Run from the repository root: ``python3 chip_smoke.py``; ``--phases 1,2,6``
runs only the order-flow path, ``--phases 1,2,7`` only the information-driven
bars, ``--phases 1,2,8`` only the engines, ``--phases 1,2,9`` only the
features, ``--phases 1,2,10`` only the framework and the profile,
``--phases 1,2,11`` only the chain, ``--phases 12`` only the off-grid month,
``--phases 13`` only the klines, the host medians and the store,
``--phases 14`` only the parallel layer (``--ranks`` its gloo ranks), and
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
# phase 12: the off-grid month
OFFGRID_TICK = 0.1           # the footprints' grid: the rounded month's tick


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
                               ("run", 680, ", each close found by a search of bit-packed "
                                "buy and sell counts on -1, 0, +1 weights"),
                               ("volume", 368, ""))},
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
    "D": ("D float_walk, the exact float64 volume and dollar walks: the warp step over "
          "grid tables that producer warps build ahead, volume in chunks that merge, or "
          "in integer units through E where no sum rounds (replaces host C++, not a TPU "
          "kernel)",
          "float_walk.cu", "finmlkit_tpu/native/seg_stats.cpp:183 and :199"),
    "Z": ("Z cusum_filter, the CUSUM event filter in one block of 1024 walkers whose "
          "chunk walks meet in rounds (replaces the host loop, not a TPU kernel)",
          "cusum_filter.cu", "finmlkit_tpu/native/seg_stats.cpp:137"),
}


def say(msg):
    print(msg, flush=True)


def kernel_entry(key, launches, err, ms, plain_ms, bound_ms, library_ms, **extra):
    """One kernel's entry of the ``kernels`` line; ``bound_ms`` is a
    ``bound()`` pair."""
    name, source, replaces = KERNELS[key]
    entry = {"name": name, "route": "cuda",
             "source": f"finmlkit_tpu_torch/csrc/{source}", "replaces": replaces,
             "launches": launches, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms[0], "bound_by": bound_ms[1],
             "library_ms": library_ms}
    if set(extra) & set(entry):
        fail(f"kernel {key}'s extra keys {sorted(set(extra) & set(entry))} would replace "
             f"keys of the kernels line")
    return dict(entry, **extra)


def bound(nbytes, ops, peak=PEAK_OPS_PER_S):
    """``(bound_ms, bound_by)`` of the ``kernels`` line; ``peak`` is the
    operations' rate (float32 unless given)."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def fail(msg):
    say(f"FAIL: {msg}")
    sys.exit(1)


def synth_trades(n, seed=0, rounded=True):
    """The synthetic month of bench.py:78-86 (``testing.bench_trades``)."""
    from finmlkit_tpu_torch.testing import bench_trades
    return bench_trades(n, seed, rounded)


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
    from finmlkit_tpu_torch.utils import trace
    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    nvcc = trace.report().get("build.nvcc")
    built = f"nvcc {nvcc['first_ms'] / 1e3:.2f} s" if nvcc else "cached"
    say(f"build: {secs:.2f} s ({built}; library loads {trace.counter('build.library')}) "
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
    # kernel Z, or on the plain path the host loop on the closes read back
    ev = (cusum_filter(close.cpu(), [0.002]).to(close.device) if plain
          else cusum_filter(close, [0.002]))
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
    from finmlkit_tpu_torch.ops import prefix_scan
    from finmlkit_tpu_torch.testing import assert_exact, assert_window_close
    from finmlkit_tpu_torch.utils import trace

    n_trades, ts, amount, side, q, tr = (month[k] for k in
                                         ("n", "ts", "amount", "side", "q", "tr"))

    def to_device():
        return interop.from_numpy(q, None, side, amount, "cuda", timestamps=ts)

    args = (tr, int(ts[0]), int(ts[-1]))
    run_slice(*args)                      # warm: allocator, build, caches
    run_slice(*args, plain=True)
    trace.reset()
    k_out, st = run_slice(*args)          # the main path's counted run
    launches = {"B": trace.counter("launch.B"), "S": trace.counter("launch.S"),
                "S float": trace.counter("launch.S.float"), "Z": trace.counter("launch.Z")}
    if launches["B"] < 1 or launches["S"] < 1 or launches["Z"] != 1:
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
    kernels.update(kernel_z(card, k_out["ohlcv"]["close"], launches))
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


def kernel_z(card, close, launches):
    """Kernel Z alone on a path's closes at its threshold (0.002): CUDA-event
    time against the host loop's (the plain version: the filter on a CPU
    tensor, host clock), events equal. Returns its entry of the ``kernels``
    line, with the path's ``launches``."""
    import torch
    from finmlkit_tpu_torch.sampling import filters
    x = close.to(torch.float64).contiguous()
    h = torch.full((1,), 0.002, dtype=torch.float64, device=x.device)
    ms = cuda_ms(lambda: filters._kernel(x, h), reps=50)
    host = x.cpu()
    t0 = time.perf_counter()
    want = filters.cusum_filter(host, [0.002])
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(filters.cusum_filter(x, [0.002]).cpu(), want):
        fail("kernel Z's events differ from the host loop's")
    z_bound = bound(8 * x.shape[0] + 8 * want.shape[0] + 16, 0)  # closes in, events out
    say(f"kernel Z ({x.shape[0]:,} closes, {want.shape[0]:,} events) alone {ms:.4f} ms vs "
        f"the host loop {plain_ms:.3f} ms, bound {z_bound[0]:.5f} ms [{card}]")
    return {"Z": kernel_entry("Z", launches["Z"], 0.0, ms, plain_ms, z_bound, None)}


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
    from finmlkit_tpu_torch.testing import assert_exact
    from finmlkit_tpu_torch.utils import trace
    n_trades, price, amount, side, q, tr = (month[k] for k in
                                            ("n", "price", "amount", "side", "q", "tr"))
    thr = float((price * amount).sum()) / DOLLAR_BARS      # bench.py:784-786

    warm, _ = run_dollar(tr, thr)                  # warm: allocator, caches
    run_dollar(tr, thr, plain=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    k_out, st = run_dollar(tr, thr)                # the path's counted run
    launches = {"B": trace.counter("launch.B"), "S": trace.counter("launch.S"),
                "S float": trace.counter("launch.S.float"),
                "C": trace.counter("launch.C")}
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
    """The CUSUM bars' sigma (``testing.cusum_sigma`` at 2e-5, bench.py:861)."""
    from finmlkit_tpu_torch.testing import cusum_sigma
    return cusum_sigma(n, CUSUM_SIGMA, seed)


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
    from finmlkit_tpu_torch.ops import event_scan
    from finmlkit_tpu_torch.testing import assert_exact
    from finmlkit_tpu_torch.utils import trace
    n = month["n"]
    month["sigma"] = info_sigma(n)

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def counters():
        return {"B": trace.counter("launch.B"), "S": trace.counter("launch.S"),
                "S float": trace.counter("launch.S.float"),
                "C": trace.counter("launch.C"), "F": trace.counter("launch.F.ffill"),
                **{f"E {scan}": trace.counter("launch.E." + event_scan.MODE_NAMES[mode])
                   + (trace.counter("launch.E.imbalance_map") if mode == event_scan._IMBALANCE else 0)
                   + (trace.counter("launch.E.run_count") if mode == event_scan._RUN else 0)
                   for scan, mode in E_MODES.items()}}

    kits = info_kits(month)
    run_info(kits, event)                      # warm: allocator, caches
    del kits
    kits = info_kits(month)                    # host quantization, copies
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    k_out, k_st = run_info(kits, event)        # the path's counted run
    launches = counters()
    imb_paths = {"map": trace.counter("launch.E.imbalance_map"), "walk": trace.counter("launch.E.imbalance")}
    run_paths = {"count": trace.counter("launch.E.run_count"), "walk": trace.counter("launch.E.run")}
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
    if run_paths["count"] < 1 or run_paths["walk"] != 0:
        fail(f"the tick run bars did not take kernel E's count search: "
             f"launches by path {run_paths}")
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
        f"{imb_paths}, E run by path {run_paths}); kernel path == plain path "
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
    kernels["E run"]["launches_by_mode"] = run_paths
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
    same closes beside it. The run scan takes the count search (no chunks:
    its stats are the table chunks its rings requested, the entries read
    past the rings, the closes at the trade after the last and the walker's
    nanoseconds, from which its time a close);
    the walk, forced, is timed beside it in turns, count, walk, walk, count.
    Returns one ``kernels`` entry a scan, with the walk's counts: 256-trade
    segments skipped and scanned, pass-2 chunks that did not merge, chunks
    fixed up."""
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
        "run": (es.info_scan_plain, (w, *run, n, True),
                {"count": es._RUN_COUNT, "walk": es._RUN}, 1,
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
            for c in E_CHUNKS if mode != es._RUN_COUNT else ():
                st = torch.zeros(4, dtype=torch.int64, device=dev)
                assert_exact(scan(c, st), got, f"E {name} {path}: {c} chunks against {chunks}")
                sweep[str(c)] = [cuda_ms(lambda: scan(c), reps=3), *st.tolist()]
            same = got.shape == want.shape and bool((got == want).all())
            if not same and (name != "cusum" or not cusum_may_differ):
                fail(f"E {name} alone ({path}): {len(got)} closes differ from the "
                     f"plain version's {len(want)}")
            runs[path] = (got, ms, chunks, stats.tolist(), sweep)
        got, ms, chunks, (skipped, scanned, unmerged, fixed), sweep = runs[next(iter(modes))]
        extra = {}
        if name == "run":
            count_stats = runs["count"][3]
            w_ms, w_chunks, (skipped, scanned, unmerged, fixed), w_sweep = runs["walk"][1:]
            turns = {"count": [], "walk": []}
            for path in ("count", "walk", "walk", "count"):
                turns[path].append(cuda_ms(lambda: es._launch(modes[path], n, start, n, dev,
                                                               **kw), reps=3))
            us_close = count_stats[3] / 1e3 / max(len(got), 1)
            extra = dict(path="count", walk_ms=w_ms, walk_chunks=w_chunks,
                         walk_by_chunks=w_sweep, count_chunks_requested=count_stats[0],
                         count_misses=count_stats[1], count_next=count_stats[2],
                         count_walker_ms=count_stats[3] / 1e6, count_us_per_close=us_close,
                         turns_ms=turns)
            say(f"kernel E run, the count search: {ms:.3f} ms, its walker "
                f"{count_stats[3] / 1e6:.3f} ms over {len(got):,} closes = {us_close:.3f} "
                f"us a close ({count_stats[0]:,} table chunks requested, {count_stats[1]} "
                f"entries read past the rings, {count_stats[2]} closes at the next trade); "
                f"the walk forced {w_ms:.3f} ms, the same closes; in turns count "
                f"{turns['count']} ms, walk {turns['walk']} ms [{card}]")
        # some 10 operations a trade; 8 bytes a close written
        e_bound = bound(nbytes * n + 8 * counts[name], 10 * n)
        m = min(len(got), len(want))    # the error: closes that differ
        err = float(int((got[:m] != want[:m]).sum()) + abs(len(got) - len(want)))
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
                else "the count search (the walk's counts below)" if name == "run"
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
    from finmlkit_tpu_torch.utils import trace
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
        return {"B": trace.counter("launch.B"), "S": trace.counter("launch.S"),
                "S float": trace.counter("launch.S.float"), "C": trace.counter("launch.C"),
                "F": trace.counter("launch.F"), "H": trace.counter("launch.H"), "V": trace.counter("launch.V")}

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
    trace.reset()
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
    trace.reset()
    got = {"P1": fs.bar_scan_io_floor(*streams),
           **{f"P2 k={k}": fs.bar_scan_io_floor_k(streams[0], k) for k in IO_FLOOR_K},
           "P3": fs.bar_scan_io_floor_stacked(stack)}
    floor_launches = {"P": trace.counter("launch.P")}
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
    from finmlkit_tpu_torch.utils import trace
    b = month_bars(month)
    n_bars = b["close"].shape[0]
    calls = feature_calls(b)
    for f in calls.values():               # warm: allocator, tables, the build
        f()
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    got = {name: f() for name, f in calls.items()}     # the path's counted run
    torch.cuda.synchronize()
    launches = {"R": trace.counter("launch.R"), "W": trace.counter("launch.W")}
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
    from finmlkit_tpu_torch.feature.kernels import VolumePro, volume
    from finmlkit_tpu_torch.testing import assert_close, assert_exact
    from finmlkit_tpu_torch.utils import trace
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
    trace.reset()
    got4, got4f, got4g, got_all, dollar, fp, prof = path()   # the path's counted run
    torch.cuda.synchronize()
    launches = {"B": trace.counter("launch.B"), "S": trace.counter("launch.S"),
                "S float": trace.counter("launch.S.float"), "C": trace.counter("launch.C"),
                "R": trace.counter("launch.R"), "W": trace.counter("launch.W"), "G": trace.counter("launch.G")}
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


# phase 11: the chain (examples/quickstart.py's flow) on the month
CHAIN_CUSUM = 0.002            # cusum_filter's threshold on the closes (as phase 5's)
CHAIN_BARRIER_MIN = 30         # the vertical barrier, minutes
CHAIN_TARGET = "close_ret1_rv30"   # config 4's realized volatility 30
CHAIN_INTERCEPT = 0.5          # the time decay's last weight
Z_WINDOW, Z_THRESHOLD = 50, 3.0
Z_TIE = 1e-9                   # z-scores this close (relative) to the threshold may flip
CHAIN_STAGES = ("bars", "dispatch", "drain", "cusum", "labels", "weights", "final",
                "zscore")


def chain_trades(month):
    """The month as a ``TradesData`` from raw trades (ids 0..n-1, the sides as
    ``is_buyer_maker``), preprocessed on the host; returns it and its host
    seconds."""
    from finmlkit_tpu_torch.bar import TradesData
    t0 = time.perf_counter()
    td = TradesData(month["ts"], month["price"], month["amount"],
                    np.arange(month["n"], dtype=np.int64),
                    is_buyer_maker=month["side"] < 0, preprocess=True)
    return td, time.perf_counter() - t0


def chain_graph():
    """Config 4's kit and its planned graph over the pipeline's bar columns."""
    from finmlkit_tpu_torch.feature import fuse
    kit4, _ = config4_kit()
    topo = {str(f.name): f for f in kit4.features}
    cols = dict.fromkeys(("open", "high", "low", "close", "volume", "vwap", "trades"))
    return kit4, fuse.build_fused_from_specs([topo[n] for n in kit4.topological_order()],
                                             cols, "timestamp")


def run_chain(trades, graph, device="cuda", plain=False):
    """The chain on ``trades`` (a ``TradesData``): 1-minute time bars through
    the kit, bars -> medians -> config 4's features through the pipeline,
    CUSUM events on the closes, ``TBMLabel`` at the events over every trade,
    the info weights and the final weights, the z-score filter on the closes'
    log returns. Returns outputs and stage times (ms, CUDA events; wall time
    on the CPU)."""
    import datetime
    import torch
    from finmlkit_tpu_torch import pipeline
    from finmlkit_tpu_torch.bar import TimeBarKit
    from finmlkit_tpu_torch.label import SampleWeights, TBMLabel
    from finmlkit_tpu_torch.ops import prefix_scan
    from finmlkit_tpu_torch.sampling import cusum_filter, z_score_peak_filter
    cumsum = prefix_scan.fast_cumsum_plain if plain else prefix_scan.fast_cumsum
    on_card = torch.device(device).type == "cuda"
    marks = []

    def mark():
        if on_card:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append(e)
        else:
            marks.append(time.perf_counter())

    mark()
    kit = TimeBarKit(trades, datetime.timedelta(minutes=1), device=device, plain=plain)
    bar_ts = kit.bar_close_timestamps
    ci, tr = kit._ci, kit.trades
    mark()
    handles = pipeline.bar_feature_dispatch(
        tr.ticks, tr.units, ci, tr.sides, tick_size=tr.tick_size,
        amount_scale=tr.amount_scale, graph=graph, bar_ts=bar_ts,
        amounts_f32=tr.amounts, plain=plain)
    mark()
    ohlcv, direc, feats = pipeline.bar_feature_drain(handles)
    mark()
    close = torch.from_numpy(ohlcv["close"]).to(device)
    # kernel Z, or on the plain path the host loop on the closes read back
    events = (cusum_filter(close.cpu(), [CHAIN_CUSUM]).to(device) if plain
              else cusum_filter(close, [CHAIN_CUSUM]))
    frame = {"timestamp": bar_ts[events], "close": close[events],
             **{k: torch.from_numpy(v).to(device)[events] for k, v in feats.items()}}
    mark()
    label_kit = TBMLabel(frame, target_ret_col=CHAIN_TARGET, min_ret=0.0,
                         horizontal_barriers=(1.0, 1.0),
                         vertical_barrier=datetime.timedelta(minutes=CHAIN_BARRIER_MIN))
    used, out = label_kit.compute_labels(trades)
    mark()
    info = label_kit.compute_weights(trades, cumsum=cumsum)
    mark()
    final = SampleWeights.compute_final_weights(
        info["avg_uniqueness"], CHAIN_INTERCEPT,
        return_attribution=info["return_attribution"],
        vertical_touch_weights=out["vertical_touch_weights"], labels=out["labels"],
        cumsum=cumsum)
    mark()
    z = z_score_peak_filter(log_return(close)[1:], Z_WINDOW, Z_THRESHOLD, cumsum=cumsum)
    mark()
    if on_card:
        torch.cuda.synchronize()
        times = [marks[i].elapsed_time(marks[i + 1]) for i in range(len(marks) - 1)]
        total = marks[0].elapsed_time(marks[-1])
    else:
        times = [(marks[i + 1] - marks[i]) * 1e3 for i in range(len(marks) - 1)]
        total = (marks[-1] - marks[0]) * 1e3
    stages = dict(zip(CHAIN_STAGES, times), total=total)
    return dict(kit=kit, ohlcv=ohlcv, directional=direc, features=feats, events=events,
                used=used, out=out, info=info, final=final, z=z), stages


def z_ties(ret, window=Z_WINDOW, threshold=Z_THRESHOLD, rel=Z_TIE):
    """Indices of ``ret`` (float64 numpy) whose z-score over the ``window``
    values before them lies within ``rel`` of the threshold."""
    from numpy.lib.stride_tricks import sliding_window_view
    win = sliding_window_view(ret[:-1], window)
    mean, std = win.mean(axis=1), win.std(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.abs(ret[window:] - mean) / std
    return set((np.flatnonzero(np.abs(z - threshold) <= rel * threshold) + window).tolist())


def check_chain(k, p, trades):
    """The chain's kernel path ``k`` against its plain path ``p`` (run_chain
    outputs). Returns (largest window-close deviation, z-score ties)."""
    import torch
    from finmlkit_tpu_torch.label.weights import return_attribution
    from finmlkit_tpu_torch.ops import prefix_scan
    from finmlkit_tpu_torch.testing import assert_exact, assert_window_close
    for part in ("ohlcv", "directional", "features"):
        for key in p[part]:
            assert_exact(k[part][key], p[part][key], f"chain {part}.{key}")
    assert_exact(k["events"], p["events"], "chain events")
    for key in ("timestamp", "touch_time", "event_idx", "touch_idx", "labels"):
        assert_exact(k["out"][key], p["out"][key], f"chain {key}")
    log_scale = float(np.abs(np.log(trades.data["price"])).max())
    assert_window_close(k["out"]["returns"], p["out"]["returns"], log_scale, 1e-12,
                        "chain returns")
    # uniqueness: a window sum of 1 / concurrency; attribution: of log returns
    # over concurrency; the final weights carry the attribution's at its scale
    t = trades.tensors(p["out"]["event_idx"].device)
    ev, touch = p["out"]["event_idx"], p["out"]["touch_idx"]
    n = t["price"].shape[0]
    conc = torch.zeros(n + 1, dtype=torch.float64, device=ev.device)
    conc.index_add_(0, ev, torch.ones_like(ev, dtype=torch.float64))
    conc.index_add_(0, touch + 1, -torch.ones_like(ev, dtype=torch.float64))
    conc = torch.cumsum(conc, 0)[:-1]
    inv_scale = float(torch.where(conc > 0, 1.0 / conc.clamp(min=1), 0.0).sum())
    lr = torch.log(t["price"][1:] / t["price"][:-1]) / conc[1:].clamp(min=1)
    lr = torch.where(conc[1:] > 0, lr, 0.0)
    lr_scale = float(torch.cumsum(lr, 0).abs().max())
    worst = max(
        assert_window_close(k["info"]["avg_uniqueness"], p["info"]["avg_uniqueness"],
                            inv_scale, 1e-12, "chain uniqueness"),
        assert_window_close(k["info"]["return_attribution"],
                            p["info"]["return_attribution"], lr_scale, 1e-12,
                            "chain attribution"))
    raw = p["info"]["return_attribution"]
    ra_scale = lr_scale * raw.shape[0] / float(raw.sum())
    ra, w = p["final"]["return_attribution"], p["final"]["weights"]
    w_scale = float((w / ra)[ra > 0].max()) * ra_scale
    worst = max(worst, assert_window_close(k["final"]["weights"], w, w_scale, 1e-12,
                                           "chain final weights"),
                assert_window_close(k["final"]["time_decay_weights"],
                                    p["final"]["time_decay_weights"], 1.0, 1e-12,
                                    "chain time decay"))
    ret = np.log(p["ohlcv"]["close"][1:] / p["ohlcv"]["close"][:-1])
    ties = z_ties(ret)
    zk, zp = set(k["z"].tolist()), set(p["z"].tolist())
    if (zk ^ zp) - ties:
        fail(f"z-score events differ outside the ties: {sorted((zk ^ zp) - ties)[:10]}")
    return worst, ties


def phase_chain(card, month, need):
    """Phase 11: the chain on the month, through the kernels and the plain
    versions. Returns the path's launches and the ``kernels`` entries of
    those of ``need`` that no earlier phase timed."""
    import torch
    from finmlkit_tpu_torch.testing import assert_exact
    from finmlkit_tpu_torch.utils import trace
    t_phase = time.perf_counter()
    trades, td_s = chain_trades(month)
    d = trades.data
    for key, want in (("timestamp", month["ts"]), ("price", month["price"]),
                      ("amount", month["amount"]), ("side", month["side"])):
        assert_exact(d[key], want, f"TradesData {key}")
    say(f"chain: TradesData of {month['n']:,} trades (ids, sort, gap scan, split merge, "
        f"sides) in {td_s:.2f} s on the host; equal to the input columns "
        f"(missing {trades.missing_pct}%, data_ok {trades.data_ok}) [{card}]")
    kit4, graph = chain_graph()

    run_chain(trades, graph)                      # warm: allocator, tables, tensors
    run_chain(trades, graph, plain=True)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    k_out, k_st = run_chain(trades, graph)        # the path's counted run
    torch.cuda.synchronize()
    launches = {"B": trace.counter("launch.B"), "S": trace.counter("launch.S"),
                "S float": trace.counter("launch.S.float"), "R": trace.counter("launch.R"),
                "Z": trace.counter("launch.Z")}
    peak_gib = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    if min(launches[x] for x in ("B", "S", "R")) < 1 or launches["Z"] != 1:
        fail(f"a kernel of the chain did not launch: {launches}")
    p_out, p_st = run_chain(trades, graph, plain=True)
    k2, k_st2 = run_chain(trades, graph)
    stages = {False: [k_st, k_st2], True: [p_st]}

    # --- the pipeline against the kit, and its features against the kit's ---
    kit = k_out["kit"]
    o, dr = kit.build_ohlcv(), kit.build_directional_features()
    for key in k_out["ohlcv"]:
        assert_exact(k_out["ohlcv"][key], o[key], f"pipeline ohlcv.{key} vs the kit")
    for key in k_out["directional"]:
        assert_exact(k_out["directional"][key], dr[key],
                     f"pipeline directional.{key} vs the kit")
    frame = {c: o[c] for c in ("open", "high", "low", "close", "vwap", "trades")}
    frame.update(volume=o["volume"].to(torch.float64), timestamp=o["timestamp"])
    want = kit4.build(frame, order="topo")
    for key, v in k_out["features"].items():
        assert_exact(v, want[key], f"pipeline feature {key} vs the kit's build")
    # --- kernel path against plain path, and the final weights run to run ---
    worst, ties = check_chain(k_out, p_out, trades)
    for key in k_out["final"]:
        assert_exact(k2["final"][key], k_out["final"][key], f"final {key} run to run")
    n_ev, used = len(k_out["events"]), k_out["out"]["labels"].shape[0]
    lab = k_out["out"]["labels"]
    counts = {int(v): int((lab == v).sum()) for v in (-1, 0, 1)}
    w = k_out["final"]["weights"]
    if used == 0 or not bool(torch.isfinite(w).all()) or abs(float(w.mean()) - 1.0) > 0.5:
        fail(f"chain weights: {used} events, mean {float(w.mean())}")
    say(f"chain: {kit.bar_close_indices.shape[0]:,} bars, {n_ev:,} CUSUM events, {used:,} "
        f"labelled ({counts}), z-score events {len(k_out['z']):,} ({len(ties)} within "
        f"{Z_TIE:g} of the threshold); launches {launches}; kernel path == plain path "
        f"(bars, features, events, indices, labels exact; weights max deviation "
        f"{worst:.3g}; final weights equal run to run); pipeline == kit, features == "
        f"config 4's kit [{card}]")
    for plain in (True, False):
        stages[plain].append(run_chain(trades, graph, plain=plain)[1])
    med = {p: {key: float(np.median([r[key] for r in stages[p]])) for key in k_st}
           for p in (False, True)}
    say("chain stage ms, median (kernel | plain): " + ", ".join(
        f"{key} {med[False][key]:.2f} | {med[True][key]:.2f}" for key in k_st)
        + f"; TradesData {td_s * 1e3:.0f} ms on the host; the chain end to end "
        f"{med[False]['total'] + td_s * 1e3:.0f} ms with it; peak device memory "
        f"{peak_gib:.3f} GiB above the trades; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")

    entries = {}
    if need & {"B", "S"}:      # no earlier phase timed them: at this path's shapes
        entries.update(kernels_b_s(card, kit.trades, kit._ci, launches))
    if "R" in need:
        entries["R"] = kernel_r(card, launches["R"], kit.bar_close_indices.shape[0])
    if "Z" in need:
        entries.update(kernel_z(card, torch.from_numpy(k_out["ohlcv"]["close"]).cuda(),
                                launches))
    return launches, entries


def run_offgrid(tr, ts_first, ts_last, thr_v, thr_d, plain=False):
    """The float64 path on the float form ``tr`` of trades off every tick
    grid, through the functions the kits call: 1-minute time bars, their
    products, trade-size features (theta the bars' median trade size) and
    footprints on the 0.1 grid, then volume and dollar bars. Returns outputs
    and stage times (ms, CUDA events)."""
    import torch
    from finmlkit_tpu_torch.bar import aggregate
    from finmlkit_tpu_torch.bar.footprint_q import bar_footprints
    from finmlkit_tpu_torch.bar.indexers import (dollar_bar_indexer, time_bar_indexer,
                                                 volume_bar_indexer)
    from finmlkit_tpu_torch.ops import float_walk, prefix_scan
    cumsum = prefix_scan.fast_cumsum_plain if plain else prefix_scan.fast_cumsum
    cols = prefix_scan.fast_cumsum_cols_plain if plain else prefix_scan.fast_cumsum_cols
    vwalk = float_walk.volume_walk_plain if plain else float_walk.volume_walk
    dwalk = float_walk.dollar_walk_plain if plain else float_walk.dollar_walk
    marks = []

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append(e)

    mark()
    clock, ci = time_bar_indexer(tr.timestamps, 60.0, ts_first=ts_first, ts_last_i=ts_last)
    mark()
    ohlcv = aggregate.comp_bar_ohlcv(tr.prices, tr.amounts, ci, cumsum=cumsum)
    direc = aggregate.comp_bar_directional_features(tr.prices, tr.amounts, ci, tr.sides,
                                                    cumsum=cumsum, cumsum_cols=cols)
    mark()
    tsf = aggregate.comp_bar_trade_size_features(tr.amounts, ohlcv["median_trade_size"],
                                                 ci, 5.0, cumsum=cumsum)
    mark()
    fp = bar_footprints(None, tr.amounts, ci, tr.sides, ohlcv, tick_size=None,
                        price_tick_size=OFFGRID_TICK, prices=tr.prices, cumsum=cumsum,
                        cumsum_cols=cols)
    mark()
    _, v_ci = volume_bar_indexer(tr.timestamps, tr.amounts, thr_v, walk=vwalk)
    mark()
    _, d_ci = dollar_bar_indexer(tr.timestamps, tr.prices, tr.amounts, thr_d, walk=dwalk)
    mark()
    torch.cuda.synchronize()
    names = ("index", "products", "trade size", "footprints", "volume index",
             "dollar index")
    stages = {k: marks[i].elapsed_time(marks[i + 1]) for i, k in enumerate(names)}
    stages["total"] = marks[0].elapsed_time(marks[-1])
    out = dict(ci=ci, ohlcv=ohlcv, directional=direc, trade_size=tsf, footprints=fp,
               v_ci=v_ci, d_ci=d_ci)
    return out, stages


def run_offgrid_kits(ts, price, amount, side, thr_v, thr_d):
    """Phase 12's main path as a user drives it: ``TimeBarKit`` (60 s) with its
    four builds, ``VolumeBarKit`` and ``DollarBarKit``, on numpy columns."""
    import torch
    from finmlkit_tpu_torch.bar import DollarBarKit, TimeBarKit, VolumeBarKit
    cols = (ts, price, amount, side)
    tk = TimeBarKit(*cols, 60.0)
    o = tk.build_ohlcv()
    out = dict(ohlcv=o, directional=tk.build_directional_features(),
               trade_size=tk.build_trade_size_features(o["median_trade_size"], 5.0),
               footprints=tk.build_footprints(OFFGRID_TICK))
    vk, dk = VolumeBarKit(*cols, thr_v), DollarBarKit(*cols, thr_d)
    vk.bar_close_indices, dk.bar_close_indices          # the walks
    out.update(ci=tk._ci, v_ci=vk._ci, d_ci=dk._ci)
    torch.cuda.synchronize()
    return out


def check_offgrid_bars_numpy(out, price, amount, side, n_sample=200):
    """Sampled float64 bars against numpy on the host arrays: prices, counts,
    medians and the tick splits exact, the volume within a float32 ulp."""
    from finmlkit_tpu_torch.testing import assert_within, ulp32
    ci = out["ci"].cpu().numpy()
    o = {k: v.cpu().numpy() for k, v in out["ohlcv"].items()}
    d = {k: v.cpu().numpy() for k, v in out["directional"].items()}
    g = np.random.default_rng(12)
    nonempty = np.flatnonzero(np.diff(ci) > 0)
    for k in g.choice(nonempty, min(n_sample, len(nonempty)), replace=False):
        s, e = ci[k] + 1, ci[k + 1] + 1
        p, a = price[s:e], amount[s:e].astype(np.float64)
        want = {"open": p[0], "high": p.max(), "low": p.min(), "close": p[-1],
                "trades": e - s, "median_trade_size": np.median(a),
                "ticks_buy": int((side[s:e] == 1).sum()),
                "ticks_sell": int((side[s:e] == -1).sum())}
        for key, v in want.items():
            got = o[key][k] if key in o else d[key][k]
            if got != v:
                fail(f"off-grid bar {k} {key}: {got!r} vs numpy {v!r}")
        vol = np.float32(a.sum())
        assert_within(o["volume"][k:k + 1], np.array([vol]), ulp32(vol),
                      f"off-grid bar {k} volume")


def hold_offgrid(got, want, price, amount, what, exact=False):
    """Phase 12's outputs of two runs: close indices and footprints exact;
    the products exact (``exact``) or as ``testing.hold_float_path`` holds
    them. Returns the products' largest shares of their bounds."""
    from finmlkit_tpu_torch.testing import assert_exact, hold_float_path
    for key in ("ci", "v_ci", "d_ci"):
        assert_exact(got[key], want[key], f"{what} {key}")
    for key in want["footprints"]:
        assert_exact(got["footprints"][key], want["footprints"][key],
                     f"{what} footprints.{key}")
    shares = {}
    for part in ("ohlcv", "directional", "trade_size"):
        if exact:
            for key in want[part]:
                assert_exact(got[part][key], want[part][key], f"{what} {part}.{key}")
        else:
            shares.update(hold_float_path(got[part], want[part], price, amount,
                                          want["ohlcv"]["volume"], f"{what} {part}"))
    return shares


def kernel_d(card, tr, thr_v, thr_d, n_v, n_d, launches, need_e):
    """Kernel D alone on the month (CUDA events, 5 calls a walk, 2 on the
    block walk) against its plain loop (one call a walk, host clock), closes
    equal, on each route: the kits' walks (volume in units through kernel
    E's volume scan, dollar by the warp step); the volume walk with one dust
    trade of 2^-100, which leaves the exact-sum case, by the warp step in
    chunks; both walks with one amount negated, by the block walk. Returns
    D's ``kernels`` entry, the dollar walk's numbers first, with each walk's
    route, time and counts (``float_walk.STATS``; the volume walk's chunks,
    merges and fixed-up chunks), and E volume's where ``need_e``: E alone on
    the month's units against its plain version."""
    import torch
    from finmlkit_tpu_torch.ops import event_scan
    from finmlkit_tpu_torch.ops import float_walk as fw
    from finmlkit_tpu_torch.testing import assert_exact
    n, dev = tr.amounts.shape[0], tr.amounts.device
    dust, neg = tr.amounts.clone(), tr.amounts.clone()
    dust[n // 2] = 2.0 ** -100
    neg[n // 2] = -neg[n // 2]
    walks = {   # (mode, prices, volumes, threshold, max_bars, the route it takes)
        "volume": (fw._VOLUME, None, tr.amounts, thr_v, n_v + 2, fw.UNITS),
        "dollar": (fw._DOLLAR, tr.prices, tr.amounts, thr_d, n_d + 2, fw.WARP),
        "volume with dust": (fw._VOLUME, None, dust, thr_v, n_v + 2, fw.WARP),
        "volume with a negative": (fw._VOLUME, None, neg, thr_v, n_v + 2, fw.BLOCK),
        "dollar with a negative": (fw._DOLLAR, tr.prices, neg, thr_d, n_d + 2, fw.BLOCK)}
    routes = {fw.WARP: "the warp step", fw.BLOCK: "the block walk",
              fw.UNITS: "units, kernel E's volume scan"}
    ms, plain_ms, bounds, counts = {}, {}, {}, {}
    for name, (mode, p, v, thr, mb, route) in walks.items():
        def walk(stats=None):
            return fw._launch(mode, p, v, thr, mb, stats=stats)
        t0 = time.perf_counter()
        want = (fw.volume_walk_plain(v, thr, mb) if mode == fw._VOLUME
                else fw.dollar_walk_plain(p, v, thr, mb))
        plain_ms[name] = (time.perf_counter() - t0) * 1e3
        st = torch.zeros(len(fw.STATS), dtype=torch.int64, device=dev)
        before = fw.route_launches()
        assert_exact(walk(st), want, f"kernel D {name} alone vs plain")
        if fw.route_launches()[route] != before[route] + 1:
            fail(f"kernel D's walk of the month, {name}, did not take {routes[route]}")
        ms[name] = cuda_ms(walk, reps=2 if route == fw.BLOCK else 5)
        counts[name] = dict(zip(fw.STATS, st.tolist()), route=routes[route])
        # each trade's float32 amount (and float64 price) read once, each close
        # written once; one float64 add a trade (and a multiply for dollar)
        bounds[name] = (bound(4 * n + 8 * n_v, n, PEAK_F64_OPS_PER_S) if mode == fw._VOLUME
                        else bound(12 * n + 8 * n_d, 2 * n, PEAK_F64_OPS_PER_S))
    c = counts["volume with dust"]
    c["chunks"] = fw.chunk_bounds(n, fw._default_chunks(dev))[1]
    c["merged"] = c["chunks"] - 1 - c["unmerged"]
    for m, c in counts.items():
        say(f"kernel D alone on the month, {m}: {ms[m]:.3f} ms vs plain {plain_ms[m]:.1f} ms "
            f"(host loop), bound {bounds[m][0]:.4f} ms ({bounds[m][1]}), "
            f"{bounds[m][0] / ms[m]:.3%} of it; route: {c['route']}"
            + (f"; {c['steps']:,} steps and {c['searches']:,} searches (rounds of ballots), "
               f"{c['ties']:,} ties, {c['crossings']:,} binade crossings and closes from the "
               f"tables, {c['serial']:,} serial adds, {c['closes']:,} closes walked; walker "
               f"cycles {c['cycles']:,}, of them waiting for tiles {c['wait']:,}"
               if c["route"] == routes[fw.WARP] else "")
            + (f"; {c['chunks']} chunks, {c['merged']} merged in pass 2, {c['fixed']} fixed up"
               if "chunks" in c else "") + f" [{card}]")
    entries = {"D": kernel_entry(
        "D", launches["D"], 0.0, ms["dollar"], plain_ms["dollar"], bounds["dollar"], None,
        volume_ms=ms["volume"], volume_plain_ms=plain_ms["volume"],
        volume_bound_ms=bounds["volume"][0], warp_step_volume_ms=ms["volume with dust"],
        block_walk_ms={m: ms[f"{m} with a negative"] for m in ("volume", "dollar")},
        walk_routes={m: c["route"] for m, c in counts.items()}, counts=counts)}
    if need_e:
        u = fw.exact_unit(tr.amounts.cpu().numpy(), thr_v)
        units = (tr.amounts.to(torch.float64) * 2.0 ** -u).to(torch.int64)
        thr_u, mb = fw.units_threshold(thr_v, u), n_v + 2
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        want = event_scan.volume_scan_plain(units, thr_u, mb)
        b.record()
        b.synchronize()
        assert_exact(event_scan.volume_scan(units, thr_u, mb), want, "E volume on units")
        e_ms = cuda_ms(lambda: event_scan.volume_scan(units, thr_u, mb))
        e_bound = bound(8 * n + 8 * n_v, 10 * n)
        entries["E volume"] = kernel_entry("E volume", launches["E volume"], 0.0, e_ms,
                                           a.elapsed_time(b), e_bound, None,
                                           chunks=event_scan._default_chunks(
                                               event_scan._VOLUME, dev), units=f"2^{u}")
        say(f"kernel E volume alone on the month's amounts in units of 2^{u}: {e_ms:.3f} ms, "
            f"plain {a.elapsed_time(b):.1f} ms, bound {e_bound[0]:.3f} ms [{card}]")
    return entries


def kernels_s_c_f64(card, tr, launches, need):
    """Kernels S and C at phase 12's shapes when no earlier phase timed them:
    S on the month's float64 amounts, C on the (7, n) float64 directional
    stack; each against its plain version and ``torch.cumsum``."""
    import torch
    from finmlkit_tpu_torch.ops import prefix_scan
    from finmlkit_tpu_torch.testing import assert_close
    n = tr.amounts.shape[0]
    a = tr.amounts.to(torch.float64)
    entries = {}
    if "S" in need:
        ms = cuda_ms(lambda: prefix_scan.fast_cumsum(a))
        plain = cuda_ms(lambda: prefix_scan.fast_cumsum_plain(a))
        lib = cuda_ms(lambda: torch.cumsum(a, 0))
        err = assert_close(prefix_scan.fast_cumsum(a), prefix_scan.fast_cumsum_plain(a),
                           rtol=1e-12, what="S float64")
        entries["S"] = kernel_entry("S", launches["S"], err, ms, plain,
                                    bound(16 * n, n, PEAK_F64_OPS_PER_S), lib)
        say(f"kernel S (float64, {n:,}) {ms:.3f} ms vs plain {plain:.3f} ms, "
            f"torch.cumsum {lib:.3f} ms [{card}]")
    if "C" in need:
        x = torch.stack([a * (k + 1) for k in range(7)])
        ms = cuda_ms(lambda: prefix_scan.fast_cumsum_cols(x))
        plain = cuda_ms(lambda: prefix_scan.fast_cumsum_cols_plain(x))
        err = assert_close(prefix_scan.fast_cumsum_cols(x),
                           prefix_scan.fast_cumsum_cols_plain(x), rtol=1e-12,
                           what="C float64")
        entries["C"] = kernel_entry("C", launches["C"], err, ms, plain,
                                    bound(2 * 8 * 7 * n, 7 * n, PEAK_F64_OPS_PER_S), plain)
        say(f"kernel C (float64 (7, {n:,})) {ms:.3f} ms vs plain and torch.cumsum(x, 1) "
            f"{plain:.3f} ms [{card}]")
    return entries


def phase_offgrid(card, need):
    """Phase 12: the month with its prices left off the 0.1 grid, through the
    kits' float64 path (kernels S, C and D), against the plain path on the
    card. Returns the path's launches and the ``kernels`` entries of D and of
    those of ``need`` that no earlier phase timed."""
    import types

    import torch
    from finmlkit_tpu_torch import interop
    from finmlkit_tpu_torch.bar.quantize import quantize_trades
    from finmlkit_tpu_torch.ops import float_walk
    from finmlkit_tpu_torch.utils import trace
    t_phase = time.perf_counter()
    ts, price, amount, side = synth_trades(N_MONTH, rounded=False)
    t0 = time.perf_counter()
    if quantize_trades(price, amount) is not None:
        fail("the off-grid month quantizes")
    say(f"off-grid month: {N_MONTH:,} trades synthesized, quantize_trades gives None "
        f"({time.perf_counter() - t0:.2f} s on the host)")
    thr_v = float(amount.astype(np.float64).sum()) / VOLUME_BARS
    thr_d = float((price * amount).sum()) / DOLLAR_BARS
    tr = interop.from_floats(price, None, side, amount, "cuda", timestamps=ts)
    args = (tr, int(ts[0]), int(ts[-1]), thr_v, thr_d)

    run_offgrid(*args)                          # warm: allocator, caches
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    t0 = time.perf_counter()
    kits = run_offgrid_kits(ts, price, amount, side, thr_v, thr_d)   # the main path
    kits_s = time.perf_counter() - t0
    routes = float_walk.route_launches()
    if routes != [1, 0, 1]:
        fail(f"the kits' walks took kernel D's routes {routes} (warp step, block walk, "
             f"units), not the dollar walk by the warp step and the volume walk in units")
    launches = {"S": trace.counter("launch.S"), "S float": trace.counter("launch.S.float"),
                "C": trace.counter("launch.C"), "D": trace.counter("launch.D"),
                "E volume": trace.counter("launch.E.volume")}
    peak = torch.cuda.max_memory_allocated()
    if launches["S"] < 1 or launches["C"] < 2 or launches["D"] != 2 \
            or launches["E volume"] != 1:
        fail(f"a kernel of the off-grid path did not launch as it should: {launches}")
    k_out, st = run_offgrid(*args)
    stages = {False: [st], True: []}
    p_out, st = run_offgrid(*args, plain=True)
    stages[True].append(st)
    for plain in (True, False):
        stages[plain].append(run_offgrid(*args, plain=plain)[1])
    k_st, p_st = ({k: float(np.median([r[k] for r in stages[p]])) for k in st}
                  for p in (False, True))
    k2, _ = run_offgrid(*args)

    # --- the kits == the functions, run to run, kernel path vs plain path ---
    hold_offgrid(kits, k_out, price, amount, "kits vs path", exact=True)
    hold_offgrid(k2, k_out, price, amount, "kernel path run to run", exact=True)
    shares = hold_offgrid(k_out, p_out, price, amount, "kernel vs plain path")
    del k2, p_out, kits

    # --- the outputs are right ---
    ci = k_out["ci"]
    n_bars = ci.shape[0] - 1
    o, fp = k_out["ohlcv"], k_out["footprints"]
    for key in ("open", "high", "low", "close", "volume", "vwap", "median_trade_size"):
        if o[key].shape != (n_bars,) or not bool(torch.isfinite(o[key]).all()):
            fail(f"off-grid ohlcv[{key}] is not {n_bars} finite values")
    if not bool(((o["low"] <= o["close"]) & (o["close"] <= o["high"])).all()) \
            or int(o["trades"].sum()) != int(ci[-1] - ci[0]):
        fail("off-grid bars: close outside [low, high] or trades not covered once")
    n_v, n_d = k_out["v_ci"].shape[0] - 1, k_out["d_ci"].shape[0] - 1
    for what, nb, want in (("volume", n_v, VOLUME_BARS), ("dollar", n_d, DOLLAR_BARS)):
        if not 0.9 * want < nb <= want + 1:
            fail(f"{nb} off-grid {what} bars")
    check_offgrid_bars_numpy(k_out, price, amount, side)
    levels = types.SimpleNamespace(price_ticks=np.round(price / OFFGRID_TICK).astype(np.int64))
    cells, off = check_footprints_numpy(k_out, levels, amount, side)
    L = fp["buy_volumes"].shape[1]
    say(f"off-grid: {n_bars:,} time bars, footprints L {L} ({n_bars * L:,} cells), "
        f"{n_v:,} volume and {n_d:,} dollar bars; launches {launches}; the kits == the "
        f"path's functions and the kernel path run to run, bit for bit; kernel path vs "
        f"plain path: closes (D on the whole month) and footprints exact, products "
        f"within their bounds (largest shares: " + ", ".join(
            f"{k} {v:.2g}" for k, v in sorted(shares.items(), key=lambda kv: -kv[1])[:4])
        + f"); 200 bars == numpy, 40 bars' footprints == np.add.at ({off} of "
        f"{cells:,} volume cells differ in the last bit) [{card}]")
    say(f"off-grid stage ms, median of 2 (kernel | plain): " + ", ".join(
        f"{k} {k_st[k]:.2f} | {p_st[k]:.2f}" for k in k_st) + f"; the kits' main path "
        f"{kits_s:.2f} s with their host quantization attempts and copies; peak device "
        f"memory {(peak - base) / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB held "
        f"before it [{card}]")
    entries = kernel_d(card, tr, thr_v, thr_d, n_v, n_d, launches, "E volume" in need)
    entries.update(kernels_s_c_f64(card, tr, launches, need))
    say(f"phase 12 wall {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches, entries


# phase 13: the host-only layers: the 1-second klines, their resample, the host
# medians, and where h5py imports, the store, the klines' reader and the CLI
KLINE_TIMEFRAMES = ("1min", "1h", "1D")
KLINE_RTOL = 2.0 ** -22      # volume and vwap against the oracle (tests/test_torch_klines.py)
CLI_TRADES = 1_000_000       # the CLI's local spot-layout ZIP, by default
CLI_ROWS = 1 << 21           # rows of the ZIP's CSV made at a time
# the CLI's parse in a process of its own: its seconds, its peak resident
# memory above the process's before it (/proc/self/status: VmHWM, or where the
# kernel keeps none, the largest VmRSS a thread reads every 5 ms), a digest of
# each column, then the preprocessing of _process_task on those columns
CLI_PARSE = """
import hashlib, json, sys, threading, time
import numpy as np
from finmlkit_tpu_torch.cli import binance2h5

def kib(key):
    with open("/proc/self/status") as f:
        return next((int(ln.split()[1]) for ln in f if ln.startswith(key + ":")), None)

before, high, done = kib("VmRSS"), [0], threading.Event()

def sample():
    while not done.wait(0.005):
        high[0] = max(high[0], kib("VmRSS") or 0)

sampler = threading.Thread(target=sample)
sampler.start()
t0 = time.perf_counter()
cols = binance2h5.load_csv_from_zip(sys.argv[1])
parse_s = time.perf_counter() - t0
done.set()
sampler.join()
hwm = kib("VmHWM")
how = "VmHWM" if hwm is not None else "VmRSS sampled every 5 ms"
top = hwm if hwm is not None else max(high[0], kib("VmRSS") or 0)
peak = None if before is None else (top - before) * 1024
digest = {k: [str(c.dtype), len(c), hashlib.sha256(c.tobytes()).hexdigest()]
          for k, c in cols.items()}
t0 = time.perf_counter()
month, out, ok, missing, disc = binance2h5._preprocess(cols, sys.argv[2])
ts = out["timestamp"]
print(json.dumps({"parse_s": parse_s, "peak": peak, "how": how,
                  "bytes": sum(c.nbytes for c in cols.values()), "digest": digest,
                  "preprocess_s": time.perf_counter() - t0, "rows": len(ts),
                  "sorted": bool(np.all(ts[1:] >= ts[:-1]))}))
"""
KLINE_EXACT = ("open", "high", "low", "close", "trades", "median_trade_size")


def resample_numpy(ts, cols, f):
    """The numpy oracle of the JAX package's resample (``finmlkit_tpu/data/
    klines.py:181-207``) on host columns: groups of ``floor(ts / f) * f`` that
    start where it changes; first and last non-NaN open and close, high and
    low without NaNs, volume and trades summed, vwap ``sum(vwap * volume) /
    sum(volume)`` in float64, and each group's trade-count-weighted median of
    the seconds' medians by the JAX module's ``w_median`` (an argsort, the
    running weights, a ``searchsorted`` of half); groups with no open dropped."""
    key = (ts // f) * f
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    ends = np.r_[starts[1:], len(ts)]
    idx = np.arange(len(ts))

    def pick(x, pos, how):
        p = how.reduceat(pos, starts)
        ok = (p >= 0) & (p < len(x))
        return np.where(ok, x[np.clip(p, 0, len(x) - 1)], np.nan)

    vol = np.nan_to_num(cols["volume"].astype(np.float64))
    vol_sum = np.add.reduceat(vol, starts)
    pv = np.nan_to_num(cols["vwap"].astype(np.float64) * cols["volume"].astype(np.float64))
    sizes, counts = cols["median_trade_size"], cols["trades"]
    med = np.empty(len(starts), np.float64)
    for g, (s, e) in enumerate(zip(starts, ends)):
        order = np.argsort(sizes[s:e])
        cum = np.cumsum(counts[s:e][order].astype(np.float64))
        med[g] = np.nan if cum[-1] <= 0 else \
            sizes[s:e][order][np.searchsorted(cum, cum[-1] * 0.5, side="left")]
    out = {"timestamp": key[starts],
           "open": pick(cols["open"], np.where(np.isnan(cols["open"]), len(ts), idx),
                        np.minimum),
           "high": np.fmax.reduceat(cols["high"], starts),
           "low": np.fmin.reduceat(cols["low"], starts),
           "close": pick(cols["close"], np.where(np.isnan(cols["close"]), -1, idx),
                         np.maximum),
           "volume": vol_sum.astype(np.float32),
           "trades": np.add.reduceat(counts, starts),
           "vwap": np.divide(np.add.reduceat(pv, starts), vol_sum,
                             where=vol_sum != 0, out=np.full(len(starts), np.nan)
                             ).astype(np.float32),
           "median_trade_size": med.astype(np.float32)}
    keep = ~np.isnan(out["open"])
    return {k: v[keep] for k, v in out.items()}


def hold_resample(got, want, what):
    """A resampled frame against another (tensors or numpy): timestamps, OHLC,
    trades and the median exact, volume and vwap within ``KLINE_RTOL``.
    Returns the largest relative deviation of volume and vwap."""
    from finmlkit_tpu_torch.testing import assert_close, assert_exact
    if list(got) != list(want):
        fail(f"{what}: columns {list(got)} vs {list(want)}")
    worst = 0.0
    for k in want:
        if k == "timestamp" or k in KLINE_EXACT:
            assert_exact(got[k], want[k], f"{what} {k}")
        else:
            w = np.asarray(want[k].cpu() if hasattr(want[k], "cpu") else want[k], np.float64)
            err = assert_close(got[k], want[k], rtol=KLINE_RTOL, what=f"{what} {k}")
            worst = max(worst, err / max(float(np.abs(w).max()), 1e-300))
    return worst


def event_ms(fn, reps=3, device="cuda"):
    """Median of ``reps`` calls' CUDA-event milliseconds, after one warm call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def run_klines(tr, ts_first, ts_last, plain=False):
    """The 1-second bars as ``TimeBarKit(trades, 1.0).build_ohlcv`` builds
    them, through the functions it calls, on the card's trades ``tr``: the
    index, then the products and the sort medians (kernels B and S, or their
    plain versions). Returns the outputs and the stage times (ms, CUDA
    events)."""
    import torch
    from finmlkit_tpu_torch.bar.fused import bar_products_final, bar_scan, median_engine
    from finmlkit_tpu_torch.bar.indexers import time_bar_indexer
    marks = []

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append(e)

    mark()
    clock, ci = time_bar_indexer(tr.timestamps, 1.0, ts_first=ts_first, ts_last_i=ts_last)
    mark()
    ohlcv, direc = bar_products_final(
        tr.ticks, tr.units, ci, tr.sides, tick_size=tr.tick_size,
        amount_scale=tr.amount_scale, amounts_f32=tr.amounts,
        scan=bar_scan("rowtail", plain=plain), medians=median_engine("sort", plain=plain))
    mark()
    marks[-1].synchronize()
    stages = {"index": marks[0].elapsed_time(marks[1]),
              "products+medians": marks[1].elapsed_time(marks[2]),
              "total": marks[0].elapsed_time(marks[2])}
    return dict(clock=clock, ci=ci, ohlcv=ohlcv, directional=direc), stages


def _digits(a, pad=False):
    """Nonnegative int64 ``a`` as rows of ASCII digits, a byte each, the
    leading zeros NUL (or, where ``pad``, the digit 0)."""
    p = 10 ** np.arange(len(str(int(a.max(initial=0)))) - 1, -1, -1, dtype=np.int64)
    d = (a[:, None] // p % 10 + ord("0")).astype(np.uint8)
    if not pad:
        d[(a[:, None] < p) & (p > 1)] = 0
    return d


def _decimals(units, places):
    """Nonnegative int64 ``units`` of ``10**-places`` as the ASCII of their
    decimals, NUL-padded byte rows (``places`` 0: integers)."""
    if not places:
        return [_digits(units)]
    return [_digits(units // 10**places), np.full((len(units), 1), ord("."), np.uint8),
            _digits(units % 10**places + 10**places, pad=True)[:, 1:]]


def spot_zip(path, member, ts, price, amount, side):
    """The trades as Binance's spot files hold them (no header; id, price,
    qty, quote_qty, time in ms, is_buyer_maker, is_best_match), the CSV made
    ``CLI_ROWS`` rows at a time (each field in a fixed-width slot of one byte
    table, its NUL padding dropped) and deflated into ``member`` of the ZIP at
    ``path``. The prices lie on the 0.1 grid and the amounts on 1e-5, so the
    text is exact. Returns the columns a parse of it must give, and the CSV's
    bytes."""
    import zipfile
    ticks = np.rint(price * 10).astype(np.int64)
    units = np.rint(amount.astype(np.float64) * 1e5).astype(np.int64)
    want = {"id": np.arange(1, len(ts) + 1, dtype=np.int64), "price": ticks / 10,
            "qty": units / 1e5, "quote_qty": ticks * units / 1e6,
            "time": ts // 10**6, "is_buyer_maker": side < 0,
            "is_best_match": np.ones(len(ts), bool)}
    comma, size = np.full((1, 1), ord(","), np.uint8), 0
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED, compresslevel=1) as z, \
            z.open(member, "w", force_zip64=True) as f:
        for a in range(0, len(ts), CLI_ROWS):
            b = min(a + CLI_ROWS, len(ts))
            fields = [_decimals(want["id"][a:b], 0), _decimals(ticks[a:b], 1),
                      _decimals(units[a:b], 5), _decimals(ticks[a:b] * units[a:b], 6),
                      _decimals(want["time"][a:b], 0),
                      [np.where(side[a:b] < 0, b"True", b"False").view(np.uint8)
                       .reshape(b - a, 5)], [np.full((b - a, 4), np.frombuffer(b"True", np.uint8))]]
            parts = []
            for i, field in enumerate(fields):
                parts += field + [np.repeat(comma if i < len(fields) - 1 else
                                            np.full((1, 1), ord("\n"), np.uint8), b - a, 0)]
            text = np.concatenate(parts, axis=1).tobytes().replace(b"\0", b"")
            size += len(text)
            f.write(text)
    return want, size


def cli_parse_step(card, zpath, want, month, csv_bytes):
    """The CLI's parse of the ZIP at ``zpath`` and its preprocessing, in a
    process of its own (``CLI_PARSE``): every column equal to ``want``, bit
    for bit, the trades preprocessed sorted. Returns its host seconds."""
    import hashlib
    import os
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", CLI_PARSE, zpath, month], capture_output=True,
                         text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if run.returncode:
        fail(f"the CLI's parse exited {run.returncode}: {run.stderr[-2000:]}")
    got = json.loads(run.stdout.strip().splitlines()[-1])
    for k, v in want.items():
        if got["digest"].get(k) != [str(v.dtype), len(v), hashlib.sha256(v.tobytes()).hexdigest()]:
            fail(f"the CLI's parse: column {k} differs from the text written")
    if list(got["digest"]) != list(want):
        fail(f"the CLI's parse: columns {list(got['digest'])}")
    n = len(want["id"])
    if not got["sorted"] or not 0.9 * n <= got["rows"] <= n:
        fail(f"the CLI's preprocessing kept {got['rows']:,} of {n:,} trades")
    say(f"CLI parse: {n:,} trades in a spot-layout ZIP ({os.path.getsize(zpath) / 1e6:.1f} MB, "
        f"CSV {csv_bytes / 1e6:.1f} MB), every column == the text written, bit for bit; "
        f"load_csv_from_zip {got['parse_s']:.2f} s, peak resident "
        + ("not measured" if got["peak"] is None else f"{got['peak'] / 1e6:.1f} MB")
        + f" above the process's before it ({got['how']}; columns "
        f"{got['bytes'] / 1e6:.1f} MB); preprocessing {got['preprocess_s']:.2f} s, "
        f"{got['rows']:,} trades after the split-trade merge; process wall {wall:.2f} s "
        f"(host clock) [{card}]")
    return {"cli parse": got["parse_s"], "cli preprocess": got["preprocess_s"]}


def store_steps(card, trades, klines_1s, workdir, zpath, n, device="cuda"):
    """Phase 13's store steps (where h5py imports), in ``workdir``: the month
    saved as its store months and loaded back equal, ``H5Inspector.
    inspect_gaps``, ``AddTimeBarH5`` over every month (its bars equal to the
    month's own build but at the months' edges), a ``TimeBarReader.read``
    across the month boundary against ``resample`` of the 1-second read, and
    the CLI offline on the local spot-layout ZIP at ``zpath`` (in a folder
    of its own, of the month's first ``n`` trades). Returns the host seconds
    of each step."""
    import os

    from finmlkit_tpu_torch.bar.data_model import TradesData
    from finmlkit_tpu_torch.cli import binance2h5
    from finmlkit_tpu_torch.data import klines, store
    from finmlkit_tpu_torch.testing import assert_exact
    secs = {}
    cols = trades.data
    ts = cols["timestamp"]
    path = os.path.join(workdir, "month.h5")
    t0 = time.perf_counter()
    first, last = (np.datetime64(store.month_key_of(t), "M") for t in (ts[0], ts[-1]))
    bounds = [store.month_bounds(str(m)) for m in np.arange(first, last + 1)]
    for lo, hi in bounds:
        a, b = np.searchsorted(ts, [lo, hi])
        TradesData(ts[a:b], cols["price"][a:b], cols["amount"][a:b], side=cols["side"][a:b],
                   timestamp_unit="ns").save_h5(path)
    secs["save"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = store.load_trades_h5(path, enable_multiprocessing=True)
    secs["load"] = time.perf_counter() - t0
    for k in cols:
        assert_exact(back.data[k], cols[k], f"store round trip {k}")
    t0 = time.perf_counter()
    gaps = store.H5Inspector(path).inspect_gaps()
    secs["inspect_gaps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    done = klines.AddTimeBarH5(path, device=device).process_all()
    secs["klines"] = time.perf_counter() - t0
    if not all(done.values()) or len(done) != len(bounds):
        fail(f"AddTimeBarH5 over the months: {done}")
    reader = klines.TimeBarReader(path, device=device)
    stored = {k: v.cpu().numpy() for k, v in reader.read().items()}
    whole = {k: v.cpu().numpy() for k, v in klines_1s.items()}
    # a month's bars are the month's own build: equal to the whole month's at
    # each second both have, but the first of each month, whose trades before
    # it lie in the month before
    _, i, j = np.intersect1d(stored["timestamp"], whole["timestamp"], return_indices=True)
    firsts = np.searchsorted(stored["timestamp"], [lo for lo, _ in bounds])
    keep = ~np.isin(i, firsts)
    if keep.sum() < 0.99 * len(whole["timestamp"]):
        fail(f"{keep.sum():,} stored 1-second bars of {len(whole['timestamp']):,} to compare")
    for k in klines.KLINE_COLS:
        assert_exact(stored[k][i[keep]], whole[k][j[keep]], f"stored klines {k}")
    edge = bounds[0][1]
    t0 = time.perf_counter()
    window = (edge - 3600 * 10**9, edge + 3600 * 10**9 - 1)     # the two hours around it
    got = reader.read(*window, "1min")
    secs["read"] = time.perf_counter() - t0
    sec = reader.read(*window)
    hold_resample(got, klines.resample(sec, "1min"), "the read across the month boundary")
    minutes = np.unique(sec["timestamp"].cpu().numpy() // (60 * 10**9))
    if got["timestamp"].shape[0] != len(minutes) or not 100 < len(minutes) <= 120:
        fail(f"the read across the month boundary gave {got['timestamp'].shape[0]} minutes")
    # the CLI, offline, on the local spot-layout ZIP at zpath
    out_dir, month = os.path.dirname(zpath), store.month_key_of(ts[0])
    t0 = time.perf_counter()
    binance2h5.orchestrate_symbol("SYNTH", [month], "spot", out_dir, 2, False, device=device)
    secs["cli"] = time.perf_counter() - t0
    got = store.load_trades_h5(os.path.join(out_dir, "SYNTH.h5"))
    if len(got.data["timestamp"]) > n or len(got.data["timestamp"]) < 0.9 * n:
        fail(f"the CLI stored {len(got.data['timestamp']):,} of {n:,} trades")
    cli_bars = klines.TimeBarReader(os.path.join(out_dir, "SYNTH.h5"), device=device).read(
        timeframe="1h")
    say(f"store: {len(bounds)} months saved and loaded back equal, {len(gaps['month'])} gaps "
        f"over a minute, {sum(done.values())} months of klines ({len(stored['timestamp']):,} "
        f"bars, {keep.sum():,} equal to the month's build), the read across the month "
        f"boundary == resample of its seconds ({len(minutes)} minutes); the CLI offline: "
        f"{len(got.data['timestamp']):,} of {n:,} trades stored after the split-trade merge, "
        f"{cli_bars['timestamp'].shape[0]} hours of klines; host s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()) + f" [{card}]")
    return secs


def phase_klines(card, need, cli_trades=CLI_TRADES):
    """Phase 13: the month's 1-second klines through the kernels (B, S) and the
    plain versions, their resample to ``KLINE_TIMEFRAMES`` against its plain
    version and the numpy oracle, ``medians="host"`` against ``"sort"`` on
    the 1-minute bars, the CLI's parse of a spot-layout ZIP of the month's
    first ``cli_trades`` trades, and the store's steps where h5py imports. Returns the
    path's launches and the ``kernels`` entries of those of ``need`` that no
    earlier phase timed."""
    import os
    import shutil
    import types

    import torch
    from finmlkit_tpu_torch import native
    from finmlkit_tpu_torch.bar import TimeBarKit, TradesData
    from finmlkit_tpu_torch.bar.fused import bar_products_final, median_engine
    from finmlkit_tpu_torch.bar.indexers import time_bar_indexer
    from finmlkit_tpu_torch.data import klines
    from finmlkit_tpu_torch.testing import assert_exact
    from finmlkit_tpu_torch.utils import trace
    t_phase = time.perf_counter()
    ts, price, amount, side = synth_trades(N_MONTH)
    trades = TradesData(ts, price, amount, side=side, timestamp_unit="ns")

    # --- the main path: the 1-second klines (a kit) and their resamples ---
    klines.resample(klines.build_klines(trades), "1min")     # warm: allocator, caches
    torch.cuda.synchronize()
    trace.reset()
    t0 = time.perf_counter()
    bars = klines.build_klines(trades)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    frames = {tf: klines.resample(bars, tf) for tf in KLINE_TIMEFRAMES}
    torch.cuda.synchronize()
    launches = {"B": trace.counter("launch.B"), "S": trace.counter("launch.S"),
                "S float": trace.counter("launch.S.float")}
    if launches["B"] != 1 or launches["S"] != 1 + 2 * len(KLINE_TIMEFRAMES):
        fail(f"the klines path did not launch B once and S {1 + 2 * len(KLINE_TIMEFRAMES)} "
             f"times: {launches}")

    # --- step 1: the klines through the kernels and the plain versions ---
    kit = TimeBarKit(trades, 1.0)
    tr, args = kit.trades, (kit.trades, int(ts[0]), int(ts[-1]))
    k_out, st = run_klines(*args)
    stages = {False: [st], True: []}
    p_out, st = run_klines(*args, plain=True)
    stages[True].append(st)
    for plain in (True, False):
        stages[plain].append(run_klines(*args, plain=plain)[1])
    k_st, p_st = ({k: float(np.median([r[k] for r in stages[p]])) for k in st}
                  for p in (False, True))
    for key in ("clock", "ci"):
        assert_exact(k_out[key], p_out[key], f"klines {key}")
    for part in ("ohlcv", "directional"):
        for key in k_out[part]:
            assert_exact(k_out[part][key], p_out[part][key], f"klines {part}.{key}")
    assert_exact(bars["timestamp"], k_out["clock"][1:], "the kit's klines timestamps")
    for key in klines.KLINE_COLS:
        assert_exact(bars[key], k_out["ohlcv"][key], f"the kit's klines {key}")
    ci, n_bars = k_out["ci"], k_out["ci"].shape[0] - 1
    if int(ci[0]) != -1 or int(ci[-1]) != N_MONTH - 1 \
            or int(bars["trades"].sum()) != N_MONTH:
        fail("the klines do not cover every trade once")
    q = types.SimpleNamespace(price_ticks=tr.ticks.cpu().numpy(), tick_size=tr.tick_size,
                              amount_units=tr.units.cpu().numpy(),
                              amount_scale=tr.amount_scale)
    check_bars_numpy(k_out, ts, q, amount, side)
    n_empty = int((bars["trades"] == 0).sum())
    p_build_s = time.perf_counter()
    klines.build_klines(trades, plain=True)
    torch.cuda.synchronize()
    p_build_s = time.perf_counter() - p_build_s
    say(f"klines: {n_bars:,} 1-second bars of the month ({n_empty:,} empty), launches "
        f"{launches}; the kit == its functions, kernel path == plain path, exact; 200 bars "
        f"== numpy. build_klines {build_s:.2f} s (plain {p_build_s:.2f} s) of host wall, "
        f"with the kit's host quantization and copy; stage ms, median of 2 (kernel | "
        f"plain): " + ", ".join(f"{k} {k_st[k]:.2f} | {p_st[k]:.2f}" for k in k_st)
        + f" [{card}]")

    # --- step 2: the resample, kernel path | plain path | numpy oracle ---
    host = {k: v.cpu().numpy() for k, v in bars.items()}
    for tf in KLINE_TIMEFRAMES:
        f = klines.parse_timeframe(tf)
        plain = klines.resample(bars, tf, plain=True)
        for k, v in plain.items():
            assert_exact(frames[tf][k], v, f"resample {tf} {k} kernel vs plain")
        t0 = time.perf_counter()
        oracle = resample_numpy(host["timestamp"], host, f)
        oracle_s = time.perf_counter() - t0
        worst = hold_resample(frames[tf], oracle, f"resample {tf} vs numpy")
        ms = event_ms(lambda: klines.resample(bars, tf))
        p_ms = event_ms(lambda: klines.resample(bars, tf, plain=True))
        say(f"resample {tf}: {frames[tf]['timestamp'].shape[0]:,} rows; kernel path == "
            f"plain path exact, == numpy oracle (OHLC, trades, median exact; volume and "
            f"vwap within {worst:.3g} of their largest value); {ms:.3f} ms vs plain "
            f"{p_ms:.3f} ms (CUDA events, median of 3), numpy {oracle_s:.2f} s [{card}]")

    # --- step 3: medians="host" against "sort" on the 1-minute bars ---
    _, ci60 = time_bar_indexer(tr.timestamps, 60.0, ts_first=int(ts[0]),
                               ts_last_i=int(ts[-1]))
    full = (ci60[1:] - ci60[:-1]) > 0
    pairs = {m: median_engine(m)(tr.amounts, ci60) for m in ("host", "sort")}
    for i in (0, 1):
        assert_exact(pairs["host"][i][full], pairs["sort"][i][full], f"host median pair {i}")
    prod = {m: bar_products_final(tr.ticks, tr.units, ci60, tr.sides,
                                  tick_size=tr.tick_size, amount_scale=tr.amount_scale,
                                  amounts_f32=tr.amounts, medians=m) for m in ("host", "sort")}
    for part in (0, 1):
        for k, v in prod["sort"][part].items():
            assert_exact(prod["host"][part][k], v, f"medians host vs sort {k}")
    host_kit = TimeBarKit(trades, 60.0, medians="host").build_ohlcv()
    for k, v in prod["sort"][0].items():
        if k in host_kit:
            assert_exact(host_kit[k], v, f"the kit with medians='host' {k}")
    times = {m: event_ms(lambda m=m: median_engine(m)(tr.amounts, ci60))
             for m in ("host", "sort")}
    amounts_h, ci_h = tr.amounts.cpu().numpy(), ci60.cpu().numpy()
    copy_ms = event_ms(lambda: (tr.amounts.cpu(), ci60.cpu()))
    select = []
    for _ in range(3):
        t0 = time.perf_counter()
        native.seg_median_pair(amounts_h, ci_h)
        select.append((time.perf_counter() - t0) * 1e3)
    say(f"medians: host == sort on {int(full.sum()):,} non-empty 1-minute bars, bit for bit "
        f"(pairs, finals, the kit); host {times['host']:.2f} ms ({native.THREADS} threads of "
        f"{os.cpu_count()} cores; of it the copies to the host {copy_ms:.2f} ms and "
        f"nth_element {float(np.median(select)):.2f} ms, host clock) vs sort "
        f"{times['sort']:.2f} ms (CUDA events, median of 3) [{card}]")

    # --- step 4: the CLI's parse of a spot-layout ZIP of the month's first trades ---
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_store")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(os.path.join(workdir, "cli"))
    try:
        n = min(cli_trades, N_MONTH)
        month = str(np.datetime64(int(ts[0]), "ns").astype("datetime64[M]"))
        zpath = os.path.join(workdir, "cli", f"SYNTH-trades-{month}.zip")
        t0 = time.perf_counter()
        want, csv_bytes = spot_zip(zpath, f"SYNTH-trades-{month}.csv", ts[:n], price[:n],
                                   amount[:n], side[:n])
        say(f"CLI ZIP: {n:,} trades written in {time.perf_counter() - t0:.2f} s (host clock)")
        cli_parse_step(card, zpath, want, month, csv_bytes)
        del want

        # --- step 5: the store, the klines' reader and the CLI, where h5py imports ---
        try:
            import h5py  # noqa: F401
        except ImportError as e:
            say(f"h5py does not import here ({e}): the store, AddTimeBarH5, TimeBarReader "
                f"and the CLI's writer are not driven on this host")
        else:
            store_steps(card, trades, bars, workdir, zpath, n)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    entries = {}
    if need & {"B", "S"}:      # no earlier phase timed them: at the klines' shapes
        entries.update(kernels_b_s(card, tr, ci, launches))
    say(f"phase 13 wall {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches, entries



# phase 14: the time-sharded layer (finmlkit_tpu_torch/parallel)
MESH_RANKS = 4               # gloo ranks sharing the card
MESH_FP_DAYS = 7             # the footprints' leading days (the month's grid: see PERF.md)
MESH_SPEC = dict(n=N_MONTH, seed=0, sigma=CUSUM_SIGMA, volume_bars=VOLUME_BARS,
                 dollar_bars=DOLLAR_BARS, interval=60.0, ticks=INFO_TICKS,
                 floor=CUSUM_FLOOR, mult=CUSUM_MULT, theta=IMB_THETA, run=RUN_EMA,
                 barrier_s=1800.0, fp_days=MESH_FP_DAYS, profile_window=PROFILE_WINDOW,
                 stage=True)
ENTRY_N = 2048 * 200 + 17    # kernel E's adversarial entry states: 132 chunks of tiles
WALK_ENTRY_N = 1_000_000     # kernel D's streams for entry sums


def check_e_entry(card, dev="cuda"):
    """Kernel E from the adversarial entry states of ``testing.E_ENTRY_CASES``
    at 1, the default and 132 chunks against its plain version: closes and
    exit states bit for bit. Returns the number of cases held."""
    import torch
    from finmlkit_tpu_torch.ops import event_scan as es
    from finmlkit_tpu_torch.testing import E_ENTRY_CASES, assert_exact, e_entry_case, same_state
    held = 0
    for name in E_ENTRY_CASES:
        mode, start, kw, plain = e_entry_case(name, ENTRY_N, dev)
        want, want_end = plain(ENTRY_N)
        for chunks in (1, None, 132):
            if dev == "cpu" and mode == es._IMBALANCE_MAP:   # a rehearsal: E's models
                got, _, end = es._map_scan_model(ENTRY_N, start, ENTRY_N, 2048, x=kw["x"],
                                                 e_t=kw["e_t"], e_r=kw["e_r"],
                                                 entry=kw["entry"], exit_state=True)
            elif dev == "cpu":
                got, _, end = es._chunked_scan_model(mode, ENTRY_N, start, ENTRY_N,
                                                     chunks or 7, exit_state=True, **kw)
            else:
                got, end = es._launch(mode, ENTRY_N, start, ENTRY_N, torch.device(dev),
                                      chunks=chunks, exit_state=True, **kw)
            assert_exact(got, want, f"E {name} at {chunks} chunks")
            if not same_state(end, want_end):
                fail(f"E {name} at {chunks} chunks: exit state {end} != plain {want_end}")
            held += 1
    say(f"kernel E from adversarial entry states ({', '.join(E_ENTRY_CASES)}) at 1, the "
        f"default and 132 chunks == plain: closes and exit states bit for bit, {held} "
        f"cases [{card}]")
    return held


def check_d_entry(card, dev="cuda"):
    """Kernel D from entry sums on each route (``testing.D_ENTRY_CASES``): the
    exit sum of the stream's first third, and one ulp below the threshold,
    against the plain loop, closes and exit sums bit for bit, the split walk
    equal to the whole walk. Returns the number of cases held."""
    import torch
    from finmlkit_tpu_torch.ops import float_walk as fw
    from finmlkit_tpu_torch.testing import D_ENTRY_CASES, assert_exact, d_entry_case, same_state
    held, n = 0, WALK_ENTRY_N
    for name in D_ENTRY_CASES:
        mode, px, v, thr = d_entry_case(name, n, dev)
        walk = fw.volume_walk if mode == "volume" else fw.dollar_walk
        plain = fw.volume_walk_plain if mode == "volume" else fw.dollar_walk_plain
        args = (lambda a, b: (v[a:b],)) if mode == "volume" else (lambda a, b: (px[a:b], v[a:b]))
        k = n // 3
        whole, whole_end = walk(*args(0, n), thr, n, exit_state=True)
        head, mid = walk(*args(0, k), thr, n, exit_state=True)
        for entry, state in (("split", mid), ("below", float(np.nextafter(thr, 0.0)))):
            before = fw.route_launches()
            got, end = walk(*args(k, n), thr, n, state=state, exit_state=True)
            routes = [a - b for a, b in zip(fw.route_launches(), before)] or [0]
            want, want_end = plain(*args(k, n), thr, n, state=state, exit_state=True)
            assert_exact(got, want, f"D {name} from {entry}")
            if not same_state(end, want_end):
                fail(f"D {name} from {entry}: exit sum {end} != plain {want_end}")
            if entry == "split":
                assert_exact(torch.cat([head, got + k]), whole, f"D {name} split vs whole")
                if not same_state(end, whole_end):
                    fail(f"D {name}: the split walk's exit sum {end} != the whole's")
            held += 1
            say(f"kernel D {name} from the {entry} entry sum: route "
                f"{dict(zip(('warp step', 'block walk', 'units'), routes))}, == plain")
    say(f"kernel D from entry sums on every route == plain, the split walks == the whole "
        f"walks: {held} cases [{card}]")
    return held


def month_shard_edges(card, ranks, dev="cuda"):
    """Kernels E and D on the month cut at the ranks' span edges: each span
    scanned from the state the kernel left at the end of the span before,
    against the plain version from the same state (closes and exit states bit
    for bit; CUSUM's float64 sums round otherwise in the plain version, so its
    states are held within 1e-12 of lam), timed on the card (each span's
    entered scan after a warm call, CUDA events; the plain versions on the
    host clock). Returns
    ``{scan: (span ms, whole-month ms, the spans equal one scan, the plain
    versions' ms over the spans)}``."""
    import torch
    from finmlkit_tpu_torch.bar.indexers import cusum_scan_inputs
    from finmlkit_tpu_torch.bar.quantize import quantize_trades
    from finmlkit_tpu_torch.ops import event_scan as es
    from finmlkit_tpu_torch.ops import float_walk as fw
    from finmlkit_tpu_torch.testing import assert_exact, same_state
    ts, price, amount, side = synth_trades(N_MONTH)
    q = quantize_trades(price, amount)
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    tt, pt, at, st = T(ts), T(price), T(amount), T(side)
    rets, lam, cc, fv, _ = cusum_scan_inputs(tt, pt, T(info_sigma(N_MONTH)), CUSUM_FLOOR,
                                             CUSUM_MULT)
    w = st.to(torch.float64)
    units = T(q.amount_units)
    thr_u = math.ceil(float(amount.astype(np.float64).sum()) / VOLUME_BARS / q.amount_scale)
    vol_thr = float(amount.astype(np.float64).sum()) / VOLUME_BARS
    dol_thr = float((price * amount.astype(np.float64)).sum()) / DOLLAR_BARS
    run = tuple(RUN_EMA[k] for k in ("expected_ticks_init", "expected_rate_init",
                                     "alpha_ticks", "alpha_rate"))
    cuts = [N_MONTH * r // ranks for r in range(ranks + 1)]
    n = N_MONTH

    def cusum(a, b, state, plain):
        f = es.cusum_scan_plain if plain else es.cusum_scan
        start = max(fv - a, -1)
        if start + 1 >= b - a:
            return torch.zeros(0, dtype=torch.int64, device=dev), state
        return f(rets[a:b], lam[a:b], cc[a:b], start, n, state=state, exit_state=True)

    def info(run_mode):
        def go(a, b, state, plain):
            f = es.info_scan_plain if plain else es.info_scan
            args = (w[a:b], *(run if run_mode else (1.0, IMB_THETA, 0.0, 0.0)), n, run_mode)
            kw = {} if plain else {"integral": True}
            st0 = None if state is None else state[:4] + (state[4] - a,)
            got, end = f(*args, state=st0, first_closes=a > 0, exit_state=True, **kw)
            return got, end[:4] + (end[4] + a,)
        return go

    def volume(a, b, state, plain):
        f = es.volume_scan_plain if plain else es.volume_scan
        return f(units[a:b], thr_u, n, state=state, first_closes=a > 0, exit_state=True)

    def walk(mode):
        def go(a, b, state, plain):
            if mode == "volume":
                f = fw.volume_walk_plain if plain else fw.volume_walk
                return f(at[a:b], vol_thr, n, state=state, exit_state=True)
            f = fw.dollar_walk_plain if plain else fw.dollar_walk
            return f(pt[a:b], at[a:b], dol_thr, n, state=state, exit_state=True)
        return go

    scans = {"E cusum": cusum, "E imbalance": info(False), "E run": info(True),
             "E volume": volume, "D volume": walk("volume"), "D dollar": walk("dollar")}
    out = {}
    for name, go in scans.items():
        state, span_ms, whole_ms, plain_ms = None, [], 0.0, 0.0
        parts = []
        for r in range(ranks):
            a, b = cuts[r], cuts[r + 1]
            go(a, b, state, False)          # warm: the allocator's blocks of this size
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            got, end = go(a, b, state, False)
            e1.record()
            e1.synchronize()
            span_ms.append(e0.elapsed_time(e1))
            t0 = time.perf_counter()
            want, want_end = go(a, b, state, True)
            plain_ms += (time.perf_counter() - t0) * 1e3
            if name == "E cusum":
                g, wv = got.cpu().numpy(), want.cpu().numpy()
                lam_at = lam[a:b].cpu().numpy()
                if not np.array_equal(g, wv):
                    fail(f"{name}, span {r}: {len(g)} closes != plain's {len(wv)}")
                if max(abs(x - y) for x, y in zip(end, want_end)) > 1e-12 * float(lam_at.min()):
                    fail(f"{name}, span {r}: exit state {end} far from plain's {want_end}")
            else:
                assert_exact(got, want, f"{name} span {r}")
                if not same_state(end, want_end):
                    fail(f"{name}, span {r}: exit state {end} != plain {want_end}")
            parts.append(got + a)
            state = end
        go(0, n, None, False)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        whole, whole_end = go(0, n, None, False)
        e1.record()
        e1.synchronize()
        whole_ms = e0.elapsed_time(e1)
        split_same = torch.equal(torch.cat(parts), whole) and same_state(state, whole_end)
        if not split_same and not name.startswith("E cusum"):
            fail(f"{name}: the month scanned in {ranks} spans differs from one scan")
        out[name] = (span_ms, whole_ms, split_same, plain_ms)
        say(f"{name} on the month in {ranks} spans, each from the kernel's state at the "
            f"span before: == plain from the same states; span ms "
            f"{[round(x, 3) for x in span_ms]} (sum {sum(span_ms):.3f}) vs one scan "
            f"{whole_ms:.3f} ms; the spans' closes and exit state "
            f"{'==' if split_same else '!='} one scan's [{card}]")
    return out


def timed_entry(key, launches, run, plain, nbytes, ops, peak=PEAK_OPS_PER_S, lib=None,
                rtol=None):
    """A ``kernels`` entry for a kernel no earlier phase timed: ``run`` against
    ``plain`` (exact, or within ``rtol``), both timed by CUDA events, and
    ``lib`` (one PyTorch call) where given."""
    from finmlkit_tpu_torch.testing import assert_close, assert_exact
    got, want = run(), plain()
    got, want = (got if isinstance(got, tuple) else (got,)), (
        want if isinstance(want, tuple) else (want,))
    err = 0.0
    for g, w in zip(got, want):
        if rtol is None:
            assert_exact(g, w, key)
        else:
            err = max(err, assert_close(g, w, rtol=rtol, what=key))
    return kernel_entry(key, launches, err, cuda_ms(run, reps=3), cuda_ms(plain, reps=1),
                        bound(nbytes, ops, peak), None if lib is None else cuda_ms(lib))


def mesh_entries(card, need, launches, edges):
    """``kernels`` entries for the sharded path's kernels no earlier phase
    timed (phase 14 alone): E's scans and D from the month's entered scans
    (the whole month, against the plain versions over the spans); S, C and F
    on the month's streams; R on a recurrence over every 1000th price; G on
    the first 2,000 dollar bars' rolling profile of the first days."""
    import torch
    from finmlkit_tpu_torch.bar import aggregate, footprint, indexers
    from finmlkit_tpu_torch.bar.quantize import quantize_trades
    from finmlkit_tpu_torch.feature.kernels import volume
    from finmlkit_tpu_torch.ops import prefix_scan, scan
    n = N_MONTH
    ts, price, amount, side = synth_trades(n)
    entries = {}
    for key in ("E cusum", "E imbalance", "E run", "E volume", "D"):
        if key in need:
            spans, whole, _, plain = edges["D dollar" if key == "D" else key]
            nbytes = {"E cusum": 17, "D": 12}.get(key, 8) * n
            entries[key] = kernel_entry(key, launches[key], 0.0, whole, plain,
                                        bound(nbytes, 10 * n), None)
    a64 = torch.from_numpy(amount.astype(np.float64)).cuda()
    if "S" in need:
        entries["S"] = timed_entry("S", launches["S"], lambda: prefix_scan.fast_cumsum(a64),
                                   lambda: prefix_scan.fast_cumsum_plain(a64), 16 * n, n,
                                   PEAK_F64_OPS_PER_S, lambda: torch.cumsum(a64, 0),
                                   rtol=1e-12)
    if "C" in need:
        x = torch.stack([a64 * (k + 1) for k in range(7)])
        entries["C"] = timed_entry("C", launches["C"], lambda: prefix_scan.fast_cumsum_cols(x),
                                   lambda: prefix_scan.fast_cumsum_cols_plain(x),
                                   16 * 7 * n, 7 * n, PEAK_F64_OPS_PER_S,
                                   lambda: torch.cumsum(x, 1), rtol=1e-12)
    if "F" in need:
        sig = torch.from_numpy(info_sigma(n)).cuda()
        valid = ~torch.isnan(sig)
        entries["F"] = timed_entry("F", launches["F"], lambda: prefix_scan.fast_ffill(sig, valid),
                                   lambda: prefix_scan.fast_ffill_plain(sig, valid), 17 * n, n)
    if "R" in need:
        y = torch.from_numpy(price[::1000].copy()).cuda()
        entries["R"] = timed_entry("R", launches["R"], lambda: scan.linear_recurrence(0.9, y),
                                   lambda: scan.linear_recurrence_plain(0.9, y),
                                   16 * y.shape[0], 2 * y.shape[0], PEAK_F64_OPS_PER_S,
                                   rtol=1e-12)
    if "G" in need:
        m = int(np.searchsorted(ts, ts[0] + int(MESH_FP_DAYS * 86_400e9)))
        q = quantize_trades(price[:m], amount[:m])
        T = lambda v: torch.from_numpy(np.ascontiguousarray(v)).cuda()  # noqa: E731
        dol_thr = float((price * amount.astype(np.float64)).sum()) / DOLLAR_BARS
        _, ci = indexers.dollar_bar_indexer_q(T(ts[:m]), T(q.price_ticks), T(q.amount_units),
                                              dol_thr, q.tick_size, q.amount_scale)
        o = aggregate.comp_bar_ohlcv(T(price[:m]), T(amount[:m]), ci)
        lo, hi = footprint.bar_levels(o["low"], o["high"], q.tick_size)
        fp = footprint.comp_bar_footprints(T(price[:m]), T(amount[:m]), ci, T(side[:m]),
                                           q.tick_size, o["low"], o["high"], 3.0,
                                           max_levels=int((hi - lo + 1).max()))
        k = min(2000, ci.shape[0] - 1)
        tb, low, nlev, buy, sell = volume._footprint_tensors(
            T(ts[:m])[ci[1:k + 1]], fp["low_level"][:k], fp["n_levels"][:k],
            fp["buy_volumes"][:k], fp["sell_volumes"][:k], "cuda")
        start, first, mx = volume._rolling_sizes(tb, low, nlev, buy.shape[1],
                                                 int(PROFILE_WINDOW * 1e9), None)
        args = (start, first, low, nlev, buy, sell, mx, 27, PROFILE_VA / 100.0)
        entries["G"] = timed_entry("G", launches["G"], lambda: volume._rolling(*args),
                                   lambda: volume.volume_profile_rolling_plain(*args),
                                   8 * buy.numel() + 16 * k, 10 * buy.numel(), rtol=1e-12)
    for key, e in entries.items():
        say(f"kernel {key} (phase 14 alone): {e['ms']:.3f} ms vs plain {e['plain_ms']:.3f} "
            f"ms, bound {e['bound_ms']:.4f} ms [{card}]")
    return entries


def phase_mesh(card, need, ranks=MESH_RANKS, dev="cuda"):
    from finmlkit_tpu_torch.parallel import dryrun
    from finmlkit_tpu_torch.parallel.mesh import spawn_mesh
    t_phase = time.perf_counter()
    e_held, d_held = check_e_entry(card, dev), check_d_entry(card, dev)
    edges = month_shard_edges(card, ranks, dev)
    # the rank path: the month through the sharded layer, gloo ranks on the card
    t0 = time.perf_counter()
    res = spawn_mesh(dryrun.month_path, ranks, args=(MESH_SPEC,), backend="gloo",
                     device=dev, timeout=600, deadline=900)
    wall = time.perf_counter() - t0
    r0 = res[0]
    if r0["bad"]:
        fail(f"the sharded layer on {ranks} ranks differs from one device: {r0['bad']}")
    if any(r["digests"] != r0["digests"] for r in res):
        fail("the ranks' replicated outputs differ")
    if dev != "cpu" and not all(r["staged_same"] for r in res):
        fail("the indexers with every collective staged through host memory differ")
    launches = {k: sum(r["launches"][k] for r in res) for k in r0["launches"]}
    missing = [k for k, v in launches.items() if k != "S float" and v < 1]
    if missing and dev != "cpu":
        fail(f"kernels of the sharded path did not launch: {missing} ({launches})")
    say(f"mesh: {ranks} gloo ranks on one card, {wall:.1f} s (spawn, CUDA contexts and "
        f"kernel load included); bars {r0['counts']}; every output == one device (closes, "
        f"integers, prices, medians, footprints of the first {MESH_FP_DAYS} days "
        f"({r0['footprint_trades']:,} trades, grid {r0['grid']}), labels, weights, the "
        f"profile's levels exact, pct within 1e-12, float sums within their bounds, largest "
        f"share {max(r0['shares'].values()):.3g}); replicated on every rank; the time "
        f"indexer and the volume ring with every collective staged through pinned host "
        f"memory give the same closes ({res[0].get('staged_bytes', 0):,} bytes staged on "
        f"rank 0); "
        f"launches {launches} [{card}]")
    for r in res:
        say(f"mesh rank {r['rank']} stage seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, v in r["seconds"].items()))
    say("mesh ring (rank 0's scan s, the ring's wall s) beside one device's indexer s: "
        + ", ".join(f"{k} ({v[0]:.3f}, {v[1]:.3f}) vs {r0['single_seconds'].get(f'indexer {k}', float('nan')):.3f}"
                    for k, v in r0["ring"].items()))
    say("mesh bytes moved by rank 0's collectives: " + json.dumps(r0["bytes"]))
    say(f"mesh: {ranks} ranks sharing one card measure no scaling (one card's SMs and "
        f"memory, the collectives through gloo on its host); N-GPU and N-host scaling are "
        f"not measured [{card}]")
    # one nccl rank: the same entry points on a world of one
    one = spawn_mesh(dryrun.month_path, 1, args=(dict(MESH_SPEC, only="indexers",
                                                      stage=False),),
                     backend="nccl" if dev != "cpu" else "gloo", device=dev, timeout=600,
                     deadline=600)[0]
    same = {k: one["digests"][k] == r0["digests"][k] for k in one["digests"]}
    if not all(same.values()):
        fail(f"one nccl rank's closes differ from {ranks} gloo ranks': {same}")
    say(f"mesh: one nccl rank gives the same closes as {ranks} gloo ranks "
        f"({len(same)} indexers) [{card}]")
    # the kernels line: the path's kernels, timed here where no earlier phase did
    entries = mesh_entries(card, need, launches, edges) if need else {}
    extra = {}
    for key, name in (("E cusum", "E cusum"), ("E imbalance", "E imbalance"),
                      ("E run", "E run"), ("E volume", "E volume"), ("D", "D dollar")):
        spans, whole, split_same, _ = edges[name]
        extra[key] = dict(entry_state_span_ms=spans, entry_state_whole_ms=whole,
                          spans_equal_one_scan=split_same)
    extra["E cusum"]["entry_states_held"] = e_held
    extra["D"]["entry_sums_held"] = d_held
    extra["D"]["volume_entry_state_span_ms"] = edges["D volume"][0]
    say(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return launches, entries, extra


def main():
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13,14",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--ranks", type=int, default=MESH_RANKS,
                    help=f"phase 14's gloo ranks on the card (default {MESH_RANKS})")
    ap.add_argument("--cli-trades", type=int, default=CLI_TRADES,
                    help="trades in phase 13's spot-layout ZIP for the CLI (default "
                         f"{CLI_TRADES:,}; {N_MONTH} is the whole month)")
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
        run_count = launches.pop("E run_count", None)  # E run's by the count search
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
        if run_count is not None:
            kernels["E run"].setdefault("count_launches_by_path", {})[path] = run_count

    month = make_month(N_MONTH) if phases & {5, 6, 7, 8, 9, 10, 11} else None
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
    if 11 in phases:
        need = {"B", "S", "R", "Z"} - set(kernels)
        merge("chain", *phase_chain(card, month, need))
    del month
    if 12 in phases:
        need = {"S", "C", "E volume"} - set(kernels)
        merge("offgrid", *phase_offgrid(card, need))
    if 13 in phases:
        need = {"B", "S"} - set(kernels)
        merge("klines", *phase_klines(card, need, args.cli_trades))
    if 14 in phases:
        need = {"S", "C", "F", "R", "G", "D", "E cusum", "E imbalance", "E run",
                "E volume"} - set(kernels)
        launches, entries, extra = phase_mesh(card, need, args.ranks)
        merge("mesh", launches, entries)
        for key, fields in extra.items():
            kernels[key].update(fields)
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
