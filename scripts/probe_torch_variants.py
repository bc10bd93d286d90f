#!/usr/bin/env python3
"""Variants of the port's kernels V (``csrc/bar_planes.cu``) and P3
(``csrc/io_floor.cu``) timed on one NVIDIA GPU at the month's shapes.

Each kernel V variant is the source with a few edits (tile shape, launch
bounds) or an ablation that skips part of the write pass (its outputs are
then wrong, and the line says so); each is built by its own ``nvcc``, run
pass by pass on the synthetic month's one-minute bars (``chip_smoke.py``'s
month) and held to ``bar_scan_planes_plain``. P3 is timed against a
grid-stride loop of the same loads and against ``torch.sum(x, 0)`` on an
``(8, n)`` int32 stack with n odd, in turns.

Run from the repository root on a machine with a card:
``python3 scripts/probe_torch_variants.py [V variant names, comma-separated]``.
It prints each kernel's registers and spills (ptxas), then one line a
variant and the card's name and power limit.

``python3 scripts/probe_torch_variants.py EH [H variant names]`` traces kernel
E's map path on the month's tick imbalance (theta 30) and kernel H's first
histogram pass and its less pass on the month's one-minute bars, as the
package builds them, in one ``torch.profiler`` session: each of their
kernels' device time, registers, blocks and warps an SM and estimated
achieved occupancy, beside each call's time from CUDA events (the trace goes
to ``build/variants/eh_trace.json``). Then each kernel H variant of
``H_VARIANTS`` named (``csrc/segment_hist.cu`` with edits, built alone) and
each ``name=dir`` whose directory holds another ``segment_hist.cu`` (a ``git
archive`` of an earlier commit, say) runs, in turns, the month's hist engine's
nine launches, its first histogram pass and its less pass, and one
histogram pass on one bar of 1M trades, held to the plain passes.

``python3 scripts/probe_torch_variants.py B [names]`` probes kernel B
(``csrc/bar_products.cu``) instead: the variants of ``B_VARIANTS`` named (by
default "as built") and each ``name=dir`` whose directory holds another
``bar_products.cu`` and ``bar_scan.cuh`` (a ``git archive`` of an earlier
commit, say), each built by its own ``nvcc``, on the month's one-minute bars and on one bar of 1M trades.
Each is held to ``bar_scan_products_plain`` and timed alone (``ci`` checked
once, outside the timed window) in turns, pass by pass where it has passes,
and traced once under ``torch.profiler``: device time, registers, blocks and
warps an SM and the estimated achieved occupancy of each of its kernels, and
the rate of its bytes (13 a trade read, the close indices, 104 a bar
written), and the package's call on the month in its parts (the check of
``ci``, the buffers, the kernel). The chrome traces go to
``build/variants/b_trace_<i>_<shape>.json``.

``python3 scripts/probe_torch_variants.py FE [names]`` probes kernel F
(``csrc/ffill.cu``) and kernel E's CUSUM scan (``csrc/event_scan.cu`` with
``csrc/prefix_scan.cu``, which compacts its closes): "as built" and each
``name=dir`` whose directory holds another checkout's ``finmlkit_tpu_torch``
(a ``git archive`` of the parent commit unpacked under ``build/``), each built
by its own ``nvcc`` and called through its C entry points. In turns (three
of them): the select engine's four int32 fills on the month's one-minute
bars (L1; the last one alone too), the float64 forward fill of the CUSUM
sigma (K5) and the month's CUSUM scan at its default chunk count, each held
to its plain version (the fills bit for bit, the closes exactly). Then one
``torch.profiler`` session traces one L1 fill and one K5 fill of each build:
its kernels and memsets, their device time and count. The last line is one
JSON object of the times.

``python3 scripts/probe_torch_variants.py RW [W variant names]`` traces
kernel R's three passes under ``torch.profiler`` (device time, registers and
estimated occupancy of each) at the month's trade count, with a constant and
a time-varying decay, and on the month's one-minute bars; then times the
kernel W builds of ``W_VARIANTS`` named (``csrc/csw.cu`` with edits, built
alone; "no division" is an ablation whose values differ), in turns, on the
month's bars at window 1000 and on 50,000 log prices at window 500, each
checked against the plain statistic. The last line is one JSON object of the
times.
"""
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from finmlkit_tpu_torch import _build  # noqa: E402
from finmlkit_tpu_torch.bar.indexers import time_bar_indexer  # noqa: E402
from finmlkit_tpu_torch.ops import fused_scan as fs  # noqa: E402

CSRC = ROOT / "finmlkit_tpu_torch" / "csrc"
OUT = ROOT / "build" / "variants"
WRITE_END = "                                 warp_f, &ftotal);\n"


def _sub(pattern, repl):
    def edit(src):
        out, k = re.subn(pattern, repl, src, flags=re.S)
        assert k == 1, pattern
        return out
    return edit


THREADS = r"constexpr int kThreads = 256;"
ITEMS = r"constexpr int kItems = 4;"
WRITE_LB = r"__launch_bounds__\(kThreads, 768 / kThreads\)\nplanes_write"
V_VARIANTS = {
    "as built": [],
    "128 threads x 8 trades": [_sub(THREADS, "constexpr int kThreads = 128;"),
                               _sub(ITEMS, "constexpr int kItems = 8;")],
    "128 threads x 8 trades, write at 128 registers": [
        _sub(THREADS, "constexpr int kThreads = 128;"), _sub(ITEMS, "constexpr int kItems = 8;"),
        _sub(WRITE_LB, "__launch_bounds__(kThreads, 4)\nplanes_write")],
    "128 threads x 4 trades": [_sub(THREADS, "constexpr int kThreads = 128;")],
    "write, 2 blocks an SM": [_sub(WRITE_LB, "__launch_bounds__(kThreads, 2)\nplanes_write")],
    "write, 4 blocks an SM": [_sub(WRITE_LB, "__launch_bounds__(kThreads, 4)\nplanes_write")],
    # ablations of the write pass: its outputs are wrong
    "write without its stores": [_sub(r"if \(w0 \+ p < n\) row\[w0 \+ p\] =",
                                      "if (w0 + p < 0) row[w0 + p] =")],
    "write without its rows": [_sub(re.escape(WRITE_END), WRITE_END +
                                    "  if (in.ct != 0x7fffffffu || fin.cvmin != 1.0f) return;\n")],
    "write without its Sum scan": [_sub(
        r"fmk::block_exclusive_scan<kWarps>\(x, sum_id\(\), comb, warp_sum, &total\)\)",
        "x); (void)total")],
}

P3_GRID_STRIDE = r"""
#include <cuda_runtime.h>
namespace {
__device__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ int4 add4(int4 a, int4 b) {
  return {wadd(a.x, b.x), wadd(a.y, b.y), wadd(a.z, b.z), wadd(a.w, b.w)};
}
__device__ int4 pick4(int4 lo, int4 hi, int m) {
  switch (m) {
    case 0: return lo;
    case 1: return {lo.y, lo.z, lo.w, hi.x};
    case 2: return {lo.z, lo.w, hi.x, hi.y};
    default: return {lo.w, hi.x, hi.y, hi.z};
  }
}
__global__ void __launch_bounds__(256) k(const int4* __restrict__ base, int head,
                                         int* __restrict__ out, long long n) {
  const long long n4 = n / 4;
  for (long long q = (long long)blockIdx.x * 256 + threadIdx.x; q < n4;
       q += (long long)gridDim.x * 256) {
    int4 acc = {0, 0, 0, 0};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const long long e = head + r * n;
      const int m = (int)(e & 3);
      const long long a = (e >> 2) + q;
      const int4 lo = base[a];
      acc = add4(acc, pick4(lo, m ? base[a + 1] : lo, m));
    }
    reinterpret_cast<int4*>(out)[q] = acc;
  }
}
}  // namespace
// rows 8, n = 4 n4 + r: only the first 4 n4 values of out are written
extern "C" int p3_grid_stride(const void* x, long long n, void* out, void* stream) {
  const auto addr = (unsigned long long)x;
  k<<<132 * 16, 256, 0, (cudaStream_t)stream>>>((const int4*)(addr & ~15ull),
                                                (int)((addr & 15ull) / 4), (int*)out, n);
  return (int)cudaGetLastError();
}
"""


def nvcc(src_dir, out):
    """Builds every .cu of src_dir into one library; returns ptxas's report."""
    cus = sorted(str(p) for p in Path(src_dir).glob("*.cu"))
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(out), *cus], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(r.stdout + r.stderr)
    return r.stdout + r.stderr


V_KERNELS = r"planes_[a-z_]+|tiles_scan\w{0,12}"
B_KERNELS = r"products_[a-z_]+|bar_products_kernel"


def ptxas_summary(log, kernels=V_KERNELS):
    """(kernel, 'N registers, S bytes spilled') of each kernel whose name
    matches ``kernels``."""
    rows, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?_cu_\w+?\d+(" + kernels + ")", line)
        if m:
            fn = m.group(1)
        elif fn and "spill stores" in line:
            spill = line.split("bytes spill stores")[0].split(",")[-1].strip()
        elif fn and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            rows.append((fn, f"{regs} registers, {spill} bytes spilled"))
            fn = None
    return rows


B_BLOCKS = r"constexpr int kBlocksPerSM = 3;"
B_VARIANTS = {
    "as built": [],
    "2 blocks an SM": [_sub(B_BLOCKS, "constexpr int kBlocksPerSM = 2;")],
    "4 blocks an SM": [_sub(B_BLOCKS, "constexpr int kBlocksPerSM = 4;")],
    "tiles of 4096": [_sub(r"constexpr int kItems = 8;", "constexpr int kItems = 16;"),
                      _sub(B_BLOCKS, "constexpr int kBlocksPerSM = 1;")],
    "1024-trade tiles of 4 a thread at 4 blocks an SM": [
        _sub(r"constexpr int kItems = 8;", "constexpr int kItems = 4;"),
        _sub(B_BLOCKS, "constexpr int kBlocksPerSM = 4;")],
    "1024-trade tiles of 128 threads at 6 blocks an SM": [
        _sub(r"constexpr int kThreads = 256;", "constexpr int kThreads = 128;"),
        _sub(B_BLOCKS, "constexpr int kBlocksPerSM = 6;")],
    # ablations of the tiles pass: its outputs are wrong
    "without the look-back": [_sub(r"\? look_back\(status, tile\) :", "? run_id() :")],
    "without the joins": [_sub(r"j < owners; j \+= kWarps\)", "j < -1; j += kWarps)")],
    "without walk 2": [_sub(r"for \(int j = 0; j < kItems; \+\+j\) \{\n    if \(i0 \+ j >= n\) break;",
                            "for (int j = 0; j < 0; ++j) {\n    if (i0 + j >= n) break;")],
    "the loads alone": [_sub(
        r"\n  // walk 1: this thread's in-bar sums; then the tile's, exclusive a thread",
        "\n  {\n    unsigned acc = open ^ next_open ^ static_cast<unsigned>(ptick + pside);\n"
        "#pragma unroll\n    for (int j = 0; j < kItems; ++j)\n"
        "      acc ^= tk[j] ^ side_of(j) ^ static_cast<unsigned>(un[j] ^ (un[j] >> 32));\n"
        "    if (acc == 0x9e3779b9u) rec.r32[0] = acc;\n    return;\n  }\n"
        "  // walk 1: this thread's in-bar sums; then the tile's, exclusive a thread")],
    "without the float extrema": [_sub(
        r"const float fv = fmk::pair_f32\(r.cv\), fd = fmk::pair_f32\(r.cd\);",
        "const float fv = __int_as_float(r.ct), fd = fv;")],
}


# kernel H's init kernel as a thread a bar that fills its close's tiles (a
# serial loop as long as the bar), in place of a warp's search a tile
H_INIT_A_BAR = _sub(
    r"  const long long t = j >> 5;\n.*?  if \(lane == 0\) tile_lo\[t\] = a;\n",
    "  if (j > nb) return;\n"
    "  const long long t0 = (ci[j] + kTile) / kTile;\n"
    "  const long long t1 = j < nb ? min((ci[j + 1] + kTile) / kTile, tiles + 1) : tiles + 1;\n"
    "  if (j == 0)\n"
    "    for (long long t = 0; t < min(t0, tiles + 1); ++t) tile_lo[t] = 0;\n"
    "  for (long long t = t0; t < t1; ++t) tile_lo[t] = j + 1;\n")
H_VARIANTS = {
    "as built": [],
    "128 threads a tile": [_sub(r"constexpr int kThreads = 256;",
                                "constexpr int kThreads = 128;")],
    "5 blocks an SM": [_sub(r"constexpr int kBlocksPerSM = 6;", "constexpr int kBlocksPerSM = 5;")],
    "8 blocks an SM": [_sub(r"constexpr int kBlocksPerSM = 6;", "constexpr int kBlocksPerSM = 8;")],
    "bucket range by compare and select": [_sub(
        r"const unsigned sh = 4u \* min\(static_cast<unsigned>\(f\), static_cast<unsigned>\(kBuckets\)\);",
        "const unsigned sh = static_cast<unsigned>(f) < 16u ? 4u * static_cast<unsigned>(f) : 64u;")],
    # the costs of exactness, each undone (outputs wrong where f wraps)
    "bucket shift wrapping": [_sub(
        r"const unsigned sh = 4u \* min\(static_cast<unsigned>\(f\), static_cast<unsigned>\(kBuckets\)\);",
        "const unsigned sh = static_cast<unsigned>(f) << 2;")],
    "init a thread a bar": [H_INIT_A_BAR],
    "shift wrapping and init a thread a bar": [_sub(
        r"const unsigned sh = 4u \* min\(static_cast<unsigned>\(f\), static_cast<unsigned>\(kBuckets\)\);",
        "const unsigned sh = static_cast<unsigned>(f) << 2;"), H_INIT_A_BAR],
    # an ablation: its outputs are wrong
    "the loads alone": [_sub(
        r"\n  const bool in_smem = ",
        "\n  {\n    int acc = static_cast<int>(lo ^ hi);\n#pragma unroll\n"
        "    for (int j = 0; j < kItems; ++j) acc ^= x[j];\n"
        "    if (acc == 0x1e3779b9) p.init(0);\n    return;\n  }\n  const bool in_smem = ")],
}


def h_library(src_dir, out_dir, edits=()):
    """Kernel H from ``src_dir`` (with ``edits``) built alone; returns its
    passes ``hist(bits, ci, base, s, out)`` and ``less(bits, ci, v, cnt, mx)``
    on checked CUDA tensors, and ptxas's report of its kernels. A source
    without tiles (the per-bar kernel of an earlier commit) takes no scratch."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (Path(src_dir) / "segment_hist.cu").read_text()
    for edit in edits:
        src = edit(src)
    (out_dir / "segment_hist.cu").write_text(src)
    log = nvcc(out_dir, out_dir / "lib.so")
    lib = ctypes.CDLL(str(out_dir / "lib.so"))
    P, I64 = ctypes.c_void_p, ctypes.c_longlong
    tiled = "tile_lo" in src
    lib.fmk_hist_pass.argtypes = [P, P, P, ctypes.c_int] + ([I64] if tiled else []) + [
        I64, P] + ([P] if tiled else []) + [P]
    lib.fmk_less_pass.argtypes = [P, P, P] + ([I64] if tiled else []) + [I64, P, P] + (
        [P] if tiled else []) + [P]
    scratch = {}

    def tile_lo(n):
        if n not in scratch:
            scratch[n] = torch.empty(n // 4096 + 2, dtype=torch.int64, device="cuda")
        return [scratch[n].data_ptr()] if tiled else []

    def hist(bits, ci, base, s, out):
        n, nb = bits.shape[0], ci.shape[0] - 1
        rc = lib.fmk_hist_pass(bits.data_ptr(), ci.data_ptr(), base.data_ptr(), s,
                               *([n] if tiled else []), nb, out.data_ptr(), *tile_lo(n),
                               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kernel H from {src_dir}: CUDA error {rc}")

    def less(bits, ci, v, cnt, mx):
        n, nb = bits.shape[0], ci.shape[0] - 1
        rc = lib.fmk_less_pass(bits.data_ptr(), ci.data_ptr(), v.data_ptr(),
                               *([n] if tiled else []), nb, cnt.data_ptr(), mx.data_ptr(),
                               *tile_lo(n), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kernel H from {src_dir}: CUDA error {rc}")
    return hist, less, ptxas_summary(log, r"(?:tiles|init|hist|less)_kernel\w*")


def probe_h(specs):
    """Kernel H's builds ``specs`` (name -> source directory and edits), in
    turns: the month's hist engine's nine launches (its 8 histogram passes and
    its less pass, with the bases the engine makes), its first histogram pass
    and its less pass alone, and one histogram pass on one bar of 1M trades,
    each held to the plain passes."""
    from finmlkit_tpu_torch.ops import segment_hist as sh
    from finmlkit_tpu_torch.testing import adversarial_trades
    card = cs.phase_env()
    builds = {}
    for i, (name, (src, edits)) in enumerate(specs.items()):
        builds[name] = h_library(src, OUT / f"h{i}", edits)
        for fn, what in builds[name][2]:
            cs.say(f"H {name}: {fn} {what}")
    month = cs.make_month(cs.N_MONTH)
    tr, ts = month["tr"], month["ts"]
    ci = time_bar_indexer(tr.timestamps, 60.0, ts_first=int(ts[0]),
                          ts_last_i=int(ts[-1]))[1]
    bits, ci = sh._check_ci(tr.amounts.view(torch.int32), ci, "probe")
    n, nb = bits.shape[0], ci.shape[0] - 1
    passes, less_v = [], []

    def record_hist(bits_, ci_, base, s_):
        passes.append((base.clone(), s_))
        return sh.hist_pass_plain(bits_, ci_, base, s_)

    def record_less(bits_, ci_, v):
        less_v.append(v.clone())
        return sh.less_pass_plain(bits_, ci_, v)

    sh.segment_median_pair_hist(tr.amounts, ci, hist=record_hist, less=record_less)
    want = [sh.hist_pass_plain(bits, ci, b, s_) for b, s_ in passes]
    want_l = sh.less_pass_plain(bits, ci, less_v[0])
    n_long = 1_000_000
    long_bits = torch.from_numpy(adversarial_trades(n=n_long, seed=1)[3]).cuda().view(torch.int32)
    long_ci = torch.tensor([-1, n_long - 1], device="cuda")
    long_base = torch.zeros(1, dtype=torch.int32, device="cuda")
    long_want = sh.hist_pass_plain(long_bits, long_ci, long_base, 28)
    out = torch.empty((nb, 16), dtype=torch.int32, device="cuda")
    long_out = torch.empty((1, 16), dtype=torch.int32, device="cuda")
    cnt, mx = (torch.empty(nb, dtype=torch.int32, device="cuda") for _ in range(2))

    def nine(hist, less):
        for b, s_ in passes:
            hist(bits, ci, b, s_, out)
        less(bits, ci, less_v[0], cnt, mx)

    exact = {}
    for name, (hist, less, _) in builds.items():
        ok = True
        for (b, s_), w in zip(passes, want):
            out.fill_(-7)
            hist(bits, ci, b, s_, out)
            ok &= torch.equal(out, w)
        cnt.fill_(-7)
        less(bits, ci, less_v[0], cnt, mx)
        long_out.fill_(-7)
        hist(long_bits, long_ci, long_base, 28, long_out)
        exact[name] = bool(ok and torch.equal(cnt, want_l[0]) and torch.equal(mx, want_l[1])
                           and torch.equal(long_out, long_want))
    parts = {"the 9 launches": lambda h, l: nine(h, l),
             "hist pass s=28": lambda h, l: h(bits, ci, *passes[0], out),
             "less pass": lambda h, l: l(bits, ci, less_v[0], cnt, mx),
             "hist pass on the 1M-trade bar": lambda h, l: h(long_bits, long_ci, long_base,
                                                              28, long_out)}
    times = {(name, part): [] for name in builds for part in parts}
    for _ in range(3):   # in turns
        for name, (hist, less, _) in builds.items():
            for part, f in parts.items():
                times[(name, part)].append(cs.cuda_ms(lambda: f(hist, less), reps=20))
    for name in builds:
        cs.say(f"H {name}: == plain {exact[name]}; ms in 3 turns, " + "; ".join(
            f"{part} " + " ".join(f"{t:.4f}" for t in times[(name, part)]) for part in parts)
            + f"; bound of a month pass {cs.bound(4 * n, 0)[0]:.4f} ms [{card}]")


def b_library(src_dir, out_dir, edits=()):
    """Kernel B from ``src_dir`` (with ``edits``) built alone; returns a launcher
    ``run(args, outs, scratch, passes)`` of its C entry, its scratch size in
    bytes for ``(n, n_bars)`` (0 if none), ptxas's report of its kernels, and
    whether it has passes (the tiled kernel) or not (the parent's)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (Path(src_dir) / "bar_products.cu").read_text()
    for edit in edits:
        src = edit(src)
    (out_dir / "bar_products.cu").write_text(src)
    (out_dir / "bar_scan.cuh").write_text((Path(src_dir) / "bar_scan.cuh").read_text())
    log = nvcc(out_dir, out_dir / "lib.so")
    lib = ctypes.CDLL(str(out_dir / "lib.so"))
    P, I64 = ctypes.c_void_p, ctypes.c_longlong
    tiled = hasattr(lib, "fmk_products_scratch_bytes")
    if tiled:
        lib.fmk_products_scratch_bytes.argtypes = [I64, I64]
        lib.fmk_products_scratch_bytes.restype = I64
    lib.fmk_bar_products.argtypes = [P] * 4 + [I64, I64] + [P] * 3 + (
        [P, ctypes.c_int] if tiled else []) + [P]

    def run(args, outs, scratch, passes=-1):
        n, nb = args[0].shape[0], args[3].shape[0] - 1
        ptrs = [a.data_ptr() for a in args] + [n, nb] + [o.data_ptr() for o in outs]
        if tiled:
            ptrs += [scratch.data_ptr(), passes]
        rc = lib.fmk_bar_products(*ptrs, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kernel B from {src_dir}: CUDA error {rc}")

    def scratch_bytes(n, nb):
        return lib.fmk_products_scratch_bytes(n, nb) if tiled else 0
    return run, scratch_bytes, ptxas_summary(log, B_KERNELS), tiled


def kernel_args(trace_path):
    """Device ms, registers, blocks and warps an SM and the estimated achieved
    occupancy of each kernel in a chrome trace of torch.profiler."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    rows = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        a = e.get("args", {})
        r = rows.setdefault(e["name"][:50], dict(ms=0.0, launches=0))
        r["ms"] += e.get("dur", 0) / 1e3
        r["launches"] += 1
        for key in ("registers per thread", "blocks per SM", "warps per SM",
                    "est. achieved occupancy %", "grid", "block", "shared memory"):
            if key in a:
                r[key] = a[key]
    return rows


def probe_b(specs):
    """Kernel B's builds ``specs`` (name -> source directory and edits) on the
    month's one-minute bars and on one bar of 1M trades."""
    from torch.profiler import ProfilerActivity, profile
    from finmlkit_tpu_torch.testing import adversarial_trades
    card = cs.phase_env()
    builds = {}
    for i, (name, (src, edits)) in enumerate(specs.items()):
        builds[name] = b_library(src, OUT / f"b{i}", edits)
        for fn, what in builds[name][2]:
            cs.say(f"B {name}: {fn} {what}")
    month = cs.make_month(cs.N_MONTH)
    tr, ts = month["tr"], month["ts"]
    ci = time_bar_indexer(tr.timestamps, 60.0, ts_first=int(ts[0]),
                          ts_last_i=int(ts[-1]))[1]
    n_long = 1_000_000
    lt, lu, ls, _, _ = (torch.from_numpy(a).cuda() for a in adversarial_trades(n=n_long, seed=1))
    shapes = {"month": fs._cuda_inputs(tr.ticks, tr.units, tr.sides, ci, "probe"),
              "1M-trade bar": fs._cuda_inputs(lt, lu, ls, torch.tensor([-1, n_long - 1],
                                                                       device="cuda"), "probe")}
    for shape, args in shapes.items():
        n, nb = args[0].shape[0], args[3].shape[0] - 1
        nbytes = 13 * n + 8 * (nb + 1) + 104 * nb
        want = fs.bar_scan_products_plain(*args)
        state = {}
        for name, (run, scratch_bytes, _, _) in builds.items():
            outs = [torch.empty_like(w) for w in want]
            for o in outs:   # no earlier build's result may pass for this one's
                o.view(torch.uint8).fill_(0xA5)
            scratch = torch.empty(max(scratch_bytes(n, nb), 1), dtype=torch.uint8,
                                  device="cuda")
            run(args, outs, scratch)
            torch.cuda.synchronize()
            exact = all(torch.equal(a, b) for a, b in zip(outs, want))
            state[name] = (run, outs, scratch, exact)
        times = {name: [] for name in builds}
        for _ in range(3):   # in turns
            for name, (run, outs, scratch, _) in state.items():
                times[name].append(cs.cuda_ms(lambda: run(args, outs, scratch), reps=20))
        for i, (name, (run, outs, scratch, exact)) in enumerate(state.items()):
            line = (f"B {name} on the {shape} ({n:,} trades, {nb:,} bars): == plain "
                    f"{exact}; alone, ms in 3 turns " + " ".join(f"{t:.4f}" for t in times[name])
                    + f"; {nbytes / min(times[name]) / 1e6:,.0f} GB/s of its bytes, bound "
                    f"{cs.bound(nbytes, 0)[0]:.4f} ms")
            if builds[name][3]:
                line += "; passes " + ", ".join(
                    f"{p} {cs.cuda_ms(lambda k=k: run(args, outs, scratch, 1 << k), reps=20):.4f}"
                    for k, p in enumerate(fs.PRODUCTS_PASSES))
            cs.say(line + f" [{card}]")
            run(args, outs, scratch)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run(args, outs, scratch)
                torch.cuda.synchronize()
            path = OUT / f"b_trace_{i}_{shape.split()[0]}.json"
            prof.export_chrome_trace(str(path))
            cs.say(f"B {name} on the {shape}, traced: " + json.dumps(kernel_args(path)))
        if shape == "month":   # the call's parts, each alone
            raw = (tr.ticks, tr.units, tr.sides, ci)
            parts = {"ci checked": lambda: fs._cuda_inputs(*raw, "probe"),
                     "buffers made": lambda: fs._products_buffers(n, nb, ci.device),
                     "kernel alone": lambda: fs._products_kernel(*args, bufs),
                     "the call": lambda: fs.bar_scan_products(*raw)}
            bufs = fs._products_buffers(n, nb, ci.device)
            cs.say("B's call on the month, ms by part (the package's build): " + ", ".join(
                f"{k} {cs.cuda_ms(f, reps=20):.4f}" for k, f in parts.items()) + f" [{card}]")
        del state, want


def probe_eh():
    """Kernel E's map path and kernel H's passes on the month, traced."""
    from torch.profiler import ProfilerActivity, profile
    from finmlkit_tpu_torch.ops import event_scan as es
    from finmlkit_tpu_torch.ops import segment_hist as sh
    card = cs.phase_env()
    month = cs.make_month(cs.N_MONTH)
    tr, ts = month["tr"], month["ts"]
    ci = time_bar_indexer(tr.timestamps, 60.0, ts_first=int(ts[0]),
                          ts_last_i=int(ts[-1]))[1]
    n = tr.ticks.shape[0]
    w = tr.sides.to(torch.float64)
    bits, ci_c = sh._check_ci(tr.amounts.view(torch.int32), ci, "probe")
    base = torch.zeros(ci.shape[0] - 1, dtype=torch.int32, device="cuda")
    calls = {"E map path": lambda: es._launch(es._IMBALANCE_MAP, n, 1, n, w.device, x=w,
                                              e_t=1.0, e_r=cs.IMB_THETA),
             "H hist pass s=28": lambda: sh._launch_hist(bits, ci_c, base, 28),
             "H less pass": lambda: sh._launch_less(bits, ci_c, bits[:ci.shape[0] - 1])}
    cs.say("calls, ms (CUDA events, 20 calls): " + ", ".join(
        f"{k} {cs.cuda_ms(f, reps=20):.4f}" for k, f in calls.items()) + f" [{card}]")
    OUT.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for f in calls.values():
            for _ in range(5):
                f()
        torch.cuda.synchronize()
    path = OUT / "eh_trace.json"
    prof.export_chrome_trace(str(path))
    rows = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") not in ("kernel", "gpu_memset"):
            continue
        a = e.get("args", {})
        r = rows.setdefault(re.sub(r"\(anonymous namespace\)::", "", e["name"])[:70],
                            dict(ms=0.0, launches=0))
        r["ms"] += e.get("dur", 0) / 1e3 / 5
        r["launches"] += 1
        for key in ("registers per thread", "blocks per SM", "warps per SM",
                    "est. achieved occupancy %", "grid", "block", "shared memory"):
            if key in a:
                r[key] = a[key]
    cs.say(f"traced, ms a call (5 calls each): " + json.dumps(rows) + f" [{card}]")


def fe_library(src_dir, out_dir):
    """Kernels F and E (with S) from another checkout's ``csrc`` built alone;
    returns ``fill(values, valid, zero_before)`` and ``cusum(rets, lam, cc,
    start, chunks)`` on CUDA tensors and ptxas's report of their kernels. A
    source whose F takes a scratch of tile indices (the three-launch kernel
    of an earlier commit) is given one."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in ("ffill.cu", "event_scan.cu", "prefix_scan.cu"):
        (out_dir / name).write_text((Path(src_dir) / name).read_text())
    log = nvcc(out_dir, out_dir / "lib.so")
    lib = ctypes.CDLL(str(out_dir / "lib.so"))
    P, I64, F64, Int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double, ctypes.c_int
    lib.fmk_ffill.argtypes = [Int, P, P, P, P, I64, Int, P]
    one_pass = hasattr(lib, "fmk_ffill_scratch_bytes")
    if one_pass:
        lib.fmk_ffill_scratch_bytes.argtypes = [I64]
        lib.fmk_ffill_scratch_bytes.restype = I64
    lib.fmk_event_scratch_bytes.argtypes = [Int, I64, I64, I64]
    lib.fmk_event_scratch_bytes.restype = I64
    lib.fmk_event_scan.argtypes = [Int, P, P, P, P, I64, I64, F64, F64, F64, F64, I64, P,
                                   I64, P, I64, P, P, P]
    scratch = {}

    def buffer(key, nbytes):
        if scratch.get(key) is None or scratch[key].numel() < nbytes:
            scratch[key] = torch.empty(max(nbytes, 1), dtype=torch.uint8, device="cuda")
        return scratch[key]

    def fill(values, valid, zero_before):
        n = values.shape[0]
        nbytes = lib.fmk_ffill_scratch_bytes(n) if one_pass else 8 * (-(-n // 2048))
        out = torch.empty_like(values)
        rc = lib.fmk_ffill(values.element_size(), values.data_ptr(), valid.data_ptr(),
                           out.data_ptr(), buffer("f", nbytes).data_ptr(), n,
                           int(zero_before), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kernel F from {src_dir}: CUDA error {rc}")
        return out

    def cusum(rets, lam, cc, start, chunks):
        n = rets.shape[0]
        out = torch.empty(n, dtype=torch.int64, device="cuda")
        count = torch.empty(1, dtype=torch.int64, device="cuda")
        sc = buffer("e", lib.fmk_event_scratch_bytes(0, n, start + 1, chunks))
        rc = lib.fmk_event_scan(0, rets.data_ptr(), lam.data_ptr(), cc.data_ptr(), None,
                                n, start + 1, 0.0, 0.0, 0.0, 0.0, 0, sc.data_ptr(), chunks,
                                out.data_ptr(), n, count.data_ptr(), None,
                                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kernel E from {src_dir}: CUDA error {rc}")
        return out, count
    return fill, cusum, ptxas_summary(
        log, r"ffill_kernel\w*|tile_last_kernel|scan_tiles_max_kernel|fill_tiles_kernel\w*"
             r"|summary_kernel\w*|pass\d_kernel\w*|fixup_kernel\w*")


def probe_fe(specs):
    """Kernels F (L1 and K5) and E's CUSUM scan, builds ``specs`` (name ->
    the directory of their sources) in turns on the month."""
    from torch.profiler import ProfilerActivity, profile
    from finmlkit_tpu_torch.bar.indexers import cusum_scan_inputs
    from finmlkit_tpu_torch.ops import event_scan as es
    from finmlkit_tpu_torch.ops import prefix_scan as ps
    from finmlkit_tpu_torch.ops.segment_select import segment_median_pair_select
    card = cs.phase_env()
    builds = {}
    for i, (name, src) in enumerate(specs.items()):
        builds[name] = fe_library(src, OUT / f"fe{i}")
        for fn, what in builds[name][2]:
            cs.say(f"FE {name}: {fn} {what}")
    month = cs.make_month(cs.N_MONTH)
    tr, ts = month["tr"], month["ts"]
    n = tr.ticks.shape[0]
    ci = time_bar_indexer(tr.timestamps, 60.0, ts_first=int(ts[0]),
                          ts_last_i=int(ts[-1]))[1]
    fills = []

    def record(v, m):
        fills.append((v, m))
        return ps.fill_last_plain(v, m)

    segment_median_pair_select(tr.amounts, ci, fill=record)
    sigma = torch.from_numpy(cs.info_sigma(n)).cuda()
    valid = ~torch.isnan(sigma)
    price = torch.from_numpy(month["price"]).cuda()
    rets, lam, cc, fv, _ = cusum_scan_inputs(tr.timestamps, price, sigma,
                                             cs.CUSUM_FLOOR, cs.CUSUM_MULT)
    chunks = es._default_chunks(es._CUSUM, rets.device)
    bits = {4: torch.int32, 8: torch.int64}
    want_l1 = [ps.fill_last_plain(v, m) for v, m in fills]
    want_k5 = ps.fast_ffill_plain(sigma, valid).view(torch.int64)
    want_e = es.cusum_scan_plain(rets, lam, cc, fv, n)
    exact = {}
    for name, (fill, cusum, _) in builds.items():
        ok_l1 = all(torch.equal(fill(v, m, True), w) for (v, m), w in zip(fills, want_l1))
        ok_k5 = torch.equal(fill(sigma, valid, False).view(torch.int64), want_k5)
        out, count = cusum(rets, lam, cc, fv, chunks)
        ok_e = torch.equal(out[:int(count)], want_e)
        exact[name] = dict(l1=ok_l1, k5=ok_k5, e_cusum=ok_e)
    last_v, last_m = fills[-1]
    parts = {"L1, one fill": lambda f, e: f(last_v, last_m, True),
             "L1, the engine's 4 fills": lambda f, e: [f(v, m, True) for v, m in fills],
             "K5, the sigma": lambda f, e: f(sigma, valid, False),
             "E cusum": lambda f, e: e(rets, lam, cc, fv, chunks)}
    reps = {"E cusum": 5}
    times = {(name, part): [] for name in builds for part in parts}
    for _ in range(3):   # in turns
        for name, (fill, cusum, _) in builds.items():
            for part, f in parts.items():
                times[(name, part)].append(
                    cs.cuda_ms(lambda: f(fill, cusum), reps=reps.get(part, 20)))
    bounds = {"L1, one fill": cs.bound(9 * n, n)[0],
              "L1, the engine's 4 fills": 4 * cs.bound(9 * n, n)[0],
              "K5, the sigma": cs.bound(17 * n, n)[0],
              "E cusum": cs.bound(17 * n + 8 * len(want_e), 10 * n)[0]}
    for name in builds:
        cs.say(f"FE {name}: == plain {exact[name]}; ms in 3 turns, " + "; ".join(
            f"{part} " + " ".join(f"{t:.4f}" for t in times[(name, part)])
            + f" (bound {bounds[part]:.4f})" for part in parts) + f" [{card}]")
    OUT.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fill, _, _ in builds.values():
            for _ in range(5):
                fill(last_v, last_m, True)
                fill(sigma, valid, False)
        torch.cuda.synchronize()
        for _, cusum, _ in builds.values():   # E's scans, build after build
            for _ in range(5):
                cusum(rets, lam, cc, fv, chunks)
            torch.cuda.synchronize()
    path = OUT / "fe_trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memset")]
    e_events = sorted((e for e in events if re.search(
        r"summary_kernel|pass\d_kernel|fixup_kernel|scatter_kernel|one_pass_kernel", e["name"])),
        key=lambda e: e["ts"])
    per = len(e_events) // len(builds)   # the builds launch alike, in order
    for i, name in enumerate(builds):
        by = {}
        for e in e_events[i * per:(i + 1) * per]:
            key = re.search(r"(summary_kernel|pass\d_kernel|fixup_kernel|scatter_kernel|"
                            r"one_pass_kernel)", e["name"]).group(1)
            by[key] = by.get(key, 0.0) + e.get("dur", 0) / 1e3 / 5
        cs.say(f"traced E cusum, {name}, device ms a scan by kernel: "
               + ", ".join(f"{k} {v:.4f}" for k, v in by.items()) + f" [{card}]")
    rows = {}
    for e in events:
        if re.search(r"summary_kernel|pass\d_kernel|fixup_kernel|scatter_kernel|"
                     r"one_pass_kernel", e["name"]):
            continue
        key = re.sub(r"\(anonymous namespace\)::", "", e["name"])[:70]
        r = rows.setdefault(key, dict(ms=0.0, launches=0))
        r["ms"] += e.get("dur", 0) / 1e3
        r["launches"] += 1
        for k in ("registers per thread", "est. achieved occupancy %", "grid"):
            if k in e.get("args", {}):
                r[k] = e["args"][k]
    cs.say("traced, 5 L1 and 5 K5 fills of each build (total device ms and count by "
           "kernel): " + json.dumps(rows) + f" [{card}]")
    # the package's wrappers (checks, allocations, the launch) on the same
    # fills: device ms from CUDA events at 5 and 20 calls, and host us a call
    wrapped = {"L1 through fill_last": lambda: ps.fill_last(last_v, last_m),
               "K5 through fast_ffill": lambda: ps.fast_ffill(sigma, valid)}
    host_us = {}
    for key, f in wrapped.items():
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            f()
        host_us[key] = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
    wrapped_ms = {key: [cs.cuda_ms(f, reps=r) for r in (5, 20)] for key, f in wrapped.items()}
    cs.say("the wrappers: ms a call at 5 and 20 calls, host us a call: " + "; ".join(
        f"{k} {wrapped_ms[k][0]:.4f} {wrapped_ms[k][1]:.4f}, host {host_us[k]:.1f} us"
        for k in wrapped) + f" [{card}]")
    cs.say(json.dumps({"card": card, "exact": exact, "bounds_ms": bounds,
                       "wrapped_ms": wrapped_ms, "wrapper_host_us": host_us,
                       "ms": {name: {part: times[(name, part)] for part in parts}
                              for name in builds}}))


RW_KERNELS = r"tile_maps_kernel|tile_ends_kernel|scan_tiles_kernel|csw_kernel"
W_VARIANTS = {
    "as built": [],
    # an ablation: the quotient taken as a product (wrong values), to weigh
    # the float64 division against the rest of the loop
    "no division": [_sub(r"__ddiv_rn\(fabs\(dyn\), denom\)", "__dmul_rn(fabs(dyn), denom)")],
}


def w_library(out_dir, edits):
    """Kernel W (``csrc/csw.cu`` with ``edits``) built alone; returns its C
    entry and ptxas's report."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "csw.cu").read_text()
    for edit in edits:
        src = edit(src)
    (out_dir / "csw.cu").write_text(src)
    log = nvcc(out_dir, out_dir / "lib.so")
    lib = ctypes.CDLL(str(out_dir / "lib.so"))
    P, I64 = ctypes.c_void_p, ctypes.c_longlong
    lib.fmk_csw_sup_stat.argtypes = [P, P, P, P, I64, I64, P, P, P, P, P]
    return lib.fmk_csw_sup_stat, ptxas_summary(log, RW_KERNELS)


def trace_r(card, what, a, b):
    """One kernel R call's passes under torch.profiler (5 calls traced)."""
    from torch.profiler import ProfilerActivity, profile
    from finmlkit_tpu_torch.ops import scan
    scan.linear_recurrence(a, b)
    torch.cuda.synchronize()
    path = OUT / f"r_trace_{re.sub(r'[^a-z0-9]+', '_', what)}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            scan.linear_recurrence(a, b)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    rows = {k: dict(v, ms=v["ms"] / 5, launches=v["launches"] // 5)
            for k, v in kernel_args(path).items()}
    call = cs.cuda_ms(lambda: scan.linear_recurrence(a, b), reps=20)
    cs.say(f"R, {what}: " + ", ".join(
        f"{k} {v['ms']:.4f} ms ({v.get('registers per thread')} registers, est. "
        f"occupancy {v.get('est. achieved occupancy %')}%)" for k, v in rows.items())
        + f"; the call {call:.4f} ms (CUDA events, 20 calls) [{card}]")
    return dict(rows, call_ms=call)


def probe_rw(names):
    """Kernel R's passes traced at the month's trade count and on the month's
    bars; kernel W's builds ``names`` timed in turns on the month's bars at
    window 1000 and on 50,000 log prices at window 500."""
    from finmlkit_tpu_torch.feature.kernels import structural_break as sb
    card = cs.phase_env()
    bars = cs.month_bars(cs.make_month(cs.N_MONTH))
    nb = bars["close"].shape[0]
    g = torch.Generator(device="cuda").manual_seed(11)
    n = cs.N_MONTH
    b = 107_000.0 * torch.exp(torch.cumsum(
        torch.randn(n, dtype=torch.float64, device="cuda", generator=g) * 2e-5, 0))
    a = torch.exp(-torch.rand(n, dtype=torch.float64, device="cuda", generator=g) * 0.14 / 60.0)
    traced = {f"constant a, n={n}": trace_r(card, f"constant a, n={n}", 1.0 - 2.0 / 101.0, b),
              f"varying a, n={n}": trace_r(card, f"varying a, n={n}", a, b),
              f"the month's {nb} bars": trace_r(card, f"the month's {nb} bars",
                                                1.0 - 2.0 / 21.0, bars["close"])}
    del a, b

    builds = {name: w_library(OUT / f"w{i}", W_VARIANTS[name]) for i, name in enumerate(names)}
    for name, (_, regs) in builds.items():
        cs.say(f"W {name}: " + "; ".join(f"{k} {v}" for k, v in regs))
    r = np.random.default_rng(12)
    walk = torch.from_numpy(100.0 * np.exp(np.cumsum(r.normal(0.0, 1e-3, 50_000)))).cuda()
    shapes = {f"the month's {nb:,} bars, window {cs.CSW_WINDOW}": (bars["close"], cs.CSW_WINDOW),
              "50,000 log prices, window 500": (walk, 500)}
    times, exact = {}, {}
    for shape, (p, w) in shapes.items():
        y = torch.log(p)
        _, sigma = sb._sigma(y, w)
        sqrt_k, crit = sb._tables(w, y.device)
        want = sb._sup_stat_plain(y, sigma, w, sqrt_k, crit)
        out = [torch.empty_like(y) for _ in range(4)]
        for turn in range(4):
            order = list(builds) if turn % 2 == 0 else list(reversed(builds))
            for name in order:
                fn = builds[name][0]

                def run():
                    rc = fn(y.data_ptr(), sigma.data_ptr(), sqrt_k.data_ptr(), crit.data_ptr(),
                            y.shape[0], w, *(o.data_ptr() for o in out),
                            torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"W {name}: CUDA error {rc}")
                times.setdefault(f"{shape} | {name}", []).append(cs.cuda_ms(run, reps=20))
                exact[f"{shape} | {name}"] = all(
                    bool(((o == v) | (torch.isnan(o) & torch.isnan(v))).all())
                    for o, v in zip(out, want))
        cs.say(f"W on {shape} (4 turns): " + ", ".join(
            f"{name} {min(times[f'{shape} | {name}']):.4f}-{max(times[f'{shape} | {name}']):.4f} ms"
            + ("" if exact[f"{shape} | {name}"] else " (ablation: values differ)")
            for name in builds) + f" [{card}]")
    cs.say(json.dumps({"card": card, "r_traced": traced, "w_ms": times, "w_exact": exact}))


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "RW":
        if not torch.cuda.is_available():
            cs.fail("no CUDA device")
        return probe_rw(sys.argv[2].split(",") if len(sys.argv) > 2 else list(W_VARIANTS))
    if len(sys.argv) > 1 and sys.argv[1] == "FE":
        if not torch.cuda.is_available():
            cs.fail("no CUDA device")
        specs = {}
        for spec in (sys.argv[2].split(",") if len(sys.argv) > 2 else ["as built"]):
            name, _, src = spec.partition("=")
            specs[name] = ROOT / src / "finmlkit_tpu_torch" / "csrc" if src else CSRC
        return probe_fe(specs)
    if len(sys.argv) > 1 and sys.argv[1] == "EH":
        if not torch.cuda.is_available():
            cs.fail("no CUDA device")
        probe_eh()
        specs = {}
        for spec in (sys.argv[2].split(",") if len(sys.argv) > 2 else ["as built"]):
            name, _, src = spec.partition("=")
            specs[name] = (ROOT / src, ()) if src else (CSRC, H_VARIANTS[name])
        return probe_h(specs)
    if len(sys.argv) > 1 and sys.argv[1] == "B":
        if not torch.cuda.is_available():
            cs.fail("no CUDA device")
        specs = {}
        for spec in (sys.argv[2].split(",") if len(sys.argv) > 2 else ["as built"]):
            name, _, src = spec.partition("=")
            specs[name] = (ROOT / src, ()) if src else (CSRC, B_VARIANTS[name])
        return probe_b(specs)
    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(V_VARIANTS)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    card = cs.phase_env()
    libs = {}
    for i, name in enumerate(names):
        d = OUT / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        src = (CSRC / "bar_planes.cu").read_text()
        for edit in V_VARIANTS[name]:
            src = edit(src)
        (d / "bar_planes.cu").write_text(src)
        (d / "bar_scan.cuh").write_text((CSRC / "bar_scan.cuh").read_text())
        for fn, what in ptxas_summary(nvcc(d, d / "lib.so")):
            cs.say(f"{name}: {fn} {what}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.fmk_planes_scratch_bytes.argtypes = [ctypes.c_longlong]
        lib.fmk_planes_scratch_bytes.restype = ctypes.c_longlong
        lib.fmk_bar_planes.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                                       + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])
        libs[name] = lib
    (OUT / "p3").mkdir(parents=True, exist_ok=True)
    (OUT / "p3" / "p3.cu").write_text(P3_GRID_STRIDE)
    nvcc(OUT / "p3", OUT / "p3" / "lib.so")
    p3 = ctypes.CDLL(str(OUT / "p3" / "lib.so"))
    p3.p3_grid_stride.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                  ctypes.c_void_p]

    month = cs.make_month(cs.N_MONTH)
    tr, ts = month["tr"], month["ts"]
    ci = time_bar_indexer(tr.timestamps, 60.0, ts_first=int(ts[0]),
                          ts_last_i=int(ts[-1]))[1]
    args = fs._cuda_inputs(tr.ticks, tr.units, tr.sides, ci, "variants")
    n, nb = tr.ticks.shape[0], ci.shape[0] - 1
    want = fs.bar_scan_planes_plain(*args)
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        outs = fs._planes_buffers(n, "cuda")[:4]
        for o in outs:   # no earlier variant's result may pass for this one's
            o.view(torch.uint8).fill_(0xA5)
        scratch = torch.empty(lib.fmk_planes_scratch_bytes(n), dtype=torch.uint8,
                              device="cuda")
        ptrs = [a.data_ptr() for a in args] + [n, nb] + [o.data_ptr() for o in outs]

        def run(passes=(1 << len(fs.PLANES_PASSES)) - 1):
            rc = lib.fmk_bar_planes(*ptrs, scratch.data_ptr(), passes, stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        run()
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(outs, want))
        total = cs.cuda_ms(run, reps=10)
        passes = [cs.cuda_ms(lambda p=p: run(1 << p), reps=10)
                  for p in range(len(fs.PLANES_PASSES))]
        cs.say(f"V {name}: planes == plain {exact}; all passes {total:.3f} ms; "
               + ", ".join(f"{k} {t:.3f}" for k, t in zip(fs.PLANES_PASSES, passes))
               + f" [{card}]")
        del outs, scratch
    del want

    x = torch.randint(-2**31, 2**31 - 1, (8, n), dtype=torch.int32, device="cuda")
    out = torch.empty(n, dtype=torch.int32, device="cuda")
    p3.p3_grid_stride(x.data_ptr(), n, out.data_ptr(), stream)
    head = 4 * (n // 4)
    ok = torch.equal(out[:head], torch.sum(x[:, :head], 0, dtype=torch.int32))
    times = {}
    for _ in range(3):   # in turns
        for key, fn in (("torch.sum(x, 0)", lambda: torch.sum(x, 0, dtype=torch.int32)),
                        ("P3, one int4 a thread", lambda: fs.bar_scan_io_floor_stacked(x)),
                        ("P3 loads in a grid-stride loop",
                         lambda: p3.p3_grid_stride(x.data_ptr(), n, out.data_ptr(), stream))):
            times.setdefault(key, []).append(cs.cuda_ms(fn, reps=20))
    cs.say(f"P3 on (8, {n:,}) int32 (grid-stride == torch.sum {ok}), ms in 3 turns: "
           + "; ".join(f"{k} " + " ".join(f"{t:.4f}" for t in v) for k, v in times.items())
           + f" [{card}]")


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
