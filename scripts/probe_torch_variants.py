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

``python3 scripts/probe_torch_variants.py RW [names]`` probes kernels R
(``csrc/recurrence.cu``) and W (``csrc/csw.cu``): "as built", each variant of
``RW_VARIANTS`` named (edits of the package's ``csw.cu`` and
``recurrence.cu``; those of ``ABLATIONS``, such as "without pass 2" and "R
without look-back", compute other values)
and each ``name=dir`` whose directory holds another checkout's
``finmlkit_tpu_torch`` (a ``git archive`` of the parent commit unpacked under
``build/``), each built by its own ``nvcc`` and called through its C entry
points as the package's wrappers call them. Each build is held to the plain
versions (R within rtol 1e-12 and equal run to run, W bit for bit), then
timed in four turns: R at the month's trade count with a constant and a
time-varying decay and on the month's one-minute bars, W on the month's bars
at window 1000, 50,000 log prices and a flat series at window 500. Then R's
look-back distances and W's pass-2 shares where a build reports them, a call
of R on the bars in wall and host time, and one ``torch.profiler`` trace of
each build (device time, registers, estimated occupancy). The last line is
one JSON object.

``python3 scripts/probe_torch_variants.py G [names]`` probes kernel G
(``csrc/volume_profile.cu``) on ``chip_smoke.py`` phase 10's inputs: the
month's dollar bars' footprints with VolumePro's 600 s window, and the last
day's developing grid. It prints the windows' level spans (percentiles of
``max_j(low_j + n_levels_j) - min_j low_j``, clipped to ``max_levels``) and
the rows' spans, and the value-area walk's step counts (all steps, steps that
move both sides, both-steps at zero pairs, levels crossed) on 2,048 bars drawn
with a seed and on every row, without bins and at 27 bins. Then each build
named, "as built" and each variant of ``G_VARIANTS`` (edits of a source; some
are ablations whose outputs are wrong), or ``name=dir`` for another
checkout's ``volume_profile.cu`` (a ``git archive`` of the parent commit
unpacked under ``build/``; a name of ``G_VARIANTS`` before ``=`` applies that
variant's edits to it), is built by its own ``nvcc``, held to the plain version
on the first 2,048 bars and to the first build on every bar, timed in four
turns (rolling at 27 bins and without, rows mode at both) and traced once under
``torch.profiler`` (registers, blocks an SM, estimated occupancy). The last
line is one JSON object of the times.
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


RW_KERNELS = r"tile_maps_kernel|tile_ends_kernel|scan_tiles_kernel|recurrence_kernel\w*|csw_kernel"
# variants of kernels W and R: edits of csrc/csw.cu and csrc/recurrence.cu
# built beside the named builds; name -> (csw.cu edits, recurrence.cu edits)
RW_VARIANTS = {
    # ablations of W (values differ): pass 2 skipped (only the best lags'
    # offers and (0, kmax) reach the sides), and pass 1 alone (no division, no
    # pass 2, no merge), to weigh the parts
    "without pass 2": ([_sub(r"  while \(lanes\) \{", "  while (lanes && sig < 0.0) {")], []),
    "pass 1 alone": ([_sub(r"  if \(__any_sync\(kFull, bad\)\) \{  // the exact path",
                           "  if (sig > -1.0) return pu > 1e300 || pd < -1e300 || ku > 0x7ffffff0"
                           " || kd > 0x7ffffff0;\n  if (__any_sync(kFull, bad)) {")], []),
    # a mutation of W: T = L, without the step to the double below (values
    # differ: the filter series show it)
    "W without the ulp step": ([_sub(r"const double tu = pred\(lu\), td = pred\(ld\);",
                                     "const double tu = lu, td = ld;")], []),
    # a kernel that returns at once: what CUDA events read for a call whose
    # device time is below the probe's host time a call
    "W empty": ([_sub(r"  const int lane = threadIdx.x & 31;\n  const int kmax",
                      "  if (n > 0) return;\n  const int lane = threadIdx.x & 31;\n"
                      "  const int kmax")], []),
    # W with 5 or 6 blocks an SM asked of the register allocator, not 4
    # (values equal)
    "W 5 blocks": ([_sub(r"__launch_bounds__\(kThreads, 4\)\ncsw_kernel",
                         "__launch_bounds__(kThreads, 5)\ncsw_kernel")], []),
    "W 6 blocks": ([_sub(r"__launch_bounds__\(kThreads, 4\)\ncsw_kernel",
                         "__launch_bounds__(kThreads, 6)\ncsw_kernel")], []),
    # R with tiles of 2048 and of 4096 where a is a constant or one a row, not
    # 8192 (values equal)
    "R tiles of 2048": ([], [_sub(r"return form == kElem \? 8 : 32;", "return 8;")]),
    "R tiles of 4096": ([], [_sub(r"return form == kElem \? 8 : 32;",
                                  "return form == kElem ? 8 : 16;")]),
    # R polling without the sleep between polls (values equal)
    "R no back-off": ([], [_sub(r"  __nanosleep\(ns\);\n", "")]),
    # an ablation of R (values differ): no look-back, every carry 0, to weigh
    # the look-back against the tile's own loads, scans and writes
    "R without look-back": ([], [_sub(
        r"const double carry = look_back\(lb, g, r, grp, row \* groups_of\(tiles\) \+ grp, "
        r"total, &walked\);", "const double carry = 0.0;")]),
}
# the variants whose values differ from the plain versions'
ABLATIONS = {"without pass 2", "pass 1 alone", "W without the ulp step", "W empty",
             "R without look-back"}


def rw_library(src_dir, out_dir, edits=((), ())):
    """Kernels R and W from ``src_dir`` (with ``edits``, a pair of lists for
    ``csw.cu`` and ``recurrence.cu``) built alone; returns
    ``(r, w, ptxas report)``: ``r(a, b, dist=None)`` and ``w(y, sigma, w,
    stats=None)`` on CUDA tensors, each as the package's wrapper calls it (the
    output and scratch from ``torch.empty``). An earlier source (R's three
    launches, W without its filter table) is called with its own arguments."""
    from finmlkit_tpu_torch.feature.kernels import structural_break as sb
    out_dir.mkdir(parents=True, exist_ok=True)
    csw = (Path(src_dir) / "csw.cu").read_text()
    for edit in edits[0]:
        csw = edit(csw)
    (out_dir / "csw.cu").write_text(csw)
    rec = (Path(src_dir) / "recurrence.cu").read_text()
    for edit in edits[1]:
        rec = edit(rec)
    (out_dir / "recurrence.cu").write_text(rec)
    log = nvcc(out_dir, out_dir / "lib.so")
    lib = ctypes.CDLL(str(out_dir / "lib.so"))
    P, I64, F64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double, ctypes.c_int
    filtered, one_pass = "isq" in csw, "look_back" in rec
    lib.fmk_csw_sup_stat.argtypes = ([P] * 5 + [I64, I64] + [P] * 6 if filtered
                                     else [P] * 4 + [I64, I64] + [P] * 5)
    lib.fmk_recurrence_scratch_bytes.argtypes = [I64, I64]
    lib.fmk_recurrence_scratch_bytes.restype = I64
    lib.fmk_linear_recurrence.argtypes = [P, F64, I64, I32, P, P, P, P, I64, I64] + (
        [P, P] if one_pass else [P])

    def r(a, b, dist=None):
        n = b.shape[-1]
        out = torch.empty_like(b)
        scratch = torch.empty(lib.fmk_recurrence_scratch_bytes(1, n), dtype=torch.uint8,
                              device="cuda")
        const = not torch.is_tensor(a)
        args = [None if const else a.data_ptr(), float(a) if const else 0.0, 0,
                0 if const else 1, b.data_ptr(), None, out.data_ptr(), scratch.data_ptr(),
                1, n] + ([None if dist is None else dist.data_ptr()] if one_pass else [])
        rc = lib.fmk_linear_recurrence(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kernel R from {src_dir}: CUDA error {rc}")
        return out

    def w(y, sigma, win, stats=None):
        sqrt_k, crit = sb._tables(win, y.device)
        out = [torch.empty_like(y) for _ in range(4)]
        ptrs = [y.data_ptr(), sigma.data_ptr(), sqrt_k.data_ptr()]
        if filtered:
            ptrs.append(sb._all_tables(win, sb._device_key(y.device))[2].data_ptr())
        ptrs += [crit.data_ptr(), y.shape[0], win, *(o.data_ptr() for o in out)]
        if filtered:
            ptrs.append(None if stats is None else stats.data_ptr())
        rc = lib.fmk_csw_sup_stat(*ptrs, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kernel W from {src_dir}: CUDA error {rc}")
        return out
    return r, w, ptxas_summary(log, RW_KERNELS)


def probe_rw(specs):
    """Kernels R and W of the builds ``specs`` (name -> (source dir, W
    edits)) in turns: R at the month's trade count with a constant and a
    time-varying decay and on the month's one-minute bars (a call's wall and
    host time there too), W on the month's bars at window 1000, 50,000 log
    prices and the flat series at 500; the look-back distances and W's pass-2
    shares of the builds that report them; one ``torch.profiler`` trace of
    each build's R and W (device time, registers, occupancy)."""
    from torch.profiler import ProfilerActivity, profile
    from finmlkit_tpu_torch.feature.kernels import structural_break as sb
    from finmlkit_tpu_torch.ops import scan
    card = cs.phase_env()
    builds = {}
    for i, (name, (src, edits)) in enumerate(specs.items()):
        builds[name] = rw_library(src, OUT / f"rw{i}", edits)
        for fn, what in builds[name][2]:
            cs.say(f"RW {name}: {fn} {what}")
    bars = cs.month_bars(cs.make_month(cs.N_MONTH))
    nb = bars["close"].shape[0]
    g = torch.Generator(device="cuda").manual_seed(11)
    n = cs.N_MONTH
    b = 107_000.0 * torch.exp(torch.cumsum(
        torch.randn(n, dtype=torch.float64, device="cuda", generator=g) * 2e-5, 0))
    a = torch.exp(-torch.rand(n, dtype=torch.float64, device="cuda", generator=g) * 0.14 / 60.0)
    r_in = {f"varying a, n={n}": (a, (1.0 - a) * b), f"constant a, n={n}": (1.0 - 2.0 / 101.0, b),
            f"the month's {nb:,} bars": (1.0 - 2.0 / 21.0, bars["close"])}
    r_bound = {k: cs.bound((24 if torch.is_tensor(aa) else 16) * bb.shape[0], 2 * bb.shape[0],
                           cs.PEAK_F64_OPS_PER_S)[0] for k, (aa, bb) in r_in.items()}
    w_in = cs.w_series(bars)
    w_args = {}
    for k, (prices, win) in w_in.items():
        y = torch.log(prices)
        w_args[k] = (y, sb._sigma(y, win)[1], win)
    # every build held to the plain versions first
    close, exact, dists, shares = {}, {}, {}, {}
    for k, (aa, bb) in r_in.items():
        want = scan.linear_recurrence_plain(aa, bb)
        mag = float(want.abs().max())
        for name, (r, _, _) in builds.items():
            got = r(aa, bb)
            close[f"{k} | {name}"] = float(((got - want).abs() / (want.abs() + mag)).max())
            if name not in ABLATIONS and not close[f"{k} | {name}"] <= 1e-12:
                cs.fail(f"R {name} on {k}: {close[f'{k} | {name}']} above 1e-12 of plain")
            if name not in ABLATIONS and not torch.equal(r(aa, bb), got):
                cs.fail(f"R {name} on {k}: not equal from run to run")
            if "look_back" in (Path(specs[name][0]) / "recurrence.cu").read_text():
                d = torch.zeros(-(-bb.shape[0] // scan.tile_of(aa, bb.shape[0])),
                                dtype=torch.int32, device="cuda")
                r(aa, bb, d)
                d = d[1:].double()
                dists[f"{k} | {name}"] = (float(d.median()) if d.numel() else 0.0,
                                          float(d.max()) if d.numel() else 0.0)
    for k, (y, sigma, win) in w_args.items():
        want = sb._sup_stat_plain(y, sigma, win, *sb._tables(win, y.device))
        for name, (_, w, _) in builds.items():
            stats = torch.zeros(y.shape[0], 4, dtype=torch.int32, device="cuda")
            got = w(y, sigma, win, stats)
            exact[f"{k} | {name}"] = all(
                bool(((o == v) | (torch.isnan(o) & torch.isnan(v))).all())
                for o, v in zip(got, want))
            if "isq" in (Path(specs[name][0]) / "csw.cu").read_text():
                shares[f"{k} | {name}"] = cs.w_shares(stats)
    # W on the filter's adversarial series (testing.csw_filter_case), bit for bit
    from finmlkit_tpu_torch.testing import CSW_FILTER_CASES, csw_filter_case
    series_fail = {name: [] for name in builds}
    for case in CSW_FILTER_CASES:
        yn, sn, win = csw_filter_case(case)
        y, sigma = torch.from_numpy(yn).cuda(), torch.from_numpy(sn).cuda()
        want = sb._sup_stat_plain(y, sigma, win, *sb._tables(win, y.device))
        for name, (_, w, _) in builds.items():
            got = w(y, sigma, win)
            if not all(bool(((o == v) | (torch.isnan(o) & torch.isnan(v))).all())
                       for o, v in zip(got, want)):
                series_fail[name].append(case)
    cs.say("W on the filter series, the cases that differ from plain by build: "
           + json.dumps(series_fail))
    cs.say("R within rtol 1e-12 of plain (largest |diff| / (|want| + magnitude)): "
           + json.dumps(close) + "; look-back tiles (median, largest): " + json.dumps(dists))
    cs.say("W == plain bit for bit: " + json.dumps(exact) + "; pass-2 shares: "
           + json.dumps(shares))
    # in turns: parent, change, change, parent, ...
    times = {}
    for turn in range(4):
        order = list(builds) if turn % 2 == 0 else list(reversed(builds))
        for name in order:
            r, w, _ = builds[name]
            for k, (aa, bb) in r_in.items():
                times.setdefault(f"R {k} | {name}", []).append(
                    cs.cuda_ms(lambda: r(aa, bb), reps=20 if bb.shape[0] > 10**6 else 200))
            for k, (y, sigma, win) in w_args.items():
                times.setdefault(f"W {k} | {name}", []).append(
                    cs.cuda_ms(lambda: w(y, sigma, win), reps=20))
    for key, v in times.items():
        cs.say(f"{key}: {min(v):.4f}-{max(v):.4f} ms in 4 turns [{card}]")
    # a call on the bars through each build as the wrapper calls it: wall time
    # (each call synchronized) and host time (200 calls enqueued)
    aa, bb = r_in[f"the month's {nb:,} bars"]
    call_us = {}
    for turn in range(2):
        for name in (list(builds) if turn == 0 else list(reversed(builds))):
            r = builds[name][0]
            r(aa, bb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                r(aa, bb)
            host = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                r(aa, bb)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 200 * 1e6
            call_us.setdefault(name, []).append({"wall": wall, "host": host})
    cs.say("R on the bars, us a call (wall, host) in 2 turns: " + json.dumps(call_us)
           + f" [{card}]")
    # one trace of each build's R (varying a at the month's count) and W (the month's bars)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "rw_trace.json"
    ra, rb = r_in[f"varying a, n={n}"]
    wy, ws, ww = w_args[next(k for k in w_args if k.startswith("the month"))]
    rows = {}
    for name, (r, w, _) in builds.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                r(ra, rb)
                w(wy, ws, ww)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        rows[name] = {k: dict(v, ms=v["ms"] / 5) for k, v in kernel_args(path).items()}
    cs.say("traced, a call of R (varying a, the month's count) and W (the month's bars) of "
           "each build (device ms, registers, occupancy by kernel): "
           + json.dumps(rows) + f" [{card}]")
    cs.say(json.dumps({"card": card, "ms": times, "bounds_ms": r_bound, "r_close": close,
                       "w_filter_series_differ": series_fail,
                       "r_lookback_tiles": dists, "w_exact": exact, "w_pass2": shares,
                       "r_bars_call_us": call_us, "traced": rows}))


G_KERNELS = r"profile_kernel\w*"
# ablations (outputs wrong): the package's kernel G cut after a step ...
G_FILL = _sub(r"  Labels lab\{false, lo, 0, 0, 1, 0\};\n  if \(a\.n_bins > 0\) \{",
              "  Labels lab{false, lo, 0, 0, 1, 0};\n  if (a.va_frac > -1.0) return;\n"
              "  if (a.n_bins > 0) {")
G_BINS = _sub(r"  // ablation anchor: the reductions\n",
              "  if (a.va_frac > -1.0) return;\n")
G_WALK = _sub(r"  const Walk w = walks\[o\];  // ablation anchor: the walk\n",
              "  const Walk w = walks[o];\n"
              "  if (w.thr > -1e308) {\n    hva[o] = lva[o] = w.lab.at(w.pidx);\n    return;\n  }\n")
# ... and the same cuts of the earlier kernel G (a block a profile over all its levels)
G_PARENT_FILL = _sub(r"  Labels lab\{false, lo, 0, 0, 1, 0\};\n  if \(a\.n_bins > 0\) \{",
                     "  Labels lab{false, lo, 0, 0, 1, 0};\n  if (a.va_frac > -1.0) return;\n"
                     "  if (a.n_bins > 0) {")
G_PARENT_BINS = _sub(r"  // total, and the POC \(first of equal maxima\)\n",
                     "  if (a.va_frac > -1.0) return;\n")
G_PARENT_WALK = _sub(r"    while \(cum < thr\) \{", "    while (cum < thr && a.va_frac < -1.0) {")
G_BLOCKS = r"constexpr int kBlocksPerSM = 6;"
G_VARIANTS = {
    "as built": [],
    "walk without prefetch": [_sub(r"if \(k \+ kAhead >= upf && upf < nu\)", "if (false)"),
                              _sub(r"if \(k \+ kAhead >= dpf && dpf < nd\)", "if (false)")],
    "walk prefetching 16 ahead": [_sub(r"constexpr int kAhead = 32;", "constexpr int kAhead = 16;")],
    "walk prefetching 64 ahead": [_sub(r"constexpr int kAhead = 32;", "constexpr int kAhead = 64;")],
    "walk prefetching into L2": [_sub(r"prefetch\.global\.L1", "prefetch.global.L2")],
    "registers for 4 blocks an SM": [_sub(G_BLOCKS, "constexpr int kBlocksPerSM = 4;")],
    "registers for 5 blocks an SM": [_sub(G_BLOCKS, "constexpr int kBlocksPerSM = 5;")],
    "fill alone": [G_FILL, G_WALK],    # no record is written: kernel B must not walk
    "fill alone on buy only": [G_FILL, G_WALK, _sub(
        r"g\[off \+ c\] = g\[off \+ c\] \+ \(static_cast<double>\(b\[c\]\) \+ static_cast<double>\(q\[c\]\)\);",
        "g[off + c] = g[off + c] + static_cast<double>(b[c]);")],
    "fill alone without loads": [G_FILL, G_WALK, _sub(
        r"g\[off \+ c\] = g\[off \+ c\] \+ \(static_cast<double>\(b\[c\]\) \+ static_cast<double>\(q\[c\]\)\);",
        "g[off + c] = g[off + c] + 1.0;")],
    "fill and bins": [G_BINS, G_WALK],
    "without the walk": [G_WALK],
    "parent fill alone": [G_PARENT_FILL],
    "parent fill and bins": [G_PARENT_BINS],
    "parent without the walk": [G_PARENT_WALK],
}
G_SAMPLE = 2048     # bars of the walk's statistics, and of the check against plain


def g_library(src_dir, out_dir, edits):
    """Kernel G from ``src_dir`` (with ``edits``) built alone; returns
    ``(rolling, rows, ptxas report)``, each call as ``volume._rolling`` and
    ``volume._profile_rows`` take it. A source without a walk kernel (the
    earlier kernel G, a block a profile over all its levels) is launched as
    its own wrapper launched it."""
    from finmlkit_tpu_torch.feature.kernels import volume
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (Path(src_dir) / "volume_profile.cu").read_text()
    for edit in edits:
        src = edit(src)
    (out_dir / "volume_profile.cu").write_text(src)
    log = nvcc(out_dir, out_dir / "lib.so")
    lib = ctypes.CDLL(str(out_dir / "lib.so"))
    lib.fmk_profile_shared_levels.argtypes = []
    lib.fmk_profile_shared_levels.restype = ctypes.c_longlong
    listed = "fmk_profile_walk" in src
    P, I64, I32, F64 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
    if listed:   # the package's signatures
        for name, types in _build._SIGNATURES.items():
            if "profile" in name:
                getattr(lib, name).argtypes = types
                getattr(lib, name).restype = I64 if name in _build._SIZES else I32
    else:
        lib.fmk_volume_profile_rolling.argtypes = [P] * 5 + [I64] * 4 + [I32, F64, I32, I64] \
            + [P] * 6
        lib.fmk_volume_profile_rows.argtypes = [P, I64, I64, I64, I32, F64, I32, I64] + [P] * 6
    if listed:
        def rolling(*args):
            return volume._rolling(*args, lib=lib)

        def rows(grid, lo, nb, va):
            return volume._profile_rows(grid, lo, nb, va, lib=lib)
        return rolling, rows, ptxas_summary(log, G_KERNELS)

    def launch(mode, args, n_out, m):
        outs = [torch.zeros(n_out, dtype=torch.int32, device="cuda") for _ in range(3)]
        outs.append(torch.zeros(n_out, dtype=torch.float64, device="cuda"))
        rows_ = args[2] if mode == "rows" else args[7] - args[6]
        shared = m <= lib.fmk_profile_shared_levels()
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        blocks = min(rows_, 1 << 20) if shared else min(rows_, 4 * sms)
        scratch = None if shared else torch.empty(blocks * m, dtype=torch.float64,
                                                  device="cuda")
        rc = getattr(lib, f"fmk_volume_profile_{mode}")(
            *args, int(shared), blocks, None if scratch is None else scratch.data_ptr(),
            *(o.data_ptr() for o in outs), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kernel G from {src_dir}: CUDA error {rc}")
        return tuple(outs)

    def rolling(start, first, low, nl, buy, sell, m, nb, va):
        n, L = buy.shape
        return launch("rolling", (start.data_ptr(), low.data_ptr(), nl.data_ptr(),
                                  buy.data_ptr(), sell.data_ptr(), L, first, n, m,
                                  int(nb or 0), float(va)), n, m)

    def rows(grid, lo, nb, va):
        return launch("rows", (grid.data_ptr(), int(lo), grid.shape[0], grid.shape[1],
                               int(nb or 0), float(va)), grid.shape[0], grid.shape[1])
    return rolling, rows, ptxas_summary(log, G_KERNELS)


def probe_g(specs):
    """Kernel G's builds ``specs`` (name -> source directory and edits) on
    phase 10's inputs."""
    from torch.profiler import ProfilerActivity, profile
    from finmlkit_tpu_torch.feature.kernels import volume
    card = cs.phase_env()
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(specs)) as pool:   # one nvcc a build, all at once
        jobs = {name: pool.submit(g_library, src, OUT / f"g{i}", edits)
                for i, (name, (src, edits)) in enumerate(specs.items())}
    builds = {}
    for name, job in jobs.items():
        try:
            builds[name] = job.result()
        except Exception as e:   # a variant that does not build is reported, not fatal
            cs.say(f"G {name}: does not build: {str(e)[-2000:]}")
            continue
        for fn, what in builds[name][2]:
            cs.say(f"G {name}: {fn} {what}")
    month = cs.make_month(cs.N_MONTH)
    tr, price, amount = month["tr"], month["price"], month["amount"]
    dollar, _ = cs.run_dollar(tr, float((price * amount).sum()) / cs.DOLLAR_BARS)
    fp = dollar["footprints"]
    ts, low, nl, buy, sell = volume._footprint_tensors(
        dollar["close_ts"][1:], fp["low_level"], fp["n_levels"], fp["buy_volumes"],
        fp["sell_volumes"], "cuda")
    del month, dollar, fp
    n, L = buy.shape
    start, first, m = volume._rolling_sizes(ts, low, nl, L, int(cs.PROFILE_WINDOW * 1e9), None)
    va = cs.PROFILE_VA / 100.0
    day_s = int(torch.searchsorted(ts, ts[-1:] - 86_400 * 10**9)[0])
    grid, g_lo = volume._developing_grid(low[day_s:], nl[day_s:], buy[day_s:], sell[day_s:])
    report = {"card": card, "bars": n, "max_levels": m, "rows": list(grid.shape)}

    spans = cs.window_spans(start, first, low, nl, L, m)
    report["window spans"] = cs.quantiles(spans)
    report["share of windows spanning at most"] = {
        str(c): float((spans <= c).to(torch.float64).mean()) for c in (1024, 2048, 4096, 8192)}
    cs.say(f"G: {n - first:,} full windows of {n:,} dollar bars, max_levels {m}: spans "
           f"{report['window spans']}; share at most 1024/2048/4096/8192 levels "
           f"{report['share of windows spanning at most']} [{card}]")
    pick = torch.from_numpy(np.sort(np.random.default_rng(13).choice(
        np.arange(first, n), min(G_SAMPLE, n - first), replace=False))).cuda()
    sample, s_lo = volume._window_grid_plain(pick, start, low, nl, buy, sell, m)
    for nb in cs.PROFILE_BINS:
        for what, (gr, lo_) in {"bars": (sample, s_lo), "rows": (grid, g_lo)}.items():
            st = {k: cs.quantiles(v) for k, v in cs.walk_stats(gr, lo_, nb, va).items()}
            report[f"walk, {what}, bins {nb}"] = st
            cs.say(f"G walk on {gr.shape[0]:,} {what} ({gr.shape[1]:,} levels), bins {nb}: "
                   + "; ".join(f"{k} {v}" for k, v in st.items()) + f" [{card}]")
    del sample

    k = min(n, first + G_SAMPLE)
    plain = {nb: volume.volume_profile_rolling_plain(start[:k], first, low[:k], nl[:k],
                                                     buy[:k], sell[:k], m, nb, va)
             for nb in cs.PROFILE_BINS}
    settings = {f"rolling, bins {nb}": (lambda f, nb=nb: f[0](start, first, low, nl, buy, sell,
                                                             m, nb, va))
                for nb in cs.PROFILE_BINS}
    settings.update({f"rows, bins {nb}": (lambda f, nb=nb: f[1](grid, g_lo, nb, va))
                     for nb in cs.PROFILE_BINS})
    ref, checks = {}, {}
    for name, f in builds.items():
        for key, fn in settings.items():
            out = fn(f)
            torch.cuda.synchronize()
            if key not in ref:
                ref[key] = out
            same = all(torch.equal(a, b) for a, b in zip(out, ref[key]))
            if key.startswith("rolling"):
                nb = None if key.endswith("None") else 27
                same_plain = all(torch.equal(a[:k], b) for a, b in zip(out, plain[nb]))
            else:
                same_plain = None
            checks[f"{key} | {name}"] = {"== first build": same, "== plain": same_plain}
    times = {}
    for turn in range(4):
        order = list(builds) if turn % 2 == 0 else list(reversed(builds))
        for name in order:
            for key, fn in settings.items():
                times.setdefault(f"{key} | {name}", []).append(
                    cs.cuda_ms(lambda: fn(builds[name]), reps=5))
    for key in settings:
        cs.say(f"G {key}, ms in 4 turns (CUDA events, mean of 5 calls each): " + "; ".join(
            f"{name} " + " ".join(f"{t:.4f}" for t in times[f'{key} | {name}'])
            + ("" if checks[f"{key} | {name}"]["== first build"] else " (differs from the "
               "first build)")
            + ("" if checks[f"{key} | {name}"]["== plain"] is not False else " (differs "
               "from plain)") for name in builds) + f" [{card}]")
    # the package's walks by thread and by warp, in turns
    for key, fn in {"rolling, bins None": lambda w: volume._rolling(
            start, first, low, nl, buy, sell, m, None, va, walk_warp=w),
                    "rows, bins None": lambda w: volume._profile_rows(grid, g_lo, None, va,
                                                                      walk_warp=w)}.items():
        outs = {w: fn(w) for w in (False, True)}
        same = all(torch.equal(a, b) for a, b in zip(outs[False], outs[True]))
        for turn in range(3):
            for w in ((False, True) if turn % 2 == 0 else (True, False)):
                times.setdefault(f"{key}, {'warp' if w else 'thread'} walks | package",
                                 []).append(cs.cuda_ms(lambda: fn(w), reps=5))
        cs.say(f"G {key}, the package's build, ms in 3 turns: a thread a walk " + " ".join(
            f"{t:.4f}" for t in times[f"{key}, thread walks | package"]) + "; a warp a walk "
            + " ".join(f"{t:.4f}" for t in times[f"{key}, warp walks | package"])
            + f" (equal: {same}) [{card}]")
    # the package's rolling launches split by span at other first grids, in turns
    splits = (None, 2048, 4096, 6144, 8192)
    for nb in cs.PROFILE_BINS:
        for turn in range(3):
            for sp in (splits if turn % 2 == 0 else splits[::-1]):
                times.setdefault(f"rolling, bins {nb}, split {sp} | package", []).append(
                    cs.cuda_ms(lambda: volume._rolling(start, first, low, nl, buy, sell, m, nb,
                                                       va, split=sp), reps=5))
        cs.say(f"G rolling, bins {nb}, the package's build split at (levels; ms in 3 turns): "
               + "; ".join(f"{sp} " + " ".join(
                   f"{t:.4f}" for t in times[f'rolling, bins {nb}, split {sp} | package'])
                   for sp in splits) + f" [{card}]")
    traced = {}
    for i, (name, f) in enumerate(builds.items()):
        for key in ("rolling, bins 27", "rolling, bins None"):
            settings[key](f)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                settings[key](f)
                torch.cuda.synchronize()
            path = OUT / f"g_trace_{i}_{key.split()[-1]}.json"
            prof.export_chrome_trace(str(path))
            traced[f"{key} | {name}"] = kernel_args(path)
            cs.say(f"G {name}, {key}, traced: " + json.dumps(traced[f"{key} | {name}"]))
    cs.say(json.dumps(dict(report, checks=checks, ms=times, traced=traced)))


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "G":
        if not torch.cuda.is_available():
            cs.fail("no CUDA device")
        specs = {}
        for spec in (sys.argv[2].split(",") if len(sys.argv) > 2 else ["as built"]):
            name, _, src = spec.partition("=")
            d = ROOT / src / "finmlkit_tpu_torch" / "csrc" if src else CSRC
            specs[name] = (d if d.is_dir() else ROOT / src, G_VARIANTS.get(name, []))
        return probe_g(specs)
    if len(sys.argv) > 1 and sys.argv[1] == "RW":
        if not torch.cuda.is_available():
            cs.fail("no CUDA device")
        specs = {}
        for spec in (sys.argv[2].split(",") if len(sys.argv) > 2 else ["as built"]):
            name, _, src = spec.partition("=")
            d = ROOT / src / "finmlkit_tpu_torch" / "csrc" if src else CSRC
            specs[name] = (d if d.is_dir() else ROOT / src, RW_VARIANTS.get(name, ((), ())))
        return probe_rw(specs)
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
