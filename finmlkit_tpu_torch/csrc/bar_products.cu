// Kernel B: per-bar products of the trade stream, one thread block per bar.
//
// Replaces the TPU kernels of finmlkit_tpu/ops/fused_scan.py:
//   K1a bar_scan_rowtails_v4 (_rowtail_kernel_v4)
//   K1b bar_scan_rowtails    (_rowtail_kernel, v2)
// together with the plane preparation (bar/fused.py _prep_planes) and the
// boundary fixup (_boundary_state) around them. For bar k, whose trades are
// (ci[k], ci[k+1]], it writes what _fused_packed_v2_jit (bar/fused.py:395-463)
// returns for that bar:
//   out64 [6][n_bars]  vol_u, dollar_u, vol_buy_u, vol_sell_u, dol_buy_u,
//                      dol_sell_u                     (int64 sums)
//   out32 [10][n_bars] open_raw, high_t, low_t, close_t, ticks_buy,
//                      ticks_sell, cum_spread_t, max_spread_t, ct_min, ct_max
//   outf  [4][n_bars]  cv_min, cv_max, cd_min, cd_max (float32)
// An empty bar (ci[k+1] == ci[k]) gets zero sums and counts and the sentinel
// extrema; the finals mask it.
//
// The TPU needed a whole-stream scan because a grid step could not find its
// bar; here a block reads its bar's trade range from ci and walks it in tiles
// of kTile trades. Sums and extrema are thread-local and reduced once at the
// end. The in-bar running tick, volume and dollar imbalances need a prefix in
// trade order: each thread sums its kItems consecutive trades serially, one
// warp-shuffle block scan joins the threads, and the running value carries
// from tile to tile. int64 stays native (the TPU's hi/lo pairs are gone);
// sums wrap as unsigned 64-bit adds, as the TPU's two's-complement pairs did.
//
// Bound: device memory for the stream (13 bytes a trade: int32 tick, int64
// units, int8 side; the previous trade's tick and side come from cache), and
// the per-tile block scan. A bar longer than one tile runs its tiles in order
// inside one block, so one very long bar serialises that block.
//
// Bit-exactness with the TPU: see bar_scan.cuh, which kernel V shares.
#include <climits>
#include <cuda_runtime.h>

#include "bar_scan.cuh"

namespace {

using fmk::kF32Big;
using fmk::kFull;
using fmk::Run;
using fmk::u64;

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // trades per tile
constexpr int kWarps = kThreads / 32;

// Per-thread, then per-block, accumulators of one bar.
struct Bar {
  u64 vol, dol, vb, vs, db, ds;
  int tb, ts;
  unsigned sp;
  int hi, lo, spmax, ctmin, ctmax;
  float cvmin, cvmax, cdmin, cdmax;
};

__device__ __forceinline__ Bar bar_identity() {
  return {0ull, 0ull, 0ull, 0ull, 0ull, 0ull, 0, 0, 0u,
          INT_MIN, INT_MAX, INT_MIN, INT_MAX, INT_MIN,
          kF32Big, -kF32Big, kF32Big, -kF32Big};
}

__device__ __forceinline__ void combine(Bar& a, const Bar& b) {
  a.vol += b.vol; a.dol += b.dol; a.vb += b.vb; a.vs += b.vs;
  a.db += b.db; a.ds += b.ds;
  a.tb += b.tb; a.ts += b.ts; a.sp += b.sp;
  a.hi = max(a.hi, b.hi); a.lo = min(a.lo, b.lo);
  a.spmax = max(a.spmax, b.spmax);
  a.ctmin = min(a.ctmin, b.ctmin); a.ctmax = max(a.ctmax, b.ctmax);
  a.cvmin = fminf(a.cvmin, b.cvmin); a.cvmax = fmaxf(a.cvmax, b.cvmax);
  a.cdmin = fminf(a.cdmin, b.cdmin); a.cdmax = fmaxf(a.cdmax, b.cdmax);
}

__device__ __forceinline__ Bar shfl_down(const Bar& v, int o) {
  Bar r;
  r.vol = __shfl_down_sync(kFull, v.vol, o);
  r.dol = __shfl_down_sync(kFull, v.dol, o);
  r.vb = __shfl_down_sync(kFull, v.vb, o);
  r.vs = __shfl_down_sync(kFull, v.vs, o);
  r.db = __shfl_down_sync(kFull, v.db, o);
  r.ds = __shfl_down_sync(kFull, v.ds, o);
  r.tb = __shfl_down_sync(kFull, v.tb, o);
  r.ts = __shfl_down_sync(kFull, v.ts, o);
  r.sp = __shfl_down_sync(kFull, v.sp, o);
  r.hi = __shfl_down_sync(kFull, v.hi, o);
  r.lo = __shfl_down_sync(kFull, v.lo, o);
  r.spmax = __shfl_down_sync(kFull, v.spmax, o);
  r.ctmin = __shfl_down_sync(kFull, v.ctmin, o);
  r.ctmax = __shfl_down_sync(kFull, v.ctmax, o);
  r.cvmin = __shfl_down_sync(kFull, v.cvmin, o);
  r.cvmax = __shfl_down_sync(kFull, v.cvmax, o);
  r.cdmin = __shfl_down_sync(kFull, v.cdmin, o);
  r.cdmax = __shfl_down_sync(kFull, v.cdmax, o);
  return r;
}

__global__ void __launch_bounds__(kThreads)
bar_products_kernel(const int* __restrict__ ticks,
                    const long long* __restrict__ units,
                    const signed char* __restrict__ sides,
                    const long long* __restrict__ ci, long long n,
                    long long n_bars, long long* __restrict__ out64,
                    int* __restrict__ out32, float* __restrict__ outf) {
  __shared__ Run warp_run[kWarps];
  __shared__ Bar warp_bar[kWarps];
  const long long k = blockIdx.x;
  const long long a = ci[k];
  const long long e = ci[k + 1];
  const bool single = (e - a) == 1;

  Bar acc = bar_identity();
  Run carry = {0ull, 0ull, 0u};
  for (long long t0 = a + 1; t0 <= e; t0 += kTile) {  // uniform in the block
    Run part[kItems];
    bool traded[kItems];
    Run run = {0ull, 0ull, 0u};
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = t0 + static_cast<long long>(threadIdx.x) * kItems + j;
      Run c = {0ull, 0ull, 0u};
      traded[j] = false;
      if (i <= e) {
        const fmk::Trade t = fmk::load_trade(ticks, units, sides, i, n, single);
        acc.vol += t.units;
        acc.dol += t.dollars;
        if (t.side == 1) {
          acc.vb += t.units; acc.db += t.dollars; acc.tb += 1;
        } else if (t.side == -1) {
          acc.vs += t.units; acc.ds += t.dollars; acc.ts += 1;
        }
        c = fmk::contribution(t);
        traded[j] = t.side != 0;
        acc.sp += static_cast<unsigned>(t.spread);
        acc.hi = max(acc.hi, t.tick);
        acc.lo = min(acc.lo, t.tick);
        acc.spmax = max(acc.spmax, t.spread);
      }
      run = fmk::add(run, c);
      part[j] = run;
    }
    Run tile_total;
    const Run base = fmk::add(carry, fmk::block_exclusive_scan<kWarps>(
                                        run, Run{0ull, 0ull, 0u}, fmk::RunAdd(),
                                        warp_run, &tile_total));
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (traded[j]) {
        const Run r = fmk::add(base, part[j]);
        const float fv = fmk::pair_f32(r.cv);
        const float fd = fmk::pair_f32(r.cd);
        acc.cvmin = fminf(acc.cvmin, fv);
        acc.cvmax = fmaxf(acc.cvmax, fv);
        acc.cdmin = fminf(acc.cdmin, fd);
        acc.cdmax = fmaxf(acc.cdmax, fd);
        acc.ctmin = min(acc.ctmin, static_cast<int>(r.ct));
        acc.ctmax = max(acc.ctmax, static_cast<int>(r.ct));
      }
    }
    carry = fmk::add(carry, tile_total);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Bar other = shfl_down(acc, o);
    combine(acc, other);
  }
  if (lane == 0) warp_bar[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    Bar b = warp_bar[0];
    for (int w = 1; w < kWarps; ++w) combine(b, warp_bar[w]);
    const long long first = a + 1 < n ? (a + 1 > 0 ? a + 1 : 0) : n - 1;
    const long long last = e < n ? (e > 0 ? e : 0) : n - 1;
    const long long m = n_bars;
    out64[0 * m + k] = static_cast<long long>(b.vol);
    out64[1 * m + k] = static_cast<long long>(b.dol);
    out64[2 * m + k] = static_cast<long long>(b.vb);
    out64[3 * m + k] = static_cast<long long>(b.vs);
    out64[4 * m + k] = static_cast<long long>(b.db);
    out64[5 * m + k] = static_cast<long long>(b.ds);
    out32[0 * m + k] = ticks[first];
    out32[1 * m + k] = b.hi;
    out32[2 * m + k] = b.lo;
    out32[3 * m + k] = ticks[last];
    out32[4 * m + k] = b.tb;
    out32[5 * m + k] = b.ts;
    out32[6 * m + k] = static_cast<int>(b.sp);
    out32[7 * m + k] = b.spmax;
    out32[8 * m + k] = b.ctmin;
    out32[9 * m + k] = b.ctmax;
    outf[0 * m + k] = b.cvmin;
    outf[1 * m + k] = b.cvmax;
    outf[2 * m + k] = b.cdmin;
    outf[3 * m + k] = b.cdmax;
  }
}

}  // namespace

// ticks int32[n], units int64[n], sides int8[n], ci int64[n_bars + 1] sorted
// with -1 <= ci[0] and ci[n_bars] < n. Returns cudaGetLastError().
extern "C" int fmk_bar_products(const void* ticks, const void* units,
                                const void* sides, const void* ci, long long n,
                                long long n_bars, void* out64, void* out32,
                                void* outf, void* stream) {
  if (n_bars <= 0 || n <= 0) return 0;
  bar_products_kernel<<<static_cast<unsigned>(n_bars), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ticks), static_cast<const long long*>(units),
      static_cast<const signed char*>(sides),
      static_cast<const long long*>(ci), n, n_bars,
      static_cast<long long*>(out64), static_cast<int*>(out32),
      static_cast<float*>(outf));
  return static_cast<int>(cudaGetLastError());
}
