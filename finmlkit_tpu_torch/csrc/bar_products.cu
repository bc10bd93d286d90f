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
// Bit-exactness with the TPU:
// - the float32 imbalance values are rounded from int64 in two steps,
//   hi * 2^32 + float(lo) (fused_scan.py:148-153, bar/fused.py:249-257), with
//   explicit round-to-nearest intrinsics so that no FMA contraction changes a
//   result;
// - "prev" of trade i is trade i-1, wrapping to trade n-1 for i == 0 (the
//   jnp.roll of _prep_planes), and does not reset at bar starts;
// - a single-trade bar's spread counts when its side != 0;
// - int32 sums wrap mod 2^32 like the TPU's int32 prefixes.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // trades per tile
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kF32Big = 3.0e38f;  // bar/fused.py _F32BIG
typedef unsigned long long u64;

// int64 -> float32 as the TPU kernel's _pair_to_f32: hi*2^32 + f32(lo).
__device__ __forceinline__ float pair_f32(u64 x) {
  const int hi = static_cast<int>(static_cast<long long>(x) >> 32);
  const int lo = static_cast<int>(static_cast<unsigned>(x & 0xffffffffull));
  const float lo_f =
      __fadd_rn(__int2float_rn(lo), lo < 0 ? 4294967296.0f : 0.0f);
  return __fadd_rn(__fmul_rn(__int2float_rn(hi), 4294967296.0f), lo_f);
}

// Running in-bar imbalances: volume units, dollar units, ticks.
struct Run {
  u64 cv, cd;
  unsigned ct;
};

__device__ __forceinline__ Run add(Run a, Run b) {
  return {a.cv + b.cv, a.cd + b.cd, a.ct + b.ct};
}

__device__ __forceinline__ Run shfl_up(Run v, int o) {
  return {__shfl_up_sync(kFull, v.cv, o), __shfl_up_sync(kFull, v.cd, o),
          __shfl_up_sync(kFull, v.ct, o)};
}

// Block-wide exclusive scan of one Run per thread; *total gets the block sum.
__device__ Run block_exclusive_scan(Run v, Run* warp_tot, Run* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Run zero = {0ull, 0ull, 0u};
  Run x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Run y = shfl_up(x, o);
    if (lane >= o) x = add(x, y);
  }
  Run excl = shfl_up(x, 1);
  if (lane == 0) excl = zero;
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    Run w = lane < kWarps ? warp_tot[lane] : zero;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const Run y = shfl_up(w, o);
      if (lane >= o) w = add(w, y);
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const Run base = warp > 0 ? warp_tot[warp - 1] : zero;
  *total = warp_tot[kWarps - 1];
  __syncthreads();
  return add(base, excl);
}

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
        const int tk = ticks[i];
        const u64 u = static_cast<u64>(units[i]);
        const signed char sd = sides[i];
        const long long ip = i == 0 ? n - 1 : i - 1;
        const int ptk = ticks[ip];
        const signed char psd = sides[ip];
        const u64 d = static_cast<u64>(static_cast<long long>(tk)) * u;
        acc.vol += u;
        acc.dol += d;
        if (sd == 1) {
          acc.vb += u; acc.db += d; acc.tb += 1;
          c = {u, d, 1u};
        } else if (sd == -1) {
          acc.vs += u; acc.ds += d; acc.ts += 1;
          c = {0ull - u, 0ull - d, 0u - 1u};
        }
        traded[j] = sd != 0;
        const bool change = single ? sd != 0 : sd != psd;
        const unsigned diff =
            static_cast<unsigned>(tk) - static_cast<unsigned>(ptk);
        const unsigned mag =
            static_cast<int>(diff) < 0 ? 0u - diff : diff;  // int32 abs, wraps
        const int spread = change ? static_cast<int>(mag) : 0;
        acc.sp += static_cast<unsigned>(spread);
        acc.hi = max(acc.hi, tk);
        acc.lo = min(acc.lo, tk);
        acc.spmax = max(acc.spmax, spread);
      }
      run = add(run, c);
      part[j] = run;
    }
    Run tile_total;
    const Run base = add(carry, block_exclusive_scan(run, warp_run, &tile_total));
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (traded[j]) {
        const Run r = add(base, part[j]);
        const float fv = pair_f32(r.cv);
        const float fd = pair_f32(r.cd);
        acc.cvmin = fminf(acc.cvmin, fv);
        acc.cvmax = fmaxf(acc.cvmax, fv);
        acc.cdmin = fminf(acc.cdmin, fd);
        acc.cdmax = fmaxf(acc.cdmax, fd);
        acc.ctmin = min(acc.ctmin, static_cast<int>(r.ct));
        acc.ctmax = max(acc.ctmax, static_cast<int>(r.ct));
      }
    }
    carry = add(carry, tile_total);
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
