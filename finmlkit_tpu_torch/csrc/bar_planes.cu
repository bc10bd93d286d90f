// Kernel V: the running extrema of every trade of the stream, one thread
// block per bar.
//
// With kernel C (prefix_scan.cu) it replaces the TPU kernel of
// finmlkit_tpu/ops/fused_scan.py:
//   K1c bar_scan_planes (_bar_scan_kernel, v1): the running scan state of
//       every trade as 24 full (rows, 128) planes.
// Kernel C gives the 9 global prefixes (six int64, three int32) from stacks
// of the masked inputs; kernel V writes the 9 segmented running extrema,
// which reset at every bar's first trade:
//   ext32 [5][n]  high, low, spmax, ctmin, ctmax (int32)
//   extf  [4][n]  cvmin, cvmax, cdmin, cdmax     (float32)
// where ct, cv and cd are the in-bar running tick, volume and dollar
// imbalances (cv and cd rounded to float32 as the TPU's pairs were), counted
// on the trades with side != 0 only (the others carry the identity).
//
// The TPU carried the state from grid step to grid step; here block k walks
// its bar (ci[k], ci[k+1]] in tiles, as kernel B does: a thread takes kItems
// consecutive trades, one block scan of the imbalance sums and one of the
// nine extrema join the threads, and both carry from tile to tile. Blocks
// n_bars and n_bars + 1 write the sentinels of the trades before the first
// bar ([0, ci[0]]) and after the last (ci[n_bars], n): INT_MIN, INT_MAX, -1
// (spmax), INT_MAX, INT_MIN, +-3e38, as the TPU kernel leaves there. An
// empty bar owns no trade.
//
// Bound: device memory. It reads 13 bytes a trade (the previous trade's tick
// and side come from cache) and writes 36; two block scans a tile.
#include <climits>
#include <cuda_runtime.h>

#include "bar_scan.cuh"

namespace {

using fmk::kF32Big;
using fmk::kFull;
using fmk::Run;

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

// The running extrema of a stretch of one bar.
struct Ext {
  int hi, lo, spmax, ctmin, ctmax;
  float cvmin, cvmax, cdmin, cdmax;
};

__device__ __forceinline__ Ext ext_identity() {
  return {INT_MIN, INT_MAX, INT_MIN, INT_MAX, INT_MIN,
          kF32Big, -kF32Big, kF32Big, -kF32Big};
}

struct ExtCombine {
  __device__ __forceinline__ Ext operator()(const Ext& a, const Ext& b) const {
    return {max(a.hi, b.hi), min(a.lo, b.lo), max(a.spmax, b.spmax),
            min(a.ctmin, b.ctmin), max(a.ctmax, b.ctmax),
            fminf(a.cvmin, b.cvmin), fmaxf(a.cvmax, b.cvmax),
            fminf(a.cdmin, b.cdmin), fmaxf(a.cdmax, b.cdmax)};
  }
};

__device__ __forceinline__ Ext shfl_up(const Ext& v, int o) {
  return {__shfl_up_sync(kFull, v.hi, o), __shfl_up_sync(kFull, v.lo, o),
          __shfl_up_sync(kFull, v.spmax, o), __shfl_up_sync(kFull, v.ctmin, o),
          __shfl_up_sync(kFull, v.ctmax, o), __shfl_up_sync(kFull, v.cvmin, o),
          __shfl_up_sync(kFull, v.cvmax, o), __shfl_up_sync(kFull, v.cdmin, o),
          __shfl_up_sync(kFull, v.cdmax, o)};
}

__device__ __forceinline__ void store(const Ext& x, long long i, long long n,
                                      int* __restrict__ ext32,
                                      float* __restrict__ extf) {
  ext32[0 * n + i] = x.hi;
  ext32[1 * n + i] = x.lo;
  ext32[2 * n + i] = x.spmax;
  ext32[3 * n + i] = x.ctmin;
  ext32[4 * n + i] = x.ctmax;
  extf[0 * n + i] = x.cvmin;
  extf[1 * n + i] = x.cvmax;
  extf[2 * n + i] = x.cdmin;
  extf[3 * n + i] = x.cdmax;
}

__global__ void __launch_bounds__(kThreads)
bar_planes_kernel(const int* __restrict__ ticks,
                  const long long* __restrict__ units,
                  const signed char* __restrict__ sides,
                  const long long* __restrict__ ci, long long n,
                  long long n_bars, int* __restrict__ ext32,
                  float* __restrict__ extf) {
  __shared__ Run warp_run[kWarps];
  __shared__ Ext warp_ext[kWarps];
  const long long k = blockIdx.x;
  if (k >= n_bars) {  // the trades outside every bar
    const long long lo = k == n_bars ? 0 : ci[n_bars] + 1;
    const long long hi = k == n_bars ? ci[0] : n - 1;
    Ext sentinel = ext_identity();
    sentinel.spmax = -1;
    for (long long i = lo + threadIdx.x; i <= hi; i += kThreads)
      store(sentinel, i, n, ext32, extf);
    return;
  }
  const long long a = ci[k];
  const long long e = ci[k + 1];
  const bool single = (e - a) == 1;
  const ExtCombine comb;

  Run carry = {0ull, 0ull, 0u};
  Ext ecarry = ext_identity();
  for (long long t0 = a + 1; t0 <= e; t0 += kTile) {  // uniform in the block
    const long long first = t0 + static_cast<long long>(threadIdx.x) * kItems;
    fmk::Trade tr[kItems];
    Run part[kItems];
    Run run = {0ull, 0ull, 0u};
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      Run c = {0ull, 0ull, 0u};
      if (first + j <= e) {
        tr[j] = fmk::load_trade(ticks, units, sides, first + j, n, single);
        c = fmk::contribution(tr[j]);
      }
      run = fmk::add(run, c);
      part[j] = run;
    }
    Run run_total;
    const Run base = fmk::add(carry, fmk::block_exclusive_scan<kWarps>(
                                         run, Run{0ull, 0ull, 0u}, fmk::RunAdd(),
                                         warp_run, &run_total));
    // this thread's running extrema, from its first trade on
    Ext loc[kItems];
    Ext x = ext_identity();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (first + j <= e) {
        Ext v = ext_identity();
        v.hi = v.lo = tr[j].tick;
        v.spmax = tr[j].spread;
        if (tr[j].side != 0) {
          const Run r = fmk::add(base, part[j]);
          v.ctmin = v.ctmax = static_cast<int>(r.ct);
          v.cvmin = v.cvmax = fmk::pair_f32(r.cv);
          v.cdmin = v.cdmax = fmk::pair_f32(r.cd);
        }
        x = comb(x, v);
      }
      loc[j] = x;
    }
    Ext ext_total;
    const Ext before = comb(ecarry, fmk::block_exclusive_scan<kWarps>(
                                        x, ext_identity(), comb, warp_ext,
                                        &ext_total));
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (first + j <= e) store(comb(before, loc[j]), first + j, n, ext32, extf);
    }
    carry = fmk::add(carry, run_total);
    ecarry = comb(ecarry, ext_total);
  }
}

}  // namespace

// ticks int32[n], units int64[n], sides int8[n], ci int64[n_bars + 1] sorted
// with -1 <= ci[0] and ci[n_bars] < n; ext32 int32[5][n], extf float32[4][n].
// Returns cudaGetLastError().
extern "C" int fmk_bar_planes(const void* ticks, const void* units,
                              const void* sides, const void* ci, long long n,
                              long long n_bars, void* ext32, void* extf,
                              void* stream) {
  if (n_bars <= 0 || n <= 0) return 0;
  bar_planes_kernel<<<static_cast<unsigned>(n_bars + 2), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ticks), static_cast<const long long*>(units),
      static_cast<const signed char*>(sides),
      static_cast<const long long*>(ci), n, n_bars, static_cast<int*>(ext32),
      static_cast<float*>(extf));
  return static_cast<int>(cudaGetLastError());
}
