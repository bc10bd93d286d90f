// Kernel D: the exact float64 volume and dollar bar walks.
//
// Replaces no TPU kernel. The JAX kits build volume and dollar bars of trades
// whose prices sit on no tick grid with host C++ loops
// (finmlkit_tpu/native/seg_stats.cpp:183-211, volume_bar_boundaries and
// dollar_bar_boundaries); their device forms (finmlkit_tpu/bar/indexers.py
// volume_bar_indexer, dollar_bar_indexer) search prefix sums and can move a
// close by one trade, so they are not the semantics. This kernel runs the
// loops as written, close for close:
//
//   cum = x[0];                                 // trade 0's value, no check
//   for (i = 1; i < n && k < max_bars; ++i) {
//     cum = cum + x[i];
//     if (cum >= thr) { out[k++] = i; cum = volume ? 0 : cum - thr; }
//   }
//
// with x[i] = (double)v[i] for volume bars (the sum restarts at each close)
// and x[i] = p[i] * (double)v[i] for dollar bars (the remainder carries).
// Every step is one rounding of an add, a subtract or a multiply, written
// with __dadd_rn, __dsub_rn and __dmul_rn so that nvcc cannot contract a
// multiply and an add into one FMA (it does by default). The source loop is
// unfused; a host compiler may fuse it (ROADMAP R15: -march=native turns the
// dollar step into vfmadd231sd), and this kernel follows the source.
//
// ONE block of 256 threads. The stream goes through shared memory in chunks
// of 2048 values, double-buffered: while lane 0 of warp 0 walks one chunk,
// warps 1-7 read the next chunk from device memory and compute its values
// (a product is exact per element, so any thread may form it), and one
// barrier a chunk hands the buffers over.
//
// The walk is a chain of dependent float64 operations on one thread, and a
// compare and a branch after every add would lengthen it. So lane 0 takes 16
// values at a time into registers and adds them in order; where all 16 are
// >= 0 and the sum after the 16th is still below the threshold, no close lies
// among them (a rounded add of a value >= 0 never decreases the sum, so every
// sum before it is below the threshold too), and the 16 adds are exactly the
// loop's. Otherwise it takes the 16 values again, one step at a time, from
// the sum before them: a close, a negative value or a NaN costs one block
// walked twice. The stream's bytes (4 a trade for volume, 12 for dollar)
// would take 0.05-0.14 ms at the card's memory rate; the kernel is bound by
// the chain of adds. A redesign (chunked walks that merge for volume, a
// certified filter on an exact prefix for dollar) is later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;                 // values a buffer holds
constexpr int kStagers = kThreads - 32;      // warps 1-7 stage
constexpr int kBlock = 16;                   // values lane 0 adds before a check

template <bool kDollar>
__device__ __forceinline__ double value(const double* p, const float* v, long long i) {
  const double x = static_cast<double>(v[i]);   // exact
  if constexpr (kDollar) return __dmul_rn(p[i], x);
  return x;
}

// One step of the loop at trade `idx`; true once max_bars closes are written.
template <bool kDollar>
__device__ __forceinline__ bool step(double& cum, double x, double thr, long long idx,
                                     long long* out, long long& k, long long max_bars) {
  cum = __dadd_rn(cum, x);
  if (cum >= thr) {
    out[k++] = idx;
    cum = kDollar ? __dsub_rn(cum, thr) : 0.0;
    return k == max_bars;
  }
  return false;
}

template <bool kDollar>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const double* __restrict__ p, const float* __restrict__ v,
            long long n, double thr, long long max_bars,
            long long* __restrict__ out, long long* __restrict__ count) {
  __shared__ double buf[2][kChunk];
  __shared__ volatile int done;   // lane 0 stops the block at max_bars
  const int t = threadIdx.x;
  const long long chunks = (n + kChunk - 1) / kChunk;

  for (int j = t; j < kChunk && j < n; j += kThreads) buf[0][j] = value<kDollar>(p, v, j);
  if (t == 0) done = max_bars <= 0;
  __syncthreads();

  double cum = 0.0;   // lane 0's state
  long long k = 0;
  for (long long c = 0; c < chunks && !done; ++c) {
    if (t == 0) {
      const double* x = buf[c & 1];
      const long long base = c * kChunk;
      const int m = static_cast<int>(n - base < kChunk ? n - base : kChunk);
      int j = 0;
      if (c == 0) {
        cum = x[0];
        j = 1;
      }
      bool stop = false;
      for (; j + kBlock <= m && !stop; j += kBlock) {
        double xs[kBlock];
#pragma unroll
        for (int u = 0; u < kBlock; ++u) xs[u] = x[j + u];
        double sum = cum;
        bool rising = true;
#pragma unroll
        for (int u = 0; u < kBlock; ++u) {
          sum = __dadd_rn(sum, xs[u]);
          rising &= xs[u] >= 0.0;
        }
        if (rising && sum < thr) {
          cum = sum;
          continue;
        }
#pragma unroll
        for (int u = 0; u < kBlock; ++u) {
          if (step<kDollar>(cum, xs[u], thr, base + j + u, out, k, max_bars)) {
            stop = true;
            break;
          }
        }
      }
      for (; j < m && !stop; ++j) stop = step<kDollar>(cum, x[j], thr, base + j, out, k, max_bars);
      if (stop) done = 1;
    } else if (t >= 32 && c + 1 < chunks) {
      double* x = buf[(c + 1) & 1];
      const long long base = (c + 1) * kChunk;
      const int m = static_cast<int>(n - base < kChunk ? n - base : kChunk);
      for (int j = t - 32; j < m; j += kStagers) x[j] = value<kDollar>(p, v, base + j);
    }
    __syncthreads();
  }
  if (t == 0) *count = k;
}

}  // namespace

// Kernel D over n >= 1 trades: mode 0 walks volume bars of the float32
// `volumes` (`prices` unused), mode 1 dollar bars of the float64 `prices`
// times `volumes`. Writes at most max_bars close indices (int64) to `out` and
// their number to `*count`, on `stream`. Returns cudaGetLastError().
extern "C" int fmk_float_walk(int mode, const void* prices, const void* volumes,
                              long long n, double thr, long long max_bars,
                              void* out, void* count, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const double*>(prices);
  const auto* v = static_cast<const float*>(volumes);
  auto* o = static_cast<long long*>(out);
  auto* c = static_cast<long long*>(count);
  switch (mode) {
    case 0: walk_kernel<false><<<1, kThreads, 0, s>>>(p, v, n, thr, max_bars, o, c); break;
    case 1: walk_kernel<true><<<1, kThreads, 0, s>>>(p, v, n, thr, max_bars, o, c); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
