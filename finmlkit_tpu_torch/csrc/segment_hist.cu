// Kernel H: per-bar histogram and "less" passes of the hist median engine,
// one thread block per bar.
//
// Replaces the TPU kernels of finmlkit_tpu/ops/segment_hist.py:
//   H1 _hist_pass (_hist_kernel): running counts of the 16 buckets
//      ((bits - B[bar]) >> s) per 128-lane row, with the per-bar base B
//      last-filled from scattered bar-open marks inside the kernel; an XLA
//      fixup (_hist_fix, bar_hist) turns the row tails into per-bar counts;
//   H2 _less_pass (_less_kernel): running count and segmented max of the
//      bits strictly below the per-bar value v, fixed up by _less_fix.
// The TPU streamed (rows, 128) planes in order and needed the row tails, the
// flags/scatter planes and the B-fill because a grid step could not find its
// bar. Here block k reads its bar's contiguous trade range (ci[k], ci[k+1]]
// directly and writes one row:
//   hist_kernel  out[k][16] int32: the counts of each bucket over the bar;
//   less_kernel  cnt[k], mx[k] int32: the count of bits < v[k] and their max
//                (INT_MIN if none).
// An empty bar writes zeros (and INT_MIN as its max).
//
// Each thread keeps its 16 counts in registers (an unrolled compare per
// bucket: no shared-memory atomics, which the first passes would serialise
// because a bar's trades share one or two buckets there); a warp-shuffle
// reduction and one pass over the warps' partial rows join them.
//
// Bound: device memory, 4 bytes of amount bits a trade a pass; the 16
// compare-adds a trade are far below the card's integer rate. A bar longer
// than a few thousand trades is walked by its block alone, so one very long
// bar serialises that block. int32 arithmetic wraps (bits - B is computed
// unsigned), as in the TPU kernel.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBuckets = 16;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int* __restrict__ bits, const long long* __restrict__ ci,
            const int* __restrict__ base, int s, int* __restrict__ out) {
  __shared__ int part[kWarps][kBuckets];
  const long long k = blockIdx.x;
  const long long e = ci[k + 1];
  const unsigned b = static_cast<unsigned>(base[k]);
  int cnt[kBuckets];
#pragma unroll
  for (int j = 0; j < kBuckets; ++j) cnt[j] = 0;
  for (long long i = ci[k] + 1 + threadIdx.x; i <= e; i += kThreads) {
    const int rel = static_cast<int>(static_cast<unsigned>(bits[i]) - b);
    const int bucket = rel >> s;  // arithmetic: negative stays out of range
#pragma unroll
    for (int j = 0; j < kBuckets; ++j) cnt[j] += bucket == j;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kBuckets; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cnt[j] += __shfl_down_sync(kFull, cnt[j], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kBuckets; ++j) part[warp][j] = cnt[j];
  }
  __syncthreads();
  if (threadIdx.x < kBuckets) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += part[w][threadIdx.x];
    out[k * kBuckets + threadIdx.x] = c;
  }
}

__global__ void __launch_bounds__(kThreads)
less_kernel(const int* __restrict__ bits, const long long* __restrict__ ci,
            const int* __restrict__ v, int* __restrict__ cnt_out,
            int* __restrict__ max_out) {
  __shared__ int part_cnt[kWarps];
  __shared__ int part_max[kWarps];
  const long long k = blockIdx.x;
  const long long e = ci[k + 1];
  const int vk = v[k];
  int cnt = 0;
  int mx = INT_MIN;
  for (long long i = ci[k] + 1 + threadIdx.x; i <= e; i += kThreads) {
    const int x = bits[i];
    if (x < vk) {
      ++cnt;
      mx = max(mx, x);
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_down_sync(kFull, cnt, o);
    mx = max(mx, __shfl_down_sync(kFull, mx, o));
  }
  if (lane == 0) {
    part_cnt[warp] = cnt;
    part_max[warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      cnt += part_cnt[w];
      mx = max(mx, part_max[w]);
    }
    cnt_out[k] = cnt;
    max_out[k] = mx;
  }
}

}  // namespace

// bits int32[n], ci int64[n_bars + 1] sorted with -1 <= ci[0] and
// ci[n_bars] < n, base int32[n_bars]; out int32[n_bars][16]. Returns
// cudaGetLastError().
extern "C" int fmk_hist_pass(const void* bits, const void* ci, const void* base,
                             int s, long long n_bars, void* out, void* stream) {
  if (n_bars <= 0) return 0;
  if (s < 0 || s > 31) return static_cast<int>(cudaErrorInvalidValue);
  hist_kernel<<<static_cast<unsigned>(n_bars), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bits), static_cast<const long long*>(ci),
      static_cast<const int*>(base), s, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The less pass over the same bars with the per-bar value v int32[n_bars];
// cnt and mx int32[n_bars]. Returns cudaGetLastError().
extern "C" int fmk_less_pass(const void* bits, const void* ci, const void* v,
                             long long n_bars, void* cnt, void* mx,
                             void* stream) {
  if (n_bars <= 0) return 0;
  less_kernel<<<static_cast<unsigned>(n_bars), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bits), static_cast<const long long*>(ci),
      static_cast<const int*>(v), static_cast<int*>(cnt), static_cast<int*>(mx));
  return static_cast<int>(cudaGetLastError());
}
