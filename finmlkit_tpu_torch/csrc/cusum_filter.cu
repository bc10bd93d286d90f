// Kernel Z: the symmetric CUSUM event filter (AFML snippet 2.4) on a float64
// series, its events exact.
//
// Not a TPU kernel: it replaces the host loop of sampling/filters.py
// cusum_filter, which follows the JAX package's native loop
// (finmlkit_tpu/native/seg_stats.cpp:137-151). The JAX package's device form
// (finmlkit_tpu/sampling/filters.py:18-62) is not followed: its prefix sum
// carries a NaN (ROADMAP.md, R11). For i = 1 .. n-1, with r = log(x[i] /
// x[i-1]) and s+ = s- = 0 at the start:
//   sp = s+ + r; sn = s- + r;
//   s+ = sp > 0 ? sp : 0;  s- = sn < 0 ? sn : 0;     (a NaN sum becomes 0)
//   if (s- < -h[i]) { s- = 0; event i } else if (s+ > h[i]) { s+ = 0; event i }
// Kernel E's CUSUM mode (event_scan.cu) differs on every line (>= and <=, s+
// first, a NaN kept, its clamps composed in a shuffle scan), so the filter has
// its own walk with the loop's arithmetic, step for step: one IEEE division,
// CUDA's double log, and additions rounded to nearest with no contraction.
//
// Bound: latency. The month's 1-minute closes are some 45,000 values, 700 KB of
// returns and events, so the cost is the launch and the chain of dependent
// steps, not bytes. The whole filter is ONE block of 1024 threads (walkers) in
// one launch, a loop inside the block in place of a grid in sequence:
//   1. Walker t owns returns [t L, (t + 1) L), L = ceil((n - 1) / 1024). It
//      computes each return, keeps it in `r` (scratch) and walks its chunk
//      from the guess (s+, s-) = (0, 0), counting its events.
//   2. Rounds: each walker whose predecessor's end state differs, bit for
//      bit, from its entry walks again from that end state, in lockstep with
//      its walk from the old entry, recomputed, until both states are equal
//      bit for bit at one index: from there both walks are the same, so its
//      end state stands and its count moves by the two prefixes' difference.
//      Only a walk that reaches the chunk's end without meeting changes its
//      end state. The rounds stop when no end state changed
//      (__syncthreads_or). A walker with no returns (they come last) takes
//      no part: no walker after it reads its state. Both sums clamp to 0
//      within a few bars, so the walks meet in the first round; where they
//      never meet, round k fixes walker k and the rounds are the sequential
//      walk, still exact. After the step a sum is never NaN nor -0.0, so
//      bitwise equality is value equality.
//   3. A block exclusive scan of the counts gives each walker its offset, and
//      a last walk from its true entry writes its event indices, ascending.
// Each walker reads only its own returns, so `r` needs no barrier.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWalkers = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Sums {
  double pos, neg;
};

__device__ __forceinline__ bool same(Sums a, Sums b) {
  return __double_as_longlong(a.pos) == __double_as_longlong(b.pos) &&
         __double_as_longlong(a.neg) == __double_as_longlong(b.neg);
}

// The loop's step on return r with threshold h; true where it records an event.
__device__ __forceinline__ bool step(Sums& s, double r, double h) {
  const double sp = __dadd_rn(s.pos, r), sn = __dadd_rn(s.neg, r);
  s.pos = sp > 0.0 ? sp : 0.0;
  s.neg = sn < 0.0 ? sn : 0.0;
  if (s.neg < -h) {
    s.neg = 0.0;
    return true;
  }
  if (s.pos > h) {
    s.pos = 0.0;
    return true;
  }
  return false;
}

__global__ void __launch_bounds__(kWalkers, 1)
    cusum_filter_kernel(const double* __restrict__ x, const double* __restrict__ h,
                        long long hs, long long m, double* __restrict__ r,
                        long long* __restrict__ events, long long* __restrict__ info) {
  __shared__ Sums ends[kWalkers];
  __shared__ long long warp_total[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long len = (m + kWalkers - 1) / kWalkers;
  const long long lo = min(m, t * len), hi = min(m, lo + len);
  // r[j] is the return of index i = j + 1, whose threshold is h[(j + 1) hs]
  const double* hj = h + hs;

  // 1. the returns and the guess walk
  Sums entry{0.0, 0.0}, s = entry;
  long long count = 0;
  for (long long j = lo; j < hi; ++j) {
    const double rj = log(__ddiv_rn(x[j + 1], x[j]));
    r[j] = rj;
    count += step(s, rj, hj[j * hs]);
  }
  ends[t] = s;
  __syncthreads();

  // 2. rounds until the walks meet
  long long rounds = 0;
  for (;;) {
    ++rounds;
    const Sums in = t == 0 ? Sums{0.0, 0.0} : ends[t - 1];
    __syncthreads();
    bool changed = false;
    if (lo < hi && !same(in, entry)) {
      Sums a = in, b = entry;
      long long ca = 0, cb = 0;
      bool met = false;
      for (long long j = lo; j < hi && !met; ++j) {
        const double rj = r[j], hv = hj[j * hs];
        ca += step(a, rj, hv);
        cb += step(b, rj, hv);
        met = same(a, b);
      }
      count += ca - cb;
      entry = in;
      if (!met) {
        ends[t] = a;
        changed = true;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }

  // 3. offsets: an exclusive scan of the counts over the block
  long long v = count;
  for (int o = 1; o < 32; o <<= 1) {
    const long long u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_total[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_total[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const long long u = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += u;
    }
    warp_total[lane] = w;
  }
  __syncthreads();
  long long k = v - count + (warp > 0 ? warp_total[warp - 1] : 0);
  s = entry;
  for (long long j = lo; j < hi; ++j)
    if (step(s, r[j], hj[j * hs])) events[k++] = j + 1;
  if (t == 0) {
    info[0] = warp_total[31];
    info[1] = rounds;
  }
}

}  // namespace

// Kernel Z: the CUSUM filter's events of the n float64 values x (n >= 2),
// threshold h[i * h_stride] at index i (h_stride 0: one value; 1: one a
// value). `r` receives the n - 1 log returns; `events` (capacity n - 1) the
// ascending event indices; info[0] their count and info[1] the rounds of
// step 2. One launch on `stream`; returns cudaGetLastError().
extern "C" int fmk_cusum_filter(const double* x, const double* h, long long h_stride,
                                long long n, double* r, long long* events, long long* info,
                                void* stream) {
  if (n < 2 || (h_stride != 0 && h_stride != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cusum_filter_kernel<<<1, kWalkers, 0, static_cast<cudaStream_t>(stream)>>>(
      x, h, h_stride, n - 1, r, events, info);
  return static_cast<int>(cudaGetLastError());
}
