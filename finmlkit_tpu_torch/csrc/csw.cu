// Kernel W: the sup statistic of the Chu-Stinchcombe-White CUSUM break test.
//
// Not a TPU kernel: it replaces the XLA lax.map over blocks of 128 t's of
// finmlkit_tpu/feature/kernels/structural_break.py:55 (_csw_rolling_impl),
// each block a (128, w - 1) matrix of lags reduced by _sup_stat (:23).
//
// For each t, over the lags k = 2 .. t_loc - 1 (t_loc = min(t, w)):
//   dyn = y[t] - y[t - k], denom = sigma[t] * sqrt(k), admissible if
//   denom > 1e-16; s = |dyn| / denom; s_up = s where dyn > 0 (or NaN), else 0;
//   s_down = s where dyn < 0 (or NaN), else 0.
// up is the largest s_up, and its critical value sqrt(4.6 + log k*) at the
// lag k* that reaches it, the largest such lag on equal values (the
// reference's loop keeps the first of equal values while it walks k
// downward); down likewise. A NaN among the values, an infinite maximum or no
// admissible lag gives (-1e-6, 0), as the reference's floor of -1e-6 and its
// isfinite test do (:38-48).
//
// sqrt(k) and sqrt(4.6 + log k) come from tables that the wrapper computes
// once, so that the kernel and the plain version do the same float
// operations: a subtraction, a product, a quotient, all rounded to nearest
// through the intrinsics, with no multiply-add for nvcc to contract. Their
// results are equal bit for bit.
//
// One warp per t. Lane l takes the lags 2 + l, 2 + l + 32, ... (neighbouring
// lanes on neighbouring y), keeps its best (value, lag) a side, and five
// shuffle rounds combine the lanes: the larger value, and on equal values the
// larger lag. That combine is associative and commutative, so the lanes' order
// does not matter and ties keep the largest lag.
//
// Bound: operations, about (n * w) lag pairs of 4 float64 operations each;
// the bytes (y and sigma read, four values written a t) are few.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Best {
  double v;     // the largest value so far (-inf: none)
  long long k;  // its lag, the largest of equal values (-1: none)
  bool nan;     // a NaN value was met
};

__device__ __forceinline__ void offer(Best& b, double v, long long k) {
  if (v != v) {
    b.nan = true;
  } else if (v > b.v || (v == b.v && k > b.k)) {
    b.v = v;
    b.k = k;
  }
}

__device__ __forceinline__ void merge_lanes(Best& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double v = __shfl_xor_sync(kFull, b.v, o);
    const long long k = __shfl_xor_sync(kFull, b.k, o);
    const bool nan = __shfl_xor_sync(kFull, static_cast<int>(b.nan), o) != 0;
    b.nan = b.nan || nan;
    if (v > b.v || (v == b.v && k > b.k)) {
      b.v = v;
      b.k = k;
    }
  }
}

__device__ __forceinline__ void write_side(const Best& b, const double* crit, double* val,
                                           double* cv, long long t) {
  const bool has = !b.nan && isfinite(b.v) && b.v > -1e-6;
  val[t] = has ? b.v : -1e-6;
  cv[t] = (has && b.k > 0) ? crit[b.k] : 0.0;
}

__global__ void __launch_bounds__(kThreads)
csw_kernel(const double* __restrict__ y, const double* __restrict__ sigma,
           const double* __restrict__ sqrt_k, const double* __restrict__ crit,
           long long n, long long w, double* __restrict__ up, double* __restrict__ down,
           double* __restrict__ cu, double* __restrict__ cd) {
  const long long t = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= n) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long t_loc = t < w ? t : w;
  const double yt = y[t], sig = sigma[t];
  Best bu{-INFINITY, -1, false}, bd{-INFINITY, -1, false};
  for (long long k = 2 + lane; k <= t_loc - 1; k += 32) {
    const double denom = __dmul_rn(sig, sqrt_k[k]);
    if (!(denom > 1e-16)) continue;
    const double dyn = __dsub_rn(yt, y[t - k]);
    const double s = __ddiv_rn(fabs(dyn), denom);
    const bool nan = dyn != dyn;
    offer(bu, (dyn > 0.0 || nan) ? s : 0.0, k);
    offer(bd, (dyn < 0.0 || nan) ? s : 0.0, k);
  }
  merge_lanes(bu);
  merge_lanes(bd);
  if (lane == 0) {
    write_side(bu, crit, up, cu, t);
    write_side(bd, crit, down, cd, t);
  }
}

}  // namespace

// Kernel W: up, down and their critical values cu, cd for each of n t's, from
// the log prices y, the per-t sigma, the window w, and the tables sqrt_k[k] =
// sqrt(k), crit[k] = sqrt(4.6 + log k) for k < w. All float64, contiguous.
// Returns cudaGetLastError().
extern "C" int fmk_csw_sup_stat(const double* y, const double* sigma, const double* sqrt_k,
                                const double* crit, long long n, long long w, double* up,
                                double* down, double* cu, double* cd, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  csw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, sigma, sqrt_k, crit, n, w, up, down, cu, cd);
  return static_cast<int>(cudaGetLastError());
}
