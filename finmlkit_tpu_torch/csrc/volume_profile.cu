// Kernel G: the volume profile of a bar's trailing window (rolling mode), or
// of each row of a given grid of profiles (rows mode): the point of control
// (POC), the value area's high and low (HVA, LVA) and the share of volume
// above the POC.
//
// Not a TPU kernel: it replaces the XLA lax.map of
// finmlkit_tpu/feature/kernels/volume.py:191 (_volume_profile_rolling_impl,
// rolling mode) and :347 (volume_profile_developing, rows mode), each a batch
// of _bucket_profile (:117) and _poc_hva_lva_single (:64), whose value-area
// expansion is a data-dependent while_loop (:110).
//
// A block takes one profile at a time (a grid-stride loop over the bars or
// rows). Its grid of max_levels float64 volumes lives in dynamic shared memory
// (up to 227 KB a block), or, where max_levels is larger, in the block's row of
// a global scratch that the wrapper allocates. The steps, each the JAX
// package's function with its order of float operations:
//   1. rolling: the window's lowest level (a block min over its bars), then
//      the grid: bar by bar in ascending order, threads own level columns and
//      add (double)buy + (double)sell into column (low - window low + c); a
//      column past max_levels - 1 lands on max_levels - 1, added by one thread
//      in ascending column order (the target clip, :180). No (bars, levels)
//      float64 grid is built in device memory. rows: the row is copied.
//   2. optional bucketing into odd-width bins (:117-145): the first and last
//      level of positive volume by a block min and max; then one thread a bin
//      adds its positive levels left to right (segment_sum's order), in place,
//      one chunk of blockDim bins at a time: a bin never starts below its own
//      index, so a chunk's writes never reach a level that a later bin reads.
//      Level labels follow the JAX formulas in wrapping int32 arithmetic
//      (wrap32), which is what they give for a window with no volume.
//   3. total and the volume above the POC: each thread adds its levels
//      t, t + 256, ... in order, then a fixed tree over the 256 partials;
//      the plain version adds in the same order, so both agree bit for bit.
//   4. POC: a block argmax, the first of equal maxima (NaN counts as the
//      largest, as in jnp.argmax and torch.argmax).
//   5. the value-area walk in one thread (:74-110): up, down or both by pair
//      volume, -1 past either end, until the area holds va_pct of the total
//      or no side moves.
//
// Bound: the bytes (each bar's n_levels float32 pairs read once, 20 bytes a
// bar written) or the adds (the sum over bars of their windows' levels, at
// the float64 peak), whichever is larger. The kernel reads each bar once a
// window that holds it (from L2 for neighbouring blocks), zeroes and reduces
// a max_levels grid a bar, and walks the value area in one thread; those are
// what to watch.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int wrap32(long long v) {
  return static_cast<int>(static_cast<unsigned int>(static_cast<unsigned long long>(v)));
}

// floor division by a positive divisor, as jnp's // on integers
__device__ __forceinline__ long long floordiv(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

struct Args {
  // rolling mode (rows == nullptr): bars i in [first, n), window [start[i], i]
  const long long* start;
  const int* low;
  const int* nlev;
  const float* buy;
  const float* sell;
  long long L;
  long long first;
  long long n;
  // rows mode: n_rows rows of M float64 volumes, levels row_lo + k
  const double* rows;
  long long row_lo;
  long long n_rows;
  long long M;
  int n_bins;  // 0: no bucketing
  double va_frac;
  double* scratch;  // gridDim.x rows of M, the global-grid path only
  int* poc;
  int* hva;
  int* lva;
  double* pct;
};

struct Shared {
  double red[kThreads];
  long long redi[kThreads];
};

// block min (is_max = false) or max of one long long a thread
__device__ long long block_minmax(Shared& sh, long long v, bool is_max) {
  const int t = threadIdx.x;
  sh.redi[t] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      const long long o = sh.redi[t + s];
      sh.redi[t] = is_max ? (o > sh.redi[t] ? o : sh.redi[t]) : (o < sh.redi[t] ? o : sh.redi[t]);
    }
    __syncthreads();
  }
  const long long r = sh.redi[0];
  __syncthreads();
  return r;
}

// the partial of each thread (its levels t, t + 256, ... added in order),
// then a fixed tree
__device__ double block_sum(Shared& sh, double acc) {
  const int t = threadIdx.x;
  sh.red[t] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) sh.red[t] = sh.red[t] + sh.red[t + s];
    __syncthreads();
  }
  const double r = sh.red[0];
  __syncthreads();
  return r;
}

__device__ __forceinline__ bool better(double a, long long ia, double b, long long ib) {
  const bool na = a != a, nb = b != b;
  if (na != nb) return na;
  if (na || a == b) return ia < ib;
  return a > b;
}

struct Labels {  // the level of grid index k
  bool binned;
  long long lo;                                   // unbinned: lo + k
  long long min_price, max_price, bw, n_full;     // binned (wrapped int32 values)
  __device__ int at(long long k) const {
    if (!binned) return wrap32(lo + k);
    const int edges = wrap32(min_price + wrap32(k * bw));
    if (k < n_full) return wrap32(static_cast<long long>(edges) + (bw - 1) / 2);
    if (k == n_full) return static_cast<int>(max_price);
    return edges;
  }
};

// steps 2-5 on the grid g of M levels whose level 0 is lo; thread 0 writes
// output o
__device__ void profile(Shared& sh, double* g, long long M, long long lo, const Args& a,
                        long long o) {
  const int t = threadIdx.x;
  Labels lab{false, lo, 0, 0, 1, 0};
  if (a.n_bins > 0) {
    long long kmin = LLONG_MAX, kmax = -1;
    for (long long k = t; k < M; k += kThreads) {
      if (g[k] > 0.0) {
        if (k < kmin) kmin = k;
        kmax = k;
      }
    }
    kmin = block_minmax(sh, kmin, false);
    kmax = block_minmax(sh, kmax, true);
    const bool has = kmax >= 0;
    const long long min_price = has ? wrap32(lo + kmin) : INT_MAX;
    const long long max_price = has ? wrap32(lo + kmax) : INT_MIN;
    const long long range = wrap32(max_price - min_price);
    long long bw = floordiv(range, a.n_bins);
    if (bw < 1) bw = 1;
    if (bw % 2 == 0) bw = wrap32(bw + 1);
    long long n_full = floordiv(wrap32(range + bw - 1), bw);
    if (n_full < 1) n_full = 1;
    lab = Labels{true, lo, min_price, max_price, bw, n_full};
    for (long long cb = 0; cb < M; cb += kThreads) {
      const long long b = cb + t;
      double sum = 0.0;
      if (b < M && has) {
        const long long k0 = kmin + b * bw;
        const long long k1 = k0 + bw < M ? k0 + bw : M;
        for (long long k = k0; k < k1; ++k) {
          const double v = g[k];
          if (v > 0.0) sum = sum + v;
        }
      }
      __syncthreads();
      if (b < M) g[b] = sum;
      __syncthreads();
    }
  }

  // total, and the POC (first of equal maxima)
  double acc = 0.0, best = 0.0;
  long long ibest = LLONG_MAX;
  for (long long k = t; k < M; k += kThreads) {
    const double v = g[k];
    acc = acc + v;
    if (ibest == LLONG_MAX || better(v, k, best, ibest)) {
      best = v;
      ibest = k;
    }
  }
  const double total = block_sum(sh, acc);
  sh.red[t] = best;
  sh.redi[t] = ibest;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s && sh.redi[t + s] != LLONG_MAX &&
        (sh.redi[t] == LLONG_MAX || better(sh.red[t + s], sh.redi[t + s], sh.red[t], sh.redi[t]))) {
      sh.red[t] = sh.red[t + s];
      sh.redi[t] = sh.redi[t + s];
    }
    __syncthreads();
  }
  const long long pidx = sh.redi[0];
  __syncthreads();
  const int poc = lab.at(pidx);

  double above = 0.0;
  for (long long k = t; k < M; k += kThreads) above = above + (lab.at(k) > poc ? g[k] : 0.0);
  above = block_sum(sh, above);

  if (t == 0) {
    const double thr = __dmul_rn(total, a.va_frac);
    double cum = g[pidx];
    long long up = pidx + 1, down = pidx - 1, hv = pidx, lv = pidx;
    while (cum < thr) {
      const double cu = up < M ? g[up] + (up + 1 < M ? g[up + 1] : 0.0) : -1.0;
      const double cd = down >= 0 ? g[down] + (down - 1 >= 0 ? g[down - 1] : 0.0) : -1.0;
      const bool go_up = cu > cd, go_down = cu < cd, both = cu == cd && cu != -1.0;
      if (!(go_up || go_down || both)) break;
      cum = cum + (go_up ? cu : (go_down ? cd : cu + cd));
      if (go_up || both) {
        hv = up + 1 < M - 1 ? up + 1 : M - 1;
        up += 2;
      }
      if (go_down || both) {
        lv = down - 1 > 0 ? down - 1 : 0;
        down -= 2;
      }
    }
    a.poc[o] = poc;
    a.hva[o] = lab.at(hv);
    a.lva[o] = lab.at(lv);
    a.pct[o] = (total > 0.0 && above > 0.0) ? __ddiv_rn(above, total) : 0.0;
  }
  __syncthreads();  // thread 0's walk reads g: the next profile waits for it
}

// the rolling window of bar i onto g; returns the window's lowest level
__device__ long long fill_window(Shared& sh, double* g, const Args& a, long long i) {
  const int t = threadIdx.x;
  const long long s = a.start[i], M = a.M;
  long long lo = LLONG_MAX;
  for (long long j = s + t; j <= i; j += kThreads) {
    const long long v = a.low[j];
    if (v < lo) lo = v;
  }
  lo = block_minmax(sh, lo, false);
  for (long long k = t; k < M; k += kThreads) g[k] = 0.0;
  __syncthreads();
  for (long long j = s; j <= i; ++j) {
    const long long off = a.low[j] - lo;
    long long nl = a.nlev[j];
    nl = nl < 0 ? 0 : (nl > a.L ? a.L : nl);
    const float* b = a.buy + j * a.L;
    const float* q = a.sell + j * a.L;
    const long long lim = (M - 1 - off) < nl ? (M - 1 - off) : nl;  // columns below M - 1
    for (long long c = t; c < lim; c += kThreads) {
      g[off + c] = g[off + c] + (static_cast<double>(b[c]) + static_cast<double>(q[c]));
    }
    if (t == 0) {  // the clip column, in ascending column order
      for (long long c = (M - 1 - off) > 0 ? (M - 1 - off) : 0; c < nl; ++c) {
        g[M - 1] = g[M - 1] + (static_cast<double>(b[c]) + static_cast<double>(q[c]));
      }
    }
    __syncthreads();
  }
  return lo;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) profile_kernel(Args a) {
  extern __shared__ double dyn[];
  __shared__ Shared sh;
  double* g = kShared ? dyn : a.scratch + static_cast<long long>(blockIdx.x) * a.M;
  const int t = threadIdx.x;
  if (a.rows == nullptr) {
    for (long long i = a.first + blockIdx.x; i < a.n; i += gridDim.x) {
      const long long lo = fill_window(sh, g, a, i);
      profile(sh, g, a.M, lo, a, i);
    }
  } else {
    for (long long r = blockIdx.x; r < a.n_rows; r += gridDim.x) {
      const double* row = a.rows + r * a.M;
      for (long long k = t; k < a.M; k += kThreads) g[k] = row[k];
      __syncthreads();
      profile(sh, g, a.M, a.row_lo, a, r);
    }
  }
}

int launch(Args a, int shared, long long blocks, void* stream) {
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL || a.M <= 0 || a.M >= 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared) {
    const size_t bytes = static_cast<size_t>(a.M) * sizeof(double);
    cudaError_t e = cudaFuncSetAttribute(profile_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    profile_kernel<true><<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(a);
  } else {
    profile_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most levels the shared-memory grid takes on the current device: the
// block's opt-in shared memory less the kernel's static shared memory, in
// float64 values; 0 if the device cannot be queried.
extern "C" long long fmk_profile_shared_levels() {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&fa, profile_kernel<true>) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  const long long room = static_cast<long long>(optin) - static_cast<long long>(fa.sharedSizeBytes);
  return room > 0 ? room / static_cast<long long>(sizeof(double)) : 0;
}

// Rolling mode: bars i in [first, n), bar i's window [start[i], i]; low and
// nlev int32 per bar, buy and sell float32 (n, L) row-major. Grid of M levels
// in shared memory (shared = 1) or in scratch (blocks rows of M float64).
// n_bins 0: no bucketing. Writes poc, hva, lva (int32) and pct (float64) at
// bars [first, n). Returns cudaGetLastError().
extern "C" int fmk_volume_profile_rolling(const long long* start, const int* low, const int* nlev,
                                          const float* buy, const float* sell, long long L,
                                          long long first, long long n, long long M, int n_bins,
                                          double va_frac, int shared, long long blocks,
                                          double* scratch, int* poc, int* hva, int* lva,
                                          double* pct, void* stream) {
  Args a{start, low, nlev, buy, sell, L, first, n, nullptr, 0, 0,
         M, n_bins, va_frac, scratch, poc, hva, lva, pct};
  return launch(a, shared, blocks, stream);
}

// Rows mode: n_rows rows of M float64 volumes (row-major), level k of every
// row at row_lo + k. Writes poc, hva, lva and pct of each row.
extern "C" int fmk_volume_profile_rows(const double* rows, long long row_lo, long long n_rows,
                                       long long M, int n_bins, double va_frac, int shared,
                                       long long blocks, double* scratch, int* poc, int* hva,
                                       int* lva, double* pct, void* stream) {
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, rows, row_lo, n_rows,
         M, n_bins, va_frac, scratch, poc, hva, lva, pct};
  return launch(a, shared, blocks, stream);
}
