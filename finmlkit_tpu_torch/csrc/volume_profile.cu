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
// Kernel A: a block takes one profile at a time (a grid-stride loop over the
// bars, the rows, or a list of them). Its grid of float64 volumes lives in
// dynamic shared memory, or in the block's row of a global scratch that the
// wrapper allocates where the grid does not fit. Every float64 sum keeps the
// order of the plain version (feature/kernels/volume.py), so that both agree
// bit for bit:
//   1. rolling: the window's lowest level and its span S (max over its bars of
//      low + n_levels, less the lowest level, within [1, max_levels]), one
//      block reduction; then the grid [0, S): thread t owns the columns
//      k = t (mod 256), zeroes them and adds (double)buy + (double)sell of
//      each bar in ascending bar order, so no barrier separates the bars. A
//      column past max_levels - 1 lands on max_levels - 1, added by that
//      column's owner in ascending column order (the target clip, :180).
//      rows: the row is copied and S is one past its last nonzero level.
//   2. optional bucketing into odd-width bins (:117-145): the first and last
//      level of positive volume; then one thread a bin adds its positive
//      levels left to right (segment_sum's order), in place, one chunk of 256
//      bins at a time (a bin never starts below its own index, so a chunk's
//      writes never reach a level that a later bin reads). Only the bins that
//      can hold volume, (kmax - kmin) / width + 1 of them, are formed: S
//      becomes their count. Level labels follow the JAX formulas in wrapping
//      int32 arithmetic (wrap32).
//   3. total and the volume above the POC: each thread adds its levels t,
//      t + 256, ... in order, then a fixed tree over the 256 partials (its
//      levels whose upper half lies past S add nothing and are skipped; the
//      last five run in one warp by shuffles, lane t reading lane t + s).
//   4. POC: a block argmax, the first of equal maxima (NaN the largest).
//   5. the pair volumes of both sides, U_k = g[p+1+2k] + g[p+2+2k] and
//      D_k = g[p-1-2k] + g[p-2-2k], written by all threads into a pool in
//      global memory, with a record of what the walk needs.
// Kernel B: the value-area walk (:74-110): up, down or both by pair volume,
// -1 past either end, until the area holds va_pct of the total or no side
// moves, its cumulative volume one chain of adds in the walk's order. A walk
// is a chain of dependent compares; kernel A's block holds a grid that leaves
// few blocks an SM, and one thread of it would walk while the others wait, so
// the walks run apart: a thread a profile where there are many (hundreds an
// SM), a warp a profile where there are few (its lanes hold the pairs, read
// by shuffles, and take the same steps).
//
// Why working on [0, S) instead of [0, max_levels) changes no bit: every
// level at S and above is +0.0 (no bar reaches it; a row's tail is +-0.0).
// A partial sum starts at +0.0 and can never become -0.0 (x + y is -0.0 only
// if both are), so adding a zero leaves it unchanged, and a partial that gets
// no level stays +0.0 as before; the tree is the same. No zero is positive, so
// the bins and their first and last levels do not change, and no bin past
// (kmax - kmin) / width holds volume. The first of equal maxima lies below S
// unless every level below S is negative, and then it is S itself (a zero),
// which the kernel checks. The walk reads the levels past S as zeros up to
// max_levels and -1 past it: when the down side has ended and the up side
// reads only those zeros, every further step adds zero and cannot reach the
// threshold, so the walk's end (the up side at max_levels, HVA clipped at
// max_levels - 1) is taken in one step. The sign of a zero may differ from
// the plain version's (a +0.0 pair where the row held -0.0 + -0.0), which no
// comparison and no output sees.
//
// Launches: a caller may split kernel A's profiles by span: a first launch
// with a small shared grid (cap levels, more blocks an SM) takes the profiles
// whose span fits and appends the others to a list, which a launch with a
// larger grid takes. Rolling mode sizes the pool by each window's span
// (slots_kernel, then a prefix sum); rows mode gives each row M / 2 + 1.
//
// Bound: the bytes (each bar's n_levels float32 pairs read once, 20 bytes a
// bar written) or the adds (the sum over bars of their windows' levels, at
// the float64 peak), whichever is larger. Kernel A reads each bar once a
// window that holds it (from L2 for neighbouring blocks): that fill, and the
// walk's chain of compares, are what to watch.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 6;  // kernel A: registers for six blocks an SM
constexpr int kWalkThreads = 128; // kernel B's block: a walk a thread
constexpr int kAhead = 32;        // kernel B's thread walk: pairs asked for ahead of use

__device__ __forceinline__ int wrap32(long long v) {
  return static_cast<int>(static_cast<unsigned int>(static_cast<unsigned long long>(v)));
}

// floor division by a positive divisor, as jnp's // on integers
__device__ __forceinline__ long long floordiv(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
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

// what kernel A leaves for the walk of one profile (kernel B)
struct Walk {
  double cum0;     // the POC's volume
  double thr;      // total * va_frac
  long long off;   // the pairs in the pool: U_k at pool[off + k], D_k at pool[off + nu + k]
  long long pidx;  // the POC's grid index
  int nu, nd;      // up pairs below the span, down pairs from level 0
  int num;         // up pairs below max_levels
  Labels lab;
};

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
  long long cap;            // levels the grid holds in this launch (<= M)
  double* scratch;          // gridDim.x rows of cap, the global-grid path only
  const long long* list;    // nullptr: every profile; else list[0] profiles list[1..]
  long long* defer;         // profiles whose span exceeds cap are appended here
  double* pool;             // the pair volumes of every profile
  const long long* offsets; // a profile's place in the pool (nullptr: o * slot)
  long long slot;
  Walk* walks;              // a record a profile, for kernel B
  int* poc;
  double* pct;
};

constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWindowBars = kThreads;  // a window's bars staged in shared memory

struct Shared {
  double red[kThreads];               // the canonical sum's partials
  double wval[kWarps];                // a value a warp
  long long wlo[kWarps], whi[kWarps]; // two integers a warp
  int win_low[kWindowBars];           // the window's bars: low level and n_levels
  int win_nl[kWindowBars];
};

// block min of lo and max of hi (every thread gets both): a warp's by
// shuffles, then the eight warps'
__device__ void block_lohi(Shared& sh, long long& lo, long long& hi) {
  for (int w = 16; w > 0; w >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, w));
    hi = max(hi, __shfl_xor_sync(kFull, hi, w));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh.wlo[warp] = lo;
    sh.whi[warp] = hi;
  }
  __syncthreads();
  lo = sh.wlo[0];
  hi = sh.whi[0];
  for (int w = 1; w < kWarps; ++w) {
    lo = min(lo, sh.wlo[w]);
    hi = max(hi, sh.whi[w]);
  }
  __syncthreads();
}

// The canonical sum: partial t holds levels t, t + 256, ... added in order;
// a fixed tree adds partial t + s into partial t for s = 128, 64, ..., 1.
// A level whose upper half holds only partials at S or above (+0.0, levels
// past the span) changes nothing and is skipped; the levels below 32 run in
// warp 0 by shuffles (lane t reads lane t + s, as the tree does). Every
// thread gets the sum.
__device__ double block_sum(Shared& sh, double acc, long long S) {
  const int t = threadIdx.x;
  int s = kThreads / 2;
  while (s >= 32 && s >= S) s >>= 1;
  if (s >= 32) {
    sh.red[t] = acc;
    __syncthreads();
    for (; s >= 32; s >>= 1) {
      if (t < s) sh.red[t] = sh.red[t] + sh.red[t + s];
      __syncthreads();
    }
    acc = sh.red[t];
  }
  if (t < 32) {
    for (int w = 16; w > 0; w >>= 1) {
      const double o = __shfl_down_sync(kFull, acc, w);
      if (t < w) acc = acc + o;
    }
    if (t == 0) sh.wval[0] = acc;
  }
  __syncthreads();
  const double r = sh.wval[0];
  __syncthreads();
  return r;
}

__device__ __forceinline__ bool better(double a, long long ia, double b, long long ib) {
  const bool na = a != a, nb = b != b;
  if (na != nb) return na;
  if (na || a == b) return ia < ib;
  return a > b;
}

// block argmax of (value, index), the first of equal maxima and NaN the
// largest (a total order, so any reduction order gives it); index LLONG_MAX
// holds nothing. Every thread gets both.
__device__ void block_argmax(Shared& sh, double& v, long long& i) {
  for (int w = 16; w > 0; w >>= 1) {
    const double ov = __shfl_xor_sync(kFull, v, w);
    const long long oi = __shfl_xor_sync(kFull, i, w);
    if (oi != LLONG_MAX && (i == LLONG_MAX || better(ov, oi, v, i))) {
      v = ov;
      i = oi;
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh.wval[warp] = v;
    sh.wlo[warp] = i;
  }
  __syncthreads();
  v = sh.wval[0];
  i = sh.wlo[0];
  for (int w = 1; w < kWarps; ++w) {
    if (sh.wlo[w] != LLONG_MAX && (i == LLONG_MAX || better(sh.wval[w], sh.wlo[w], v, i))) {
      v = sh.wval[w];
      i = sh.wlo[w];
    }
  }
  __syncthreads();
}


// The value-area walk: up pairs U_k (k < nu, then zeros up to k < num, then
// -1), down pairs D_k (k < nd, then -1); cum starts at the POC's volume.
// Returns the steps taken up (x) and down (y). Pairs fetches U_k and D_k.
// Fast loops take the cases in which a step needs no bounds (both sides
// stored; the down side ended; the up side reading zeros against a stored
// down pair of at least zero); anything else is one step of the plain walk.
template <class Pairs>
__device__ __forceinline__ int2 walk(Pairs& pr, int nu, int nd, int num, double cum, double thr) {
  int ua = 0, db = 0;
  bool general = false;
  while (cum < thr) {
    if (!general && ua < nu && db < nd) {        // both sides stored
      do {
        const double u = pr.up(ua), d = pr.down(db);
        const bool gu = u > d, gd = u < d;
        if (!(gu || gd || (u == d && u != -1.0))) {
          general = true;
          break;
        }
        cum = cum + (gu ? u : (gd ? d : u + d));
        ua += gd ? 0 : 1;
        db += gu ? 0 : 1;
      } while (cum < thr && ua < nu && db < nd);
    } else if (!general && ua < nu) {             // the down side has ended: -1
      do {
        const double u = pr.up(ua);
        if (!(u > -1.0)) {
          general = true;
          break;
        }
        cum = cum + u;
        ++ua;
      } while (cum < thr && ua < nu);
    } else if (!general && ua < num && db < nd) { // the up side reads zeros past the span
      do {
        const double d = pr.down(db);
        if (d > 0.0) {
          cum = cum + d;
          ++db;
        } else if (d == 0.0) {
          cum = cum + (0.0 + d);
          ++ua;
          ++db;
        } else {
          general = true;
          break;
        }
      } while (cum < thr && ua < num && db < nd);
    } else {                                      // one step of the plain walk
      const double cu = ua < nu ? pr.up(ua) : (ua < num ? 0.0 : -1.0);
      const double cd = db < nd ? pr.down(db) : -1.0;
      const bool go_up = cu > cd, go_down = cu < cd, both = cu == cd && cu != -1.0;
      if (!(go_up || go_down || both)) break;
      if (go_up && db >= nd && ua >= nu) {  // zeros to the end: cum stays below thr
        ua = num;
        break;
      }
      cum = cum + (go_up ? cu : (go_down ? cd : cu + cd));
      ua += (go_up || both) ? 1 : 0;
      db += (go_down || both) ? 1 : 0;
      general = false;
    }
  }
  return make_int2(ua, db);
}

// a thread's own profile: its pairs read from the pool. The 32 lanes of a
// warp walk 32 profiles, each through its own lines, and a step waits for
// the lane whose pair missed; so each side asks for its lines kAhead pairs
// before it reaches them.
struct ThreadPairs {
  const double* su;
  const double* sd;
  int nu, nd;
  int upf, dpf;  // each side's next pair whose line is asked for
  __device__ static void prefetch(const double* p) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
  }
  __device__ double up(int k) {
    if (k + kAhead >= upf && upf < nu) {
      prefetch(su + upf);
      upf += 16;
    }
    return su[k];
  }
  __device__ double down(int k) {
    if (k + kAhead >= dpf && dpf < nd) {
      prefetch(sd + dpf);
      dpf += 16;
    }
    return sd[k];
  }
};

// a warp's profile: each side's pairs held 32 at a time, a lane each, with
// the next 32 loaded ahead; a pair is read from its lane by a shuffle, so
// every lane takes the same steps. A side's index grows by at most one a
// step, so one refill check a read keeps it within the 32 held.
struct WarpPairs {
  const double* su;
  const double* sd;
  int nu, nd, lane;
  int ubase, dbase;  // the index of each side's first pair held
  double uv, uvn, dv, dvn;
  __device__ WarpPairs(const double* su_, const double* sd_, int nu_, int nd_)
      : su(su_), sd(sd_), nu(nu_), nd(nd_), lane(threadIdx.x & 31), ubase(0), dbase(0) {
    uv = lane < nu ? su[lane] : 0.0;
    uvn = 32 + lane < nu ? su[32 + lane] : 0.0;
    dv = lane < nd ? sd[lane] : 0.0;
    dvn = 32 + lane < nd ? sd[32 + lane] : 0.0;
  }
  __device__ double up(int k) {
    if (k - ubase >= 32) {
      ubase += 32;
      uv = uvn;
      uvn = ubase + 32 + lane < nu ? su[ubase + 32 + lane] : 0.0;
    }
    return __shfl_sync(kFull, uv, k - ubase);
  }
  __device__ double down(int k) {
    if (k - dbase >= 32) {
      dbase += 32;
      dv = dvn;
      dvn = dbase + 32 + lane < nd ? sd[dbase + 32 + lane] : 0.0;
    }
    return __shfl_sync(kFull, dv, k - dbase);
  }
};

// steps 2-5 on the grid g whose levels [0, S) hold the profile (zeros up to
// M), level 0 at lo; thread 0 writes output o
__device__ void profile(Shared& sh, double* __restrict__ g, long long S, long long lo,
                        const Args& a, long long o) {
  const int t = threadIdx.x;
  const long long M = a.M;
  Labels lab{false, lo, 0, 0, 1, 0};
  if (a.n_bins > 0) {
    long long kmin = LLONG_MAX, kmax = -1;
    for (long long k = t; k < S; k += kThreads) {
      if (g[k] > 0.0) {
        if (k < kmin) kmin = k;
        kmax = k;
      }
    }
    block_lohi(sh, kmin, kmax);
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
    const long long nb = has ? (kmax - kmin) / bw + 1 : 1;  // the bins that can hold volume
    for (long long cb = 0; cb < nb; cb += kThreads) {
      const long long b = cb + t;
      double sum = 0.0;
      if (b < nb && has) {
        const long long k0 = kmin + b * bw;
        const long long k1 = k0 + bw < S ? k0 + bw : S;
        for (long long k = k0; k < k1; ++k) {
          const double v = g[k];
          if (v > 0.0) sum = sum + v;
        }
      }
      __syncthreads();
      if (b < nb) g[b] = sum;
      __syncthreads();
    }
    S = nb;
  }
  // ablation anchor: the reductions

  // total, and the POC (first of equal maxima)
  double acc = 0.0, best = 0.0;
  long long pidx = LLONG_MAX;
  for (long long k = t; k < S; k += kThreads) {
    const double v = g[k];
    acc = acc + v;
    if (pidx == LLONG_MAX || better(v, k, best, pidx)) {
      best = v;
      pidx = k;
    }
  }
  const double total = block_sum(sh, acc, S);
  block_argmax(sh, best, pidx);
  if (S < M && best < 0.0) pidx = S;  // every level below S negative: the first zero
  const int poc = lab.at(pidx);

  double above = 0.0;
  for (long long k = t; k < S; k += kThreads) above = above + (lab.at(k) > poc ? g[k] : 0.0);
  above = block_sum(sh, above, S);

  // the pair volumes into the pool: U_k at pool[off + k], D_k at pool[off + nu + k]
  const int nu = pidx + 1 < S ? static_cast<int>((S - pidx) / 2) : 0;  // up pairs below S
  const int nd = static_cast<int>((pidx + 1) / 2);                     // down pairs from 0
  const long long off = a.offsets != nullptr ? a.offsets[o] : o * a.slot;
  double* __restrict__ pu = a.pool + off;
  double* __restrict__ pd = pu + nu;
  for (int k = t; k < nu; k += kThreads) {
    const long long x = pidx + 1 + 2LL * k;
    pu[k] = g[x] + (x + 1 < S ? g[x + 1] : 0.0);
  }
  for (int k = t; k < nd; k += kThreads) {
    const long long x = pidx - 1 - 2LL * k;
    pd[k] = g[x] + (x >= 1 ? g[x - 1] : 0.0);
  }
  if (t == 0) {
    a.walks[o] = Walk{pidx < S ? g[pidx] : 0.0, __dmul_rn(total, a.va_frac), off, pidx, nu, nd,
                      static_cast<int>((M - pidx) / 2), lab};
    a.poc[o] = poc;
    a.pct[o] = (total > 0.0 && above > 0.0) ? __ddiv_rn(above, total) : 0.0;
  }
  __syncthreads();  // every thread reads g: the next profile waits for them
}

// bar i's window: its lowest level and span (block-uniform); if the span fits
// the grid, the grid [0, span) is filled. Returns the span.
__device__ long long fill_window(Shared& sh, double* __restrict__ g, const Args& a, long long i,
                                long long& lo) {
  const int t = threadIdx.x;
  const long long s = a.start[i], M = a.M, L = a.L;
  const bool staged = i - s < kWindowBars;
  long long hi = LLONG_MIN;
  lo = LLONG_MAX;
  for (long long j = s + t; j <= i; j += kThreads) {
    const int v = a.low[j];
    long long nl = a.nlev[j];
    nl = nl < 0 ? 0 : (nl > L ? L : nl);
    if (staged) {
      sh.win_low[j - s] = v;
      sh.win_nl[j - s] = static_cast<int>(nl);
    }
    lo = v < lo ? v : lo;
    hi = v + nl > hi ? v + nl : hi;
  }
  block_lohi(sh, lo, hi);
  long long S = hi - lo;
  S = S < 1 ? 1 : (S > M ? M : S);
  if (S > a.cap) return S;
  for (long long k = t; k < S; k += kThreads) g[k] = 0.0;
  const int owner_clip = static_cast<int>((M - 1) % kThreads);
  for (long long j = s; j <= i; ++j) {  // each column's owner adds the bars in order
    long long off, nl;
    if (staged) {
      off = sh.win_low[j - s] - lo;
      nl = sh.win_nl[j - s];
    } else {
      off = a.low[j] - lo;
      nl = a.nlev[j];
      nl = nl < 0 ? 0 : (nl > L ? L : nl);
    }
    const float* __restrict__ b = a.buy + j * L;
    const float* __restrict__ q = a.sell + j * L;
    const long long lim = (M - 1 - off) < nl ? (M - 1 - off) : nl;  // columns below M - 1
    long long c = (t - off) % kThreads;
    if (c < 0) c += kThreads;
#pragma unroll 4
    for (; c < lim; c += kThreads) {
      g[off + c] = g[off + c] + (static_cast<double>(b[c]) + static_cast<double>(q[c]));
    }
    if (t == owner_clip) {  // the clip column, in ascending column order
      for (long long cc = (M - 1 - off) > 0 ? (M - 1 - off) : 0; cc < nl; ++cc) {
        g[M - 1] = g[M - 1] + (static_cast<double>(b[cc]) + static_cast<double>(q[cc]));
      }
    }
  }
  __syncthreads();
  return S;
}

// row r copied into the grid's first cap levels; returns its span, one past
// its last nonzero level (NaN counts), within [1, M]
__device__ long long fill_row(Shared& sh, double* __restrict__ g, const Args& a, long long r) {
  const int t = threadIdx.x;
  const double* __restrict__ row = a.rows + r * a.M;
  long long last = -1, unused = LLONG_MAX;
  for (long long k = t; k < a.M; k += kThreads) {
    const double v = row[k];
    if (k < a.cap) g[k] = v;
    if (v != 0.0) last = k;
  }
  block_lohi(sh, unused, last);
  return last + 1 < 1 ? 1 : last + 1;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) profile_kernel(Args a) {
  extern __shared__ double dyn[];
  __shared__ Shared sh;
  double* g = kShared ? dyn : a.scratch + static_cast<long long>(blockIdx.x) * a.cap;
  const bool rolling = a.rows == nullptr;
  const long long count = a.list != nullptr ? a.list[0] : (rolling ? a.n - a.first : a.n_rows);
  for (long long r = blockIdx.x; r < count; r += gridDim.x) {
    const long long o = a.list != nullptr ? a.list[1 + r] : (rolling ? a.first + r : r);
    long long lo = a.row_lo;
    const long long S = rolling ? fill_window(sh, g, a, o, lo) : fill_row(sh, g, a, o);
    if (S > a.cap) {
      if (threadIdx.x == 0) {
        const unsigned long long slot =
            atomicAdd(reinterpret_cast<unsigned long long*>(a.defer), 1ULL);
        a.defer[1 + slot] = o;
      }
      continue;
    }
    profile(sh, g, S, lo, a, o);
  }
}

// Kernel B: the value-area walk of profiles [first, n) from kernel A's
// records and pairs, a thread a profile (kWarp false) or a warp a profile;
// writes HVA and LVA.
template <bool kWarp>
__global__ void __launch_bounds__(kWalkThreads) walk_kernel(const Walk* __restrict__ walks,
                                                            const double* __restrict__ pool,
                                                            long long first, long long n,
                                                            long long M, int* hva, int* lva) {
  const long long o = first + (static_cast<long long>(blockIdx.x) * kWalkThreads + threadIdx.x) /
                                  (kWarp ? 32 : 1);
  if (o >= n) return;
  const Walk w = walks[o];  // ablation anchor: the walk
  int2 steps;
  if (kWarp) {
    WarpPairs pr(pool + w.off, pool + w.off + w.nu, w.nu, w.nd);
    steps = walk(pr, w.nu, w.nd, w.num, w.cum0, w.thr);
    if ((threadIdx.x & 31) != 0) return;
  } else {
    ThreadPairs pr{pool + w.off, pool + w.off + w.nu, w.nu, w.nd, 0, 0};
    steps = walk(pr, w.nu, w.nd, w.num, w.cum0, w.thr);
  }
  const long long p = w.pidx;
  const long long hv = steps.x > 0 ? (p + 2LL * steps.x < M - 1 ? p + 2LL * steps.x : M - 1) : p;
  const long long lv = steps.y > 0 ? (p - 2LL * steps.y > 0 ? p - 2LL * steps.y : 0) : p;
  hva[o] = w.lab.at(hv);
  lva[o] = w.lab.at(lv);
}

// each full window's pool slot: its span S (as kernel A finds it) / 2 + 1
__global__ void slots_kernel(const long long* __restrict__ start, const int* __restrict__ low,
                             const int* __restrict__ nlev, long long L, long long first,
                             long long n, long long M, long long* slots) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (i < first) {
    slots[i] = 0;
    return;
  }
  long long lo = LLONG_MAX, hi = LLONG_MIN;
  for (long long j = start[i]; j <= i; ++j) {
    long long nl = nlev[j];
    nl = nl < 0 ? 0 : (nl > L ? L : nl);
    lo = low[j] < lo ? low[j] : lo;
    hi = low[j] + nl > hi ? low[j] + nl : hi;
  }
  long long S = hi - lo;
  S = S < 1 ? 1 : (S > M ? M : S);
  slots[i] = S / 2 + 1;
}

int launch(Args a, int shared, long long blocks, void* stream) {
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL || a.M <= 0 || a.M >= 0x7fffffffLL || a.cap < 1 || a.cap > a.M ||
      (a.cap < a.M && a.defer == nullptr) || a.pool == nullptr || a.walks == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared) {
    const size_t bytes = static_cast<size_t>(a.cap) * sizeof(double);
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

// Kernel A, rolling mode: bars i in [first, n), bar i's window [start[i], i];
// low and nlev int32 per bar, buy and sell float32 (n, L) row-major. Grid of
// cap levels in shared memory (shared = 1) or in scratch (blocks rows of cap
// float64). list: nullptr for every bar, else list[0] bars list[1..]. A bar
// whose window spans more than cap levels is appended to defer (defer[0] its
// count; needed when cap < M). n_bins 0: no bucketing. Writes poc (int32) and
// pct (float64) of the bars it takes, their pair volumes at pool + offsets[i]
// and their walk records (fmk_profile_walk_bytes() each, indexed by bar).
// Returns cudaGetLastError().
extern "C" int fmk_volume_profile_rolling(const long long* start, const int* low, const int* nlev,
                                          const float* buy, const float* sell, long long L,
                                          long long first, long long n, long long M, int n_bins,
                                          double va_frac, long long cap, int shared,
                                          long long blocks, double* scratch,
                                          const long long* list, long long* defer, double* pool,
                                          const long long* offsets, void* walks, int* poc,
                                          double* pct, void* stream) {
  Args a{start, low, nlev, buy, sell, L, first, n, nullptr, 0, 0, M, n_bins, va_frac,
         cap, scratch, list, defer, pool, offsets, 0, static_cast<Walk*>(walks), poc, pct};
  return launch(a, shared, blocks, stream);
}

// Kernel A, rows mode: n_rows rows of M float64 volumes (row-major), level k of
// every row at row_lo + k; row r's pairs at pool + r * (M / 2 + 1). cap, list,
// defer and the outputs as in rolling mode.
extern "C" int fmk_volume_profile_rows(const double* rows, long long row_lo, long long n_rows,
                                       long long M, int n_bins, double va_frac, long long cap,
                                       int shared, long long blocks, double* scratch,
                                       const long long* list, long long* defer, double* pool,
                                       void* walks, int* poc, double* pct, void* stream) {
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, rows, row_lo, n_rows,
         M, n_bins, va_frac, cap, scratch, list, defer, pool, nullptr, M / 2 + 1,
         static_cast<Walk*>(walks), poc, pct};
  return launch(a, shared, blocks, stream);
}

// Bytes of one walk record.
extern "C" long long fmk_profile_walk_bytes() { return static_cast<long long>(sizeof(Walk)); }

// Each bar's pool slot (doubles) in rolling mode: 0 below first, else its
// window's span / 2 + 1. Returns cudaGetLastError().
extern "C" int fmk_profile_slots(const long long* start, const int* low, const int* nlev,
                                 long long L, long long first, long long n, long long M,
                                 long long* slots, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + 255) / 256;
  slots_kernel<<<static_cast<unsigned>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      start, low, nlev, L, first, n, M, slots);
  return static_cast<int>(cudaGetLastError());
}

// Kernel B: the walks of profiles [first, n) from kernel A's records and
// pools, a thread a profile (warp = 0) or a warp a profile (warp = 1); writes
// hva and lva (int32). Returns cudaGetLastError().
extern "C" int fmk_profile_walk(const void* walks, const double* pool, long long first,
                                long long n, long long M, int warp, int* hva, int* lva,
                                void* stream) {
  if (n <= first) return 0;
  const long long per_block = warp ? kWalkThreads / 32 : kWalkThreads;
  const long long blocks = (n - first + per_block - 1) / per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Walk* w = static_cast<const Walk*>(walks);
  if (warp) {
    walk_kernel<true><<<static_cast<unsigned>(blocks), kWalkThreads, 0, s>>>(w, pool, first, n,
                                                                           M, hva, lva);
  } else {
    walk_kernel<false><<<static_cast<unsigned>(blocks), kWalkThreads, 0, s>>>(w, pool, first, n,
                                                                            M, hva, lva);
  }
  return static_cast<int>(cudaGetLastError());
}
