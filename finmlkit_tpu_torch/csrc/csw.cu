// Kernel W: the sup statistic of the Chu-Stinchcombe-White CUSUM break test.
//
// Not a TPU kernel: it replaces the XLA lax.map over blocks of 128 t's of
// finmlkit_tpu/feature/kernels/structural_break.py:55 (_csw_rolling_impl),
// each block a (128, w - 1) matrix of lags reduced by _sup_stat (:23).
//
// For each t, over the lags k = 2 .. kmax (kmax = t_loc - 1, t_loc = min(t, w)):
//   dyn = y[t] - y[t - k], denom = sigma[t] * sqrt(k), admissible if
//   denom > 1e-16; s = |dyn| / denom; s_up = s where dyn > 0 (or NaN), else 0;
//   s_down = s where dyn < 0 (or NaN), else 0.
// up is the largest s_up, and its critical value sqrt(4.6 + log k*) at the
// lag k* that reaches it, the largest such lag on equal values (the
// reference's loop keeps the first of equal values while it walks k
// downward); down likewise. A NaN among the values, an infinite maximum or no
// admissible lag gives (-1e-6, 0), as the reference's floor of -1e-6 and its
// isfinite test do (:38-48). sqrt(k) and sqrt(4.6 + log k) come from tables
// that the wrapper computes once on the host, so that the kernel and the plain
// version do the same float operations: a subtraction, a product and a
// quotient, each rounded to nearest through the intrinsics. Their results are
// equal bit for bit.
//
// Bound: operations, about 4 float64 operations a (t, lag) pair; the bytes (y
// and sigma read, four values written a t) are few. What cost the time was
// not the bound's work but a correctly rounded division and two sides' float64
// compares for every pair. This design takes the division off nearly every
// pair. One warp a t, one launch; lane l takes the lags k0 + l, k0 + l + 32, ...
//
//   0. The first admissible lag k0. RN(sigma * sqrt_k[k]) does not decrease in
//      k (the table does not decrease, and rounding to nearest is monotone),
//      so `denom > 1e-16` holds exactly for k >= k0: a binary search on the
//      table finds k0 (k0 = 2 at once in the usual case). A NaN sigma admits
//      no lag. After it no lag is tested again.
//   1. Pass 1, no division. Each lane takes p_k = RN(dyn_k * isq[k]), isq[k] =
//      RN(2^100 / sqrt_k[k]) (a table of the wrapper's), and keeps its largest
//      p (the up side, dyn > 0) and its smallest (the down side, dyn < 0) with
//      their lags. Each lane then divides once a side at that lag: s =
//      RN(|dyn| / denom) is the lag's exact step, and from it and the sign of
//      the fused remainder |dyn| - s denom, L_lane = RD(|dyn| / denom) <= that
//      lag's exact quotient; the warp's largest is L <= q*, the side's largest
//      exact quotient. T = pred(L), the next double below L. The lane offers
//      (s, k) where s > T (at or below T it cannot win, as below).
//   2. Pass 2, the unchanged exact step for what may win. A lane is walked
//      again only if the upper bound U = RU(P * C) of its side's quotients
//      (P its largest |p| on the side, C = RU(RU(2^-100 / sigma) * (1 +
//      2^-44))) is not below T; the warp walks each such lane's lags together,
//      a lag a lane. There a lag (but the lane's best, already offered) is
//      divided only if NOT |dyn| < RD(T * denom); the survivors take s =
//      RN(|dyn| / denom) and the old offer of (s, k). The lanes that hold an
//      offer join (the larger value, on equal values the larger lag:
//      associative and commutative), and lane 0 offers (0, kmax) to both
//      sides and writes them.
//
// Why the result is bit for bit the plain version's (q_k = |dyn_k| / denom_k,
// exact; fl = rounding to nearest; u = 2^-53):
//   - Zeros. Every admissible lag offers a side either 0 or its quotient (>=
//     0). A side's maximum is therefore 0 only if every admissible lag offers
//     0, and then the largest lag, kmax (admissible, as k0 <= kmax), wins. So
//     the 0 offers of a side, from lags of the other sign, from dyn = 0 (or
//     -0.0) and from quotients that round to 0, matter only through (0, kmax),
//     which lane 0 offers once; where a quotient is above 0 it beats (0, kmax),
//     and (0, kmax) never beats anything that it should not.
//   - Which lags may win. fl is monotone, so a side's result is fl(q*), and
//     only lags with fl(q_k) = fl(q*) win or tie. T < L <= q* and L is a
//     double, so T < L <= fl(q*). A lag that is dropped has q_k < T, so
//     fl(q_k) <= T < fl(q*): it neither wins nor ties; nor does a best lag
//     whose s = fl(q_k) <= T, which is not offered. The lag test: RD(T *
//     denom) <= T * denom, so |dyn| < RD(T * denom) gives q_k < T; an overflow
//     of T * denom rounds down to DBL_MAX and keeps it true. The lane test:
//     for every lag of the side in the lane, q_k <= U (below), so U < T gives
//     q_k < T for all of them.
//   - Distinct quotients that round equal are not dropped: fl(q_k) = fl(q*)
//     > T and T is a double, so q_k > T, and neither test can drop them.
//     Without the step from L to pred(L), a lag with q_k < L = fl(q*) that
//     rounds up to fl(q*) would be dropped, and it may be the larger lag of a
//     tie (tests/test_torch_csw_filter.py holds such a case).
//   - U bounds the lane. In the fast path (below) |dyn| >= 2^-1074 or dyn = 0,
//     and isq[k] >= 2^100 / 2^31.5, so a nonzero x = dyn * isq[k] is a normal
//     number and |x| <= |p| / (1 - u). With isq[k] >= (2^100 / sqrt_k[k]) (1 -
//     e), e <= 2^-46 (the table rounds once), and denom >= sigma sqrt_k[k] (1 -
//     u) (a normal product), q_k = |dyn| / denom <= |p| 2^-100 / (sigma (1 -
//     e) (1 - u)^2) <= P C, because (1 + 2^-44) >= 1 / ((1 - e) (1 - u)^2).
//     Every rounding in U and C is upward; a U that overflows is infinite and
//     keeps the lane. A lane with no lag of the side (no p of that sign) is
//     not walked for it; in the fast path p = 0 only where dyn = 0 (no
//     underflow, as above), and those lags only offer 0.
//   - The edge of admissibility: the lags below k0 are not admissible and
//     offer nothing, in the plain version too; the search uses the plain
//     version's own test, `RN(sigma * sqrt_k[k]) > 1e-16`.
//   - t < w and t < 3: kmax = t_loc - 1 = t - 1; with kmax < 2 or no
//     admissible lag both sides are (-1e-6, 0), as in the plain version.
//   - NaN, +-inf and huge values take the exact path. The fast path runs only
//     where every p is finite (so every dyn is finite, and no product
//     overflowed) and the denominator at kmax, the largest, is finite. Else
//     the warp runs the plain rule over every admissible lag, in rounds of 32:
//     each lag's exact quotient and both offers, the NaN mark as before. A NaN
//     dyn (at an admissible lag) marks both sides NaN, so once a round has
//     seen one, both sides are (-1e-6, 0) and the warp stops. An infinite dyn
//     gives an infinite quotient, or NaN over an infinite denominator: that
//     side is (-1e-6, 0) as before. In the fast path a quotient may still
//     overflow to inf (|dyn| up to 2^924 over denom near 1e-16); its lag is
//     never dropped (q_k > T, T finite), and write_side floors the side.
//   - A subnormal dyn: x is normal (above), p is not 0, its side sees the lag;
//     L may round down to 0, and then T = -2^-1074 drops nothing.
//   - L = 0 (all the side's quotients round down to 0): T < 0 drops nothing.
//     No lag of a side anywhere in the warp: L = -inf, and no lane is walked
//     for that side; its result is (0, kmax).
//
// With a non-null `stats`, each t also writes four ints: the admissible lags,
// the lags walked in pass 2 (every lag on the exact path), the quotients taken
// there, and the path (the lanes walked again; -1 the exact path, -2 stopped
// at a NaN, -3 no admissible lag).
// This file must not be built with -ftz or --use_fast_math (nor does any
// float32 enter it): the bounds rely on IEEE float64 directed rounding.
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr double kAdmit = 1e-16;
constexpr double kIsqScale = 0x1p-100;  // isq[k] = RN(2^100 / sqrt_k[k])
constexpr double kSlack = 1.0 + 0x1p-44;

struct Best {
  double v;  // the largest value so far (-inf: none)
  int k;     // its lag, the largest of equal values (-1: none)
  bool nan;  // a NaN value was met
};

__device__ __forceinline__ void offer(Best& b, double v, int k, bool nan = false) {
  if (v != v || nan) {
    b.nan = true;
  } else if (v > b.v || (v == b.v && k > b.k)) {
    b.v = v;
    b.k = k;
  }
}

// Every lane's Best offered to every lane's: the larger value, on equal
// values the larger lag, NaN marks joined. Only the lanes that hold an offer
// take part (after pass 2, one or two).
__device__ __forceinline__ void merge_lanes(Best& b) {
  unsigned held = __ballot_sync(kFull, b.k >= 0 || b.nan);
  Best m{-INFINITY, -1, false};
  while (held) {
    const int l = __ffs(held) - 1;
    held &= held - 1;
    offer(m, __shfl_sync(kFull, b.v, l), __shfl_sync(kFull, b.k, l),
          __shfl_sync(kFull, static_cast<int>(b.nan), l) != 0);
  }
  b = m;
}

__device__ __forceinline__ void write_side(const Best& b, const double* crit, double* val,
                                           double* cv, long long t) {
  const bool has = !b.nan && isfinite(b.v) && b.v > -1e-6;
  val[t] = has ? b.v : -1e-6;
  cv[t] = (has && b.k > 0) ? crit[b.k] : 0.0;
}

__device__ __forceinline__ bool admissible(double sig, double sqrt_k) {
  return __dmul_rn(sig, sqrt_k) > kAdmit;
}

// The first admissible lag of 2 .. kmax, or kmax + 1 if there is none. Every
// lane computes the same.
__device__ int first_admissible(double sig, const double* sqrt_k, int kmax) {
  if (kmax < 2) return kmax + 1;
  const double s_max = sqrt_k[kmax], s_2 = sqrt_k[2];  // loaded together
  if (!admissible(sig, s_max)) return kmax + 1;
  if (admissible(sig, s_2)) return 2;
  int lo = 3, hi = kmax;  // lo - 1 not admissible, hi admissible
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (admissible(sig, sqrt_k[mid])) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// The warp's largest of x >= 0 (+0 or more; not -0.0, not NaN), in every
// lane: such doubles order as their bits do, so two integer reductions (the
// high words, then the low words of the lanes that hold the largest high
// word) find it.
__device__ __forceinline__ double warp_max_nonneg(double x) {
  const unsigned long long bits = static_cast<unsigned long long>(__double_as_longlong(x));
  const unsigned hi = static_cast<unsigned>(bits >> 32), lo = static_cast<unsigned>(bits);
  const unsigned top = __reduce_max_sync(kFull, hi);
  const unsigned low = __reduce_max_sync(kFull, hi == top ? lo : 0u);
  return __longlong_as_double(static_cast<long long>(
      (static_cast<unsigned long long>(top) << 32) | low));
}

// Pass 1's step at lag k: p = (y0 - yk) * isq_k; the lane's largest and
// smallest p with their lags, and whether p is finite.
__device__ __forceinline__ void pass1_step(double y0, double yk, double isq_k, int k,
                                           double& pu, int& ku, double& pd, int& kd,
                                           bool& bad) {
  const double p = __dmul_rn(__dsub_rn(y0, yk), isq_k);
  bad |= !(fabs(p) <= DBL_MAX);
  if (p > pu) { pu = p; ku = k; }
  if (p < pd) { pd = p; kd = k; }
}

// RD(x / y) from s = RN(x / y), for x >= 0 finite and y a finite normal
// number > 0: the remainder x - s y, computed in one fused operation, has
// the sign of the exact remainder (a rounding never changes a sign; an
// underflow to zero keeps it in the sign bit), so s is above x / y exactly
// when its sign bit is set, and then RD is the double below s (DBL_MAX for s
// = inf, x / y above DBL_MAX).
__device__ __forceinline__ double round_down(double s, double x, double y) {
  if (!signbit(__fma_rn(-s, y, x))) return s;
  return __longlong_as_double(__double_as_longlong(s) - 1);
}

// The next double below x, for x >= 0 or x = -inf (kept).
__device__ __forceinline__ double pred(double x) {
  if (x > 0.0) return __longlong_as_double(__double_as_longlong(x) - 1);
  return x == 0.0 ? -0x1p-1074 : x;
}

struct Count {
  int lags = 0;    // admissible lags
  int walked = 0;  // lags walked in pass 2 (the exact path: every lag)
  int exact = 0;   // quotients taken there
  int path = 0;    // lanes walked again; -1 exact path, -2 NaN, -3 none admissible
};

// The plain rule over every admissible lag, in rounds of 32 lags. Returns
// false, having stopped, once a round has met a NaN dyn. yt points at y[t].
__device__ bool exact_lags(const double* yt, const double* sqrt_k, double sig, int k0,
                           int kmax, int lane, Best& bu, Best& bd, Count& c) {
  for (int base = k0; base <= kmax; base += 32) {
    const int k = base + lane;
    bool nan = false;
    if (k <= kmax) {
      const double dyn = __dsub_rn(*yt, yt[-k]);
      const double s = __ddiv_rn(fabs(dyn), __dmul_rn(sig, sqrt_k[k]));
      nan = dyn != dyn;
      offer(bu, (dyn > 0.0 || nan) ? s : 0.0, k);
      offer(bd, (dyn < 0.0 || nan) ? s : 0.0, k);
      ++c.walked;
      ++c.exact;
    }
    if (__any_sync(kFull, nan)) return false;
  }
  return true;
}

// The statistic of one t, both sides, complete in every lane. Returns false
// if both sides are (-1e-6, 0) by a NaN or by no admissible lag.
__device__ bool sup_stat_t(const double* __restrict__ yt, const double* __restrict__ sqrt_k,
                           const double* __restrict__ isq, int kmax, double y0, double sig,
                           int lane, Best& bu, Best& bd, Count& c) {
  const int k0 = first_admissible(sig, sqrt_k, kmax);
  if (k0 > kmax) {
    c.path = -3;
    return false;
  }
  c.lags = kmax - k0 + 1;
  // U's factor, here so that its division overlaps pass 1's loads
  const double cc = __dmul_ru(__ddiv_ru(kIsqScale, sig), kSlack);
  // Pass 1: each lane's largest and smallest p, with their lags.
  bool bad = !(__dmul_rn(sig, sqrt_k[kmax]) <= DBL_MAX);
  double pu = 0.0, pd = 0.0;
  int ku = -1, kd = -1;
  if (!bad) {
    int k = k0 + lane;
    for (; k + 96 <= kmax; k += 128) {  // four lags, their loads issued together
      const double y1 = yt[-k], y2 = yt[-(k + 32)], y3 = yt[-(k + 64)], y4 = yt[-(k + 96)];
      const double i1 = isq[k], i2 = isq[k + 32], i3 = isq[k + 64], i4 = isq[k + 96];
      pass1_step(y0, y1, i1, k, pu, ku, pd, kd, bad);
      pass1_step(y0, y2, i2, k + 32, pu, ku, pd, kd, bad);
      pass1_step(y0, y3, i3, k + 64, pu, ku, pd, kd, bad);
      pass1_step(y0, y4, i4, k + 96, pu, ku, pd, kd, bad);
    }
    for (; k <= kmax; k += 32) pass1_step(y0, yt[-k], isq[k], k, pu, ku, pd, kd, bad);
  }
  if (__any_sync(kFull, bad)) {  // the exact path
    c.path = -1;
    if (!exact_lags(yt, sqrt_k, sig, k0, kmax, lane, bu, bd, c)) {
      c.path = -2;
      return false;
    }
    merge_lanes(bu);
    merge_lanes(bd);
    return true;
  }
  // The exact step at each lane's best lag of a side, once: its quotient
  // rounded to nearest is that lag's offer, and rounded down, L_lane (both
  // sides in straight-line code, so the divisions overlap).
  const int ju = ku >= 0 ? ku : k0, jd = kd >= 0 ? kd : k0;
  const double xu = fabs(__dsub_rn(y0, yt[-ju])), xd = fabs(__dsub_rn(y0, yt[-jd]));
  const double nu = __dmul_rn(sig, sqrt_k[ju]), nd = __dmul_rn(sig, sqrt_k[jd]);
  const double su = __ddiv_rn(xu, nu), sd = __ddiv_rn(xd, nd);
  const double du = round_down(su, xu, nu), dd = round_down(sd, xd, nd);
  // (L >= 0 where a lane has the side; no lane with it: L = -inf)
  const double lu = __any_sync(kFull, ku >= 0) ? warp_max_nonneg(ku >= 0 ? du : 0.0) : -INFINITY;
  const double ld = __any_sync(kFull, kd >= 0) ? warp_max_nonneg(kd >= 0 ? dd : 0.0) : -INFINITY;
  const double tu = pred(lu), td = pred(ld);
  // the best lags' offers, where they may win (above T; see below)
  if (ku >= 0 && su > tu) offer(bu, su, ku);
  if (kd >= 0 && sd > td) offer(bd, sd, kd);
  // The lanes whose bound U is not below T are walked again.
  const bool again = (ku >= 0 && !(__dmul_ru(pu, cc) < tu)) ||
                     (kd >= 0 && !(__dmul_ru(-pd, cc) < td));
  unsigned lanes = __ballot_sync(kFull, again);
  c.path = __popc(lanes);
  // Pass 2 (ablation anchor): the exact step for the lags that pass the test,
  // but the lane's best lags, which have had it.
  while (lanes) {
    const int i = __ffs(lanes) - 1;
    lanes &= lanes - 1;
    const int iu = __shfl_sync(kFull, ku, i), id = __shfl_sync(kFull, kd, i);
    for (int k = k0 + i + 32 * lane; k <= kmax; k += 32 * 32) {
      const double dyn = __dsub_rn(y0, yt[-k]);
      const double denom = __dmul_rn(sig, sqrt_k[k]);
      const double th = dyn > 0.0 ? tu : td;
      ++c.walked;
      if (dyn != 0.0 && k != (dyn > 0.0 ? iu : id) && !(fabs(dyn) < __dmul_rd(th, denom))) {
        const double s = __ddiv_rn(fabs(dyn), denom);
        if (dyn > 0.0) offer(bu, s, k); else offer(bd, s, k);
        ++c.exact;
      }
    }
  }
  merge_lanes(bu);
  merge_lanes(bd);
  offer(bu, 0.0, kmax);  // the zeros of every side (see above)
  offer(bd, 0.0, kmax);
  return true;
}

__global__ void __launch_bounds__(kThreads, 4)
csw_kernel(const double* __restrict__ y, const double* __restrict__ sigma,
           const double* __restrict__ sqrt_k, const double* __restrict__ isq,
           const double* __restrict__ crit, long long n, long long w,
           double* __restrict__ up, double* __restrict__ down, double* __restrict__ cu,
           double* __restrict__ cd, int* __restrict__ stats) {
  const long long t = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= n) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int kmax = static_cast<int>((t < w ? t : w) - 1);
  Best bu{-INFINITY, -1, false}, bd{-INFINITY, -1, false};
  Count c;
  const bool any = sup_stat_t(y + t, sqrt_k, isq, kmax, y[t], sigma[t], lane, bu, bd, c);
  if (stats != nullptr) {
    const int walked = __reduce_add_sync(kFull, c.walked);
    const int exact = __reduce_add_sync(kFull, c.exact);
    if (lane == 0) {
      stats[4 * t] = c.lags;
      stats[4 * t + 1] = walked;
      stats[4 * t + 2] = exact;
      stats[4 * t + 3] = c.path;
    }
  }
  if (lane == 0) {
    if (!any) bu = bd = Best{-INFINITY, -1, false};
    write_side(bu, crit, up, cu, t);
    write_side(bd, crit, down, cd, t);
  }
}

}  // namespace

// Kernel W: up, down and their critical values cu, cd for each of n t's, from
// the log prices y, the per-t sigma, the window w (< 2^31), and the tables
// sqrt_k[k] = sqrt(k), isq[k] = RN(2^100 / sqrt_k[k]) and crit[k] = sqrt(4.6 +
// log k) for k < w. All float64, contiguous. `stats` is null, or 4 n ints (see
// the header). Returns cudaGetLastError().
extern "C" int fmk_csw_sup_stat(const double* y, const double* sigma, const double* sqrt_k,
                                const double* isq, const double* crit, long long n,
                                long long w, double* up, double* down, double* cu,
                                double* cd, int* stats, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL || w > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  csw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, sigma, sqrt_k, isq, crit, n, w, up, down, cu, cd, stats);
  return static_cast<int>(cudaGetLastError());
}
