// Kernel E: the event-jump boundary scans of the information-driven bars.
//
// Not a TPU kernel: the JAX package runs these scans as XLA while_loops
// (finmlkit_tpu/bar/indexers.py _volume_boundaries :368, _cusum_boundaries
// :508, _info_bar_boundaries :680). PyTorch has no loop that stays on the
// device, so a literal port would read the card once per chunk and per bar;
// this kernel runs the whole scan in one call and the host reads the count
// once. One mode argument selects the bar type:
//   0 CUSUM      s+ = max(0, s+ + r), s- = min(0, s- + r); a trade i closes
//                when can_close[i] and (s+ >= lam[i] or s- <= -lam[i]); s+
//                takes precedence and only the triggered side resets;
//   1 imbalance  |in-bar sum of w| >= theta;
//   2 run        max(in-bar sum of buy w, in-bar sum of sell |w|) >= theta;
//                in modes 1 and 2 theta = E[T] * E[rate], whose EMAs update
//                at each close from the bar's length and statistic;
//   3 volume     the int64 in-bar sum of amount units >= thr, reset to zero.
//
// The walk. Trades start .. n-1 are cut into tiles of 2048 trades counted from
// `start`, a tile into 8 segments of 256. One warp walks a segment from the
// state it enters with: each lane holds 8 consecutive trades; each in-bar
// statistic is a prefix under an associative combine (a sum, a pair of sums,
// or for CUSUM the composition of the maps s -> max(a, s + b) and
// s -> min(c, s + b)), so a warp-shuffle scan from the state gives every
// trade's statistic and a ballot finds the first closing trade. After a close
// the state resets and the rest of the segment is scanned again, the trades up
// to the close masked out. The arithmetic of a segment depends only on the
// segment and the state it enters with, so two walks that enter a tile with
// bitwise-equal states agree from there on: that makes the stream splittable.
//
// Design, five launches on one stream:
//   1. summaries, all SMs: every segment is scanned once from the identity, as
//      a walk entering it would scan it, and keeps its end aggregate and bounds
//      on its statistic (volume the largest prefix; imbalance the largest and
//      smallest; run the largest buy and sell sums; CUSUM the composed clamp
//      map's extremes and the smallest lam over the trades that may close).
//      Rounding is monotone, so a walk that enters the segment with state s
//      can tell from s and the bounds alone, exactly, that no trade of it
//      closes; it then takes the segment's end state from the end aggregate in
//      O(1), bit for bit what a scan would give. Other segments are scanned.
//   2. pass 1: the tiles are cut into chunks of whole tiles, one warp each;
//      chunk 0 walks from the true initial state, every other chunk from the
//      mode's reset state. Each tile records its closes (one bit a trade),
//      their count and the state at its end.
//   3. pass 2: every chunk c > 0 walks again from chunk c-1's pass-1 end
//      state, rewriting its tiles, until a tile end where its state equals,
//      bit for bit, the recorded one: from there both walks are identical.
//   4. fix-up, one warp: in chunk order, every chunk whose last walk did not
//      start from its predecessor's final end state is walked again from it,
//      with the same stop rule. Where walks meet (CUSUM once both sides clamp
//      to 0; volume once one trade covers both walks' offset) it finds little
//      to do; where they never meet it is the sequential walk, chunk after
//      chunk, with the skips of 1: EMA thresholds never agree bit for bit, and
//      imbalance sums of +-1 keep two walks' difference modulo theta.
//   5. compaction: kernel S scans the tiles' close counts (the wrapper counts
//      it as a launch of S); one warp a tile writes its close indices, the
//      first max_out of them, and the count.
// The result does not depend on the number of chunks or on scheduling: each
// tile's record is a walk from its true entry state. One chunk is the
// sequential walk.
//
// Bound: the walk's latency, not device memory. A step is a skip (a few
// dependent float64 operations on a summary in shared memory, requested two
// tiles ahead) or a segment scan (a 3-level tree in each lane, a 5-level
// shuffle scan, a ballot; its inputs prefetched into L2 three tiles ahead),
// one warp at a time; chunks run on all SMs. A scanned segment costs several
// times a skip: float64 latency on one warp's chain of combines.
// The EMA updates use explicitly rounded operations (no fused multiply-add),
// so that they round as the plain PyTorch version and XLA do.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstring>

extern "C" long long fmk_scan_scratch_bytes(int dtype, long long rows, long long n);
extern "C" int fmk_prefix_scan(int dtype, const void* x, void* out,
                               void* scratch, long long n, void* stream);

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 trades per tile
constexpr int kSeg = 32 * kItems;         // 256 trades per segment, one warp
constexpr int kSegs = kTile / kSeg;       // 8 segments per tile
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kAlign = 256;

struct Args {
  const double* x;                 // CUSUM log returns, or info weights
  const double* lam;               // CUSUM per-trade thresholds
  const unsigned char* can_close;  // CUSUM same-timestamp rule mask
  const long long* units;          // volume amount units
  long long n, start;              // stream length; first trade checked
  double e_t, e_r, alpha_t, alpha_r;  // info: E0[T], E0[rate], EMA rates
  long long thr;                   // volume: the threshold in amount units
};

// Scratch, per tile and per chunk. States and summaries are stored as the
// mode's structs in the untyped regions.
struct Work {
  long long tiles, per_chunk, chunks;  // chunk c: tiles [c * per_chunk, ...)
  void* sums;                 // per segment: the mode's Sum
  void* states;               // per tile: the state at its end, last walk
  void* used;                 // per chunk: the state its last walk began with
  void* end1;                 // per chunk: its pass-1 end state
  unsigned char* flags;       // per tile: one byte a lane and segment, a bit a trade
  long long* cnt;             // per tile: its closes, last walk
  long long* incl;            // per tile: inclusive prefix of cnt
  void* scan_scratch;         // kernel S's scratch for cnt
  long long* stats;           // segments skipped, segments scanned, pass-2
                              // chunks that did not merge, chunks fixed up
};

__device__ __forceinline__ double shfl_up(double x, int o) {
  return __shfl_up_sync(kFull, x, o);
}
__device__ __forceinline__ long long shfl_up(long long x, int o) {
  return __shfl_up_sync(kFull, x, o);
}
__device__ __forceinline__ double shfl_x(double x, int o) {
  return __shfl_xor_sync(kFull, x, o);
}
__device__ __forceinline__ long long shfl_x(long long x, int o) {
  return __shfl_xor_sync(kFull, x, o);
}
__device__ __forceinline__ bool same(double x, double y) {
  return __double_as_longlong(x) == __double_as_longlong(y);
}
// max and min that let a NaN through, so that a bound holding one never
// allows a skip (every comparison with NaN is false)
__device__ __forceinline__ double max_nan(double x, double y) {
  return (x != x || x > y) ? x : y;
}
__device__ __forceinline__ double min_nan(double x, double y) {
  return (x != x || x < y) ? x : y;
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}
// Asynchronous copy of `bytes` (a multiple of 16) from src to dst in shared
// memory, both 16-byte aligned, 16 bytes a request, by the lanes of a warp.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes) {
  const char* s = static_cast<const char*>(src);
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  for (int k = threadIdx.x & 31; k < bytes / 16; k += 32)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d + 16 * k),
                 "l"(s + 16 * k) : "memory");
}

// ---- CUSUM ---------------------------------------------------------------
struct Cusum {
  // s+ -> max(a, s+ + b), s- -> min(c, s- + b)
  struct E { double a, c, b; };
  struct In { double r, lam; unsigned char cc; };
  struct State { double sp, sn; };
  // over the trades that may close: the largest a and b, the smallest c, b
  // and lam; a NaN in a, b or c leaves a NaN that forbids the skip
  struct Bounds { double amax, bmax, cmin, bmin, lmin; };

  __device__ static E identity() { return {-INFINITY, INFINITY, 0.0}; }
  __device__ static E elem(const In& v) { return {0.0, 0.0, v.r}; }
  // x then y
  __device__ static E combine(const E& x, const E& y) {
    return {fmax(y.a, x.a + y.b), fmin(y.c, x.c + y.b), x.b + y.b};
  }
  __device__ static E shfl(const E& x, int o) {
    return {shfl_up(x.a, o), shfl_up(x.c, o), shfl_up(x.b, o)};
  }
  __device__ static State init(const Args&) { return {0.0, 0.0}; }
  __device__ static State reset(const Args&, long long) { return {0.0, 0.0}; }
  __device__ static In load(const Args& a, long long g) {
    if (g >= a.n) return {0.0, INFINITY, 0};
    return {a.x[g], a.lam[g], a.can_close[g]};
  }
  __device__ static void prefetch(const Args& a, long long g) {
    if (g < a.n) { prefetch_l2(a.x + g); prefetch_l2(a.lam + g); prefetch_l2(a.can_close + g); }
  }
  // Whether the trade with in-segment aggregate p closes (no branch), and
  // the state after it does.
  __device__ static bool test(const E& p, const In& v, const State& s, const Args&) {
    const double sp = fmax(p.a, s.sp + p.b);
    const double sn = fmin(p.c, s.sn + p.b);
    return (v.cc != 0) & ((sp >= v.lam) | (sn <= -v.lam));
  }
  __device__ static State next(const E& p, const In& v, const State& s,
                               long long, const Args&) {
    const double sp = fmax(p.a, s.sp + p.b);
    const double sn = fmin(p.c, s.sn + p.b);
    return sp >= v.lam ? State{0.0, sn} : State{sp, 0.0};
  }
  __device__ static State at_end(const E& p, const State& s) {
    return {fmax(p.a, s.sp + p.b), fmin(p.c, s.sn + p.b)};
  }
  __device__ static bool same_state(const State& x, const State& y) {
    return same(x.sp, y.sp) && same(x.sn, y.sn);
  }
  __device__ static Bounds empty() {
    return {-INFINITY, -INFINITY, INFINITY, INFINITY, INFINITY};
  }
  __device__ static void add(Bounds& m, const E& p, const In& v) {
    if (!v.cc) return;
    m.amax = max_nan(p.a, m.amax);
    m.bmax = max_nan(p.b, m.bmax);
    m.cmin = min_nan(p.c, m.cmin);
    m.bmin = min_nan(p.b, m.bmin);
    m.lmin = fmin(m.lmin, v.lam);  // a NaN lam never closes: ignore it
  }
  __device__ static Bounds merge(const Bounds& x, const Bounds& y) {
    return {max_nan(x.amax, y.amax), max_nan(x.bmax, y.bmax),
            min_nan(x.cmin, y.cmin), min_nan(x.bmin, y.bmin), fmin(x.lmin, y.lmin)};
  }
  __device__ static Bounds shfl_bounds(const Bounds& m, int o) {
    return {shfl_x(m.amax, o), shfl_x(m.bmax, o), shfl_x(m.cmin, o),
            shfl_x(m.bmin, o), shfl_x(m.lmin, o)};
  }
  // s+ at a trade that may close is max(a, s.sp + b) <= max(amax, s.sp +
  // bmax) < lmin <= its lam, and likewise s- > -lam: no trade closes
  // (fmax and fmin drop a NaN, as the walk's do, so a NaN bound is refused
  // first)
  __device__ static bool skip(const Bounds& m, const State& s, const Args&) {
    if (isnan(m.amax) || isnan(m.bmax) || isnan(m.cmin) || isnan(m.bmin)) return false;
    return fmax(m.amax, s.sp + m.bmax) < m.lmin &&
           fmin(m.cmin, s.sn + m.bmin) > -m.lmin;
  }
};

// ---- imbalance and run ---------------------------------------------------
struct InfoState { double cb, cs, e_t, e_r; long long open; };

__device__ InfoState info_close(const InfoState& s, double stat, long long g,
                                const Args& a) {
  // (1 - alpha) * e + alpha * x, rounded step by step
  const double t_bar = static_cast<double>(g - s.open);
  const double rate = __ddiv_rn(stat, fmax(t_bar, 1.0));
  const double e_t = __dadd_rn(__dmul_rn(__dsub_rn(1.0, a.alpha_t), s.e_t),
                               __dmul_rn(a.alpha_t, t_bar));
  const double e_r = __dadd_rn(__dmul_rn(__dsub_rn(1.0, a.alpha_r), s.e_r),
                               __dmul_rn(a.alpha_r, rate));
  return {0.0, 0.0, e_t, e_r, g};
}

struct InfoCommon {
  using State = InfoState;
  struct In { double w; };
  __device__ static State init(const Args& a) {
    return {0.0, 0.0, a.e_t, a.e_r, 0};
  }
  // a chunk that does not know its entry state guesses a bar opened at the
  // trade before it
  __device__ static State reset(const Args& a, long long g) {
    return {0.0, 0.0, a.e_t, a.e_r, g - 1};
  }
  __device__ static In load(const Args& a, long long g) {
    return {g < a.n ? a.x[g] : 0.0};
  }
  __device__ static void prefetch(const Args& a, long long g) {
    if (g < a.n) prefetch_l2(a.x + g);
  }
  __device__ static bool same_state(const State& x, const State& y) {
    return same(x.cb, y.cb) && same(x.cs, y.cs) && same(x.e_t, y.e_t) &&
           same(x.e_r, y.e_r) && x.open == y.open;
  }
};

struct Imbalance : InfoCommon {
  using E = double;
  struct Bounds { double hi, lo; };  // largest and smallest in-tile prefix

  __device__ static E identity() { return 0.0; }
  __device__ static E elem(const In& v) { return v.w; }
  __device__ static E combine(E x, E y) { return x + y; }
  __device__ static E shfl(E x, int o) { return shfl_up(x, o); }
  __device__ static bool test(E p, const In&, const State& s, const Args&) {
    return !(fabs(s.cb + p) < __dmul_rn(s.e_t, s.e_r));
  }
  __device__ static State next(E p, const In&, const State& s, long long g,
                               const Args& a) {
    return info_close(s, fabs(s.cb + p), g, a);
  }
  __device__ static State at_end(E p, const State& s) {
    return {s.cb + p, 0.0, s.e_t, s.e_r, s.open};
  }
  __device__ static Bounds empty() { return {-INFINITY, INFINITY}; }
  __device__ static void add(Bounds& m, E p, const In&) {
    m.hi = max_nan(p, m.hi);
    m.lo = min_nan(p, m.lo);
  }
  __device__ static Bounds merge(const Bounds& x, const Bounds& y) {
    return {max_nan(x.hi, y.hi), min_nan(x.lo, y.lo)};
  }
  __device__ static Bounds shfl_bounds(const Bounds& m, int o) {
    return {shfl_x(m.hi, o), shfl_x(m.lo, o)};
  }
  // s.cb + p lies between s.cb + lo and s.cb + hi, rounded alike
  __device__ static bool skip(const Bounds& m, const State& s, const Args&) {
    const double theta = __dmul_rn(s.e_t, s.e_r);
    return fabs(s.cb + m.hi) < theta && fabs(s.cb + m.lo) < theta;
  }
};

struct Run : InfoCommon {
  struct E { double b, s; };
  struct Bounds { double b, s; };  // largest in-tile buy and sell sums

  __device__ static E identity() { return {0.0, 0.0}; }
  __device__ static E elem(const In& v) {
    return {v.w > 0.0 ? v.w : 0.0, v.w < 0.0 ? -v.w : 0.0};
  }
  __device__ static E combine(const E& x, const E& y) {
    return {x.b + y.b, x.s + y.s};
  }
  __device__ static E shfl(const E& x, int o) {
    return {shfl_up(x.b, o), shfl_up(x.s, o)};
  }
  __device__ static bool test(const E& p, const In&, const State& s, const Args&) {
    return !(fmax(s.cb + p.b, s.cs + p.s) < __dmul_rn(s.e_t, s.e_r));
  }
  __device__ static State next(const E& p, const In&, const State& s,
                               long long g, const Args& a) {
    return info_close(s, fmax(s.cb + p.b, s.cs + p.s), g, a);
  }
  __device__ static State at_end(const E& p, const State& s) {
    return {s.cb + p.b, s.cs + p.s, s.e_t, s.e_r, s.open};
  }
  __device__ static Bounds empty() { return {-INFINITY, -INFINITY}; }
  __device__ static void add(Bounds& m, const E& p, const In&) {
    m.b = max_nan(p.b, m.b);
    m.s = max_nan(p.s, m.s);
  }
  __device__ static Bounds merge(const Bounds& x, const Bounds& y) {
    return {max_nan(x.b, y.b), max_nan(x.s, y.s)};
  }
  __device__ static Bounds shfl_bounds(const Bounds& m, int o) {
    return {shfl_x(m.b, o), shfl_x(m.s, o)};
  }
  __device__ static bool skip(const Bounds& m, const State& s, const Args&) {
    return fmax(s.cb + m.b, s.cs + m.s) < __dmul_rn(s.e_t, s.e_r);
  }
};

// ---- volume ----------------------------------------------------------------
struct Volume {
  using E = long long;
  struct In { long long u; };
  struct State { long long carry; };
  struct Bounds { long long hi; };  // the largest in-tile prefix

  __device__ static E identity() { return 0; }
  __device__ static E elem(const In& v) { return v.u; }
  __device__ static E combine(E x, E y) { return x + y; }
  __device__ static E shfl(E x, int o) { return shfl_up(x, o); }
  // trade 0 opens the first bar and counts toward it
  __device__ static State init(const Args& a) { return {a.units[0]}; }
  __device__ static State reset(const Args&, long long) { return {0}; }
  __device__ static In load(const Args& a, long long g) {
    return {g < a.n ? a.units[g] : 0};
  }
  __device__ static void prefetch(const Args& a, long long g) {
    if (g < a.n) prefetch_l2(a.units + g);
  }
  __device__ static bool test(E p, const In&, const State& s, const Args& a) {
    return s.carry + p >= a.thr;
  }
  __device__ static State next(E, const In&, const State&, long long, const Args&) {
    return {0};
  }
  __device__ static State at_end(E p, const State& s) { return {s.carry + p}; }
  __device__ static bool same_state(const State& x, const State& y) {
    return x.carry == y.carry;
  }
  __device__ static Bounds empty() { return {LLONG_MIN}; }
  __device__ static void add(Bounds& m, E p, const In&) { m.hi = max(m.hi, p); }
  __device__ static Bounds merge(const Bounds& x, const Bounds& y) {
    return {max(x.hi, y.hi)};
  }
  __device__ static Bounds shfl_bounds(const Bounds& m, int o) {
    return {shfl_x(m.hi, o)};
  }
  __device__ static bool skip(const Bounds& m, const State& s, const Args& a) {
    return s.carry + m.hi < a.thr;
  }
};

template <class M> struct Sum {
  typename M::E end;         // the aggregate at the segment's last trade
  typename M::Bounds bounds;
};

// A value of 8-byte fields from lane `src` to every lane of the warp.
template <typename S> __device__ S broadcast(const S& x, int src) {
  static_assert(sizeof(S) % 8 == 0, "8-byte fields");
  unsigned long long w[sizeof(S) / 8];
  memcpy(w, &x, sizeof(S));
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(S) / 8); ++k) w[k] = __shfl_sync(kFull, w[k], src);
  S out;
  memcpy(&out, w, sizeof(S));
  return out;
}

// The in-segment aggregate of every trade j of the segment, from <= j < len,
// from the identity at `from`: p[i] is lane l's trade l * kItems + i. A lane
// scans its own trades as a tree (three levels), the lanes' totals go through
// a warp-shuffle scan, and each trade takes its lane's exclusive prefix once:
// a chain of 3 + 5 + 1 combines, where a sequential in-lane scan is 8 + 5 + 8.
// The walk and the summaries both use this, so they round alike.
template <class M>
__device__ void warp_prefix(const typename M::In (&cur)[kItems], int from,
                            int len, typename M::E (&p)[kItems]) {
  using E = typename M::E;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = lane * kItems + i;
    p[i] = (j >= from && j < len) ? M::elem(cur[i]) : M::identity();
  }
#pragma unroll
  for (int d = 1; d < kItems; d <<= 1)
#pragma unroll
    for (int i = kItems - 1; i >= d; --i) p[i] = M::combine(p[i - d], p[i]);
  E x = p[kItems - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const E y = M::shfl(x, o);
    if (lane >= o) x = M::combine(y, x);
  }
  E excl = M::shfl(x, 1);
  if (lane == 0) excl = M::identity();
#pragma unroll
  for (int i = 0; i < kItems; ++i) p[i] = M::combine(excl, p[i]);
}

// 1. The summary of every segment: a block a tile, a warp a segment.
template <class M>
__global__ void __launch_bounds__(kThreads) summary_kernel(Args a, Work w) {
  using Bounds = typename M::Bounds;
  const long long seg = static_cast<long long>(blockIdx.x) * kSegs + (threadIdx.x >> 5);
  const long long pos = a.start + seg * kSeg;
  if (pos >= a.n) return;
  const int lane = threadIdx.x & 31;
  const int len = static_cast<int>(min(static_cast<long long>(kSeg), a.n - pos));
  typename M::In cur[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) cur[i] = M::load(a, pos + lane * kItems + i);
  typename M::E p[kItems];
  warp_prefix<M>(cur, 0, len, p);
  Sum<M>* sum = static_cast<Sum<M>*>(w.sums) + seg;
  Bounds b = M::empty();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = lane * kItems + i;
    if (j < len) M::add(b, p[i], cur[i]);
    if (j == len - 1) sum->end = p[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) b = M::merge(b, M::shfl_bounds(b, o));
  if (lane == 0) sum->bounds = b;
}

// A walking warp's segment summaries, a tile at a time, in a ring of kStages
// tiles in shared memory: each tile's are requested kStages - 1 tiles ahead,
// so a skip reads them from shared memory.
constexpr int kStages = 3;
template <class M> using Ring = Sum<M>[kStages][kSegs];

// Request tile `tile`'s summaries into `dst` and commit them as one group (an
// empty group past the chunk's end, so that every tile waits alike).
template <class M>
__device__ void request(const Work& w, long long tile, long long t1, Sum<M>* dst) {
  if (tile < t1)
    copy_async(dst, static_cast<const Sum<M>*>(w.sums) + tile * kSegs,
               kSegs * static_cast<int>(sizeof(Sum<M>)));
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Walk the tiles of chunk c from state s with one warp, segment by segment,
// recording each tile's closes, their count and its end state. With `merge`,
// stop after the first tile whose end state equals the recorded one. Returns
// whether it stopped so. Every lane calls it with the same arguments.
template <class M>
__device__ bool walk_chunk(const Args& a, const Work& w, long long c,
                           typename M::State s, bool merge, Ring<M>& ring) {
  using State = typename M::State;
  State* states = static_cast<State*>(w.states);
  const int lane = threadIdx.x & 31;
  const long long t0 = c * w.per_chunk, t1 = min(t0 + w.per_chunk, w.tiles);
  long long skipped = 0, scanned = 0;
  bool merged = false;
  for (int k = 0; k < kStages - 1; ++k) request<M>(w, t0 + k, t1, ring[k]);
  for (long long tile = t0; tile < t1 && !merged; ++tile) {
    const long long pos0 = a.start + tile * kTile;
    const Sum<M>* sums = ring[(tile - t0) % kStages];
    // into the slot the previous tile used
    request<M>(w, tile + kStages - 1, t1, ring[(tile - t0 + kStages - 1) % kStages]);
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");  // this tile's
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k)  // the tile after the ring's into L2
      M::prefetch(a, pos0 + kStages * kTile + (lane * 4 + k) * 16);
    State rec;
    if (merge) rec = states[tile];
    long long cnt = 0;
    for (int sg = 0; sg < kSegs; ++sg) {
      const long long pos = pos0 + sg * kSeg;
      unsigned mask = 0;  // this lane's closing trades in the segment
      if (pos < a.n && M::skip(sums[sg].bounds, s, a)) {
        s = M::at_end(sums[sg].end, s);
        ++skipped;
      } else if (pos < a.n) {
        ++scanned;
        const int len = static_cast<int>(min(static_cast<long long>(kSeg), a.n - pos));
        typename M::In cur[kItems];
#pragma unroll
        for (int i = 0; i < kItems; ++i) cur[i] = M::load(a, pos + lane * kItems + i);
        int from = 0;  // trades of the segment before `from` belong to closed bars
        while (true) {
          typename M::E p[kItems];
          warp_prefix<M>(cur, from, len, p);
          unsigned hits = 0;  // this lane's trades that would close
#pragma unroll
          for (int i = 0; i < kItems; ++i) {
            const int j = lane * kItems + i;
            hits |= static_cast<unsigned>((j >= from) & (j < len) &
                                          M::test(p[i], cur[i], s, a)) << i;
          }
          // the trade a lane hands on: its first close, or the segment's last
          const int pick = hits ? __ffs(hits) - 1 : (len - 1) & (kItems - 1);
          typename M::E pp = p[0];
          typename M::In pv = cur[0];
#pragma unroll
          for (int i = 1; i < kItems; ++i)
            if (i == pick) { pp = p[i]; pv = cur[i]; }
          const unsigned any = __ballot_sync(kFull, hits != 0);
          if (any) {
            const int owner = __ffs(any) - 1;
            const int e = owner * kItems + __shfl_sync(kFull, pick, owner);
            if (lane == owner) mask |= 1u << pick;
            s = broadcast(M::next(pp, pv, s, pos + lane * kItems + pick, a), owner);
            ++cnt;
            from = e + 1;
            if (from >= len) break;
          } else {
            s = broadcast(M::at_end(pp, s), (len - 1) / kItems);
            break;
          }
        }
      }
      w.flags[tile * kThreads + sg * 32 + lane] = static_cast<unsigned char>(mask);
    }
    merged = merge && M::same_state(s, rec);
    __syncwarp();  // every lane has read rec and the summaries before they are rewritten
    if (lane == 0) {
      w.cnt[tile] = cnt;
      if (!merged) states[tile] = s;
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");  // nothing left in flight
  __syncwarp();
  if (lane == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(w.stats), skipped);
    atomicAdd(reinterpret_cast<unsigned long long*>(w.stats + 1), scanned);
  }
  return merged;
}

// 2. Pass 1: chunk c = blockIdx.x from the initial or the reset state.
template <class M>
__global__ void __launch_bounds__(32) pass1_kernel(Args a, Work w) {
  using State = typename M::State;
  __shared__ __align__(16) Ring<M> ring;
  const long long c = blockIdx.x;
  const State s0 = c == 0 ? M::init(a) : M::reset(a, a.start + c * w.per_chunk * kTile);
  if (threadIdx.x == 0) static_cast<State*>(w.used)[c] = s0;
  walk_chunk<M>(a, w, c, s0, false, ring);
  if (threadIdx.x == 0) {
    const long long last = min((c + 1) * w.per_chunk, w.tiles) - 1;
    static_cast<State*>(w.end1)[c] = static_cast<State*>(w.states)[last];
  }
}

// 3. Pass 2: chunk c = blockIdx.x + 1 from chunk c-1's pass-1 end state.
template <class M>
__global__ void __launch_bounds__(32) pass2_kernel(Args a, Work w) {
  using State = typename M::State;
  __shared__ __align__(16) Ring<M> ring;
  const long long c = blockIdx.x + 1;
  const State s0 = static_cast<const State*>(w.end1)[c - 1];
  if (threadIdx.x == 0) static_cast<State*>(w.used)[c] = s0;
  const bool merged = walk_chunk<M>(a, w, c, s0, true, ring);
  if (threadIdx.x == 0 && !merged)
    atomicAdd(reinterpret_cast<unsigned long long*>(w.stats + 2), 1ull);
}

// 4. Fix-up, one warp: chunks in order, each walked again from its
// predecessor's end state where its last walk began elsewhere.
template <class M>
__global__ void __launch_bounds__(32) fixup_kernel(Args a, Work w) {
  using State = typename M::State;
  __shared__ __align__(16) Ring<M> ring;
  State* states = static_cast<State*>(w.states);
  State* used = static_cast<State*>(w.used);
  long long fixed = 0;
  for (long long c = 1; c < w.chunks;) {
    long long found = LLONG_MAX;
    for (long long q = c + threadIdx.x; q < w.chunks; q += 32)
      if (!M::same_state(states[q * w.per_chunk - 1], used[q])) { found = q; break; }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) found = min(found, shfl_x(found, o));
    if (found == LLONG_MAX) break;
    const State s0 = states[found * w.per_chunk - 1];
    __syncwarp();
    if (threadIdx.x == 0) used[found] = s0;
    walk_chunk<M>(a, w, found, s0, true, ring);
    __syncwarp();  // the chunk's records are visible to every lane
    ++fixed;
    c = found + 1;
  }
  if (threadIdx.x == 0) w.stats[3] = fixed;
}

// 5. One warp a tile: its close indices at their ranks, the first max_out.
__global__ void __launch_bounds__(32)
scatter_kernel(const unsigned long long* __restrict__ flags,
               const long long* __restrict__ cnt, const long long* __restrict__ incl,
               long long start, long long tiles, long long* __restrict__ out,
               long long max_out, long long* __restrict__ count) {
  const long long tile = blockIdx.x;
  const int lane = threadIdx.x;
  if (tile == 0 && lane == 0) *count = min(incl[tiles - 1], max_out);
  const long long c = cnt[tile];
  const long long base = incl[tile] - c;
  if (c == 0 || base >= max_out) return;
  // the tile's flag bytes 8l .. 8l+7: its trades 64l .. 64l+63, one a bit
  unsigned long long m = flags[tile * (kThreads / 8) + lane];
  const int k = __popcll(m);
  int x = k;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  long long idx = base + x - k;
  const long long p0 = start + tile * kTile + 64LL * lane;
  for (; m != 0 && idx < max_out; m &= m - 1, ++idx) out[idx] = p0 + __ffsll(m) - 1;
}

long long round_up(long long x) { return (x + kAlign - 1) / kAlign * kAlign; }

template <class M> long long layout(Work* w, char* base, long long n,
                                    long long start, long long chunks) {
  using State = typename M::State;
  const long long tiles = (n - start + kTile - 1) / kTile;
  const long long per = (tiles + chunks - 1) / chunks;
  long long o = 0;
  auto take = [&](long long bytes) { char* p = base + o; o += round_up(bytes); return p; };
  Work v;
  v.tiles = tiles;
  v.per_chunk = per;
  v.chunks = (tiles + per - 1) / per;
  v.stats = reinterpret_cast<long long*>(take(4 * sizeof(long long)));
  v.sums = take(tiles * kSegs * sizeof(Sum<M>));
  v.states = take(tiles * sizeof(State));
  v.used = take(v.chunks * sizeof(State));
  v.end1 = take(v.chunks * sizeof(State));
  v.flags = reinterpret_cast<unsigned char*>(take(tiles * kThreads));
  v.cnt = reinterpret_cast<long long*>(take(tiles * sizeof(long long)));
  v.incl = reinterpret_cast<long long*>(take(tiles * sizeof(long long)));
  v.scan_scratch = take(fmk_scan_scratch_bytes(1, 1, tiles));
  if (w != nullptr) *w = v;
  return o;
}

#define FMK_CHECK(call)                                    \
  do {                                                     \
    const cudaError_t e_ = (call);                         \
    if (e_ != cudaSuccess) return static_cast<int>(e_);    \
  } while (0)

template <class M>
int launch(const Args& a, void* scratch, long long chunks, long long* out,
           long long max_out, long long* count, void* stats, cudaStream_t s) {
  Work w;
  layout<M>(&w, static_cast<char*>(scratch), a.n, a.start, chunks);
  if (stats != nullptr) w.stats = static_cast<long long*>(stats);
  FMK_CHECK(cudaMemsetAsync(w.stats, 0, 4 * sizeof(long long), s));
  const unsigned tiles = static_cast<unsigned>(w.tiles);
  summary_kernel<M><<<tiles, kThreads, 0, s>>>(a, w);
  FMK_CHECK(cudaGetLastError());
  pass1_kernel<M><<<static_cast<unsigned>(w.chunks), 32, 0, s>>>(a, w);
  FMK_CHECK(cudaGetLastError());
  if (w.chunks > 1) {
    pass2_kernel<M><<<static_cast<unsigned>(w.chunks - 1), 32, 0, s>>>(a, w);
    FMK_CHECK(cudaGetLastError());
    fixup_kernel<M><<<1, 32, 0, s>>>(a, w);
    FMK_CHECK(cudaGetLastError());
  }
  const int rc = fmk_prefix_scan(1, w.cnt, w.incl, w.scan_scratch, w.tiles, s);
  if (rc != 0) return rc;
  scatter_kernel<<<tiles, 32, 0, s>>>(
      reinterpret_cast<const unsigned long long*>(w.flags), w.cnt, w.incl,
      a.start, w.tiles, out, max_out, count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch kernel E needs for trades start .. n-1 (start < n) in
// `chunks` chunks, by mode; -1 for an unknown mode.
extern "C" long long fmk_event_scratch_bytes(int mode, long long n,
                                             long long start, long long chunks) {
  switch (mode) {
    case 0: return layout<Cusum>(nullptr, nullptr, n, start, chunks);
    case 1: return layout<Imbalance>(nullptr, nullptr, n, start, chunks);
    case 2: return layout<Run>(nullptr, nullptr, n, start, chunks);
    case 3: return layout<Volume>(nullptr, nullptr, n, start, chunks);
    default: return -1;
  }
}

// Kernel E. mode: 0 CUSUM (x = log returns, lam, can_close), 1 imbalance and
// 2 run (x = weights, e_t / e_r / alpha_t / alpha_r), 3 volume (units, thr;
// the first bar holds trade 0). Checks trades start .. n-1 (start < n) in
// `chunks` chunks of whole tiles (at least 1), with `scratch` of
// fmk_event_scratch_bytes(mode, n, start, chunks) bytes, 256-byte aligned;
// writes the first max_out close indices to out and their number to
// count[0]. `stats`, if not null, receives four int64 counts: segments
// skipped, segments scanned, pass-2 chunks that did not merge, chunks fixed up.
// Returns cudaGetLastError().
extern "C" int fmk_event_scan(int mode, const void* x, const void* lam,
                              const void* can_close, const void* units,
                              long long n, long long start, double e_t,
                              double e_r, double alpha_t, double alpha_r,
                              long long thr, void* scratch, long long chunks,
                              void* out, long long max_out, void* count,
                              void* stats, void* stream) {
  if (start >= n || chunks < 1 || max_out < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const double*>(x), static_cast<const double*>(lam),
         static_cast<const unsigned char*>(can_close),
         static_cast<const long long*>(units), n, start, e_t, e_r, alpha_t,
         alpha_r, thr};
  long long* o = static_cast<long long*>(out);
  long long* c = static_cast<long long*>(count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<Cusum>(a, scratch, chunks, o, max_out, c, stats, s);
    case 1: return launch<Imbalance>(a, scratch, chunks, o, max_out, c, stats, s);
    case 2: return launch<Run>(a, scratch, chunks, o, max_out, c, stats, s);
    case 3: return launch<Volume>(a, scratch, chunks, o, max_out, c, stats, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
