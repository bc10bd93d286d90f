// Kernel E: the event-jump boundary scans of the information-driven bars.
//
// Not a TPU kernel: the JAX package runs these scans as XLA while_loops
// (finmlkit_tpu/bar/indexers.py _volume_boundaries :368, _cusum_boundaries
// :508, _info_bar_boundaries :680). PyTorch has no loop that stays on the
// device, so a literal port would read the card once per chunk and per bar;
// this kernel runs the whole scan in one call and the host reads the count
// once. One mode argument selects the bar type:
//   0 CUSUM      s+ = max(0, s+ + r), s- = min(0, s- + r), in IEEE doubles
//                with max and min that let a NaN through; a trade i closes
//                when can_close[i] and (s+ >= lam[i] or s- <= -lam[i]); s+
//                takes precedence and only the triggered side resets (the
//                walk stops at a non-finite return as at a close: Cusum);
//   1 imbalance  |in-bar sum of w| >= theta;
//   2 run        max(in-bar sum of buy w, in-bar sum of sell |w|) >= theta;
//                in modes 1 and 2 theta = E[T] * E[rate], whose EMAs update
//                at each close from the bar's length and statistic;
//   3 volume     the int64 in-bar sum of amount units >= thr, reset to zero;
//   4 imbalance  as 1, where both alphas are 0 and every weight is a finite
//                integer: a parallel scan of the tiles' maps of states (below);
//   5 run        as 2, where every weight is -1, 0 or +1 (tick run bars): a
//                search of each close in bit-packed counts (below).
// A close needs its statistic >= theta, as in the reference, so a NaN
// statistic or threshold never closes.
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
//      chunk 0 walks from the entry state, every other chunk from the
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
// Entry and exit states. The stream enters with a state (Args::entry, the
// mode's State as five 8-byte words): by default the mode's initial state,
// or the state a scan of the trades before it left, so that the shards of
// one stream scan in turn. Chunk 0 walks from it, so pass 2 and the fix-up
// test their merges against walks that saw it. After the fix-up every tile's
// recorded end state is that of the walk from the true entry, and the last
// tile's is copied out as the exit state. A scan that starts at trade 0
// lets trade 0 close; volume bars starting at trade 1 add trade 0 to the
// carry unchecked. Mode 4 enters with the in-bar sum of the entry state, and
// its exit takes the last tile's end state and the last close as the open.
//
// Mode 4 has no chunks. With a fixed theta and integer weights the in-bar sum
// takes 2K + 1 values (K the largest integer below theta), so a tile's effect
// is a map from its entry state to its exit state: pass 1 walks every entry
// state of every tile at once (a thread a state, the tile's weights read once
// into shared memory), pass 2 composes the maps as an exclusive scan in two
// levels of 128, pass 3 walks each tile once from its true entry state (a
// thread a tile, over the weights pass 1 stored as bytes), and step 5's
// compaction follows. Its work is (2K + 1) integer steps a trade.
//
// Mode 5 has no walk. With weights in {-1, 0, +1} the in-bar buy and sell
// sums are counts that only grow, and a whole count reaches theta exactly
// where it reaches ceil(theta); so the close after close c is the nearer of
// the first trades whose prefix count of buys, or of sells, reaches its value
// at c plus ceil(theta) less the entry sum. A pack over all SMs writes a
// buy and a sell bit a trade and each 1024-trade block's counts (kernel S
// scans them); one warp then finds each close from the counts and the bits,
// and takes the EMA step of the walk (info_close) once a close.
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
  long long entry[5];              // the state entering the stream, as the
                                   // mode's State (zeros: CUSUM's and volume's
                                   // initial state)
};

// The mode's State from the entry words.
template <typename S> __device__ S entry_state(const Args& a) {
  static_assert(sizeof(S) <= sizeof(Args::entry), "five 8-byte words");
  S s;
  memcpy(&s, a.entry, sizeof(S));
  return s;
}

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
// The recurrence is the reference's host loop (finmlkit_tpu/native/
// seg_stats.cpp:159-176) in IEEE doubles: s+ = max(0, s+ + r), s- = min(0,
// s- + r), both max and min letting a NaN through. A composed map is exact
// only over finite returns, so no map spans a non-finite one: such a trade
// is a stop. A segment's summary marks it as holding a stop when its end sum
// is not finite (a sum over a non-finite return never is), which forbids
// the skip; the walk scans such a segment with its stops' returns entered
// as 0 (the state before a stop is then read off the aggregate before it),
// stops at a stop as at a close, applies the scalar step to the actual
// state, and scans on from the identity after it. Segments without a stop
// take the finite walk unchanged. A NaN return so makes both sums NaN for
// good, -inf then +inf with no close between makes only s- NaN, and a NaN
// state never closes.
struct Cusum {
  // s+ -> max(a, s+ + b), s- -> min(c, s- + b)
  struct E { double a, c, b; };
  struct In { double r, lam; unsigned char cc; };
  struct State { double sp, sn; };
  // over the trades that may close: the largest a and b, the smallest c, b
  // and lam; a NaN in a, b or c (or a stop in the segment, which sets amax to
  // NaN) leaves a NaN that forbids the skip
  struct Bounds { double amax, bmax, cmin, bmin, lmin; };
  static constexpr bool kStops = true;

  __device__ static E identity() { return {-INFINITY, INFINITY, 0.0}; }
  __device__ static E elem(const In& v) { return {0.0, 0.0, v.r}; }
  // x then y; the returns composed are finite, so fmax and fmin lose nothing
  __device__ static E combine(const E& x, const E& y) {
    return {fmax(y.a, x.a + y.b), fmin(y.c, x.c + y.b), x.b + y.b};
  }
  __device__ static E shfl(const E& x, int o) {
    return {shfl_up(x.a, o), shfl_up(x.c, o), shfl_up(x.b, o)};
  }
  __device__ static State init(const Args& a) { return entry_state<State>(a); }
  __device__ static State reset(const Args&, long long) { return {0.0, 0.0}; }
  __device__ static In load(const Args& a, long long g) {
    if (g >= a.n) return {0.0, INFINITY, 0};
    return {a.x[g], a.lam[g], a.can_close[g]};
  }
  // Summaries: a segment whose end sum is not finite holds a stop.
  __device__ static bool holds_stops(const E& end) { return !isfinite(end.b); }
  __device__ static void mark_stops(Bounds& m) { m.amax = NAN; }
  // The walk: whether a segment may hold a stop; and, in one that may,
  // whether a trade is one, its return then entered as 0.
  __device__ static bool may_stop(const Bounds& m) { return isnan(m.amax); }
  __device__ static bool stop(In& v) {
    const bool st = !isfinite(v.r);
    if (st) v.r = 0.0;
    return st;
  }
  __device__ static void prefetch(const Args& a, long long g) {
    if (g < a.n) { prefetch_l2(a.x + g); prefetch_l2(a.lam + g); prefetch_l2(a.can_close + g); }
  }
  // The state after the trades of the aggregate p, entered with s; a NaN
  // state stays NaN.
  __device__ static State apply(const E& p, const State& s) {
    return {max_nan(p.a, s.sp + p.b), min_nan(p.c, s.sn + p.b)};
  }
  // Whether the trade with in-segment aggregate p closes (no branch), and
  // the state after it does.
  __device__ static bool test(const E& p, const In& v, const State& s, const Args&) {
    const State t = apply(p, s);
    return (v.cc != 0) & ((t.sp >= v.lam) | (t.sn <= -v.lam));
  }
  __device__ static State next(const E& p, const In& v, const State& s,
                               long long, const Args&) {
    const State t = apply(p, s);
    return t.sp >= v.lam ? State{0.0, t.sn} : State{t.sp, 0.0};
  }
  // The scalar step at stop g, whose return entered p as 0: p's state is the
  // one before it (max(0, s+) = s+, since s+ is never below 0), and its
  // return is read again.
  __device__ static State stop_step(const E& p, const In& v, const State& s,
                                    long long g, const Args& a, bool* closed) {
    const State t = apply(p, s);
    const double r = a.x[g];
    const double sp = max_nan(0.0, t.sp + r), sn = min_nan(0.0, t.sn + r);
    *closed = v.cc != 0 && (sp >= v.lam || sn <= -v.lam);
    if (!*closed) return {sp, sn};
    return sp >= v.lam ? State{0.0, sn} : State{sp, 0.0};
  }
  __device__ static State at_end(const E& p, const State& s) { return apply(p, s); }
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
  // bmax) < lmin <= its lam, and likewise s- > -lam: no trade closes. A NaN
  // bound is refused first. A NaN state side never closes: fmax and fmin
  // drop it here and leave the test to the segment's own maps, and at_end
  // keeps it NaN.
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
  static constexpr bool kStops = false;
  struct In { double w; };
  __device__ static State init(const Args& a) { return entry_state<State>(a); }
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
  // as the reference's stat >= theta: a NaN sum or threshold never closes
  __device__ static bool test(E p, const In&, const State& s, const Args&) {
    return fabs(s.cb + p) >= __dmul_rn(s.e_t, s.e_r);
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
  // a NaN threshold (after a close on an infinite weight at alpha 0) never
  // closes, as in the reference
  __device__ static bool test(const E& p, const In&, const State& s, const Args&) {
    return fmax(s.cb + p.b, s.cs + p.s) >= __dmul_rn(s.e_t, s.e_r);
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
  static constexpr bool kStops = false;
  struct In { long long u; };
  struct State { long long carry; };
  struct Bounds { long long hi; };  // the largest in-tile prefix

  __device__ static E identity() { return 0; }
  __device__ static E elem(const In& v) { return v.u; }
  __device__ static E combine(E x, E y) { return x + y; }
  __device__ static E shfl(E x, int o) { return shfl_up(x, o); }
  // the carried units; trade 0 counts toward the bar unchecked where the
  // walk starts at trade 1
  __device__ static State init(const Args& a) {
    return {entry_state<State>(a).carry + (a.start > 0 ? a.units[0] : 0)};
  }
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
  if constexpr (M::kStops) {
    bool stops = false;
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (lane * kItems + i == len - 1) stops = M::holds_stops(p[i]);
    if (__any_sync(kFull, stops)) M::mark_stops(b);
  }
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
        unsigned stop_bits = 0;  // this lane's stops (CUSUM: non-finite returns)
        if constexpr (M::kStops) {
          if (M::may_stop(sums[sg].bounds)) {
#pragma unroll
            for (int i = 0; i < kItems; ++i)
              stop_bits |= static_cast<unsigned>(M::stop(cur[i])) << i;
          }
        }
        int from = 0;  // trades of the segment before `from` belong to closed bars
        while (true) {
          typename M::E p[kItems];
          warp_prefix<M>(cur, from, len, p);
          unsigned hits = 0;  // this lane's trades that would close, and its stops
#pragma unroll
          for (int i = 0; i < kItems; ++i) {
            const int j = lane * kItems + i;
            hits |= static_cast<unsigned>((j >= from) & (j < len) &
                                          M::test(p[i], cur[i], s, a)) << i;
          }
          unsigned stops = 0;
          if constexpr (M::kStops) {
            const int lo = min(max(from - lane * kItems, 0), kItems);
            const int hi = min(max(len - lane * kItems, 0), kItems);
            stops = stop_bits & ((1u << hi) - 1) & ~((1u << lo) - 1);
            hits |= stops;
          }
          // the trade a lane hands on: its first close or stop, or the segment's last
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
            const long long g = pos + lane * kItems + pick;
            bool closed = true;
            State ns;
            if constexpr (M::kStops) {
              ns = (stops >> pick) & 1u ? M::stop_step(pp, pv, s, g, a, &closed)
                                        : M::next(pp, pv, s, g, a);
              closed = __shfl_sync(kFull, closed, owner);
            } else {
              ns = M::next(pp, pv, s, g, a);
            }
            if (lane == owner && closed) mask |= 1u << pick;
            s = broadcast(ns, owner);
            cnt += closed;
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

// ---- mode 4: imbalance at a fixed threshold on integer weights ------------
// With both alphas 0 the threshold theta never moves, and with integer
// weights the in-bar sum before a close is an integer s with |s| <= K, K the
// largest integer below theta: 2K + 1 states. A tile's whole effect is then a
// map from its entry state to its exit state, and maps compose. The state is
// kept biased, u = s + K in [0, 2K]; a trade adds w and closes where u + w
// leaves [0, 2K], which resets u to K. A weight with |w| >= 2K + 1 closes from
// every state, so weights are clamped to that and fit a signed byte.
constexpr int kMapStates = 127;  // the most states (2K + 1) a map holds
constexpr int kMapRow = 128;     // bytes of one map
constexpr int kGroup = 128;      // tiles (or groups) a block of the map scan composes

struct MapWork {
  long long tiles, groups;
  signed char* w8;       // per trade: the clamped weight
  unsigned char* maps;   // per tile: the exit state of each entry state
  unsigned char* gmaps;  // per group of kGroup tiles: the same over the group
  int* gentry;           // per group: its entry state
  int* tentry;           // per tile: its entry state
  unsigned long long* flags;  // per tile: its closes, a bit a trade
  long long* cnt;        // per tile: their number
  long long* incl;       // per tile: inclusive prefix of cnt
  void* scan_scratch;    // kernel S's scratch for cnt
};

__device__ __forceinline__ int map_step(int u, int w, int two_k) {
  const int v = u + w;
  return static_cast<unsigned>(v) > static_cast<unsigned>(two_k) ? two_k >> 1 : v;
}

// Pass 1, a block a tile: the tile's weights are read once, clamped, kept in
// shared memory and stored as bytes for pass 3; thread u walks entry state u
// over the tile, every thread reading the same weights.
__global__ void __launch_bounds__(kMapRow)
map_tiles_kernel(const double* __restrict__ x, long long n, long long start, int k,
                 signed char* __restrict__ w8, unsigned char* __restrict__ maps) {
  __shared__ __align__(16) int sw[kTile];
  const long long tile = blockIdx.x;
  const long long pos0 = start + tile * kTile;
  const double lim = 2.0 * k + 1.0;
  for (int j = threadIdx.x; j < kTile; j += blockDim.x) {
    const long long g = pos0 + j;
    const int v = static_cast<int>(fmin(fmax(g < n ? x[g] : 0.0, -lim), lim));
    sw[j] = v;
    w8[tile * kTile + j] = static_cast<signed char>(v);
  }
  __syncthreads();
  const int u0 = threadIdx.x;
  if (u0 > 2 * k) return;
  const int4* s4 = reinterpret_cast<const int4*>(sw);
  int u = u0;
#pragma unroll 8
  for (int j = 0; j < kTile / 4; ++j) {
    const int4 q = s4[j];
    u = map_step(u, q.x, 2 * k);
    u = map_step(u, q.y, 2 * k);
    u = map_step(u, q.z, 2 * k);
    u = map_step(u, q.w, 2 * k);
  }
  maps[tile * kMapRow + u0] = static_cast<unsigned char>(u);
}

// Rows r0 .. r0+cnt-1 of a table of maps into shared memory, 16 bytes a request.
__device__ __forceinline__ void load_maps(const unsigned char* __restrict__ src, long long r0,
                                          int cnt, unsigned char (*dst)[kMapRow]) {
  const int4* s = reinterpret_cast<const int4*>(src + r0 * kMapRow);
  int4* d = reinterpret_cast<int4*>(&dst[0][0]);
  for (int q = threadIdx.x; q < cnt * (kMapRow / 16); q += blockDim.x) d[q] = s[q];
}

// Pass 2a, a block a group: the composition of the group's tile maps.
__global__ void __launch_bounds__(kMapRow)
map_groups_kernel(const unsigned char* __restrict__ maps, long long tiles, int states,
                  unsigned char* __restrict__ gmaps) {
  __shared__ __align__(16) unsigned char sm[kGroup][kMapRow];
  const long long g = blockIdx.x;
  const int cnt = static_cast<int>(min(static_cast<long long>(kGroup), tiles - g * kGroup));
  load_maps(maps, g * kGroup, cnt, sm);
  __syncthreads();
  const int u0 = threadIdx.x;
  if (u0 >= states) return;
  int u = u0;
  for (int j = 0; j < cnt; ++j) u = sm[j][u];
  gmaps[g * kMapRow + u0] = static_cast<unsigned char>(u);
}

// Pass 2b, one block: the groups' entry states, from the stream's entry
// state u0 (K + the entry sum) through the group maps in order, kGroup of
// them at a time.
__global__ void __launch_bounds__(kMapRow)
map_top_kernel(const unsigned char* __restrict__ gmaps, long long groups, int u0,
               int* __restrict__ gentry) {
  __shared__ __align__(16) unsigned char sm[kGroup][kMapRow];
  int u = u0;
  for (long long g0 = 0; g0 < groups; g0 += kGroup) {
    const int cnt = static_cast<int>(min(static_cast<long long>(kGroup), groups - g0));
    __syncthreads();  // the previous rows are read
    load_maps(gmaps, g0, cnt, sm);
    __syncthreads();
    if (threadIdx.x == 0)
      for (int j = 0; j < cnt; ++j) {
        gentry[g0 + j] = u;
        u = sm[j][u];
      }
  }
}

// Pass 2c, a block a group: its tiles' entry states.
__global__ void __launch_bounds__(32)
map_expand_kernel(const unsigned char* __restrict__ maps, long long tiles,
                  const int* __restrict__ gentry, int* __restrict__ tentry) {
  __shared__ __align__(16) unsigned char sm[kGroup][kMapRow];
  const long long g = blockIdx.x;
  const int cnt = static_cast<int>(min(static_cast<long long>(kGroup), tiles - g * kGroup));
  load_maps(maps, g * kGroup, cnt, sm);
  __syncthreads();
  if (threadIdx.x != 0) return;
  int u = gentry[g];
  for (int j = 0; j < cnt; ++j) {
    tentry[g * kGroup + j] = u;
    u = sm[j][u];
  }
}

// Pass 3, a thread a tile: the walk from the tile's true entry state over its
// byte weights, 64 trades (one word of close bits) a step, the next 64
// requested before the current are walked. Where `exit` is not null (an
// InfoState holding the entry state), the last tile writes its end sum and
// every tile raises the open to its last close.
__global__ void __launch_bounds__(128)
map_walk_kernel(const signed char* __restrict__ w8, const int* __restrict__ tentry,
                long long tiles, int k, long long start, unsigned long long* __restrict__ flags,
                long long* __restrict__ cnt, InfoState* __restrict__ exit) {
  const long long tile = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tile >= tiles) return;
  constexpr int kWords = kTile / 64;
  const int4* src = reinterpret_cast<const int4*>(w8 + tile * kTile);
  unsigned long long* f = flags + tile * kWords;
  int u = tentry[tile];
  long long c = 0, last = -1;
  int4 nxt[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) nxt[q] = src[q];
  for (int b = 0; b < kWords; ++b) {
    int4 cur[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) cur[q] = nxt[q];
    if (b + 1 < kWords) {
#pragma unroll
      for (int q = 0; q < 4; ++q) nxt[q] = src[4 * (b + 1) + q];
    }
    unsigned long long bits = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int words[4] = {cur[q].x, cur[q].y, cur[q].z, cur[q].w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int w = static_cast<signed char>(words[r] >> (8 * y));
          const int v = u + w;
          const bool closes = static_cast<unsigned>(v) > static_cast<unsigned>(2 * k);
          u = closes ? k : v;
          bits |= static_cast<unsigned long long>(closes) << (16 * q + 4 * r + y);
        }
    }
    f[b] = bits;
    c += __popcll(bits);
    if (bits) last = 64LL * b + 63 - __clzll(static_cast<long long>(bits));
  }
  cnt[tile] = c;
  if (exit != nullptr) {
    if (tile == tiles - 1) exit->cb = static_cast<double>(u - k);
    if (last >= 0) atomicMax(&exit->open, start + tile * kTile + last);
  }
}

// The exit state of mode 4 before pass 3: the entry state.
__global__ void map_exit_kernel(InfoState* exit, InfoState entry) { *exit = entry; }

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
           long long max_out, long long* count, void* stats, void* exit, cudaStream_t s) {
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
  if (exit != nullptr)  // the last tile's end state, from the true entry
    FMK_CHECK(cudaMemcpyAsync(exit, static_cast<const typename M::State*>(w.states) + w.tiles - 1,
                              sizeof(typename M::State), cudaMemcpyDeviceToDevice, s));
  const int rc = fmk_prefix_scan(1, w.cnt, w.incl, w.scan_scratch, w.tiles, s);
  if (rc != 0) return rc;
  scatter_kernel<<<tiles, 32, 0, s>>>(
      reinterpret_cast<const unsigned long long*>(w.flags), w.cnt, w.incl,
      a.start, w.tiles, out, max_out, count);
  return static_cast<int>(cudaGetLastError());
}

// K of mode 4, from theta = e_t * e_r rounded as the walk rounds it; -1 where
// the map does not apply (an alpha not 0, theta not finite and positive, or
// more than kMapStates states).
int map_k(const Args& a) {
  const double theta = a.e_t * a.e_r;
  if (a.alpha_t != 0.0 || a.alpha_r != 0.0 || !(theta > 0.0) || !std::isfinite(theta))
    return -1;
  const double k = std::ceil(theta) - 1.0;
  return 2.0 * k + 1.0 <= kMapStates ? static_cast<int>(k) : -1;
}

long long map_layout(MapWork* w, char* base, long long n, long long start) {
  const long long tiles = (n - start + kTile - 1) / kTile;
  const long long groups = (tiles + kGroup - 1) / kGroup;
  long long o = 0;
  auto take = [&](long long bytes) { char* p = base + o; o += round_up(bytes); return p; };
  MapWork v;
  v.tiles = tiles;
  v.groups = groups;
  v.w8 = reinterpret_cast<signed char*>(take(tiles * kTile));
  v.maps = reinterpret_cast<unsigned char*>(take(tiles * kMapRow));
  v.gmaps = reinterpret_cast<unsigned char*>(take(groups * kMapRow));
  v.gentry = reinterpret_cast<int*>(take(groups * sizeof(int)));
  v.tentry = reinterpret_cast<int*>(take(tiles * sizeof(int)));
  v.flags = reinterpret_cast<unsigned long long*>(take(tiles * (kTile / 8)));
  v.cnt = reinterpret_cast<long long*>(take(tiles * sizeof(long long)));
  v.incl = reinterpret_cast<long long*>(take(tiles * sizeof(long long)));
  v.scan_scratch = take(fmk_scan_scratch_bytes(1, 1, tiles));
  if (w != nullptr) *w = v;
  return o;
}

// Mode 4: the tiles' maps (pass 1), their exclusive composition in two levels
// (pass 2: groups of kGroup tiles, the groups in one block, the tiles of each
// group), the walk of every tile from its entry state (pass 3), then the
// compaction of the other modes.
int launch_map(const Args& a, void* scratch, long long* out, long long max_out,
               long long* count, void* stats, void* exit, cudaStream_t s) {
  const int k = map_k(a);
  InfoState entry;
  memcpy(&entry, a.entry, sizeof(entry));
  // the entry sum must be one of the map's states
  if (k < 0 || !(fabs(entry.cb) <= k) || entry.cb != std::trunc(entry.cb))
    return static_cast<int>(cudaErrorInvalidValue);
  InfoState* ex = static_cast<InfoState*>(exit);
  if (ex != nullptr) {
    map_exit_kernel<<<1, 1, 0, s>>>(ex, entry);
    FMK_CHECK(cudaGetLastError());
  }
  MapWork w;
  map_layout(&w, static_cast<char*>(scratch), a.n, a.start);
  if (stats != nullptr) FMK_CHECK(cudaMemsetAsync(stats, 0, 4 * sizeof(long long), s));
  const int threads = (2 * k + 1 + 31) / 32 * 32;  // a thread a state
  map_tiles_kernel<<<static_cast<unsigned>(w.tiles), threads, 0, s>>>(
      a.x, a.n, a.start, k, w.w8, w.maps);
  FMK_CHECK(cudaGetLastError());
  map_groups_kernel<<<static_cast<unsigned>(w.groups), kMapRow, 0, s>>>(
      w.maps, w.tiles, 2 * k + 1, w.gmaps);
  FMK_CHECK(cudaGetLastError());
  map_top_kernel<<<1, kMapRow, 0, s>>>(w.gmaps, w.groups, k + static_cast<int>(entry.cb),
                                       w.gentry);
  FMK_CHECK(cudaGetLastError());
  map_expand_kernel<<<static_cast<unsigned>(w.groups), 32, 0, s>>>(
      w.maps, w.tiles, w.gentry, w.tentry);
  FMK_CHECK(cudaGetLastError());
  map_walk_kernel<<<static_cast<unsigned>((w.tiles + 127) / 128), 128, 0, s>>>(
      w.w8, w.tentry, w.tiles, k, a.start, w.flags, w.cnt, ex);
  FMK_CHECK(cudaGetLastError());
  const int rc = fmk_prefix_scan(1, w.cnt, w.incl, w.scan_scratch, w.tiles, s);
  if (rc != 0) return rc;
  scatter_kernel<<<static_cast<unsigned>(w.tiles), 32, 0, s>>>(
      w.flags, w.cnt, w.incl, a.start, w.tiles, out, max_out, count);
  return static_cast<int>(cudaGetLastError());
}

// ---- mode 5: tick run bars by count search ---------------------------------
// With weights in {-1, 0, +1} the close after close c is the first trade j
// where cb + B(j) - B(c) >= k or cs + S(j) - S(c) >= k: B and S the prefix
// counts of buys and sells over the checked trades (those before `start` do
// not count), k = ceil(theta), cb and cs the entry sums of the first bar (0
// after it). So with the trades of the m-th buy and of the m-th sell in
// tables, a close is two table reads: the buy that brings B to B(c) + k - cb
// and the sell that brings S to S(c) + k - cs, the nearer one closing (or
// c + 1 where a target is met already). The count that reaches its target
// stands at it, so the bar's statistic is k itself; each table entry also
// holds the other count at its trade.
//
// Launches: the pack (all SMs: a buy and a sell bit a trade by ballot, each
// 32-trade word's counts within its block of 1024, each block's counts);
// kernel S over the blocks' counts; the tables (all SMs: each bit to its
// rank); the walker (one warp). The walker keeps each table's next entries in
// a ring of two chunks in shared memory, each chunk one bulk copy that an
// mbarrier counts in, the next requested as soon as the count at the last
// close leaves the first; a target beyond the ring (a bar of more than 4,096
// buys or sells) reads its entry from device memory.
constexpr int kCountBlock = 1024;  // trades a block: 32 words
constexpr int kChunk = 4096;       // table entries a chunk of the walker's two-chunk rings holds

// Where the sells' table starts: a chunk after the last buy, at an even entry
// (a bulk copy reads 16-byte aligned).
__device__ __forceinline__ long long sells_at(long long buys) {
  return (buys + kChunk + 1) / 2 * 2;
}

struct Entry {
  unsigned g;       // the trade
  unsigned other;   // the other side's count there (sells at a buy, buys at a sell)
};

struct CountWork {
  long long blocks;     // blocks of 1024 trades from trade 0
  unsigned* buy;        // per 32 trades: the buy bits
  unsigned* sell;       // per 32 trades: the sell bits
  unsigned* cnt;        // per 32 trades: buys << 16 | sells in its block, to its end
  long long* tot;       // per block: (buys << 32) + sells
  long long* incl;      // per block: inclusive prefix of tot
  void* scan_scratch;   // kernel S's scratch for tot
  Entry* tab;           // per buy in order, then (sells_at) per sell, each with a chunk after
  int* flag;            // set where a weight of trades start .. n-1 is not -1, 0 or +1
};

// Pack, a block of 256 threads a block of trades, a warp 4 words: the bits
// by ballot, the words' counts in the block by a warp scan, the block's
// counts, the flag. The weights are read once, as a stream.
__global__ void __launch_bounds__(256)
count_pack_kernel(const double* __restrict__ x, long long n, long long start,
                  unsigned* __restrict__ buy, unsigned* __restrict__ sell,
                  unsigned* __restrict__ cnt, long long* __restrict__ tot,
                  int* __restrict__ flag) {
  __shared__ unsigned words[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q = blockIdx.x;
  double v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long g = q * kCountBlock + (warp * 4 + i) * 32 + lane;
    v[i] = (g >= start && g < n) ? __ldcs(x + g) : 0.0;
  }
  bool bad = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned b = __ballot_sync(kFull, v[i] == 1.0);
    const unsigned s = __ballot_sync(kFull, v[i] == -1.0);
    bad |= !(v[i] == 0.0 || v[i] == 1.0 || v[i] == -1.0);
    if (lane == i) {
      buy[q * 32 + warp * 4 + i] = b;
      sell[q * 32 + warp * 4 + i] = s;
      words[warp * 4 + i] = (__popc(b) << 16) | __popc(s);
    }
  }
  if (__any_sync(kFull, bad) && lane == 0) atomicOr(flag, 1);
  __syncthreads();
  if (warp != 0) return;
  unsigned c = words[lane];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, c, o);
    if (lane >= o) c += y;
  }
  cnt[q * 32 + lane] = c;
  if (lane == 31) tot[q] = (static_cast<long long>(c >> 16) << 32) + (c & 0xffff);
}

// The tables, a block of 256 threads a block of trades, a warp 4 words, a
// lane a bit: each buy and each sell to its rank, with the other count; the
// sells' table starts a chunk after the last buy.
__global__ void __launch_bounds__(256)
count_table_kernel(const unsigned* __restrict__ buy, const unsigned* __restrict__ sell,
                   const unsigned* __restrict__ cnt, const long long* __restrict__ incl,
                   long long blocks, Entry* __restrict__ tab) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q = blockIdx.x;
  const long long base = q > 0 ? incl[q - 1] : 0;
  Entry* tab_s = tab + sells_at(incl[blocks - 1] >> 32);
  const unsigned below = (1u << lane) - 1u, upto = below | (1u << lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long wd = q * 32 + warp * 4 + i;
    const unsigned b = buy[wd], s = sell[wd], c = cnt[wd];
    // B and S before the word
    const unsigned eb = static_cast<unsigned>(base >> 32) + (c >> 16) - __popc(b);
    const unsigned es = static_cast<unsigned>(base & 0xffffffffLL) + (c & 0xffff) - __popc(s);
    const unsigned g = static_cast<unsigned>(wd * 32 + lane);
    if ((b >> lane) & 1u) tab[eb + __popc(b & below)] = Entry{g, es + __popc(s & upto)};
    if ((s >> lane) & 1u) tab_s[es + __popc(s & below)] = Entry{g, eb + __popc(b & upto)};
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ bool bar_done(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}" : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// One table's ring: its chunks lo and lo + 1, chunk i in slot i & 1, each
// filled by one bulk copy counted in by the slot's mbarrier; entry idx of
// either lies at (idx mod 2 kChunk) in the ring.
struct TabRing {
  const Entry* tab;   // the table in device memory
  unsigned total;     // its entries
  unsigned lo;        // the first chunk held
  unsigned ring;      // shared address of the ring
  unsigned bar;       // shared address of slot 0's mbarrier (slot 1's 8 bytes on)
  unsigned par;       // bit s: the phase parity of slot s's next fill
  unsigned in;        // bit s: slot s's last fill is known to be in
};

// Wait until slot s's last fill is in.
__device__ __forceinline__ void settle(TabRing& r, unsigned s) {
  if (!((r.in >> s) & 1u)) {
    while (!bar_done(r.bar + 8 * s, ((r.par >> s) & 1u) ^ 1u)) {}
    r.in |= 1u << s;
  }
}

// Fill chunk i's slot with it (an arrival alone past the table's end).
__device__ __forceinline__ void request(TabRing& r, unsigned i) {
  constexpr unsigned bytes = kChunk * sizeof(Entry);
  const unsigned s = i & 1u;
  if ((threadIdx.x & 31) == 0) {
    const unsigned bar = r.bar + 8 * s;
    if (static_cast<long long>(i) * kChunk < r.total) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          :: "r"(r.ring + s * bytes), "l"(r.tab + static_cast<long long>(i) * kChunk),
             "r"(bytes), "r"(bar) : "memory");
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
    }
  }
  r.par ^= 1u << s;
  r.in &= ~(1u << s);
}

// Hold chunks lo and lo + 1 (lo no lower than before); returns the chunks requested.
__device__ __forceinline__ unsigned advance(TabRing& r, unsigned lo) {
  unsigned got = 0;
  for (; r.lo < lo; ++r.lo, ++got) {
    const unsigned i = max(r.lo + 2, lo);  // chunk r.lo's slot takes its successor's
    settle(r, i & 1u);
    __syncwarp();  // no lane reads the slot any more
    request(r, i);
    if (i == lo) {  // a jump of more than one chunk: the other slot too
      settle(r, (i + 1) & 1u);
      __syncwarp();
      request(r, i + 1);
      r.lo = lo;
      return got + 2;
    }
  }
  return got;
}

// Entry idx (< total) of the table: from the ring where it holds it, else
// from device memory (counted in misses).
__device__ __forceinline__ Entry entry(TabRing& r, unsigned idx, long long& misses) {
  if ((idx / kChunk) >= r.lo + 2) {
    ++misses;
    return r.tab[idx];
  }
  settle(r, (idx / kChunk) & 1u);
  unsigned g, other;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(g), "=r"(other)
               : "r"(r.ring + (idx % (2 * kChunk)) * 8u));
  return Entry{g, other};
}

constexpr int kWalkShared = 2 * 2 * kChunk * sizeof(Entry) + 4 * 8;

// The walker, one warp: every close in order, the first max_out written, the
// count (-1 where the pack set the flag) and the exit state. `stats`, if not
// null: the chunks the rings requested, the entries read from device memory,
// the closes at the trade after the last (a target already met), and the
// walker's nanoseconds.
__global__ void __launch_bounds__(32)
count_walk_kernel(Args a, CountWork w, long long* __restrict__ out, long long max_out,
                  long long* __restrict__ count, long long* __restrict__ stats,
                  InfoState* __restrict__ exit) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x;
  const unsigned long long t0 = global_ns();
  if (*w.flag != 0) {
    if (lane == 0) *count = -1;
    return;
  }
  const long long all = w.incl[w.blocks - 1];
  const long long b_all = all >> 32, s_all = all & 0xffffffffLL;
  // the shared base in a register once (not recomputed at every use)
  unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("mov.u32 %0, %0;" : "+r"(base));
  constexpr unsigned ring_bytes = 2 * kChunk * sizeof(Entry);
  TabRing rb{w.tab, static_cast<unsigned>(b_all), 0, base, base + 2 * ring_bytes, 0, 0};
  TabRing rs{w.tab + sells_at(b_all), static_cast<unsigned>(s_all), 0, base + ring_bytes,
             base + 2 * ring_bytes + 16, 0, 0};
  if (lane < 4)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(rb.bar + 8 * lane) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncwarp();
  for (unsigned i = 0; i < 2; ++i) {
    request(rb, i);
    request(rs, i);
  }
  InfoState s = entry_state<InfoState>(a);
  long long cb = static_cast<long long>(s.cb), cs = static_cast<long long>(s.cs);
  long long c = a.start - 1, bc = 0, sc = 0, cnt = 0, requested = 4, misses = 0, next = 0;
  while (c + 1 < a.n) {
    // a whole count reaches theta where it reaches ceil(theta); none reaches
    // a NaN or +inf theta, and every one a theta of -inf
    const double theta = __dmul_rn(s.e_t, s.e_r);
    if (!(theta < INFINITY)) break;
    const double k = ceil(theta);
    if (k > 0x1p62) break;
    const long long ki = static_cast<long long>(fmax(k, -0x1p62));
    const long long tb = bc + ki - cb, ts = sc + ki - cs;
    long long j, bj, sj;
    double stat;
    if (tb <= bc || ts <= sc) {  // a target met already: the trade after the last closes
      j = c + 1;
      bj = bc + (bc < b_all && entry(rb, static_cast<unsigned>(bc), misses).g == j);
      sj = sc + (sc < s_all && entry(rs, static_cast<unsigned>(sc), misses).g == j);
      stat = fmax(s.cb + static_cast<double>(bj - bc), s.cs + static_cast<double>(sj - sc));
      ++next;
    } else {
      const bool fb = tb <= b_all, fs = ts <= s_all;
      if (!fb && !fs) break;  // neither count reaches its target
      // both read at once: a side whose target lies past its last entry
      // reads its next entry (in the ring, and never the nearer)
      const Entry eb = entry(rb, static_cast<unsigned>(fb ? tb - 1 : bc), misses);
      const Entry es = entry(rs, static_cast<unsigned>(fs ? ts - 1 : sc), misses);
      // a buy and a sell are two trades: the nearer closes
      const bool by_buy = fb && (!fs || eb.g < es.g);
      j = by_buy ? eb.g : es.g;
      bj = by_buy ? tb : es.other;
      sj = by_buy ? eb.other : ts;
      // the count that reached its target stands at it: the statistic is k
      stat = static_cast<double>(ki);
    }
    s = info_close(s, stat, j, a);
    if (lane == 0 && cnt < max_out) out[cnt] = j;
    ++cnt;
    c = j;
    bc = bj;
    sc = sj;
    cb = cs = 0;
    requested += advance(rb, static_cast<unsigned>(bc) / kChunk) +
                 advance(rs, static_cast<unsigned>(sc) / kChunk);
  }
  for (unsigned q = 0; q < 2; ++q) {  // nothing left in flight
    settle(rb, q);
    settle(rs, q);
  }
  if (lane != 0) return;
  *count = min(cnt, max_out);
  if (exit != nullptr)
    *exit = {s.cb + static_cast<double>(b_all - bc), s.cs + static_cast<double>(s_all - sc),
             s.e_t, s.e_r, s.open};
  if (stats != nullptr) {
    stats[0] = requested;
    stats[1] = misses;
    stats[2] = next;
    stats[3] = static_cast<long long>(global_ns() - t0);
  }
}

long long count_layout(CountWork* w, char* base, long long n) {
  const long long blocks = (n + kCountBlock - 1) / kCountBlock;
  long long o = 0;
  auto take = [&](long long bytes) { char* p = base + o; o += round_up(bytes); return p; };
  CountWork v;
  v.blocks = blocks;
  v.buy = reinterpret_cast<unsigned*>(take(blocks * 32 * sizeof(unsigned)));
  v.sell = reinterpret_cast<unsigned*>(take(blocks * 32 * sizeof(unsigned)));
  v.cnt = reinterpret_cast<unsigned*>(take(blocks * 32 * sizeof(unsigned)));
  v.tot = reinterpret_cast<long long*>(take(blocks * sizeof(long long)));
  v.incl = reinterpret_cast<long long*>(take(blocks * sizeof(long long)));
  v.scan_scratch = take(fmk_scan_scratch_bytes(1, 1, blocks));
  // the buys and the sells are at most n, each table followed by a chunk
  // that the rings copy whole
  v.tab = reinterpret_cast<Entry*>(take((n + 2 * kChunk + 1) * sizeof(Entry)));
  v.flag = reinterpret_cast<int*>(take(sizeof(int)));
  if (w != nullptr) *w = v;
  return o;
}

// Mode 5: the pack, kernel S over the blocks' counts, the tables, the
// walker. The entry sums must be whole (and at most 2^52, so that every sum
// stays exact) and the stream below 2^31 trades (a table entry holds a trade
// in 32 bits, the blocks' counts share 64).
int launch_count(const Args& a, void* scratch, long long* out, long long max_out,
                 long long* count, void* stats, void* exit, cudaStream_t s) {
  InfoState entry;
  memcpy(&entry, a.entry, sizeof(entry));
  auto whole = [](double v) { return fabs(v) <= 0x1p52 && v == std::trunc(v); };
  if (a.n >= (1LL << 31) || !whole(entry.cb) || !whole(entry.cs))
    return static_cast<int>(cudaErrorInvalidValue);
  CountWork w;
  count_layout(&w, static_cast<char*>(scratch), a.n);
  FMK_CHECK(cudaMemsetAsync(w.flag, 0, sizeof(int), s));
  const unsigned blocks = static_cast<unsigned>(w.blocks);
  count_pack_kernel<<<blocks, 256, 0, s>>>(a.x, a.n, a.start, w.buy, w.sell, w.cnt, w.tot,
                                          w.flag);
  FMK_CHECK(cudaGetLastError());
  const int rc = fmk_prefix_scan(1, w.tot, w.incl, w.scan_scratch, w.blocks, s);
  if (rc != 0) return rc;
  count_table_kernel<<<blocks, 256, 0, s>>>(w.buy, w.sell, w.cnt, w.incl, w.blocks, w.tab);
  FMK_CHECK(cudaGetLastError());
  FMK_CHECK(cudaFuncSetAttribute(count_walk_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kWalkShared));
  count_walk_kernel<<<1, 32, kWalkShared, s>>>(a, w, out, max_out,
                                               static_cast<long long*>(count),
                                               static_cast<long long*>(stats),
                                               static_cast<InfoState*>(exit));
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
    case 4: return map_layout(nullptr, nullptr, n, start);
    case 5: return count_layout(nullptr, nullptr, n);
    default: return -1;
  }
}

// Kernel E. mode: 0 CUSUM (x = log returns, lam, can_close), 1 imbalance and
// 2 run (x = weights, e_t / e_r / alpha_t / alpha_r), 3 volume (units, thr;
// the first bar holds trade 0), 4 imbalance by tile maps (x = integer-valued
// finite weights, alphas 0, theta = e_t * e_r finite, positive and of at most
// kMapStates states; chunks and the stats' counts unused, the stats zeroed),
// 5 run by count search (x = weights, each -1, 0 or +1, else count[0] is -1
// and nothing else is written; whole entry sums cb and cs; chunks unused; the
// stats: table chunks the rings requested, entries read past the rings,
// closes at the trade after the last, the walker's nanoseconds).
// Checks trades start .. n-1 (start < n) in
// `chunks` chunks of whole tiles (at least 1), with `scratch` of
// fmk_event_scratch_bytes(mode, n, start, chunks) bytes, 256-byte aligned;
// writes the first max_out close indices to out and their number to
// count[0]. `stats`, if not null, receives four int64 counts: segments
// skipped, segments scanned, pass-2 chunks that did not merge, chunks fixed up.
// `entry` (host memory, five int64 words, or null for zeros) is the state the
// stream enters trade `start` with, as the mode's State: CUSUM {sp, sn}
// (doubles), imbalance and run {cb, cs, e_t, e_r (doubles), open (int64, the
// trade the bar opened at, relative to the stream)}, volume {carry} (int64;
// where start is 1, trade 0's units are added to it unchecked); mode 4 takes
// the imbalance state, its cb an integer of at most K in magnitude. `exit`
// (device memory, five int64 words, or null) receives the state after trade
// n-1 in the same layout. Returns cudaGetLastError().
extern "C" int fmk_event_scan(int mode, const void* x, const void* lam,
                              const void* can_close, const void* units,
                              long long n, long long start, double e_t,
                              double e_r, double alpha_t, double alpha_r,
                              long long thr, const void* entry, void* scratch,
                              long long chunks, void* out, long long max_out,
                              void* count, void* stats, void* exit, void* stream) {
  if (start >= n || chunks < 1 || max_out < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const double*>(x), static_cast<const double*>(lam),
         static_cast<const unsigned char*>(can_close),
         static_cast<const long long*>(units), n, start, e_t, e_r, alpha_t,
         alpha_r, thr, {0, 0, 0, 0, 0}};
  if (entry != nullptr) memcpy(a.entry, entry, sizeof(a.entry));
  long long* o = static_cast<long long*>(out);
  long long* c = static_cast<long long*>(count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<Cusum>(a, scratch, chunks, o, max_out, c, stats, exit, s);
    case 1: return launch<Imbalance>(a, scratch, chunks, o, max_out, c, stats, exit, s);
    case 2: return launch<Run>(a, scratch, chunks, o, max_out, c, stats, exit, s);
    case 3: return launch<Volume>(a, scratch, chunks, o, max_out, c, stats, exit, s);
    case 4: return launch_map(a, scratch, o, max_out, c, stats, exit, s);
    case 5: return launch_count(a, scratch, o, max_out, c, stats, exit, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
