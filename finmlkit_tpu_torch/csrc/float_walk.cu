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
// THREE ROUTES. route_kernel reads the stream once on all SMs: it flags a
// value that is negative or not finite and, for volume bars, finds the
// lowest set bit over the values and the largest value. The host reads those
// three numbers once and launches one route: the block walk for a flagged
// stream or a threshold outside [2^-960, 2^1000), kernel E's volume scan on
// integer units for a volume walk of the exact-sum case (6. below), the warp
// step for the others.
//
// THE WARP STEP. Its proof, for values x >= 0 that are finite:
//
// 1. The identity. Let g = S u, u = 2^(e-52), 2^52 <= S < 2^53: a double of
//    the binade [2^e, 2^(e+1)). Let q = x / u (exact: a power-of-two scaling),
//    k = floor(q) and f = q - k. The doubles from 2^e up to 2^(e+1) are the
//    multiples of u, 2^(e+1) included, and a significand's last bit is the
//    parity of its multiple; so fl(g + x) rounds S + q to an integer, ties to
//    the even one, as long as that integer is at most 2^53: fl(g + x) =
//    (S + k + r) u with r = [f > 1/2], and at a tie (f = 1/2) r = (S + k) & 1.
//    If the rounded integer exceeds 2^53, so does S + k + r (and the double
//    sum lies at or above 2^(e+1)). A run of adds inside the binade is thus an
//    integer prefix sum of the k, with a parity map at each tie.
// 2. The limits. With L_e = min(2^53, ceil(thr / u)), a state S < L_e is below
//    the threshold (S u < thr) and in its binade. The values are >= 0, so the
//    prefix of the k only rises: the first trade whose integer state reaches
//    L_e is the first that leaves the binade or may close, and every trade
//    before it is an add of the identity with no close.
// 3. The crossing trade takes the loop's own __dadd_rn from the exact state it
//    enters with (S u, built from the bits), then the compare, and at a close
//    __dsub_rn (dollar) or the reset to 0 (volume); the walk goes on from the
//    state that gives, in its binade.
// 4. Ties. The tables store a tie's k plus kTie = 2^52 + 1 > 2^53 - S, so a tie
//    stops the search as a crossing does; the walker adds r from the exact
//    parity there and goes on if the state stays below L_e (else it is a
//    crossing). k is capped at 2^52, which also reaches L_e from any S.
// 5. The first trade is the state the walk starts with, unchecked, or an
//    entry sum carried from the trades before the stream starts it and trade
//    0 is checked; states below 2^e_lo (0 after a volume close among them)
//    or at or above the threshold (a dollar carry) take real adds, kRun at
//    once while their sum stays below 2^e_lo (values >= 0: no sum before the
//    last is larger). The tables' seven binades thus cover every entry sum
//    in [2^e_lo, thr), and any other takes real adds until it enters them.
//    The host sends an entry sum that is negative or not finite to the block
//    walk, as the route pass sends such a value; the units route takes an
//    entry sum only where it is a whole number of the unit (6.).
//
// 6. The exact-sum case (volume bars). Where every value is a multiple of
//    U = 2^u and ceil(thr / U) and the largest value are below 2^52 U, every
//    add of the loop starts from a state below thr, 0 or trade 0's value, so
//    its sum is a multiple of U below 2^53 U and does not round, and
//    cum >= thr holds exactly where cum / U >= ceil(thr / U): the walk is
//    kernel E's volume scan of the integers x / U at that threshold (the sum
//    starts with trade 0's, checks from trade 1, resets to 0). units_kernel
//    writes them; the scan is E's.
//
// Layout: one block of 8 warps a walk. Warps 1-3 and 5-7 (producers) fill a
// ring of three tiles of 768 trades ahead of the walker: each trade's value
// (the product rounded once for dollar) and, for each of the kBinades = 7
// binades below the threshold (e_lo .. e_top, thr in binade e_top), its k
// from q + 2^52 (the FPU's round to nearest even on integers; (t - 2^52) - q
// is -+1/2 exactly at a tie), as the prefix in the tile and at each step's
// end. Warp 0 walks, alone on its quarter of the SM (warp 4 waits at the
// barrier): with the state in a table's binade it holds lim = L - S + P(last
// trade), so that a later trade m stops it where P(m) >= lim. A round is one
// ballot over the next 32 trades and one over the ends of the tile's later
// steps of 32, a second round the step found. Each lane loads its trade's
// prefix, the one before and its value, so an event (a tie, a binade
// crossing, a close) costs shuffles, and the next round's loads are issued
// before the event is resolved. The walk is about ten events a bar.
//
// Volume bars restart at exactly 0 at each close, so two walks that close at
// one trade are equal from there on (kernel E's volume mode): pass 1 walks all
// chunks at once (chunk 0 from trade 0 or the entry sum, the others from a
// bar that opens at their first trade), pass 2 walks each chunk c > 0 again from chunk c-1's
// pass-1 end state until it closes where pass 1 did, and the fix-up walks, in
// chunk order, each chunk whose last walk did not begin at its predecessor's
// final end state, until it closes where that walk did. Each walk sets its
// closes in a bitmap of its own; the compaction takes a chunk's closes from
// the fix-up's before its merge trade, pass 2's before its merge trade, and
// pass 1's after. Dollar bars carry a remainder and walk as one chunk. The
// exit sum is the last chunk's end state after the fix-up (pass 1's with one
// chunk).
//
// Bound: the walker's chain of dependent shared loads, ballots and shuffles,
// some hundreds of cycles an event, not memory: the stream's bytes (4 a trade
// for volume, 12 for dollar) take 0.05-0.14 ms at the card's memory rate.
// The producers' tables come next (their float64 and integer work for seven
// binades, about 100 ms of the month alone).
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

using u64 = unsigned long long;
constexpr unsigned kFull = 0xffffffffu;

template <bool kDollar>
__device__ __forceinline__ double value(const double* p, const float* v, long long i) {
  const double x = static_cast<double>(v[i]);   // exact
  if constexpr (kDollar) return __dmul_rn(p[i], x);
  return x;
}

// --- the block walk: streams outside the warp step's domain ---------------
//
// ONE block of 256 threads. The stream goes through shared memory in chunks
// of 2048 values, double-buffered: while lane 0 of warp 0 walks one chunk,
// warps 1-7 read the next chunk and compute its values, and one barrier a
// chunk hands the buffers over. Lane 0 takes 16 values at a time into
// registers and adds them in order; where all 16 are >= 0 and the sum after
// the 16th is still below the threshold, no close lies among them (a rounded
// add of a value >= 0 never decreases the sum) and the 16 adds are exactly
// the loop's. Otherwise it takes the 16 values again, one step at a time,
// from the sum before them.

constexpr int kThreads = 256;
constexpr int kChunk = 2048;                 // values a buffer holds
constexpr int kStagers = kThreads - 32;      // warps 1-7 stage
constexpr int kBlock = 16;                   // values lane 0 adds before a check

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

// With `entered`, the walk starts from the sum cum0 before trade 0 and
// checks trade 0; `exit`, if not null, receives the sum after the last trade
// (after the last close written where max_bars stops the walk).
template <bool kDollar>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const double* __restrict__ p, const float* __restrict__ v,
            long long n, double thr, long long max_bars, bool entered, double cum0,
            long long* __restrict__ out, long long* __restrict__ count,
            double* __restrict__ exit) {
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
        cum = entered ? cum0 : x[0];
        j = entered ? 0 : 1;
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
  if (t == 0) {
    *count = k;
    if (exit != nullptr) *exit = cum;
  }
}

// The route pass: info[0] = 1 where a value is negative or not finite; for
// volume bars (`lows`) also info[1], the exponent of the lowest set bit over
// the values > 0, and info[2], the largest value's bits.
template <bool kDollar>
__global__ void route_kernel(const double* __restrict__ p, const float* __restrict__ v,
                             long long n, long long* __restrict__ info, bool lows) {
  bool bad = false;
  long long lo_bit = LLONG_MAX;
  u64 top = 0;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const double x = value<kDollar>(p, v, i);
    bad |= !(x >= 0.0) || isinf(x);
    if (lows && x > 0.0) {
      const u64 b = static_cast<u64>(__double_as_longlong(x));
      const int e = static_cast<int>(b >> 52);
      const u64 m = (b & ((1ull << 52) - 1)) | (e ? 1ull << 52 : 0ull);
      lo_bit = min(lo_bit, static_cast<long long>((e ? e : 1) - 1075 +
                                                  __ffsll(static_cast<long long>(m)) - 1));
      top = b > top ? b : top;
    }
  }
  if (lows) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo_bit = min(lo_bit, __shfl_xor_sync(kFull, lo_bit, o));
      const u64 t = __shfl_xor_sync(kFull, top, o);
      top = t > top ? t : top;
    }
    if ((threadIdx.x & 31) == 0 && lo_bit != LLONG_MAX) {
      atomicMin(info + 1, lo_bit);
      atomicMax(reinterpret_cast<u64*>(info + 2), top);
    }
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) info[0] = 1;
}

// The exact-sum case's integers: units[i] = volumes[i] / 2^u (exact).
__global__ void units_kernel(const float* __restrict__ v, long long n, double inv_unit,
                             long long* __restrict__ units) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    units[i] = static_cast<long long>(__dmul_rn(static_cast<double>(v[i]), inv_unit));
  }
}

// --- the warp step --------------------------------------------------------

constexpr int kTile = 768;                   // trades a ring tile holds
constexpr int kSteps = kTile / 32;           // steps of 32 trades a tile
constexpr int kBinades = 7;                  // binades with grid tables
constexpr int kRing = 3;                     // tiles in the ring
constexpr int kWarps = 8;                    // warp 0 walks, warp 4 waits, 6 produce
constexpr int kIdle = 4;                     // shares the walker's quarter of the SM
constexpr int kProducers = kWarps - 2;
constexpr int kPer = kTile / (32 * kProducers);   // trades a producer thread takes
constexpr int kTps = 32 / kPer;                    // producer threads a step of 32
constexpr int kWalkThreads = 32 * kWarps;
constexpr int kPad = kTile + kTile / 8;      // a gap every 8 trades: no bank conflicts
constexpr int kRun = 4;                      // serial adds before one compare
constexpr int kGroupWords = 8192;            // bitmap words a compaction block takes
constexpr u64 kTwo52 = 1ull << 52, kTwo53 = 1ull << 53;
constexpr u64 kTie = kTwo52 + 1;
static_assert(kPer == 4 || kPer == 8, "a producer thread loads 4 or 8 trades");

// The walks' counts, taken where a call asks for them; CYCLES, WAIT and
// PWAIT in SM clock cycles: the walker's, of them those it waited for a
// tile, and those the producers waited for room.
enum Stat { SEARCHES, STEPS, TIES, CROSSINGS, SERIAL, CLOSES, UNMERGED, FIXED, CYCLES, WAIT,
            PWAIT, NSTATS };

__device__ __forceinline__ int pad(int m) { return m + (m >> 3); }

struct Tile {
  double x[kPad];               // the trades' values
  u64 p[kBinades][kPad];        // grid values' inclusive prefix in the tile
  u64 e[kBinades][kSteps];      // the same at each step's end
  unsigned old[kSteps];         // the closes of the walk this one merges with
};

struct Shared {
  Tile tile[kRing];
  u64 stot[kBinades][kSteps];   // step totals, before their scan
  u64 lims[kBinades];           // Walk::lim
  int produced, consumed, stop, go;
  double end;                   // the walk's end state
  long long merged;             // the trade where it merged, or -1
};

struct Rec {                    // one chunk of a volume walk
  double end1, end2;            // end states: pass 1; pass 2 where it never merged
  long long m2, m3;             // pass 2's and the fix-up's merge trades (lo: none)
};

struct Walk {
  const double* p;
  const float* v;
  long long n, per, chunks, max_bars;
  double thr, lo_bound, s0;     // s0 = 2^(52 - e_lo), lo_bound = 2^e_lo
  bool entered;                 // chunk 0 starts from g0 at trade 0
  double g0;
  double* exit;                 // the sum after the last trade, or null
  int e_lo;
  u64 lim[kBinades];            // L of each binade e_lo + d
  unsigned *a, *b, *f;          // close bitmaps: pass 1, pass 2, the fix-up
  Rec* rec;
  long long* gcnt;              // closes of each compaction group
  long long* stats;             // Stat, or null: no counts
  long long* out;
  long long* count;             // closes written
};

// A handshake that has waited some seconds is a fault: stop the launch with
// an error rather than hold the card.
__device__ __forceinline__ void spin(long long& spins) {
  if (++spins > (1ll << 28)) __trap();
}

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kProducers) : "memory");
}

// k of x on the grid of scale s = 2^(52 - e), a tie's floor plus kTie.
__device__ __forceinline__ u64 grid(double x, double s) {
  const double q = __dmul_rn(x, s);
  const double t = fmin(__dadd_rn(q, 0x1p52), 0x1p53);
  const double diff = __dsub_rn(__dsub_rn(t, 0x1p52), q);
  u64 k = static_cast<u64>(__double_as_longlong(t)) - 0x4330000000000000ull;
  if (fabs(diff) == 0.5) k += kTie - (diff > 0.0 ? 1ull : 0ull);
  return k;
}

// Bits below trade `split` from lo_w, the rest from hi_w (word of trade w0).
__device__ __forceinline__ unsigned pick(unsigned hi_w, unsigned lo_w, long long split,
                                         long long w0) {
  if (split <= w0) return hi_w;
  if (split >= w0 + 32) return lo_w;
  const unsigned m = (1u << (split - w0)) - 1u;
  return (lo_w & m) | (hi_w & ~m);
}

template <bool kDollar>
__device__ __forceinline__ void load(const Walk& w, long long i, long long hi, double (&pp)[kPer],
                                     float (&vv)[kPer]) {
  if (i + kPer <= hi) {
    const float4* v4 = reinterpret_cast<const float4*>(w.v + i);
#pragma unroll
    for (int k = 0; k < kPer / 4; ++k) {
      const float4 a = __ldg(v4 + k);
      vv[4 * k] = a.x;
      vv[4 * k + 1] = a.y;
      vv[4 * k + 2] = a.z;
      vv[4 * k + 3] = a.w;
    }
    if constexpr (kDollar) {
      const double2* p2 = reinterpret_cast<const double2*>(w.p + i);
#pragma unroll
      for (int k = 0; k < kPer / 2; ++k) {
        const double2 t = __ldg(p2 + k);
        pp[2 * k] = t.x;
        pp[2 * k + 1] = t.y;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const bool in = i + k < hi;
      vv[k] = in ? w.v[i + k] : 0.0f;
      if constexpr (kDollar) pp[k] = in ? w.p[i + k] : 0.0;
    }
  }
}

// The producer warps (1-3 and 5-7): the ring's tiles of trades lo .. hi-1, ahead of the walker.
template <bool kDollar>
__device__ void produce(const Walk& w, Shared& sm, long long lo, long long hi, int ntiles,
                        const unsigned* old_lo, const unsigned* old_hi, long long split) {
  const int wid = threadIdx.x >> 5, pw = wid - 1 - (wid > kIdle), pl = threadIdx.x & 31;
  const int pt = 32 * pw + pl, qs = pl % kTps;
  volatile int* flags = &sm.produced;   // produced, consumed, stop, go
  const bool counting = w.stats != nullptr;
  double pp[kPer];
  float vv[kPer];
  long long waited = 0;
  load<kDollar>(w, lo + kPer * pt, hi, pp, vv);
  for (int j = 0; j < ntiles; ++j) {
    if (pt == 0) {
      long long spins = 0;
      const long long t0 = counting ? clock64() : 0;
      while (flags[1] <= j - kRing && !flags[2]) spin(spins);
      if (counting) waited += clock64() - t0;
      flags[3] = !flags[2];
    }
    producer_sync();
    if (!flags[3]) break;
    double x[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      x[k] = kDollar ? __dmul_rn(pp[k], static_cast<double>(vv[k])) : static_cast<double>(vv[k]);
    }
    const long long cb = lo + static_cast<long long>(j) * kTile;
    if (j + 1 < ntiles) load<kDollar>(w, cb + kTile + kPer * pt, hi, pp, vv);
    Tile& t = sm.tile[j % kRing];
#pragma unroll
    for (int k = 0; k < kPer; ++k) t.x[pad(kPer * pt + k)] = x[k];
    if (old_hi != nullptr && pt < kSteps) {
      const long long w0 = cb + 32 * pt;
      t.old[pt] = w0 < hi ? pick(old_hi[w0 >> 5], old_lo[w0 >> 5], split, w0) : 0u;
    }
    // each binade's grid values, their prefix in the step, the step totals
    u64 loc[kBinades][kPer];
    double s = w.s0;
#pragma unroll
    for (int d = 0; d < kBinades; ++d, s *= 0.5) {
      u64 acc = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        acc += grid(x[k], s);
        loc[d][k] = acc;
      }
      u64 incl = acc;
#pragma unroll
      for (int o = 1; o < kTps; o <<= 1) {
        const u64 y = __shfl_up_sync(kFull, incl, o, kTps);
        if (qs >= o) incl += y;
      }
      const u64 ex = incl - acc;
#pragma unroll
      for (int k = 0; k < kPer; ++k) loc[d][k] += ex;
      if (qs == kTps - 1) sm.stot[d][pt / kTps] = incl;
    }
    __threadfence_block();
    producer_sync();
    // the prefix at each step's end, in the tile
    for (int d = pw; d < kBinades; d += kProducers) {
      u64 v = pl < kSteps ? sm.stot[d][pl] : 0ull;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const u64 y = __shfl_up_sync(kFull, v, o);
        if (pl >= o) v += y;
      }
      if (pl < kSteps) t.e[d][pl] = v;
    }
    __threadfence_block();
    producer_sync();
    // the prefix in the tile: one shared load a value for the walker
    const int step = pt / kTps;
#pragma unroll
    for (int d = 0; d < kBinades; ++d) {
      const u64 off = step > 0 ? t.e[d][step - 1] : 0ull;
#pragma unroll
      for (int k = 0; k < kPer; ++k) t.p[d][pad(kPer * pt + k)] = loc[d][k] + off;
    }
    __threadfence_block();
    producer_sync();
    if (pt == 0) flags[0] = j + 1;
  }
  if (counting && pt == 0) atomicAdd(reinterpret_cast<u64*>(w.stats + PWAIT), static_cast<u64>(waited));
}

// Warp 0: the walk of trades start .. hi-1 (start = lo + first) from the
// state g entering it (trade lo's value where first), its closes set in
// `bits`; it stops at `cap` closes or, where `merging`, at a close that the
// tiles' old words hold. All 32 lanes hold the state. The walk is a chain of
// dependent latencies, so a round's shared loads have no branches between
// them, an event costs shuffles, and the next round's loads are issued
// before the event is resolved, for the same binade (a tie) and the next
// one (a crossing).
template <bool kDollar>
__device__ void walker(const Walk& w, Shared& sm, long long lo, long long hi, int ntiles,
                       bool first, double g, bool merging, unsigned* bits, long long cap) {
  const int lane = threadIdx.x;
  const int lb = lane < kBinades ? lane : kBinades - 1;   // lane b < kBinades: binade b
  volatile int* flags = &sm.produced;
  const bool counting = w.stats != nullptr;
  const double thr = w.thr, lo_bound = w.lo_bound;
  const u64 lreg = sm.lims[lb];
  long long st_search = 0, st_step = 0, st_tie = 0, st_cross = 0, st_serial = 0, closes = 0;
  long long merged = -1, waited = 0;
  const long long t_start = counting ? clock64() : 0;
  bool win = false, done = false;
  int d = 0, eb = 0;
  u64 lim = 0, L = 0;
  for (int j = 0; j < ntiles && !done; ++j) {
    long long spins = 0;
    const long long t0 = counting ? clock64() : 0;
    while (flags[0] <= j) spin(spins);
    if (counting) waited += clock64() - t0;
    __threadfence_block();
    const Tile& t = sm.tile[j % kRing];
    const long long cb = lo + static_cast<long long>(j) * kTile;
    const int len = static_cast<int>(hi - cb < kTile ? hi - cb : kTile);
    const int nst = (len + 31) >> 5;
    // a round's loads from trade p of binade b: lane l takes the prefix at
    // p + l and before it, its value (clamped into the tile) and the prefix
    // at the end of step (p + 32) / 32 + l
    auto fetch = [&](int b, int p, u64& a, u64& a1, double& xv, u64& ev) {
      const int m = min(p + lane, len - 1);
      const u64 v1 = t.p[b][pad(max(m - 1, 0))];
      a = t.p[b][pad(m)];
      a1 = m > 0 ? v1 : 0ull;
      xv = t.x[pad(m)];
      ev = t.e[b][min(((p + 32) >> 5) + lane, nst - 1)];
    };
    // lane b < kBinades: binade b's prefix at tile trade q (0 before the tile)
    auto at = [&](int q) -> u64 {
      const u64 v = t.p[lb][pad(max(q, 0))];
      return q >= 0 ? v : 0ull;
    };
    // the state g after a tile trade where lane b of pq holds binade b's
    // prefix: its binade's table, if it has one
    auto enter = [&](u64 pq) {
      win = g >= lo_bound && g < thr;
      if (win) {
        const u64 gb = static_cast<u64>(__double_as_longlong(g));
        eb = static_cast<int>(gb >> 52);
        d = eb - 1023 - w.e_lo;
        L = __shfl_sync(kFull, lreg, d);
        lim = L - ((gb & (kTwo52 - 1)) | kTwo52) + __shfl_sync(kFull, pq, d);
      }
    };
    // a close at tile trade m; true to stop
    auto close = [&](int m) -> bool {
      const long long i = cb + m;
      if (lane == 0) atomicOr(bits + (i >> 5), 1u << (i & 31));
      ++closes;
      g = kDollar ? __dsub_rn(g, thr) : 0.0;
      if (merging && ((t.old[m >> 5] >> (m & 31)) & 1u)) {
        merged = i;
        return true;
      }
      return closes >= cap;
    };
    int pos = 0;
    if (j == 0) {
      if (first) {
        g = t.x[pad(0)];
        pos = 1;
      }
      enter(at(pos - 1));
    }
    bool pre = false;             // the round's values are loaded already
    u64 pn = 0, pn1 = 0, pe = 0;
    double xn = 0.0;
    while (pos < len) {
      if (!win) {   // real adds
        if (pos + kRun <= len) {
          double s = g;
#pragma unroll
          for (int u = 0; u < kRun; ++u) s = __dadd_rn(s, t.x[pad(pos + u)]);
          if (s < lo_bound) {
            g = s;
            pos += kRun;
            st_serial += kRun;
            continue;
          }
        }
        const u64 pq = at(pos);   // loaded while the add runs
        g = __dadd_rn(g, t.x[pad(pos)]);
        ++st_serial;
        if (g >= thr && close(pos)) {
          done = true;
          break;
        }
        enter(pq);
        ++pos;
        continue;
      }
      // a round: the next 32 trades and the ends of the tile's later steps
      if (!pre) fetch(d, pos, pn, pn1, xn, pe);
      pre = false;
      const int s0 = (pos + 32) >> 5;
      unsigned hit = __ballot_sync(kFull, pos + lane < len && pn >= lim);
      const unsigned far = __ballot_sync(kFull, s0 + lane < nst && pe >= lim);
      ++st_step;
      int base = pos;
      if (!hit) {   // the step whose end stops the walk, a second round
        if (!far) break;
        ++st_search;
        base = 32 * (s0 + __ffs(far) - 1);
        fetch(d, base, pn, pn1, xn, pe);
        hit = __ballot_sync(kFull, base + lane < len && pn >= lim);
      }
      const int src = __ffs(hit) - 1;
      const int m = base + src;
      const u64 pm = __shfl_sync(kFull, pn, src), pp = __shfl_sync(kFull, pn1, src);
      const double xm = __shfl_sync(kFull, xn, src);
      // ahead of the event: the next round in this binade (after a tie) and
      // in the next (after a crossing), and each binade's prefix at m
      const int nb = d + 1 < kBinades ? d + 1 : d;
      u64 tn, tn1, te, cn, cn1, ce;
      double tx, cx;
      fetch(d, m + 1, tn, tn1, tx, te);
      fetch(nb, m + 1, cn, cn1, cx, ce);
      const u64 pq = at(m);
      const u64 s1 = L - lim + pp;   // the exact state before trade m
      const u64 kap = pm - pp;
      pos = m + 1;
      if (kap > kTwo52) {            // a tie: to the even neighbour
        ++st_tie;
        const u64 kf = kap - kTie, r = (s1 + kf) & 1ull;
        if (s1 + kf + r < L) {
          lim += kTie - r;
          pn = tn, pn1 = tn1, xn = tx, pe = te, pre = true;
          continue;
        }
      }
      ++st_cross;                    // the loop's own add from the exact state
      const double gp =
          __longlong_as_double(static_cast<long long>(s1 + (static_cast<u64>(eb - 1) << 52)));
      g = __dadd_rn(gp, xm);
      if (g >= thr && close(m)) {
        done = true;
        break;
      }
      enter(pq);
      if (win && d == nb) pn = cn, pn1 = cn1, xn = cx, pe = ce, pre = true;
    }
    if (win && !done) lim -= t.e[d][nst - 1];
    __syncwarp();
    __threadfence_block();
    if (lane == 0) flags[1] = j + 1;
  }
  if (win && !done) {
    g = __longlong_as_double(static_cast<long long>((L - lim) + (static_cast<u64>(eb - 1) << 52)));
  }
  if (lane == 0) {
    flags[2] = 1;
    sm.end = g;
    sm.merged = merged;
  }
  if (lane == 0 && counting) {
    const long long add[] = {st_search, st_step, st_tie, st_cross, st_serial, closes, 0, 0,
                             clock64() - t_start, waited};
#pragma unroll
    for (int k = 0; k <= WAIT; ++k) {
      if (add[k]) atomicAdd(reinterpret_cast<u64*>(w.stats + k), static_cast<u64>(add[k]));
    }
  }
}

// One walk by the whole block; afterwards sm.end and sm.merged hold its end
// state and merge trade (-1: none).
template <bool kDollar>
__device__ void walk(const Walk& w, Shared& sm, long long lo, long long hi, bool first, double g,
                     const unsigned* old_lo, const unsigned* old_hi, long long split,
                     unsigned* bits, long long cap) {
  if (threadIdx.x == 0) sm.produced = sm.consumed = sm.stop = sm.go = 0;
  if (threadIdx.x < kBinades) sm.lims[threadIdx.x] = w.lim[threadIdx.x];
  __syncthreads();
  const int ntiles = static_cast<int>((hi - lo + kTile - 1) / kTile);
  const int wid = threadIdx.x >> 5;
  if (wid == 0) {
    walker<kDollar>(w, sm, lo, hi, ntiles, first, g, old_hi != nullptr, bits, cap);
  } else if (wid != kIdle) {
    produce<kDollar>(w, sm, lo, hi, ntiles, old_lo, old_hi, split);
  }
  __syncthreads();
}

__device__ __forceinline__ Shared& shared_state() {
  extern __shared__ __align__(16) unsigned char smem[];
  return *reinterpret_cast<Shared*>(smem);
}

// Pass 1: chunk c from a bar that opens at its first trade (chunk 0 from
// trade 0's value, or from the entry sum g0 at trade 0); with one chunk, the
// whole walk, to at most max_bars closes.
template <bool kDollar>
__global__ void __launch_bounds__(kWalkThreads, 1) pass1_kernel(Walk w) {
  Shared& sm = shared_state();
  const long long c = blockIdx.x, lo = c * w.per, hi = min(lo + w.per, w.n);
  const bool entered = c == 0 && w.entered;
  walk<kDollar>(w, sm, lo, hi, c == 0 && !entered, entered ? w.g0 : 0.0, nullptr, nullptr,
                0, w.a, w.chunks == 1 ? w.max_bars : LLONG_MAX);
  if (threadIdx.x == 0) {
    w.rec[c] = Rec{sm.end, sm.end, lo, lo};
    if (w.chunks == 1 && w.exit != nullptr) *w.exit = sm.end;
  }
}

// Pass 2: chunk c > 0 from chunk c-1's pass-1 end state until it merges with
// its pass-1 walk.
__global__ void __launch_bounds__(kWalkThreads, 1) pass2_kernel(Walk w) {
  Shared& sm = shared_state();
  const long long c = blockIdx.x + 1, lo = c * w.per, hi = min(lo + w.per, w.n);
  const double g = w.rec[c - 1].end1;
  if (__double_as_longlong(g) == 0) return;   // pass 1's own entry
  walk<false>(w, sm, lo, hi, false, g, w.a, w.a, 0, w.b, LLONG_MAX);
  if (threadIdx.x == 0) {
    w.rec[c].m2 = sm.merged >= 0 ? sm.merged : hi;
    if (sm.merged < 0) {
      w.rec[c].end2 = sm.end;
      if (w.stats != nullptr) atomicAdd(reinterpret_cast<u64*>(w.stats + UNMERGED), 1ull);
    }
  }
}

// The fix-up, one block: in chunk order, each chunk whose last walk began
// elsewhere than at its predecessor's final end state, until it merges with
// that walk (pass 2's closes before its merge trade, pass 1's after).
__global__ void __launch_bounds__(kWalkThreads, 1) fixup_kernel(Walk w) {
  Shared& sm = shared_state();
  double fe = w.rec[0].end1;
  for (long long c = 1; c < w.chunks; ++c) {
    const long long lo = c * w.per, hi = min(lo + w.per, w.n);
    const Rec r = w.rec[c];
    double last = r.m2 < hi ? r.end1 : r.end2;
    if (__double_as_longlong(fe) != __double_as_longlong(w.rec[c - 1].end1)) {
      walk<false>(w, sm, lo, hi, false, fe, w.b, w.a, r.m2, w.f, LLONG_MAX);
      if (sm.merged < 0) last = sm.end;
      if (threadIdx.x == 0) {
        w.rec[c].m3 = sm.merged >= 0 ? sm.merged : hi;
        if (w.stats != nullptr) atomicAdd(reinterpret_cast<u64*>(w.stats + FIXED), 1ull);
      }
    }
    fe = last;
  }
  if (threadIdx.x == 0 && w.exit != nullptr) *w.exit = fe;   // the last chunk's end
}

// The closes of bitmap word gw: the fix-up's below m3, pass 2's below m2,
// pass 1's above.
__device__ __forceinline__ unsigned final_word(const Walk& w, long long gw) {
  const long long w0 = gw * 32;
  const unsigned a = w.a[gw];
  if (w.b == nullptr) return a;
  const Rec& r = w.rec[w0 / w.per];
  return pick(pick(a, w.b[gw], r.m2, w0), w.f[gw], r.m3, w0);
}

__device__ long long block_sum(long long x) {
  __shared__ long long part[8];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = x;
  __syncthreads();
  long long s = 0;
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) s += part[i];
  return s;
}

// Compaction, pass 1: the closes of each group of kGroupWords words.
__global__ void __launch_bounds__(256) count_kernel(Walk w) {
  const long long nw = (w.n + 31) / 32;
  const long long g0 = blockIdx.x * static_cast<long long>(kGroupWords);
  const long long g1 = min(g0 + kGroupWords, nw);
  long long cnt = 0;
  for (long long gw = g0 + threadIdx.x; gw < g1; gw += blockDim.x) cnt += __popc(final_word(w, gw));
  cnt = block_sum(cnt);
  if (threadIdx.x == 0) w.gcnt[blockIdx.x] = cnt;
}

// Compaction, pass 2: each group writes its closes in order from the sum of
// the groups before it; the last writes the count.
__global__ void __launch_bounds__(256) write_kernel(Walk w) {
  __shared__ long long part[8];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long nw = (w.n + 31) / 32;
  const long long g0 = blockIdx.x * static_cast<long long>(kGroupWords);
  const long long g1 = min(g0 + kGroupWords, nw);
  long long before = 0;
  for (long long k = threadIdx.x; k < blockIdx.x; k += blockDim.x) before += w.gcnt[k];
  long long off = block_sum(before);
  for (long long b0 = g0; b0 < g1; b0 += blockDim.x) {
    const long long gw = b0 + threadIdx.x;
    unsigned word = gw < g1 ? final_word(w, gw) : 0u;
    long long incl = __popc(word);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    __syncthreads();
    if (lane == 31) part[wid] = incl;
    __syncthreads();
    long long ex = incl - __popc(word), total = 0;
    for (int i = 0; i < 8; ++i) {
      if (i < wid) ex += part[i];
      total += part[i];
    }
    long long o = off + ex;
    while (word) {
      if (o < w.max_bars) w.out[o] = gw * 32 + (__ffs(word) - 1);
      ++o;
      word &= word - 1u;
    }
    off += total;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) *w.count = off < w.max_bars ? off : w.max_bars;
}

struct Layout {
  long long per, chunks, nw, groups;
  size_t rec, gcnt, a, b, f, total;
};

size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

Layout layout(long long n, long long chunks) {
  Layout l{};
  const long long tiles = (n + kTile - 1) / kTile;
  l.per = (tiles + chunks - 1) / chunks * kTile;
  l.chunks = (n + l.per - 1) / l.per;
  l.nw = (n + 31) / 32;
  l.groups = (l.nw + kGroupWords - 1) / kGroupWords;
  const size_t words = align16(static_cast<size_t>(l.nw) * 4);
  l.rec = 0;
  l.gcnt = l.rec + align16(static_cast<size_t>(l.chunks) * sizeof(Rec));
  l.a = l.gcnt + align16(static_cast<size_t>(l.groups) * sizeof(long long));
  l.b = l.a + words;
  l.f = l.b + (l.chunks > 1 ? words : 0);
  l.total = l.f + (l.chunks > 1 ? words : 0);
  return l;
}

template <typename K>
void allow_shared(K kernel) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(sizeof(Shared)));
}

template <bool kDollar>
void launch(const Walk& w, const Layout& l, cudaStream_t s) {
  allow_shared(pass1_kernel<kDollar>);
  pass1_kernel<kDollar><<<static_cast<unsigned>(l.chunks), kWalkThreads, sizeof(Shared), s>>>(w);
  if (l.chunks > 1) {
    allow_shared(pass2_kernel);
    allow_shared(fixup_kernel);
    pass2_kernel<<<static_cast<unsigned>(l.chunks - 1), kWalkThreads, sizeof(Shared), s>>>(w);
    fixup_kernel<<<1, kWalkThreads, sizeof(Shared), s>>>(w);
  }
  count_kernel<<<static_cast<unsigned>(l.groups), 256, 0, s>>>(w);
  write_kernel<<<static_cast<unsigned>(l.groups), 256, 0, s>>>(w);
}

}  // namespace

// Scratch bytes of a walk of n trades cut into `chunks` (a volume walk; a
// dollar walk is one chunk).
extern "C" long long fmk_float_walk_scratch_bytes(long long n, long long chunks) {
  if (n <= 0 || chunks < 1) return 0;
  return static_cast<long long>(layout(n, chunks).total);
}

// Kernel D's route pass over n >= 1 trades (mode 0 volume bars of the
// float32 `volumes`, mode 1 dollar bars of the float64 `prices` times
// `volumes`): `info` (int64[3]) receives 1 in info[0] where a value is
// negative or not finite, and for volume bars the exponent of the lowest set
// bit over the values > 0 in info[1] (0x7f7f7f7f7f7f7f7f where no value is
// > 0) and the largest value's bits in info[2]. On `stream`; returns
// cudaGetLastError().
extern "C" int fmk_float_walk_route(int mode, const void* prices, const void* volumes,
                                    long long n, void* info, void* stream) {
  if (n <= 0 || (mode != 0 && mode != 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const double*>(prices);
  const auto* v = static_cast<const float*>(volumes);
  auto* i = static_cast<long long*>(info);
  cudaMemsetAsync(i, 0, 3 * sizeof(long long), s);
  cudaMemsetAsync(i + 1, 0x7f, sizeof(long long), s);
  if (mode == 1) {
    route_kernel<true><<<528, 256, 0, s>>>(p, v, n, i, false);
  } else {
    route_kernel<false><<<528, 256, 0, s>>>(p, v, n, i, true);
  }
  return static_cast<int>(cudaGetLastError());
}

// The exact-sum case's integers of n float32 `volumes` in units of 2^u, to
// `units` (int64[n]). On `stream`; returns cudaGetLastError().
extern "C" int fmk_float_walk_units(const void* volumes, long long n, int u, void* units,
                                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  units_kernel<<<528, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(volumes), n, std::ldexp(1.0, -u), static_cast<long long*>(units));
  return static_cast<int>(cudaGetLastError());
}

// Kernel D's walk over n >= 1 trades by one route: 0 the warp step, 1 the
// block walk (mode as for the route pass; a dollar walk is one chunk, a
// volume walk of the warp step `chunks`). With `entered`, the walk starts
// from the running sum `entry` before trade 0 (the volume since the last
// close, or the dollar remainder) and checks trade 0; else trade 0's value
// starts it unchecked. Writes at most max_bars close indices (int64) to
// `out` and their number to `count` (int64[1]); `exit` (a double, or null)
// receives the sum after the last trade; `stats` (int64[NSTATS] or null)
// receives the warp step's counts (Stat). `scratch` holds
// fmk_float_walk_scratch_bytes (the warp step). Pointers to float32 and
// float64 data are 16-byte aligned. On `stream`; returns cudaGetLastError().
extern "C" int fmk_float_walk(int mode, int route, const void* prices, const void* volumes,
                              long long n, double thr, long long max_bars, long long chunks,
                              int entered, double entry, void* scratch, void* out,
                              void* count, void* exit, void* stats, void* stream) {
  if (n <= 0 || chunks < 1 || (mode != 0 && mode != 1) || (route != 0 && route != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const double*>(prices);
  const auto* v = static_cast<const float*>(volumes);
  auto* o = static_cast<long long*>(out);
  auto* c = static_cast<long long*>(count);
  auto* ex = static_cast<double*>(exit);
  const bool dollar = mode == 1;
  if (route == 1) {
    if (dollar) {
      walk_kernel<true><<<1, kThreads, 0, s>>>(p, v, n, thr, max_bars, entered, entry, o, c, ex);
    } else {
      walk_kernel<false><<<1, kThreads, 0, s>>>(p, v, n, thr, max_bars, entered, entry, o, c,
                                                ex);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const Layout l = layout(n, dollar ? 1 : chunks);
  auto* base = static_cast<unsigned char*>(scratch);
  cudaMemsetAsync(scratch, 0, l.total, s);
  Walk w{};
  w.p = p;
  w.v = v;
  w.n = n;
  w.per = l.per;
  w.chunks = l.chunks;
  w.max_bars = max_bars;
  w.thr = thr;
  w.entered = entered != 0;
  w.g0 = entry;
  w.exit = ex;
  w.e_lo = std::ilogb(thr) - kBinades + 1;
  w.lo_bound = std::ldexp(1.0, w.e_lo);
  w.s0 = std::ldexp(1.0, 52 - w.e_lo);
  for (int d = 0; d < kBinades; ++d) {
    const double cl = std::ceil(thr * std::ldexp(w.s0, -d));   // exact scaling
    w.lim[d] = cl >= 0x1p53 ? kTwo53 : static_cast<u64>(cl);
  }
  w.a = reinterpret_cast<unsigned*>(base + l.a);
  w.b = l.chunks > 1 ? reinterpret_cast<unsigned*>(base + l.b) : nullptr;
  w.f = l.chunks > 1 ? reinterpret_cast<unsigned*>(base + l.f) : nullptr;
  w.rec = reinterpret_cast<Rec*>(base + l.rec);
  w.gcnt = reinterpret_cast<long long*>(base + l.gcnt);
  w.stats = static_cast<long long*>(stats);
  w.out = o;
  w.count = c;
  if (dollar) {
    launch<true>(w, l, s);
  } else {
    launch<false>(w, l, s);
  }
  return static_cast<int>(cudaGetLastError());
}
