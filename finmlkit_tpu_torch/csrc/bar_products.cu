// Kernel B: per-bar products of the trade stream, as one trade-parallel pass
// over fixed tiles of trades with an exact carry of the in-bar sums.
//
// Replaces the TPU kernels of finmlkit_tpu/ops/fused_scan.py:
//   K1a bar_scan_rowtails_v4 (_rowtail_kernel_v4)
//   K1b bar_scan_rowtails    (_rowtail_kernel, v2)
// together with the plane preparation (bar/fused.py _prep_planes) and the
// boundary fixup (_boundary_state) around them. For bar k, whose trades are
// (ci[k], ci[k+1]], it writes what _fused_packed_v2_jit (bar/fused.py:395-463)
// returns for that bar:
//   out64 [6][n_bars]  vol_u, dollar_u, vol_buy_u, vol_sell_u, dol_buy_u,
//                      dol_sell_u                     (int64 sums)
//   out32 [10][n_bars] open_raw, high_t, low_t, close_t, ticks_buy,
//                      ticks_sell, cum_spread_t, max_spread_t, ct_min, ct_max
//   outf  [4][n_bars]  cv_min, cv_max, cd_min, cd_max (float32)
// An empty bar (ci[k+1] == ci[k]) gets zero sums and counts and the sentinel
// extrema; the finals mask it.
//
// The stream is cut into tiles of kTile trades, whatever the bars; a block
// takes a tile and no block or thread walks more than kTile trades in order.
// A *segment* is the part of one bar inside one tile. The passes
// (ops/fused_scan.py bar_scan_products_tiles models them on the CPU):
//   0. marks: the opens of the stream as a bitmap (bar_scan.cuh mark_open),
//      every bar's record set to the identity, and each tile's range of close
//      indices (a binary search a tile);
//   1. tiles: each block takes the next tile from an atomic ticket, loads
//      kItems consecutive trades a thread with 16-byte loads, and scans the
//      in-bar sums (cv, cd, ct; an open restarts them) over the tile. It
//      publishes the tile's total and, in warp 0, reads the tiles before it
//      back until one that a bar opens in or that has published its inclusive
//      prefix (a decoupled look-back, as kernel S's): the exact in-bar sums at
//      the tile's first trade. Only the threads before the tile's first open
//      wait for them; the others walk meanwhile. Each thread walks its trades
//      once more from its exact sums into records of 18 fields: 6 int64 and 3 int32 sums and 9 int32 extrema, all
//      taken by max (minima bit-inverted, the float extrema as order keys). A
//      bar that opens and closes in one thread is stored to its record; the
//      pieces of the others go to a slot a thread, and a warp a segment joins
//      them (each lane every 32nd slot, then a warp reduction). A segment that
//      opens and closes in the tile is stored; one that entered the tile open
//      or leaves it open is joined to its record by atomics (add, max);
//   2. bars: each bar's products from its record, open and close ticks at the
//      clamped positions.
// Every trade is read once from device memory. The float extrema are taken
// from the exact in-bar sums, never from int64 extrema rounded once:
// pair_f32 drops at -2^56 and an in-bar sum may wrap past 2^63. Trades
// outside (ci[0], ci[n_bars]] form segments of no bar and are dropped whole,
// so no trade needs a validity test.
//
// Bound: device memory for the stream (13 bytes a trade: int32 tick, int64
// units, int8 side) and 104 bytes a bar of output; the records (72 bytes a
// bar), the bitmap and the tiles' status words are small. On the H100 the
// tiles pass runs below that rate (PERF.md section 6): its loads alone stream at
// 2.7 TB/s, and the per-trade work of the two walks on 64-bit sums, at 3
// blocks an SM (80 registers), holds it.
//
// Bit-exactness with the TPU: see bar_scan.cuh, which kernel V shares.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bar_scan.cuh"

namespace {

using fmk::kF32Big;
using fmk::kFull;
using fmk::u64;

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 trades (ops/fused_scan.py _TILE)
constexpr int kWarps = kThreads / 32;
constexpr int kSums64 = 6;   // vol, dol, vb, db, cv, cd
constexpr int kWords32 = 12;  // sums tb, ct, sp; maxima hi, ~lo, spmax, ~ctmin,
                              // ctmax, cvmax, ~cvmin, cdmax, ~cdmin (keys)
constexpr int kFields = kSums64 + kWords32;
constexpr int kSums32 = 3;
constexpr int kSlots = kThreads + 1;  // a slot a thread and one past the last
constexpr int kWindow = 256;  // close indices of a tile kept in shared memory
constexpr int kBlocksPerSM = 3;  // of the tiles pass: at most 80 registers a thread

// In-bar running sums of a stretch (volume, dollar and tick imbalance) and
// whether a bar opens in it.
struct Run {
  u64 cv, cd;
  unsigned ct, o;
};

__device__ __forceinline__ Run run_id() { return {0ull, 0ull, 0u, 0u}; }

struct RunCombine {  // a before b: an open in b restarts the sums
  __device__ __forceinline__ Run operator()(const Run& a, const Run& b) const {
    return b.o ? b : Run{a.cv + b.cv, a.cd + b.cd, a.ct + b.ct, a.o};
  }
};

__device__ __forceinline__ Run shfl_up(const Run& v, int o) {
  return {__shfl_up_sync(kFull, v.cv, o), __shfl_up_sync(kFull, v.cd, o),
          __shfl_up_sync(kFull, v.ct, o), __shfl_up_sync(kFull, v.o, o)};
}

__device__ __forceinline__ Run shfl_down(const Run& v, int o) {
  return {__shfl_down_sync(kFull, v.cv, o), __shfl_down_sync(kFull, v.cd, o),
          __shfl_down_sync(kFull, v.ct, o), __shfl_down_sync(kFull, v.o, o)};
}

__device__ __forceinline__ Run shfl_from(const Run& v, int lane) {
  return {__shfl_sync(kFull, v.cv, lane), __shfl_sync(kFull, v.cd, lane),
          __shfl_sync(kFull, v.ct, lane), __shfl_sync(kFull, v.o, lane)};
}

// ---- the look-back over the tiles' in-bar sums ------------------------------

enum : unsigned { kInvalid = 0, kTotal = 1, kPrefix = 2 };
constexpr int kStatusWords = 6;  // cv lo, cv hi, cd lo, cd hi, ct, o

// Tile q's status: each 32-bit piece of its Run in one 64-bit word with the
// flag in the high half, written whole, so that a reader that sees one flag
// in every word sees the pieces written with it (kernel S's scheme).
__device__ __forceinline__ void publish(u64* status, long long q, unsigned flag, const Run& v) {
  volatile u64* w = status + q * kStatusWords;
  const unsigned p[kStatusWords] = {static_cast<unsigned>(v.cv),
                                    static_cast<unsigned>(v.cv >> 32),
                                    static_cast<unsigned>(v.cd),
                                    static_cast<unsigned>(v.cd >> 32), v.ct, v.o};
#pragma unroll
  for (int i = 0; i < kStatusWords; ++i) w[i] = (static_cast<u64>(flag) << 32) | p[i];
}

__device__ __forceinline__ unsigned peek(const u64* status, long long q, Run* v) {
  const volatile u64* w = status + q * kStatusWords;
  u64 x[kStatusWords];
#pragma unroll
  for (int i = 0; i < kStatusWords; ++i) x[i] = w[i];
  const unsigned flag = static_cast<unsigned>(x[0] >> 32);
#pragma unroll
  for (int i = 1; i < kStatusWords; ++i)
    if (static_cast<unsigned>(x[i] >> 32) != flag) return kInvalid;
  v->cv = (x[0] & 0xffffffffull) | (x[1] << 32);
  v->cd = (x[2] & 0xffffffffull) | (x[3] << 32);
  v->ct = static_cast<unsigned>(x[4]);
  v->o = static_cast<unsigned>(x[5]);
  return flag;
}

// One warp: the in-bar sums before tile k, read back 32 tiles a step (lane l
// the tile l before the step's first) until a tile that a bar opens in or that
// has published its inclusive prefix. Every lane returns them.
__device__ Run look_back(const u64* status, long long k) {
  const int lane = threadIdx.x & 31;
  const RunCombine comb;
  Run acc = run_id();
  for (long long q = k - 1 - lane;; q -= 32) {
    unsigned st;
    Run v;
    long long spins = 0;
    do {
      v = run_id();
      st = q >= 0 ? peek(status, q, &v) : kPrefix;
      // a tile before this one belongs to a block that took its ticket
      // earlier and is running; one that never publishes is a fault, which
      // ends the launch with an error rather than a hung card
      if (++spins > (1ll << 26)) __trap();
    } while (__any_sync(kFull, st == kInvalid));
    const unsigned done = __ballot_sync(kFull, st == kPrefix || v.o);
    if (done && lane > __ffs(done) - 1) v = run_id();  // past the nearest stop
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {  // higher lanes are earlier tiles
      const Run y = shfl_down(v, o);
      if (lane + o < 32) v = comb(y, v);
    }
    acc = comb(shfl_from(v, 0), acc);
    if (done) return acc;
  }
}

// The number of close indices at or below x, where ci[k] <= x below lo and
// ci[k] > x from hi; ci is sorted.
template <typename P>
__device__ __forceinline__ long long upper_bound(P ci, long long lo, long long hi, long long x) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (ci[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---- a bar's record ----------------------------------------------------------

// The running state of one segment in a thread: its sums and extrema, and the
// in-bar sums at its first trade (r0).
struct Piece {
  u64 vol, dol, vb, db;
  unsigned tb, sp;
  int hi, lo, spmax, ctmin, ctmax;
  float cvmin, cvmax, cdmin, cdmax;
  Run r0;
};

__device__ __forceinline__ Piece piece_at(const Run& r) {
  return {0ull, 0ull, 0ull, 0ull, 0u, 0u, INT_MIN, INT_MAX, INT_MIN, INT_MAX, INT_MIN,
          kF32Big, -kF32Big, kF32Big, -kF32Big, r};
}

// float32 -> int32 in the same order (finite values); its own inverse.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// The record's fields of a piece that has reached the in-bar sums r.
struct Words {
  u64 w64[kSums64];
  unsigned w32[kWords32];
};

__device__ __forceinline__ Words words(const Piece& p, const Run& r) {
  const bool traded = p.ctmax != INT_MIN;  // |ct| < 2^31 for n < 2^31 trades
  Words w;
  w.w64[0] = p.vol;
  w.w64[1] = p.dol;
  w.w64[2] = p.vb;
  w.w64[3] = p.db;
  w.w64[4] = r.cv - p.r0.cv;
  w.w64[5] = r.cd - p.r0.cd;
  const int m[kWords32 - kSums32] = {
      p.hi, ~p.lo, p.spmax, ~p.ctmin, p.ctmax,
      traded ? order_key(p.cvmax) : INT_MIN, traded ? ~order_key(p.cvmin) : INT_MIN,
      traded ? order_key(p.cdmax) : INT_MIN, traded ? ~order_key(p.cdmin) : INT_MIN};
  w.w32[0] = p.tb;
  w.w32[1] = r.ct - p.r0.ct;
  w.w32[2] = p.sp;
#pragma unroll
  for (int f = 0; f < kWords32 - kSums32; ++f) w.w32[kSums32 + f] = static_cast<unsigned>(m[f]);
  return w;
}

// The bars' records, field-major: r64[f * m + k], r32[f * m + k].
struct Records {
  u64* r64;
  unsigned* r32;
  long long m;
};

__device__ __forceinline__ void store(const Records& rec, long long k, const Words& w) {
#pragma unroll
  for (int f = 0; f < kSums64; ++f) rec.r64[f * rec.m + k] = w.w64[f];
#pragma unroll
  for (int f = 0; f < kWords32; ++f) rec.r32[f * rec.m + k] = w.w32[f];
}

// The joins of the slots' pieces in shared memory, field-major with a slot
// a thread: a lane's field over consecutive slots falls on its own bank.
struct Slots {
  u64 s64[kSums64][kSlots];
  unsigned s32[kWords32][kSlots];
};

__device__ __forceinline__ void put(Slots& s, int t, const Words& w) {
#pragma unroll
  for (int f = 0; f < kSums64; ++f) s.s64[f][t] = w.w64[f];
#pragma unroll
  for (int f = 0; f < kWords32; ++f) s.s32[f][t] = w.w32[f];
}

__device__ __forceinline__ void join(Slots& s, int t, const Words& w) {
#pragma unroll
  for (int f = 0; f < kSums64; ++f) s.s64[f][t] += w.w64[f];
#pragma unroll
  for (int f = 0; f < kSums32; ++f) s.s32[f][t] += w.w32[f];
#pragma unroll
  for (int f = kSums32; f < kWords32; ++f)
    s.s32[f][t] = static_cast<unsigned>(max(static_cast<int>(s.s32[f][t]),
                                            static_cast<int>(w.w32[f])));
}

__device__ __forceinline__ unsigned field_id(int f) {  // f indexes s32
  return f < kSums32 ? 0u : static_cast<unsigned>(INT_MIN);
}

// ---- pass 0: marks and identities --------------------------------------------

// Also, for t = 0 .. tiles, the close indices at or below t * kTile - 1 (so
// that ci[tile_lo[t] - 1] closes the bar holding the tile's first trade).
__global__ void products_marks(const long long* __restrict__ ci, long long n, long long n_bars,
                               long long tiles, unsigned* __restrict__ bits,
                               long long* __restrict__ tile_lo, Records rec) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k <= tiles) tile_lo[k] = upper_bound(ci, 0, n_bars + 1, k * kTile - 1);
  if (k > n_bars) return;
  fmk::mark_open(ci, n, k, bits);
  if (k == n_bars) return;
#pragma unroll
  for (int f = 0; f < kSums64; ++f) rec.r64[f * rec.m + k] = 0ull;
#pragma unroll
  for (int f = 0; f < kWords32; ++f) rec.r32[f * rec.m + k] = field_id(f);
}

// ---- pass 1: the tiles ---------------------------------------------------------

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
products_tiles(const int* __restrict__ ticks, const long long* __restrict__ units,
               const signed char* __restrict__ sides, const long long* __restrict__ ci,
               const unsigned* __restrict__ bits, const long long* __restrict__ tile_lo,
               long long n, long long n_bars, u64* __restrict__ ticket,
               u64* __restrict__ status, Records rec) {
  __shared__ Slots slots;
  __shared__ Run warp_run[kWarps];
  __shared__ long long s_tile;
  __shared__ long long s_ci[kWindow];
  __shared__ Run s_entry;
  __shared__ volatile int s_ready;
  __shared__ bool s_opens_first;
  __shared__ int s_owners, s_warp_owners[kWarps];
  __shared__ short s_owner[kThreads];
  __shared__ long long s_tail_bar[kThreads];
  if (threadIdx.x == 0) {
    s_tile = static_cast<long long>(atomicAdd(ticket, 1ull));
    s_ready = 0;
  }
  __syncthreads();
  const long long tile = s_tile;
  const long long t0 = tile * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i0 = t0 + static_cast<long long>(threadIdx.x) * kItems;

  // the close indices of the bars that open in the tile are lo .. hi - 1;
  // this thread's opens sit in two words of the bitmap (i0 is a multiple of
  // kItems)
  const long long lo = tile_lo[tile], hi = tile_lo[tile + 1];
  const long long word = i0 >> 5;
  const unsigned b0 = i0 < n ? bits[word] : 0u, b1 = i0 < n ? bits[word + 1] : 0u;

  // this thread's trades: 16-byte loads where the tile is whole and aligned
  int tk[kItems];
  u64 un[kItems];
  unsigned sw[kItems / 4];  // the sides, four bytes a word
  auto side_of = [&sw](int j) {
    return static_cast<int>(static_cast<signed char>((sw[j >> 2] >> (8 * (j & 3))) & 0xffu));
  };
  const bool vec = t0 + kTile <= n &&
      ((reinterpret_cast<uintptr_t>(ticks) | reinterpret_cast<uintptr_t>(units)) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(sides) & 3) == 0;
  if (vec) {
    static_assert(kItems % 4 == 0, "a thread's trades are whole 16-byte loads of ticks");
    const int4* tp = reinterpret_cast<const int4*>(ticks + i0);
    const longlong2* up = reinterpret_cast<const longlong2*>(units + i0);
    const unsigned* sp = reinterpret_cast<const unsigned*>(sides + i0);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 t4 = tp[q];
      tk[4 * q] = t4.x;
      tk[4 * q + 1] = t4.y;
      tk[4 * q + 2] = t4.z;
      tk[4 * q + 3] = t4.w;
    }
#pragma unroll
    for (int q = 0; q < kItems / 2; ++q) {
      const longlong2 u2 = up[q];
      un[2 * q] = static_cast<u64>(u2.x);
      un[2 * q + 1] = static_cast<u64>(u2.y);
    }
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) sw[q] = sp[q];
  } else {
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) sw[q] = 0u;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in = i0 + j < n;
      tk[j] = in ? ticks[i0 + j] : 0;
      un[j] = in ? static_cast<u64>(units[i0 + j]) : 0ull;
      sw[j >> 2] |= (in ? static_cast<unsigned char>(sides[i0 + j]) : 0u) << (8 * (j & 3));
    }
  }
  // the trade before this thread's first: the previous lane's last, or (lane
  // 0) trade i0 - 1, trade n - 1 before trade 0
  int ptick = __shfl_up_sync(kFull, tk[kItems - 1], 1);
  int pside = __shfl_up_sync(kFull, side_of(kItems - 1), 1);
  if (lane == 0 && i0 < n) {
    const long long ip = i0 == 0 ? n - 1 : i0 - 1;
    ptick = ticks[ip];
    pside = sides[ip];
  }
  // bit j: trade i0 + j opens a bar; next bit j: trade i0 + j + 1 does or is
  // past the stream (its bar holds one trade if both)
  unsigned open = 0u, next_open = 0u;
  if (i0 < n) {
    const u64 mw = b0 | (static_cast<u64>(b1) << 32);
    const int off = static_cast<int>(i0 & 31);
    open = static_cast<unsigned>(mw >> off) & ((1u << kItems) - 1);
    next_open = static_cast<unsigned>(mw >> (off + 1)) & ((1u << kItems) - 1);
    if (n - i0 <= kItems) next_open |= 1u << (n - i0 - 1);
  }

  // walk 1: this thread's in-bar sums; then the tile's, exclusive a thread
  Run agg = run_id();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if ((open >> j) & 1u) agg = {0ull, 0ull, 0u, 1u};
    const u64 u = un[j], d = static_cast<u64>(static_cast<long long>(tk[j])) * u;
    const bool b = side_of(j) == 1, s = side_of(j) == -1;
    agg.cv += b ? u : (s ? 0ull - u : 0ull);
    agg.cd += b ? d : (s ? 0ull - d : 0ull);
    agg.ct += static_cast<unsigned>(b) - static_cast<unsigned>(s);
  }
  // those close indices in shared memory when they are few
  const bool window = hi - lo <= kWindow;
  if (window)
    for (long long q = lo + threadIdx.x; q < hi; q += kThreads) s_ci[q - lo] = ci[q];
  Run tile_total;
  const Run excl = fmk::block_exclusive_scan<kWarps>(agg, run_id(), RunCombine(), warp_run,
                                                     &tile_total);

  // the owners: the threads a bar opens in, in order
  const bool owner = open != 0u;
  const unsigned ob = __ballot_sync(kFull, owner);
  if (lane == 0) s_warp_owners[warp] = __popc(ob);
  __syncthreads();  // ... and warp_run is free
  int rank = __popc(ob & ((1u << lane) - 1));
  for (int v = 0; v < warp; ++v) rank += s_warp_owners[v];
  if (owner) s_owner[rank] = static_cast<short>(threadIdx.x);
  if (threadIdx.x == kThreads - 1) s_owners = rank + owner;

  if (warp == 0) {
    // the tile's total (its inclusive prefix if a bar opens in it), and the
    // in-bar sums before it
    if (lane == 0) publish(status, tile, tile_total.o ? kPrefix : kTotal, tile_total);
    const bool opens_first = __shfl_sync(kFull, open & 1u, 0);
    const Run before = tile > 0 && !opens_first ? look_back(status, tile) : run_id();
    if (lane == 0) {
      if (!tile_total.o) publish(status, tile, kPrefix, RunCombine()(before, tile_total));
      s_entry = before;
      s_opens_first = opens_first;
      __threadfence_block();
      s_ready = 1;
    }
    __syncwarp();
  }
  // only the threads before the tile's first open need the sums before it;
  // the others walk meanwhile
  Run r = excl;
  if (!excl.o && !(open & 1u)) {
    while (!s_ready) __nanosleep(32);
    __threadfence_block();
    r = RunCombine()(s_entry, excl);
  }

  // walk 2: this thread's trades from their exact in-bar sums. The piece
  // before its first open goes to its slot; a bar that opens and closes here
  // to its record; the piece from its last open stays for the joins.
  Piece p = piece_at(r);
  long long bar = -1;
  bool seen = false;
  const Records rc = rec;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (i0 + j >= n) break;
    if ((open >> j) & 1u) {
      const Words w = words(p, r);
      if (!seen) {
        put(slots, threadIdx.x, w);
      } else if (bar >= 0 && bar < n_bars) {
        store(rc, bar, w);
      }
      seen = true;
      const long long x = i0 + j - 1;
      bar = (window ? lo + upper_bound(s_ci, 0, hi - lo, x) : upper_bound(ci, lo, hi, x)) - 1;
      r = run_id();
      p = piece_at(r);
    }
    const int tick = tk[j], side = side_of(j);
    const u64 u = un[j], d = static_cast<u64>(static_cast<long long>(tick)) * u;
    const bool b = side == 1, s = side == -1;
    p.vol += u;
    p.dol += d;
    p.vb += b ? u : 0ull;
    p.db += b ? d : 0ull;
    p.tb += b;
    r.cv += b ? u : (s ? 0ull - u : 0ull);
    r.cd += b ? d : (s ? 0ull - d : 0ull);
    r.ct += static_cast<unsigned>(b) - static_cast<unsigned>(s);
    const int pt = j ? tk[j - 1] : ptick, ps = j ? side_of(j - 1) : pside;
    const bool single = (open >> j) & (next_open >> j) & 1u;
    const bool change = single ? side != 0 : side != ps;
    const unsigned diff = static_cast<unsigned>(tick) - static_cast<unsigned>(pt);
    const unsigned mag = static_cast<int>(diff) < 0 ? 0u - diff : diff;  // wraps
    const int spread = change ? static_cast<int>(mag) : 0;
    p.sp += static_cast<unsigned>(spread);
    p.spmax = max(p.spmax, spread);
    p.hi = max(p.hi, tick);
    p.lo = min(p.lo, tick);
    if (side != 0) {
      p.ctmin = min(p.ctmin, static_cast<int>(r.ct));
      p.ctmax = max(p.ctmax, static_cast<int>(r.ct));
      const float fv = fmk::pair_f32(r.cv), fd = fmk::pair_f32(r.cd);
      p.cvmin = fminf(p.cvmin, fv);
      p.cvmax = fmaxf(p.cvmax, fv);
      p.cdmin = fminf(p.cdmin, fd);
      p.cdmax = fmaxf(p.cdmax, fd);
    }
  }
  const Words tail = words(p, r);
  if (!seen) put(slots, threadIdx.x, tail);  // the whole thread's piece
  if (threadIdx.x == 0) {
#pragma unroll
    for (int f = 0; f < kSums64; ++f) slots.s64[f][kThreads] = 0ull;
#pragma unroll
    for (int f = 0; f < kWords32; ++f) slots.s32[f][kThreads] = field_id(f);
  }
  __syncthreads();
  // an owner's last piece joins the slot after it: segment j is the slots
  // s_owner[j] + 1 .. s_owner[j + 1], and the segment entering the tile the
  // slots 0 .. s_owner[0]
  if (seen) {
    join(slots, threadIdx.x + 1, tail);
    s_tail_bar[rank] = bar;
  }
  __syncthreads();

  // the segments that cross threads, a warp a segment: each lane folds every
  // 32nd slot, a warp reduction joins the lanes, and lane f writes field f.
  // One that opens and closes in the tile is stored; the segment entering
  // the tile and one that leaves it open are joined by atomics.
  const int owners = s_owners;
  const bool closes = t0 + kTile >= n ||
      ((bits[(t0 + kTile) >> 5] >> ((t0 + kTile) & 31)) & 1u);
  for (int j = warp - 1; j < owners; j += kWarps) {  // j = -1: entering the tile
    const long long k = j < 0 ? lo - 1 : s_tail_bar[j];
    if (k < 0 || k >= n_bars || (j < 0 && s_opens_first)) continue;  // no bar, or empty
    const int a = j < 0 ? 0 : s_owner[j] + 1;
    const int e = j + 1 < owners ? s_owner[j + 1] : kThreads;
    const bool whole = j >= 0 && (j + 1 < owners || closes);
    Words x;
#pragma unroll
    for (int f = 0; f < kSums64; ++f) x.w64[f] = 0ull;
#pragma unroll
    for (int f = 0; f < kWords32; ++f) x.w32[f] = field_id(f);
    for (int t = a + lane; t <= e; t += 32) {
#pragma unroll
      for (int f = 0; f < kSums64; ++f) x.w64[f] += slots.s64[f][t];
#pragma unroll
      for (int f = 0; f < kSums32; ++f) x.w32[f] += slots.s32[f][t];
#pragma unroll
      for (int f = kSums32; f < kWords32; ++f)
        x.w32[f] = static_cast<unsigned>(max(static_cast<int>(x.w32[f]),
                                             static_cast<int>(slots.s32[f][t])));
    }
    u64 v64 = 0ull;
    unsigned v32 = 0u;
#pragma unroll
    for (int f = 0; f < kSums64; ++f) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x.w64[f] += __shfl_xor_sync(kFull, x.w64[f], o);
      if (lane == f) v64 = x.w64[f];
    }
#pragma unroll
    for (int f = 0; f < kWords32; ++f) {
      const unsigned y = f < kSums32
          ? __reduce_add_sync(kFull, x.w32[f])
          : static_cast<unsigned>(__reduce_max_sync(kFull, static_cast<int>(x.w32[f])));
      if (lane == kSums64 + f) v32 = y;
    }
    if (lane < kSums64) {
      u64* dst = rc.r64 + lane * rc.m + k;
      if (whole) *dst = v64; else atomicAdd(dst, v64);
    } else if (lane < kFields) {
      const int f = lane - kSums64;
      unsigned* dst = rc.r32 + f * rc.m + k;
      if (whole) *dst = v32;
      else if (f < kSums32) atomicAdd(dst, v32);
      else atomicMax(reinterpret_cast<int*>(dst), static_cast<int>(v32));
    }
  }
}

// ---- pass 2: the bars ------------------------------------------------------------

// A float extremum from its word: INT_MIN for none, else the order key, bit
// inverted for a minimum.
__device__ __forceinline__ float key_float(unsigned w, bool minimum) {
  const int x = static_cast<int>(w);
  if (x == INT_MIN) return minimum ? kF32Big : -kF32Big;
  return __int_as_float(order_key(__int_as_float(minimum ? ~x : x)));
}

__global__ void products_bars(const int* __restrict__ ticks, const long long* __restrict__ ci,
                              long long n, long long n_bars, Records rec,
                              long long* __restrict__ out64, int* __restrict__ out32,
                              float* __restrict__ outf) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n_bars) return;
  const long long m = n_bars;
  u64 s[kSums64];
  unsigned w[kWords32];
#pragma unroll
  for (int f = 0; f < kSums64; ++f) s[f] = rec.r64[f * m + k];
#pragma unroll
  for (int f = 0; f < kWords32; ++f) w[f] = rec.r32[f * m + k];
  const long long a = ci[k] + 1, e = ci[k + 1];
  const long long first = a < n ? (a > 0 ? a : 0) : n - 1;
  const long long last = e < n ? (e > 0 ? e : 0) : n - 1;
  out64[0 * m + k] = static_cast<long long>(s[0]);
  out64[1 * m + k] = static_cast<long long>(s[1]);
  out64[2 * m + k] = static_cast<long long>(s[2]);
  out64[3 * m + k] = static_cast<long long>(s[2] - s[4]);  // sells: buys - imbalance
  out64[4 * m + k] = static_cast<long long>(s[3]);
  out64[5 * m + k] = static_cast<long long>(s[3] - s[5]);
  out32[0 * m + k] = ticks[first];
  out32[1 * m + k] = static_cast<int>(w[3]);
  out32[2 * m + k] = ~static_cast<int>(w[4]);
  out32[3 * m + k] = ticks[last];
  out32[4 * m + k] = static_cast<int>(w[0]);
  out32[5 * m + k] = static_cast<int>(w[0] - w[1]);
  out32[6 * m + k] = static_cast<int>(w[2]);
  out32[7 * m + k] = static_cast<int>(w[5]);
  out32[8 * m + k] = ~static_cast<int>(w[6]);
  out32[9 * m + k] = static_cast<int>(w[7]);
  outf[0 * m + k] = key_float(w[9], true);
  outf[1 * m + k] = key_float(w[8], false);
  outf[2 * m + k] = key_float(w[11], true);
  outf[3 * m + k] = key_float(w[10], false);
}

long long align_up(long long b) { return (b + 255) / 256 * 256; }

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

long long mark_words(long long n) { return n / 32 + 2; }

// The scratch of fmk_bar_products: the opens' bitmap; the ticket and the
// tiles' status words; the bars' records.
struct Scratch {
  unsigned* bits;
  u64* ticket;  // the status words follow it
  long long* tile_lo;
  Records rec;
  long long bits_bytes, lookback_bytes, bytes;
};

Scratch carve(void* base, long long n, long long n_bars) {
  char* p = static_cast<char*>(base);
  long long off = 0;
  auto take = [&](long long bytes) {
    char* q = p ? p + off : nullptr;
    off += align_up(bytes);
    return q;
  };
  Scratch s;
  s.bits_bytes = 4 * mark_words(n);
  s.lookback_bytes = 8 * (1 + kStatusWords * tiles_of(n));
  s.bits = reinterpret_cast<unsigned*>(take(s.bits_bytes));
  s.ticket = reinterpret_cast<u64*>(take(s.lookback_bytes));
  s.tile_lo = reinterpret_cast<long long*>(take(8 * (tiles_of(n) + 1)));
  s.rec.r64 = reinterpret_cast<u64*>(take(8 * kSums64 * n_bars));
  s.rec.r32 = reinterpret_cast<unsigned*>(take(4 * kWords32 * n_bars));
  s.rec.m = n_bars;
  s.bytes = off;
  return s;
}

}  // namespace

// Bytes of scratch fmk_bar_products needs for n trades and n_bars bars.
extern "C" long long fmk_products_scratch_bytes(long long n, long long n_bars) {
  return carve(nullptr, n, n_bars).bytes;
}

// ticks int32[n], units int64[n], sides int8[n], ci int64[n_bars + 1] sorted
// with -1 <= ci[0] and ci[n_bars] < n < 2^31 - kTile; out64 int64[6][n_bars],
// out32 int32[10][n_bars], outf float32[4][n_bars]; scratch of
// fmk_products_scratch_bytes(n, n_bars) bytes. `passes` is a bit mask of the
// passes to run (bit p: pass p; 7 runs all three). Returns cudaGetLastError().
extern "C" int fmk_bar_products(const void* ticks, const void* units,
                                const void* sides, const void* ci, long long n,
                                long long n_bars, void* out64, void* out32,
                                void* outf, void* scratch, int passes, void* stream) {
  if (n_bars <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = carve(scratch, n, n_bars);
  const long long* c = static_cast<const long long*>(ci);
  const long long tiles = tiles_of(n);
  const unsigned bar_blocks = static_cast<unsigned>((n_bars + 1 + 255) / 256);
  if (passes & 1) {
    cudaMemsetAsync(s.bits, 0, s.bits_bytes, st);
    const long long m = n_bars > tiles ? n_bars : tiles;
    products_marks<<<static_cast<unsigned>((m + 1 + 255) / 256), 256, 0, st>>>(
        c, n, n_bars, tiles, s.bits, s.tile_lo, s.rec);
  }
  if (passes & 2) {
    cudaMemsetAsync(s.ticket, 0, s.lookback_bytes, st);  // every status kInvalid
    products_tiles<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        static_cast<const int*>(ticks), static_cast<const long long*>(units),
        static_cast<const signed char*>(sides), c, s.bits, s.tile_lo, n, n_bars, s.ticket,
        s.ticket + 1, s.rec);
  }
  if (passes & 4)
    products_bars<<<bar_blocks, 256, 0, st>>>(
        static_cast<const int*>(ticks), c, n, n_bars, s.rec,
        static_cast<long long*>(out64), static_cast<int*>(out32), static_cast<float*>(outf));
  return static_cast<int>(cudaGetLastError());
}
