// Kernel V: the full planes of the bar scan, the running state of every
// trade, as one trade-parallel segmented scan over fixed tiles of trades.
//
// Replaces the TPU kernel of finmlkit_tpu/ops/fused_scan.py:
//   K1c bar_scan_planes (_bar_scan_kernel, v1): the running scan state of
//       every trade as 24 full (rows, 128) planes.
// It reads the trades as the caller holds them (int32 ticks, int64 units,
// int8 sides, int64 close indices) and writes every row once:
//   pre64 [6][n]  prefix sums of buy units, sell units, buy dollars, sell
//                 dollars, units and dollars (wrapping int64)
//   pre32 [3][n]  prefix sums of buy ticks, sell ticks, spread (wrapping)
//   ext32 [5][n]  high, low, spmax, ctmin, ctmax (int32)
//   extf  [4][n]  cvmin, cvmax, cdmin, cdmax     (float32)
// The extrema restart at every bar's first trade (an "open", at each
// ci[k] + 1 < n); ct, cv and cd are the in-bar running tick, volume and
// dollar imbalances, cv and cd rounded to float32 as the TPU's pairs were,
// counted on the trades with side != 0 only. Outside every bar the inputs
// count 0 and the extrema keep their sentinels (INT_MIN, INT_MAX, -1,
// INT_MAX, INT_MIN, +-3e38).
//
// The TPU carried the state from grid step to grid step. Here the stream is
// cut into tiles of kTile trades, whatever the bars, and passes join them
// (ops/fused_scan.py bar_scan_planes_tiles models passes 1 to 5 on the CPU):
//   0. marks: the opens of the stream as a bitmap, one bit a trade;
//   1. reduce: each tile's summary (struct Sum): its 9 sums, whether a bar
//      opens in it, and its last segment's in-bar sums and integer extrema;
//      where a bar opens in the tile, also the float extrema of its last
//      segment, whose in-bar sums start at 0;
//   2. scan: the summaries under the segmented operator (sums add; an open on
//      the right restarts the in-bar state), in groups of kGroup tiles and
//      then the groups: every tile's entry state, exact;
//   3. float reduce: the float extrema of the last segment of each tile where
//      no bar opens, from its exact entry sums. pair_f32 drops at -2^56 and an
//      in-bar sum may wrap, so int64 extrema rounded once would not be exact;
//   4. float scan: every tile's entry float extrema;
//   5. write: each tile again from its entry state.
// A tile pass loads its trades into shared memory with coalesced reads; a
// thread then takes kItems consecutive trades and block scans join the
// threads, so a bar over many tiles and a tile of many bars cost the same.
// Pass 5 writes the 18 rows two at a time, each pair from a walk of the
// thread's trades in shared memory, and stages each row through a warp's
// shared buffer, so that every store of a warp covers consecutive addresses.
//
// Bound: device memory at the data sheet's rate: the planes (96 bytes a
// trade) written once, the trades (13 bytes) read by passes 1 and 5 and, for
// the tiles no bar opens in, by pass 3; the bitmap and the summaries are
// small. On the H100 passes 1 and 5 run below that rate: the per-trade work on
// the 26-word scan state (64-bit sums, block scans) holds them.
#include <climits>
#include <cuda_runtime.h>

#include "bar_scan.cuh"

namespace {

using fmk::kF32Big;
using fmk::kFull;
using fmk::u64;

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // 1024 trades
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 256;  // tiles a block of the scan passes
constexpr int kWarpTrades = 32 * kItems;

// Word w of a warp's staging buffer in pass 5, with 4 pad words per 32.
__host__ __device__ constexpr int stage_word(int w) { return w + (w / 32) * 4; }
constexpr int kStage = stage_word(2 * kWarpTrades);  // a warp's words (8-byte rows)

// Integer running extrema of a stretch: high, low, max spread, and the min
// and max of the tick imbalance, relative to the stretch's entry.
struct Ext {
  int hi, lo, sp, ctmin, ctmax;
};

__host__ __device__ __forceinline__ Ext ext_id() {
  return {INT_MIN, INT_MAX, INT_MIN, INT_MAX, INT_MIN};
}

// A stretch of trades: its 9 sums (s64: buy units, sell units, buy dollars,
// sell dollars, units, dollars; s32: buy ticks, sell ticks, spread), whether
// a bar opens in it (o), and its last segment's in-bar sums (ct, cv, cd) and
// extrema (e).
struct Sum {
  u64 s64[6];
  u64 cv, cd;
  unsigned s32[3];
  unsigned ct;
  unsigned o;
  Ext e;
};

__host__ __device__ __forceinline__ Sum sum_id() {
  Sum x;
#pragma unroll
  for (int k = 0; k < 6; ++k) x.s64[k] = 0ull;
  x.cv = x.cd = 0ull;
  x.s32[0] = x.s32[1] = x.s32[2] = 0u;
  x.ct = 0u;
  x.o = 0u;
  x.e = ext_id();
  return x;
}

// A sentinel stays; a count moves by the tick imbalance before it.
__device__ __forceinline__ int shift(int x, unsigned c, int sentinel) {
  return x == sentinel ? x : static_cast<int>(static_cast<unsigned>(x) + c);
}

struct SumCombine {  // a before b
  __device__ __forceinline__ Sum operator()(const Sum& a, const Sum& b) const {
    Sum x;
#pragma unroll
    for (int k = 0; k < 6; ++k) x.s64[k] = a.s64[k] + b.s64[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) x.s32[k] = a.s32[k] + b.s32[k];
    x.o = a.o | b.o;
    if (b.o) {
      x.ct = b.ct;
      x.cv = b.cv;
      x.cd = b.cd;
      x.e = b.e;
    } else {
      x.ct = a.ct + b.ct;
      x.cv = a.cv + b.cv;
      x.cd = a.cd + b.cd;
      x.e.hi = max(a.e.hi, b.e.hi);
      x.e.lo = min(a.e.lo, b.e.lo);
      x.e.sp = max(a.e.sp, b.e.sp);
      x.e.ctmin = min(a.e.ctmin, shift(b.e.ctmin, a.ct, INT_MAX));
      x.e.ctmax = max(a.e.ctmax, shift(b.e.ctmax, a.ct, INT_MIN));
    }
    return x;
  }
};

__device__ __forceinline__ Sum shfl_up(const Sum& v, int o) {
  Sum x;
#pragma unroll
  for (int k = 0; k < 6; ++k) x.s64[k] = __shfl_up_sync(kFull, v.s64[k], o);
  x.cv = __shfl_up_sync(kFull, v.cv, o);
  x.cd = __shfl_up_sync(kFull, v.cd, o);
#pragma unroll
  for (int k = 0; k < 3; ++k) x.s32[k] = __shfl_up_sync(kFull, v.s32[k], o);
  x.ct = __shfl_up_sync(kFull, v.ct, o);
  x.o = __shfl_up_sync(kFull, v.o, o);
  x.e.hi = __shfl_up_sync(kFull, v.e.hi, o);
  x.e.lo = __shfl_up_sync(kFull, v.e.lo, o);
  x.e.sp = __shfl_up_sync(kFull, v.e.sp, o);
  x.e.ctmin = __shfl_up_sync(kFull, v.e.ctmin, o);
  x.e.ctmax = __shfl_up_sync(kFull, v.e.ctmax, o);
  return x;
}

// The float extrema of a stretch's last segment, and whether a bar opens in
// the stretch.
struct FSum {
  float cvmin, cvmax, cdmin, cdmax;
  unsigned o;
};

__host__ __device__ __forceinline__ FSum fsum_id() {
  return {kF32Big, -kF32Big, kF32Big, -kF32Big, 0u};
}

struct FSumCombine {
  __device__ __forceinline__ FSum operator()(const FSum& a, const FSum& b) const {
    if (b.o) return {b.cvmin, b.cvmax, b.cdmin, b.cdmax, 1u};
    return {fminf(a.cvmin, b.cvmin), fmaxf(a.cvmax, b.cvmax),
            fminf(a.cdmin, b.cdmin), fmaxf(a.cdmax, b.cdmax), a.o};
  }
};

__device__ __forceinline__ FSum shfl_up(const FSum& v, int o) {
  return {__shfl_up_sync(kFull, v.cvmin, o), __shfl_up_sync(kFull, v.cvmax, o),
          __shfl_up_sync(kFull, v.cdmin, o), __shfl_up_sync(kFull, v.cdmax, o),
          __shfl_up_sync(kFull, v.o, o)};
}

// One trade as the passes need it.
constexpr unsigned kValid = 1u, kOpen = 2u;
struct Item {
  u64 units;  // 0 outside every bar
  int tick;
  int spread;  // 0 outside every bar
  signed char side;
  unsigned char flags;
};

__device__ __forceinline__ bool buy(const Item& t) { return (t.flags & kValid) && t.side == 1; }
__device__ __forceinline__ bool sell(const Item& t) { return (t.flags & kValid) && t.side == -1; }
__device__ __forceinline__ bool traded(const Item& t) { return (t.flags & kValid) && t.side != 0; }
__device__ __forceinline__ u64 dollars(const Item& t) {
  return static_cast<u64>(static_cast<long long>(t.tick)) * t.units;
}

// Padded shared-memory index: one pad word per kItems, so that a warp's
// blocked reads (stride kItems + 1) fall on distinct banks.
__device__ __forceinline__ int padi(int p) { return p + p / kItems; }

// A tile's trades in shared memory, loaded with coalesced reads: the units of
// tile trade p (0 outside every bar) at padi(p), its tick at padi(p + 1) and
// its side at p + 1; slot 0 holds the trade before the tile (trade n-1 before
// trade 0).
struct Tile {
  u64 units[kTile + kTile / kItems];
  int tick[kTile + 1 + kTile / kItems + 1];
  signed char side[kTile + 4];
};

// Thread-local view of its kItems trades t0 + p0 + j in a loaded tile.
struct View {
  const Tile* s;
  long long i0, n;
  int p0;
  unsigned valid, open, next_open;  // bit j for trade j
};

// Loads tile t0 into `s` and returns this thread's view of it; every thread
// of the block must call it. `bits` marks the opens of the whole stream.
__device__ View load_tile(const int* __restrict__ ticks,
                          const long long* __restrict__ units,
                          const signed char* __restrict__ sides,
                          const long long* __restrict__ ci,
                          const unsigned* __restrict__ bits, long long n,
                          long long n_bars, long long t0, Tile& s) {
  const long long first_in = ci[0], last_in = ci[n_bars];
  for (int q = threadIdx.x; q < kTile; q += kThreads) {
    const long long i = t0 + q;
    int tk = 0;
    signed char sd = 0;
    u64 u = 0ull;
    if (i < n) {
      tk = ticks[i];
      sd = sides[i];
      if (i > first_in && i <= last_in) u = static_cast<u64>(units[i]);
    }
    s.tick[padi(q + 1)] = tk;
    s.side[q + 1] = sd;
    s.units[padi(q)] = u;
  }
  if (threadIdx.x == 0) {
    const long long ip = t0 == 0 ? n - 1 : t0 - 1;
    s.tick[0] = ticks[ip];
    s.side[0] = sides[ip];
  }
  View v;
  v.s = &s;
  v.n = n;
  v.p0 = threadIdx.x * kItems;
  v.i0 = t0 + v.p0;
  // t0 is a multiple of 32: this thread's bits and the next one sit in two
  // words of the stream's bitmap
  const long long w = v.i0 >> 5;
  const u64 mw = v.i0 < n ? bits[w] | (static_cast<u64>(bits[w + 1]) << 32) : 0ull;
  const int off = static_cast<int>(v.i0 & 31);
  v.open = static_cast<unsigned>(mw >> off) & ((1u << kItems) - 1);
  v.next_open = static_cast<unsigned>(mw >> (off + 1)) & ((1u << kItems) - 1);
  v.valid = 0u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = v.i0 + j;
    if (i + 1 == n) v.next_open |= 1u << j;
    if (i < n && i > first_in && i <= last_in) v.valid |= 1u << j;
  }
  __syncthreads();
  return v;
}

// Trade j of the view.
__device__ __forceinline__ Item get(const View& v, int j) {
  Item t = {0ull, 0, 0, 0, 0};
  if (v.i0 + j >= v.n) return t;
  const int p = v.p0 + j;
  t.tick = v.s->tick[padi(p + 1)];
  t.side = v.s->side[p + 1];
  t.units = v.s->units[padi(p)];
  const bool valid = (v.valid >> j) & 1u, open = (v.open >> j) & 1u;
  t.flags = (valid ? kValid : 0u) | (open ? kOpen : 0u);
  if (valid) {
    // a single-trade bar compares its side with 0, others with the previous
    // trade's
    const bool single = open && ((v.next_open >> j) & 1u);
    const bool change = single ? t.side != 0 : t.side != v.s->side[p];
    const unsigned diff = static_cast<unsigned>(t.tick) -
                          static_cast<unsigned>(v.s->tick[padi(p)]);
    const unsigned mag = static_cast<int>(diff) < 0 ? 0u - diff : diff;
    t.spread = change ? static_cast<int>(mag) : 0;
  }
  return t;
}

// Sum of the stretch x followed by trade t.
__device__ __forceinline__ void step(Sum& x, const Item& t) {
  const bool b = buy(t), s = sell(t), v = t.flags & kValid;
  const u64 d = dollars(t);
  x.s64[0] += b ? t.units : 0ull;
  x.s64[1] += s ? t.units : 0ull;
  x.s64[2] += b ? d : 0ull;
  x.s64[3] += s ? d : 0ull;
  x.s64[4] += t.units;
  x.s64[5] += d;
  x.s32[0] += b;
  x.s32[1] += s;
  x.s32[2] += static_cast<unsigned>(t.spread);
  if (t.flags & kOpen) {
    x.o = 1u;
    x.ct = 0u;
    x.cv = x.cd = 0ull;
    x.e = ext_id();
  }
  x.ct += static_cast<unsigned>(b) - static_cast<unsigned>(s);
  x.cv += b ? t.units : (s ? 0ull - t.units : 0ull);
  x.cd += b ? d : (s ? 0ull - d : 0ull);
  x.e.hi = max(x.e.hi, v ? t.tick : INT_MIN);
  x.e.lo = min(x.e.lo, v ? t.tick : INT_MAX);
  x.e.sp = max(x.e.sp, v ? t.spread : -1);
  if (traded(t)) {
    x.e.ctmin = min(x.e.ctmin, static_cast<int>(x.ct));
    x.e.ctmax = max(x.e.ctmax, static_cast<int>(x.ct));
  }
}

// In-bar volume and dollar imbalances after trade t, from (cv, cd) before it.
__device__ __forceinline__ void step_run(u64& cv, u64& cd, const Item& t) {
  if (t.flags & kOpen) cv = cd = 0ull;
  const u64 d = dollars(t);
  if (buy(t)) {
    cv += t.units;
    cd += d;
  } else if (sell(t)) {
    cv -= t.units;
    cd -= d;
  }
}

__device__ __forceinline__ void step_float(FSum& f, const Item& t, u64 cv, u64 cd) {
  if (t.flags & kOpen) f = {kF32Big, -kF32Big, kF32Big, -kF32Big, 1u};
  if (traded(t)) {
    const float v = fmk::pair_f32(cv), w = fmk::pair_f32(cd);
    f.cvmin = fminf(f.cvmin, v);
    f.cvmax = fmaxf(f.cvmax, v);
    f.cdmin = fminf(f.cdmin, w);
    f.cdmax = fmaxf(f.cdmax, w);
  }
}

// The float extrema of this thread's trades, from the in-bar sums (cv, cd)
// at its first trade; every thread of the block must call it. Returns the block's
// exclusive float state of this thread, joined to `carry` before the tile.
__device__ FSum thread_floats(const View& v, u64 cv, u64 cd, FSum carry, FSum* warp_f,
                              FSum* total) {
  FSum f = fsum_id();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const Item t = get(v, j);
    step_run(cv, cd, t);
    step_float(f, t, cv, cd);
  }
  const FSumCombine comb;
  return comb(carry, fmk::block_exclusive_scan<kWarps>(f, fsum_id(), comb, warp_f, total));
}

// ---------------------------------------------------------------------------
// Pass 0: the opens of the stream, one bit a trade (zeroed before).
__global__ void planes_marks(const long long* __restrict__ ci, long long n,
                             long long n_bars, unsigned* __restrict__ bits) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k <= n_bars) fmk::mark_open(ci, n, k, bits);
}

// Pass 1: the summary of each tile, and the float extrema of its last
// segment from in-bar sums of 0 at the tile's start: right when a bar opens
// in the tile, and left to pass 3 otherwise.
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
planes_reduce(const int* __restrict__ ticks, const long long* __restrict__ units,
              const signed char* __restrict__ sides, const long long* __restrict__ ci,
              const unsigned* __restrict__ bits, long long n, long long n_bars,
              Sum* __restrict__ tiles, FSum* __restrict__ ftiles) {
  __shared__ Tile tile;
  __shared__ Sum warp_sum[kWarps];
  __shared__ FSum warp_f[kWarps];
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const View v = load_tile(ticks, units, sides, ci, bits, n, n_bars, t0, tile);
  Sum x = sum_id();
#pragma unroll
  for (int j = 0; j < kItems; ++j) step(x, get(v, j));
  Sum total;
  const Sum ex = fmk::block_exclusive_scan<kWarps>(x, sum_id(), SumCombine(), warp_sum,
                                                   &total);
  if (threadIdx.x == 0) tiles[blockIdx.x] = total;
  if (!total.o) return;  // uniform in the block
  FSum ftotal;
  thread_floats(v, ex.cv, ex.cd, fsum_id(), warp_f, &ftotal);
  if (threadIdx.x == 0) ftiles[blockIdx.x] = ftotal;
}

// A value written by another block of the same launch, read past L1.
template <typename T>
__device__ __forceinline__ T load_cg(const T* p) {
  static_assert(sizeof(T) % 4 == 0, "T is read in 4-byte words");
  T v;
  const unsigned* src = reinterpret_cast<const unsigned*>(p);
  unsigned* dst = reinterpret_cast<unsigned*>(&v);
#pragma unroll
  for (int w = 0; w < static_cast<int>(sizeof(T) / 4); ++w) dst[w] = __ldcg(src + w);
  return v;
}

// Passes 2 and 4: the exclusive scan of m values in groups of kGroup, one
// block a group: `within` gets each value's exclusive scan inside its group,
// `groups` each group's total. The last block to finish (a counter, which it
// sets back to 0) scans the group totals into `gexcl`, in order. A tile's
// entry is then op(gexcl[t / kGroup], within[t]) (entry()).
template <typename T, typename Op>
__global__ void __launch_bounds__(kGroup)
tiles_scan(const T* __restrict__ in, T* __restrict__ within, T* __restrict__ groups,
           T* __restrict__ gexcl, unsigned* __restrict__ counter, long long m, T id) {
  __shared__ T warp_tot[kGroup / 32];
  __shared__ bool last;
  const Op op;
  const long long k = static_cast<long long>(blockIdx.x) * kGroup + threadIdx.x;
  T total;
  const T ex = fmk::block_exclusive_scan<kGroup / 32>(k < m ? in[k] : id, id, op,
                                                      warp_tot, &total);
  if (k < m) within[k] = ex;
  if (threadIdx.x == 0) {
    groups[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  T carry = id;
  for (unsigned r = 0; r < gridDim.x; r += kGroup) {  // uniform in the block
    const unsigned g = r + threadIdx.x;
    T gt;
    const T gx = fmk::block_exclusive_scan<kGroup / 32>(
        g < gridDim.x ? load_cg(groups + g) : id, id, op, warp_tot, &gt);
    if (g < gridDim.x) gexcl[g] = op(carry, gx);
    carry = op(carry, gt);
  }
  if (threadIdx.x == 0) *counter = 0u;
}

// Tile t's entry state from the scan of passes 2 and 4.
template <typename T, typename Op>
__device__ __forceinline__ T entry(const T* __restrict__ within,
                                   const T* __restrict__ gexcl, unsigned t) {
  return Op()(gexcl[t / kGroup], within[t]);
}

// Pass 3: the float extrema of the last segment of each tile where no bar
// opens (the others come from pass 1), from its exact entry sums.
__global__ void __launch_bounds__(kThreads)
planes_float_reduce(const int* __restrict__ ticks, const long long* __restrict__ units,
                    const signed char* __restrict__ sides,
                    const long long* __restrict__ ci, const unsigned* __restrict__ bits,
                    long long n, long long n_bars, const Sum* __restrict__ tiles,
                    const Sum* __restrict__ within, const Sum* __restrict__ gexcl,
                    FSum* __restrict__ ftiles) {
  __shared__ Tile tile;
  __shared__ Sum warp_sum[kWarps];
  __shared__ FSum warp_f[kWarps];
  if (tiles[blockIdx.x].o) return;  // uniform in the block
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const View v = load_tile(ticks, units, sides, ci, bits, n, n_bars, t0, tile);
  Sum x = sum_id();
#pragma unroll
  for (int j = 0; j < kItems; ++j) step(x, get(v, j));
  const SumCombine comb;
  Sum stretch;
  const Sum start = comb(entry<Sum, SumCombine>(within, gexcl, blockIdx.x),
                         fmk::block_exclusive_scan<kWarps>(x, sum_id(), comb, warp_sum,
                                                           &stretch));
  FSum total;
  thread_floats(v, start.cv, start.cd, fsum_id(), warp_f, &total);
  if (threadIdx.x == 0) ftiles[blockIdx.x] = total;
}

// Pass 5 helper: this warp's values of one row (thread value j at blocked
// position lane * kItems + j) through the warp's shared buffer to the row,
// each store of the warp on consecutive addresses. A lane's values go in as
// 16-byte stores; the buffer holds 4 pad words per 32, so that neither side
// of the transpose meets a bank conflict.
__device__ __forceinline__ void words(int x, int* w) { w[0] = x; }
__device__ __forceinline__ void words(float x, int* w) { w[0] = __float_as_int(x); }
__device__ __forceinline__ void words(long long x, int* w) {
  w[0] = static_cast<int>(x);
  w[1] = static_cast<int>(x >> 32);
}

template <typename V>
__device__ __forceinline__ void put_row(V* __restrict__ row, int* stage,
                                        const V (&v)[kItems], long long w0,
                                        long long n) {
  constexpr int kW = sizeof(V) / 4;  // words a value
  static_assert(kItems * kW % 4 == 0, "a lane's values are whole 16-byte stores");
  const int lane = threadIdx.x & 31;
  int w[kItems * kW];
#pragma unroll
  for (int j = 0; j < kItems; ++j) words(v[j], w + j * kW);
  int4* dst = reinterpret_cast<int4*>(stage + stage_word(lane * kItems * kW));
#pragma unroll
  for (int c = 0; c < kItems * kW / 4; ++c)
    dst[c] = make_int4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int p = j * 32 + lane;
    if (w0 + p < n) row[w0 + p] = *reinterpret_cast<const V*>(stage + stage_word(p * kW));
  }
  __syncwarp();
}

// Pass 5: every trade's 18 values, from each tile's entry state. The rows are
// written two at a time, each pair from a walk of the thread's trades in
// shared memory (which leaves registers for 3 blocks an SM), through the
// warp's staging buffer.
__global__ void __launch_bounds__(kThreads, 768 / kThreads)
planes_write(const int* __restrict__ ticks, const long long* __restrict__ units,
             const signed char* __restrict__ sides, const long long* __restrict__ ci,
             const unsigned* __restrict__ bits, long long n, long long n_bars,
             const Sum* __restrict__ within, const Sum* __restrict__ gexcl,
             const FSum* __restrict__ fwithin, const FSum* __restrict__ fgexcl,
             long long* __restrict__ pre64, int* __restrict__ pre32,
             int* __restrict__ ext32, float* __restrict__ extf) {
  __shared__ Tile tile;
  __shared__ int4 stage_all[kWarps][kStage / 4];
  __shared__ Sum warp_sum[kWarps];
  __shared__ FSum warp_f[kWarps];
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const View view = load_tile(ticks, units, sides, ci, bits, n, n_bars, t0, tile);
  Sum x = sum_id();
#pragma unroll
  for (int j = 0; j < kItems; ++j) step(x, get(view, j));
  const SumCombine comb;
  Sum total;
  const Sum in = comb(entry<Sum, SumCombine>(within, gexcl, blockIdx.x),
                      fmk::block_exclusive_scan<kWarps>(x, sum_id(), comb, warp_sum, &total));
  FSum ftotal;
  const FSum fin = thread_floats(view, in.cv, in.cd,
                                 entry<FSum, FSumCombine>(fwithin, fgexcl, blockIdx.x),
                                 warp_f, &ftotal);

  const int warp = threadIdx.x >> 5;
  const long long w0 = t0 + static_cast<long long>(warp) * kWarpTrades;
  int* stage = reinterpret_cast<int*>(stage_all[warp]);

  // the rows two at a time, each pair from one walk of the thread's trades
#pragma unroll
  for (int k = 0; k < 6; k += 2) {  // buy/sell units, buy/sell dollars, units/dollars
    long long ra[kItems], rb[kItems];
    u64 a = in.s64[k], b = in.s64[k + 1];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const Item t = get(view, j);
      const u64 u = t.units, d = dollars(t);
      if (k == 0) {
        a += buy(t) ? u : 0ull;
        b += sell(t) ? u : 0ull;
      } else if (k == 2) {
        a += buy(t) ? d : 0ull;
        b += sell(t) ? d : 0ull;
      } else {
        a += u;
        b += d;
      }
      ra[j] = static_cast<long long>(a);
      rb[j] = static_cast<long long>(b);
    }
    put_row(pre64 + k * n, stage, ra, w0, n);
    put_row(pre64 + (k + 1) * n, stage, rb, w0, n);
  }
  {  // buy and sell ticks
    int ra[kItems], rb[kItems];
    unsigned a = in.s32[0], b = in.s32[1];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      a += static_cast<unsigned>(buy(get(view, j)));
      b += static_cast<unsigned>(sell(get(view, j)));
      ra[j] = static_cast<int>(a);
      rb[j] = static_cast<int>(b);
    }
    put_row(pre32, stage, ra, w0, n);
    put_row(pre32 + n, stage, rb, w0, n);
  }
  {  // the spread's prefix and running max
    int ra[kItems], rb[kItems];
    unsigned a = in.s32[2];
    int b = in.e.sp;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const Item t = get(view, j);
      a += static_cast<unsigned>(t.spread);
      if (t.flags & kOpen) b = INT_MIN;
      b = max(b, (t.flags & kValid) ? t.spread : -1);
      ra[j] = static_cast<int>(a);
      rb[j] = b;
    }
    put_row(pre32 + 2 * n, stage, ra, w0, n);
    put_row(ext32 + 2 * n, stage, rb, w0, n);
  }
  {  // the running high and low
    int ra[kItems], rb[kItems];
    int a = in.e.hi, b = in.e.lo;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const Item t = get(view, j);
      const bool ok = t.flags & kValid;
      if (t.flags & kOpen) {
        a = INT_MIN;
        b = INT_MAX;
      }
      a = max(a, ok ? t.tick : INT_MIN);
      b = min(b, ok ? t.tick : INT_MAX);
      ra[j] = a;
      rb[j] = b;
    }
    put_row(ext32, stage, ra, w0, n);
    put_row(ext32 + n, stage, rb, w0, n);
  }
  {  // the min and max of the running tick imbalance
    int ra[kItems], rb[kItems];
    int a = in.e.ctmin, b = in.e.ctmax;
    unsigned ct = in.ct;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const Item t = get(view, j);
      if (t.flags & kOpen) {
        a = INT_MAX;
        b = INT_MIN;
        ct = 0u;
      }
      ct += static_cast<unsigned>(buy(t)) - static_cast<unsigned>(sell(t));
      if (traded(t)) {
        a = min(a, static_cast<int>(ct));
        b = max(b, static_cast<int>(ct));
      }
      ra[j] = a;
      rb[j] = b;
    }
    put_row(ext32 + 3 * n, stage, ra, w0, n);
    put_row(ext32 + 4 * n, stage, rb, w0, n);
  }
#pragma unroll
  for (int k = 0; k < 4; k += 2) {  // the volume (k = 0) and dollar (2) imbalances
    float ra[kItems], rb[kItems];
    float a = k == 0 ? fin.cvmin : fin.cdmin, b = k == 0 ? fin.cvmax : fin.cdmax;
    u64 c = k == 0 ? in.cv : in.cd;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const Item t = get(view, j);
      if (t.flags & kOpen) {
        a = kF32Big;
        b = -kF32Big;
        c = 0ull;
      }
      const u64 x = k == 0 ? t.units : dollars(t);
      c += buy(t) ? x : (sell(t) ? 0ull - x : 0ull);
      if (traded(t)) {
        const float f = fmk::pair_f32(c);
        a = fminf(a, f);
        b = fmaxf(b, f);
      }
      ra[j] = a;
      rb[j] = b;
    }
    put_row(extf + k * n, stage, ra, w0, n);
    put_row(extf + (k + 1) * n, stage, rb, w0, n);
  }
}

long long align_up(long long b) { return (b + 255) / 256 * 256; }

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

long long mark_words(long long n) { return n / 32 + 2; }

// The scratch of fmk_bar_planes: the opens' bitmap and the scan counter
// (zeroed by pass 0), then each tile's summaries, within-group scans and the
// groups' totals and scans, integer and float.
struct Scratch {
  unsigned* bits;
  unsigned* counter;
  Sum *tiles, *within, *groups, *gexcl;
  FSum *ftiles, *fwithin, *fgroups, *fgexcl;
  long long bytes;
};

Scratch carve(void* base, long long n) {
  const long long m = tiles_of(n), g = (m + kGroup - 1) / kGroup;
  char* p = static_cast<char*>(base);
  long long off = 0;
  auto take = [&](long long bytes) {
    char* q = p ? p + off : nullptr;
    off += align_up(bytes);
    return q;
  };
  Scratch s;
  s.bits = reinterpret_cast<unsigned*>(take(4 * (mark_words(n) + 1)));
  s.counter = s.bits ? s.bits + mark_words(n) : nullptr;
  s.tiles = reinterpret_cast<Sum*>(take(m * static_cast<long long>(sizeof(Sum))));
  s.within = reinterpret_cast<Sum*>(take(m * static_cast<long long>(sizeof(Sum))));
  s.groups = reinterpret_cast<Sum*>(take(g * static_cast<long long>(sizeof(Sum))));
  s.gexcl = reinterpret_cast<Sum*>(take(g * static_cast<long long>(sizeof(Sum))));
  s.ftiles = reinterpret_cast<FSum*>(take(m * static_cast<long long>(sizeof(FSum))));
  s.fwithin = reinterpret_cast<FSum*>(take(m * static_cast<long long>(sizeof(FSum))));
  s.fgroups = reinterpret_cast<FSum*>(take(g * static_cast<long long>(sizeof(FSum))));
  s.fgexcl = reinterpret_cast<FSum*>(take(g * static_cast<long long>(sizeof(FSum))));
  s.bytes = off;
  return s;
}

}  // namespace

// Bytes of scratch fmk_bar_planes needs for n trades.
extern "C" long long fmk_planes_scratch_bytes(long long n) {
  return carve(nullptr, n).bytes;
}

// ticks int32[n], units int64[n], sides int8[n], ci int64[n_bars + 1] sorted
// with -1 <= ci[0] and ci[n_bars] < n < 2^31 - kTile; pre64 int64[6][n],
// pre32 int32[3][n], ext32 int32[5][n], extf float32[4][n]; scratch of
// fmk_planes_scratch_bytes(n) bytes. `passes` is a bit mask of the passes to
// run (bit p: pass p; 63 runs all six). Returns cudaGetLastError().
extern "C" int fmk_bar_planes(const void* ticks, const void* units,
                              const void* sides, const void* ci, long long n,
                              long long n_bars, void* pre64, void* pre32,
                              void* ext32, void* extf, void* scratch, int passes,
                              void* stream) {
  if (n_bars <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long m = tiles_of(n);
  const unsigned grid = static_cast<unsigned>(m);
  const unsigned groups = static_cast<unsigned>((m + kGroup - 1) / kGroup);
  const Scratch s = carve(scratch, n);
  const int* tk = static_cast<const int*>(ticks);
  const long long* un = static_cast<const long long*>(units);
  const signed char* sd = static_cast<const signed char*>(sides);
  const long long* c = static_cast<const long long*>(ci);
  if (passes & 1) {
    cudaMemsetAsync(s.bits, 0, 4 * (mark_words(n) + 1), st);
    planes_marks<<<static_cast<unsigned>((n_bars + 1 + 255) / 256), 256, 0, st>>>(
        c, n, n_bars, s.bits);
  }
  if (passes & 2)
    planes_reduce<<<grid, kThreads, 0, st>>>(tk, un, sd, c, s.bits, n, n_bars, s.tiles,
                                             s.ftiles);
  if (passes & 4)
    tiles_scan<Sum, SumCombine><<<groups, kGroup, 0, st>>>(
        s.tiles, s.within, s.groups, s.gexcl, s.counter, m, sum_id());
  if (passes & 8)
    planes_float_reduce<<<grid, kThreads, 0, st>>>(tk, un, sd, c, s.bits, n, n_bars,
                                                   s.tiles, s.within, s.gexcl, s.ftiles);
  if (passes & 16)
    tiles_scan<FSum, FSumCombine><<<groups, kGroup, 0, st>>>(
        s.ftiles, s.fwithin, s.fgroups, s.fgexcl, s.counter, m, fsum_id());
  if (passes & 32)
    planes_write<<<grid, kThreads, 0, st>>>(
        tk, un, sd, c, s.bits, n, n_bars, s.within, s.gexcl, s.fwithin, s.fgexcl,
        static_cast<long long*>(pre64), static_cast<int*>(pre32),
        static_cast<int*>(ext32), static_cast<float*>(extf));
  return static_cast<int>(cudaGetLastError());
}
