// Kernel H: per-bar histogram and "less" passes of the hist median engine, as
// one pass over fixed tiles of trades, whatever the bars.
//
// Replaces the TPU kernels of finmlkit_tpu/ops/segment_hist.py:
//   H1 _hist_pass (_hist_kernel): running counts of the 16 buckets
//      ((bits - B[bar]) >> s) per 128-lane row, with the per-bar base B
//      last-filled from scattered bar-open marks inside the kernel; an XLA
//      fixup (_hist_fix, bar_hist) turns the row tails into per-bar counts;
//   H2 _less_pass (_less_kernel): running count and segmented max of the
//      bits strictly below the per-bar value v, fixed up by _less_fix.
// For bar k, whose trades are (ci[k], ci[k+1]], it writes
//   hist  out[k][16] int32: the counts of each bucket over the bar;
//   less  cnt[k], mx[k] int32: the count of bits < v[k] and their max
//         (INT_MIN if none).
// An empty bar keeps zeros (and INT_MIN as its max). int32 arithmetic wraps
// (bits - B is computed unsigned), as in the TPU kernel.
//
// The stream is cut into tiles of kTile trades, a block a tile, kItems
// consecutive trades a thread (ops/segment_hist.py hist_pass_tiles and
// less_pass_tiles model it on the CPU):
//   - a first kernel sets every bar's output to the identity and, for each
//     tile, the number of close indices before it (a 32-way search of ci a
//     warp), so ci[lo..hi) are the closes in tile t;
//   - each block reads its lo and hi while every thread loads its trades,
//     then the closes ci[lo..hi] and the bars' keys (base or v) go to shared
//     memory where they fit: two dependent reads before the counting;
//   - each thread walks its trades once, keeping the counts of the bar it is
//     in in registers (4-bit fields, a 64-bit word for each 8 trades). A bar that opens and
//     closes inside one thread is stored whole; the thread's first piece (its
//     head) and a last piece that runs on into the next thread (its tail) are
//     partial;
//   - a tail joins the next lane's head (the same bar) through a shuffle, the
//     heads of a warp are summed by bar (16-bit fields; one reduction a field
//     where the warp lies in one bar, else a segmented scan), and each bar's
//     sum joins the output by atomics, 16 lanes a row (add; max for the less
//     pass). A lane's trades mostly share one or two
//     buckets in the first passes, which is why no count is added trade by
//     trade to shared or device memory.
// The output starts at the identity, so any order of the joins is exact.
//
// Bound: device memory, 4 bytes of amount bits a trade a pass; the work of a
// trade is a few integer operations. No block walks more than kTile trades,
// so a long bar costs what as many short ones do.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 4096 trades a block (ops/segment_hist.py _TILE)
constexpr int kWindow = 1024;  // close indices of a tile kept in shared memory
constexpr int kBlocksPerSM = 6;  // of the tiles kernel: at most 40 registers a thread
constexpr int kBuckets = 16;
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

// ---- the two passes: a lane's counts, their sums across lanes, the joins -------

// x << n with PTX's clamp: 0 for n >= 32, read as unsigned
__device__ __forceinline__ unsigned shl_clamped(unsigned x, unsigned n) {
  unsigned r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(n));
  return r;
}

// A lane's counts are 4-bit fields, buckets 0-7 in one 32-bit word (bucket f
// in bits 4f .. 4f+3) and 8-15 in another, a pair of words for its even
// trades and one for its odd ones, so that no field passes 8; they widen to
// 16-bit fields to be summed across lanes. (Scalar words, not an array: an
// array indexed by the trade would live in local memory.)
static_assert(kItems == 16, "two shares of at most 8 trades a lane");

struct Hist {
  struct Lane { unsigned e_lo, e_hi, o_lo, o_hi; };
  struct Wide { unsigned w[8]; };  // buckets 2j (low half) and 2j+1 (high) in w[j]
  const int* base;
  int s;
  int* out;

  __device__ int key(long long b) const { return base[b]; }
  __device__ void init(long long b) const {
    int4* row = reinterpret_cast<int4*>(out + b * kBuckets);
#pragma unroll
    for (int j = 0; j < 4; ++j) row[j] = make_int4(0, 0, 0, 0);
  }
  __device__ static Lane zero() { return {0u, 0u, 0u, 0u}; }
  // trade k of the lane, x its bits: one in bucket f's field where f is in
  // [0, 16), none elsewhere. f spans int32 (at s = 0, bits 2^30 away from the
  // key give f = +-2^30 + b), so it is clamped unsigned to 16 before it makes
  // a shift: 4 * f would wrap back into the fields. A shift of 32 or more,
  // and sh - 32 below 32 (it wraps to above), gives 0.
  __device__ void add(Lane& l, int x, int key, int k) const {
    const int f = static_cast<int>(static_cast<unsigned>(x) - static_cast<unsigned>(key)) >> s;
    const unsigned sh = 4u * min(static_cast<unsigned>(f), static_cast<unsigned>(kBuckets));
    const unsigned lo = shl_clamped(1u, sh);
    const unsigned hi = shl_clamped(1u, sh - 32u);
    if (k & 1) {
      l.o_lo += lo;
      l.o_hi += hi;
    } else {
      l.e_lo += lo;
      l.e_hi += hi;
    }
  }
  __device__ static bool nonzero(const Lane& l) {
    return (l.e_lo | l.e_hi | l.o_lo | l.o_hi) != 0u;
  }
  __device__ static Wide widen(const Lane& l) {
    constexpr u64 kNib = 0x0f0f0f0f0f0f0f0full;
    const u64 even = (static_cast<u64>(l.e_hi) << 32) | l.e_lo;
    const u64 odd = (static_cast<u64>(l.o_hi) << 32) | l.o_lo;
    // 8-bit counts: byte j of ev counts bucket 2j, of od bucket 2j+1
    const u64 ev = (even & kNib) + (odd & kNib);
    const u64 od = ((even >> 4) & kNib) + ((odd >> 4) & kNib);
    Wide v;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned e = static_cast<unsigned>(ev >> (32 * h));
      const unsigned o = static_cast<unsigned>(od >> (32 * h));
      const unsigned q0 = __byte_perm(e, o, 0x5140);  // buckets 8h .. 8h+3 as bytes
      const unsigned q1 = __byte_perm(e, o, 0x7362);  // buckets 8h+4 .. 8h+7
      v.w[4 * h] = __byte_perm(q0, 0u, 0x4140);
      v.w[4 * h + 1] = __byte_perm(q0, 0u, 0x4342);
      v.w[4 * h + 2] = __byte_perm(q1, 0u, 0x4140);
      v.w[4 * h + 3] = __byte_perm(q1, 0u, 0x4342);
    }
    return v;
  }
  __device__ static Wide plus(const Wide& a, const Wide& b) {
    Wide v;
#pragma unroll
    for (int j = 0; j < 8; ++j) v.w[j] = a.w[j] + b.w[j];
    return v;
  }
  __device__ static Wide shfl_up(const Wide& a, int o) {
    Wide v;
#pragma unroll
    for (int j = 0; j < 8; ++j) v.w[j] = __shfl_up_sync(kFull, a.w[j], o);
    return v;
  }
  __device__ static Wide reduce(const Wide& a) {  // over the warp
    Wide v;
#pragma unroll
    for (int j = 0; j < 8; ++j) v.w[j] = __reduce_add_sync(kFull, a.w[j]);
    return v;
  }
  // Bar b's counts held by lane src, joined to what other warps and tiles
  // add, a bucket a lane; every lane calls it.
  __device__ void join_from(long long b, const Wide& a, int src) const {
    const int lane = threadIdx.x & 31;
    unsigned mine = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned v = __shfl_sync(kFull, a.w[j], src);
      if ((lane >> 1) == j) mine = v;
    }
    const int c = static_cast<int>((mine >> (16 * (lane & 1))) & 0xffffu);
    if (lane < kBuckets && c != 0) atomicAdd(out + b * kBuckets + lane, c);
  }
  // bar b's counts, all of them: stored
  __device__ void store(long long b, const Lane& l) const {
    const Wide v = widen(l);
    int4* row = reinterpret_cast<int4*>(out + b * kBuckets);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      row[j] = make_int4(static_cast<int>(v.w[2 * j] & 0xffffu), static_cast<int>(v.w[2 * j] >> 16),
                         static_cast<int>(v.w[2 * j + 1] & 0xffffu),
                         static_cast<int>(v.w[2 * j + 1] >> 16));
  }
};

struct Less {
  struct Lane { int c, m; };  // the count below v and their max
  typedef Lane Wide;
  const int* v;
  int* cnt;
  int* mx;

  __device__ int key(long long b) const { return v[b]; }
  __device__ void init(long long b) const {
    cnt[b] = 0;
    mx[b] = INT_MIN;
  }
  __device__ static Lane zero() { return {0, INT_MIN}; }
  __device__ void add(Lane& a, int x, int key, int) const {
    const bool below = x < key;
    a.c += below;
    a.m = below ? max(a.m, x) : a.m;
  }
  __device__ static bool nonzero(const Lane& a) { return a.c != 0; }
  __device__ static Wide widen(const Lane& a) { return a; }
  __device__ static Wide plus(const Wide& a, const Wide& b) {
    return {a.c + b.c, max(a.m, b.m)};
  }
  __device__ static Wide shfl_up(const Wide& a, int o) {
    return {__shfl_up_sync(kFull, a.c, o), __shfl_up_sync(kFull, a.m, o)};
  }
  __device__ static Wide reduce(const Wide& a) {
    return {static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(a.c))),
            __reduce_max_sync(kFull, a.m)};
  }
  __device__ void join_from(long long b, const Wide& a, int src) const {
    const int c = __shfl_sync(kFull, a.c, src);
    const int m = __shfl_sync(kFull, a.m, src);
    if ((threadIdx.x & 31) == 0 && c != 0) {
      atomicAdd(cnt + b, c);
      atomicMax(mx + b, m);
    }
  }
  __device__ void store(long long b, const Lane& a) const {
    cnt[b] = a.c;
    mx[b] = a.m;
  }
};

// Bar j's output set to the identity (thread j), and tile_lo[t] = the number
// of ci[0 .. nb] at or below t * kTile - 1 for t = 0 .. tiles (warp t): a
// 32-way search of the sorted ci, each round a load a lane and a ballot that
// cut the range 32-fold, so no thread's work grows with a bar's length.
template <class P>
__global__ void init_kernel(const long long* __restrict__ ci, long long nb, long long tiles,
                            long long* __restrict__ tile_lo, P p) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j < nb) p.init(j);
  const long long t = j >> 5;
  if (t > tiles) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const long long edge = t * kTile - 1;
  long long a = 0, z = nb + 1;  // the count lies in [a, z]
  while (a < z) {
    const long long q = a + (z - a) * lane / 32;  // a <= q < z, rising with the lane
    const int k = __popc(__ballot_sync(kFull, ci[q] <= edge));
    if (k == 0) {
      z = a;
    } else {
      a = __shfl_sync(kFull, q, k - 1) + 1;
      const long long qk = __shfl_sync(kFull, q, k & 31);
      if (k < 32) z = qk;
    }
  }
  if (lane == 0) tile_lo[t] = a;
}

// One tile of bits[0 .. n) for bars (ci[k], ci[k+1]], k < nb.
template <class P>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
tiles_kernel(const int* __restrict__ bits, const long long* __restrict__ ci, long long n,
             long long nb, const long long* __restrict__ tile_lo, P p) {
  using Lane = typename P::Lane;
  using Wide = typename P::Wide;
  __shared__ long long win[kWindow + 1];  // ci[lo .. hi]
  __shared__ int keys[kWindow + 1];       // the keys of bars lo-1 .. hi-1
  const int lane = threadIdx.x & 31;
  const long long tile = blockIdx.x;
  const long long tile0 = tile * kTile;
  const long long i0 = tile0 + static_cast<long long>(threadIdx.x) * kItems;
  const long long iend = min(i0 + kItems, n);
  // closes ci[lo .. hi) lie in the tile; ci[hi] (or none) closes its last bar
  const long long lo = tile_lo[tile], hi = tile_lo[tile + 1];

  // the thread's trades, requested beside the tile's range
  int x[kItems];
  if ((reinterpret_cast<uintptr_t>(bits) & 15) == 0 && i0 + kItems <= n) {
    const int4* src = reinterpret_cast<const int4*>(bits + i0);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 v = src[q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) x[j] = i0 + j < n ? bits[i0 + j] : 0;
  }
  const bool in_smem = hi - lo < kWindow + 1;
  if (in_smem)
    for (long long j = threadIdx.x; j <= hi - lo; j += kThreads) {
      win[j] = lo + j <= nb ? ci[lo + j] : LLONG_MAX;
      const long long b = lo - 1 + j;
      keys[j] = b >= 0 && b < nb ? p.key(b) : 0;
    }
  __syncthreads();
  auto close_at = [&](long long j) -> long long {  // ci[j], j in [lo, hi]
    if (in_smem) return win[j - lo];
    return j <= nb ? ci[j] : LLONG_MAX;
  };
  auto key_of = [&](long long b) -> int {  // a bar of the tile, lo-1 <= b < nb
    return in_smem ? keys[b - lo + 1] : p.key(b);
  };

  Lane head = P::zero(), tail = P::zero();
  long long hb = nb + 1, tb = -1;  // head bar (nb + 1: no trades); continuing tail's bar
  if (i0 < n) {
    long long a = lo, z = hi;  // the bar of trade i0: closes before it, less one
    while (a < z) {
      const long long m = (a + z) >> 1;
      if (close_at(m) < i0) a = m + 1; else z = m;
    }
    long long b = a - 1;
    long long cn = close_at(b + 1);
    bool valid = b >= 0 && b < nb;
    int key = valid ? key_of(b) : 0;
    hb = b;
    Lane cur = P::zero();
    if (iend - i0 == kItems && iend - 1 <= cn) {  // kItems trades of one bar
      if (valid) {
#pragma unroll
        for (int j = 0; j < kItems; ++j) p.add(cur, x[j], key, j);
      }
      head = cur;
    } else {
      bool in_head = true;
      for (long long i = i0; i < iend; ++i) {
        while (i > cn) {  // bar b ended before trade i
          if (in_head) {
            head = cur;
            in_head = false;
          } else if (valid && P::nonzero(cur)) {
            p.store(b, cur);  // it opened and closed in this thread
          }
          cur = P::zero();
          ++b;
          cn = close_at(b + 1);
          valid = b < nb;
          key = valid ? key_of(b) : 0;
        }
        if (valid) p.add(cur, bits[i], key, static_cast<int>(i - i0));
      }
      if (in_head) {  // a short last lane of one bar
        head = cur;
      } else if (cn >= iend) {
        if (valid) {
          tail = cur;
          tb = b;
        }
      } else if (valid && P::nonzero(cur)) {
        p.store(b, cur);
      }
    }
  }
  // lane 31's tail runs past the warp; the others into the next lane's head
  // (the same bar)
  const Wide tw = P::widen(tail);
  const long long t31 = __shfl_sync(kFull, tb, 31);
  if (t31 >= 0) p.join_from(t31, tw, 31);
  const Wide from = P::shfl_up(tw, 1);
  const long long from_b = __shfl_up_sync(kFull, tb, 1);
  Wide h = P::widen(head);
  if (lane > 0 && from_b >= 0) h = P::plus(from, h);
  const long long hb0 = __shfl_sync(kFull, hb, 0);
  if (__all_sync(kFull, hb == hb0)) {  // the warp's heads are of one bar
    h = P::reduce(h);
    if (hb0 >= 0 && hb0 < nb) p.join_from(hb0, h, 0);
    return;
  }
  // the heads summed by bar (a segmented scan; bars rise with the lane), then
  // each bar's sum joined from its last lane
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Wide y = P::shfl_up(h, o);
    const long long yb = __shfl_up_sync(kFull, hb, o);
    if (lane >= o && yb == hb) h = P::plus(y, h);
  }
  const long long nxt = __shfl_down_sync(kFull, hb, 1);
  for (unsigned ends = __ballot_sync(kFull, (lane == 31 || nxt != hb) && hb >= 0 && hb < nb);
       ends != 0; ends &= ends - 1) {
    const int src = __ffs(ends) - 1;
    p.join_from(__shfl_sync(kFull, hb, src), h, src);
  }
}

template <class P>
int launch(const int* bits, const long long* ci, long long n, long long nb,
           long long* tile_lo, cudaStream_t st, const P& p) {
  const long long tiles = (n + kTile - 1) / kTile;
  init_kernel<P><<<static_cast<unsigned>((std::max(nb, 32 * (tiles + 1)) + 255) / 256), 256, 0, st>>>(
      ci, nb, tiles, tile_lo, p);
  if (tiles > 0)
    tiles_kernel<P><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(bits, ci, n, nb,
                                                                       tile_lo, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bits int32[n], ci int64[n_bars + 1] sorted with -1 <= ci[0] and
// ci[n_bars] < n, base int32[n_bars]; out int32[n_bars][16], 16-byte
// aligned; tile_lo int64[ceil(n / 4096) + 1] of scratch. Returns
// cudaGetLastError().
extern "C" int fmk_hist_pass(const void* bits, const void* ci, const void* base,
                             int s, long long n, long long n_bars, void* out,
                             void* tile_lo, void* stream) {
  if (n_bars <= 0) return 0;
  if (s < 0 || s > 31) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const int*>(bits), static_cast<const long long*>(ci), n, n_bars,
                static_cast<long long*>(tile_lo), static_cast<cudaStream_t>(stream),
                Hist{static_cast<const int*>(base), s, static_cast<int*>(out)});
}

// The less pass over the same bars with the per-bar value v int32[n_bars];
// cnt and mx int32[n_bars]; tile_lo as above. Returns cudaGetLastError().
extern "C" int fmk_less_pass(const void* bits, const void* ci, const void* v,
                             long long n, long long n_bars, void* cnt, void* mx,
                             void* tile_lo, void* stream) {
  if (n_bars <= 0) return 0;
  return launch(static_cast<const int*>(bits), static_cast<const long long*>(ci), n, n_bars,
                static_cast<long long*>(tile_lo), static_cast<cudaStream_t>(stream),
                Less{static_cast<const int*>(v), static_cast<int*>(cnt), static_cast<int*>(mx)});
}
