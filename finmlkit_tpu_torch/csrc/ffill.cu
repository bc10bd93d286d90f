// Kernel F: forward fill. out[i] = values[j], j the last position <= i where
// valid[j] != 0; positions before the first valid one take values[0], or 0
// with the zero_before flag.
//
// Replaces the TPU kernels
//   K5  finmlkit_tpu/ops/pallas_scan.py _ffill_2d (_ffill_kernel): last-valid
//       fill of float32 values, moved there as int32 bits in (rows, 128)
//       planes with the carry in scratch memory;
//   L1  finmlkit_tpu/ops/segment_select.py _fill_last_planes
//       (_fill_last_kernel): the segmented last-fill of int32 values at
//       marks, 0 before the first mark (zero_before = 1, 4-byte payload).
// Here the payload is 32 or 64 bits (float32, float64 or int32, moved as
// bits: the output is a selection, bit-exact, NaN payloads included) and the
// stream is flat.
//
// ONE launch, a single-pass scan with a decoupled look-back, as kernel S's
// integer scan (csrc/prefix_scan.cu; Merrill and Garland, 2016), over the
// combine "the later valid index wins", a max. Each block takes its tile of
// 4096 values from an atomic ticket, so every tile before it belongs to a
// block that is already running and the spin-wait below cannot deadlock. A
// warp holds 512 consecutive values as rows of 32 16-byte vectors (4 int32 or
// 2 float64 values), lane l the l-th vector of each row, so each load and
// store of a warp covers consecutive bytes: the values' and the mask's (4 or
// 2 mask bytes a vector). Row by row, a ballot of the lanes that hold a valid
// value and two shuffles give each vector the last valid value before it in
// the warp; the warps' last valid values join in shared memory. A tile that
// holds a valid value publishes its inclusive result (its own last valid
// index) at once, before any look-back; a tile without one publishes that it
// has none, and its inclusive result once its look-back ends. Only a tile
// whose first value is not valid needs what comes before it: one warp reads
// the status of the 32 tiles before it at a time, back to the nearest
// published inclusive result, and one thread reads the value at the index
// found (one global load a tile). Max is associative and idempotent, so the
// order and the reach of the look-back cannot change the result, and floats
// need no fixed-order path. The status words and the ticket are zeroed by one
// memset in the same call.
//
// Bound: device memory, 9 bytes a value for int32 (the mask and the value
// read, the output written), 17 for float64; the look-back reads a few words
// a tile.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                // values a lane holds
constexpr int kSpan = 32 * kItems;        // 512 consecutive values a warp
constexpr int kTile = kThreads * kItems;  // 4096 values a block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kAlign = 256;

// A tile's status word: the flag in the top two bits, below it the last valid
// index + 1 (0: none). One 64-bit word, so a reader that sees a flag sees the
// index written with it.
constexpr unsigned long long kInvalid = 0, kAggregate = 1, kPrefix = 2;
constexpr int kFlagShift = 62;
constexpr unsigned long long kIndexBits = (1ull << kFlagShift) - 1;

struct LookBack {
  unsigned long long* ticket;  // the next tile to hand out
  unsigned long long* status;  // one word a tile
};

__device__ __forceinline__ void publish(const LookBack& lb, long long k,
                                        unsigned long long flag, long long last) {
  *reinterpret_cast<volatile unsigned long long*>(lb.status + k) =
      (flag << kFlagShift) | static_cast<unsigned long long>(last + 1);
}

// One warp: the last valid index before tile k (-1 if none), read back from
// tile k-1, 32 tiles a round (lane l the tile l before the round's first),
// until the nearest tile that has published its inclusive result. Tiles
// beyond that one hold no later index, so they are masked out and not waited
// for. Every lane returns the index.
__device__ long long look_back(const LookBack& lb, long long k) {
  const int lane = threadIdx.x & 31;
  long long best = -1;
  for (long long q = k - 1 - lane;; q -= 32) {
    unsigned long long w;
    unsigned pre;
    while (true) {
      w = q >= 0 ? *reinterpret_cast<const volatile unsigned long long*>(lb.status + q)
                 : kPrefix << kFlagShift;  // before the stream: none, final
      const unsigned long long flag = w >> kFlagShift;
      pre = __ballot_sync(kFull, flag == kPrefix);
      const unsigned inv = __ballot_sync(kFull, flag == kInvalid);
      const unsigned upto = pre ? (pre ^ (pre - 1)) : kFull;  // lanes to the nearest prefix
      if ((inv & upto) == 0) break;
    }
    long long v = static_cast<long long>(w & kIndexBits) - 1;
    if (pre && lane > __ffs(pre) - 1) v = -1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
    best = max(best, v);
    if (pre) return best;
  }
}

// Grid: one block a tile, the tile from the ticket. T is the payload's bits
// (unsigned int or unsigned long long).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ffill_kernel(const T* __restrict__ values, const unsigned char* __restrict__ valid,
             T* __restrict__ out, long long n, LookBack lb, bool zero_before) {
  constexpr int V = 16 / sizeof(T);  // values a vector, a 16-byte load
  constexpr int R = kItems / V;      // rows a warp
  using MaskWord = typename std::conditional<V == 4, unsigned, unsigned short>::type;
  __shared__ long long s_tile;
  __shared__ int warp_last[kWarps];
  __shared__ T warp_val[kWarps];
  __shared__ T s_carry;
  if (threadIdx.x == 0)
    s_tile = static_cast<long long>(atomicAdd(lb.ticket, 1ull));
  __syncthreads();
  const long long k = s_tile;
  const long long base = k * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long wb = base + warp * kSpan;  // the warp's first value
  const bool vec = n - base >= kTile &&
      ((reinterpret_cast<uintptr_t>(values) | reinterpret_cast<uintptr_t>(valid) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  // value j of row q is v[q * V + j], at wb + (q * 32 + lane) * V + j; bit
  // q * V + j of `bits` says whether it is valid
  T v[kItems];
  unsigned bits = 0;
  if (vec) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const long long g = wb + (q * 32 + lane) * V;
      const uint4 w = *reinterpret_cast<const uint4*>(values + g);
      memcpy(&v[q * V], &w, 16);
      const MaskWord mw = *reinterpret_cast<const MaskWord*>(valid + g);
#pragma unroll
      for (int j = 0; j < V; ++j)
        bits |= static_cast<unsigned>(((mw >> (8 * j)) & 0xff) != 0) << (q * V + j);
    }
  } else {
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const long long g = wb + (q * 32 + lane) * V + j;
        v[q * V + j] = g < n ? values[g] : T(0);
        bits |= static_cast<unsigned>(g < n && valid[g] != 0) << (q * V + j);
      }
  }
  // Row by row: each value becomes the last valid value at or before it in
  // the warp; `need` marks those with none (they take the carry below).
  const unsigned below = (1u << lane) - 1;  // the lanes before this one
  bool has = false;   // a valid value in the rows before
  T last_v = T(0);    // the last one
  int last_i = -1;    // its index in the warp
  unsigned need = 0;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    T lv = T(0);      // this vector's last valid value
    int lj = -1;
#pragma unroll
    for (int j = 0; j < V; ++j)
      if ((bits >> (q * V + j)) & 1u) { lv = v[q * V + j]; lj = j; }
    const unsigned b = __ballot_sync(kFull, lj >= 0);
    const unsigned prev = b & below;
    const T pv = __shfl_sync(kFull, lv, prev ? 31 - __clz(prev) : lane);
    T cur = prev ? pv : last_v;
    bool got = prev != 0 || has;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if ((bits >> (q * V + j)) & 1u) { cur = v[q * V + j]; got = true; }
      v[q * V + j] = cur;
      need |= static_cast<unsigned>(!got) << (q * V + j);
    }
    if (b) {
      const int hi = 31 - __clz(b);
      last_v = __shfl_sync(kFull, lv, hi);
      last_i = (q * 32 + hi) * V + __shfl_sync(kFull, lj, hi);
      has = true;
    }
  }
  if (lane == 0) {
    warp_last[warp] = has ? warp * kSpan + last_i : -1;
    warp_val[warp] = last_v;
  }
  __syncthreads();
  int tile_last = -1, before = -1;  // the tile's last valid value; the warps' before this one
  T before_v = T(0);
#pragma unroll
  for (int u = 0; u < kWarps; ++u) {
    const int y = warp_last[u];
    if (u < warp && y >= 0) { before = y; before_v = warp_val[u]; }
    if (y >= 0) tile_last = y;
  }
  if (warp == 0) {
    const bool first_valid = (__shfl_sync(kFull, bits, 0) & 1u) != 0;
    if (lane == 0)  // a tile with a valid value knows its inclusive result now
      publish(lb, k, k == 0 || tile_last >= 0 ? kPrefix : kAggregate,
              tile_last >= 0 ? base + tile_last : -1);
    if (!first_valid) {  // its leading values take what comes before the tile
      const long long c = k > 0 ? look_back(lb, k) : -1;
      if (lane == 0) {
        if (tile_last < 0 && k > 0) publish(lb, k, kPrefix, c);
        s_carry = c >= 0 ? values[c] : (zero_before ? T(0) : values[0]);
      }
    }
  }
  __syncthreads();
  if (need) {
    const T fill = before >= 0 ? before_v : s_carry;
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if ((need >> i) & 1u) v[i] = fill;
  }
  if (vec) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      uint4 w;
      memcpy(&w, &v[q * V], 16);
      *reinterpret_cast<uint4*>(out + wb + (q * 32 + lane) * V) = w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const long long g = wb + (q * 32 + lane) * V + j;
        if (g < n) out[g] = v[q * V + j];
      }
  }
}

long long round_up(long long x) { return (x + kAlign - 1) / kAlign * kAlign; }

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

// Scratch: the ticket, then the status words.
long long scratch_bytes(long long n, LookBack* lb, char* base) {
  if (lb != nullptr) {
    lb->ticket = reinterpret_cast<unsigned long long*>(base);
    lb->status = reinterpret_cast<unsigned long long*>(base + kAlign);
  }
  return kAlign + round_up(8 * tiles_of(n));
}

template <typename T>
int launch(const void* values, const unsigned char* valid, void* out, void* scratch,
           long long n, bool zero_before, cudaStream_t stream) {
  const long long tiles = tiles_of(n);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  LookBack lb;
  // the ticket and every status word start at zero (kInvalid)
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0, scratch_bytes(n, &lb, static_cast<char*>(scratch)), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  ffill_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      static_cast<const T*>(values), valid, static_cast<T*>(out), n, lb, zero_before);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch kernel F needs for n values (256-byte aligned).
extern "C" long long fmk_ffill_scratch_bytes(long long n) {
  return scratch_bytes(n, nullptr, nullptr);
}

// Kernel F over n values of `bytes` bytes each (4 or 8), valid a uint8 mask;
// zero_before != 0 writes 0 before the first valid position. `scratch` holds
// fmk_ffill_scratch_bytes(n) bytes, 256-byte aligned; the call zeroes it
// first, on the same stream. Returns cudaGetLastError().
extern "C" int fmk_ffill(int bytes, const void* values, const void* valid,
                         void* out, void* scratch, long long n, int zero_before,
                         void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const unsigned char*>(valid);
  switch (bytes) {
    case 4: return launch<unsigned int>(values, m, out, scratch, n, zero_before != 0, s);
    case 8:
      return launch<unsigned long long>(values, m, out, scratch, n, zero_before != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
