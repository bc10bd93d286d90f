// Kernels S and C: inclusive prefix sums of int32, int64, float32 or float64
// values, over one stream (S) or over every row of a (C, n) stack (C).
//
// Replaces the TPU kernels of finmlkit_tpu/ops/pallas_scan.py:
//   K2   _cumsum_2d      (_cumsum_kernel)      int32 / float32 prefix sums,
//   K3   _cumsum_2d_i64  (_cumsum_kernel_i64)  exact int64 prefix sums, carried
//                                              there as hi/lo int32 pairs,
//   K4a  _cumsum_3d      (_cumsum_kernel_cols)      C independent int32 /
//                                                   float32 row prefix sums,
//   K4b  _cumsum_3d_i64  (_cumsum_kernel_cols_i64)  K4a for int64 as hi/lo
//                                                   pairs.
// S is C with one row. On the TPU the grid ran in order and carried the
// running total in scratch memory from one block to the next. Here blocks run
// in parallel and in no order.
//
// Integer streams: ONE launch, a single-pass scan with a decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016). Each block takes its tile from an atomic ticket, so every
// tile before it belongs to a block that is already running and the spin-wait
// below cannot deadlock. It loads its tile of 128 bytes a thread with 16-byte
// vector loads through shared memory, scans it in registers (one warp-shuffle
// scan joins the threads), publishes the tile's total, then lets one warp
// read the status of the 32 tiles before it at a time, adding their totals
// until it meets a tile that has published its inclusive prefix. It publishes its own inclusive
// prefix and writes the tile. A status is the value's 32-bit pieces, each in a
// 64-bit word beside the flag, so one read of independent words gives flags
// and values with no fence. The ticket and the status words are zeroed by one
// memset in the same call. The rows of C share one ticket counter and one
// status array; a look-back never leaves its row.
//
// Bound: device memory, 8 bytes per int32 element (read once, written once)
// and 16 per int64 element; the look-back reads a few words a tile. What it
// costs is latency: the front of published prefixes advances one look-back
// step (one round of reads from L2) per 32 tiles, so the tiles are large (32
// KB); a wider step, each lane reading 4 tiles, measured slower on the H100.
//
// Integer adds run in the unsigned type of the same width, so a prefix that
// wraps past 2^63 (or 2^31) is defined and equals the two's-complement result
// of the TPU pair scans (pallas_scan.py:155-178, 264-283). Wrapping addition is
// associative, so the order of the look-back does not change the result.
//
// Float streams keep three launches in a fixed association order, so that
// their results repeat bit for bit from run to run (a look-back that stops at
// whichever tile is ready first would round differently from run to run):
//   1. every block reduces its tile of kTile elements of its row to one total;
//   2. one block per row scans that row's tile totals in place (inclusive);
//   3. every block scans its tile and adds the total of the row's tiles before
//      it.
// Rows of one tile skip 1 and 2. That path reads the stream twice.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 elements per float tile
constexpr int kWarps = kThreads / 32;
constexpr int kStage = kTile + kTile / 32;  // one pad word per 32
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kAlign = 256;  // scratch regions start at this alignment

template <typename T> struct Acc { using type = T; };
template <> struct Acc<int> { using type = unsigned int; };
template <> struct Acc<long long> { using type = unsigned long long; };

// Shared-memory index with one pad word per 32 so that the blocked reads
// (thread t reads t*kItems .. t*kItems+kItems-1) fall on distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Block-wide exclusive scan of one value per thread. Every thread of the
// block must call it. *total receives the block's total.
template <typename A>
__device__ A block_exclusive_scan(A v, A* warp_tot, A* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  A x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const A y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = x + y;
  }
  A excl = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) excl = A(0);
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    A w = lane < kWarps ? warp_tot[lane] : A(0);
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const A y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w = w + y;
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const A base = warp > 0 ? warp_tot[warp - 1] : A(0);
  *total = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return base + excl;
}

// ---- integer streams: one pass with a decoupled look-back ------------------

enum : unsigned { kInvalid = 0, kTotal = 1, kPrefix = 2 };

// Status of tile k: the value in 32-bit pieces, each in one 64-bit word with
// the flag in its high half. A word is written whole, so a reader that sees a
// flag sees the piece written with it; a value is read when all its pieces
// carry the same flag. A tile writes its total (kTotal), then overwrites it
// with its inclusive prefix (kPrefix).
template <typename A> struct LookBack {
  static constexpr int kWords = sizeof(A) / 4;
  unsigned long long* ticket;  // the next tile to hand out
  unsigned long long* status;  // kWords words a tile
};

template <typename A>
__device__ __forceinline__ void publish(const LookBack<A>& lb, long long k,
                                        unsigned flag, A value) {
  volatile unsigned long long* w = lb.status + k * LookBack<A>::kWords;
#pragma unroll
  for (int i = 0; i < LookBack<A>::kWords; ++i)
    w[i] = (static_cast<unsigned long long>(flag) << 32) |
           static_cast<unsigned>(static_cast<unsigned long long>(value) >> (32 * i));
}

// The flag and value of tile q (kInvalid while its pieces disagree).
template <typename A>
__device__ __forceinline__ unsigned peek(const LookBack<A>& lb, long long q, A* value) {
  const volatile unsigned long long* w = lb.status + q * LookBack<A>::kWords;
  unsigned long long v[LookBack<A>::kWords];
#pragma unroll
  for (int i = 0; i < LookBack<A>::kWords; ++i) v[i] = w[i];
  const unsigned flag = static_cast<unsigned>(v[0] >> 32);
  unsigned long long x = 0;
#pragma unroll
  for (int i = 0; i < LookBack<A>::kWords; ++i) {
    if (static_cast<unsigned>(v[i] >> 32) != flag) return kInvalid;
    x |= (v[i] & 0xffffffffull) << (32 * i);
  }
  *value = static_cast<A>(x);
  return flag;
}

// One warp: the sum of the tiles first .. k-1 of k's row, read back from k-1,
// 32 tiles a step (lane l the tile l before the step's first), until a tile
// that has published its inclusive prefix. Every lane returns the sum.
template <typename A>
__device__ A look_back(const LookBack<A>& lb, long long k, long long first) {
  const int lane = threadIdx.x & 31;
  A sum = A(0);
  for (long long q = k - 1 - lane;; q -= 32) {
    unsigned st;
    A v;
    do {
      v = A(0);
      st = q >= first ? peek(lb, q, &v) : kPrefix;
    } while (__any_sync(kFull, st == kInvalid));
    const unsigned done = __ballot_sync(kFull, st == kPrefix);
    if (done && lane > __ffs(done) - 1) v = A(0);  // past the nearest prefix
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(kFull, v, o);
    sum = sum + v;
    if (done) return sum;
  }
}

// items a thread: 128 bytes, 32 int32 or 16 int64 (a tile of 32 KB in shared
// memory)
template <typename T> struct OnePass { static constexpr int kItems = 128 / sizeof(T); };

// Grid: rows * tiles blocks; the ticket k is tile k % tiles of row k / tiles.
// The tile moves between device memory and shared memory in 16-byte vectors,
// neighbouring threads on neighbouring addresses, and between shared memory
// and registers in blocks of K consecutive values a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
one_pass_kernel(const T* __restrict__ in, T* __restrict__ out, long long n,
                long long tiles, LookBack<typename Acc<T>::type> lb) {
  using A = typename Acc<T>::type;
  constexpr int K = OnePass<T>::kItems;
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int kTileN = kThreads * K;
  __shared__ long long s_ticket;
  __shared__ A warp_tot[kWarps];
  __shared__ A s_prefix;
  __shared__ A stage[kTileN + kTileN / 32];  // one pad value per 32
  if (threadIdx.x == 0)
    s_ticket = static_cast<long long>(atomicAdd(lb.ticket, 1ull));
  __syncthreads();
  const long long k = s_ticket;
  const long long row = k / tiles, tile = k - row * tiles;
  const long long base_off = row * n + tile * kTileN;
  const long long left = n - tile * kTileN;  // values of the row from the tile on
  const bool vec = left >= kTileN &&
      ((reinterpret_cast<uintptr_t>(in + base_off) |
        reinterpret_cast<uintptr_t>(out + base_off)) & 15) == 0;
  if (vec) {
    const uint4* src = reinterpret_cast<const uint4*>(in + base_off);
#pragma unroll
    for (int i = 0; i < K / V; ++i) {
      const int u = i * kThreads + threadIdx.x;
      const uint4 w = src[u];
      T t[V];
      memcpy(t, &w, 16);
#pragma unroll
      for (int j = 0; j < V; ++j) stage[pad(u * V + j)] = static_cast<A>(t[j]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int e = i * kThreads + threadIdx.x;
      stage[pad(e)] = e < left ? static_cast<A>(in[base_off + e]) : A(0);
    }
  }
  __syncthreads();
  A v[K];
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = stage[pad(threadIdx.x * K + i)];
#pragma unroll
  for (int i = 1; i < K; ++i) v[i] = v[i] + v[i - 1];
  A total;
  const A excl = block_exclusive_scan(v[K - 1], warp_tot, &total);
  A prefix = A(0);
  if (tile == 0) {
    if (threadIdx.x == 0) publish(lb, k, kPrefix, total);
  } else {
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) publish(lb, k, kTotal, total);
      const A before = look_back(lb, k, row * tiles);
      if (threadIdx.x == 0) {
        publish(lb, k, kPrefix, before + total);
        s_prefix = before;
      }
    }
    __syncthreads();
    prefix = s_prefix;
  }
  const A base = prefix + excl;
#pragma unroll
  for (int i = 0; i < K; ++i) stage[pad(threadIdx.x * K + i)] = base + v[i];
  __syncthreads();
  if (vec) {
    uint4* dst = reinterpret_cast<uint4*>(out + base_off);
#pragma unroll
    for (int i = 0; i < K / V; ++i) {
      const int u = i * kThreads + threadIdx.x;
      T t[V];
#pragma unroll
      for (int j = 0; j < V; ++j) t[j] = static_cast<T>(stage[pad(u * V + j)]);
      uint4 w;
      memcpy(&w, t, 16);
      dst[u] = w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int e = i * kThreads + threadIdx.x;
      if (e < left) out[base_off + e] = static_cast<T>(stage[pad(e)]);
    }
  }
}

long long round_up(long long x) { return (x + kAlign - 1) / kAlign * kAlign; }

template <typename T> long long one_pass_tiles(long long n) {
  const long long tile = static_cast<long long>(kThreads) * OnePass<T>::kItems;
  return (n + tile - 1) / tile;
}

// Scratch of the one-pass scan: the ticket, then the status words.
template <typename T>
long long one_pass_bytes(long long rows, long long n,
                         LookBack<typename Acc<T>::type>* lb, char* base) {
  using LB = LookBack<typename Acc<T>::type>;
  if (lb != nullptr) {
    lb->ticket = reinterpret_cast<unsigned long long*>(base);
    lb->status = reinterpret_cast<unsigned long long*>(base + kAlign);
  }
  return kAlign + round_up(8LL * LB::kWords * rows * one_pass_tiles<T>(n));
}

template <typename T>
int launch_one_pass(const void* x, void* out, void* scratch, long long rows,
                    long long n, cudaStream_t stream) {
  LookBack<typename Acc<T>::type> lb;
  const long long tiles = one_pass_tiles<T>(n);
  if (rows * tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // the ticket and every status word start at zero (kInvalid)
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0, one_pass_bytes<T>(rows, n, &lb, static_cast<char*>(scratch)), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  one_pass_kernel<T><<<static_cast<unsigned>(rows * tiles), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, tiles, lb);
  return static_cast<int>(cudaGetLastError());
}

// ---- float streams: three passes in a fixed order --------------------------

// Inclusive scan of the tile [start, start + kTile) of in[0, n), plus offset,
// written to out when out is not null. Returns the tile's own total.
// in and out may be the same array (phase 2 scans in place): every element
// is read before the barrier and written after it.
template <typename T>
__device__ typename Acc<T>::type tile_scan(const T* in, T* out,
                                           long long start, long long n,
                                           typename Acc<T>::type offset) {
  using A = typename Acc<T>::type;
  __shared__ A stage[kStage];
  __shared__ A warp_tot[kWarps];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = i * kThreads + threadIdx.x;
    const long long g = start + j;
    stage[pad(j)] = g < n ? static_cast<A>(in[g]) : A(0);
  }
  __syncthreads();
  A v[kItems];
  A run = A(0);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    run = run + stage[pad(threadIdx.x * kItems + i)];
    v[i] = run;
  }
  A total;
  const A excl = block_exclusive_scan(run, warp_tot, &total);
  if (out != nullptr) {
    const A base = offset + excl;
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      stage[pad(threadIdx.x * kItems + i)] = base + v[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = i * kThreads + threadIdx.x;
      const long long g = start + j;
      if (g < n) out[g] = static_cast<T>(stage[pad(j)]);
    }
    __syncthreads();
  }
  return total;
}

// Grid (tiles, rows): block (x, y) reduces tile x of row y. Row y of the
// input starts at y * n, row y of the totals at y * tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_totals_kernel(const T* __restrict__ in, T* __restrict__ tot, long long n) {
  const long long row = blockIdx.y;
  const auto t = tile_scan<T>(in + row * n, nullptr,
                              static_cast<long long>(blockIdx.x) * kTile, n, T(0));
  if (threadIdx.x == 0) tot[row * gridDim.x + blockIdx.x] = t;
}

// One block per row walks that row's m tile totals in order, tile by tile,
// carrying the sum.
template <typename T>
__global__ void __launch_bounds__(kThreads) scan_totals_kernel(T* tot, long long m) {
  T* row_tot = tot + static_cast<long long>(blockIdx.x) * m;
  T carry = T(0);
  for (long long s = 0; s < m; s += kTile)
    carry = carry + tile_scan<T>(row_tot, row_tot, s, m, carry);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_tiles_kernel(const T* __restrict__ in, T* __restrict__ out,
                  const T* __restrict__ tot, long long n) {
  const long long row = blockIdx.y;
  const T offset = blockIdx.x > 0 ? tot[row * gridDim.x + blockIdx.x - 1] : T(0);
  tile_scan<T>(in + row * n, out + row * n,
               static_cast<long long>(blockIdx.x) * kTile, n, offset);
}

template <typename T> long long three_pass_bytes(long long rows, long long n) {
  return round_up(sizeof(T) * rows * ((n + kTile - 1) / kTile));
}

template <typename T>
int launch_three_pass(const void* x, void* out, void* scratch, long long rows,
                      long long n, cudaStream_t stream) {
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const T* in = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  T* tot = static_cast<T*>(scratch);
  const long long tiles = (n + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(rows));
  if (tiles > 1) {
    tile_totals_kernel<T><<<grid, kThreads, 0, stream>>>(in, tot, n);
    scan_totals_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
        tot, tiles);
  }
  scan_tiles_kernel<T><<<grid, kThreads, 0, stream>>>(in, o, tot, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch that fmk_prefix_scan_rows needs for `rows` rows of n values
// of the dtype (0 int32, 1 int64, 2 float32, 3 float64); -1 for another dtype.
extern "C" long long fmk_scan_scratch_bytes(int dtype, long long rows, long long n) {
  switch (dtype) {
    case 0: return one_pass_bytes<int>(rows, n, nullptr, nullptr);
    case 1: return one_pass_bytes<long long>(rows, n, nullptr, nullptr);
    case 2: return three_pass_bytes<float>(rows, n);
    case 3: return three_pass_bytes<double>(rows, n);
    default: return -1;
  }
}

// Kernel C: the inclusive prefix sum of each row of a contiguous (rows, n)
// array; float rows <= 65535 (the grid's y limit). `scratch` holds
// fmk_scan_scratch_bytes(dtype, rows, n) bytes, 256-byte aligned; an integer
// scan zeroes the part it needs first, on the same stream.
// dtype: 0 int32, 1 int64, 2 float32, 3 float64. Returns cudaGetLastError().
extern "C" int fmk_prefix_scan_rows(int dtype, const void* x, void* out,
                                    void* scratch, long long rows,
                                    long long n, void* stream) {
  if (n <= 0 || rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_one_pass<int>(x, out, scratch, rows, n, s);
    case 1: return launch_one_pass<long long>(x, out, scratch, rows, n, s);
    case 2: return launch_three_pass<float>(x, out, scratch, rows, n, s);
    case 3: return launch_three_pass<double>(x, out, scratch, rows, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernel S: the inclusive prefix sum of one stream of n values.
extern "C" int fmk_prefix_scan(int dtype, const void* x, void* out,
                               void* scratch, long long n, void* stream) {
  return fmk_prefix_scan_rows(dtype, x, out, scratch, 1, n, stream);
}

extern "C" const char* fmk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
