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
// S is C with one row: every kernel below takes its row from blockIdx.y.
// On the TPU the grid ran in order and carried the running total in scratch
// memory from one block to the next. Here blocks run in parallel and in no
// order, so the scan is three launches on one stream:
//   1. every block reduces its tile of kTile elements of its row to one total;
//   2. one block per row scans that row's tile totals in place (inclusive);
//   3. every block scans its tile and adds the total of the row's tiles before
//      it.
// Rows of one tile skip 1 and 2.
//
// Bound: device memory. The stream is read twice and written once (12 bytes
// per int32 element); phase 2 touches n / kTile values per row. Inside a tile
// each thread loads kItems values coalesced through shared memory, sums them
// serially, and one warp-shuffle scan per block joins the threads.
//
// int64 and int32 adds run in the unsigned type of the same width, so a prefix
// that wraps past 2^63 (or 2^31) is defined and equals the two's-complement
// result of the TPU pair scans (pallas_scan.py:155-178, 264-283). Float sums
// are taken in a fixed order, so results repeat bit for bit from run to run.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 elements per block
constexpr int kWarps = kThreads / 32;
constexpr int kStage = kTile + kTile / 32;  // one pad word per 32
constexpr unsigned kFull = 0xffffffffu;

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
tile_totals_kernel(const T* __restrict__ in,
                   typename Acc<T>::type* __restrict__ tot, long long n) {
  const long long row = blockIdx.y;
  const auto t = tile_scan<T>(in + row * n, nullptr,
                              static_cast<long long>(blockIdx.x) * kTile, n,
                              typename Acc<T>::type(0));
  if (threadIdx.x == 0) tot[row * gridDim.x + blockIdx.x] = t;
}

// One block per row walks that row's m tile totals in order, tile by tile,
// carrying the sum.
template <typename A>
__global__ void __launch_bounds__(kThreads)
scan_totals_kernel(A* tot, long long m) {
  A* row_tot = tot + static_cast<long long>(blockIdx.x) * m;
  A carry = A(0);
  for (long long s = 0; s < m; s += kTile)
    carry = carry + tile_scan<A>(row_tot, row_tot, s, m, carry);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_tiles_kernel(const T* __restrict__ in, T* __restrict__ out,
                  const typename Acc<T>::type* __restrict__ tot, long long n) {
  using A = typename Acc<T>::type;
  const long long row = blockIdx.y;
  const A offset =
      blockIdx.x > 0 ? tot[row * gridDim.x + blockIdx.x - 1] : A(0);
  tile_scan<T>(in + row * n, out + row * n,
               static_cast<long long>(blockIdx.x) * kTile, n, offset);
}

template <typename T>
int launch(const void* x, void* out, void* partial, long long rows,
           long long n, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const T* in = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  A* tot = static_cast<A*>(partial);
  const long long tiles = (n + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(rows));
  if (tiles > 1) {
    tile_totals_kernel<T><<<grid, kThreads, 0, stream>>>(in, tot, n);
    scan_totals_kernel<A><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
        tot, tiles);
  }
  scan_tiles_kernel<T><<<grid, kThreads, 0, stream>>>(in, o, tot, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Elements per tile: the caller allocates rows * ceil(n / fmk_scan_tile())
// scratch values of the stream's dtype for the tile totals.
extern "C" int fmk_scan_tile() { return kTile; }

// Kernel C: the inclusive prefix sum of each row of a contiguous (rows, n)
// array, rows <= 65535 (the grid's y limit).
// dtype: 0 int32, 1 int64, 2 float32, 3 float64. Returns cudaGetLastError().
extern "C" int fmk_prefix_scan_rows(int dtype, const void* x, void* out,
                                    void* partial, long long rows,
                                    long long n, void* stream) {
  if (n <= 0 || rows <= 0) return 0;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<int>(x, out, partial, rows, n, s);
    case 1: return launch<long long>(x, out, partial, rows, n, s);
    case 2: return launch<float>(x, out, partial, rows, n, s);
    case 3: return launch<double>(x, out, partial, rows, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernel S: the inclusive prefix sum of one stream of n values.
extern "C" int fmk_prefix_scan(int dtype, const void* x, void* out,
                               void* partial, long long n, void* stream) {
  return fmk_prefix_scan_rows(dtype, x, out, partial, 1, n, stream);
}

extern "C" const char* fmk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
