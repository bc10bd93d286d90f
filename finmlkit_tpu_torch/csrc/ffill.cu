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
// bits: the output is a selection, bit-exact, NaN included) and the stream
// is flat.
// Blocks run in no order, so the fill is kernel S's three launches with the
// combine "the later valid index wins" (a max over valid positions):
//   1. every block writes the last valid index of its tile (-1 if none);
//   2. one block turns those into a running max over the tiles, in place;
//   3. every block fills its tile: inside the tile from the tile's own valid
//      values (a block-wide max-scan of the local last valid index), before
//      the tile's first valid value from the carry, values[max(carried, 0)].
//
// Bound: device memory. Pass 1 reads the mask (1 byte per element), pass 3
// the mask, the values and writes the output (17 bytes per float64 element);
// pass 2 touches n / kTile indices. Values go through shared memory so that
// loads and stores are coalesced and an in-tile source is one shared read.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 elements per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Block-wide exclusive max-scan of one value per thread (identity -1). Every
// thread of the block must call it. *total receives the block's maximum.
__device__ long long block_exclusive_max(long long v, long long* warp_tot,
                                         long long* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = max(x, y);
  }
  long long excl = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) excl = -1;
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < kWarps ? warp_tot[lane] : -1;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w = max(w, y);
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const long long base = warp > 0 ? warp_tot[warp - 1] : -1;
  *total = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return max(base, excl);
}

// The last valid index of the tile [start, start + kTile) of [0, n), or -1.
__device__ long long tile_last_valid(const unsigned char* valid, long long start,
                                     long long n, long long* warp_tot) {
  long long last = -1;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long g = start + i * kThreads + threadIdx.x;
    if (g < n && valid[g]) last = max(last, g);
  }
  long long total;
  block_exclusive_max(last, warp_tot, &total);
  return total;
}

__global__ void __launch_bounds__(kThreads)
tile_last_kernel(const unsigned char* __restrict__ valid,
                 long long* __restrict__ tot, long long n) {
  __shared__ long long warp_tot[kWarps];
  const long long t = tile_last_valid(
      valid, static_cast<long long>(blockIdx.x) * kTile, n, warp_tot);
  if (threadIdx.x == 0) tot[blockIdx.x] = t;
}

// One block walks the m tile results in order, kTile at a time, carrying the
// running maximum.
__global__ void __launch_bounds__(kThreads)
scan_tiles_max_kernel(long long* tot, long long m) {
  __shared__ long long warp_tot[kWarps];
  long long carry = -1;
  for (long long s = 0; s < m; s += kTile) {
    long long v[kItems];
    long long run = -1;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long g = s + threadIdx.x * kItems + i;
      run = max(run, g < m ? tot[g] : -1);
      v[i] = run;
    }
    long long total;
    const long long base = max(carry, block_exclusive_max(run, warp_tot, &total));
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long g = s + threadIdx.x * kItems + i;
      if (g < m) tot[g] = max(base, v[i]);
    }
    carry = max(carry, total);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fill_tiles_kernel(const T* __restrict__ values,
                  const unsigned char* __restrict__ valid, T* __restrict__ out,
                  const long long* __restrict__ tot, long long n,
                  bool zero_before) {
  __shared__ T stage[kTile];
  __shared__ unsigned char mask[kTile];
  __shared__ long long warp_tot[kWarps];
  const long long start = static_cast<long long>(blockIdx.x) * kTile;
  const long long carried = blockIdx.x > 0 ? tot[blockIdx.x - 1] : -1;
  const T carry = carried >= 0 ? values[carried] : (zero_before ? T(0) : values[0]);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = i * kThreads + threadIdx.x;
    const long long g = start + j;
    stage[j] = g < n ? values[g] : T(0);
    mask[j] = g < n ? valid[g] : 0;
  }
  __syncthreads();
  // local last valid index (tile-relative) at each of this thread's items
  int loc[kItems];
  int run = -1;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = threadIdx.x * kItems + i;
    if (mask[j]) run = j;
    loc[i] = run;
  }
  long long total;
  const int before = static_cast<int>(block_exclusive_max(run, warp_tot, &total));
  T res[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int src = max(before, loc[i]);
    res[i] = src >= 0 ? stage[src] : carry;
  }
  __syncthreads();  // every source read before the stage is overwritten
#pragma unroll
  for (int i = 0; i < kItems; ++i) stage[threadIdx.x * kItems + i] = res[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = i * kThreads + threadIdx.x;
    const long long g = start + j;
    if (g < n) out[g] = stage[j];
  }
}

template <typename T>
int launch(const void* values, const unsigned char* valid, void* out,
           long long* tot, long long n, bool zero_before, cudaStream_t stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  const unsigned grid = static_cast<unsigned>(tiles);
  if (tiles > 1) {
    tile_last_kernel<<<grid, kThreads, 0, stream>>>(valid, tot, n);
    scan_tiles_max_kernel<<<1, kThreads, 0, stream>>>(tot, tiles);
  }
  fill_tiles_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(values), valid, static_cast<T*>(out), tot, n,
      zero_before);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Elements per tile: the caller allocates ceil(n / fmk_ffill_tile()) int64
// scratch values for the tiles' last valid indices.
extern "C" int fmk_ffill_tile() { return kTile; }

// Kernel F over n values of `bytes` bytes each (4 or 8), valid a uint8 mask;
// zero_before != 0 writes 0 before the first valid position. Returns
// cudaGetLastError().
extern "C" int fmk_ffill(int bytes, const void* values, const void* valid,
                         void* out, void* scratch, long long n, int zero_before,
                         void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const unsigned char*>(valid);
  auto* tot = static_cast<long long*>(scratch);
  switch (bytes) {
    case 4: return launch<unsigned int>(values, m, out, tot, n, zero_before != 0, s);
    case 8:
      return launch<unsigned long long>(values, m, out, tot, n, zero_before != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
