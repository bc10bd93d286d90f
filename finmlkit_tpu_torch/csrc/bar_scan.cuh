// What kernels B (bar_products.cu) and V (bar_planes.cu) share: the float32
// rounding of the imbalances, the bitmap of the bar opens and the block-wide
// scan.
//
// Bit-exactness with the TPU kernels (finmlkit_tpu/ops/fused_scan.py):
// - the float32 imbalance values are rounded from int64 in two steps,
//   hi * 2^32 + float(lo) (fused_scan.py:148-153, bar/fused.py:249-257), with
//   explicit round-to-nearest intrinsics so that no FMA contraction changes a
//   result;
// - "prev" of trade i is trade i-1, wrapping to trade n-1 for i == 0 (the
//   jnp.roll of _prep_planes), and does not reset at bar starts;
// - a single-trade bar's spread counts when its side != 0;
// - int32 and int64 sums wrap (unsigned adds), like the TPU's prefixes.
#pragma once

#include <cuda_runtime.h>

namespace fmk {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kF32Big = 3.0e38f;  // bar/fused.py _F32BIG
typedef unsigned long long u64;

// int64 -> float32 as the TPU kernel's _pair_to_f32: hi*2^32 + f32(lo).
__device__ __forceinline__ float pair_f32(u64 x) {
  const int hi = static_cast<int>(static_cast<long long>(x) >> 32);
  const int lo = static_cast<int>(static_cast<unsigned>(x & 0xffffffffull));
  const float lo_f =
      __fadd_rn(__int2float_rn(lo), lo < 0 ? 4294967296.0f : 0.0f);
  return __fadd_rn(__fmul_rn(__int2float_rn(hi), 4294967296.0f), lo_f);
}

// The opens of the stream as a bitmap, one bit a trade (zeroed before): bar
// k's first trade, ci[k] + 1, for k = 0 .. n_bars while it is below n. The
// mark at ci[n_bars] + 1 opens the trades after the last bar.
__device__ __forceinline__ void mark_open(const long long* __restrict__ ci, long long n,
                                          long long k, unsigned* __restrict__ bits) {
  const long long pos = ci[k] + 1;
  if (pos < n) atomicOr(&bits[pos >> 5], 1u << (pos & 31));
}

// Block-wide exclusive scan of one value per thread under the associative
// op(earlier, later) with identity id; every thread of the block must call
// it. *total receives the combination of the whole block. warp_tot holds
// kWarps values in shared memory. T needs an overload shfl_up(T, int).
template <int kWarps, typename T, typename Op>
__device__ T block_exclusive_scan(T v, T id, Op op, T* warp_tot, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = shfl_up(x, o);
    if (lane >= o) x = op(y, x);
  }
  T excl = shfl_up(x, 1);
  if (lane == 0) excl = id;
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_tot[lane] : id;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const T y = shfl_up(w, o);
      if (lane >= o) w = op(y, w);
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const T base = warp > 0 ? warp_tot[warp - 1] : id;
  *total = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return op(base, excl);
}

}  // namespace fmk
