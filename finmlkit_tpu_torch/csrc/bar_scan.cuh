// What kernels B (bar_products.cu) and V (bar_planes.cu) share: the float32
// rounding of the imbalances and the block-wide scan; and B's view of one
// trade's contributions to a bar, whose rules V follows on its shared-memory
// tiles.
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

// One trade of a bar: its tick, units, dollars (tick * units), side and
// tick-sign-change spread.
struct Trade {
  int tick;
  u64 units, dollars;
  signed char side;
  int spread;
};

// Trade i of n; `single` says that its bar holds only this trade.
__device__ __forceinline__ Trade load_trade(const int* __restrict__ ticks,
                                            const long long* __restrict__ units,
                                            const signed char* __restrict__ sides,
                                            long long i, long long n,
                                            bool single) {
  Trade t;
  t.tick = ticks[i];
  t.units = static_cast<u64>(units[i]);
  t.side = sides[i];
  t.dollars = static_cast<u64>(static_cast<long long>(t.tick)) * t.units;
  const long long ip = i == 0 ? n - 1 : i - 1;
  const bool change = single ? t.side != 0 : t.side != sides[ip];
  const unsigned diff =
      static_cast<unsigned>(t.tick) - static_cast<unsigned>(ticks[ip]);
  const unsigned mag = static_cast<int>(diff) < 0 ? 0u - diff : diff;  // wraps
  t.spread = change ? static_cast<int>(mag) : 0;
  return t;
}

// Running in-bar imbalances: volume units, dollar units, ticks.
struct Run {
  u64 cv, cd;
  unsigned ct;
};

__device__ __forceinline__ Run add(Run a, Run b) {
  return {a.cv + b.cv, a.cd + b.cd, a.ct + b.ct};
}

struct RunAdd {
  __device__ __forceinline__ Run operator()(Run a, Run b) const { return add(a, b); }
};

// A trade's signed contribution to the running imbalances.
__device__ __forceinline__ Run contribution(const Trade& t) {
  if (t.side == 1) return {t.units, t.dollars, 1u};
  if (t.side == -1) return {0ull - t.units, 0ull - t.dollars, 0u - 1u};
  return {0ull, 0ull, 0u};
}

__device__ __forceinline__ Run shfl_up(const Run& v, int o) {
  return {__shfl_up_sync(kFull, v.cv, o), __shfl_up_sync(kFull, v.cd, o),
          __shfl_up_sync(kFull, v.ct, o)};
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
