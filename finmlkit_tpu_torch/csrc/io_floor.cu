// Kernel P: the streaming floor. out[i] = x_0[i] + ... + x_{k-1}[i], int32
// sums that wrap, for k <= 8 input streams of n values.
//
// Replaces the TPU measurement probes of finmlkit_tpu/ops/fused_scan.py:
//   P1 bar_scan_io_floor          (_io_floor_kernel): the 8 input planes of
//                                 the bar scan in, one plane out;
//   P2 bar_scan_io_floor_k        (_io_floor_kernel_k): the same plane k times;
//   P3 bar_scan_io_floor_stacked  (_io_floor_kernel_stacked): the 8 planes as
//                                 one (8, rows, 128) stack.
// All three are one grid-stride loop here: the stream pointers come in by
// value, each thread moves 16 bytes of each stream per step (int4 loads and
// stores) when every pointer is 16-byte aligned, 4 bytes otherwise. What the
// card measures for it is the rate at which it streams: the floor under any
// kernel that reads the same bytes.
//
// Bound: device memory, 4 (k + 1) bytes a value; one add a value a stream.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStreams = 8;
constexpr long long kMaxBlocks = 132 * 16;  // 16 blocks for each SM of an H100

struct Streams {
  const int* p[kMaxStreams];
};

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__global__ void __launch_bounds__(kThreads)
io_floor_vec4(Streams in, int k, int* __restrict__ out, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       q < n4; q += stride) {
    int4 acc = reinterpret_cast<const int4*>(in.p[0])[q];
#pragma unroll
    for (int r = 1; r < kMaxStreams; ++r) {  // unrolled: no pointer array in memory
      if (r < k) {
        const int4 v = reinterpret_cast<const int4*>(in.p[r])[q];
        acc.x = wadd(acc.x, v.x);
        acc.y = wadd(acc.y, v.y);
        acc.z = wadd(acc.z, v.z);
        acc.w = wadd(acc.w, v.w);
      }
    }
    reinterpret_cast<int4*>(out)[q] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
io_floor_scalar(Streams in, int k, int* __restrict__ out, long long start,
                long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = start + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    int acc = in.p[0][i];
#pragma unroll
    for (int r = 1; r < kMaxStreams; ++r) {
      if (r < k) acc = wadd(acc, in.p[r][i]);
    }
    out[i] = acc;
  }
}

unsigned blocks_for(long long items) {
  const long long b = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace

// The k streams p0..p{k-1} (int32[n] each; the others are ignored) summed
// into out int32[n]. Returns cudaGetLastError().
extern "C" int fmk_io_floor(const void* p0, const void* p1, const void* p2,
                            const void* p3, const void* p4, const void* p5,
                            const void* p6, const void* p7, int k, void* out,
                            long long n, void* stream) {
  if (k < 1 || k > kMaxStreams) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[kMaxStreams] = {p0, p1, p2, p3, p4, p5, p6, p7};
  Streams in;
  bool aligned = reinterpret_cast<unsigned long long>(out) % 16 == 0;
  for (int r = 0; r < kMaxStreams; ++r) {
    in.p[r] = static_cast<const int*>(ptrs[r]);
    if (r < k) aligned = aligned && reinterpret_cast<unsigned long long>(ptrs[r]) % 16 == 0;
  }
  int* o = static_cast<int*>(out);
  const long long n4 = aligned ? n / 4 : 0;
  if (n4 > 0) io_floor_vec4<<<blocks_for(n4), kThreads, 0, s>>>(in, k, o, n4);
  if (4 * n4 < n)
    io_floor_scalar<<<blocks_for(n - 4 * n4), kThreads, 0, s>>>(in, k, o, 4 * n4, n);
  return static_cast<int>(cudaGetLastError());
}
