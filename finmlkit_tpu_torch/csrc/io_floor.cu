// Kernel P: the streaming floor. out[i] = x_0[i] + ... + x_{k-1}[i], int32
// sums that wrap, for k <= 8 input streams of n values.
//
// Replaces the TPU measurement probes of finmlkit_tpu/ops/fused_scan.py:
//   P1 bar_scan_io_floor          (_io_floor_kernel): the 8 input planes of
//                                 the bar scan in, one plane out;
//   P2 bar_scan_io_floor_k        (_io_floor_kernel_k): the same plane k times;
//   P3 bar_scan_io_floor_stacked  (_io_floor_kernel_stacked): the 8 planes as
//                                 one (8, rows, 128) stack.
// P1 and P2 are one grid-stride loop here: the stream pointers come in by
// value, each thread moves 16 bytes of each stream per step (int4 loads and
// stores) when every pointer is 16-byte aligned, 4 bytes otherwise. P3 has an
// entry of its own, fmk_io_floor_stacked, that takes the stack's one pointer:
// with an odd n most rows start off a 16-byte boundary, so thread q, which
// writes out[4q, 4q + 4) with one aligned int4 store, loads for each row the
// two aligned int4s that cover the row's 4 values and picks them by the row's
// offset (a switch, uniform across the block). Its neighbour loads the same
// second int4, which then comes from L1 or L2: each byte reaches device
// memory once. The last n mod 4 values take a scalar tail. One int4 a thread
// and no grid-stride loop: on an H100 that ran 6% faster than a grid-stride
// loop of the same loads. What the card
// measures for the three is the rate at which it streams: the floor under any
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

__device__ __forceinline__ int4 add4(int4 a, int4 b) {
  return {wadd(a.x, b.x), wadd(a.y, b.y), wadd(a.z, b.z), wadd(a.w, b.w)};
}

// Values m, m+1, m+2, m+3 of the 8 values (lo, hi).
__device__ __forceinline__ int4 pick4(int4 lo, int4 hi, int m) {
  switch (m) {
    case 0: return lo;
    case 1: return {lo.y, lo.z, lo.w, hi.x};
    case 2: return {lo.z, lo.w, hi.x, hi.y};
    default: return {lo.w, hi.x, hi.y, hi.z};
  }
}

// out[i] = sum over r < rows of the stack's value (r, i); the stack starts
// `head` int32 values after the 16-byte aligned `base`. One int4 of out a
// thread; the block of the last values also takes the scalar tail.
__global__ void __launch_bounds__(kThreads)
io_floor_stacked(const int4* __restrict__ base, int head, int rows,
                 int* __restrict__ out, long long n) {
  const long long n4 = n / 4;
  const long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (q < n4) {
    int4 acc = {0, 0, 0, 0};
#pragma unroll
    for (int r = 0; r < kMaxStreams; ++r) {
      if (r < rows) {
        const long long e = head + r * n;  // row r's first value, from base
        const int m = static_cast<int>(e & 3);
        const long long a = (e >> 2) + q;
        const int4 lo = base[a];
        // values 4a + m .. 4a + m + 3 lie in the row, so for m > 0 the next
        // int4 holds one of them and lies inside the stack
        const int4 hi = m ? base[a + 1] : lo;
        acc = add4(acc, pick4(lo, hi, m));
      }
    }
    reinterpret_cast<int4*>(out)[q] = acc;
  }
  if (q == n4 && 4 * n4 < n) {  // the tail: at most 3 values
    const int* x = reinterpret_cast<const int*>(base) + head;
    for (long long t = 4 * n4; t < n; ++t) {
      int acc = 0;
#pragma unroll
      for (int r = 0; r < kMaxStreams; ++r) {
        if (r < rows) acc = wadd(acc, x[r * n + t]);
      }
      out[t] = acc;
    }
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

// P3: the rows of a contiguous (rows, n) int32 stack x summed into out
// int32[n] (16-byte aligned). Returns cudaGetLastError().
extern "C" int fmk_io_floor_stacked(const void* x, int rows, long long n,
                                    void* out, void* stream) {
  const auto addr = reinterpret_cast<unsigned long long>(x);
  if (rows < 1 || rows > kMaxStreams || addr % 4 != 0 ||
      reinterpret_cast<unsigned long long>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int4* base = reinterpret_cast<const int4*>(addr & ~15ull);
  const int head = static_cast<int>((addr & 15ull) / 4);
  const unsigned blocks = static_cast<unsigned>(n / 4 / kThreads + 1);  // q <= n / 4
  io_floor_stacked<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      base, head, rows, static_cast<int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
