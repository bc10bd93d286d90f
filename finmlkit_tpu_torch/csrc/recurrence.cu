// Kernel R: the float64 first-order linear recurrence y_t = a_t * y_{t-1} + b_t,
// y_{-1} = 0, over one stream or over every row of a (rows, n) stack.
//
// Not a TPU kernel: it replaces the XLA associative scan of
// finmlkit_tpu/ops/scan.py:21 linear_recurrence (jax.lax.associative_scan over
// the affine maps y -> a*y + b), which the feature kernels call for EWMA, the
// EWM variances, Wilder's RSI, ATR and ADX smoothing.
//
// The maps compose associatively: "x then y" is (x.a * y.a, x.b * y.a + y.b).
// The design is kernel S's float path (prefix_scan.cu): three launches in a
// fixed association order, so that a result repeats bit for bit from run to
// run (a look-back that stops at whichever tile is ready first would round
// differently from run to run):
//   1. every block composes its tile's kTile maps into one (the tile's map);
//   2. one block per row walks that row's tile maps in order and writes y at
//      the end of every tile;
//   3. every block scans its tile from the y carried in from the tile before.
// A row of one tile skips 1 and 2. In a tile, a thread composes its kItems
// consecutive maps, one block-wide scan of the threads' maps (warp shuffles)
// gives each thread the map of everything before it, and the thread then runs
// the recurrence over its items from the y that map gives.
//
// y0 (one value a row, optional) folds into the row's first map as
// b_0 + a_0 * y0, as ops/scan.py:28-29 folds it. A NaN in b reaches every
// later y through the carried maps and no earlier one, as in the sequential
// loop: no map ever composes a later element into an earlier one.
//
// a comes as one value a row (a_cs = 0), one value an element (a_cs = 1), or,
// with a null pointer, as the constant a_const.
//
// Bound: device memory. Each value's a and b are read once and y written once:
// 24 bytes a value, 16 with a constant a. Passes 1 and 3 both read a and b, so
// the stream moves 40 (or 24) bytes a value; pass 2 touches 24 bytes a tile.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 values a tile
constexpr int kWarps = kThreads / 32;
constexpr int kStage = kTile + kTile / 32;  // one pad word per 32
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kAlign = 256;

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

struct Map {
  double a, b;  // y -> a * y + b
};

__device__ __forceinline__ Map identity() { return {1.0, 0.0}; }

// x, then y
__device__ __forceinline__ Map then(Map x, Map y) { return {x.a * y.a, x.b * y.a + y.b}; }

__device__ __forceinline__ Map shfl_up(Map m, int o) {
  return {__shfl_up_sync(kFull, m.a, o), __shfl_up_sync(kFull, m.b, o)};
}

// Block-wide exclusive scan of one map per thread, in thread order. Every
// thread of the block must call it. *total receives the block's map.
__device__ Map block_exclusive(Map v, Map* warp_tot, Map* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Map x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Map y = shfl_up(x, o);
    if (lane >= o) x = then(y, x);
  }
  Map excl = shfl_up(x, 1);
  if (lane == 0) excl = identity();
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    Map w = lane < kWarps ? warp_tot[lane] : identity();
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const Map y = shfl_up(w, o);
      if (lane >= o) w = then(y, w);
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const Map base = warp > 0 ? warp_tot[warp - 1] : identity();
  *total = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return then(base, excl);
}

struct Operands {
  const double* a;  // null: every a is a_const
  double a_const;
  long long a_rs;   // a's row stride
  int a_cs;         // a's element stride: 0 (one a a row) or 1
  const double* b;  // (rows, n)
  const double* y0; // rows values, or null
  long long n;

  __device__ __forceinline__ Map map(long long row, long long i) const {
    const double ai = a != nullptr ? a[row * a_rs + i * a_cs] : a_const;
    double bi = b[row * n + i];
    if (i == 0 && y0 != nullptr) bi = bi + ai * y0[row];
    return {ai, bi};
  }
};

// Loads the maps of [start, start + kTile) of one row into shared memory,
// neighbouring threads on neighbouring elements (identity past n), and
// returns thread t's maps t*kItems .. t*kItems + kItems - 1 in m.
__device__ __forceinline__ void load_tile(const Operands& op, long long row,
                                          long long start, double* sa, double* sb,
                                          Map (&m)[kItems]) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = i * kThreads + threadIdx.x;
    const long long g = start + j;
    const Map v = g < op.n ? op.map(row, g) : identity();
    sa[pad(j)] = v.a;
    sb[pad(j)] = v.b;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = threadIdx.x * kItems + i;
    m[i] = {sa[pad(j)], sb[pad(j)]};
  }
  __syncthreads();  // sa and sb are reused for the output
}

// Grid (tiles, rows): block (x, y) writes the map of tile x of row y.
__global__ void __launch_bounds__(kThreads) tile_maps_kernel(Operands op, Map* maps) {
  __shared__ double sa[kStage], sb[kStage];
  __shared__ Map warp_tot[kWarps];
  const long long row = blockIdx.y;
  Map m[kItems];
  load_tile(op, row, static_cast<long long>(blockIdx.x) * kTile, sa, sb, m);
  Map t = identity();
#pragma unroll
  for (int i = 0; i < kItems; ++i) t = then(t, m[i]);
  Map total;
  block_exclusive(t, warp_tot, &total);
  if (threadIdx.x == 0) maps[row * gridDim.x + blockIdx.x] = total;
}

// One block per row walks the row's `tiles` tile maps in order, kTile at a
// time, and writes y at the end of every tile (y_{-1} = 0).
__global__ void __launch_bounds__(kThreads)
tile_ends_kernel(const Map* __restrict__ maps, double* __restrict__ ends, long long tiles) {
  __shared__ Map warp_tot[kWarps];
  const Map* row_maps = maps + static_cast<long long>(blockIdx.x) * tiles;
  double* row_ends = ends + static_cast<long long>(blockIdx.x) * tiles;
  double carry = 0.0;
  for (long long s = 0; s < tiles; s += kTile) {
    Map m[kItems];
    Map t = identity();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long g = s + threadIdx.x * kItems + i;
      m[i] = g < tiles ? row_maps[g] : identity();
      t = then(t, m[i]);
    }
    Map total;
    const Map before = block_exclusive(t, warp_tot, &total);
    double y = before.a * carry + before.b;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long g = s + threadIdx.x * kItems + i;
      y = m[i].a * y + m[i].b;
      if (g < tiles) row_ends[g] = y;
    }
    __syncthreads();  // the block's global writes are visible to the block
    carry = row_ends[(s + kTile < tiles ? s + kTile : tiles) - 1];
  }
}

// Grid (tiles, rows): block (x, y) runs the recurrence over tile x of row y
// from the y at the end of tile x - 1 (0 before tile 0).
__global__ void __launch_bounds__(kThreads)
scan_tiles_kernel(Operands op, const double* __restrict__ ends, double* __restrict__ out) {
  __shared__ double sa[kStage], sb[kStage];
  __shared__ Map warp_tot[kWarps];
  const long long row = blockIdx.y;
  const long long start = static_cast<long long>(blockIdx.x) * kTile;
  const double carry = blockIdx.x > 0 ? ends[row * gridDim.x + blockIdx.x - 1] : 0.0;
  Map m[kItems];
  load_tile(op, row, start, sa, sb, m);
  Map t = identity();
#pragma unroll
  for (int i = 0; i < kItems; ++i) t = then(t, m[i]);
  Map total;
  const Map before = block_exclusive(t, warp_tot, &total);
  double y = before.a * carry + before.b;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    y = m[i].a * y + m[i].b;
    sb[pad(threadIdx.x * kItems + i)] = y;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = i * kThreads + threadIdx.x;
    const long long g = start + j;
    if (g < op.n) out[row * op.n + g] = sb[pad(j)];
  }
}

long long round_up(long long x) { return (x + kAlign - 1) / kAlign * kAlign; }

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Bytes of scratch that fmk_linear_recurrence needs for `rows` rows of n
// values: each tile's map, then y at each tile's end.
extern "C" long long fmk_recurrence_scratch_bytes(long long rows, long long n) {
  const long long tiles = tiles_of(n);
  return round_up(static_cast<long long>(sizeof(Map)) * rows * tiles) +
         round_up(8LL * rows * tiles);
}

// Kernel R: out[r, t] = a[r, t] * out[r, t-1] + b[r, t] for each of `rows`
// contiguous rows of n float64 values, out[r, -1] = 0, with b[r, 0] taken as
// b[r, 0] + a[r, 0] * y0[r] when y0 is not null. a[r, t] is a[r * a_rs + t *
// a_cs], or a_const when a is null. rows <= 65535 (the grid's y limit).
// `scratch` holds fmk_recurrence_scratch_bytes(rows, n) bytes, 256-byte
// aligned. Returns cudaGetLastError().
extern "C" int fmk_linear_recurrence(const double* a, double a_const, long long a_rs,
                                     int a_cs, const double* b, const double* y0,
                                     double* out, void* scratch, long long rows,
                                     long long n, void* stream) {
  if (n <= 0 || rows <= 0) return 0;
  const long long tiles = tiles_of(n);
  if (rows > 65535 || tiles > 0x7fffffffLL || (a_cs != 0 && a_cs != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operands op{a, a_const, a_rs, a_cs, b, y0, n};
  Map* maps = static_cast<Map*>(scratch);
  double* ends = reinterpret_cast<double*>(
      static_cast<char*>(scratch) + round_up(static_cast<long long>(sizeof(Map)) * rows * tiles));
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(rows));
  if (tiles > 1) {
    tile_maps_kernel<<<grid, kThreads, 0, s>>>(op, maps);
    tile_ends_kernel<<<static_cast<unsigned>(rows), kThreads, 0, s>>>(maps, ends, tiles);
  }
  scan_tiles_kernel<<<grid, kThreads, 0, s>>>(op, ends, out);
  return static_cast<int>(cudaGetLastError());
}
