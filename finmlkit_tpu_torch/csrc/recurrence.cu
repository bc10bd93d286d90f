// Kernel R: the float64 first-order linear recurrence y_t = a_t * y_{t-1} + b_t,
// y_{-1} = 0, over one stream or over every row of a (rows, n) stack.
//
// Not a TPU kernel: it replaces the XLA associative scan of
// finmlkit_tpu/ops/scan.py:21 linear_recurrence (jax.lax.associative_scan over
// the affine maps y -> a*y + b), which the feature kernels call for EWMA, the
// EWM variances, Wilder's RSI, ATR and ADX smoothing.
//
// ONE launch, a single-pass scan with a decoupled look-back (Merrill and
// Garland, 2016; the ticket and status idiom of prefix_scan.cu and ffill.cu),
// whose result does not depend on where a look-back stops. Each block takes
// its tile of one row (2048 values where a comes a value an element, 8192
// where it is a constant or one a row) from an atomic ticket, so every tile
// before it belongs to a block that is already running and the spin-waits
// below cannot deadlock; a row's tiles follow one another in ticket order, and
// a look-back never leaves its row. The block loads its tile's maps (16-byte
// loads where the tile is whole and aligned) through shared memory, each
// thread composes its kItems consecutive maps, and a block-wide scan of the
// threads' maps (warp shuffles, in thread order) gives each thread the map of
// everything before it in the tile and the tile's map M_i.
//
// The carries are defined by a FIXED association, so every block that
// computes one gets the same bits. The row's tiles form groups of 32 (tiles
// 32 G .. 32 G + 31). Within a group, S(G, r) is the composition of the maps
// of its tiles 0 .. r by one fixed 32-lane warp scan (Hillis-Steele, lane l
// holding tile 32 G + l; a lane's result reads only the lanes below it).
// Y(G), the y at the end of group G, is S(G, 31) applied to Y(G - 1), Y(-1)
// = 0: a chain of scalar steps y = A * y + B, each rounded to nearest, no
// multiply-add. Tile 32 G + r starts from S(G, r - 1) applied to Y(G - 1).
//   - Each tile publishes M_i at once; the last tile of a group publishes the
//     group's map S(G, 31) once the group's maps are in, and later Y(G).
//   - One warp reads the maps of its group's tiles before it, polling until
//     each is in, and runs the warp scan. That needs no tile's carry, so no
//     tile waits for the front of carries to reach it.
//   - It then reads the status of the 32 groups before its own, polling until
//     every group back to the nearest published Y (before the row: 0) has
//     published its map, and applies the group maps after that Y to the
//     SCALAR y, oldest first. It never composes them into one map: that is
//     exactly the chain Y(G) = S(G, 31) Y(G - 1), so Y has the same bits
//     whichever group the look-back stopped at.
//   - Every published value travels in a 16-byte word beside its flag,
//     written and read by one access, so no reader sees a flag without its
//     value and no fence is needed. A poll that finds a value missing sleeps
//     a little (32 to 256 ns) before the next, so that the polling warps do
//     not crowd the writers off the status lines.
//   - Each thread then runs the recurrence over its items from the y that its
//     map gives from the tile's carry, and the tile is written through shared
//     memory.
// Groups, not single tiles, carry the chain of end y's: a chain of tile ends
// would make every tile wait for the front of published ends to reach it.
//
// y0 (one value a row, optional) folds into the row's first map as
// b_0 + a_0 * y0, as ops/scan.py:28-29 folds it. A NaN in b reaches every
// later y through the tile maps and the carried y and no earlier one, as in
// the sequential loop: no map ever composes a later element into an earlier
// one, and no tile reads a later tile.
//
// a comes as one value a row (a_cs = 0), one value an element (a_cs = 1), or,
// with a null pointer, as the constant a_const; each form is its own kernel.
//
// Bound: device memory. Each value's a and b are read once and y written once:
// 24 bytes a value, 16 with a constant a (or one a a row); the look-back reads
// a few status words a tile. With a non-null `dist`, each tile writes how many
// tiles its look-back walked back: its place in its group, plus 32 for each
// group map it applied.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kAlign = 256;

enum AForm { kConst = 0, kRow = 1, kElem = 2 };

// Values a thread: 8 (tiles of 2048) where a comes a value an element, 32
// (tiles of 8192) where it is a constant or one a row: fewer tiles, so fewer
// look-backs, for the stream with fewer bytes a value. The staging buffers
// hold one pad word per 32.
__host__ __device__ constexpr int items_of(int form) { return form == kElem ? 8 : 32; }
__host__ __device__ constexpr int stage_of(int form) {
  return kThreads * items_of(form) + kThreads * items_of(form) / 32;
}
__host__ __device__ constexpr int smem_of(int form) {  // dynamic shared memory
  return form == kElem ? 0 : stage_of(form) * static_cast<int>(sizeof(double));
}
constexpr int kMinTile = kThreads * 8;

__host__ __device__ __forceinline__ long long groups_of(long long tiles) {
  return (tiles + 31) / 32;
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

struct Map {
  double a, b;  // y -> a * y + b
};

__device__ __forceinline__ Map identity() { return {1.0, 0.0}; }

// x, then y
__device__ __forceinline__ Map then(Map x, Map y) {
  return {__dmul_rn(x.a, y.a), __dadd_rn(__dmul_rn(x.b, y.a), y.b)};
}

// m applied to y. The tile-end chain and the look-back both use this, and
// only this, so they round alike.
__device__ __forceinline__ double apply(Map m, double y) {
  return __dadd_rn(__dmul_rn(m.a, y), m.b);
}

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
  return then(base, excl);
}

// Every published value travels in its own 16-byte word beside a flag,
// written and read by one 16-byte access, so no reader sees a flag without
// its value and no fence is needed: a tile's map is two words (A, B), a
// group's map two words and its end y a third. The memset zeroes the flags.
struct alignas(16) Word {
  unsigned long long flag;
  double v;
};

struct LookBack {
  unsigned long long* ticket;  // the next tile to hand out
  Word* tile;                  // 2 a tile, in ticket order: A, B
  Word* group;                 // 3 a group (rows * groups a row): A, B, Y
};

__device__ __forceinline__ void put(Word* p, double v) {
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(1ull),
               "l"(__double_as_longlong(v))
               : "memory");
}

__device__ __forceinline__ Word get(const Word* p) {
  unsigned long long f, v;
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(f), "=l"(v)
               : "l"(p)
               : "memory");
  return {f, __longlong_as_double(v)};
}

// Between two polls that found a value missing: a short, growing sleep, so
// the spinning warps leave the status lines to the writers.
__device__ __forceinline__ void back_off(unsigned& ns) {
  __nanosleep(ns);
  ns = ns < 256 ? 2 * ns : 256;
}

// One warp, for the tile of ticket g, place r in group grp of its row (gidx
// the group's index), own map `mine`: the tile's carry. The last tile of a
// group also publishes the group's map and end y. Every lane returns the
// carry; *walked receives the tiles walked back.
__device__ double look_back(const LookBack& lb, long long g, int r, long long grp,
                            long long gidx, Map mine, int* walked) {
  const int lane = threadIdx.x & 31;
  // the maps of the group's tiles before this one (lane l: tile l of the group)
  Map m = lane == r ? mine : identity();
  if (r > 0) {
    const Word* tw = lb.tile + 2 * (g - r + lane);
    bool have = lane >= r;
    unsigned ns = 32;
    while (true) {
      if (!have) {
        const Word a = get(tw), b = get(tw + 1);
        if (a.flag != 0 && b.flag != 0) {
          m = {a.v, b.v};
          have = true;
        }
      }
      if (__all_sync(kFull, have)) break;
      back_off(ns);
    }
  }
  // the fixed warp scan of the group's maps
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Map y = shfl_up(m, o);
    if (lane >= o) m = then(y, m);
  }
  const int rb = r > 0 ? r - 1 : 0;
  const Map before = {__shfl_sync(kFull, m.a, rb), __shfl_sync(kFull, m.b, rb)};
  const Map total = {__shfl_sync(kFull, m.a, 31), __shfl_sync(kFull, m.b, 31)};
  Word* own = lb.group + 3 * gidx;
  if (r == 31 && lane == 0) {
    put(own, total.a);
    put(own + 1, total.b);
  }
  // Y(grp - 1): lane l reads the group l + 1 back (past the row's start,
  // y = 0), until every group back to the nearest end y has its map
  double y = 0.0;
  int p = 0;
  if (grp > 0) {
    const Word* gw = lb.group + 3 * (gidx - 1 - lane);
    Word ga{0, 0.0}, gb{0, 0.0}, gy{1, 0.0};
    unsigned pre, ns = 32;
    while (true) {
      if (lane < grp) {
        gy = get(gw + 2);
        if (gy.flag == 0) {
          ga = get(gw);
          gb = get(gw + 1);
        }
      }
      pre = __ballot_sync(kFull, gy.flag != 0);
      const unsigned inv = __ballot_sync(kFull, gy.flag == 0 && (ga.flag == 0 || gb.flag == 0));
      if (pre != 0 && (inv & (pre ^ (pre - 1))) == 0) break;
      back_off(ns);
    }
    p = __ffs(pre) - 1;
    y = __shfl_sync(kFull, gy.v, p);
    for (int l = p - 1; l >= 0; --l)  // oldest first, on the scalar y
      y = apply({__shfl_sync(kFull, ga.v, l), __shfl_sync(kFull, gb.v, l)}, y);
  }
  if (r == 31 && lane == 0) put(own + 2, apply(total, y));
  *walked = r + 32 * p;
  return r > 0 ? apply(before, y) : y;
}

struct Operands {
  const double* a;   // kRow, kElem
  double a_const;    // kConst
  long long a_rs;    // a's row stride
  const double* b;   // (rows, n)
  const double* y0;  // rows values, or null
  double* out;       // (rows, n)
  long long n;
};

template <int F>
__device__ __forceinline__ double a_at(const Operands& op, long long row, long long i) {
  if (F == kConst) return op.a_const;
  if (F == kRow) return op.a[row * op.a_rs];
  return op.a[row * op.a_rs + i];
}

// Loads b (and a, kElem) of [start, start + kTile) of one row into shared
// memory at pad(j), j the index in the tile; past n, b = 0 and a = 1 (with a
// constant or one a a row, a stays: the maps past n change only the map of
// the row's last tile, and no tile reads that).
template <int F, int kItems, int kTile = kThreads * kItems>
__device__ __forceinline__ void load_tile(const Operands& op, long long row, long long start,
                                          bool vec, double* sa, double* sb) {
  const double* b = op.b + row * op.n + start;
  const double* a = F == kElem ? op.a + row * op.a_rs + start : nullptr;
  if (vec) {
#pragma unroll
    for (int i = 0; i < kItems / 2; ++i) {
      const int j = 2 * (i * kThreads + threadIdx.x);
      const double2 vb = *reinterpret_cast<const double2*>(b + j);
      sb[pad(j)] = vb.x;
      sb[pad(j + 1)] = vb.y;
      if (F == kElem) {
        const double2 va = *reinterpret_cast<const double2*>(a + j);
        sa[pad(j)] = va.x;
        sa[pad(j + 1)] = va.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = i * kThreads + threadIdx.x;
      const bool in = start + j < op.n;
      sb[pad(j)] = in ? b[j] : 0.0;
      if (F == kElem) sa[pad(j)] = in ? a[j] : 1.0;
    }
  }
}

// Grid: one block a tile, (row, tile) from the ticket; `tiles` a row.
template <int F, int kItems = items_of(F), int kTile = kThreads * kItems>
__global__ void __launch_bounds__(kThreads)
recurrence_kernel(Operands op, LookBack lb, long long tiles, int* __restrict__ dist) {
  // a (kElem) and b: static arrays where they fit in 48 KB (two arrays, so
  // that the compiler knows they do not overlap), else dynamic
  __shared__ double fixed_a[F == kElem ? stage_of(kElem) : 1];
  __shared__ double fixed_b[F == kElem ? stage_of(kElem) : 1];
  extern __shared__ double wide[];
  double* const sa = fixed_a;
  double* const sb = F == kElem ? fixed_b : wide;
  __shared__ Map warp_tot[kWarps];
  __shared__ long long s_ticket;
  __shared__ double s_carry;
  if (threadIdx.x == 0) s_ticket = static_cast<long long>(atomicAdd(lb.ticket, 1ull));
  __syncthreads();
  const long long g = s_ticket;
  const long long row = g / tiles, tile = g - row * tiles;
  const long long start = tile * kTile;
  const long long left = op.n - start;  // values of the row from start on
  const uintptr_t addr = reinterpret_cast<uintptr_t>(op.b + row * op.n + start) |
                         reinterpret_cast<uintptr_t>(op.out + row * op.n + start) |
                         (F == kElem ? reinterpret_cast<uintptr_t>(op.a + row * op.a_rs + start)
                                     : 0);
  const bool vec = left >= kTile && (addr & 15) == 0;
  load_tile<F, kItems>(op, row, start, vec, sa, sb);
  const double a_row = F == kRow ? a_at<F>(op, row, 0) : op.a_const;
  __syncthreads();
  // this thread's items j0 .. j0 + kItems - 1, composed in order
  const int j0 = threadIdx.x * kItems;
  if (op.y0 != nullptr && tile == 0 && threadIdx.x == 0) {  // the row's first map
    const double a0 = F == kElem ? sa[pad(0)] : a_row;
    sb[pad(0)] = __dadd_rn(sb[pad(0)], __dmul_rn(a0, op.y0[row]));
  }
  Map t = identity();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = j0 + i;
    const double ai = F == kElem ? sa[pad(j)] : a_row;
    t = then(t, Map{ai, sb[pad(j)]});
  }
  Map total;
  const Map before = block_exclusive(t, warp_tot, &total);
  if (threadIdx.x < 32) {
    const int r = static_cast<int>(tile & 31);
    const long long grp = tile >> 5;
    if (threadIdx.x == 0 && r < 31 && tile + 1 < tiles) {  // a later tile of the group reads it
      put(lb.tile + 2 * g, total.a);
      put(lb.tile + 2 * g + 1, total.b);
    }
    int walked = 0;
    const double carry = look_back(lb, g, r, grp, row * groups_of(tiles) + grp, total, &walked);
    if (threadIdx.x == 0) {
      s_carry = carry;
      if (dist != nullptr) dist[g] = walked;
    }
  }
  __syncthreads();
  double y = apply(before, s_carry);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = j0 + i;
    const double ai = F == kElem ? sa[pad(j)] : a_row;
    y = apply(Map{ai, sb[pad(j)]}, y);
    sb[pad(j)] = y;  // each thread rewrites only its own items
  }
  __syncthreads();
  double* out = op.out + row * op.n + start;
  if (vec) {
#pragma unroll
    for (int i = 0; i < kItems / 2; ++i) {
      const int j = 2 * (i * kThreads + threadIdx.x);
      *reinterpret_cast<double2*>(out + j) = make_double2(sb[pad(j)], sb[pad(j + 1)]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = i * kThreads + threadIdx.x;
      if (j < left) out[j] = sb[pad(j)];
    }
  }
}

long long round_up(long long x) { return (x + kAlign - 1) / kAlign * kAlign; }

long long tiles_of(long long n, int tile) { return (n + tile - 1) / tile; }

// Scratch, for tiles of kMinTile (the most tiles any form makes): the ticket,
// the tiles' words and the groups' words, all zeroed each call.
long long scratch_layout(long long rows, long long n, LookBack* lb, char* base) {
  const long long tiles = rows * tiles_of(n, kMinTile);
  const long long groups = rows * groups_of(tiles_of(n, kMinTile));
  const long long tile = kAlign, group = tile + round_up(2 * sizeof(Word) * tiles);
  if (lb != nullptr) {
    lb->ticket = reinterpret_cast<unsigned long long*>(base);
    lb->tile = reinterpret_cast<Word*>(base + tile);
    lb->group = reinterpret_cast<Word*>(base + group);
  }
  return group + round_up(3 * sizeof(Word) * groups);
}

template <int F>
cudaError_t launch(const Operands& op, const LookBack& lb, long long rows, int* dist,
                   cudaStream_t s) {
  if (smem_of(F) > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        recurrence_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_of(F));
    if (e != cudaSuccess) return e;
  }
  const long long tiles = tiles_of(op.n, kThreads * items_of(F));
  recurrence_kernel<F><<<static_cast<unsigned>(rows * tiles), kThreads, smem_of(F), s>>>(
      op, lb, tiles, dist);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch that fmk_linear_recurrence needs for `rows` rows of n
// values (256-byte aligned).
extern "C" long long fmk_recurrence_scratch_bytes(long long rows, long long n) {
  return scratch_layout(rows, n, nullptr, nullptr);
}

// Kernel R: out[r, t] = a[r, t] * out[r, t-1] + b[r, t] for each of `rows`
// contiguous rows of n float64 values, out[r, -1] = 0, with b[r, 0] taken as
// b[r, 0] + a[r, 0] * y0[r] when y0 is not null. a[r, t] is a[r * a_rs + t *
// a_cs], or a_const when a is null. `scratch` holds
// fmk_recurrence_scratch_bytes(rows, n) bytes, 256-byte aligned; the call
// zeroes its ticket and status words first, on the same stream. `dist` is
// null, or one int a tile: rows * ceil(n / 2048) where a comes a value an
// element, rows * ceil(n / 8192) else. Returns cudaGetLastError().
extern "C" int fmk_linear_recurrence(const double* a, double a_const, long long a_rs,
                                     int a_cs, const double* b, const double* y0,
                                     double* out, void* scratch, long long rows,
                                     long long n, int* dist, void* stream) {
  if (n <= 0 || rows <= 0) return 0;
  if (rows > 0x7fffffffLL / tiles_of(n, kMinTile) || (a_cs != 0 && a_cs != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LookBack lb;
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0, scratch_layout(rows, n, &lb, static_cast<char*>(scratch)), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Operands op{a, a_const, a_rs, b, y0, out, n};
  if (a == nullptr) return static_cast<int>(launch<kConst>(op, lb, rows, dist, s));
  if (a_cs == 0) return static_cast<int>(launch<kRow>(op, lb, rows, dist, s));
  return static_cast<int>(launch<kElem>(op, lb, rows, dist, s));
}
