// Kernel E: the event-jump boundary scans of the information-driven bars.
//
// Not a TPU kernel: the JAX package runs these scans as XLA while_loops
// (finmlkit_tpu/bar/indexers.py _volume_boundaries :368, _cusum_boundaries
// :508, _info_bar_boundaries :680). PyTorch has no loop that stays on the
// device, so a literal port would read the card once per chunk and per bar;
// this kernel runs the whole scan in one launch and the host reads the count
// once. One mode argument selects the bar type:
//   0 CUSUM      s+ = max(0, s+ + r), s- = min(0, s- + r); a trade i closes
//                when can_close[i] and (s+ >= lam[i] or s- <= -lam[i]); s+
//                takes precedence and only the triggered side resets;
//   1 imbalance  |in-bar sum of w| >= theta;
//   2 run        max(in-bar sum of buy w, in-bar sum of sell |w|) >= theta;
//                in modes 1 and 2 theta = E[T] * E[rate], whose EMAs update
//                at each close from the bar's length and statistic;
//   3 volume     the int64 in-bar sum of amount units >= thr, reset to zero.
//
// Design: ONE thread block walks the stream in tiles of kTile trades, from
// `start`. Every thread holds kItems consecutive trades. Each in-bar statistic
// is a prefix under an associative combine (a sum, a pair of sums, or for
// CUSUM the composition of the maps s -> max(a, s + b) and s -> min(c, s + b)),
// so a block-wide scan from the carried state gives every trade's statistic;
// a block-wide min finds the first closing trade. After a close the state
// resets and the same tile is scanned again from the next trade, with the
// trades up to the close masked out; without one the state at the tile's end
// is carried to the next tile, whose loads were issued before this tile's
// scans. Work: one block scan per tile and one per bar.
//
// Bound: the latency of one SM, not device memory: a block scan and a min per
// tile and per bar, about 19,000 tiles and 20,000-45,000 bars on a month.
// The EMA updates use explicitly rounded operations (no fused multiply-add),
// so that they round as the plain PyTorch version and XLA do.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 trades per tile
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const double* x;                 // CUSUM log returns, or info weights
  const double* lam;               // CUSUM per-trade thresholds
  const unsigned char* can_close;  // CUSUM same-timestamp rule mask
  const long long* units;          // volume amount units
  long long n, start;              // stream length; first trade checked
  double e_t, e_r, alpha_t, alpha_r;  // info: E0[T], E0[rate], EMA rates
  long long thr;                   // volume: the threshold in amount units
  long long* out;                  // close indices
  long long max_out;
  long long* count;                // number of closes written
};

__device__ __forceinline__ double shfl_up(double x, int o) {
  return __shfl_up_sync(kFull, x, o);
}
__device__ __forceinline__ long long shfl_up(long long x, int o) {
  return __shfl_up_sync(kFull, x, o);
}

// ---- CUSUM ---------------------------------------------------------------
struct Cusum {
  // s+ -> max(a, s+ + b), s- -> min(c, s- + b)
  struct E { double a, c, b; };
  struct In { double r, lam; unsigned char cc; };
  struct State { double sp, sn; };
  struct Hit { State next; };

  __device__ static E identity() { return {-INFINITY, INFINITY, 0.0}; }
  __device__ static E elem(const In& v) { return {0.0, 0.0, v.r}; }
  // x then y
  __device__ static E combine(const E& x, const E& y) {
    return {fmax(y.a, x.a + y.b), fmin(y.c, x.c + y.b), x.b + y.b};
  }
  __device__ static E shfl(const E& x, int o) {
    return {shfl_up(x.a, o), shfl_up(x.c, o), shfl_up(x.b, o)};
  }
  __device__ static State init(const Args&) { return {0.0, 0.0}; }
  __device__ static In load(const Args& a, long long g) {
    if (g >= a.n) return {0.0, INFINITY, 0};
    return {a.x[g], a.lam[g], a.can_close[g]};
  }
  // Whether trade g closes; if so, *hit is the state after the close.
  __device__ static bool closes(const E& p, const In& v, const State& s,
                                long long, const Args&, Hit* hit) {
    const double sp = fmax(p.a, s.sp + p.b);
    const double sn = fmin(p.c, s.sn + p.b);
    if (!v.cc) return false;
    if (sp >= v.lam) { hit->next = {0.0, sn}; return true; }
    if (sn <= -v.lam) { hit->next = {sp, 0.0}; return true; }
    return false;
  }
  __device__ static State at_end(const E& p, const State& s) {
    return {fmax(p.a, s.sp + p.b), fmin(p.c, s.sn + p.b)};
  }
};

// ---- imbalance and run ---------------------------------------------------
struct InfoState { double cb, cs, e_t, e_r; long long open; };

__device__ InfoState info_close(const InfoState& s, double stat, long long g,
                                const Args& a) {
  // (1 - alpha) * e + alpha * x, rounded step by step
  const double t_bar = static_cast<double>(g - s.open);
  const double rate = __ddiv_rn(stat, fmax(t_bar, 1.0));
  const double e_t = __dadd_rn(__dmul_rn(__dsub_rn(1.0, a.alpha_t), s.e_t),
                               __dmul_rn(a.alpha_t, t_bar));
  const double e_r = __dadd_rn(__dmul_rn(__dsub_rn(1.0, a.alpha_r), s.e_r),
                               __dmul_rn(a.alpha_r, rate));
  return {0.0, 0.0, e_t, e_r, g};
}

struct Imbalance {
  using E = double;
  struct In { double w; };
  using State = InfoState;
  struct Hit { State next; };

  __device__ static E identity() { return 0.0; }
  __device__ static E elem(const In& v) { return v.w; }
  __device__ static E combine(E x, E y) { return x + y; }
  __device__ static E shfl(E x, int o) { return shfl_up(x, o); }
  __device__ static State init(const Args& a) {
    return {0.0, 0.0, a.e_t, a.e_r, 0};
  }
  __device__ static In load(const Args& a, long long g) {
    return {g < a.n ? a.x[g] : 0.0};
  }
  __device__ static bool closes(E p, const In&, const State& s, long long g,
                                const Args& a, Hit* hit) {
    const double stat = fabs(s.cb + p);
    if (stat < __dmul_rn(s.e_t, s.e_r)) return false;
    hit->next = info_close(s, stat, g, a);
    return true;
  }
  __device__ static State at_end(E p, const State& s) {
    return {s.cb + p, 0.0, s.e_t, s.e_r, s.open};
  }
};

struct Run {
  struct E { double b, s; };
  struct In { double w; };
  using State = InfoState;
  struct Hit { State next; };

  __device__ static E identity() { return {0.0, 0.0}; }
  __device__ static E elem(const In& v) {
    return {v.w > 0.0 ? v.w : 0.0, v.w < 0.0 ? -v.w : 0.0};
  }
  __device__ static E combine(const E& x, const E& y) {
    return {x.b + y.b, x.s + y.s};
  }
  __device__ static E shfl(const E& x, int o) {
    return {shfl_up(x.b, o), shfl_up(x.s, o)};
  }
  __device__ static State init(const Args& a) {
    return {0.0, 0.0, a.e_t, a.e_r, 0};
  }
  __device__ static In load(const Args& a, long long g) {
    return {g < a.n ? a.x[g] : 0.0};
  }
  __device__ static bool closes(const E& p, const In&, const State& s,
                                long long g, const Args& a, Hit* hit) {
    const double stat = fmax(s.cb + p.b, s.cs + p.s);
    if (stat < __dmul_rn(s.e_t, s.e_r)) return false;
    hit->next = info_close(s, stat, g, a);
    return true;
  }
  __device__ static State at_end(const E& p, const State& s) {
    return {s.cb + p.b, s.cs + p.s, s.e_t, s.e_r, s.open};
  }
};

// ---- volume ----------------------------------------------------------------
struct Volume {
  using E = long long;
  struct In { long long u; };
  struct State { long long carry; };
  struct Hit { State next; };

  __device__ static E identity() { return 0; }
  __device__ static E elem(const In& v) { return v.u; }
  __device__ static E combine(E x, E y) { return x + y; }
  __device__ static E shfl(E x, int o) { return shfl_up(x, o); }
  // trade 0 opens the first bar and counts toward it
  __device__ static State init(const Args& a) { return {a.units[0]}; }
  __device__ static In load(const Args& a, long long g) {
    return {g < a.n ? a.units[g] : 0};
  }
  __device__ static bool closes(E p, const In&, const State& s, long long,
                                const Args& a, Hit* hit) {
    if (s.carry + p < a.thr) return false;
    hit->next = {0};
    return true;
  }
  __device__ static State at_end(E p, const State& s) { return {s.carry + p}; }
};

// Block-wide exclusive scan of one value per thread under M::combine (not
// commutative: the earlier operand goes left). Every thread must call it.
template <class M>
__device__ typename M::E block_exclusive_scan(typename M::E v,
                                              typename M::E* warp_tot) {
  using E = typename M::E;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  E x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const E y = M::shfl(x, o);
    if (lane >= o) x = M::combine(y, x);
  }
  E excl = M::shfl(x, 1);
  if (lane == 0) excl = M::identity();
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    E w = lane < kWarps ? warp_tot[lane] : M::identity();
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const E y = M::shfl(w, o);
      if (lane >= o) w = M::combine(y, w);
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const E base = warp > 0 ? warp_tot[warp - 1] : M::identity();
  __syncthreads();  // warp_tot is reused by the next call
  return M::combine(base, excl);
}

__device__ int block_min(int v, int* warp_min) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = __reduce_min_sync(kFull, v);
  if (lane == 0) warp_min[warp] = v;
  __syncthreads();
  int m = warp_min[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = min(m, warp_min[w]);
  __syncthreads();
  return m;
}

template <class M>
__global__ void __launch_bounds__(kThreads) event_scan_kernel(Args a) {
  using E = typename M::E;
  using In = typename M::In;
  using State = typename M::State;
  __shared__ State st;  // the state before the current segment's first trade
  __shared__ E warp_tot[kWarps];
  __shared__ int warp_min[kWarps];
  const int t = threadIdx.x;
  if (t == 0) st = M::init(a);
  In cur[kItems], nxt[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) cur[i] = M::load(a, a.start + t * kItems + i);
  __syncthreads();
  long long k = 0;
  for (long long pos = a.start; pos < a.n && k < a.max_out; pos += kTile) {
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      nxt[i] = M::load(a, pos + kTile + t * kItems + i);
    const int len = static_cast<int>(min(static_cast<long long>(kTile), a.n - pos));
    int seg = 0;  // trades of the tile before seg belong to closed bars
    while (true) {
      const State s = st;
      E agg = M::identity();
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int j = t * kItems + i;
        if (j >= seg && j < len) agg = M::combine(agg, M::elem(cur[i]));
      }
      E run = block_exclusive_scan<M>(agg, warp_tot);
      int first = kTile;
      typename M::Hit hit;
      State end{};
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int j = t * kItems + i;
        if (j >= seg && j < len) {
          run = M::combine(run, M::elem(cur[i]));
          if (first == kTile && M::closes(run, cur[i], s, pos + j, a, &hit)) first = j;
          if (j == len - 1) end = M::at_end(run, s);
        }
      }
      const int e = block_min(first, warp_min);
      if (e < kTile) {
        if (first == e) {
          st = hit.next;
          a.out[k] = pos + e;
        }
        ++k;
        __syncthreads();
        seg = e + 1;
        if (seg >= len || k >= a.max_out) break;
      } else {
        if (t * kItems <= len - 1 && len - 1 < (t + 1) * kItems) st = end;
        __syncthreads();
        break;
      }
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) cur[i] = nxt[i];
  }
  if (t == 0) *a.count = k;
}

template <class M>
int launch(const Args& a, cudaStream_t stream) {
  event_scan_kernel<M><<<1, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel E. mode: 0 CUSUM (x = log returns, lam, can_close), 1 imbalance and
// 2 run (x = weights, e_t / e_r / alpha_t / alpha_r), 3 volume (units, thr;
// the first bar holds trade 0). Checks trades start .. n-1 (start < n) and
// writes at most max_out close indices to out and their number to count[0].
// Returns cudaGetLastError().
extern "C" int fmk_event_scan(int mode, const void* x, const void* lam,
                              const void* can_close, const void* units,
                              long long n, long long start, double e_t,
                              double e_r, double alpha_t, double alpha_r,
                              long long thr, void* out,
                              long long max_out, void* count, void* stream) {
  Args a{static_cast<const double*>(x), static_cast<const double*>(lam),
         static_cast<const unsigned char*>(can_close),
         static_cast<const long long*>(units), n, start, e_t, e_r, alpha_t,
         alpha_r, thr, static_cast<long long*>(out), max_out,
         static_cast<long long*>(count)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<Cusum>(a, s);
    case 1: return launch<Imbalance>(a, s);
    case 2: return launch<Run>(a, s);
    case 3: return launch<Volume>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
