// The windowed reads of the stats for Hopper (sm_90a): K3, the port of
// sentinel_tpu/metrics/metric_array.py:window_sums and window_min_rt
// (:205/:219, _valid_mask :199), and the rest of the stats read that
// sentinel_tpu/runtime/engine.py:Engine._all_stats_arrays (:4537) takes
// in one device round trip with them: the thread gauge, and
// occupied_in_window and waiting_tokens (sentinel_tpu/metrics/nodes.py
// :141/:192) of the future slab.
//
// Two C entry points share one device body (read_window):
//
// - window_reduce: one window's sums [R', NE] and, optionally, its min RT
//   [R'], over every row or over R' gathered rows (clipped into [0, R)).
//   metric_array.window_reduce (window_sums, window_min_rt) and the token
//   service's flow_stats call it.
// - row_stats: for R' gathered rows, one int32 record of RS_WIDTH a row
//   (nodes.rows_stats, Engine.rows_stats): the second window's NE sums,
//   the minute window's NE sums, the second window's min RT, the gauge,
//   the slab's occupied-in-window tokens (age = now - future_ws, wrapping,
//   counted while 0 <= age <= the second interval) and its waiting tokens
//   (future_ws > now). One launch, and the caller copies the records back
//   in one copy.
//
// A bucket counts while now - window_start <= interval (wrapping int32);
// sums wrap in int32; the min RT of a row with no counting bucket is
// max_rt. Exactly the JAX reductions, whatever the order of the adds.
//
// Mapping: a group of G lanes of one warp reads one row. For
// window_reduce G is the power of two at or above half the bucket count
// (at most 32; one lane a row for the second window's 2 buckets): lane j
// of the group reads buckets j, j + G, ... (start, counts and min RT at
// once, keeping those of counting buckets), and xor shuffles within the
// group leave every lane with the totals; the group's first lanes write
// the row's outputs side by side. row_stats takes a whole warp a row
// (G = 32: the minute window's 60 buckets, two a lane); the second window
// and the slab are read by the lanes below their bucket count and reduced
// over those lanes only, then broadcast.
//
// What bounds it: bytes. A row of window_reduce needs B window starts and
// the NE counts (and the min RT) of its counting buckets and writes NE (+1)
// int32; a row of row_stats needs the second window (up to 64 B), the
// minute window (60 starts and up to 60 x NE counts, 1,680 B), the gauge
// (4 B) and the slab (16 B) and writes 64 B. The kernel reads the counts
// of buckets that do not count too (the sectors they share with counting
// ones are read anyway): that spares a round trip a row.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int NE = 6;         // metric events (metrics/events.py)
constexpr int RS_WIDTH = 16;  // row_stats' record (metrics/nodes.py RS_*)

__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wrap_sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

struct Window {  // metric_array.MetricArrayState of one geometry
  const int* counts;  // [R, B, NE]
  const int* min_rt;  // [R, B]
  const int* ws;      // [R, B]
  int nb, interval, max_rt;
};

// Sum (SUM) or min over the lanes [0, P) of each aligned run of P lanes;
// the result lands on every lane of the run.
template <int P, bool SUM>
__device__ __forceinline__ int group_reduce(int v) {
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1) {
    int o = __shfl_xor_sync(FULL_MASK, v, off);
    v = SUM ? wrap_add(v, o) : min(v, o);
  }
  return v;
}

// This lane's share (lane `sub` of a group of G) of row `row`'s buckets:
// the NE sums of the counting ones, and the min over its buckets of the
// min RT where the bucket counts, else max_rt (JAX's where, then min). A
// bucket's start, counts (three 8-byte loads: the wrapper checks that the
// counts are 8-byte aligned) and min RT are loaded together, so that no
// load waits on another; what does not count is dropped. A lane that reads
// no row or no bucket keeps the identities (0, INT_MAX); every lane of the
// warp calls it, so the shuffles that follow see the whole warp.
template <int G>
__device__ __forceinline__ void read_window(const Window& w, int64_t row, int now, int sub, bool in, bool with_min,
                                            int (&sum)[NE], int& mn) {
#pragma unroll
  for (int e = 0; e < NE; ++e) sum[e] = 0;
  mn = INT_MAX;
  if (!in) return;
  for (int b = sub; b < w.nb; b += G) {
    const int64_t c = row * w.nb + b;
    const int ws = __ldg(w.ws + c);
    const int2* cnt = reinterpret_cast<const int2*>(w.counts + c * NE);
    int2 v[NE / 2];
#pragma unroll
    for (int k = 0; k < NE / 2; ++k) v[k] = __ldg(cnt + k);
    const int m = with_min ? __ldg(w.min_rt + c) : w.max_rt;
    const bool counts = wrap_sub(now, ws) <= w.interval;
    if (counts) {
#pragma unroll
      for (int k = 0; k < NE / 2; ++k) {
        sum[2 * k] = wrap_add(sum[2 * k], v[k].x);
        sum[2 * k + 1] = wrap_add(sum[2 * k + 1], v[k].y);
      }
    }
    mn = min(mn, counts ? m : w.max_rt);
  }
}

// v[k] for a k known only at run time, without local memory.
template <int W>
__device__ __forceinline__ int pick(const int (&v)[W], int k) {
  int out = v[0];
#pragma unroll
  for (int i = 1; i < W; ++i)
    if (k == i) out = v[i];
  return out;
}

template <int G>
__global__ void __launch_bounds__(THREADS) wr_rows(Window w, const int* __restrict__ rows, int n_out, int n_rows,
                                                   int now, int* __restrict__ sums, int* __restrict__ mins) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t r = t / G;
  const int sub = (int)(t % G);
  const bool in = r < n_out;
  const int64_t row = !in ? 0 : rows ? clampi(__ldg(rows + r), 0, n_rows - 1) : r;
  int sum[NE], mn;
  read_window<G>(w, row, now, sub, in, mins != nullptr, sum, mn);
#pragma unroll
  for (int e = 0; e < NE; ++e) sum[e] = group_reduce<G, true>(sum[e]);
  if (mins) mn = group_reduce<G, false>(mn);
  if (!in) return;
  for (int e = sub; e < NE; e += G) sums[r * NE + e] = pick(sum, e);
  if (mins && sub == 0) mins[r] = mn;
}

}  // namespace

// Everything one row_stats call reads and writes; metrics/nodes.py fills
// the same layout (pointers first, then the ints). At file scope, so that
// the C entry point taking it keeps external linkage.
struct RsArgs {
  const int* sec_counts;  // the second window [R, Bs, NE], [R, Bs], [R, Bs]
  const int* sec_min_rt;
  const int* sec_ws;
  const int* min_counts;  // the minute window [R, Bm, NE], [R, Bm]
  const int* min_ws;
  const int* threads;  // [R] the gauge
  const int* fpass;    // the future slab [R, Bf], [R, Bf]
  const int* fws;
  const int* rows;  // [n_out], clipped into [0, R)
  int* out;         // [n_out, RS_WIDTH]
  int n_out, n_rows, sec_nb, sec_interval, sec_max_rt, min_nb, min_interval, slab_b, now;
};

namespace {

// One warp a row. The second window's buckets and the slab's cells sit on
// lanes [0, P2) (P2 = 2 for the default 2 x 500 ms geometry): reduced over
// those lanes, then read from lane 0 of the warp.
template <int P2>
__global__ void __launch_bounds__(THREADS) rs_rows(RsArgs a) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t r = t >> 5;
  const int lane = threadIdx.x & 31;
  const bool in = r < a.n_out;
  const int64_t row = in ? clampi(__ldg(a.rows + r), 0, a.n_rows - 1) : 0;
  const Window sec{a.sec_counts, a.sec_min_rt, a.sec_ws, a.sec_nb, a.sec_interval, a.sec_max_rt};
  const Window minute{a.min_counts, nullptr, a.min_ws, a.min_nb, a.min_interval, 0};
  int rec[RS_WIDTH];
  int s_sum[NE], m_sum[NE], mn, unused;
  read_window<32>(minute, row, a.now, lane, in, false, m_sum, unused);
  read_window<P2>(sec, row, a.now, lane, in && lane < P2, true, s_sum, mn);
  int occ = 0, wait = 0;
  if (in && lane < P2) {
    for (int b = lane; b < a.slab_b; b += P2) {
      const int64_t c = row * a.slab_b + b;
      const int fw = __ldg(a.fws + c), fp = __ldg(a.fpass + c);
      const int age = wrap_sub(a.now, fw);
      if (age >= 0 && age <= a.sec_interval) occ = wrap_add(occ, fp);
      if (fw > a.now) wait = wrap_add(wait, fp);
    }
  }
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    rec[e] = __shfl_sync(FULL_MASK, group_reduce<P2, true>(s_sum[e]), 0);
    rec[NE + e] = group_reduce<32, true>(m_sum[e]);
  }
  rec[2 * NE] = __shfl_sync(FULL_MASK, group_reduce<P2, false>(mn), 0);
  rec[2 * NE + 2] = __shfl_sync(FULL_MASK, group_reduce<P2, true>(occ), 0);
  rec[2 * NE + 3] = __shfl_sync(FULL_MASK, group_reduce<P2, true>(wait), 0);
  if (!in || lane >= RS_WIDTH) return;
  rec[2 * NE + 1] = lane == 2 * NE + 1 ? __ldg(a.threads + row) : 0;
  a.out[r * RS_WIDTH + lane] = pick(rec, lane);
}

inline unsigned blocks_for(int64_t threads) { return (unsigned)((threads + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// K3: one window's sums (and min RT with `mins`) over n_out rows, every
// row when `rows` is null; any nb >= 1. Returns the CUDA error code of
// the launch.
int window_reduce(const int* counts, const int* min_rt, const int* ws, int nb, int interval, int max_rt,
                  const int* rows, int n_out, int n_rows, int now, int* sums, int* mins, void* stream) {
  if (n_out <= 0) return 0;
  if (nb <= 0 || n_rows <= 0 || (!rows && n_out > n_rows)) return (int)cudaErrorInvalidValue;
  const Window w{counts, min_rt, ws, nb, interval, max_rt};
  cudaStream_t st = (cudaStream_t)stream;
  int g = 1;  // lanes a row: up to two buckets a lane
  while (2 * g < nb && g < 32) g <<= 1;
  const unsigned blocks = blocks_for((int64_t)n_out * g);
  switch (g) {
    case 1: wr_rows<1><<<blocks, THREADS, 0, st>>>(w, rows, n_out, n_rows, now, sums, mins); break;
    case 2: wr_rows<2><<<blocks, THREADS, 0, st>>>(w, rows, n_out, n_rows, now, sums, mins); break;
    case 4: wr_rows<4><<<blocks, THREADS, 0, st>>>(w, rows, n_out, n_rows, now, sums, mins); break;
    case 8: wr_rows<8><<<blocks, THREADS, 0, st>>>(w, rows, n_out, n_rows, now, sums, mins); break;
    case 16: wr_rows<16><<<blocks, THREADS, 0, st>>>(w, rows, n_out, n_rows, now, sums, mins); break;
    default: wr_rows<32><<<blocks, THREADS, 0, st>>>(w, rows, n_out, n_rows, now, sums, mins); break;
  }
  return (int)cudaGetLastError();
}

// K3 with the rest of the stats read: one record a gathered row (see the
// header); `args` is read on the host. The second window and the slab are
// read by their first 2, 8 or 32 lanes, by their larger bucket count.
int row_stats(const RsArgs* args, void* stream) {
  const RsArgs a = *args;
  if (a.n_out <= 0) return 0;
  if (a.n_rows <= 0 || a.sec_nb <= 0 || a.min_nb <= 0 || a.slab_b < 0) return (int)cudaErrorInvalidValue;
  const int span = a.sec_nb > a.slab_b ? a.sec_nb : a.slab_b;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = blocks_for((int64_t)a.n_out * 32);
  if (span <= 2) {
    rs_rows<2><<<blocks, THREADS, 0, st>>>(a);
  } else if (span <= 8) {
    rs_rows<8><<<blocks, THREADS, 0, st>>>(a);
  } else {
    rs_rows<32><<<blocks, THREADS, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
