// Window update for Hopper (sm_90a): the port of
// sentinel_tpu/metrics/metric_array.py:update (the LeapArray
// currentWindow + add path over a whole batch) and of
// sentinel_tpu/metrics/nodes.py:apply_updates (both windows' updates and
// the thread-gauge scatter).
//
// Two C calls, two launches each, one per phase of window_update.cuh:
//
//   - window_update (K2 alone, for one window): wu_newest (the newest
//     window per cell, and the roll), then wu_add (the sums and the min RT
//     in that window);
//   - apply_updates (the engine's accounting): au_newest takes each
//     update's second-window cell and minute-window cell through
//     wu::newest, and au_add both windows' sums and min RT through wu::add
//     (the minute window with its own deltas where given) and the thread
//     gauge's warp-combined add.
//
// The state is updated in place; nothing is sorted and nothing is
// allocated.
//
// What bounds it: bytes. Per update it reads the batch (row, ts, mask,
// six deltas, RT: about 37 B) once per launch, and each touched cell
// reads and writes its 32 B of window state. So the design keeps each
// phase a single coalesced pass over the batch, with one atomic per warp
// and cell; apply_updates reads the batch twice where three calls read it
// five times.
//
// Arithmetic that may overflow int32 is done in unsigned, where it wraps
// as the JAX int32 arithmetic does (atomicAdd and the warp sums wrap).

#include "window_update.cuh"

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 256;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__global__ void wu_newest(const int* __restrict__ rows, const int* __restrict__ ts,
                          const uint8_t* __restrict__ mask, int n, wu::Window s) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int cell = -1, w = 0;
  if (i < n) {
    cell = wu::cell_of(s, mask[i] != 0, rows[i], ts[i]);
    w = wu::window_of(s, ts[i]);
  }
  wu::newest(s, cell, w);
}

__global__ void wu_add(const int* __restrict__ rows, const int* __restrict__ ts, const int* __restrict__ deltas,
                       const int* __restrict__ rt, const uint8_t* __restrict__ mask, int n, wu::Window s) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int cell = -1, w = 0, r = 0;
  int d[wu::NE] = {0, 0, 0, 0, 0, 0};
  if (i < n) {
    cell = wu::cell_of(s, mask[i] != 0, rows[i], ts[i]);
    w = wu::window_of(s, ts[i]);
    if (cell >= 0) {
#pragma unroll
      for (int e = 0; e < wu::NE; ++e) d[e] = deltas[(int64_t)i * wu::NE + e];
      if (rt != nullptr) r = rt[i];
    }
  }
  wu::add(s, cell, w, d, rt != nullptr, r);
}

__global__ void au_newest(const int* __restrict__ rows, const int* __restrict__ ts,
                          const uint8_t* __restrict__ mask, int n, wu::Window sec, wu::Window mnt) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int cs = -1, ws = 0, cm = -1, wm = 0;
  if (i < n) {
    bool in = mask[i] != 0;
    int r = rows[i], t = ts[i];
    cs = wu::cell_of(sec, in, r, t);
    ws = wu::window_of(sec, t);
    cm = wu::cell_of(mnt, in, r, t);
    wm = wu::window_of(mnt, t);
  }
  wu::newest(sec, cs, ws);
  wu::newest(mnt, cm, wm);
}

// `mdeltas` (the minute window's own deltas) may be null: the minute
// window then takes `deltas`.
__global__ void au_add(const int* __restrict__ rows, const int* __restrict__ ts, const int* __restrict__ deltas,
                       const int* __restrict__ mdeltas, const int* __restrict__ rt, const int* __restrict__ thr,
                       const uint8_t* __restrict__ mask, int n, wu::Window sec, wu::Window mnt,
                       int* __restrict__ threads) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int cs = -1, ws = 0, cm = -1, wm = 0, r = 0, row = -1, v = 0;
  int d[wu::NE] = {0, 0, 0, 0, 0, 0};
  int dm[wu::NE] = {0, 0, 0, 0, 0, 0};
  if (i < n) {
    bool in = mask[i] != 0;
    int t = ts[i];
    row = rows[i];
    cs = wu::cell_of(sec, in, row, t);
    ws = wu::window_of(sec, t);
    cm = wu::cell_of(mnt, in, row, t);
    wm = wu::window_of(mnt, t);
    if (cs >= 0) {  // both windows have the same rows: cs >= 0 iff cm >= 0
#pragma unroll
      for (int e = 0; e < wu::NE; ++e) d[e] = deltas[(int64_t)i * wu::NE + e];
#pragma unroll
      for (int e = 0; e < wu::NE; ++e) dm[e] = mdeltas != nullptr ? mdeltas[(int64_t)i * wu::NE + e] : d[e];
      if (rt != nullptr) r = rt[i];
    }
    if (in) v = thr[i];
  }
  wu::add(sec, cs, ws, d, rt != nullptr, r);
  wu::add(mnt, cm, wm, dm, rt != nullptr, r);
  // The thread gauge: threads[row] += thr for masked-in rows in range.
  bool act = row >= 0 && row < sec.n_rows && v != 0;
  unsigned am = __ballot_sync(FULL_MASK, act);
  if (!act) return;
  unsigned grp = __match_any_sync(am, row);
  int sum = __reduce_add_sync(grp, v);
  if (lane_id() == __ffs(grp) - 1 && sum != 0) atomicAdd(&threads[row], sum);
}

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

extern "C" {

// The whole update: both phases over the n updates. `rt` may be null
// (entries: a rolled bucket's min RT resets to max_rt). Masked-in rows
// outside [0, n_rows) are dropped. The state is updated in place.
// Returns the CUDA error code of the launches.
int window_update(const int* rows, const int* ts, const int* deltas, const int* rt, const uint8_t* mask, int n,
                  int n_rows, int nb, int wlen, int max_rt, int* counts, int* min_rt, int* window_start,
                  void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  wu::Window s{counts, min_rt, window_start, n_rows, nb, wlen, max_rt};
  wu_newest<<<blocks_for(n), THREADS, 0, st>>>(rows, ts, mask, n, s);
  wu_add<<<blocks_for(n), THREADS, 0, st>>>(rows, ts, deltas, rt, mask, n, s);
  return (int)cudaGetLastError();
}

// The engine's accounting update: both windows over the n updates (the
// minute window with `mdeltas` where not null) and the thread gauge
// threads[rows[i]] += thr[i], in two launches. The two windows have the
// same rows and max RT. `rt` may be null, as in window_update. Returns the
// CUDA error code of the launches.
int apply_updates(const int* rows, const int* ts, const int* deltas, const int* mdeltas, const int* rt,
                  const int* thr, const uint8_t* mask, int n, int n_rows, int max_rt, int s_nb, int s_wlen,
                  int* s_counts, int* s_min_rt, int* s_window_start, int m_nb, int m_wlen, int* m_counts,
                  int* m_min_rt, int* m_window_start, int* threads, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  wu::Window sec{s_counts, s_min_rt, s_window_start, n_rows, s_nb, s_wlen, max_rt};
  wu::Window mnt{m_counts, m_min_rt, m_window_start, n_rows, m_nb, m_wlen, max_rt};
  au_newest<<<blocks_for(n), THREADS, 0, st>>>(rows, ts, mask, n, sec, mnt);
  au_add<<<blocks_for(n), THREADS, 0, st>>>(rows, ts, deltas, mdeltas, rt, thr, mask, n, sec, mnt, threads);
  return (int)cudaGetLastError();
}

}  // extern "C"
