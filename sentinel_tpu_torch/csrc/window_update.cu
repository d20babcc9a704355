// Window update for Hopper (sm_90a): the port of
// sentinel_tpu/metrics/metric_array.py:update (the LeapArray
// currentWindow + add path over a whole batch) and of the thread-gauge
// scatter in sentinel_tpu/metrics/nodes.py:apply_updates.
//
// One C call per update (window_update) makes two launches, one per
// phase of window_update.cuh: wu_newest (the newest window per cell, and
// the roll), then wu_add (the sums and the min RT in that window). The
// state is updated in place; nothing is sorted and nothing is allocated.
// thread_gauge_add is the thread-gauge scatter (tg_add).
//
// What bounds it: bytes. Per update it reads the batch (row, ts, mask,
// six deltas, RT: about 37 B) twice, once per phase, and each touched
// cell reads and writes its 32 B of window state. So the design keeps
// each phase a single coalesced pass over the batch, with one atomic per
// warp and cell.
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

__global__ void tg_add(const int* __restrict__ rows, const int* __restrict__ thr,
                       const uint8_t* __restrict__ mask, int n, int n_rows,
                       int* __restrict__ threads) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int r = -1, v = 0;
  if (i < n && mask[i]) {
    r = rows[i];
    v = thr[i];
  }
  bool act = r >= 0 && r < n_rows && v != 0;
  unsigned am = __ballot_sync(FULL_MASK, act);
  if (!act) return;
  unsigned grp = __match_any_sync(am, r);
  int sum = __reduce_add_sync(grp, v);
  if (lane_id() == __ffs(grp) - 1 && sum != 0) atomicAdd(&threads[r], sum);
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

// Thread gauge: threads[rows[i]] += thr[i] for masked-in rows in range.
int thread_gauge_add(const int* rows, const int* thr, const uint8_t* mask, int n, int n_rows,
                     int* threads, void* stream) {
  if (n <= 0) return 0;
  tg_add<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(rows, thr, mask, n, n_rows, threads);
  return (int)cudaGetLastError();
}

}  // extern "C"
