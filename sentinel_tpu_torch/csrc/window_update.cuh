// The window update's device phases (K2), shared by window_update.cu and
// by the token decision's commit (token_decide.cu).
//
// An update (row, ts, six deltas, an RT sample) touches the bucket cell
// row * B + (ts / wlen) % B, which is the flat index of that cell in the
// state, in the window w = ts - ts % wlen. The state is updated in place
// in two phases, with a barrier between them (a kernel boundary, or
// __syncthreads() inside one block):
//
//   1. newest:  old = atomicMax(&window_start[cell], w). Whoever raises a
//               cell's window start (old < w) rolls the bucket: counts to
//               0, min RT to max_rt. Every raiser writes the same values,
//               and some update raises the cell iff the batch's newest
//               window is newer than the stored one, so the roll happens
//               exactly when the JAX code's `newer` branch does.
//   2. add:     where w == window_start[cell] (the cell's window after the
//               batch), wrapping atomicAdd of the deltas and atomicMin of
//               the RT sample. An update of an older window is dropped.
//
// A same-window bucket thus adds, a newer one rolls and then takes the
// sum, an older update drops, and a rolled bucket's min RT is
// min(samples, max_rt): what the JAX sort-and-segment update writes.
// Integer max, min and wrapping add are order-free, so the result is bit
// for bit the same whatever order the atomics land in. Each phase first
// reduces across the warp (__match_any_sync + __reduce_*_sync), so a hot
// cell costs one atomic per warp, not one per update.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace wu {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int NE = 6;  // metric events (metrics/events.py)

// The window state of one geometry, updated in place.
struct Window {
  int* counts;        // [rows * B, NE]
  int* min_rt;        // [rows * B]
  int* window_start;  // [rows * B]
  int n_rows, nb, wlen, max_rt;
};

// The cell an update touches, or -1 when it is masked out or its row is
// outside [0, rows). ts >= 0 (ms relative to the epoch).
__device__ __forceinline__ int cell_of(const Window& s, bool in, int row, int ts) {
  return (in && row >= 0 && row < s.n_rows) ? row * s.nb + (ts / s.wlen) % s.nb : -1;
}

__device__ __forceinline__ int window_of(const Window& s, int ts) { return ts - ts % s.wlen; }

__device__ __forceinline__ bool warp_leader(unsigned grp) { return (int)(threadIdx.x & 31) == __ffs(grp) - 1; }

// Phase 1 for one update per lane. All 32 lanes of the warp call it.
__device__ __forceinline__ void newest(const Window& s, int cell, int w) {
  bool act = cell >= 0;
  unsigned am = __ballot_sync(FULL_MASK, act);
  if (!act) return;
  unsigned grp = __match_any_sync(am, cell);
  int m = __reduce_max_sync(grp, w);
  if (warp_leader(grp) && atomicMax(&s.window_start[cell], m) < m) {
    int64_t c = (int64_t)cell * NE;
#pragma unroll
    for (int e = 0; e < NE; ++e) s.counts[c + e] = 0;
    s.min_rt[cell] = s.max_rt;
  }
}

// Phase 2 for one update per lane. All 32 lanes of the warp call it;
// `has_rt` is the same on every lane.
__device__ __forceinline__ void add(const Window& s, int cell, int w, const int (&d)[NE], bool has_rt, int rt) {
  bool act = cell >= 0 && w == s.window_start[cell];
  unsigned am = __ballot_sync(FULL_MASK, act);
  if (!act) return;
  unsigned grp = __match_any_sync(am, cell);
  bool leader = warp_leader(grp);
  int64_t c = (int64_t)cell * NE;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    int v = __reduce_add_sync(grp, d[e]);
    if (leader && v != 0) atomicAdd(&s.counts[c + e], v);
  }
  if (has_rt) {
    int r = __reduce_min_sync(grp, rt);
    if (leader) atomicMin(&s.min_rt[cell], r);
  }
}

}  // namespace wu
