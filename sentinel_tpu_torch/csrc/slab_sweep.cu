// The matured-borrow sweep for Hopper (sm_90a): the port of
// sentinel_tpu/metrics/nodes.py:materialize_matured (K1).
//
// Over the future slab's cells (future_ws, future_pass [R * B]): a cell
// matures when the wrapping int32 age now - future_ws is >= 0; a matured
// cell still inside the interval (age <= interval) adds its tokens to
// PASS of the second-window bucket at the same flat index, rolling that
// bucket first (counts to 0, min RT to max_rt, the start to future_ws)
// when the borrowed window is newer than the bucket's; every matured cell
// is reset to (empty_ws, 0).
//
// What bounds it: bytes, and nearly all of them are reads. An empty cell
// is (empty_ws, 0) and is "matured" at any now >= empty_ws, so on the
// slab the engine meets on traffic without borrows every cell matures and
// none changes. The design therefore writes only what changes:
//
//   - each thread takes 4 cells with one 16-byte load of future_ws, and
//     loads future_pass only for a group that holds a matured cell;
//   - it stores the group's (future_ws, future_pass) only when some
//     matured cell is not already (empty_ws, 0);
//   - it touches the second window (counts, window_start, min_rt) only
//     for live cells.
//
// So a swept slab of 2^21 cells reads 16.8 MB and writes nothing. A base
// pointer that is not 16-byte aligned (a view at an odd row of [R, 2]),
// and the last group when the cell count is not a multiple of 4, take
// the same steps with scalar loads and stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NE = 6;  // metric events (metrics/events.py); PASS is event 0

struct Slab {
  int* fws;           // future_ws [n]
  int* fpass;         // future_pass [n]
  int* counts;        // second window counts [n, NE]
  int* min_rt;        // [n]
  int* window_start;  // [n]
  int64_t n;
  int now, interval, empty_ws, max_rt;
};

// A live matured cell: its tokens go to PASS of the bucket at the same
// index, which rolls first when the borrowed window is newer.
__device__ __forceinline__ void fold_live(const Slab& s, int64_t c, int fw, int fp) {
  int bws = s.window_start[c];
  if (fw > bws) {
    int* cnt = s.counts + c * NE;
    cnt[0] = fp;
#pragma unroll
    for (int e = 1; e < NE; ++e) cnt[e] = 0;
    s.window_start[c] = fw;
    s.min_rt[c] = s.max_rt;
  } else if (fw == bws && fp != 0) {
    int* pass = s.counts + c * NE;
    *pass = (int)((unsigned)*pass + (unsigned)fp);
  }
}

template <bool VEC>
__global__ void slab_sweep(Slab s) {
  int64_t c0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (c0 >= s.n) return;
  int cnt = s.n - c0 < 4 ? (int)(s.n - c0) : 4;
  bool vec = VEC && cnt == 4;
  int fw[4], fp[4];
  if (vec) {
    int4 v = *reinterpret_cast<const int4*>(s.fws + c0);
    fw[0] = v.x, fw[1] = v.y, fw[2] = v.z, fw[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) fw[k] = k < cnt ? s.fws[c0 + k] : 0;
  }
  int age[4];
  bool mat[4], any = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    age[k] = (int)((unsigned)s.now - (unsigned)fw[k]);  // wrapping int32, as the JAX code
    mat[k] = k < cnt && age[k] >= 0;
    any |= mat[k];
  }
  if (!any) return;
  if (vec) {
    int4 v = *reinterpret_cast<const int4*>(s.fpass + c0);
    fp[0] = v.x, fp[1] = v.y, fp[2] = v.z, fp[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) fp[k] = k < cnt ? s.fpass[c0 + k] : 0;
  }
  bool dirty = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!mat[k]) continue;
    if (age[k] <= s.interval) fold_live(s, c0 + k, fw[k], fp[k]);
    dirty |= fw[k] != s.empty_ws || fp[k] != 0;
    fw[k] = s.empty_ws;
    fp[k] = 0;
  }
  if (!dirty) return;
  if (vec) {
    *reinterpret_cast<int4*>(s.fws + c0) = make_int4(fw[0], fw[1], fw[2], fw[3]);
    *reinterpret_cast<int4*>(s.fpass + c0) = make_int4(fp[0], fp[1], fp[2], fp[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (mat[k]) {
        s.fws[c0 + k] = fw[k];
        s.fpass[c0 + k] = fp[k];
      }
    }
  }
}

}  // namespace

extern "C" {

// The sweep over n_cells slab cells, in place, in one launch. The 16-byte
// path is taken when both slab pointers are 16-byte aligned. Returns the
// CUDA error code of the launch.
int slab_sweep(int* fws, int* fpass, int* counts, int* min_rt, int* window_start, long long n_cells, int now,
               int interval, int empty_ws, int max_rt, void* stream) {
  if (n_cells <= 0) return 0;
  Slab s{fws, fpass, counts, min_rt, window_start, (int64_t)n_cells, now, interval, empty_ws, max_rt};
  int64_t groups = (n_cells + 3) / 4;
  unsigned blocks = (unsigned)((groups + THREADS - 1) / THREADS);
  bool aligned = ((uintptr_t)fws % 16 == 0) && ((uintptr_t)fpass % 16 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  if (aligned) {
    slab_sweep<true><<<blocks, THREADS, 0, st>>>(s);
  } else {
    slab_sweep<false><<<blocks, THREADS, 0, st>>>(s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
