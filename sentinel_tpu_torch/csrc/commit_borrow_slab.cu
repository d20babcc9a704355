// Borrow commit for Hopper (sm_90a): the port of
// sentinel_tpu/runtime/flush.py:commit_borrow_slab (addWaitingRequest,
// StatisticNode.java:342-345): granted borrows of finally admitted
// prioritized entries go into the future slab future_pass/future_ws
// [R, B], set-if-newer per (row, bucket) like the borrow array's
// reset-then-add roll.
//
// Launch sequence (driven by runtime/flush.py:_commit_borrow_cuda), the
// per-segment logic of the window update (window_update.cu) on a
// one-event array:
//   1. cb_keys    key = row * B + (target / wlen) % B for a borrowed slot,
//                 R * B otherwise
//   2. torch.sort(key, stable=True)   (CUB radix sort)
//   3. cb_init    per segment head: newest window INT_MIN, sum 0
//   4. cb_max     each borrow finds its head (binary search); the newest
//                 target window reaches the head by atomicMax
//   5. cb_sum     the acquire of borrows at that window, by atomicAdd
//   6. cb_write   one writer per touched cell: same window adds, a newer
//                 one sets pass and window, an older one writes nothing
//
// What bounds it: bytes. Per slot: the borrow flag, target, row and
// acquire (13 B); the sort moves 12 B twice; one 8 B cell per touched
// (row, bucket). Atomics are combined across the warp first
// (__match_any_sync + __reduce_*_sync) for a hot row.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 256;

__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int floormod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ int lower_bound_i32(const int* __restrict__ a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void cb_keys(const uint8_t* __restrict__ occ, const int* __restrict__ tgt,
                        const int* __restrict__ crow, int nk, int n_rows, int nb, int wlen,
                        int* __restrict__ key) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= nk) return;
  int row = min(max(crow[p], 0), n_rows - 1);
  key[p] = occ[p] ? row * nb + floormod(floordiv(tgt[p], wlen), nb) : n_rows * nb;
}

__global__ void cb_init(const int* __restrict__ key_s, int nk, int rb, int* __restrict__ seg_ws,
                        int* __restrict__ seg_sum) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nk) return;
  int key = key_s[i];
  if (key < rb && (i == 0 || key_s[i - 1] != key)) {
    seg_ws[i] = INT_MIN;
    seg_sum[i] = 0;
  }
}

__global__ void cb_max(const int* __restrict__ key_s, const int64_t* __restrict__ perm,
                       const int* __restrict__ tgt, int nk, int rb, int* __restrict__ head,
                       int* __restrict__ seg_ws) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int key = i < nk ? key_s[i] : rb;
  bool act = i < nk && key < rb;
  unsigned am = __ballot_sync(FULL_MASK, act);
  if (!act) return;
  int h = (i == 0 || key_s[i - 1] != key) ? i : lower_bound_i32(key_s, i, key);
  head[i] = h;
  unsigned grp = __match_any_sync(am, h);
  int m = __reduce_max_sync(grp, tgt[perm[i]]);
  if ((threadIdx.x & 31) == __ffs(grp) - 1) atomicMax(&seg_ws[h], m);
}

__global__ void cb_sum(const int* __restrict__ key_s, const int64_t* __restrict__ perm,
                       const int* __restrict__ tgt, const int* __restrict__ acq, int nk, int k, int rb,
                       const int* __restrict__ head, const int* __restrict__ seg_ws,
                       int* __restrict__ seg_sum) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int h = 0, a = 0;
  bool act = false;
  if (i < nk && key_s[i] < rb) {
    int64_t p = perm[i];
    h = head[i];
    act = tgt[p] == seg_ws[h];  // only borrows of the newest window count
    a = acq[p / k];
  }
  unsigned am = __ballot_sync(FULL_MASK, act);
  if (!act) return;
  unsigned grp = __match_any_sync(am, h);
  int s = __reduce_add_sync(grp, a);
  if ((threadIdx.x & 31) == __ffs(grp) - 1) atomicAdd(&seg_sum[h], s);
}

__global__ void cb_write(const int* __restrict__ key_s, int nk, int rb, const int* __restrict__ seg_ws,
                         const int* __restrict__ seg_sum, int* __restrict__ fut_pass,
                         int* __restrict__ fut_ws) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nk) return;
  int key = key_s[i];
  if (key >= rb || (i > 0 && key_s[i - 1] == key)) return;
  // key = row * B + bucket is the flat index of the slab cell.
  int old = fut_ws[key];
  if (seg_ws[i] == old) {
    fut_pass[key] = wrap_add(fut_pass[key], seg_sum[i]);
  } else if (seg_ws[i] > old) {
    fut_pass[key] = seg_sum[i];
    fut_ws[key] = seg_ws[i];
  }
}

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

extern "C" {

// Step 1: slab keys of the [nk] borrow slots.
int commit_borrow_keys(const uint8_t* occ, const int* tgt, const int* crow, int nk, int n_rows, int nb,
                       int wlen, int* key, void* stream) {
  if (nk <= 0) return 0;
  if (wlen <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  cb_keys<<<blocks_for(nk), THREADS, 0, (cudaStream_t)stream>>>(occ, tgt, crow, nk, n_rows, nb, wlen, key);
  return (int)cudaGetLastError();
}

// Steps 3-6 over the sorted keys. Scratch: head, seg_ws, seg_sum [nk].
// The slab is updated in place.
int commit_borrow_apply(const int* key_s, const int64_t* perm, const int* tgt, const int* acq, int nk, int k,
                        int rb, int* head, int* seg_ws, int* seg_sum, int* fut_pass, int* fut_ws,
                        void* stream) {
  if (nk <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int g = blocks_for(nk);
  cb_init<<<g, THREADS, 0, st>>>(key_s, nk, rb, seg_ws, seg_sum);
  cb_max<<<g, THREADS, 0, st>>>(key_s, perm, tgt, nk, rb, head, seg_ws);
  cb_sum<<<g, THREADS, 0, st>>>(key_s, perm, tgt, acq, nk, k, rb, head, seg_ws, seg_sum);
  cb_write<<<g, THREADS, 0, st>>>(key_s, nk, rb, seg_ws, seg_sum, fut_pass, fut_ws);
  return (int)cudaGetLastError();
}

}  // extern "C"
