// Window update for Hopper (sm_90a): the port of
// sentinel_tpu/metrics/metric_array.py:update (the LeapArray
// currentWindow + add path over a whole batch) and of the thread-gauge
// scatter in sentinel_tpu/metrics/nodes.py:apply_updates.
//
// Launch sequence (driven by metrics/metric_array.py:_update_cuda):
//   1. wu_keys      key = row*B + (ts/wlen)%B, masked entries -> R*B
//   2. torch.sort(key, stable=True)            (CUB radix sort)
//   3. wu_init      per-segment scratch to the identity of each reduce
//   4. wu_seg_max   newest window start per (row, bucket) segment
//   5. wu_seg_sum   sum of the deltas and min RT of the entries in that
//                   newest window
//   6. wu_write     one writer per touched bucket: add, set or drop
// and, for apply_updates, tg_add: the thread gauge.
//
// What bounds it: bytes. Per update it reads the batch (rows, ts, six
// deltas, RT: about 36 B an entry), the sort moves 12 B an entry twice,
// and each touched bucket reads and writes 32 B of window state. No
// arithmetic is heavy. So the design moves each byte once and keeps
// every kernel a single pass.
//
// Design against the hot segment. One hot resource can put every entry
// of a flush (4 x 131,072 updates) into one (row, bucket) segment, so a
// thread-per-segment walk would run serially there. Instead every
// sorted position gets its own thread: it finds its segment's head by
// binary search on the sorted keys (the head is its own position unless
// its left neighbour has the same key), and contributes to per-segment
// scratch through integer atomics, first reduced across the warp with
// __match_any_sync + __reduce_*_sync so a hot segment costs one atomic
// per warp rather than one per entry. Integer max, min and wrapping add
// are order-free, so the result is bit-identical to the sort-and-segment
// reduction of the JAX code whatever order the atomics land in. The
// final write has one thread per segment head, so each bucket has one
// writer and needs no atomic.
//
// Arithmetic that may overflow int32 is done in unsigned, where it wraps
// as the JAX int32 arithmetic does.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int NE = 6;       // metric events (metrics/events.py)
constexpr int THREADS = 256;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// First position of `key` in the sorted array a[0, n).
__device__ __forceinline__ int lower_bound_i32(const int* __restrict__ a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void wu_keys(const int* __restrict__ rows, const int* __restrict__ ts,
                        const uint8_t* __restrict__ mask, int n, int nb, int wlen, int rb,
                        int* __restrict__ key) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  key[i] = mask[i] ? rows[i] * nb + (ts[i] / wlen) % nb : rb;
}

__global__ void wu_init(int n, int* __restrict__ seg_ws, int* __restrict__ seg_rt,
                        int* __restrict__ seg_sum) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  seg_ws[i] = INT_MIN;
  seg_rt[i] = INT_MAX;
#pragma unroll
  for (int e = 0; e < NE; ++e) seg_sum[i * NE + e] = 0;
}

__global__ void wu_seg_max(const int* __restrict__ key_s, const int64_t* __restrict__ perm,
                           const int* __restrict__ ts, int n, int rb, int wlen,
                           int* __restrict__ head, int* __restrict__ seg_ws) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int key = (i < n) ? key_s[i] : rb;
  bool act = (i < n) && key >= 0 && key < rb;
  unsigned am = __ballot_sync(FULL_MASK, act);
  if (!act) return;
  int s = (i == 0 || key_s[i - 1] != key) ? i : lower_bound_i32(key_s, i, key);
  head[i] = s;
  int t = ts[perm[i]];
  int w = t - t % wlen;
  unsigned grp = __match_any_sync(am, s);
  int m = __reduce_max_sync(grp, w);
  if (lane_id() == __ffs(grp) - 1) atomicMax(&seg_ws[s], m);
}

__global__ void wu_seg_sum(const int* __restrict__ key_s, const int64_t* __restrict__ perm,
                           const int* __restrict__ ts, const int* __restrict__ deltas,
                           const int* __restrict__ rt, int n, int rb, int wlen,
                           const int* __restrict__ head, const int* __restrict__ seg_ws,
                           int* __restrict__ seg_sum, int* __restrict__ seg_rt) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int key = (i < n) ? key_s[i] : rb;
  bool act = (i < n) && key >= 0 && key < rb;
  int s = 0;
  int64_t p = 0;
  if (act) {
    s = head[i];
    p = perm[i];
    int t = ts[p];
    act = (t - t % wlen) == seg_ws[s];  // only the newest window contributes
  }
  unsigned cm = __ballot_sync(FULL_MASK, act);
  if (!act) return;
  unsigned grp = __match_any_sync(cm, s);
  bool leader = lane_id() == __ffs(grp) - 1;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    int v = __reduce_add_sync(grp, deltas[p * NE + e]);
    if (leader && v != 0) atomicAdd(&seg_sum[s * NE + e], v);
  }
  if (rt != nullptr) {
    int r = __reduce_min_sync(grp, rt[p]);
    if (leader) atomicMin(&seg_rt[s], r);
  }
}

__global__ void wu_write(const int* __restrict__ key_s, int n, int rb, int max_rt, int has_rt,
                         const int* __restrict__ seg_ws, const int* __restrict__ seg_sum,
                         const int* __restrict__ seg_rt, int* __restrict__ counts,
                         int* __restrict__ min_rt, int* __restrict__ window_start) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int key = key_s[i];
  if (key < 0 || key >= rb) return;
  if (i > 0 && key_s[i - 1] == key) return;  // not the segment head
  // key = row * B + bucket is the flat index of the bucket's cell.
  int u_ws = seg_ws[i];
  int old = window_start[key];
  int64_t c = (int64_t)key * NE;
  if (u_ws == old) {  // same window: add
#pragma unroll
    for (int e = 0; e < NE; ++e) counts[c + e] = wrap_add(counts[c + e], seg_sum[i * NE + e]);
    if (has_rt) min_rt[key] = min(min_rt[key], seg_rt[i]);
  } else if (u_ws > old) {  // newer window: the bucket rolls
#pragma unroll
    for (int e = 0; e < NE; ++e) counts[c + e] = seg_sum[i * NE + e];
    window_start[key] = u_ws;
    min_rt[key] = has_rt ? min(seg_rt[i], max_rt) : max_rt;
  }  // older window: dropped
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

// Step 1: bucket keys. Returns the CUDA error code of the launch.
int window_update_keys(const int* rows, const int* ts, const uint8_t* mask, int n, int nb,
                       int wlen, int rb, int* key, void* stream) {
  if (n <= 0) return 0;
  wu_keys<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(rows, ts, mask, n, nb, wlen, rb, key);
  return (int)cudaGetLastError();
}

// Steps 3-6 over the sorted keys. `rt` may be null (entries: a rolled
// bucket's min RT resets to max_rt). Scratch: head/seg_ws/seg_rt [n],
// seg_sum [n*6]. State is updated in place.
int window_update_apply(const int* key_s, const int64_t* perm, const int* ts,
                        const int* deltas, const int* rt, int n, int rb, int wlen, int max_rt,
                        int* head, int* seg_ws, int* seg_rt, int* seg_sum, int* counts,
                        int* min_rt, int* window_start, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int g = blocks_for(n);
  wu_init<<<g, THREADS, 0, st>>>(n, seg_ws, seg_rt, seg_sum);
  wu_seg_max<<<g, THREADS, 0, st>>>(key_s, perm, ts, n, rb, wlen, head, seg_ws);
  wu_seg_sum<<<g, THREADS, 0, st>>>(key_s, perm, ts, deltas, rt, n, rb, wlen, head, seg_ws,
                                    seg_sum, seg_rt);
  wu_write<<<g, THREADS, 0, st>>>(key_s, n, rb, max_rt, rt != nullptr ? 1 : 0, seg_ws, seg_sum,
                                  seg_rt, counts, min_rt, window_start);
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
