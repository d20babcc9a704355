// K12: the embedded token server's decision pass on the card (replaces the
// jitted `_batch_decide`, sentinel_tpu/cluster/token_service.py:95, and its
// atomic variant `_decide_jit_atomic`, :162-165).
//
// One C call (token_decide) decides a batch of B token requests (flow row,
// namespace row or -1, acquire, float32 thresholds, valid) and commits it:
//   0. each request reads the PASS sum of its flow row and its namespace
//      row from the 10 x 100 ms cluster window (the buckets with
//      now - window_start <= interval, as K3 reads them);
//   1. namespace guard: requests keyed by namespace row (the dump group
//      n_rows for invalid or namespace-less ones) in (key, position)
//      order; each is charged the acquire of the earlier requests of its
//      group, computed as JAX does: the wrapping int32 exclusive sum over
//      the whole sorted batch minus the running max of the group-start
//      values (when the batch's acquire sum passes 2^31 the running max can
//      pick an earlier group's head; a per-group sum would differ there);
//      ns_ok = ns_row < 0 || (float)(sum + charge) / interval + acquire <= ns_threshold;
//   2. flow check, keyed by flow row where valid and ns_ok:
//      next_remaining = (threshold - (float)(sum + charge) / interval) - acquire;
//      admitted = valid && ns_ok && next_remaining >= 0; the atomic variant
//      charges nothing unless every valid request is admitted;
//   3. commit: PASS += acquire on the flow and namespace rows of the charged
//      requests, by K2's two phases (window_update.cuh) on the state.
// Outputs: one int32 [3, B] tensor (admitted, ns_ok, the bits of
// next_remaining), copied back in one piece.
//
// Two routes, both hand-written and both held against the plain version:
// - B <= SMALL_MAX (the main path's batches: the service pads to a power
//   of two >= 8): one launch of one block. It sorts the packed (group,
//   position) keys in shared memory (bitonic), scans, decides and
//   commits, with __syncthreads() between the steps.
// - larger B: td_prep (the sums and the first keys), a CUB radix sort of
//   the keys (end_bit cut to the bits they use; temp storage from the
//   caller's workspace), td_stage<0> (one single-pass kernel: the scans by
//   decoupled look-back, and the decisions), the second sort, td_stage<1>,
//   and the two commit phases.
// Float32 is IEEE round-to-nearest in the JAX order of operations (no
// multiply, so no FMA question); the build never enables fast math.
//
// Bound: bytes. Each request moves a few dozen bytes; at a token server's
// batch sizes the pass is bound by launch and synchronisation latency, so
// the design is about launches: one host call, one launch for small B.

#include <cub/device/device_radix_sort.cuh>

#include "bitonic.cuh"
#include "lookback.cuh"
#include "window_update.cuh"

namespace {

constexpr int PASS = 0;  // MetricEvent.PASS
constexpr int SMALL_MAX = 2048;
constexpr int SMALL_IPT = SMALL_MAX / THREADS;

struct Batch {
  const int* rows;
  const int* ns_rows;
  const int* acquire;
  const float* thr;
  const float* ns_thr;
  const uint8_t* valid;
  int b, now, interval_ms, atomic, pbits;
  float interval_sec;
  int* out;  // [3, b]: admitted, ns_ok, next_remaining bits
};

__device__ __forceinline__ u64 pack_key(int group, int pos, int pbits) {
  return ((u64)(unsigned)group << pbits) | (unsigned)pos;
}
__device__ __forceinline__ int key_group(u64 k, int pbits) { return (int)(k >> pbits); }
__device__ __forceinline__ int key_pos(u64 k, int pbits) { return (int)(k & ((1ull << pbits) - 1)); }

// PASS sum of a row (clamped into [0, n_rows)) over its valid buckets.
__device__ int pass_sum(const wu::Window& s, int row, int now, int interval_ms) {
  int64_t c0 = (int64_t)clampi(row, 0, s.n_rows - 1) * s.nb;
  int acc = 0;
  for (int k = 0; k < s.nb; ++k) {
    if (wrap_sub(now, s.window_start[c0 + k]) <= interval_ms) acc = wrap_add(acc, s.counts[(c0 + k) * wu::NE + PASS]);
  }
  return acc;
}

__device__ __forceinline__ bool ns_admits(const Batch& a, int pos, int sum, int charge) {
  float qps = __fdiv_rn(__int2float_rn(wrap_add(sum, charge)), a.interval_sec);
  return a.ns_rows[pos] < 0 || __fadd_rn(qps, __int2float_rn(a.acquire[pos])) <= a.ns_thr[pos];
}

__device__ __forceinline__ float flow_remaining(const Batch& a, int pos, int sum, int charge) {
  float latest = __fdiv_rn(__int2float_rn(wrap_add(sum, charge)), a.interval_sec);
  return __fsub_rn(__fsub_rn(a.thr[pos], latest), __int2float_rn(a.acquire[pos]));
}

// The commit of request i's two updates (u < b: its flow row, else its
// namespace row), as JAX masks them: rows >= n_rows (the dump) drop, the
// rest are clamped into range.
__device__ __forceinline__ int commit_cell(const wu::Window& s, const Batch& a, int u, bool charged) {
  int i = u < a.b ? u : u - a.b;
  int r = u < a.b ? (charged ? a.rows[i] : s.n_rows) : ((charged && a.ns_rows[i] >= 0) ? a.ns_rows[i] : s.n_rows);
  return wu::cell_of(s, r < s.n_rows, clampi(r, 0, s.n_rows - 1), a.now);
}

__device__ __forceinline__ void commit_add(const wu::Window& s, const Batch& a, int u, int cell) {
  int d[wu::NE] = {0, 0, 0, 0, 0, 0};
  if (cell >= 0) d[PASS] = a.acquire[u < a.b ? u : u - a.b];
  wu::add(s, cell, wu::window_of(s, a.now), d, false, 0);
}

// ---------------------------------------------------------------------------
// one block: B <= SMALL_MAX
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) td_small(Batch a, wu::Window s) {
  __shared__ u64 key[SMALL_MAX];
  __shared__ int sum_f[SMALL_MAX], sum_n[SMALL_MAX];
  __shared__ uint8_t ns_ok[SMALL_MAX], adm[SMALL_MAX];
  __shared__ int all_ok;
  const int b = a.b;
  int p = 1;
  while (p < b) p <<= 1;
  const int ipt = (p + THREADS - 1) / THREADS;  // items per thread, <= SMALL_IPT
  const int span = ipt * THREADS;
  if (threadIdx.x == 0) all_ok = 1;
  for (int i = threadIdx.x; i < span; i += THREADS) {
    if (i < b) {
      int ns = a.ns_rows[i];
      key[i] = pack_key((a.valid[i] && ns >= 0) ? ns : s.n_rows, i, a.pbits);
      sum_f[i] = pass_sum(s, a.rows[i], a.now, a.interval_ms);
      sum_n[i] = ns >= 0 ? pass_sum(s, ns, a.now, a.interval_ms) : 0;
    } else {
      key[i] = SENTINEL;
    }
  }
  __syncthreads();
  NoCarry none;
  for (int stage = 0; stage < 2; ++stage) {
    bitonic_sort(key, p);
    int2 acq[SMALL_IPT], charge[SMALL_IPT];
    int pos[SMALL_IPT];
    bool head[SMALL_IPT];
#pragma unroll
    for (int k = 0; k < SMALL_IPT; ++k) {
      int j = threadIdx.x * ipt + k;
      acq[k] = make_int2(0, 0);
      head[k] = false;
      pos[k] = -1;
      if (k < ipt && j < b) {
        u64 kj = key[j];
        pos[k] = key_pos(kj, a.pbits);
        acq[k].x = a.acquire[pos[k]];
        head[k] = j == 0 || key_group(key[j - 1], a.pbits) != key_group(kj, a.pbits);
      }
    }
    charges<SMALL_IPT, 1>(ipt, acq, head, charge, none);
#pragma unroll
    for (int k = 0; k < SMALL_IPT; ++k) {
      int q = pos[k];
      if (q < 0) continue;
      if (stage == 0) {
        bool ok = ns_admits(a, q, sum_n[q], charge[k].x);
        ns_ok[q] = ok;
        a.out[b + q] = ok;
      } else {
        float rem = flow_remaining(a, q, sum_f[q], charge[k].x);
        bool ad = a.valid[q] && ns_ok[q] && rem >= 0.0f;
        adm[q] = ad;
        a.out[q] = ad;
        a.out[2 * b + q] = __float_as_int(rem);
        if (a.valid[q] && !ad) all_ok = 0;
      }
    }
    __syncthreads();
    if (stage == 0) {
      for (int i = threadIdx.x; i < b; i += THREADS)
        key[i] = pack_key((a.valid[i] && ns_ok[i]) ? a.rows[i] : s.n_rows, i, a.pbits);
      __syncthreads();
    }
  }
  // Commit: K2's phases over the 2B updates; global writes of one phase are
  // visible to the whole block after the barrier.
  const bool all = !a.atomic || all_ok;
  int w = wu::window_of(s, a.now);
  for (int base = 0; base < 2 * b; base += THREADS) {
    int u = base + threadIdx.x;
    int cell = u < 2 * b ? commit_cell(s, a, u, adm[u < b ? u : u - b] && all) : -1;
    wu::newest(s, cell, w);
  }
  __syncthreads();
  for (int base = 0; base < 2 * b; base += THREADS) {
    int u = base + threadIdx.x;
    int cell = u < 2 * b ? commit_cell(s, a, u, adm[u < b ? u : u - b] && all) : -1;
    commit_add(s, a, u, cell);
  }
}

// ---------------------------------------------------------------------------
// many blocks: any B
// ---------------------------------------------------------------------------

// The gathered sums, the namespace keys, and the look-back state reset.
__global__ void td_prep(Batch a, wu::Window s, int* sum_f, int* sum_n, u64* key, u64* status, int n_status,
                        int* ctl) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_status) status[i] = 0;
  if (i < 3) ctl[i] = i == 2 ? 1 : 0;  // two tile counters, the all-admitted flag
  if (i >= a.b) return;
  int ns = a.ns_rows[i];
  key[i] = pack_key((a.valid[i] && ns >= 0) ? ns : s.n_rows, i, a.pbits);
  sum_f[i] = pass_sum(s, a.rows[i], a.now, a.interval_ms);
  sum_n[i] = ns >= 0 ? pass_sum(s, ns, a.now, a.interval_ms) : 0;
}

// One stage over its sorted keys, single pass: each block takes the next
// tile, scans it with the carries of the tiles before it, and decides.
// Stage 0 writes ns_ok and the flow keys; stage 1 the verdicts.
template <int STAGE>
__global__ void __launch_bounds__(THREADS)
    td_stage(Batch a, int n_rows, const u64* __restrict__ key_s, const int* __restrict__ sum, u64* next_key,
             u64* status, int nt, int* ctl) {
  __shared__ int s_tile;
  if (threadIdx.x == 0) s_tile = atomicAdd(&ctl[STAGE], 1);
  __syncthreads();
  LookBack<1> lb{status, nt, s_tile, 2 * STAGE};
  int2 acq[IPT], charge[IPT];
  int pos[IPT];
  bool head[IPT];
  int base = s_tile * TILE + threadIdx.x * IPT;
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    int j = base + k;
    acq[k] = make_int2(0, 0);
    head[k] = false;
    pos[k] = -1;
    if (j < a.b) {
      u64 kj = key_s[j];
      pos[k] = key_pos(kj, a.pbits);
      acq[k].x = a.acquire[pos[k]];
      head[k] = j == 0 || key_group(key_s[j - 1], a.pbits) != key_group(kj, a.pbits);
    }
  }
  charges<IPT, 1>(IPT, acq, head, charge, lb);
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    int q = pos[k];
    if (q < 0) continue;
    if (STAGE == 0) {
      bool ok = ns_admits(a, q, sum[q], charge[k].x);
      a.out[a.b + q] = ok;
      next_key[q] = pack_key((a.valid[q] && ok) ? a.rows[q] : n_rows, q, a.pbits);
    } else {
      float rem = flow_remaining(a, q, sum[q], charge[k].x);
      bool ad = a.valid[q] && a.out[a.b + q] && rem >= 0.0f;
      a.out[q] = ad;
      a.out[2 * a.b + q] = __float_as_int(rem);
      if (a.valid[q] && !ad) ctl[2] = 0;
    }
  }
}

__global__ void td_commit_newest(Batch a, wu::Window s, const int* ctl) {
  int u = blockIdx.x * blockDim.x + threadIdx.x;
  bool all = !a.atomic || ctl[2];
  int cell = u < 2 * a.b ? commit_cell(s, a, u, a.out[u < a.b ? u : u - a.b] && all) : -1;
  wu::newest(s, cell, wu::window_of(s, a.now));
}

__global__ void td_commit_add(Batch a, wu::Window s, const int* ctl) {
  int u = blockIdx.x * blockDim.x + threadIdx.x;
  bool all = !a.atomic || ctl[2];
  int cell = u < 2 * a.b ? commit_cell(s, a, u, a.out[u < a.b ? u : u - a.b] && all) : -1;
  commit_add(s, a, u, cell);
}

// Workspace of the many-block route: two key arrays, two sums, four
// look-back status arrays, three control words, CUB's temp storage.
struct Layout {
  size_t keys, sums, status, ctl, temp, total;
  int n_status;
};

Layout layout(int b) {
  Layout l;
  int nt = tiles_for(b);
  l.n_status = 4 * nt;
  size_t temp = 0;
  cub::DeviceRadixSort::SortKeys(nullptr, temp, (const u64*)nullptr, (u64*)nullptr, b, 0, 64);
  l.keys = 0;
  l.sums = l.keys + align256(2 * sizeof(u64) * (size_t)b);
  l.status = l.sums + align256(2 * sizeof(int) * (size_t)b);
  l.ctl = l.status + align256(sizeof(u64) * (size_t)l.n_status);
  l.temp = l.ctl + 256;
  l.total = l.temp + align256(temp);
  return l;
}

}  // namespace

extern "C" {

// Bytes of workspace token_decide needs for a batch of b (0 for the
// one-block route).
long long token_decide_workspace(int b) { return b <= SMALL_MAX ? 0 : (long long)layout(b).total; }

// Decide and commit one batch (see the header). Returns a CUDA error code,
// or -1 when the workspace is smaller than token_decide_workspace(b).
int token_decide(const int* rows, const int* ns_rows, const int* acquire, const float* thr, const float* ns_thr,
                 const uint8_t* valid, int b, int now, int interval_ms, float interval_sec, int atomic,
                 int* counts, int* min_rt, int* window_start, int n_rows, int nb, int wlen, int max_rt, int* out,
                 void* workspace, long long workspace_bytes, cudaStream_t stream) {
  if (b <= 0) return 0;
  int pbits = bits_for(b - 1);
  Batch a{rows, ns_rows, acquire, thr, ns_thr, valid, b, now, interval_ms, atomic, pbits, interval_sec, out};
  wu::Window s{counts, min_rt, window_start, n_rows, nb, wlen, max_rt};
  if (b <= SMALL_MAX) {
    td_small<<<1, THREADS, 0, stream>>>(a, s);
    return (int)cudaGetLastError();
  }
  Layout l = layout(b);
  if (workspace_bytes < (long long)l.total) return -1;
  char* ws = (char*)workspace;
  u64* key_a = (u64*)(ws + l.keys);
  u64* key_b = key_a + b;
  int* sum_f = (int*)(ws + l.sums);
  int* sum_n = sum_f + b;
  u64* status = (u64*)(ws + l.status);
  int nt = tiles_for(b);
  int* ctl = (int*)(ws + l.ctl);
  void* temp = ws + l.temp;
  size_t temp_bytes = l.total - l.temp;
  int end_bit = pbits + bits_for(n_rows);
  int err;
  td_prep<<<blocks_for(max(b, l.n_status)), THREADS, 0, stream>>>(a, s, sum_f, sum_n, key_a, status, l.n_status,
                                                                  ctl);
  if ((err = (int)cub::DeviceRadixSort::SortKeys(temp, temp_bytes, key_a, key_b, b, 0, end_bit, stream))) return err;
  td_stage<0><<<nt, THREADS, 0, stream>>>(a, n_rows, key_b, sum_n, key_a, status, nt, ctl);
  if ((err = (int)cub::DeviceRadixSort::SortKeys(temp, temp_bytes, key_a, key_b, b, 0, end_bit, stream))) return err;
  td_stage<1><<<nt, THREADS, 0, stream>>>(a, n_rows, key_b, sum_f, nullptr, status, nt, ctl);
  td_commit_newest<<<blocks_for(2 * b), THREADS, 0, stream>>>(a, s, ctl);
  td_commit_add<<<blocks_for(2 * b), THREADS, 0, stream>>>(a, s, ctl);
  return (int)cudaGetLastError();
}

}  // extern "C"
