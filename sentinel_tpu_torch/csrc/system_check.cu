// System protection for Hopper (sm_90a): the port of
// sentinel_tpu/runtime/flush.py:system_check (SystemRuleManager.checkSystem,
// SystemRuleManager.java:298-353) against the global inbound row 0.
//
// Launch sequence (driven by runtime/flush.py:_system_check_cuda):
//   1. sc_keys     key = ts for a live inbound entry, INT_MAX otherwise
//   2. torch.sort(key, stable=True)   (CUB radix sort): (ts, pos) order
//   3. sc_apply    ONE block: reduces row 0's second-window buckets (pass,
//                  success and RT sums over valid buckets, max success,
//                  min RT), then walks the sorted entries a tile at a time
//                  with an exclusive block scan of (acquire, 1) over the
//                  checked ones plus a running carry, and runs the five
//                  checks per entry.
//
// An unchecked entry that ties a checked one at ts = INT_MAX contributes
// zero to both prefixes, so the order among them changes nothing.
//
// What bounds it: one pass over N entries (perm 8 B, live/rows/acquire
// about 10 B, outputs 5 B) and the sort. The scan is serial across tiles
// inside one block; at N = 131,072 that is 16 tiles of 8,192 entries.
//
// Numerics: float32 in the JAX order, with __f*_rn intrinsics and no
// fast-math: (pass + charge) / interval_sec + acquire > qps (no floor,
// unlike the flow check), rt_sum / max(success, 1), BBR
// curThread > (maxSuccessQps * minRt) / 1000. The last matching dimension
// in the order cpu, load, rt, thread, qps wins (QPS beats the rest).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int SC_THREADS = 1024;
constexpr int SC_IPT = 8;
constexpr int SC_TILE = SC_THREADS * SC_IPT;
constexpr int SC_WARPS = SC_THREADS / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int EVENT_PASS = 0, EVENT_SUCCESS = 3, EVENT_RT = 4;  // metrics/events.py
constexpr int SYS_NONE = 0, SYS_QPS = 1, SYS_THREAD = 2, SYS_RT = 3, SYS_LOAD = 4, SYS_CPU = 5;

__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

__global__ void sc_keys(const uint8_t* __restrict__ live, const int* __restrict__ e_rows,
                        const int* __restrict__ e_ts, int n, int* __restrict__ key) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool checked = live[i] && e_rows[(int64_t)i * 4 + 3] >= 0;
  key[i] = checked ? e_ts[i] : INT_MAX;
}

// Exclusive block scan of (acquire, count) pairs with wrapping adds.
__device__ int2 block_scan(int2 v, int2* warp_tot, int2& total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int yx = __shfl_up_sync(FULL_MASK, x.x, off), yy = __shfl_up_sync(FULL_MASK, x.y, off);
    if (lane >= off) x = make_int2(wrap_add(yx, x.x), wrap_add(yy, x.y));
  }
  int2 ex = make_int2(__shfl_up_sync(FULL_MASK, x.x, 1), __shfl_up_sync(FULL_MASK, x.y, 1));
  if (lane == 0) ex = make_int2(0, 0);
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int2 w = lane < SC_WARPS ? warp_tot[lane] : make_int2(0, 0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int yx = __shfl_up_sync(FULL_MASK, w.x, off), yy = __shfl_up_sync(FULL_MASK, w.y, off);
      if (lane >= off) w = make_int2(wrap_add(yx, w.x), wrap_add(yy, w.y));
    }
    warp_tot[lane] = w;  // SC_WARPS == 32: inclusive over warps
  }
  __syncthreads();
  int2 pre = warp == 0 ? make_int2(0, 0) : warp_tot[warp - 1];
  total = warp_tot[SC_WARPS - 1];
  __syncthreads();
  return make_int2(wrap_add(pre.x, ex.x), wrap_add(pre.y, ex.y));
}

struct Thresholds {
  float qps, max_thread, max_rt, load_thr, cpu_thr, cur_load, cur_cpu;
};

__global__ void __launch_bounds__(SC_THREADS)
sc_apply(const int64_t* __restrict__ perm, const uint8_t* __restrict__ live,
         const int* __restrict__ e_rows, const int* __restrict__ e_acq, int n,
         const int* __restrict__ counts0, const int* __restrict__ min_rt0, const int* __restrict__ ws0,
         const int* __restrict__ threads, int nb, int ne, int interval, int max_rt, int now,
         float interval_sec, Thresholds th, uint8_t* __restrict__ ok, int* __restrict__ sys_type) {
  __shared__ int2 warp_tot[SC_WARPS];
  // Row 0's second window, over the valid buckets (now - ws <= interval,
  // in wrapping int32).
  int pass = 0, succ = 0, rt = 0, max_succ = INT_MIN, min_rt = INT_MAX;
  for (int b = 0; b < nb; ++b) {
    bool v = (int)((unsigned)now - (unsigned)ws0[b]) <= interval;
    const int* c = counts0 + (int64_t)b * ne;
    if (v) {
      pass = wrap_add(pass, c[EVENT_PASS]);
      succ = wrap_add(succ, c[EVENT_SUCCESS]);
      rt = wrap_add(rt, c[EVENT_RT]);
    }
    max_succ = max(max_succ, v ? c[EVENT_SUCCESS] : 0);
    min_rt = min(min_rt, v ? min_rt0[b] : max_rt);
  }
  float pass_f = __int2float_rn(pass), succ_f = __int2float_rn(succ), rt_f = __int2float_rn(rt);
  float threads0 = __int2float_rn(threads[0]);
  float avg_rt = succ_f > 0.0f ? __fdiv_rn(rt_f, fmaxf(succ_f, 1.0f)) : 0.0f;
  bool rt_block = avg_rt > th.max_rt;
  float bbr_cap = __fdiv_rn(__fmul_rn(__fmul_rn(__int2float_rn(max_succ), (float)nb), __int2float_rn(min_rt)),
                            1000.0f);
  bool load_on = th.load_thr >= 0.0f && th.cur_load > th.load_thr;
  bool cpu_block = th.cpu_thr >= 0.0f && th.cur_cpu > th.cpu_thr;

  int2 carry = make_int2(0, 0);
  for (int start = 0; start < n; start += SC_TILE) {
    int p[SC_IPT];
    bool chk[SC_IPT];
    int2 acc = make_int2(0, 0);
#pragma unroll
    for (int j = 0; j < SC_IPT; ++j) {
      int i = start + threadIdx.x * SC_IPT + j;
      p[j] = i < n ? (int)perm[i] : -1;
      chk[j] = p[j] >= 0 && live[p[j]] && e_rows[(int64_t)p[j] * 4 + 3] >= 0;
      if (chk[j]) acc = make_int2(wrap_add(acc.x, e_acq[p[j]]), acc.y + 1);
    }
    int2 total;
    int2 run = block_scan(acc, warp_tot, total);
    run = make_int2(wrap_add(run.x, carry.x), wrap_add(run.y, carry.y));
#pragma unroll
    for (int j = 0; j < SC_IPT; ++j) {
      if (p[j] < 0) continue;
      int e = p[j];
      int t = SYS_NONE;
      if (chk[j]) {
        float acq_f = __int2float_rn(e_acq[e]);
        float cur_qps = __fdiv_rn(__fadd_rn(pass_f, __int2float_rn(run.x)), interval_sec);
        float cur_thread = __fadd_rn(threads0, __int2float_rn(run.y));
        bool qps_block = __fadd_rn(cur_qps, acq_f) > th.qps;
        bool thread_block = cur_thread > th.max_thread;
        bool load_block = load_on && cur_thread > 1.0f && cur_thread > bbr_cap;
        if (cpu_block) t = SYS_CPU;
        if (load_block) t = SYS_LOAD;
        if (rt_block) t = SYS_RT;
        if (thread_block) t = SYS_THREAD;
        if (qps_block) t = SYS_QPS;
        run = make_int2(wrap_add(run.x, e_acq[e]), run.y + 1);
      }
      ok[e] = t == SYS_NONE ? 1 : 0;
      sys_type[e] = t;
    }
    carry = make_int2(wrap_add(carry.x, total.x), wrap_add(carry.y, total.y));
  }
}

}  // namespace

extern "C" {

// Step 1: sort keys. Returns the CUDA error code of the launch.
int system_check_keys(const uint8_t* live, const int* e_rows, const int* e_ts, int n, int* key,
                      void* stream) {
  if (n <= 0) return 0;
  sc_keys<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(live, e_rows, e_ts, n, key);
  return (int)cudaGetLastError();
}

// Step 3. counts0/min_rt0/ws0 point at row 0 of the second window
// ([B, E], [B], [B]); threads at the gauge (row 0 is read).
int system_check_apply(const int64_t* perm, const uint8_t* live, const int* e_rows, const int* e_acq,
                       int n, const int* counts0, const int* min_rt0, const int* ws0,
                       const int* threads, int nb, int ne, int interval, int max_rt, int now,
                       float interval_sec, float qps, float max_thread, float max_rt_thr,
                       float load_thr, float cpu_thr, float cur_load, float cur_cpu, uint8_t* ok,
                       int* sys_type, void* stream) {
  if (n <= 0) return 0;
  Thresholds th{qps, max_thread, max_rt_thr, load_thr, cpu_thr, cur_load, cur_cpu};
  sc_apply<<<1, SC_THREADS, 0, (cudaStream_t)stream>>>(perm, live, e_rows, e_acq, n, counts0, min_rt0,
                                                       ws0, threads, nb, ne, interval, max_rt, now,
                                                       interval_sec, th, ok, sys_type);
  return (int)cudaGetLastError();
}

}  // extern "C"
