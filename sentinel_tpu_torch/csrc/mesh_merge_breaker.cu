// The sharded step's breaker merge for Hopper (sm_90a): the port of
// merge_breaker inside sentinel_tpu/parallel/ici.py:make_sharded_flush.
// K14.
//
// Each shard ran its part of the batch against its own copy of the
// replicated post-exit breaker state; per breaker, against that base:
//   * state: a shard whose state differs from the base offers it, the
//     largest offer wins (OPEN over CLOSED), else the base stays;
//   * window: the newest window start over the shards; only shards whose
//     window is that one contribute bad/total minus the base's (the base
//     counts only if its window is that one too), summed;
//   * next_retry: the largest over the shards;
//   * a CLOSED breaker whose merged counts reach min_request and trip the
//     threshold (breaker_trip.cuh, float32 as K7 evaluates it) opens at
//     now + retry_ms.
// One thread per breaker, a fixed loop over the shards; the merged state
// is written over the base in place.
//
// What bounds it: bytes. Per breaker it reads the base's and every
// shard's five int32 fields and the table's five, and writes five.
//
// Numerics: int32 sums and now + retry_ms wrap (uint32 adds), as JAX's
// int32 arithmetic does; the min_request compare is int32, the trip
// predicate float32 (__int2float_rn of the merged counts).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "breaker_trip.cuh"

namespace {

constexpr int THREADS_MB = 256;
constexpr int CLOSED = 0, OPEN = 1;  // rules/degrade_table.py

__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }

struct Dyn {
  int* state;
  int* next_retry;
  int* bad;
  int* total;
  int* ws;
};

struct Shards {  // [D, ND] each
  const int* state;
  const int* next_retry;
  const int* bad;
  const int* total;
  const int* ws;
};

__global__ void mb_merge(Dyn base, Shards sh, int nd, int d_count, const int* __restrict__ grade,
                         const float* __restrict__ threshold, const float* __restrict__ slow_ratio,
                         const int* __restrict__ min_request, const int* __restrict__ retry_ms, int now) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= nd) return;
  int st0 = base.state[g];
  int best = -1, g_ws = INT_MIN, next_retry = INT_MIN;
  for (int d = 0; d < d_count; ++d) {
    int64_t c = (int64_t)d * nd + g;
    int s = sh.state[c];
    if (s != st0) best = max(best, s);
    g_ws = max(g_ws, sh.ws[c]);
    next_retry = max(next_retry, sh.next_retry[c]);
  }
  bool old_cur = base.ws[g] == g_ws;
  int base_bad = old_cur ? base.bad[g] : 0;
  int base_total = old_cur ? base.total[g] : 0;
  int bad = base_bad, total = base_total;
  for (int d = 0; d < d_count; ++d) {
    int64_t c = (int64_t)d * nd + g;
    if (sh.ws[c] == g_ws) {
      bad = wadd(bad, wsub(sh.bad[c], base_bad));
      total = wadd(total, wsub(sh.total[c], base_total));
    }
  }
  int state = best >= 0 ? best : st0;
  bool cross = state == CLOSED && total >= min_request[g] &&
               trip_condition(grade[g], threshold[g], slow_ratio[g], __int2float_rn(bad), __int2float_rn(total));
  base.state[g] = cross ? OPEN : state;
  base.next_retry[g] = cross ? wadd(now, retry_ms[g]) : next_retry;
  base.bad[g] = bad;
  base.total[g] = total;
  base.ws[g] = g_ws;
}

}  // namespace

extern "C" {

// base: the five [nd] fields, merged in place; shards: the five [d, nd].
int mesh_merge_breaker(int* state, int* next_retry, int* bad, int* total, int* ws, const int* s_state,
                       const int* s_next_retry, const int* s_bad, const int* s_total, const int* s_ws, int nd,
                       int d_count, const int* grade, const float* threshold, const float* slow_ratio,
                       const int* min_request, const int* retry_ms, int now, void* stream) {
  if (nd <= 0) return 0;
  Dyn base{state, next_retry, bad, total, ws};
  Shards sh{s_state, s_next_retry, s_bad, s_total, s_ws};
  mb_merge<<<(nd + THREADS_MB - 1) / THREADS_MB, THREADS_MB, 0, (cudaStream_t)stream>>>(
      base, sh, nd, d_count, grade, threshold, slow_ratio, min_request, retry_ms, now);
  return (int)cudaGetLastError();
}

}  // extern "C"
