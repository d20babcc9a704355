// Circuit-breaker completions for Hopper (sm_90a): the port of
// sentinel_tpu/rules/degrade_table.py:breaker_on_exits with trip_condition
// and _segment_cum (onRequestComplete of the reference's breakers,
// AbstractCircuitBreaker.java, ExceptionCircuitBreaker.java,
// ResponseTimeCircuitBreaker.java).
//
// Launch sequence (driven by rules/degrade_table.py:_breaker_on_exits_cuda):
//   1. bo_keys      one int64 key per exit slot: (gid << 32) | (ts ^ 2^31),
//                   ND << 32 for empty slots. gid <= ND and the biased ts
//                   fit in 64 bits, so ONE stable torch.sort (CUB) gives the
//                   (gid, ts, pos) order of the JAX two-key stable sort
//   2. torch.sort(key, stable=True)
//   3. bo_init      per segment head: its window start, first crossing ts,
//                   in-window total and bad count, in per-segment scratch
//   4. bo_seg_max   (a) each exit finds its head (binary search) and the
//                   newest aligned window reaches the head by atomicMax
//   5. bo_flags     (b) in-window and bad flags as the scan's (total, bad)
//   6. scan_*       (c) the segmented inclusive prefixes (segscan.cuh)
//   7. bo_decide    (d) the float32 trip predicate per exit, (e) the first
//                   crossing ts per breaker by atomicMin, (g) the in-window
//                   totals by atomicAdd
//   8. bo_resolve   (f, h) per breaker (one thread, at its head): window
//                   roll, CLOSED -> OPEN, the HALF_OPEN probe outcome of
//                   the segment's first exit, written in place
//
// What bounds it: bytes and the sort. Per exit slot it reads the slot's
// gid, ts, RT and error (16 B) and the breaker's table row (28 B, cached
// for a hot breaker), and the sort moves 16 B twice; only touched breakers
// are written. A hot breaker under Zipf exits takes thousands of exits in
// one segment, so every atomic is first combined across the warp
// (__match_any_sync + __reduce_*_sync): one atomic per warp and segment.
// Integer max, min and wrapping add are order-free, so the result is
// bit-identical to the JAX sort-and-segment reduction.
//
// Numerics: the ratio and the min-request compare are float32 as in JAX
// (min_request 2^31 - 1 rounds to 2^31). ts + retry_ms wraps in uint32,
// as JAX's int32 addition wraps; signed overflow is not used.

#include "breaker_trip.cuh"
#include "segscan.cuh"

namespace {

constexpr int CLOSED = 0, OPEN = 1, HALF_OPEN = 2;  // rules/degrade_table.py
constexpr int GRADE_RT = 0;  // models/constants.py

struct Table {
  const int* grade;
  const float* threshold;
  const float* slow_ratio;
  const int* min_request;
  const int* interval_ms;
  const int* retry_ms;
  const int* max_rt;
};

struct Dyn {
  int* state;
  int* next_retry;
  int* bad;
  int* total;
  int* ws;
};

__device__ __forceinline__ int key_gid(long long key) { return (int)(key >> 32); }
__device__ __forceinline__ int key_ts(long long key) { return (int)((unsigned)key ^ 0x80000000u); }

__device__ __forceinline__ bool is_head(const long long* key_s, int i) {
  return i == 0 || key_gid(key_s[i - 1]) != key_gid(key_s[i]);
}

// ts aligned to the breaker's window: ts - ts % interval (floor modulo).
__device__ __forceinline__ int aligned_ts(int ts, int iv) {
  return (int)((unsigned)ts - (unsigned)floormod(ts, max(iv, 1)));
}

__device__ __forceinline__ bool exit_bad(const Table& t, int g, int rt, int err) {
  return t.grade[g] == GRADE_RT ? rt > t.max_rt[g] : err > 0;
}

// trip_condition (degrade_table.py:151) in float32 (breaker_trip.cuh).
__device__ __forceinline__ bool trip(const Table& t, int g, float bad, float total) {
  return trip_condition(t.grade[g], t.threshold[g], t.slow_ratio[g], bad, total);
}

__global__ void bo_keys(const int* __restrict__ dgid, const int* __restrict__ x_ts,
                        const uint8_t* __restrict__ x_valid, int mk, int kd, int nd,
                        long long* __restrict__ keys) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= mk) return;
  int e = p / kd;
  int g = dgid[p];
  bool valid = g >= 0 && g < nd && x_valid[e];
  keys[p] = valid ? ((long long)g << 32) | (unsigned)(x_ts[e] ^ (int)0x80000000u) : (long long)nd << 32;
}

__global__ void bo_init(const long long* __restrict__ key_s, int mk, int nd, const int* __restrict__ ws,
                        uint8_t* __restrict__ new_grp, int* __restrict__ seg_ws, int* __restrict__ seg_fc,
                        int* __restrict__ seg_tot, int* __restrict__ seg_bad) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mk) return;
  bool h = is_head(key_s, i);
  new_grp[i] = h ? 1 : 0;
  int g = key_gid(key_s[i]);
  if (h && g < nd) {
    seg_ws[i] = ws[g];
    seg_fc[i] = INT_MAX;
    seg_tot[i] = 0;
    seg_bad[i] = 0;
  }
}

__global__ void bo_seg_max(const long long* __restrict__ key_s, int mk, int nd, Table t,
                           int* __restrict__ head, int* __restrict__ seg_ws) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  long long key = i < mk ? key_s[i] : (long long)nd << 32;
  int g = key_gid(key);
  bool act = i < mk && g < nd;
  unsigned am = __ballot_sync(FULL_MASK, act);
  if (!act) return;
  int h = is_head(key_s, i) ? i : lower_bound<long long>(key_s, i, (long long)g << 32);
  head[i] = h;
  int a = aligned_ts(key_ts(key), t.interval_ms[g]);
  unsigned grp = __match_any_sync(am, h);
  int m = __reduce_max_sync(grp, a);
  if ((threadIdx.x & 31) == __ffs(grp) - 1) atomicMax(&seg_ws[h], m);
}

__global__ void bo_flags(const long long* __restrict__ key_s, const int64_t* __restrict__ perm, int mk,
                         int kd, int nd, Table t, const int* __restrict__ x_rt, const int* __restrict__ x_err,
                         const int* __restrict__ head, const int* __restrict__ seg_ws,
                         int2* __restrict__ contrib) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mk) return;
  long long key = key_s[i];
  int g = key_gid(key);
  int2 c = make_int2(0, 0);
  if (g < nd) {
    int e = (int)(perm[i] / kd);
    bool in_win = aligned_ts(key_ts(key), t.interval_ms[g]) == seg_ws[head[i]];
    bool bad = exit_bad(t, g, x_rt[e], x_err[e]);
    c = make_int2(in_win ? 1 : 0, (in_win && bad) ? 1 : 0);
  }
  contrib[i] = c;
}

// Phase 3 of the running max fused with the per-exit trip check.
__global__ void bo_decide(LoadSnapshot ld, int mk, int nd, Table t, Dyn d,
                          const long long* __restrict__ key_s, const int2* __restrict__ partial_max,
                          const int2* __restrict__ excl, const int2* __restrict__ contrib,
                          const int* __restrict__ head, const int* __restrict__ seg_ws,
                          int* __restrict__ seg_fc, int* __restrict__ seg_tot, int* __restrict__ seg_bad) {
  __shared__ int2 warp_tot[NWARPS];
  int base = blockIdx.x * TILE + threadIdx.x * IPT;
  int2 loc[IPT];
  int2 run = max_scan_prefix(ld, mk, partial_max, loc, warp_tot);
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    int i = base + j;
    run = MaxOp::op(run, loc[j]);
    bool in_win = false, cross = false;
    int h = 0, ts = 0, bad_in = 0;
    if (i < mk) {
      long long key = key_s[i];
      int g = key_gid(key);
      int2 x = contrib[i];
      if (g < nd && x.x) {
        in_win = true;
        bad_in = x.y;
        h = head[i];
        ts = key_ts(key);
        // _segment_cum: inclusive = exclusive + own - the group's base.
        int2 ex = excl[i];
        int cum_tot = wrap_sub(wrap_add(ex.x, x.x), run.x);
        int cum_bad = wrap_sub(wrap_add(ex.y, x.y), run.y);
        bool rolled = seg_ws[h] > d.ws[g];
        float run_tot = __int2float_rn(wrap_add(rolled ? 0 : d.total[g], cum_tot));
        float run_bad = __int2float_rn(wrap_add(rolled ? 0 : d.bad[g], cum_bad));
        cross = d.state[g] == CLOSED && run_tot >= __int2float_rn(t.min_request[g]) &&
                trip(t, g, run_bad, run_tot);
      }
    }
    unsigned m1 = __ballot_sync(FULL_MASK, in_win);
    if (in_win) {
      unsigned grp = __match_any_sync(m1, h);
      int n_in = __popc(grp);
      int n_bad = __reduce_add_sync(grp, bad_in);
      if ((threadIdx.x & 31) == __ffs(grp) - 1) {
        atomicAdd(&seg_tot[h], n_in);
        if (n_bad) atomicAdd(&seg_bad[h], n_bad);
      }
    }
    unsigned m2 = __ballot_sync(FULL_MASK, cross);
    if (cross) {
      unsigned grp = __match_any_sync(m2, h);
      int first = __reduce_min_sync(grp, ts);
      if ((threadIdx.x & 31) == __ffs(grp) - 1) atomicMin(&seg_fc[h], first);
    }
  }
}

__global__ void bo_resolve(const long long* __restrict__ key_s, const int64_t* __restrict__ perm, int mk,
                           int kd, int nd, Table t, Dyn d, const int* __restrict__ x_rt,
                           const int* __restrict__ x_err, const int* __restrict__ seg_ws,
                           const int* __restrict__ seg_fc, const int* __restrict__ seg_tot,
                           const int* __restrict__ seg_bad) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mk || !is_head(key_s, i)) return;
  int g = key_gid(key_s[i]);
  if (g >= nd) return;
  int ws_new = seg_ws[i];
  bool rolled = ws_new > d.ws[g];
  int total = wrap_add(rolled ? 0 : d.total[g], seg_tot[i]);
  int bad = wrap_add(rolled ? 0 : d.bad[g], seg_bad[i]);
  int st = d.state[g];
  int next_retry = d.next_retry[g];
  unsigned retry = (unsigned)t.retry_ms[g];
  if (st == CLOSED && seg_fc[i] < INT_MAX) {
    st = OPEN;
    next_retry = (int)((unsigned)seg_fc[i] + retry);
  } else if (st == HALF_OPEN) {
    // The probe's outcome is the segment's first exit, in window or not.
    int e = (int)(perm[i] / kd);
    if (exit_bad(t, g, x_rt[e], x_err[e])) {
      st = OPEN;
      next_retry = (int)((unsigned)max(0, key_ts(key_s[i])) + retry);
    } else {
      st = CLOSED;  // fromHalfOpenToClose resets the bucket
      total = 0;
      bad = 0;
    }
  }
  d.ws[g] = ws_new;
  d.total[g] = total;
  d.bad[g] = bad;
  d.state[g] = st;
  d.next_retry[g] = next_retry;
}

}  // namespace

extern "C" {

// Step 1: sort keys, [m * kd] int64.
int breaker_on_exits_keys(const int* x_dgid, const int* x_ts, const uint8_t* x_valid, int m, int kd, int nd,
                          long long* keys, void* stream) {
  int mk = m * kd;
  if (mk <= 0) return 0;
  bo_keys<<<blocks_for(mk), THREADS, 0, (cudaStream_t)stream>>>(x_dgid, x_ts, x_valid, mk, kd, nd, keys);
  return (int)cudaGetLastError();
}

// Size of the int2 scratch for the tile totals.
int breaker_on_exits_tiles(int mk) { return tiles_for(mk); }

// Steps 3-8 over the sorted keys. Scratch: head, seg_ws, seg_fc, seg_tot,
// seg_bad [mk]; contrib/excl int2 [mk]; partial/partial_max int2 [tiles];
// new_grp [mk]. The state is updated in place.
int breaker_on_exits_apply(const long long* key_s, const int64_t* perm, const int* x_rt, const int* x_err,
                           const int* x_ts, int m, int kd, int nd, const int* grade, const float* threshold,
                           const float* slow_ratio, const int* min_request, const int* interval_ms,
                           const int* retry_ms, const int* max_rt, int* state, int* next_retry, int* bad,
                           int* total, int* ws, int* head, int* seg_ws, int* seg_fc, int* seg_tot,
                           int* seg_bad, int* contrib, int* excl, int* partial, int* partial_max,
                           uint8_t* new_grp, void* stream) {
  (void)x_ts;  // the sorted keys carry ts
  int mk = m * kd;
  if (mk <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  Table t{grade, threshold, slow_ratio, min_request, interval_ms, retry_ms, max_rt};
  Dyn d{state, next_retry, bad, total, ws};
  int g = blocks_for(mk);
  int tiles = tiles_for(mk);
  int2* c2 = reinterpret_cast<int2*>(contrib);
  int2* x2 = reinterpret_cast<int2*>(excl);
  int2* p2 = reinterpret_cast<int2*>(partial);
  int2* m2 = reinterpret_cast<int2*>(partial_max);
  bo_init<<<g, THREADS, 0, st>>>(key_s, mk, nd, ws, new_grp, seg_ws, seg_fc, seg_tot, seg_bad);
  bo_seg_max<<<g, THREADS, 0, st>>>(key_s, mk, nd, t, head, seg_ws);
  bo_flags<<<g, THREADS, 0, st>>>(key_s, perm, mk, kd, nd, t, x_rt, x_err, head, seg_ws, c2);
  LoadContrib lc{c2};
  scan_reduce<SumOp, LoadContrib><<<tiles, THREADS, 0, st>>>(lc, mk, p2);
  scan_partials<SumOp><<<1, THREADS, 0, st>>>(p2, tiles);
  scan_apply_sum<<<tiles, THREADS, 0, st>>>(lc, mk, p2, x2);
  LoadSnapshot ls{x2, new_grp};
  scan_reduce<MaxOp, LoadSnapshot><<<tiles, THREADS, 0, st>>>(ls, mk, m2);
  scan_partials<MaxOp><<<1, THREADS, 0, st>>>(m2, tiles);
  bo_decide<<<tiles, THREADS, 0, st>>>(ls, mk, nd, t, d, key_s, m2, x2, c2, head, seg_ws, seg_fc, seg_tot,
                                       seg_bad);
  bo_resolve<<<g, THREADS, 0, st>>>(key_s, perm, mk, kd, nd, t, d, x_rt, x_err, seg_ws, seg_fc, seg_tot,
                                    seg_bad);
  return (int)cudaGetLastError();
}

}  // extern "C"
