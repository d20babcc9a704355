// K10, the hot-parameter recurrence for Hopper (sm_90a): the port of
// sentinel_tpu/rules/param_table.py:run_param with _transition and
// _seg_end_rows (ParamFlowChecker.java:46-280): per (rule, value) row, the
// token bucket (passDefaultLocalCheck), the throttle pacer
// (passThrottleLocalCheck) and the per-value thread gauge.
//
// Launch sequence (driven by rules/param_table.py):
//   1. pa_reset     rows recycled by LRU eviction back to "never seen"
//      pa_keys      one int64 key per item: (row << 32) | (ts ^ 2^31),
//                   invalid items keyed past every row
//   2. torch.sort(keys, stable=True): the JAX (row, ts, position) order in
//      one CUB radix sort
//   3. pa_init, pa_flags + scan_* (segscan.cuh) + pa_heads: every item
//      ok = 1, wait = 0; the row segments' heads compacted into a list
//   then, for rounds >= 0 (the rounds and scan schedules of JAX):
//   4. pa_walk      one thread per row segment walks its items in order (at
//                   most `rounds` when rounds > 0): tokens, last_add,
//                   latest and the intra-batch thread charge in registers,
//                   the row's thread gauge read once (after this flush's
//                   exit releases); writes ok/wait at each item's original
//                   position and the row state once at the end
//   or, for rounds <= -1 (the closed-form rank path for QPS-grade DEFAULT
//   items with one acquire, at most -rounds timestamps per row):
//   4'. pa_subsegs  one thread per row segment: for each (row, ts)
//                   sub-segment (found by binary search, so a heavy value
//                   with thousands of items at one ts costs O(log S)), its
//                   start state into scratch and the state after it; the
//                   row state is carried across at most -rounds of them
//   5'. pa_closed   one thread per item: its rank in its sub-segment and
//                   the budget floor(avail / acquire) from the sub-segment's
//                   start state
//
// What bounds it: bytes and launches (an item reads about 48 B and writes
// 5 B); a value with thousands of items of mixed grades or behaviors is
// serial in its thread, as in JAX's lax.scan; the closed form is not.
//
// Numerics: all int32, wrapping as JAX's int32 arithmetic does
// (pass_time * token_count and every sum in uint32); (pass_time * tc) //
// duration and avail // acquire are floor divisions; the throttle queues
// a wait strictly below maxQueueingTimeMs (ParamFlowChecker.java:258).

#include "segscan.cuh"

namespace {

constexpr int PARAM_NEVER = -(1 << 30);  // rules/param_table.py
constexpr int FLOW_GRADE_QPS = 1;        // models/constants.py
constexpr int CB_RATE_LIMITER = 2;

__device__ __forceinline__ int wrap_mul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
__device__ __forceinline__ int key_of(int64_t k) { return (int)(k >> 32); }

struct Items {
  const uint8_t* valid;
  const int* ts;
  const int* acq;
  const int* grade;
  const int* beh;
  const int* tc;
  const int* burst;
  const int* dur;
  const int* maxq;
  const int* cost;
};

struct Dyn {
  int* tokens;
  int* last_add;
  int* latest;
  int* threads;
};

struct PaState {
  int tokens, last, latest, thr_used;
};

// _transition for one item (param_table.py:169-230).
__device__ __forceinline__ void pa_step(PaState& st, bool valid, int ts, int acq, int grade, int beh, int tc,
                                        int burst, int dur, int maxq, int cost, int g_threads, bool& ok,
                                        int& wait) {
  int max_count = wrap_add(tc, burst);
  bool never = st.last == PARAM_NEVER;
  // token bucket (passDefaultLocalCheck)
  int first_tokens = wrap_sub(max_count, acq);
  int pass_time = wrap_sub(ts, st.last);
  bool refill_win = pass_time > dur;
  int to_add = floordiv(wrap_mul(pass_time, tc), dur);
  int new_qps = wrap_add(to_add, st.tokens) > max_count ? first_tokens : wrap_sub(wrap_add(st.tokens, to_add), acq);
  int spent = wrap_sub(st.tokens, acq);
  bool tb_ok = (never ? true : (refill_win ? new_qps >= 0 : spent >= 0)) && tc > 0 && acq <= max_count;
  int tokens2 = never ? first_tokens : (refill_win ? (new_qps >= 0 ? new_qps : st.tokens) : spent);
  if (!tb_ok) tokens2 = st.tokens;
  int last2 = (tb_ok && (never || refill_win)) ? ts : st.last;
  // throttle (passThrottleLocalCheck)
  bool t_never = st.latest == PARAM_NEVER;
  int expected = wrap_add(st.latest, cost);
  bool th_imm = expected <= ts;
  int th_wait = wrap_sub(expected, ts);
  bool th_q = !th_imm && th_wait < maxq;  // strictly below
  bool th_ok = (t_never || th_imm || th_q) && tc > 0;
  int latest2 = (t_never || th_imm) ? ts : (th_q ? expected : st.latest);
  if (!th_ok) latest2 = st.latest;
  int th_wait_out = (th_q && th_ok && !t_never) ? max(th_wait, 0) : 0;
  // per-value thread grade
  int thr_cnt = wrap_add(g_threads, st.thr_used);
  bool thr_ok = wrap_add(thr_cnt, 1) <= tc;
  bool is_qps = grade == FLOW_GRADE_QPS;
  bool is_throttle = is_qps && beh == CB_RATE_LIMITER;
  bool okv = is_throttle ? th_ok : (is_qps ? tb_ok : thr_ok);
  ok = okv || !valid;
  wait = (is_throttle && valid) ? th_wait_out : 0;
  // Only the behavior in effect moves its state.
  if (valid && is_qps && !is_throttle) {
    st.tokens = tokens2;
    st.last = last2;
  }
  if (valid && is_throttle) st.latest = latest2;
  if (valid && !is_qps) st.thr_used = wrap_add(st.thr_used, thr_ok ? 1 : 0);
}

__global__ void pa_reset(const int* __restrict__ rows, int q, int pr, Dyn dyn) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  int r = rows[i];
  if (r < 0 || r >= pr) return;  // padding, or a row past the state: dropped
  dyn.tokens[r] = 0;
  dyn.last_add[r] = PARAM_NEVER;
  dyn.latest[r] = PARAM_NEVER;
  dyn.threads[r] = 0;
}

__global__ void pa_keys(const uint8_t* __restrict__ valid, const int* __restrict__ prow,
                        const int* __restrict__ ts, int s, int pr, int64_t* __restrict__ keys) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  int key = valid[i] ? prow[i] : pr;
  keys[i] = static_cast<int64_t>(key) * INT64_C(4294967296) + (int64_t)((unsigned)ts[i] ^ 0x80000000u);
}

__global__ void pa_init(int s, const int64_t* __restrict__ key_s, uint8_t* __restrict__ ok,
                        int* __restrict__ wait, int2* __restrict__ contrib) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  ok[i] = 1;
  wait[i] = 0;
  bool head = i == 0 || key_of(key_s[i]) != key_of(key_s[i - 1]);
  contrib[i] = make_int2(head ? 1 : 0, 0);
}

// heads[j] = position of the j-th row segment, heads[nseg] = s, heads[s + 1] = nseg.
__global__ void pa_heads(const int2* __restrict__ contrib, const int2* __restrict__ excl, int s,
                         int* __restrict__ heads) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  if (contrib[i].x) heads[excl[i].x] = i;
  if (i == s - 1) {
    int nseg = excl[i].x + contrib[i].x;
    heads[nseg] = s;
    heads[s + 1] = nseg;
  }
}

__global__ void pa_walk(int s, int pr, int rounds, const int64_t* __restrict__ key_s,
                        const int64_t* __restrict__ perm, const int* __restrict__ heads, Items it, Dyn dyn,
                        uint8_t* __restrict__ ok, int* __restrict__ wait) {
  int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= heads[s + 1]) return;
  int start = heads[h], end = heads[h + 1];
  int key = key_of(key_s[start]);
  if (key >= pr) return;  // invalid items keep ok = 1, wait = 0
  int r = clampi(key, 0, pr - 1);
  // The thread charge restarts at 0 per segment, on the gauge as it stands
  // after this flush's exit releases.
  PaState st{dyn.tokens[r], dyn.last_add[r], dyn.latest[r], 0};
  int g_threads = dyn.threads[r];
  int n_items = end - start;
  int limit = rounds > 0 ? min(rounds, n_items) : n_items;
  for (int i = start; i < start + limit; ++i) {
    int p = (int)perm[i];
    bool okv;
    int w;
    pa_step(st, it.valid[p], it.ts[p], it.acq[p], it.grade[p], it.beh[p], it.tc[p], it.burst[p],
            max(it.dur[p], 1), it.maxq[p], it.cost[p], g_threads, okv, w);
    ok[p] = okv ? 1 : 0;
    wait[p] = w;
  }
  if (limit == n_items && it.valid[perm[end - 1]]) {
    dyn.tokens[r] = st.tokens;
    dyn.last_add[r] = st.last;
    dyn.latest[r] = st.latest;
  }
}

// The budget of one (row, ts) sub-segment for item p, from the state
// before it (param_table.py:325-357).
struct Budget {
  int avail, cap;
  bool gate, never, refill;
};

__device__ __forceinline__ Budget pa_budget(const Items& it, int p, int cur_tokens, int cur_last) {
  Budget b;
  int tc = it.tc[p], acq = it.acq[p], dur = max(it.dur[p], 1);
  int max_count = wrap_add(tc, it.burst[p]);
  b.gate = tc > 0 && acq <= max_count;
  b.never = cur_last == PARAM_NEVER;
  int pass_time = wrap_sub(it.ts[p], cur_last);
  b.refill = pass_time > dur;
  int to_add = floordiv(wrap_mul(pass_time, tc), dur);
  b.avail = b.never ? max_count : (b.refill ? min(wrap_add(cur_tokens, to_add), max_count) : cur_tokens);
  b.cap = b.gate ? floordiv(b.avail, max(acq, 1)) : 0;
  return b;
}

// One thread per row segment: the row state through its sub-segments.
// Scratch at each sub-segment's first position: the state before it and
// its index in the row.
__global__ void pa_subsegs(int s, int pr, int nseg_max, const int64_t* __restrict__ key_s,
                           const int64_t* __restrict__ perm, const int* __restrict__ heads, Items it, Dyn dyn,
                           int* __restrict__ sub_tok, int* __restrict__ sub_last, int* __restrict__ sub_idx) {
  int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= heads[s + 1]) return;
  int start = heads[h], end = heads[h + 1];
  int key = key_of(key_s[start]);
  if (key >= pr) return;
  int r = clampi(key, 0, pr - 1);
  int cur_tokens = dyn.tokens[r], cur_last = dyn.last_add[r];
  int si = 0;
  for (int j = start; j < end; ++si) {
    int j2 = j + lower_bound(key_s + j, end - j, key_s[j] + 1);
    sub_tok[j] = cur_tokens;
    sub_last[j] = cur_last;
    sub_idx[j] = si;
    int pl = (int)perm[j2 - 1];  // the sub-segment's last item writes the state
    if (si < nseg_max && it.valid[pl]) {
      Budget b = pa_budget(it, pl, cur_tokens, cur_last);
      int granted = min(j2 - j, b.cap);
      if (granted > 0) {
        cur_tokens = wrap_sub(b.avail, wrap_mul(granted, it.acq[pl]));
        if (b.never || b.refill) cur_last = it.ts[pl];
      }
    }
    j = j2;
  }
  dyn.tokens[r] = cur_tokens;
  dyn.last_add[r] = cur_last;
}

__global__ void pa_closed(int s, int pr, int nseg_max, const int64_t* __restrict__ key_s,
                          const int64_t* __restrict__ perm, Items it, const int* __restrict__ sub_tok,
                          const int* __restrict__ sub_last, const int* __restrict__ sub_idx,
                          uint8_t* __restrict__ ok) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  int p = (int)perm[i];
  if (!it.valid[p] || key_of(key_s[i]) >= pr) return;  // ok = 1 already
  int ss = lower_bound(key_s, s, key_s[i]);  // the sub-segment's first position
  if (sub_idx[ss] >= nseg_max) {
    ok[p] = 0;  // beyond the host's bound: JAX leaves such items blocked
    return;
  }
  Budget b = pa_budget(it, p, sub_tok[ss], sub_last[ss]);
  ok[p] = (b.gate && i - ss < b.cap) ? 1 : 0;
}

}  // namespace

extern "C" {

// Number of scan tiles for s items (the int2 partial scratch).
int param_tiles(int s) { return tiles_for(s); }

// Step 1: LRU resets (q rows, -1 padding), then the sort keys (s items).
int param_prep(const int* reset_rows, int q, const uint8_t* valid, const int* prow, const int* ts, int s, int pr,
               int* tokens, int* last_add, int* latest, int* threads, int64_t* keys, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (q > 0) pa_reset<<<blocks_for(q), THREADS, 0, st>>>(reset_rows, q, pr, Dyn{tokens, last_add, latest, threads});
  if (s > 0) pa_keys<<<blocks_for(s), THREADS, 0, st>>>(valid, prow, ts, s, pr, keys);
  return (int)cudaGetLastError();
}

// Steps 3-5' after the sort. Scratch: partial int2 [tiles], contrib and
// excl int2 [s], heads int [s + 2], sub_tok/sub_last/sub_idx int [s].
int param_run(const int64_t* key_s, const int64_t* perm, int s, int pr, int rounds, const uint8_t* valid,
              const int* ts, const int* acq, const int* grade, const int* beh, const int* tc, const int* burst,
              const int* dur, const int* maxq, const int* cost, int* tokens, int* last_add, int* latest,
              int* threads, int* partial, int* contrib, int* excl, int* heads, int* sub_tok, int* sub_last,
              int* sub_idx, uint8_t* ok, int* wait, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (s <= 0) return 0;
  if (pr <= 0) return (int)cudaErrorInvalidValue;
  Items it{valid, ts, acq, grade, beh, tc, burst, dur, maxq, cost};
  Dyn dyn{tokens, last_add, latest, threads};
  int tiles = tiles_for(s);
  int2* c2 = reinterpret_cast<int2*>(contrib);
  int2* x2 = reinterpret_cast<int2*>(excl);
  int2* p2 = reinterpret_cast<int2*>(partial);
  pa_init<<<blocks_for(s), THREADS, 0, st>>>(s, key_s, ok, wait, c2);
  LoadContrib lc{c2};
  scan_reduce<SumOp, LoadContrib><<<tiles, THREADS, 0, st>>>(lc, s, p2);
  scan_partials<SumOp><<<1, THREADS, 0, st>>>(p2, tiles);
  scan_apply_sum<<<tiles, THREADS, 0, st>>>(lc, s, p2, x2);
  pa_heads<<<blocks_for(s), THREADS, 0, st>>>(c2, x2, s, heads);
  if (rounds <= -1) {
    pa_subsegs<<<blocks_for(s), THREADS, 0, st>>>(s, pr, -rounds, key_s, perm, heads, it, dyn, sub_tok, sub_last,
                                                 sub_idx);
    pa_closed<<<blocks_for(s), THREADS, 0, st>>>(s, pr, -rounds, key_s, perm, it, sub_tok, sub_last, sub_idx, ok);
  } else {
    pa_walk<<<blocks_for(s), THREADS, 0, st>>>(s, pr, rounds, key_s, perm, heads, it, dyn, ok, wait);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
