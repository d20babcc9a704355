// K9, the shaping recurrence for Hopper (sm_90a): the port of
// sentinel_tpu/rules/shaping.py:run_shaping over rules/recurrence.py:
// run_segmented, with _transition and _pacer_cost, and the flush's inputs
// to it (runtime/flush.py:_prev_second_pass and the gathers of
// flush_entries :759-764). RateLimiter, WarmUp and WarmUpRateLimiter
// (RateLimiterController.java:28-90, WarmUpController.java:84-175,
// WarmUpRateLimiterController.java:25-90).
//
// Launch sequence (driven by rules/shaping.py):
//   0. sh_inputs    (flush only) each item's liveness, its slot's pass plus
//                   intra-batch charge, the previous second's pass of its
//                   row in the minute window
//   1. sh_keys      one int64 key per item: (rule << 32) | (ts ^ 2^31),
//                   invalid items keyed past every rule
//   2. torch.sort(keys, stable=True): the JAX (rule, ts, position) order
//      in one CUB radix sort
//   then, for rounds >= 0 (the rounds and scan schedules of JAX):
//   3. sh_init      every item ok = 1, wait = 0 (what unresolved and
//                   invalid items keep)
//   4. sh_flags, scan_reduce/scan_partials/scan_apply_sum (segscan.cuh),
//      sh_heads     segment heads as a flag, compacted by an exclusive sum
//                   into a dense list, so one thread gets one segment and
//                   no work is of the size of the rule table
//   5. sh_walk      one thread per rule segment walks its items in order
//                   (at most `rounds` of them when rounds > 0), the rule's
//                   state (latest, stored, lastfill) in registers; writes
//                   ok and wait at each item's original position and the
//                   final state once
//   or, for rounds == -1 (the closed-form pacer path the engine selects
//   when every item is a plain RATE_LIMITER at one ts with one acquire):
//   3'. sh_closed   one thread per item: its rank in the segment (binary
//                   search for the segment head), the segment's grant cap
//                   from the segment-start state, its verdict and wait;
//                   the segment's last item computes the new latest
//   4'. sh_commit   the segment ends write latest (after every read)
//
// What bounds it: bytes and launches for typical batches (each item reads
// about 30 B of batch and rule table and writes 5 B); a rule with thousands
// of items in one flush is serial in its thread, as it is in JAX's
// lax.scan. The closed form has no serial part.
//
// Numerics: float32 statement by statement as the JAX code runs on the
// CPU, with round-to-nearest intrinsics and no fast-math. XLA's CPU
// backend fuses a multiply feeding an add into an FMA, so
// above * slope + 1 / count and acquire / qps * 1000 + 0.5 are __fmaf_rn
// here (that fused result is the reference's). float -> int32 conversions
// saturate (__float2int_rz), as XLA's do: a WARM_UP_RATE_LIMITER cost at a
// count near 0 is far outside int32. Times wrap in int32 (uint32
// arithmetic); ts - ts % 1000 and the minute bucket use floor division
// and modulo.

#include <math.h>

#include "segscan.cuh"

namespace {

constexpr int CB_WARM_UP = 1;  // models/constants.py
constexpr int CB_RATE_LIMITER = 2;
constexpr int CB_WARM_UP_RATE_LIMITER = 3;

__device__ __forceinline__ int wrap_mul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }

struct Table {
  const int* behavior;
  const float* count;
  const int* maxq;
  const int* cost1;
  const int* warn;
  const int* maxtok;
  const float* slope;
  const int* refill;
};

struct Dyn {
  int* latest;
  float* stored;
  int* lastfill;
};

struct Items {
  const uint8_t* valid;
  const int* ts;
  const int* acq;
  const int* ppc;
  const int* prev;
  float interval_sec;
};

// _pacer_cost: cost1 when acquire == 1, else floor(acquire / count * 1000 + 0.5).
__device__ __forceinline__ int pacer_cost(float acq_f, int acq_i, float cnt, int c1) {
  float q = __fdiv_rn(acq_f, fmaxf(cnt, 1e-9f));
  float generic = floorf(__fmaf_rn(q, 1000.0f, 0.5f));
  return __float2int_rz(acq_i == 1 ? __int2float_rn(c1) : generic);
}

struct ShState {
  int latest;
  float stored;
  int lastfill;
};

// _transition for one item (shaping.py:84-149).
__device__ __forceinline__ void sh_step(ShState& st, bool valid, int ts, int acq_i, float passq, float prevq,
                                        int b, float cnt, int mq, int c1, float wn, float mx, float sl, float rt,
                                        bool& ok, int& wait) {
  float acq_f = __int2float_rn(acq_i);
  bool is_wu = b == CB_WARM_UP || b == CB_WARM_UP_RATE_LIMITER;
  // syncToken (WarmUpController.syncToken / coolDownTokens)
  int sec = wrap_sub(ts, floormod(ts, 1000));
  bool do_sync = is_wu && sec > st.lastfill && valid;
  float elapsed = __int2float_rn(wrap_sub(sec, st.lastfill));
  bool refill_ok = st.stored < wn || (st.stored > wn && prevq < rt);
  float refilled = fminf(floorf(__fadd_rn(st.stored, __fdiv_rn(__fmul_rn(elapsed, cnt), 1000.0f))), mx);
  float stored1 = (do_sync && refill_ok) ? refilled : st.stored;
  float stored2 = do_sync ? fmaxf(__fsub_rn(stored1, prevq), 0.0f) : stored1;
  int lastfill2 = do_sync ? sec : st.lastfill;
  // the warm-up admitted QPS above the warning line
  float above = fmaxf(__fsub_rn(stored2, wn), 0.0f);
  float inv = __fmaf_rn(above, sl, __fdiv_rn(1.0f, fmaxf(cnt, 1e-9f)));
  float warning_qps = nextafterf(__fdiv_rn(1.0f, inv), INFINITY);
  bool cold = stored2 >= wn;
  float pa = __fadd_rn(passq, acq_f);
  bool wu_ok = cold ? pa <= warning_qps : pa <= cnt;
  // the pacer cost (RateLimiter / WarmUpRateLimiter)
  float cost_rl = __int2float_rn(pacer_cost(acq_f, acq_i, cnt, c1));
  float cost_wurl_cold = floorf(__fmaf_rn(__fdiv_rn(acq_f, warning_qps), 1000.0f, 0.5f));
  float cost_f = (b == CB_WARM_UP_RATE_LIMITER && cold) ? cost_wurl_cold : cost_rl;
  int cost = __float2int_rz(cost_f);
  int expected = wrap_add(st.latest, cost);
  bool imm = expected <= ts;
  int w = wrap_sub(expected, ts);
  bool queued = !imm && w <= mq;
  bool pacer_ok = ((imm || queued) && cnt > 0.0f) || acq_i <= 0;  // acquire <= 0 always passes
  int latest2 = (valid && pacer_ok && acq_i > 0) ? (imm ? ts : expected) : st.latest;
  bool is_pacer = b == CB_RATE_LIMITER || b == CB_WARM_UP_RATE_LIMITER;
  bool okv = b == CB_WARM_UP ? wu_ok : (is_pacer ? pacer_ok : true);
  ok = okv || !valid;
  wait = (valid && is_pacer && queued && pacer_ok) ? w : 0;
  // The pacer state advances only for pacer behaviors, the warm-up state
  // only through the sync; invalid items touch nothing.
  if (valid && is_pacer) st.latest = latest2;
  if (valid) {
    st.stored = stored2;
    st.lastfill = lastfill2;
  }
}

__device__ __forceinline__ int key_of(int64_t k) { return (int)(k >> 32); }

__global__ void sh_inputs(const uint8_t* __restrict__ sv, const int* __restrict__ eidx,
                          const int* __restrict__ flat_pos, const int* __restrict__ row,
                          const int* __restrict__ ts, int s, const uint8_t* __restrict__ live, int n,
                          const int* __restrict__ ppc, int nk, const int* __restrict__ mws,
                          const int* __restrict__ mcounts, int r_rows, int nb, int ne, int wlen,
                          uint8_t* __restrict__ valid_out, int* __restrict__ ppc_out, int* __restrict__ prev_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  valid_out[i] = (sv[i] && live[clampi(eidx[i], 0, n - 1)]) ? 1 : 0;
  ppc_out[i] = ppc[clampi(flat_pos[i], 0, nk - 1)];
  // node.previousPassQps(): the minute window's bucket one second back.
  int tprev = wrap_sub(ts[i], wlen);
  int aligned = wrap_sub(tprev, floormod(tprev, wlen));
  int b = floormod(floordiv(tprev, wlen), nb);
  int64_t c = (int64_t)clampi(row[i], 0, r_rows - 1) * nb + b;
  prev_out[i] = mws[c] == aligned ? mcounts[c * ne] : 0;  // event 0 = PASS
}

__global__ void sh_keys(const uint8_t* __restrict__ valid, const int* __restrict__ gid,
                        const int* __restrict__ ts, int s, int nr, int64_t* __restrict__ keys) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  int key = valid[i] ? gid[i] : nr;
  keys[i] = static_cast<int64_t>(key) * INT64_C(4294967296) + (int64_t)((unsigned)ts[i] ^ 0x80000000u);
}

__global__ void sh_init(int s, uint8_t* __restrict__ ok, int* __restrict__ wait) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  ok[i] = 1;
  wait[i] = 0;
}

// Segment-head flags as scan contributions (x = 1 at a head).
__global__ void sh_flags(const int64_t* __restrict__ key_s, int s, int2* __restrict__ contrib) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  bool head = i == 0 || key_of(key_s[i]) != key_of(key_s[i - 1]);
  contrib[i] = make_int2(head ? 1 : 0, 0);
}

// Compaction: heads[j] = position of the j-th head, heads[nseg] = s, and
// heads[s + 1] = nseg.
__global__ void sh_heads(const int2* __restrict__ contrib, const int2* __restrict__ excl, int s,
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

__global__ void sh_walk(int s, int nr, int rounds, const int64_t* __restrict__ key_s,
                        const int64_t* __restrict__ perm, const int* __restrict__ heads, Items it, Table tb,
                        Dyn dyn, uint8_t* __restrict__ ok, int* __restrict__ wait) {
  int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= heads[s + 1]) return;
  int start = heads[h], end = heads[h + 1];
  int key = key_of(key_s[start]);
  if (key >= nr) return;  // invalid items: ok = 1, wait = 0 already
  int g = clampi(key, 0, nr - 1);
  int b = tb.behavior[g], mq = tb.maxq[g], c1 = tb.cost1[g];
  float cnt = tb.count[g], sl = tb.slope[g];
  float wn = __int2float_rn(tb.warn[g]), mx = __int2float_rn(tb.maxtok[g]);
  float rt = __int2float_rn(tb.refill[g]);
  ShState st{dyn.latest[g], dyn.stored[g], dyn.lastfill[g]};
  int n_items = end - start;
  int limit = rounds > 0 ? min(rounds, n_items) : n_items;
  for (int i = start; i < start + limit; ++i) {
    int p = (int)perm[i];
    float passq = floorf(__fdiv_rn(__int2float_rn(it.ppc[p]), it.interval_sec));
    bool okv;
    int w;
    sh_step(st, it.valid[p], it.ts[p], it.acq[p], passq, __int2float_rn(it.prev[p]), b, cnt, mq, c1, wn, mx, sl,
            rt, okv, w);
    ok[p] = okv ? 1 : 0;
    wait[p] = w;
  }
  // The segment's last item writes the final state back; past the rounds
  // bound that is the segment-start state (JAX leaves it unresolved).
  if (limit == n_items && it.valid[perm[end - 1]]) {
    dyn.latest[g] = st.latest;
    dyn.stored[g] = st.stored;
    dyn.lastfill[g] = st.lastfill;
  }
}

// The closed-form pacer path (shaping.py:220-282). new_latest[i] holds the
// segment end's state until sh_commit writes it.
__global__ void sh_closed(int s, int nr, const int64_t* __restrict__ key_s, const int64_t* __restrict__ perm,
                          Items it, Table tb, const int* __restrict__ latest, uint8_t* __restrict__ ok,
                          int* __restrict__ wait, int* __restrict__ new_latest) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  int key = key_of(key_s[i]);
  int start = lower_bound(key_s, s, static_cast<int64_t>(key) * INT64_C(4294967296));
  int p = (int)perm[i];
  bool v = it.valid[p];
  int g = clampi(key, 0, nr - 1);
  int ts = it.ts[p], acq_i = it.acq[p];
  float cnt = tb.count[g];
  int maxq = tb.maxq[g];
  int r1 = i - start + 1;  // rank in the segment, 1-indexed
  int cost = pacer_cost(__int2float_rn(acq_i), acq_i, cnt, tb.cost1[g]);
  int latest0 = latest[g];
  bool imm0 = wrap_add(latest0, cost) <= ts;
  const int big = 1 << 30;
  int safe = max(cost, 1);
  // The grant cap by division only: rank x cost may overflow int32.
  int g_imm = cost > 0 ? wrap_add(1, floordiv(maxq, safe)) : big;
  int g_queue = cost > 0 ? max(floordiv(wrap_sub(wrap_add(ts, maxq), latest0), safe), 0)
                         : (wrap_sub(latest0, ts) <= maxq ? big : 0);
  int cap = cnt > 0.0f ? (imm0 ? g_imm : g_queue) : 0;
  bool okv = !v || r1 <= cap;
  int wait_r = imm0 ? wrap_mul(r1 - 1, cost) : wrap_sub(wrap_add(latest0, wrap_mul(r1, cost)), ts);
  ok[p] = okv ? 1 : 0;
  wait[p] = (v && okv && wait_r > 0) ? wait_r : 0;
  bool seg_end = i == s - 1 || key_of(key_s[i + 1]) != key;
  if (seg_end && v) {
    int granted = min(r1, cap);
    new_latest[i] = granted > 0 ? (imm0 ? wrap_add(ts, wrap_mul(granted - 1, cost))
                                        : wrap_add(latest0, wrap_mul(granted, cost)))
                                : latest0;
  }
}

__global__ void sh_commit(int s, int nr, const int64_t* __restrict__ key_s, const int64_t* __restrict__ perm,
                          const uint8_t* __restrict__ valid, const int* __restrict__ new_latest,
                          int* __restrict__ latest) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  int key = key_of(key_s[i]);
  bool seg_end = i == s - 1 || key_of(key_s[i + 1]) != key;
  if (seg_end && valid[perm[i]]) latest[clampi(key, 0, nr - 1)] = new_latest[i];
}

}  // namespace

extern "C" {

// Step 0 (flush only): the item inputs. live [n], ppc [nk] (slot order),
// the minute window's window_start [r_rows, nb] and counts [r_rows, nb, ne].
int shaping_inputs(const uint8_t* sv, const int* eidx, const int* flat_pos, const int* row, const int* ts, int s,
                   const uint8_t* live, int n, const int* ppc, int nk, const int* mws, const int* mcounts,
                   int r_rows, int nb, int ne, int wlen, uint8_t* valid_out, int* ppc_out, int* prev_out,
                   void* stream) {
  if (s <= 0) return 0;
  if (n <= 0 || nk <= 0 || r_rows <= 0 || nb <= 0 || wlen <= 0) return (int)cudaErrorInvalidValue;
  sh_inputs<<<blocks_for(s), THREADS, 0, (cudaStream_t)stream>>>(sv, eidx, flat_pos, row, ts, s, live, n, ppc, nk,
                                                                 mws, mcounts, r_rows, nb, ne, wlen, valid_out,
                                                                 ppc_out, prev_out);
  return (int)cudaGetLastError();
}

// Step 1: the sort keys.
int shaping_keys(const uint8_t* valid, const int* gid, const int* ts, int s, int nr, int64_t* keys, void* stream) {
  if (s <= 0) return 0;
  sh_keys<<<blocks_for(s), THREADS, 0, (cudaStream_t)stream>>>(valid, gid, ts, s, nr, keys);
  return (int)cudaGetLastError();
}

// Number of scan tiles for s items (the int2 partial scratch).
int shaping_tiles(int s) { return tiles_for(s); }

// Steps 3-5 (rounds >= 0) or 3'-4' (rounds == -1) after the sort. Scratch:
// partial int2 [tiles], contrib and excl int2 [s], heads int [s + 2].
int shaping_run(const int64_t* key_s, const int64_t* perm, int s, int nr, int rounds, const uint8_t* valid,
                const int* ts, const int* acq, const int* ppc, const int* prev, float interval_sec,
                const int* behavior, const float* count, const int* maxq, const int* cost1, const int* warn,
                const int* maxtok, const float* slope, const int* refill, int* latest, float* stored,
                int* lastfill, int* partial, int* contrib, int* excl, int* heads, uint8_t* ok, int* wait,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (s <= 0) return 0;
  if (nr <= 0) return (int)cudaErrorInvalidValue;
  Items it{valid, ts, acq, ppc, prev, interval_sec};
  Table tb{behavior, count, maxq, cost1, warn, maxtok, slope, refill};
  if (rounds == -1) {
    sh_closed<<<blocks_for(s), THREADS, 0, st>>>(s, nr, key_s, perm, it, tb, latest, ok, wait, excl);
    sh_commit<<<blocks_for(s), THREADS, 0, st>>>(s, nr, key_s, perm, valid, excl, latest);
    return (int)cudaGetLastError();
  }
  int tiles = tiles_for(s);
  int2* c2 = reinterpret_cast<int2*>(contrib);
  int2* x2 = reinterpret_cast<int2*>(excl);
  int2* p2 = reinterpret_cast<int2*>(partial);
  sh_init<<<blocks_for(s), THREADS, 0, st>>>(s, ok, wait);
  sh_flags<<<blocks_for(s), THREADS, 0, st>>>(key_s, s, c2);
  LoadContrib lc{c2};
  scan_reduce<SumOp, LoadContrib><<<tiles, THREADS, 0, st>>>(lc, s, p2);
  scan_partials<SumOp><<<1, THREADS, 0, st>>>(p2, tiles);
  scan_apply_sum<<<tiles, THREADS, 0, st>>>(lc, s, p2, x2);
  sh_heads<<<blocks_for(s), THREADS, 0, st>>>(c2, x2, s, heads);
  sh_walk<<<blocks_for(s), THREADS, 0, st>>>(s, nr, rounds, key_s, perm, heads, it, tb,
                                             Dyn{latest, stored, lastfill}, ok, wait);
  return (int)cudaGetLastError();
}

}  // extern "C"
