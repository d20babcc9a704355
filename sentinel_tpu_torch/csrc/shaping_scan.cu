// K9, the shaping recurrence for Hopper (sm_90a), with its inputs: the port
// of sentinel_tpu/rules/shaping.py:run_shaping over rules/recurrence.py:
// run_segmented, with _transition and _pacer_cost, and the flush's inputs
// to it (runtime/flush.py:_prev_second_pass and the gathers of
// flush_entries :759-764). RateLimiter, WarmUp and WarmUpRateLimiter
// (RateLimiterController.java:28-90, WarmUpController.java:84-175,
// WarmUpRateLimiterController.java:25-90).
//
// One C call, shaping_call, per shaping stage (driven by rules/shaping.py),
// in one of three modes set by the pointers of ShArgs:
// - run (live null): the items' pass-plus-charge and previous pass given;
// - stage (live and ok set): the inputs gathered first, as the flush's
//   shaping stage does: each item's validity masked by its entry's
//   liveness (written out), its slot's pass-plus-charge, the previous
//   second's pass of its row in the minute window;
// - inputs only (ok null): the gather alone, one launch.
// Invalid items are keyed past every rule and keep ok = 1, wait = 0. The
// order is JAX's (rule, ts, position). Two routes:
//
// - s <= small_max items (st.entry sends 8-64; at most SMALL_CAP): one
//   launch of one block of 1,024 threads. Inputs and keys, a bitonic sort
//   of (key, position) pairs in shared memory, then the heads, then each
//   head's thread walks its segment (a long one: its warp), barriers
//   between.
// - more items: sh_prep (the inputs gathered by item, keys, positions,
//   look-back state), one CUB radix sort of (key, position) pairs with
//   end_bit 32 + bits(nr + 1), sh_heads (one single-pass kernel: the
//   segment heads compacted by decoupled look-back, each item's fields
//   gathered once into a 32-byte record in sorted order, the outputs
//   initialised), then sh_walk, or for the closed form sh_closed. Scratch
//   from the caller's workspace.
//
// The walk (rounds >= 0; rounds > 0 stops a segment after that many items
// and leaves its state at the segment start, as JAX leaves it unresolved):
// a segment of at most LONG items is one thread's. A longer one is its
// warp's: the lanes load the next 32 records and compute their
// state-free parts (the pacer cost, passQps, the second) while the chain
// runs on the current 32, broadcast one by one (shuffles); every lane runs
// the same recurrence, lane j keeps item j's verdict. The recurrence stays
// serial within a rule, as JAX's lax.scan is; its per-item chain is only
// the rule's behavior (a segment is one rule), and the warm-up line's
// warning QPS is recomputed only when the stored tokens change.
// The closed form (rounds == -1, every item a plain RATE_LIMITER at one ts
// with one acquire): one thread per item ranks it in its segment from the
// segment-start state, which sh_heads put into its record; the segment's
// last item writes the new latest.
//
// What bounds it: launches for typical batches (each item reads about 30 B
// of batch, inputs and rule table and writes 5 B); a rule with thousands
// of items in one flush is serial, as it is in JAX's lax.scan. The closed
// form has no serial part.
//
// Numerics: float32 statement by statement as the JAX code runs on the
// CPU, with round-to-nearest intrinsics and no fast-math. XLA's CPU
// backend fuses a multiply feeding an add into an FMA, so
// above * slope + 1 / count and acquire / qps * 1000 + 0.5 are __fmaf_rn
// here (that fused result is the reference's). float -> int32 conversions
// saturate (__float2int_rz), as XLA's do: a WARM_UP_RATE_LIMITER cost at a
// count near 0 is far outside int32. Times wrap in int32 (uint32
// arithmetic); ts - ts % 1000 and the minute bucket use floor division
// and modulo. A valid item whose rule id lies outside [0, nr) counts as
// invalid, as in run_shaping_plain (the flush's ids lie in range).

#include <math.h>

#include <cub/device/device_radix_sort.cuh>

#include "bitonic.cuh"
#include "lookback.cuh"

// Everything one call reads and writes; rules/shaping.py fills the same
// layout (pointers first, then the ints, then the float). At file scope, so
// that the C entry point taking it keeps external linkage.
struct ShArgs {
  const int* behavior;  // [nr] the rule table (rules/flow_table.py)
  const float* count;
  const int* maxq;
  const int* cost1;
  const int* warn;
  const int* maxtok;
  const float* slope;
  const int* refill;
  int* latest;  // [nr] the rule state, updated in place
  float* stored;
  int* lastfill;
  const uint8_t* valid;  // [s] the items
  const int* gid;
  const int* ts;
  const int* acq;
  const int* ppc;        // [s] by item; with `live`, [nk] by slot
  const int* prev;       // [s] by item; unused with `live`
  const uint8_t* live;   // [n] entry liveness, or null: no gather
  const int* eidx;       // [s] the gather's item fields
  const int* flat_pos;
  const int* row;
  const int* mws;        // the minute window: [r_rows, nb] starts
  const int* mcounts;    // [r_rows, nb, ne]
  uint8_t* ok;           // [s], or null: the inputs only
  int* wait;
  uint8_t* valid_out;    // [s] with `live`: the masked validity
  int* ppc_out;          // [s] the inputs only: the gathered inputs
  int* prev_out;
  int s, nr, rounds, n, nk, r_rows, nb, ne, wlen, small_max;
  float interval_sec;
};

namespace {

constexpr int CB_WARM_UP = 1;  // models/constants.py
constexpr int CB_RATE_LIMITER = 2;
constexpr int CB_WARM_UP_RATE_LIMITER = 3;
constexpr int SMALL_CAP = 8192;  // items the one-block route can take
constexpr int LONG = 64;         // a longer segment is walked by its warp
constexpr int SMALL_THREADS = 1024;  // the one-block route's block

// ---------------------------------------------------------------------------
// the inputs
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool item_valid(const ShArgs& a, int i) {
  return a.valid[i] && (a.live == nullptr || a.live[clampi(a.eidx[i], 0, a.n - 1)]);
}

// The sort key: the rule + 1 over the ts; invalid items, and valid ones
// whose rule id lies outside [0, nr), nr + 1.
__device__ __forceinline__ u64 item_key(const ShArgs& a, int i, bool v) {
  return row_ts_key(v && (unsigned)a.gid[i] < (unsigned)a.nr ? a.gid[i] + 1 : a.nr + 1, a.ts[i]);
}

__device__ __forceinline__ int item_ppc(const ShArgs& a, int p) {
  return a.live ? a.ppc[clampi(a.flat_pos[p], 0, a.nk - 1)] : a.ppc[p];
}

// node.previousPassQps(): the minute window's bucket one second back.
__device__ __forceinline__ int gather_prev(const ShArgs& a, int p) {
  int tprev = wrap_sub(a.ts[p], a.wlen);
  int aligned = wrap_sub(tprev, floormod(tprev, a.wlen));
  int b = floormod(floordiv(tprev, a.wlen), a.nb);
  int64_t c = (int64_t)clampi(a.row[p], 0, a.r_rows - 1) * a.nb + b;
  return a.mws[c] == aligned ? a.mcounts[c * a.ne] : 0;  // event 0 = PASS
}

__device__ __forceinline__ int item_prev(const ShArgs& a, int p) { return a.live ? gather_prev(a, p) : a.prev[p]; }

// ---------------------------------------------------------------------------
// the recurrence
// ---------------------------------------------------------------------------

__device__ __forceinline__ int wrap_mul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }

// _pacer_cost: cost1 when acquire == 1, else floor(acquire / count * 1000 + 0.5).
__device__ __forceinline__ int pacer_cost(float acq_f, int acq_i, float cnt, int c1) {
  float q = __fdiv_rn(acq_f, fmaxf(cnt, 1e-9f));
  float generic = floorf(__fmaf_rn(q, 1000.0f, 0.5f));
  return __float2int_rz(acq_i == 1 ? __int2float_rn(c1) : generic);
}

// One item's inputs (a record in sorted order, or gathered in place).
struct Raw {
  int ts, acq, ppc, prev, pos, latest0;
};

// The rule of a segment, read once by its walker.
struct Rule {
  int b, mq, c1;
  float cnt, wn, mx, sl, rt, inv_cnt;
};

__device__ __forceinline__ Rule load_rule(const ShArgs& a, int g) {
  float cnt = a.count[g];
  return Rule{a.behavior[g], a.maxq[g], a.cost1[g], cnt, __int2float_rn(a.warn[g]), __int2float_rn(a.maxtok[g]),
              a.slope[g], __int2float_rn(a.refill[g]), __fdiv_rn(1.0f, fmaxf(cnt, 1e-9f))};
}

// What of an item does not depend on the rule's state.
struct Item {
  int ts, acq, sec, cost, pos;
  float acq_f, passq, prevq;
};

__device__ __forceinline__ Item make_item(const Raw& r, const Rule& u, float interval_sec) {
  Item x;
  x.ts = r.ts;
  x.acq = r.acq;
  x.pos = r.pos;
  x.acq_f = __int2float_rn(r.acq);
  x.sec = wrap_sub(r.ts, floormod(r.ts, 1000));
  // The pacer cost as _transition takes it: through float32 and back.
  x.cost = __float2int_rz(__int2float_rn(pacer_cost(x.acq_f, r.acq, u.cnt, u.c1)));
  x.passq = floorf(__fdiv_rn(__int2float_rn(r.ppc), interval_sec));
  x.prevq = __int2float_rn(r.prev);
  return x;
}

struct ShState {
  int latest;
  float stored;
  int lastfill;
  float wq;  // the warning QPS of `stored`
};

// The warm-up admitted QPS above the warning line.
__device__ __forceinline__ float warning_qps(float stored, const Rule& u) {
  float above = fmaxf(__fsub_rn(stored, u.wn), 0.0f);
  float inv = __fmaf_rn(above, u.sl, u.inv_cnt);
  return nextafterf(__fdiv_rn(1.0f, inv), INFINITY);
}

__device__ __forceinline__ bool is_wu(int b) { return b == CB_WARM_UP || b == CB_WARM_UP_RATE_LIMITER; }

__device__ __forceinline__ ShState load_state(const ShArgs& a, int g, const Rule& u) {
  ShState st{a.latest[g], a.stored[g], a.lastfill[g], 0.0f};
  if (is_wu(u.b)) st.wq = warning_qps(st.stored, u);
  return st;
}

// _transition for one valid item of the rule (shaping.py:84-149): only the
// rule's behavior is computed. The pacer state advances only for pacer
// behaviors, the warm-up state only through the sync.
__device__ __forceinline__ void sh_step(ShState& st, const Item& x, const Rule& u, bool& ok, int& wait) {
  if (is_wu(u.b) && x.sec > st.lastfill) {  // syncToken (WarmUpController.syncToken / coolDownTokens)
    float elapsed = __int2float_rn(wrap_sub(x.sec, st.lastfill));
    bool refill_ok = st.stored < u.wn || (st.stored > u.wn && x.prevq < u.rt);
    float refilled = fminf(floorf(__fadd_rn(st.stored, __fdiv_rn(__fmul_rn(elapsed, u.cnt), 1000.0f))), u.mx);
    float stored1 = refill_ok ? refilled : st.stored;
    st.stored = fmaxf(__fsub_rn(stored1, x.prevq), 0.0f);
    st.lastfill = x.sec;
    st.wq = warning_qps(st.stored, u);
  }
  ok = true;
  wait = 0;
  if (u.b == CB_WARM_UP) {
    float pa = __fadd_rn(x.passq, x.acq_f);
    ok = st.stored >= u.wn ? pa <= st.wq : pa <= u.cnt;
  } else if (u.b == CB_RATE_LIMITER || u.b == CB_WARM_UP_RATE_LIMITER) {
    int cost = x.cost;
    if (u.b == CB_WARM_UP_RATE_LIMITER && st.stored >= u.wn)
      cost = __float2int_rz(floorf(__fmaf_rn(__fdiv_rn(x.acq_f, st.wq), 1000.0f, 0.5f)));
    int expected = wrap_add(st.latest, cost);
    bool imm = expected <= x.ts;
    int w = wrap_sub(expected, x.ts);
    bool queued = !imm && w <= u.mq;
    ok = ((imm || queued) && u.cnt > 0.0f) || x.acq <= 0;  // acquire <= 0 always passes
    if (ok && x.acq > 0) st.latest = imm ? x.ts : expected;
    wait = (queued && ok) ? w : 0;
  }
}

__device__ __forceinline__ int walk_limit(const ShArgs& a, int n) { return a.rounds > 0 ? min(a.rounds, n) : n; }

__device__ __forceinline__ void store_state(const ShArgs& a, int g, const ShState& st) {
  a.latest[g] = st.latest;
  a.stored[g] = st.stored;
  a.lastfill[g] = st.lastfill;
}

// One thread walks the segment [start, start + n) of rule g in order; the
// state is written back when the walk finished the segment.
template <class Load>
__device__ void walk_thread(const ShArgs& a, const Load& ld, int start, int n, int g) {
  const Rule u = load_rule(a, g);
  ShState st = load_state(a, g, u);
  const int limit = walk_limit(a, n);
  for (int i = start; i < start + limit; ++i) {
    Item x = make_item(ld(a, i), u, a.interval_sec);
    bool okv;
    int w;
    sh_step(st, x, u, okv, w);
    a.ok[x.pos] = okv ? 1 : 0;
    a.wait[x.pos] = w;
  }
  if (limit == n) store_state(a, g, st);
}

__device__ __forceinline__ Item shfl_item(const Item& x, int j) {
  Item y;
  y.ts = __shfl_sync(FULL_MASK, x.ts, j);
  y.acq = __shfl_sync(FULL_MASK, x.acq, j);
  y.sec = __shfl_sync(FULL_MASK, x.sec, j);
  y.cost = __shfl_sync(FULL_MASK, x.cost, j);
  y.pos = __shfl_sync(FULL_MASK, x.pos, j);
  y.acq_f = __shfl_sync(FULL_MASK, x.acq_f, j);
  y.passq = __shfl_sync(FULL_MASK, x.passq, j);
  y.prevq = __shfl_sync(FULL_MASK, x.prevq, j);
  return y;
}

// The whole warp walks a long segment: lane l holds item base + l of the
// current 32 and loads and prepares its next one while every lane runs the
// chain on the current ones, broadcast in order; lane j keeps item j's
// verdict.
template <class Load>
__device__ void walk_warp(const ShArgs& a, const Load& ld, int start, int n, int g) {
  const int lane = threadIdx.x & 31;
  const int limit = walk_limit(a, n);
  const Rule u = load_rule(a, g);
  ShState st = load_state(a, g, u);
  Item cur{};
  if (lane < limit) cur = make_item(ld(a, start + lane), u, a.interval_sec);
  for (int base = 0; base < limit; base += 32) {
    const int m = min(32, limit - base);
    Item nxt{};
    if (base + 32 + lane < limit) nxt = make_item(ld(a, start + base + 32 + lane), u, a.interval_sec);
    bool my_ok = true;
    int my_wait = 0;
    for (int j = 0; j < m; ++j) {
      Item x = shfl_item(cur, j);
      bool okv;
      int w;
      sh_step(st, x, u, okv, w);
      if (lane == j) {
        my_ok = okv;
        my_wait = w;
      }
    }
    if (lane < m) {
      a.ok[cur.pos] = my_ok ? 1 : 0;
      a.wait[cur.pos] = my_wait;
    }
    cur = nxt;
  }
  if (lane == 0 && limit == n) store_state(a, g, st);
}

// The closed-form pacer path (shaping.py:220-282) for sorted item i of the
// valid segment starting at `start`, from the segment-start latest0; the
// segment's last item (seg_end) writes the new latest.
__device__ __forceinline__ void closed_item(const ShArgs& a, const Raw& r, int g, int start, int i, bool seg_end) {
  float cnt = a.count[g];
  int maxq = a.maxq[g];
  int r1 = i - start + 1;  // rank in the segment, 1-indexed
  int cost = pacer_cost(__int2float_rn(r.acq), r.acq, cnt, a.cost1[g]);
  int latest0 = r.latest0;
  bool imm0 = wrap_add(latest0, cost) <= r.ts;
  const int big = 1 << 30;
  int safe = max(cost, 1);
  // The grant cap by division only: rank x cost may overflow int32.
  int g_imm = cost > 0 ? wrap_add(1, floordiv(maxq, safe)) : big;
  int g_queue = cost > 0 ? max(floordiv(wrap_sub(wrap_add(r.ts, maxq), latest0), safe), 0)
                         : (wrap_sub(latest0, r.ts) <= maxq ? big : 0);
  int cap = cnt > 0.0f ? (imm0 ? g_imm : g_queue) : 0;
  bool okv = r1 <= cap;
  int wait_r = imm0 ? wrap_mul(r1 - 1, cost) : wrap_sub(wrap_add(latest0, wrap_mul(r1, cost)), r.ts);
  a.ok[r.pos] = okv ? 1 : 0;
  a.wait[r.pos] = (okv && wait_r > 0) ? wait_r : 0;
  if (seg_end) {
    int granted = min(r1, cap);
    a.latest[g] = granted > 0 ? (imm0 ? wrap_add(r.ts, wrap_mul(granted - 1, cost))
                                      : wrap_add(latest0, wrap_mul(granted, cost)))
                              : latest0;
  }
}

// ---------------------------------------------------------------------------
// the inputs alone
// ---------------------------------------------------------------------------

__global__ void sh_gather(ShArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.s) return;
  a.valid_out[i] = item_valid(a, i) ? 1 : 0;
  a.ppc_out[i] = item_ppc(a, i);
  a.prev_out[i] = gather_prev(a, i);
}

// ---------------------------------------------------------------------------
// one block: s <= small_max
// ---------------------------------------------------------------------------

// Items gathered through the sorted positions; ppc and prev were gathered
// into shared memory by item.
struct SmallLoad {
  const unsigned short* val;
  const int* ppc;
  const int* prev;
  __device__ Raw operator()(const ShArgs& a, int i) const {
    int p = val[i];
    return Raw{a.ts[p], a.acq[p], ppc[p], prev[p], p, 0};
  }
};

// Dynamic shared memory: p2 keys, p2 positions, then by item ppc, prev and
// (closed form) the segment-start latest of each sorted position.
__global__ void __launch_bounds__(SMALL_THREADS) sh_small(ShArgs a, int p2) {
  extern __shared__ u64 key[];
  int* ppc = reinterpret_cast<int*>(key + p2);
  int* prev = ppc + a.s;
  int* lat0 = prev + a.s;
  unsigned short* val = reinterpret_cast<unsigned short*>(lat0 + a.s);
  __shared__ int2 longs[SMALL_CAP / LONG];
  __shared__ int n_long;
  for (int i = threadIdx.x; i < p2; i += SMALL_THREADS) {
    val[i] = (unsigned short)i;
    if (i < a.s) {
      bool v = item_valid(a, i);
      key[i] = item_key(a, i, v);
      if (a.live) a.valid_out[i] = v ? 1 : 0;
      ppc[i] = item_ppc(a, i);
      prev[i] = item_prev(a, i);
      a.ok[i] = 1;
      a.wait[i] = 0;
    } else {
      key[i] = SENTINEL;
    }
  }
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
  bitonic_sort_pairs(key, val, p2);
  const SmallLoad ld{val, ppc, prev};
  const int ipt = (p2 + SMALL_THREADS - 1) / SMALL_THREADS;
  const int j0 = threadIdx.x * ipt;
  const int j1 = min(j0 + ipt, a.s);
  if (a.rounds == -1) {
    // Every segment-start latest is read before any segment end writes.
    for (int j = j0; j < j1; ++j) {
      int hi = key_row(key[j]);
      if (hi <= a.nr) lat0[j] = a.latest[clampi(hi - 1, 0, a.nr - 1)];
    }
    __syncthreads();
    for (int j = j0; j < j1; ++j) {
      int hi = key_row(key[j]);
      if (hi > a.nr) continue;  // invalid: ok = 1, wait = 0
      int start = lower_bound(key, a.s, (u64)(unsigned)hi << 32);
      Raw r = ld(a, j);
      r.latest0 = lat0[j];
      closed_item(a, r, clampi(hi - 1, 0, a.nr - 1), start, j, j + 1 == a.s || key_row(key[j + 1]) != hi);
    }
    return;
  }
  for (int j = j0; j < j1; ++j) {
    int hi = key_row(key[j]);
    if (hi > a.nr || (j > 0 && key_row(key[j - 1]) == hi)) continue;  // not a valid segment's head
    int end = j + lower_bound(key + j, a.s - j, (u64)(unsigned)(hi + 1) << 32);
    int g = clampi(hi - 1, 0, a.nr - 1);
    if (walk_limit(a, end - j) > LONG)
      longs[atomicAdd(&n_long, 1)] = make_int2(j, end);
    else
      walk_thread(a, ld, j, end - j, g);
  }
  __syncthreads();
  for (int l = threadIdx.x >> 5; l < n_long; l += SMALL_THREADS / 32) {
    int hi = key_row(key[longs[l].x]);
    walk_warp(a, ld, longs[l].x, longs[l].y - longs[l].x, clampi(hi - 1, 0, a.nr - 1));
  }
}

// ---------------------------------------------------------------------------
// many blocks: any s
// ---------------------------------------------------------------------------

// The inputs' validity, the sort keys and positions, the look-back state;
// with `live`, each valid item's gathered pass-plus-charge and previous
// pass by item (`in2`), so that sh_heads reads one word pair per item.
__global__ void sh_prep(ShArgs a, u64* __restrict__ key, int* __restrict__ val, int2* __restrict__ in2,
                        u64* __restrict__ status, int n_status, int* __restrict__ ctl) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_status) status[i] = 0;
  if (i == 0) *ctl = 0;
  if (i < a.s) {
    bool v = item_valid(a, i);
    key[i] = item_key(a, i, v);
    val[i] = i;
    if (a.live) {
      a.valid_out[i] = v ? 1 : 0;
      if (v) in2[i] = make_int2(item_ppc(a, i), gather_prev(a, i));
    }
  }
}

// Records in sorted order: {ts, acq, ppc, prev}, {pos, latest0, -, -}.
struct RecLoad {
  const int4* rec;
  __device__ Raw operator()(const ShArgs&, int i) const {
    int4 u = rec[2 * i], v = rec[2 * i + 1];
    return Raw{u.x, u.y, u.z, u.w, v.x, v.y};
  }
};

// Single pass over the sorted items: the segment heads compacted into
// heads[0, nseg) (heads[nseg] = s, heads[s + 1] = nseg), each valid item's
// inputs gathered into its record in sorted order (for the closed form
// with its rule's latest before the call), every output's first value
// (ok = 1, wait = 0).
__global__ void __launch_bounds__(THREADS)
    sh_heads(ShArgs a, const u64* __restrict__ ks, const int* __restrict__ vs, const int2* __restrict__ in2,
             int4* __restrict__ rec, int* __restrict__ heads, u64* status, int nt, int* ctl) {
  __shared__ int s_tile;
  if (threadIdx.x == 0) s_tile = atomicAdd(ctl, 1);
  __syncthreads();
  LookBack<1> lb{status, nt, s_tile, 0};
  const int base = s_tile * TILE + threadIdx.x * IPT;
  int p[IPT], hi[IPT];
  bool head[IPT];
  int local = 0;
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    int i = base + q;
    p[q] = -1;
    head[q] = false;
    if (i >= a.s) continue;
    hi[q] = key_row(ks[i]);
    head[q] = i == 0 || key_row(ks[i - 1]) != hi[q];
    local += head[q] ? 1 : 0;
    p[q] = vs[i];
  }
  // Every field is loaded before anything is stored, and the loads are in
  // flight during the look-back.
  int4 r[IPT];
  int lat0[IPT];
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    if (p[q] < 0 || hi[q] > a.nr) continue;  // invalid: no record is read
    int2 pp = a.live ? in2[p[q]] : make_int2(a.ppc[p[q]], a.prev[p[q]]);
    r[q] = make_int4(a.ts[p[q]], a.acq[p[q]], pp.x, pp.y);
    lat0[q] = a.rounds == -1 ? a.latest[clampi(hi[q] - 1, 0, a.nr - 1)] : 0;
  }
  int total;
  int idx = compact_index(local, lb, total);
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    int i = base + q;
    if (p[q] < 0) continue;
    a.ok[p[q]] = 1;
    a.wait[p[q]] = 0;
    if (hi[q] <= a.nr) {
      rec[2 * i] = r[q];
      rec[2 * i + 1] = make_int4(p[q], lat0[q], 0, 0);
    }
    if (head[q]) heads[idx++] = i;
    if (i == a.s - 1) {
      heads[idx] = a.s;
      heads[a.s + 1] = idx;
    }
  }
}

// One thread per segment; the block's long segments go to its warps.
__global__ void __launch_bounds__(THREADS)
    sh_walk(ShArgs a, const u64* __restrict__ ks, const int4* __restrict__ rec, const int* __restrict__ heads) {
  __shared__ int2 longs[THREADS];
  __shared__ int n_long;
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
  const RecLoad ld{rec};
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h < heads[a.s + 1]) {
    int start = heads[h], end = heads[h + 1];
    int hi = key_row(ks[start]);
    if (hi <= a.nr) {  // invalid items keep ok = 1, wait = 0
      if (walk_limit(a, end - start) > LONG)
        longs[atomicAdd(&n_long, 1)] = make_int2(start, end);
      else
        walk_thread(a, ld, start, end - start, clampi(hi - 1, 0, a.nr - 1));
    }
  }
  __syncthreads();
  for (int l = threadIdx.x >> 5; l < n_long; l += NWARPS) {
    int hi = key_row(ks[longs[l].x]);
    walk_warp(a, ld, longs[l].x, longs[l].y - longs[l].x, clampi(hi - 1, 0, a.nr - 1));
  }
}

__global__ void sh_closed(ShArgs a, const u64* __restrict__ ks, const int4* __restrict__ rec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.s) return;
  int hi = key_row(ks[i]);
  if (hi > a.nr) return;  // invalid: ok = 1, wait = 0 already
  int start = lower_bound(ks, a.s, (u64)(unsigned)hi << 32);
  closed_item(a, RecLoad{rec}(a, i), clampi(hi - 1, 0, a.nr - 1), start, i,
              i + 1 == a.s || key_row(ks[i + 1]) != hi);
}

// Workspace of the many-block route: keys and positions in and out, the
// gathered inputs by item, the records, the heads, one look-back walk, the
// tile counter, CUB's temp storage.
struct Layout {
  size_t key_in, key_out, val_in, val_out, in2, rec, heads, status, ctl, temp, total;
  int nt;
};

Layout layout(int s) {
  Layout l;
  l.nt = tiles_for(s);
  size_t temp = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, temp, (const u64*)nullptr, (u64*)nullptr, (const int*)nullptr,
                                  (int*)nullptr, s, 0, 64);
  size_t k8 = align256(sizeof(u64) * (size_t)s), k4 = align256(sizeof(int) * (size_t)s);
  l.key_in = 0;
  l.key_out = l.key_in + k8;
  l.val_in = l.key_out + k8;
  l.val_out = l.val_in + k4;
  l.in2 = l.val_out + k4;
  l.rec = l.in2 + k8;
  l.heads = l.rec + align256(sizeof(int4) * 2 * (size_t)s);
  l.status = l.heads + align256(sizeof(int) * ((size_t)s + 2));
  l.ctl = l.status + align256(sizeof(u64) * (size_t)l.nt);
  l.temp = l.ctl + 256;
  l.total = l.temp + align256(temp);
  return l;
}

bool one_block(const ShArgs& a) { return a.s <= a.small_max; }

}  // namespace

extern "C" {

// Bytes of workspace shaping_call needs (0 for the one-block route and for
// the inputs alone).
long long shaping_workspace(const ShArgs* args) {
  const ShArgs& a = *args;
  return (a.ok == nullptr || one_block(a)) ? 0 : (long long)layout(a.s).total;
}

// One call (see the header); `args` is read on the host. Returns a CUDA
// error code, or -1 when the workspace is smaller than shaping_workspace.
int shaping_call(const ShArgs* args, void* workspace, long long workspace_bytes, cudaStream_t stream) {
  const ShArgs a = *args;
  if (a.s <= 0) return 0;
  if (a.s >= (1 << 28) || a.small_max < 0 || a.small_max > SMALL_CAP) return (int)cudaErrorInvalidValue;
  if (a.live && (a.n <= 0 || a.nk <= 0 || a.r_rows <= 0 || a.nb <= 0 || a.wlen <= 0))
    return (int)cudaErrorInvalidValue;
  if (a.ok == nullptr) {
    sh_gather<<<blocks_for(a.s), THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (a.nr <= 0) return (int)cudaErrorInvalidValue;
  if (one_block(a)) {
    int p2 = 1;
    while (p2 < a.s) p2 <<= 1;
    size_t smem = sizeof(u64) * (size_t)p2 + sizeof(int) * 3 * (size_t)a.s + sizeof(unsigned short) * (size_t)p2;
    // A block asks for more than the default 48 KB, which the static arrays
    // share with the dynamic bytes.
    if (smem > 40 * 1024) {
      int err = (int)cudaFuncSetAttribute(sh_small, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err) return err;
    }
    sh_small<<<1, SMALL_THREADS, smem, stream>>>(a, p2);
    return (int)cudaGetLastError();
  }
  Layout l = layout(a.s);
  if (workspace_bytes < (long long)l.total) return -1;
  char* ws = (char*)workspace;
  u64* key_in = (u64*)(ws + l.key_in);
  u64* key_out = (u64*)(ws + l.key_out);
  int* val_in = (int*)(ws + l.val_in);
  int* val_out = (int*)(ws + l.val_out);
  int2* in2 = (int2*)(ws + l.in2);
  int4* rec = (int4*)(ws + l.rec);
  int* heads = (int*)(ws + l.heads);
  u64* status = (u64*)(ws + l.status);
  int* ctl = (int*)(ws + l.ctl);
  size_t temp_bytes = l.total - l.temp;
  sh_prep<<<blocks_for(max(a.s, l.nt)), THREADS, 0, stream>>>(a, key_in, val_in, in2, status, l.nt, ctl);
  int err = (int)cub::DeviceRadixSort::SortPairs(ws + l.temp, temp_bytes, key_in, key_out, val_in, val_out, a.s, 0,
                                                 32 + bits_for((long long)a.nr + 1), stream);
  if (err) return err;
  sh_heads<<<l.nt, THREADS, 0, stream>>>(a, key_out, val_out, in2, rec, heads, status, l.nt, ctl);
  if (a.rounds == -1)  // the closed form reads the records, not the heads
    sh_closed<<<blocks_for(a.s), THREADS, 0, stream>>>(a, key_out, rec);
  else
    sh_walk<<<blocks_for(a.s), THREADS, 0, stream>>>(a, key_out, rec, heads);
  return (int)cudaGetLastError();
}

}  // extern "C"
