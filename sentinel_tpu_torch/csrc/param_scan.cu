// K10, the hot-parameter recurrence for Hopper (sm_90a): the port of
// sentinel_tpu/rules/param_table.py:run_param with _transition and
// _seg_end_rows (ParamFlowChecker.java:46-280): per (rule, value) row, the
// token bucket (passDefaultLocalCheck), the throttle pacer
// (passThrottleLocalCheck) and the per-value thread gauge.
//
// One C call, param_run, per batch (driven by rules/param_table.py). In
// order: the LRU resets (rows recycled back to "never seen"), one key per
// item (row << 32 | ts ^ 2^31, invalid items keyed past every row), the
// (row, ts, position) order, the row segments, then for rounds >= 0 the
// walk (at most `rounds` items a segment when rounds > 0) or for rounds <=
// -1 the closed-form rank path (QPS-grade DEFAULT items with one acquire,
// at most -rounds timestamp sub-segments a row). Two routes:
//
// - s <= SMALL_MAX items (st.entry sends 8-64): one launch of one block.
//   Resets, keys, a bitonic sort of (key, position) pairs in shared
//   memory, then each head's thread walks its segment (or runs its
//   sub-segments), barriers between the steps.
// - more items: pa_prep (resets, keys, positions, look-back state), one
//   CUB radix sort of (key, position) pairs with end_bit 32 +
//   bits(pr), pa_heads (one single-pass kernel: the segment heads
//   compacted by decoupled look-back, each item's fields gathered once
//   into a 32-byte record in sorted order, the outputs initialised), then
//   pa_walk, or pa_subsegs and pa_closed. Scratch from the caller's
//   workspace.
//
// The walk: a segment of at most LONG items is one thread's, reading its
// records in order. A longer one is its warp's: the lanes load the next
// 32 records while the chain runs on the current 32, broadcast one by one
// (shuffles); every lane runs the same recurrence, lane j keeps item j's
// verdict. The recurrence stays serial within a row, as JAX's lax.scan is.
// The closed form keeps its shape: one thread per row carries the state
// across the sub-segments (binary search, so a heavy value with thousands
// of items at one ts costs O(log S)), one thread per item ranks it.
//
// What bounds it: launches, and on a heavy row the chain's latency: an
// item reads 32 B of record and writes 5 B, its step is some fifty
// dependent integer operations with a division.
//
// Numerics: all int32, wrapping as JAX's int32 arithmetic does
// (pass_time * token_count and every sum in uint32); (pass_time * tc) //
// duration and avail // acquire are floor divisions; the throttle queues
// a wait strictly below maxQueueingTimeMs (ParamFlowChecker.java:258).

#include <cub/device/device_radix_sort.cuh>

#include "bitonic.cuh"
#include "lookback.cuh"

// Everything one call reads and writes; rules/param_table.py fills the
// same layout (pointers first, then the ints). At file scope, so that the
// C entry point taking it keeps external linkage.
struct PaArgs {
  const int* reset_rows;  // [q] rows recycled by LRU eviction (-1 pad)
  const uint8_t* valid;   // [s]
  const int* prow;
  const int* ts;
  const int* acq;
  const int* grade;
  const int* beh;
  const int* tc;
  const int* burst;
  const int* dur;
  const int* maxq;
  const int* cost;
  int* tokens;            // [pr] the row state
  int* last_add;
  int* latest;
  int* threads;
  uint8_t* ok;            // [s]
  int* wait;
  int s, q, pr, rounds;
};

namespace {

constexpr int PARAM_NEVER = -(1 << 30);  // rules/param_table.py
constexpr int FLOW_GRADE_QPS = 1;        // models/constants.py
constexpr int CB_RATE_LIMITER = 2;
constexpr int SMALL_MAX = 2048;          // items of the one-block route
constexpr int LONG = 64;                 // a longer segment is walked by its warp

// One item's fields in sorted order: meta = position << 3 | throttle << 2
// | QPS grade << 1 | valid; dur is clamped to >= 1.
struct Rec {
  int ts, acq, tc, burst, dur, maxq, cost, meta;
};

struct PaState {
  int tokens, last, latest, thr_used;
};

__device__ __forceinline__ int wrap_mul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }

__device__ __forceinline__ Rec make_rec(const PaArgs& a, int p) {
  bool qps = a.grade[p] == FLOW_GRADE_QPS;
  bool throttle = qps && a.beh[p] == CB_RATE_LIMITER;
  return Rec{a.ts[p], a.acq[p], a.tc[p], a.burst[p], max(a.dur[p], 1), a.maxq[p], a.cost[p],
             (p << 3) | (throttle ? 4 : 0) | (qps ? 2 : 0) | (a.valid[p] ? 1 : 0)};
}

// The sort key of item i: its row (clamped into [0, pr]; pr for an invalid
// item) over its ts, sign flipped.
__device__ __forceinline__ u64 item_key(const PaArgs& a, int i) {
  return row_ts_key(a.valid[i] ? clampi(a.prow[i], 0, a.pr) : a.pr, a.ts[i]);
}

__device__ __forceinline__ void reset_row(const PaArgs& a, int r) {
  if (r < 0 || r >= a.pr) return;  // padding, or a row past the state: dropped
  a.tokens[r] = 0;
  a.last_add[r] = PARAM_NEVER;
  a.latest[r] = PARAM_NEVER;
  a.threads[r] = 0;
}

// _transition for one item (param_table.py:169-230). Only the behavior in
// effect is computed, and the refill's division only on a refill: the
// heavy row's chain runs one item after another on one warp.
__device__ __forceinline__ void pa_step(PaState& st, const Rec& x, int g_threads, bool& ok, int& wait) {
  const bool valid = x.meta & 1, is_qps = x.meta & 2, is_throttle = x.meta & 4;
  const int tc = x.tc, ts = x.ts;
  bool okv;
  wait = 0;
  if (is_throttle) {  // passThrottleLocalCheck
    bool t_never = st.latest == PARAM_NEVER;
    int expected = wrap_add(st.latest, x.cost);
    bool th_imm = expected <= ts;
    int th_wait = wrap_sub(expected, ts);
    bool th_q = !th_imm && th_wait < x.maxq;  // strictly below
    okv = (t_never || th_imm || th_q) && tc > 0;
    if (valid && okv) {
      st.latest = (t_never || th_imm) ? ts : expected;
      wait = (th_q && !t_never) ? max(th_wait, 0) : 0;
    }
  } else if (is_qps) {  // the token bucket (passDefaultLocalCheck)
    const int acq = x.acq;
    int max_count = wrap_add(tc, x.burst);
    bool never = st.last == PARAM_NEVER;
    int pass_time = wrap_sub(ts, st.last);
    bool refill_win = pass_time > x.dur;
    bool cand_ok;
    int tokens2;
    if (never) {
      cand_ok = true;
      tokens2 = wrap_sub(max_count, acq);
    } else if (refill_win) {
      int to_add = floordiv(wrap_mul(pass_time, tc), x.dur);
      int new_qps = wrap_add(to_add, st.tokens) > max_count ? wrap_sub(max_count, acq)
                                                            : wrap_sub(wrap_add(st.tokens, to_add), acq);
      cand_ok = new_qps >= 0;
      tokens2 = cand_ok ? new_qps : st.tokens;
    } else {
      tokens2 = wrap_sub(st.tokens, acq);
      cand_ok = tokens2 >= 0;
    }
    okv = cand_ok && tc > 0 && acq <= max_count;
    if (valid && okv) {
      st.tokens = tokens2;
      if (never || refill_win) st.last = ts;
    }
  } else {  // the per-value thread grade
    okv = wrap_add(wrap_add(g_threads, st.thr_used), 1) <= tc;
    if (valid) st.thr_used = wrap_add(st.thr_used, okv ? 1 : 0);
  }
  ok = okv || !valid;
}

// Records in sorted order (the many-block route).
struct RecLoad {
  const int4* rec;
  __device__ Rec operator()(const PaArgs&, int i) const {
    int4 u = rec[2 * i], v = rec[2 * i + 1];
    return Rec{u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
  }
};

// Fields gathered through the sorted positions (the one-block route).
struct GatherLoad {
  const unsigned short* val;
  __device__ Rec operator()(const PaArgs& a, int i) const { return make_rec(a, val[i]); }
};

// The walk limit of a segment of n items.
__device__ __forceinline__ int walk_limit(const PaArgs& a, int n) { return a.rounds > 0 ? min(a.rounds, n) : n; }

// One thread walks the segment [start, start + n) of row r in order. The
// thread charge restarts at 0 per segment, on the gauge as it stands
// after this flush's exit releases. The row state is written only when
// the walk finished the segment and its last item is valid.
template <class Load>
__device__ void walk_thread(const PaArgs& a, const Load& ld, int start, int n, int r) {
  PaState st{a.tokens[r], a.last_add[r], a.latest[r], 0};
  const int g = a.threads[r];
  const int limit = walk_limit(a, n);
  bool last_valid = false;
  for (int i = start; i < start + limit; ++i) {
    Rec x = ld(a, i);
    bool okv;
    int w;
    pa_step(st, x, g, okv, w);
    int p = x.meta >> 3;
    a.ok[p] = okv ? 1 : 0;
    a.wait[p] = w;
    last_valid = x.meta & 1;
  }
  if (limit == n && last_valid) {
    a.tokens[r] = st.tokens;
    a.last_add[r] = st.last;
    a.latest[r] = st.latest;
  }
}

__device__ __forceinline__ Rec shfl_rec(const Rec& x, int j) {
  return Rec{__shfl_sync(FULL_MASK, x.ts, j),    __shfl_sync(FULL_MASK, x.acq, j),
             __shfl_sync(FULL_MASK, x.tc, j),    __shfl_sync(FULL_MASK, x.burst, j),
             __shfl_sync(FULL_MASK, x.dur, j),   __shfl_sync(FULL_MASK, x.maxq, j),
             __shfl_sync(FULL_MASK, x.cost, j),  __shfl_sync(FULL_MASK, x.meta, j)};
}

// The whole warp walks a long segment: lane l holds record base + l of the
// current 32 and loads its next one while every lane runs the chain on the
// current ones, broadcast in order; lane j keeps item j's verdict.
template <class Load>
__device__ void walk_warp(const PaArgs& a, const Load& ld, int start, int n, int r) {
  const int lane = threadIdx.x & 31;
  const int limit = walk_limit(a, n);
  PaState st{a.tokens[r], a.last_add[r], a.latest[r], 0};
  const int g = a.threads[r];
  Rec cur = lane < limit ? ld(a, start + lane) : Rec{};
  bool last_valid = false;
  for (int base = 0; base < limit; base += 32) {
    const int m = min(32, limit - base);
    Rec nxt{};
    if (base + 32 + lane < limit) nxt = ld(a, start + base + 32 + lane);
    bool my_ok = true;
    int my_wait = 0;
    for (int j = 0; j < m; ++j) {
      Rec x = shfl_rec(cur, j);
      bool okv;
      int w;
      pa_step(st, x, g, okv, w);
      if (lane == j) {
        my_ok = okv;
        my_wait = w;
      }
      last_valid = x.meta & 1;
    }
    if (lane < m) {
      int p = cur.meta >> 3;
      a.ok[p] = my_ok ? 1 : 0;
      a.wait[p] = my_wait;
    }
    cur = nxt;
  }
  if (lane == 0 && limit == n && last_valid) {
    a.tokens[r] = st.tokens;
    a.last_add[r] = st.last;
    a.latest[r] = st.latest;
  }
}

// The budget of one (row, ts) sub-segment for item x, from the state
// before it (param_table.py:325-357).
struct Budget {
  int avail, cap;
  bool gate, never, refill;
};

__device__ __forceinline__ Budget pa_budget(const Rec& x, int cur_tokens, int cur_last) {
  Budget b;
  int max_count = wrap_add(x.tc, x.burst);
  b.gate = x.tc > 0 && x.acq <= max_count;
  b.never = cur_last == PARAM_NEVER;
  int pass_time = wrap_sub(x.ts, cur_last);
  b.refill = pass_time > x.dur;
  int to_add = floordiv(wrap_mul(pass_time, x.tc), x.dur);
  b.avail = b.never ? max_count : (b.refill ? min(wrap_add(cur_tokens, to_add), max_count) : cur_tokens);
  b.cap = b.gate ? floordiv(b.avail, max(x.acq, 1)) : 0;
  return b;
}

// The closed form for the row segment [start, end) of row r: the row state
// through its sub-segments, carried across at most nseg_max of them.
// Scratch at each sub-segment's first position: the state before it and
// its index in the row.
template <class Load, class T>
__device__ void subsegs(const PaArgs& a, const u64* ks, const Load& ld, int start, int end, int r, int nseg_max,
                        int* sub_tok, int* sub_last, T* sub_idx) {
  int cur_tokens = a.tokens[r], cur_last = a.last_add[r];
  int si = 0;
  for (int j = start; j < end; ++si) {
    int j2 = j + lower_bound(ks + j, end - j, ks[j] + 1);
    sub_tok[j] = cur_tokens;
    sub_last[j] = cur_last;
    sub_idx[j] = (T)min(si, nseg_max);
    Rec xl = ld(a, j2 - 1);  // the sub-segment's last item writes the state
    if (si < nseg_max && (xl.meta & 1)) {
      Budget b = pa_budget(xl, cur_tokens, cur_last);
      int granted = min(j2 - j, b.cap);
      if (granted > 0) {
        cur_tokens = wrap_sub(b.avail, wrap_mul(granted, xl.acq));
        if (b.never || b.refill) cur_last = xl.ts;
      }
    }
    j = j2;
  }
  a.tokens[r] = cur_tokens;
  a.last_add[r] = cur_last;
}

// The closed form's verdict of sorted item i: its rank in its sub-segment
// against the budget floor(avail / acquire) from the sub-segment's start.
template <class Load, class T>
__device__ void closed_item(const PaArgs& a, const u64* ks, const Load& ld, int i, int nseg_max, const int* sub_tok,
                            const int* sub_last, const T* sub_idx) {
  Rec x = ld(a, i);
  if (!(x.meta & 1) || key_row(ks[i]) >= a.pr) return;  // ok = 1 already
  int p = x.meta >> 3;
  int ss = lower_bound(ks, a.s, ks[i]);  // the sub-segment's first position
  if ((int)sub_idx[ss] >= nseg_max) {
    a.ok[p] = 0;  // beyond the host's bound: JAX leaves such items blocked
    return;
  }
  Budget b = pa_budget(x, sub_tok[ss], sub_last[ss]);
  a.ok[p] = (b.gate && i - ss < b.cap) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// one block: s <= SMALL_MAX
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) pa_small(PaArgs a) {
  __shared__ u64 key[SMALL_MAX];
  __shared__ unsigned short val[SMALL_MAX];
  __shared__ int sub_tok[SMALL_MAX], sub_last[SMALL_MAX];
  __shared__ unsigned short sub_idx[SMALL_MAX];
  __shared__ int2 longs[SMALL_MAX / LONG];
  __shared__ int n_long;
  for (int i = threadIdx.x; i < a.q; i += THREADS) reset_row(a, a.reset_rows[i]);
  int p2 = 1;
  while (p2 < a.s) p2 <<= 1;
  for (int i = threadIdx.x; i < p2; i += THREADS) {
    key[i] = i < a.s ? item_key(a, i) : SENTINEL;
    val[i] = (unsigned short)i;
    if (i < a.s) {
      a.ok[i] = 1;
      a.wait[i] = 0;
    }
  }
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();  // the resets and the outputs' first values are in place
  bitonic_sort_pairs(key, val, p2);
  GatherLoad ld{val};
  const int ipt = (p2 + THREADS - 1) / THREADS;
  const int j0 = threadIdx.x * ipt;
  const bool closed = a.rounds <= -1;
  for (int j = j0; j < j0 + ipt && j < a.s; ++j) {
    int r = key_row(key[j]);
    if (r >= a.pr || (j > 0 && key_row(key[j - 1]) == r)) continue;  // not a valid row's head
    int end = j + lower_bound(key + j, a.s - j, (u64)(unsigned)(r + 1) << 32);
    if (closed)
      subsegs(a, key, ld, j, end, r, -a.rounds, sub_tok, sub_last, sub_idx);
    else if (walk_limit(a, end - j) > LONG)
      longs[atomicAdd(&n_long, 1)] = make_int2(j, end);
    else
      walk_thread(a, ld, j, end - j, r);
  }
  __syncthreads();
  if (closed) {
    for (int i = threadIdx.x; i < a.s; i += THREADS) closed_item(a, key, ld, i, -a.rounds, sub_tok, sub_last, sub_idx);
    return;
  }
  for (int l = threadIdx.x >> 5; l < n_long; l += NWARPS)
    walk_warp(a, ld, longs[l].x, longs[l].y - longs[l].x, key_row(key[longs[l].x]));
}

// ---------------------------------------------------------------------------
// many blocks: any s
// ---------------------------------------------------------------------------

// The resets, the sort keys and positions, and the look-back state reset.
__global__ void pa_prep(PaArgs a, u64* __restrict__ key, int* __restrict__ val, u64* __restrict__ status,
                        int n_status, int* __restrict__ ctl) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.q) reset_row(a, a.reset_rows[i]);
  if (i < n_status) status[i] = 0;
  if (i == 0) *ctl = 0;
  if (i < a.s) {
    key[i] = item_key(a, i);
    val[i] = i;
  }
}

// Single pass over the sorted items: the row-segment heads compacted into
// heads[0, nseg) (heads[nseg] = s, heads[s + 1] = nseg), each item's
// record in sorted order, every output's first value (ok = 1, wait = 0).
__global__ void __launch_bounds__(THREADS)
    pa_heads(PaArgs a, const u64* __restrict__ ks, const int* __restrict__ vs, int4* __restrict__ rec,
             int* __restrict__ heads, u64* status, int nt, int* ctl) {
  __shared__ int s_tile;
  if (threadIdx.x == 0) s_tile = atomicAdd(ctl, 1);
  __syncthreads();
  LookBack<1> lb{status, nt, s_tile, 0};
  const int base = s_tile * TILE + threadIdx.x * IPT;
  bool head[IPT];
  int local = 0;
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    int i = base + q;
    head[q] = false;
    if (i >= a.s) continue;
    head[q] = i == 0 || key_row(ks[i - 1]) != key_row(ks[i]);
    local += head[q] ? 1 : 0;
    int p = vs[i];
    Rec x = make_rec(a, p);
    rec[2 * i] = make_int4(x.ts, x.acq, x.tc, x.burst);
    rec[2 * i + 1] = make_int4(x.dur, x.maxq, x.cost, x.meta);
    a.ok[p] = 1;
    a.wait[p] = 0;
  }
  int total;
  int idx = compact_index(local, lb, total);
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    int i = base + q;
    if (i >= a.s) continue;
    if (head[q]) heads[idx++] = i;
    if (i == a.s - 1) {
      heads[idx] = a.s;
      heads[a.s + 1] = idx;
    }
  }
}

// One thread per row segment; the block's long segments go to its warps.
__global__ void __launch_bounds__(THREADS)
    pa_walk(PaArgs a, const u64* __restrict__ ks, const int4* __restrict__ rec, const int* __restrict__ heads) {
  __shared__ int2 longs[THREADS];
  __shared__ int n_long;
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
  RecLoad ld{rec};
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h < heads[a.s + 1]) {
    int start = heads[h], end = heads[h + 1];
    int r = key_row(ks[start]);
    if (r < a.pr) {  // invalid items keep ok = 1, wait = 0
      if (walk_limit(a, end - start) > LONG)
        longs[atomicAdd(&n_long, 1)] = make_int2(start, end);
      else
        walk_thread(a, ld, start, end - start, r);
    }
  }
  __syncthreads();
  for (int l = threadIdx.x >> 5; l < n_long; l += NWARPS)
    walk_warp(a, ld, longs[l].x, longs[l].y - longs[l].x, key_row(ks[longs[l].x]));
}

__global__ void pa_subsegs(PaArgs a, const u64* __restrict__ ks, const int4* __restrict__ rec,
                           const int* __restrict__ heads, int* __restrict__ sub_tok, int* __restrict__ sub_last,
                           int* __restrict__ sub_idx) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= heads[a.s + 1]) return;
  int start = heads[h], end = heads[h + 1];
  int r = key_row(ks[start]);
  if (r >= a.pr) return;
  subsegs(a, ks, RecLoad{rec}, start, end, r, -a.rounds, sub_tok, sub_last, sub_idx);
}

__global__ void pa_closed(PaArgs a, const u64* __restrict__ ks, const int4* __restrict__ rec,
                          const int* __restrict__ sub_tok, const int* __restrict__ sub_last,
                          const int* __restrict__ sub_idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.s) closed_item(a, ks, RecLoad{rec}, i, -a.rounds, sub_tok, sub_last, sub_idx);
}

// Workspace of the many-block route: keys and positions in and out, the
// records, the heads, the closed form's sub-segment scratch, one
// look-back walk, the tile counter, CUB's temp storage.
struct Layout {
  size_t key_in, key_out, val_in, val_out, rec, heads, sub, status, ctl, temp, total;
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
  l.rec = l.val_out + k4;
  l.heads = l.rec + align256(sizeof(int4) * 2 * (size_t)s);
  l.sub = l.heads + align256(sizeof(int) * ((size_t)s + 2));
  l.status = l.sub + 3 * k4;
  l.ctl = l.status + align256(sizeof(u64) * (size_t)l.nt);
  l.temp = l.ctl + 256;
  l.total = l.temp + align256(temp);
  return l;
}

}  // namespace

extern "C" {

// Bytes of workspace param_run needs for s items (0 for the one-block route).
long long param_workspace(int s) { return s <= SMALL_MAX ? 0 : (long long)layout(s).total; }

// One batch (see the header); `args` is read on the host. Returns a CUDA
// error code, or -1 when the workspace is smaller than param_workspace(s).
int param_run(const PaArgs* args, void* workspace, long long workspace_bytes, cudaStream_t stream) {
  const PaArgs a = *args;
  if (a.s < 0 || a.q < 0 || a.s >= (1 << 28) || (a.s > 0 && a.pr <= 0)) return (int)cudaErrorInvalidValue;
  if (a.s <= SMALL_MAX) {
    pa_small<<<1, THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  Layout l = layout(a.s);
  if (workspace_bytes < (long long)l.total) return -1;
  char* ws = (char*)workspace;
  u64* key_in = (u64*)(ws + l.key_in);
  u64* key_out = (u64*)(ws + l.key_out);
  int* val_in = (int*)(ws + l.val_in);
  int* val_out = (int*)(ws + l.val_out);
  int4* rec = (int4*)(ws + l.rec);
  int* heads = (int*)(ws + l.heads);
  size_t k4 = align256(sizeof(int) * (size_t)a.s);
  int* sub_tok = (int*)(ws + l.sub);
  int* sub_last = (int*)(ws + l.sub + k4);
  int* sub_idx = (int*)(ws + l.sub + 2 * k4);
  u64* status = (u64*)(ws + l.status);
  int* ctl = (int*)(ws + l.ctl);
  size_t temp_bytes = l.total - l.temp;
  pa_prep<<<blocks_for(max(max(a.s, a.q), l.nt)), THREADS, 0, stream>>>(a, key_in, val_in, status, l.nt, ctl);
  int err = (int)cub::DeviceRadixSort::SortPairs(ws + l.temp, temp_bytes, key_in, key_out, val_in, val_out, a.s, 0,
                                                 32 + bits_for(a.pr), stream);
  if (err) return err;
  pa_heads<<<l.nt, THREADS, 0, stream>>>(a, key_out, val_out, rec, heads, status, l.nt, ctl);
  if (a.rounds <= -1) {
    pa_subsegs<<<blocks_for(a.s), THREADS, 0, stream>>>(a, key_out, rec, heads, sub_tok, sub_last, sub_idx);
    pa_closed<<<blocks_for(a.s), THREADS, 0, stream>>>(a, key_out, rec, sub_tok, sub_last, sub_idx);
  } else {
    pa_walk<<<blocks_for(a.s), THREADS, 0, stream>>>(a, key_out, rec, heads);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
