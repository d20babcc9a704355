// K4, flow admission for Hopper (sm_90a): the port of
// sentinel_tpu/runtime/flush.py:flow_admission (DEFAULT controller with
// the occupy branch of prioritized entries) with segment_excl_cumsum /
// _segment_consumed, plus the verdict tail of flush_entries: the
// per-entry AND, the reason codes (:837-845), the occupy wait, the
// breakers' probe transitions (degrade_table.py:apply_probe_transitions)
// and the blocked-weight top-K (:879-897).
//
// One C call, flow_admission, per admission (driven by runtime/flush.py),
// on either route; `tail` selects the DEFAULT path's fused verdict, else
// the slot chain's stage (with occupy, and each slot's pass plus charge
// for the shaping stage):
//
// - n*k <= SMALL_MAX slots (the batches st.entry sends): one launch of one
//   block. It keys the slots (check row, ts), sorts (key, position) pairs
//   in shared memory (bitonic), reads each slot's windowed PASS from the
//   second window (K3's buckets with now - ws <= interval) and thread
//   gauge, takes both segmented prefixes and decides, with occupy takes
//   the borrow prefix and runs tryOccupyNext; then, after a barrier, the
//   per-entry verdict and, with topk > 0, the top-K among the touched
//   rows (no dense [R] array; see small_topk).
// - more slots: fa_prep (keys, positions, look-back state), one CUB radix
//   sort of (row << 32 | ts ^ 2^31, position) pairs with end_bit cut to
//   the row's bits, fa_stage (one single-pass kernel: the prefixes by
//   decoupled look-back, the window read, the decision, the borrow prefix
//   and search), then fa_verdict and fa_topk (DEFAULT) or fa_entry (slot
//   chain). Scratch comes from the caller's workspace; the dense blocked
//   weights live in a buffer the caller keeps zeroed, which fa_topk zeroes
//   again as it reads it: no memset.
//
// flow_admission_chain_verdict is the slot chain's verdict after the
// breakers (fa_chain, then fa_topk).
//
// What bounds it: launches and host calls, not bytes. Per slot it reads
// about 40 B of batch and rule table plus two buckets of the window (about
// 64 B with occupy) and writes a byte of verdict; the sort moves 12 B a
// slot per pass. The design is one host call, one launch for small
// batches, and few launches beside the sort's for large ones.
//
// Numerics: no fast-math. The QPS compare is
// floor((float)(pass + charge) / interval_sec) + (float)acquire <= count,
// the borrow check ((pass + borrow) + acquire) - window_pass <= count *
// interval_sec, both in float32 with round-to-nearest conversions and
// IEEE arithmetic in the JAX order; interval_sec arrives as the float32
// the JAX code uses. The int32 window arithmetic wraps as JAX's does; the
// segmented prefixes are JAX's wrapping cumsum minus the running max of
// the group-start values (lookback.cuh).

#include <cub/device/device_radix_sort.cuh>

#include "bitonic.cuh"
#include "lookback.cuh"

// Everything one call reads and writes (null = absent); runtime/flush.py
// fills the same layout (pointers first, then the ints, then the float).
// At file scope, so that the C entry point taking it keeps external linkage.
struct FaArgs {
  const int* gid;          // [n, k] rule ids, -1 = empty slot
  const int* crow;         // [n, k] check rows, -1 = passes trivially
  const uint8_t* e_valid;  // [n]
  const int* e_ts;
  const int* e_acq;
  const int* e_rows;       // [n, 4]
  const uint8_t* e_auth;
  const uint8_t* e_cluster;
  const uint8_t* e_prio;
  const uint8_t* live;     // [n] occupy: not blocked by an earlier stage
  const int* f_grade;      // [nr]
  const float* f_count;
  const int* f_behavior;
  const int* sec_ws;       // [R, nb] second-window starts
  const int* sec_counts;   // [R, nb, ne]
  const int* threads;      // [R]
  const int* fut_ws;       // [R, nb] the borrow slab
  const int* fut_pass;
  uint8_t* slot_ok;        // [n, k]
  uint8_t* flow_pass;      // [n]
  uint8_t* admitted;       // [n] (tail)
  int* reason;             // [n] (tail)
  int* blk_w;              // [topk] (tail)
  int* blk_r;
  int* ppc;                // [n, k] pass plus charge (slot chain, may be null)
  uint8_t* occ_slot;       // [n, k] (occupy)
  int* occ_target;         // [n, k]
  uint8_t* occupied;       // [n]
  int* occupy_wait;        // [n]
  int n, k, n_rows, nr, nb, ne, now, wlen, interval_ms, occupy_timeout_ms, occupy, tail, topk;
  float interval_sec;
};

namespace {

constexpr int KMAX = 8;                // top-K capacity
constexpr int FLOW_GRADE_QPS = 1;      // models/constants.py
constexpr int CONTROL_BEHAVIOR_DEFAULT = 0;
constexpr int EVENT_PASS = 0;          // metrics/events.py
constexpr int REASON_PASS = 0;         // core/errors.py
constexpr int REASON_BLOCK_FLOW = 1;
constexpr int REASON_BLOCK_DEGRADE = 2;
constexpr int REASON_BLOCK_SYSTEM = 3;
constexpr int REASON_BLOCK_AUTHORITY = 4;
constexpr int REASON_BLOCK_PARAM = 5;
constexpr int BREAKER_HALF_OPEN = 2;   // rules/degrade_table.py
constexpr int SMALL_MAX = 2048;        // slots of the one-block route
constexpr int SMALL_IPT = SMALL_MAX / THREADS;
// Slots per thread and per tile of fa_stage: two, so that a 131,072-slot
// batch gives 256 tiles, two blocks an SM to hide the window reads.
constexpr int FA_IPT = 2;
constexpr int FA_TILE = THREADS * FA_IPT;
// The zeroed buffer of the top-K: a counter, the per-block candidates,
// then the dense weights of the rows.
constexpr int TOPK_MAX_BLOCKS = 1024;
constexpr int TOPK_CAND = 32;
constexpr int TOPK_DENSE = TOPK_CAND + 2 * TOPK_MAX_BLOCKS * KMAX;

__device__ __forceinline__ bool slot_active(const FaArgs& a, int p) {
  return a.gid[p] >= 0 && a.crow[p] >= 0 && a.e_valid[p / a.k];
}

// The sort key of flat slot p: its check row (n_rows for an inactive slot;
// rows are clamped into [0, n_rows]) over its entry's ts, sign flipped.
__device__ __forceinline__ u64 slot_key(const FaArgs& a, int p) {
  return row_ts_key(slot_active(a, p) ? min(a.crow[p], a.n_rows) : a.n_rows, a.e_ts[p / a.k]);
}

// The windowed PASS of a row (in range) over its valid buckets, as K3 reads it.
__device__ __forceinline__ int window_pass(const FaArgs& a, int row) {
  int64_t c0 = (int64_t)row * a.nb;
  int acc = 0;
  for (int b = 0; b < a.nb; ++b)
    if (wrap_sub(a.now, a.sec_ws[c0 + b]) <= a.interval_ms)
      acc = wrap_add(acc, a.sec_counts[(c0 + b) * a.ne + EVENT_PASS]);
  return acc;
}

// tryOccupyNext (StatisticNode.java:302-333) for one eligible slot on `row`:
// step s of the search sees the pass that remains once windows 0..s expired.
__device__ bool occupy_search(const FaArgs& a, int row, int charge, int pass, int acq, float count, int& wait,
                              int& target) {
  int waiting = 0;  // StatisticNode.waiting(): tokens of still-future windows
  for (int b = 0; b < a.nb; ++b) {
    int64_t c = (int64_t)row * a.nb + b;
    if (a.fut_ws[c] > a.now) waiting = wrap_add(waiting, a.fut_pass[c]);
  }
  float cur_borrow = __int2float_rn(wrap_add(waiting, charge));
  float cur_pass = __int2float_rn(pass);
  float acq_f = __int2float_rn(acq);
  float max_count = __fmul_rn(count, a.interval_sec);
  int now_mod = floormod(a.now, a.wlen);
  unsigned start = (unsigned)a.now - (unsigned)now_mod;
  bool got = false;
  wait = 0;
  target = 0;
  for (int s = 0; s < a.nb; ++s) {
    int wait_s = s * a.wlen + a.wlen - now_mod;
    int exp_ws = (int)(start + (unsigned)a.wlen - (unsigned)a.interval_ms + (unsigned)(s * a.wlen));
    int bidx = floormod(floordiv(exp_ws, a.wlen), a.nb);
    int64_t c = (int64_t)row * a.nb + bidx;
    int win_pass = a.sec_ws[c] == exp_ws ? a.sec_counts[c * a.ne + EVENT_PASS] : 0;
    float win_f = __int2float_rn(win_pass);
    bool cond = exp_ws < a.now && wait_s < a.occupy_timeout_ms &&
                __fsub_rn(__fadd_rn(__fadd_rn(cur_pass, cur_borrow), acq_f), win_f) <= max_count;
    if (cond && !got) {
      wait = wait_s;
      target = (int)(start + (unsigned)((s + 1) * a.wlen));
    }
    got = got || cond;
    cur_pass = __fsub_rn(cur_pass, win_f);
  }
  return got;
}

// One thread's `cnt` consecutive sorted slots from j0 (keys `ks`, flat
// positions `vs`, in shared or global memory; all threads of the block
// call it): the two intra-batch charges (the acquire and the count of
// earlier entries' slots on the entry's own rows, charged at each
// entry's last slot of the group), the decision, and with occupy the
// borrow prefix (every earlier eligible slot of the row) and the search.
// Writes slot_ok, ppc, occ_slot and occ_target at the flat position, and a
// borrowing slot's wait into occ_wait (flat).
template <int MAXI, class V, class Carry2, class Carry1>
__device__ void decide_slots(const FaArgs& a, const u64* ks, const V* vs, int nk, int j0, int cnt, Carry2& c2,
                             Carry1& c1, int* occ_wait) {
  int pos[MAXI], row[MAXI];
  int2 contrib[MAXI], charge[MAXI];
  bool head[MAXI], last[MAXI];
#pragma unroll
  for (int q = 0; q < MAXI; ++q) {
    int j = j0 + q;
    pos[q] = -1;
    row[q] = 0;
    contrib[q] = make_int2(0, 0);
    head[q] = last[q] = false;
    if (q < cnt && j < nk) {
      u64 kj = ks[j];
      int p = (int)vs[j];
      int e = p / a.k;
      int r = key_row(kj);
      pos[q] = p;
      row[q] = r;
      head[q] = j == 0 || key_row(ks[j - 1]) != r;
      last[q] = j + 1 == nk || key_row(ks[j + 1]) != r || (int)vs[j + 1] / a.k != e;
      int cr = a.crow[p];
      const int* er = a.e_rows + (int64_t)e * 4;
      bool own = cr == er[0] || cr == er[1] || cr == er[2] || cr == er[3];
      if (last[q] && own) contrib[q] = make_int2(a.e_acq[e], 1);
    }
  }
  charges<MAXI, 2>(cnt, contrib, head, charge, c2);
  int pass_v[MAXI];
  bool elig[MAXI];
#pragma unroll
  for (int q = 0; q < MAXI; ++q) {
    int p = pos[q];
    elig[q] = false;
    pass_v[q] = 0;
    contrib[q] = make_int2(0, 0);  // now the borrow contributions
    if (p < 0) continue;
    int e = p / a.k;
    bool active = slot_active(a, p);
    int g = clampi(a.gid[p], 0, a.nr - 1);
    int rkc = clampi(row[q], 0, a.n_rows - 1);
    int pass = wrap_add(window_pass(a, rkc), charge[q].x);
    float qps_cur = floorf(__fdiv_rn(__int2float_rn(pass), a.interval_sec));
    float thread_cur = __int2float_rn(wrap_add(a.threads[rkc], charge[q].y));
    bool is_qps = a.f_grade[g] == FLOW_GRADE_QPS;
    float cur = is_qps ? qps_cur : thread_cur;
    bool ok_raw = __fadd_rn(cur, __int2float_rn(a.e_acq[e])) <= a.f_count[g];
    bool is_default = a.f_behavior[g] == CONTROL_BEHAVIOR_DEFAULT;
    a.slot_ok[p] = (ok_raw || !active || !is_default) ? 1 : 0;
    if (a.ppc != nullptr) a.ppc[p] = pass;
    if (a.occupy) {
      elig[q] = active && !ok_raw && is_default && a.live[e] && a.e_prio[e] && a.e_cluster[e] && is_qps;
      if (elig[q] && last[q]) contrib[q] = make_int2(a.e_acq[e], 0);
      pass_v[q] = pass;
    }
  }
  if (!a.occupy) return;
  charges<MAXI, 1>(cnt, contrib, head, charge, c1);
#pragma unroll
  for (int q = 0; q < MAXI; ++q) {
    int p = pos[q];
    if (p < 0) continue;
    int wait = 0, target = 0;
    bool got = false;
    if (elig[q]) {
      int g = clampi(a.gid[p], 0, a.nr - 1);
      got = occupy_search(a, clampi(row[q], 0, a.n_rows - 1), charge[q].x, pass_v[q], a.e_acq[p / a.k],
                          a.f_count[g], wait, target);
    }
    a.occ_slot[p] = got ? 1 : 0;
    a.occ_target[p] = target;
    occ_wait[p] = wait;
    if (got) a.slot_ok[p] = 1;
  }
}

// The DEFAULT verdict of entry e: the AND over its slots, the admission
// (valid, authority, token server) and the reason.
__device__ __forceinline__ void entry_verdict(const FaArgs& a, int e) {
  bool fp = true;
  for (int j = 0; j < a.k; ++j) fp = fp && a.slot_ok[(int64_t)e * a.k + j];
  a.flow_pass[e] = fp ? 1 : 0;
  bool valid = a.e_valid[e], auth = a.e_auth[e];
  bool fpc = fp && a.e_cluster[e];
  bool adm = valid && auth && fpc;
  int r = REASON_PASS;
  if (valid && !fpc) r = REASON_BLOCK_FLOW;
  if (valid && !auth) r = REASON_BLOCK_AUTHORITY;
  if (adm) r = REASON_PASS;
  a.admitted[e] = adm ? 1 : 0;
  a.reason[e] = r;
}

// Entry e's blocked acquire (0 unless it is valid, not admitted, and
// acquires), after its verdict; `row` gets its clamped cluster row.
__device__ __forceinline__ int blocked_weight(const FaArgs& a, int e, int& row) {
  row = clampi(a.e_rows[(int64_t)e * 4 + 1], 0, a.n_rows - 1);
  return (a.e_valid[e] && !a.admitted[e] && a.e_acq[e] > 0) ? a.e_acq[e] : 0;
}

// The slot chain's per-entry fold: AND over the slots; with occupy, OR of
// the borrows and the largest borrowing slot's wait.
__device__ __forceinline__ void entry_fold(const FaArgs& a, int e, const int* occ_wait) {
  bool fp = true, occ = false;
  int w = 0;
  for (int j = 0; j < a.k; ++j) {
    int64_t p = (int64_t)e * a.k + j;
    fp = fp && a.slot_ok[p];
    if (a.occupy && a.occ_slot[p]) {
      occ = true;
      w = max(w, occ_wait[p]);
    }
  }
  a.flow_pass[e] = fp ? 1 : 0;
  if (a.occupy) {
    a.occupied[e] = occ ? 1 : 0;
    a.occupy_wait[e] = w;
  }
}

// (w1, r1) ranks before (w2, r2): heavier first, lower row on a tie.
__device__ __forceinline__ bool better(int w1, int r1, int w2, int r2) {
  return w1 > w2 || (w1 == w2 && r1 < r2);
}

__device__ __forceinline__ void list_init(int* lw, int* lr) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) { lw[j] = INT_MIN; lr[j] = INT_MAX; }
}

// The list holds the best KMAX in order (registers: every index is static);
// the top k <= KMAX is its prefix.
__device__ __forceinline__ void list_insert(int* lw, int* lr, int w, int r) {
  if (!better(w, r, lw[KMAX - 1], lr[KMAX - 1])) return;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (better(w, r, lw[j], lr[j])) {
      int tw = lw[j], tr = lr[j];
      lw[j] = w;
      lr[j] = r;
      w = tw;
      r = tr;
    }
  }
}

// Merge the block's per-thread lists (in shared memory) into list 0.
__device__ void block_merge(int* sw, int* sr) {
  int t = threadIdx.x;
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (t < s) {
      int aw[KMAX], ar[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) { aw[j] = sw[t * KMAX + j]; ar[j] = sr[t * KMAX + j]; }
#pragma unroll
      for (int j = 0; j < KMAX; ++j) list_insert(aw, ar, sw[(t + s) * KMAX + j], sr[(t + s) * KMAX + j]);
#pragma unroll
      for (int j = 0; j < KMAX; ++j) { sw[t * KMAX + j] = aw[j]; sr[t * KMAX + j] = ar[j]; }
    }
    __syncthreads();
  }
}

// Every thread's list into shared memory, merged; list 0 holds the best.
__device__ void lists_merge(int* sw, int* sr, const int* lw, const int* lr) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) { sw[threadIdx.x * KMAX + j] = lw[j]; sr[threadIdx.x * KMAX + j] = lr[j]; }
  __syncthreads();
  block_merge(sw, sr);
}

// ---------------------------------------------------------------------------
// one block: n * k <= SMALL_MAX
// ---------------------------------------------------------------------------

// The top-K of the blocked acquire per cluster row, as lax.top_k over the
// dense [R] weights takes it, without the dense array: the blocked entries
// sorted by (row, entry) give each touched row's wrapping sum (index_add_'s)
// at its last entry; every row that is not touched weighs 0, and the k
// lowest of them lie below k + (touched rows), so those rows are the only
// other candidates. `key` holds SMALL_MAX keys and is reused as the merge
// lists; `pre` holds SMALL_MAX ints. The entries' verdicts are in place.
__device__ void small_topk(const FaArgs& a, u64* key, int* pre) {
  int p2 = 1;
  while (p2 < a.n) p2 <<= 1;
  for (int e = threadIdx.x; e < p2; e += THREADS) {
    int row = 0;
    int w = e < a.n ? blocked_weight(a, e, row) : 0;
    key[e] = w > 0 ? (((u64)(unsigned)row << 32) | (unsigned)e) : SENTINEL;
  }
  __syncthreads();
  bitonic_sort(key, p2);
  const int ipt = (p2 + THREADS - 1) / THREADS;
  const int j0 = threadIdx.x * ipt;
  __shared__ int2 warp_tot[NWARPS];
  int2 total;
  // The wrapping prefix of the sorted weights, and the running max of the
  // run starts.
  int local = 0, head_max = -1;
  for (int q = 0; q < ipt; ++q) {
    int j = j0 + q;
    if (j < p2 && key[j] != SENTINEL) {
      local = wrap_add(local, a.e_acq[(unsigned)key[j]]);
      if (j == 0 || key_row(key[j - 1]) != key_row(key[j])) head_max = j;
    }
  }
  int run = block_exclusive_scan<SumOp>(make_int2(local, 0), warp_tot, total).x;
  int head = block_exclusive_scan<MaxOp>(make_int2(head_max, 0), warp_tot, total).x;
  for (int q = 0; q < ipt; ++q) {
    int j = j0 + q;
    if (j < p2) pre[j] = run;
    if (j < p2 && key[j] != SENTINEL) run = wrap_add(run, a.e_acq[(unsigned)key[j]]);
  }
  __syncthreads();
  int lw[KMAX], lr[KMAX];
  list_init(lw, lr);
  int touched = 0;
  for (int q = 0; q < ipt; ++q) {
    int j = j0 + q;
    if (j >= p2 || key[j] == SENTINEL) continue;
    int r = key_row(key[j]);
    if (j == 0 || key_row(key[j - 1]) != r) head = j;
    if (j + 1 == p2 || key_row(key[j + 1]) != r) {  // the run's last entry
      int incl = wrap_add(pre[j], a.e_acq[(unsigned)key[j]]);
      list_insert(lw, lr, wrap_sub(incl, pre[head]), r);
      ++touched;
    }
  }
  block_exclusive_scan<SumOp>(make_int2(touched, 0), warp_tot, total);
  int fill = min(a.n_rows, a.topk + total.x);
  for (int r = threadIdx.x; r < fill; r += THREADS) {
    int j = lower_bound(key, p2, (u64)(unsigned)r << 32);
    if (j == p2 || key_row(key[j]) != r) list_insert(lw, lr, 0, r);
  }
  __syncthreads();  // the keys are read; their memory becomes the lists
  int* sw = reinterpret_cast<int*>(key);
  lists_merge(sw, sw + THREADS * KMAX, lw, lr);
  if (threadIdx.x < a.topk) {
    a.blk_w[threadIdx.x] = sw[threadIdx.x];
    a.blk_r[threadIdx.x] = sw[THREADS * KMAX + threadIdx.x];
  }
}

template <bool TAIL>
__global__ void __launch_bounds__(THREADS) fa_small(FaArgs a) {
  __shared__ u64 key[SMALL_MAX];
  __shared__ unsigned short val[SMALL_MAX];
  __shared__ int aux[SMALL_MAX];  // the borrowing slots' waits; on the tail the top-K's prefix
  static_assert(2 * THREADS * KMAX * sizeof(int) <= sizeof(key), "the merge lists reuse the keys");
  const int nk = a.n * a.k;
  int p2 = 1;
  while (p2 < nk) p2 <<= 1;
  for (int i = threadIdx.x; i < p2; i += THREADS) {
    key[i] = i < nk ? slot_key(a, i) : SENTINEL;
    val[i] = (unsigned short)i;
  }
  __syncthreads();
  bitonic_sort_pairs(key, val, p2);
  NoCarry none;
  const int ipt = (p2 + THREADS - 1) / THREADS;
  decide_slots<SMALL_IPT>(a, key, val, nk, threadIdx.x * ipt, ipt, none, none, aux);
  __syncthreads();  // every slot is decided: its verdict is visible to the block
  if (!TAIL) {
    for (int e = threadIdx.x; e < a.n; e += THREADS) entry_fold(a, e, aux);
    return;
  }
  for (int e = threadIdx.x; e < a.n; e += THREADS) entry_verdict(a, e);
  if (a.topk == 0) return;
  __syncthreads();
  small_topk(a, key, aux);
}

// ---------------------------------------------------------------------------
// many blocks: any n * k
// ---------------------------------------------------------------------------

// The sort keys and positions, and the look-back state reset.
__global__ void fa_prep(FaArgs a, u64* __restrict__ key, int* __restrict__ val, u64* __restrict__ status,
                        int n_status, int* __restrict__ ctl) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_status) status[i] = 0;
  if (i == 0) *ctl = 0;
  if (i < a.n * a.k) {
    key[i] = slot_key(a, i);
    val[i] = i;
  }
}

// Single pass over the sorted slots: each block takes the next tile and
// decides it with the carries of the tiles before it (walks 0-3: the two
// charges; 4-5: the borrow charge).
__global__ void __launch_bounds__(THREADS) fa_stage(FaArgs a, const u64* __restrict__ ks, const int* __restrict__ vs,
                                                    u64* status, int nt, int* ctl, int* occ_wait) {
  __shared__ int s_tile;
  if (threadIdx.x == 0) s_tile = atomicAdd(ctl, 1);
  __syncthreads();
  int tile = s_tile;
  LookBack<2> c2{status, nt, tile, 0};
  LookBack<1> c1{status, nt, tile, 4};
  decide_slots<FA_IPT>(a, ks, vs, a.n * a.k, tile * FA_TILE + threadIdx.x * FA_IPT, FA_IPT, c2, c1, occ_wait);
}

// The blocked acquire of one entry into the dense weights: warp-aggregated
// integer atomics, one per (warp, row). All lanes call it.
__device__ __forceinline__ void scatter_blocked(int w, int row, int* __restrict__ dense) {
  bool act = w > 0;
  unsigned am = __ballot_sync(FULL_MASK, act);
  if (!act) return;
  unsigned grp = __match_any_sync(am, row);
  int sum = __reduce_add_sync(grp, w);
  if ((threadIdx.x & 31) == __ffs(grp) - 1) atomicAdd(&dense[row], sum);
}

__global__ void fa_verdict(FaArgs a, int* __restrict__ dense) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  int w = 0, row = -1;
  if (e < a.n) {
    entry_verdict(a, e);
    w = blocked_weight(a, e, row);
  }
  if (dense != nullptr) scatter_blocked(w, row, dense);
}

__global__ void fa_entry(FaArgs a, const int* __restrict__ occ_wait) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < a.n) entry_fold(a, e, occ_wait);
}

// The slot chain's verdict (flush_entries :700-845 of the JAX module).
// Null inputs: sys_ok (no system stage), param_ok/wait_param (no hot
// parameters), shape_wait (no shaping; flow_pass then has no shaping
// verdicts either), occupied/occupy_wait (no occupy),
// dslot_ok/probe_slot/state (no breakers), occ_slot (no borrows).
__global__ void fa_chain(int n, int k, int kd, int n_rows, const uint8_t* __restrict__ e_valid,
                         const uint8_t* __restrict__ e_auth, const uint8_t* __restrict__ sys_ok,
                         const uint8_t* __restrict__ flow_pass, const uint8_t* __restrict__ e_cluster,
                         const uint8_t* __restrict__ occupied_raw, const int* __restrict__ occupy_wait,
                         const uint8_t* __restrict__ dslot_ok, const uint8_t* __restrict__ probe_slot,
                         const int* __restrict__ e_dgid, int* __restrict__ state,
                         uint8_t* __restrict__ occ_slot, const uint8_t* __restrict__ param_ok,
                         const int* __restrict__ wait_param, const int* __restrict__ shape_wait,
                         const int* __restrict__ e_acq,
                         const int* __restrict__ e_rows, uint8_t* __restrict__ admitted,
                         int* __restrict__ reason, int* __restrict__ wait_ms,
                         uint8_t* __restrict__ flow_live, uint8_t* __restrict__ occupied,
                         int* __restrict__ dense) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  int w = 0, row = -1;
  if (e < n) {
    bool valid = e_valid[e], auth = e_auth[e];
    bool sys = sys_ok == nullptr || sys_ok[e];
    bool par = param_ok == nullptr || param_ok[e];
    bool live = valid && auth && sys && par;
    bool fp = flow_pass[e] && e_cluster[e];
    bool live2 = live && fp;
    bool occ = occupied_raw != nullptr && occupied_raw[e] && live;
    int wait = occ ? max(0, occupy_wait[e]) : 0;
    if (shape_wait != nullptr) wait = max(wait, shape_wait[e]);
    if (!live2) wait = 0;
    // Occupied entries skip the breakers: PriorityWaitException aborts
    // the chain before DegradeSlot.
    bool deg = true;
    if (dslot_ok != nullptr)
      for (int j = 0; j < kd; ++j) deg = deg && dslot_ok[(int64_t)e * kd + j];
    deg = deg || (occ && live2);
    bool adm = live2 && deg;
    if (wait_param != nullptr && adm) wait = max(wait, wait_param[e]);
    if (state != nullptr && adm && !occ) {
      for (int j = 0; j < kd; ++j)  // apply_probe_transitions: one probe per breaker
        if (probe_slot[(int64_t)e * kd + j]) state[e_dgid[(int64_t)e * kd + j]] = BREAKER_HALF_OPEN;
    }
    int r = REASON_PASS;
    if (valid && !deg) r = REASON_BLOCK_DEGRADE;
    if (valid && !fp) r = REASON_BLOCK_FLOW;
    if (valid && !par) r = REASON_BLOCK_PARAM;
    if (valid && !sys) r = REASON_BLOCK_SYSTEM;
    if (valid && !auth) r = REASON_BLOCK_AUTHORITY;
    if (adm) r = REASON_PASS;
    bool occ_final = occ && adm;
    if (occ_slot != nullptr && !occ_final)
      for (int j = 0; j < k; ++j) occ_slot[(int64_t)e * k + j] = 0;
    admitted[e] = adm ? 1 : 0;
    reason[e] = r;
    wait_ms[e] = wait;
    flow_live[e] = live2 ? 1 : 0;
    occupied[e] = occ_final ? 1 : 0;
    if (valid && !adm && e_acq[e] > 0) {
      w = e_acq[e];
      row = clampi(e_rows[(int64_t)e * 4 + 1], 0, n_rows - 1);
    }
  }
  if (dense != nullptr) scatter_blocked(w, row, dense);
}

// The top-K (k <= KMAX) of the dense weights by weight descending, row
// ascending, in one launch: each block keeps its k best and zeroes what it
// read, the last block to finish merges the candidates, zeroes them and
// resets the counter: the buffer is all zero again when it ends. `zero` is
// the caller's zeroed buffer (TOPK_DENSE + n_rows ints).
__global__ void fa_topk(int* __restrict__ zero, int n_rows, int k, int* __restrict__ out_w, int* __restrict__ out_r) {
  __shared__ int sw[THREADS * KMAX];
  __shared__ int sr[THREADS * KMAX];
  __shared__ bool is_last;
  int* ctl = zero;
  int* cand_w = zero + TOPK_CAND;
  int* cand_r = cand_w + TOPK_MAX_BLOCKS * KMAX;
  int* dense = zero + TOPK_DENSE;
  int lw[KMAX], lr[KMAX];
  list_init(lw, lr);
  const int stride = gridDim.x * THREADS;
  for (int i0 = blockIdx.x * THREADS + threadIdx.x; i0 < n_rows; i0 += 4 * stride) {
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = i0 + u * stride < n_rows ? dense[i0 + u * stride] : 0;  // all in flight
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int i = i0 + u * stride;
      if (i < n_rows) {
        list_insert(lw, lr, v[u], i);
        if (v[u] != 0) dense[i] = 0;  // zero again for the next call
      }
    }
  }
  lists_merge(sw, sr, lw, lr);
  if (threadIdx.x < k) {
    cand_w[blockIdx.x * KMAX + threadIdx.x] = sw[threadIdx.x];
    cand_r[blockIdx.x * KMAX + threadIdx.x] = sr[threadIdx.x];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ctl, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  list_init(lw, lr);
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS)
    for (int j = 0; j < k; ++j) {
      int* cw = cand_w + b * KMAX + j;
      int* cr = cand_r + b * KMAX + j;
      list_insert(lw, lr, __ldcg(cw), __ldcg(cr));
      *cw = *cr = 0;  // zero again: K8 takes its election cells from the same buffer
    }
  lists_merge(sw, sr, lw, lr);
  if (threadIdx.x < k) {
    out_w[threadIdx.x] = sw[threadIdx.x];
    out_r[threadIdx.x] = sr[threadIdx.x];
  }
  if (threadIdx.x == 0) *ctl = 0;
}

int topk_blocks(int n_rows) {  // sixteen rows a thread, at most TOPK_MAX_BLOCKS blocks
  int b = (n_rows + THREADS * 16 - 1) / (THREADS * 16);
  return b < 1 ? 1 : (b > TOPK_MAX_BLOCKS ? TOPK_MAX_BLOCKS : b);
}

// Workspace of the many-block route: keys and positions in and out, the
// borrowing slots' waits, six look-back walks, the tile counter, CUB's
// temp storage.
struct Layout {
  size_t key_in, key_out, val_in, val_out, occ_wait, status, ctl, temp, total;
  int nt, n_status;
};

Layout layout(int nk) {
  Layout l;
  l.nt = (nk + FA_TILE - 1) / FA_TILE;
  l.n_status = 6 * l.nt;
  size_t temp = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, temp, (const u64*)nullptr, (u64*)nullptr, (const int*)nullptr,
                                  (int*)nullptr, nk, 0, 64);
  size_t k8 = align256(sizeof(u64) * (size_t)nk), k4 = align256(sizeof(int) * (size_t)nk);
  l.key_in = 0;
  l.key_out = l.key_in + k8;
  l.val_in = l.key_out + k8;
  l.val_out = l.val_in + k4;
  l.occ_wait = l.val_out + k4;
  l.status = l.occ_wait + k4;
  l.ctl = l.status + align256(sizeof(u64) * (size_t)l.n_status);
  l.temp = l.ctl + 256;
  l.total = l.temp + align256(temp);
  return l;
}

}  // namespace

extern "C" {

// Bytes of workspace flow_admission needs for n*k slots (0 for the
// one-block route).
long long flow_admission_workspace(int nk) { return nk <= SMALL_MAX ? 0 : (long long)layout(nk).total; }

// Ints of the zeroed top-K buffer for n_rows rows.
long long flow_admission_topk_ints(int n_rows) { return (long long)TOPK_DENSE + n_rows; }

// One flow admission (see the header). `args` is read on the host; `zero`
// (flow_admission_topk_ints ints, kept zeroed) is used by the many-block
// DEFAULT route with topk > 0. Returns a CUDA error code, or -1 when the
// workspace is smaller than flow_admission_workspace(n*k).
int flow_admission(const FaArgs* args, void* workspace, long long workspace_bytes, int* zero, cudaStream_t stream) {
  const FaArgs a = *args;
  const int nk = a.n * a.k;
  if (nk <= 0) return 0;
  if (a.topk < 0 || a.topk > KMAX || (a.tail && a.occupy) || a.nb <= 0 || a.n_rows <= 0 || a.nr <= 0 ||
      (a.occupy && a.wlen <= 0))
    return (int)cudaErrorInvalidValue;
  if (nk <= SMALL_MAX) {
    if (a.tail)
      fa_small<true><<<1, THREADS, 0, stream>>>(a);
    else
      fa_small<false><<<1, THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  Layout l = layout(nk);
  if (workspace_bytes < (long long)l.total || (a.tail && a.topk > 0 && zero == nullptr)) return -1;
  char* ws = (char*)workspace;
  u64* key_in = (u64*)(ws + l.key_in);
  u64* key_out = (u64*)(ws + l.key_out);
  int* val_in = (int*)(ws + l.val_in);
  int* val_out = (int*)(ws + l.val_out);
  int* occ_wait = (int*)(ws + l.occ_wait);
  u64* status = (u64*)(ws + l.status);
  int* ctl = (int*)(ws + l.ctl);
  size_t temp_bytes = l.total - l.temp;
  fa_prep<<<blocks_for(max(nk, l.n_status)), THREADS, 0, stream>>>(a, key_in, val_in, status, l.n_status, ctl);
  int err = (int)cub::DeviceRadixSort::SortPairs(ws + l.temp, temp_bytes, key_in, key_out, val_in, val_out, nk, 0,
                                                 32 + bits_for(a.n_rows), stream);
  if (err) return err;
  fa_stage<<<l.nt, THREADS, 0, stream>>>(a, key_out, val_out, status, l.nt, ctl, occ_wait);
  if (!a.tail) {
    fa_entry<<<blocks_for(a.n), THREADS, 0, stream>>>(a, occ_wait);
    return (int)cudaGetLastError();
  }
  fa_verdict<<<blocks_for(a.n), THREADS, 0, stream>>>(a, a.topk > 0 ? zero + TOPK_DENSE : nullptr);
  if (a.topk > 0) fa_topk<<<topk_blocks(a.n_rows), THREADS, 0, stream>>>(zero, a.n_rows, a.topk, a.blk_w, a.blk_r);
  return (int)cudaGetLastError();
}

// The verdict after the breakers; see fa_chain for the null inputs.
// occ_slot [n*k] is gated in place. `zero` as for flow_admission.
int flow_admission_chain_verdict(
    int n, int k, int kd, int n_rows, const uint8_t* e_valid, const uint8_t* e_auth,
    const uint8_t* sys_ok, const uint8_t* flow_pass, const uint8_t* e_cluster,
    const uint8_t* occupied_raw, const int* occupy_wait, const uint8_t* dslot_ok,
    const uint8_t* probe_slot, const int* e_dgid, int* state, uint8_t* occ_slot, const uint8_t* param_ok,
    const int* wait_param, const int* shape_wait, const int* e_acq,
    const int* e_rows, int topk, int* zero, uint8_t* admitted,
    int* reason, int* wait_ms, uint8_t* flow_live, uint8_t* occupied, int* blk_w, int* blk_r,
    cudaStream_t st) {
  if (n <= 0) return 0;
  if (topk < 0 || topk > KMAX || (topk > 0 && zero == nullptr)) return (int)cudaErrorInvalidValue;
  fa_chain<<<blocks_for(n), THREADS, 0, st>>>(n, k, kd, n_rows, e_valid, e_auth, sys_ok, flow_pass,
                                              e_cluster, occupied_raw, occupy_wait, dslot_ok,
                                              probe_slot, e_dgid, state, occ_slot, param_ok, wait_param,
                                              shape_wait, e_acq, e_rows,
                                              admitted, reason, wait_ms, flow_live, occupied,
                                              topk > 0 ? zero + TOPK_DENSE : nullptr);
  if (topk > 0) fa_topk<<<topk_blocks(n_rows), THREADS, 0, st>>>(zero, n_rows, topk, blk_w, blk_r);
  return (int)cudaGetLastError();
}

}  // extern "C"
