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
// chain_verdict is the slot chain's verdict tail after the breakers (the
// port of flush_entries :790-845 of the JAX module with
// degrade_table.py:apply_probe_transitions and the blocked top-K of
// :879-897), one C call per flush, its arguments in one CvArgs:
//
// - n <= small_max entries: one launch of one block (cv_small) decides
//   every entry, then takes the top-K among the touched rows as the
//   DEFAULT tail does (small_topk, the same code): no dense array, no
//   memset;
// - more entries: cv_entry decides one entry a thread and adds each
//   blocked acquire into a 64-bit cell per row in the zeroed scratch
//   (warp-combined): the cell is nonzero exactly when a blocked entry
//   touched the row, whatever the wrapping int32 sum in its low half, so
//   the add that finds it zero pushes the row onto a list; the last block
//   notes the k lowest untouched rows. cv_topk reads only the listed rows,
//   zeroes each cell and list slot it read, and its last block merges the
//   blocks' candidates with those rows and zeroes the rest. No read of
//   the R rows, no memset; a call that fails after the first launch
//   memsets what it may have written.
//
// What bounds it: launches and host calls, not bytes. Per slot K4 reads
// about 40 B of batch and rule table plus two buckets of the window (about
// 64 B with occupy) and writes a byte of verdict; the sort moves 12 B a
// slot per pass. The tail reads some 20 B an entry and writes 11. The
// design is one host call, one launch for small batches, and few launches
// beside the sort's for large ones.
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

// Everything one chain_verdict call reads and writes (null = absent: no
// system stage, no param stage, no shaping, no occupy, no borrows, no
// breakers, no probe transitions); runtime/flush.py fills the same layout
// (_CvArgs: pointers first, then the ints).
struct CvArgs {
  const uint8_t* e_valid;       // [n]
  const uint8_t* e_auth;
  const uint8_t* e_cluster;
  const int* e_acq;
  const int* e_rows;            // [n, 4]
  const int* e_dgid;            // [n, kd]
  const uint8_t* sys_ok;        // [n] system verdicts
  const uint8_t* param_ok;      // [n] param verdicts, with wait_param [n]
  const int* wait_param;
  const int* shape_wait;        // [n] (flow_pass then holds the shaping verdicts)
  const uint8_t* flow_pass;     // [n]
  const uint8_t* occupied_raw;  // [n] with occupy_wait [n]
  const int* occupy_wait;
  const uint8_t* occ_slot_in;   // [n, k] the borrowing slots
  const uint8_t* dslot_ok;      // [n, kd] with probe_slot [n, kd]
  const uint8_t* probe_slot;
  int* state;                   // [nd] breaker states (the probe transitions)
  uint8_t* admitted;            // [n]
  uint8_t* flow_live;
  uint8_t* occupied;            // occupied and admitted
  uint8_t* occ_slot;            // [n, k] gated on occupied and admitted
  int* reason;                  // [n]
  int* wait_ms;
  int* blk_w;                   // [topk]
  int* blk_r;
  int n, k, kd, n_rows, topk, small_max;
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
// The zeroed buffer of the top-K: a counter, the per-block candidates (one
// 64-bit key each), then the dense weights of the rows.
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
// (valid, authority, token server) and the reason. Returns the admission.
__device__ __forceinline__ bool entry_verdict(const FaArgs& a, int e) {
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
  return adm;
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

// ---------------------------------------------------------------------------
// the blocked top-K (the DEFAULT tail's and the slot chain's)
// ---------------------------------------------------------------------------

// An entry's blocked acquire (0 unless it is valid, not admitted and
// acquires), and in `row` its cluster row (e_rows column 1) clamped.
__device__ __forceinline__ int blocked_weight(bool valid, bool adm, int acq, const int* e_rows, int e, int n_rows,
                                              int& row) {
  row = clampi(e_rows[(int64_t)e * 4 + 1], 0, n_rows - 1);
  return (valid && !adm && acq > 0) ? acq : 0;
}

// A candidate (weight w, row r >= 0) as one 64-bit key that is larger
// exactly when it ranks first in lax.top_k: heavier first, the lower row on
// a tie. Every candidate's key is nonzero; 0 marks an empty place.
__device__ __forceinline__ u64 cand_key(int w, int r) {
  return ((u64)((unsigned)w ^ 0x80000000u) << 32) | (unsigned)~r;
}
__device__ __forceinline__ int cand_w(u64 key) { return (int)((unsigned)(key >> 32) ^ 0x80000000u); }
__device__ __forceinline__ int cand_r(u64 key) { return (int)~(unsigned)key; }

__device__ __forceinline__ void list_init(u64* l) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) l[j] = 0;
}

// The list holds the best KMAX in order (registers: every index is static);
// the top k <= KMAX is its prefix.
__device__ __forceinline__ void list_insert(u64* l, u64 key) {
  if (key <= l[KMAX - 1]) return;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (key > l[j]) {
      u64 t = l[j];
      l[j] = key;
      key = t;
    }
  }
}

// The warp's best KMAX of its lanes' lists, best first, into every lane's
// `out`: KMAX rounds of a warp-wide max of the lists' heads, the lane that
// holds the round's best popping it (candidates' keys are distinct).
__device__ __forceinline__ void warp_top(u64* l, u64* out) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    const u64 head = l[0];
    const unsigned hi = __reduce_max_sync(FULL_MASK, (unsigned)(head >> 32));
    const unsigned lo = __reduce_max_sync(FULL_MASK, (unsigned)(head >> 32) == hi ? (unsigned)head : 0u);
    const u64 best = ((u64)hi << 32) | lo;
    out[j] = best;
    if (best != 0 && head == best) {
#pragma unroll
      for (int q = 0; q + 1 < KMAX; ++q) l[q] = l[q + 1];
      l[KMAX - 1] = 0;
    }
  }
}

// The best KMAX of every thread's list in a block of NT threads, into
// s[0, KMAX) (s: NT / 32 * KMAX keys of shared memory): each warp's best,
// then warp 0's pick among them.
template <int NT>
__device__ void block_top(u64* l, u64* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64 best[KMAX];
  warp_top(l, best);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) s[warp * KMAX + j] = best[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) l[j] = lane < NT / 32 ? s[lane * KMAX + j] : 0;
    warp_top(l, best);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j) s[j] = best[j];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void write_top(const u64* best, int k, int* out_w, int* out_r) {
  if (threadIdx.x < k) {
    out_w[threadIdx.x] = cand_w(best[threadIdx.x]);
    out_r[threadIdx.x] = cand_r(best[threadIdx.x]);
  }
}

// ---------------------------------------------------------------------------
// one block
// ---------------------------------------------------------------------------

// The wrapping sum of the blocked acquire per cluster row (index_add_'s), in
// a hash table in shared memory: open addressing with linear probing, a
// capacity that is a power of two at least twice the entries. A row is
// touched exactly when it holds a place, whatever its sum.
struct RowTable {
  int* key;      // [1 << bits] the row, -1 = empty
  int* sum;      // [1 << bits]
  int* touched;  // the rows that hold a place
  int bits;      // >= 1

  __device__ __forceinline__ unsigned home(int row) const { return ((unsigned)row * 2654435761u) >> (32 - bits); }
  __device__ __forceinline__ unsigned mask() const { return (1u << bits) - 1; }

  template <int NT>
  __device__ void clear() const {
    for (int i = threadIdx.x; i < (1 << bits); i += NT) {
      key[i] = -1;
      sum[i] = 0;
    }
    if (threadIdx.x == 0) *touched = 0;
  }

  __device__ void add(int row, int w) const {
    for (unsigned h = home(row);; h = (h + 1) & mask()) {
      int prev = atomicCAS(&key[h], -1, row);
      if (prev == -1) atomicAdd(touched, 1);
      if (prev == -1 || prev == row) {
        atomicAdd(&sum[h], w);
        return;
      }
    }
  }

  __device__ bool has(int row) const {
    for (unsigned h = home(row);; h = (h + 1) & mask()) {
      if (key[h] == row) return true;
      if (key[h] < 0) return false;
    }
  }
};

// Bits of the table's capacity for n entries: twice n to a power of two.
__host__ __device__ inline int table_bits(int n) {
  int b = 1;
  while ((1 << b) < 2 * n) ++b;
  return b;
}

// The top-K of the blocked acquire per cluster row, as lax.top_k over the
// dense [R] weights takes it, without the dense array: every row in the
// table (filled, after a barrier) with its sum; every row that is not
// touched weighs 0, and the k lowest of them lie below k + (touched rows),
// so those rows are the only other candidates.
template <int NT>
__device__ void small_topk(const RowTable& t, int n_rows, int topk, int* out_w, int* out_r) {
  __shared__ u64 s[NT / 32 * KMAX];
  u64 l[KMAX];
  list_init(l);
  for (int i = threadIdx.x; i < (1 << t.bits); i += NT)
    if (t.key[i] >= 0) list_insert(l, cand_key(t.sum[i], t.key[i]));
  const int fill = min(n_rows, topk + *t.touched);
  for (int r = threadIdx.x; r < fill; r += NT)
    if (!t.has(r)) list_insert(l, cand_key(0, r));
  block_top<NT>(l, s);
  write_top(s, topk, out_w, out_r);
}

// The slots' keys, positions and borrowing waits; on the DEFAULT tail the
// same bytes then hold the row table (n <= SMALL_MAX entries).
constexpr int SMALL_BYTES = 2 * 2 * SMALL_MAX * sizeof(int);
static_assert(SMALL_MAX * (sizeof(u64) + sizeof(unsigned short) + sizeof(int)) <= SMALL_BYTES, "the slots fit");

template <bool TAIL>
__global__ void __launch_bounds__(THREADS) fa_small(FaArgs a) {
  __shared__ __align__(16) unsigned char smem[SMALL_BYTES];
  __shared__ int touched;
  u64* key = reinterpret_cast<u64*>(smem);
  unsigned short* val = reinterpret_cast<unsigned short*>(key + SMALL_MAX);
  int* aux = reinterpret_cast<int*>(val + SMALL_MAX);
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
  const int bits = table_bits(a.n);
  const RowTable t{reinterpret_cast<int*>(smem), reinterpret_cast<int*>(smem) + (1 << bits), &touched, bits};
  if (a.topk > 0) {
    t.clear<THREADS>();
    __syncthreads();
  }
  for (int e = threadIdx.x; e < a.n; e += THREADS) {
    bool adm = entry_verdict(a, e);
    int row, w = blocked_weight(a.e_valid[e], adm, a.e_acq[e], a.e_rows, e, a.n_rows, row);
    if (a.topk > 0 && w > 0) t.add(row, w);
  }
  if (a.topk == 0) return;
  __syncthreads();
  small_topk<THREADS>(t, a.n_rows, a.topk, a.blk_w, a.blk_r);
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
    bool adm = entry_verdict(a, e);
    w = blocked_weight(a.e_valid[e], adm, a.e_acq[e], a.e_rows, e, a.n_rows, row);
  }
  if (dense != nullptr) scatter_blocked(w, row, dense);
}

__global__ void fa_entry(FaArgs a, const int* __restrict__ occ_wait) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < a.n) entry_fold(a, e, occ_wait);
}

// The top-K (k <= KMAX) of the dense weights by weight descending, row
// ascending, in one launch: each block keeps its k best and zeroes what it
// read, the last block to finish merges the candidates, zeroes them and
// resets the counter: the buffer is all zero again when it ends. `zero` is
// the caller's zeroed buffer (TOPK_DENSE + n_rows ints).
__global__ void __launch_bounds__(THREADS) fa_topk(int* __restrict__ zero, int n_rows, int k, int* __restrict__ out_w,
                                                   int* __restrict__ out_r) {
  __shared__ u64 s[NWARPS * KMAX];
  __shared__ bool is_last;
  int* ctl = zero;
  u64* cand = reinterpret_cast<u64*>(zero + TOPK_CAND);
  int* dense = zero + TOPK_DENSE;
  u64 l[KMAX];
  list_init(l);
  const int stride = gridDim.x * THREADS;
  for (int i0 = blockIdx.x * THREADS + threadIdx.x; i0 < n_rows; i0 += 4 * stride) {
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = i0 + u * stride < n_rows ? dense[i0 + u * stride] : 0;  // all in flight
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int i = i0 + u * stride;
      if (i < n_rows) {
        list_insert(l, cand_key(v[u], i));
        if (v[u] != 0) dense[i] = 0;  // zero again for the next call
      }
    }
  }
  block_top<THREADS>(l, s);
  if (threadIdx.x < k) cand[blockIdx.x * KMAX + threadIdx.x] = s[threadIdx.x];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ctl, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  list_init(l);
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS)
    for (int j = 0; j < k; ++j) {
      u64* c = cand + b * KMAX + j;
      list_insert(l, __ldcg(c));
      *c = 0;  // zero again: K8 takes its election cells from the same buffer
    }
  block_top<THREADS>(l, s);
  write_top(s, k, out_w, out_r);
  if (threadIdx.x == 0) *ctl = 0;
}

// ---------------------------------------------------------------------------
// the slot chain's verdict tail
// ---------------------------------------------------------------------------

constexpr int CV_SMALL_CAP = 8192;      // entries cv_small can take
constexpr int CV_SMALL_THREADS = 1024;  // cv_small's block
// The zeroed scratch of the many-block route, in ints: a header ([0]
// cv_entry's finished blocks, [1] the list's length, [2] cv_topk's
// finished blocks, [3, 3 + KMAX) the lowest untouched rows + 1), cv_topk's
// per-block candidates (fa_topk's), then the 64-bit cells of the R rows
// and the list of touched rows (min(n, R) ints).
constexpr int CV_LOW = 3;
static_assert(CV_LOW + KMAX <= TOPK_CAND, "the header holds the low rows");
static_assert(TOPK_CAND % 2 == 0 && TOPK_DENSE % 2 == 0, "the 64-bit cells are aligned");

// The slot chain's verdict of entry e (flush_entries :790-845 of the JAX
// module): admission = live and flow pass and breaker pass (an occupied
// entry skips the breakers: PriorityWaitException aborts the chain before
// DegradeSlot), the waits, the reason with precedence authority > system >
// param > flow > degrade, one OPEN -> HALF_OPEN per probe of an entry
// admitted and not occupied, the borrows gated on the final admission.
// Returns the admission.
__device__ __forceinline__ bool chain_entry(const CvArgs& c, int e) {
  bool valid = c.e_valid[e], auth = c.e_auth[e];
  bool sys = c.sys_ok == nullptr || c.sys_ok[e];
  bool par = c.param_ok == nullptr || c.param_ok[e];
  bool live = valid && auth && sys && par;
  bool fp = c.flow_pass[e] && c.e_cluster[e];
  bool live2 = live && fp;
  bool occ = c.occupied_raw != nullptr && c.occupied_raw[e] && live;
  int wait = occ ? max(0, c.occupy_wait[e]) : 0;
  if (c.shape_wait != nullptr) wait = max(wait, c.shape_wait[e]);
  if (!live2) wait = 0;
  bool deg = true;
  if (c.dslot_ok != nullptr)
    for (int j = 0; j < c.kd; ++j) deg = deg && c.dslot_ok[(int64_t)e * c.kd + j];
  deg = deg || (occ && live2);
  bool adm = live2 && deg;
  if (c.wait_param != nullptr && adm) wait = max(wait, c.wait_param[e]);
  if (c.state != nullptr && adm && !occ) {
    for (int j = 0; j < c.kd; ++j)  // apply_probe_transitions: one probe per breaker
      if (c.probe_slot[(int64_t)e * c.kd + j]) c.state[c.e_dgid[(int64_t)e * c.kd + j]] = BREAKER_HALF_OPEN;
  }
  int r = REASON_PASS;
  if (valid && !deg) r = REASON_BLOCK_DEGRADE;
  if (valid && !fp) r = REASON_BLOCK_FLOW;
  if (valid && !par) r = REASON_BLOCK_PARAM;
  if (valid && !sys) r = REASON_BLOCK_SYSTEM;
  if (valid && !auth) r = REASON_BLOCK_AUTHORITY;
  if (adm) r = REASON_PASS;
  bool occ_final = occ && adm;
  for (int j = 0; j < c.k; ++j) {
    int64_t p = (int64_t)e * c.k + j;
    c.occ_slot[p] = (occ_final && c.occ_slot_in != nullptr && c.occ_slot_in[p]) ? 1 : 0;
  }
  c.admitted[e] = adm ? 1 : 0;
  c.reason[e] = r;
  c.wait_ms[e] = wait;
  c.flow_live[e] = live2 ? 1 : 0;
  c.occupied[e] = occ_final ? 1 : 0;
  return adm;
}

// One block: every verdict, the blocked acquire into the row table, then
// the top-K among the touched rows. Dynamic shared memory: the table, 2 <<
// bits ints (with topk > 0).
__global__ void __launch_bounds__(CV_SMALL_THREADS) cv_small(CvArgs c, int bits) {
  constexpr int NT = CV_SMALL_THREADS;
  extern __shared__ int cv_tab[];
  __shared__ int touched;
  const RowTable t{cv_tab, cv_tab + (1 << bits), &touched, bits};
  if (c.topk > 0) {
    t.clear<NT>();
    __syncthreads();
  }
  for (int e = threadIdx.x; e < c.n; e += NT) {
    bool adm = chain_entry(c, e);
    int row, w = blocked_weight(c.e_valid[e], adm, c.e_acq[e], c.e_rows, e, c.n_rows, row);
    if (c.topk > 0 && w > 0) t.add(row, w);
  }
  if (c.topk == 0) return;
  __syncthreads();  // every add is done
  small_topk<NT>(t, c.n_rows, c.topk, c.blk_w, c.blk_r);
}

// The lowest `topk` rows whose cell is zero (no blocked entry touched
// them), as row + 1 into the header; run by cv_entry's last block, once
// every add is done, four rows a thread at a time (Zipf rows touch a long
// prefix).
__device__ void low_rows(const CvArgs& c, int* hdr, const u64* dense) {
  constexpr int PER = 4;
  __shared__ int2 warp_tot[NWARPS];
  int found = 0;
  for (int base = 0; base < c.n_rows && found < c.topk; base += THREADS * PER) {
    const int r0 = base + threadIdx.x * PER;
    bool z[PER];
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      z[q] = r0 + q < c.n_rows && __ldcg(dense + r0 + q) == 0;
      cnt += z[q] ? 1 : 0;
    }
    int2 total;
    int rank = found + block_exclusive_scan<SumOp>(make_int2(cnt, 0), warp_tot, total).x;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      if (z[q] && rank < c.topk) hdr[CV_LOW + rank] = r0 + q + 1;
      rank += z[q] ? 1 : 0;
    }
    found += total.x;
  }
}

// Many blocks, one entry a thread: the verdict, and with topk > 0 the
// blocked acquire into its row's 64-bit cell. A warp adds (its lanes' sum
// mod 2^32) + (lanes << 32): the low half stays the wrapping int32 sum
// (index_add_'s), the high half counts the entries, so a touched cell is
// never zero; the add that finds it zero lists the row.
__global__ void __launch_bounds__(THREADS) cv_entry(CvArgs c, int* __restrict__ zero) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  __shared__ int s_cnt, s_base;
  __shared__ bool is_last;
  int w = 0, row = 0;
  if (e < c.n) {
    bool adm = chain_entry(c, e);
    w = blocked_weight(c.e_valid[e], adm, c.e_acq[e], c.e_rows, e, c.n_rows, row);
  }
  if (c.topk == 0) return;
  if (threadIdx.x == 0) s_cnt = 0;
  __syncthreads();
  int* hdr = zero;
  u64* dense = reinterpret_cast<u64*>(zero + TOPK_DENSE);
  int* list = reinterpret_cast<int*>(dense + c.n_rows);
  bool act = w > 0;
  unsigned am = __ballot_sync(FULL_MASK, act);
  bool push = false;
  if (act) {
    unsigned grp = __match_any_sync(am, row);
    unsigned sum = __reduce_add_sync(grp, (unsigned)w);
    if (lane == __ffs(grp) - 1) push = atomicAdd(&dense[row], ((u64)__popc(grp) << 32) + sum) == 0;
  }
  // The rows this block lists: a place per warp in the block's share, one
  // global atomic per block.
  unsigned pm = __ballot_sync(FULL_MASK, push);
  int at = 0;
  if (pm != 0 && lane == __ffs(pm) - 1) at = atomicAdd(&s_cnt, __popc(pm));
  at = __shfl_sync(FULL_MASK, at, pm != 0 ? __ffs(pm) - 1 : 0) + __popc(pm & ((1u << lane) - 1));
  __syncthreads();
  if (threadIdx.x == 0) s_base = s_cnt > 0 ? atomicAdd(&hdr[1], s_cnt) : 0;
  __syncthreads();
  if (push) list[s_base + at] = row;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&hdr[0], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  low_rows(c, hdr, dense);
  if (threadIdx.x == 0) hdr[0] = 0;
}

// The top-K over the listed rows: each block keeps its k best of its share
// of the list and zeroes the cells and list slots it read; the last block
// merges the candidates with the lowest untouched rows (weight 0) and
// zeroes the candidates and the header: the buffer is all zero again.
__global__ void __launch_bounds__(THREADS) cv_topk(CvArgs c, int* __restrict__ zero) {
  __shared__ u64 s[NWARPS * KMAX];
  __shared__ bool is_last;
  int* hdr = zero;
  u64* cand = reinterpret_cast<u64*>(zero + TOPK_CAND);
  u64* dense = reinterpret_cast<u64*>(zero + TOPK_DENSE);
  int* list = reinterpret_cast<int*>(dense + c.n_rows);
  const int len = __ldcg(hdr + 1);
  u64 l[KMAX];
  list_init(l);
  const int stride = gridDim.x * THREADS;
  for (int i0 = blockIdx.x * THREADS + threadIdx.x; i0 < len; i0 += 4 * stride) {
    int r[4];
    u64 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) r[u] = i0 + u * stride < len ? list[i0 + u * stride] : -1;  // all in flight
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = r[u] >= 0 ? dense[r[u]] : 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r[u] < 0) continue;
      list_insert(l, cand_key((int)(unsigned)v[u], r[u]));
      dense[r[u]] = 0;
      list[i0 + u * stride] = 0;
    }
  }
  block_top<THREADS>(l, s);
  if (threadIdx.x < c.topk) cand[blockIdx.x * KMAX + threadIdx.x] = s[threadIdx.x];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&hdr[2], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  list_init(l);
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS)
    for (int j = 0; j < c.topk; ++j) {
      u64* cp = cand + b * KMAX + j;
      list_insert(l, __ldcg(cp));
      *cp = 0;
    }
  if (threadIdx.x < c.topk) {
    int r1 = __ldcg(hdr + CV_LOW + threadIdx.x);
    if (r1 != 0) list_insert(l, cand_key(0, r1 - 1));
    hdr[CV_LOW + threadIdx.x] = 0;
  }
  block_top<THREADS>(l, s);
  write_top(s, c.topk, c.blk_w, c.blk_r);
  if (threadIdx.x == 0) hdr[1] = hdr[2] = 0;
}

long long cv_zero_bytes(int n, int n_rows) { return 4ll * TOPK_DENSE + 8ll * n_rows + 4ll * min(n, n_rows); }

int cv_small_launch(const CvArgs& c, cudaStream_t st) {
  const int bits = table_bits(c.n);
  size_t smem = c.topk > 0 ? sizeof(int) * ((size_t)2 << bits) : 0;
  // A block asks for more than the default 48 KB, which the static arrays
  // share with the dynamic bytes.
  if (smem > 40 * 1024) {
    int err = (int)cudaFuncSetAttribute(cv_small, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  cv_small<<<1, CV_SMALL_THREADS, smem, st>>>(c, bits);
  return (int)cudaGetLastError();
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

// Bytes of the zeroed scratch chain_verdict needs for n entries over
// n_rows rows (its many-block route with topk > 0).
long long chain_verdict_zero_bytes(int n, int n_rows) { return cv_zero_bytes(n, n_rows); }

// The slot chain's verdict tail (see the header and CvArgs); `args` is read
// on the host. `zero`: chain_verdict_zero_bytes(n, n_rows) bytes that are
// zero, used by the many-block route with topk > 0 and left zero. Returns
// a CUDA error code, or -1 when that route lacks its zeroed bytes (no
// launch).
int chain_verdict(const CvArgs* args, int* zero, long long zero_bytes, cudaStream_t st) {
  const CvArgs c = *args;
  if (c.n == 0 && c.topk == 0) return 0;  // with topk > 0 the top-K is still written: the k lowest rows
  if (c.n < 0 || c.topk < 0 || c.topk > KMAX || c.k < 0 || c.kd < 0 || (c.topk > 0 && c.n_rows <= 0) || c.small_max < 0 ||
      c.small_max > CV_SMALL_CAP)
    return (int)cudaErrorInvalidValue;
  if (c.n <= c.small_max) return cv_small_launch(c, st);
  const long long need = c.topk > 0 ? cv_zero_bytes(c.n, c.n_rows) : 0;
  if (c.topk > 0 && (zero == nullptr || zero_bytes < need)) return -1;
  cv_entry<<<blocks_for(c.n), THREADS, 0, st>>>(c, zero);
  int err = (int)cudaGetLastError();
  if (!err && c.topk > 0) {
    int rows = min(c.n, c.n_rows);
    int g = min(TOPK_MAX_BLOCKS, max(1, (rows + 4 * THREADS - 1) / (4 * THREADS)));
    cv_topk<<<g, THREADS, 0, st>>>(c, zero);
    err = (int)cudaGetLastError();
  }
  // cv_entry may have added into the zeroed cells: a call that fails after
  // it leaves them zero all the same.
  if (err && c.topk > 0) cudaMemsetAsync(zero, 0, (size_t)need, st);
  return err;
}

}  // extern "C"
