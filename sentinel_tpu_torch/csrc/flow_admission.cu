// Flow admission for Hopper (sm_90a): the port of
// sentinel_tpu/runtime/flush.py:flow_admission (DEFAULT controller with
// the occupy branch of prioritized entries) with segment_excl_cumsum /
// _segment_consumed, plus the verdict tail of flush_entries: the
// per-entry AND, the reason codes, the occupy wait, the breakers' probe
// transitions (degrade_table.py:apply_probe_transitions) and the
// blocked-weight top-K.
//
// Launch sequences (driven by runtime/flush.py):
//
// DEFAULT path, flow_admission_decide (no occupy, system or breakers):
//   1. fa_prep        flatten the N*K rule slots: check-row key, ts
//   2. torch.sort(ts, stable=True), fa_gather, torch.sort(row, stable=True)
//                     two stable radix sorts give the (row, ts, pos) order
//                     without packing three keys into 64 bits
//   3. window_sums    (Triton, metrics/metric_array.py) at the sorted rows
//   4. fa_flags       group starts, last slot of each entry, the charge
//   5. scan_*         the segmented exclusive prefix (segscan.cuh)
//   6. fa_decide      the float32 threshold compare, per slot
//   7. fa_verdict     per entry: AND over slots, admitted, reason, and the
//                     blocked acquire scattered into [R+1] by integer atomics
//   8. topk_pass1/2   top-K (K <= 8) by weight descending, row ascending
//
// Slot chain, flow_admission_slots (steps 1-6 without the verdict):
//   6a. with shaping, fa_decide also writes each slot's windowed pass plus
//       intra-batch charge at its flat position (the shaping stage's
//       passQps input, flush.py:pass_plus_consumed)
//   6b. with occupy, fa_decide also writes each slot's borrow charge and
//       running pass; a third segmented prefix (scan_*) gives the
//       conservative intra-batch borrow charge, and fa_occupy runs
//       tryOccupyNext's search over the future windows per eligible slot
//   7b. fa_entry      per entry: AND over slots; OR of borrows, max wait
// then, after the breakers (rules/degrade_table.py),
// flow_admission_chain_verdict:
//   8b. fa_chain      per entry: admission (live incl. the hot-parameter
//                     verdict, flow incl. the shaping verdicts, breakers;
//                     occupied entries skip the breakers), reason
//                     precedence, wait (occupy, shaping and throttle),
//                     OPEN -> HALF_OPEN for admitted probes, the gate on
//                     the borrowed slots, the blocked-weight scatter
//   9b. topk_pass1/2
//
// What bounds it: bytes and launches. Per slot it reads about 40 B of
// batch and rule table (about 64 B with occupy, which also reads the
// row's two slab cells and two bucket heads) and writes a byte of
// verdict; the sorts move 16 B per slot twice; the top-K reads the [R]
// weight array once. There is little arithmetic. The design keeps each
// step a single pass over its array and does each prefix as two plain
// scans, exact in any evaluation order.
//
// Numerics: no fast-math. The QPS compare is
// floor((float)(pass + charge) / interval_sec) + (float)acquire <= count,
// the borrow check ((pass + borrow) + acquire) - window_pass <= count *
// interval_sec, both in float32 with round-to-nearest conversions and
// IEEE arithmetic in the JAX order; interval_sec arrives as the float32
// the JAX code uses. The int32 window arithmetic wraps as JAX's does.

#include "segscan.cuh"

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

// Everything the occupy branch reads beyond the plain check (null = off).
struct Occupy {
  const uint8_t* live;
  const uint8_t* prio;
  const uint8_t* cluster;
  const int* fut_ws;
  const int* fut_pass;
  const int* sec_ws;
  const int* sec_counts;
  int nb, ne, now, wlen, interval, timeout;
};

__global__ void fa_prep(const int* __restrict__ gid, const int* __restrict__ crow,
                        const uint8_t* __restrict__ e_valid, const int* __restrict__ e_ts, int nk,
                        int k, int n_rows, int* __restrict__ row_key, int* __restrict__ ts_f) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= nk) return;
  int e = p / k;
  bool active = gid[p] >= 0 && crow[p] >= 0 && e_valid[e];
  row_key[p] = active ? crow[p] : n_rows;
  ts_f[p] = e_ts[e];
}

__global__ void fa_gather(const int64_t* __restrict__ perm1, const int* __restrict__ row_key,
                          int nk, int* __restrict__ rk1) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nk) rk1[i] = row_key[perm1[i]];
}

// `last_out` (may be null) keeps the last-of-entry flag for the borrow charge.
__global__ void fa_flags(const int* __restrict__ rk_s, const int64_t* __restrict__ perm1,
                         const int64_t* __restrict__ perm2, const int* __restrict__ crow,
                         const int* __restrict__ e_rows, const int* __restrict__ e_acq, int nk,
                         int k, int* __restrict__ pos_s, uint8_t* __restrict__ new_grp,
                         uint8_t* __restrict__ last_out, int2* __restrict__ contrib) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nk) return;
  int p = (int)perm1[perm2[i]];
  int e = p / k;
  int r = rk_s[i];
  pos_s[i] = p;
  new_grp[i] = (i == 0 || rk_s[i - 1] != r) ? 1 : 0;
  bool last = true;  // the entry's last slot within this group
  if (i + 1 < nk) {
    int pn = (int)perm1[perm2[i + 1]];
    last = rk_s[i + 1] != r || pn / k != e;
  }
  if (last_out != nullptr) last_out[i] = last ? 1 : 0;
  // The charge rides only rows the entry accounts on (its own node rows).
  int row = crow[p];
  const int* er = e_rows + (int64_t)e * 4;
  bool own = row == er[0] || row == er[1] || row == er[2] || row == er[3];
  contrib[i] = (last && own) ? make_int2(e_acq[e], 1) : make_int2(0, 0);
}

// Phase 3 of the running max, fused with the per-slot decision. With
// occupy (contrib3 non-null) it also writes each slot's borrow charge
// contribution (an eligible slot's acquire, at the entry's last slot of
// the group) and its running pass (window pass + charge).
__global__ void fa_decide(LoadSnapshot ld, int nk, int k, int n_rows, int nr,
                          const int2* __restrict__ partial_max, const int2* __restrict__ excl,
                          const int* __restrict__ pos_s, const int* __restrict__ rk_s,
                          const int* __restrict__ gid, const int* __restrict__ crow,
                          const uint8_t* __restrict__ e_valid, const int* __restrict__ e_acq,
                          const int* __restrict__ f_grade, const float* __restrict__ f_count,
                          const int* __restrict__ f_behavior, const int* __restrict__ pass_sums,
                          int pass_stride, const int* __restrict__ threads, float interval_sec,
                          uint8_t* __restrict__ slot_ok, Occupy occ, const uint8_t* __restrict__ last,
                          int2* __restrict__ contrib3, int* __restrict__ cur_pass_s, int* __restrict__ ppc) {
  __shared__ int2 warp_tot[NWARPS];
  int base = blockIdx.x * TILE + threadIdx.x * IPT;
  int2 loc[IPT];
  int2 run = max_scan_prefix(ld, nk, partial_max, loc, warp_tot);
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    int i = base + j;
    run = MaxOp::op(run, loc[j]);  // inclusive running max = the group's base
    if (i >= nk) continue;
    int p = pos_s[i];
    int e = p / k;
    int2 ex = excl[i];
    int consumed_acq = wrap_sub(ex.x, run.x);
    int consumed_cnt = wrap_sub(ex.y, run.y);
    bool active = gid[p] >= 0 && crow[p] >= 0 && e_valid[e];
    int g = clampi(gid[p], 0, nr - 1);
    int rkc = clampi(rk_s[i], 0, n_rows - 1);
    int pass = wrap_add(pass_sums[(int64_t)i * pass_stride], consumed_acq);
    float qps_cur = floorf(__fdiv_rn(__int2float_rn(pass), interval_sec));
    float thread_cur = __int2float_rn(wrap_add(threads[rkc], consumed_cnt));
    float cur = f_grade[g] == FLOW_GRADE_QPS ? qps_cur : thread_cur;
    bool ok_raw = __fadd_rn(cur, __int2float_rn(e_acq[e])) <= f_count[g];
    bool is_default = f_behavior[g] == CONTROL_BEHAVIOR_DEFAULT;
    slot_ok[p] = (ok_raw || !active || !is_default) ? 1 : 0;
    if (ppc != nullptr) ppc[p] = pass;
    if (contrib3 != nullptr) {
      bool eligible = active && !ok_raw && is_default && occ.live[e] && occ.prio[e] && occ.cluster[e] &&
                      f_grade[g] == FLOW_GRADE_QPS;
      contrib3[i] = (eligible && last[i]) ? make_int2(e_acq[e], 0) : make_int2(0, 0);
      cur_pass_s[i] = pass;
    }
  }
}

// tryOccupyNext (StatisticNode.java:302-333) per eligible slot, fused with
// the phase 3 of the borrow charge's running max. Step s of the search
// sees the pass that remains once windows 0..s expired.
__global__ void fa_occupy(LoadSnapshot ld, int nk, int k, int n_rows, int nr,
                          const int2* __restrict__ partial_max, const int2* __restrict__ excl3,
                          const int* __restrict__ pos_s, const int* __restrict__ rk_s,
                          const int* __restrict__ gid, const int* __restrict__ e_acq,
                          const int* __restrict__ f_grade, const float* __restrict__ f_count,
                          float interval_sec, const int* __restrict__ cur_pass_s, Occupy occ,
                          uint8_t* __restrict__ slot_ok, uint8_t* __restrict__ occ_slot,
                          int* __restrict__ occ_wait_slot, int* __restrict__ occ_target) {
  __shared__ int2 warp_tot[NWARPS];
  int base = blockIdx.x * TILE + threadIdx.x * IPT;
  int2 loc[IPT];
  int2 run = max_scan_prefix(ld, nk, partial_max, loc, warp_tot);
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    int i = base + j;
    run = MaxOp::op(run, loc[j]);
    if (i >= nk) continue;
    int p = pos_s[i];
    int e = p / k;
    int g = clampi(gid[p], 0, nr - 1);
    // Eligible: the plain check failed on an active DEFAULT slot (slot_ok
    // is still the plain verdict here) of a live, prioritized entry the
    // token server did not block, under a QPS rule.
    bool eligible = !slot_ok[p] && occ.live[e] && occ.prio[e] && occ.cluster[e] &&
                    f_grade[g] == FLOW_GRADE_QPS;
    bool got = false;
    int wait = 0, target = 0;
    if (eligible) {
      int row = clampi(rk_s[i], 0, n_rows - 1);
      int waiting = 0;  // StatisticNode.waiting(): tokens of still-future windows
      for (int b = 0; b < occ.nb; ++b) {
        int64_t c = (int64_t)row * occ.nb + b;
        if (occ.fut_ws[c] > occ.now) waiting = wrap_add(waiting, occ.fut_pass[c]);
      }
      int charge = wrap_sub(excl3[i].x, run.x);
      float cur_borrow = __int2float_rn(wrap_add(waiting, charge));
      float cur_pass = __int2float_rn(cur_pass_s[i]);
      float acq_f = __int2float_rn(e_acq[e]);
      float max_count = __fmul_rn(f_count[g], interval_sec);
      int now_mod = floormod(occ.now, occ.wlen);
      unsigned start = (unsigned)occ.now - (unsigned)now_mod;
      for (int s = 0; s < occ.nb; ++s) {
        int wait_s = s * occ.wlen + occ.wlen - now_mod;
        int exp_ws = (int)(start + (unsigned)occ.wlen - (unsigned)occ.interval + (unsigned)(s * occ.wlen));
        int bidx = floormod(floordiv(exp_ws, occ.wlen), occ.nb);
        int64_t c = (int64_t)row * occ.nb + bidx;
        int win_pass = occ.sec_ws[c] == exp_ws ? occ.sec_counts[c * occ.ne + EVENT_PASS] : 0;
        float win_f = __int2float_rn(win_pass);
        bool cond = exp_ws < occ.now && wait_s < occ.timeout &&
                    __fsub_rn(__fadd_rn(__fadd_rn(cur_pass, cur_borrow), acq_f), win_f) <= max_count;
        if (cond && !got) {
          wait = wait_s;
          target = (int)(start + (unsigned)((s + 1) * occ.wlen));
        }
        got = got || cond;
        cur_pass = __fsub_rn(cur_pass, win_f);
      }
    }
    occ_slot[p] = got ? 1 : 0;
    occ_wait_slot[p] = wait;
    occ_target[p] = target;
    if (got) slot_ok[p] = 1;
  }
}

// Per entry: AND over the slots; with occupy, OR of the borrows and the
// largest borrowing slot's wait.
__global__ void fa_entry(const uint8_t* __restrict__ slot_ok, int n, int k,
                         const uint8_t* __restrict__ occ_slot, const int* __restrict__ occ_wait_slot,
                         uint8_t* __restrict__ flow_pass, uint8_t* __restrict__ occupied,
                         int* __restrict__ occupy_wait) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  bool fp = true, occ = false;
  int w = 0;
  for (int j = 0; j < k; ++j) {
    int64_t p = (int64_t)e * k + j;
    fp = fp && slot_ok[p];
    if (occ_slot != nullptr && occ_slot[p]) {
      occ = true;
      w = max(w, occ_wait_slot[p]);
    }
  }
  flow_pass[e] = fp ? 1 : 0;
  if (occupied != nullptr) {
    occupied[e] = occ ? 1 : 0;
    occupy_wait[e] = w;
  }
}

// The blocked acquire of one entry into the dense [R+1] weights: warp-
// aggregated integer atomics, one per (warp, row). All lanes call it.
__device__ __forceinline__ void scatter_blocked(int w, int row, int* __restrict__ dense) {
  bool act = w > 0;
  unsigned am = __ballot_sync(FULL_MASK, act);
  if (!act) return;
  unsigned grp = __match_any_sync(am, row);
  int sum = __reduce_add_sync(grp, w);
  if ((threadIdx.x & 31) == __ffs(grp) - 1) atomicAdd(&dense[row], sum);
}

__global__ void fa_verdict(const uint8_t* __restrict__ slot_ok, int n, int k,
                           const uint8_t* __restrict__ e_valid, const uint8_t* __restrict__ e_auth,
                           const uint8_t* __restrict__ e_cluster, const int* __restrict__ e_acq,
                           const int* __restrict__ e_rows, int n_rows,
                           uint8_t* __restrict__ flow_pass, uint8_t* __restrict__ admitted,
                           int* __restrict__ reason, int* __restrict__ dense) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  int w = 0, row = -1;
  if (e < n) {
    bool fp = true;
    for (int j = 0; j < k; ++j) fp = fp && slot_ok[(int64_t)e * k + j];
    flow_pass[e] = fp ? 1 : 0;
    bool valid = e_valid[e], auth = e_auth[e];
    bool fpc = fp && e_cluster[e];
    bool adm = valid && auth && fpc;
    int r = REASON_PASS;
    if (valid && !fpc) r = REASON_BLOCK_FLOW;
    if (valid && !auth) r = REASON_BLOCK_AUTHORITY;
    if (adm) r = REASON_PASS;
    admitted[e] = adm ? 1 : 0;
    reason[e] = r;
    if (valid && !adm && e_acq[e] > 0) {
      w = e_acq[e];
      row = clampi(e_rows[(int64_t)e * 4 + 1], 0, n_rows - 1);
    }
  }
  if (dense != nullptr) scatter_blocked(w, row, dense);
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

// (w1, r1) ranks before (w2, r2): heavier first, lower row on a tie.
__device__ __forceinline__ bool better(int w1, int r1, int w2, int r2) {
  return w1 > w2 || (w1 == w2 && r1 < r2);
}

__device__ __forceinline__ void list_init(int* lw, int* lr) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) { lw[j] = INT_MIN; lr[j] = INT_MAX; }
}

__device__ __forceinline__ void list_insert(int* lw, int* lr, int k, int w, int r) {
  if (!better(w, r, lw[k - 1], lr[k - 1])) return;
  int j = k - 1;
  while (j > 0 && better(w, r, lw[j - 1], lr[j - 1])) {
    lw[j] = lw[j - 1];
    lr[j] = lr[j - 1];
    --j;
  }
  lw[j] = w;
  lr[j] = r;
}

// Merge the block's per-thread lists (in shared memory) into list 0.
__device__ void block_merge(int* sw, int* sr, int k) {
  int t = threadIdx.x;
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (t < s) {
      int aw[KMAX], ar[KMAX];
      int* bw = sw + (t + s) * KMAX;
      int* br = sr + (t + s) * KMAX;
      int* cw = sw + t * KMAX;
      int* cr = sr + t * KMAX;
      int ia = 0, ib = 0;
      for (int j = 0; j < k; ++j) {
        if (better(cw[ia], cr[ia], bw[ib], br[ib])) { aw[j] = cw[ia]; ar[j] = cr[ia]; ++ia; }
        else { aw[j] = bw[ib]; ar[j] = br[ib]; ++ib; }
      }
      for (int j = 0; j < k; ++j) { cw[j] = aw[j]; cr[j] = ar[j]; }
    }
    __syncthreads();
  }
}

__global__ void topk_pass1(const int* __restrict__ dense, int n_rows, int k,
                           int* __restrict__ cand_w, int* __restrict__ cand_r) {
  __shared__ int sw[THREADS * KMAX];
  __shared__ int sr[THREADS * KMAX];
  int lw[KMAX], lr[KMAX];
  list_init(lw, lr);
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n_rows; i += gridDim.x * THREADS)
    list_insert(lw, lr, k, dense[i], i);
  for (int j = 0; j < KMAX; ++j) { sw[threadIdx.x * KMAX + j] = lw[j]; sr[threadIdx.x * KMAX + j] = lr[j]; }
  __syncthreads();
  block_merge(sw, sr, k);
  if (threadIdx.x < k) {
    cand_w[blockIdx.x * KMAX + threadIdx.x] = sw[threadIdx.x];
    cand_r[blockIdx.x * KMAX + threadIdx.x] = sr[threadIdx.x];
  }
}

__global__ void topk_pass2(const int* __restrict__ cand_w, const int* __restrict__ cand_r,
                           int n_blocks, int k, int* __restrict__ out_w, int* __restrict__ out_r) {
  __shared__ int sw[THREADS * KMAX];
  __shared__ int sr[THREADS * KMAX];
  int lw[KMAX], lr[KMAX];
  list_init(lw, lr);
  for (int b = threadIdx.x; b < n_blocks; b += THREADS)
    for (int j = 0; j < k; ++j) list_insert(lw, lr, k, cand_w[b * KMAX + j], cand_r[b * KMAX + j]);
  for (int j = 0; j < KMAX; ++j) { sw[threadIdx.x * KMAX + j] = lw[j]; sr[threadIdx.x * KMAX + j] = lr[j]; }
  __syncthreads();
  block_merge(sw, sr, k);
  if (threadIdx.x < k) {
    out_w[threadIdx.x] = sw[threadIdx.x];
    out_r[threadIdx.x] = sr[threadIdx.x];
  }
}

int topk_blocks(int n_rows) {
  int b = (n_rows + THREADS * 16 - 1) / (THREADS * 16);
  return b < 1 ? 1 : (b > 1024 ? 1024 : b);
}

// The top-K after the dense weights are in place.
void launch_topk(const int* dense, int n_rows, int topk, int* cand_w, int* cand_r, int* blk_w, int* blk_r,
                 cudaStream_t st) {
  int nb = topk_blocks(n_rows);
  topk_pass1<<<nb, THREADS, 0, st>>>(dense, n_rows, topk, cand_w, cand_r);
  topk_pass2<<<1, THREADS, 0, st>>>(cand_w, cand_r, nb, topk, blk_w, blk_r);
}

// Steps 4-6: flags, the two segmented prefixes and the per-slot decision.
void launch_decide(const int* rk_s, const int64_t* perm1, const int64_t* perm2, const int* gid,
                   const int* crow, const uint8_t* e_valid, const int* e_acq, const int* e_rows, int n,
                   int k, int n_rows, int nr, const int* f_grade, const float* f_count,
                   const int* f_behavior, const int* pass_sums, int pass_stride, const int* threads,
                   float interval_sec, int* pos_s, uint8_t* new_grp, uint8_t* last, int* contrib,
                   int* excl, int* partial, int* partial_max, uint8_t* slot_ok, Occupy occ,
                   int* contrib3, int* cur_pass_s, int* ppc, cudaStream_t st) {
  int nk = n * k;
  int tiles = tiles_for(nk);
  int2* c2 = reinterpret_cast<int2*>(contrib);
  int2* x2 = reinterpret_cast<int2*>(excl);
  int2* p2 = reinterpret_cast<int2*>(partial);
  int2* m2 = reinterpret_cast<int2*>(partial_max);
  fa_flags<<<blocks_for(nk), THREADS, 0, st>>>(rk_s, perm1, perm2, crow, e_rows, e_acq, nk, k, pos_s,
                                               new_grp, last, c2);
  LoadContrib lc{c2};
  scan_reduce<SumOp, LoadContrib><<<tiles, THREADS, 0, st>>>(lc, nk, p2);
  scan_partials<SumOp><<<1, THREADS, 0, st>>>(p2, tiles);
  scan_apply_sum<<<tiles, THREADS, 0, st>>>(lc, nk, p2, x2);
  LoadSnapshot ls{x2, new_grp};
  scan_reduce<MaxOp, LoadSnapshot><<<tiles, THREADS, 0, st>>>(ls, nk, m2);
  scan_partials<MaxOp><<<1, THREADS, 0, st>>>(m2, tiles);
  fa_decide<<<tiles, THREADS, 0, st>>>(ls, nk, k, n_rows, nr, m2, x2, pos_s, rk_s, gid, crow, e_valid,
                                       e_acq, f_grade, f_count, f_behavior, pass_sums, pass_stride,
                                       threads, interval_sec, slot_ok, occ, last,
                                       reinterpret_cast<int2*>(contrib3), cur_pass_s, ppc);
}

}  // namespace

extern "C" {

// Step 1: per flat slot, the check-row sort key and the entry's ts.
int flow_admission_prep(const int* gid, const int* crow, const uint8_t* e_valid, const int* e_ts,
                        int nk, int k, int n_rows, int* row_key, int* ts_f, void* stream) {
  if (nk <= 0) return 0;
  fa_prep<<<blocks_for(nk), THREADS, 0, (cudaStream_t)stream>>>(gid, crow, e_valid, e_ts, nk, k,
                                                                n_rows, row_key, ts_f);
  return (int)cudaGetLastError();
}

// Step 2 (between the sorts): the row keys in ts order.
int flow_admission_gather(const int64_t* perm1, const int* row_key, int nk, int* rk1, void* stream) {
  if (nk <= 0) return 0;
  fa_gather<<<blocks_for(nk), THREADS, 0, (cudaStream_t)stream>>>(perm1, row_key, nk, rk1);
  return (int)cudaGetLastError();
}

// Size of the int2 scratch for the tile totals.
int flow_admission_tiles(int nk) { return tiles_for(nk); }

// Number of first-pass top-K blocks for n_rows rows.
int flow_admission_topk_blocks(int n_rows) { return topk_blocks(n_rows); }

// The DEFAULT path, steps 4-8. Scratch: pos_s [nk], new_grp [nk],
// contrib/excl int2 [nk], partial/partial_max int2 [tiles]; dense [n_rows+1]
// and cand [2 * blocks * 8] when topk > 0 (dense is zeroed here).
// pass_sums holds the windowed PASS of each sorted slot's row at stride
// pass_stride.
int flow_admission_decide(
    const int* rk_s, const int64_t* perm1, const int64_t* perm2, const int* gid, const int* crow,
    const uint8_t* e_valid, const uint8_t* e_auth, const uint8_t* e_cluster, const int* e_acq,
    const int* e_rows, int n, int k, int n_rows, int nr, const int* f_grade, const float* f_count,
    const int* f_behavior, const int* pass_sums, int pass_stride, const int* threads,
    float interval_sec, int topk, int* pos_s, uint8_t* new_grp, int* contrib, int* excl,
    int* partial, int* partial_max, int* dense, int* cand_w, int* cand_r,
    uint8_t* slot_ok, uint8_t* flow_pass, uint8_t* admitted, int* reason, int* blk_w, int* blk_r,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int nk = n * k;
  if (nk <= 0) return 0;
  if (topk > KMAX) return (int)cudaErrorInvalidValue;
  Occupy off{};
  launch_decide(rk_s, perm1, perm2, gid, crow, e_valid, e_acq, e_rows, n, k, n_rows, nr, f_grade,
                f_count, f_behavior, pass_sums, pass_stride, threads, interval_sec, pos_s, new_grp,
                nullptr, contrib, excl, partial, partial_max, slot_ok, off, nullptr, nullptr, nullptr, st);
  int* d = nullptr;
  if (topk > 0) {
    cudaError_t err = cudaMemsetAsync(dense, 0, sizeof(int) * ((size_t)n_rows + 1), st);
    if (err != cudaSuccess) return (int)err;
    d = dense;
  }
  fa_verdict<<<blocks_for(n), THREADS, 0, st>>>(slot_ok, n, k, e_valid, e_auth, e_cluster, e_acq,
                                                e_rows, n_rows, flow_pass, admitted, reason, d);
  if (topk > 0) launch_topk(dense, n_rows, topk, cand_w, cand_r, blk_w, blk_r, st);
  return (int)cudaGetLastError();
}

// The slot chain's flow stage: steps 4-6, with occupy (occupy != 0) the
// borrow search, and the per-entry fold (7b). `flags` holds new_grp and
// the last-of-entry flags, [nk] each. With occupy, scratch also holds
// contrib3/excl3 int2 [nk], occ_wait_slot and cur_pass_s [nk]; outputs
// occ_slot/occ_target [nk], occupied/occupy_wait [n]. Without occupy they
// may all be null. ppc [nk] (may be null) receives each slot's pass plus
// intra-batch charge.
int flow_admission_slots(
    const int* rk_s, const int64_t* perm1, const int64_t* perm2, const int* gid, const int* crow,
    const int* e_acq, const int* e_rows, int n, int k, int n_rows, int nr, const int* f_grade,
    const float* f_count, const int* f_behavior, const int* pass_sums, int pass_stride,
    const int* threads, float interval_sec, int occupy, const uint8_t* live, const uint8_t* e_prio,
    const uint8_t* e_cluster, const int* fut_ws, const int* fut_pass, const int* sec_ws,
    const int* sec_counts, int nb, int ne, int now, int wlen, int interval_ms, int occupy_timeout_ms,
    const uint8_t* e_valid, int* pos_s, uint8_t* flags, int* contrib, int* excl, int* partial,
    int* partial_max, int* contrib3, int* excl3, int* occ_wait_slot, int* cur_pass_s, int* ppc,
    uint8_t* slot_ok, uint8_t* flow_pass, uint8_t* occ_slot, int* occ_target, uint8_t* occupied,
    int* occupy_wait, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int nk = n * k;
  if (nk <= 0) return 0;
  if (occupy && (wlen <= 0 || nb <= 0)) return (int)cudaErrorInvalidValue;
  uint8_t* new_grp = flags;
  uint8_t* last = flags + nk;
  Occupy occ{live, e_prio, e_cluster, fut_ws, fut_pass, sec_ws, sec_counts, nb, ne, now, wlen,
             interval_ms, occupy_timeout_ms};
  launch_decide(rk_s, perm1, perm2, gid, crow, e_valid, e_acq, e_rows, n, k, n_rows, nr, f_grade,
                f_count, f_behavior, pass_sums, pass_stride, threads, interval_sec, pos_s, new_grp,
                last, contrib, excl, partial, partial_max, slot_ok, occ,
                occupy ? contrib3 : nullptr, cur_pass_s, ppc, st);
  if (occupy) {
    int tiles = tiles_for(nk);
    int2* c3 = reinterpret_cast<int2*>(contrib3);
    int2* x3 = reinterpret_cast<int2*>(excl3);
    int2* p2 = reinterpret_cast<int2*>(partial);
    int2* m2 = reinterpret_cast<int2*>(partial_max);
    LoadContrib lc{c3};
    scan_reduce<SumOp, LoadContrib><<<tiles, THREADS, 0, st>>>(lc, nk, p2);
    scan_partials<SumOp><<<1, THREADS, 0, st>>>(p2, tiles);
    scan_apply_sum<<<tiles, THREADS, 0, st>>>(lc, nk, p2, x3);
    LoadSnapshot ls{x3, new_grp};
    scan_reduce<MaxOp, LoadSnapshot><<<tiles, THREADS, 0, st>>>(ls, nk, m2);
    scan_partials<MaxOp><<<1, THREADS, 0, st>>>(m2, tiles);
    fa_occupy<<<tiles, THREADS, 0, st>>>(ls, nk, k, n_rows, nr, m2, x3, pos_s, rk_s, gid, e_acq,
                                         f_grade, f_count, interval_sec, cur_pass_s, occ, slot_ok,
                                         occ_slot, occ_wait_slot, occ_target);
  }
  fa_entry<<<blocks_for(n), THREADS, 0, st>>>(slot_ok, n, k, occupy ? occ_slot : nullptr,
                                              occ_wait_slot, flow_pass, occupy ? occupied : nullptr,
                                              occupy_wait);
  return (int)cudaGetLastError();
}

// The verdict after the breakers (8b-9b); see fa_chain for the null
// inputs. occ_slot [n*k] is gated in place. dense/cand as for decide.
int flow_admission_chain_verdict(
    int n, int k, int kd, int n_rows, const uint8_t* e_valid, const uint8_t* e_auth,
    const uint8_t* sys_ok, const uint8_t* flow_pass, const uint8_t* e_cluster,
    const uint8_t* occupied_raw, const int* occupy_wait, const uint8_t* dslot_ok,
    const uint8_t* probe_slot, const int* e_dgid, int* state, uint8_t* occ_slot, const uint8_t* param_ok,
    const int* wait_param, const int* shape_wait, const int* e_acq,
    const int* e_rows, int topk, int* dense, int* cand_w, int* cand_r, uint8_t* admitted,
    int* reason, int* wait_ms, uint8_t* flow_live, uint8_t* occupied, int* blk_w, int* blk_r,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (topk > KMAX) return (int)cudaErrorInvalidValue;
  int* d = nullptr;
  if (topk > 0) {
    cudaError_t err = cudaMemsetAsync(dense, 0, sizeof(int) * ((size_t)n_rows + 1), st);
    if (err != cudaSuccess) return (int)err;
    d = dense;
  }
  fa_chain<<<blocks_for(n), THREADS, 0, st>>>(n, k, kd, n_rows, e_valid, e_auth, sys_ok, flow_pass,
                                              e_cluster, occupied_raw, occupy_wait, dslot_ok,
                                              probe_slot, e_dgid, state, occ_slot, param_ok, wait_param,
                                              shape_wait, e_acq, e_rows,
                                              admitted, reason, wait_ms, flow_live, occupied, d);
  if (topk > 0) launch_topk(dense, n_rows, topk, cand_w, cand_r, blk_w, blk_r, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
