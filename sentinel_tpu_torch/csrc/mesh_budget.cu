// The sharded step's budget math for Hopper (sm_90a), all shards of one
// device in one launch sequence:
//
// K15 mesh_split_spend: sentinel_tpu/parallel/ici.py:_split_and_spend with
//     the cap prologues of _demote_over_grant (the flow budget) and
//     _demote_over_borrow (the occupy borrow budget). Per shard and check
//     row, the demand of the participating slots; the cross-shard
//     exclusive prefix `before` (cluster_allocate's recipe); within the
//     shard, the row's charge spent in (ts, arrival) order; a slot is kept
//     iff before + its segment prefix + acquire <= its own cap, and an
//     entry iff every participating slot is kept.
// K16 mesh_shaping_charge: the global shaping charge of
//     ici.py:_global_shaping_scan: over every valid global shaping item
//     (liveness-unmasked), in (row, ts, item) order, the acquire of the
//     earlier entries of the row (an entry's contribution sits at its last
//     item of the row), plus the row's windowed PASS, back in item order.
//
// Launch sequence of K15 (parallel/ici.py:_mesh_split_spend_cuda):
//   1. demand[D, R] zeroed (torch)
//   2. ms_prep     per flat slot: the participation mask, the unit, the
//                  float32 cap (window PASS sum or thread gauge; borrow:
//                  count x interval minus the waiting tokens), the demand
//                  by atomicAdd, and one int64 sort key:
//                  ((shard * (R + 1) + row|R) << 32) | (ts ^ 2^31)
//   3. torch.sort(key, stable=True): (shard, row, ts, pos) in one sort
//   4. ms_flags    group heads and the contributions
//   5. scan_*      the segmented exclusive prefix (segscan.cuh)
//   6. ms_decide   before from the demand, the keep per slot
//   7. ms_entries  the AND over each entry's slots
// K16: msc_prep (key (row|R) << 32 | ts ^ 2^31), torch.sort, msc_flags,
// scan_*, msc_decide.
//
// What bounds them: bytes, then the sort. K15 reads per slot its gid,
// check row, entry ts, acquire and masks (about 18 B) and the row's window
// (B buckets of start and PASS) or gauge or slab; the sort moves 16 B per
// slot twice; demand is D x R int32, written where touched and read at
// D - 1 cells per slot. K16 reads 17 B per item and the row's window.
//
// Numerics as the JAX code: int32 sums wrap (uint32 adds), the caps are
// float32 (IEEE division and multiplication, floorf, no fast math) and
// convert with XLA's saturating truncation (__float2int_rz).

#include "segscan.cuh"

namespace {

constexpr int FLOW_GRADE_QPS = 1;  // models/constants.py
constexpr int CONTROL_BEHAVIOR_DEFAULT = 0;
constexpr int EVENT_PASS = 0;  // metrics/events.py

struct Window {  // the second window (metric_array.MetricArrayState)
  const int* counts;  // [R, B, NE]
  const int* ws;      // [R, B]
  int nb, ne, interval_ms;
};

// window_sums (metric_array.py) of one row's PASS at `now`: the buckets
// with now - ws <= interval, in wrapping int32.
__device__ __forceinline__ int pass_sum(const Window& w, int row, int now) {
  int s = 0;
  for (int b = 0; b < w.nb; ++b) {
    int64_t c = (int64_t)row * w.nb + b;
    if (wrap_sub(now, w.ws[c]) <= w.interval_ms) s = wrap_add(s, w.counts[c * w.ne + EVENT_PASS]);
  }
  return s;
}

__device__ __forceinline__ long long sort_key(int hi, int ts) {
  return (long long)hi * 4294967296LL + (long long)(unsigned)(ts ^ (int)0x80000000u);
}

__device__ __forceinline__ int key_hi(long long key) { return (int)(key >> 32); }

struct Prep {
  int grant;  // 1: _demote_over_grant, 0: _demote_over_borrow
  const int* gid;
  const int* crow;
  const uint8_t* e_valid;
  const int* e_ts;
  const int* e_acq;
  const uint8_t* live;      // grant: bool [N] budgeted entries
  const uint8_t* occ_slot;  // borrow: bool [N * K] borrowing slots
  const int* f_grade;
  const float* f_count;
  const int* f_behavior;
  Window win;               // grant
  const int* threads;       // grant
  const int* fpass;         // borrow: the future slab [R, B]
  const int* fws;
  int slab_b;
  int now;
  float interval_sec;
};

__global__ void ms_prep(Prep a, int nk, int k, int slots_per_shard, int n_rows, int nr,
                        long long* __restrict__ keys, int* __restrict__ unit_out, int* __restrict__ cap_out,
                        uint8_t* __restrict__ mask_out, int* __restrict__ demand) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= nk) return;
  int e = p / k;
  int shard = p / slots_per_shard;
  int g = a.gid[p], row = a.crow[p];
  int gc = clampi(g, 0, nr - 1), rc = clampi(row, 0, n_rows - 1);
  int acq = a.e_acq[e];
  bool m;
  int unit;
  float cap;
  if (a.grant) {
    bool is_qps = a.f_grade[gc] == FLOW_GRADE_QPS;
    m = g >= 0 && row >= 0 && a.e_valid[e] && a.live[e] && a.f_behavior[gc] == CONTROL_BEHAVIOR_DEFAULT;
    unit = is_qps ? acq : 1;
    float base = is_qps ? floorf(__fdiv_rn(__int2float_rn(pass_sum(a.win, rc, a.now)), a.interval_sec))
                        : __int2float_rn(a.threads[rc]);
    cap = __fsub_rn(floorf(a.f_count[gc]), base);
  } else {
    m = a.occ_slot[p];
    unit = acq;
    int waiting = 0;  // waiting_tokens (nodes.py): tokens of still-future windows
    for (int b = 0; b < a.slab_b; ++b) {
      int64_t c = (int64_t)rc * a.slab_b + b;
      if (a.fws[c] > a.now) waiting = wrap_add(waiting, a.fpass[c]);
    }
    cap = __fsub_rn(floorf(__fmul_rn(a.f_count[gc], a.interval_sec)), __int2float_rn(waiting));
  }
  cap_out[p] = __float2int_rz(fmaxf(cap, 0.0f));
  unit_out[p] = unit;
  mask_out[p] = m ? 1 : 0;
  keys[p] = sort_key(shard * (n_rows + 1) + (m ? rc : n_rows), a.e_ts[e]);
  if (m) atomicAdd(&demand[(int64_t)shard * n_rows + rc], unit);
}

__global__ void ms_flags(const long long* __restrict__ key_s, const int64_t* __restrict__ perm, int nk,
                         const uint8_t* __restrict__ mask, const int* __restrict__ unit,
                         uint8_t* __restrict__ new_grp, int2* __restrict__ contrib) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nk) return;
  int p = (int)perm[i];
  new_grp[i] = (i == 0 || key_hi(key_s[i - 1]) != key_hi(key_s[i])) ? 1 : 0;
  contrib[i] = make_int2(mask[p] ? unit[p] : 0, 0);
}

__global__ void ms_decide(LoadSnapshot ld, int nk, int k, int n_rows, const int2* __restrict__ partial_max,
                          const int2* __restrict__ excl, const long long* __restrict__ key_s,
                          const int64_t* __restrict__ perm, const uint8_t* __restrict__ mask,
                          const int* __restrict__ cap, const int* __restrict__ e_acq,
                          const int* __restrict__ demand, uint8_t* __restrict__ keep_slot) {
  __shared__ int2 warp_tot[NWARPS];
  int base = blockIdx.x * TILE + threadIdx.x * IPT;
  int2 loc[IPT];
  int2 run = max_scan_prefix(ld, nk, partial_max, loc, warp_tot);
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    int i = base + j;
    run = MaxOp::op(run, loc[j]);  // inclusive running max = the group's base
    if (i >= nk) continue;
    int p = (int)perm[i];
    if (!mask[p]) {
      keep_slot[p] = 1;
      continue;
    }
    int hi = key_hi(key_s[i]);
    int shard = hi / (n_rows + 1);
    int row = clampi(hi - shard * (n_rows + 1), 0, n_rows - 1);
    int before = 0;  // the cross-shard exclusive demand prefix
    for (int d = 0; d < shard; ++d) before = wrap_add(before, demand[(int64_t)d * n_rows + row]);
    int prefix = wrap_sub(excl[i].x, run.x);
    keep_slot[p] = wrap_add(wrap_add(before, prefix), e_acq[p / k]) <= cap[p] ? 1 : 0;
  }
}

__global__ void ms_entries(const uint8_t* __restrict__ keep_slot, int n, int k, uint8_t* __restrict__ keep) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  bool all = true;
  for (int j = 0; j < k; ++j) all = all && keep_slot[(int64_t)e * k + j];
  keep[e] = all ? 1 : 0;
}

__global__ void msc_prep(const uint8_t* __restrict__ valid, const int* __restrict__ row,
                         const int* __restrict__ ts, int s, int n_rows, long long* __restrict__ keys) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  keys[i] = sort_key(valid[i] ? row[i] : n_rows, ts[i]);
}

__global__ void msc_flags(const long long* __restrict__ key_s, const int64_t* __restrict__ perm, int s,
                          const uint8_t* __restrict__ valid, const int* __restrict__ eidx,
                          const int* __restrict__ acq, uint8_t* __restrict__ new_grp, int2* __restrict__ contrib) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  int p = (int)perm[i];
  int rk = key_hi(key_s[i]);
  new_grp[i] = (i == 0 || key_hi(key_s[i - 1]) != rk) ? 1 : 0;
  bool last = i + 1 == s || key_hi(key_s[i + 1]) != rk || eidx[(int)perm[i + 1]] != eidx[p];
  contrib[i] = make_int2((last && valid[p]) ? acq[p] : 0, 0);
}

__global__ void msc_decide(LoadSnapshot ld, int s, int n_rows, const int2* __restrict__ partial_max,
                           const int2* __restrict__ excl, const long long* __restrict__ key_s,
                           const int64_t* __restrict__ perm, Window win, int now, int* __restrict__ ppc) {
  __shared__ int2 warp_tot[NWARPS];
  int base = blockIdx.x * TILE + threadIdx.x * IPT;
  int2 loc[IPT];
  int2 run = max_scan_prefix(ld, s, partial_max, loc, warp_tot);
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    int i = base + j;
    run = MaxOp::op(run, loc[j]);
    if (i >= s) continue;
    int row = clampi(key_hi(key_s[i]), 0, n_rows - 1);
    ppc[(int)perm[i]] = wrap_add(pass_sum(win, row, now), wrap_sub(excl[i].x, run.x));
  }
}

// Steps 5: the segmented exclusive prefix of the contributions, as two
// three-phase scans (the wrapping cumsum, then the running max of the
// group-start snapshots, whose last phase the decide kernel fuses).
void launch_scans(LoadContrib lc, LoadSnapshot ls, int n, int2* partial, int2* partial_max, int2* excl,
                  cudaStream_t st) {
  int tiles = tiles_for(n);
  scan_reduce<SumOp, LoadContrib><<<tiles, THREADS, 0, st>>>(lc, n, partial);
  scan_partials<SumOp><<<1, THREADS, 0, st>>>(partial, tiles);
  scan_apply_sum<<<tiles, THREADS, 0, st>>>(lc, n, partial, excl);
  scan_reduce<MaxOp, LoadSnapshot><<<tiles, THREADS, 0, st>>>(ls, n, partial_max);
  scan_partials<MaxOp><<<1, THREADS, 0, st>>>(partial_max, tiles);
}

}  // namespace

extern "C" {

int mesh_tiles(int n) { return tiles_for(n); }

// K15 step 2. `grant` selects the prologue; the other mode's pointers may
// be null. demand is [n_shards, n_rows], zeroed.
int mesh_split_prep(int grant, const int* gid, const int* crow, const uint8_t* e_valid, const int* e_ts,
                    const int* e_acq, const uint8_t* live, const uint8_t* occ_slot, const int* f_grade,
                    const float* f_count, const int* f_behavior, const int* sec_counts, const int* sec_ws,
                    int nb, int ne, int interval_ms, const int* threads, const int* fpass, const int* fws,
                    int slab_b, int now, float interval_sec, int n, int k, int n_shards, int n_rows, int nr,
                    long long* keys, int* unit, int* cap, uint8_t* mask, int* demand, void* stream) {
  int nk = n * k;
  if (nk <= 0) return 0;
  Prep a{grant, gid, crow, e_valid, e_ts, e_acq, live, occ_slot, f_grade, f_count, f_behavior,
         Window{sec_counts, sec_ws, nb, ne, interval_ms}, threads, fpass, fws, slab_b, now, interval_sec};
  ms_prep<<<blocks_for(nk), THREADS, 0, (cudaStream_t)stream>>>(a, nk, k, nk / n_shards, n_rows, nr, keys, unit,
                                                               cap, mask, demand);
  return (int)cudaGetLastError();
}

// K15 steps 4-7, after the sort. scratch: new_grp [nk], contrib/excl
// [2 nk] each, partial/partial_max [2 tiles] each.
int mesh_split_spend(const long long* key_s, const int64_t* perm, const uint8_t* mask, const int* unit,
                     const int* cap, const int* e_acq, const int* demand, int n, int k, int n_rows,
                     uint8_t* new_grp, int* contrib, int* excl, int* partial, int* partial_max,
                     uint8_t* keep_slot, uint8_t* keep, void* stream) {
  int nk = n * k;
  if (nk <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int2* c2 = reinterpret_cast<int2*>(contrib);
  int2* x2 = reinterpret_cast<int2*>(excl);
  int2* m2 = reinterpret_cast<int2*>(partial_max);
  ms_flags<<<blocks_for(nk), THREADS, 0, st>>>(key_s, perm, nk, mask, unit, new_grp, c2);
  LoadContrib lc{c2};
  LoadSnapshot ls{x2, new_grp};
  launch_scans(lc, ls, nk, reinterpret_cast<int2*>(partial), m2, x2, st);
  ms_decide<<<tiles_for(nk), THREADS, 0, st>>>(ls, nk, k, n_rows, m2, x2, key_s, perm, mask, cap, e_acq, demand,
                                                keep_slot);
  ms_entries<<<blocks_for(n), THREADS, 0, st>>>(keep_slot, n, k, keep);
  return (int)cudaGetLastError();
}

// K16 step 1.
int mesh_charge_keys(const uint8_t* valid, const int* row, const int* ts, int s, int n_rows, long long* keys,
                     void* stream) {
  if (s <= 0) return 0;
  msc_prep<<<blocks_for(s), THREADS, 0, (cudaStream_t)stream>>>(valid, row, ts, s, n_rows, keys);
  return (int)cudaGetLastError();
}

// K16 after the sort. ppc is int32 [s] in item order.
int mesh_charge(const long long* key_s, const int64_t* perm, const uint8_t* valid, const int* eidx,
                const int* acq, int s, int n_rows, const int* sec_counts, const int* sec_ws, int nb, int ne,
                int interval_ms, int now, uint8_t* new_grp, int* contrib, int* excl, int* partial,
                int* partial_max, int* ppc, void* stream) {
  if (s <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int2* c2 = reinterpret_cast<int2*>(contrib);
  int2* x2 = reinterpret_cast<int2*>(excl);
  int2* m2 = reinterpret_cast<int2*>(partial_max);
  msc_flags<<<blocks_for(s), THREADS, 0, st>>>(key_s, perm, s, valid, eidx, acq, new_grp, c2);
  LoadContrib lc{c2};
  LoadSnapshot ls{x2, new_grp};
  launch_scans(lc, ls, s, reinterpret_cast<int2*>(partial), m2, x2, st);
  msc_decide<<<tiles_for(s), THREADS, 0, st>>>(ls, s, n_rows, m2, x2, key_s, perm,
                                                Window{sec_counts, sec_ws, nb, ne, interval_ms}, now, ppc);
  return (int)cudaGetLastError();
}

}  // extern "C"
