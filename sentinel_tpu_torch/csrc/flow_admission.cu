// Flow admission for Hopper (sm_90a): the port of
// sentinel_tpu/runtime/flush.py:flow_admission (DEFAULT controller, no
// occupy branch) with segment_excl_cumsum / _segment_consumed, plus the
// verdict tail of flush_entries: the per-entry AND, the reason codes and
// the blocked-weight top-K.
//
// Launch sequence (driven by runtime/flush.py:_flow_admission_cuda):
//   1. fa_prep        flatten the N*K rule slots: check-row key, ts
//   2. torch.sort(ts, stable=True), fa_gather, torch.sort(row, stable=True)
//                     two stable radix sorts give the (row, ts, pos) order
//                     without packing three keys into 64 bits
//   3. window_sums    (Triton, metrics/metric_array.py) at the sorted rows
//   4. fa_flags       group starts, last slot of each entry, the charge
//   5. scan_*         the segmented exclusive prefix, as in the JAX code:
//                     a wrapping int32 exclusive sum over all slots, then
//                     an inclusive running max of the group-start values;
//                     each is a three-phase block scan (block totals, one
//                     block scanning the totals, block scan plus carry)
//   6. fa_decide      the float32 threshold compare, per slot
//   7. fa_verdict     per entry: AND over slots, admitted, reason, and the
//                     blocked acquire scattered into [R+1] by integer atomics
//   8. topk_pass1/2   top-K (K <= 8) by weight descending, row ascending:
//                     block-local lists, then one block merging them
//
// What bounds it: bytes and launches. Per slot it reads about 40 B of
// batch and rule table and writes a byte of verdict; the sorts move
// 16 B per slot twice; the top-K reads the [R] weight array once. There
// is little arithmetic. The design keeps each step a single pass over
// its array and does the prefix as two plain scans, both exact in any
// evaluation order: wrapping integer addition and max are associative,
// so the result equals the JAX cumsum/cummax bit for bit.
//
// Numerics: no fast-math. The QPS compare is
// floor((float)(pass + charge) / interval_sec) + (float)acquire <= count
// in float32 with round-to-nearest conversions and IEEE division, as
// XLA computes it; interval_sec arrives as the float32 the JAX code uses.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int IPT = 4;                 // items per thread in the scans
constexpr int TILE = THREADS * IPT;    // items per scan block
constexpr int KMAX = 8;                // top-K capacity
constexpr int FLOW_GRADE_QPS = 1;      // models/constants.py
constexpr int CONTROL_BEHAVIOR_DEFAULT = 0;
constexpr int REASON_PASS = 0;         // core/errors.py
constexpr int REASON_BLOCK_FLOW = 1;
constexpr int REASON_BLOCK_AUTHORITY = 4;

__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wrap_sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

struct SumOp {
  __device__ static int2 id() { return make_int2(0, 0); }
  __device__ static int2 op(int2 a, int2 b) { return make_int2(wrap_add(a.x, b.x), wrap_add(a.y, b.y)); }
};

struct MaxOp {
  __device__ static int2 id() { return make_int2(INT_MIN, INT_MIN); }
  __device__ static int2 op(int2 a, int2 b) { return make_int2(max(a.x, b.x), max(a.y, b.y)); }
};

// Slot contributions (acquire, count) at their sorted positions.
struct LoadContrib {
  const int2* c;
  __device__ int2 operator()(int i) const { return c[i]; }
};

// Group-start snapshots: the exclusive sum where a group starts, else 0
// (segment_excl_cumsum's jnp.where(new_grp, excl, 0)).
struct LoadSnapshot {
  const int2* excl;
  const uint8_t* new_grp;
  __device__ int2 operator()(int i) const { return new_grp[i] ? excl[i] : make_int2(0, 0); }
};

__device__ __forceinline__ int2 shfl_up2(int2 v, int off) {
  return make_int2(__shfl_up_sync(FULL_MASK, v.x, off), __shfl_up_sync(FULL_MASK, v.y, off));
}

// Exclusive scan of one value per thread over the block; `total` gets the
// block's reduction. All threads of the block must call it.
template <class Op>
__device__ int2 block_exclusive_scan(int2 v, int2* warp_tot, int2& total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int2 y = shfl_up2(x, off);
    if (lane >= off) x = Op::op(y, x);
  }
  int2 ex_in_warp = shfl_up2(x, 1);
  if (lane == 0) ex_in_warp = Op::id();
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int2 w = lane < NWARPS ? warp_tot[lane] : Op::id();
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int2 y = shfl_up2(w, off);
      if (lane >= off) w = Op::op(y, w);
    }
    if (lane < NWARPS) warp_tot[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int2 warp_prefix = warp == 0 ? Op::id() : warp_tot[warp - 1];
  total = warp_tot[NWARPS - 1];
  __syncthreads();  // warp_tot may be reused by the caller's next scan
  return Op::op(warp_prefix, ex_in_warp);
}

// Phase 1: one total per TILE of the input.
template <class Op, class Load>
__global__ void scan_reduce(Load ld, int n, int2* __restrict__ partial) {
  __shared__ int2 warp_tot[NWARPS];
  int base = blockIdx.x * TILE + threadIdx.x * IPT;
  int2 acc = Op::id();
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    int i = base + j;
    if (i < n) acc = Op::op(acc, ld(i));
  }
  int2 total;
  block_exclusive_scan<Op>(acc, warp_tot, total);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// Phase 2: one block turns the tile totals into exclusive carries.
template <class Op>
__global__ void scan_partials(int2* __restrict__ partial, int nb) {
  __shared__ int2 warp_tot[NWARPS];
  int2 carry = Op::id();
  for (int start = 0; start < nb; start += TILE) {
    int2 loc[IPT];
    int2 acc = Op::id();
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      int i = start + threadIdx.x * IPT + j;
      loc[j] = i < nb ? partial[i] : Op::id();
      acc = Op::op(acc, loc[j]);
    }
    int2 total;
    int2 run = Op::op(carry, block_exclusive_scan<Op>(acc, warp_tot, total));
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      int i = start + threadIdx.x * IPT + j;
      if (i < nb) partial[i] = run;
      run = Op::op(run, loc[j]);
    }
    carry = Op::op(carry, total);
  }
}

// Phase 3 of the sum: exclusive prefix of the contributions.
__global__ void scan_apply_sum(LoadContrib ld, int n, const int2* __restrict__ partial,
                               int2* __restrict__ excl) {
  __shared__ int2 warp_tot[NWARPS];
  int base = blockIdx.x * TILE + threadIdx.x * IPT;
  int2 loc[IPT];
  int2 acc = SumOp::id();
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    int i = base + j;
    loc[j] = i < n ? ld(i) : SumOp::id();
    acc = SumOp::op(acc, loc[j]);
  }
  int2 total;
  int2 run = SumOp::op(partial[blockIdx.x], block_exclusive_scan<SumOp>(acc, warp_tot, total));
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    int i = base + j;
    if (i < n) excl[i] = run;
    run = SumOp::op(run, loc[j]);
  }
}

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

__global__ void fa_flags(const int* __restrict__ rk_s, const int64_t* __restrict__ perm1,
                         const int64_t* __restrict__ perm2, const int* __restrict__ crow,
                         const int* __restrict__ e_rows, const int* __restrict__ e_acq, int nk,
                         int k, int* __restrict__ pos_s, uint8_t* __restrict__ new_grp,
                         int2* __restrict__ contrib) {
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
  // The charge rides only rows the entry accounts on (its own node rows).
  int row = crow[p];
  const int* er = e_rows + (int64_t)e * 4;
  bool own = row == er[0] || row == er[1] || row == er[2] || row == er[3];
  contrib[i] = (last && own) ? make_int2(e_acq[e], 1) : make_int2(0, 0);
}

// Phase 3 of the running max, fused with the per-slot decision.
__global__ void fa_decide(LoadSnapshot ld, int nk, int k, int n_rows, int nr,
                          const int2* __restrict__ partial_max, const int2* __restrict__ excl,
                          const int* __restrict__ pos_s, const int* __restrict__ rk_s,
                          const int* __restrict__ gid, const int* __restrict__ crow,
                          const uint8_t* __restrict__ e_valid, const int* __restrict__ e_acq,
                          const int* __restrict__ f_grade, const float* __restrict__ f_count,
                          const int* __restrict__ f_behavior, const int* __restrict__ pass_sums,
                          int pass_stride, const int* __restrict__ threads, float interval_sec,
                          uint8_t* __restrict__ slot_ok) {
  __shared__ int2 warp_tot[NWARPS];
  int base = blockIdx.x * TILE + threadIdx.x * IPT;
  int2 loc[IPT];
  int2 acc = MaxOp::id();
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    int i = base + j;
    loc[j] = i < nk ? ld(i) : MaxOp::id();
    acc = MaxOp::op(acc, loc[j]);
  }
  int2 total;
  int2 run = MaxOp::op(partial_max[blockIdx.x], block_exclusive_scan<MaxOp>(acc, warp_tot, total));
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
    float qps_cur = floorf(__fdiv_rn(__int2float_rn(wrap_add(pass_sums[(int64_t)i * pass_stride], consumed_acq)),
                                     interval_sec));
    float thread_cur = __int2float_rn(wrap_add(threads[rkc], consumed_cnt));
    float cur = f_grade[g] == FLOW_GRADE_QPS ? qps_cur : thread_cur;
    bool ok = __fadd_rn(cur, __int2float_rn(e_acq[e])) <= f_count[g];
    ok = ok || !active || f_behavior[g] != CONTROL_BEHAVIOR_DEFAULT;
    slot_ok[p] = ok ? 1 : 0;
  }
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
  if (dense == nullptr) return;
  bool act = w > 0;
  unsigned am = __ballot_sync(FULL_MASK, act);
  if (!act) return;
  unsigned grp = __match_any_sync(am, row);
  int sum = __reduce_add_sync(grp, w);
  if ((threadIdx.x & 31) == __ffs(grp) - 1) atomicAdd(&dense[row], sum);
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

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }
inline int tiles_for(int n) { return (n + TILE - 1) / TILE; }

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
int flow_admission_topk_blocks(int n_rows) {
  int b = (n_rows + THREADS * 16 - 1) / (THREADS * 16);
  return b < 1 ? 1 : (b > 1024 ? 1024 : b);
}

// Steps 4-8. Scratch: pos_s [nk], new_grp [nk], contrib/excl int2 [nk],
// partial/partial_max int2 [tiles]; dense [n_rows+1] and cand [2 * blocks
// * 8] when topk > 0 (dense is zeroed here). pass_sums holds the windowed
// PASS of each sorted slot's row at stride pass_stride.
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
  int tiles = tiles_for(nk);
  int2* c2 = reinterpret_cast<int2*>(contrib);
  int2* x2 = reinterpret_cast<int2*>(excl);
  int2* p2 = reinterpret_cast<int2*>(partial);
  int2* m2 = reinterpret_cast<int2*>(partial_max);

  fa_flags<<<blocks_for(nk), THREADS, 0, st>>>(rk_s, perm1, perm2, crow, e_rows, e_acq, nk, k,
                                               pos_s, new_grp, c2);
  LoadContrib lc{c2};
  scan_reduce<SumOp, LoadContrib><<<tiles, THREADS, 0, st>>>(lc, nk, p2);
  scan_partials<SumOp><<<1, THREADS, 0, st>>>(p2, tiles);
  scan_apply_sum<<<tiles, THREADS, 0, st>>>(lc, nk, p2, x2);
  LoadSnapshot ls{x2, new_grp};
  scan_reduce<MaxOp, LoadSnapshot><<<tiles, THREADS, 0, st>>>(ls, nk, m2);
  scan_partials<MaxOp><<<1, THREADS, 0, st>>>(m2, tiles);
  fa_decide<<<tiles, THREADS, 0, st>>>(ls, nk, k, n_rows, nr, m2, x2, pos_s, rk_s, gid, crow,
                                       e_valid, e_acq, f_grade, f_count, f_behavior, pass_sums,
                                       pass_stride, threads, interval_sec, slot_ok);
  int* d = nullptr;
  if (topk > 0) {
    cudaError_t err = cudaMemsetAsync(dense, 0, sizeof(int) * ((size_t)n_rows + 1), st);
    if (err != cudaSuccess) return (int)err;
    d = dense;
  }
  fa_verdict<<<blocks_for(n), THREADS, 0, st>>>(slot_ok, n, k, e_valid, e_auth, e_cluster, e_acq,
                                                e_rows, n_rows, flow_pass, admitted, reason, d);
  if (topk > 0) {
    int nb = flow_admission_topk_blocks(n_rows);
    topk_pass1<<<nb, THREADS, 0, st>>>(dense, n_rows, topk, cand_w, cand_r);
    topk_pass2<<<1, THREADS, 0, st>>>(cand_w, cand_r, nb, topk, blk_w, blk_r);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
