// K12: the embedded token server's decision pass on the card (replaces the
// jitted `_batch_decide`, sentinel_tpu/cluster/token_service.py:95, and its
// atomic variant `_decide_jit_atomic`, :162-165).
//
// For B token requests (flow row, namespace row or -1, acquire, float32
// thresholds, valid), with the PASS sums of both rows already gathered by
// K3 on the cluster geometry (10 x 100 ms):
//   1. namespace guard: requests keyed by namespace row (the dump group
//      n_rows for invalid or namespace-less ones) in (key, position) order,
//      one packed int64 key per request sorted by CUB (torch.sort); each is
//      charged the acquire of the earlier requests of its group, computed
//      as JAX does: a wrapping int32 cumsum minus a running max of the
//      group-start values (segscan.cuh's three-phase scans);
//      ns_ok = ns_row < 0 || (float)(sum + charge) / interval + acquire <= ns_threshold;
//   2. flow check: keyed by flow row where valid and ns_ok (dump group
//      otherwise), sorted and scanned again;
//      next_remaining = (threshold - (float)(sum + charge) / interval) - acquire;
//      admitted = valid && ns_ok && next_remaining >= 0, and the atomic
//      variant's all(admitted | !valid) folds into one flag;
//   3. the 2B PASS updates (flow rows, then namespace rows; masked unless
//      charged) for K2's window update, which the wrapper runs next.
// Float32 is IEEE round-to-nearest in the JAX order of operations (no
// multiply, so no FMA question); the wrapper never enables fast math.
//
// Bound: bytes. Each request moves a few dozen bytes; the sorts and the
// scans are launch-bound at a token server's batch sizes.

#include "segscan.cuh"

namespace {

constexpr int PASS = 0;  // MetricEvent.PASS
constexpr int NE = 6;    // NUM_EVENTS

__device__ __forceinline__ long long pack_key(int k, int pos) { return (long long)k * 4294967296LL + pos; }

__global__ void td_ns_keys(const int* __restrict__ ns_rows, const uint8_t* __restrict__ valid, int b, int nrows,
                           long long* __restrict__ key, int* __restrict__ all_flag) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) *all_flag = 1;
  if (i >= b) return;
  int k = (valid[i] && ns_rows[i] >= 0) ? ns_rows[i] : nrows;
  key[i] = pack_key(k, i);
}

__global__ void td_contrib(const long long* __restrict__ key_s, int b, const int* __restrict__ acquire,
                           int2* __restrict__ contrib, uint8_t* __restrict__ new_grp) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  long long k = key_s[i];
  contrib[i] = make_int2(acquire[(int)(k & 0xFFFFFFFFLL)], 0);
  new_grp[i] = (i == 0 || (key_s[i - 1] >> 32) != (k >> 32)) ? 1 : 0;
}

// One sorted item per scan slot: its charge = excl - (running max of the
// group-start values), then the stage's decision at its position.
__global__ void td_decide(int stage, const long long* __restrict__ key_s, int b, const int2* __restrict__ excl,
                          const uint8_t* __restrict__ new_grp, const int2* __restrict__ part_max,
                          const int* __restrict__ sums, const int* __restrict__ rows, const int* __restrict__ ns_rows,
                          const int* __restrict__ acquire, const float* __restrict__ thr,
                          const float* __restrict__ ns_thr, const uint8_t* __restrict__ valid, float interval_sec,
                          int nrows, uint8_t* __restrict__ ns_ok, long long* __restrict__ next_key,
                          uint8_t* __restrict__ admitted, float* __restrict__ remaining, int* __restrict__ all_flag) {
  __shared__ int2 warp_tot[NWARPS];
  int2 loc[IPT];
  int2 run = max_scan_prefix(LoadSnapshot{excl, new_grp}, b, part_max, loc, warp_tot);
  int base = blockIdx.x * TILE + threadIdx.x * IPT;
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    run = MaxOp::op(run, loc[j]);
    int i = base + j;
    if (i >= b) continue;
    int charge = wrap_sub(excl[i].x, run.x);
    int pos = (int)(key_s[i] & 0xFFFFFFFFLL);
    float acq = __int2float_rn(acquire[pos]);
    if (stage == 0) {
      float qps = __fdiv_rn(__int2float_rn(wrap_add(sums[(size_t)(b + pos) * NE + PASS], charge)), interval_sec);
      bool ok = ns_rows[pos] < 0 || __fadd_rn(qps, acq) <= ns_thr[pos];
      ns_ok[pos] = ok ? 1 : 0;
      next_key[pos] = pack_key((valid[pos] && ok) ? rows[pos] : nrows, pos);
    } else {
      float latest = __fdiv_rn(__int2float_rn(wrap_add(sums[(size_t)pos * NE + PASS], charge)), interval_sec);
      float rem = __fsub_rn(__fsub_rn(thr[pos], latest), acq);
      bool adm = valid[pos] && ns_ok[pos] && rem >= 0.0f;
      admitted[pos] = adm ? 1 : 0;
      remaining[pos] = rem;
      if (valid[pos] && !adm) atomicAnd(all_flag, 0);
    }
  }
}

__global__ void td_commit(int b, int nrows, int now, int atomic, const int* __restrict__ all_flag,
                          const uint8_t* __restrict__ admitted, const int* __restrict__ rows,
                          const int* __restrict__ ns_rows, const int* __restrict__ acquire, int* __restrict__ upd_rows,
                          int* __restrict__ upd_ts, uint8_t* __restrict__ upd_mask, int* __restrict__ deltas) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  bool charged = admitted[i] && (!atomic || *all_flag);
  int r0 = charged ? rows[i] : nrows;
  int r1 = (charged && ns_rows[i] >= 0) ? ns_rows[i] : nrows;
  int r[2] = {r0, r1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int u = h * b + i;
    upd_mask[u] = r[h] < nrows ? 1 : 0;
    upd_rows[u] = clampi(r[h], 0, nrows - 1);
    upd_ts[u] = now;
#pragma unroll
    for (int e = 0; e < NE; ++e) deltas[(size_t)u * NE + e] = e == PASS ? acquire[i] : 0;
  }
}

}  // namespace

extern "C" {

// Step 1's keys (and the atomic flag's reset).
int token_decide_keys(const int* ns_rows, const uint8_t* valid, int b, int nrows, long long* key, int* all_flag,
                      cudaStream_t stream) {
  td_ns_keys<<<blocks_for(b), THREADS, 0, stream>>>(ns_rows, valid, b, nrows, key, all_flag);
  return (int)cudaGetLastError();
}

// One stage (0: namespace guard, writing ns_ok and the flow keys; 1: flow
// check) over its sorted keys.
int token_decide_stage(int stage, const long long* key_s, int b, const int* acquire, const int* sums,
                       const int* rows, const int* ns_rows, const float* thr, const float* ns_thr,
                       const uint8_t* valid, float interval_sec, int nrows, uint8_t* ns_ok, long long* next_key,
                       uint8_t* admitted, float* remaining, int* all_flag, int2* contrib, uint8_t* new_grp,
                       int2* excl, int2* part_sum, int2* part_max, cudaStream_t stream) {
  int nt = tiles_for(b);
  td_contrib<<<blocks_for(b), THREADS, 0, stream>>>(key_s, b, acquire, contrib, new_grp);
  scan_reduce<SumOp><<<nt, THREADS, 0, stream>>>(LoadContrib{contrib}, b, part_sum);
  scan_partials<SumOp><<<1, THREADS, 0, stream>>>(part_sum, nt);
  scan_apply_sum<<<nt, THREADS, 0, stream>>>(LoadContrib{contrib}, b, part_sum, excl);
  scan_reduce<MaxOp><<<nt, THREADS, 0, stream>>>(LoadSnapshot{excl, new_grp}, b, part_max);
  scan_partials<MaxOp><<<1, THREADS, 0, stream>>>(part_max, nt);
  td_decide<<<nt, THREADS, 0, stream>>>(stage, key_s, b, excl, new_grp, part_max, sums, rows, ns_rows, acquire, thr,
                                        ns_thr, valid, interval_sec, nrows, ns_ok, next_key, admitted, remaining,
                                        all_flag);
  return (int)cudaGetLastError();
}

// Step 3: the 2B masked PASS updates for K2.
int token_decide_commit(int b, int nrows, int now, int atomic, const int* all_flag, const uint8_t* admitted,
                        const int* rows, const int* ns_rows, const int* acquire, int* upd_rows, int* upd_ts,
                        uint8_t* upd_mask, int* deltas, cudaStream_t stream) {
  td_commit<<<blocks_for(b), THREADS, 0, stream>>>(b, nrows, now, atomic, all_flag, admitted, rows, ns_rows, acquire,
                                                   upd_rows, upd_ts, upd_mask, deltas);
  return (int)cudaGetLastError();
}

}  // extern "C"
