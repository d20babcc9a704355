// Circuit-breaker entry check for Hopper (sm_90a): the port of
// sentinel_tpu/rules/degrade_table.py:breaker_try_pass (tryPass and the
// OPEN -> HALF_OPEN probe election of AbstractCircuitBreaker.java:91-110),
// with the sharded step's probe_allowed mask (degrade_table.py:291-298).
//
// A slot passes when its breaker is CLOSED, when it is the one probe of an
// OPEN breaker whose retry time has come, or when the slot is empty or its
// entry is not live. probe_allowed (bool [ND], may be null) restricts probe
// candidacy to the breakers this shard won in the mesh's probe election
// (parallel/ici.py). The probe is the earliest candidate by (ts, slot):
// the JAX code sorts the candidates by (gid, ts, pos) and takes rank 0.
// Here no sort is needed:
//   1. bt_reset   each candidate writes INT64_MAX into its breaker's
//                 winner cell (only touched breakers are written, so the
//                 [ND] scratch is never cleared as a whole)
//   2. bt_elect   each candidate does atomicMin of its 64-bit key
//                 ts * 2^32 + slot into the cell; keys are distinct
//   3. bt_out     a candidate whose key equals the cell's is the probe;
//                 the verdicts are written per slot
// The HALF_OPEN transition itself waits for the entry's final admission
// (flow_admission.cu fa_chain).
//
// What bounds it: bytes. Per slot: the gid and the entry's ts and live
// flag (9 B), the breaker's state and retry deadline (8 B, cached for a
// hot breaker), two verdict bytes out; one 8 B cell per touched breaker.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CLOSED = 0, OPEN = 1;  // rules/degrade_table.py

struct Slot {
  int g;
  long long key;
  bool valid, cand;
};

__device__ __forceinline__ Slot slot_of(int p, const int* __restrict__ dgid, const int* __restrict__ e_ts,
                                        const uint8_t* __restrict__ e_live, int kd, int nd,
                                        const int* __restrict__ state, const int* __restrict__ next_retry,
                                        const uint8_t* __restrict__ allowed) {
  int e = p / kd;
  Slot s;
  s.g = dgid[p];
  s.valid = s.g >= 0 && s.g < nd && e_live[e];
  int ts = e_ts[e];
  s.cand = s.valid && state[s.g] == OPEN && ts >= next_retry[s.g] && (allowed == nullptr || allowed[s.g]);
  s.key = (long long)ts * 4294967296LL + (long long)p;
  return s;
}

__global__ void bt_reset(const int* __restrict__ dgid, const int* __restrict__ e_ts,
                         const uint8_t* __restrict__ e_live, int nk, int kd, int nd,
                         const int* __restrict__ state, const int* __restrict__ next_retry,
                         const uint8_t* __restrict__ allowed, long long* __restrict__ win) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= nk) return;
  Slot s = slot_of(p, dgid, e_ts, e_live, kd, nd, state, next_retry, allowed);
  if (s.cand) win[s.g] = LLONG_MAX;
}

__global__ void bt_elect(const int* __restrict__ dgid, const int* __restrict__ e_ts,
                         const uint8_t* __restrict__ e_live, int nk, int kd, int nd,
                         const int* __restrict__ state, const int* __restrict__ next_retry,
                         const uint8_t* __restrict__ allowed, long long* __restrict__ win) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= nk) return;
  Slot s = slot_of(p, dgid, e_ts, e_live, kd, nd, state, next_retry, allowed);
  if (s.cand && s.key < win[s.g]) atomicMin(&win[s.g], s.key);
}

__global__ void bt_out(const int* __restrict__ dgid, const int* __restrict__ e_ts,
                       const uint8_t* __restrict__ e_live, int nk, int kd, int nd,
                       const int* __restrict__ state, const int* __restrict__ next_retry,
                       const uint8_t* __restrict__ allowed, const long long* __restrict__ win,
                       uint8_t* __restrict__ ok, uint8_t* __restrict__ probe) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= nk) return;
  Slot s = slot_of(p, dgid, e_ts, e_live, kd, nd, state, next_retry, allowed);
  bool pr = s.cand && win[s.g] == s.key;
  ok[p] = (!s.valid || state[s.g] == CLOSED || pr) ? 1 : 0;
  probe[p] = pr ? 1 : 0;
}

}  // namespace

extern "C" {

// The three launches. win is [nd] int64 scratch; ok/probe are [n * kd];
// probe_allowed is bool [nd] or null.
int breaker_try_pass(const int* e_dgid, const int* e_ts, const uint8_t* e_live, int n, int kd, int nd,
                     const int* state, const int* next_retry, const uint8_t* probe_allowed, long long* win,
                     uint8_t* ok, uint8_t* probe, void* stream) {
  int nk = n * kd;
  if (nk <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int g = (nk + THREADS - 1) / THREADS;
  bt_reset<<<g, THREADS, 0, st>>>(e_dgid, e_ts, e_live, nk, kd, nd, state, next_retry, probe_allowed, win);
  bt_elect<<<g, THREADS, 0, st>>>(e_dgid, e_ts, e_live, nk, kd, nd, state, next_retry, probe_allowed, win);
  bt_out<<<g, THREADS, 0, st>>>(e_dgid, e_ts, e_live, nk, kd, nd, state, next_retry, probe_allowed, win, ok,
                                probe);
  return (int)cudaGetLastError();
}

}  // extern "C"
