// K8, the circuit-breaker entry check for Hopper (sm_90a): the port of
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
// Here no sort is needed. Each candidate does atomicMax of
// ~(key ^ 2^63), key = ts * 2^32 + slot as a signed 64-bit value, into
// its breaker's cell: the largest such word is the smallest key. It is
// never 0 (that would need slot 2^32 - 1), so the cells start at 0 and
// need no reset. A candidate whose word is in the cell after the election
// is the probe; it writes 0 back once it has read it. Another candidate
// that reads after that write sees 0, not its own word, so it is still
// not the probe, and every cell is 0 again when the call ends.
//
// The cells are the first 8 * ND bytes of the caller's zeroed buffer
// (cuda_build.scratch, shared with K4's top-K), one call at a time:
// - n * kd <= small_max slots (at most SMALL_CAP): one launch of one block,
//   the election, a barrier, the verdicts; each slot's fields are read once
//   and kept in registers;
// - more slots: bt_elect, then bt_out (the verdicts and the restore); each
//   reads a slot's fields once.
// A kernel that faults leaves the context unusable, and the buffer with
// it; a bt_out that does not launch after bt_elect did is followed by a
// memset of the cells, so a call that returns an error leaves them zero.
//
// What bounds it: launches, not bytes. Per slot: the gid and the entry's
// ts and live flag (9 B), the breaker's state and retry deadline (8 B,
// cached for a hot breaker), two verdict bytes out; 8 B a touched breaker.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;        // bt_elect, bt_out
constexpr int SMALL_THREADS = 1024;  // bt_small
constexpr int SMALL_CAP = 8192;     // slots the one-block route can take
constexpr int SMALL_IPT = SMALL_CAP / SMALL_THREADS;
constexpr int CLOSED = 0, OPEN = 1;  // rules/degrade_table.py

using u64 = unsigned long long;

struct BtArgs {
  const int* dgid;  // [n * kd] breaker ids, -1 = empty slot
  const int* e_ts;  // [n]
  const uint8_t* e_live;
  const int* state;  // [nd]
  const int* next_retry;
  const uint8_t* allowed;  // [nd] or null
  u64* win;                // [nd] cells, zero on entry and on exit
  uint8_t* ok;             // [n * kd]
  uint8_t* probe;          // [n * kd]
  int nk, kd, nd;
};

struct Slot {
  int g;     // the breaker's cell (clamped as the JAX code clamps)
  u64 word;  // ~(key ^ 2^63): the largest word is the earliest candidate
  bool pass, cand;  // passes without the probe; a probe candidate
};

__device__ __forceinline__ Slot slot_of(const BtArgs& a, int p) {
  const int e = p / a.kd;
  const int g = a.dgid[p];
  Slot s;
  s.g = min(max(g, 0), a.nd - 1);
  s.word = 0;
  s.cand = false;
  s.pass = true;
  if (g >= 0 && a.e_live[e] && a.nd > 0) {
    const int st = a.state[s.g];
    const int ts = a.e_ts[e];
    s.pass = st == CLOSED;
    s.cand = g < a.nd && st == OPEN && ts >= a.next_retry[s.g] && (a.allowed == nullptr || a.allowed[s.g]);
    const long long key = (long long)ts * 4294967296LL + (long long)p;
    s.word = ~((u64)key ^ (1ull << 63));
  }
  return s;
}

__device__ __forceinline__ void elect(const BtArgs& a, const Slot& s) {
  if (s.cand && s.word > __ldcg(a.win + s.g)) atomicMax(a.win + s.g, s.word);
}

// After the election: the verdicts of slot p; the probe zeroes its cell.
__device__ __forceinline__ void verdict(const BtArgs& a, int p, const Slot& s) {
  bool pr = false;
  if (s.cand) {
    pr = __ldcg(a.win + s.g) == s.word;
    if (pr) a.win[s.g] = 0;
  }
  a.ok[p] = (s.pass || pr) ? 1 : 0;
  a.probe[p] = pr ? 1 : 0;
}

__global__ void __launch_bounds__(SMALL_THREADS) bt_small(BtArgs a) {
  Slot s[SMALL_IPT];
#pragma unroll
  for (int q = 0; q < SMALL_IPT; ++q) {
    const int p = threadIdx.x + q * SMALL_THREADS;
    if (p < a.nk) {
      s[q] = slot_of(a, p);
      elect(a, s[q]);
    }
  }
  __syncthreads();  // every atomic of the block is done and visible
#pragma unroll
  for (int q = 0; q < SMALL_IPT; ++q) {
    const int p = threadIdx.x + q * SMALL_THREADS;
    if (p < a.nk) verdict(a, p, s[q]);
  }
}

__global__ void bt_elect(BtArgs a) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < a.nk) elect(a, slot_of(a, p));
}

__global__ void bt_out(BtArgs a) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < a.nk) verdict(a, p, slot_of(a, p));
}

}  // namespace

extern "C" {

// One entry check of n * kd slots. ok and probe are [n * kd]; probe_allowed
// is bool [nd] or null; win points at win_bytes >= 8 * nd bytes that are
// zero, and are zero again when the call returns. Returns a CUDA error code.
int breaker_try_pass(const int* e_dgid, const int* e_ts, const uint8_t* e_live, int n, int kd, int nd,
                     const int* state, const int* next_retry, const uint8_t* probe_allowed, u64* win,
                     long long win_bytes, uint8_t* ok, uint8_t* probe, int small_max, cudaStream_t stream) {
  const int nk = n * kd;
  if (nk <= 0) return 0;
  if (small_max < 0 || small_max > SMALL_CAP || (nd > 0 && (win == nullptr || win_bytes < 8ll * nd)))
    return (int)cudaErrorInvalidValue;
  BtArgs a{e_dgid, e_ts, e_live, state, next_retry, probe_allowed, win, ok, probe, nk, kd, nd};
  if (nk <= small_max) {
    bt_small<<<1, SMALL_THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const int g = (nk + THREADS - 1) / THREADS;
  bt_elect<<<g, THREADS, 0, stream>>>(a);
  int err = (int)cudaGetLastError();
  if (err) return err;
  bt_out<<<g, THREADS, 0, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err && nd > 0) cudaMemsetAsync(win, 0, 8 * (size_t)nd, stream);
  return err;
}

}  // extern "C"
