// K7, the circuit-breaker completions for Hopper (sm_90a): the port of
// sentinel_tpu/rules/degrade_table.py:breaker_on_exits with trip_condition
// (:151) and _segment_cum (:177) (onRequestComplete of the reference's
// breakers, AbstractCircuitBreaker.java, ExceptionCircuitBreaker.java,
// ResponseTimeCircuitBreaker.java).
//
// Per breaker, over its valid exit slots in (gid, ts, slot) order: the
// window rolls to the newest aligned ts; the in-window (total, bad) count
// up exit by exit from the window's base; a CLOSED breaker opens at the
// first exit whose running counts cross the threshold; a HALF_OPEN one is
// decided by its first exit, in window or not. The order among equal
// (gid, ts) exits is part of the result: it decides where a ratio crosses
// and which exit is the probe. (gid, ts, slot) does not fit 64 bits at
// ND = 2^20, so the sorts below order (key, slot) pairs.
//
// Within a breaker's sorted exits the aligned window start does not
// decrease, so the window's new start is that of the breaker's last exit
// (or the old one, if newer), and the in-window exits are a suffix. Each
// (gid, window) run is scanned as a segment of its own, from the base its
// window would have (the old counts if it is the old window, zero if it
// is newer, nothing if it is older); only the last run's counts and
// crossings count, which the breaker's last exit resolves.
//
// One C call, breaker_on_exits, per batch (rules/degrade_table.py), its
// arguments in one BoArgs; the state is updated in place.
// - m * kd <= small_max slots (at most SMALL_CAP): one launch of one block
//   of 1,024 threads (bo_small, instantiated for 1, 2, 4 or 8 slots a
//   thread). The slots' (key, slot) pairs are sorted in shared memory
//   (bitonic), a block scan gives each run's counts, every exit decides, a
//   barrier, and each breaker's last exit writes.
// - more slots: bo_prep (keys, values with the exit's bad flag over its
//   slot, the look-back state), one CUB SortPairs (a radix sort is stable:
//   equal keys keep slot order; end_bit 32 + bits of ND), bo_scan and
//   bo_resolve. bo_scan is one single-pass kernel: each block a tile, the
//   runs' counts carried in by decoupled look-back (lookback.cuh, the
//   JAX segmented prefix as cumsum minus running max), the trip predicate
//   and the crossing posted in the same pass; a run's last exit records
//   its counts. Fused, against the parity form's eleven launches: the
//   window roll into the scan (no per-breaker maximum pass and no search
//   for a segment's head), both channels' sums and running maxima into
//   one look-back pass, the trip predicate and the crossing into that
//   pass, the bad flag into prep (it rides the sort's values, so the scan
//   reads no exit column). Not fused: bo_resolve needs every crossing of
//   a breaker posted, and so a launch boundary, since a later tile's
//   look-back can pass a tile that has not posted yet.
// Both routes post into two 64-bit cells per breaker in the caller's
// zeroed scratch (16 * ND bytes), which each breaker's last exit reads
// and zeroes: the crossing cell takes atomicMax of (window ^ 2^31) << 32
// | ~(ts ^ 2^31), so it holds the newest window with a crossing and its
// first crossing ts (never zero); the probe cell the HALF_OPEN breaker's
// first exit. A hot breaker's crossings are combined across the warp
// first (__match_any_sync + __reduce_*_sync): one atomic per warp.
//
// What bounds it: launches, the sort and round trips, not bytes. Per slot
// it reads gid, ts, RT, error and the valid flag (17 B) and per touched
// breaker its table and state (48 B), writing 20 B; the sort moves 12 B a
// slot a pass (7 passes of 8 bits at ND = 2^20).
//
// Numerics: the ratio and the min-request compare are float32 as in JAX
// (min_request 2^31 - 1 rounds to 2^31); totals wrap in int32; ts +
// retry_ms wraps in uint32, as JAX's int32 addition wraps; the HALF_OPEN
// retry starts at max(0, ts). Slots with gid < 0 or >= ND, or an invalid
// exit, are skipped.

#include <cub/device/device_radix_sort.cuh>

#include "bitonic.cuh"
#include "breaker_trip.cuh"
#include "lookback.cuh"

// Everything one call reads and writes; rules/degrade_table.py fills the
// same layout (_BoArgs: pointers first, then the ints).
struct BoArgs {
  const int* x_dgid;       // [m, kd] breaker per exit slot (-1 empty)
  const int* x_ts;         // [m]
  const int* x_rt;         // [m]
  const int* x_err;        // [m]
  const uint8_t* x_valid;  // [m]
  const int* grade;        // the table [nd]
  const float* threshold;
  const float* slow_ratio;
  const int* min_request;
  const int* interval_ms;
  const int* retry_ms;
  const int* max_rt;
  int* state;  // the state [nd], updated in place
  int* next_retry;
  int* bad;
  int* total;
  int* ws;
  int m, kd, nd, small_max;
};

namespace {

constexpr int CLOSED = 0, OPEN = 1, HALF_OPEN = 2;  // rules/degrade_table.py
constexpr int GRADE_RT = 0;                         // models/constants.py
constexpr int SMALL_CAP = 8192;                     // slots bo_small can take (slots fit 16 bits)
constexpr int SMALL_THREADS = 1024;                 // bo_small's block
constexpr unsigned BIAS = 0x80000000u;     // int32 -> unsigned in signed order
constexpr unsigned BAD_BIT = 0x80000000u;  // over the slot in a sort value

__device__ __forceinline__ int key_gid(u64 key) { return (int)(key >> 32); }
__device__ __forceinline__ int key_ts(u64 key) { return (int)((unsigned)key ^ BIAS); }

// ts aligned to the breaker's window: ts - ts % interval (floor modulo).
__device__ __forceinline__ int aligned_ts(int ts, int iv) {
  return (int)((unsigned)ts - (unsigned)floormod(ts, max(iv, 1)));
}

__device__ __forceinline__ bool slot_bad(const BoArgs& a, int g, int p) {
  const int e = p / a.kd;
  return a.grade[g] == GRADE_RT ? a.x_rt[e] > a.max_rt[g] : a.x_err[e] > 0;
}

// The sort key of slot p: (gid << 32) | (ts ^ 2^31) when valid, else
// ND << 32, after every valid key.
__device__ __forceinline__ u64 slot_key(const BoArgs& a, int p, bool& valid) {
  const int g = a.x_dgid[p];
  const int e = p / a.kd;
  valid = g >= 0 && g < a.nd && a.x_valid[e];
  return valid ? ((u64)(unsigned)g << 32) | ((unsigned)a.x_ts[e] ^ BIAS) : (u64)(unsigned)a.nd << 32;
}

// One sorted exit: its breaker (ND for none), ts, aligned window start and
// bad flag, where it stands in its breaker's exits (head, end) and in its
// (breaker, window) run (sub), and what the run counts from it.
struct Exit {
  int g, ts, al;
  bool bad, valid, head, end, sub;
  int2 acq;  // (1, bad) when its window is not older than the breaker's, else (0, 0)
};

__device__ Exit sorted_exit(const BoArgs& a, const u64* key, int j, int n, bool bad) {
  Exit x;
  const u64 k = key[j];
  x.g = key_gid(k);
  x.ts = key_ts(k);
  x.valid = x.g < a.nd;
  x.bad = bad;
  x.acq = make_int2(0, 0);
  x.head = x.end = false;
  x.sub = j == 0;  // the first item always starts a run
  x.al = 0;
  if (!x.valid) return x;
  const int iv = a.interval_ms[x.g];
  x.al = aligned_ts(x.ts, iv);
  x.head = j == 0 || key_gid(key[j - 1]) != x.g;
  x.sub = x.head || aligned_ts(key_ts(key[j - 1]), iv) != x.al;
  x.end = j + 1 == n || key_gid(key[j + 1]) != x.g;
  if (x.al >= a.ws[x.g]) x.acq = make_int2(1, bad ? 1 : 0);
  return x;
}

// Does the exit cross, with `charge` its run's counts before it? Only a
// CLOSED breaker's exits in a window not older than its own do.
__device__ bool crosses(const BoArgs& a, const Exit& x, int2 charge) {
  if (!x.acq.x || a.state[x.g] != CLOSED) return false;
  const bool same = x.al == a.ws[x.g];  // the old window: its counts are the base
  const float run_tot = __int2float_rn(wrap_add(same ? a.total[x.g] : 0, wrap_add(charge.x, x.acq.x)));
  const float run_bad = __int2float_rn(wrap_add(same ? a.bad[x.g] : 0, wrap_add(charge.y, x.acq.y)));
  return run_tot >= __int2float_rn(a.min_request[x.g]) &&
         trip_condition(a.grade[x.g], a.threshold[x.g], a.slow_ratio[x.g], run_bad, run_tot);
}

// Posts the warp's crossings (one atomic per breaker) and its HALF_OPEN
// breakers' first exits. All lanes of the warp call it.
__device__ void post(const BoArgs& a, u64* cells, const Exit& x, bool cross) {
  const unsigned m = __ballot_sync(FULL_MASK, cross);
  if (cross) {
    const unsigned grp = __match_any_sync(m, x.g);
    const unsigned al = (unsigned)x.al ^ BIAS;
    const unsigned top = __reduce_max_sync(grp, al);
    const unsigned newest = __ballot_sync(grp, al == top);
    if (al == top) {
      const unsigned first = __reduce_min_sync(newest, (unsigned)x.ts ^ BIAS);
      if ((threadIdx.x & 31) == __ffs(newest) - 1) atomicMax(&cells[2 * (size_t)x.g], ((u64)top << 32) | ~first);
    }
  }
  if (x.valid && x.head && a.state[x.g] == HALF_OPEN)
    cells[2 * (size_t)x.g + 1] = (1ull << 63) | ((u64)x.bad << 32) | (unsigned)x.ts;
}

// The breaker's write, by its last exit: `al` its window start, `incl`
// the counts of its last run up to it; the cells are read and zeroed.
__device__ void resolve(const BoArgs& a, u64* cells, int g, int al, int2 incl) {
  const int ws_old = a.ws[g];
  const int ws_new = max(ws_old, al);
  const bool rolled = ws_new > ws_old;
  int total = wrap_add(rolled ? 0 : a.total[g], incl.x);
  int bad = wrap_add(rolled ? 0 : a.bad[g], incl.y);
  int st = a.state[g];
  int next_retry = a.next_retry[g];
  const unsigned retry = (unsigned)a.retry_ms[g];
  if (st == CLOSED) {
    const u64 c = atomicExch(&cells[2 * (size_t)g], 0ull);
    if (c && (int)((unsigned)(c >> 32) ^ BIAS) == al) {  // a crossing in the last window
      st = OPEN;
      next_retry = (int)((~(unsigned)c ^ BIAS) + retry);
    }
  } else if (st == HALF_OPEN) {
    const u64 c = atomicExch(&cells[2 * (size_t)g + 1], 0ull);
    if ((c >> 32) & 1) {
      st = OPEN;
      next_retry = (int)((unsigned)max(0, (int)(unsigned)c) + retry);
    } else {
      st = CLOSED;  // fromHalfOpenToClose resets the bucket
      total = 0;
      bad = 0;
    }
  }
  a.ws[g] = ws_new;
  a.total[g] = total;
  a.bad[g] = bad;
  a.state[g] = st;
  a.next_retry[g] = next_retry;
}

// ---------------------------------------------------------------------------
// one block: m * kd <= small_max
// ---------------------------------------------------------------------------

// Dynamic shared memory: p2 keys, then p2 slots (p2: m * kd to a power of
// two, at most SIPT * 1,024: each thread's exits stay in registers).
template <int SIPT>
__global__ void __launch_bounds__(SMALL_THREADS) bo_small(BoArgs a, int p2, u64* cells) {
  constexpr int NT = SMALL_THREADS;
  extern __shared__ u64 bo_key[];
  unsigned short* slot = reinterpret_cast<unsigned short*>(bo_key + p2);
  const int mk = a.m * a.kd;
  for (int i = threadIdx.x; i < p2; i += NT) {
    bool v;
    bo_key[i] = i < mk ? slot_key(a, i, v) : SENTINEL;
    slot[i] = (unsigned short)i;
  }
  __syncthreads();
  bitonic_sort_pairs(bo_key, slot, p2);
  const int ipt = (p2 + NT - 1) / NT;
  const int j0 = threadIdx.x * ipt;
  const int cnt = max(0, min(ipt, mk - j0));
  Exit x[SIPT];
  int2 acq[SIPT], charge[SIPT];
  bool sub[SIPT];
#pragma unroll
  for (int k = 0; k < SIPT; ++k) {
    acq[k] = make_int2(0, 0);
    sub[k] = false;
    x[k].valid = false;
    if (k < cnt) {
      const int j = j0 + k;
      const int g = key_gid(bo_key[j]);
      x[k] = sorted_exit(a, bo_key, j, mk, g < a.nd && slot_bad(a, g, slot[j]));
      acq[k] = x[k].acq;
      sub[k] = x[k].sub;
    }
  }
  NoCarry none;
  charges<SIPT, 2, NoCarry, NT>(cnt, acq, sub, charge, none);
#pragma unroll
  for (int k = 0; k < SIPT; ++k) post(a, cells, x[k], k < cnt && crosses(a, x[k], charge[k]));
  __syncthreads();  // every read of the state and every post before a write
#pragma unroll
  for (int k = 0; k < SIPT; ++k)
    if (k < cnt && x[k].valid && x[k].end)
      resolve(a, cells, x[k].g, x[k].al, make_int2(wrap_add(charge[k].x, acq[k].x), wrap_add(charge[k].y, acq[k].y)));
}

// ---------------------------------------------------------------------------
// many blocks: any m * kd
// ---------------------------------------------------------------------------

// The sort keys, the values (slot | bad flag) and the look-back state.
__global__ void bo_prep(BoArgs a, u64* __restrict__ key, unsigned* __restrict__ val, u64* __restrict__ status,
                        int n_status, int* __restrict__ ctl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_status) status[i] = 0;
  if (i == 0) *ctl = 0;
  if (i < a.m * a.kd) {
    bool v;
    key[i] = slot_key(a, i, v);
    val[i] = (unsigned)i | (v && slot_bad(a, a.x_dgid[i], i) ? BAD_BIT : 0u);
  }
}

// Single pass over the sorted exits: each block takes the next tile, its
// runs' carries by look-back; the crossings and probes are posted and each
// breaker's last exit records its last run's counts in `rec`.
__global__ void __launch_bounds__(THREADS) bo_scan(BoArgs a, const u64* __restrict__ key, const unsigned* __restrict__ val,
                                                   u64* status, int nt, int* ctl, u64* cells, int2* __restrict__ rec) {
  __shared__ int s_tile;
  if (threadIdx.x == 0) s_tile = atomicAdd(ctl, 1);
  __syncthreads();
  const int tile = s_tile;
  const int n = a.m * a.kd;
  const int j0 = tile * TILE + threadIdx.x * IPT;
  const int cnt = max(0, min(IPT, n - j0));
  Exit x[IPT];
  int2 acq[IPT], charge[IPT];
  bool sub[IPT];
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    acq[k] = make_int2(0, 0);
    sub[k] = false;
    x[k].valid = false;
    if (k < cnt) {
      x[k] = sorted_exit(a, key, j0 + k, n, (val[j0 + k] & BAD_BIT) != 0);
      acq[k] = x[k].acq;
      sub[k] = x[k].sub;
    }
  }
  LookBack<2> carry{status, nt, tile, 0};
  charges<IPT, 2>(cnt, acq, sub, charge, carry);
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    post(a, cells, x[k], k < cnt && crosses(a, x[k], charge[k]));
    if (k < cnt && x[k].valid && x[k].end)
      rec[j0 + k] = make_int2(wrap_add(charge[k].x, acq[k].x), wrap_add(charge[k].y, acq[k].y));
  }
}

// Each breaker's last sorted exit writes it.
__global__ void bo_resolve(BoArgs a, const u64* __restrict__ key, const int2* __restrict__ rec, u64* cells) {
  const int n = a.m * a.kd;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int g = key_gid(key[j]);
  if (g >= a.nd || (j + 1 < n && key_gid(key[j + 1]) == g)) return;
  resolve(a, cells, g, aligned_ts(key_ts(key[j]), a.interval_ms[g]), rec[j]);
}

// Workspace of the many-block route: keys and values in and out, the
// runs' counts, four look-back walks (two sums, two running maxima), the
// tile counter, CUB's temp storage.
struct Layout {
  size_t key_in, key_out, val_in, val_out, rec, status, ctl, temp, total;
  int nt, n_status, end_bit;
};

Layout layout(int n, int nd) {
  Layout l;
  l.nt = (n + TILE - 1) / TILE;
  l.n_status = 4 * l.nt;
  l.end_bit = 32 + bits_for(nd);
  size_t temp = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, temp, (const u64*)nullptr, (u64*)nullptr, (const unsigned*)nullptr,
                                  (unsigned*)nullptr, n, 0, l.end_bit);
  const size_t k8 = align256(sizeof(u64) * (size_t)n), v4 = align256(sizeof(unsigned) * (size_t)n);
  l.key_in = 0;
  l.key_out = l.key_in + k8;
  l.val_in = l.key_out + k8;
  l.val_out = l.val_in + v4;
  l.rec = l.val_out + v4;
  l.status = l.rec + k8;
  l.ctl = l.status + align256(sizeof(u64) * (size_t)l.n_status);
  l.temp = l.ctl + 256;
  l.total = l.temp + align256(temp);
  return l;
}

template <int SIPT>
int small_launch(const BoArgs& a, int p2, u64* cells, cudaStream_t stream) {
  const size_t smem = (sizeof(u64) + sizeof(unsigned short)) * (size_t)p2;
  const int most = (int)((sizeof(u64) + sizeof(unsigned short)) * SIPT * SMALL_THREADS);
  const int err = dyn_smem_once<bo_small<SIPT>>(smem, most);
  if (err) return err;
  bo_small<SIPT><<<1, SMALL_THREADS, smem, stream>>>(a, p2, cells);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of workspace breaker_on_exits needs for m * kd slots over nd
// breakers (0 for the one-block route). Both routes take 16 * nd bytes of
// the zeroed scratch.
long long breaker_on_exits_workspace(int mk, int nd, int small_max) {
  return mk <= small_max ? 0 : (long long)layout(mk, nd).total;
}

// One batch of completions (see the header); `args` is read on the host.
// Returns a CUDA error code, or -1 when the workspace or the zeroed bytes
// are short (no launch).
int breaker_on_exits(const BoArgs* args, void* workspace, long long workspace_bytes, void* zero,
                     long long zero_bytes, cudaStream_t stream) {
  const BoArgs a = *args;
  const long long mk = (long long)a.m * a.kd;
  if (mk <= 0) return 0;
  if (mk >= (1 << 28) || a.kd <= 0 || a.nd <= 0 || a.nd >= INT_MAX || a.small_max < 0 || a.small_max > SMALL_CAP)
    return (int)cudaErrorInvalidValue;
  if (zero == nullptr || zero_bytes < 16ll * a.nd) return -1;
  u64* cells = (u64*)zero;
  if (mk <= a.small_max) {
    int p2 = 1;
    while (p2 < mk) p2 <<= 1;
    if (p2 <= SMALL_THREADS) return small_launch<1>(a, p2, cells, stream);
    if (p2 <= 2 * SMALL_THREADS) return small_launch<2>(a, p2, cells, stream);
    if (p2 <= 4 * SMALL_THREADS) return small_launch<4>(a, p2, cells, stream);
    return small_launch<SMALL_CAP / SMALL_THREADS>(a, p2, cells, stream);
  }
  const int n = (int)mk;
  const Layout l = layout(n, a.nd);
  if (workspace == nullptr || workspace_bytes < (long long)l.total) return -1;
  char* ws = (char*)workspace;
  u64* key_in = (u64*)(ws + l.key_in);
  u64* key_out = (u64*)(ws + l.key_out);
  unsigned* val_in = (unsigned*)(ws + l.val_in);
  unsigned* val_out = (unsigned*)(ws + l.val_out);
  int2* rec = (int2*)(ws + l.rec);
  u64* status = (u64*)(ws + l.status);
  int* ctl = (int*)(ws + l.ctl);
  size_t temp_bytes = l.total - l.temp;
  bo_prep<<<blocks_for(max(n, l.n_status)), THREADS, 0, stream>>>(a, key_in, val_in, status, l.n_status, ctl);
  int err = (int)cudaGetLastError();
  if (!err)
    err = (int)cub::DeviceRadixSort::SortPairs(ws + l.temp, temp_bytes, key_in, key_out, val_in, val_out, n, 0,
                                               l.end_bit, stream);
  if (err) return err;
  bo_scan<<<l.nt, THREADS, 0, stream>>>(a, key_out, val_out, status, l.nt, ctl, cells, rec);
  err = (int)cudaGetLastError();
  if (!err) {
    bo_resolve<<<blocks_for(n), THREADS, 0, stream>>>(a, key_out, rec, cells);
    err = (int)cudaGetLastError();
  }
  if (err) cudaMemsetAsync(zero, 0, (size_t)(16ll * a.nd), stream);  // bo_scan may have posted
  return err;
}

}  // extern "C"
