// K6, system protection for Hopper (sm_90a): the port of
// sentinel_tpu/runtime/flush.py:system_check (SystemRuleManager.checkSystem,
// SystemRuleManager.java:298-353) against the global inbound row 0.
//
// One C call, system_check, per batch (driven by runtime/flush.py), on
// either route. An entry is checked when it is live and inbound; the QPS
// and thread checks see the acquire and the count of the checked entries
// before it in (ts, position) order.
//
// - n <= small_max entries (the batches st.entry sends; at most SMALL_CAP):
//   one launch of one block. It keys the entries, sorts the keys in
//   dynamic shared memory (bitonic; the acquires beside them, 96 KB at
//   the most), reduces row 0's second window, takes the exclusive block
//   scan of (acquire, 1) over the checked entries and runs the five checks.
// - more entries: sc_prep (keys, values, look-back state), one CUB radix
//   sort of 32-bit keys with (acquire, flag, position) values, so that the
//   scan reads the acquire in sorted order without a gather, then sc_scan:
//   one single-pass kernel, each block a tile, its carry of both sums by
//   decoupled look-back (lookback.cuh), row 0's window reduced in every
//   block (two buckets). Scratch comes from the caller's workspace.
//
// The key is ts ^ 2^31 for a checked entry and 0xFFFFFFFF for the rest. A
// checked entry at ts = INT_MAX ties the unchecked ones; the radix sort is
// stable and the one-block key carries the position, so equal keys keep
// their input order, and an unchecked entry adds zero to both prefixes:
// the order among them changes nothing.
//
// What bounds it: launches and the sort, not bytes. Per entry it reads
// about 10 B (live, the inbound row, ts, acquire) and writes 5 B; the sort
// moves 12 B an entry per pass (4 passes of 8 bits).
//
// Numerics: float32 in the JAX order, with __f*_rn intrinsics and no
// fast-math: (pass + charge) / interval_sec + acquire > qps (no floor,
// unlike the flow check), rt_sum / max(success, 1), BBR
// curThread > (maxSuccessQps * minRt) / 1000; wrapping int32 sums;
// bucket validity now - ws <= interval in wrapping int32. The last
// matching dimension in the order cpu, load, rt, thread, qps wins.

#include <cub/device/device_radix_sort.cuh>

#include "bitonic.cuh"
#include "lookback.cuh"

// Everything one call reads and writes; runtime/flush.py fills the same
// layout (pointers, then the ints, then the floats).
struct ScArgs {
  const uint8_t* live;     // [n] not blocked by an earlier stage
  const int* e_rows;       // [n, 4]; column 3 >= 0 marks an inbound entry
  const int* e_ts;         // [n]
  const int* e_acq;        // [n]
  const int* counts0;      // row 0 of the second window's counts [nb, ne]
  const int* min_rt0;      // [nb]
  const int* ws0;          // [nb]
  const int* threads;      // the thread gauge; row 0 is read
  uint8_t* ok;             // [n]
  int* sys_type;           // [n]
  int n, nb, ne, interval, max_rt, now, small_max;
  float interval_sec, qps, max_thread, max_rt_thr, load_thr, cpu_thr, cur_load, cur_cpu;
};

namespace {

constexpr int EVENT_PASS = 0, EVENT_SUCCESS = 3, EVENT_RT = 4;  // metrics/events.py
constexpr int SYS_NONE = 0, SYS_QPS = 1, SYS_THREAD = 2, SYS_RT = 3, SYS_LOAD = 4, SYS_CPU = 5;
constexpr int SMALL_CAP = 8192;  // entries the one-block route can take
constexpr int SC_IPT = 4;        // entries per thread of sc_scan
constexpr int SC_TILE = THREADS * SC_IPT;
constexpr unsigned UNCHECKED = 0x80000000u;  // flag bit of an item's low word, over the position

// The flush-time snapshot of row 0: the windowed pass, the gauge, and the
// checks that do not depend on the entry.
struct Row0 {
  float pass, threads, bbr_cap;
  bool rt_block, load_on, cpu_block;
};

__device__ Row0 row0(const ScArgs& a) {
  int pass = 0, succ = 0, rt = 0, max_succ = INT_MIN, min_rt = INT_MAX;
  for (int b = 0; b < a.nb; ++b) {
    bool v = wrap_sub(a.now, a.ws0[b]) <= a.interval;
    const int* c = a.counts0 + (int64_t)b * a.ne;
    if (v) {
      pass = wrap_add(pass, c[EVENT_PASS]);
      succ = wrap_add(succ, c[EVENT_SUCCESS]);
      rt = wrap_add(rt, c[EVENT_RT]);
    }
    max_succ = max(max_succ, v ? c[EVENT_SUCCESS] : 0);
    min_rt = min(min_rt, v ? a.min_rt0[b] : a.max_rt);
  }
  Row0 r;
  r.pass = __int2float_rn(pass);
  r.threads = __int2float_rn(a.threads[0]);
  float succ_f = __int2float_rn(succ);
  float avg_rt = succ_f > 0.0f ? __fdiv_rn(__int2float_rn(rt), fmaxf(succ_f, 1.0f)) : 0.0f;
  r.rt_block = avg_rt > a.max_rt_thr;
  r.bbr_cap = __fdiv_rn(__fmul_rn(__fmul_rn(__int2float_rn(max_succ), (float)a.nb), __int2float_rn(min_rt)), 1000.0f);
  r.load_on = a.load_thr >= 0.0f && a.cur_load > a.load_thr;
  r.cpu_block = a.cpu_thr >= 0.0f && a.cur_cpu > a.cpu_thr;
  return r;
}

// The verdict of a checked entry with `acq` whose earlier checked entries
// hold `run` (acquire sum, count).
__device__ __forceinline__ int sys_type_of(const ScArgs& a, const Row0& r, int acq, int2 run) {
  float cur_qps = __fdiv_rn(__fadd_rn(r.pass, __int2float_rn(run.x)), a.interval_sec);
  float cur_thread = __fadd_rn(r.threads, __int2float_rn(run.y));
  int t = SYS_NONE;
  if (r.cpu_block) t = SYS_CPU;
  if (r.load_on && cur_thread > 1.0f && cur_thread > r.bbr_cap) t = SYS_LOAD;
  if (r.rt_block) t = SYS_RT;
  if (cur_thread > a.max_thread) t = SYS_THREAD;
  if (__fadd_rn(cur_qps, __int2float_rn(acq)) > a.qps) t = SYS_QPS;
  return t;
}

__device__ __forceinline__ unsigned entry_key(const ScArgs& a, int i, bool& checked) {
  checked = a.live[i] && a.e_rows[(int64_t)i * 4 + 3] >= 0;
  return checked ? ((unsigned)a.e_ts[i] ^ 0x80000000u) : 0xFFFFFFFFu;
}

// Sorted items of the one-block route: (key << 32 | flag | position) in
// shared memory; the acquire is gathered from its copy in shared memory.
struct SmallItems {
  const unsigned long long* key;
  const int* acq_of;  // by position
  __device__ void get(int j, int& pos, bool& chk, int& acq) const {
    unsigned lo = (unsigned)key[j];
    pos = (int)(lo & ~UNCHECKED);
    chk = !(lo & UNCHECKED);
    acq = chk ? acq_of[pos] : 0;
  }
};

// Sorted values of the many-block route: (acquire << 32 | flag | position).
struct SortedItems {
  const unsigned long long* val;
  __device__ void get(int j, int& pos, bool& chk, int& acq) const {
    unsigned long long v = val[j];
    pos = (int)((unsigned)v & ~UNCHECKED);
    chk = !((unsigned)v & UNCHECKED);
    acq = (int)(v >> 32);
  }
};

// One thread's `cnt` consecutive sorted items from j0 (all threads of the
// block call it): the exclusive (acquire, count) prefix over the checked
// items, with the carry of the tiles before (walks 0 and 1 of a
// LookBack<2>, or none), then each item's verdict at its position.
template <class Items, class Carry>
__device__ void check_items(const ScArgs& a, const Row0& r, const Items& items, int j0, int cnt, Carry& carry) {
  __shared__ int2 warp_tot[NWARPS];
  __shared__ int bcast[2];
  const int end = min(j0 + cnt, a.n);
  int2 local = make_int2(0, 0);
  for (int j = j0; j < end; ++j) {
    int pos, acq;
    bool chk;
    items.get(j, pos, chk, acq);
    if (chk) local = make_int2(wrap_add(local.x, acq), wrap_add(local.y, 1));
  }
  int2 total;
  int2 ex = block_exclusive_scan<SumOp>(local, warp_tot, total);
  const int warp = threadIdx.x >> 5;  // warp ch walks channel ch
  if (warp < 2) {
    int c = carry.sum_in(warp, warp == 0 ? total.x : total.y);
    if ((threadIdx.x & 31) == 0) bcast[warp] = c;
  }
  __syncthreads();
  int2 run = SumOp::op(make_int2(bcast[0], bcast[1]), ex);
  for (int j = j0; j < end; ++j) {
    int pos, acq;
    bool chk;
    items.get(j, pos, chk, acq);
    int t = SYS_NONE;
    if (chk) {
      t = sys_type_of(a, r, acq, run);
      run = make_int2(wrap_add(run.x, acq), wrap_add(run.y, 1));
    }
    a.ok[pos] = t == SYS_NONE ? 1 : 0;
    a.sys_type[pos] = t;
  }
}

// ---------------------------------------------------------------------------
// one block: n <= small_max
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) sc_small(ScArgs a) {
  extern __shared__ unsigned long long key[];  // p2 keys, then the n acquires
  int p2 = 1;
  while (p2 < a.n) p2 <<= 1;
  int* acq = reinterpret_cast<int*>(key + p2);
  for (int i = threadIdx.x; i < p2; i += THREADS) {
    unsigned long long k = SENTINEL;
    if (i < a.n) {
      bool chk;
      unsigned hi = entry_key(a, i, chk);
      k = ((unsigned long long)hi << 32) | (chk ? 0u : UNCHECKED) | (unsigned)i;
      acq[i] = a.e_acq[i];
    }
    key[i] = k;
  }
  __syncthreads();
  bitonic_sort(key, p2);
  Row0 r = row0(a);
  NoCarry none;
  const int ipt = (p2 + THREADS - 1) / THREADS;
  check_items(a, r, SmallItems{key, acq}, threadIdx.x * ipt, ipt, none);
}

// ---------------------------------------------------------------------------
// many blocks: any n
// ---------------------------------------------------------------------------

// The sort keys and values, and the look-back state reset.
__global__ void sc_prep(ScArgs a, unsigned* __restrict__ key, unsigned long long* __restrict__ val,
                        u64* __restrict__ status, int n_status, int* __restrict__ ctl) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_status) status[i] = 0;
  if (i == 0) *ctl = 0;
  if (i < a.n) {
    bool chk;
    key[i] = entry_key(a, i, chk);
    val[i] = chk ? ((unsigned long long)(unsigned)a.e_acq[i] << 32) | (unsigned)i : (UNCHECKED | (unsigned)i);
  }
}

// Single pass over the sorted entries: each block takes the next tile and
// checks it with the carries of the tiles before it.
__global__ void __launch_bounds__(THREADS) sc_scan(ScArgs a, const unsigned long long* __restrict__ val, u64* status,
                                                   int nt, int* ctl) {
  __shared__ int s_tile;
  if (threadIdx.x == 0) s_tile = atomicAdd(ctl, 1);
  __syncthreads();
  const int tile = s_tile;
  Row0 r = row0(a);
  LookBack<2> carry{status, nt, tile, 0};
  check_items(a, r, SortedItems{val}, tile * SC_TILE + threadIdx.x * SC_IPT, SC_IPT, carry);
}

// Workspace of the many-block route: keys and values in and out, two
// look-back walks, the tile counter, CUB's temp storage.
struct Layout {
  size_t key_in, key_out, val_in, val_out, status, ctl, temp, total;
  int nt, n_status;
};

Layout layout(int n) {
  Layout l;
  l.nt = (n + SC_TILE - 1) / SC_TILE;
  l.n_status = 2 * l.nt;
  size_t temp = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, temp, (const unsigned*)nullptr, (unsigned*)nullptr,
                                  (const unsigned long long*)nullptr, (unsigned long long*)nullptr, n, 0, 32);
  size_t k4 = align256(sizeof(unsigned) * (size_t)n), v8 = align256(sizeof(unsigned long long) * (size_t)n);
  l.key_in = 0;
  l.key_out = l.key_in + k4;
  l.val_in = l.key_out + k4;
  l.val_out = l.val_in + v8;
  l.status = l.val_out + v8;
  l.ctl = l.status + align256(sizeof(u64) * (size_t)l.n_status);
  l.temp = l.ctl + 256;
  l.total = l.temp + align256(temp);
  return l;
}

}  // namespace

extern "C" {

// Bytes of workspace system_check needs for n entries (0 for the one-block
// route).
long long system_check_workspace(int n, int small_max) {
  return n <= small_max ? 0 : (long long)layout(n).total;
}

// One system check (see the header). `args` is read on the host. Returns a
// CUDA error code, or -1 when the workspace is smaller than
// system_check_workspace(n, small_max).
int system_check(const ScArgs* args, void* workspace, long long workspace_bytes, cudaStream_t stream) {
  const ScArgs a = *args;
  if (a.n <= 0) return 0;
  if (a.nb <= 0 || a.ne <= EVENT_RT || a.small_max < 0 || a.small_max > SMALL_CAP)
    return (int)cudaErrorInvalidValue;
  if (a.n <= a.small_max) {
    int p2 = 1;
    while (p2 < a.n) p2 <<= 1;
    size_t smem = sizeof(unsigned long long) * (size_t)p2 + sizeof(int) * (size_t)a.n;
    // A block asks for more than the default 48 KB, which the scans'
    // static arrays share with the dynamic bytes.
    if (smem > 40 * 1024) {
      int err = (int)cudaFuncSetAttribute(sc_small, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err) return err;
    }
    sc_small<<<1, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  Layout l = layout(a.n);
  if (workspace_bytes < (long long)l.total) return -1;
  char* ws = (char*)workspace;
  unsigned* key_in = (unsigned*)(ws + l.key_in);
  unsigned* key_out = (unsigned*)(ws + l.key_out);
  unsigned long long* val_in = (unsigned long long*)(ws + l.val_in);
  unsigned long long* val_out = (unsigned long long*)(ws + l.val_out);
  u64* status = (u64*)(ws + l.status);
  int* ctl = (int*)(ws + l.ctl);
  size_t temp_bytes = l.total - l.temp;
  sc_prep<<<blocks_for(max(a.n, l.n_status)), THREADS, 0, stream>>>(a, key_in, val_in, status, l.n_status, ctl);
  int err = (int)cub::DeviceRadixSort::SortPairs(ws + l.temp, temp_bytes, key_in, key_out, val_in, val_out, a.n, 0,
                                                 32, stream);
  if (err) return err;
  sc_scan<<<l.nt, THREADS, 0, stream>>>(a, val_out, status, l.nt, ctl);
  return (int)cudaGetLastError();
}

}  // extern "C"
