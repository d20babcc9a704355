// K5, the borrow commit for Hopper (sm_90a): the port of
// sentinel_tpu/runtime/flush.py:commit_borrow_slab (addWaitingRequest,
// StatisticNode.java:342-345): granted borrows of finally admitted
// prioritized entries go into the future slab future_pass/future_ws
// [R, B], set-if-newer per (row, bucket) cell like the borrow array's
// reset-then-add roll. Per cell: the newest target window among its
// borrows, the wrapping int32 sum of the acquires of the borrows that
// target it, then one write: the same window adds, a newer one sets pass
// and window, an older one writes nothing. Max and wrapping sum do not
// depend on order, so no sort is needed to be exact.
//
// One C call, commit_borrow, per commit (runtime/flush.py), its arguments
// in one CbArgs:
// - n * k <= small_max slots (at most SMALL_CAP): one launch of one block
//   (cb_small). The borrowed slots' (cell, target) keys are compacted and
//   sorted in shared memory (bitonic, with their positions); a block scan
//   gives the wrapping prefix of their acquires and the start of each
//   (cell, target) run; the last slot of each cell's run is its newest
//   target and writes.
// - more slots: three launches over the slots, no sort, no memset. Two
//   R * B arrays in the caller's zeroed scratch: a 64-bit cell
//   (target ^ 2^31) << 32 | 1, and an int32 sum. cb_max: each borrowed
//   slot atomicMax'es its encoded target into its cell (warp-combined).
//   The encoding keeps the signed order of the targets, and its low bit
//   makes every cell a borrow reached nonzero, for any target: a zero
//   cell means "no borrow" without reserving a target value (under the
//   port's ts >= 0 contract a target is some window start after now, but
//   none needs to be excluded). cb_sum: each slot whose target is its
//   cell's newest atomicAdd's its acquire (wrapping). cb_write: per cell,
//   the slot whose atomicExch takes the nonzero cell is its one writer: it
//   applies set-if-newer to the slab and zeroes the sum. Both arrays are
//   all zero when the call ends; a call that fails after the first launch
//   memsets them.
//
// What bounds it: launches and host calls. Per slot it reads the borrow
// flag (1 B), and per borrowed slot the target, row and acquire (12 B);
// per touched cell it reads and writes 8 B of slab. The design is one
// host call, one launch for the batches st.entry sends, three small ones
// at full width; no sort (the parity form took a CUB sort of every slot
// and four more kernels).

#include "bitonic.cuh"

// Everything one call reads and writes; runtime/flush.py fills the same
// layout (_CbArgs: pointers first, then the ints).
struct CbArgs {
  const uint8_t* occ;  // [n, k] the borrowing slots, gated on the final admission
  const int* tgt;      // [n, k] target window starts
  const int* crow;     // [n, k] check rows
  const int* acq;      // [n]
  int* fut_pass;       // [R, nb] the slab, updated in place
  int* fut_ws;
  int n, k, n_rows, nb, wlen, small_max;
};

namespace {

using u64 = unsigned long long;
constexpr int SMALL_CAP = 8192;  // slots cb_small can take (positions fit 16 bits)
constexpr int SMALL_THREADS = 1024;  // cb_small's block

// The slab cell (row * B + bucket) of a borrowed slot: its clamped check
// row, and its target window's bucket.
__device__ __forceinline__ unsigned slab_cell(const CbArgs& a, int p) {
  int row = clampi(a.crow[p], 0, a.n_rows - 1);
  return (unsigned)(row * a.nb + floormod(floordiv(a.tgt[p], a.wlen), a.nb));
}

// A target in unsigned order: the signed order of the int32 targets.
__device__ __forceinline__ unsigned enc(int t) { return (unsigned)t ^ 0x80000000u; }
__device__ __forceinline__ int dec(unsigned u) { return (int)(u ^ 0x80000000u); }

// The cell's one write, set-if-newer: `newest` is its newest target, `sum`
// the wrapping acquire of the borrows that target it, `old_ws`/`old_pass`
// the slab cell as it was.
__device__ __forceinline__ void slab_apply(const CbArgs& a, unsigned cell, int newest, int sum, int old_ws,
                                           int old_pass) {
  if (newest == old_ws) {
    a.fut_pass[cell] = wrap_add(old_pass, sum);
  } else if (newest > old_ws) {
    a.fut_pass[cell] = sum;
    a.fut_ws[cell] = newest;
  }
}

// ---------------------------------------------------------------------------
// one block: n * k <= small_max
// ---------------------------------------------------------------------------

// Dynamic shared memory: p2n keys, p2n ints, p2n positions (p2n: n * k to
// a power of two).
__global__ void __launch_bounds__(SMALL_THREADS) cb_small(CbArgs a, int p2n) {
  constexpr int NT = SMALL_THREADS;
  extern __shared__ u64 cb_key[];
  int* pre = reinterpret_cast<int*>(cb_key + p2n);
  unsigned short* val = reinterpret_cast<unsigned short*>(pre + p2n);
  __shared__ int cnt;
  __shared__ int2 warp_tot[NT / 32];
  const int nk = a.n * a.k;
  if (threadIdx.x == 0) cnt = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < nk; p += NT)
    if (a.occ[p]) {
      int i = atomicAdd(&cnt, 1);
      cb_key[i] = ((u64)slab_cell(a, p) << 32) | enc(a.tgt[p]);
      val[i] = (unsigned short)p;
    }
  __syncthreads();
  const int m = cnt;
  if (m == 0) return;
  int p2 = 1;
  while (p2 < m) p2 <<= 1;
  for (int i = m + threadIdx.x; i < p2; i += NT) {
    cb_key[i] = SENTINEL;
    val[i] = 0xffff;
  }
  __syncthreads();
  bitonic_sort_pairs(cb_key, val, p2);
  // The wrapping prefix of the acquires in sorted order, and the start of
  // each (cell, target) run.
  const int ipt = (m + NT - 1) / NT;
  const int j0 = min((int)threadIdx.x * ipt, m), j1 = min(j0 + ipt, m);
  int local = 0, head_max = -1;
  for (int j = j0; j < j1; ++j) {
    local = wrap_add(local, a.acq[val[j] / a.k]);
    if (j == 0 || cb_key[j - 1] != cb_key[j]) head_max = j;
  }
  int2 total;
  int run = block_exclusive_scan<SumOp, NT>(make_int2(local, 0), warp_tot, total).x;
  int head = block_exclusive_scan<MaxOp, NT>(make_int2(head_max, 0), warp_tot, total).x;
  for (int j = j0; j < j1; ++j) {
    pre[j] = run;
    run = wrap_add(run, a.acq[val[j] / a.k]);
  }
  __syncthreads();
  for (int j = j0; j < j1; ++j) {
    if (j == 0 || cb_key[j - 1] != cb_key[j]) head = j;
    unsigned cell = (unsigned)(cb_key[j] >> 32);
    if (j + 1 < m && (unsigned)(cb_key[j + 1] >> 32) == cell) continue;  // not the cell's newest target
    int incl = wrap_add(pre[j], a.acq[val[j] / a.k]);
    slab_apply(a, cell, dec((unsigned)cb_key[j]), wrap_sub(incl, pre[head]), a.fut_ws[cell], a.fut_pass[cell]);
  }
}

int cb_small_launch(const CbArgs& a, int nk, cudaStream_t st) {
  int p2n = 1;
  while (p2n < nk) p2n <<= 1;
  size_t smem = (sizeof(u64) + sizeof(int) + sizeof(unsigned short)) * (size_t)p2n;
  // A block asks for more than the default 48 KB, which the static arrays
  // share with the dynamic bytes.
  if (smem > 40 * 1024) {
    int err = (int)cudaFuncSetAttribute(cb_small, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  cb_small<<<1, SMALL_THREADS, smem, st>>>(a, p2n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// many blocks: any n * k, the two arrays in the zeroed scratch
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool lane_leads(unsigned grp) { return (threadIdx.x & 31) == __ffs(grp) - 1; }

__global__ void __launch_bounds__(THREADS) cb_max(CbArgs a, u64* __restrict__ cmax) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const bool act = p < a.n * a.k && a.occ[p];
  const unsigned am = __ballot_sync(FULL_MASK, act);
  if (!act) return;
  const unsigned cell = slab_cell(a, p);
  const unsigned grp = __match_any_sync(am, cell);
  const unsigned m = __reduce_max_sync(grp, enc(a.tgt[p]));
  if (lane_leads(grp)) atomicMax(&cmax[cell], ((u64)m << 32) | 1u);
}

__global__ void __launch_bounds__(THREADS) cb_sum(CbArgs a, const u64* __restrict__ cmax, int* __restrict__ csum) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  unsigned cell = 0;
  bool act = false;
  if (p < a.n * a.k && a.occ[p]) {
    cell = slab_cell(a, p);
    act = (unsigned)(cmax[cell] >> 32) == enc(a.tgt[p]);  // only borrows of the newest window count
  }
  const unsigned am = __ballot_sync(FULL_MASK, act);
  if (!act) return;
  const unsigned grp = __match_any_sync(am, cell);
  const unsigned s = __reduce_add_sync(grp, (unsigned)a.acq[p / a.k]);
  if (lane_leads(grp)) atomicAdd(&csum[cell], (int)s);
}

__global__ void __launch_bounds__(THREADS) cb_write(CbArgs a, u64* __restrict__ cmax, int* __restrict__ csum) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const bool act = p < a.n * a.k && a.occ[p];
  const unsigned am = __ballot_sync(FULL_MASK, act);
  if (!act) return;
  const unsigned cell = slab_cell(a, p);
  const unsigned grp = __match_any_sync(am, cell);
  if (!lane_leads(grp)) return;
  // Everything the writer reads is final: loaded beside the election, one
  // round trip.
  const int sum = csum[cell], old_ws = a.fut_ws[cell], old_pass = a.fut_pass[cell];
  const u64 top = atomicExch(&cmax[cell], 0ull);
  if (top == 0) return;  // another slot of the cell took it: that one writes
  csum[cell] = 0;
  slab_apply(a, cell, dec((unsigned)(top >> 32)), sum, old_ws, old_pass);
}

}  // namespace

extern "C" {

// Bytes of the zeroed scratch commit_borrow needs over an [n_rows, nb] slab
// (its many-block route): the 64-bit cells and the int32 sums.
long long commit_borrow_zero_bytes(int n_rows, int nb) { return 12ll * n_rows * nb; }

// One borrow commit (see the header); `args` is read on the host. `zero`:
// commit_borrow_zero_bytes bytes that are zero, used by the many-block
// route and left zero. Returns a CUDA error code, or -1 when that route
// lacks its zeroed bytes (no launch).
int commit_borrow(const CbArgs* args, void* zero, long long zero_bytes, cudaStream_t st) {
  const CbArgs a = *args;
  const long long nk = (long long)a.n * a.k;
  if (nk <= 0) return 0;
  const long long rb = (long long)a.n_rows * a.nb;
  if (nk >= (1 << 28) || a.k <= 0 || a.n_rows <= 0 || a.nb <= 0 || a.wlen <= 0 || rb >= (1ll << 31) || a.small_max < 0 ||
      a.small_max > SMALL_CAP)
    return (int)cudaErrorInvalidValue;
  if (nk <= a.small_max) return cb_small_launch(a, (int)nk, st);
  if (zero == nullptr || zero_bytes < 12 * rb) return -1;
  u64* cmax = (u64*)zero;
  int* csum = (int*)(cmax + rb);
  const int g = blocks_for((int)nk);
  cb_max<<<g, THREADS, 0, st>>>(a, cmax);
  int err = (int)cudaGetLastError();
  if (!err) {
    cb_sum<<<g, THREADS, 0, st>>>(a, cmax, csum);
    err = (int)cudaGetLastError();
  }
  if (!err) {
    cb_write<<<g, THREADS, 0, st>>>(a, cmax, csum);
    err = (int)cudaGetLastError();
  }
  if (err) cudaMemsetAsync(zero, 0, (size_t)(12 * rb), st);
  return err;
}

}  // extern "C"
