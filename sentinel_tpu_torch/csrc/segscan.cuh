// Shared device code of the port's kernels: wrapping int32 arithmetic,
// the three-phase block scan over int2 pairs (block totals, one block
// scanning the totals, block scan plus carry), segment-head search and
// floor division, and the dynamic shared memory limit. Included through
// lookback.cuh and bitonic.cuh by K4-K7, K9-K12 and K15-K16 (mesh_budget.cu:
// K16 takes the three-phase scans); each source builds into its own
// library, so everything here is local to the including file.
//
// The segmented prefixes of the JAX package are computed there as a
// wrapping int32 cumsum minus a running max of group-start values; this
// header gives both plain scans. Wrapping addition and max are
// associative, so the results equal the JAX cumsum/cummax bit for bit
// whatever the evaluation order.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int IPT = 4;               // items per thread in the scans
constexpr int TILE = THREADS * IPT;  // items per scan block

__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wrap_sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// Floor division and modulo (Python's and JAX's // and % on integers).
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int floormod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

struct SumOp {
  __device__ static int2 id() { return make_int2(0, 0); }
  __device__ static int2 op(int2 a, int2 b) { return make_int2(wrap_add(a.x, b.x), wrap_add(a.y, b.y)); }
};

struct MaxOp {
  __device__ static int2 id() { return make_int2(INT_MIN, INT_MIN); }
  __device__ static int2 op(int2 a, int2 b) { return make_int2(max(a.x, b.x), max(a.y, b.y)); }
};

// Contributions at their sorted positions.
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

// Exclusive scan of one value per thread over a block of NT threads (at
// most 1,024; `warp_tot` holds NT / 32); `total` gets the block's
// reduction. All threads of the block must call it.
template <class Op, int NT = THREADS>
__device__ int2 block_exclusive_scan(int2 v, int2* warp_tot, int2& total) {
  constexpr int NW = NT / 32;
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
    int2 w = lane < NW ? warp_tot[lane] : Op::id();
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int2 y = shfl_up2(w, off);
      if (lane >= off) w = Op::op(y, w);
    }
    if (lane < NW) warp_tot[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int2 warp_prefix = warp == 0 ? Op::id() : warp_tot[warp - 1];
  total = warp_tot[NW - 1];
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

// Phase 3 of the running max, for a kernel that consumes it: loads this
// thread's IPT snapshots and returns the running max before them; the
// caller folds loc[j] in item by item (the inclusive max = the group's
// base). All threads of the block must call it.
__device__ __forceinline__ int2 max_scan_prefix(LoadSnapshot ld, int n, const int2* __restrict__ partial_max,
                                                int2* loc, int2* warp_tot) {
  int base = blockIdx.x * TILE + threadIdx.x * IPT;
  int2 acc = MaxOp::id();
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    int i = base + j;
    loc[j] = i < n ? ld(i) : MaxOp::id();
    acc = MaxOp::op(acc, loc[j]);
  }
  int2 total;
  return MaxOp::op(partial_max[blockIdx.x], block_exclusive_scan<MaxOp>(acc, warp_tot, total));
}

// First position in [0, n) whose key is >= `key` in a sorted array.
template <class T>
__device__ __forceinline__ int lower_bound(const T* __restrict__ a, int n, T key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }
inline int tiles_for(int n) { return (n + TILE - 1) / TILE; }
inline int bits_for(long long v) {  // bits to hold 0..v (a radix sort's end_bit)
  int n = 1;
  while ((1ll << n) <= v) ++n;
  return n;
}
inline size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }  // workspace offsets

// Lets `Kernel` take up to `max_bytes` of dynamic shared memory on the
// current device: the attribute is set the first time a call there needs
// more than the default 48 KB, and later calls cost one cudaGetDevice.
// Returns a CUDA error code.
template <auto Kernel>
int dyn_smem_once(size_t need, int max_bytes) {
  static unsigned long long done = 0;  // one bit per device
  if (need <= 48 * 1024) return 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err || (dev < 64 && ((done >> dev) & 1))) return err;
  err = (int)cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
  if (!err && dev < 64) done |= 1ull << dev;
  return err;
}

}  // namespace
