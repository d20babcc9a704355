// Shared device code of the port's kernels: wrapping int32 arithmetic,
// the block-wide exclusive scan over int2 pairs, segment-head search and
// floor division, and the dynamic shared memory limit. Included through
// lookback.cuh and bitonic.cuh by K4-K7, K9-K12 and K15-K16; each source
// builds into its own library, so everything here is local to the
// including file.
//
// The segmented prefixes of the JAX package are computed as a wrapping
// int32 cumsum minus a running max of group-start values (lookback.cuh's
// `charges`). Wrapping addition and max are associative, so the results
// equal the JAX cumsum/cummax bit for bit whatever the evaluation order.

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
// more than 40 KB (the kernel's static arrays share the default 48 KB with
// the dynamic bytes), and later calls cost one cudaGetDevice. Returns a
// CUDA error code.
template <auto Kernel>
int dyn_smem_once(size_t need, int max_bytes) {
  static unsigned long long done = 0;  // one bit per device
  if (need <= 40 * 1024) return 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err || (dev < 64 && ((done >> dev) & 1))) return err;
  err = (int)cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
  if (!err && dev < 64) done |= 1ull << dev;
  return err;
}

}  // namespace
