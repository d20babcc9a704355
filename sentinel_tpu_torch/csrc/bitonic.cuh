// Bitonic sorts in shared memory by the whole block, for the one-block
// routes of K4 and the slot chain's verdict tail (flow_admission.cu), K5
// (commit_borrow_slab.cu), K6 (system_check.cu), K9 (shaping_scan.cu), K10
// (param_scan.cu), K12 (token_decide.cu) and K15 and K16 (mesh_budget.cu), and the
// (row, ts) sort key of K4 and K10. `p` is a
// power of two; callers pad with SENTINEL keys; any block size. Included
// by one source per library, so local to it.

#pragma once

#include "segscan.cuh"

namespace {

constexpr unsigned long long SENTINEL = ~0ull;  // pads a sort: sorts last

// The (row, ts) sort key of K4's slots and K10's items: the row over the
// ts, its sign bit flipped so that a negative ts sorts first.
__device__ __forceinline__ unsigned long long row_ts_key(int row, int ts) {
  return ((unsigned long long)(unsigned)row << 32) | ((unsigned)ts ^ 0x80000000u);
}
__device__ __forceinline__ int key_row(unsigned long long key) { return (int)(unsigned)(key >> 32); }

// Ascending sort of p distinct 64-bit keys.
__device__ void bitonic_sort(unsigned long long* key, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        int ixj = i ^ j;
        if (ixj > i) {
          unsigned long long x = key[i], y = key[ixj];
          if ((x > y) == ((i & k) == 0)) {
            key[i] = y;
            key[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Ascending sort of p (key, val) pairs by key, then val: with the input
// positions as vals, the stable order of equal keys.
template <class V>
__device__ void bitonic_sort_pairs(unsigned long long* key, V* val, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        int ixj = i ^ j;
        if (ixj > i) {
          unsigned long long x = key[i], y = key[ixj];
          V a = val[i], b = val[ixj];
          bool gt = x > y || (x == y && a > b);
          if (gt == ((i & k) == 0)) {
            key[i] = y;
            key[ixj] = x;
            val[i] = b;
            val[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace
