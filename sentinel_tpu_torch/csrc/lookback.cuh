// Single-pass prefix scans across the blocks of one launch (decoupled
// look-back), and the segmented prefix of the JAX package in that form.
// Included by token_decide.cu (K12), flow_admission.cu (K4),
// system_check.cu (K6), breaker_on_exits.cu (K7), shaping_scan.cu (K9),
// param_scan.cu (K10) and mesh_budget.cu (K15, K16); each source builds
// into its own library, so everything here is local to the including file.
//
// A launch that scans takes its tiles in the order its blocks start (an
// atomic counter), so a block waits only on tiles whose blocks already
// run. Each tile publishes its total in a 64-bit status word (flag in the
// high half, the value's bits in the low half, one store), then walks
// back over the earlier tiles' words until one holds an inclusive prefix.
// The status words and the tile counter are zeroed before the launch.

#pragma once

#include "segscan.cuh"

namespace {

using u64 = unsigned long long;
constexpr u64 LB_AGG = 1ull << 32, LB_INC = 2ull << 32;  // look-back status flags

// Carry-ins of a block's scans: none for the one-block routes.
struct NoCarry {
  __device__ int sum_in(int, int) { return 0; }
  __device__ int max_in(int, int) { return INT_MIN; }
};

// The carries of tile `tile` over NCH channels, each with a wrapping-sum
// walk and a max walk. Walk w of the scan reads st[(base + w) * nt + j]:
// the sum walks are w = ch, the max walks w = NCH + ch. A walk is run by
// one whole warp: each round reads the status words of the 32 tiles before
// the window's start at once, and stops at the nearest inclusive one.
template <int NCH>
struct LookBack {
  u64* st;
  int nt;
  int tile;
  int base;

  __device__ static u64 load(const u64* p) { return *(volatile const u64*)p; }
  __device__ static void store(u64* p, u64 flag, int v) { atomicExch(p, flag | (unsigned)v); }

  template <bool SUM>
  __device__ int walk(u64* s, int total) {
    const int lane = threadIdx.x & 31;
    if (tile == 0) {
      if (lane == 0) store(s, LB_INC, total);
      return SUM ? 0 : INT_MIN;
    }
    if (lane == 0) store(s + tile, LB_AGG, total);
    int acc = SUM ? 0 : INT_MIN;
    for (int start = tile - 1;; start -= 32) {
      const int j = start - lane;  // lane 0 holds the nearest tile
      u64 w = 0;
      if (j >= 0) {
        do {
          w = load(s + j);
        } while ((w >> 32) == 0);
      }
      unsigned inc = __ballot_sync(FULL_MASK, j >= 0 && (w & ~0xFFFFFFFFull) == LB_INC);
      int stop = inc ? __ffs(inc) - 1 : 31;  // the lanes up to the nearest inclusive word count
      int v = (j >= 0 && lane <= stop) ? (int)(unsigned)w : (SUM ? 0 : INT_MIN);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        int o = __shfl_xor_sync(FULL_MASK, v, off);
        v = SUM ? wrap_add(v, o) : max(v, o);
      }
      acc = SUM ? wrap_add(acc, v) : max(acc, v);
      if (inc) break;
    }
    if (lane == 0) store(s + tile, LB_INC, SUM ? wrap_add(acc, total) : max(acc, total));
    return acc;
  }
  __device__ int sum_in(int ch, int total) { return walk<true>(st + (size_t)(base + ch) * nt, total); }
  __device__ int max_in(int ch, int total) { return walk<false>(st + (size_t)(base + NCH + ch) * nt, total); }
};

__device__ __forceinline__ int chan(int2 v, int ch) { return ch == 0 ? v.x : v.y; }

// The charges of this thread's `cnt` consecutive sorted items (all threads
// of the block call it) on NCH (1 or 2) channels of int2: per channel the
// wrapping exclusive sum of `acq` minus the running max of the group-start
// snapshots, JAX's excl - cummax(where(head, excl, 0)). Padding items have
// acq 0 and no head. Past 2^31 the running max can pick an earlier
// group's head, as in JAX; a per-group sum would differ there. NT: the
// block's threads (a one-block route of 1,024 takes NoCarry).
template <int MAXI, int NCH, class Carry, int NT = THREADS>
__device__ void charges(int cnt, const int2 (&acq)[MAXI], const bool (&head)[MAXI], int2 (&charge)[MAXI],
                        Carry& carry) {
  __shared__ int2 warp_tot[NT / 32];
  __shared__ int bcast[NCH];
  int2 total;
  int2 local = SumOp::id();
#pragma unroll
  for (int k = 0; k < MAXI; ++k)
    if (k < cnt) local = SumOp::op(local, acq[k]);
  int2 ex = block_exclusive_scan<SumOp, NT>(local, warp_tot, total);
  const int warp = threadIdx.x >> 5;  // warp ch walks channel ch
  if (warp < NCH) {
    int c = carry.sum_in(warp, chan(total, warp));
    if ((threadIdx.x & 31) == 0) bcast[warp] = c;
  }
  __syncthreads();
  int2 run = SumOp::op(make_int2(bcast[0], NCH > 1 ? bcast[NCH - 1] : 0), ex);
  int2 excl[MAXI];
  int2 snap = MaxOp::id();
  const int2 zero = make_int2(0, 0);
#pragma unroll
  for (int k = 0; k < MAXI; ++k) {
    if (k < cnt) {
      excl[k] = run;
      run = SumOp::op(run, acq[k]);
      snap = MaxOp::op(snap, head[k] ? excl[k] : zero);
    }
  }
  __syncthreads();  // bcast is read by every thread before it is written again
  int2 mx = block_exclusive_scan<MaxOp, NT>(snap, warp_tot, total);
  if (warp < NCH) {
    int c = carry.max_in(warp, chan(total, warp));
    if ((threadIdx.x & 31) == 0) bcast[warp] = c;
  }
  __syncthreads();
  int2 m = MaxOp::op(make_int2(bcast[0], NCH > 1 ? bcast[NCH - 1] : INT_MIN), mx);
#pragma unroll
  for (int k = 0; k < MAXI; ++k) {
    if (k < cnt) {
      m = MaxOp::op(m, head[k] ? excl[k] : zero);
      charge[k] = make_int2(wrap_sub(excl[k].x, m.x), wrap_sub(excl[k].y, m.y));
    }
  }
  __syncthreads();
}

// The exclusive count of this thread's flagged items over the launch
// (a compaction index): the block scan plus the look-back carry of sum
// walk `base` (LookBack<1>), or no carry. `total` gets the count up to and
// including this block's tile. All threads of the block call it.
template <class Carry>
__device__ int compact_index(int local, Carry& carry, int& total) {
  __shared__ int2 warp_tot[NWARPS];
  __shared__ int bcast;
  int2 tot;
  int2 ex = block_exclusive_scan<SumOp>(make_int2(local, 0), warp_tot, tot);
  if (threadIdx.x < 32) {  // warp 0 walks
    int c = carry.sum_in(0, tot.x);
    if (threadIdx.x == 0) bcast = c;
  }
  __syncthreads();
  int c = bcast;
  total = wrap_add(c, tot.x);
  __syncthreads();
  return wrap_add(c, ex.x);
}

}  // namespace
