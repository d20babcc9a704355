// The blocked top-K above KMAX = 8 for Hopper (sm_90a): the wide route of
// the verdict tails' blocked-weight top-K, the port of
// sentinel_tpu/runtime/flush.py:flush_entries :879-897 (lax.top_k of the
// dense [R] blocked acquire per cluster row) for any k. K4's DEFAULT tail
// (flow_admission.cu: fa_small / small_topk, fa_verdict + fa_topk) and the
// slot chain's tail (cv_small, cv_entry + cv_topk) keep their fused top-K
// up to KMAX candidates a thread; above it, runtime/flush.py runs them
// with no top-K and then this one C call over the verdicts they wrote.
//
// One C call, blocked_topk, two routes after one shared first launch:
//
// - bt_add, one entry a thread: an entry that is valid, blocked and
//   acquires w > 0 adds into its cluster row's 64-bit cell in the zeroed
//   scratch, combined first in the warp and then in the block (a hash of
//   rows in shared memory, one global add a row a block): the low half is
//   the wrapping int32 sum, the high half counts the entries, so a touched
//   cell is never zero, and the add that finds it zero lists the row. The
//   last block writes the keys of the k lowest untouched rows (weight 0),
//   in row order.
// - The selection (two launches in all, no memset, no device-wide sort),
//   for k up to SEL_K_MAX = 256: bt_select, one tile
//   of T listed rows a block (1,024, or 2,048 for k above 64), reads and
//   zeroes the rows' cells and list slots, forms one 64-bit key a row
//   (larger exactly when the row ranks first in lax.top_k: weight
//   descending, row ascending; 0 marks an empty place) and keeps its
//   tile's top k: runs of K = pow2(k) keys sorted by a bitonic network,
//   then merged pairwise (the top K of two descending runs is the max of
//   one against the other reversed, a bitonic sequence that a half-cleaner
//   sorts), a tree of log2(T / K) rounds. The keys stay in registers, KPT
//   a thread; a warp owns 32 * KPT consecutive places, so that a step
//   within them is a shuffle (or a register of the thread), and only a
//   longer one goes through shared memory. Each block writes its k
//   candidates; the last block to finish (a done counter in the zeroed
//   header) merges them with the k low-row keys the same way, T / K runs
//   at a time, a level after another, writes the weights and rows, and
//   zeroes the header.
// - The sort route, for a larger k: bt_keys (one listed
//   row a thread: its key; zeroes the cell and the list slot), one
//   cub::DeviceRadixSort::SortKeysDescending of the min(n, R) + k keys and
//   bt_out (the first k keys into the weights and rows, the list's length
//   back to zero).
//
// Either way the scratch is all zero again; a call that fails after
// bt_add memsets what it may have written.
//
// Why these candidates suffice: a row no blocked entry touched weighs 0,
// and among such rows lax.top_k takes the lowest first, so only the k
// lowest of them can rank; a touched row whose sum wraps to 0 ranks among
// the zeros by its row, as in the dense array.
//
// What bounds it: latency, not bytes. Per entry it reads about 10 B of
// batch and verdict (0.39 us at 131,072 entries); per listed row it moves
// a 16-byte cell and list slot. The time goes to the adds to hot rows,
// which serialize on their address, the networks' steps (at k = 16 a tile
// of 1,024 takes 5 steps through shared memory, the merge as many) and
// the two launches.

#include <cub/device/device_radix_sort.cuh>

#include "segscan.cuh"

// One call's arguments; runtime/flush.py fills the same layout (_BtArgs).
// At file scope, so that the C entry point taking it keeps external linkage.
struct BtArgs {
  const uint8_t* admitted;  // [n]
  const uint8_t* e_valid;   // [n]
  const int* e_acq;         // [n]
  const int* e_rows;        // [n, 4] (the cluster row is column 1, clipped into [0, R))
  int* out_w;               // [k]
  int* out_r;               // [k]
  int n, n_rows, k;
  int fault;  // tests: nonzero launches the step after bt_add with too many threads, which is refused
};

namespace {

using u64 = unsigned long long;

// The zeroed scratch: a header of BT_HDR ints ([0] bt_add's finished
// blocks, [1] the list's length, [2] bt_select's finished blocks), the
// 64-bit cells of the R rows, then the list of touched rows (min(n, R)
// ints).
constexpr int BT_HDR = 8;
constexpr int NT_ADD = 1024;                  // bt_add's threads
constexpr int ADD_BITS = 11;                  // bt_add's hash of rows: 2,048 slots a block
constexpr int ADD_SLOTS = 1 << ADD_BITS;
constexpr int SEL_K_MAX = 256;                // the largest k of the selection

__device__ __forceinline__ u64 cand_key(int w, int r) {
  return ((u64)((unsigned)w ^ 0x80000000u) << 32) | (unsigned)~r;
}

__host__ __device__ inline int listed_max(int n, int n_rows) { return n < n_rows ? n : n_rows; }

__host__ __device__ inline long long pow2_at_least(long long v) {
  long long p = 1;
  while (p < v) p <<= 1;
  return p;
}

// The selection's shape: nt threads of bt_select with kpt keys each, tiles
// of T = nt * kpt listed rows, one a block, runs of K = pow2(k) keys, nb
// blocks. kpt 0: take the sort route. Up to K = 16 a block of 1,024
// threads with a key each (more warps to hide the steps' latency), else
// 256 threads with 4 keys (8 for K = 128 and 256), so that a run lies in
// one warp's places.
struct Plan {
  int nt, kpt, tile, runk, nb;
};

Plan plan_for(int n, int n_rows, int k) {
  Plan p{0, 0, 0, 0, 0};
  if (k > SEL_K_MAX) return p;
  p.runk = (int)pow2_at_least(k);
  p.nt = p.runk <= 16 ? 1024 : 256;
  p.kpt = p.runk <= 16 ? 1 : p.runk <= 64 ? 4 : 8;
  p.tile = p.nt * p.kpt;
  const int L = listed_max(n, n_rows);
  p.nb = L > 0 ? (L + p.tile - 1) / p.tile : 1;
  return p;
}

// Runs each level of the last block's merge holds: level 0 the nb + 1
// candidate runs, level l + 1 one run for each T / K runs of level l.
__host__ __device__ inline int level_runs(int runs, int per) { return (runs + per - 1) / per; }

// The keys of the k lowest rows whose cell is zero, at low[j] (0 where
// fewer exist); run by bt_add's last block once every add is done.
__device__ void low_rows(const BtArgs& a, const u64* dense, u64* low) {
  constexpr int PER = 4;
  __shared__ int2 warp_tot[NT_ADD / 32];
  int found = 0;
  for (int r0b = 0; r0b < a.n_rows && found < a.k; r0b += NT_ADD * PER) {
    const int r0 = r0b + threadIdx.x * PER;
    bool z[PER];
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      z[q] = r0 + q < a.n_rows && __ldcg(dense + r0 + q) == 0;
      cnt += z[q] ? 1 : 0;
    }
    int2 total;
    int rank = found + block_exclusive_scan<SumOp, NT_ADD>(make_int2(cnt, 0), warp_tot, total).x;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      if (z[q] && rank < a.k) low[rank] = cand_key(0, r0 + q);
      rank += z[q] ? 1 : 0;
    }
    found += total.x;
  }
  for (int j = found + threadIdx.x; j < a.k; j += NT_ADD) low[j] = 0;
}

// One entry a thread. A warp's adds to one row are combined (match_any),
// then the block's in a hash of rows in shared memory, so that a hot row
// takes one global add a block: on Zipf rows the first row is some 12% of
// the blocked entries, and adds to one address serialize.
__global__ void __launch_bounds__(NT_ADD) bt_add(BtArgs a, int* __restrict__ zero, u64* __restrict__ low) {
  const int e = blockIdx.x * NT_ADD + threadIdx.x;
  const int lane = threadIdx.x & 31;
  __shared__ int h_row[ADD_SLOTS];
  __shared__ u64 h_val[ADD_SLOTS];
  __shared__ int s_cnt, s_base;
  __shared__ bool is_last;
  int* hdr = zero;
  u64* dense = reinterpret_cast<u64*>(zero + BT_HDR);
  int* list = reinterpret_cast<int*>(dense + a.n_rows);
  for (int j = threadIdx.x; j < ADD_SLOTS; j += NT_ADD) {
    h_row[j] = -1;
    h_val[j] = 0;
  }
  if (threadIdx.x == 0) s_cnt = 0;
  int w = 0, row = 0;
  if (e < a.n) {
    row = clampi(a.e_rows[(int64_t)e * 4 + 1], 0, a.n_rows - 1);
    const int acq = a.e_acq[e];
    w = (a.e_valid[e] && !a.admitted[e] && acq > 0) ? acq : 0;
  }
  __syncthreads();
  const bool act = w > 0;
  const unsigned am = __ballot_sync(FULL_MASK, act);
  if (act) {
    const unsigned grp = __match_any_sync(am, row);
    const unsigned sum = __reduce_add_sync(grp, (unsigned)w);
    if (lane == __ffs(grp) - 1) {
      unsigned h = ((unsigned)row * 2654435761u) >> (32 - ADD_BITS);
      for (;;) {
        const int prev = atomicCAS(&h_row[h], -1, row);
        if (prev == -1 || prev == row) break;
        h = (h + 1) & (ADD_SLOTS - 1);
      }
      atomicAdd(&h_val[h], ((u64)__popc(grp) << 32) + sum);
    }
  }
  __syncthreads();
  // One global add a row of the block; the add that finds the cell zero
  // lists the row: a place per warp in the block's share of the list, one
  // global atomic per block.
  int lrow[ADD_SLOTS / NT_ADD], at[ADD_SLOTS / NT_ADD];
  bool push[ADD_SLOTS / NT_ADD];
#pragma unroll
  for (int q = 0; q < ADD_SLOTS / NT_ADD; ++q) {
    const int j = q * NT_ADD + threadIdx.x;
    lrow[q] = h_row[j];
    push[q] = lrow[q] >= 0 && atomicAdd(&dense[lrow[q]], h_val[j]) == 0;
    const unsigned pm = __ballot_sync(FULL_MASK, push[q]);
    int base = 0;
    if (pm != 0 && lane == __ffs(pm) - 1) base = atomicAdd(&s_cnt, __popc(pm));
    at[q] = __shfl_sync(FULL_MASK, base, pm != 0 ? __ffs(pm) - 1 : 0) + __popc(pm & ((1u << lane) - 1));
  }
  __syncthreads();
  if (threadIdx.x == 0) s_base = s_cnt > 0 ? atomicAdd(&hdr[1], s_cnt) : 0;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < ADD_SLOTS / NT_ADD; ++q)
    if (push[q]) list[s_base + at[q]] = lrow[q];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&hdr[0], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  low_rows(a, dense, low);
  if (threadIdx.x == 0) hdr[0] = 0;
}

// ---------------------------------------------------------------------------
// the selection
// ---------------------------------------------------------------------------

__device__ __forceinline__ u64 umax(u64 x, u64 y) { return x > y ? x : y; }
__device__ __forceinline__ u64 umin(u64 x, u64 y) { return x < y ? x : y; }

// The place of key q of this thread: warp w owns places [w W, (w + 1) W)
// of W = 32 KPT, lane l holds w W + 32 q + l.
template <int KPT>
__device__ __forceinline__ int place(int q) {
  return (threadIdx.x >> 5) * 32 * KPT + 32 * q + (threadIdx.x & 31);
}

// y[q]: the key at place(q) ^ (32 MQ + ml), a key of this warp.
template <int KPT, int MQ>
__device__ __forceinline__ void warp_partner(const u64 (&x)[KPT], u64 (&y)[KPT], int ml) {
  if constexpr (MQ < KPT) {
#pragma unroll
    for (int q = 0; q < KPT; ++q) y[q] = __shfl_xor_sync(FULL_MASK, x[q ^ MQ], ml);
  }
}

// One step of a network over the block's NT * KPT keys: each key
// becomes the max (where take_max of its place) or the min of itself and
// the key at place ^ m. Within a warp's places by shuffles; else through
// shared memory (two __syncthreads).
template <int KPT, class F>
__device__ __forceinline__ void exchange(u64 (&x)[KPT], int m, u64* sh, F take_max) {
  u64 y[KPT];
  if (m < 32 * KPT) {
    const int ml = m & 31;
    switch (m >> 5) {
      case 0: warp_partner<KPT, 0>(x, y, ml); break;
      case 1: warp_partner<KPT, 1>(x, y, ml); break;
      case 2: warp_partner<KPT, 2>(x, y, ml); break;
      case 3: warp_partner<KPT, 3>(x, y, ml); break;
      case 4: warp_partner<KPT, 4>(x, y, ml); break;
      case 5: warp_partner<KPT, 5>(x, y, ml); break;
      case 6: warp_partner<KPT, 6>(x, y, ml); break;
      default: warp_partner<KPT, 7>(x, y, ml); break;
    }
  } else {
#pragma unroll
    for (int q = 0; q < KPT; ++q) sh[place<KPT>(q)] = x[q];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < KPT; ++q) y[q] = sh[place<KPT>(q) ^ m];
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < KPT; ++q) x[q] = take_max(place<KPT>(q)) ? umax(x[q], y[q]) : umin(x[q], y[q]);
}

// Sorts each run of K keys (K a power of two) descending: a bitonic
// network whose last merge runs every run downward.
template <int KPT>
__device__ __forceinline__ void sort_runs(u64 (&x)[KPT], int K, u64* sh) {
  for (int kk = 2; kk <= K; kk <<= 1)
    for (int j = kk >> 1; j > 0; j >>= 1)
      exchange(x, j, sh, [=](int i) { return ((i & j) == 0) == (kk == K || (i & kk) == 0); });
}

// The keys hold `runs` (a power of two) runs of K keys, each descending;
// leaves the top K of them all in run 0, descending. Round s merges run
// q with run q + s for q a multiple of 2s: q[i] = max(q[i], (q + s)[K - 1
// - i]), a partner at place ^ (s K | K - 1), holds the pair's top K as a
// bitonic sequence, which a half-cleaner network sorts. The other runs
// take what they take.
template <int KPT>
__device__ __forceinline__ void merge_runs(u64 (&x)[KPT], int runs, int K, u64* sh) {
  for (int s = 1; s < runs; s <<= 1) {
    exchange(x, s * K | (K - 1), sh, [](int) { return true; });
    for (int j = K >> 1; j > 0; j >>= 1) exchange(x, j, sh, [=](int i) { return (i & j) == 0; });
  }
}

// cand: block b's k candidates at cand[b * k], the k low-row keys at
// cand[nb * k] (bt_add's last block wrote them); lvl: the last block's two
// buffers of merged runs, level_runs(nb + 1, T / K) * k keys each.
template <int NT, int KPT>
__global__ void __launch_bounds__(NT) bt_select(BtArgs a, Plan p, int* __restrict__ zero, u64* __restrict__ cand,
                                               u64* __restrict__ lvl) {
  __shared__ u64 sh[NT * KPT];
  __shared__ int s_count;
  __shared__ bool is_last;
  int* hdr = zero;
  u64* dense = reinterpret_cast<u64*>(zero + BT_HDR);
  int* list = reinterpret_cast<int*>(dense + a.n_rows);
  const int K = p.runk, T = NT * KPT, lk = __ffs(K) - 1;
  if (threadIdx.x == 0) s_count = hdr[1];
  __syncthreads();
  const int count = s_count;
  const int base = blockIdx.x * T;
  u64 x[KPT];
  if (base < count) {
#pragma unroll
    for (int q = 0; q < KPT; ++q) {
      const int at = base + place<KPT>(q);
      x[q] = 0;
      if (at < count) {
        const int r = list[at];
        x[q] = cand_key((int)(unsigned)dense[r], r);
        dense[r] = 0;
        list[at] = 0;
      }
    }
    sort_runs(x, K, sh);
    merge_runs(x, T >> lk, K, sh);
#pragma unroll
    for (int q = 0; q < KPT; ++q)
      if (place<KPT>(q) < a.k) cand[(size_t)blockIdx.x * a.k + place<KPT>(q)] = x[q];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&hdr[2], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // Level 0: run 0 the low-row keys, run 1 + b block b's candidates (those
  // of the blocks that had listed rows). Each chunk of T / K runs merges
  // into one run of the next level, until one chunk holds them all.
  const int per = T >> lk;
  const int used = min(p.nb, (count + T - 1) / T);
  const size_t stride = (size_t)level_runs(p.nb + 1, per) * a.k;
  int runs = used + 1;
  for (int level = 0;; ++level) {
    const int chunks = level_runs(runs, per);
    const u64* src = level == 0 ? cand : lvl + ((level + 1) & 1) * stride;
    u64* dst = lvl + (level & 1) * stride;
    for (int c = 0; c < chunks; ++c) {
#pragma unroll
      for (int q = 0; q < KPT; ++q) {
        const int i = place<KPT>(q), run = c * per + (i >> lk), j = i & (K - 1);
        const size_t at = level == 0 ? (size_t)(run == 0 ? p.nb : run - 1) * a.k : (size_t)run * a.k;
        x[q] = j < a.k && run < runs ? __ldcg(src + at + j) : 0;
      }
      merge_runs(x, per, K, sh);
#pragma unroll
      for (int q = 0; q < KPT; ++q) {
        const int i = place<KPT>(q);
        if (i >= a.k) continue;
        if (chunks > 1) {
          dst[(size_t)c * a.k + i] = x[q];
        } else {
          a.out_w[i] = (int)((unsigned)(x[q] >> 32) ^ 0x80000000u);
          a.out_r[i] = (int)~(unsigned)x[q];
        }
      }
    }
    if (chunks == 1) break;
    __threadfence();
    __syncthreads();
    runs = chunks;
  }
  if (threadIdx.x == 0) {
    hdr[1] = 0;
    hdr[2] = 0;
  }
}

// ---------------------------------------------------------------------------
// the sort route
// ---------------------------------------------------------------------------

__global__ void bt_keys(BtArgs a, int* __restrict__ zero, u64* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= listed_max(a.n, a.n_rows)) return;
  u64* dense = reinterpret_cast<u64*>(zero + BT_HDR);
  int* list = reinterpret_cast<int*>(dense + a.n_rows);
  u64 key = 0;
  if (i < __ldcg(zero + 1)) {
    const int r = list[i];
    key = cand_key((int)(unsigned)dense[r], r);
    dense[r] = 0;
    list[i] = 0;
  }
  keys[i] = key;
}

__global__ void bt_out(BtArgs a, int* __restrict__ zero, const u64* __restrict__ sorted) {
  for (int j = threadIdx.x; j < a.k; j += blockDim.x) {
    const u64 key = sorted[j];
    a.out_w[j] = (int)((unsigned)(key >> 32) ^ 0x80000000u);
    a.out_r[j] = (int)~(unsigned)key;
  }
  if (threadIdx.x == 0) zero[1] = 0;
}

// The workspace: the selection's candidates ((nb + 1) * k keys) and the
// last block's two level buffers, or the sort route's keys in and out
// (min(n, R) + k each: the low-row keys after the listed rows') and CUB's
// temporary storage.
struct Layout {
  Plan plan;
  size_t keys_in, keys_out, temp, lvl, total;
  int n_keys;
};

Layout layout(int n, int n_rows, int k) {
  Layout l{};
  l.plan = plan_for(n, n_rows, k);
  if (l.plan.kpt > 0) {
    const Plan& p = l.plan;
    l.lvl = sizeof(u64) * ((size_t)p.nb + 1) * (size_t)k;
    l.total = l.lvl + 2 * sizeof(u64) * (size_t)level_runs(p.nb + 1, p.tile / p.runk) * (size_t)k;
    return l;
  }
  l.n_keys = listed_max(n, n_rows) + k;
  size_t temp = 0;
  cub::DeviceRadixSort::SortKeysDescending(nullptr, temp, (const u64*)nullptr, (u64*)nullptr, l.n_keys);
  const size_t kb = align256(sizeof(u64) * (size_t)l.n_keys);
  l.keys_in = 0;
  l.keys_out = kb;
  l.temp = 2 * kb;
  l.total = l.temp + align256(temp);
  return l;
}

long long zero_bytes_for(int n, int n_rows) {
  return 4ll * BT_HDR + 8ll * n_rows + 4ll * listed_max(n, n_rows);
}

}  // namespace

extern "C" {

// Bytes of workspace blocked_topk needs for n entries over n_rows rows at k.
long long blocked_topk_workspace(int n, int n_rows, int k) {
  return (long long)layout(n, n_rows, k).total;
}

// Bytes of the zeroed scratch blocked_topk needs (and leaves zero).
long long blocked_topk_zero_bytes(int n, int n_rows) { return zero_bytes_for(n, n_rows); }

// 1 when blocked_topk takes the selection at these sizes, 0 the sort route.
int blocked_topk_selects(int n, int n_rows, int k) {
  return plan_for(n, n_rows, k).kpt > 0 ? 1 : 0;
}

// The top-k (0 < k <= n_rows) blocked cluster rows of one verdict tail, as
// the header says; `args` is read on the host. Returns a CUDA error code,
// or -1 when the workspace or the zeroed scratch is short (no launch).
int blocked_topk(const BtArgs* args, void* workspace, long long workspace_bytes, int* zero, long long zero_bytes,
                 cudaStream_t st) {
  const BtArgs a = *args;
  if (a.n < 0 || a.n_rows <= 0 || a.k <= 0 || a.k > a.n_rows) return (int)cudaErrorInvalidValue;
  const Layout l = layout(a.n, a.n_rows, a.k);
  const long long need_zero = zero_bytes_for(a.n, a.n_rows);
  if (workspace_bytes < (long long)l.total || zero == nullptr || zero_bytes < need_zero) return -1;
  char* ws = (char*)workspace;
  const Plan& p = l.plan;
  u64* low = p.kpt > 0 ? (u64*)ws + (size_t)p.nb * a.k : (u64*)(ws + l.keys_in) + listed_max(a.n, a.n_rows);
  bt_add<<<max(1, (a.n + NT_ADD - 1) / NT_ADD), NT_ADD, 0, st>>>(a, zero, low);
  int err = (int)cudaGetLastError();
  if (p.kpt > 0) {
    if (!err) {
      const int nt = a.fault ? 2 * 1024 : p.nt;
      u64* lvl = (u64*)(ws + l.lvl);
      if (p.kpt == 1)
        bt_select<1024, 1><<<p.nb, nt, 0, st>>>(a, p, zero, (u64*)ws, lvl);
      else if (p.kpt == 4)
        bt_select<256, 4><<<p.nb, nt, 0, st>>>(a, p, zero, (u64*)ws, lvl);
      else
        bt_select<256, 8><<<p.nb, nt, 0, st>>>(a, p, zero, (u64*)ws, lvl);
      err = (int)cudaGetLastError();
    }
  } else {
    u64* keys_in = (u64*)(ws + l.keys_in);
    u64* keys_out = (u64*)(ws + l.keys_out);
    size_t temp_bytes = l.total - l.temp;
    if (!err && listed_max(a.n, a.n_rows) > 0) {
      bt_keys<<<blocks_for(listed_max(a.n, a.n_rows)), a.fault ? 2 * 1024 : THREADS, 0, st>>>(a, zero, keys_in);
      err = (int)cudaGetLastError();
    }
    if (!err)
      err = (int)cub::DeviceRadixSort::SortKeysDescending(ws + l.temp, temp_bytes, keys_in, keys_out, l.n_keys, 0,
                                                          64, st);
    if (!err) {
      bt_out<<<1, THREADS, 0, st>>>(a, zero, keys_out);
      err = (int)cudaGetLastError();
    }
  }
  // bt_add may have added into the zeroed cells: a call that fails after
  // it leaves them zero all the same.
  if (err) cudaMemsetAsync(zero, 0, (size_t)need_zero, st);
  return err;
}

}  // extern "C"
