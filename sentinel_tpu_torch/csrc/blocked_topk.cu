// The blocked top-K above KMAX = 8 for Hopper (sm_90a): the wide route of
// the verdict tails' blocked-weight top-K, the port of
// sentinel_tpu/runtime/flush.py:flush_entries :879-897 (lax.top_k of the
// dense [R] blocked acquire per cluster row) for any k. K4's DEFAULT tail
// (flow_admission.cu: fa_small / small_topk, fa_verdict + fa_topk) and the
// slot chain's tail (cv_small, cv_entry + cv_topk) keep their fused top-K
// up to KMAX candidates a thread; above it, runtime/flush.py runs them
// with no top-K and then this one C call over the verdicts they wrote.
//
// One C call, blocked_topk, four launches and one CUB radix sort:
//
// - bt_add, one entry a thread: an entry that is valid, blocked and
//   acquires w > 0 adds into its cluster row's 64-bit cell in the zeroed
//   scratch (warp-combined): the low half is the wrapping int32 sum, the
//   high half counts the entries, so a touched cell is never zero, and the
//   add that finds it zero lists the row. The last block writes the keys
//   of the k lowest untouched rows (weight 0) after the listed rows' keys.
// - bt_keys, one listed row a thread: the row's key, one 64-bit value
//   that is larger exactly when the row ranks first in lax.top_k (weight
//   descending, row ascending; 0 marks an empty place); it zeroes the cell
//   and the list slot it read.
// - one cub::DeviceRadixSort::SortKeysDescending of the min(n, R) + k keys
//   (named by the kernel item; the list's length is known on the device
//   only, so the empty places sort last as zeros).
// - bt_out: the first k keys into the weights and rows, and the list's
//   length back to zero: the scratch is all zero again. A call that fails
//   after bt_add memsets what it may have written.
//
// Why these candidates suffice: a row no blocked entry touched weighs 0,
// and among such rows lax.top_k takes the lowest first, so only the k
// lowest of them can rank; a touched row whose sum wraps to 0 ranks among
// the zeros by its row, as in the dense array.
//
// What bounds it: launches and the sort, not bytes. Per entry it reads
// about 14 B of batch and verdict; per listed row it moves a 16-byte cell
// and list slot and a key through the sort (a few passes over 8 B).

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
};

namespace {

using u64 = unsigned long long;

// The zeroed scratch: a header of BT_HDR ints ([0] bt_add's finished
// blocks, [1] the list's length), the 64-bit cells of the R rows, then the
// list of touched rows (min(n, R) ints).
constexpr int BT_HDR = 8;

__device__ __forceinline__ u64 cand_key(int w, int r) {
  return ((u64)((unsigned)w ^ 0x80000000u) << 32) | (unsigned)~r;
}

__host__ __device__ inline int listed_max(int n, int n_rows) { return n < n_rows ? n : n_rows; }

// The keys of the k lowest rows whose cell is zero, at keys[base + j] (0
// where fewer exist); run by bt_add's last block once every add is done.
__device__ void low_rows(const BtArgs& a, const u64* dense, u64* keys, int base) {
  constexpr int PER = 4;
  __shared__ int2 warp_tot[NWARPS];
  int found = 0;
  for (int r0b = 0; r0b < a.n_rows && found < a.k; r0b += THREADS * PER) {
    const int r0 = r0b + threadIdx.x * PER;
    bool z[PER];
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      z[q] = r0 + q < a.n_rows && __ldcg(dense + r0 + q) == 0;
      cnt += z[q] ? 1 : 0;
    }
    int2 total;
    int rank = found + block_exclusive_scan<SumOp>(make_int2(cnt, 0), warp_tot, total).x;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      if (z[q] && rank < a.k) keys[base + rank] = cand_key(0, r0 + q);
      rank += z[q] ? 1 : 0;
    }
    found += total.x;
  }
  for (int j = found + threadIdx.x; j < a.k; j += THREADS) keys[base + j] = 0;
}

__global__ void __launch_bounds__(THREADS) bt_add(BtArgs a, int* __restrict__ zero, u64* __restrict__ keys) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  __shared__ int s_cnt, s_base;
  __shared__ bool is_last;
  int* hdr = zero;
  u64* dense = reinterpret_cast<u64*>(zero + BT_HDR);
  int* list = reinterpret_cast<int*>(dense + a.n_rows);
  int w = 0, row = 0;
  if (e < a.n) {
    row = clampi(a.e_rows[(int64_t)e * 4 + 1], 0, a.n_rows - 1);
    const int acq = a.e_acq[e];
    w = (a.e_valid[e] && !a.admitted[e] && acq > 0) ? acq : 0;
  }
  if (threadIdx.x == 0) s_cnt = 0;
  __syncthreads();
  const bool act = w > 0;
  const unsigned am = __ballot_sync(FULL_MASK, act);
  bool push = false;
  if (act) {
    const unsigned grp = __match_any_sync(am, row);
    const unsigned sum = __reduce_add_sync(grp, (unsigned)w);
    if (lane == __ffs(grp) - 1) push = atomicAdd(&dense[row], ((u64)__popc(grp) << 32) + sum) == 0;
  }
  // A place per warp in the block's share of the list, one global atomic
  // per block.
  const unsigned pm = __ballot_sync(FULL_MASK, push);
  int at = 0;
  if (pm != 0 && lane == __ffs(pm) - 1) at = atomicAdd(&s_cnt, __popc(pm));
  at = __shfl_sync(FULL_MASK, at, pm != 0 ? __ffs(pm) - 1 : 0) + __popc(pm & ((1u << lane) - 1));
  __syncthreads();
  if (threadIdx.x == 0) s_base = s_cnt > 0 ? atomicAdd(&hdr[1], s_cnt) : 0;
  __syncthreads();
  if (push) list[s_base + at] = row;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&hdr[0], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  low_rows(a, dense, keys, listed_max(a.n, a.n_rows));
  if (threadIdx.x == 0) hdr[0] = 0;
}

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

struct Layout {
  size_t keys_in, keys_out, temp, total;
  int n_keys;
};

Layout layout(int n, int n_rows, int k) {
  Layout l;
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
long long blocked_topk_workspace(int n, int n_rows, int k) { return (long long)layout(n, n_rows, k).total; }

// Bytes of the zeroed scratch blocked_topk needs (and leaves zero).
long long blocked_topk_zero_bytes(int n, int n_rows) { return zero_bytes_for(n, n_rows); }

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
  u64* keys_in = (u64*)(ws + l.keys_in);
  u64* keys_out = (u64*)(ws + l.keys_out);
  size_t temp_bytes = l.total - l.temp;
  bt_add<<<max(1, blocks_for(a.n)), THREADS, 0, st>>>(a, zero, keys_in);
  int err = (int)cudaGetLastError();
  if (!err && listed_max(a.n, a.n_rows) > 0) {
    bt_keys<<<blocks_for(listed_max(a.n, a.n_rows)), THREADS, 0, st>>>(a, zero, keys_in);
    err = (int)cudaGetLastError();
  }
  if (!err)
    err = (int)cub::DeviceRadixSort::SortKeysDescending(ws + l.temp, temp_bytes, keys_in, keys_out, l.n_keys, 0, 64,
                                                        st);
  if (!err) {
    bt_out<<<1, THREADS, 0, st>>>(a, zero, keys_out);
    err = (int)cudaGetLastError();
  }
  // bt_add may have added into the zeroed cells: a call that fails after
  // it leaves them zero all the same.
  if (err) cudaMemsetAsync(zero, 0, (size_t)need_zero, st);
  return err;
}

}  // extern "C"
