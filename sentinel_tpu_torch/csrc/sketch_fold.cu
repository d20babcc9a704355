// K11: the sketch tier's fold on the card (replaces the jitted
// `sketch_fold`, sentinel_tpu/runtime/sketch.py:191).
//
// What it computes, per flush, for a count-min array cm [D, W] (D <= 8,
// W a power of two), a candidate table (ids, counts) [C] and a batch of
// S (id, weight) pairs (id -1 = padding):
//   1. with `decay`, cm >>= 1 and counts >>= 1 (arithmetic, int32);
//   2. cm[d][h_d(id)] += w for every valid pair and row (atomicAdd: exact
//      integer adds that wrap in int32 as XLA's scatter-add does);
//   3. after every add of the batch (a launch boundary), each id's
//      estimate min_d cm[d][h_d(id)] and its sort key (I32_MAX for
//      padding); the wrapper sorts the keys with one CUB radix sort
//      (torch.sort); equal ids carry equal estimates, so the order among
//      them does not matter;
//   4. the top C of the C + S merged counts: the candidates first (-1 for
//      an empty slot or one the batch touched, found by binary search over
//      the sorted ids instead of JAX's [C, S] matrix), then the distinct
//      ids in sorted order (their estimate at a segment head, -1
//      elsewhere), ordered by count descending then index ascending as
//      lax.top_k breaks ties. Each key packs count * 2^32 + (2^32 - 1 -
//      index), a total order. Blocks sort tiles of T keys in shared memory
//      (bitonic; T = max(4096, 2C rounded up to a power of two), at most
//      16,384: C <= 8,192) and keep their top C; passes repeat until one
//      tile is left, whose block decodes ids (-1, count 0 below 0).
//
// Bound: bytes. The adds touch D cells per key (scattered 4-byte atomics,
// one sector each); the rest streams S or C items a few times. Nothing
// here is sized by W except the decay pass.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TOPC_THREADS = 1024;
constexpr int TOPC_TILE_MIN = 4096;   // keys per top-C block: 32 KB of shared memory
constexpr int TOPC_TILE_MAX = 16384;  // 128 KB, under the 227 KB a block may use
constexpr int I32_MAX = 0x7fffffff;
constexpr long long KEY_PAD = LLONG_MIN;

// Per-depth-row seeds: runtime/sketch.py _SEEDS.
__constant__ uint32_t SEEDS[8] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du, 0x27D4EB2Fu,
                                  0x165667B1u, 0xD3A2646Du, 0xFD7046C5u, 0xB55A4F09u};

__device__ __forceinline__ int cm_cell(uint32_t id, int d, int width) {
  uint32_t h = (id ^ SEEDS[d]) * 2654435761u;
  h ^= h >> 15;
  return (int)(h & (uint32_t)(width - 1));
}

__global__ void sf_decay(int* __restrict__ cm, long long n_cm, int* __restrict__ cand_cnt, int c) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_cm; i += stride) cm[i] >>= 1;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < c) cand_cnt[t] >>= 1;
}

// One thread per (depth row, item): neighbouring threads read
// neighbouring ids.
__global__ void sf_add(const int* __restrict__ ids, const int* __restrict__ w, int s, int depth, int width,
                       int* __restrict__ cm) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)s * depth) return;
  int d = (int)(t / s);
  int i = (int)(t - (long long)d * s);
  int id = ids[i];
  if (id < 0) return;
  atomicAdd(&cm[(size_t)d * width + cm_cell((uint32_t)id, d, width)], w[i]);
}

__global__ void sf_estimate(const int* __restrict__ ids, int s, int depth, int width, const int* __restrict__ cm,
                            int* __restrict__ est, int* __restrict__ key) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  int id = ids[i];
  int e = I32_MAX;
  for (int d = 0; d < depth; ++d) e = min(e, cm[(size_t)d * width + cm_cell((uint32_t)id, d, width)]);
  est[i] = e;
  key[i] = id >= 0 ? id : I32_MAX;
}

__device__ __forceinline__ long long pack(int cnt, int index) {
  return (long long)cnt * 4294967296LL + (long long)(0xFFFFFFFFu - (unsigned)index);
}

// Is `v` among the sorted ids? (Padding sorts last as I32_MAX; the
// caller never asks for I32_MAX, which is no segment head.)
__device__ __forceinline__ bool touched(const int* __restrict__ ids_s, int s, int v) {
  int lo = 0, hi = s;
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (ids_s[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo < s && ids_s[lo] == v;
}

// The merged count at index j of [candidates | sorted batch].
__device__ __forceinline__ long long merged_key(int j, const int* __restrict__ ids_s, const long long* __restrict__ perm,
                                               const int* __restrict__ est, int s, const int* __restrict__ cand_ids,
                                               const int* __restrict__ cand_cnt, int c) {
  int cnt;
  if (j < c) {
    int cid = cand_ids[j];
    cnt = (cid < 0 || (cid < I32_MAX && touched(ids_s, s, cid))) ? -1 : cand_cnt[j];
  } else {
    int p = j - c;
    int v = ids_s[p];
    bool head = v < I32_MAX && (p == 0 || ids_s[p - 1] != v);
    cnt = head ? est[perm[p]] : -1;
  }
  return pack(cnt, j);
}

// One block: load a tile of `tn` keys (merged counts on the first pass,
// the previous pass's survivors after), sort it descending, keep its top
// C; a single-block pass decodes the final table in place.
__global__ void __launch_bounds__(TOPC_THREADS)
sf_topc(int first, int n, int tn, const long long* __restrict__ in_keys, const int* __restrict__ ids_s,
        const long long* __restrict__ perm, const int* __restrict__ est, int s, int* __restrict__ cand_ids,
        int* __restrict__ cand_cnt, int c, long long* __restrict__ out_keys) {
  extern __shared__ long long tile[];
  int base = blockIdx.x * tn;
  for (int i = threadIdx.x; i < tn; i += blockDim.x) {
    int j = base + i;
    long long k = KEY_PAD;
    if (j < n) k = first ? merged_key(j, ids_s, perm, est, s, cand_ids, cand_cnt, c) : in_keys[j];
    tile[i] = k;
  }
  __syncthreads();
  for (int k = 2; k <= tn; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < tn; i += blockDim.x) {
        int ixj = i ^ j;
        if (ixj > i) {
          long long a = tile[i], b = tile[ixj];
          bool desc = (i & k) == 0;
          if (desc ? (a < b) : (a > b)) {
            tile[i] = b;
            tile[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  if (gridDim.x > 1) {
    for (int r = threadIdx.x; r < c; r += blockDim.x) out_keys[(size_t)blockIdx.x * c + r] = tile[r];
    return;
  }
  // Final table: decode every slot into the tile's upper half (C <= tn / 2,
  // so it does not overlap the keys being read) before any write, since the
  // table's old ids are inputs; then write in place.
  int2* dec = reinterpret_cast<int2*>(tile + c);
  for (int r = threadIdx.x; r < c; r += blockDim.x) {
    long long key = tile[r];
    int cnt = (int)(key >> 32);
    int index = (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFLL));
    int id = -1;
    if (cnt >= 0) id = index < c ? cand_ids[index] : ids_s[index - c];
    dec[r] = make_int2(id, cnt >= 0 ? cnt : 0);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < c; r += blockDim.x) {
    cand_ids[r] = dec[r].x;
    cand_cnt[r] = dec[r].y;
  }
}

inline int blocks(long long n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// Steps 1-3: decay, adds, estimates and sort keys. est and key are [S].
int sketch_fold_adds(int* cm, int depth, int width, int* cand_cnt, int c, int decay, const int* ids, const int* w,
                     int s, int* est, int* key, cudaStream_t stream) {
  if (decay) {
    long long n_cm = (long long)depth * width;
    long long need = n_cm > c ? n_cm : c;
    int nb = blocks(need);
    if (nb > 4096) nb = 4096;  // grid-stride over the rest
    if (nb < blocks(c)) nb = blocks(c);
    sf_decay<<<nb, THREADS, 0, stream>>>(cm, n_cm, cand_cnt, c);
  }
  sf_add<<<blocks((long long)s * depth), THREADS, 0, stream>>>(ids, w, s, depth, width, cm);
  sf_estimate<<<blocks(s), THREADS, 0, stream>>>(ids, s, depth, width, cm, est, key);
  return (int)cudaGetLastError();
}

// Step 4 on the sorted keys: top-C passes over tiles of `tn` keys (a power
// of two in [4096, 16384], at least 2C) until one tile is left; the last
// pass writes the candidate table. buf_a and buf_b hold ceil((C + S) / tn)
// * C keys each.
int sketch_fold_topc(const int* ids_s, const long long* perm, const int* est, int s, int* cand_ids, int* cand_cnt,
                     int c, int tn, long long* buf_a, long long* buf_b, cudaStream_t stream) {
  if (c < 1 || tn < TOPC_TILE_MIN || tn > TOPC_TILE_MAX || (tn & (tn - 1)) || 2 * c > tn)
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)tn * sizeof(long long);
  cudaError_t attr = cudaFuncSetAttribute(sf_topc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  int n = c + s;
  int first = 1;
  const long long* in = nullptr;
  long long* out = buf_a;
  while (true) {
    int tiles = (n + tn - 1) / tn;
    sf_topc<<<tiles, TOPC_THREADS, smem, stream>>>(first, n, tn, in, ids_s, perm, est, s, cand_ids, cand_cnt, c,
                                                    out);
    int err = (int)cudaGetLastError();
    if (err != 0 || tiles == 1) return err;
    first = 0;
    n = tiles * c;
    in = out;
    out = out == buf_a ? buf_b : buf_a;
  }
}

}  // extern "C"
