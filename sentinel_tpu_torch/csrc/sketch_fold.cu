// K11, the sketch tier's fold for Hopper (sm_90a): the port of the jitted
// sentinel_tpu/runtime/sketch.py:sketch_fold.
//
// Per flush, for a count-min array cm [D, W] (D <= 8, W a power of two), a
// candidate table (ids, counts) [C] and a batch of S (id, weight) pairs
// (id -1 = padding):
//   1. with `decay`, cm >>= 1 and counts >>= 1 (arithmetic, int32);
//   2. cm[d][h_d(id)] += w for every valid pair and row (integer atomics,
//      wrapping in int32 as XLA's scatter-add does);
//   3. after every add of the batch, each distinct valid id's estimate
//      min_d cm[d][h_d(id)];
//   4. the table becomes the top C of [candidates | distinct ids], ranked
//      as lax.top_k ranks JAX's merge: count descending, then index. A
//      candidate the batch touches, or an empty slot, ranks as -1.
//
// No sort is needed for 4. Every candidate index is below every batch
// index, and among the batch's heads index order is id order, so one
// 64-bit key per entry orders them, from the high bits: the count with its
// sign bit flipped, then 0xFFFFFFFF - j for candidate j or 0x7FFFFFFF - id
// for a batch id. Keys are distinct, and duplicate ids carry equal
// estimates, so a duplicate is dropped by dedupe alone. Entries with a
// negative count come out as (-1, 0) wherever they rank, so only counts
// >= 0 are keyed (a key is then never 0), and slots past them are -1 / 0.
// The id 2^31 - 1 is added into the count-min but is never a head: JAX
// keys padding as I32_MAX.
//
// One C call, sketch_fold, per fold (runtime/sketch.py), its arguments in
// one SfArgs:
// - S <= small_max keys (at most SMALL_CAP), C + S <= SMALL_KEYS and, with
//   decay, D * W <= SMALL_DECAY_CELLS: one launch of one block of 1,024
//   threads (sf_small). It halves, adds, and after a barrier reads the
//   estimates with __ldcg (L1 is not coherent with the block's own L2
//   atomics); dedupe and the candidate-touch test go through one
//   shared-memory hash of the batch's ids; the keys are selected and sorted
//   in shared memory and the table is written in place.
// - otherwise: sf_decay (with decay), sf_add and sf_select. sf_add: each
//   valid id's adds (warp-combined by id); each id below 2^31 - 1 claims a
//   cell of an open-addressing table in the caller's zeroed scratch by
//   atomicCAS (the first claim is the id's head) and probes a
//   shared-memory hash of the C candidates, flagging the touched ones in a
//   zeroed [C] array. sf_select, after the launch boundary: the heads'
//   estimates and keys, each head clearing its table cell; each block's
//   top C by a radix select in shared memory, packed into the workspace;
//   each block that selects raises a shared lower bound of the C-th key
//   (atomicMax), below which later blocks and the merge drop keys; the last
//   block to finish (a counter in the zeroed scratch, after __threadfence)
//   merges the survivors with the untouched candidates, clears the flags
//   and the counters, sorts the top C and writes the table.
// Selection is a block-wide MSB radix select over 8-bit digits (the
// digits on which every key agrees skipped), at any C up to MAX_C. The
// table's keys are sorted by a warp-shuffle network and binary-search
// merges up to 1,024 of them (a bitonic sort pays a barrier a stage),
// bitonically above.
//
// What bounds it: atomics and round trips. Per key it reads 8 B and makes
// D scattered adds; the estimates read the same D cells; the table is C *
// 8 B. Decay streams the whole array (D * W * 8 B).

#include <algorithm>

#include "bitonic.cuh"

// Everything one call reads and writes; runtime/sketch.py fills the same
// layout (_SfArgs: pointers first, then the ints).
struct SfArgs {
  int* cm;          // [depth, width], updated in place
  int* cand_ids;    // [c], rewritten
  int* cand_cnt;    // [c], rewritten
  const int* ids;   // [s], -1 = padding
  const int* w;     // [s]
  int depth, width, c, s, decay, small_max;
};

namespace {

using u64 = unsigned long long;
constexpr int NT = 1024;                 // threads of every block here but sf_decay's
constexpr int SMALL_CAP = 8192;          // keys sf_small can take
constexpr int SMALL_KEYS = 16384;        // C + S of sf_small: its keys in shared memory
constexpr int SMALL_DECAY_CELLS = 65536; // count-min cells one block halves
constexpr int MAX_C = 8192;              // candidates
constexpr int BUF_MAX = 2 * MAX_C;       // keys in sf_select's shared memory
constexpr int MAX_IPT = 8;               // items a thread of sf_select takes
constexpr int LOAD_UNROLL = 4;           // survivors a thread of the merge loads at once
constexpr int SEL_PER_THREAD = BUF_MAX / NT;
constexpr int I32_MAX = 0x7fffffff;
constexpr unsigned BIAS = 0x80000000u;

// Per-depth-row seeds: runtime/sketch.py _SEEDS.
__constant__ uint32_t SEEDS[8] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du, 0x27D4EB2Fu,
                                  0x165667B1u, 0xD3A2646Du, 0xFD7046C5u, 0xB55A4F09u};

__device__ __forceinline__ int cm_cell(const SfArgs& a, int id, int d) {
  uint32_t h = ((uint32_t)id ^ SEEDS[d]) * 2654435761u;
  h ^= h >> 15;
  return d * a.width + (int)(h & (uint32_t)(a.width - 1));
}

// Slot of an id in an open-addressing table of 2^bits cells.
__device__ __forceinline__ unsigned tab_slot(int id, int bits) {
  return ((uint32_t)id * 0x9E3779B1u) >> (32 - bits);
}

__device__ __forceinline__ u64 head_key(int est, int id) {
  return ((u64)((unsigned)est ^ BIAS) << 32) | (0x7FFFFFFFu - (unsigned)id);
}
__device__ __forceinline__ u64 cand_key(int cnt, int j) {
  return ((u64)((unsigned)cnt ^ BIAS) << 32) | (0xFFFFFFFFu - (unsigned)j);
}

// The adds of item i, with id `id` (-1: none), into `cm` (the count-min
// array or a block's copy of it; all lanes of the warp call it): lanes
// with the same id add their weights' wrapping sum once per row. True in
// the lane that added for its id.
__device__ __forceinline__ bool add_item(const SfArgs& a, int i, int id, int* cm) {
  const bool act = id >= 0;
  const unsigned am = __ballot_sync(FULL_MASK, act);
  if (!act) return false;
  const unsigned grp = __match_any_sync(am, id);
  const unsigned sum = __reduce_add_sync(grp, (unsigned)a.w[i]);
  if ((threadIdx.x & 31) != __ffs(grp) - 1) return false;
  for (int d = 0; d < a.depth; ++d) atomicAdd(&cm[cm_cell(a, id, d)], (int)sum);
  return true;
}

template <bool COHERENT>
__device__ __forceinline__ int estimate(const SfArgs& a, int id) {
  int e = I32_MAX;
  for (int d = 0; d < a.depth; ++d) {
    const int* p = &a.cm[cm_cell(a, id, d)];
    e = min(e, COHERENT ? __ldcg(p) : *p);
  }
  return e;
}

// Claims id in a table of 2^bits int cells holding id + 1 (0 empty): true
// for the first claim. id is in [0, 2^31 - 1).
__device__ __forceinline__ bool claim(int* tab, int bits, int id, unsigned& slot) {
  const unsigned mask = (1u << bits) - 1;
  for (slot = tab_slot(id, bits);; slot = (slot + 1) & mask) {
    const int old = atomicCAS(&tab[slot], 0, id + 1);
    if (old == 0) return true;
    if (old == id + 1) return false;
  }
}

__device__ __forceinline__ bool in_table(const int* tab, int bits, int id) {
  const unsigned mask = (1u << bits) - 1;
  for (unsigned slot = tab_slot(id, bits);; slot = (slot + 1) & mask) {
    const int v = tab[slot];
    if (v == 0) return false;
    if (v == id + 1) return true;
  }
}

int bits_of(int p2) {  // log2 of a power of two
  int b = 0;
  while ((1 << b) < p2) ++b;
  return b;
}

int pow2_at_least(long long v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// ---------------------------------------------------------------------------
// block-wide selection and the final table
// ---------------------------------------------------------------------------

struct SelShared {
  int hist[256];
  int n;
  int digit, above;
  u64 diff;
};

// Appends `key` to buf where `has` (a slot taken from *n, one atomic per
// warp). All lanes of the warp call it.
__device__ __forceinline__ void append(u64* buf, int* n, bool has, u64 key) {
  const unsigned m = __ballot_sync(FULL_MASK, has);
  if (!m) return;
  const int lane = threadIdx.x & 31, lead = __ffs(m) - 1;
  int base = 0;
  if (lane == lead) base = atomicAdd(n, __popc(m));
  base = __shfl_sync(FULL_MASK, base, lead);
  if (has) buf[base + __popc(m & ((1u << lane) - 1))] = key;
}

// Moves the c largest of the n (> c) distinct keys in buf to buf[0, c), in
// no order: an MSB radix select over 8-bit digits, from the highest digit
// on which the keys differ. Returns a lower bound of the c-th largest key
// (its digits down to the last one resolved). All threads of the block
// call it.
__device__ u64 select_top(u64* buf, int n, int c, SelShared& sh) {
  const int lane = threadIdx.x & 31;
  const u64 first = buf[0];
  if (threadIdx.x == 0) sh.diff = 0;
  __syncthreads();
  u64 diff = 0;
  for (int i = threadIdx.x; i < n; i += NT) diff |= buf[i] ^ first;
  const unsigned lo = __reduce_or_sync(FULL_MASK, (unsigned)diff), hi = __reduce_or_sync(FULL_MASK, (unsigned)(diff >> 32));
  if (lane == 0 && (lo | hi)) atomicOr(&sh.diff, ((u64)hi << 32) | lo);
  __syncthreads();
  int shift = sh.diff ? (63 - __clzll((long long)sh.diff)) / 8 * 8 : 0;
  u64 mask = shift + 8 >= 64 ? 0 : ~0ull << (shift + 8);
  u64 prefix = first & mask;
  int need = c;
  for (; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += NT) sh.hist[b] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += NT) {
      const int i = base + threadIdx.x;
      const u64 k = i < n ? buf[i] : 0;
      const bool act = i < n && (k & mask) == prefix;
      const unsigned am = __ballot_sync(FULL_MASK, act);
      if (act) {
        const unsigned dg = (unsigned)(k >> shift) & 255u;
        const unsigned grp = __match_any_sync(am, dg);
        if (lane == __ffs(grp) - 1) atomicAdd(&sh.hist[dg], __popc(grp));
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // lane l holds bins 255 - 8l down to 248 - 8l
      int part = 0;
      for (int q = 0; q < 8; ++q) part += sh.hist[255 - 8 * lane - q];
      int incl = part;
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(FULL_MASK, incl, off);
        if (lane >= off) incl += o;
      }
      const unsigned hit = __ballot_sync(FULL_MASK, incl >= need);
      if (lane == __ffs(hit) - 1) {
        int above = incl - part;
        int bin = 255 - 8 * lane;
        while (above + sh.hist[bin] < need) above += sh.hist[bin--];
        sh.digit = bin;
        sh.above = above;
      }
    }
    __syncthreads();
    const int dg = sh.digit;
    need -= sh.above;
    prefix |= (u64)dg << shift;
    mask |= 0xFFull << shift;
    const bool done = sh.hist[dg] == need;  // every key of the bin is in
    __syncthreads();
    if (done) break;
  }
  // Keep the keys at or above the prefix: exactly c of them.
  u64 mine[SEL_PER_THREAD];
#pragma unroll
  for (int q = 0; q < SEL_PER_THREAD; ++q) {
    const int i = threadIdx.x + q * NT;
    mine[q] = i < n ? buf[i] : 0;
  }
  if (threadIdx.x == 0) sh.n = 0;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < SEL_PER_THREAD; ++q)
    append(buf, &sh.n, threadIdx.x + q * NT < n && (mine[q] & mask) >= prefix, mine[q]);
  __syncthreads();
  return prefix;
}

// Sorts the n (<= NT) distinct keys of buf descending, one a thread: each
// warp sorts 32 in registers (a bitonic network over shuffles), then runs
// of 32, 64, ... merge: a key's place in its merged run is its place in
// its own run plus the number of keys above it in the other run (a binary
// search). Leaves ~key in buf, as write_table reads it. All threads call
// it.
__device__ void sort_desc_small(u64* buf, int n) {
  int p = 32;
  while (p < n) p <<= 1;
  const int i = threadIdx.x, lane = i & 31;
  u64 v = i < n ? buf[i] : 0;  // 0 pads: below every key
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const u64 o = __shfl_xor_sync(FULL_MASK, v, j);
      const bool keep_max = ((lane & j) == 0) == ((lane & k) == 0);
      v = keep_max ? (o > v ? o : v) : (o < v ? o : v);
    }
  for (int w = 32; w < p; w <<= 1) {
    __syncthreads();
    if (i < p) buf[i] = v;
    __syncthreads();
    int pos = 0;
    if (i < p) {
      const int run = i / w;
      const u64* other = buf + (run ^ 1) * w;
      int lo = 0, hi = w;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (other[mid] > v) lo = mid + 1; else hi = mid;
      }
      pos = (run & ~1) * w + (i - run * w) + lo;
    }
    __syncthreads();
    if (i < p) buf[pos] = v;
    __syncthreads();
    if (i < p) v = buf[i];
  }
  __syncthreads();
  if (i < n) buf[i] = ~v;
}

// Sorts the n (<= c) keys of buf descending and writes the table: slot r
// the entry of the r-th key, -1 / 0 past n. Up to NT keys by
// sort_desc_small; more bitonically, complemented, in the power of two
// above n, which buf holds. Reads the old candidate ids before any write.
__device__ void write_table(const SfArgs& a, u64* buf, int n) {
  if (n <= NT) {
    sort_desc_small(buf, n);
  } else {
    int p = 1;
    while (p < n) p <<= 1;
    for (int i = threadIdx.x; i < p; i += NT) buf[i] = i < n ? ~buf[i] : SENTINEL;  // descending, 0 pads last
    __syncthreads();
    bitonic_sort(buf, p);
  }
  __syncthreads();
  int2 out[MAX_C / NT];
#pragma unroll
  for (int q = 0; q < MAX_C / NT; ++q) {
    const int r = threadIdx.x + q * NT;
    out[q] = make_int2(-1, 0);
    if (r < n) {
      const u64 key = ~buf[r];
      const unsigned low = (unsigned)key;
      const int cnt = (int)((unsigned)(key >> 32) ^ BIAS);
      out[q] = make_int2(low >= BIAS ? a.cand_ids[0xFFFFFFFFu - low] : (int)(0x7FFFFFFFu - low), cnt);
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < MAX_C / NT; ++q) {
    const int r = threadIdx.x + q * NT;
    if (r < a.c) {
      a.cand_ids[r] = out[q].x;
      a.cand_cnt[r] = out[q].y;
    }
  }
}

// The key of candidate j if it competes: a valid id the batch did not
// touch, with a count (halved under decay) >= 0.
__device__ __forceinline__ bool candidate(const SfArgs& a, int j, bool touched, u64& key) {
  const int cid = a.cand_ids[j];
  const int cnt = a.decay ? a.cand_cnt[j] >> 1 : a.cand_cnt[j];
  key = cand_key(cnt, j);
  return cid >= 0 && cnt >= 0 && !touched;
}

// ---------------------------------------------------------------------------
// one block
// ---------------------------------------------------------------------------

// Dynamic shared memory: nbuf keys, then the batch's id table (2^bits
// ints).
__global__ void __launch_bounds__(NT) sf_small(SfArgs a, int nbuf, int bits) {
  extern __shared__ u64 sf_key[];
  int* tab = reinterpret_cast<int*>(sf_key + nbuf);
  __shared__ SelShared sh;
  if (a.decay)
    for (int i = threadIdx.x; i < a.depth * a.width; i += NT) a.cm[i] >>= 1;
  for (int i = threadIdx.x; i < (1 << bits); i += NT) tab[i] = 0;
  if (threadIdx.x == 0) sh.n = 0;
  __syncthreads();
  unsigned heads = 0;  // bit q: item threadIdx.x + q * NT is its id's head
  for (int q = 0; q * NT < a.s; ++q) {
    const int i = threadIdx.x + q * NT;
    const int id = i < a.s ? a.ids[i] : -1;
    add_item(a, i, id, a.cm);
    unsigned slot;
    if (id >= 0 && id < I32_MAX && claim(tab, bits, id, slot)) heads |= 1u << q;
  }
  __syncthreads();  // every add and claim before an estimate or a probe
  for (int q = 0; q * NT < a.s; ++q) {
    const bool head = (heads >> q) & 1;
    const int id = head ? a.ids[threadIdx.x + q * NT] : 0;
    const int est = head ? estimate<true>(a, id) : -1;
    append(sf_key, &sh.n, est >= 0, head_key(est, id));
  }
  for (int j0 = 0; j0 < a.c; j0 += NT) {
    const int j = j0 + threadIdx.x;
    const int cid = j < a.c ? a.cand_ids[j] : -1;
    u64 key = 0;
    const bool has = j < a.c && candidate(a, j, cid >= 0 && cid < I32_MAX && in_table(tab, bits, cid), key);
    append(sf_key, &sh.n, has, key);
  }
  __syncthreads();
  int n = sh.n;
  if (n > a.c) {
    select_top(sf_key, n, a.c, sh);
    n = a.c;
  }
  write_table(a, sf_key, n);
}

// ---------------------------------------------------------------------------
// many blocks
// ---------------------------------------------------------------------------

__global__ void sf_decay(int* __restrict__ cm, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n4 = ((uintptr_t)cm & 15) ? 0 : n / 4;  // int4 where the array is 16-byte aligned
  int4* v = reinterpret_cast<int4*>(cm);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    int4 x = v[i];
    v[i] = make_int4(x.x >> 1, x.y >> 1, x.z >> 1, x.w >> 1);
  }
  for (long long i = 4 * n4 + (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) cm[i] >>= 1;
}

// Scratch of the many-block route. Zeroed: the id table (2^bits ints), the
// touched flags [C], and Ctl. Workspace: each item's table cell (or -1 if
// not a head), the blocks' survivors, packed.
struct Plan {
  int bits, ipt, nb, per_block, buf;  // sf_select: items per thread, blocks, survivors per block, keys in smem
  size_t tab, touched, ctl, zero_total;
  size_t slot, surv, ws_total;
};

// sf_select's counters in the zeroed scratch: blocks done, survivors
// written, and the largest lower bound of the C-th key that a block found
// (every key below it is out).
struct Ctl {
  int done, n_surv;
  u64 bound;
};

Plan plan(int s, int c) {
  Plan p;
  p.bits = bits_of(pow2_at_least(2ll * s));
  const int ids_per_block = std::min(std::max(pow2_at_least(32ll * c), 2048), MAX_IPT * NT);
  p.ipt = ids_per_block / NT;
  p.nb = (s + ids_per_block - 1) / ids_per_block;
  p.per_block = std::min(c, ids_per_block);
  p.buf = c > 256 ? BUF_MAX : std::max(8192, c + p.per_block);  // the merge's chunks: C and the survivors
  p.tab = 0;
  p.touched = align256(sizeof(int) * ((size_t)1 << p.bits));
  p.ctl = p.touched + align256(sizeof(int) * (size_t)c);
  p.zero_total = p.ctl + align256(sizeof(Ctl));
  p.slot = 0;
  p.surv = align256(sizeof(int) * (size_t)s);
  p.ws_total = p.surv + align256(sizeof(u64) * (size_t)p.nb * p.per_block);
  return p;
}

// The adds and claims; dynamic shared memory: the candidates' hash (2^cbits
// ints, -1 empty; bit 31 set once the batch touches the id).
__global__ void __launch_bounds__(NT) sf_add(SfArgs a, int* tab, int bits, int* __restrict__ slot_of,
                                             int* __restrict__ touched, int cbits) {
  extern __shared__ int ctab[];
  __shared__ int any;
  const int hs = 1 << cbits;
  const unsigned cmask = hs - 1;
  for (int i = threadIdx.x; i < hs; i += NT) ctab[i] = -1;
  if (threadIdx.x == 0) any = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < a.c; j += NT) {
    const int cid = a.cand_ids[j];
    if (cid < 0 || cid == I32_MAX) continue;
    for (unsigned sl = tab_slot(cid, cbits);; sl = (sl + 1) & cmask) {
      const int old = atomicCAS(&ctab[sl], -1, cid);
      if (old == -1 || old == cid) break;
    }
  }
  __syncthreads();
  const int i = blockIdx.x * NT + threadIdx.x;
  const int id = i < a.s ? a.ids[i] : -1;
  // The lane that added for the lanes with its id claims for them all.
  const bool lead = add_item(a, i, id, a.cm);
  int out = -1;
  unsigned sl;
  if (lead && id < I32_MAX && claim(tab, bits, id, sl)) out = (int)sl;
  if (id >= 0 && id < I32_MAX) {
    for (unsigned cs = tab_slot(id, cbits);; cs = (cs + 1) & cmask) {
      const int v = ctab[cs];
      if (v == -1) break;
      if ((v & I32_MAX) == id) {
        if (v >= 0) atomicOr(&ctab[cs], (int)BIAS);
        any = 1;
        break;
      }
    }
  }
  if (i < a.s) slot_of[i] = out;
  __syncthreads();
  if (!any) return;
  for (int j = threadIdx.x; j < a.c; j += NT) {
    const int cid = a.cand_ids[j];
    if (cid < 0 || cid == I32_MAX) continue;
    for (unsigned sl2 = tab_slot(cid, cbits);; sl2 = (sl2 + 1) & cmask) {
      const int v = ctab[sl2];
      if ((v & I32_MAX) == cid) {
        if (v < 0) touched[j] = 1;
        break;
      }
    }
  }
}

// The heads' estimates and keys (each head clears its table cell), each
// block's top C, and in the last block the merge and the table. A block
// that selects publishes a lower bound of its C-th key (atomicMax): no key
// below any block's bound is in the table, so later blocks and the merge
// drop such keys. Dynamic shared memory: p.buf keys.
__global__ void __launch_bounds__(NT) sf_select(SfArgs a, Plan p, int* tab, const int* __restrict__ slot_of,
                                                int* touched, Ctl* ctl, u64* surv) {
  extern __shared__ u64 sel_key[];
  __shared__ SelShared sh;
  __shared__ int s_off;
  __shared__ bool last;
  if (threadIdx.x == 0) sh.n = 0;
  __syncthreads();
  u64 bound = __ldcg(&ctl->bound);
  const int base = blockIdx.x * p.ipt * NT;
  int id[MAX_IPT], est[MAX_IPT];
#pragma unroll
  for (int q = 0; q < MAX_IPT; ++q) {  // every item's loads before the first use
    const int i = base + q * NT + threadIdx.x;
    const int sl = q < p.ipt && i < a.s ? slot_of[i] : -1;
    id[q] = sl >= 0 ? a.ids[i] : -1;
    if (sl >= 0) tab[sl] = 0;
  }
#pragma unroll
  for (int q = 0; q < MAX_IPT; ++q) est[q] = id[q] >= 0 ? estimate<false>(a, id[q]) : -1;
#pragma unroll
  for (int q = 0; q < MAX_IPT; ++q) {
    const u64 key = head_key(est[q], id[q]);
    append(sel_key, &sh.n, est[q] >= 0 && key >= bound, key);
  }
  __syncthreads();
  int n = sh.n;
  if (n > a.c) {
    const u64 mine = select_top(sel_key, n, a.c, sh);
    n = a.c;
    if (threadIdx.x == 0) atomicMax(&ctl->bound, mine);
  }
  if (threadIdx.x == 0) s_off = atomicAdd(&ctl->n_surv, n);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += NT) surv[s_off + i] = sel_key[i];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&ctl->done, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The last block: the untouched candidates, then the survivors, each
  // above the final bound, in chunks of what shared memory holds.
  bound = __ldcg(&ctl->bound);
  const int total = __ldcg(&ctl->n_surv);
  if (threadIdx.x == 0) sh.n = 0;
  __syncthreads();
  if (threadIdx.x == 0) *ctl = Ctl{0, 0, 0};
  for (int j0 = 0; j0 < a.c; j0 += NT) {
    const int j = j0 + threadIdx.x;
    const bool t = j < a.c && touched[j] != 0;
    if (t) touched[j] = 0;
    u64 key = 0;
    const bool has = j < a.c && candidate(a, j, t, key);
    append(sel_key, &sh.n, has && key >= bound, key);
  }
  __syncthreads();
  n = sh.n;
  for (int from = 0; from < total;) {
    const int take = min(p.buf - n, total - from);
    for (int i0 = 0; i0 < take; i0 += LOAD_UNROLL * NT) {
      u64 key[LOAD_UNROLL];  // the loads in flight together
#pragma unroll
      for (int u = 0; u < LOAD_UNROLL; ++u) {
        const int i = i0 + u * NT + threadIdx.x;
        key[u] = i < take ? __ldcg(&surv[from + i]) : 0;
      }
#pragma unroll
      for (int u = 0; u < LOAD_UNROLL; ++u) append(sel_key, &sh.n, key[u] >= bound && key[u] != 0, key[u]);
    }
    __syncthreads();
    n = sh.n;
    from += take;
    if (from < total && n > a.c) {
      select_top(sel_key, n, a.c, sh);
      n = a.c;
    }
  }
  if (n > a.c) {
    select_top(sel_key, n, a.c, sh);
    n = a.c;
  }
  write_table(a, sel_key, n);
}

bool small_route(const SfArgs& a) {
  return a.s <= a.small_max && a.c + a.s <= SMALL_KEYS &&
         (!a.decay || (long long)a.depth * a.width <= SMALL_DECAY_CELLS);
}

}  // namespace

extern "C" {

// Bytes of workspace (out[0]) and of the zeroed scratch (out[1]) one fold
// needs (both 0 for the one-block route).
void sketch_fold_scratch(const SfArgs* args, long long* out) {
  const SfArgs a = *args;
  if (a.s <= 0 || small_route(a)) {
    out[0] = out[1] = 0;
    return;
  }
  const Plan p = plan(a.s, a.c);
  out[0] = (long long)p.ws_total;
  out[1] = (long long)p.zero_total;
}

// One fold (see the header); `args` is read on the host. Returns a CUDA
// error code, or -1 when the workspace or the zeroed bytes are short (no
// launch). The zeroed bytes are zero again when the call returns, also
// after a failed launch.
int sketch_fold(const SfArgs* args, void* workspace, long long workspace_bytes, void* zero, long long zero_bytes,
                cudaStream_t stream) {
  const SfArgs a = *args;
  if (a.s <= 0) return 0;
  if (a.depth < 1 || a.depth > 8 || a.width < 1 || (a.width & (a.width - 1)) || a.c < 1 || a.c > MAX_C ||
      a.s >= (1 << 28) || a.small_max < 0 || a.small_max > SMALL_CAP)
    return (int)cudaErrorInvalidValue;
  if (small_route(a)) {
    const int nbuf = std::max(a.c + a.s, pow2_at_least(a.c));
    const int bits = bits_of(pow2_at_least(2ll * a.s));
    const size_t smem = sizeof(u64) * (size_t)nbuf + sizeof(int) * ((size_t)1 << bits);
    const int err = dyn_smem_once<sf_small>(smem, (int)(sizeof(u64) * SMALL_KEYS + sizeof(int) * 2 * SMALL_CAP));
    if (err) return err;
    sf_small<<<1, NT, smem, stream>>>(a, nbuf, bits);
    return (int)cudaGetLastError();
  }
  const Plan p = plan(a.s, a.c);
  if (workspace == nullptr || zero == nullptr || workspace_bytes < (long long)p.ws_total ||
      zero_bytes < (long long)p.zero_total)
    return -1;
  char* ws = (char*)workspace;
  char* z = (char*)zero;
  const int cbits = bits_of(pow2_at_least(2ll * a.c));
  const size_t add_smem = sizeof(int) * ((size_t)1 << cbits);
  int err = dyn_smem_once<sf_add>(add_smem, (int)(sizeof(int) * 2 * MAX_C));
  if (!err) err = dyn_smem_once<sf_select>(sizeof(u64) * (size_t)p.buf, (int)(sizeof(u64) * BUF_MAX));
  if (err) return err;
  if (a.decay) {
    const long long n = (long long)a.depth * a.width;
    const int nb = (int)std::min<long long>(std::max<long long>((n / 4 + 255) / 256, 1), 4096);
    sf_decay<<<nb, 256, 0, stream>>>(a.cm, n);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  sf_add<<<(a.s + NT - 1) / NT, NT, add_smem, stream>>>(a, (int*)(z + p.tab), p.bits, (int*)(ws + p.slot),
                                                        (int*)(z + p.touched), cbits);
  err = (int)cudaGetLastError();
  if (!err) {
    sf_select<<<p.nb, NT, sizeof(u64) * (size_t)p.buf, stream>>>(a, p, (int*)(z + p.tab), (int*)(ws + p.slot),
                                                                (int*)(z + p.touched), (Ctl*)(z + p.ctl),
                                                                (u64*)(ws + p.surv));
    err = (int)cudaGetLastError();
  }
  if (err) cudaMemsetAsync(zero, 0, p.zero_total, stream);  // sf_add may have claimed and flagged
  return err;
}

}  // extern "C"
