// The sharded step's budget math for Hopper (sm_90a), all shards of one
// device:
//
// K15 mesh_split_spend: sentinel_tpu/parallel/ici.py:_split_and_spend with
//     the cap prologues of _demote_over_grant (the flow budget) and
//     _demote_over_borrow (the occupy borrow budget), and cluster_allocate's
//     prefix. Per shard and check row, the demand of the participating
//     slots; the cross-shard exclusive prefix `before`; within the shard,
//     the row's charge spent in (ts, arrival) order, its prefix taken over
//     the shard's own slots as each chip takes it (segment_excl_cumsum, a
//     wrapping cumsum minus the running max of its group-start values,
//     restarting at the shard's first sorted position); a slot is kept iff
//     before + its prefix + acquire <= its own cap, an entry iff every
//     participating slot is kept.
// K16 mesh_shaping_charge: the global shaping charge of
//     ici.py:_global_shaping_scan: over every valid global shaping item
//     (liveness-unmasked), in (row, ts, item) order, the acquire of the
//     earlier entries of the row (an entry's contribution sits at its last
//     item of the row), plus the row's windowed PASS, back in item order.
//
// K15 is one C call, mesh_split, per demotion (parallel/ici.py), its
// arguments in one MsArgs. The demand per (shard, row) is summed into the
// caller's zeroed buffer (D x R int32) with atomicAdd and read back for
// `before`; the call zeroes the cells it touched before it ends. Two routes:
// - nk <= small_max slots (at most SMALL_CAP): one launch of one block of
//   1,024 threads:
//   each slot's mask, unit, cap, demand and sort key, a bitonic sort of
//   (key, position) pairs in shared memory, then a warp per shard the
//   prefix (warp scans, 32 slots at a time, the running sum and max
//   carried in registers) and the decisions, then the cells zeroed;
// - more slots: ms_prep (mask, unit, cap, demand, keys, keep = 1, the
//   look-back state), one CUB radix sort of (key, position) pairs with
//   end_bit 32 + bits(D (R + 1)), ms_decide (single pass: the tiles of a
//   shard form one decoupled look-back chain carrying JAX's wrapping sum
//   and running max, so the prefix restarts at every shard; a slot that
//   fails writes keep = 0 for its entry), ms_clear (each group's cell back
//   to zero). The sort key is ((shard (R + 1) + row|R) << 32) | (ts ^ 2^31):
//   shard d fills sorted positions [d nk/D, (d + 1) nk/D).
// K16: msc_prep (key (row|R) << 32 | ts ^ 2^31), torch.sort, msc_flags,
// scan_*, msc_decide.
//
// What bounds them: launches and the sort for the batches the mesh sends.
// K15 reads per slot its gid, check row, entry ts, acquire and masks
// (about 18 B) and the row's window (B buckets of start and PASS) or gauge
// or slab; the sort moves 12 B per slot a pass; the demand is D x R int32,
// touched at one cell per slot and read at D - 1 cells per masked slot.
// K16 reads 17 B per item and the row's window.
//
// Numerics as the JAX code: int32 sums wrap (uint32 adds), the caps are
// float32 (IEEE division and multiplication, floorf, no fast math) and
// convert with XLA's saturating truncation (__float2int_rz).

#include <cub/device/device_radix_sort.cuh>

#include "bitonic.cuh"
#include "lookback.cuh"

// Everything one K15 call reads and writes; parallel/ici.py fills the same
// layout (pointers first, then the ints, then the float). At file scope, so
// that the C entry point taking it keeps external linkage.
struct MsArgs {
  const int* gid;           // [n * k] rule ids
  const int* crow;          // [n * k] check rows
  const uint8_t* e_valid;   // [n]
  const int* e_ts;
  const int* e_acq;
  const uint8_t* live;      // grant: [n] the budgeted entries
  const uint8_t* occ_slot;  // borrow: [n * k] the borrowing slots
  const int* f_grade;       // [nr]
  const float* f_count;
  const int* f_behavior;
  const int* sec_counts;    // grant: the second window [R, B, NE], [R, B]
  const int* sec_ws;
  const int* threads;       // grant: [R] the thread gauge
  const int* fpass;         // borrow: the future slab [R, slab_b]
  const int* fws;
  int* demand;              // [D * R] zero on entry and on return
  uint8_t* keep;            // [n] out
  int grant, n, k, n_shards, n_rows, nr, nb, ne, interval_ms, slab_b, now, small_max;
  float interval_sec;
};

namespace {

constexpr int FLOW_GRADE_QPS = 1;  // models/constants.py
constexpr int CONTROL_BEHAVIOR_DEFAULT = 0;
constexpr int EVENT_PASS = 0;  // metrics/events.py

struct Window {  // the second window (metric_array.MetricArrayState)
  const int* counts;  // [R, B, NE]
  const int* ws;      // [R, B]
  int nb, ne, interval_ms;
};

// window_sums (metric_array.py) of one row's PASS at `now`: the buckets
// with now - ws <= interval, in wrapping int32.
__device__ __forceinline__ int pass_sum(const Window& w, int row, int now) {
  int s = 0;
  for (int b = 0; b < w.nb; ++b) {
    int64_t c = (int64_t)row * w.nb + b;
    if (wrap_sub(now, w.ws[c]) <= w.interval_ms) s = wrap_add(s, w.counts[c * w.ne + EVENT_PASS]);
  }
  return s;
}

__device__ __forceinline__ long long sort_key(int hi, int ts) {
  return (long long)hi * 4294967296LL + (long long)(unsigned)(ts ^ (int)0x80000000u);
}

__device__ __forceinline__ int key_hi(long long key) { return (int)(key >> 32); }

constexpr int SMALL_CAP = 8192;  // slots the one-block route can take
constexpr int SMALL_THREADS = 1024;  // the one-block route's block

// One slot's participation, budget unit and cap (the prologues of the two
// demotions), and its shard.
struct Slot {
  bool m;
  int unit, cap, shard, rc;
};

__device__ __forceinline__ Slot slot_of(const MsArgs& a, int p) {
  const int e = p / a.k;
  const int g = a.gid[p], row = a.crow[p];
  const int gc = clampi(g, 0, a.nr - 1);
  Slot s;
  s.rc = clampi(row, 0, a.n_rows - 1);
  s.shard = p / (a.n * a.k / a.n_shards);
  const int acq = a.e_acq[e];
  float cap;
  if (a.grant) {
    bool is_qps = a.f_grade[gc] == FLOW_GRADE_QPS;
    s.m = g >= 0 && row >= 0 && a.e_valid[e] && a.live[e] && a.f_behavior[gc] == CONTROL_BEHAVIOR_DEFAULT;
    s.unit = is_qps ? acq : 1;
    const Window w{a.sec_counts, a.sec_ws, a.nb, a.ne, a.interval_ms};
    float base = is_qps ? floorf(__fdiv_rn(__int2float_rn(pass_sum(w, s.rc, a.now)), a.interval_sec))
                        : __int2float_rn(a.threads[s.rc]);
    cap = __fsub_rn(floorf(a.f_count[gc]), base);
  } else {
    s.m = a.occ_slot[p];
    s.unit = acq;
    int waiting = 0;  // waiting_tokens (nodes.py): tokens of still-future windows
    for (int b = 0; b < a.slab_b; ++b) {
      int64_t c = (int64_t)s.rc * a.slab_b + b;
      if (a.fws[c] > a.now) waiting = wrap_add(waiting, a.fpass[c]);
    }
    cap = __fsub_rn(floorf(__fmul_rn(a.f_count[gc], a.interval_sec)), __int2float_rn(waiting));
  }
  s.cap = __float2int_rz(fmaxf(cap, 0.0f));
  return s;
}

// A slot's sort key, its unit and cap kept by position, its demand added,
// and its entry's keep set to 1 (by the entry's first slot).
__device__ __forceinline__ u64 prep_slot(const MsArgs& a, int p, int2* uc) {
  Slot s = slot_of(a, p);
  uc[p] = make_int2(s.unit, s.cap);
  if (s.m) atomicAdd(&a.demand[(int64_t)s.shard * a.n_rows + s.rc], s.unit);
  if (p % a.k == 0) a.keep[p / a.k] = 1;
  return row_ts_key(s.shard * (a.n_rows + 1) + (s.m ? s.rc : a.n_rows), a.e_ts[p / a.k]);
}

// Shard d's row of a sorted key: n_rows for a slot that does not take part.
__device__ __forceinline__ int key_row_of(const MsArgs& a, u64 key, int d) {
  return key_row(key) - d * (a.n_rows + 1);
}

// The decision of a participating slot at position p with its prefix in
// its shard d's charge stream of row `row`: a slot that fails demotes its
// entry.
__device__ __forceinline__ void decide_slot(const MsArgs& a, int p, int d, int row, int prefix, int cap) {
  int before = 0;  // the cross-shard exclusive demand prefix
  for (int q = 0; q < d; ++q) before = wrap_add(before, a.demand[(int64_t)q * a.n_rows + row]);
  if (wrap_add(wrap_add(before, prefix), a.e_acq[p / a.k]) > cap) a.keep[p / a.k] = 0;
}

// This thread's IPT sorted positions from `base` (below `end`) of shard d,
// whose first position is `first`: the contributions and group heads, the
// prefixes (with the look-back's carries), then each participating slot
// decided. All threads of the block call it.
__device__ void decide_tile(const MsArgs& a, const u64* ks, const int* vs, const int2* uc, int d, int first,
                            int base, int end, LookBack<1>& carry) {
  int2 acq[IPT], charge[IPT];
  bool head[IPT];
  const int cnt = clampi(end - base, 0, IPT);
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    acq[j] = make_int2(0, 0);
    head[j] = false;
    if (j < cnt) {
      int i = base + j;
      head[j] = i == first || key_row(ks[i - 1]) != key_row(ks[i]);
      if (key_row_of(a, ks[i], d) < a.n_rows) acq[j].x = uc[vs[i]].x;
    }
  }
  charges<IPT, 1>(cnt, acq, head, charge, carry);
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    if (j >= cnt) continue;
    int i = base + j;
    int row = key_row_of(a, ks[i], d);
    if (row < a.n_rows) decide_slot(a, vs[i], d, row, charge[j].x, uc[vs[i]].y);
  }
}

// One warp decides shard d's sorted positions [first, end), 32 at a time:
// the wrapping sum and the running max of the group-start values by warp
// scans, their carries in registers (the one-block route).
__device__ void decide_shard_warp(const MsArgs& a, const u64* ks, const int* vs, const int2* uc, int d, int first,
                                  int end) {
  const int lane = threadIdx.x & 31;
  int run_sum = 0, run_max = INT_MIN;
  for (int c0 = first; c0 < end; c0 += 32) {
    const int i = c0 + lane;
    const bool in = i < end;
    int contrib = 0, row = a.n_rows, p = 0;
    bool head = false;
    if (in) {
      head = i == first || key_row(ks[i - 1]) != key_row(ks[i]);
      row = key_row_of(a, ks[i], d);
      p = vs[i];
      if (row < a.n_rows) contrib = uc[p].x;
    }
    int sum = contrib;  // inclusive, wrapping
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(FULL_MASK, sum, off);
      if (lane >= off) sum = wrap_add(sum, y);
    }
    const int excl = wrap_add(run_sum, wrap_sub(sum, contrib));
    int mx = head ? excl : 0;  // JAX's where(new_grp, excl, 0), then its running max
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(FULL_MASK, mx, off);
      if (lane >= off) mx = max(mx, y);
    }
    if (in && row < a.n_rows) decide_slot(a, p, d, row, wrap_sub(excl, max(run_max, mx)), uc[p].y);
    run_sum = wrap_add(run_sum, __shfl_sync(FULL_MASK, sum, 31));
    run_max = max(run_max, __shfl_sync(FULL_MASK, mx, 31));
  }
}

// ---------------------------------------------------------------------------
// one block: nk <= small_max
// ---------------------------------------------------------------------------

// Dynamic shared memory: p2 keys, p2 positions, nk (unit, cap) pairs by
// position.
__global__ void __launch_bounds__(SMALL_THREADS) ms_small(MsArgs a, int p2) {
  extern __shared__ u64 key[];
  int* val = reinterpret_cast<int*>(key + p2);
  int2* uc = reinterpret_cast<int2*>(val + p2);
  const int nk = a.n * a.k;
  for (int i = threadIdx.x; i < p2; i += SMALL_THREADS) {
    key[i] = i < nk ? prep_slot(a, i, uc) : SENTINEL;
    val[i] = i;
  }
  __syncthreads();  // the demand is summed, keep set
  bitonic_sort_pairs(key, val, p2);
  const int m = nk / a.n_shards;
  for (int d = threadIdx.x >> 5; d < a.n_shards; d += SMALL_THREADS / 32)
    decide_shard_warp(a, key, val, uc, d, d * m, (d + 1) * m);
  __syncthreads();  // every read of the demand is done
  for (int i = threadIdx.x; i < nk; i += SMALL_THREADS) {
    int d = i / m;
    int row = key_row_of(a, key[i], d);
    if (row < a.n_rows && (i == 0 || key_row(key[i - 1]) != key_row(key[i])))
      a.demand[(int64_t)d * a.n_rows + row] = 0;
  }
}

// ---------------------------------------------------------------------------
// many blocks: any nk
// ---------------------------------------------------------------------------

__global__ void ms_prep(MsArgs a, u64* __restrict__ key, int* __restrict__ val, int2* __restrict__ uc,
                        u64* __restrict__ status, int n_status, int* __restrict__ ctl) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n_status) status[p] = 0;
  if (p == 0) *ctl = 0;
  if (p < a.n * a.k) {
    key[p] = prep_slot(a, p, uc);
    val[p] = p;
  }
}

// Tile t of the sorted slots: shard t / tps, its chunk t % tps. The tiles
// of a shard form one look-back chain (status words from d * tps), so the
// prefix restarts at the shard's first position.
__global__ void __launch_bounds__(THREADS)
    ms_decide(MsArgs a, const u64* __restrict__ ks, const int* __restrict__ vs, const int2* __restrict__ uc,
              u64* status, int nt, int tps, int* ctl) {
  __shared__ int s_tile;
  if (threadIdx.x == 0) s_tile = atomicAdd(ctl, 1);
  __syncthreads();
  const int d = s_tile / tps, c = s_tile % tps;
  const int m = a.n * a.k / a.n_shards;
  LookBack<1> lb{status + (size_t)d * tps, nt, c, 0};
  decide_tile(a, ks, vs, uc, d, d * m, d * m + c * TILE + threadIdx.x * IPT, (d + 1) * m, lb);
}

// Each (shard, row) group's demand cell back to zero, by its first slot.
__global__ void ms_clear(MsArgs a, const u64* __restrict__ ks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int nk = a.n * a.k;
  if (i >= nk) return;
  const int d = i / (nk / a.n_shards);
  const int row = key_row_of(a, ks[i], d);
  if (row < a.n_rows && (i == 0 || key_row(ks[i - 1]) != key_row(ks[i])))
    a.demand[(int64_t)d * a.n_rows + row] = 0;
}

// Workspace of the many-block route: keys and positions in and out, the
// (unit, cap) pairs, two look-back walks, the tile counter, CUB's temp
// storage.
struct Layout {
  size_t key_in, key_out, val_in, val_out, uc, status, ctl, temp, total;
  int nt, tps;
};

Layout layout(int nk, int n_shards) {
  Layout l;
  l.tps = tiles_for(nk / n_shards);
  l.nt = l.tps * n_shards;
  size_t temp = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, temp, (const u64*)nullptr, (u64*)nullptr, (const int*)nullptr,
                                  (int*)nullptr, nk, 0, 64);
  size_t k8 = align256(sizeof(u64) * (size_t)nk), k4 = align256(sizeof(int) * (size_t)nk);
  l.key_in = 0;
  l.key_out = l.key_in + k8;
  l.val_in = l.key_out + k8;
  l.val_out = l.val_in + k4;
  l.uc = l.val_out + k4;
  l.status = l.uc + k8;
  l.ctl = l.status + align256(2 * sizeof(u64) * (size_t)l.nt);
  l.temp = l.ctl + 256;
  l.total = l.temp + align256(temp);
  return l;
}

bool one_block(const MsArgs& a) { return a.n * a.k <= a.small_max; }

__global__ void msc_prep(const uint8_t* __restrict__ valid, const int* __restrict__ row,
                         const int* __restrict__ ts, int s, int n_rows, long long* __restrict__ keys) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  keys[i] = sort_key(valid[i] ? row[i] : n_rows, ts[i]);
}

__global__ void msc_flags(const long long* __restrict__ key_s, const int64_t* __restrict__ perm, int s,
                          const uint8_t* __restrict__ valid, const int* __restrict__ eidx,
                          const int* __restrict__ acq, uint8_t* __restrict__ new_grp, int2* __restrict__ contrib) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s) return;
  int p = (int)perm[i];
  int rk = key_hi(key_s[i]);
  new_grp[i] = (i == 0 || key_hi(key_s[i - 1]) != rk) ? 1 : 0;
  bool last = i + 1 == s || key_hi(key_s[i + 1]) != rk || eidx[(int)perm[i + 1]] != eidx[p];
  contrib[i] = make_int2((last && valid[p]) ? acq[p] : 0, 0);
}

__global__ void msc_decide(LoadSnapshot ld, int s, int n_rows, const int2* __restrict__ partial_max,
                           const int2* __restrict__ excl, const long long* __restrict__ key_s,
                           const int64_t* __restrict__ perm, Window win, int now, int* __restrict__ ppc) {
  __shared__ int2 warp_tot[NWARPS];
  int base = blockIdx.x * TILE + threadIdx.x * IPT;
  int2 loc[IPT];
  int2 run = max_scan_prefix(ld, s, partial_max, loc, warp_tot);
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    int i = base + j;
    run = MaxOp::op(run, loc[j]);
    if (i >= s) continue;
    int row = clampi(key_hi(key_s[i]), 0, n_rows - 1);
    ppc[(int)perm[i]] = wrap_add(pass_sum(win, row, now), wrap_sub(excl[i].x, run.x));
  }
}

// Steps 5: the segmented exclusive prefix of the contributions, as two
// three-phase scans (the wrapping cumsum, then the running max of the
// group-start snapshots, whose last phase the decide kernel fuses).
void launch_scans(LoadContrib lc, LoadSnapshot ls, int n, int2* partial, int2* partial_max, int2* excl,
                  cudaStream_t st) {
  int tiles = tiles_for(n);
  scan_reduce<SumOp, LoadContrib><<<tiles, THREADS, 0, st>>>(lc, n, partial);
  scan_partials<SumOp><<<1, THREADS, 0, st>>>(partial, tiles);
  scan_apply_sum<<<tiles, THREADS, 0, st>>>(lc, n, partial, excl);
  scan_reduce<MaxOp, LoadSnapshot><<<tiles, THREADS, 0, st>>>(ls, n, partial_max);
  scan_partials<MaxOp><<<1, THREADS, 0, st>>>(partial_max, tiles);
}

}  // namespace

extern "C" {

int mesh_tiles(int n) { return tiles_for(n); }

// Bytes of workspace mesh_split needs (0 for the one-block route).
long long mesh_split_workspace(const MsArgs* args) {
  const MsArgs& a = *args;
  return one_block(a) ? 0 : (long long)layout(a.n * a.k, a.n_shards).total;
}

// K15: one demotion pass (see the header); `args` is read on the host.
// Returns a CUDA error code, or -1 when the workspace cannot hold the keys,
// positions, pairs and walks (no launch); CUB's sort refuses a remainder
// too small for its own storage, after ms_prep.
int mesh_split(const MsArgs* args, void* workspace, long long workspace_bytes, cudaStream_t stream) {
  const MsArgs a = *args;
  const long long nk = (long long)a.n * a.k;
  if (nk <= 0) return 0;
  if (nk >= (1 << 28) || a.n_shards <= 0 || nk % a.n_shards || a.n_rows <= 0 || a.nr <= 0 || a.small_max < 0 ||
      a.small_max > SMALL_CAP || (long long)a.n_shards * (a.n_rows + 1) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (one_block(a)) {
    int p2 = 1;
    while (p2 < nk) p2 <<= 1;
    size_t smem = (sizeof(u64) + sizeof(int)) * (size_t)p2 + sizeof(int2) * (size_t)nk;
    // A block asks for more than the default 48 KB, which the static arrays
    // share with the dynamic bytes.
    if (smem > 40 * 1024) {
      int err = (int)cudaFuncSetAttribute(ms_small, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err) return err;
    }
    ms_small<<<1, SMALL_THREADS, smem, stream>>>(a, p2);
    return (int)cudaGetLastError();
  }
  Layout l = layout((int)nk, a.n_shards);
  if (workspace_bytes < (long long)l.temp) return -1;
  char* ws = (char*)workspace;
  u64* key_in = (u64*)(ws + l.key_in);
  u64* key_out = (u64*)(ws + l.key_out);
  int* val_in = (int*)(ws + l.val_in);
  int* val_out = (int*)(ws + l.val_out);
  int2* uc = (int2*)(ws + l.uc);
  u64* status = (u64*)(ws + l.status);
  int* ctl = (int*)(ws + l.ctl);
  size_t temp_bytes = (size_t)workspace_bytes - l.temp;
  ms_prep<<<blocks_for(max((int)nk, 2 * l.nt)), THREADS, 0, stream>>>(a, key_in, val_in, uc, status, 2 * l.nt, ctl);
  int err = (int)cudaGetLastError();
  if (!err)
    err = (int)cub::DeviceRadixSort::SortPairs(ws + l.temp, temp_bytes, key_in, key_out, val_in, val_out, (int)nk, 0,
                                               32 + bits_for((long long)a.n_shards * (a.n_rows + 1) - 1), stream);
  if (!err) {
    ms_decide<<<l.nt, THREADS, 0, stream>>>(a, key_out, val_out, uc, status, l.nt, l.tps, ctl);
    ms_clear<<<blocks_for((int)nk), THREADS, 0, stream>>>(a, key_out);
    err = (int)cudaGetLastError();
  }
  // ms_prep has added into the zeroed demand: a call that fails after it
  // leaves the demand zero all the same (K4's, K8's and K15's cells).
  if (err) cudaMemsetAsync(a.demand, 0, sizeof(int) * (size_t)a.n_shards * a.n_rows, stream);
  return err;
}

// K16 step 1.
int mesh_charge_keys(const uint8_t* valid, const int* row, const int* ts, int s, int n_rows, long long* keys,
                     void* stream) {
  if (s <= 0) return 0;
  msc_prep<<<blocks_for(s), THREADS, 0, (cudaStream_t)stream>>>(valid, row, ts, s, n_rows, keys);
  return (int)cudaGetLastError();
}

// K16 after the sort. ppc is int32 [s] in item order.
int mesh_charge(const long long* key_s, const int64_t* perm, const uint8_t* valid, const int* eidx,
                const int* acq, int s, int n_rows, const int* sec_counts, const int* sec_ws, int nb, int ne,
                int interval_ms, int now, uint8_t* new_grp, int* contrib, int* excl, int* partial,
                int* partial_max, int* ppc, void* stream) {
  if (s <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int2* c2 = reinterpret_cast<int2*>(contrib);
  int2* x2 = reinterpret_cast<int2*>(excl);
  int2* m2 = reinterpret_cast<int2*>(partial_max);
  msc_flags<<<blocks_for(s), THREADS, 0, st>>>(key_s, perm, s, valid, eidx, acq, new_grp, c2);
  LoadContrib lc{c2};
  LoadSnapshot ls{x2, new_grp};
  launch_scans(lc, ls, s, reinterpret_cast<int2*>(partial), m2, x2, st);
  msc_decide<<<tiles_for(s), THREADS, 0, st>>>(ls, s, n_rows, m2, x2, key_s, perm,
                                                Window{sec_counts, sec_ws, nb, ne, interval_ms}, now, ppc);
  return (int)cudaGetLastError();
}

}  // extern "C"
