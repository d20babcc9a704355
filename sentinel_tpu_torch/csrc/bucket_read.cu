// K17, the metric timer's bucket read for Hopper (sm_90a): the port of
// sentinel_tpu/metrics/metric_array.py:bucket_windows (:231, _valid_mask
// :199) as sentinel_tpu/metrics/metric_log.py:MetricTimer.collect
// (:377-403) consumes it. The JAX timer copies the whole minute window to
// the host on every pull and keeps, for each asked row and each second in
// [begin, upto), the cell of bucket b = (sec / wlen) mod nb that passes
// three tests: the bucket counts at `now` (now - ws <= interval, wrapping
// int32: the strict age of LeapArray#isWindowDeprecated, taken at `now`,
// not at `sec`), its window starts at that very second (ws == sec: a
// bucket rolled to another second does not count), and one of its counts
// is nonzero.
//
// One C call, bucket_read: one launch and no memset, a thread per CPT
// (asked row, second) cells, seconds fastest; each thread loads its cells'
// rows, then their buckets' starts, then the counts of those that pass,
// so that its loads overlap. A passing cell writes a compact record of
// RECORD int32 (the asked row's index, the second, the NE counts) at a
// place taken from a counter (one atomic per warp). The counter is one of
// two persistent words in front of the records, picked by the caller's
// parity; the launch zeroes the other one, which the last call counted
// in, so no memset is needed, and the same C call queues the one copy
// that brings the count and the first records back. The order of the records is free: the timer sorts its lines
// by (timestamp, resource). Records past `cap` are counted and not
// written: the caller sizes `out` for a steady pull and, when the count
// is larger, launches again with room for all of them. The read moves the
// asked seconds' buckets only, one second a pull in steady state, against
// the R x nb x (NE + 2) int32 of the whole window.
//
// What bounds it: bytes and the memory's latency. A (row, second) reads
// the row's index, the bucket's start and, for a bucket of that second,
// its NE counts, and a passing one writes 32 B; the bound counts 4 + 4 +
// 24 B a cell (8.4 MB, 2.51 us at 3.35 TB/s, for 262,144 asked rows and
// one second). The buckets of one second lie nb * 4 (starts) and
// nb * NE * 4 (counts) bytes apart from row to row, so each start read
// takes a 32-byte sector of its own: the starts alone move 8.4 MB of
// sectors, the bound's bytes, whatever share of the counts is read. Each
// cell's three loads depend on one another (index, start, counts).

#include <cuda_runtime.h>
#include <stdint.h>

#include "segscan.cuh"

namespace {

constexpr int NE = 6;               // metric events (metrics/events.py)
constexpr int RECORD = 2 + NE;      // the asked row's index, the second, the counts

constexpr int CPT = 4;              // cells a thread

struct BrArgs {
  const int* counts;  // [R, nb, NE]
  const int* ws;      // [R, nb]
  const int* rows;    // [A] the asked rows, clipped into [0, R)
  int* out;           // [cap, RECORD]
  int* ctl;           // [2] the counters: ctl[parity] counts the records, ctl[1 - parity] is zeroed
  int n_rows, nb, wlen, interval, n_asked, n_sec, begin, now, cap, parity;
};

__global__ void __launch_bounds__(THREADS) br_read(BrArgs a) {
  const int64_t total = (int64_t)a.n_asked * a.n_sec;
  const int64_t t0 = (int64_t)blockIdx.x * THREADS * CPT + threadIdx.x;
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x == 0) a.ctl[1 - a.parity] = 0;
  int idx[CPT], sec[CPT], row[CPT], w[CPT];
  bool keep[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int64_t t = t0 + (int64_t)q * THREADS;
    keep[q] = t < total;
    idx[q] = a.n_sec == 1 ? (int)t : (int)(t / a.n_sec);
    const int s = (int)(t - (int64_t)idx[q] * a.n_sec);
    sec[q] = (int)((unsigned)a.begin + (unsigned)s * (unsigned)a.wlen);
    row[q] = keep[q] ? a.rows[idx[q]] : 0;
  }
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    row[q] = clampi(row[q], 0, a.n_rows - 1) * a.nb + floormod(floordiv(sec[q], a.wlen), a.nb);  // the cell
    w[q] = keep[q] ? a.ws[(int64_t)row[q]] : 0;
  }
  int c[CPT][NE];
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    keep[q] = keep[q] && wrap_sub(a.now, w[q]) <= a.interval && w[q] == sec[q];
    bool any = false;
    if (keep[q]) {
      const int2* p = reinterpret_cast<const int2*>(a.counts + (int64_t)row[q] * NE);  // 8-byte aligned: NE is even
#pragma unroll
      for (int e = 0; e < NE / 2; ++e) {
        const int2 v = p[e];
        c[q][2 * e] = v.x;
        c[q][2 * e + 1] = v.y;
        any = any || v.x != 0 || v.y != 0;
      }
    }
    keep[q] = any;
  }
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const unsigned m = __ballot_sync(FULL_MASK, keep[q]);
    if (m == 0) continue;
    int base = 0;
    if (lane == __ffs(m) - 1) base = atomicAdd(a.ctl + a.parity, __popc(m));
    base = __shfl_sync(FULL_MASK, base, __ffs(m) - 1);
    const int slot = base + __popc(m & ((1u << lane) - 1));
    if (!keep[q] || slot >= a.cap) continue;
    int* r = a.out + (int64_t)slot * RECORD;
    r[0] = idx[q];
    r[1] = sec[q];
#pragma unroll
    for (int e = 0; e < NE; ++e) r[2 + e] = c[q][e];
  }
}

}  // namespace

extern "C" {

// The records of the asked rows' buckets for the n_sec seconds from begin
// (step wlen), as the header says. `out` holds cap records; `ctl` the two
// counters: ctl[parity], zero before the call, ends at the number of
// records that pass, also those past cap; ctl[1 - parity] is zeroed. With
// `host` (pinned) the call also queues the copy back of the first
// host_ints int32 from ctl, the counters then the records (`out` must
// then start at ctl + 2). Launches and copies on `st`; waits for neither.
// Returns a CUDA error code.
int bucket_read(const int* counts, const int* ws, const int* rows, int n_rows, int nb, int wlen, int interval,
                int n_asked, int n_sec, int begin, int now, int cap, int* out, int* ctl, int parity, int* host,
                long long host_ints, cudaStream_t st) {
  if (n_rows <= 0 || nb <= 0 || wlen <= 0 || n_asked < 0 || n_sec < 0 || cap < 0 || (parity & ~1) ||
      (host != nullptr && (out != ctl + 2 || host_ints < 2 || host_ints > 2 + (long long)cap * RECORD)))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)n_asked * n_sec;
  if (n == 0 || n > INT_MAX) return n == 0 ? 0 : (int)cudaErrorInvalidValue;
  BrArgs a{counts, ws, rows, out, ctl, n_rows, nb, wlen, interval, n_asked, n_sec, begin, now, cap, parity};
  br_read<<<(unsigned)((n + THREADS * CPT - 1) / (THREADS * CPT)), THREADS, 0, st>>>(a);
  int err = (int)cudaGetLastError();
  if (!err && host != nullptr)
    err = (int)cudaMemcpyAsync(host, ctl, sizeof(int) * (size_t)host_ints, cudaMemcpyDeviceToHost, st);
  return err;
}

}  // extern "C"
