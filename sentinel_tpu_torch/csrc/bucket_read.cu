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
// One C call, bucket_read: one memset of the record count and one launch,
// one thread per (asked row, second), seconds fastest. A passing cell
// writes a compact record of RECORD int32 (the asked row's index, the
// second, the NE counts) at a place taken from one counter (one atomic per
// warp). The order of the records is free: the timer sorts its lines by
// (timestamp, resource). Records past `cap` are counted and not written:
// the caller sizes `out` for a steady pull and, when the count is larger,
// launches again with room for all of them. The caller copies the count
// back, then that many records: the read moves the asked seconds' buckets
// only, one second a pull in steady state, against the R x nb x (NE + 2)
// int32 of the whole window.
//
// What bounds it: bytes. A (row, second) reads the row's index, the
// bucket's start and its NE counts (4 + 4 + 24 B) and a passing one writes
// 32 B. The buckets of one second lie nb * 4 (starts) and nb * NE * 4
// (counts) bytes apart from row to row, so each read takes its own
// sectors.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segscan.cuh"

namespace {

constexpr int NE = 6;               // metric events (metrics/events.py)
constexpr int RECORD = 2 + NE;      // the asked row's index, the second, the counts

struct BrArgs {
  const int* counts;  // [R, nb, NE]
  const int* ws;      // [R, nb]
  const int* rows;    // [A] the asked rows, clipped into [0, R)
  int* out;           // [cap, RECORD]
  int* count;         // [1] records that pass (written while below cap)
  int n_rows, nb, wlen, interval, n_asked, n_sec, begin, now, cap;
};

__global__ void __launch_bounds__(THREADS) br_read(BrArgs a) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  bool keep = false;
  int idx = 0, sec = 0, c[NE];
  if (t < (int64_t)a.n_asked * a.n_sec) {
    idx = (int)(t / a.n_sec);
    const int s = (int)(t - (int64_t)idx * a.n_sec);
    sec = (int)((unsigned)a.begin + (unsigned)s * (unsigned)a.wlen);
    const int row = clampi(a.rows[idx], 0, a.n_rows - 1);
    const int b = floormod(floordiv(sec, a.wlen), a.nb);
    const int64_t cell = (int64_t)row * a.nb + b;
    const int w = a.ws[cell];
    if (wrap_sub(a.now, w) <= a.interval && w == sec) {
      const int2* p = reinterpret_cast<const int2*>(a.counts + cell * NE);  // 8-byte aligned: NE is even
      bool any = false;
#pragma unroll
      for (int q = 0; q < NE / 2; ++q) {
        int2 v = p[q];
        c[2 * q] = v.x;
        c[2 * q + 1] = v.y;
        any = any || v.x != 0 || v.y != 0;
      }
      keep = any;
    }
  }
  const unsigned m = __ballot_sync(FULL_MASK, keep);
  if (m == 0) return;
  int base = 0;
  if (lane == __ffs(m) - 1) base = atomicAdd(a.count, __popc(m));
  base = __shfl_sync(FULL_MASK, base, __ffs(m) - 1);
  const int slot = base + __popc(m & ((1u << lane) - 1));
  if (!keep || slot >= a.cap) return;
  int* r = a.out + (int64_t)slot * RECORD;
  r[0] = idx;
  r[1] = sec;
#pragma unroll
  for (int q = 0; q < NE; ++q) r[2 + q] = c[q];
}

}  // namespace

extern "C" {

// The records of the asked rows' buckets for the n_sec seconds from begin
// (step wlen), as the header says. `out` holds cap records, `count` one
// int: the number of records that pass, also those past cap. Returns a CUDA
// error code.
int bucket_read(const int* counts, const int* ws, const int* rows, int n_rows, int nb, int wlen, int interval,
                int n_asked, int n_sec, int begin, int now, int cap, int* out, int* count, cudaStream_t st) {
  if (n_rows <= 0 || nb <= 0 || wlen <= 0 || n_asked < 0 || n_sec < 0 || cap < 0)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaMemsetAsync(count, 0, sizeof(int), st);
  if (err) return err;
  const long long n = (long long)n_asked * n_sec;
  if (n == 0) return 0;
  BrArgs a{counts, ws, rows, out, count, n_rows, nb, wlen, interval, n_asked, n_sec, begin, now, cap};
  br_read<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
