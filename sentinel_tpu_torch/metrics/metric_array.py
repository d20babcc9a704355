"""The sliding-window counter tensor (port of
``sentinel_tpu/metrics/metric_array.py``).

The reference's ``LeapArray<MetricBucket>`` for every node is one set of
tensors per geometry::

    counts       int32 [rows, buckets, NUM_EVENTS]
    min_rt       int32 [rows, buckets]
    window_start int32 [rows, buckets]     (ms relative to clock epoch)

Semantics kept from the reference (and the JAX package, bit for bit):

* bucket index ``(ts // window_len) % buckets`` and aligned window start
  ``ts - ts % window_len``, with ``ts >= 0``;
* a bucket counts for reads iff ``now - window_start <= interval``
  (LeapArray#isWindowDeprecated is strict), in wrapping int32;
* updates from a window older than the bucket's post-batch window are
  dropped; a newer window rolls the bucket;
* ``min_rt`` starts at the statistic max RT (4900).

Three kernels live here, each beside its plain PyTorch version:

* :func:`update` (K2): CUDA C++, ``csrc/window_update.cu``;
* :func:`window_reduce` (K3, behind :func:`window_sums` and
  :func:`window_min_rt`): CUDA C++, ``csrc/window_reduce.cu``, whose
  second entry point ``row_stats`` serves ``nodes.rows_stats`` (the
  engine's stats read: both windows, the gauge and the slab in one
  launch).

and the metric timer's read of the minute window:

* :func:`bucket_read` (K17): CUDA C++, ``csrc/bucket_read.cu``; what
  ``bucket_windows`` and the JAX timer's filter compute, as compact
  records of the asked rows' seconds.

Each wrapper takes its plain version only for CPU tensors; a CUDA tensor
launches the kernel (or raises), and the wrapper counts the launch in its
``launches`` attribute. State updates happen IN PLACE on the state's
tensors (the JAX code donated these buffers to the kernel; here nothing
is copied).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.metrics.events import NUM_EVENTS
from sentinel_tpu_torch.utils import cuda_build
from sentinel_tpu_torch.utils.numeric import wrap_i32


class MetricArrayConfig(NamedTuple):
    """Geometry of one window array family (sample_count × window_len_ms
    = interval_ms, LeapArray.java:58-76)."""

    sample_count: int
    interval_ms: int
    max_rt: int = 4900  # reference: Constants.TIME_DROP_VALVE / statisticMaxRt

    @property
    def window_len_ms(self) -> int:
        return self.interval_ms // self.sample_count

    @property
    def empty_ws(self) -> int:
        # A window start so old that it is always deprecated for ts >= 0.
        return -self.interval_ms - 1


class MetricArrayState(NamedTuple):
    counts: torch.Tensor  # int32 [R, B, E]
    min_rt: torch.Tensor  # int32 [R, B]
    window_start: torch.Tensor  # int32 [R, B]

    @property
    def n_rows(self) -> int:
        return self.counts.shape[0]


def make_state(n_rows: int, cfg: MetricArrayConfig, device: torch.device) -> MetricArrayState:
    b = cfg.sample_count
    return MetricArrayState(
        counts=torch.zeros((n_rows, b, NUM_EVENTS), dtype=torch.int32, device=device),
        min_rt=torch.full((n_rows, b), cfg.max_rt, dtype=torch.int32, device=device),
        window_start=torch.full((n_rows, b), cfg.empty_ws, dtype=torch.int32, device=device),
    )


def grow(state: MetricArrayState, new_rows: int, cfg: MetricArrayConfig) -> MetricArrayState:
    """Row-capacity growth (new rows empty); returns new tensors."""
    extra = new_rows - state.n_rows
    if extra <= 0:
        return state
    tail = make_state(extra, cfg, state.counts.device)
    return MetricArrayState(*(torch.cat([a, t], dim=0) for a, t in zip(state, tail)))


def state_from_numpy(d, device) -> MetricArrayState:
    """``(counts, min_rt, window_start)`` numpy arrays → state tensors."""
    return MetricArrayState(
        *(torch.tensor(np.asarray(a, dtype=np.int32), device=device) for a in d)
    )


def state_to_numpy(state: MetricArrayState):
    return tuple(t.cpu().numpy() for t in state)


def _check_ts(ts: torch.Tensor, mask: torch.Tensor) -> None:
    if bool((ts < 0).logical_and(mask).any()):
        raise ValueError("window update timestamps must be >= 0 (ms relative to the epoch)")


# ---------------------------------------------------------------------------
# K2: update
# ---------------------------------------------------------------------------


def update(
    cfg: MetricArrayConfig,
    state: MetricArrayState,
    rows: torch.Tensor,  # int32 [N]
    ts: torch.Tensor,  # int32 [N], ms rel epoch, >= 0
    deltas: torch.Tensor,  # int32 [N, NUM_EVENTS]
    rt_sample: Optional[torch.Tensor] = None,  # int32 [N] or None
    mask: Optional[torch.Tensor] = None,  # bool [N]
) -> MetricArrayState:
    """Apply a batch of bucket updates in place (LeapArray.currentWindow +
    add). Masked-out entries contribute nothing; duplicate (row, bucket)
    keys accumulate; entries from a superseded window are dropped. With
    ``rt_sample`` None a rolled bucket's min RT resets to ``max_rt``.
    Masked-in rows must lie in ``[0, R)``."""
    if mask is None:
        mask = torch.ones(rows.shape, dtype=torch.bool, device=rows.device)
    if state.counts.is_cuda:
        return _update_cuda(cfg, state, rows, ts, deltas, rt_sample, mask)
    return update_plain(cfg, state, rows, ts, deltas, rt_sample, mask)


update.launches = 0


def update_plain(cfg, state, rows, ts, deltas, rt_sample=None, mask=None) -> MetricArrayState:
    """Plain PyTorch version of :func:`update`, in the kernel's phases on
    the flat cells (``csrc/window_update.cuh``): the newest window per cell
    (``scatter_reduce`` amax), the roll of the cells it raised, then the
    sums (``index_add_``, wrapping int32) and the min RT (``scatter_reduce``
    amin) of the updates in the cell's window."""
    b = cfg.sample_count
    if mask is None:
        mask = torch.ones(rows.shape, dtype=torch.bool, device=rows.device)
    if rows.shape[0] == 0:
        return state
    _check_ts(ts, mask)
    rows = rows.to(torch.int64)
    ts = ts.to(torch.int64)
    sel = mask & (rows >= 0) & (rows < state.n_rows)
    cell = (rows * b + torch.div(ts, cfg.window_len_ms, rounding_mode="floor") % b)[sel]
    w = (ts - ts % cfg.window_len_ms)[sel].to(torch.int32)
    ws = state.window_start.view(-1)
    counts = state.counts.view(-1, NUM_EVENTS)
    min_rt = state.min_rt.view(-1)

    # (1) the newest window per cell; the cells it raised roll.
    old = ws[cell]
    ws.scatter_reduce_(0, cell, w, "amax")
    now_ws = ws[cell]
    rolled = cell[now_ws > old]
    counts[rolled] = 0
    min_rt[rolled] = cfg.max_rt
    # (2) the updates in their cell's window add.
    add = w == now_ws
    cells, inv = torch.unique(cell[add], return_inverse=True)
    sums = torch.zeros((cells.shape[0], NUM_EVENTS), dtype=torch.int64, device=cells.device)
    sums.index_add_(0, inv, deltas[sel][add].to(torch.int64))
    counts[cells] = wrap_i32(counts[cells].to(torch.int64) + sums)
    if rt_sample is not None:
        min_rt.scatter_reduce_(0, cell[add], rt_sample[sel][add].to(torch.int32), "amin")
    return state


_P = ctypes.c_void_p
_I = ctypes.c_int


def _wu_lib() -> ctypes.CDLL:
    lib = cuda_build.load("window_update")
    if not getattr(lib, "_typed", False):
        lib.window_update.argtypes = [_P] * 5 + [_I] * 5 + [_P] * 4
        # nodes.apply_updates: both windows and the thread gauge.
        lib.apply_updates.argtypes = [_P] * 7 + [_I] * 5 + [_P] * 3 + [_I] * 2 + [_P] * 5
        for f in (lib.window_update, lib.apply_updates):
            f.restype = _I
        lib._typed = True
    return lib


def _i32(t: torch.Tensor, what: str, shape) -> torch.Tensor:
    if t.dtype != torch.int32 or not t.is_contiguous() or not t.is_cuda or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: need a contiguous CUDA int32 tensor of shape {tuple(shape)}")
    return t


def _bool(t: torch.Tensor, what: str, n: int) -> torch.Tensor:
    if t.dtype != torch.bool or not t.is_contiguous() or not t.is_cuda or tuple(t.shape) != (n,):
        raise ValueError(f"{what}: need a contiguous CUDA bool tensor of shape ({n},)")
    return t


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _update_cuda(cfg, state, rows, ts, deltas, rt_sample, mask) -> MetricArrayState:
    n = rows.shape[0]
    b = cfg.sample_count
    _i32(rows, "rows", (n,))
    _i32(ts, "ts", (n,))
    _i32(deltas, "deltas", (n, NUM_EVENTS))
    _bool(mask, "mask", n)
    if rt_sample is not None:
        _i32(rt_sample, "rt_sample", (n,))
    for name, t in zip(MetricArrayState._fields, state):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"state.{name}: need a contiguous int32 tensor")
    if n == 0:
        return state
    cuda_build.check(
        _wu_lib().window_update(
            rows.data_ptr(), ts.data_ptr(), deltas.data_ptr(),
            rt_sample.data_ptr() if rt_sample is not None else None, mask.data_ptr(), n, state.n_rows,
            b, cfg.window_len_ms, cfg.max_rt, state.counts.data_ptr(), state.min_rt.data_ptr(),
            state.window_start.data_ptr(), stream_of(rows),
        ),
        "window_update",
    )
    update.launches += 1
    return state


# ---------------------------------------------------------------------------
# K3: window sums / min RT
# ---------------------------------------------------------------------------


def window_reduce(
    cfg: MetricArrayConfig,
    state: MetricArrayState,
    now: int,
    rows: Optional[torch.Tensor] = None,
    with_min: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Windowed event sums (int32 [R', E]) and, with ``with_min``, the
    windowed min RT (int32 [R']; ``max_rt`` when empty), over the buckets
    with ``now - window_start <= interval``. ``rows`` (int32 [R'], clipped
    into ``[0, R)``) reads only those rows, in that order; None reads all.
    Sums wrap in int32 as the JAX reduction does."""
    if state.counts.is_cuda:
        return _window_reduce_cuda(cfg, state, now, rows, with_min)
    return window_reduce_plain(cfg, state, now, rows, with_min)


window_reduce.launches = 0


def window_sums(cfg, state, now, rows=None) -> torch.Tensor:
    """ArrayMetric.pass_()/block()/...: sums over the valid buckets."""
    return window_reduce(cfg, state, now, rows)[0]


def window_min_rt(cfg, state, now, rows=None) -> torch.Tensor:
    """ArrayMetric#minRt over the valid buckets (``max_rt`` when empty)."""
    return window_reduce(cfg, state, now, rows, with_min=True)[1]


def window_reduce_plain(cfg, state, now, rows=None, with_min=False):
    """Plain PyTorch version of :func:`window_reduce`."""
    counts, min_rt, ws = state.counts, state.min_rt, state.window_start
    if rows is not None:
        r = rows.long().clamp(0, state.n_rows - 1)
        counts, min_rt, ws = counts[r], min_rt[r], ws[r]
    now_t = torch.tensor(int(now), dtype=torch.int32, device=ws.device)
    valid = (now_t - ws) <= cfg.interval_ms
    sums = (counts * valid[:, :, None].to(torch.int32)).sum(dim=1).to(torch.int32)
    mins = None
    if with_min:
        mins = torch.where(valid, min_rt, cfg.max_rt).amin(dim=1).to(torch.int32)
    return sums, mins


def _wr_lib() -> ctypes.CDLL:
    lib = cuda_build.load("window_reduce")
    if not getattr(lib, "_typed", False):
        lib.window_reduce.argtypes = [_P] * 3 + [_I] * 3 + [_P] + [_I] * 3 + [_P] * 3
        # nodes.rows_stats: one record a row (RsArgs, nodes._RsArgs).
        lib.row_stats.argtypes = [_P, _P]
        for f in (lib.window_reduce, lib.row_stats):
            f.restype = _I
        lib._typed = True
    return lib


def check_window(cfg: MetricArrayConfig, state: MetricArrayState, what: str) -> None:
    """Raise unless ``state`` is one contiguous CUDA int32 window of
    ``cfg``'s geometry: counts [R, B, NE] (8-byte aligned: K3 reads a
    bucket's counts in 8-byte words), min_rt and window_start [R, B]."""
    n, b = state.n_rows, cfg.sample_count
    for name, t in zip(MetricArrayState._fields, state):
        shape = (n, b, NUM_EVENTS) if name == "counts" else (n, b)
        if t.dtype != torch.int32 or not t.is_contiguous() or not t.is_cuda or tuple(t.shape) != shape:
            raise ValueError(f"{what}.{name}: need a contiguous CUDA int32 tensor of shape {shape}")
    if state.counts.data_ptr() % 8:
        raise ValueError(f"{what}.counts: need an 8-byte aligned tensor")


def _window_reduce_cuda(cfg, state, now, rows, with_min):
    check_window(cfg, state, "state")
    dev = state.counts.device
    gather = rows is not None
    if gather:
        _i32(rows, "rows", (rows.shape[0],))
    n_out = rows.shape[0] if gather else state.n_rows
    sums = torch.empty((n_out, NUM_EVENTS), dtype=torch.int32, device=dev)
    mins = torch.empty((n_out,), dtype=torch.int32, device=dev) if with_min else None
    if n_out == 0:
        return sums, mins
    if state.n_rows == 0:
        raise IndexError("window_reduce: rows asked of a window with no rows")
    cuda_build.check(
        _wr_lib().window_reduce(
            state.counts.data_ptr(), state.min_rt.data_ptr(), state.window_start.data_ptr(), cfg.sample_count,
            cfg.interval_ms, cfg.max_rt, rows.data_ptr() if gather else None, n_out, state.n_rows, int(now),
            sums.data_ptr(), None if mins is None else mins.data_ptr(), stream_of(state.counts),
        ),
        "window_reduce",
    )
    window_reduce.launches += 1
    return sums, mins


# ---------------------------------------------------------------------------
# bucket_windows, and K17: the metric timer's bucket read
# ---------------------------------------------------------------------------


def bucket_windows(cfg: MetricArrayConfig, state: MetricArrayState, now: int):
    """(window_start [R, B], counts [R, B, E], valid [R, B]) of the whole
    window, as the JAX metric log reads it (``MetricTimerListener`` reading
    each node's per-second buckets). Plain PyTorch on any device: the
    engine's timer reads through :func:`bucket_read` instead."""
    ws = state.window_start
    now_t = torch.tensor(int(now), dtype=torch.int32, device=ws.device)
    return ws, state.counts, (now_t - ws) <= cfg.interval_ms


BUCKET_RECORD = 2 + NUM_EVENTS  # bucket_read's record: the asked row's index, the second, the counts


def bucket_read(cfg: MetricArrayConfig, state: MetricArrayState, rows: torch.Tensor, begin: int,
                upto: int, now: int) -> torch.Tensor:
    """The metric timer's read: for each asked row (``rows``, int32 [A],
    clipped into ``[0, R)``) and each second ``sec`` of ``[begin, upto)``
    (step ``cfg.window_len_ms``), the cell of bucket ``(sec // wlen) % B``
    when it counts at ``now`` (``now - ws <= interval``, wrapping int32),
    starts at ``sec``, and holds a nonzero count. Returns int32
    [n, BUCKET_RECORD] records ``(index into rows, sec, counts...)``, in no
    set order on the card, by (index, sec) here. On the card K17 writes
    them in one launch (two when they outgrow a steady pull's buffer) into
    the device's :class:`BucketReader`, kept from read to read, and one copy
    brings back the count and the records (two when they outgrow the
    reader's head); the result lies on the host."""
    if state.counts.is_cuda:
        return _default_reader(state.counts.device).read(cfg, state, rows, begin, upto, now)
    return bucket_read_plain(cfg, state, rows, begin, upto, now)


bucket_read.launches = 0


def _read_seconds(cfg: MetricArrayConfig, begin: int, upto: int) -> int:
    return max(0, -(-(int(upto) - int(begin)) // cfg.window_len_ms))


def bucket_read_plain(cfg, state, rows, begin, upto, now) -> torch.Tensor:
    """Plain PyTorch version of :func:`bucket_read`."""
    wlen = cfg.window_len_ms
    dev = state.counts.device
    n_sec = _read_seconds(cfg, begin, upto)
    secs64 = int(begin) + wlen * torch.arange(n_sec, dtype=torch.int64, device=dev)
    secs = wrap_i32(secs64)
    b = torch.remainder(torch.div(secs64, wlen, rounding_mode="floor"), cfg.sample_count)
    r = rows.long().clamp(0, state.n_rows - 1)
    ws = state.window_start[r][:, b]  # [A, S]
    counts = state.counts[r][:, b]  # [A, S, E]
    now_t = torch.tensor(int(now), dtype=torch.int32, device=dev)
    keep = ((now_t - ws) <= cfg.interval_ms) & (ws == secs[None, :]) & (counts != 0).any(-1)
    a_idx, s_idx = keep.nonzero(as_tuple=True)
    out = torch.empty((a_idx.shape[0], BUCKET_RECORD), dtype=torch.int32, device=dev)
    out[:, 0] = a_idx.to(torch.int32)
    out[:, 1] = secs[s_idx]
    out[:, 2:] = counts[a_idx, s_idx]
    return out.cpu()


def _br_lib() -> ctypes.CDLL:
    lib = cuda_build.load("bucket_read")
    if not getattr(lib, "_typed", False):
        lib.bucket_read.argtypes = [_P] * 3 + [_I] * 9 + [_P] * 2 + [_I, _P, ctypes.c_longlong, _P]
        lib.bucket_read.restype = _I
        lib._typed = True
    return lib


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


class BucketReader:
    """K17's buffers, kept from read to read (:func:`bucket_read` keeps one
    a device, under its lock): on the device the two counters and the
    records, on the host a pinned buffer for the counters and the first
    ``head`` records. A read is one C
    call (one launch, no memset, and the copy back of ``2 + head *
    BUCKET_RECORD`` int32 queued behind it), then one event wait; ``head``
    follows the last read's count (a power of two, at least
    :data:`HEAD_MIN`), so that a steady pull's records come back in the one
    copy. A count above ``head`` copies the rest in a second copy; one
    above the device buffer's ``cap`` launches again with room for all
    (``cap`` by default what a steady pull can give: one second of every
    asked row, twice over, and 65,536 more, not the asked cells' worst
    case, at 1,048,576 rows and 59 s some 2 GB). A read that raises drops
    the device buffer, whose counters it may have left counted."""

    HEAD_MIN = 1024

    def __init__(self) -> None:
        self.head = self.HEAD_MIN
        self._lock = threading.Lock()
        self._dev: Optional[torch.Tensor] = None  # int32 [2 + cap * BUCKET_RECORD], the counters in front
        self._host: Optional[torch.Tensor] = None  # pinned int32, the counters and the first records
        self._host_np: Optional[np.ndarray] = None  # its numpy view
        self._parity = 0  # the counter this read counts in; the launch zeroes the other
        self._event: Optional[torch.cuda.Event] = None

    def read(self, cfg: MetricArrayConfig, state: MetricArrayState, rows: torch.Tensor, begin: int, upto: int,
             now: int, cap: Optional[int] = None) -> torch.Tensor:
        # The window's tensors come call after call, updated in place.
        cuda_build.check_once(f"bucket_read/{cfg.sample_count}", tuple(state),
                              lambda: check_window(cfg, state, "state"))
        a = rows.shape[0]
        _i32(rows, "rows", (a,))
        if state.n_rows == 0:
            raise IndexError("bucket_read: rows asked of a window with no rows")
        n_sec = _read_seconds(cfg, begin, upto)
        if cap is None:
            cap = min(a * n_sec, 2 * a + 65536)
        if a * n_sec == 0:
            return torch.empty((0, BUCKET_RECORD), dtype=torch.int32)
        dev = state.counts.device
        stream = torch.cuda.current_stream(dev)
        lib = _br_lib()
        with self._lock:  # on the current stream, as the launch and the copies
            try:
                return self._read(lib, cfg, state, rows, a, n_sec, int(begin), int(now), cap, dev, stream)
            except BaseException:
                self._dev = None
                raise

    def _read(self, lib, cfg, state, rows, a, n_sec, begin, now, cap, dev, stream) -> torch.Tensor:
        st = stream.cuda_stream
        rec = BUCKET_RECORD
        while True:
            if self._dev is None or self._dev.device != dev or self._dev.numel() < 2 + cap * rec:
                self._dev = torch.zeros(2 + cap * rec, dtype=torch.int32, device=dev)
                self._parity = 0
            p, buf = self._parity, self._dev
            m = 2 + min(self.head, cap) * rec
            host = self._pinned(m)
            ptr = buf.data_ptr()
            cuda_build.check(
                lib.bucket_read(
                    state.counts.data_ptr(), state.window_start.data_ptr(), rows.data_ptr(), state.n_rows,
                    cfg.sample_count, cfg.window_len_ms, cfg.interval_ms, a, n_sec, begin, now, cap,
                    ptr + 8, ptr, p, host.data_ptr(), m, st,
                ),
                "bucket_read",
            )
            bucket_read.launches += 1
            self._parity = 1 - p
            self._wait(stream)
            n = int(self._host_np[p])
            if n <= cap:
                break
            cap = n
        need = 2 + n * rec
        if need > m:  # more records than the head: the rest in a second copy
            host = self._pinned(need, keep=m)
            host[m:need].copy_(buf[m:need], non_blocking=True)
            self._wait(stream)
        self.head = max(self.HEAD_MIN, _pow2_at_least(n))
        return torch.from_numpy(self._host_np[2:need].reshape(n, rec).copy())

    def _pinned(self, size: int, keep: int = 0) -> torch.Tensor:
        """The pinned host buffer, grown to ``size`` int32 (its first
        ``keep`` kept)."""
        host = self._host
        if host is None or host.numel() < size:
            grown = torch.empty(2 + max(self.head, _pow2_at_least(size // BUCKET_RECORD)) * BUCKET_RECORD,
                                dtype=torch.int32, pin_memory=True)
            if keep:
                grown[:keep].copy_(host[:keep])
            host = self._host = grown
            self._host_np = grown.numpy()
        return host

    def _wait(self, stream: torch.cuda.Stream) -> None:
        """Wait for the copies queued on ``stream``."""
        if self._event is None:
            self._event = torch.cuda.Event()
        self._event.record(stream)
        self._event.synchronize()


_readers: Dict[torch.device, BucketReader] = {}
_readers_lock = threading.Lock()


def _default_reader(device: torch.device) -> BucketReader:
    with _readers_lock:
        r = _readers.get(device)
        if r is None:
            r = _readers[device] = BucketReader()
        return r


