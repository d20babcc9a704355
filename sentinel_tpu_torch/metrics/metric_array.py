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

Two kernels live here, each beside its plain PyTorch version:

* :func:`update` (K2): CUDA C++, ``csrc/window_update.cu``;
* :func:`window_reduce` (K3, behind :func:`window_sums` and
  :func:`window_min_rt`): Triton, :func:`_window_reduce_cuda`.

Each wrapper takes its plain version only for CPU tensors; a CUDA tensor
launches the kernel (or raises), and the wrapper counts the launch in its
``launches`` attribute. State updates happen IN PLACE on the state's
tensors (the JAX code donated these buffers to the kernel; here nothing
is copied).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

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


_TRITON = None
tl = None  # triton.language, bound on first launch (_triton_kernels)


def _window_reduce_body(
    counts_ptr, ws_ptr, min_ptr, rows_ptr, sums_ptr, mins_ptr, now, n_out, n_rows, interval,
    max_rt,
    B: tl.constexpr, BP: tl.constexpr, NE: tl.constexpr, EP: tl.constexpr,
    GATHER: tl.constexpr, WITH_MIN: tl.constexpr, BLOCK_R: tl.constexpr,
):
    # One program reduces BLOCK_R rows: a [BLOCK_R, BP, EP] tile of counts
    # masked by bucket validity, summed over the bucket axis.
    pid = tl.program_id(0)
    r = pid * BLOCK_R + tl.arange(0, BLOCK_R)
    rm = r < n_out
    if GATHER:
        row = tl.load(rows_ptr + r, mask=rm, other=0)
        row = tl.minimum(tl.maximum(row, 0), n_rows - 1)
    else:
        row = r
    b = tl.arange(0, BP)
    cell = row[:, None] * B + b[None, :]
    cm = rm[:, None] & (b < B)[None, :]
    ws = tl.load(ws_ptr + cell, mask=cm, other=0)
    valid = ((now - ws) <= interval) & cm
    e = tl.arange(0, EP)
    em = e < NE
    c = tl.load(
        counts_ptr + cell[:, :, None] * NE + e[None, None, :],
        mask=valid[:, :, None] & em[None, None, :],
        other=0,
    )
    s = tl.sum(c, axis=1)
    tl.store(sums_ptr + r[:, None] * NE + e[None, :], s, mask=rm[:, None] & em[None, :])
    if WITH_MIN:
        m = tl.load(min_ptr + cell, mask=valid, other=max_rt)
        tl.store(mins_ptr + r, tl.min(m, axis=1), mask=rm)


def _triton_kernels():
    """Compile-on-first-use: triton is imported here, never at module
    import (the CPU tests import every module of the package)."""
    global _TRITON, tl
    if _TRITON is None:
        import triton
        import triton.language

        tl = triton.language
        _TRITON = triton.jit(_window_reduce_body)
    return _TRITON


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def _window_reduce_cuda(cfg, state, now, rows, with_min):
    for name, t in zip(MetricArrayState._fields, state):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"state.{name}: need a contiguous int32 tensor")
    kernel = _triton_kernels()
    dev = state.counts.device
    gather = rows is not None
    if gather:
        _i32(rows, "rows", (rows.shape[0],))
    n_out = rows.shape[0] if gather else state.n_rows
    sums = torch.empty((n_out, NUM_EVENTS), dtype=torch.int32, device=dev)
    mins = torch.empty((n_out,), dtype=torch.int32, device=dev) if with_min else sums
    if n_out == 0:
        return sums, (mins if with_min else None)
    b = cfg.sample_count
    bp = _next_pow2(b)
    block_r = max(1, 4096 // (bp * 8))
    grid = ((n_out + block_r - 1) // block_r,)
    kernel[grid](
        state.counts, state.window_start, state.min_rt, rows if gather else sums, sums, mins,
        int(now), n_out, state.n_rows, cfg.interval_ms, cfg.max_rt,
        B=b, BP=bp, NE=NUM_EVENTS, EP=8, GATHER=gather, WITH_MIN=with_min, BLOCK_R=block_r,
    )
    window_reduce.launches += 1
    return sums, (mins if with_min else None)
