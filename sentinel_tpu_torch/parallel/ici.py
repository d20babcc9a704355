"""The sharded flush on one device (port of ``sentinel_tpu/parallel/ici.py``).

The JAX package runs one flush over an n-chip mesh: every chip takes a
contiguous block of the batch's entries and exits against replicated
counter tensors, and the collectives of the step (``psum``, ``pmax``,
``pmin``, ``all_gather``, ``axis_index``) rebuild the global state inside
it; flow budgets, occupy borrows and breaker probes are conserved across
the mesh. Here the mesh is ``n`` shards of one device
(``parallel/mesh.py``): the step runs each shard's stages in turn, in
shard order, and the collectives are reductions over the shards
(:class:`ShardCollectives`, the one seam an NCCL group across cards would
replace). A value JAX replicates on every chip is computed once (the
matured-borrow sweep, the breaker completions over the gathered exits, the
global shaping and param scans); each shard gets its own copy of the state
its stages write (stats, breakers), and the merges read the replicated base
unchanged.

Kernels here, each beside its plain PyTorch version:

* :func:`merge_stats_across` (K13): Triton, the rollover-aware merge of
  the second and minute windows, the future slab and the thread gauge
  (one pass over the count elements, one over the cells);
* :func:`merge_breaker` (K14): CUDA C++, ``csrc/mesh_merge_breaker.cu``;
* :func:`mesh_split_spend` (K15): CUDA C++, ``csrc/mesh_budget.cu``, the
  budget split of ``_demote_over_grant`` and ``_demote_over_borrow``;
* :func:`mesh_shaping_charge` (K16): CUDA C++, ``csrc/mesh_budget.cu``,
  the global shaping charge.

The rest is torch glue: the shard split and concatenation, the probe
election, the owner-gated scatters of the global param and shaping
verdicts, the param exit releases and thread increments. Every per-shard
stage calls the flush's kernels once per shard (K2-K10).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterable, List, NamedTuple, Optional, Tuple

import torch

from sentinel_tpu_torch.metrics import metric_array as ma
from sentinel_tpu_torch.metrics import nodes as _nodes
from sentinel_tpu_torch.metrics.events import NUM_EVENTS, MetricEvent
from sentinel_tpu_torch.metrics.nodes import StatsState, materialize_matured, waiting_tokens
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.rules import degrade_table as _dt
from sentinel_tpu_torch.rules.degrade_table import DegradeDynState, DegradeTableDevice
from sentinel_tpu_torch.rules.flow_table import FlowTableDevice
from sentinel_tpu_torch.rules.param_table import ParamBatch, ParamDynState, run_param
from sentinel_tpu_torch.rules.shaping import ShapingBatch, shaping_stage
from sentinel_tpu_torch.runtime import flush as _flush
from sentinel_tpu_torch.runtime.flush import FlushBatch, FlushResult, SystemDevice
from sentinel_tpu_torch.utils import cuda_build
from sentinel_tpu_torch.utils.numeric import add_i32, f32_to_i32, sub_i32, wrap_i32

_I32_MAX = 2**31 - 1


class ShardCollectives:
    """The step's five collectives over the shards this process holds, all
    on one device. Each reduction takes the shards' parts in shard order
    (an iterable: a part is made only when it is reduced) and returns the
    one replicated value; int32 sums wrap as JAX's ``psum`` does."""

    def __init__(self, n_shards: int) -> None:
        self.n_shards = n_shards

    def axis_index(self) -> range:
        return range(self.n_shards)

    def psum(self, parts: Iterable[torch.Tensor]) -> torch.Tensor:
        acc = None
        for x in parts:
            acc = x.to(torch.int64) if acc is None else acc + x
        return wrap_i32(acc)

    def pmax(self, parts: Iterable[torch.Tensor]) -> torch.Tensor:
        return functools.reduce(torch.maximum, parts)

    def pmin(self, parts: Iterable[torch.Tensor]) -> torch.Tensor:
        return functools.reduce(torch.minimum, parts)

    def all_gather(self, parts: Iterable[torch.Tensor]) -> torch.Tensor:
        return torch.stack(list(parts))


def replicate(state, n_shards: int):
    """``n_shards`` copies of a state tuple (``StatsState``,
    ``DegradeDynState``), stacked on a new leading shard axis."""
    if isinstance(state, tuple):
        return type(state)(*(replicate(t, n_shards) for t in state))
    return state.unsqueeze(0).expand((n_shards,) + tuple(state.shape)).clone()


def shard_of(stacked, d: int):
    """Shard ``d``'s view of a stacked state (contiguous, written in place)."""
    if isinstance(stacked, tuple):
        return type(stacked)(*(shard_of(t, d) for t in stacked))
    return stacked[d]


def _copy_into(dst, src) -> None:
    """``src`` copied over ``dst`` field by field, in place; a state copied
    over a stacked one refills every shard."""
    if isinstance(dst, tuple):
        for a, b in zip(dst, src):
            _copy_into(a, b)
        return
    dst.copy_(src)


# ---------------------------------------------------------------------------
# K13: the rollover-aware merges
# ---------------------------------------------------------------------------


def merge_window_across(old: ma.MetricArrayState, new: ma.MetricArrayState, coll: ShardCollectives
                        ) -> ma.MetricArrayState:
    """Rollover-aware merge of one window array (``new`` stacked over the
    shards). A shard that rolled a bucket to a newer window zeroed its old
    counts, so the merged window start is the max over shards and only the
    shards whose final window is that one contribute their counts minus
    the base's (which are the old counts iff the old window already was
    the merged one); ``min_rt`` is the min over those shards."""
    g_ws = coll.pmax(new.window_start[d] for d in coll.axis_index())
    old_cur = old.window_start == g_ws
    base = torch.where(old_cur[:, :, None], old.counts, 0)
    counts = add_i32(base, coll.psum(
        torch.where((new.window_start[d] == g_ws)[:, :, None], sub_i32(new.counts[d], base), 0)
        for d in coll.axis_index()
    ))
    min_rt = torch.minimum(
        torch.where(old_cur, old.min_rt, _I32_MAX),
        coll.pmin(torch.where(new.window_start[d] == g_ws, new.min_rt[d], _I32_MAX) for d in coll.axis_index()),
    )
    return ma.MetricArrayState(counts=counts, min_rt=min_rt.to(torch.int32), window_start=g_ws)


def merge_stats_across(old: StatsState, new: StatsState) -> StatsState:
    """Merge the shards' stats (``new``, stacked) against their common base
    ``old``: the second and minute windows and the future slab rollover
    aware (the newest window start wins; only shards on it contribute),
    the thread gauge as ``old + psum(new - old)``. Written over ``old`` in
    place."""
    if old.threads.is_cuda:
        return _merge_stats_cuda(old, new)
    return merge_stats_across_plain(old, new)


merge_stats_across.launches = 0


def merge_stats_across_plain(old: StatsState, new: StatsState) -> StatsState:
    """Plain PyTorch version of :func:`merge_stats_across`."""
    coll = ShardCollectives(new.threads.shape[0])
    g_ws = coll.pmax(new.future_ws[d] for d in coll.axis_index())
    base = torch.where(old.future_ws == g_ws, old.future_pass, 0)
    fut = add_i32(base, coll.psum(
        torch.where(new.future_ws[d] == g_ws, sub_i32(new.future_pass[d], base), 0) for d in coll.axis_index()
    ))
    merged = StatsState(
        second=merge_window_across(old.second, new.second, coll),
        minute=merge_window_across(old.minute, new.minute, coll),
        threads=add_i32(old.threads, coll.psum(sub_i32(new.threads[d], old.threads) for d in coll.axis_index())),
        future_pass=fut,
        future_ws=g_ws,
    )
    _copy_into(old, merged)
    return old


_TRITON = None
tl = None  # triton.language, bound on first launch (_triton_kernels)


def _merge_counts_body(
    old_c, old_w, new_c, new_w, n_elem, stride_c, stride_w,
    D: tl.constexpr, E: tl.constexpr, HAS_WS: tl.constexpr, BLOCK: tl.constexpr,
):
    # One program merges BLOCK consecutive count elements (E per cell): the
    # cell's newest window over the D shards, the base where it is current,
    # plus the contributions of the shards on that window. Indices within
    # one shard fit int32; each shard's base pointer is offset in int64.
    pid = tl.program_id(0)
    i = pid * BLOCK + tl.arange(0, BLOCK)
    m = i < n_elem
    cell = i // E
    sw = stride_w.to(tl.int64)
    sc = stride_c.to(tl.int64)
    if HAS_WS:
        g = tl.load(new_w + cell, mask=m, other=0)
        for d in tl.static_range(1, D):
            g = tl.maximum(g, tl.load(new_w + d * sw + cell, mask=m, other=0))
        old_cur = (tl.load(old_w + cell, mask=m, other=0) == g) & m
    else:
        old_cur = m
    base = tl.load(old_c + i, mask=old_cur, other=0)
    acc = tl.zeros((BLOCK,), dtype=tl.int32)
    for d in tl.static_range(D):
        if HAS_WS:
            cur = (tl.load(new_w + d * sw + cell, mask=m, other=0) == g) & m
        else:
            cur = m
        nc = tl.load(new_c + d * sc + i, mask=cur, other=0)
        acc += tl.where(cur, nc - base, 0)
    tl.store(old_c + i, base + acc, mask=m)


def _merge_cells_body(
    old_m, old_w, new_m, new_w, n_cells, stride_w, big,
    D: tl.constexpr, HAS_MIN: tl.constexpr, BLOCK: tl.constexpr,
):
    # After the counts: per cell the merged window start and the min RT
    # over the base and the shards on it (reads the base's start before
    # writing it).
    pid = tl.program_id(0)
    c = pid * BLOCK + tl.arange(0, BLOCK)
    m = c < n_cells
    sw = stride_w.to(tl.int64)
    g = tl.load(new_w + c, mask=m, other=0)
    for d in tl.static_range(1, D):
        g = tl.maximum(g, tl.load(new_w + d * sw + c, mask=m, other=0))
    if HAS_MIN:
        old_cur = (tl.load(old_w + c, mask=m, other=0) == g) & m
        mn = tl.load(old_m + c, mask=old_cur, other=big)
        for d in tl.static_range(D):
            cur = (tl.load(new_w + d * sw + c, mask=m, other=0) == g) & m
            mn = tl.minimum(mn, tl.load(new_m + d * sw + c, mask=cur, other=big))
        tl.store(old_m + c, mn, mask=m)
    tl.store(old_w + c, g, mask=m)


def _triton_kernels():
    """Compile-on-first-use: triton is imported here, never at module
    import (the CPU tests import every module of the package)."""
    global _TRITON, tl
    if _TRITON is None:
        import triton
        import triton.language

        tl = triton.language
        _TRITON = (triton.jit(_merge_counts_body), triton.jit(_merge_cells_body))
    return _TRITON


def _contig_i32(t: torch.Tensor, what: str, shape) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous() or not t.is_cuda or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: need a contiguous CUDA int32 tensor of shape {tuple(shape)}")


def _merge_stats_cuda(old: StatsState, new: StatsState) -> StatsState:
    d_count = new.threads.shape[0]
    r = old.n_rows
    for (name, a), b in zip(_flat_fields(old), (t for _, t in _flat_fields(new))):
        _contig_i32(a, f"old.{name}", a.shape)
        _contig_i32(b, f"new.{name}", (d_count,) + tuple(a.shape))
    counts_k, cells_k = _triton_kernels()
    block = 1024

    def launch(oc, om, ow, nc, nm, nw, e, has_min, has_ws):
        # The counts first: their merge reads the base's window starts,
        # which the cell pass then overwrites.
        n_elem = oc.numel()
        counts_k[((n_elem + block - 1) // block,)](
            oc, ow, nc, nw, n_elem, n_elem, ow.numel(), D=d_count, E=e, HAS_WS=has_ws, BLOCK=block,
        )
        if has_ws:
            cells = ow.numel()
            cells_k[((cells + block - 1) // block,)](
                om, ow, nm, nw, cells, cells, _I32_MAX, D=d_count, HAS_MIN=has_min, BLOCK=block,
            )

    for o, w in ((old.second, new.second), (old.minute, new.minute)):
        launch(o.counts, o.min_rt, o.window_start, w.counts, w.min_rt, w.window_start, NUM_EVENTS, True, True)
    launch(old.future_pass, old.future_pass, old.future_ws, new.future_pass, new.future_pass, new.future_ws,
           1, False, True)
    launch(old.threads, old.threads, old.threads, new.threads, new.threads, new.threads, 1, False, False)
    merge_stats_across.launches += 1
    return old


def _flat_fields(stats: StatsState):
    for name in ("second", "minute"):
        for f, t in zip(ma.MetricArrayState._fields, getattr(stats, name)):
            yield f"{name}.{f}", t
    for name in ("threads", "future_pass", "future_ws"):
        yield name, getattr(stats, name)


# ---------------------------------------------------------------------------
# K14: the breaker merge
# ---------------------------------------------------------------------------


def merge_breaker(ddev: DegradeTableDevice, base: DegradeDynState, new: DegradeDynState, now: int
                  ) -> DegradeDynState:
    """Merge the shards' breaker states (``new``, stacked) against their
    common base, written over ``base`` in place. A transition happens on
    the one shard that carried its op, so a shard whose state changed
    offers it and the largest offer wins (OPEN over CLOSED: a plain max
    would lose HALF_OPEN -> CLOSED and wedge the breaker); windows merge
    rollover aware as the stats do; the retry deadline is the max. A
    CLOSED breaker whose MERGED counts cross the threshold (errors spread
    one per shard) opens at ``now + retry_ms``."""
    if base.state.is_cuda:
        return _merge_breaker_cuda(ddev, base, new, now)
    return merge_breaker_plain(ddev, base, new, now)


merge_breaker.launches = 0


def merge_breaker_plain(ddev: DegradeTableDevice, base: DegradeDynState, new: DegradeDynState, now: int
                        ) -> DegradeDynState:
    """Plain PyTorch version of :func:`merge_breaker`."""
    coll = ShardCollectives(new.state.shape[0])
    ax = coll.axis_index()
    best = coll.pmax(torch.where(new.state[d] != base.state, new.state[d], -1) for d in ax)
    state = torch.where(best >= 0, best, base.state)
    g_ws = coll.pmax(new.ws[d] for d in ax)
    cur = base.ws == g_ws
    base_bad = torch.where(cur, base.bad, 0)
    base_total = torch.where(cur, base.total, 0)
    bad = add_i32(base_bad, coll.psum(torch.where(new.ws[d] == g_ws, sub_i32(new.bad[d], base_bad), 0) for d in ax))
    total = add_i32(base_total, coll.psum(
        torch.where(new.ws[d] == g_ws, sub_i32(new.total[d], base_total), 0) for d in ax))
    next_retry = coll.pmax(new.next_retry[d] for d in ax)
    trip = _dt.trip_condition(ddev.grade, ddev.threshold, ddev.slow_ratio, bad.to(torch.float32),
                              total.to(torch.float32))
    cross = (state == _dt.CLOSED) & (total >= ddev.min_request) & trip
    merged = DegradeDynState(
        state=torch.where(cross, _dt.OPEN, state).to(torch.int32),
        next_retry=torch.where(cross, add_i32(now, ddev.retry_ms), next_retry),
        bad=bad, total=total, ws=g_ws,
    )
    _copy_into(base, merged)
    return base


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _mb_lib() -> ctypes.CDLL:
    lib = cuda_build.load("mesh_merge_breaker")
    if not getattr(lib, "_typed", False):
        lib.mesh_merge_breaker.argtypes = [_P] * 10 + [_I, _I] + [_P] * 5 + [_I, _P]
        lib.mesh_merge_breaker.restype = _I
        lib._typed = True
    return lib


def _merge_breaker_cuda(ddev, base, new, now) -> DegradeDynState:
    nd = ddev.n_rules
    d_count = new.state.shape[0]
    for name, t in zip(DegradeDynState._fields, base):
        _contig_i32(t, f"base.{name}", (nd,))
    for name, t in zip(DegradeDynState._fields, new):
        _contig_i32(t, f"new.{name}", (d_count, nd))
    for name in ("grade", "min_request", "retry_ms"):
        _contig_i32(getattr(ddev, name), f"ddev.{name}", (nd,))
    for name in ("threshold", "slow_ratio"):
        t = getattr(ddev, name)
        if t.dtype != torch.float32 or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"ddev.{name}: need a contiguous CUDA float32 tensor")
    cuda_build.check(
        _mb_lib().mesh_merge_breaker(
            *(t.data_ptr() for t in base), *(t.data_ptr() for t in new), nd, d_count,
            ddev.grade.data_ptr(), ddev.threshold.data_ptr(), ddev.slow_ratio.data_ptr(),
            ddev.min_request.data_ptr(), ddev.retry_ms.data_ptr(), int(now), ma.stream_of(base.state),
        ),
        "mesh_merge_breaker",
    )
    merge_breaker.launches += 1
    return base


# ---------------------------------------------------------------------------
# the batch split, the cross-shard allocation
# ---------------------------------------------------------------------------


def shard_batch(batch: FlushBatch, n_shards: int) -> List[FlushBatch]:
    """A global batch as ``n_shards`` contiguous blocks of entries and of
    exits (views), as ``shard_map`` with ``P(axis)`` cuts it; ``now`` is
    replicated. Entries and exits must divide evenly."""
    n, m = batch.e_valid.shape[0], batch.x_valid.shape[0]
    if n % n_shards or m % n_shards:
        raise ValueError(f"shard_batch: {n} entries and {m} exits do not split into {n_shards} shards")
    nl, ml = n // n_shards, m // n_shards
    out = []
    for d in range(n_shards):
        f = {"now": batch.now}
        for name in FlushBatch._fields[1:]:
            t = getattr(batch, name)
            f[name] = t[d * nl : (d + 1) * nl] if name.startswith("e_") else t[d * ml : (d + 1) * ml]
        out.append(FlushBatch(**f))
    return out


def unshard_results(parts: List[FlushResult]) -> FlushResult:
    """Per-shard results concatenated in shard order (``out_specs=P(axis)``)."""
    return FlushResult(*(
        None if getattr(parts[0], f) is None else torch.cat([getattr(p, f) for p in parts])
        for f in FlushResult._fields
    ))


def _before(coll: ShardCollectives, demand: torch.Tensor) -> torch.Tensor:
    """Each shard's exclusive prefix of ``demand`` (stacked) over the
    shards before it: its offset into the global charge stream."""
    all_d = coll.all_gather(demand[d] for d in coll.axis_index())
    return torch.stack([
        coll.psum(all_d[j] for j in range(d)) if d else torch.zeros_like(all_d[0]) for d in coll.axis_index()
    ])


def cluster_allocate(coll: ShardCollectives, demand: torch.Tensor, capacity, with_before: bool = False):
    """Greedy shard-indexed allocation of global capacity: shard i may
    admit ``min(demand_i, capacity - sum_{j<i} demand_j)``. ``demand`` is
    stacked over the shards; returns the stacked grants, or ``(grant,
    before)`` with each shard's exclusive demand prefix."""
    before = _before(coll, demand)
    left = torch.clamp(sub_i32(capacity, before), min=0)
    grant = torch.minimum(demand, left)
    return (grant, before) if with_before else grant


# ---------------------------------------------------------------------------
# K15: the budget split of the two demotion passes
# ---------------------------------------------------------------------------


def _split_and_spend(n_shards: int, batch: FlushBatch, r_rows: int, mask: torch.Tensor, unit: torch.Tensor,
                     cap_slot: torch.Tensor) -> torch.Tensor:
    """The mesh-budget recipe behind both demotions, keyed per check row:
    per shard the participating slots' ``unit`` per row, the cross-shard
    exclusive prefix ``before``, and within the shard the row's charge
    spent in (ts, arrival) order; a slot is kept iff ``before + prefix +
    acquire <= cap_slot`` (its own cap, so two rules sharing a row each
    hold their own count), an entry iff every participating slot is.
    Sorted as the kernel sorts: one int64 key (shard, row, ts), then
    position; the prefix restarts at each shard's first position."""
    n, k = batch.e_rule_gid.shape
    nk = n * k
    dev = batch.e_valid.device
    coll = ShardCollectives(n_shards)
    pos = torch.arange(nk, device=dev)
    shard = pos // (nk // n_shards)
    eidx = pos // k
    row_c = batch.e_check_row.reshape(-1).clamp(0, r_rows - 1).long()
    zero = torch.zeros_like(unit)
    demand = torch.zeros(n_shards * r_rows + 1, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(mask, shard * r_rows + row_c, n_shards * r_rows), torch.where(mask, unit, zero)
    )[: n_shards * r_rows].view(n_shards, r_rows)
    before = _before(coll, demand)
    row_key = torch.where(mask, row_c, r_rows)
    hi = shard * (r_rows + 1) + row_key
    ts = batch.e_ts[eidx].to(torch.int64)
    p_s = torch.sort(hi * 2**32 + ts + 2**31, stable=True).indices
    hi_s, m_s = hi[p_s], mask[p_s]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    new_grp = torch.cat([one, hi_s[1:] != hi_s[:-1]])
    # JAX takes the prefix on each chip over that chip's slots alone: shard
    # d fills sorted positions [d nk/D, (d+1) nk/D), so one row each. A
    # prefix over all shards differs once their units pass 2**31.
    prefix = _flush.segment_excl_cumsum(
        new_grp.view(n_shards, -1), torch.where(m_s, unit[p_s], zero).view(n_shards, -1)).view(-1)
    charged = add_i32(add_i32(before[shard[p_s], row_key[p_s].clamp(0, r_rows - 1)], prefix),
                      batch.e_acquire[eidx[p_s]])
    keep_slot = torch.ones(nk, dtype=torch.bool, device=dev)
    keep_slot[p_s] = ~m_s | (charged <= cap_slot[p_s])
    return keep_slot.view(n, k).all(dim=1)


def mesh_split_spend(n_shards: int, stats: StatsState, flow_dev: FlowTableDevice, batch: FlushBatch,
                     grant: bool, live: Optional[torch.Tensor] = None,
                     occ_slot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-entry keep mask of one demotion pass over the global batch
    (all shards): ``grant`` caps each DEFAULT flow rule's admissions of
    the budgeted entries ``live`` (bool [N]) at the global grant, against
    the post-exit ``stats`` (QPS: ``count - floor(passQps)``, spending
    ``acquire``; THREAD: ``count - curThreadNum``, spending 1); otherwise
    it caps the borrowing slots ``occ_slot`` (bool [N, K]) at the global
    borrow budget ``floor(count x interval) - waiting``, against the
    pre-exit ``stats``. See :func:`_split_and_spend`."""
    if batch.e_valid.is_cuda:
        return _mesh_split_spend_cuda(n_shards, stats, flow_dev, batch, grant, live, occ_slot)
    return mesh_split_spend_plain(n_shards, stats, flow_dev, batch, grant, live, occ_slot)


mesh_split_spend.launches = 0


def mesh_split_spend_plain(n_shards, stats, flow_dev, batch, grant, live=None, occ_slot=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`mesh_split_spend`."""
    n, k = batch.e_rule_gid.shape
    r_rows = stats.n_rows
    dev = batch.e_valid.device
    f32 = torch.float32
    interval_sec = torch.tensor(_flush._interval_sec(), dtype=f32, device=dev)
    gid_f = batch.e_rule_gid.reshape(-1)
    row_f = batch.e_check_row.reshape(-1)
    eidx = torch.arange(n * k, device=dev) // k
    gid_c = gid_f.clamp(0, flow_dev.n_rules - 1).long()
    row_fc = row_f.clamp(0, r_rows - 1)
    acq = batch.e_acquire[eidx]
    count = flow_dev.count[gid_c]
    if grant:
        is_qps = flow_dev.grade[gid_c] == C.FLOW_GRADE_QPS
        mask = ((gid_f >= 0) & (row_f >= 0) & batch.e_valid[eidx] & live[eidx]
                & (flow_dev.behavior[gid_c] == C.CONTROL_BEHAVIOR_DEFAULT))
        unit = torch.where(is_qps, acq, 1).to(torch.int32)
        sums, _ = ma.window_reduce_plain(_nodes.SECOND_CFG, stats.second, batch.now, rows=row_fc)
        base = torch.where(is_qps, torch.floor(sums[:, MetricEvent.PASS].to(f32) / interval_sec),
                           stats.threads[row_fc.long()].to(f32))
        cap = torch.floor(count) - base
    else:
        mask = occ_slot.reshape(-1)
        unit = acq
        waiting = waiting_tokens(stats, batch.now)[row_fc.long()]
        cap = torch.floor(count * interval_sec) - waiting.to(f32)
    return _split_and_spend(n_shards, batch, r_rows, mask, unit, f32_to_i32(torch.clamp(cap, min=0.0)))


# Slots of K15's one-block route (the C side takes at most 8,192): above it
# prep, one CUB sort, the decisions and the demand's reset. On the H100 the
# one block's device time ties the many-block route's at 1,024 slots and
# is 1.8x it at 2,048 (chip_smoke.py phase 2f's routes).
MESH_SPLIT_SMALL_MAX = 1024


class _MsArgs(ctypes.Structure):
    """The ``MsArgs`` of ``csrc/mesh_budget.cu``, field for field."""

    _fields_ = [(name, _P) for name in (
        "gid", "crow", "e_valid", "e_ts", "e_acq", "live", "occ_slot", "f_grade", "f_count", "f_behavior",
        "sec_counts", "sec_ws", "threads", "fpass", "fws", "demand", "keep",
    )] + [(name, _I) for name in (
        "grant", "n", "k", "n_shards", "n_rows", "nr", "nb", "ne", "interval_ms", "slab_b", "now", "small_max",
    )] + [("interval_sec", _F)]


class _McArgs(ctypes.Structure):
    """``McArgs`` of ``csrc/mesh_budget.cu``, field for field."""

    _fields_ = [(name, _P) for name in (
        "valid", "row", "ts", "eidx", "acquire", "sec_counts", "sec_ws", "ppc",
    )] + [(name, _I) for name in ("s", "n_rows", "nb", "ne", "interval_ms", "now", "small_max")]


def _mb2_lib() -> ctypes.CDLL:
    lib = cuda_build.load("mesh_budget")
    if not getattr(lib, "_typed", False):
        lib.mesh_split_workspace.argtypes = [ctypes.POINTER(_MsArgs)]
        lib.mesh_charge_workspace.argtypes = [_I]
        for f in (lib.mesh_split_workspace, lib.mesh_charge_workspace):
            f.restype = ctypes.c_longlong
        lib.mesh_split.argtypes = [ctypes.POINTER(_MsArgs), _P, ctypes.c_longlong, _P]
        lib.mesh_charge.argtypes = [ctypes.POINTER(_McArgs), _P, ctypes.c_longlong, _P]
        for f in (lib.mesh_split, lib.mesh_charge):
            f.restype = _I
        lib._typed = True
    return lib


def _check_split_tables(flow_dev: FlowTableDevice, tensors: Tuple[torch.Tensor, ...]) -> None:
    """The rule table and the stats K15 reads, on every call: the mesh step
    passes a new stats view each time."""
    nr = flow_dev.n_rules
    for name in ("grade", "count", "behavior"):
        t = getattr(flow_dev, name)
        want = torch.float32 if name == "count" else torch.int32
        if t.dtype != want or not t.is_contiguous() or not t.is_cuda or tuple(t.shape) != (nr,):
            raise ValueError(f"flow_dev.{name}: need a contiguous CUDA {want} tensor of shape ({nr},)")
    for t in tensors:
        _contig_i32(t, "stats", t.shape)


def _mesh_split_spend_cuda(n_shards, stats, flow_dev, batch, grant, live, occ_slot) -> torch.Tensor:
    """K15 in one host call: one block up to MESH_SPLIT_SMALL_MAX slots,
    else four launches and CUB's sort; the demand per (shard, row) lives
    in the zeroed scratch, which the call leaves zeroed."""
    n, k = batch.e_rule_gid.shape
    nk = n * k
    r_rows = stats.n_rows
    if nk % n_shards:
        raise ValueError(f"mesh_split_spend: {n} entries do not split into {n_shards} shards")
    if n_shards * (r_rows + 1) >= 2**31:
        raise ValueError("mesh_split_spend: shards x rows exceed the 31-bit sort key")
    if nk >= 2**28:
        raise ValueError("mesh_split_spend: at most 2**28 - 1 slots a call")
    for name in ("e_rule_gid", "e_check_row"):
        _contig_i32(getattr(batch, name), f"batch.{name}", (n, k))
    for name in ("e_ts", "e_acquire"):
        _contig_i32(getattr(batch, name), f"batch.{name}", (n,))
    ma._bool(batch.e_valid, "batch.e_valid", n)
    dev = batch.e_valid.device
    if grant:
        ma._bool(live, "live", n)
        sec = stats.second
        _check_split_tables(flow_dev, (sec.counts, sec.window_start, stats.threads))
        if tuple(stats.threads.shape) != (r_rows,) or tuple(sec.window_start.shape) != tuple(sec.counts.shape[:2]):
            raise ValueError("stats: the gauge and the second window need R rows")
        win = (sec.counts, sec.window_start, stats.threads, None, None)
        geom = (sec.counts.shape[1], NUM_EVENTS, _nodes.SECOND_CFG.interval_ms, 0)
    else:
        if occ_slot.dtype != torch.bool or not occ_slot.is_contiguous() or tuple(occ_slot.shape) != (n, k):
            raise ValueError("occ_slot: need a contiguous bool tensor of shape (N, K)")
        _check_split_tables(flow_dev, (stats.future_pass, stats.future_ws))
        if stats.future_ws.shape != stats.future_pass.shape:
            raise ValueError("stats: the future slab's starts and counts differ in shape")
        win = (None, None, None, stats.future_pass, stats.future_ws)
        geom = (0, 0, 0, stats.future_pass.shape[1])
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    if nk == 0:
        return keep
    ptr = lambda t: None if t is None else t.data_ptr()
    a = _MsArgs(
        *map(ptr, (batch.e_rule_gid, batch.e_check_row, batch.e_valid, batch.e_ts, batch.e_acquire,
                   live if grant else None, None if grant else occ_slot, flow_dev.grade, flow_dev.count,
                   flow_dev.behavior, *win)),
        None, keep.data_ptr(), 1 if grant else 0, n, k, n_shards, r_rows, flow_dev.n_rules, geom[0], geom[1], geom[2],
        geom[3], int(batch.now), MESH_SPLIT_SMALL_MAX, _flush._interval_sec(),
    )
    lib = _mb2_lib()
    st = ma.stream_of(batch.e_valid)
    with cuda_build.scratch(dev, st, int(lib.mesh_split_workspace(ctypes.byref(a))), 4 * n_shards * r_rows) as (
            buf, size, zero):
        a.demand = zero
        cuda_build.check(lib.mesh_split(ctypes.byref(a), buf, size, st), "mesh_split")
    mesh_split_spend.launches += 1
    return keep


def _demote_over_grant(n_shards, stats_x, flow_dev, batch, flow_live) -> torch.Tensor:
    """Cap each DEFAULT-behavior flow rule's admissions at the globally
    allocated grant (budgeting at the flow level: ``flow_live`` passed
    every stage up to the breakers); the per-entry keep mask. ``stats_x``
    is the global post-exit view."""
    return mesh_split_spend(n_shards, stats_x, flow_dev, batch, True, live=flow_live)


def _demote_over_borrow(n_shards, stats_pre, flow_dev, batch, occ_slot) -> torch.Tensor:
    """Cap occupy borrows (the slots that borrowed in the demand pass) at
    the global borrow budget, against the pre-exit state's waiting
    tokens; the per-entry keep mask."""
    return mesh_split_spend(n_shards, stats_pre, flow_dev, batch, False, occ_slot=occ_slot)


# ---------------------------------------------------------------------------
# K16 and the global scans
# ---------------------------------------------------------------------------


def mesh_shaping_charge(second: ma.MetricArrayState, shaping: ShapingBatch, now: int) -> torch.Tensor:
    """Each global shaping item's passQps input (int32 [S]): its row's
    windowed PASS plus the acquire of the earlier entries of the row in
    (row, ts, item) order, charged over every valid item whatever its
    liveness (as the single-device flow admission charges blocked
    entries). Valid items' rows must lie in ``[0, R)``, as the engine's
    check rows do."""
    if shaping.valid.is_cuda:
        return _mesh_shaping_charge_cuda(second, shaping, now)
    return mesh_shaping_charge_plain(second, shaping, now)


mesh_shaping_charge.launches = 0


def mesh_shaping_charge_plain(second: ma.MetricArrayState, shaping: ShapingBatch, now: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`mesh_shaping_charge`."""
    s = shaping.valid.shape[0]
    r_rows = second.window_start.shape[0]
    dev = shaping.valid.device
    rkey = torch.where(shaping.valid, shaping.row, r_rows).to(torch.int64)
    p_s = torch.sort(rkey * 2**32 + shaping.ts.to(torch.int64) + 2**31, stable=True).indices
    rk_s, ei_s = rkey[p_s], shaping.eidx[p_s]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    change = rk_s[1:] != rk_s[:-1]
    new_grp = torch.cat([one, change])
    last_of_ent = torch.cat([change, one]) | torch.cat([ei_s[1:] != ei_s[:-1], one])
    consumed = _flush._segment_consumed(
        new_grp, last_of_ent, torch.where(shaping.valid[p_s], shaping.acquire[p_s], 0).to(torch.int32))
    sums, _ = ma.window_reduce_plain(_nodes.SECOND_CFG, second, now, rows=rk_s.clamp(0, r_rows - 1).to(torch.int32))
    ppc = torch.zeros(s, dtype=torch.int32, device=dev)
    ppc[p_s] = add_i32(sums[:, MetricEvent.PASS], consumed)
    return ppc


# The one-block route's largest batch (the C side takes up to 8,192).
MESH_CHARGE_SMALL_MAX = 1024


@functools.lru_cache(maxsize=64)
def _charge_workspace(s: int) -> int:
    """Bytes of K16's many-block workspace for ``s`` items (CUB's storage
    depends on the count alone)."""
    return int(_mb2_lib().mesh_charge_workspace(s))


def _mesh_shaping_charge_cuda(second, shaping, now) -> torch.Tensor:
    """K16 in one host call: one block up to MESH_CHARGE_SMALL_MAX items,
    else mc_prep, CUB's sort and mc_decide in the scratch buffer."""
    s = shaping.valid.shape[0]
    for name, t in zip(ShapingBatch._fields, shaping):
        want = torch.bool if name == "valid" else torch.int32
        if t.dtype != want or not t.is_contiguous() or not t.is_cuda or tuple(t.shape) != (s,):
            raise ValueError(f"shaping.{name}: need a contiguous CUDA {want} tensor of shape ({s},)")
    ma.check_window(_nodes.SECOND_CFG, second, "second")
    dev = shaping.valid.device
    ppc = torch.empty(s, dtype=torch.int32, device=dev)
    if s == 0:
        return ppc
    r_rows = second.n_rows
    if r_rows == 0:
        raise IndexError("mesh_shaping_charge: a second window with no rows")
    if s >= 2**28:
        raise ValueError("mesh_shaping_charge: at most 2**28 - 1 items a call")
    a = _McArgs(shaping.valid.data_ptr(), shaping.row.data_ptr(), shaping.ts.data_ptr(), shaping.eidx.data_ptr(),
                shaping.acquire.data_ptr(), second.counts.data_ptr(), second.window_start.data_ptr(), ppc.data_ptr(),
                s, r_rows, _nodes.SECOND_CFG.sample_count, NUM_EVENTS, _nodes.SECOND_CFG.interval_ms, int(now),
                MESH_CHARGE_SMALL_MAX)
    lib = _mb2_lib()
    st = ma.stream_of(shaping.valid)
    if s <= MESH_CHARGE_SMALL_MAX:
        cuda_build.check(lib.mesh_charge(ctypes.byref(a), None, 0, st), "mesh_charge")
    else:
        with cuda_build.scratch(dev, st, _charge_workspace(s)) as (buf, size, _):
            cuda_build.check(lib.mesh_charge(ctypes.byref(a), buf, size, st), "mesh_charge")
    mesh_shaping_charge.launches += 1
    return ppc


def _in_batch(eidx: torch.Tensor, n: int) -> torch.Tensor:
    """Items whose entry lies in the global batch (it has an owner shard)."""
    return (eidx >= 0) & (eidx < n)


def _global_param_scan(pdyn: ParamDynState, param_g: ParamBatch, live_up: torch.Tensor, rounds: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The hot-param recurrence (K10) once, on the global item batch,
    against the replicated state (updated in place): exits release their
    per-value thread slots first, items of entries the upstream stages
    blocked (``live_up`` [N], the shards' bits) are dropped. Returns the
    global (param_ok [N], wait_param [N]), each entry's AND and max over
    its items, and the live item mask."""
    n = live_up.shape[0]
    pr = pdyn.threads.shape[0]
    xr = param_g.exit_rows
    x_in = (xr >= 0) & (xr < pr)
    pdyn.threads.index_add_(0, torch.where(x_in, xr, 0).long(), -x_in.to(torch.int32))
    eidx = param_g.eidx.clamp(0, max(n - 1, 0)).long()
    valid = param_g.valid & _in_batch(param_g.eidx, n) & live_up[eidx]
    _, ok_s, wait_s = run_param(pdyn, param_g._replace(valid=valid), rounds)
    dump = torch.where(valid, eidx, n)
    ok = torch.ones(n + 1, dtype=torch.int32, device=live_up.device)
    ok.scatter_reduce_(0, dump, ok_s.to(torch.int32), reduce="amin")
    wait = torch.zeros(n + 1, dtype=torch.int32, device=live_up.device)
    wait.scatter_reduce_(0, dump, wait_s, reduce="amax")
    return ok[:n].bool(), wait[:n], valid


def _global_shaping_scan(stats_x: StatsState, flow_dev, flow_dyn, shaping_g: ShapingBatch, now: int,
                         live_up: torch.Tensor, rounds: int = 0):
    """The shaping recurrence (K9) once, on the global item batch, against
    the replicated pacer state (updated in place): the global charge (K16)
    is its passQps input, the previous second's pass comes through K9's
    input gather, items of upstream-blocked entries do not advance the
    pacers. Returns (live item mask [S], ok [S], wait_ms [S])."""
    n = live_up.shape[0]
    s = shaping_g.valid.shape[0]
    ppc = mesh_shaping_charge(stats_x.second, shaping_g, now)
    # Item order throughout: the charge is already per item.
    items = shaping_g._replace(valid=shaping_g.valid & _in_batch(shaping_g.eidx, n),
                               flat_pos=torch.arange(s, dtype=torch.int32, device=ppc.device))
    return shaping_stage(flow_dev, flow_dyn, items, live_up, ppc, stats_x.minute, _flush._interval_sec(), rounds)


def _shaping_pre_of(shaping_g: ShapingBatch, live: torch.Tensor, ok_s, wait_s, d: int, n_local: int, k: int):
    """Shard ``d``'s slice of the global shaping verdicts, in its own
    positions (the owner-gated scatter inputs of ``flush_entries``)."""
    eidx = shaping_g.eidx
    owner = torch.div(eidx, n_local, rounding_mode="floor") == d
    lidx = torch.remainder(eidx, n_local).clamp(0, n_local - 1).to(torch.int32)
    lflat = (lidx * k + torch.remainder(shaping_g.flat_pos, k)).to(torch.int32)
    return live & owner, lflat, lidx, ok_s, wait_s


def elect_probes(coll: ShardCollectives, ddyn: DegradeDynState, batch: FlushBatch, flow_live: torch.Tensor
                 ) -> torch.Tensor:
    """One probe per OPEN breaker across the mesh (fromOpenToHalfOpen is
    one CAS, AbstractCircuitBreaker.java:91-110): each shard offers the
    earliest ts of its candidates (entries live through the flow stage,
    the breaker OPEN and due in the pre-exit state), the global (ts,
    shard) minimum wins. Returns the stacked probe_allowed [D, ND]."""
    n_shards = coll.n_shards
    nd = ddyn.state.shape[0]
    n, kd = batch.e_dgid.shape
    dev = batch.e_dgid.device
    gid_f = batch.e_dgid.reshape(-1)
    eidx = torch.arange(n * kd, device=dev) // kd
    shard = eidx // (n // n_shards)
    gid_c = gid_f.clamp(0, nd - 1).long()
    ts = batch.e_ts[eidx]
    cand = (gid_f >= 0) & (gid_f < nd) & flow_live[eidx] & (ddyn.state[gid_c] == _dt.OPEN) & (
        ts >= ddyn.next_retry[gid_c])
    best = torch.full((n_shards * (nd + 1),), _I32_MAX, dtype=torch.int32, device=dev)
    best.scatter_reduce_(0, shard * (nd + 1) + torch.where(cand, gid_c, nd), ts, reduce="amin")
    best = best.view(n_shards, nd + 1)[:, :nd]
    g_ts = coll.pmin(best[d] for d in coll.axis_index())
    g_shard = coll.pmin(torch.where(best[d] == g_ts, d, n_shards) for d in coll.axis_index())
    return torch.stack([(g_ts < _I32_MAX) & (g_shard == d) for d in coll.axis_index()])


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------


class ShardedFlush(NamedTuple):
    """The step of :func:`make_sharded_flush`, callable as ``step(stats,
    flow_dev, flow_dyn, ddev, ddyn, pdyn, sysdev, batch[, shaping_g][,
    param_g])``."""

    mesh: object
    occupy_timeout_ms: int
    with_shaping: bool
    with_param: bool
    shaping_rounds: int
    param_rounds: int

    def __call__(self, stats, flow_dev, flow_dyn, ddev, ddyn, pdyn, sysdev, batch, *extra):
        names = [kw for kw, on in (("shaping_g", self.with_shaping), ("param_g", self.with_param)) if on]
        if len(extra) != len(names):
            raise TypeError(f"sharded step: expected {names}, got {len(extra)} extra batches")
        return sharded_step(self.mesh.n_shards, stats, flow_dev, flow_dyn, ddev, ddyn, pdyn, sysdev, batch,
                            occupy_timeout_ms=self.occupy_timeout_ms, shaping_rounds=self.shaping_rounds,
                            param_rounds=self.param_rounds, **dict(zip(names, extra)))


def make_sharded_flush(mesh, occupy_timeout_ms: int = 500, with_shaping: bool = False, with_param: bool = False,
                       shaping_rounds: int = 0, param_rounds: int = 0) -> ShardedFlush:
    """The full batched step over ``mesh``'s shards (``parallel/mesh.py``):
    entries and exits data-parallel over the shards, counters and rule
    tables replicated, the windows and breakers merged after the shards'
    steps so the step ends with one global state. Flow budgets (with
    occupy borrows) are conserved across the shards in two passes: the
    demand pass decides without writing, the budget split demotes what
    exceeds the global grants, the real pass decides again. With
    ``with_shaping`` / ``with_param`` the step takes a ShapingBatch /
    ParamBatch of the GLOBAL items (entry positions global): the
    serializing scans run once on the replicated state. The step returns
    (stats, flow_dyn, ddyn, pdyn, result) like the JAX one."""
    return ShardedFlush(mesh, int(occupy_timeout_ms), bool(with_shaping), bool(with_param), int(shaping_rounds),
                        int(param_rounds))


def sharded_step(
    n_shards: int,
    stats: StatsState,
    flow_dev: FlowTableDevice,
    flow_dyn,
    ddev: DegradeTableDevice,
    ddyn: DegradeDynState,
    pdyn: ParamDynState,
    sysdev: SystemDevice,
    batch: FlushBatch,
    shaping_g: Optional[ShapingBatch] = None,
    param_g: Optional[ParamBatch] = None,
    occupy_timeout_ms: int = 500,
    shaping_rounds: int = 0,
    param_rounds: int = 0,
):
    """One sharded step (see :func:`make_sharded_flush`). ``stats``,
    ``flow_dyn`` (with shaping) and ``pdyn`` (with params) are updated in
    place and returned; the breaker state comes back as a new tuple
    (``ddyn`` is read, not written)."""
    coll = ShardCollectives(n_shards)
    now = batch.now
    shards = shard_batch(batch, n_shards)
    n = batch.e_valid.shape[0]
    n_local, k = n // n_shards, batch.e_rule_gid.shape[1]
    every_stage = dict(ddev=ddev, sysdev=sysdev, occupy_timeout_ms=occupy_timeout_ms, with_occupy=True,
                       with_system=True, with_degrade=True, flow_dyn=flow_dyn, pdyn=pdyn)

    # Matured borrows fold into the windows once, before the shards
    # diverge: the merge base.
    materialize_matured(stats, now)
    waiting_base = stats.future_pass.clone(), stats.future_ws.clone()  # the borrow budget's pre-exit slab
    # Exits per shard, then the post-exit view is made global before any
    # admission (exits apply before every entry check of the flush).
    copies = replicate(stats, n_shards)
    for d, b in enumerate(shards):
        _flush.apply_exit_phase(shard_of(copies, d), b, True)
    stats_x = merge_stats_across(stats, copies)
    # Breaker completions once, on the gathered exits (contiguous shards:
    # the global exit columns in global order).
    ddyn_x = DegradeDynState(*(t.clone() for t in ddyn))
    _dt.breaker_on_exits(ddev, ddyn_x, batch.x_dgid, batch.x_ts, batch.x_rt, batch.x_err, batch.x_valid)

    # The serializing scans on the global item batches, gated by the
    # shards' upstream liveness (authority, system).
    param_pre = shaping_pre = None
    if shaping_g is not None or param_g is not None:
        live_up = []
        for b in shards:
            live0 = b.e_valid & b.e_auth_ok
            sys_ok, _ = _flush.system_check(stats_x, sysdev, b, live0)
            live_up.append(live0 & sys_ok)
        live_up = torch.cat(live_up)
        if param_g is not None:
            p_ok, p_wait, _ = _global_param_scan(pdyn, param_g, live_up, param_rounds)
            param_pre = [(p_ok[d * n_local : (d + 1) * n_local], p_wait[d * n_local : (d + 1) * n_local])
                         for d in range(n_shards)]
            live_up = live_up & p_ok
        if shaping_g is not None:
            sh_live, sh_ok, sh_wait = _global_shaping_scan(stats_x, flow_dev, flow_dyn, shaping_g, now, live_up,
                                                           shaping_rounds)
            shaping_pre = [_shaping_pre_of(shaping_g, sh_live, sh_ok, sh_wait, d, n_local, k)
                           for d in range(n_shards)]

    def pre(d):
        return dict(param_pre=None if param_pre is None else param_pre[d],
                    shaping_pre=None if shaping_pre is None else shaping_pre[d])

    # Pass 1 (no state writes): each shard's flow-level admission demand.
    r1 = unshard_results([
        _flush.flush_entries(stats_x, flow_dev, b, ddyn=ddyn_x, commit=False, **every_stage, **pre(d))[1]
        for d, b in enumerate(shards)
    ])
    # Occupied entries borrow from future windows, not the current budget:
    # they are budgeted apart, against the global borrow allowance.
    budgeted = r1.flow_live & ~r1.occupied
    keep = _demote_over_grant(n_shards, stats_x, flow_dev, batch, budgeted)
    slab = stats._replace(future_pass=waiting_base[0], future_ws=waiting_base[1])
    keep_occ = _demote_over_borrow(n_shards, slab, flow_dev, batch, r1.occ_slot)
    batch2 = batch._replace(e_cluster_ok=batch.e_cluster_ok & (keep | ~budgeted),
                            e_prio=batch.e_prio & r1.occupied & keep_occ)
    probe_allowed = elect_probes(coll, ddyn, batch, r1.flow_live)

    # Pass 2: the real step with the demotions, each shard on its own copy
    # of the post-exit stats and breakers.
    _copy_into(copies, stats_x)
    dcopies = replicate(ddyn_x, n_shards)
    results = []
    for d, b in enumerate(shard_batch(batch2, n_shards)):
        results.append(_flush.flush_entries(shard_of(copies, d), flow_dev, b, ddyn=shard_of(dcopies, d),
                                            probe_allowed=probe_allowed[d], **every_stage, **pre(d))[1])
    result = unshard_results(results)
    if param_g is not None:
        # Per-value thread acquire of the admitted entries' THREAD-grade
        # items (the owner shard's verdict).
        eidx = param_g.eidx.clamp(0, max(n - 1, 0)).long()
        inc = (param_g.valid & _in_batch(param_g.eidx, n) & (param_g.grade == C.FLOW_GRADE_THREAD)
               & result.admitted[eidx])
        pdyn.threads.index_add_(0, torch.where(inc, param_g.prow, 0).long(), inc.to(torch.int32))
    # The bases are the global post-exit views: the merges sum exactly the
    # shards' entry deltas.
    merged = merge_stats_across(stats_x, copies)
    merged_ddyn = merge_breaker(ddev, ddyn_x, dcopies, now)
    return merged, flow_dyn, merged_ddyn, pdyn, result
