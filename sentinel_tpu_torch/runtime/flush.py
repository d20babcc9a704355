"""The flush step on the DEFAULT flow path (port of
``sentinel_tpu/runtime/flush.py``).

One flush applies a batch of ops in three phases, replacing the
per-request slot-chain walk (StatisticSlot + FlowSlot of the reference):

1. **exits/traces**: success, RT, exception and thread release go into
   the window tensors (:func:`apply_exit_phase`);
2. **admission**: every flow rule slot of every entry is checked against
   the post-exit statistics, with the intra-batch sequencing of the JAX
   package: slots are ordered by (check row, ts, arrival) and each one is
   charged the acquire of earlier entries on that row, counted only on
   rows the entry itself accounts on (see the JAX module's docstring);
3. **entry accounting**: pass/block and thread acquire go into the
   windows.

The slice covers what the engine runs with only DEFAULT-behavior flow
rules loaded (the JAX ``with_occupy=False, with_system=False,
with_degrade=False`` specialization): no occupy branch, no system or
authority rules, no breakers, no shaping, no hot parameters. Slots whose
rule behavior is not DEFAULT pass here, as in the JAX ``flow_admission``;
the engine refuses such rules rather than let them pass.

Kernels: :func:`flow_admission` (K4, CUDA C++ ``csrc/flow_admission.cu``)
decides the slots and the verdict tail; it reads the windows through
``metric_array.window_sums`` (K3) and the accounting goes through
``nodes.apply_updates`` (K2). :func:`flush_step` runs
``nodes.materialize_matured`` (K1) first. The rest is torch glue.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core import errors as E
from sentinel_tpu_torch.metrics import metric_array as ma
from sentinel_tpu_torch.metrics import nodes as _nodes
from sentinel_tpu_torch.metrics.events import NUM_EVENTS, MetricEvent
from sentinel_tpu_torch.metrics.nodes import StatsState, apply_updates, materialize_matured
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.rules.flow_table import FlowTableDevice
from sentinel_tpu_torch.utils import cuda_build

_I32_MAX = 2**31 - 1
TOPK_MAX = 8  # the blocked top-K kernel keeps at most this many rows


class FlushBatch(NamedTuple):
    """One encoded batch of ops (padded; *_valid masks padding). Fields
    and layout are the JAX package's, so a JAX batch carries over through
    :func:`batch_from_numpy`."""

    now: int  # flush time (ms rel epoch)
    # --- entries ---
    e_valid: torch.Tensor  # bool [N]
    e_ts: torch.Tensor  # int32 [N]
    e_acquire: torch.Tensor  # int32 [N]
    e_rows: torch.Tensor  # int32 [N, 4]: default, cluster, origin|-1, entry|-1
    e_rule_gid: torch.Tensor  # int32 [N, K], -1 = empty slot
    e_check_row: torch.Tensor  # int32 [N, K], -1 = rule passes trivially
    e_prio: torch.Tensor  # bool [N] (must be all False on this path)
    e_auth_ok: torch.Tensor  # bool [N]
    e_cluster_ok: torch.Tensor  # bool [N]
    e_dgid: torch.Tensor  # int32 [N, KD] (unused on this path)
    # --- exits and traces ---
    x_valid: torch.Tensor  # bool [M]
    x_ts: torch.Tensor  # int32 [M]
    x_count: torch.Tensor  # int32 [M] success delta (0 for trace ops)
    x_rows: torch.Tensor  # int32 [M, 4]
    x_rt: torch.Tensor  # int32 [M] RT delta (0 for trace ops)
    x_err: torch.Tensor  # int32 [M] exception delta
    x_thr: torch.Tensor  # int32 [M] thread delta (-1 exit, 0 trace)
    x_dgid: torch.Tensor  # int32 [M, KD] (unused on this path)


class FlushResult(NamedTuple):
    admitted: torch.Tensor  # bool [N]
    reason: torch.Tensor  # int32 [N], errors.PASS / BLOCK_*
    slot_ok: torch.Tensor  # bool [N, K] per-rule verdicts (block attribution)
    wait_ms: torch.Tensor  # int32 [N] (0 on the DEFAULT path)
    blk_rows: Optional[torch.Tensor] = None  # int32 [k] rows with most blocked acquire
    blk_weight: Optional[torch.Tensor] = None  # int32 [k] their blocked acquire


class Admission(NamedTuple):
    """Output of :func:`flow_admission`."""

    slot_ok: torch.Tensor  # bool [N, K]
    flow_pass: torch.Tensor  # bool [N] AND over the entry's slots
    admitted: torch.Tensor  # bool [N]
    reason: torch.Tensor  # int32 [N]
    blk_rows: Optional[torch.Tensor]  # int32 [k] or None
    blk_weight: Optional[torch.Tensor]  # int32 [k] or None


_BOOL_FIELDS = ("e_valid", "e_prio", "e_auth_ok", "e_cluster_ok", "x_valid")


def batch_from_numpy(b, device) -> FlushBatch:
    """A :class:`FlushBatch` on ``device`` from numpy arrays in the same
    field order (``jax.device_get`` of a JAX ``FlushBatch``)."""
    vals = {"now": int(np.asarray(b[0]))}
    for name, a in zip(FlushBatch._fields[1:], b[1:]):
        dt = np.bool_ if name in _BOOL_FIELDS else np.int32
        vals[name] = torch.tensor(np.asarray(a, dtype=dt), device=device)
    return FlushBatch(**vals)


def _interval_sec() -> float:
    # The JAX code divides by the Python float interval/1000, which JAX
    # weak-types to float32: the compare runs in float32 against that value.
    return float(np.float32(_nodes.SECOND_CFG.interval_ms / 1000.0))


def segment_excl_cumsum(new_grp: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """Exclusive running sum of ``contrib`` restarting at every group start
    (``new_grp`` marks boundaries in an already sorted array), computed as
    the JAX code does: a wrapping int32 exclusive cumsum, minus the running
    max of its group-start values."""
    contrib = contrib.to(torch.int32)
    excl = torch.cumsum(contrib.to(torch.int64), 0).to(torch.int32) - contrib
    base = torch.cummax(torch.where(new_grp, excl, torch.zeros_like(excl)), 0).values
    return excl - base


def _segment_consumed(new_grp, last_of_ent, contrib) -> torch.Tensor:
    """Per-position sum of *prior entries'* contributions in its group: an
    entry's contribution sits at its last slot, so it never charges itself."""
    return segment_excl_cumsum(new_grp, torch.where(last_of_ent, contrib, torch.zeros_like(contrib)))


# ---------------------------------------------------------------------------
# K4: flow admission + verdict tail
# ---------------------------------------------------------------------------


def flow_admission(
    stats: StatsState, flow_dev: FlowTableDevice, batch: FlushBatch, blk_topk: int = 0
) -> Admission:
    """Vectorized FlowRuleChecker + DefaultController.canPass (block iff
    ``curCount + acquire > count``, curCount = ``(int) passQps()`` for the
    QPS grade, ``curThreadNum`` for the thread grade;
    DefaultController.java:49-78), then the verdict tail of
    ``flush_entries``: the per-entry AND, admission (valid, authority and
    token-server verdicts), the reason code, and with ``blk_topk > 0`` the
    ``blk_topk`` cluster rows with the most blocked acquire (weight
    descending, row ascending, zero-weight rows filling up)."""
    if stats.threads.is_cuda:
        return _flow_admission_cuda(stats, flow_dev, batch, blk_topk)
    return flow_admission_plain(stats, flow_dev, batch, blk_topk)


flow_admission.launches = 0


def flow_admission_plain(
    stats: StatsState, flow_dev: FlowTableDevice, batch: FlushBatch, blk_topk: int = 0
) -> Admission:
    """Plain PyTorch version of :func:`flow_admission`."""
    n, k = batch.e_rule_gid.shape
    r_rows = stats.n_rows
    nr = flow_dev.n_rules
    dev = batch.e_valid.device
    i32 = torch.int32

    gid_f = batch.e_rule_gid.reshape(-1)
    row_f = batch.e_check_row.reshape(-1)
    eidx_f = torch.arange(n * k, device=dev) // k
    active = (gid_f >= 0) & (row_f >= 0) & batch.e_valid[eidx_f]
    row_key = torch.where(active, row_f, torch.full_like(row_f, r_rows))
    ts_f = batch.e_ts[eidx_f]
    # (row, ts, pos) order: stable sort by ts, then stable sort by row.
    o1 = torch.sort(ts_f, stable=True).indices
    o2 = torch.sort(row_key[o1], stable=True).indices
    pos_s = o1[o2]
    rk_s = row_key[pos_s]
    ei_s = pos_s // k

    active_s = active[pos_s]
    gid_s = gid_f[pos_s].clamp(0, nr - 1).long()
    acq_s = batch.e_acquire[ei_s]
    grade_s = flow_dev.grade[gid_s]
    count_s = flow_dev.count[gid_s]
    behavior_s = flow_dev.behavior[gid_s]

    one = torch.ones(1, dtype=torch.bool, device=dev)
    grp_change = rk_s[1:] != rk_s[:-1]
    new_grp = torch.cat([one, grp_change])
    last_of_ent = torch.cat([grp_change, one]) | torch.cat([ei_s[1:] != ei_s[:-1], one])

    own_f = torch.zeros(n * k, dtype=torch.bool, device=dev)
    for j in range(4):
        own_f |= row_f == batch.e_rows[:, j][eidx_f]
    own_s = own_f[pos_s]
    zero = torch.zeros_like(acq_s)
    consumed_acq = _segment_consumed(new_grp, last_of_ent, torch.where(own_s, acq_s, zero))
    consumed_cnt = _segment_consumed(new_grp, last_of_ent, own_s.to(i32))

    rk_c = rk_s.clamp(0, r_rows - 1).long()
    sums, _ = ma.window_reduce_plain(_nodes.SECOND_CFG, stats.second, batch.now, rows=rk_s)
    base_pass = sums[:, MetricEvent.PASS]
    base_thread = stats.threads[rk_c]

    interval_sec = torch.tensor(_interval_sec(), dtype=torch.float32, device=dev)
    qps_cur = torch.floor((base_pass + consumed_acq).to(torch.float32) / interval_sec)
    thread_cur = (base_thread + consumed_cnt).to(torch.float32)
    cur = torch.where(grade_s == C.FLOW_GRADE_QPS, qps_cur, thread_cur)
    ok = (cur + acq_s.to(torch.float32)) <= count_s
    ok = ok | ~active_s | (behavior_s != C.CONTROL_BEHAVIOR_DEFAULT)

    slot_ok = torch.ones(n * k, dtype=torch.bool, device=dev)
    slot_ok[pos_s] = ok
    slot_ok = slot_ok.reshape(n, k)
    flow_pass = slot_ok.all(dim=1)

    fpc = flow_pass & batch.e_cluster_ok
    admitted = batch.e_valid & batch.e_auth_ok & fpc
    reason = torch.full((n,), E.PASS, dtype=i32, device=dev)
    reason[batch.e_valid & ~fpc] = E.BLOCK_FLOW
    reason[batch.e_valid & ~batch.e_auth_ok] = E.BLOCK_AUTHORITY
    reason[admitted] = E.PASS

    blk_rows = blk_weight = None
    if blk_topk > 0:
        blocked_w = torch.where(batch.e_valid & ~admitted, batch.e_acquire, 0).to(i32)
        crow = batch.e_rows[:, 1].clamp(0, r_rows - 1)
        scat = torch.where(blocked_w > 0, crow, torch.full_like(crow, r_rows)).long()
        dense = torch.zeros(r_rows + 1, dtype=i32, device=dev).index_add_(0, scat, blocked_w)
        top = torch.sort(dense[:r_rows], descending=True, stable=True)
        kk = min(blk_topk, r_rows)
        blk_weight = top.values[:kk].to(i32)
        blk_rows = top.indices[:kk].to(i32)
    return Admission(slot_ok, flow_pass, admitted, reason, blk_rows, blk_weight)


_P = ctypes.c_void_p
_I = ctypes.c_int


def _fa_lib() -> ctypes.CDLL:
    lib = cuda_build.load("flow_admission")
    if not getattr(lib, "_typed", False):
        lib.flow_admission_prep.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P]
        lib.flow_admission_gather.argtypes = [_P, _P, _I, _P, _P]
        lib.flow_admission_tiles.argtypes = [_I]
        lib.flow_admission_topk_blocks.argtypes = [_I]
        lib.flow_admission_decide.argtypes = (
            [_P] * 10 + [_I, _I, _I, _I] + [_P, _P, _P, _P, _I, _P, ctypes.c_float, _I]
            + [_P] * 16
        )
        for f in (
            lib.flow_admission_prep, lib.flow_admission_gather, lib.flow_admission_tiles,
            lib.flow_admission_topk_blocks, lib.flow_admission_decide,
        ):
            f.restype = _I
        lib._typed = True
    return lib


def _check_batch_cuda(batch: FlushBatch) -> None:
    for name in FlushBatch._fields[1:]:
        t = getattr(batch, name)
        want = torch.bool if name in _BOOL_FIELDS else torch.int32
        if t.dtype != want or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"batch.{name}: need a contiguous CUDA {want} tensor")


def _flow_admission_cuda(stats, flow_dev, batch, blk_topk) -> Admission:
    _check_batch_cuda(batch)
    if not 0 <= blk_topk <= TOPK_MAX:
        raise ValueError(f"blk_topk must lie in [0, {TOPK_MAX}]")
    for name in ("grade", "count", "behavior"):
        t = getattr(flow_dev, name)
        if not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"flow_dev.{name}: need a contiguous CUDA tensor")
    if stats.threads.dtype != torch.int32 or not stats.threads.is_contiguous():
        raise ValueError("stats.threads: need a contiguous int32 tensor")
    lib = _fa_lib()
    n, k = batch.e_rule_gid.shape
    nk = n * k
    r_rows = stats.n_rows
    dev = batch.e_valid.device
    st = ma.stream_of(batch.e_valid)
    i32 = torch.int32

    row_key = torch.empty(nk, dtype=i32, device=dev)
    ts_f = torch.empty(nk, dtype=i32, device=dev)
    cuda_build.check(
        lib.flow_admission_prep(
            batch.e_rule_gid.data_ptr(), batch.e_check_row.data_ptr(), batch.e_valid.data_ptr(),
            batch.e_ts.data_ptr(), nk, k, r_rows, row_key.data_ptr(), ts_f.data_ptr(), st,
        ),
        "flow_admission_prep",
    )
    perm1 = torch.sort(ts_f, stable=True).indices
    rk1 = torch.empty(nk, dtype=i32, device=dev)
    cuda_build.check(
        lib.flow_admission_gather(perm1.data_ptr(), row_key.data_ptr(), nk, rk1.data_ptr(), st),
        "flow_admission_gather",
    )
    rk_s, perm2 = torch.sort(rk1, stable=True)
    pass_sums = ma.window_sums(_nodes.SECOND_CFG, stats.second, batch.now, rows=rk_s)

    tiles = lib.flow_admission_tiles(nk)
    topk_blocks = lib.flow_admission_topk_blocks(r_rows)
    scratch = torch.empty(nk * 5 + tiles * 4, dtype=i32, device=dev)
    pos_s = scratch[:nk]
    contrib = scratch[nk : 3 * nk]
    excl = scratch[3 * nk : 5 * nk]
    partial = scratch[5 * nk : 5 * nk + 2 * tiles]
    partial_max = scratch[5 * nk + 2 * tiles :]
    new_grp = torch.empty(nk, dtype=torch.uint8, device=dev)
    slot_ok = torch.empty((n, k), dtype=torch.bool, device=dev)
    flow_pass = torch.empty(n, dtype=torch.bool, device=dev)
    admitted = torch.empty(n, dtype=torch.bool, device=dev)
    reason = torch.empty(n, dtype=i32, device=dev)
    if blk_topk > 0:
        dense = torch.empty(r_rows + 1, dtype=i32, device=dev)
        cand = torch.empty(2 * topk_blocks * TOPK_MAX, dtype=i32, device=dev)
        cand_w, cand_r = cand[: topk_blocks * TOPK_MAX], cand[topk_blocks * TOPK_MAX :]
        blk = torch.empty(2 * blk_topk, dtype=i32, device=dev)
        blk_weight, blk_rows = blk[:blk_topk], blk[blk_topk:]
        ptrs = (dense.data_ptr(), cand_w.data_ptr(), cand_r.data_ptr())
        out_ptrs = (blk_weight.data_ptr(), blk_rows.data_ptr())
    else:
        blk_weight = blk_rows = None
        ptrs = (None, None, None)
        out_ptrs = (None, None)
    cuda_build.check(
        lib.flow_admission_decide(
            rk_s.data_ptr(), perm1.data_ptr(), perm2.data_ptr(), batch.e_rule_gid.data_ptr(),
            batch.e_check_row.data_ptr(), batch.e_valid.data_ptr(), batch.e_auth_ok.data_ptr(),
            batch.e_cluster_ok.data_ptr(), batch.e_acquire.data_ptr(), batch.e_rows.data_ptr(),
            n, k, r_rows, flow_dev.n_rules,
            flow_dev.grade.data_ptr(), flow_dev.count.data_ptr(), flow_dev.behavior.data_ptr(),
            pass_sums.data_ptr(), NUM_EVENTS, stats.threads.data_ptr(), _interval_sec(),
            blk_topk,
            pos_s.data_ptr(), new_grp.data_ptr(), contrib.data_ptr(), excl.data_ptr(),
            partial.data_ptr(), partial_max.data_ptr(), *ptrs,
            slot_ok.data_ptr(), flow_pass.data_ptr(), admitted.data_ptr(), reason.data_ptr(),
            *out_ptrs, st,
        ),
        "flow_admission_decide",
    )
    flow_admission.launches += 1
    return Admission(slot_ok, flow_pass, admitted, reason, blk_rows, blk_weight)


# ---------------------------------------------------------------------------
# phases and the step
# ---------------------------------------------------------------------------


def _rep4(t: torch.Tensor) -> torch.Tensor:
    return t.repeat_interleave(4)


def _event_cols(m: int, device, **cols: torch.Tensor) -> torch.Tensor:
    """An int32 [m, NUM_EVENTS] delta matrix from named event columns."""
    out = torch.zeros((m, NUM_EVENTS), dtype=torch.int32, device=device)
    for name, v in cols.items():
        out[:, MetricEvent[name]] = v.to(torch.int32)
    return out


def apply_exit_phase(stats: StatsState, batch: FlushBatch, with_exits: bool = True) -> StatsState:
    """Phase 1: exits and traces (StatisticSlot.exit), in place.
    ``with_exits=False`` (the host knows the exit buffer is empty) skips
    the updates; every mask would be False anyway."""
    if not with_exits:
        return stats
    m = batch.x_valid.shape[0]
    x_rows_f = batch.x_rows.reshape(-1)
    x_mask = (x_rows_f >= 0) & _rep4(batch.x_valid)
    count4 = _rep4(batch.x_count)
    rt4 = _rep4(batch.x_rt)
    x_thr4 = _rep4(batch.x_thr)
    deltas = _event_cols(
        4 * m, x_rows_f.device, SUCCESS=count4, RT=rt4, EXCEPTION=_rep4(batch.x_err)
    )
    # A min-RT sample comes only from true exits that carry completions.
    rt_sample = torch.where((x_thr4 < 0) & (count4 > 0), rt4, _I32_MAX).to(torch.int32)
    return apply_updates(stats, x_rows_f, _rep4(batch.x_ts), deltas, rt_sample, x_thr4, x_mask)


def flush_entries(
    stats: StatsState, flow_dev: FlowTableDevice, batch: FlushBatch, blk_topk: int = 0
) -> Tuple[StatsState, FlushResult]:
    """Phases 2-3: admission, then entry accounting (StatisticSlot.entry)."""
    n = batch.e_valid.shape[0]
    adm = flow_admission(stats, flow_dev, batch, blk_topk)

    e_rows_f = batch.e_rows.reshape(-1)
    e_mask = (e_rows_f >= 0) & _rep4(batch.e_valid)
    adm4 = _rep4(adm.admitted)
    acq4 = _rep4(batch.e_acquire)
    zero = torch.zeros_like(acq4)
    # Without occupied entries the minute window takes the same deltas.
    e_deltas = _event_cols(
        4 * n, e_rows_f.device,
        PASS=torch.where(adm4, acq4, zero),
        BLOCK=torch.where(adm4, zero, acq4),
    )
    apply_updates(stats, e_rows_f, _rep4(batch.e_ts), e_deltas, None, adm4.to(torch.int32), e_mask)

    result = FlushResult(
        admitted=adm.admitted,
        reason=adm.reason,
        slot_ok=adm.slot_ok,
        wait_ms=torch.zeros(n, dtype=torch.int32, device=batch.e_valid.device),
        blk_rows=adm.blk_rows,
        blk_weight=adm.blk_weight,
    )
    return stats, result


def flush_step(
    stats: StatsState,
    flow_dev: FlowTableDevice,
    batch: FlushBatch,
    with_exits: bool = True,
    blk_topk: int = 0,
) -> Tuple[StatsState, FlushResult]:
    """Apply one batch, in place: the matured-borrow sweep, exits, then
    admission and accounting. ``with_exits`` and ``blk_topk`` are the JAX
    package's host-known flags; the occupy, system and degrade stages are
    off on this path."""
    materialize_matured(stats, batch.now)
    apply_exit_phase(stats, batch, with_exits=with_exits)
    return flush_entries(stats, flow_dev, batch, blk_topk=blk_topk)
