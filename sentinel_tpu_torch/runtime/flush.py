"""The flush step (port of ``sentinel_tpu/runtime/flush.py``).

One flush applies a batch of ops in three phases, replacing the
per-request slot-chain walk (StatisticSlot, AuthoritySlot, SystemSlot,
FlowSlot, DegradeSlot of the reference):

1. **exits/traces**: success, RT, exception and thread release go into
   the window tensors, and completions into the circuit breakers
   (:func:`apply_exit_phase`);
2. **admission**, in the slot chain's order: authority (decided on the
   host, ``e_auth_ok``), system protection on the global inbound row
   (:func:`system_check`), every flow rule slot of every entry against
   the post-exit statistics (:func:`flow_admission`, with the occupy
   branch for prioritized entries), then the breakers
   (``rules/degrade_table.breaker_try_pass``). An entry blocked by an
   earlier stage consumes nothing of a later one. Intra-batch sequencing
   is the JAX package's: slots are ordered by (check row, ts, arrival)
   and each is charged the acquire of earlier entries on that row,
   counted only on rows the entry itself accounts on (see the JAX
   module's docstring);
3. **entry accounting**: pass/block/occupied pass and thread acquire go
   into the windows, granted borrows into the future slab.

The ``with_occupy`` / ``with_system`` / ``with_degrade`` flags are the
JAX package's host-known specializations ("the batch has prioritized
entries", "a system rule is loaded", "degrade rules are loaded"): each
skipped stage would pass everything, so the flags change no verdict.
Hot parameters (a :class:`~sentinel_tpu_torch.rules.param_table.ParamBatch`)
are checked after system protection and before the flow rules
(ParamFlowSlot, order -3000); the shaping controllers (a
:class:`~sentinel_tpu_torch.rules.shaping.ShapingBatch`) decide their slots
right after the flow admission, from its per-slot pass plus intra-batch
charge. With all stages off the step is the DEFAULT path, whose verdict
tail is fused into the flow admission kernel; with any of them on the
verdict runs after the breakers (:func:`slot_chain_verdict`).

Kernels (CUDA C++ in ``csrc/``, each beside its plain PyTorch version):
:func:`flow_admission` (K4, ``flow_admission.cu``), :func:`system_check`
(K6, ``system_check.cu``), :func:`commit_borrow_slab` (K5,
``commit_borrow_slab.cu``) and :func:`slot_chain_verdict` (the verdict
tail with the probe transitions, ``flow_admission.cu``); the breakers'
K7 and K8 live in ``rules/degrade_table.py``, the shaping recurrence K9
(with its input gather) in ``rules/shaping.py`` and the hot-parameter
recurrence K10 in ``rules/param_table.py``, the sketch fold K11 in
``runtime/sketch.py``. K4 and K6 read the second window themselves
(K3 with the gauge and the slab, ``nodes.rows_stats``, serves the
engine's stats reads); the windows are written through
``nodes.apply_updates`` (K2 and the thread gauge); :func:`flush_step`
runs ``nodes.materialize_matured`` (K1) first, unless its caller knows
the future slab holds no borrow (``with_matured``, the engine's slab
horizon: :func:`borrow_horizon`). The rest is torch glue.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core import errors as E
from sentinel_tpu_torch.metrics import metric_array as ma
from sentinel_tpu_torch.metrics import nodes as _nodes
from sentinel_tpu_torch.metrics.events import NUM_EVENTS, MetricEvent
from sentinel_tpu_torch.metrics.nodes import StatsState, apply_updates, materialize_matured, waiting_tokens
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.rules import degrade_table as _dt
from sentinel_tpu_torch.rules.degrade_table import DegradeDynState, DegradeTableDevice
from sentinel_tpu_torch.rules.flow_table import FlowRuleDynState, FlowTableDevice
from sentinel_tpu_torch.rules.param_table import ParamBatch, ParamDynState, run_param
from sentinel_tpu_torch.rules.shaping import ShapingBatch, shaping_stage
from sentinel_tpu_torch.runtime.sketch import SketchBatch, SketchState, sketch_fold
from sentinel_tpu_torch.utils import cuda_build
from sentinel_tpu_torch.utils.numeric import add_i32

_I32_MAX = 2**31 - 1
# The fused blocked top-K of the verdict tails keeps at most this many rows;
# a larger k takes the wide route (blocked_topk_wide, csrc/blocked_topk.cu).
TOPK_MAX = 8


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
    e_prio: torch.Tensor  # bool [N] prioritized: may borrow a future window
    e_auth_ok: torch.Tensor  # bool [N] AuthoritySlot verdict (host-resolved)
    e_cluster_ok: torch.Tensor  # bool [N] token-server verdict
    e_dgid: torch.Tensor  # int32 [N, KD] degrade rule ids of the resource
    # --- exits and traces ---
    x_valid: torch.Tensor  # bool [M]
    x_ts: torch.Tensor  # int32 [M]
    x_count: torch.Tensor  # int32 [M] success delta (0 for trace ops)
    x_rows: torch.Tensor  # int32 [M, 4]
    x_rt: torch.Tensor  # int32 [M] RT delta (0 for trace ops)
    x_err: torch.Tensor  # int32 [M] exception delta
    x_thr: torch.Tensor  # int32 [M] thread delta (-1 exit, 0 trace)
    x_dgid: torch.Tensor  # int32 [M, KD] degrade rule ids (breaker completion)


class SystemDevice(NamedTuple):
    """Effective system-protection config and the current host samples,
    as float32 values. Thresholds are +inf when disabled; load and CPU
    follow the reference's ">= 0 means set" (SystemRuleManager.java:
    298-353)."""

    qps: float
    max_thread: float
    max_rt: float
    load_threshold: float
    cpu_threshold: float
    cur_load: float
    cur_cpu: float


def _f32(v) -> float:
    return float(np.float32(v))


def system_device_from_numpy(sd) -> SystemDevice:
    """A :class:`SystemDevice` from the JAX package's (seven float32
    scalars, ``jax.device_get``)."""
    return SystemDevice(*(_f32(np.asarray(v)) for v in sd))


def make_system_device(cfg, load: float, cpu: float) -> SystemDevice:
    """The engine's view of a ``SystemConfig`` (None = no system rule)."""
    inf = float("inf")
    if cfg is None:
        return SystemDevice(inf, inf, inf, -1.0, -1.0, -1.0, -1.0)

    def thr(v):
        return _f32(v) if v is not None and v >= 0 else inf

    return SystemDevice(
        qps=thr(cfg.qps), max_thread=thr(cfg.max_thread), max_rt=thr(cfg.max_rt),
        load_threshold=_f32(cfg.highest_system_load), cpu_threshold=_f32(cfg.highest_cpu_usage),
        cur_load=_f32(load), cur_cpu=_f32(cpu),
    )


# System block dimension codes (limit types in SystemBlockException).
SYS_NONE = 0
SYS_QPS = 1
SYS_THREAD = 2
SYS_RT = 3
SYS_LOAD = 4
SYS_CPU = 5
SYS_TYPE_NAMES = {SYS_QPS: "qps", SYS_THREAD: "thread", SYS_RT: "rt", SYS_LOAD: "load", SYS_CPU: "cpu"}


def make_probe_batch(now: int, device: torch.device, n: int = 8, m: int = 8, k: int = 1, kd: int = 1) -> FlushBatch:
    """An all-invalid batch for the failover probe flushes (RECOVERING ->
    HEALTHY, runtime/failover.py): every entry and exit slot is masked, so
    the flush launches its kernels and comes back through the copy back,
    which is what a probe must prove works again, while admission state
    passes through untouched (only the matured-borrow sweep runs, as any
    flush at this ``now`` would). The smallest padded chunk shape."""
    i32 = torch.int32

    def full(shape, v, dtype=i32):
        return torch.full(shape, v, dtype=dtype, device=device)

    return FlushBatch(
        now=int(now),
        e_valid=full((n,), False, torch.bool), e_ts=full((n,), 0), e_acquire=full((n,), 1),
        e_rows=full((n, 4), -1), e_rule_gid=full((n, k), -1), e_check_row=full((n, k), -1),
        e_prio=full((n,), False, torch.bool), e_auth_ok=full((n,), True, torch.bool),
        e_cluster_ok=full((n,), True, torch.bool), e_dgid=full((n, kd), -1),
        x_valid=full((m,), False, torch.bool), x_ts=full((m,), 0), x_count=full((m,), 0), x_rows=full((m, 4), -1),
        x_rt=full((m,), 0), x_err=full((m,), 0), x_thr=full((m,), 0), x_dgid=full((m, kd), -1),
    )


class FlushResult(NamedTuple):
    admitted: torch.Tensor  # bool [N]
    reason: torch.Tensor  # int32 [N], errors.PASS / BLOCK_*
    slot_ok: torch.Tensor  # bool [N, K] per-rule verdicts (block attribution)
    wait_ms: torch.Tensor  # int32 [N] occupy wait of a borrowed pass
    sys_type: torch.Tensor  # int32 [N] system block dimension (SYS_*)
    dslot_ok: torch.Tensor  # bool [N, KD] per-breaker verdicts
    flow_live: torch.Tensor  # bool [N] passed every stage before the breakers
    occupied: torch.Tensor  # bool [N] admitted by borrowing a future window
    occ_slot: torch.Tensor  # bool [N, K] the slots that borrowed (admission-gated)
    blk_rows: Optional[torch.Tensor] = None  # int32 [k] rows with most blocked acquire
    blk_weight: Optional[torch.Tensor] = None  # int32 [k] their blocked acquire


class Admission(NamedTuple):
    """Output of :func:`flow_admission`. ``admitted``/``reason`` and the
    top-K come only from the fused DEFAULT-path tail; the occupy fields
    only with ``with_occupy``."""

    slot_ok: torch.Tensor  # bool [N, K]
    flow_pass: torch.Tensor  # bool [N] AND over the entry's slots
    admitted: Optional[torch.Tensor]  # bool [N]
    reason: Optional[torch.Tensor]  # int32 [N]
    blk_rows: Optional[torch.Tensor]  # int32 [k] or None
    blk_weight: Optional[torch.Tensor]  # int32 [k] or None
    occupied: Optional[torch.Tensor] = None  # bool [N] some slot borrowed
    occupy_wait: Optional[torch.Tensor] = None  # int32 [N] max wait over borrowing slots
    occ_slot: Optional[torch.Tensor] = None  # bool [N, K]
    occ_target: Optional[torch.Tensor] = None  # int32 [N, K] target window start
    # int32 [N*K] windowed pass + intra-batch charge per slot (``with_ppc``):
    # the shaping stage's passQps input.
    pass_plus_consumed: Optional[torch.Tensor] = None


class ChainVerdict(NamedTuple):
    """Output of :func:`slot_chain_verdict`."""

    admitted: torch.Tensor  # bool [N]
    reason: torch.Tensor  # int32 [N]
    wait_ms: torch.Tensor  # int32 [N]
    flow_live: torch.Tensor  # bool [N]
    occupied: torch.Tensor  # bool [N] occupied and admitted
    occ_slot: torch.Tensor  # bool [N, K] gated on occupied and admitted
    blk_rows: Optional[torch.Tensor]
    blk_weight: Optional[torch.Tensor]


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
    return _f32(_nodes.SECOND_CFG.interval_ms / 1000.0)


def _wrap32(x: int) -> int:
    """A Python int wrapped to int32, as JAX int32 arithmetic wraps."""
    return ((x + 2**31) % 2**32) - 2**31


def occupy_steps(now: int):
    """The scalars of tryOccupyNext's loop over future windows
    (StatisticNode.java:302-333), per step i: (wait_ms, expiring window
    start, its bucket index, whether it started before now, the borrowed
    window's start), in the int32 arithmetic of the JAX code."""
    cfg = _nodes.SECOND_CFG
    wlen, nb, interval = cfg.window_len_ms, cfg.sample_count, cfg.interval_ms
    now_mod = now % wlen
    out = []
    for i in range(nb):
        exp_ws = _wrap32(now - now_mod + wlen - interval + i * wlen)
        out.append((i * wlen + wlen - now_mod, exp_ws, (exp_ws // wlen) % nb, exp_ws < now,
                    _wrap32(now - now_mod + (i + 1) * wlen)))
    return out


def borrow_horizon(now: int, occupy_timeout_ms: int) -> Optional[int]:
    """The latest window start a borrow committed by a flush at ``now`` can
    take: the largest target of :func:`occupy_steps` whose step may grant
    (``started and wait_ms < occupy_timeout_ms``), or None when none may.
    The target is not wrapped to int32: near 2^31 it may lie past every
    int32 ``now``. A caller that keeps the largest horizon of its borrowing
    flushes knows that the sweep (K1) at any ``now`` at or past it, and
    before ``now - empty_ws`` wraps, leaves every slab cell (empty_ws, 0);
    on such a slab the sweep changes nothing (no cell is live: its age is
    ``now + interval + 1``), so the flushes after it may skip it until the
    next borrow."""
    wlen = _nodes.SECOND_CFG.window_len_ms
    base = now - now % wlen
    targets = [base + (i + 1) * wlen for i, (wait_i, _, _, started, _) in enumerate(occupy_steps(now))
               if started and wait_i < occupy_timeout_ms]
    return max(targets, default=None)


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Wrapping int32 exclusive cumsum along the last dimension."""
    x = x.to(torch.int32)
    return torch.cumsum(x.to(torch.int64), -1).to(torch.int32) - x


def segment_excl_cumsum(new_grp: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """Exclusive running sum of ``contrib`` restarting at every group start
    (``new_grp`` marks boundaries in an already sorted array), computed as
    the JAX code does: a wrapping int32 exclusive cumsum, minus the running
    max of its group-start values. Along the last dimension: each row of a
    2-D input is a sorted array of its own."""
    excl = _excl_cumsum(contrib)
    base = torch.cummax(torch.where(new_grp, excl, torch.zeros_like(excl)), -1).values
    return excl - base


def _segment_consumed(new_grp, last_of_ent, contrib) -> torch.Tensor:
    """Per-position sum of *prior entries'* contributions in its group: an
    entry's contribution sits at its last slot, so it never charges itself."""
    return segment_excl_cumsum(new_grp, torch.where(last_of_ent, contrib, torch.zeros_like(contrib)))


def _blocked_topk_plain(batch: FlushBatch, admitted: torch.Tensor, r_rows: int, blk_topk: int):
    """The ``blk_topk`` cluster rows with the most blocked acquire (weight
    descending, row ascending, zero-weight rows filling up)."""
    if blk_topk <= 0:
        return None, None
    i32 = torch.int32
    blocked_w = torch.where(batch.e_valid & ~admitted, batch.e_acquire, 0).to(i32)
    crow = batch.e_rows[:, 1].clamp(0, r_rows - 1)
    scat = torch.where(blocked_w > 0, crow, torch.full_like(crow, r_rows)).long()
    dense = torch.zeros(r_rows + 1, dtype=i32, device=admitted.device).index_add_(0, scat, blocked_w)
    top = torch.sort(dense[:r_rows], descending=True, stable=True)
    kk = min(blk_topk, r_rows)
    return top.indices[:kk].to(i32), top.values[:kk].to(i32)


# ---------------------------------------------------------------------------
# K4: flow admission (with the occupy branch) + the DEFAULT-path tail
# ---------------------------------------------------------------------------


def flow_admission(
    stats: StatsState,
    flow_dev: FlowTableDevice,
    batch: FlushBatch,
    blk_topk: int = 0,
    live: Optional[torch.Tensor] = None,
    occupy_timeout_ms: int = 500,
    with_occupy: bool = False,
    tail: bool = True,
    with_ppc: bool = False,
) -> Admission:
    """Vectorized FlowRuleChecker + DefaultController.canPass (block iff
    ``curCount + acquire > count``, curCount = ``(int) passQps()`` for the
    QPS grade, ``curThreadNum`` for the thread grade;
    DefaultController.java:49-78).

    ``with_occupy``: a prioritized QPS entry that fails the plain check
    may borrow from a future 500 ms window (StatisticNode.tryOccupyNext,
    StatisticNode.java:302-340): the borrowed total, charged with earlier
    prioritized candidates of the row, must stay under ``count x
    interval`` after the pass of each expiring window is released, and
    the wait under ``occupy_timeout_ms``. ``live`` (bool [N]) masks
    entries an earlier stage blocked out of borrowing. Borrows are NOT
    committed here (:func:`commit_borrow_slab`).

    ``tail`` (the DEFAULT path only: no occupy, system or breakers) fuses
    the verdict tail of ``flush_entries``: the admission (valid,
    authority and token-server verdicts), the reason code, and with
    ``blk_topk > 0`` the top-K blocked cluster rows.

    ``with_ppc`` (slot chain only) also returns each slot's windowed pass
    plus intra-batch charge, [N*K] in slot order, for the shaping stage."""
    if tail and (with_occupy or with_ppc):
        raise ValueError("flow_admission: the fused tail is the DEFAULT path's; occupy and shaping need "
                         "slot_chain_verdict")
    if stats.threads.is_cuda:
        return _flow_admission_cuda(stats, flow_dev, batch, blk_topk, live, occupy_timeout_ms, with_occupy, tail,
                                    with_ppc)
    return flow_admission_plain(stats, flow_dev, batch, blk_topk, live, occupy_timeout_ms, with_occupy, tail,
                                with_ppc)


flow_admission.launches = 0
# Launches of K4 with its occupy branch on (a subset of ``launches``).
flow_admission.occupy_launches = 0


def flow_admission_plain(
    stats: StatsState,
    flow_dev: FlowTableDevice,
    batch: FlushBatch,
    blk_topk: int = 0,
    live: Optional[torch.Tensor] = None,
    occupy_timeout_ms: int = 500,
    with_occupy: bool = False,
    tail: bool = True,
    with_ppc: bool = False,
) -> Admission:
    """Plain PyTorch version of :func:`flow_admission`."""
    n, k = batch.e_rule_gid.shape
    r_rows = stats.n_rows
    nr = flow_dev.n_rules
    dev = batch.e_valid.device
    i32, f32 = torch.int32, torch.float32

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

    interval_sec = torch.tensor(_interval_sec(), dtype=f32, device=dev)
    qps_cur = torch.floor((base_pass + consumed_acq).to(f32) / interval_sec)
    thread_cur = (base_thread + consumed_cnt).to(f32)
    cur = torch.where(grade_s == C.FLOW_GRADE_QPS, qps_cur, thread_cur)
    ok = (cur + acq_s.to(f32)) <= count_s
    is_default = behavior_s == C.CONTROL_BEHAVIOR_DEFAULT

    occ_s = torch.zeros(n * k, dtype=torch.bool, device=dev)
    occ_wait = torch.zeros(n * k, dtype=i32, device=dev)
    occ_target = torch.zeros(n * k, dtype=i32, device=dev)
    if with_occupy:
        # An entry the token server already BLOCKED never reaches the local
        # controller, so it does not borrow either (FlowRuleChecker.java:207).
        live_s = torch.ones_like(active_s) if live is None else live[ei_s]
        eligible = (
            active_s & ~ok & is_default & live_s & batch.e_prio[ei_s] & batch.e_cluster_ok[ei_s]
            & (grade_s == C.FLOW_GRADE_QPS)
        )
        max_count = count_s * interval_sec
        waiting = waiting_tokens(stats, batch.now)[rk_c]
        # Conservative intra-batch borrow charge: every earlier prioritized
        # candidate of the row charges, granted or not.
        borrow_charge = _segment_consumed(new_grp, last_of_ent, torch.where(eligible, acq_s, zero))
        cur_borrow = (waiting + borrow_charge).to(f32)
        cur_pass = (base_pass + consumed_acq).to(f32)
        acq_fs = acq_s.to(f32)
        ws2, pass2 = stats.second.window_start, stats.second.counts[:, :, MetricEvent.PASS]
        for wait_i, exp_ws, bidx, started, target in occupy_steps(batch.now):
            # Step i sees the pass that remains once windows 0..i expired:
            # the loop's cumulative ``currentPass -= windowPass``.
            win_pass = torch.where(ws2[rk_c, bidx] == exp_ws, pass2[rk_c, bidx], 0).to(f32)
            cond = eligible & (cur_pass + cur_borrow + acq_fs - win_pass <= max_count)
            if not (started and wait_i < occupy_timeout_ms):
                cond = torch.zeros_like(cond)
            fresh = cond & ~occ_s
            occ_wait = torch.where(fresh, wait_i, occ_wait).to(i32)
            occ_target = torch.where(fresh, target, occ_target).to(i32)
            occ_s = occ_s | cond
            cur_pass = cur_pass - win_pass
    # Non-DEFAULT behaviors are decided by the shaping stage, not here.
    ok = ok | occ_s | ~active_s | ~is_default

    slot_ok = torch.ones(n * k, dtype=torch.bool, device=dev)
    slot_ok[pos_s] = ok
    slot_ok = slot_ok.reshape(n, k)
    flow_pass = slot_ok.all(dim=1)

    occ = {}
    if with_ppc:
        ppc = torch.zeros(n * k, dtype=i32, device=dev)
        ppc[pos_s] = add_i32(base_pass, consumed_acq)
        occ["pass_plus_consumed"] = ppc
    if with_occupy:
        e_occ = ei_s[occ_s]
        occupied = torch.zeros(n, dtype=torch.bool, device=dev)
        occupied[e_occ] = True
        occupy_wait = torch.zeros(n, dtype=i32, device=dev).scatter_reduce_(0, e_occ, occ_wait[occ_s], reduce="amax")
        occ_nk = torch.zeros(n * k, dtype=torch.bool, device=dev)
        occ_nk[pos_s] = occ_s
        tgt_nk = torch.zeros(n * k, dtype=i32, device=dev)
        tgt_nk[pos_s] = occ_target
        occ.update(occupied=occupied, occupy_wait=occupy_wait, occ_slot=occ_nk.reshape(n, k),
                   occ_target=tgt_nk.reshape(n, k))

    admitted = reason = blk_rows = blk_weight = None
    if tail:
        fpc = flow_pass & batch.e_cluster_ok
        admitted = batch.e_valid & batch.e_auth_ok & fpc
        reason = torch.full((n,), E.PASS, dtype=i32, device=dev)
        reason[batch.e_valid & ~fpc] = E.BLOCK_FLOW
        reason[batch.e_valid & ~batch.e_auth_ok] = E.BLOCK_AUTHORITY
        reason[admitted] = E.PASS
        blk_rows, blk_weight = _blocked_topk_plain(batch, admitted, r_rows, blk_topk)
    return Admission(slot_ok, flow_pass, admitted, reason, blk_rows, blk_weight, **occ)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class _FaArgs(ctypes.Structure):
    """The ``FaArgs`` of ``csrc/flow_admission.cu``, field for field."""

    _fields_ = [(name, _P) for name in (
        "gid", "crow", "e_valid", "e_ts", "e_acq", "e_rows", "e_auth", "e_cluster", "e_prio", "live",
        "f_grade", "f_count", "f_behavior", "sec_ws", "sec_counts", "threads", "fut_ws", "fut_pass",
        "slot_ok", "flow_pass", "admitted", "reason", "blk_w", "blk_r", "ppc", "occ_slot", "occ_target",
        "occupied", "occupy_wait",
    )] + [(name, _I) for name in (
        "n", "k", "n_rows", "nr", "nb", "ne", "now", "wlen", "interval_ms", "occupy_timeout_ms", "occupy", "tail",
        "topk",
    )] + [("interval_sec", _F)]


def _fa_lib() -> ctypes.CDLL:
    lib = cuda_build.load("flow_admission")
    if not getattr(lib, "_typed", False):
        lib.flow_admission_workspace.argtypes = [_I]
        lib.flow_admission_workspace.restype = ctypes.c_longlong
        lib.flow_admission_topk_ints.argtypes = [_I]
        lib.flow_admission_topk_ints.restype = ctypes.c_longlong
        lib.flow_admission.argtypes = [ctypes.POINTER(_FaArgs), _P, ctypes.c_longlong, _P, _P]
        lib.flow_admission.restype = _I
        lib.chain_verdict_zero_bytes.argtypes = [_I, _I]
        lib.chain_verdict_zero_bytes.restype = ctypes.c_longlong
        lib.chain_verdict.argtypes = [ctypes.POINTER(_CvArgs), _P, ctypes.c_longlong, _P]
        lib.chain_verdict.restype = _I
        lib._typed = True
    return lib


# The batch fields K4 reads, and those the slot chain's verdict reads.
_FA_FIELDS = ("e_valid", "e_ts", "e_acquire", "e_rows", "e_rule_gid", "e_check_row", "e_auth_ok", "e_cluster_ok",
              "e_prio")
_CHAIN_FIELDS = ("e_valid", "e_auth_ok", "e_cluster_ok", "e_acquire", "e_rows", "e_dgid")


def _check_batch_cuda(batch: FlushBatch, fields=FlushBatch._fields[1:]) -> None:
    for name in fields:
        t = getattr(batch, name)
        want = torch.bool if name in _BOOL_FIELDS else torch.int32
        if t.dtype != want or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"batch.{name}: need a contiguous CUDA {want} tensor")


def _check_topk(blk_topk: int) -> None:
    if blk_topk < 0:
        raise ValueError("blk_topk must be >= 0")


def blocked_topk_wide(batch: FlushBatch, admitted: torch.Tensor, r_rows: int, blk_topk: int):
    """The blocked top-K above :data:`TOPK_MAX`, over the verdicts a tail
    wrote: the ``min(blk_topk, r_rows)`` cluster rows with the most blocked
    acquire (weight descending, row ascending, the lowest zero-weight rows
    filling up), as ``lax.top_k`` of the dense weights. Returns (rows,
    weights), int32 [kk] each. On the card one C call (csrc/blocked_topk.cu:
    two launches and a selection up to k = 256, else four and a CUB radix
    sort) that leaves the zeroed scratch zero; here the plain version."""
    if admitted.is_cuda:
        return _blocked_topk_wide_cuda(batch, admitted, r_rows, blk_topk)
    return _blocked_topk_plain(batch, admitted, r_rows, blk_topk)


blocked_topk_wide.launches = 0

class _BtArgs(ctypes.Structure):
    """The ``BtArgs`` of ``csrc/blocked_topk.cu``, field for field."""

    _fields_ = [(name, _P) for name in ("admitted", "e_valid", "e_acq", "e_rows", "out_w", "out_r")] + [
        (name, _I) for name in ("n", "n_rows", "k", "fault")
    ]


def _bt_lib() -> ctypes.CDLL:
    lib = cuda_build.load("blocked_topk")
    if not getattr(lib, "_typed", False):
        lib.blocked_topk_workspace.argtypes = [_I, _I, _I]
        lib.blocked_topk_workspace.restype = ctypes.c_longlong
        lib.blocked_topk_zero_bytes.argtypes = [_I, _I]
        lib.blocked_topk_zero_bytes.restype = ctypes.c_longlong
        lib.blocked_topk_selects.argtypes = [_I, _I, _I]
        lib.blocked_topk_selects.restype = _I
        lib.blocked_topk.argtypes = [ctypes.POINTER(_BtArgs), _P, ctypes.c_longlong, _P, ctypes.c_longlong, _P]
        lib.blocked_topk.restype = _I
        lib._typed = True
    return lib


_bt_sizes: Dict[Tuple[int, int, int], Tuple[int, int]] = {}  # (n, R, k) -> workspace, zero bytes


def _blocked_topk_wide_cuda(batch: FlushBatch, admitted: torch.Tensor, r_rows: int, blk_topk: int):
    n = batch.e_valid.shape[0]
    for name, t, want, shape in (("admitted", admitted, torch.bool, (n,)), ("batch.e_valid", batch.e_valid,
                                 torch.bool, (n,)), ("batch.e_acquire", batch.e_acquire, torch.int32, (n,)),
                                 ("batch.e_rows", batch.e_rows, torch.int32, (n, 4))):
        if t.dtype != want or not t.is_contiguous() or not t.is_cuda or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need a contiguous CUDA {want} tensor of shape {shape}")
    kk = min(int(blk_topk), int(r_rows))
    if kk <= 0:
        return None, None
    blk_weight, blk_rows = torch.empty(2 * kk, dtype=torch.int32, device=admitted.device).split([kk, kk])
    _blocked_topk_run(batch, admitted, int(r_rows), kk, blk_weight, blk_rows)
    return blk_rows, blk_weight


def _blocked_topk_run(batch: FlushBatch, admitted: torch.Tensor, r_rows: int, kk: int, out_w: torch.Tensor,
                      out_r: torch.Tensor) -> None:
    """The wide route's one C call into ``out_w``/``out_r`` (int32 [kk]),
    for a caller that checked the batch and made ``admitted``."""
    n = admitted.shape[0]
    lib = _bt_lib()
    key = (n, r_rows, kk)
    sizes = _bt_sizes.get(key)
    if sizes is None:
        sizes = _bt_sizes[key] = (int(lib.blocked_topk_workspace(n, r_rows, kk)),
                                  int(lib.blocked_topk_zero_bytes(n, r_rows)))
    need, zero_bytes = sizes
    a = _BtArgs(admitted=admitted.data_ptr(), e_valid=batch.e_valid.data_ptr(), e_acq=batch.e_acquire.data_ptr(),
                e_rows=batch.e_rows.data_ptr(), out_w=out_w.data_ptr(), out_r=out_r.data_ptr(), n=n, n_rows=r_rows,
                k=kk)
    st = ma.stream_of(admitted)
    with cuda_build.scratch(admitted.device, st, need, zero_bytes) as (buf, size, zero):
        cuda_build.check(lib.blocked_topk(ctypes.byref(a), buf, size, zero, zero_bytes, st), "blocked_topk")
    blocked_topk_wide.launches += 1


def _topk_zero_bytes(lib, r_rows: int) -> int:
    """Bytes of the zeroed buffer the blocked top-K needs over ``r_rows``."""
    return 4 * int(lib.flow_admission_topk_ints(r_rows))


def _flow_admission_cuda(stats, flow_dev, batch, blk_topk, live, occupy_timeout_ms, with_occupy, tail,
                         with_ppc=False) -> Admission:
    """K4 in one host call: the DEFAULT path with its fused tail, or the
    slot chain's stage (occupy, pass plus charge)."""
    _check_batch_cuda(batch, _FA_FIELDS)
    _check_topk(blk_topk)
    for name in ("grade", "count", "behavior"):
        t = getattr(flow_dev, name)
        if not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"flow_dev.{name}: need a contiguous CUDA tensor")
    sec = stats.second
    for name, t in (("stats.threads", stats.threads), ("stats.second.window_start", sec.window_start),
                    ("stats.second.counts", sec.counts), ("stats.future_ws", stats.future_ws),
                    ("stats.future_pass", stats.future_pass)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous int32 tensor")
    lib = _fa_lib()
    n, k = batch.e_rule_gid.shape
    nk = n * k
    r_rows = stats.n_rows
    dev = batch.e_valid.device
    st = ma.stream_of(batch.e_valid)
    cfg = _nodes.SECOND_CFG
    kk_all = min(blk_topk, r_rows) if tail else 0
    kk = kk_all if kk_all <= TOPK_MAX else 0  # above TOPK_MAX: the wide route after the call
    a = _FaArgs(
        gid=batch.e_rule_gid.data_ptr(), crow=batch.e_check_row.data_ptr(), e_valid=batch.e_valid.data_ptr(),
        e_ts=batch.e_ts.data_ptr(), e_acq=batch.e_acquire.data_ptr(), e_rows=batch.e_rows.data_ptr(),
        e_auth=batch.e_auth_ok.data_ptr(), e_cluster=batch.e_cluster_ok.data_ptr(), e_prio=batch.e_prio.data_ptr(),
        f_grade=flow_dev.grade.data_ptr(), f_count=flow_dev.count.data_ptr(), f_behavior=flow_dev.behavior.data_ptr(),
        sec_ws=sec.window_start.data_ptr(), sec_counts=sec.counts.data_ptr(), threads=stats.threads.data_ptr(),
        fut_ws=stats.future_ws.data_ptr(), fut_pass=stats.future_pass.data_ptr(),
        n=n, k=k, n_rows=r_rows, nr=flow_dev.n_rules, nb=cfg.sample_count, ne=NUM_EVENTS, now=batch.now,
        wlen=cfg.window_len_ms, interval_ms=cfg.interval_ms, occupy_timeout_ms=int(occupy_timeout_ms),
        occupy=int(with_occupy), tail=int(tail), topk=kk, interval_sec=_interval_sec(),
    )
    # The outputs: one bool and one int32 allocation, cut into the fields.
    n_occ = nk + n if with_occupy else 0
    extra = {}
    admitted = reason = blk_rows = blk_weight = None
    if tail:
        slot_ok, flow_pass, admitted = torch.empty(nk + 2 * n, dtype=torch.bool, device=dev).split([nk, n, n])
        # The top-K's outputs come from this allocation, the wide route's too.
        reason, blk_weight, blk_rows = torch.empty(n + 2 * kk_all, dtype=torch.int32, device=dev).split(
            [n, kk_all, kk_all])
        a.admitted, a.reason = admitted.data_ptr(), reason.data_ptr()
        if kk > 0:
            a.blk_w, a.blk_r = blk_weight.data_ptr(), blk_rows.data_ptr()
        elif kk_all == 0:
            blk_weight = blk_rows = None
        slot_ok = slot_ok.view(n, k)
        a.slot_ok, a.flow_pass = slot_ok.data_ptr(), flow_pass.data_ptr()
    else:
        flags = torch.empty(nk + n + n_occ, dtype=torch.bool, device=dev)
        slot_ok, flow_pass = flags[:nk].view(n, k), flags[nk : nk + n]
        a.slot_ok, a.flow_pass = slot_ok.data_ptr(), flow_pass.data_ptr()
        n_i32 = (nk if with_ppc else 0) + (nk + n if with_occupy else 0)
        ints = torch.empty(n_i32, dtype=torch.int32, device=dev) if n_i32 else None
        off = 0
        if with_ppc:
            extra["pass_plus_consumed"] = ints[:nk]
            a.ppc = ints.data_ptr()
            off = nk
        if with_occupy:
            live = batch.e_valid if live is None else live
            if live.dtype != torch.bool or not live.is_contiguous() or tuple(live.shape) != (n,) or not live.is_cuda:
                raise ValueError("live: need a contiguous CUDA bool tensor of shape (N,)")
            a.live = live.data_ptr()
            occ_slot, occupied = flags[nk + n : 2 * nk + n].view(n, k), flags[2 * nk + n :]
            occ_target, occupy_wait = ints[off : off + nk].view(n, k), ints[off + nk : off + nk + n]
            a.occ_slot, a.occupied = occ_slot.data_ptr(), occupied.data_ptr()
            a.occ_target, a.occupy_wait = occ_target.data_ptr(), occupy_wait.data_ptr()
            extra.update(occupied=occupied, occupy_wait=occupy_wait, occ_slot=occ_slot, occ_target=occ_target)
    need = int(lib.flow_admission_workspace(nk))
    zero_bytes = _topk_zero_bytes(lib, r_rows) if kk > 0 and need > 0 else 0
    with cuda_build.scratch(dev, st, need, zero_bytes) as (buf, size, zero):
        cuda_build.check(lib.flow_admission(ctypes.byref(a), buf, size, zero, st), "flow_admission")
    flow_admission.launches += 1
    if with_occupy:
        flow_admission.occupy_launches += 1
    if kk_all > TOPK_MAX:
        _blocked_topk_run(batch, admitted, r_rows, kk_all, blk_weight, blk_rows)
    return Admission(slot_ok, flow_pass, admitted, reason, blk_rows, blk_weight, **extra)


# ---------------------------------------------------------------------------
# K6: system_check
# ---------------------------------------------------------------------------


def system_check(
    stats: StatsState, sysdev: SystemDevice, batch: FlushBatch, live: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized SystemRuleManager.checkSystem (SystemRuleManager.java:
    298-353) against the global inbound row (Constants.ENTRY_NODE, row 0).
    Only live inbound (EntryType.IN) entries are checked. QPS and thread
    count see the charge of earlier inbound entries in (ts, arrival)
    order; RT, BBR load and CPU use the flush-time snapshot. The first
    tripped dimension in the reference's order wins. Returns (ok [N],
    sys_type [N])."""
    if stats.threads.is_cuda:
        return _system_check_cuda(stats, sysdev, batch, live)
    return system_check_plain(stats, sysdev, batch, live)


system_check.launches = 0


def system_check_plain(stats, sysdev, batch, live) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`system_check`."""
    cfg = _nodes.SECOND_CFG
    n = batch.e_valid.shape[0]
    dev = batch.e_valid.device
    i32, f32 = torch.int32, torch.float32

    def f(v):
        return torch.tensor(v, dtype=f32, device=dev)

    checked = live & (batch.e_rows[:, 3] >= 0)
    sums = ma.window_reduce_plain(cfg, stats.second, batch.now, rows=torch.zeros(1, dtype=i32, device=dev))[0][0]
    pass_sum, success, rt_sum = (sums[e].to(f32) for e in (MetricEvent.PASS, MetricEvent.SUCCESS, MetricEvent.RT))
    threads0 = stats.threads[0].to(f32)

    # Intra-batch charge among inbound entries, in (ts, arrival) order.
    key = torch.where(checked, 0, 1).to(i32)
    o1 = torch.sort(batch.e_ts, stable=True).indices
    p_s = o1[torch.sort(key[o1], stable=True).indices]
    in_grp = key[p_s] == 0
    acq_s = batch.e_acquire[p_s]
    zero = torch.zeros_like(acq_s)
    consumed_acq = torch.zeros(n, dtype=i32, device=dev)
    consumed_acq[p_s] = torch.where(in_grp, _excl_cumsum(torch.where(in_grp, acq_s, zero)), zero)
    consumed_cnt = torch.zeros(n, dtype=i32, device=dev)
    consumed_cnt[p_s] = torch.where(in_grp, _excl_cumsum(in_grp.to(i32)), zero)

    acq = batch.e_acquire.to(f32)
    cur_qps = (pass_sum + consumed_acq.to(f32)) / f(_interval_sec())
    qps_block = cur_qps + acq > f(sysdev.qps)
    cur_thread = threads0 + consumed_cnt.to(f32)
    thread_block = cur_thread > f(sysdev.max_thread)
    avg_rt = torch.where(success > 0, rt_sum / torch.maximum(success, f(1.0)), f(0.0))
    rt_block = avg_rt > f(sysdev.max_rt)

    # BBR (checkBbr): under high load, block unless
    # curThread <= maxSuccessQps * minRt / 1000 (or curThread <= 1).
    now_t = torch.tensor(batch.now, dtype=i32, device=dev)
    valid_b = (now_t - stats.second.window_start[0]) <= cfg.interval_ms
    succ = torch.where(valid_b, stats.second.counts[0, :, MetricEvent.SUCCESS], 0)
    max_success_qps = succ.max().to(f32) * f(cfg.sample_count)
    min_rt = torch.where(valid_b, stats.second.min_rt[0], cfg.max_rt).min().to(f32)
    load_on = sysdev.load_threshold >= 0 and sysdev.cur_load > sysdev.load_threshold
    load_block = (cur_thread > f(1.0)) & (cur_thread > max_success_qps * min_rt / f(1000.0)) & load_on
    cpu_block = sysdev.cpu_threshold >= 0 and sysdev.cur_cpu > sysdev.cpu_threshold

    # The first matching dimension in the reference's order wins.
    sys_type = torch.full((n,), SYS_NONE, dtype=i32, device=dev)
    for blocked, code in ((torch.full_like(checked, cpu_block), SYS_CPU), (load_block, SYS_LOAD),
                          (rt_block, SYS_RT), (thread_block, SYS_THREAD), (qps_block, SYS_QPS)):
        sys_type = torch.where(checked & blocked, code, sys_type).to(i32)
    return sys_type == SYS_NONE, sys_type


# Entries of K6's one-block route (sorted in shared memory; the C side
# takes at most 8,192): the many-block route's sort and scan win above it.
SYSTEM_CHECK_SMALL_MAX = 2048


class _ScArgs(ctypes.Structure):
    """The ``ScArgs`` of ``csrc/system_check.cu``, field for field."""

    _fields_ = [(name, _P) for name in (
        "live", "e_rows", "e_ts", "e_acq", "counts0", "min_rt0", "ws0", "threads", "ok", "sys_type",
    )] + [(name, _I) for name in ("n", "nb", "ne", "interval", "max_rt", "now", "small_max")] + [
        (name, _F) for name in (
            "interval_sec", "qps", "max_thread", "max_rt_thr", "load_thr", "cpu_thr", "cur_load", "cur_cpu")]


def _sc_lib() -> ctypes.CDLL:
    lib = cuda_build.load("system_check")
    if not getattr(lib, "_typed", False):
        lib.system_check_workspace.argtypes = [_I, _I]
        lib.system_check_workspace.restype = ctypes.c_longlong
        lib.system_check.argtypes = [ctypes.POINTER(_ScArgs), _P, ctypes.c_longlong, _P]
        lib.system_check.restype = _I
        lib._typed = True
    return lib


_SC_FIELDS = ("e_ts", "e_acquire", "e_rows")  # the batch fields K6 reads


def _system_check_cuda(stats, sysdev, batch, live) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 in one host call: one block up to SYSTEM_CHECK_SMALL_MAX entries,
    else one CUB sort and one single-pass scan."""
    _check_batch_cuda(batch, _SC_FIELDS)
    n = batch.e_ts.shape[0]
    ma._bool(live, "live", n)
    sec = stats.second
    for name, t in (*zip(ma.MetricArrayState._fields, sec), ("threads", stats.threads)):
        if t.dtype != torch.int32 or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"stats.{name}: need a contiguous CUDA int32 tensor")
    dev = batch.e_ts.device
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    sys_type = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return ok, sys_type
    lib = _sc_lib()
    cfg = _nodes.SECOND_CFG
    a = _ScArgs(
        live=live.data_ptr(), e_rows=batch.e_rows.data_ptr(), e_ts=batch.e_ts.data_ptr(),
        e_acq=batch.e_acquire.data_ptr(), counts0=sec.counts.data_ptr(), min_rt0=sec.min_rt.data_ptr(),
        ws0=sec.window_start.data_ptr(), threads=stats.threads.data_ptr(), ok=ok.data_ptr(),
        sys_type=sys_type.data_ptr(), n=n, nb=cfg.sample_count, ne=NUM_EVENTS, interval=cfg.interval_ms,
        max_rt=cfg.max_rt, now=batch.now, small_max=SYSTEM_CHECK_SMALL_MAX, interval_sec=_interval_sec(),
    )
    a.qps, a.max_thread, a.max_rt_thr, a.load_thr, a.cpu_thr, a.cur_load, a.cur_cpu = (float(v) for v in sysdev)
    st = ma.stream_of(live)
    need = int(lib.system_check_workspace(n, SYSTEM_CHECK_SMALL_MAX))
    with cuda_build.scratch(dev, st, need) as (buf, size, _):
        cuda_build.check(lib.system_check(ctypes.byref(a), buf, size, st), "system_check")
    system_check.launches += 1
    return ok, sys_type


# ---------------------------------------------------------------------------
# K5: commit_borrow_slab
# ---------------------------------------------------------------------------


def commit_borrow_slab(
    stats: StatsState,
    occ_slot: torch.Tensor,  # bool [N, K], gated on the entry's final admission
    occ_target: torch.Tensor,  # int32 [N, K] target window starts
    acquire: torch.Tensor,  # int32 [N]
    check_row: torch.Tensor,  # int32 [N, K]
) -> StatsState:
    """Write granted borrows into the future slab, in place:
    addWaitingRequest (StatisticNode.java:342-345), set-if-newer per
    (row, bucket) like the borrow array's reset-then-add roll. A borrow by
    an entry that another stage vetoed must not reach here."""
    if stats.threads.is_cuda:
        return _commit_borrow_cuda(stats, occ_slot, occ_target, acquire, check_row)
    return commit_borrow_slab_plain(stats, occ_slot, occ_target, acquire, check_row)


commit_borrow_slab.launches = 0


def commit_borrow_slab_plain(stats, occ_slot, occ_target, acquire, check_row) -> StatsState:
    """Plain PyTorch version of :func:`commit_borrow_slab`."""
    cfg = _nodes.SECOND_CFG
    n, k = occ_slot.shape
    r_rows, nb, wlen = stats.n_rows, cfg.sample_count, cfg.window_len_ms
    dev = occ_slot.device
    occ_f = occ_slot.reshape(-1)
    tgt = occ_target.reshape(-1)[occ_f]
    acq = acquire[(torch.arange(n * k, device=dev) // k)[occ_f]]
    key = check_row.reshape(-1)[occ_f].clamp(0, r_rows - 1).long() * nb + torch.remainder(
        torch.div(tgt, wlen, rounding_mode="floor"), nb).long()
    # Per (row, bucket): the newest target window, and the acquire of the
    # borrows that target it.
    seg_ws = torch.full((r_rows * nb,), cfg.empty_ws, dtype=torch.int32, device=dev)
    seg_ws.scatter_reduce_(0, key, tgt, reduce="amax", include_self=False)
    hit = tgt == seg_ws[key]
    seg_sum = torch.zeros(r_rows * nb, dtype=torch.int32, device=dev).index_add_(0, key[hit], acq[hit])
    touched = torch.zeros(r_rows * nb, dtype=torch.bool, device=dev)
    touched[key] = True
    fws, fpass = stats.future_ws.view(-1), stats.future_pass.view(-1)
    same = touched & (seg_ws == fws)
    newer = touched & (seg_ws > fws)
    fpass.copy_(torch.where(same, fpass + seg_sum, torch.where(newer, seg_sum, fpass)))
    fws.copy_(torch.where(newer, seg_ws, fws))
    return stats


# Slots of K5's one-block route (the C side takes at most 8,192).
COMMIT_BORROW_SMALL_MAX = 2048


class _CbArgs(ctypes.Structure):
    """The ``CbArgs`` of ``csrc/commit_borrow_slab.cu``, field for field."""

    _fields_ = [(name, _P) for name in ("occ", "tgt", "crow", "acq", "fut_pass", "fut_ws")] + [
        (name, _I) for name in ("n", "k", "n_rows", "nb", "wlen", "small_max")]


def _cb_lib() -> ctypes.CDLL:
    lib = cuda_build.load("commit_borrow_slab")
    if not getattr(lib, "_typed", False):
        lib.commit_borrow_zero_bytes.argtypes = [_I, _I]
        lib.commit_borrow_zero_bytes.restype = ctypes.c_longlong
        lib.commit_borrow.argtypes = [ctypes.POINTER(_CbArgs), _P, ctypes.c_longlong, _P]
        lib.commit_borrow.restype = _I
        lib._typed = True
    return lib


def _commit_borrow_cuda(stats, occ_slot, occ_target, acquire, check_row) -> StatsState:
    """K5 in one host call: one block up to COMMIT_BORROW_SMALL_MAX slots,
    else three launches over the slots with the per-cell newest window and
    sum in the zeroed scratch, which the call leaves zeroed. No sort, no
    allocation."""
    n, k = occ_slot.shape
    if occ_slot.dtype != torch.bool or not occ_slot.is_contiguous() or not occ_slot.is_cuda:
        raise ValueError("occ_slot: need a contiguous CUDA bool tensor")
    ma._i32(occ_target, "occ_target", (n, k))
    ma._i32(check_row, "check_row", (n, k))
    ma._i32(acquire, "acquire", (n,))
    cfg = _nodes.SECOND_CFG
    slab = (stats.n_rows, cfg.sample_count)
    for name in ("future_pass", "future_ws"):
        t = getattr(stats, name)
        if t.dtype != torch.int32 or not t.is_contiguous() or not t.is_cuda or tuple(t.shape) != slab:
            raise ValueError(f"stats.{name}: need a contiguous CUDA int32 tensor of shape {slab}")
    if n * k == 0:
        return stats
    lib = _cb_lib()
    a = _CbArgs(
        occ=occ_slot.data_ptr(), tgt=occ_target.data_ptr(), crow=check_row.data_ptr(), acq=acquire.data_ptr(),
        fut_pass=stats.future_pass.data_ptr(), fut_ws=stats.future_ws.data_ptr(), n=n, k=k, n_rows=stats.n_rows,
        nb=cfg.sample_count, wlen=cfg.window_len_ms, small_max=COMMIT_BORROW_SMALL_MAX,
    )
    zero_bytes = 0 if n * k <= COMMIT_BORROW_SMALL_MAX else int(lib.commit_borrow_zero_bytes(*slab))
    st = ma.stream_of(occ_slot)
    with cuda_build.scratch(occ_slot.device, st, 0, zero_bytes) as (_, _, zero):
        cuda_build.check(lib.commit_borrow(ctypes.byref(a), zero, zero_bytes, st), "commit_borrow")
    commit_borrow_slab.launches += 1
    return stats


# ---------------------------------------------------------------------------
# the verdict tail after the breakers (with apply_probe_transitions)
# ---------------------------------------------------------------------------


def slot_chain_verdict(
    batch: FlushBatch,
    adm: Admission,
    sys_ok: Optional[torch.Tensor],
    dslot_ok: Optional[torch.Tensor],
    probe_slot: Optional[torch.Tensor],
    ddyn: Optional[DegradeDynState],
    n_rows: int,
    blk_topk: int = 0,
    param_ok: Optional[torch.Tensor] = None,
    wait_param: Optional[torch.Tensor] = None,
    shape_wait: Optional[torch.Tensor] = None,
) -> ChainVerdict:
    """The verdict tail of ``flush_entries`` when any stage beyond the
    DEFAULT flow check is on: admission = live and flow pass and breaker
    pass (an occupied entry skips the breaker: PriorityWaitException
    aborts the chain before DegradeSlot), ``wait_ms`` (the occupy wait and
    the shaping wait of live entries, then the throttle wait of admitted
    ones), the reason with precedence authority > system > param > flow >
    degrade, the blocked top-K, and OPEN -> HALF_OPEN for probes of
    entries admitted end to end and not occupied (applied to
    ``ddyn.state`` in place). ``sys_ok`` None = no system stage;
    ``param_ok``/``wait_param`` None = no param stage; ``shape_wait``
    (per-entry max of the shaping waits; ``adm.flow_pass`` then already
    holds the shaping verdicts) None = no shaping stage;
    ``dslot_ok``/``probe_slot`` None = no breakers; ``ddyn`` None with
    breakers = decide without applying the probe transitions (the sharded
    step's demand pass); ``n_rows`` is the stats row count (the top-K's
    range)."""
    if batch.e_valid.is_cuda:
        return _chain_verdict_cuda(batch, adm, sys_ok, dslot_ok, probe_slot, ddyn, n_rows, blk_topk, param_ok,
                                   wait_param, shape_wait)
    return slot_chain_verdict_plain(batch, adm, sys_ok, dslot_ok, probe_slot, ddyn, n_rows, blk_topk, param_ok,
                                    wait_param, shape_wait)


slot_chain_verdict.launches = 0


def slot_chain_verdict_plain(batch, adm, sys_ok, dslot_ok, probe_slot, ddyn, n_rows, blk_topk=0, param_ok=None,
                             wait_param=None, shape_wait=None) -> ChainVerdict:
    """Plain PyTorch version of :func:`slot_chain_verdict`."""
    n, k = batch.e_rule_gid.shape
    dev = batch.e_valid.device
    live = batch.e_valid & batch.e_auth_ok
    if sys_ok is not None:
        live = live & sys_ok
    if param_ok is not None:
        live = live & param_ok
    flow_pass = adm.flow_pass & batch.e_cluster_ok
    live2 = live & flow_pass
    no = torch.zeros(n, dtype=torch.bool, device=dev)
    occupied = no if adm.occupied is None else adm.occupied & live
    wait_ms = torch.where(occupied, adm.occupy_wait if adm.occupy_wait is not None else 0, 0).clamp(min=0)
    if shape_wait is not None:
        wait_ms = torch.maximum(wait_ms, shape_wait)
    wait_ms = torch.where(live2, wait_ms, 0).to(torch.int32)
    deg_pass = ~no if dslot_ok is None else dslot_ok.all(dim=1) | (occupied & live2)
    admitted = live2 & deg_pass
    if wait_param is not None:
        wait_ms = torch.maximum(wait_ms, torch.where(admitted, wait_param, 0)).to(torch.int32)
    if probe_slot is not None and ddyn is not None:
        _dt.apply_probe_transitions_plain(ddyn, batch.e_dgid, probe_slot, admitted & ~occupied)
    reason = torch.full((n,), E.PASS, dtype=torch.int32, device=dev)
    reason[batch.e_valid & ~deg_pass] = E.BLOCK_DEGRADE
    reason[batch.e_valid & ~flow_pass] = E.BLOCK_FLOW
    if param_ok is not None:
        reason[batch.e_valid & ~param_ok] = E.BLOCK_PARAM
    if sys_ok is not None:
        reason[batch.e_valid & ~sys_ok] = E.BLOCK_SYSTEM
    reason[batch.e_valid & ~batch.e_auth_ok] = E.BLOCK_AUTHORITY
    reason[admitted] = E.PASS
    occ_final = occupied & admitted
    occ_slot = (torch.zeros((n, k), dtype=torch.bool, device=dev) if adm.occ_slot is None
                else adm.occ_slot & occ_final[:, None])
    blk_rows, blk_weight = _blocked_topk_plain(batch, admitted, n_rows, blk_topk)
    return ChainVerdict(admitted, reason, wait_ms, live2, occ_final, occ_slot, blk_rows, blk_weight)


# Entries of the verdict tail's one-block route (the C side takes at most
# 8,192).
CHAIN_VERDICT_SMALL_MAX = 2048


class _CvArgs(ctypes.Structure):
    """The ``CvArgs`` of ``csrc/flow_admission.cu``, field for field."""

    _fields_ = [(name, _P) for name in (
        "e_valid", "e_auth", "e_cluster", "e_acq", "e_rows", "e_dgid", "sys_ok", "param_ok", "wait_param",
        "shape_wait", "flow_pass", "occupied_raw", "occupy_wait", "occ_slot_in", "dslot_ok", "probe_slot", "state",
        "admitted", "flow_live", "occupied", "occ_slot", "reason", "wait_ms", "blk_w", "blk_r",
    )] + [(name, _I) for name in ("n", "k", "kd", "n_rows", "topk", "small_max")]


def _opt_ptr(t: Optional[torch.Tensor], dtype, shape, what: str) -> Optional[int]:
    """The pointer of an optional input of the tail, checked."""
    if t is None:
        return None
    if t.dtype is not dtype or not t.is_cuda or not t.is_contiguous() or t.shape != shape:
        raise ValueError(f"{what}: need a contiguous CUDA {dtype} tensor of shape {shape}")
    return t.data_ptr()


def _chain_verdict_cuda(batch, adm, sys_ok, dslot_ok, probe_slot, ddyn, n_rows, blk_topk, param_ok=None,
                        wait_param=None, shape_wait=None) -> ChainVerdict:
    """The tail in one host call: one block up to CHAIN_VERDICT_SMALL_MAX
    entries (the top-K among the touched rows), else two launches over the
    listed rows of the zeroed scratch, which the call leaves zeroed. The
    outputs are cut from one allocation."""
    _check_batch_cuda(batch, _CHAIN_FIELDS)
    _check_topk(blk_topk)
    n, k = batch.e_rule_gid.shape
    kd = batch.e_dgid.shape[1]
    if dslot_ok is not None and probe_slot is None:
        raise ValueError("slot_chain_verdict: dslot_ok [N, KD] needs probe_slot")
    if (param_ok is None) != (wait_param is None):
        raise ValueError("slot_chain_verdict: param_ok and wait_param come together")
    if (adm.occupied is None) != (adm.occupy_wait is None):
        raise ValueError("slot_chain_verdict: occupied and occupy_wait come together")
    b, i32 = torch.bool, torch.int32
    state = None
    if dslot_ok is not None and ddyn is not None:
        state = ddyn.state
        if state.dtype != i32 or not state.is_contiguous() or not state.is_cuda:
            raise ValueError("ddyn.state: need a contiguous CUDA int32 tensor")
    dev = batch.e_valid.device
    kk_all = min(blk_topk, n_rows)
    kk = kk_all if kk_all <= TOPK_MAX else 0  # above TOPK_MAX: the wide route after the call
    nk = n * k
    off = (3 * n + nk + 15) // 16 * 16  # the int32 outputs start 16-byte aligned
    out = torch.empty(off + 4 * (2 * n + 2 * kk_all), dtype=torch.uint8, device=dev)  # the wide route's outputs too
    flags = out[: 3 * n + nk].view(b)
    admitted, flow_live, occupied = flags[:n], flags[n : 2 * n], flags[2 * n : 3 * n]
    occ_slot = flags[3 * n :].view(n, k)
    ints = out[off:].view(i32)
    reason, wait_ms = ints[:n], ints[n : 2 * n]
    blk_weight, blk_rows = (ints[2 * n : 2 * n + kk_all], ints[2 * n + kk_all :]) if kk_all > 0 else (None, None)
    a = _CvArgs(
        e_valid=batch.e_valid.data_ptr(), e_auth=batch.e_auth_ok.data_ptr(), e_cluster=batch.e_cluster_ok.data_ptr(),
        e_acq=batch.e_acquire.data_ptr(), e_rows=batch.e_rows.data_ptr(), e_dgid=batch.e_dgid.data_ptr(),
        sys_ok=_opt_ptr(sys_ok, b, (n,), "sys_ok"), param_ok=_opt_ptr(param_ok, b, (n,), "param_ok"),
        wait_param=_opt_ptr(wait_param, i32, (n,), "wait_param"),
        shape_wait=_opt_ptr(shape_wait, i32, (n,), "shape_wait"),
        flow_pass=_opt_ptr(adm.flow_pass, b, (n,), "adm.flow_pass"),
        occupied_raw=_opt_ptr(adm.occupied, b, (n,), "adm.occupied"),
        occupy_wait=_opt_ptr(adm.occupy_wait, i32, (n,), "adm.occupy_wait"),
        occ_slot_in=_opt_ptr(adm.occ_slot, b, (n, k), "adm.occ_slot"),
        dslot_ok=_opt_ptr(dslot_ok, b, (n, kd), "dslot_ok"),
        probe_slot=None if dslot_ok is None else _opt_ptr(probe_slot, b, (n, kd), "probe_slot"),
        state=None if state is None else state.data_ptr(),
        admitted=admitted.data_ptr(), flow_live=flow_live.data_ptr(), occupied=occupied.data_ptr(),
        occ_slot=occ_slot.data_ptr(), reason=reason.data_ptr(), wait_ms=wait_ms.data_ptr(),
        blk_w=None if kk == 0 else blk_weight.data_ptr(), blk_r=None if kk == 0 else blk_rows.data_ptr(),
        n=n, k=k, kd=kd, n_rows=n_rows, topk=kk, small_max=CHAIN_VERDICT_SMALL_MAX,
    )
    lib = _fa_lib()
    zero_bytes = int(lib.chain_verdict_zero_bytes(n, n_rows)) if kk > 0 and n > CHAIN_VERDICT_SMALL_MAX else 0
    st = ma.stream_of(batch.e_valid)
    with cuda_build.scratch(dev, st, 0, zero_bytes) as (_, _, zero):
        cuda_build.check(lib.chain_verdict(ctypes.byref(a), zero, zero_bytes, st), "chain_verdict")
    slot_chain_verdict.launches += 1
    if kk_all > TOPK_MAX:
        _blocked_topk_run(batch, admitted, n_rows, kk_all, blk_weight, blk_rows)
    return ChainVerdict(admitted, reason, wait_ms, flow_live, occupied, occ_slot, blk_rows, blk_weight)


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


def apply_exit_phase(
    stats: StatsState,
    batch: FlushBatch,
    with_exits: bool = True,
    ddev: Optional[DegradeTableDevice] = None,
    ddyn: Optional[DegradeDynState] = None,
    with_degrade: bool = False,
) -> StatsState:
    """Phases 1 and 1b: exits and traces (StatisticSlot.exit), then the
    breaker completions (DegradeSlot.exit), in place. ``with_exits=False``
    (the host knows the exit buffer is empty) skips both; every mask would
    be False anyway."""
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
    apply_updates(stats, x_rows_f, _rep4(batch.x_ts), deltas, rt_sample, x_thr4, x_mask)
    if with_degrade:
        _dt.breaker_on_exits(ddev, ddyn, batch.x_dgid, batch.x_ts, batch.x_rt, batch.x_err, batch.x_valid)
    return stats


def _param_stage(pdyn: ParamDynState, param: ParamBatch, live: torch.Tensor, rounds: int):
    """Phase 2b' (ParamFlowSlot): exits release their per-value thread
    slots first (ParamFlowStatisticExitCallback), then K10 checks the
    slots of live entries. Returns (param_ok [N], wait_param [N]): the AND
    and the max over each entry's slots."""
    n = live.shape[0]
    pr = pdyn.threads.shape[0]
    xr = param.exit_rows
    x_in = (xr >= 0) & (xr < pr)
    pdyn.threads.index_add_(0, torch.where(x_in, xr, 0).long(), -x_in.to(torch.int32))
    valid = param.valid & live[param.eidx.clamp(0, max(n - 1, 0)).long()]
    _, ok_s, wait_s = run_param(pdyn, param._replace(valid=valid), rounds)
    dump = torch.where(valid, param.eidx, n).long()
    ok = torch.ones(n + 1, dtype=torch.int32, device=live.device)
    ok.scatter_reduce_(0, dump, ok_s.to(torch.int32), reduce="amin")
    wait = torch.zeros(n + 1, dtype=torch.int32, device=live.device)
    wait.scatter_reduce_(0, dump, wait_s, reduce="amax")
    return ok[:n].bool(), wait[:n]


def _shaping_stage(stats, flow_dev, flow_dyn, shaping: ShapingBatch, adm: "Admission", live, rounds: int):
    """The shaping controllers after the flow admission: K9 decides the
    shaping slots of live entries; their verdicts AND into ``slot_ok`` at
    their flat positions (unique), and each entry takes the largest wait
    of its slots. Returns (the admission with the new slot_ok/flow_pass,
    shape_wait [N])."""
    n, k = adm.slot_ok.shape
    valid, ok_s, wait_s = shaping_stage(flow_dev, flow_dyn, shaping, live, adm.pass_plus_consumed, stats.minute,
                                        _interval_sec(), rounds)
    flat = torch.ones(n * k + 1, dtype=torch.int32, device=live.device)
    flat[: n * k] = adm.slot_ok.reshape(-1).to(torch.int32)
    flat.scatter_reduce_(0, torch.where(valid, shaping.flat_pos, n * k).long(), ok_s.to(torch.int32), reduce="amin")
    slot_ok = flat[: n * k].bool().reshape(n, k)
    wait = torch.zeros(n + 1, dtype=torch.int32, device=live.device)
    wait.scatter_reduce_(0, torch.where(valid, shaping.eidx, n).long(), wait_s, reduce="amax")
    return adm._replace(slot_ok=slot_ok, flow_pass=slot_ok.all(dim=1)), wait[:n]


def _shaping_pre_stage(adm: "Admission", shaping_pre, shape_wait: Optional[torch.Tensor]):
    """Shaping verdicts decided outside the step (the sharded step's global
    pacer scan): ``shaping_pre = (valid [S], flat_pos [S], eidx [S], ok [S],
    wait_ms [S])`` in this batch's positions. They AND into ``slot_ok`` and
    raise each entry's wait, as :func:`_shaping_stage` does with its own."""
    sp_valid, sp_flat, sp_eidx, sp_ok, sp_wait = shaping_pre
    n, k = adm.slot_ok.shape
    dev = adm.slot_ok.device
    flat = torch.ones(n * k + 1, dtype=torch.int32, device=dev)
    flat[: n * k] = adm.slot_ok.reshape(-1).to(torch.int32)
    flat.scatter_reduce_(0, torch.where(sp_valid, sp_flat, n * k).long(), sp_ok.to(torch.int32), reduce="amin")
    slot_ok = flat[: n * k].bool().reshape(n, k)
    wait = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    if shape_wait is not None:
        wait[:n] = shape_wait
    wait.scatter_reduce_(0, torch.where(sp_valid, sp_eidx, n).long(), sp_wait, reduce="amax")
    return adm._replace(slot_ok=slot_ok, flow_pass=slot_ok.all(dim=1)), wait[:n]


def _copy_state(state):
    return type(state)(*(t.clone() for t in state))


def flush_entries(
    stats: StatsState,
    flow_dev: FlowTableDevice,
    batch: FlushBatch,
    blk_topk: int = 0,
    ddev: Optional[DegradeTableDevice] = None,
    ddyn: Optional[DegradeDynState] = None,
    sysdev: Optional[SystemDevice] = None,
    occupy_timeout_ms: int = 500,
    with_occupy: bool = False,
    with_system: bool = False,
    with_degrade: bool = False,
    flow_dyn: Optional[FlowRuleDynState] = None,
    pdyn: Optional[ParamDynState] = None,
    shaping: Optional[ShapingBatch] = None,
    param: Optional[ParamBatch] = None,
    shaping_rounds: int = 0,
    param_rounds: int = 0,
    commit: bool = True,
    probe_allowed: Optional[torch.Tensor] = None,
    param_pre: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    shaping_pre: Optional[Tuple[torch.Tensor, ...]] = None,
) -> Tuple[StatsState, FlushResult]:
    """Phases 2-3: the slot chain (authority, system, hot parameters, flow
    with occupy and shaping, breakers), then entry accounting
    (StatisticSlot.entry), the borrow commit and the per-value thread
    acquire. The breaker state ``ddyn``, the shaping state ``flow_dyn``
    and the param state ``pdyn`` are updated in place.

    The sharded step's hooks (``parallel/ici.py``), as the JAX module has
    them: ``commit=False`` decides without writing any state (no window
    or future-slab write, no probe transition, no param thread gauge; a
    param or shaping stage runs on a copy of its state), the step's
    demand pass. ``probe_allowed`` (bool [ND]) restricts probe candidacy
    to the breakers this shard won. ``param_pre = (param_ok [N],
    wait_param [N])`` and ``shaping_pre = (valid [S], flat_pos [S], eidx
    [S], ok [S], wait_ms [S])`` carry verdicts the global scans decided
    outside this call: the stage takes them and runs no recurrence."""
    n, k = batch.e_rule_gid.shape
    kd = batch.e_dgid.shape[1]
    dev = batch.e_valid.device
    pre = param_pre is not None or shaping_pre is not None
    if not (with_occupy or with_system or with_degrade or shaping is not None or param is not None or pre):
        # The DEFAULT path: the verdict tail is fused into K4.
        adm = flow_admission(stats, flow_dev, batch, blk_topk)
        v = ChainVerdict(adm.admitted, adm.reason, torch.zeros(n, dtype=torch.int32, device=dev), adm.admitted,
                         torch.zeros(n, dtype=torch.bool, device=dev),
                         torch.zeros((n, k), dtype=torch.bool, device=dev), adm.blk_rows, adm.blk_weight)
        sys_type = torch.zeros(n, dtype=torch.int32, device=dev)
        dslot_ok = torch.ones((n, kd), dtype=torch.bool, device=dev)
    else:
        # ---- 2a authority (host-resolved) and 2b system protection ----
        live = batch.e_valid & batch.e_auth_ok
        sys_ok = None
        sys_type = torch.zeros(n, dtype=torch.int32, device=dev)
        if with_system:
            sys_ok, sys_type = system_check(stats, sysdev, batch, live)
            live = live & sys_ok
        # ---- 2b' hot parameters ----
        param_ok = wait_param = None
        if param_pre is not None:
            param_ok, wait_param = param_pre
            live = live & param_ok
        elif param is not None:
            param_ok, wait_param = _param_stage(pdyn if commit else _copy_state(pdyn), param, live, param_rounds)
            live = live & param_ok
        # ---- 2c flow rules, with the occupy branch, then shaping ----
        adm = flow_admission(stats, flow_dev, batch, 0, live, occupy_timeout_ms, with_occupy, tail=False,
                             with_ppc=shaping is not None)
        shape_wait = None
        if shaping is not None:
            adm, shape_wait = _shaping_stage(stats, flow_dev, flow_dyn if commit else _copy_state(flow_dyn),
                                             shaping, adm, live, shaping_rounds)
        if shaping_pre is not None:
            adm, shape_wait = _shaping_pre_stage(adm, shaping_pre, shape_wait)
        # ---- 2d circuit breakers: occupied entries skip them ----
        dslot_ok = probe_slot = None
        if with_degrade:
            e_live = live & adm.flow_pass & batch.e_cluster_ok
            if adm.occupied is not None:
                e_live = e_live & ~adm.occupied
            dslot_ok, probe_slot = _dt.breaker_try_pass(ddev, ddyn, batch.e_dgid, batch.e_ts, e_live, probe_allowed)
        v = slot_chain_verdict(batch, adm, sys_ok, dslot_ok, probe_slot, ddyn if commit else None, stats.n_rows,
                               blk_topk, param_ok, wait_param, shape_wait)
        if dslot_ok is None:
            dslot_ok = torch.ones((n, kd), dtype=torch.bool, device=dev)
        if with_occupy and commit:
            # Borrows persist only for entries finally admitted.
            commit_borrow_slab(stats, v.occ_slot, adm.occ_target, batch.e_acquire, batch.e_check_row)
        if param is not None and param_pre is None and commit:
            # Per-value thread acquire (ParamFlowStatisticEntryCallback.onPass):
            # +1 per thread-grade slot of an admitted entry (rows may repeat).
            inc = (param.valid & (param.grade == C.FLOW_GRADE_THREAD)
                   & v.admitted[param.eidx.clamp(0, max(n - 1, 0)).long()])
            pdyn.threads.index_add_(0, torch.where(inc, param.prow, 0).long(), inc.to(torch.int32))

    result = FlushResult(
        admitted=v.admitted, reason=v.reason, slot_ok=adm.slot_ok, wait_ms=v.wait_ms, sys_type=sys_type,
        dslot_ok=dslot_ok, flow_live=v.flow_live, occupied=v.occupied, occ_slot=v.occ_slot,
        blk_rows=v.blk_rows, blk_weight=v.blk_weight,
    )
    if not commit:
        return stats, result

    # ---- phase 3: entry accounting (StatisticSlot.entry) ----
    e_rows_f = batch.e_rows.reshape(-1)
    e_mask = (e_rows_f >= 0) & _rep4(batch.e_valid)
    adm4 = _rep4(v.admitted)
    acq4 = _rep4(batch.e_acquire)
    zero = torch.zeros_like(acq4)
    blocked = torch.where(adm4, zero, acq4)
    minute = None
    if with_occupy:
        # Occupied entries take the thread and OCCUPIED_PASS now; their
        # second-window PASS arrives through the future slab, while the
        # minute window counts PASS at once (StatisticNode.addOccupiedPass).
        occ4 = _rep4(v.occupied)
        e_deltas = _event_cols(4 * n, dev, PASS=torch.where(adm4 & ~occ4, acq4, zero), BLOCK=blocked)
        minute = _event_cols(4 * n, dev, PASS=torch.where(adm4, acq4, zero), BLOCK=blocked,
                             OCCUPIED_PASS=torch.where(occ4, acq4, zero))
    else:
        e_deltas = _event_cols(4 * n, dev, PASS=torch.where(adm4, acq4, zero), BLOCK=blocked)
    apply_updates(stats, e_rows_f, _rep4(batch.e_ts), e_deltas, None, adm4.to(torch.int32), e_mask,
                  minute_deltas=minute)
    return stats, result


def flush_step(
    stats: StatsState,
    flow_dev: FlowTableDevice,
    batch: FlushBatch,
    with_exits: bool = True,
    blk_topk: int = 0,
    ddev: Optional[DegradeTableDevice] = None,
    ddyn: Optional[DegradeDynState] = None,
    sysdev: Optional[SystemDevice] = None,
    occupy_timeout_ms: int = 500,
    with_occupy: bool = False,
    with_system: bool = False,
    with_degrade: bool = False,
    flow_dyn: Optional[FlowRuleDynState] = None,
    pdyn: Optional[ParamDynState] = None,
    shaping: Optional[ShapingBatch] = None,
    param: Optional[ParamBatch] = None,
    shaping_rounds: int = 0,
    param_rounds: int = 0,
    skstate: Optional[SketchState] = None,
    sk: Optional[SketchBatch] = None,
    sketch_decay: bool = False,
    with_matured: bool = True,
) -> Tuple[StatsState, FlushResult]:
    """Apply one batch, in place: the matured-borrow sweep, exits and
    breaker completions, then the slot chain and accounting. The flags
    are the JAX package's host-known specializations (see the module
    docstring); ``with_matured=False`` skips the sweep, for a caller that
    knows every slab cell is (empty_ws, 0) (see :func:`borrow_horizon`);
    each sweep counts one in ``flush_step.sweeps``. ``shaping``/``param``
    (None = no such slots) come with their state (``flow_dyn``, ``pdyn``)
    and the host's execution modes (``shaping_rounds``, ``param_rounds``,
    as ``run_shaping``/``run_param`` take them). The breaker, shaping and param states are updated in
    place. ``skstate``/``sk`` thread the sketch tier: after the entries,
    the chunk's key batch folds into the sketch state in place (K11,
    with the once-per-window halving when ``sketch_decay``)."""
    if with_degrade and (ddev is None or ddyn is None):
        raise ValueError("flush_step: with_degrade needs the breaker table and state")
    if with_system and sysdev is None:
        raise ValueError("flush_step: with_system needs a SystemDevice")
    if shaping is not None and flow_dyn is None:
        raise ValueError("flush_step: shaping needs the flow rules' dynamic state")
    if param is not None and pdyn is None:
        raise ValueError("flush_step: param needs the param state")
    if with_matured:
        materialize_matured(stats, batch.now)
        flush_step.sweeps += 1
    apply_exit_phase(stats, batch, with_exits, ddev, ddyn, with_degrade)
    out = flush_entries(
        stats, flow_dev, batch, blk_topk, ddev, ddyn, sysdev, occupy_timeout_ms,
        with_occupy, with_system, with_degrade, flow_dyn, pdyn, shaping, param, shaping_rounds, param_rounds,
    )
    if skstate is not None and sk is not None:
        sketch_fold(skstate, sk, decay=sketch_decay)
    return out


flush_step.sweeps = 0
