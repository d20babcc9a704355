"""The batched engine on the main path (port of
``sentinel_tpu/runtime/engine.py``).

It plays the role of the reference's ``CtSph`` + slot chain + node map
(CtSph.java:43-233): it owns the statistics tensors on its device, the
compiled flow rule table, the host node registry and the pending-op
buffers. ``submit_*`` calls enqueue ops; ``flush()`` encodes them into
padded arrays and runs one flush step (runtime/flush.py) for the whole
batch. ``entry_sync`` is submit + flush: the synchronous ``SphU.entry``.

The port runs the slot chain at pipeline depth 0, on one device or
sharded over ``n`` shards of it (``enable_mesh``, parallel/ici.py): flow
rules with every
controller (DEFAULT, with prioritized entries borrowing future windows;
RATE_LIMITER, WARM_UP, WARM_UP_RATE_LIMITER), hot-parameter rules,
authority rules, system rules and circuit breakers; entries (with their
args), bulk entries (with args columns), exits and traces; the sketch tier
(``sentinel.tpu.sketch.enabled``: the fold K11 rides the flush, the
promotion controller runs at every drain, and the cold ceilings refuse at
submit); and cluster-mode flow and param rules decided by the embedded
token service when this node is the token server (``cluster/``).
Everything else the JAX engine does is refused loudly with
``NotImplementedError`` naming its ROADMAP item (see
``_refuse_unported_config`` and the ``set_*`` methods), never ignored.

Locking as in the JAX engine: ``_lock`` guards the pending buffers and
host indexes briefly; ``_flush_lock`` serializes flushes and owns the
device state during a flush (lock order: ``_flush_lock`` → ``_lock``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core import errors as E
from sentinel_tpu_torch.metrics.events import MetricEvent
from sentinel_tpu_torch.metrics.nodes import (
    MINUTE_CFG,
    RS_MIN_RT,
    RS_MINUTE,
    RS_OCCUPIED,
    RS_SECOND,
    RS_THREADS,
    RS_WAITING,
    SECOND_CFG,
    NodeRegistry,
    StatsState,
    grow_stats,
    make_stats,
)
from sentinel_tpu_torch.metrics.nodes import rows_stats as _read_rows
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.models.rules import AuthorityRule, DegradeRule, FlowRule, ParamFlowRule
from sentinel_tpu_torch.rules.degrade_table import WS_FLOOR, DegradeDynState, DegradeIndex
from sentinel_tpu_torch.rules.flow_table import FlowIndex, FlowRuleDynState
from sentinel_tpu_torch.rules.param_table import (
    PARAM_CLOSED_MAX_SEGMENTS,
    PARAM_NEVER,
    ParamBatch,
    ParamDynState,
    ParamIndex,
    ParamSlotInfo,
    grow_param_state,
    make_param_state,
)
from sentinel_tpu_torch.rules.shaping import ShapingBatch
from sentinel_tpu_torch.runtime.sketch import SketchBatch, SketchTier
from sentinel_tpu_torch.runtime.flush import (
    SYS_TYPE_NAMES,
    TOPK_MAX,
    FlushBatch,
    borrow_horizon,
    flush_step,
    make_system_device,
)
from sentinel_tpu_torch.utils.clock import Clock, SystemClock, default_clock
from sentinel_tpu_torch.utils.config import config
from sentinel_tpu_torch.utils.system_status import sampler as system_sampler
from sentinel_tpu_torch.utils.device import DeviceLike, resolve_device
from sentinel_tpu_torch.utils.numeric import pad_pow2 as _pad_pow2
from sentinel_tpu_torch.utils.unported import (
    ROADMAP_CLUSTER,
    ROADMAP_IPC,
    ROADMAP_METRICS,
    ROADMAP_PIPELINE,
    ROADMAP_TIERS,
    unported,
)

# submit_many takes exactly submit_entry's request keys; anything else is
# handed to submit_entry(**req) so that a typo raises TypeError there.
_SUBMIT_ENTRY_KEYS = frozenset(("resource", "context_name", "origin", "acquire", "entry_type", "prio", "ts", "args"))

# Switches the JAX engine honours that this slice does not have yet.
_UNPORTED_SWITCHES = (
    (config.SPECULATIVE_ENABLED, ROADMAP_TIERS),
    (config.FAILOVER_ENABLED, ROADMAP_TIERS),
    (config.CAPTURE_ENABLED, ROADMAP_TIERS),
    (config.AUTOTUNE_ENABLED, ROADMAP_TIERS),
    (config.IPC_ENABLED, ROADMAP_IPC),
)


def _refuse_unported_config() -> None:
    for key, item in _UNPORTED_SWITCHES:
        if config.get_bool(key, False):
            raise unported(f"{key}=true", item)
    if config.get_int(config.PIPELINE_DEPTH, 0) > 0:
        raise unported(f"{config.PIPELINE_DEPTH} > 0", ROADMAP_PIPELINE)
    if config.get_bool(config.SKETCH_ENABLED, False) and config.get_bool(config.GOSSIP_ENABLED, False):
        # The tier merges peer frames (SketchTier.merge_remote); the agent
        # that would carry them between engines is not ported.
        raise unported(f"{config.GOSSIP_ENABLED}=true (the gossip transport)", ROADMAP_CLUSTER)


class Verdict(NamedTuple):
    admitted: bool
    reason: int  # errors.PASS / BLOCK_*
    wait_ms: int
    blocked_rule: Optional[object]  # the rule bean that blocked, if attributable
    limit_type: str = ""  # system block dimension (qps/thread/rt/load/cpu)


@dataclass(slots=True)
class _EntryOp:
    resource: str
    ts: int
    acquire: int
    rows: Tuple[int, int, int, int]  # default, cluster, origin|-1, entry|-1
    slots: List[Tuple[int, int]]  # (rule_gid, check_row)
    d_gids: List[int] = field(default_factory=list)  # degrade rule ids
    p_slots: List[ParamSlotInfo] = field(default_factory=list)  # hot-param slots
    auth_ok: bool = True  # AuthoritySlot verdict, decided at submit
    prio: bool = False
    context_name: str = C.CONTEXT_DEFAULT_NAME
    origin: str = ""
    args: Tuple[object, ...] = ()
    src: Optional[tuple] = None  # the (flow, degrade, param) indexes the ids were resolved against
    verdict: Optional[Verdict] = None
    cluster_blocked_rule: Optional[object] = None  # the token server said BLOCKED for this rule
    # Held cluster concurrency tokens [(service, token_id)] of THREAD-grade
    # cluster rules: released at exit, or at once if the entry is blocked.
    cluster_tokens: List[Tuple[object, int]] = field(default_factory=list)
    # Cluster flow ids the token server already decided (OK or BLOCKED): a
    # re-resolution after a rule reload must not re-add them as local slots.
    token_decided_flow_ids: frozenset = frozenset()

    @property
    def param_thread_rows(self) -> List[int]:
        """The per-value thread rows this entry holds once admitted; its
        exit releases them (``submit_exit(param_rows=...)``)."""
        return [s.prow for s in self.p_slots if s.grade == C.FLOW_GRADE_THREAD]


@dataclass
class _BulkParamCols:
    """One param rule's resolved columns over a bulk group (hot items make
    the threshold per value); ``valid`` masks entries without a value."""

    rule: ParamFlowRule
    valid: np.ndarray  # bool [n]
    prow: np.ndarray  # int32 [n]
    token_count: np.ndarray  # int32 [n]
    cost_ms: np.ndarray  # int32 [n]


@dataclass
class BulkOp:
    """A columnar group of ``n`` entries on one resource: one slot
    resolution, one numpy-slice encode, array verdicts. After ``flush()``
    ``admitted``/``reason``/``wait_ms`` are numpy arrays of length ``n``."""

    resource: str
    n: int
    ts: np.ndarray  # int32 [n]
    acquire: np.ndarray  # int32 [n]
    rows: Tuple[int, int, int, int]
    slots: List[Tuple[int, int]]
    d_gids: List[int]
    auth_ok: bool
    context_name: str
    origin: str
    src: Optional[tuple] = None
    # QPS-grade hot-param rules on this path: per-entry args resolved to
    # per-rule columns (one _BulkParamCols per param rule).
    args_column: Optional[Sequence] = None
    p_cols: List[_BulkParamCols] = field(default_factory=list)
    admitted: Optional[np.ndarray] = None
    reason: Optional[np.ndarray] = None
    wait_ms: Optional[np.ndarray] = None

    @property
    def admitted_count(self) -> int:
        return int(self.admitted.sum()) if self.admitted is not None else 0


@dataclass
class _BulkExitOp:
    rows: Tuple[int, int, int, int]
    n: int
    ts: np.ndarray
    count: np.ndarray
    rt: np.ndarray
    err: np.ndarray
    thr: int  # -1 exits, 0 traces
    d_gids: List[int] = field(default_factory=list)  # breakers to complete
    resource: Optional[str] = None
    src_dindex: Optional[DegradeIndex] = None


@dataclass(slots=True)
class _ExitOp:
    ts: int
    rows: Tuple[int, int, int, int]
    count: int = 0  # success delta
    rt: int = 0
    err: int = 0  # exception delta
    thr: int = 0  # thread delta (-1 exits, 0 traces)
    d_gids: List[int] = field(default_factory=list)  # breakers to complete
    p_rows: List[int] = field(default_factory=list)  # param thread rows to release
    resource: Optional[str] = None
    src_dindex: Optional[DegradeIndex] = None


def release_cluster_tokens(tokens: Sequence[Tuple[object, int]]) -> None:
    """Best-effort release of held cluster concurrency tokens (host
    bookkeeping, no kernel); a failed release is covered by the server's
    resourceTimeout sweep."""
    from sentinel_tpu_torch.utils.record_log import record_log

    for service, token_id in tokens:
        try:
            service.release_concurrent_token(token_id)
        except Exception:
            record_log.warn("[Engine] release of cluster token %d failed", token_id)


_SENTINEL = object()  # "not given" for the token service argument (None means no service)

# A token request that fails in transport counts as FAIL (the rule falls
# back to its local check when it allows it), as in the reference. Any
# other error, such as a fault of the embedded service's kernel, propagates.
_TOKEN_TRANSPORT_ERRORS = (OSError, TimeoutError)


def _is_cluster_param_slot(s) -> bool:
    """A param slot whose admission the token server owns: a QPS-grade
    cluster-mode ParamFlowRule with a flow_id."""
    r = s.rule
    return (
        isinstance(r, ParamFlowRule)
        and r.cluster_mode
        and r.grade == C.FLOW_GRADE_QPS
        and r.cluster_config is not None
        and r.cluster_config.flow_id is not None
    )


def _rounds_bucket(keys: np.ndarray) -> int:
    """Host-known max items per key of a recurrence batch, bucketed to a
    power of two and capped: above 16, 0 (every item; one key dominates)."""
    if keys.size == 0:
        return 1
    m = int(np.unique(keys, return_counts=True)[1].max())
    if m > 16:
        return 0
    return 1 if m <= 1 else 1 << (m - 1).bit_length()


class Engine:
    """Owns device state + host indexes; thread-safe op submission."""

    def __init__(
        self,
        clock: Optional[Clock] = None,
        initial_rows: Optional[int] = None,
        device: DeviceLike = None,
    ) -> None:
        _refuse_unported_config()
        self.device = resolve_device(device)
        self.clock = clock or default_clock()
        self.nodes = NodeRegistry()
        rows = _pad_pow2(initial_rows or config.get_int(config.INITIAL_ROWS, 1024))
        self.stats: StatsState = make_stats(rows, self.device)
        # The slab horizon: None while every future-slab cell is
        # (empty_ws, 0), else the latest window start a committed borrow
        # may hold (flush.borrow_horizon). The single-device flush sweeps
        # matured borrows (K1) only while it is set; see _note_borrows.
        self._slab_horizon: Optional[int] = None
        self.flow_index = FlowIndex([], cold_factor=config.cold_factor, device=self.device)
        self.flow_dyn: FlowRuleDynState = self.flow_index.make_dyn_state()
        self.degrade_index = DegradeIndex([], device=self.device)
        self.degrade_dyn: DegradeDynState = self.degrade_index.make_dyn_state()
        self.param_index = ParamIndex({})
        self.param_dyn: ParamDynState = make_param_state(8, self.device)
        # Test seam, as the JAX engine's: "scan" runs a closed-form-eligible
        # param batch on the rounds/scan path instead (the autotuner that
        # arbitrates this in the JAX engine is not ported, so by default
        # the closed form is taken whenever it is eligible).
        self.param_force_path: Optional[str] = None
        self.system_config = None  # rules/system_manager.SystemConfig, or None
        self.authority_rules: Dict[str, AuthorityRule] = {}
        self._entries: List[_EntryOp] = []
        self._exits: List[_ExitOp] = []
        self._bulk_entries: List[BulkOp] = []
        self._bulk_exits: List[_BulkExitOp] = []
        self._bulk_pending_n = 0
        self._bulk_exit_pending_n = 0
        self._rows_cache: Dict[tuple, Tuple[int, int, int, int]] = {}
        self._lock = threading.RLock()
        self._flush_lock = threading.RLock()
        self.max_batch = config.get_int(config.FLUSH_MAX_BATCH, 131072)
        # Device-side blocked-resource top-K (the JAX TelemetryBus default:
        # on, k = 8). The bus that folds these waits for its own item; the
        # engine keeps the last chunk's pair.
        self._blk_topk_k = self._blocked_topk_k()
        self.last_blocked_topk: Optional[Tuple[np.ndarray, np.ndarray]] = None
        # The statistics sketch tier (runtime/sketch.py): disarmed by
        # default, one attribute read per call site; armed, its fold rides
        # the flush and its candidate table the verdict copy.
        self.sketch = SketchTier(self)
        # Mesh mode (enable_mesh): the shards and the sharded steps built
        # for it, one per (shaping, param, rounds) variant.
        self.mesh = None
        self._sharded_fns: Optional[Dict[tuple, object]] = None
        self._n_shards = 1

    @staticmethod
    def _blocked_topk_k() -> int:
        if not config.get_bool(config.TELEMETRY_ENABLED, True):
            return 0
        k = config.get_int(config.TELEMETRY_BLOCKED_TOPK_K, -1)
        if k < 0:
            k = config.get_int(config.TELEMETRY_SKETCH_K, 8)
        if k > TOPK_MAX:
            raise unported(f"a blocked top-K above {TOPK_MAX} (k={k})", ROADMAP_METRICS)
        return max(0, k)

    # ------------------------------------------------------------------
    # mesh mode
    # ------------------------------------------------------------------
    def enable_mesh(self, n_devices: Optional[int] = None) -> None:
        """Switch to sharded flushing: every flush's entries and exits are
        split into ``n_devices`` (a power of two) contiguous shards of the
        engine's device, each shard's step runs against replicated
        counters, and the windows and breakers are merged after it; flow
        budgets and occupy borrows are conserved across the shards by the
        two-pass grant split, shaping pacers and hot parameters run once on
        the global item batch (parallel/ici.py). ``None`` is one shard per
        device: one. Pending ops are flushed first. Shards on several
        cards are not ported (``parallel.make_mesh``)."""
        from sentinel_tpu_torch.parallel import make_mesh

        with self._flush_lock:
            drained = self._flush_locked()
            with self._lock:
                self.mesh = make_mesh(1 if n_devices is None else n_devices, self.device)  # pow2 or ValueError
                self._n_shards = self.mesh.n_shards
                self._sharded_fns = {}
        _release_blocked_tokens(drained)

    def disable_mesh(self) -> None:
        with self._flush_lock:
            drained = self._flush_locked()
            with self._lock:
                self.mesh = None
                self._sharded_fns = None
                self._n_shards = 1
        _release_blocked_tokens(drained)

    def _sharded_fn_for(self, with_shaping: bool, with_param: bool, shaping_rounds: int, param_rounds: int):
        """The sharded step of one variant, built on first use (the occupy
        timeout is read then, as the JAX engine bakes it into the compiled
        step)."""
        from sentinel_tpu_torch.parallel import make_sharded_flush

        key = (with_shaping, with_param, shaping_rounds, param_rounds)
        fn = self._sharded_fns.get(key)
        if fn is None:
            fn = make_sharded_flush(self.mesh, occupy_timeout_ms=config.occupy_timeout_ms, with_shaping=with_shaping,
                                    with_param=with_param, shaping_rounds=shaping_rounds, param_rounds=param_rounds)
            self._sharded_fns[key] = fn
        return fn

    # ------------------------------------------------------------------
    # what this slice refuses
    # ------------------------------------------------------------------
    def flush_async(self):
        raise unported("flush_async", ROADMAP_PIPELINE)

    def drain(self) -> None:
        raise unported("Engine.drain", ROADMAP_PIPELINE)

    def set_depth(self, depth: int, drain: bool = True) -> None:
        raise unported("Engine.set_depth", ROADMAP_PIPELINE)

    def pipeline_stats(self, reset: bool = False) -> Dict[str, float]:
        raise unported("Engine.pipeline_stats", ROADMAP_PIPELINE)

    @property
    def last_flush_host_ms(self) -> Dict[str, float]:
        raise unported("Engine.last_flush_host_ms", ROADMAP_PIPELINE)

    def start_auto_flush(self, interval_ms: Optional[float] = None) -> None:
        raise unported("Engine.start_auto_flush", ROADMAP_PIPELINE)

    def reset(self) -> None:
        raise unported("Engine.reset", ROADMAP_PIPELINE)

    def retune_second_window(self, sample_count: int, interval_ms: int) -> None:
        raise unported("Engine.retune_second_window", ROADMAP_METRICS)

    # ------------------------------------------------------------------
    # rule plumbing (called by the rule manager)
    # ------------------------------------------------------------------
    def set_flow_rules(self, rules: Sequence[FlowRule]) -> None:
        findex = FlowIndex(rules, cold_factor=config.cold_factor, device=self.device)
        with self._flush_lock:
            drained = self._flush_locked()  # pending ops are decided under the old rules
            with self._lock:
                self.flow_index = findex
                self.flow_dyn = findex.make_dyn_state()
        _release_blocked_tokens(drained)

    def set_degrade_rules(self, rules: Sequence[DegradeRule]) -> None:
        """Breaker state is not carried across reloads: the reference
        builds fresh CircuitBreaker objects per load (DegradeRuleManager)."""
        dindex = DegradeIndex(rules, device=self.device)
        with self._flush_lock:
            drained = self._flush_locked()
            with self._lock:
                self.degrade_index = dindex
                self.degrade_dyn = dindex.make_dyn_state()
        _release_blocked_tokens(drained)

    def set_param_rules(self, by_resource: Dict[str, List[ParamFlowRule]]) -> None:
        """A fresh value index and fresh param state on every reload, like
        ParamFlowRuleManager clearing ParameterMetric. Sketch-mode rules
        resolve through the sketch tier when it is armed."""
        pindex = ParamIndex(by_resource, sketch_tier=self.sketch)
        with self._flush_lock:
            drained = self._flush_locked()
            with self._lock:
                self.param_index = pindex
                self.param_dyn = make_param_state(8, self.device)
        _release_blocked_tokens(drained)

    def set_system_config(self, cfg) -> None:
        with self._flush_lock:
            drained = self._flush_locked()
            with self._lock:
                self.system_config = cfg if cfg is not None and cfg.any_enabled else None
                if self.system_config is not None and (
                    self.system_config.highest_system_load >= 0 or self.system_config.highest_cpu_usage >= 0
                ):
                    system_sampler.start()
        _release_blocked_tokens(drained)

    def set_authority_rules(self, by_resource: Dict[str, AuthorityRule]) -> None:
        with self._flush_lock:
            drained = self._flush_locked()
            with self._lock:
                self.authority_rules = dict(by_resource)
        _release_blocked_tokens(drained)

    def _auth_ok(self, resource: str, origin: str) -> bool:
        rule = self.authority_rules.get(resource)
        if rule is None:
            return True
        # Imported here: the manager module instantiates its manager, which
        # reaches back to the API for the engine.
        from sentinel_tpu_torch.rules.authority_manager import AuthorityRuleManager

        return AuthorityRuleManager.passes(rule, origin)

    # ------------------------------------------------------------------
    # op submission
    # ------------------------------------------------------------------
    def resolve_entry_rows(
        self, resource: str, context_name: str, origin: str, entry_type: C.EntryType
    ) -> Optional[Tuple[int, int, int, int]]:
        """Rows for the default node, cluster node, origin node and global
        entry node (NodeSelectorSlot/ClusterBuilderSlot). None above the
        resource cap (pass-through); that None is not cached."""
        key = (resource, context_name, origin, entry_type)
        hit = self._rows_cache.get(key)
        if hit is not None:
            return hit
        crow = self.nodes.cluster_row(resource)
        if crow is None:
            return None
        drow = self.nodes.default_row(resource, context_name)
        orow = self.nodes.origin_row(resource, origin) if origin else None
        erow = self.nodes.entry_node_row if entry_type == C.EntryType.IN else None
        rows = (
            drow if drow is not None else -1,
            crow,
            orow if orow is not None else -1,
            erow if erow is not None else -1,
        )
        self._rows_cache[key] = rows
        return rows

    def submit_entry(
        self,
        resource: str,
        context_name: str = C.CONTEXT_DEFAULT_NAME,
        origin: str = "",
        acquire: int = 1,
        entry_type: C.EntryType = C.EntryType.OUT,
        prio: bool = False,
        ts: Optional[int] = None,
        args: Sequence[object] = (),
    ) -> Optional[_EntryOp]:
        """Enqueue an entry; None for pass-through (over the resource cap).
        ``prio`` entries may borrow a future window when over a QPS rule.
        ``args`` are the invocation arguments hot-parameter rules check.

        With the sketch tier armed, an over-cap resource is noted in the
        key stream, and the cold ceilings may refuse the entry at once
        (BLOCK_SKETCH, never enqueued). Cluster-mode rules consult the
        token service outside the engine lock (it may be remote in the
        reference, FlowRuleChecker.passClusterCheck); the op is enqueued
        after that, so no flush sees it half decided."""
        args = tuple(args)
        with self._lock:
            findex = self.flow_index
            cluster_gids = findex.cluster_gids
            op = self._resolve_entry_locked(findex, self.degrade_index, self.param_index, resource, context_name,
                                            origin, acquire, entry_type, prio, ts, args)
        sk = self.sketch
        if op is None:
            # Over the cap: the one key class the encode never sees.
            if sk.armed:
                if sk.cold_armed and sk.cold_blocked(resource, findex, self.param_index):
                    return self._blocked_cold(resource, context_name, origin, acquire)
                sk.note_unrouted(resource, acquire)
            return None
        if sk.cold_armed and sk.cold_blocked(resource, findex, self.param_index):
            return self._blocked_cold(resource, context_name, origin, acquire)
        if (
            sk.cold_armed
            and op.args
            and self.param_index.sketch_idx_by_resource
            and sk.cold_value_blocked(resource, self.param_index, op.args)
        ):
            return self._blocked_cold(resource, context_name, origin, acquire, limit_type="cold_value")
        if cluster_gids and any(gid in cluster_gids for gid, _ in op.slots):
            self._apply_cluster_checks(op, cluster_gids)
        if op.p_slots and any(s.rule is not None and s.rule.cluster_mode for s in op.p_slots):
            self._apply_cluster_param_checks(op)
        with self._lock:
            self._entries.append(op)
            over = len(self._entries) >= self.max_batch
        if over:
            self.flush()  # flush-on-size: the pending buffer is bounded
        return op

    def _resolve_entry_locked(self, findex, dindex, pindex, resource, context_name, origin, acquire, entry_type,
                              prio, ts, args) -> Optional[_EntryOp]:
        """One resolved, not yet enqueued op against the given index
        snapshot; None above the resource cap. The caller holds ``_lock``.
        submit_entry and submit_many both resolve here, so the path a
        request takes never changes its semantics."""
        rows = self.resolve_entry_rows(resource, context_name, origin, entry_type)
        if rows is None:
            return None
        return _EntryOp(
            resource=resource,
            ts=self.clock.now_ms() if ts is None else int(ts),
            acquire=int(acquire),
            rows=rows,
            slots=findex.resolve_slots(resource, context_name, origin, self.nodes),
            d_gids=dindex.gids_for(resource),
            p_slots=pindex.slots_for(resource, args) if args and pindex.has_rules() else [],
            auth_ok=self._auth_ok(resource, origin),
            prio=bool(prio),
            context_name=context_name,
            origin=origin,
            args=args,
            src=(findex, dindex, pindex),
        )

    def submit_many(self, requests: Sequence[Dict]) -> List[Optional[_EntryOp]]:
        """Deferred batch submission: enqueue many entries without
        flushing; verdicts appear on the returned ops after ``flush()``
        (None entries are over-cap pass-throughs). Each request is a
        kwargs dict for :meth:`submit_entry` (``{"resource": ...}`` at
        least). Order guarantees, as the JAX engine's:

        * the whole batch resolves under ONE lock acquisition;
        * a request with keys submit_entry does not take goes, with the
          rest, through ``submit_entry(**req)`` (which raises for it);
        * from the first request that needs the token service
          (cluster-mode flow or param rules) on, the resolved ops are held
          back: ONE batched token call per frame kind runs outside the
          lock (:meth:`_apply_cluster_checks_bulk`), then they append in
          request order;
        * reaching ``max_batch`` flushes the ops queued so far (their
          verdicts are then filled) and the remaining requests go through
          ``submit_entry``, in request order.

        With the sketch tier's cold ceilings armed every request goes
        through ``submit_entry`` (the ceiling must see each one)."""
        if self.sketch.cold_armed:
            return [self.submit_entry(**req) for req in requests]
        out: List[Optional[_EntryOp]] = []
        resume_at = 0
        over = False
        tail: List[Tuple[_EntryOp, bool]] = []  # (op, needs the token service)
        with self._lock:
            findex, dindex, pindex = self.flow_index, self.degrade_index, self.param_index
            cluster_gids = findex.cluster_gids
            for i, req in enumerate(requests):
                if not req.keys() <= _SUBMIT_ENTRY_KEYS:
                    resume_at = i
                    break
                op = self._resolve_entry_locked(
                    findex, dindex, pindex, req["resource"], req.get("context_name", C.CONTEXT_DEFAULT_NAME),
                    req.get("origin", ""), req.get("acquire", 1), req.get("entry_type", C.EntryType.OUT),
                    req.get("prio", False), req.get("ts"), tuple(req.get("args", ())),
                )
                resume_at = i + 1
                if op is None:
                    if self.sketch.armed:
                        self.sketch.note_unrouted(req["resource"], req.get("acquire", 1))
                    out.append(None)
                    continue
                needs_cluster = bool(
                    (cluster_gids and any(gid in cluster_gids for gid, _ in op.slots))
                    or any(s.rule is not None and s.rule.cluster_mode for s in op.p_slots)
                )
                out.append(op)
                if needs_cluster or tail:
                    tail.append((op, needs_cluster))
                    if len(self._entries) + len(tail) >= self.max_batch:
                        over = True
                        break
                    continue
                self._entries.append(op)
                if len(self._entries) >= self.max_batch:
                    over = True
                    break
        if tail:
            pending = [(op, cluster_gids) for op, needs in tail if needs]
            if pending:
                self._apply_cluster_checks_bulk(pending)
            with self._lock:
                self._entries.extend(op for op, _ in tail)
                if len(self._entries) >= self.max_batch:
                    over = True
        if over:
            self.flush()  # flush-on-size, as submit_entry
        for req in requests[resume_at:]:
            out.append(self.submit_entry(**req))
        return out

    def _blocked_cold(
        self, resource: str, context_name: str, origin: str, acquire: int, limit_type: str = "cold"
    ) -> _EntryOp:
        """A never-enqueued sketch cold-ceiling verdict (``limit_type``
        "cold" for the resource ceiling, "cold_value" for the value
        ceiling; the tier counted it). Nothing reaches the device, so no
        gauge charges. The block-log row the JAX engine writes waits for
        ROADMAP Queue 1 item 8."""
        op = _EntryOp(
            resource=resource, ts=self.clock.now_ms(), acquire=int(acquire), rows=(-1, -1, -1, -1), slots=[],
            context_name=context_name, origin=origin,
        )
        op.verdict = Verdict(False, E.BLOCK_SKETCH, 0, None, limit_type)
        return op

    def _blocked_cold_bulk(self, resource: str, n: int, context_name: str, origin: str, acquire) -> BulkOp:
        """Bulk form of :meth:`_blocked_cold`: dense all-refused arrays."""
        g = BulkOp(
            resource=resource, n=n, ts=np.full(n, self.clock.now_ms(), dtype=np.int32),
            acquire=self._bulk_col(acquire, n, 1), rows=(-1, -1, -1, -1), slots=[], d_gids=[], auth_ok=True,
            context_name=context_name, origin=origin,
        )
        g.admitted = np.zeros(n, dtype=bool)
        g.reason = np.full(n, E.BLOCK_SKETCH, dtype=np.int32)
        g.wait_ms = np.zeros(n, dtype=np.int32)
        return g

    # ------------------------------------------------------------------
    # cluster-mode rules (the token service)
    # ------------------------------------------------------------------
    @staticmethod
    def _cluster_token_service():
        """The token service of this node's cluster role
        (FlowRuleChecker.pickClusterService): the embedded server's
        service in server mode, None otherwise (client mode is not
        ported: ``ClusterStateManager.set_to_client`` raises)."""
        from sentinel_tpu_torch.cluster.state import ClusterStateManager, EmbeddedClusterTokenServerProvider

        if ClusterStateManager.is_server():
            server = EmbeddedClusterTokenServerProvider.get_server()
            return getattr(server, "service", server)
        return None

    def _apply_cluster_checks(self, op: _EntryOp, cluster_gids, service=_SENTINEL, prefetched=None,
                              wait: Optional[List[int]] = None) -> None:
        """applyTokenResult (FlowRuleChecker.java:207-230): OK passes the
        rule (its local slot is dropped), SHOULD_WAIT paces then passes,
        BLOCKED blocks, anything else falls back to the local check when
        the rule allows it, else passes. THREAD-grade rules hold a
        concurrency token instead (released at exit), always asked per op.
        ``prefetched`` (the batched seam) maps gid -> the token result a
        batched call already got; ``wait`` is the batch's one-cell
        SHOULD_WAIT accumulator, settled by the caller (None: this op
        settles its own)."""
        if service is _SENTINEL:
            service = self._cluster_token_service()
        own_wait = wait is None
        if own_wait:
            wait = [0]
        kept = []
        decided = set()
        for gid, crow in op.slots:
            rule = cluster_gids.get(gid)
            if rule is None:
                kept.append((gid, crow))
                continue
            cc = rule.cluster_config
            if service is None:
                if cc.fallback_to_local_when_fail:
                    kept.append((gid, crow))
                continue
            if rule.grade == C.FLOW_GRADE_THREAD:
                try:
                    result = service.request_concurrent_token(cc.flow_id, op.acquire)
                except _TOKEN_TRANSPORT_ERRORS:
                    result = None
                status = result.status if result is not None else C.TokenResultStatus.FAIL
                if status == C.TokenResultStatus.OK:
                    op.cluster_tokens.append((service, result.token_id))
                    decided.add(cc.flow_id)
                elif status == C.TokenResultStatus.BLOCKED:
                    op.cluster_blocked_rule = rule
                    decided.add(cc.flow_id)
                elif cc.fallback_to_local_when_fail:
                    kept.append((gid, crow))
                continue
            if prefetched is not None and gid in prefetched:
                result = prefetched[gid]
            else:
                try:
                    result = service.request_token(cc.flow_id, op.acquire, op.prio)
                except _TOKEN_TRANSPORT_ERRORS:
                    result = None
            status = result.status if result is not None else C.TokenResultStatus.FAIL
            if status == C.TokenResultStatus.OK:
                decided.add(cc.flow_id)
            elif status == C.TokenResultStatus.SHOULD_WAIT:
                wait[0] += int(result.wait_in_ms)
                decided.add(cc.flow_id)
            elif status == C.TokenResultStatus.BLOCKED:
                op.cluster_blocked_rule = rule
                decided.add(cc.flow_id)
            elif cc.fallback_to_local_when_fail:
                kept.append((gid, crow))
        op.slots = kept
        op.token_decided_flow_ids = op.token_decided_flow_ids | frozenset(decided)
        if own_wait:
            self._settle_cluster_wait(wait[0])

    def _settle_cluster_wait(self, total: int) -> None:
        """Pay the accumulated SHOULD_WAIT pacing once, bounded by
        sentinel.tpu.cluster.wait.cap.ms (the overflow is forfeited). The
        cluster-wait telemetry counter waits for ROADMAP Queue 1 item 8."""
        if total <= 0:
            return
        cap = config.get_int(config.CLUSTER_WAIT_CAP_MS, 1000)
        slept = min(total, cap) if cap > 0 else total
        if slept > 0:
            self.clock.sleep_ms(slept)

    @staticmethod
    def _cluster_param_groups(op: _EntryOp) -> Dict[int, Tuple[object, List[str]]]:
        """flow_id -> (rule, values) of the op's cluster-mode QPS param
        slots (the unit of one request_param_token call)."""
        groups: Dict[int, Tuple[object, List[str]]] = {}
        for s in op.p_slots:
            if _is_cluster_param_slot(s):
                fid = int(s.rule.cluster_config.flow_id)
                if fid not in groups:
                    groups[fid] = (s.rule, [])
                groups[fid][1].append(s.value_key)
        return groups

    def _apply_cluster_checks_bulk(self, pending: List[Tuple[_EntryOp, Dict]]) -> None:
        """The batched seam of ``submit_many``: every cluster verdict of an
        op batch from ONE batched token call per frame kind (flow, param),
        outside the engine lock, then applied per op through the same
        mapping as the per-op path. SHOULD_WAIT pacing accumulates over
        the batch and settles once, bounded. THREAD-grade held tokens stay
        per op (a held token has its own id). A batched call that fails in
        transport counts as FAIL for each of its requests."""
        service = self._cluster_token_service()
        wait = [0]
        flow_rows: List[Tuple[int, int, bool]] = []
        flow_refs: List[Tuple[int, int]] = []  # (pending index, gid)
        param_rows: List[Tuple[int, int, List[str]]] = []
        param_refs: List[Tuple[int, int]] = []  # (pending index, flow id)
        if service is not None:
            for oi, (op, gids) in enumerate(pending):
                for gid, _ in op.slots:
                    rule = gids.get(gid)
                    if rule is None or rule.grade == C.FLOW_GRADE_THREAD:
                        continue
                    flow_rows.append((int(rule.cluster_config.flow_id), op.acquire, op.prio))
                    flow_refs.append((oi, gid))
                for fid, (_, values) in self._cluster_param_groups(op).items():
                    param_rows.append((fid, op.acquire, values))
                    param_refs.append((oi, fid))
        flow_pre: List[Dict[int, object]] = [{} for _ in pending]
        param_pre: List[Dict[int, object]] = [{} for _ in pending]
        for rows, refs, call, pre in ((flow_rows, flow_refs, "request_tokens_batch", flow_pre),
                                      (param_rows, param_refs, "request_param_tokens_batch", param_pre)):
            if not rows:
                continue
            try:
                results = getattr(service, call)(rows)
            except _TOKEN_TRANSPORT_ERRORS:
                results = [None] * len(rows)
            for (oi, key), r in zip(refs, results):
                pre[oi][key] = r
        for oi, (op, gids) in enumerate(pending):
            if gids and any(gid in gids for gid, _ in op.slots):
                self._apply_cluster_checks(op, gids, service=service, prefetched=flow_pre[oi], wait=wait)
            if op.p_slots and any(s.rule is not None and s.rule.cluster_mode for s in op.p_slots):
                self._apply_cluster_param_checks(op, service=service, prefetched=param_pre[oi])
        self._settle_cluster_wait(wait[0])

    def _apply_cluster_param_checks(self, op: _EntryOp, service=_SENTINEL, prefetched=None) -> None:
        """Cluster-mode hot-param admission (ParamFlowChecker.passCheck's
        cluster branch): QPS-grade cluster rules ask the token server with
        the entry's values; THREAD grade stays local. OK drops the local
        slots, BLOCKED blocks the op, FAIL or no service falls back to the
        local check when the rule allows it, else passes. ``prefetched``
        (the batched seam) maps flow id -> a result already obtained."""
        groups = self._cluster_param_groups(op)
        if not groups:
            return
        if service is _SENTINEL:
            service = self._cluster_token_service()
        decided = set()
        fallback_fids = set()
        for fid, (rule, values) in groups.items():
            cc = rule.cluster_config
            if service is None:
                (fallback_fids if cc.fallback_to_local_when_fail else decided).add(fid)
                continue
            if prefetched is not None and fid in prefetched:
                result = prefetched[fid]
            else:
                try:
                    result = service.request_param_token(fid, op.acquire, values)
                except _TOKEN_TRANSPORT_ERRORS:
                    result = None
            status = result.status if result is not None else C.TokenResultStatus.FAIL
            if status == C.TokenResultStatus.OK:
                decided.add(fid)
            elif status == C.TokenResultStatus.BLOCKED:
                op.cluster_blocked_rule = rule
                decided.add(fid)
            elif cc.fallback_to_local_when_fail:
                fallback_fids.add(fid)
            else:
                decided.add(fid)
        # Token-decided rules are not also checked locally; fallback rules
        # keep their local slots.
        op.p_slots = [
            s for s in op.p_slots
            if not _is_cluster_param_slot(s) or int(s.rule.cluster_config.flow_id) in fallback_fids
        ]
        op.token_decided_flow_ids = op.token_decided_flow_ids | frozenset(decided)

    def submit_exit(
        self,
        rows: Tuple[int, int, int, int],
        rt: int,
        count: int = 1,
        err: int = 0,
        ts: Optional[int] = None,
        resource: Optional[str] = None,
        param_rows: Sequence[int] = (),
        cluster_tokens: Sequence[Tuple[object, int]] = (),
    ) -> None:
        """StatisticSlot.exit: success + RT + thread release (+exception).
        ``resource`` routes the completion to the resource's circuit
        breakers (DegradeSlot.exit), resolved against the degrade rules
        active at exit time, like the reference. ``param_rows`` are the
        per-value thread gauges to release (the entry's
        ``param_thread_rows``); ``cluster_tokens`` the held cluster
        concurrency tokens to hand back (the entry's ``cluster_tokens``)."""
        with self._lock:
            dindex = self.degrade_index
            op = _ExitOp(
                ts=self.clock.now_ms() if ts is None else int(ts),
                rows=rows,
                count=int(count),
                rt=min(int(rt), config.statistic_max_rt),
                err=int(err),
                thr=-1,
                d_gids=dindex.gids_for(resource) if resource is not None else [],
                p_rows=list(param_rows),
                resource=resource,
                src_dindex=dindex if resource is not None else None,
            )
            self._exits.append(op)
            over = len(self._exits) >= self.max_batch
        if cluster_tokens:
            release_cluster_tokens(cluster_tokens)
        if over:
            self.flush()

    def submit_trace(
        self, rows: Tuple[int, int, int, int], count: int = 1, ts: Optional[int] = None
    ) -> None:
        """Tracer-style direct exception recording (no thread/success)."""
        op = _ExitOp(
            ts=self.clock.now_ms() if ts is None else int(ts), rows=rows, err=int(count)
        )
        with self._lock:
            self._exits.append(op)
            over = len(self._exits) >= self.max_batch
        if over:
            self.flush()

    @staticmethod
    def _bulk_col(v, n: int, default: int) -> np.ndarray:
        """Broadcast a scalar / validate an array into a fresh int32 [n]."""
        if v is None:
            return np.full(n, default, dtype=np.int32)
        src = np.asarray(v)
        if src.dtype.kind not in "iub":
            raise TypeError(
                f"bulk column dtype {src.dtype} is not integral; pass int values"
            )
        info = np.iinfo(np.int32)
        if src.size and (src.min() < info.min or src.max() > info.max):
            raise OverflowError(
                "bulk column value out of int32 range; pass relative-ms timestamps"
            )
        a = src.astype(np.int32, copy=True)
        if a.ndim == 0:
            return np.full(n, int(a), dtype=np.int32)
        if a.shape != (n,):
            raise ValueError(f"bulk column shape {a.shape} != ({n},)")
        return a

    def submit_bulk(
        self,
        resource: str,
        n: int,
        ts=None,
        acquire=1,
        context_name: str = C.CONTEXT_DEFAULT_NAME,
        origin: str = "",
        entry_type: C.EntryType = C.EntryType.OUT,
        args_column: Optional[Sequence] = None,
    ) -> Optional[BulkOp]:
        """Enqueue ``n`` entries on one resource as one columnar group
        (``ts``/``acquire`` scalars or [n] arrays). Returns None for
        pass-through, like :meth:`submit_entry`.

        ``args_column`` (length ``n``: one args tuple per entry, or a
        ``param_table.ArgsColumns``) checks QPS-grade hot-param rules per
        entry; THREAD-grade param rules and collection values need
        per-entry bookkeeping, and cluster-mode rules a token per entry:
        these raise ``ValueError`` (use :meth:`submit_entry`). With the
        sketch tier's cold ceilings armed, a group over its ceiling is
        refused whole (BLOCK_SKETCH); a group only some of whose values
        are over the value ceiling raises ``ValueError`` too."""
        if n < 1:
            raise ValueError("submit_bulk: n must be >= 1")
        if n > self.max_batch:
            raise ValueError(f"submit_bulk: n={n} exceeds max_batch={self.max_batch}; split the group")
        sk = self.sketch
        if sk.cold_armed and sk.cold_blocked(resource, self.flow_index, self.param_index, n=n):
            return self._blocked_cold_bulk(resource, n, context_name, origin, acquire)
        if sk.cold_armed and args_column is not None and self.param_index.sketch_idx_by_resource:
            vmask = sk.cold_value_mask(resource, self.param_index, args_column, n)
            if vmask is not None:
                if bool(vmask.all()):
                    sk.note_cold_value_rows(n)
                    return self._blocked_cold_bulk(resource, n, context_name, origin, acquire)
                raise ValueError(
                    "submit_bulk: the sketch cold-value ceiling needs per-entry verdicts on this group — "
                    "use submit_entry"
                )
        with self._lock:
            rows = self.resolve_entry_rows(resource, context_name, origin, entry_type)
            if rows is None:
                if sk.armed:
                    sk.note_unrouted(resource, int(self._bulk_col(acquire, n, 1).sum()))
                return None
            findex, dindex, pindex = self.flow_index, self.degrade_index, self.param_index
            slots = findex.resolve_slots(resource, context_name, origin, self.nodes)
            if findex.cluster_gids and any(gid in findex.cluster_gids for gid, _ in slots):
                raise ValueError(
                    "submit_bulk: resource has cluster-mode flow rules (token verdicts are per entry) — "
                    "use submit_entry"
                )
            p_cols: List[_BulkParamCols] = []
            if args_column is not None:
                if len(args_column) != n:
                    raise ValueError(f"submit_bulk: args_column length {len(args_column)} != n={n}")
                if pindex.has_rules():
                    p_cols = self._bulk_param_cols(pindex, resource, args_column)
            g = BulkOp(
                resource=resource,
                n=n,
                ts=self._bulk_col(ts, n, self.clock.now_ms()),
                acquire=self._bulk_col(acquire, n, 1),
                rows=rows,
                slots=slots,
                d_gids=dindex.gids_for(resource),
                auth_ok=self._auth_ok(resource, origin),
                context_name=context_name,
                origin=origin,
                src=(findex, dindex, pindex),
                args_column=args_column,
                p_cols=p_cols,
            )
            self._bulk_entries.append(g)
            self._bulk_pending_n += n
            over = len(self._entries) + self._bulk_pending_n >= self.max_batch
        if over:
            self.flush()
        return g

    @staticmethod
    def _bulk_param_cols(pindex: ParamIndex, resource: str, args_column: Sequence) -> List[_BulkParamCols]:
        """A per-entry args column resolved to per-rule columns
        (``ParamIndex.bulk_cols``). QPS grade only: THREAD-grade rules need
        per-entry exits, collection values per-entry expansion."""
        for _, r in pindex.by_resource.get(resource, ()):
            if r.grade == C.FLOW_GRADE_THREAD:
                raise ValueError("submit_bulk: THREAD-grade param rules need per-entry exits — use submit_entry")
            if r.cluster_mode:
                raise ValueError(
                    "submit_bulk: resource has cluster-mode param rules (the token request is per entry) — "
                    "use submit_entry"
                )
        cols = pindex.bulk_cols(resource, args_column)
        if cols is None:
            raise ValueError("submit_bulk: collection param values expand per entry — use submit_entry")
        return [_BulkParamCols(rule=r, valid=valid, prow=prow, token_count=tc, cost_ms=cost)
                for r, valid, prow, tc, cost in cols]

    def submit_exit_bulk(
        self,
        rows: Tuple[int, int, int, int],
        n: int,
        rt=0,
        count=1,
        err=0,
        ts=None,
        resource: Optional[str] = None,
    ) -> None:
        """Columnar exits: ``n`` completions on one node-row set (and on
        the resource's breakers when ``resource`` is given)."""
        if n < 1:
            raise ValueError("submit_exit_bulk: n must be >= 1")
        if n > self.max_batch:
            raise ValueError(f"submit_exit_bulk: n={n} exceeds max_batch={self.max_batch}; split the group")
        with self._lock:
            dindex = self.degrade_index
            rt_col = self._bulk_col(rt, n, 0)
            np.minimum(rt_col, config.statistic_max_rt, out=rt_col)
            gx = _BulkExitOp(
                rows=rows,
                n=n,
                ts=self._bulk_col(ts, n, self.clock.now_ms()),
                count=self._bulk_col(count, n, 1),
                rt=rt_col,
                err=self._bulk_col(err, n, 0),
                thr=-1,
                d_gids=dindex.gids_for(resource) if resource is not None else [],
                resource=resource,
                src_dindex=dindex if resource is not None else None,
            )
            self._bulk_exits.append(gx)
            self._bulk_exit_pending_n += n
            over = len(self._exits) + self._bulk_exit_pending_n >= self.max_batch
        if over:
            self.flush()

    def entry_sync(
        self,
        resource: str,
        context_name: str = C.CONTEXT_DEFAULT_NAME,
        origin: str = "",
        acquire: int = 1,
        entry_type: C.EntryType = C.EntryType.OUT,
        prio: bool = False,
        args: Sequence[object] = (),
    ) -> Tuple[Optional[_EntryOp], Verdict]:
        """Submit + flush: synchronous SphU.entry semantics."""
        op = self.submit_entry(resource, context_name, origin, acquire, entry_type, prio, args=args)
        if op is None:
            return None, Verdict(True, E.PASS, 0, None)  # over cap: pass-through
        self.flush()
        return op, op.verdict

    # ------------------------------------------------------------------
    # flushing
    # ------------------------------------------------------------------
    # Rebase when less than ~2 days of int32-ms headroom remain.
    REBASE_HEADROOM_MS = 2 * 24 * 3600 * 1000

    def _maybe_rebase(self) -> None:
        """Shift the relative-ms epoch forward before int32 overflow
        (a SystemClock after ~22 days); stored window starts shift too."""
        clock = self.clock
        if not isinstance(clock, SystemClock):
            return
        if clock.rebase_headroom_ms() > self.REBASE_HEADROOM_MS:
            return
        offset = clock.rebase()
        if offset > 0:
            self._apply_rebase(offset)

    def _apply_rebase(self, offset: int) -> None:
        """Shift every stored absolute-ms tensor and pending op by
        ``offset`` (a multiple of SystemClock.REBASE_GRANULARITY_MS, so
        every window grid is preserved)."""
        if offset % SystemClock.REBASE_GRANULARITY_MS != 0:
            raise ValueError(f"rebase offset {offset} not aligned to window grids")

        def shift(ws: torch.Tensor, floor: int) -> None:
            # In place: ws = max(ws - offset, floor), in int64 so that no
            # intermediate wraps.
            ws.copy_(torch.clamp(ws.to(torch.int64) - offset, min=floor).to(torch.int32))

        s = self.stats
        if self._slab_horizon is not None:
            self._slab_horizon -= offset
        shift(s.second.window_start, SECOND_CFG.empty_ws)
        shift(s.minute.window_start, MINUTE_CFG.empty_ws)
        shift(s.future_ws, SECOND_CFG.empty_ws)
        shift(self.flow_dyn.latest_passed_time, -(10**9))
        shift(self.flow_dyn.last_filled_time, -(10**9))
        # Breakers: an OPEN breaker's retry deadline and the window anchor
        # are absolute ms. A rule's statIntervalMs need not divide the
        # rebase granularity, so the shifted window start is floor-aligned
        # to the rule's own grid (exits align ts - ts % interval); torch's
        # remainder is a floor modulo, as JAX's, for a negative start too.
        d = self.degrade_dyn
        shift(d.next_retry, WS_FLOOR)
        shift(d.ws, WS_FLOOR)
        iv = self.degrade_index.device.interval_ms.clamp(min=1)
        d.ws.copy_(torch.where(d.ws > WS_FLOOR, d.ws - torch.remainder(d.ws, iv), d.ws))
        # Hot-param buckets and pacers; PARAM_NEVER ("no state yet") stays.
        shift(self.param_dyn.last_add, PARAM_NEVER)
        shift(self.param_dyn.latest, PARAM_NEVER)
        if self.sketch.armed:
            self.sketch.on_rebase(offset)
        for op in self._entries:
            op.ts = max(op.ts - offset, 0)
        for x in self._exits:
            x.ts = max(x.ts - offset, 0)
        for g in self._bulk_entries:
            np.maximum(g.ts - offset, 0, out=g.ts)
        for gx in self._bulk_exits:
            np.maximum(gx.ts - offset, 0, out=gx.ts)

    def _ensure_capacity(self) -> None:
        need = len(self.nodes)
        if need > self.stats.n_rows:
            self.stats = grow_stats(self.stats, _pad_pow2(need))
        pneed = self.param_index.n_rows
        if pneed > self.param_dyn.tokens.shape[0]:
            self.param_dyn = grow_param_state(self.param_dyn, _pad_pow2(pneed))

    def flush(self) -> List[_EntryOp]:
        """Encode + run the flush step for all pending ops; fills verdicts
        before it returns (pipeline depth 0). Queued sketch promotions and
        demotions land first, outside the flush lock; after the flush,
        entries that were blocked hand their held cluster tokens back."""
        if self.sketch.armed and self.sketch.pending_actions:
            self.sketch.apply_actions()
        with self._flush_lock:
            entries = self._flush_locked()
        _release_blocked_tokens(entries)
        return entries

    def _flush_locked(self) -> List[_EntryOp]:
        with self._lock:
            self._maybe_rebase()
            entries, self._entries = self._entries, []
            exits, self._exits = self._exits, []
            bulk_e, self._bulk_entries = self._bulk_entries, []
            bulk_x, self._bulk_exits = self._bulk_exits, []
            self._bulk_pending_n = 0
            self._bulk_exit_pending_n = 0
            if not entries and not exits and not bulk_e and not bulk_x:
                return []
            findex, dindex, pindex = self.flow_index, self.degrade_index, self.param_index
            auth_rules = self.authority_rules
            # Ops resolved against a superseded rule table are re-resolved
            # against the one they will be checked with.
            cur = (findex, dindex, pindex)
            for op in entries:
                if op.src != cur:
                    # Rules the token server already decided stay decided: a
                    # local re-check would double-check a granted token.
                    decided = op.token_decided_flow_ids
                    op.slots = [
                        sl for sl in findex.resolve_slots(op.resource, op.context_name, op.origin, self.nodes)
                        if not _token_decided(findex.cluster_gids.get(sl[0]), decided)
                    ]
                    op.d_gids = dindex.gids_for(op.resource)
                    p_slots = pindex.slots_for(op.resource, op.args) if op.args and pindex.has_rules() else []
                    op.p_slots = [ps for ps in p_slots if not _token_decided(ps.rule, decided)]
                    op.src = cur
            for g in bulk_e:
                if g.src != cur:
                    g.slots = findex.resolve_slots(g.resource, g.context_name, g.origin, self.nodes)
                    g.d_gids = dindex.gids_for(g.resource)
                    g.p_cols = []
                    if g.args_column is not None and pindex.has_rules():
                        # Param rows are index-scoped: re-intern the column.
                        # A rule that became THREAD-grade drops the group's
                        # param slots rather than raising mid-flush.
                        try:
                            g.p_cols = self._bulk_param_cols(pindex, g.resource, g.args_column)
                        except ValueError:
                            g.p_cols = []
                    g.src = cur
            # After the re-resolution: its interning may add param rows.
            self._ensure_capacity()
            for x in (*exits, *bulk_x):
                if x.src_dindex is not None and x.src_dindex is not dindex:
                    x.d_gids = dindex.gids_for(x.resource)
                    x.src_dindex = dindex
        mb = max(self.max_batch, 1)
        n_bulk = sum(g.n for g in bulk_e)
        m_bulk = sum(g.n for g in bulk_x)
        if len(entries) + n_bulk <= mb and len(exits) + m_bulk <= mb:
            # One step: every exit applies before every admission.
            self._run_chunk(entries, exits, bulk_e, bulk_x, findex, dindex, pindex, auth_rules)
            return entries
        # Oversized backlog: singles chunks, then packed bulk chunks (exits
        # in a later chunk are not visible to earlier chunks' admissions).
        for off in range(0, max(len(entries), len(exits)), mb):
            self._run_chunk(entries[off : off + mb], exits[off : off + mb], [], [], findex, dindex, pindex,
                            auth_rules)
        be_chunks, bx_chunks = _pack(bulk_e, mb), _pack(bulk_x, mb)
        for i in range(max(len(be_chunks), len(bx_chunks))):
            self._run_chunk(
                [], [],
                be_chunks[i] if i < len(be_chunks) else [],
                bx_chunks[i] if i < len(bx_chunks) else [],
                findex, dindex, pindex, auth_rules,
            )
        return entries

    def _encode(self, entries, exits, bulk, bulk_exits, now: int) -> Tuple[FlushBatch, int, int]:
        """Host encode of one chunk into pow2-padded numpy columns, moved
        to the device in one copy per column."""
        # Powers of two: shard-divisible on a mesh once at least n_shards.
        n = max(_pad_pow2(len(entries) + sum(g.n for g in bulk), 8), self._n_shards)
        m = max(_pad_pow2(len(exits) + sum(g.n for g in bulk_exits), 8), self._n_shards)
        k = _pad_pow2(
            max(1, max((len(op.slots) for op in entries), default=1),
                max((len(g.slots) for g in bulk), default=1)),
            1,
        )
        kd = _pad_pow2(
            max(1, *(len(x.d_gids) for grp in (entries, exits, bulk, bulk_exits) for x in grp)),
            1,
        )
        e_valid = np.zeros(n, dtype=bool)
        e_ts = np.zeros(n, dtype=np.int32)
        e_acquire = np.ones(n, dtype=np.int32)
        e_rows = np.full((n, 4), -1, dtype=np.int32)
        e_gid = np.full((n, k), -1, dtype=np.int32)
        e_crow = np.full((n, k), -1, dtype=np.int32)
        e_prio = np.zeros(n, dtype=bool)
        e_auth = np.ones(n, dtype=bool)
        e_dgid = np.full((n, kd), -1, dtype=np.int32)
        e_cluster = np.ones(n, dtype=bool)  # False where the token server said BLOCKED
        ne = len(entries)
        if ne:
            e_valid[:ne] = True
            e_cluster[:ne] = [op.cluster_blocked_rule is None for op in entries]
            e_ts[:ne] = [op.ts for op in entries]
            e_acquire[:ne] = [op.acquire for op in entries]
            e_rows[:ne] = [op.rows for op in entries]
            e_prio[:ne] = [op.prio for op in entries]
            e_auth[:ne] = [op.auth_ok for op in entries]
            for i, op in enumerate(entries):
                for j, (gid, crow) in enumerate(op.slots[:k]):
                    e_gid[i, j] = gid
                    e_crow[i, j] = crow
                for j, dg in enumerate(op.d_gids[:kd]):
                    e_dgid[i, j] = dg
        off = ne
        for g in bulk:
            sl = slice(off, off + g.n)
            e_valid[sl] = True
            e_ts[sl] = g.ts
            e_acquire[sl] = g.acquire
            e_rows[sl] = g.rows
            e_auth[sl] = g.auth_ok
            for j, (gid, crow) in enumerate(g.slots[:k]):
                e_gid[sl, j] = gid
                e_crow[sl, j] = crow
            for j, dg in enumerate(g.d_gids[:kd]):
                e_dgid[sl, j] = dg
            off += g.n

        x_valid = np.zeros(m, dtype=bool)
        x_ts = np.zeros(m, dtype=np.int32)
        x_count = np.zeros(m, dtype=np.int32)
        x_rows = np.full((m, 4), -1, dtype=np.int32)
        x_rt = np.zeros(m, dtype=np.int32)
        x_err = np.zeros(m, dtype=np.int32)
        x_thr = np.zeros(m, dtype=np.int32)
        x_dgid = np.full((m, kd), -1, dtype=np.int32)
        nx = len(exits)
        if nx:
            x_valid[:nx] = True
            x_ts[:nx] = [x.ts for x in exits]
            x_count[:nx] = [x.count for x in exits]
            x_rows[:nx] = [x.rows for x in exits]
            x_rt[:nx] = [x.rt for x in exits]
            x_err[:nx] = [x.err for x in exits]
            x_thr[:nx] = [x.thr for x in exits]
            for i, x in enumerate(exits):
                for j, dg in enumerate(x.d_gids[:kd]):
                    x_dgid[i, j] = dg
        off = nx
        for gx in bulk_exits:
            sl = slice(off, off + gx.n)
            x_valid[sl] = True
            x_ts[sl] = gx.ts
            x_count[sl] = gx.count
            x_rows[sl] = gx.rows
            x_rt[sl] = gx.rt
            x_err[sl] = gx.err
            x_thr[sl] = gx.thr
            for j, dg in enumerate(gx.d_gids[:kd]):
                x_dgid[sl, j] = dg
            off += gx.n
        # Window buckets are (ts // wlen) % B: timestamps must be >= 0.
        if (e_valid & (e_ts < 0)).any() or (x_valid & (x_ts < 0)).any():
            raise ValueError("op timestamps must be >= 0 (ms relative to the clock epoch)")

        dev = self.device

        def t(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(dev, non_blocking=False)

        batch = FlushBatch(
            now=int(now),
            e_valid=t(e_valid), e_ts=t(e_ts), e_acquire=t(e_acquire), e_rows=t(e_rows),
            e_rule_gid=t(e_gid), e_check_row=t(e_crow),
            e_prio=t(e_prio), e_auth_ok=t(e_auth), e_cluster_ok=t(e_cluster), e_dgid=t(e_dgid),
            x_valid=t(x_valid), x_ts=t(x_ts), x_count=t(x_count), x_rows=t(x_rows), x_rt=t(x_rt),
            x_err=t(x_err), x_thr=t(x_thr), x_dgid=t(x_dgid),
        )
        return batch, k, kd

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, non_blocking=False)

    def _encode_shaping(self, entries, bulk, k: int, findex: FlowIndex) -> Tuple[Optional[ShapingBatch], int]:
        """The (entry, slot) pairs governed by shaping controllers, as the
        compact batch the K9 recurrence takes, and the host-known mode
        (:meth:`_shaping_rounds_for`). (None, 1) without shaping slots."""
        sg = findex.shaping_gids
        if not sg:
            return None, 1
        items = [
            (i * k + j, gid, crow, i, op.ts, op.acquire)
            for i, op in enumerate(entries)
            for j, (gid, crow) in enumerate(op.slots[:k])
            if gid in sg
        ]
        cols: List[Tuple[np.ndarray, ...]] = []
        if items:
            arr = np.asarray(items, dtype=np.int32)
            cols.append(tuple(arr[:, c] for c in range(6)))
        off = len(entries)
        for g in bulk:
            for j, (gid, crow) in enumerate(g.slots[:k]):
                if gid in sg:
                    ei = np.arange(off, off + g.n, dtype=np.int32)
                    cols.append((ei * k + j, np.full(g.n, gid, np.int32), np.full(g.n, crow, np.int32), ei,
                                 g.ts, g.acquire))
            off += g.n
        if not cols:
            return None, 1
        flat_pos, gid, row, eidx, ts, acquire = (np.concatenate([c[a] for c in cols]) for a in range(6))
        total = flat_pos.shape[0]
        pad = _pad_pow2(total, 8) - total

        def padded(a, fill=0):
            return np.pad(a, (0, pad), constant_values=fill) if pad else a

        t = self._tensor
        batch = ShapingBatch(
            valid=t(padded(np.ones(total, dtype=bool))), gid=t(padded(gid)), row=t(padded(row)),
            eidx=t(padded(eidx)), flat_pos=t(padded(flat_pos)), ts=t(padded(ts)), acquire=t(padded(acquire, 1)),
        )
        return batch, self._shaping_rounds_for(gid, ts, acquire, findex)

    @staticmethod
    def _shaping_rounds_for(gid, ts, acquire, findex: FlowIndex) -> int:
        """-1 (the closed-form pacer path) when every item is a plain
        RATE_LIMITER at one ts with one acquire >= 1; otherwise the pow2
        rounds bound (0 = every item)."""
        if (
            gid.shape[0] > 0
            and ts.min() == ts.max()
            and acquire.min() == acquire.max()
            and acquire.min() >= 1
            and all(
                (r := findex.rule_of_gid(int(g))) is not None
                and r.control_behavior == C.CONTROL_BEHAVIOR_RATE_LIMITER
                for g in np.unique(gid)
            )
        ):
            return -1
        return _rounds_bucket(gid)

    def _encode_param(self, entries, exits, pindex: ParamIndex, bulk=()) -> Tuple[Optional[ParamBatch], int]:
        """The hot-param slots of the chunk (singles' p_slots, then bulk
        groups' p_cols as column blocks), the exits' thread rows, the rows
        recycled by LRU eviction, and the host-known mode
        (:meth:`_param_rounds_for`). (None, 1) when there is none of it."""
        items = [(i, op.ts, op.acquire, ps) for i, op in enumerate(entries) for ps in op.p_slots]
        bulk_cols = []
        n_bulk_items = 0
        off_b = len(entries)
        for g in bulk:
            for pc in g.p_cols:
                cnt = int(pc.valid.sum())
                if cnt:
                    bulk_cols.append((off_b, g, pc, cnt))
                    n_bulk_items += cnt
            off_b += g.n
        exit_rows = [r for op in exits for r in op.p_rows]
        resets = pindex.take_resets()
        if not items and not n_bulk_items and not exit_rows and not resets:
            return None, 1
        n_items = len(items) + n_bulk_items
        s = _pad_pow2(max(1, n_items), 8)
        sx = _pad_pow2(max(1, len(exit_rows)), 8)
        q = _pad_pow2(max(1, len(resets)), 8)
        valid = np.zeros(s, dtype=bool)
        prow, eidx, ts = (np.zeros(s, dtype=np.int32) for _ in range(3))
        acquire = np.ones(s, dtype=np.int32)
        grade, behavior, token_count, burst = (np.zeros(s, dtype=np.int32) for _ in range(4))
        duration_ms = np.ones(s, dtype=np.int32)
        maxq, cost_ms = (np.zeros(s, dtype=np.int32) for _ in range(2))
        for a, (i, t0, acq, ps) in enumerate(items):
            valid[a] = True
            prow[a], eidx[a], ts[a], acquire[a] = ps.prow, i, t0, acq
            grade[a], behavior[a], token_count[a], burst[a] = ps.grade, ps.behavior, ps.token_count, ps.burst
            duration_ms[a], maxq[a], cost_ms[a] = ps.duration_ms, ps.maxq, ps.cost_ms
        a = len(items)
        for off, g, pc, cnt in bulk_cols:
            sl = slice(a, a + cnt)
            m = pc.valid
            r = pc.rule
            valid[sl] = True
            prow[sl] = pc.prow[m]
            eidx[sl] = off + np.nonzero(m)[0].astype(np.int32)
            ts[sl] = g.ts[m]
            acquire[sl] = g.acquire[m]
            grade[sl] = r.grade
            behavior[sl] = r.control_behavior
            token_count[sl] = pc.token_count[m]
            burst[sl] = int(r.burst_count)
            duration_ms[sl] = int(r.duration_in_sec) * 1000  # the kernel clamps to >= 1
            maxq[sl] = int(r.max_queueing_time_ms)
            cost_ms[sl] = pc.cost_ms[m]
            a += cnt
        xr = np.full(sx, -1, dtype=np.int32)
        xr[: len(exit_rows)] = exit_rows
        rs = np.full(q, -1, dtype=np.int32)
        rs[: len(resets)] = resets
        t = self._tensor
        pb = ParamBatch(
            valid=t(valid), prow=t(prow), eidx=t(eidx), ts=t(ts), acquire=t(acquire), grade=t(grade),
            behavior=t(behavior), token_count=t(token_count), burst=t(burst), duration_ms=t(duration_ms),
            maxq=t(maxq), cost_ms=t(cost_ms), reset_rows=t(rs), exit_rows=t(xr),
        )
        rounds = self._param_rounds_for(prow[:n_items], grade[:n_items], behavior[:n_items], ts[:n_items],
                                        acquire[:n_items])
        if n_items and self.param_force_path == "scan" and rounds <= -1:
            rounds = _rounds_bucket(prow[:n_items])
        return pb, rounds

    @staticmethod
    def _param_rounds_for(prow, grade, behavior, ts, acquire) -> int:
        """A negative mode selects the closed-form rank path (every item
        QPS-grade DEFAULT with one acquire >= 1): -1 for one timestamp, -S
        for at most S (pow2, <= PARAM_CLOSED_MAX_SEGMENTS) distinct
        timestamps per value row. Otherwise the pow2 rounds bound (0 =
        every item)."""
        n = prow.shape[0]
        if (
            n > 0
            and (grade == C.FLOW_GRADE_QPS).all()
            and (behavior == C.CONTROL_BEHAVIOR_DEFAULT).all()
            and acquire.min() == acquire.max()
            and acquire.min() >= 1  # acquire 0 admits unconditionally in the recurrence
        ):
            if ts.min() == ts.max():
                return -1
            key = (prow.astype(np.int64) << 32) | (ts.astype(np.int64) & 0xFFFFFFFF)
            pairs = np.unique(key)
            segs = int(np.unique(pairs >> 32, return_counts=True)[1].max())
            if segs <= PARAM_CLOSED_MAX_SEGMENTS:
                return -(1 << (segs - 1).bit_length()) if segs > 1 else -1
        return _rounds_bucket(prow)

    def _run_chunk(self, entries, exits, bulk, bulk_exits, findex: FlowIndex, dindex: DegradeIndex,
                   pindex: ParamIndex, auth_rules: Dict[str, AuthorityRule]) -> None:
        """Encode one chunk, run the flush step, fill verdicts. Runs under
        the flush lock only."""
        now = self.clock.now_ms()
        batch, k, kd = self._encode(entries, exits, bulk, bulk_exits, now)
        shaping, sh_rounds = self._encode_shaping(entries, bulk, k, findex)
        param, p_rounds = self._encode_param(entries, exits, pindex, bulk)
        # The sketch tier: this chunk's aggregated key ids and the
        # once-per-window halving; the fold (K11) runs inside the step.
        tier = self.sketch
        sk_batch = None
        sk_decay = False
        if tier.armed and self.mesh is None:  # the fold stays off on the mesh, as in the JAX engine
            sk_ids, sk_w = tier.encode_chunk(entries, bulk, findex, pindex)
            sk_decay = tier.decay_due(now)
            sk_batch = SketchBatch(ids=self._tensor(sk_ids), w=self._tensor(sk_w))
        load, cpu = system_sampler.read() if self.system_config is not None else (-1.0, -1.0)
        sysdev = make_system_device(self.system_config, load, cpu)
        with_occupy = any(op.prio for op in entries)
        sweep = self._sharded_fns is not None or self._slab_horizon is not None
        timeout = config.occupy_timeout_ms
        if self._sharded_fns is not None:
            # Mesh mode: one global batch sharded over the shards; the
            # shaping and param items (global positions) go to the global
            # scans. A failure propagates: no single-shard retry. The
            # sharded step sweeps the slab on every step.
            fn = self._sharded_fn_for(shaping is not None, param is not None, sh_rounds, p_rounds)
            timeout = fn.occupy_timeout_ms  # read when the step was built
            extra = tuple(b for b in (shaping, param) if b is not None)
            self.stats, self.flow_dyn, self.degrade_dyn, self.param_dyn, result = fn(
                self.stats, findex.device, self.flow_dyn, dindex.device, self.degrade_dyn, self.param_dyn, sysdev,
                batch, *extra,
            )
        else:
            self.stats, result = flush_step(
                self.stats, findex.device, batch,
                with_exits=bool(exits) or bool(bulk_exits),
                blk_topk=min(self._blk_topk_k, self.stats.n_rows),
                ddev=dindex.device, ddyn=self.degrade_dyn, sysdev=sysdev,
                occupy_timeout_ms=timeout,
                # Host-known stage specializations, as the JAX engine sets
                # them; the sweep only while the slab may hold a borrow.
                with_occupy=with_occupy, with_matured=sweep,
                with_system=self.system_config is not None,
                with_degrade=bool(dindex.rules),
                flow_dyn=self.flow_dyn, pdyn=self.param_dyn, shaping=shaping, param=param,
                shaping_rounds=sh_rounds, param_rounds=p_rounds,
                skstate=tier.dev_state if sk_batch is not None else None, sk=sk_batch, sketch_decay=sk_decay,
            )
        self._note_borrows(now, with_occupy, sweep, timeout)
        # One device→host copy of the verdicts; the sketch's candidate
        # table rides along.
        got = [result.admitted, result.reason, result.slot_ok, result.wait_ms, result.sys_type, result.dslot_ok]
        if result.blk_rows is not None:
            got += [result.blk_rows, result.blk_weight]
        if sk_batch is not None:
            got += [tier.dev_state.cand_ids, tier.dev_state.cand_cnt]
        got = [x.cpu().numpy() for x in got]
        if sk_batch is not None:
            # The promotion/demotion controller evaluates at every drain.
            tier.on_drain(got[-2], got[-1], self.clock.now_ms())
            got = got[:-2]
        self._fill_results(got, entries, bulk, findex, dindex, auth_rules, k, kd)

    def _note_borrows(self, now: int, with_occupy: bool, swept: bool, occupy_timeout_ms: int) -> None:
        """The slab horizon after a flush at ``now``. A sweep at or past the
        horizon matured every borrow (and, before ``now - empty_ws`` wraps,
        reset every cell to (empty_ws, 0)); a flush with prioritized entries
        may then have committed borrows up to :func:`borrow_horizon`. Only
        such a flush writes the slab (K5 runs under ``with_occupy``), make
        and growth add empty cells, and a rebase shifts the horizon with the
        slab. A path that replaces the stats wholesale sets the horizon from
        ``int(stats.future_ws.max())``."""
        h = self._slab_horizon
        if swept and h is not None and h <= now <= 2**31 - 1 + SECOND_CFG.empty_ws:
            h = None
        if with_occupy:
            t = borrow_horizon(now, occupy_timeout_ms)
            if t is not None:
                h = t if h is None else max(h, t)
        self._slab_horizon = h

    def _fill_results(self, got, entries, bulk, findex: FlowIndex, dindex: DegradeIndex,
                      auth_rules: Dict[str, AuthorityRule], k: int, kd: int) -> None:
        admitted, reason, slot_ok, wait_ms, sys_type, dslot_ok = got[:6]
        if len(got) > 6:
            self.last_blocked_topk = (got[6], got[7])
        for i, op in enumerate(entries):
            blocked_rule = None
            limit_type = ""
            r = int(reason[i])
            if not admitted[i]:
                if r == E.BLOCK_AUTHORITY:
                    blocked_rule = auth_rules.get(op.resource)
                elif r == E.BLOCK_SYSTEM:
                    limit_type = SYS_TYPE_NAMES.get(int(sys_type[i]), "")
                elif r == E.BLOCK_FLOW:
                    if op.cluster_blocked_rule is not None:
                        blocked_rule = op.cluster_blocked_rule
                        if isinstance(blocked_rule, ParamFlowRule):
                            # A token-server param verdict surfaces as a
                            # param block (ParamFlowChecker's cluster branch).
                            r = E.BLOCK_PARAM
                    else:
                        blocked_rule = _first_failing(op.slots[:k], slot_ok[i], findex)
                elif r == E.BLOCK_PARAM:
                    # The entry's first param rule, as the JAX engine names it.
                    blocked_rule = op.p_slots[0].rule if op.p_slots else None
                elif r == E.BLOCK_DEGRADE:
                    blocked_rule = _first_failing(op.d_gids[:kd], dslot_ok[i], dindex)
            op.verdict = Verdict(
                admitted=bool(admitted[i]),
                reason=r,
                wait_ms=int(wait_ms[i]),
                blocked_rule=blocked_rule,
                limit_type=limit_type,
            )
        off = len(entries)
        for g in bulk:
            sl = slice(off, off + g.n)
            g.admitted = np.array(admitted[sl])
            g.reason = np.array(reason[sl], dtype=np.int32)
            g.wait_ms = np.array(wait_ms[sl])
            off += g.n

    # ------------------------------------------------------------------
    # reads (command/metric plane)
    # ------------------------------------------------------------------
    def rows_stats(self, rows: Sequence[int], now: Optional[int] = None) -> Dict[int, Dict[str, float]]:
        """Stats dicts for many rows: one launch reads every asked row's
        windows, gauge and slab (``nodes.rows_stats``), one copy brings the
        records back. A row outside the stats raises IndexError."""
        rows = list(rows)
        if not rows:
            return {}
        now_i = self.clock.now_ms() if now is None else int(now)
        with self._flush_lock:
            s = self.stats
            for r in rows:
                if not 0 <= r < s.n_rows:
                    raise IndexError(f"row {r} is outside the {s.n_rows} stats rows")
            idx = torch.tensor(rows, dtype=torch.int32, device=self.device)
            records = _read_rows(s, idx, now_i).cpu().tolist()  # Python ints: cheap dict arithmetic
        return {
            r: _stats_dict(x[RS_SECOND], x[RS_MINUTE], x[RS_MIN_RT], x[RS_THREADS], x[RS_OCCUPIED], x[RS_WAITING])
            for r, x in zip(rows, records)
        }

    def _row_stats(self, row: int, now: Optional[int] = None) -> Dict[str, float]:
        return self.rows_stats([row], now)[row]

    def cluster_node_stats(self, resource: str, flush: bool = True) -> Optional[Dict[str, float]]:
        if flush:
            self.flush()
        row = self.nodes.lookup_cluster_row(resource)
        if row is None:
            return None
        return self._row_stats(row)

    def entry_node_stats(self, flush: bool = True) -> Dict[str, float]:
        if flush:
            self.flush()
        return self._row_stats(self.nodes.entry_node_row)

    def close(self) -> None:
        """Decide anything still queued."""
        self.flush()


def _release_blocked_tokens(entries: Sequence[_EntryOp]) -> None:
    """Entries that held a cluster concurrency token but were blocked (by
    another rule) hand it back at once, outside the flush lock (the
    reference's releaseConcurrentToken on abort)."""
    for op in entries:
        if op.cluster_tokens and op.verdict is not None and not op.verdict.admitted:
            release_cluster_tokens(op.cluster_tokens)
            op.cluster_tokens = []


def _token_decided(rule, decided: frozenset) -> bool:
    """Is ``rule`` a cluster-mode rule whose flow id the token server
    already decided for this op?"""
    return (
        rule is not None
        and rule.cluster_mode
        and rule.cluster_config is not None
        and rule.cluster_config.flow_id in decided
    )


def _first_failing(ids, ok_row, index):
    """The rule of the first failing slot (flow slots are (gid, row)
    pairs, breaker slots plain ids), or None."""
    for j, slot in enumerate(ids):
        if not ok_row[j]:
            return index.rule_of_gid(slot[0] if isinstance(slot, tuple) else slot)
    return None


def _pack(groups, mb: int):
    """Greedy-pack bulk groups into chunks of at most ``mb`` rows."""
    chunks, cur, cur_n = [], [], 0
    for g in groups:
        if cur and cur_n + g.n > mb:
            chunks.append(cur)
            cur, cur_n = [], 0
        cur.append(g)
        cur_n += g.n
    if cur:
        chunks.append(cur)
    return chunks


def _stats_dict(sec, minute, min_rt: int, threads: int, occ_cur: int, waiting: int) -> Dict[str, float]:
    """The JAX engine's stats dict (StatisticNode's readers)."""
    interval_sec = SECOND_CFG.interval_ms / 1000.0
    success = int(sec[MetricEvent.SUCCESS])
    rt_sum = int(sec[MetricEvent.RT])
    return {
        "pass_qps": (int(sec[MetricEvent.PASS]) + occ_cur) / interval_sec,
        "waiting": waiting,
        "block_qps": sec[MetricEvent.BLOCK] / interval_sec,
        "success_qps": success / interval_sec,
        "exception_qps": sec[MetricEvent.EXCEPTION] / interval_sec,
        "occupied_pass_qps": minute[MetricEvent.OCCUPIED_PASS] / (MINUTE_CFG.interval_ms / 1000.0),
        "avg_rt": (rt_sum / success) if success > 0 else 0.0,
        "min_rt": min_rt,
        "cur_thread_num": threads,
        "total_pass_minute": int(minute[MetricEvent.PASS]),
        "total_block_minute": int(minute[MetricEvent.BLOCK]),
        "total_success_minute": int(minute[MetricEvent.SUCCESS]),
        "total_exception_minute": int(minute[MetricEvent.EXCEPTION]),
    }
