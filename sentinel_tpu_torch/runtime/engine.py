"""The batched engine on the main path (port of
``sentinel_tpu/runtime/engine.py``).

It plays the role of the reference's ``CtSph`` + slot chain + node map
(CtSph.java:43-233): it owns the statistics tensors on its device, the
compiled flow rule table, the host node registry and the pending-op
buffers. ``submit_*`` calls enqueue ops; ``flush()`` encodes them into
padded arrays and runs one flush step (runtime/flush.py) for the whole
batch. ``entry_sync`` is submit + flush: the synchronous ``SphU.entry``.

This slice ports the DEFAULT flow path at pipeline depth 0: flow rules
with the DEFAULT controller, entries, bulk entries, exits and traces.
Everything else the JAX engine does is refused loudly with
``NotImplementedError`` naming its ROADMAP item (see
``_refuse_unported_config`` and the ``set_*`` methods), never ignored.

Locking as in the JAX engine: ``_lock`` guards the pending buffers and
host indexes briefly; ``_flush_lock`` serializes flushes and owns the
device state during a flush (lock order: ``_flush_lock`` → ``_lock``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core import errors as E
from sentinel_tpu_torch.metrics import metric_array as ma
from sentinel_tpu_torch.metrics.events import MetricEvent
from sentinel_tpu_torch.metrics.nodes import (
    MINUTE_CFG,
    SECOND_CFG,
    NodeRegistry,
    StatsState,
    grow_stats,
    make_stats,
    slab_fold_host,
)
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.models.rules import FlowRule
from sentinel_tpu_torch.rules.flow_table import FlowIndex, FlowRuleDynState
from sentinel_tpu_torch.runtime.flush import TOPK_MAX, FlushBatch, flush_step
from sentinel_tpu_torch.utils.clock import Clock, SystemClock, default_clock
from sentinel_tpu_torch.utils.config import config
from sentinel_tpu_torch.utils.device import DeviceLike, resolve_device
from sentinel_tpu_torch.utils.numeric import pad_pow2 as _pad_pow2

# ROADMAP items (Queue 1) that own what this slice refuses.
_ROADMAP_PIPELINE = "ROADMAP Queue 1 item 1 (depth-K flush pipeline and flush_async)"
_ROADMAP_OCCUPY = "ROADMAP Queue 1 item 2 (occupy, system, authority)"
_ROADMAP_BREAKERS = "ROADMAP Queue 1 item 3 (circuit breakers)"
_ROADMAP_SHAPING = "ROADMAP Queue 1 item 4 (traffic shaping)"
_ROADMAP_PARAM = "ROADMAP Queue 1 item 5 (hot parameters)"
_ROADMAP_SKETCH = "ROADMAP Queue 1 item 6 (sketch tier)"
_ROADMAP_TIERS = "ROADMAP Queue 1 item 7 (engine tiers)"
_ROADMAP_METRICS = "ROADMAP Queue 1 item 8 (metrics and observability)"
_ROADMAP_CLUSTER = "ROADMAP Queue 1 item 9 (cluster token plane)"
_ROADMAP_IPC = "ROADMAP Queue 1 item 10 (IPC plane)"
_ROADMAP_MESH = "ROADMAP Queue 1 item 12 (multi-GPU)"

# Switches the JAX engine honours that this slice does not have yet.
_UNPORTED_SWITCHES = (
    (config.SKETCH_ENABLED, _ROADMAP_SKETCH),
    (config.SPECULATIVE_ENABLED, _ROADMAP_TIERS),
    (config.FAILOVER_ENABLED, _ROADMAP_TIERS),
    (config.CAPTURE_ENABLED, _ROADMAP_TIERS),
    (config.AUTOTUNE_ENABLED, _ROADMAP_TIERS),
    (config.IPC_ENABLED, _ROADMAP_IPC),
)


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"sentinel_tpu_torch: {what} is not ported yet ({item})")


def _refuse_unported_config() -> None:
    for key, item in _UNPORTED_SWITCHES:
        if config.get_bool(key, False):
            raise _unported(f"{key}=true", item)
    if config.get_int(config.PIPELINE_DEPTH, 0) > 0:
        raise _unported(f"{config.PIPELINE_DEPTH} > 0", _ROADMAP_PIPELINE)


class Verdict(NamedTuple):
    admitted: bool
    reason: int  # errors.PASS / BLOCK_*
    wait_ms: int
    blocked_rule: Optional[object]  # the rule bean that blocked, if attributable


@dataclass(slots=True)
class _EntryOp:
    resource: str
    ts: int
    acquire: int
    rows: Tuple[int, int, int, int]  # default, cluster, origin|-1, entry|-1
    slots: List[Tuple[int, int]]  # (rule_gid, check_row)
    context_name: str = C.CONTEXT_DEFAULT_NAME
    origin: str = ""
    src: Optional[FlowIndex] = None  # the index the slots were resolved against
    verdict: Optional[Verdict] = None


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
    context_name: str
    origin: str
    src: Optional[FlowIndex] = None
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


@dataclass(slots=True)
class _ExitOp:
    ts: int
    rows: Tuple[int, int, int, int]
    count: int = 0  # success delta
    rt: int = 0
    err: int = 0  # exception delta
    thr: int = 0  # thread delta (-1 exits, 0 traces)


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
        self.flow_index = FlowIndex([], cold_factor=config.cold_factor, device=self.device)
        self.flow_dyn: FlowRuleDynState = self.flow_index.make_dyn_state()
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

    @staticmethod
    def _blocked_topk_k() -> int:
        if not config.get_bool(config.TELEMETRY_ENABLED, True):
            return 0
        k = config.get_int(config.TELEMETRY_BLOCKED_TOPK_K, -1)
        if k < 0:
            k = config.get_int(config.TELEMETRY_SKETCH_K, 8)
        if k > TOPK_MAX:
            raise _unported(f"a blocked top-K above {TOPK_MAX} (k={k})", _ROADMAP_METRICS)
        return max(0, k)

    # ------------------------------------------------------------------
    # what this slice refuses
    # ------------------------------------------------------------------
    def enable_mesh(self, n_devices: Optional[int] = None) -> None:
        raise _unported("enable_mesh", _ROADMAP_MESH)

    def flush_async(self):
        raise _unported("flush_async", _ROADMAP_PIPELINE)

    def set_degrade_rules(self, rules) -> None:
        if rules:
            raise _unported("degrade rules", _ROADMAP_BREAKERS)

    def set_param_rules(self, by_resource) -> None:
        if by_resource:
            raise _unported("hot-parameter rules", _ROADMAP_PARAM)

    def set_system_config(self, cfg) -> None:
        if cfg is not None:
            raise _unported("system rules", _ROADMAP_OCCUPY)

    def set_authority_rules(self, by_resource) -> None:
        if by_resource:
            raise _unported("authority rules", _ROADMAP_OCCUPY)

    # ------------------------------------------------------------------
    # rule plumbing (called by the rule manager)
    # ------------------------------------------------------------------
    def set_flow_rules(self, rules: Sequence[FlowRule]) -> None:
        findex = FlowIndex(rules, cold_factor=config.cold_factor, device=self.device)
        for cr in findex.rules:
            if cr.rule.control_behavior != C.CONTROL_BEHAVIOR_DEFAULT:
                raise _unported(
                    f"flow rule controlBehavior={cr.rule.control_behavior}", _ROADMAP_SHAPING
                )
            if cr.rule.cluster_mode:
                raise _unported("cluster-mode flow rules", _ROADMAP_CLUSTER)
        with self._flush_lock:
            self._flush_locked()  # pending ops are decided under the old rules
            with self._lock:
                self.flow_index = findex
                self.flow_dyn = findex.make_dyn_state()

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
        ``args`` feed hot-parameter rules, which this slice refuses to
        load, so they are not kept."""
        if prio:
            raise _unported("prioritized (prio=True) entries", _ROADMAP_OCCUPY)
        with self._lock:
            rows = self.resolve_entry_rows(resource, context_name, origin, entry_type)
            if rows is None:
                return None
            findex = self.flow_index
            op = _EntryOp(
                resource=resource,
                ts=self.clock.now_ms() if ts is None else int(ts),
                acquire=int(acquire),
                rows=rows,
                slots=findex.resolve_slots(resource, context_name, origin, self.nodes),
                context_name=context_name,
                origin=origin,
                src=findex,
            )
            self._entries.append(op)
            over = len(self._entries) >= self.max_batch
        if over:
            self.flush()  # flush-on-size: the pending buffer is bounded
        return op

    def submit_exit(
        self,
        rows: Tuple[int, int, int, int],
        rt: int,
        count: int = 1,
        err: int = 0,
        ts: Optional[int] = None,
        resource: Optional[str] = None,
    ) -> None:
        """StatisticSlot.exit: success + RT + thread release (+exception).
        ``resource`` routes completions to circuit breakers, which this
        slice does not have; it is accepted for the API's sake."""
        op = _ExitOp(
            ts=self.clock.now_ms() if ts is None else int(ts),
            rows=rows,
            count=int(count),
            rt=min(int(rt), config.statistic_max_rt),
            err=int(err),
            thr=-1,
        )
        with self._lock:
            self._exits.append(op)
            over = len(self._exits) >= self.max_batch
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
        pass-through, like :meth:`submit_entry`."""
        if args_column is not None:
            raise _unported("hot-parameter args columns", _ROADMAP_PARAM)
        if n < 1:
            raise ValueError("submit_bulk: n must be >= 1")
        if n > self.max_batch:
            raise ValueError(f"submit_bulk: n={n} exceeds max_batch={self.max_batch}; split the group")
        with self._lock:
            rows = self.resolve_entry_rows(resource, context_name, origin, entry_type)
            if rows is None:
                return None
            findex = self.flow_index
            g = BulkOp(
                resource=resource,
                n=n,
                ts=self._bulk_col(ts, n, self.clock.now_ms()),
                acquire=self._bulk_col(acquire, n, 1),
                rows=rows,
                slots=findex.resolve_slots(resource, context_name, origin, self.nodes),
                context_name=context_name,
                origin=origin,
                src=findex,
            )
            self._bulk_entries.append(g)
            self._bulk_pending_n += n
            over = len(self._entries) + self._bulk_pending_n >= self.max_batch
        if over:
            self.flush()
        return g

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
        """Columnar exits: ``n`` completions on one node-row set."""
        if n < 1:
            raise ValueError("submit_exit_bulk: n must be >= 1")
        if n > self.max_batch:
            raise ValueError(f"submit_exit_bulk: n={n} exceeds max_batch={self.max_batch}; split the group")
        with self._lock:
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
        shift(s.second.window_start, SECOND_CFG.empty_ws)
        shift(s.minute.window_start, MINUTE_CFG.empty_ws)
        shift(s.future_ws, SECOND_CFG.empty_ws)
        shift(self.flow_dyn.latest_passed_time, -(10**9))
        shift(self.flow_dyn.last_filled_time, -(10**9))
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

    def flush(self) -> List[_EntryOp]:
        """Encode + run the flush step for all pending ops; fills verdicts
        before it returns (pipeline depth 0)."""
        with self._flush_lock:
            return self._flush_locked()

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
            self._ensure_capacity()
            findex = self.flow_index
            # Ops resolved against a superseded rule table are re-resolved
            # against the one they will be checked with.
            for op in entries:
                if op.src is not findex:
                    op.slots = findex.resolve_slots(op.resource, op.context_name, op.origin, self.nodes)
                    op.src = findex
            for g in bulk_e:
                if g.src is not findex:
                    g.slots = findex.resolve_slots(g.resource, g.context_name, g.origin, self.nodes)
                    g.src = findex
        mb = max(self.max_batch, 1)
        n_bulk = sum(g.n for g in bulk_e)
        m_bulk = sum(g.n for g in bulk_x)
        if len(entries) + n_bulk <= mb and len(exits) + m_bulk <= mb:
            # One step: every exit applies before every admission.
            self._run_chunk(entries, exits, bulk_e, bulk_x, findex)
            return entries
        # Oversized backlog: singles chunks, then packed bulk chunks (exits
        # in a later chunk are not visible to earlier chunks' admissions).
        for off in range(0, max(len(entries), len(exits)), mb):
            self._run_chunk(entries[off : off + mb], exits[off : off + mb], [], [], findex)
        be_chunks, bx_chunks = _pack(bulk_e, mb), _pack(bulk_x, mb)
        for i in range(max(len(be_chunks), len(bx_chunks))):
            self._run_chunk(
                [], [],
                be_chunks[i] if i < len(be_chunks) else [],
                bx_chunks[i] if i < len(bx_chunks) else [],
                findex,
            )
        return entries

    def _encode(self, entries, exits, bulk, bulk_exits, now: int) -> Tuple[FlushBatch, int]:
        """Host encode of one chunk into pow2-padded numpy columns, moved
        to the device in one copy per column."""
        n = _pad_pow2(len(entries) + sum(g.n for g in bulk), 8)
        m = _pad_pow2(len(exits) + sum(g.n for g in bulk_exits), 8)
        k = _pad_pow2(
            max(1, max((len(op.slots) for op in entries), default=1),
                max((len(g.slots) for g in bulk), default=1)),
            1,
        )
        e_valid = np.zeros(n, dtype=bool)
        e_ts = np.zeros(n, dtype=np.int32)
        e_acquire = np.ones(n, dtype=np.int32)
        e_rows = np.full((n, 4), -1, dtype=np.int32)
        e_gid = np.full((n, k), -1, dtype=np.int32)
        e_crow = np.full((n, k), -1, dtype=np.int32)
        ne = len(entries)
        if ne:
            e_valid[:ne] = True
            e_ts[:ne] = [op.ts for op in entries]
            e_acquire[:ne] = [op.acquire for op in entries]
            e_rows[:ne] = [op.rows for op in entries]
            for i, op in enumerate(entries):
                for j, (gid, crow) in enumerate(op.slots[:k]):
                    e_gid[i, j] = gid
                    e_crow[i, j] = crow
        off = ne
        for g in bulk:
            sl = slice(off, off + g.n)
            e_valid[sl] = True
            e_ts[sl] = g.ts
            e_acquire[sl] = g.acquire
            e_rows[sl] = g.rows
            for j, (gid, crow) in enumerate(g.slots[:k]):
                e_gid[sl, j] = gid
                e_crow[sl, j] = crow
            off += g.n

        x_valid = np.zeros(m, dtype=bool)
        x_ts = np.zeros(m, dtype=np.int32)
        x_count = np.zeros(m, dtype=np.int32)
        x_rows = np.full((m, 4), -1, dtype=np.int32)
        x_rt = np.zeros(m, dtype=np.int32)
        x_err = np.zeros(m, dtype=np.int32)
        x_thr = np.zeros(m, dtype=np.int32)
        nx = len(exits)
        if nx:
            x_valid[:nx] = True
            x_ts[:nx] = [x.ts for x in exits]
            x_count[:nx] = [x.count for x in exits]
            x_rows[:nx] = [x.rows for x in exits]
            x_rt[:nx] = [x.rt for x in exits]
            x_err[:nx] = [x.err for x in exits]
            x_thr[:nx] = [x.thr for x in exits]
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
            e_prio=t(np.zeros(n, dtype=bool)), e_auth_ok=t(np.ones(n, dtype=bool)),
            e_cluster_ok=t(np.ones(n, dtype=bool)), e_dgid=t(np.full((n, 1), -1, dtype=np.int32)),
            x_valid=t(x_valid), x_ts=t(x_ts), x_count=t(x_count), x_rows=t(x_rows), x_rt=t(x_rt),
            x_err=t(x_err), x_thr=t(x_thr), x_dgid=t(np.full((m, 1), -1, dtype=np.int32)),
        )
        return batch, k

    def _run_chunk(self, entries, exits, bulk, bulk_exits, findex: FlowIndex) -> None:
        """Encode one chunk, run the flush step, fill verdicts. Runs under
        the flush lock only."""
        now = self.clock.now_ms()
        batch, k = self._encode(entries, exits, bulk, bulk_exits, now)
        self.stats, result = flush_step(
            self.stats, findex.device, batch,
            with_exits=bool(exits) or bool(bulk_exits),
            blk_topk=min(self._blk_topk_k, self.stats.n_rows),
        )
        # One device→host copy of the verdicts.
        got = [result.admitted, result.reason, result.slot_ok, result.wait_ms]
        if result.blk_rows is not None:
            got += [result.blk_rows, result.blk_weight]
        got = [x.cpu().numpy() for x in got]
        self._fill_results(got, entries, bulk, findex, k)

    def _fill_results(self, got, entries, bulk, findex: FlowIndex, k: int) -> None:
        admitted, reason, slot_ok, wait_ms = got[:4]
        if len(got) > 4:
            self.last_blocked_topk = (got[4], got[5])
        for i, op in enumerate(entries):
            blocked_rule = None
            if not admitted[i] and int(reason[i]) == E.BLOCK_FLOW:
                for j, (gid, _) in enumerate(op.slots[:k]):
                    if not slot_ok[i, j]:
                        blocked_rule = findex.rule_of_gid(gid)
                        break
            op.verdict = Verdict(
                admitted=bool(admitted[i]),
                reason=int(reason[i]),
                wait_ms=int(wait_ms[i]),
                blocked_rule=blocked_rule,
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
        """Stats dicts for many rows: the windowed reads run on the
        device for just these rows (K3 with a row gather)."""
        rows = list(rows)
        if not rows:
            return {}
        now_i = self.clock.now_ms() if now is None else int(now)
        with self._flush_lock:
            s = self.stats
            idx = torch.tensor(rows, dtype=torch.int32, device=self.device)
            sec, min_rt = ma.window_reduce(SECOND_CFG, s.second, now_i, rows=idx, with_min=True)
            minute, _ = ma.window_reduce(MINUTE_CFG, s.minute, now_i, rows=idx)
            sec, min_rt, minute = sec.cpu().numpy(), min_rt.cpu().numpy(), minute.cpu().numpy()
            per_row = [
                (
                    int(s.threads[r : r + 1].cpu()[0]),
                    s.future_ws[r].cpu().numpy(),
                    s.future_pass[r].cpu().numpy(),
                )
                for r in rows
            ]
        out = {}
        for i, r in enumerate(rows):
            threads, fws, fpass = per_row[i]
            occ, waiting = slab_fold_host(fws, fpass, now_i)
            out[r] = _stats_dict(sec[i], minute[i], int(min_rt[i]), threads, occ, waiting)
        return out

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
