"""Device-failure domain: health state machine, host-fallback admission,
flush watchdog, checkpoint/restore (port of
``sentinel_tpu/runtime/failover.py``).

Losing the device must degrade admission QUALITY, never availability: the
reference's cluster stance (``cc.fallback_to_local_when_fail``) applied to
the engine's own most critical dependency, the card.

Four pieces:

* a **health state machine** ``HEALTHY -> DEGRADED -> RECOVERING ->
  HEALTHY``: a dispatch fault, a fault of the wait for a flush's copy back
  or a watchdog timeout trips the engine DEGRADED, quarantines the
  in-flight flush queue (every affected op gets a policy verdict instead
  of a re-raised device exception) and routes later flushes to the host
  fallback;
* a **flush watchdog**: with failover armed, the kernel dispatch and the
  wait on the chunk's CUDA event run on a waiter thread bounded by
  ``sentinel.tpu.failover.fetch.timeout.ms``. The waiter enters the
  engine's stream itself (``torch.cuda.stream`` is per thread). A
  timed-out wait is abandoned, not cancelled: the thread stays parked on
  the event until the card gets there, and the restore generation token
  turns a late completion into a no-op;
* a :class:`HostFallbackAdmitter` serving admission while DEGRADED from
  the rule tables already compiled: host token buckets for QPS flow
  rules, live concurrency counters for THREAD rules, the engine's breaker
  host mirror for degrade rules, per-value token buckets for QPS hot-param
  rules, under a per-resource fail-open/fail-closed policy
  (``sentinel.tpu.failover.policy``). Degraded verdicts carry their
  provenance (``Verdict.degraded``; reason ``BLOCK_FAILOVER`` for policy
  sheds);
* **checkpoint/restore**: every N flushes
  (``sentinel.tpu.failover.checkpoint.every``) each state tensor gets one
  non-blocking copy on the engine stream into fresh pinned host buffers,
  queued before the chunk's event, so the one wait of the copy back also
  covers them (the kernels update state in place: stream order is what
  makes the copy the post-flush state). RECOVERING restores the last
  checkpoint into fresh device tensors (a copy, never an alias: the
  checkpoint stays intact for the next restore), re-based through the
  engine's timestamp shift when the clock epoch moved, and requires K
  consecutive probe flushes (``sentinel.tpu.failover.probe.flushes``)
  that launch the flush's kernels and wait for their copy back.

A kernel build or load error (``utils/cuda_build.KernelBuildError``, or an
error of the Triton compiler) is a defect of the program, not a device
fault: it is raised to the caller and never trips DEGRADED. The JAX
package trips on any dispatch exception; ROADMAP Queue 3 records the
difference.

Everything is deterministic under ``testing/faults.FaultInjector``.

The health transitions, degraded verdicts and probe flushes are noted on
the telemetry bus, and each transition on the capture journal's timeline
(one into DEGRADED freezes its recent segments); the degraded fill writes
the admission trace's records, the per-resource ledger's degraded column
and the block log's rows. The degraded fill runs the custom processor
slots of a chunk that has not run them (core/slots.py).
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core import errors as E
from sentinel_tpu_torch.metrics import nodes as _ncfg
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.utils.config import config
from sentinel_tpu_torch.utils.cuda_build import KernelBuildError
from sentinel_tpu_torch.utils.record_log import record_log

HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
RECOVERING = "RECOVERING"
# The states as the Prometheus gauge sentinel_engine_health exports them.
HEALTH_GAUGE = {HEALTHY: 0, DEGRADED: 1, RECOVERING: 2}

# The components of a checkpoint, in the order of their leaves in a durable
# file (the JAX package's order).
COMPONENTS = ("stats", "flow", "degrade", "param", "sketch")


def parse_policy(raw: str) -> Tuple[str, Dict[str, str]]:
    """``"open"`` / ``"closed"`` / ``"open,resA=closed,resB=open"``: the
    first segment without ``=`` is the default; unknown modes fall back to
    open (a config typo never becomes an outage)."""
    default = "open"
    by_res: Dict[str, str] = {}
    for seg in str(raw).split(","):
        seg = seg.strip()
        if not seg:
            continue
        if "=" in seg:
            res, _, mode = seg.partition("=")
            by_res[res.strip()] = "closed" if mode.strip().lower() == "closed" else "open"
        else:
            default = "closed" if seg.lower() == "closed" else "open"
    return default, by_res


def is_build_error(exc: BaseException) -> bool:
    """A kernel that did not build or load: a defect of the program,
    raised to the caller rather than read as a device fault."""
    return isinstance(exc, KernelBuildError) or type(exc).__module__.startswith("triton")


def tree_leaves(tree) -> List[np.ndarray]:
    """The arrays of a (nested) NamedTuple state in field order: the leaf
    order of ``jax.tree_util.tree_leaves`` on the JAX package's states."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        out: List[np.ndarray] = []
        for v in tree:
            out.extend(tree_leaves(v))
        return out
    return [tree]


def tree_unflatten(ref, leaves: Sequence[np.ndarray]):
    """``leaves`` laid out as the (nested) NamedTuple ``ref``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, tuple):
            vals = [build(v) for v in node]
            return type(node)(*vals) if hasattr(node, "_fields") else tuple(vals)
        return next(it)

    return build(ref)


def _dead_ref():
    """A weakref whose referent is gone: marks a checkpoint component as
    not restorable (the durable loader's analog of an index swap)."""

    class _T:
        pass

    o = _T()
    r = weakref.ref(o)
    del o
    return r


class DeviceFetchTimeout(RuntimeError):
    """The flush watchdog's verdict: a dispatch or the wait for a flush's
    copy back exceeded ``sentinel.tpu.failover.fetch.timeout.ms``."""


@dataclass(slots=True)
class HealthEvent:
    """One state transition, for the health snapshot."""

    now_ms: int
    frm: str
    to: str
    reason: str

    def as_dict(self) -> dict:
        return {"now_ms": self.now_ms, "from": self.frm, "to": self.to, "reason": self.reason}


@dataclass(slots=True)
class Checkpoint:
    """One host-resident snapshot of the engine's device states.

    ``states`` is ``(stats, flow_dyn, degrade_dyn, param_dyn, sketch)``,
    each a NamedTuple of numpy arrays laid out as the port's state (and as
    ``jax.device_get`` of the JAX package's); ``sketch`` is None when the
    tier is disarmed. On the card the arrays are views of pinned buffers
    that the copy back filled; nothing else writes them. The index
    weakrefs gate which components are still restorable: a rule reload
    swaps an index and its dyn state's shape, so a stale component
    restores as a fresh dyn state."""

    seq: int
    now_ms: int
    epoch_wall_ms: int
    win_key: object  # SECOND_CFG at capture
    findex_ref: object
    dindex_ref: object
    pindex_ref: object
    states: Optional[tuple] = None  # filled when the copy back lands
    # ParamIndex.values_snapshot() when the states land (durable spills
    # only): the value -> row maps that give the param rows their meaning.
    param_values: Optional[dict] = None


class _TokenBucket:
    """Host token bucket approximating one QPS window: capacity =
    threshold per window, continuous refill at threshold/window. Starts
    full: degrade entry grants one window's burst, as a restarted
    reference node does."""

    __slots__ = ("cap", "rate_ms", "tokens", "last_ms")

    def __init__(self, cap: float, window_ms: float, now_ms: int) -> None:
        self.cap = float(cap)
        self.rate_ms = self.cap / max(window_ms, 1.0)
        self.tokens = self.cap
        self.last_ms = now_ms

    def _refill(self, now_ms: int) -> None:
        if now_ms > self.last_ms:
            self.tokens = min(self.cap, self.tokens + (now_ms - self.last_ms) * self.rate_ms)
            self.last_ms = now_ms

    def try_take(self, now_ms: int, n: float) -> bool:
        self._refill(now_ms)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def available(self, now_ms: int) -> float:
        self._refill(now_ms)
        return self.tokens

    def consume(self, n: float) -> None:
        self.tokens = max(0.0, self.tokens - n)


class _HostShaping:
    """Host mirror of one shaping rule's controller state (the record
    ``rules/shaping.mirror_shaping_decide`` evolves) plus pass counters
    approximating the check node's windowed pass: ``passq(ts)`` is a
    rolling window at the SECOND_CFG bucket width, ``pass_prev`` the
    aligned previous-1s bucket. Reconciliation adopts the settled device
    columns at every drain."""

    __slots__ = ("rule", "info", "latest", "stored", "lastfill", "win", "pass_sec", "pass_cur", "pass_prev")

    def __init__(self, rule, info) -> None:
        self.rule = rule
        self.info = info  # FlowIndex.mirror_shaping_info tuple
        # The inits of FlowIndex.make_dyn_state: "infinitely past".
        self.latest = -(10**9)
        self.stored = 0.0
        self.lastfill = -(10**9)
        self.win: "deque[list]" = deque()  # [bucket_ws, count] rolling
        self.pass_sec: Optional[int] = None
        self.pass_cur = 0
        self.pass_prev = 0

    def roll_pass(self, ts: int) -> None:
        sec = ts - ts % 1000
        if self.pass_sec is None:
            self.pass_sec = sec
            return
        if sec > self.pass_sec:
            self.pass_prev = self.pass_cur if sec - self.pass_sec == 1000 else 0
            self.pass_cur = 0
            self.pass_sec = sec

    def note_pass(self, ts: int, n: int) -> None:
        self.roll_pass(ts)
        self.pass_cur += n
        # The rolling window feeds only the warm-up line's passQps; a pacer
        # never reads it, so it never grows for one.
        if self.info[1] == C.CONTROL_BEHAVIOR_RATE_LIMITER:
            return
        self._trim_win(ts)
        wlen = _ncfg.SECOND_CFG.window_len_ms
        ws = ts - ts % wlen
        if self.win and self.win[-1][0] == ws:
            self.win[-1][1] += n
        else:
            self.win.append([ws, n])

    def _trim_win(self, ts: int) -> None:
        interval = _ncfg.SECOND_CFG.interval_ms
        while self.win and ts - self.win[0][0] > interval:
            self.win.popleft()

    def passq(self, ts: int) -> int:
        self._trim_win(ts)
        return sum(c for _ws, c in self.win)


class _HostSystem:
    """Host mirror of the global system-protection inputs: a token bucket
    for the global inbound QPS threshold, a live inbound concurrency
    counter, and per-second success/RT windows for the avg-RT and BBR
    checks. Load and CPU read the same ``utils/system_status.sampler`` the
    device path samples."""

    __slots__ = ("bucket", "qps_cap", "threads", "sec", "succ_cur", "succ_prev", "rt_cur", "rt_prev",
                 "minrt_cur", "minrt_prev")

    def __init__(self) -> None:
        self.bucket: Optional[_TokenBucket] = None
        self.qps_cap = -1.0
        self.threads = 0
        self.sec: Optional[int] = None
        self.succ_cur = 0
        self.succ_prev = 0
        self.rt_cur = 0
        self.rt_prev = 0
        self.minrt_cur = _ncfg.SECOND_CFG.max_rt
        self.minrt_prev = _ncfg.SECOND_CFG.max_rt

    def roll(self, now_ms: int) -> None:
        sec = now_ms - now_ms % 1000
        if self.sec is None:
            self.sec = sec
            return
        if sec > self.sec:
            gap1 = sec - self.sec == 1000
            self.succ_prev = self.succ_cur if gap1 else 0
            self.rt_prev = self.rt_cur if gap1 else 0
            self.minrt_prev = self.minrt_cur if gap1 else _ncfg.SECOND_CFG.max_rt
            self.succ_cur = 0
            self.rt_cur = 0
            self.minrt_cur = _ncfg.SECOND_CFG.max_rt
            self.sec = sec

    def note_complete(self, now_ms: int, rt: int, count: int, min_rt: Optional[int] = None) -> None:
        """``rt`` is the group's RT sum, ``min_rt`` its per-exit minimum (a
        bulk group's sum must not pose as one sample)."""
        self.roll(now_ms)
        self.succ_cur += count
        self.rt_cur += rt
        sample = rt if min_rt is None else min_rt
        if count > 0 and sample < self.minrt_cur:
            self.minrt_cur = sample

    def release(self, n: int) -> None:
        self.threads = max(0, self.threads - n)


class HostFallbackAdmitter:
    """Serves admission from host state while the engine is DEGRADED.

    Stage order follows the device path's attribution order (authority ->
    system -> param -> flow -> degrade); an op blocked by an earlier stage
    consumes no later stage's tokens.

    Two lifecycles: non-``persistent``, all state is scoped to one degraded
    window (``begin()`` resets it). ``persistent`` (the speculative tier's
    mirror, runtime/speculative.py) runs continuously under HEALTHY and is
    reconciled against the device at every drain; ``begin()`` keeps it (a
    device trip is a zero-transition event) and only resets the
    degraded-window delta ledgers. The gauge-delta ledgers track only ops
    the device never saw, so recording is gated on ``_track_deltas``: true
    exactly between a trip and a successful recovery."""

    def __init__(self, engine, persistent: bool = False) -> None:
        self._engine = engine
        self.persistent = persistent
        self._track_deltas = not persistent
        self._lock = threading.Lock()
        # id(rule) -> (rule, bucket): the rule ref pins the object so a
        # freed rule's id is never reused under the same key.
        self._buckets: Dict[int, Tuple[object, _TokenBucket]] = {}
        # prow -> (rule, bucket) for QPS hot-param values.
        self._pbuckets: Dict[int, Tuple[object, _TokenBucket]] = {}
        # resource -> live concurrency this mirror admitted.
        self._threads: Dict[str, int] = {}
        # gid -> shaping-controller mirror; _shaping_src pins the FlowIndex
        # the gids belong to.
        self.shaping_enabled = config.get_bool(config.SPECULATIVE_SHAPING, True)
        self._shaping: Dict[int, _HostShaping] = {}
        self._shaping_src: Optional[object] = None
        self._sys: Optional[_HostSystem] = None
        # Device-gauge deltas while DEGRADED, node row -> count: releases
        # the device never saw (_exit_rows) and THREAD admissions the
        # fallback made (_admit_rows). Recovery applies the net per row.
        self._exit_rows: Dict[int, int] = {}
        self._exit_prows: Dict[int, int] = {}
        self._admit_rows: Dict[int, int] = {}
        self._admit_prows: Dict[int, int] = {}
        self._policy_default = "open"
        self._policy_by_resource: Dict[str, str] = {}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def begin(self, now_ms: int) -> None:
        """Enter a degraded window: fresh buckets and counters (unless
        persistent), fresh delta ledgers, the policy re-read."""
        with self._lock:
            if not self.persistent:
                self._buckets.clear()
                self._pbuckets.clear()
                self._threads.clear()
                self._shaping.clear()
                self._sys = None
            self._exit_rows.clear()
            self._exit_prows.clear()
            self._admit_rows.clear()
            self._admit_prows.clear()
            self._track_deltas = True
            self._parse_policy(config.get(config.FAILOVER_POLICY) or "open")

    def end_degraded(self) -> None:
        """Recovery succeeded: a persistent mirror stops delta tracking."""
        with self._lock:
            if self.persistent:
                self._track_deltas = False

    def assert_live(self, resource: str, n: int) -> None:
        """A reconnecting ipc worker's re-assertion (ipc/plane.py): charge
        ``n`` live admissions to the mirror's THREAD counter. A restarted
        engine's mirror starts empty; the workers' re-asserted live sets
        make the fast tier's concurrency headroom exact in the new world,
        and their exits release through the normal on_exit path."""
        if n <= 0:
            return
        with self._lock:
            self._threads[resource] = self._threads.get(resource, 0) + n

    def reset_world(self) -> None:
        """Fresh mirror world: buckets, counters and ledgers cleared."""
        with self._lock:
            self._buckets.clear()
            self._pbuckets.clear()
            self._threads.clear()
            self._shaping.clear()
            self._sys = None
            self._exit_rows.clear()
            self._exit_prows.clear()
            self._admit_rows.clear()
            self._admit_prows.clear()
            self._track_deltas = not self.persistent

    def _parse_policy(self, raw: str) -> None:
        self._policy_default, self._policy_by_resource = parse_policy(raw)

    def policy_for(self, resource: str) -> str:
        with self._lock:
            return self._policy_by_resource.get(resource, self._policy_default)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _bucket_for(self, rule, now_ms: int, cap: Optional[float] = None, window_ms: float = 1000.0) -> _TokenBucket:
        key = id(rule)
        ent = self._buckets.get(key)
        if ent is None or ent[0] is not rule:
            ent = (rule, _TokenBucket(float(rule.count) if cap is None else cap, window_ms, now_ms))
            self._buckets[key] = ent
        return ent[1]

    def _pbucket_for(self, ps, now_ms: int) -> _TokenBucket:
        ent = self._pbuckets.get(ps.prow)
        if ent is None:
            cap, window = ps.mirror_bucket()
            ent = (ps.rule, _TokenBucket(cap, window, now_ms))
            self._pbuckets[ps.prow] = ent
        return ent[1]

    def _shaping_for(self, findex, gid: int) -> Optional[_HostShaping]:
        """The shaping mirror of one gid; the caller holds ``self._lock``.
        Keyed per FlowIndex: the table resets on first touch after a swap."""
        if self._shaping_src is not findex:
            self._shaping.clear()
            self._shaping_src = findex
        st = self._shaping.get(gid)
        if st is None:
            info = findex.mirror_shaping_info(gid)
            if info is None:
                return None
            st = self._shaping[gid] = _HostShaping(info[0], info)
        return st

    def _shaping_admit_locked(self, findex, op) -> Tuple[bool, int, object]:
        """Decide the op's shaping slots on the host mirror: ``(ok,
        wait_ms, blocking_rule)``. Every slot's state advances, as the
        kernel's would."""
        from sentinel_tpu_torch.rules.shaping import mirror_shaping_decide

        sg = findex.shaping_gids
        ok_all, wait_all, bad_rule = True, 0, None
        for gid, _crow in op.slots:
            if gid not in sg:
                continue
            st = self._shaping_for(findex, gid)
            if st is None:
                continue
            st.roll_pass(op.ts)
            ok, wait = mirror_shaping_decide(st, st.info, op.ts, op.acquire)
            if not ok and ok_all:
                ok_all, bad_rule = False, st.rule
            if wait > wait_all:
                wait_all = wait
        return ok_all, wait_all, bad_rule

    def _shaping_note_pass_locked(self, findex, op) -> None:
        sg = findex.shaping_gids
        for gid, _crow in op.slots:
            if gid in sg:
                st = self._shaping.get(gid)
                if st is not None:
                    st.note_pass(op.ts, op.acquire)

    def reconcile_shaping(self, findex, latest, stored, lastfill) -> None:
        """Adopt the settled device shaping columns at a drain:
        ``latestPassedTime`` only advances (the mirror may be ahead by its
        in-flight grants); the warm-up pair is adopted whenever the
        device's sync is at least as recent. A reconcile against a
        superseded index is a no-op."""
        with self._lock:
            if self._shaping_src is not findex:
                return
            n = latest.shape[0]
            for gid, st in self._shaping.items():
                if gid >= n:
                    continue
                dl = int(latest[gid])
                if dl > st.latest:
                    st.latest = dl
                df = int(lastfill[gid])
                if df >= st.lastfill:
                    st.lastfill = df
                    st.stored = float(stored[gid])

    def _sys_state_locked(self, cfg, now_ms: int) -> _HostSystem:
        s = self._sys
        if s is None:
            s = self._sys = _HostSystem()
        if cfg.qps >= 0 and (s.bucket is None or s.qps_cap != cfg.qps):
            # qps is a per-second rate on both planes.
            s.bucket = _TokenBucket(float(cfg.qps), 1000.0, now_ms)
            s.qps_cap = cfg.qps
        return s

    def _sys_check_locked(self, s: _HostSystem, cfg, now_ms: int, acquire: int) -> Optional[str]:
        """First violated system dimension or None, in checkSystem's order.
        Nothing is consumed here: the charge lands on the final admit."""
        if cfg.qps >= 0 and s.bucket is not None:
            if s.bucket.available(now_ms) < acquire:
                return "qps"
        if cfg.max_thread >= 0 and s.threads > cfg.max_thread:
            return "thread"
        s.roll(now_ms)
        return self._sys_check_scalar_locked(s, cfg)

    def _sys_check_scalar_locked(self, s: _HostSystem, cfg) -> Optional[str]:
        from sentinel_tpu_torch.utils.system_status import sampler

        if cfg.max_rt >= 0:
            succ = s.succ_cur + s.succ_prev
            if succ > 0 and (s.rt_cur + s.rt_prev) / succ > cfg.max_rt:
                return "rt"
        cur_load, cur_cpu = sampler.read()
        if cfg.highest_system_load >= 0 and cur_load > cfg.highest_system_load:
            # checkBbr: under high load, block unless curThread <=
            # maxSuccessQps * minRt / 1000 (or <= 1).
            max_sq = float(max(s.succ_cur, s.succ_prev))
            min_rt = float(min(s.minrt_cur, s.minrt_prev))
            if s.threads > 1 and s.threads > max_sq * min_rt / 1000.0:
                return "load"
        if cfg.highest_cpu_usage >= 0 and cur_cpu > cfg.highest_cpu_usage:
            return "cpu"
        return None

    def drain_sys_bucket(self) -> bool:
        """Settlement saw a system-QPS over-admit: empty the gate's bucket."""
        with self._lock:
            s = self._sys
            if s is not None and s.bucket is not None:
                s.bucket.consume(s.bucket.tokens)
                return True
        return False

    def _breaker_open(self, d_gids: Sequence[int]) -> bool:
        """Last-known breaker verdict from the engine's host mirror; an
        invalid mirror fails open."""
        if not d_gids:
            return False
        from sentinel_tpu_torch.rules.degrade_table import mirror_any_open

        eng = self._engine
        with eng._breaker_mirror_lock:
            if not eng._breaker_mirror_valid:
                return False
            return mirror_any_open(eng._breaker_state_host, d_gids)

    @staticmethod
    def _rule_of(src_index, gid: int):
        try:
            return src_index.rule_of_gid(gid)
        except Exception:
            return None

    # ------------------------------------------------------------------
    # single-op admission
    # ------------------------------------------------------------------
    def admit(self, op, now_ms: int, apply_policy: bool = True, degraded: bool = True, speculative: bool = False):
        """Host verdict for one op; never raises. The degraded fill marks
        ``degraded``; the speculative tier marks ``speculative`` (and
        ``degraded`` only while the engine is). The fail-open/closed policy
        is a DEGRADED concept: the healthy tier passes
        ``apply_policy=False``. A custom slot's veto blocks before the
        authority check, with the device fill's attribution."""
        from sentinel_tpu_torch.runtime.engine import Verdict

        def blocked(reason, rule=None, limit_type="", slot_name=""):
            return Verdict(admitted=False, reason=reason, wait_ms=0, blocked_rule=rule, limit_type=limit_type,
                           slot_name=slot_name, degraded=degraded, speculative=speculative)

        if apply_policy and self.policy_for(op.resource) == "closed":
            return blocked(E.BLOCK_FAILOVER)
        if op.custom_veto is not None:
            slot, veto = op.custom_veto
            return blocked(E.BLOCK_CUSTOM, veto if veto is not True else None,
                           slot_name=getattr(slot, "name", "") or type(slot).__name__)
        if not op.auth_ok:
            return blocked(E.BLOCK_AUTHORITY, self._engine.authority_rules.get(op.resource))
        if op.cluster_blocked_rule is not None:
            # The token server's verdict predates the fault and stays binding.
            rule = op.cluster_blocked_rule
            reason = E.BLOCK_PARAM if type(rule).__name__ == "ParamFlowRule" else E.BLOCK_FLOW
            return blocked(reason, rule)
        findex = op.src[0] if op.src is not None else self._engine.flow_index
        sys_cfg = self._engine.system_config
        is_in = op.rows is not None and op.rows[3] >= 0
        with self._lock:
            sys_state = None
            if sys_cfg is not None and is_in:
                sys_state = self._sys_state_locked(sys_cfg, now_ms)
                dim = self._sys_check_locked(sys_state, sys_cfg, now_ms, op.acquire)
                if dim is not None:
                    return blocked(E.BLOCK_SYSTEM, limit_type=dim)
            thr_prows = []
            for ps in op.p_slots:
                if ps.grade != C.FLOW_GRADE_QPS:
                    # THREAD-grade param gauges pass, but the row joins the
                    # recovery seed like _admit_rows.
                    if ps.prow >= 0:
                        thr_prows.append(ps.prow)
                    continue
                if ps.rule is None:
                    continue
                if not self._pbucket_for(ps, now_ms).try_take(now_ms, op.acquire):
                    return blocked(E.BLOCK_PARAM, ps.rule)
            # Shaping controllers before the plain buckets: a shaping block
            # consumes no bucket tokens.
            sg = findex.shaping_gids
            has_shaping = bool(sg) and any(g in sg for g, _ in op.slots)
            wait_ms = 0
            if has_shaping and self.shaping_enabled:
                sh_ok, wait_ms, sh_rule = self._shaping_admit_locked(findex, op)
                if not sh_ok:
                    return blocked(E.BLOCK_FLOW, sh_rule)
            thread_rules = []
            for gid, _crow in op.slots:
                if sg and gid in sg and self.shaping_enabled:
                    continue  # decided by the shaping mirror above
                info = findex.mirror_info(gid)
                if info is None:
                    continue
                rule, grade, cap, window_ms = info
                if grade == C.FLOW_GRADE_THREAD:
                    thread_rules.append(rule)
                    cur = self._threads.get(op.resource, 0)
                    if cur + 1 > int(cap):
                        return blocked(E.BLOCK_FLOW, rule)
                else:
                    if not self._bucket_for(rule, now_ms, cap, window_ms).try_take(now_ms, op.acquire):
                        return blocked(E.BLOCK_FLOW, rule)
            if self._breaker_open(op.d_gids):
                dindex = op.src[1] if op.src is not None else self._engine.degrade_index
                rule = self._rule_of(dindex, op.d_gids[0]) if op.d_gids else None
                return blocked(E.BLOCK_DEGRADE, rule)
            if thread_rules:
                self._threads[op.resource] = self._threads.get(op.resource, 0) + 1
                # Speculative ops record at fill time (note_unsettled_admit),
                # never here: recording at both points double-counts.
                if self._track_deltas and not speculative:
                    for r in op.rows:
                        if r >= 0:
                            self._admit_rows[r] = self._admit_rows.get(r, 0) + 1
            if self._track_deltas and not speculative:
                for r in thr_prows:
                    self._admit_prows[r] = self._admit_prows.get(r, 0) + 1
            if sys_state is not None:
                if sys_state.bucket is not None:
                    sys_state.bucket.consume(op.acquire)
                sys_state.threads += 1
            if has_shaping and self.shaping_enabled:
                self._shaping_note_pass_locked(findex, op)
        return Verdict(admitted=True, reason=E.PASS, wait_ms=wait_ms, blocked_rule=None, degraded=degraded,
                       speculative=speculative)

    # ------------------------------------------------------------------
    # bulk admission (vectorized)
    # ------------------------------------------------------------------
    def bulk_shaping_servable(self, g, findex) -> bool:
        """The bulk closed-form preconditions (Engine._shaping_rounds_for's
        -1 path): every shaping slot a plain RATE_LIMITER, one ts, one
        acquire >= 1."""
        sg = findex.shaping_gids
        if not sg or not any(gid in sg for gid, _crow in g.slots):
            return True
        ts = np.asarray(g.ts)
        acq = np.asarray(g.acquire)
        if ts.size and int(ts.min()) != int(ts.max()):
            return False
        if acq.size and (int(acq.min()) != int(acq.max()) or int(acq.min()) < 1):
            return False
        for gid, _crow in g.slots:
            if gid in sg:
                info = findex.mirror_shaping_info(gid)
                if info is None or info[1] != C.CONTROL_BEHAVIOR_RATE_LIMITER:
                    return False
        return True

    def admit_bulk(self, g, now_ms: int, apply_policy: bool = True, speculative: bool = False,
                   shaping_servable: Optional[bool] = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Array verdicts ``(admitted, reason, wait_ms)`` for one bulk group:
        numpy prefix math against the buckets and counters the singles path
        consumes. Shaping slots run the closed-form host pacer when
        :meth:`bulk_shaping_servable` holds, else the plain-bucket stance."""
        n = g.n
        admitted = np.ones(n, dtype=bool)
        reason = np.full(n, E.PASS, dtype=np.int32)
        wait = np.zeros(n, dtype=np.int32)

        def block(mask: np.ndarray, code: int) -> None:
            sel = admitted & mask
            admitted[sel] = False
            reason[sel] = code

        if apply_policy and self.policy_for(g.resource) == "closed":
            block(np.ones(n, dtype=bool), E.BLOCK_FAILOVER)
            return admitted, reason, wait
        if g.custom_veto_mask is not None:
            block(np.asarray(g.custom_veto_mask, dtype=bool), E.BLOCK_CUSTOM)
        if not g.auth_ok:
            block(np.ones(n, dtype=bool), E.BLOCK_AUTHORITY)
        findex = g.src[0] if g.src is not None else self._engine.flow_index
        acquire = np.asarray(g.acquire, dtype=np.int64)
        sys_cfg = self._engine.system_config
        is_in = g.rows is not None and g.rows[3] >= 0
        with self._lock:
            sys_state = None
            if sys_cfg is not None and is_in:
                sys_state = self._sys_state_locked(sys_cfg, now_ms)
                if sys_cfg.qps >= 0 and sys_state.bucket is not None:
                    avail = sys_state.bucket.available(now_ms)
                    cum = np.cumsum(np.where(admitted, acquire, 0))
                    block(cum > avail, E.BLOCK_SYSTEM)
                if sys_cfg.max_thread >= 0:
                    adm_i = admitted.astype(np.int64)
                    excl = np.cumsum(adm_i) - adm_i
                    block(excl + sys_state.threads > sys_cfg.max_thread, E.BLOCK_SYSTEM)
                sys_state.roll(now_ms)
                dim = self._sys_check_scalar_locked(sys_state, sys_cfg)
                if dim is not None:
                    block(np.ones(n, dtype=bool), E.BLOCK_SYSTEM)
            sg = findex.shaping_gids
            shaped_gids = [gid for gid, _crow in g.slots if gid in sg] if sg else []
            shaping_as_bucket = False
            if shaped_gids:
                if shaping_servable is None:
                    shaping_servable = self.bulk_shaping_servable(g, findex)
                if self.shaping_enabled and shaping_servable:
                    from sentinel_tpu_torch.rules.shaping import mirror_pacer_bulk, mirror_pacer_cost

                    ts0 = int(np.asarray(g.ts)[0]) if n else now_ms
                    acq0 = int(acquire[0]) if n else 1
                    for gid in shaped_gids:
                        st = self._shaping_for(findex, gid)
                        if st is None:
                            continue
                        count, maxq = st.info[2], st.info[3]
                        cost = mirror_pacer_cost(acq0, count, st.info[4])
                        # Ranks over still-admitted rows, as the kernel's
                        # shaping_live gating.
                        ranks = np.cumsum(admitted.astype(np.int64))
                        ok, w, latest = mirror_pacer_bulk(st.latest, count, maxq, cost, ts0, ranks)
                        st.latest = latest
                        np.maximum(wait, np.where(admitted & ok, w, 0).astype(np.int32), out=wait)
                        block(~ok, E.BLOCK_FLOW)
                else:
                    shaping_as_bucket = True
            thread_rule = None
            for gid, _crow in g.slots:
                if shaped_gids and gid in shaped_gids and not shaping_as_bucket:
                    continue  # decided by the closed-form pacer above
                info = findex.mirror_info(gid)
                if info is None:
                    continue
                rule, grade, cap, window_ms = info
                if grade == C.FLOW_GRADE_THREAD:
                    thread_rule = rule
                    cur = self._threads.get(g.resource, 0)
                    headroom = max(0, int(cap) - cur)
                    live_rank = np.cumsum(admitted)
                    block(live_rank > headroom, E.BLOCK_FLOW)
                else:
                    bucket = self._bucket_for(rule, now_ms, cap, window_ms)
                    avail = bucket.available(now_ms)
                    cum = np.cumsum(np.where(admitted, acquire, 0))
                    block(cum > avail, E.BLOCK_FLOW)
                    bucket.consume(int(np.where(admitted, acquire, 0).sum()))
            if self._breaker_open(g.d_gids):
                block(np.ones(n, dtype=bool), E.BLOCK_DEGRADE)
            n_adm = int(admitted.sum())
            if thread_rule is not None:
                self._threads[g.resource] = self._threads.get(g.resource, 0) + n_adm
                if self._track_deltas and not speculative:
                    for r in g.rows:
                        if r >= 0:
                            self._admit_rows[r] = self._admit_rows.get(r, 0) + n_adm
            if sys_state is not None and n_adm:
                if sys_state.bucket is not None:
                    sys_state.bucket.consume(int(np.where(admitted, acquire, 0).sum()))
                sys_state.threads += n_adm
        return admitted, reason, wait

    def on_exit(self, resource: str, n: int = 1, rows=None, rt: int = 0, count: int = 0,
                now_ms: Optional[int] = None, min_rt: Optional[int] = None) -> None:
        """Thread release for exits while DEGRADED (and, on a persistent
        mirror, at submit_exit). Clamped at zero. An inbound entry's exit
        also releases the system gate and lands its RT sample."""
        with self._lock:
            cur = self._threads.get(resource)
            if cur is not None:
                self._threads[resource] = max(0, cur - n)
            s = self._sys
            if s is not None and rows is not None and len(rows) > 3 and rows[3] is not None and rows[3] >= 0:
                s.release(n)
                if count > 0 and now_ms is not None:
                    s.note_complete(now_ms, rt, count, min_rt=min_rt)

    def note_device_exit(self, rows, p_rows=(), n: int = 1) -> None:
        """Record the device-gauge releases one degraded exit would have
        scattered: recovery replays them into the restored gauges."""
        with self._lock:
            for r in rows:
                if r is not None and r >= 0:
                    self._exit_rows[r] = self._exit_rows.get(r, 0) + n
            for r in p_rows:
                if r >= 0:
                    self._exit_prows[r] = self._exit_prows.get(r, 0) + n

    def note_unsettled_admit(self, op) -> None:
        """A speculative admit whose chunk the device never applied: record
        its THREAD-gauge deltas for the restore replay, without admitting
        again."""
        if not self._track_deltas:
            return
        findex = op.src[0] if op.src is not None else self._engine.flow_index
        thread = any(
            (info := findex.mirror_info(gid)) is not None and info[1] == C.FLOW_GRADE_THREAD
            for gid, _crow in op.slots
        )
        with self._lock:
            if not self._track_deltas:
                return
            if thread:
                for r in op.rows:
                    if r >= 0:
                        self._admit_rows[r] = self._admit_rows.get(r, 0) + 1
            for ps in op.p_slots:
                if ps.grade != C.FLOW_GRADE_QPS and ps.prow >= 0:
                    self._admit_prows[ps.prow] = self._admit_prows.get(ps.prow, 0) + 1

    def note_unsettled_admit_bulk(self, g, n_adm: int) -> None:
        if not self._track_deltas or n_adm <= 0:
            return
        findex = g.src[0] if g.src is not None else self._engine.flow_index
        if any(
            (info := findex.mirror_info(gid)) is not None and info[1] == C.FLOW_GRADE_THREAD
            for gid, _crow in g.slots
        ):
            self.note_unsettled_admit_rows(g.rows, n_adm)

    def note_unsettled_admit_rows(self, rows, n: int = 1) -> None:
        """Raw-row form, for the tier's +thread gauge-compensation ops
        caught in a degraded window."""
        if not self._track_deltas:
            return
        with self._lock:
            for r in rows:
                if r is not None and r >= 0:
                    self._admit_rows[r] = self._admit_rows.get(r, 0) + n

    # ------------------------------------------------------------------
    # reconciliation clamps (speculative tier)
    # ------------------------------------------------------------------
    def drain_bucket(self, rule) -> bool:
        """Settlement said this rule's mirror was too generous: empty it."""
        with self._lock:
            ent = self._buckets.get(id(rule))
            if ent is not None and ent[0] is rule:
                b = ent[1]
                b.consume(b.tokens)
                return True
        return False

    def drain_pbucket(self, prow: int) -> bool:
        with self._lock:
            ent = self._pbuckets.get(prow)
            if ent is not None:
                b = ent[1]
                b.consume(b.tokens)
                return True
        return False

    def invalidate_rule_mirrors(self) -> None:
        """A rule reload swapped the indexes: retire every rule-keyed
        mirror. Live THREAD counters persist like the device's gauge."""
        with self._lock:
            self._buckets.clear()
            self._pbuckets.clear()
            self._shaping.clear()
            self._shaping_src = None

    def peek_gauge_deltas(self) -> Tuple[Dict[int, int], Dict[int, int], Dict[int, int], Dict[int, int]]:
        """Non-destructive ``(exit_rows, exit_prows, admit_rows,
        admit_prows)``: a restore that later fails its probes keeps them."""
        with self._lock:
            return dict(self._exit_rows), dict(self._exit_prows), dict(self._admit_rows), dict(self._admit_prows)

    def clear_gauge_deltas(self) -> None:
        with self._lock:
            self._exit_rows.clear()
            self._exit_prows.clear()
            self._admit_rows.clear()
            self._admit_prows.clear()

    def snapshot(self) -> dict:
        with self._lock:
            s = self._sys
            return {
                "policy_default": self._policy_default,
                "policy_overrides": dict(self._policy_by_resource),
                "qps_buckets": len(self._buckets),
                "param_buckets": len(self._pbuckets),
                "live_threads": dict(self._threads),
                "shaping_enabled": self.shaping_enabled,
                "shaping_mirrors": len(self._shaping),
                "system_gate": (
                    None if s is None
                    else {"threads": s.threads,
                          "qps_tokens": round(s.bucket.tokens, 2) if s.bucket is not None else None}
                ),
            }


class _Waiter:
    """One persistent watchdog waiter thread: the engine submits a device
    call to it and waits with a timeout, so a wedged wait strands this
    thread, never the submitter. A timed-out waiter is marked lost and
    abandoned. One waiter serves one call at a time."""

    __slots__ = ("lost", "_jobs", "_thread")

    def __init__(self, name: str) -> None:
        import queue

        self.lost = False
        self._jobs: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            fn, box, done = job
            try:
                box["v"] = fn()
            except BaseException as exc:
                box["e"] = exc
            finally:
                done.set()
            if self.lost:
                # Abandoned, but the call did finish: exit instead of
                # parking on a queue no one feeds.
                return

    def submit(self, fn) -> Tuple[dict, threading.Event]:
        box: dict = {}
        done = threading.Event()
        self._jobs.put((fn, box, done))
        return box, done

    def stop(self) -> None:
        self._jobs.put(None)


class FailoverManager:
    """Engine-scoped failure-domain coordinator (one per Engine).

    Disarmed (``sentinel.tpu.failover.enabled`` false, the default), every
    engine hook is one attribute read and device errors re-raise to
    callers."""

    # A dispatch includes a kernel's first build and load on the card,
    # which takes seconds: the dispatch bound has this floor.
    DISPATCH_TIMEOUT_FLOOR_MS = 60_000

    def __init__(self, engine) -> None:
        self._engine = engine
        self.armed = config.get_bool(config.FAILOVER_ENABLED, False)
        self.fetch_timeout_ms = config.get_int(config.FAILOVER_FETCH_TIMEOUT_MS, 5000)
        self.checkpoint_every = max(0, config.get_int(config.FAILOVER_CHECKPOINT_EVERY, 8))
        self.probe_k = max(1, config.get_int(config.FAILOVER_PROBE_FLUSHES, 3))
        self.retry_ms = max(0, config.get_int(config.FAILOVER_RETRY_MS, 1000))
        self._lock = threading.RLock()
        self.state = HEALTHY
        self.state_since_ms = 0
        self._last_attempt_ms: Optional[int] = None
        self._ckpt: Optional[Checkpoint] = None
        self.fallback = HostFallbackAdmitter(engine)
        self.counters: Dict[str, int] = {
            "trips": 0,
            "transitions": 0,
            "quarantined_records": 0,
            "degraded_admits": 0,
            "degraded_blocks": 0,
            "checkpoints": 0,
            "restores": 0,
            "probe_flushes": 0,
            "fetch_timeouts": 0,
            "recoveries": 0,
            "durable_writes": 0,
            "durable_write_errors": 0,
            "durable_loads": 0,
            "durable_load_cold": 0,
        }
        # Durable spill (sentinel.tpu.failover.checkpoint.path): unset, no
        # writer thread and no file IO. Serialization runs on a writer
        # thread: store_checkpoint runs on the drain path.
        self.durable_path = (config.get(config.FAILOVER_CKPT_PATH) or "").strip()
        self.durable_interval_ms = max(0, config.get_int(config.FAILOVER_CKPT_INTERVAL_MS, 1000))
        self._durable_pending: Optional[Checkpoint] = None
        self._ckpt_force = False
        self._durable_event = threading.Event()
        self._durable_stop = False
        self._durable_thread: Optional[threading.Thread] = None
        # (wall_ms, seq, write_ms, bytes) of the last successful spill.
        self.last_durable: Optional[Tuple[int, int, float, int]] = None
        self.events: "deque[HealthEvent]" = deque(maxlen=64)
        self.last_fault = ""
        # Idle watchdog waiters: each watched call takes its own, so one
        # call's queueing never counts against another's timeout.
        self._idle_waiters: List[_Waiter] = []
        self._waiter_lock = threading.Lock()
        # Bumped per restore attempt (and again when one times out): an
        # abandoned restore installs only while it holds the current one.
        self._restore_gen = 0

    # ------------------------------------------------------------------
    # state machine
    # ------------------------------------------------------------------
    @property
    def healthy(self) -> bool:
        return self.state == HEALTHY

    @property
    def degraded(self) -> bool:
        return self.state == DEGRADED

    def _set_state_locked(self, to: str, reason: str) -> None:
        frm = self.state
        if frm == to:
            return
        now = self._engine.clock.now_ms()
        self.state = to
        self.state_since_ms = now
        self.counters["transitions"] += 1
        self.events.append(HealthEvent(now, frm, to, reason))
        tele = self._engine.telemetry
        if tele.enabled:
            tele.note_health(frm, to, reason, now_ms=now)
        cap = self._engine.capture
        if cap is not None:
            # Every transition rides the capture timeline; one into
            # DEGRADED also freezes the recent segments.
            cap.note_health({"event": "failover", "from": frm, "to": to, "reason": reason, "now_ms": now})

    def trip(self, where: str, exc: BaseException, seq: object = -1) -> None:
        """A device fault: go DEGRADED and quarantine the in-flight queue.
        Idempotent: later faults while DEGRADED only update ``last_fault``."""
        eng = self._engine
        with self._lock:
            first = self.state != DEGRADED
            self.last_fault = f"{where}@{seq}: {type(exc).__name__}: {exc}"
            if isinstance(exc, DeviceFetchTimeout):
                self.counters["fetch_timeouts"] += 1
            if first:
                self.counters["trips"] += 1
                self._set_state_locked(DEGRADED, self.last_fault)
                self.fallback.begin(eng.clock.now_ms())
                # Auto-recovery waits retry.ms from the trip.
                self._last_attempt_ms = eng.clock.now_ms()
        if first:
            record_log.error("[Failover] engine DEGRADED (%s)", self.last_fault)
            eng._quarantine_pending()

    def recovery_due(self, now_ms: int) -> bool:
        if self._engine.mesh is not None:
            return False  # see try_recover's mesh gate
        with self._lock:
            if self.state != DEGRADED:
                return False
            last = self._last_attempt_ms
            return last is None or now_ms - last >= self.retry_ms

    def try_recover(self) -> bool:
        """DEGRADED -> RECOVERING -> (restore + K probe flushes) -> HEALTHY;
        any restore or probe fault falls back to DEGRADED. Serialized with
        real flushes on the engine's flush lock."""
        eng = self._engine
        if eng.mesh is not None:
            # Restore and probe are single-device; stay DEGRADED.
            with self._lock:
                if self.state == HEALTHY:
                    return True
                self.last_fault = ("recovery unsupported while mesh mode is enabled — disable_mesh() first, "
                                   "then try_recover()")
            record_log.warn("[Failover] %s", self.last_fault)
            return False
        with eng._flush_lock:
            with self._lock:
                if self.state == HEALTHY:
                    return True
                self._set_state_locked(RECOVERING, "recovery attempt")
                self._last_attempt_ms = eng.clock.now_ms()
            try:
                self._restore_locked()
                for _ in range(self.probe_k):
                    self._probe_locked()
                self._reanchor_checkpoint()
            except BaseException as exc:
                with self._lock:
                    self.last_fault = f"recovery: {type(exc).__name__}: {exc}"
                    self._set_state_locked(DEGRADED, self.last_fault)
                record_log.warn("[Failover] recovery failed (%s); staying DEGRADED", self.last_fault)
                return False
            self.fallback.clear_gauge_deltas()
            self.fallback.end_degraded()
            with self._lock:
                self.counters["recoveries"] += 1
                self._set_state_locked(HEALTHY, "recovered")
        record_log.info("[Failover] engine HEALTHY again")
        return True

    def _reanchor_checkpoint(self) -> None:
        """Replace the stored checkpoint with the world just installed: the
        restore replayed the degraded window's net gauge deltas, which
        recovery then clears, so a second fault before any clean drain
        must not restore the pre-replay world again (it would leak the
        THREAD gauge by the replayed net). A fault here falls back to
        DEGRADED with the old (checkpoint, ledger) pair intact."""
        eng = self._engine
        meta = self.begin_checkpoint(eng.flush_seq, eng.clock.now_ms(), eng.flow_index, eng.degrade_index,
                                     eng.param_index)
        states = self.watched(eng._copy_states_now, "checkpoint re-anchor fetch", ())
        self.store_checkpoint(meta, states)

    # ------------------------------------------------------------------
    # watchdog
    # ------------------------------------------------------------------
    def watched(self, fn, what: str, seqs: Sequence[int], timeout_ms: Optional[int] = None):
        """Run ``fn`` on a watchdog waiter thread, in the engine's device and
        stream, bounded by the fetch timeout (a dispatch by at least
        :attr:`DISPATCH_TIMEOUT_FLOOR_MS`). A wedged call cannot be
        cancelled, only abandoned: the waiter is marked lost and the next
        call starts a replacement."""
        if timeout_ms is None:
            timeout_ms = self.fetch_timeout_ms
            if "dispatch" in what:
                timeout_ms = max(timeout_ms, self.DISPATCH_TIMEOUT_FLOOR_MS)
        eng = self._engine

        def run():
            with eng._thread_context():
                return fn()

        with self._waiter_lock:
            w = self._idle_waiters.pop() if self._idle_waiters else None
        if w is None or w.lost:
            w = _Waiter("sentinel-failover-waiter")
        box, done = w.submit(run)
        try:
            if not done.wait(timeout_ms / 1000.0):
                w.lost = True
                # The stop sentinel too: a call that finishes after this
                # flag but before its own check still unparks the thread.
                w.stop()
                raise DeviceFetchTimeout(f"{what} exceeded {timeout_ms} ms (flush seqs {list(seqs)})")
        finally:
            if not w.lost:
                with self._waiter_lock:
                    if len(self._idle_waiters) < 4:
                        self._idle_waiters.append(w)
                        w = None
                if w is not None:
                    w.stop()  # pool full: retire rather than leak
        if "e" in box:
            raise box["e"]
        return box["v"]

    # ------------------------------------------------------------------
    # degraded fill (the one home of policy-verdict assembly)
    # ------------------------------------------------------------------
    def fill_degraded(self, entries, exits=(), bulk=(), bulk_exits=(), run_custom_slots: bool = True) -> List[tuple]:
        """Fill every op's verdict from the fallback admitter: the degraded
        flush, the chunk-level fault handler and quarantined records.
        Exits record their device-gauge releases for the restore replay.
        Writes the trace records and the provenance ledger's degraded
        column; returns the block-log items. ``run_custom_slots`` False for
        ops whose chunk ran the custom slot checks before the fault: a
        second run would double a user slot's side effects."""
        from sentinel_tpu_torch.core.slots import SlotChainRegistry, SlotEntryContext

        eng = self._engine
        now = eng.clock.now_ms()
        fb = self.fallback
        tracer = eng.admission_trace
        rm = eng.resource_metrics
        end_pc = time.perf_counter()
        items: List[tuple] = []
        n_admit = 0
        n_block = 0
        slots_active = run_custom_slots and bool(SlotChainRegistry.slots())
        for op in entries:
            v0 = op._verdict
            if v0 is not None and v0.speculative:
                # The speculative tier served this verdict from the same
                # persistent mirror: keep it (the caller may have acted on
                # it); the device never applied this chunk, so an admitted
                # THREAD entry's deltas join the restore replay, and the
                # serve note its settle would write lands here.
                op._pending = None
                if rm.enabled:
                    rm.note(op.ts, op.resource, spec=op.acquire, degraded=op.acquire if v0.degraded else 0)
                if v0.admitted:
                    n_admit += 1
                    fb.note_unsettled_admit(op)
                else:
                    n_block += 1
                    limit_app = getattr(v0.blocked_rule, "limit_app", None) or "default"
                    items.append((op.resource, E.exc_name_for_code(v0.reason), limit_app, op.origin, op.acquire))
                if op.trace is not None:
                    tracer.record_admission(op.trace, op.resource, op.origin, op.context_name, v0.admitted,
                                            v0.reason, -1, op.spec_end_pc or end_pc, degraded=v0.degraded,
                                            provenance="speculative")
                    op.trace = None
                continue
            if slots_active and not op.custom_checked:
                op.custom_veto = SlotChainRegistry.check_entry(
                    SlotEntryContext(op.resource, op.context_name, op.origin, op.acquire, op.prio, op.args))
                op.custom_checked = True
            v = fb.admit(op, now)
            op.verdict = v
            op._pending = None
            if rm.enabled:
                rm.note(op.ts, op.resource, degraded=op.acquire)
            if v.admitted:
                n_admit += 1
            else:
                n_block += 1
                limit_app = getattr(v.blocked_rule, "limit_app", None) or "default"
                items.append((op.resource, E.exc_name_for_code(v.reason), limit_app, op.origin, op.acquire))
            if op.trace is not None:
                tracer.record_admission(op.trace, op.resource, op.origin, op.context_name, v.admitted, v.reason, -1,
                                        end_pc, degraded=True)
                op.trace = None
        for g in bulk:
            if g.spec_admitted is not None and g._admitted is not None:
                # The bulk analog of the kept speculative verdict.
                g._pending = None
                adm, rsn = g._admitted, g._reason
                n_adm = int(adm.sum())
                n_admit += n_adm
                n_block += g.n - n_adm
                fb.note_unsettled_admit_bulk(g, n_adm)
                items.extend(_bulk_block_items(g, adm, rsn))
                if g.trace is not None:
                    tracer.record_bulk(g.trace, g.resource, g.origin, g.context_name, adm, rsn, -1, end_pc,
                                       degraded=g.spec_degraded, provenance="speculative")
                    g.trace = None
                continue
            if slots_active:
                # The device path's per-acquire check: a slot's veto keeps
                # applying to bulk traffic while DEGRADED.
                SlotChainRegistry.check_bulk_entry(g)
            adm, rsn, wait = fb.admit_bulk(g, now)
            g.admitted = adm
            g.reason = rsn
            g.wait_ms = wait
            g._pending = None
            if rm.enabled:
                rm.note_col(g.resource, g.ts, weights=g.acquire, degraded=True)
            n_adm = int(adm.sum())
            n_admit += n_adm
            n_block += g.n - n_adm
            items.extend(_bulk_block_items(g, adm, rsn))
            if g.trace is not None:
                tracer.record_bulk(g.trace, g.resource, g.origin, g.context_name, adm, rsn, -1, end_pc,
                                   degraded=True)
                g.trace = None
        for x in exits:
            if x.thr < 0:
                fb.note_device_exit(x.rows, getattr(x, "p_rows", ()) or (), -x.thr)
                if x.resource is not None and not fb.persistent:
                    # A persistent mirror already released at submit_exit.
                    fb.on_exit(x.resource, 1, rows=x.rows, rt=x.rt, count=x.count, now_ms=now)
            elif x.thr > 0:
                # A speculative +thread compensation op caught in a
                # degraded window: the device never saw the +n either.
                fb.note_unsettled_admit_rows(x.rows, x.thr)
        for gx in bulk_exits:
            if gx.thr < 0:
                fb.note_device_exit(gx.rows, (), gx.n)
                if gx.resource is not None and not fb.persistent:
                    fb.on_exit(gx.resource, gx.n, rows=gx.rows, rt=int(gx.rt.sum()), count=int(gx.count.sum()),
                               now_ms=now, min_rt=int(gx.rt.min()))
        with self._lock:
            self.counters["degraded_admits"] += n_admit
            self.counters["degraded_blocks"] += n_block
        tele = eng.telemetry
        if tele.enabled and (n_admit or n_block):
            tele.note_degraded(n_admit, n_block)
        return items

    def note_quarantined(self, n: int = 1) -> None:
        with self._lock:
            self.counters["quarantined_records"] += n

    # ------------------------------------------------------------------
    # checkpoint / restore
    # ------------------------------------------------------------------
    def checkpoint_due(self, seq: int) -> bool:
        # Sharded states are not checkpointed (restore is single-device).
        if self._engine.mesh is not None:
            return False
        if self._ckpt_force:
            # One-shot (a planned handoff): the next flush checkpoints
            # whatever the cadence, so the final durable spill carries the
            # freshest state the successor warms from.
            self._ckpt_force = False
            return True
        return self.checkpoint_every > 0 and seq % self.checkpoint_every == 0

    def request_checkpoint(self) -> None:
        """Arm a one-shot checkpoint on the next flush (the planned
        handoff's final spill)."""
        self._ckpt_force = True

    def begin_checkpoint(self, seq, now_ms, findex, dindex, pindex) -> Checkpoint:
        """Metadata for a checkpoint whose state copies ride the chunk's
        copy back (Engine._run_chunk)."""
        return Checkpoint(
            seq=seq, now_ms=now_ms, epoch_wall_ms=self._engine.clock.epoch_wall_ms, win_key=_ncfg.SECOND_CFG,
            findex_ref=weakref.ref(findex), dindex_ref=weakref.ref(dindex), pindex_ref=weakref.ref(pindex),
        )

    def store_checkpoint(self, meta: Checkpoint, host_states: tuple) -> None:
        if len(host_states) == 4:
            host_states = host_states + (None,)
        meta.states = host_states
        with self._lock:
            # Two in-flight checkpointed chunks landing out of order never
            # replace a newer checkpoint with an older one.
            if self._ckpt is None or self._ckpt.seq <= meta.seq:
                self._ckpt = meta
            self.counters["checkpoints"] += 1
        if self.durable_path:
            # The value -> row maps now: the live index may recycle rows
            # before the writer thread runs.
            pindex = meta.pindex_ref()
            if pindex is not None and meta.states[3] is not None:
                meta.param_values = pindex.values_snapshot()
            self._durable_schedule(meta)

    # ------------------------------------------------------------------
    # durable spill (sentinel.tpu.failover.checkpoint.path)
    # ------------------------------------------------------------------
    def _durable_schedule(self, meta: Checkpoint) -> None:
        with self._lock:
            if self._durable_pending is None or self._durable_pending.seq <= meta.seq:
                self._durable_pending = meta
            if self._durable_thread is None and not self._durable_stop:
                self._durable_thread = threading.Thread(target=self._durable_loop, name="sentinel-ckpt-writer",
                                                        daemon=True)
                self._durable_thread.start()
        self._durable_event.set()

    def _durable_loop(self) -> None:
        while True:
            self._durable_event.wait()
            if self._durable_stop:
                return
            # At most one write per interval; the newest pending wins.
            if self.durable_interval_ms > 0 and self.last_durable:
                gap = time.time() * 1000 - self.last_durable[0]
                wait = (self.durable_interval_ms - gap) / 1e3
                if wait > 0:
                    time.sleep(wait)
                    if self._durable_stop:
                        return
            self._durable_event.clear()
            with self._lock:
                meta, self._durable_pending = self._durable_pending, None
            if meta is not None and meta.states is not None:
                self._write_durable(meta)

    def _write_durable(self, meta: Checkpoint) -> bool:
        """Spill one checkpoint and count the outcome; never raises."""
        try:
            t0 = time.perf_counter()
            nbytes = self._durable_spill(meta)
            with self._lock:
                self.counters["durable_writes"] += 1
                self.last_durable = (int(time.time() * 1000), meta.seq, (time.perf_counter() - t0) * 1e3, nbytes)
            return True
        except Exception:
            with self._lock:
                self.counters["durable_write_errors"] += 1
            record_log.error("[Failover] durable checkpoint spill failed", exc_info=True)
            return False

    def _durable_spill(self, meta: Checkpoint) -> int:
        """Serialize one checkpoint to the durable file in the JAX
        package's layout. Components whose index weakref died are omitted."""
        from sentinel_tpu_torch.runtime import durable

        eng = self._engine
        states = meta.states
        comp_leaves: List[np.ndarray] = []
        comps: Dict[str, int] = {}
        fps: Dict[str, int] = {}

        def put(name: str, tree, ok: bool) -> None:
            if not ok or tree is None:
                comps[name] = 0
                return
            leaves = tree_leaves(tree)
            comps[name] = len(leaves)
            comp_leaves.extend(np.asarray(a) for a in leaves)

        findex = meta.findex_ref()
        dindex = meta.dindex_ref()
        pindex = meta.pindex_ref()
        put("stats", states[0], True)
        put("flow", states[1], findex is not None)
        put("degrade", states[2], dindex is not None)
        # Param rows name dynamically interned (rule, value) pairs: the
        # checkpoint carries the value -> row maps the loader re-installs.
        put("param", states[3], pindex is not None and meta.param_values is not None)
        put("sketch", states[4], states[4] is not None)
        if findex is not None:
            fps["flow"] = durable.rules_fingerprint(findex.rules)
        if dindex is not None:
            fps["degrade"] = durable.rules_fingerprint(dindex.rules)
        if comps.get("param"):
            fps["param"] = durable.rules_fingerprint(pindex.rules)
        cur = _ncfg.SECOND_CFG
        header = {
            "seq": meta.seq,
            "now_ms": meta.now_ms,
            # Stats are padded past the registry: the loader needs the
            # captured row count to rebuild the reference layout.
            "stats_rows": int(np.shape(states[0].threads)[0]),
            "epoch_wall_ms": meta.epoch_wall_ms,
            "wall_ms": int(time.time() * 1000),
            "win": [cur.sample_count, cur.interval_ms, cur.max_rt],
            "components": comps,
            "fingerprints": fps,
            # Rows are never reassigned, so a key list taken slightly after
            # the states still maps every row they contain.
            "node_keys": eng.nodes.keys_snapshot(),
        }
        if comps.get("param"):
            header["param_values"] = meta.param_values
            header["param_rows"] = int(np.shape(states[3].tokens)[0])
        return durable.write_checkpoint(self.durable_path, header, comp_leaves)

    def restore_durable(self, path: Optional[str] = None) -> bool:
        """Warm-start a fresh engine from the durable file: load, validate,
        remap the stats rows through the node-registry key list, install
        through the DEGRADED -> RECOVERING machinery and return True when
        the engine came back HEALTHY. Every validation failure is a cold
        start with a counted event (``durable_load_cold``), never an
        exception. THREAD gauges restore as zero: live concurrency is a set
        of running callers, rebuilt by their re-assertions."""
        from sentinel_tpu_torch.runtime import durable

        eng = self._engine
        p = (path or self.durable_path).strip()
        if not p or eng.mesh is not None:
            return False
        if not os.path.exists(p):
            return False
        try:
            header, leaves = durable.read_checkpoint(p)
        except (durable.DurableCheckpointError, OSError) as e:
            with self._lock:
                self.counters["durable_load_cold"] += 1
            record_log.warn("[Failover] durable checkpoint unusable (%s) — cold start", e)
            return False
        stale_ms = config.get_int(config.FAILOVER_CKPT_STALE_MS, 0)
        age = int(time.time() * 1000) - int(header.get("wall_ms", 0))
        if stale_ms > 0 and age > stale_ms:
            with self._lock:
                self.counters["durable_load_cold"] += 1
            record_log.warn("[Failover] durable checkpoint stale (%d ms > %d) — cold start", age, stale_ms)
            return False
        try:
            ck = self._build_durable_checkpoint(header, leaves)
        except Exception:
            with self._lock:
                self.counters["durable_load_cold"] += 1
            record_log.error("[Failover] durable checkpoint rejected — cold start", exc_info=True)
            return False
        with self._lock:
            self._ckpt = ck
            self.counters["durable_loads"] += 1
            if self.state == HEALTHY:
                self._set_state_locked(DEGRADED, "durable restore")
                self.fallback.begin(eng.clock.now_ms())
            self._last_attempt_ms = eng.clock.now_ms()
        return self.try_recover()

    def _build_durable_checkpoint(self, header, leaves) -> Checkpoint:
        """Validate per component and assemble a :class:`Checkpoint` aligned
        with this engine's world. Raises on structural surprises."""
        from sentinel_tpu_torch.metrics.nodes import make_stats, stats_to_numpy
        from sentinel_tpu_torch.rules.param_table import make_param_state, param_state_to_numpy
        from sentinel_tpu_torch.runtime import durable
        from sentinel_tpu_torch.runtime.sketch import make_sketch_state, sketch_state_to_numpy

        eng = self._engine
        cpu = torch.device("cpu")
        comps = header.get("components") or {}
        fps = header.get("fingerprints") or {}
        split: Dict[str, List[np.ndarray]] = {}
        off = 0
        for name in COMPONENTS:
            n = int(comps.get(name, 0))
            split[name] = leaves[off: off + n]
            off += n

        def host(tree):
            return type(tree)(*(host(v) if isinstance(v, tuple) else v.cpu().numpy() for v in tree))

        def rebuild(name: str, ref_tree):
            """Leaves -> the reference layout, gated on exact shape and
            dtype agreement (a changed rule set changes shapes)."""
            got = split[name]
            ref_leaves = tree_leaves(ref_tree)
            if len(got) != len(ref_leaves):
                return None
            for a, r in zip(got, ref_leaves):
                if tuple(a.shape) != tuple(np.shape(r)) or a.dtype != np.asarray(r).dtype:
                    return None
            return tree_unflatten(ref_tree, list(got))

        win = list(header.get("win") or [])
        cur = _ncfg.SECOND_CFG
        win_ok = win == [cur.sample_count, cur.interval_ms, cur.max_rt]

        # Stats: rows remapped by name through the registry key replay;
        # THREAD gauges zero.
        stats_tree = None
        node_keys = header.get("node_keys") or []
        stats_rows = int(header.get("stats_rows", 0))
        if win_ok and split["stats"] and node_keys and stats_rows >= len(node_keys):
            mapping = eng.nodes.adopt_keys(list(node_keys))
            n_new = max(len(eng.nodes), eng.stats.n_rows)
            fresh = stats_to_numpy(make_stats(n_new, cpu))
            old_tree = rebuild("stats", stats_to_numpy(make_stats(stats_rows, cpu)))
            if old_tree is not None and mapping:
                old_rows = np.fromiter(mapping.keys(), np.int64, len(mapping))
                new_rows = np.fromiter(mapping.values(), np.int64, len(mapping))

                def scatter(fresh_leaf, old_leaf):
                    out = np.array(fresh_leaf)
                    out[new_rows] = np.asarray(old_leaf)[old_rows]
                    return out

                stats_tree = tree_unflatten(fresh, [scatter(f, o) for f, o in zip(tree_leaves(fresh),
                                                                                   tree_leaves(old_tree))])
                stats_tree = stats_tree._replace(threads=np.zeros_like(np.asarray(stats_tree.threads)))

        findex = eng.flow_index
        flow_tree = None
        if split["flow"] and fps.get("flow") == durable.rules_fingerprint(findex.rules):
            flow_tree = rebuild("flow", host(findex.make_dyn_state()))
        dindex = eng.degrade_index
        degrade_tree = None
        if split["degrade"] and fps.get("degrade") == durable.rules_fingerprint(dindex.rules):
            degrade_tree = rebuild("degrade", host(dindex.make_dyn_state()))
        # Param: restorable only when the rules match and the fresh index
        # adopts the spilled value -> row maps; else param restores cold.
        pindex = eng.param_index
        param_tree = None
        pvals = header.get("param_values")
        prows = int(header.get("param_rows", 0))
        if split["param"] and pvals and prows > 0 and fps.get("param") == durable.rules_fingerprint(pindex.rules):
            candidate = rebuild("param", param_state_to_numpy(make_param_state(prows, cpu)))
            if candidate is not None and pindex.adopt_values(pvals):
                param_tree = candidate._replace(threads=np.zeros_like(np.asarray(candidate.threads)))
        sketch_tree = None
        tier = eng.sketch
        if split["sketch"] and tier.armed:
            sketch_tree = rebuild("sketch", sketch_state_to_numpy(make_sketch_state(tier.depth, tier.width,
                                                                                    tier.candidates, cpu)))

        def ref_or_dead(obj, ok: bool):
            return weakref.ref(obj) if ok else _dead_ref()

        return Checkpoint(
            seq=int(header.get("seq", 0)),
            now_ms=int(header.get("now_ms", 0)),
            epoch_wall_ms=int(header.get("epoch_wall_ms", 0)),
            win_key=cur if (win_ok and stats_tree is not None) else ("durable-win-mismatch",),
            findex_ref=ref_or_dead(findex, flow_tree is not None),
            dindex_ref=ref_or_dead(dindex, degrade_tree is not None),
            pindex_ref=ref_or_dead(pindex, param_tree is not None),
            states=(
                stats_tree if stats_tree is not None else stats_to_numpy(make_stats(eng.stats.n_rows, cpu)),
                flow_tree if flow_tree is not None else host(findex.make_dyn_state()),
                degrade_tree if degrade_tree is not None else host(dindex.make_dyn_state()),
                param_tree,
                sketch_tree,
            ),
        )

    def _restore_locked(self) -> None:
        """Re-seed the engine's device states from the last checkpoint; the
        body runs on the watchdog waiter (it copies to the device that just
        faulted, and an unbounded wedge would hold the flush lock). The
        caller holds the flush lock."""
        with self._lock:
            self._restore_gen += 1
            gen = self._restore_gen
        try:
            self.watched(lambda: self._restore_body(gen), "restore dispatch", ())
        except BaseException:
            with self._lock:
                self._restore_gen += 1
            raise

    def _restore_body(self, gen: int) -> None:
        """Fresh states where no checkpoint exists or a component went
        stale; a copy of the checkpoint's arrays into fresh device tensors
        otherwise (never an alias: the checkpoint stays intact for the next
        restore), re-based through the engine's timestamp shift if the
        clock epoch moved since capture."""
        from sentinel_tpu_torch.metrics.nodes import make_stats, stats_from_numpy
        from sentinel_tpu_torch.rules.degrade_table import degrade_state_from_numpy
        from sentinel_tpu_torch.rules.flow_table import FlowRuleDynState
        from sentinel_tpu_torch.rules.param_table import make_param_state, param_state_from_numpy
        from sentinel_tpu_torch.runtime.sketch import sketch_state_from_numpy

        eng = self._engine
        if eng.faults is not None:
            eng.faults.on_restore()
        dev = eng.device
        ck = self._ckpt
        with self._lock:
            self.counters["restores"] += 1
        with eng._lock:
            fresh_stats = ck is None or ck.win_key != _ncfg.SECOND_CFG
            stats = make_stats(eng.stats.n_rows, dev) if fresh_stats else stats_from_numpy(ck.states[0], dev)
            if ck is not None and ck.findex_ref() is eng.flow_index:
                # stored_tokens is float32: each leaf keeps its dtype.
                flow_dyn = FlowRuleDynState(*(torch.tensor(np.asarray(a), device=dev) for a in ck.states[1]))
            else:
                flow_dyn = eng.flow_index.make_dyn_state()
            if ck is not None and ck.dindex_ref() is eng.degrade_index:
                degrade_dyn = degrade_state_from_numpy(ck.states[2], dev)
                restored_breakers = np.array(ck.states[2].state, dtype=np.int32).reshape(-1)
            else:
                degrade_dyn = eng.degrade_index.make_dyn_state()
                restored_breakers = None
            if ck is not None and ck.pindex_ref() is eng.param_index:
                param_dyn = param_state_from_numpy(ck.states[3], dev)
            else:
                param_dyn = make_param_state(8, dev)
            offset = eng.clock.epoch_wall_ms - ck.epoch_wall_ms if ck is not None else 0
            if offset > 0:
                # The epoch re-anchored between capture and now: the same
                # shift the live rebase applies (Engine._shift_states).
                eng._shift_states(stats, flow_dyn, degrade_dyn, param_dyn, offset)
            # Replay the degraded window's NET thread-gauge deltas: exits the
            # device never saw come off, fallback admits still in flight go
            # on; clamped at 0. Peeked, not drained: a failed probe keeps
            # them for the next attempt.
            rel_rows, rel_prows, adm_rows, adm_prows = self.fallback.peek_gauge_deltas()
            stats = stats._replace(threads=_replay(stats.threads, adm_rows, rel_rows))
            # Param thread rows get the same treatment while the live
            # param index is the checkpoint's.
            if ck is not None and ck.pindex_ref() is eng.param_index:
                param_dyn = param_dyn._replace(threads=_replay(param_dyn.threads, adm_prows, rel_prows))
            if gen != self._restore_gen:
                # The watchdog abandoned this restore and the engine moved
                # on: installing now would replace live states with stale
                # ones. (A plain int read; taking self._lock under
                # eng._lock would order locks against other paths.)
                return
            eng.stats = stats
            eng.flow_dyn = flow_dyn
            eng.degrade_dyn = degrade_dyn
            eng.param_dyn = param_dyn
            eng._slab_horizon = _slab_horizon_of(stats)
            # The sketch: restored verbatim when its shapes match the live
            # config (keys are stable CRC ids), else reset.
            sk = ck.states[4] if ck is not None and len(ck.states) > 4 else None
            tier = eng.sketch
            if (
                sk is not None
                and tier.armed
                and tier.dev_state is not None
                and all(tuple(np.shape(a)) == tuple(b.shape) for a, b in zip(sk, tier.dev_state))
            ):
                tier.dev_state = sketch_state_from_numpy(sk, dev)
            else:
                tier.reset_device_state()
            # Resync the breaker host mirror to the restored world.
            eng._reset_breaker_mirror()
            if restored_breakers is not None and restored_breakers.shape == (eng._breaker_state_host.shape[0],):
                with eng._breaker_mirror_lock:
                    eng._breaker_state_host = restored_breakers
            eng._ensure_capacity()

    def _probe_locked(self) -> None:
        """One probe flush: an all-invalid batch through the flush's kernels
        and back through the copy back; raises on any fault
        (watchdog-bounded). The caller holds the flush lock."""
        eng = self._engine
        seq = eng._next_flush_seq()
        if eng.faults is not None:
            eng.faults.on_dispatch(seq)
        staging: List[tuple] = []
        refs = self.watched(lambda: eng._probe_dispatch(staging), "probe dispatch", (seq,))
        eng._fetch_refs([refs], (seq,))
        if eng._arena is not None:
            eng._arena.give_all(staging)
        with self._lock:
            self.counters["probe_flushes"] += 1
        tele = eng.telemetry
        if tele.enabled:
            tele.note_probe()

    # ------------------------------------------------------------------
    # readers
    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Back to HEALTHY with no checkpoint (engine reset)."""
        with self._lock:
            self._set_state_locked(HEALTHY, "engine reset")
            self._ckpt = None
            self._last_attempt_ms = None
        self.fallback.clear_gauge_deltas()
        self.fallback.end_degraded()

    def warm_probe(self, k: int = 1) -> float:
        """Drive ``k`` probe flushes through the flush's kernels (builds and
        loads them before serving); returns elapsed ms. Raises on faults."""
        eng = self._engine
        t0 = time.perf_counter()
        with eng._flush_lock:
            for _ in range(max(1, int(k))):
                self._probe_locked()
        return (time.perf_counter() - t0) * 1e3

    def spill_durable_now(self) -> bool:
        """Write the newest checkpoint synchronously on the caller's thread
        (a planned handoff's final spill). Never raises."""
        if not self.durable_path:
            return False
        with self._lock:
            meta = self._durable_pending or self._ckpt
            self._durable_pending = None
        if meta is None or meta.states is None:
            return False
        return self._write_durable(meta)

    def close(self) -> None:
        """Retire the idle waiters and stop the durable writer.
        Non-destructive: later calls start fresh ones."""
        with self._waiter_lock:
            waiters, self._idle_waiters = self._idle_waiters, []
        for w in waiters:
            w.stop()
        with self._lock:
            self._durable_stop = True
            t, self._durable_thread = self._durable_thread, None
        self._durable_event.set()
        if t is not None:
            t.join(timeout=5.0)
        with self._lock:
            self._durable_stop = False
            self._durable_event.clear()

    def snapshot(self) -> dict:
        with self._lock:
            ck = self._ckpt
            return {
                "enabled": self.armed,
                "state": self.state,
                "state_since_ms": self.state_since_ms,
                "policy": config.get(config.FAILOVER_POLICY) or "open",
                "fetch_timeout_ms": self.fetch_timeout_ms,
                "checkpoint_every": self.checkpoint_every,
                "probe_flushes": self.probe_k,
                "retry_ms": self.retry_ms,
                "last_fault": self.last_fault,
                "counters": dict(self.counters),
                "checkpoint": (
                    {"seq": ck.seq, "now_ms": ck.now_ms} if ck is not None and ck.states is not None else None
                ),
                "durable": {
                    "path": self.durable_path,
                    "interval_ms": self.durable_interval_ms,
                    "writes": self.counters["durable_writes"],
                    "write_errors": self.counters["durable_write_errors"],
                    "loads": self.counters["durable_loads"],
                    "load_cold": self.counters["durable_load_cold"],
                    "last": (
                        {
                            "wall_ms": self.last_durable[0],
                            "seq": self.last_durable[1],
                            "write_ms": round(self.last_durable[2], 3),
                            "bytes": self.last_durable[3],
                            "age_ms": max(0, int(time.time() * 1000) - self.last_durable[0]),
                        }
                        if self.last_durable else None
                    ),
                },
                "events": [e.as_dict() for e in self.events],
                "fallback": self.fallback.snapshot(),
            }


def _replay(threads: torch.Tensor, adm: Dict[int, int], rel: Dict[int, int]) -> torch.Tensor:
    """``threads`` plus the net (admits - releases) per row, rows outside
    the tensor dropped, then clamped at 0 (as the JAX package's
    ``.at[rows].add(mode="drop")`` and ``maximum``)."""
    net = {r: adm.get(r, 0) - rel.get(r, 0) for r in set(adm) | set(rel)}
    net = {r: d for r, d in net.items() if d != 0}
    if not net:
        return threads
    net = {r: d for r, d in net.items() if 0 <= r < threads.shape[0]}
    rows = torch.tensor(list(net), dtype=torch.int64, device=threads.device)
    cnt = torch.tensor([net[r] for r in net], dtype=torch.int32, device=threads.device)
    return threads.index_add(0, rows, cnt).clamp_(min=0)


def _slab_horizon_of(stats) -> Optional[int]:
    """The engine's slab horizon for stats installed wholesale: the latest
    future window start, or None when every cell is (empty_ws, 0)."""
    top = int(stats.future_ws.max()) if stats.future_ws.numel() else _ncfg.SECOND_CFG.empty_ws
    if top == _ncfg.SECOND_CFG.empty_ws and not bool((stats.future_pass != 0).any()):
        return None
    return top


def _bulk_block_items(g, adm: np.ndarray, rsn: np.ndarray) -> List[tuple]:
    """A bulk group's block-log items of a policy fill: one per reason
    among its blocked rows, under the "default" limit app."""
    blocked = ~adm
    if not blocked.any():
        return []
    acq = np.asarray(g.acquire)
    return [
        (g.resource, E.exc_name_for_code(int(r)), "default", g.origin, int(acq[blocked & (rsn == r)].sum()))
        for r in np.unique(rsn[blocked])
    ]
