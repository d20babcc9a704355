"""Two-tier speculative admission: the host admits, the device settles,
reconciliation bounds the drift (port of
``sentinel_tpu/runtime/speculative.py``).

A per-request caller never gets a microsecond verdict from a round trip to
the card. This tier promotes the failover's host mirror from a failure
mode to an always-on fast tier:

* **fast tier (host)**: ``SphU.entry``-style singles and bulk groups get
  an immediate verdict from the persistent
  :class:`~sentinel_tpu_torch.runtime.failover.HostFallbackAdmitter`
  (QPS token buckets, live THREAD counters, the breaker host mirror,
  per-value param buckets, the shaping pacer/ramp mirror, a host system
  gate), tagged ``Verdict.speculative``;
* **settling plane (device)**: the same op still rides the flush, and the
  kernels re-decide it against the device state, which therefore evolves
  as the synchronous engine's would;
* **reconciliation (each drain)**: the settled verdict is diffed against
  the speculative one. An over-admit drains the offending mirror bucket;
  every mismatch queues a +-1 thread-gauge compensation op (an exit op of
  count 0, through the flush's update kernel) so the device gauge tracks
  the callers that really run.

Drift is bounded by the clamps and by a valve: with
``sentinel.tpu.speculative.overadmit.max`` observed over-admits in one
drift window, speculation is suspended (ops take the synchronous device
path) until the window rolls. The mirror is persistent, so a device trip
is a zero-transition event: ``FailoverManager.fallback`` is this tier's
mirror when the tier is on.

Prioritized (occupy) entries decline to the device path: their borrow
semantics live in the kernels' slab.

The tier's serves, declines, drift, drift windows and suspensions are
noted on the telemetry bus, the serves and the drift also in the
per-resource provenance ledger (metrics/provenance.py) at each op's submit
ts; the admission trace records a speculative op when it settles
(``Engine._fill_results``). The custom processor slots run at admission,
once an op or group (``custom_checked``): the settle's encode never runs
them again.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np

from sentinel_tpu_torch.core import errors as E
from sentinel_tpu_torch.core.slots import SlotChainRegistry, SlotEntryContext
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.runtime.failover import HostFallbackAdmitter
from sentinel_tpu_torch.utils.config import config


class SpeculativeAdmitter:
    """Engine-scoped speculative fast tier (one per Engine). Disabled (the
    default), every engine hook is one attribute read."""

    def __init__(self, engine) -> None:
        self._engine = engine
        self.enabled = config.get_bool(config.SPECULATIVE_ENABLED, False)
        self.flush_batch = max(1, config.get_int(config.SPECULATIVE_FLUSH_BATCH, 64))
        self.overadmit_max = max(0, config.get_int(config.SPECULATIVE_OVERADMIT_MAX, 64))
        self.window_ms = max(1, config.get_int(config.SPECULATIVE_WINDOW_MS, 1000))
        # The persistent mirror; the engine aliases FailoverManager.fallback
        # to it when the tier is on.
        self.mirror = HostFallbackAdmitter(engine, persistent=True)
        self._lock = threading.Lock()
        # Valve window (live observation clock).
        self._win_start = -1
        self._win_over = 0
        self._win_under = 0
        self._suspended = False
        # Drift accounting windows keyed by submit-ts window start, folded
        # once they are >= 2 windows behind the newest seen.
        self._attr: Dict[int, list] = {}
        self._attr_newest = -1
        self._max_window_net = 0
        self.counters: Dict[str, int] = {
            "spec_admits": 0,
            "spec_blocks": 0,
            "spec_declined": 0,
            "spec_shaped": 0,
            "spec_system_blocks": 0,
            "reconciled": 0,
            "over_admits": 0,
            "under_admits": 0,
            "comp_plus": 0,
            "comp_minus": 0,
            "bucket_clamps": 0,
            "suspensions": 0,
            "windows": 0,
        }

    # ------------------------------------------------------------------
    # admission fast path
    # ------------------------------------------------------------------
    def _declinable(self, op) -> bool:
        """Ops only the device implements: prioritized (occupy) entries,
        and shaped slots while the shaping mirror is off."""
        return bool(op.prio) or self._declinable_slots(op.src, op.slots)

    def _declinable_slots(self, src, slots) -> bool:
        if self.mirror.shaping_enabled:
            return False
        return self._shaped_slots(src, slots)

    def _shaped_slots(self, src, slots) -> bool:
        findex = src[0] if src is not None else self._engine.flow_index
        sg = findex.shaping_gids
        return bool(sg) and any(gid in sg for gid, _crow in slots)

    def _decline(self, n: int = 1) -> None:
        with self._lock:
            self.counters["spec_declined"] += n
        tele = self._engine.telemetry
        if tele.enabled:
            tele.note_spec_declined(n)

    def try_admit(self, op, now_ms: int):
        """Immediate host verdict for one entry op, or None when the tier
        declines (the caller takes the device path). Fills ``op.verdict``;
        the settled device verdict reconciles against it at the drain
        without replacing it."""
        fo = self._engine.failover
        degraded = fo.armed and not fo.healthy
        with self._lock:
            self._roll_window_locked(now_ms)
            suspended = self._suspended
        # Suspension only matters while HEALTHY: degraded has no better tier.
        if (suspended and not degraded) or self._declinable(op):
            self._decline()
            return None
        # The custom slots run here, at admission; custom_checked keeps the
        # chunk's encode from running the user's hooks again.
        if SlotChainRegistry.slots() and not op.custom_checked:
            op.custom_veto = SlotChainRegistry.check_entry(
                SlotEntryContext(op.resource, op.context_name, op.origin, op.acquire, op.prio, op.args))
            op.custom_checked = True
        shaped = self._shaped_slots(op.src, op.slots)
        v = self.mirror.admit(op, now_ms, apply_policy=degraded, degraded=degraded, speculative=True)
        op.verdict = v
        op.spec_end_pc = time.perf_counter()  # the latency the trace record attributes
        sys_block = not v.admitted and v.reason == E.BLOCK_SYSTEM
        with self._lock:
            self.counters["spec_admits" if v.admitted else "spec_blocks"] += 1
            if shaped:
                self.counters["spec_shaped"] += 1
            if sys_block:
                self.counters["spec_system_blocks"] += 1
        tele = self._engine.telemetry
        if tele.enabled:
            tele.note_speculative(int(v.admitted), int(not v.admitted))
            if shaped:
                tele.note_spec_shaped(1)
            if sys_block:
                tele.note_spec_system_block(1)
        return v

    def try_admit_bulk(self, g, now_ms: int) -> bool:
        """Immediate array verdicts for one bulk group; False when the tier
        declines. The speculative arrays are kept on the group
        (``spec_admitted``) for the reconcile and installed as its results."""
        fo = self._engine.failover
        degraded = fo.armed and not fo.healthy
        with self._lock:
            self._roll_window_locked(now_ms)
            suspended = self._suspended
        shaped = self._shaped_slots(g.src, g.slots)
        servable = True
        if shaped:
            findex = g.src[0] if g.src is not None else self._engine.flow_index
            servable = self.mirror.bulk_shaping_servable(g, findex)
        if (suspended and not degraded) or self._declinable_slots(g.src, g.slots) or (
            shaped and not degraded and not servable
        ):
            # Shaped groups outside the closed form decline to the device's
            # general scan, except while degraded (no device to decline to).
            self._decline(g.n)
            return False
        if SlotChainRegistry.slots() and g.custom_veto_mask is None:
            SlotChainRegistry.check_bulk_entry(g)
        adm, rsn, wait = self.mirror.admit_bulk(g, now_ms, apply_policy=degraded, speculative=True,
                                                shaping_servable=servable)
        g.spec_admitted = adm.copy()
        g.spec_degraded = degraded
        g.admitted = adm
        g.reason = rsn
        g.wait_ms = wait
        n_adm = int(adm.sum())
        n_sys = int((~adm & (rsn == E.BLOCK_SYSTEM)).sum())
        with self._lock:
            self.counters["spec_admits"] += n_adm
            self.counters["spec_blocks"] += g.n - n_adm
            if shaped:
                self.counters["spec_shaped"] += g.n
            if n_sys:
                self.counters["spec_system_blocks"] += n_sys
        tele = self._engine.telemetry
        if tele.enabled:
            tele.note_speculative(n_adm, g.n - n_adm)
            if shaped:
                tele.note_spec_shaped(g.n)
            if n_sys:
                tele.note_spec_system_block(n_sys)
        rm = self._engine.resource_metrics
        if rm.enabled:
            # Columnar serve note grouped by each row's submit second.
            rm.note_col(g.resource, g.ts, weights=g.acquire, spec=True, degraded=degraded)
        return True

    # ------------------------------------------------------------------
    # reconciliation (drain path)
    # ------------------------------------------------------------------
    def _fold_attr_locked(self, start: int, bucket: list) -> None:
        """Close one submit-ts accounting window (the bound is on NET
        excess admissions); the caller holds ``self._lock``."""
        net = max(0, bucket[0] - bucket[1])
        self.counters["windows"] += 1
        if net > self._max_window_net:
            self._max_window_net = net
        tele = self._engine.telemetry
        if tele.enabled:
            tele.note_spec_window(net)

    def _touch_attr_locked(self, ts: int) -> None:
        start = ts - ts % self.window_ms
        if start > self._attr_newest:
            self._attr_newest = start
            horizon = start - 2 * self.window_ms
            for s in [s for s in self._attr if s <= horizon]:
                self._fold_attr_locked(s, self._attr.pop(s))
        if start not in self._attr:
            self._attr[start] = [0, 0]

    def _roll_window_locked(self, now_ms: int) -> None:
        self._touch_attr_locked(now_ms)
        start = now_ms - now_ms % self.window_ms
        if start == self._win_start:
            return
        self._win_start = start
        self._win_over = 0
        self._win_under = 0
        self._suspended = False

    def flush_window(self) -> None:
        """Fold every open accounting window (Engine.close)."""
        with self._lock:
            for s in list(self._attr):
                self._fold_attr_locked(s, self._attr.pop(s))

    def _note_mismatch_locked(self, ts: int, over: int, under: int) -> None:
        self._win_over += over
        self._win_under += under
        self.counters["over_admits"] += over
        self.counters["under_admits"] += under
        start = ts - ts % self.window_ms
        bucket = self._attr.get(start)
        if bucket is None:
            bucket = self._attr[start] = [0, 0]
        bucket[0] += over
        bucket[1] += under
        if self.overadmit_max > 0 and self._win_over - self._win_under >= self.overadmit_max and not self._suspended:
            # The divergence valve: stop speculating until the window rolls.
            self._suspended = True
            self.counters["suspensions"] += 1
            tele = self._engine.telemetry
            if tele.enabled:
                tele.note_spec_suspended()

    def _clamp_for(self, op, settled) -> None:
        """Drain the mirror state that over-admitted ``op``."""
        rule = settled.blocked_rule
        clamped = False
        if settled.reason == E.BLOCK_FLOW and rule is not None:
            clamped = self.mirror.drain_bucket(rule)
        elif settled.reason == E.BLOCK_PARAM:
            for ps in op.p_slots:
                if ps.grade == C.FLOW_GRADE_QPS and ps.prow >= 0:
                    clamped = self.mirror.drain_pbucket(ps.prow) or clamped
        elif settled.reason == E.BLOCK_SYSTEM and settled.limit_type == "qps":
            # Only the consumable QPS dimension empties the gate's bucket.
            clamped = self.mirror.drain_sys_bucket()
        # BLOCK_DEGRADE needs no clamp (the breaker mirror rides every
        # flush while the tier is on); shaping re-anchors at this drain.
        if clamped:
            with self._lock:
                self.counters["bucket_clamps"] += 1

    def reconcile_entry(self, op, spec_v, settled) -> bool:
        """Diff one op's speculative verdict against its settled one;
        returns the match flag. A speculatively admitted caller runs and
        will exit (+1 now); a speculatively blocked one never ran (-1)."""
        eng = self._engine
        now = eng.clock.now_ms()
        match = bool(spec_v.admitted) == bool(settled.admitted)
        with self._lock:
            self._roll_window_locked(now)
            self.counters["reconciled"] += 1
            if not match:
                if spec_v.admitted:
                    self._note_mismatch_locked(op.ts, 1, 0)
                else:
                    self._note_mismatch_locked(op.ts, 0, 1)
        if not match:
            if spec_v.admitted:
                self._clamp_for(op, settled)
                eng._submit_gauge_comp(op.rows, +1)
                with self._lock:
                    self.counters["comp_plus"] += 1
            else:
                eng._submit_gauge_comp(op.rows, -1)
                with self._lock:
                    self.counters["comp_minus"] += 1
            tele = eng.telemetry
            if tele.enabled:
                tele.note_spec_drift(int(spec_v.admitted), int(not spec_v.admitted))
            rm = eng.resource_metrics
            if rm.enabled:
                # Per-resource drift at the op's submit ts.
                rm.note(op.ts, op.resource, over=int(spec_v.admitted), under=int(not spec_v.admitted))
        return match

    def reconcile_bulk(self, g, dev_admitted: np.ndarray, dev_reason: np.ndarray,
                       dev_slot_ok: Optional[np.ndarray] = None, dev_sys_type: Optional[np.ndarray] = None) -> None:
        """Vectorized bulk reconcile: mismatch counts, bucket clamps
        narrowed to the slots the device found violated (``dev_slot_ok``),
        and one +-n thread-gauge compensation per direction."""
        spec = g.spec_admitted
        if spec is None:
            return
        eng = self._engine
        now = eng.clock.now_ms()
        over_m = spec & ~dev_admitted
        under_m = ~spec & dev_admitted
        over = int(over_m.sum())
        under = int(under_m.sum())
        with self._lock:
            self._roll_window_locked(now)
            self.counters["reconciled"] += g.n
            if over or under:
                ts = np.asarray(g.ts)
                starts = ts - ts % self.window_ms
                for s in np.unique(starts[over_m | under_m]):
                    sel = starts == s
                    self._note_mismatch_locked(int(s), int(over_m[sel].sum()), int(under_m[sel].sum()))
        if over:
            findex = g.src[0] if g.src is not None else eng.flow_index
            flow_m = over_m & (dev_reason == E.BLOCK_FLOW)
            if flow_m.any():
                bad_slot = None
                if dev_slot_ok is not None:
                    bad_slot = (~dev_slot_ok[flow_m]).any(axis=0)
                clamped = False
                for j, (gid, _crow) in enumerate(g.slots):
                    if bad_slot is not None and (j >= bad_slot.shape[0] or not bad_slot[j]):
                        continue
                    info = findex.mirror_info(gid)
                    if info is not None and info[1] == C.FLOW_GRADE_QPS:
                        clamped = self.mirror.drain_bucket(info[0]) or clamped
                if clamped:
                    with self._lock:
                        self.counters["bucket_clamps"] += 1
            if (dev_reason[over_m] == E.BLOCK_PARAM).any():
                for pc in g.p_cols:
                    rows = np.unique(pc.prow[over_m & pc.valid & (dev_reason == E.BLOCK_PARAM)])
                    for prow in rows.tolist():
                        if prow >= 0:
                            self.mirror.drain_pbucket(int(prow))
            sys_over = over_m & (dev_reason == E.BLOCK_SYSTEM)
            if sys_over.any():
                from sentinel_tpu_torch.runtime.flush import SYS_QPS

                qps_dim = dev_sys_type is None or bool((dev_sys_type[sys_over] == SYS_QPS).any())
                if qps_dim and self.mirror.drain_sys_bucket():
                    with self._lock:
                        self.counters["bucket_clamps"] += 1
            eng._submit_gauge_comp(g.rows, over)
            with self._lock:
                self.counters["comp_plus"] += over
        if under:
            eng._submit_gauge_comp(g.rows, -under)
            with self._lock:
                self.counters["comp_minus"] += under
        if over or under:
            if eng.telemetry.enabled:
                eng.telemetry.note_spec_drift(over, under)
            rm = eng.resource_metrics
            if rm.enabled:
                ts = np.asarray(g.ts)
                if over:
                    rm.note_col(g.resource, ts[over_m], over=True)
                if under:
                    rm.note_col(g.resource, ts[under_m], under=True)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def on_rules_reloaded(self) -> None:
        """A reload swapped the indexes and rebuilt the dyn states: retire
        the rule-keyed mirrors."""
        if self.enabled:
            self.mirror.invalidate_rule_mirrors()

    def on_exit(self, resource: str, n: int = 1, rows=None, rt: int = 0, count: int = 0,
                now_ms: Optional[int] = None, min_rt: Optional[int] = None) -> None:
        """Synchronous host release at submit_exit: the live THREAD counter
        tracks real concurrency, not settle lag."""
        self.mirror.on_exit(resource, n, rows=rows, rt=rt, count=count, now_ms=now_ms, min_rt=min_rt)

    def reconcile_shaping(self, findex, latest, stored, lastfill) -> None:
        """Re-anchor the host pacer/ramp mirrors to the settled device
        columns a drain brought back."""
        self.mirror.reconcile_shaping(findex, latest, stored, lastfill)

    def reset(self) -> None:
        """Engine reset: fresh mirror world and drift accounting."""
        self.mirror.reset_world()
        with self._lock:
            self._win_start = -1
            self._win_over = 0
            self._win_under = 0
            self._suspended = False
            self._attr.clear()
            self._attr_newest = -1
            self._max_window_net = 0
            for k in self.counters:
                self.counters[k] = 0

    # ------------------------------------------------------------------
    # readers
    # ------------------------------------------------------------------
    @property
    def suspended(self) -> bool:
        with self._lock:
            return self._suspended

    @property
    def max_over_admit_window(self) -> int:
        """Worst per-window net over-admit, the open windows included."""
        with self._lock:
            return self._max_over_admit_locked()

    def _max_over_admit_locked(self) -> int:
        live = max((max(0, b[0] - b[1]) for b in self._attr.values()), default=0)
        return max(self._max_window_net, live)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "enabled": self.enabled,
                "flush_batch": self.flush_batch,
                "overadmit_max": self.overadmit_max,
                "window_ms": self.window_ms,
                "suspended": self._suspended,
                "window_over": self._win_over,
                "window_under": self._win_under,
                "open_attr_windows": len(self._attr),
                "max_over_admit_window": self._max_over_admit_locked(),
                "counters": dict(self.counters),
            }
        out["mirror"] = self.mirror.snapshot()
        return out
