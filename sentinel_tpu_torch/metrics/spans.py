"""Per-process fleet span journal — the cross-process half of tracing.

The flight recorder and the admission tracer are engine-scoped:
once the plane went multi-process (ipc workers, cluster token shards)
a single admission's life — worker window join, ring residency,
engine drain, shard RPC — spans three process types that none of the
existing machinery can see at once.

This module is the per-process leg: a bounded ring of wall-clock
spans with rolling jsonl spill. ``tools/fleetdump.py`` merges the
journals of every process in a run into ONE Perfetto trace, using the
correlation keys each span carries:

* ``wid``/``seq`` — the (worker_id, client seq) pair that crosses the
  shared-memory ring (ipc/frames.py puts seq columns on both request
  and verdict frames);
* ``trace`` — the W3C traceparent hex when the admission carried one;
* ``xid`` — the cluster wire's transaction id (client RPC span on one
  side, shard serve span on the other).

Clock model: every span stamps ``time.time()*1000`` — the SAME clock
the ipc ControlBlock's wall-ms ruler (header offset 32) publishes each
heartbeat, so worker and engine spans align without NTP: each spill
records the delta between the local clock and the last ruler beat the
process observed (``ruler_off_ms``), bounding skew to one heartbeat
cadence.

Disabled (the default) costs ONE bool read per call site: sites hold
the journal and check ``journal.enabled`` before stamping anything.
Verdicts are bit-identical either way — spans only observe.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from sentinel_tpu_torch.utils.config import SentinelConfig, config

# Size-rolled like the metric log: one live file + one .1 backup.
_SPILL_ROLL_BYTES = 16 * 1024 * 1024


def wall_ms() -> float:
    """The shared ruler clock: epoch wall time in milliseconds."""
    return time.time() * 1000.0


class SpanJournal:
    """Bounded per-process span ring with rolling jsonl spill.

    One journal per process (``get_journal``); every span source in
    the process — IngestClient, IngestPlane, ClusterTokenClient,
    SentinelTokenServer — appends here, tagged with its own ``cat``
    (worker / engine / client / shard) so fleetdump can build one
    track per stage even when stages share a process.
    """

    def __init__(
        self,
        role: str = "engine",
        enabled: Optional[bool] = None,
        ring: Optional[int] = None,
        spill_every: Optional[int] = None,
        base_dir: Optional[str] = None,
    ) -> None:
        self.role = role
        self.pid = os.getpid()
        self.enabled = (
            config.get_bool(SentinelConfig.SPANS_ENABLED)
            if enabled is None
            else enabled
        )
        cap = ring if ring is not None else config.get_int(SentinelConfig.SPANS_RING, 8192)
        self._ring = max(16, cap)
        self._spill_every = (
            spill_every
            if spill_every is not None
            else config.get_int(SentinelConfig.SPANS_SPILL_EVERY, 0)
        )
        self._base_dir = base_dir or config.get(SentinelConfig.SPANS_DIR) or None
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self._ring)
        self._since_spill = 0
        self._spilled_total = 0
        self._recorded_total = 0
        # Last control-header ruler beat this process observed, as
        # (ruler_wall_ms, local_wall_ms_at_read). Zero until the first
        # heartbeat crosses the ring.
        self._ruler = (0.0, 0.0)

    # ---- recording ---------------------------------------------------

    def record(self, name: str, cat: str, t0_ms: float, dur_ms: float, **fields: Any) -> None:
        """Append one finished span. Callers gate on ``self.enabled``
        BEFORE computing t0/dur so the disabled path stays one bool."""
        sp: Dict[str, Any] = {
            "name": name,
            "cat": cat,
            "t0": round(t0_ms, 3),
            "dur": round(max(0.0, dur_ms), 3),
        }
        for k, v in fields.items():
            if v is not None:
                sp[k] = v
        spill = False
        with self._lock:
            self._spans.append(sp)
            self._recorded_total += 1
            self._since_spill += 1
            if self._spill_every > 0 and self._since_spill >= self._spill_every:
                spill = True
        if spill:
            try:
                self.spill()
            except OSError:
                pass

    def note_ruler(self, ruler_wall_ms: float) -> None:
        """Record the latest control-header wall-ms beat (ipc worker
        and engine call this when they touch the header)."""
        self._ruler = (float(ruler_wall_ms), wall_ms())

    # ---- reading -----------------------------------------------------

    def spans(self, cat: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._spans)
        if cat is not None:
            out = [s for s in out if s.get("cat") == cat]
        return out

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "role": self.role,
                "pid": self.pid,
                "enabled": self.enabled,
                "ring": self._ring,
                "buffered": len(self._spans),
                "recorded_total": self._recorded_total,
                "spilled_total": self._spilled_total,
            }

    # ---- spill -------------------------------------------------------

    def _meta(self) -> Dict[str, Any]:
        ruler, at = self._ruler
        meta: Dict[str, Any] = {
            "meta": 1,
            "role": self.role,
            "pid": self.pid,
            "app": config.app_name,
            "wall_ms": round(wall_ms(), 3),
        }
        if ruler:
            # Local-clock minus ruler-clock at the moment the beat was
            # read: fleetdump subtracts this to land every process on
            # the ruler timeline.
            meta["ruler_off_ms"] = round(at - ruler, 3)
        return meta

    def spill_path(self) -> str:
        base = self._base_dir
        if not base:
            from sentinel_tpu_torch.utils.record_log import log_dir

            base = log_dir()
        os.makedirs(base, exist_ok=True)
        return os.path.join(
            base, f"{config.app_name}-spans-{self.role}-{self.pid}.jsonl"
        )

    def spill(self, path: Optional[str] = None) -> Optional[str]:
        """Drain the ring to the journal file (appending). Each spill
        batch starts with a meta line; fleetdump uses the LAST meta's
        ruler offset (freshest skew estimate). Returns the path, or
        None when there was nothing to write."""
        with self._lock:
            batch = list(self._spans)
            self._spans.clear()
            self._since_spill = 0
        if not batch:
            return None
        out = path or self.spill_path()
        self._roll_if_needed(out)
        with open(out, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(self._meta(), separators=(",", ":")) + "\n")
            for sp in batch:
                fh.write(json.dumps(sp, separators=(",", ":")) + "\n")
        with self._lock:
            self._spilled_total += len(batch)
        return out

    def _roll_if_needed(self, path: str) -> None:
        try:
            if os.path.getsize(path) < _SPILL_ROLL_BYTES:
                return
        except OSError:
            return
        try:
            os.replace(path, path + ".1")
        except OSError:
            pass


# ---- process-wide journal ------------------------------------------------

_journal: Optional[SpanJournal] = None
_journal_lock = threading.Lock()


def get_journal(role: str = "engine") -> SpanJournal:
    """The process-wide journal. The FIRST caller's role names the
    process (engine constructs before workers attach in-process, so
    worker processes pass role="worker" from IngestClient, shard
    server processes "shard" from SentinelTokenServer.start)."""
    global _journal
    j = _journal
    if j is not None:
        return j
    with _journal_lock:
        if _journal is None:
            _journal = SpanJournal(role=role)
        return _journal


def reset_journal() -> None:
    """Test hook: drop the singleton so the next get_journal re-reads
    config (enabled/ring/dir)."""
    global _journal
    with _journal_lock:
        _journal = None


def load_journal(path: str) -> Dict[str, Any]:
    """Parse one spilled journal file -> {"meta": ..., "spans": [...]}.
    Malformed tail lines are skipped (a crash mid-spill must not sink
    the whole fleet merge); the last meta line wins."""
    meta: Dict[str, Any] = {}
    spans: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if not isinstance(obj, dict):
                continue
            if obj.get("meta"):
                meta = obj
            elif "name" in obj and "t0" in obj:
                spans.append(obj)
    return {"meta": meta, "spans": spans}
