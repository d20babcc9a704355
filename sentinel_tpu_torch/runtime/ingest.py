"""Engine ingest self-protection: bounded queues + deadline shedding
(port of ``sentinel_tpu/runtime/ingest.py``).

A stalled settle (a wedged device, a slow drain, a caller that never
flushes) would let the pending queues grow without bound while every
caller keeps paying submit cost for verdicts that can no longer arrive in
useful time. The valve keeps the SHED decision on the submit fast path,
a handful of int reads, so overload produces fast, distinct
``BLOCK_SHED`` verdicts instead of unbounded memory growth or
indefinite blocking.

Two independent triggers (either alone arms the valve):

* **queue bounds** — ``sentinel.tpu.ingest.max.pending`` caps queued
  single entry ops, ``…max.pending.bulk`` caps queued bulk rows. The
  counts are read without the engine lock (list-len reads are atomic
  under the GIL); under concurrency the bound is honored within the
  submit race width, which is exactly the slack a load-shedding bound
  tolerates by construction.
* **verdict deadline** — ``sentinel.tpu.ingest.deadline.ms`` sheds when
  the *estimated* time for a newly queued op to receive its settled
  verdict exceeds the deadline. The estimate is a settle-latency EWMA
  (fed by every synchronous fetch and coalesced drain, host clocks
  around the existing wait on the chunk's CUDA event) times the pipeline
  occupancy (in-flight dispatched-but-unfetched flushes + the flush this
  op will ride).

Exits and traces are NEVER shed: completions are the path by which
gauges drain and breakers observe recovery — shedding them would turn
overload into a permanent thread-gauge leak. Shed entries are never
enqueued anywhere; they are counted here and on the telemetry bus, and
the engine writes each a trace record, a block-log row and the provenance
ledger's shed column (``Engine._refused_entry``).

All keys default 0 = disarmed: one attribute read per submit.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from sentinel_tpu_torch.utils.config import config


class IngestValve:
    """Engine-scoped shed valve (one per Engine); see module doc."""

    # EWMA smoothing for the settle-latency estimate: heavy enough to
    # ride out one outlier fetch, light enough to track a regime change
    # within a few flushes.
    ALPHA = 0.25

    def __init__(self, engine) -> None:
        self._engine = engine
        self.max_pending = max(
            0, config.get_int(config.INGEST_MAX_PENDING, 0)
        )
        self.max_pending_bulk = max(
            0, config.get_int(config.INGEST_MAX_PENDING_BULK, 0)
        )
        self.deadline_ms = max(
            0, config.get_int(config.INGEST_DEADLINE_MS, 0)
        )
        self.armed = bool(
            self.max_pending or self.max_pending_bulk or self.deadline_ms
        )
        self._lock = threading.Lock()
        self._ewma_ms = 0.0
        self._forced_ms: Optional[float] = None  # test hook
        self.counters: Dict[str, int] = {
            "shed_entries": 0,
            "shed_rows": 0,
            "shed_queue": 0,
            "shed_deadline": 0,
            # Worker-side ring-full sheds from the multi-process plane
            # (ipc/plane.py folds them in): load shedding of THIS
            # engine's ingest (cause "ring").
            "shed_ring": 0,
        }

    # ------------------------------------------------------------------
    # signals (fed by the engine's settle paths; gated on `armed` at
    # the call sites so the disarmed hot path stays one attribute read)
    # ------------------------------------------------------------------
    def note_settle_ms(self, ms: float) -> None:
        """One observed settle latency (synchronous kernel fetch or a
        coalesced drain's share) folds into the EWMA."""
        with self._lock:
            if self._ewma_ms == 0.0:
                self._ewma_ms = ms
            else:
                self._ewma_ms += self.ALPHA * (ms - self._ewma_ms)

    def force_latency_ms(self, ms: Optional[float]) -> None:
        """Test hook: pin the settle-latency estimate (None unpins) —
        the deterministic analog of system_status.sampler.force."""
        with self._lock:
            self._forced_ms = ms

    def estimate_ms(self) -> float:
        """Estimated verdict latency for an op queued NOW: the settle
        EWMA times (in-flight flushes ahead of it + its own flush)."""
        with self._lock:
            ewma = self._forced_ms if self._forced_ms is not None else self._ewma_ms
        if ewma <= 0.0:
            return 0.0
        eng = self._engine
        with eng._pending_lock:
            inflight = len(eng._pending_fetches)
        return ewma * (inflight + 1)

    # ------------------------------------------------------------------
    # the valve (submit fast path)
    # ------------------------------------------------------------------
    def check_entry(self, n: int = 1) -> Optional[str]:
        """Shed cause ("queue"/"deadline") for ``n`` incoming single
        entries, or None to admit them into the queue. Unlocked count
        reads — see module doc."""
        eng = self._engine
        if self.max_pending and len(eng._entries) + n > self.max_pending:
            self._note_shed(n, 0, "queue")
            return "queue"
        if self.deadline_ms and self.estimate_ms() > self.deadline_ms:
            self._note_shed(n, 0, "deadline")
            return "deadline"
        return None

    def check_bulk(self, rows: int) -> Optional[str]:
        """Shed cause for one incoming bulk group of ``rows`` rows.
        Requests queued in the adapter-edge batch window (runtime/
        window.py) count toward the bound: they are bulk rows the
        engine has committed to but not yet submitted, so ignoring
        them would let the window defeat the cap."""
        eng = self._engine
        if (
            self.max_pending_bulk
            and eng._bulk_pending_n + eng.ingest_window.pending_n + rows
            > self.max_pending_bulk
        ):
            self._note_shed(0, rows, "queue")
            return "queue"
        if self.deadline_ms and self.estimate_ms() > self.deadline_ms:
            self._note_shed(0, rows, "deadline")
            return "deadline"
        return None

    def note_ipc_shed(self, n: int) -> None:
        """Fold ``n`` worker-side ring-full sheds (cause ``ring``) into
        the valve's accounting — reported by the ipc plane, which reads
        the workers' cumulative counts out of the control header. Not
        gated on ``armed``: the plane's ring bound is its own valve."""
        with self._lock:
            self.counters["shed_entries"] += n
            self.counters["shed_ring"] += n

    def _note_shed(self, entries: int, rows: int, cause: str) -> None:
        with self._lock:
            self.counters["shed_entries"] += entries
            self.counters["shed_rows"] += rows
            self.counters["shed_" + cause] += entries + rows
        tele = self._engine.telemetry
        if tele.enabled:
            tele.note_ingest_shed(entries + rows)
        cap = self._engine.capture
        if cap is not None:
            # The shed-streak freeze: a saturated engine is when the
            # capture journal matters most.
            cap.note_shed(entries + rows)

    # ------------------------------------------------------------------
    # lifecycle / readers
    # ------------------------------------------------------------------
    def reset(self) -> None:
        with self._lock:
            self._ewma_ms = 0.0
            self._forced_ms = None
            for k in self.counters:
                self.counters[k] = 0

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
            ewma = self._forced_ms if self._forced_ms is not None else self._ewma_ms
        return {
            "armed": self.armed,
            "max_pending": self.max_pending,
            "max_pending_bulk": self.max_pending_bulk,
            "deadline_ms": self.deadline_ms,
            "settle_ewma_ms": round(ewma, 3),
            "estimate_ms": round(self.estimate_ms(), 3) if self.armed else 0.0,
            "counters": counters,
        }
