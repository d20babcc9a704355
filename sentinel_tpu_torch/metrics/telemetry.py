"""Engine flight recorder: per-flush spans, histograms, blocked sketch
(port of ``sentinel_tpu/metrics/telemetry.py``).

* a bounded ring of structured per-flush spans (:class:`FlushSpan`):
  flush id, pipeline depth and in-flight occupancy at dispatch, batch
  rows, encode/dispatch/settle wall-ms, arena and intern-cache hit/miss
  deltas, coalesced-fetch fallbacks. ``Engine._run_chunk`` records them;
  nothing at all is recorded when disabled
  (``sentinel.tpu.telemetry.enabled``);
* fixed-bucket latency histograms (metrics/histogram.py) for the
  host-blocking flush time, the coalesced drain fetches and the
  end-to-end admission (dispatch start to verdicts filled);
* a host space-saving top-K summary of blocked weight per resource, fed
  by the per-flush top-K the verdict tail computes on the device and the
  chunk's one copy back already brings (no read of its own);
* per-second engine aggregates and a Chrome trace-event export
  (:func:`spans_to_trace`) for Perfetto.

Spans and the histograms read host clocks only (``time.perf_counter``):
no span adds a device synchronization.

The bus is engine-scoped (one per :class:`Engine`); the process-global
engine's bus is therefore the process view. Config keys::

    sentinel.tpu.telemetry.enabled      default true
    sentinel.tpu.telemetry.ring         span ring capacity, default 4096
    sentinel.tpu.telemetry.blocked.topk.k
                                        device blocked top-K per flush,
                                        default 8 (0 disables the fold);
                                        falls back to the historical
                                        sentinel.tpu.telemetry.sketch.k
    sentinel.tpu.telemetry.blocked.topk.capacity
                                        host summary capacity, default
                                        64; falls back to
                                        sentinel.tpu.telemetry.sketch.capacity
    sentinel.tpu.telemetry.topk.export  rows the exports list when the
                                        fold is off, default 10

The ``blocked.*`` spelling keeps the blocked-weight top-K and the
count-min statistics tier (runtime/sketch.py, ``sentinel.tpu.sketch.*``)
apart; ``TelemetryBus.sketch`` / ``sketch_k`` remain as deprecated read
aliases.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from sentinel_tpu_torch.metrics.histogram import LatencyHistogram
from sentinel_tpu_torch.utils.config import config


@dataclass(slots=True)
class FlushSpan:
    """One dispatched flush chunk's structured record. Mutable: the
    settle fields land later for a pipelined flush (the ring holds the
    reference, so readers see the update). Timestamps are
    ``time.perf_counter()`` seconds — monotonic, shared by every span
    in the process, which is all a trace needs."""

    flush_id: int
    t0: float  # perf_counter at encode start
    depth: int  # configured pipeline depth at dispatch
    inflight: int  # dispatched-but-unfetched flushes ahead of this one
    n_entries: int = 0  # single entry ops
    n_exits: int = 0  # single exit/trace ops
    n_bulk: int = 0  # bulk entry rows
    n_bulk_exits: int = 0  # bulk exit rows
    encode_ms: float = 0.0
    dispatch_ms: float = 0.0
    settle_t0: float = 0.0  # perf_counter when the result fetch began
    settle_end: float = 0.0  # perf_counter when verdicts materialized
    settle_ms: float = 0.0  # device→host fetch duration (own or coalesced share)
    deferred: bool = False  # dispatched without fetching (pipelined/async)
    settled: bool = False
    arena_hits: int = 0
    arena_misses: int = 0
    intern_hits: int = 0  # ParamIndex resolved-value cache delta since prev span
    intern_misses: int = 0
    fallbacks: int = 0  # coalesced-fetch failures this span rode through
    # Failover quarantined this flush: its device results were lost and
    # its verdicts came from the host fallback (runtime/failover.py).
    quarantined: bool = False
    # Autotune param-path cost attribution (runtime/autotune.py): the
    # shape bucket and path (PATH_CLOSED/PATH_SCAN) the cost memo
    # picked for this chunk's param batch — None/0 when autotune is off
    # or the chunk carried no eligible param batch. Internal to the
    # tuner; deliberately NOT part of as_dict().
    param_bucket: Optional[tuple] = None
    param_path: int = 0

    @property
    def rows(self) -> int:
        return self.n_entries + self.n_exits + self.n_bulk + self.n_bulk_exits

    @property
    def host_ms(self) -> float:
        """Host-blocking cost of this flush: encode + dispatch, plus
        the fetch when it was synchronous (a deferred settle overlaps
        the next flush's host work by design)."""
        ms = self.encode_ms + self.dispatch_ms
        if not self.deferred:
            ms += self.settle_ms
        return ms

    def as_dict(self) -> dict:
        return {
            "flush_id": self.flush_id,
            "t0": self.t0,
            "depth": self.depth,
            "inflight": self.inflight,
            "rows": self.rows,
            "n_entries": self.n_entries,
            "n_exits": self.n_exits,
            "n_bulk": self.n_bulk,
            "n_bulk_exits": self.n_bulk_exits,
            "encode_ms": round(self.encode_ms, 4),
            "dispatch_ms": round(self.dispatch_ms, 4),
            "settle_ms": round(self.settle_ms, 4),
            "deferred": self.deferred,
            "settled": self.settled,
            "arena_hits": self.arena_hits,
            "arena_misses": self.arena_misses,
            "intern_hits": self.intern_hits,
            "intern_misses": self.intern_misses,
            "fallbacks": self.fallbacks,
            "quarantined": self.quarantined,
        }


class SpaceSaving:
    """Bounded heavy-hitter summary (Metwally et al.'s space-saving, the
    merge target for the kernel's per-flush top-K). ``counts[key]`` is
    an overestimate by at most ``error[key]`` — the guarantee the
    differential test exercises: any key whose true weight exceeds the
    minimum counter is present."""

    __slots__ = ("capacity", "_counts", "_error", "_lock")

    def __init__(self, capacity: int = 64) -> None:
        self.capacity = max(1, int(capacity))
        self._counts: Dict[str, int] = {}
        self._error: Dict[str, int] = {}
        self._lock = threading.Lock()

    def offer(self, key: str, weight: int = 1) -> None:
        if weight <= 0:
            return
        with self._lock:
            c = self._counts.get(key)
            if c is not None:
                self._counts[key] = c + weight
                return
            if len(self._counts) < self.capacity:
                self._counts[key] = weight
                self._error[key] = 0
                return
            victim = min(self._counts, key=self._counts.__getitem__)
            floor = self._counts.pop(victim)
            self._error.pop(victim, None)
            self._counts[key] = floor + weight
            self._error[key] = floor

    def topk(self, k: int = 10) -> List[Tuple[str, int, int]]:
        """[(key, count, max_overestimate)] sorted by count desc."""
        with self._lock:
            items = sorted(
                self._counts.items(), key=lambda kv: kv[1], reverse=True
            )[: max(0, int(k))]
            return [(key, cnt, self._error.get(key, 0)) for key, cnt in items]

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._error.clear()


class TelemetryBus:
    """Engine-scoped telemetry: span ring + histograms + counters +
    blocked-resource sketch + per-second aggregates.

    Hot-path contract: when ``enabled`` is False the engine makes no
    calls here at all (one attribute read per flush); when True, a
    flush costs one dataclass build, one deque append and a few
    histogram records — microseconds against a multi-ms flush."""

    def __init__(
        self,
        enabled: Optional[bool] = None,
        ring: Optional[int] = None,
        sketch_k: Optional[int] = None,
        sketch_capacity: Optional[int] = None,
    ) -> None:
        self.enabled = (
            config.get_bool(config.TELEMETRY_ENABLED, True)
            if enabled is None
            else bool(enabled)
        )
        self.ring_size = max(
            1,
            ring
            if ring is not None
            else config.get_int(config.TELEMETRY_RING, 4096),
        )
        # Blocked-weight top-K fold size — NOT the statistics
        # sketch tier (sentinel.tpu.sketch.*, runtime/sketch.py). The
        # ``blocked.topk.k`` spelling is preferred; the historical
        # ``telemetry.sketch.k`` key is the fallback when unset.
        if sketch_k is not None:
            k = sketch_k
        else:
            k = config.get_int(config.TELEMETRY_BLOCKED_TOPK_K, -1)
            if k < 0:
                k = config.get_int(config.TELEMETRY_SKETCH_K, 8)
        self.blocked_topk_k = max(0, k)
        self._spans: "deque[FlushSpan]" = deque(maxlen=self.ring_size)
        self._lock = threading.Lock()
        self._next_id = 0
        self.hist_flush = LatencyHistogram()
        self.hist_drain = LatencyHistogram()
        self.hist_e2e = LatencyHistogram()
        # Per-drift-window over-admit counts of the speculative tier —
        # the distribution the differential bound is stated over (a
        # count histogram riding the same pow2-bucket machinery).
        self.hist_spec_drift = LatencyHistogram()
        self.counters: Dict[str, int] = {
            "flushes": 0,
            "ops": 0,
            "deferred_flushes": 0,
            "coalesced_fallbacks": 0,
            "arena_hits": 0,
            "arena_misses": 0,
            # Failure domain (runtime/failover.py): host-fallback
            # verdicts served while DEGRADED, health transitions, and
            # recovery probe flushes.
            "degraded_admits": 0,
            "degraded_blocks": 0,
            "health_transitions": 0,
            "probe_flushes": 0,
            # Speculative tier (runtime/speculative.py): fast-path
            # verdicts served, declines (device-only semantics or the
            # drift valve), reconciliation mismatches by direction, and
            # valve suspensions.
            "spec_admits": 0,
            "spec_blocks": 0,
            "spec_declined": 0,
            "spec_over_admits": 0,
            "spec_under_admits": 0,
            "spec_suspensions": 0,
            # Fast-tier coverage: shaped ops served
            # host-side and host system-gate blocks.
            "spec_shaped": 0,
            "spec_system_blocks": 0,
            # Ingest valve (runtime/ingest.py): ops shed at submit.
            "ingest_shed": 0,
            # Adapter-edge batch window (runtime/window.py): requests
            # coalesced into columnar windows, and windows flushed.
            "ingest_window_reqs": 0,
            "ingest_window_flushes": 0,
            # Statistics sketch tier (runtime/sketch.py): distinct keys
            # folded per chunk, heavy-hitter promotions/demotions, and
            # DEGRADED host-mirror folds.
            "sketch_keys": 0,
            "sketch_promotions": 0,
            "sketch_demotions": 0,
            "sketch_host_folds": 0,
            # Param admission path selection (Engine._encode_param):
            # batches routed to the closed-form rank path vs the
            # rounds/scan family — one count per encoded param batch.
            "param_closed_form": 0,
            "param_scan": 0,
            # Self-tuning control plane (runtime/autotune.py): applied
            # knob changes (depth / window retunes).
            "autotune_decisions": 0,
            # Sketch-tier cold-key admission ceiling
            # (sentinel.tpu.sketch.cold.qps): submits blocked from the
            # host count-min twin's estimate.
            "sketch_cold_blocks": 0,
            # Multi-process ingest plane (ipc/plane.py): request
            # frames drained / rows
            # carried, worker-side ring-full sheds folded in, dead-worker
            # reaps with their auto-exited live admissions.
            "ipc_frames": 0,
            "ipc_requests": 0,
            "ipc_sheds": 0,
            "ipc_worker_deaths": 0,
            "ipc_auto_exits": 0,
            # Engine hot-restart: workers that detected the
            # boot-epoch bump and re-asserted their live ledgers into
            # this (new) engine world.
            "ipc_worker_reconnects": 0,
            # Cluster token plane: milliseconds actually slept
            # honoring SHOULD_WAIT verdicts (bounded per op batch by
            # sentinel.tpu.cluster.wait.cap.ms — the pre-cap path slept
            # per op back-to-back, unbounded).
            "cluster_wait_ms": 0,
            # The capture journal (runtime/capture.py): chunks
            # and frame records spilled, bytes written, segment
            # rollovers, postmortem freezes, and bulk rows whose args
            # column could not be serialized (those rows replay
            # without args).
            "capture_chunks": 0,
            "capture_records": 0,
            "capture_bytes": 0,
            "capture_rollovers": 0,
            "capture_freezes": 0,
            "capture_args_dropped": 0,
        }
        # Bounded ring of health transitions (now_ms is engine-clock
        # relative ms): the flight-recorder view of the failover state
        # machine — the authoritative copy (with counters) lives on
        # FailoverManager; this one rides telemetry snapshots.
        self.health_events: "deque[Tuple[int, str, str, str]]" = deque(
            maxlen=64
        )
        if sketch_capacity is not None:
            cap = sketch_capacity
        else:
            cap = config.get_int(config.TELEMETRY_BLOCKED_TOPK_CAP, -1)
            if cap < 0:
                cap = config.get_int(config.TELEMETRY_SKETCH_CAP, 64)
        self.blocked_sketch = SpaceSaving(cap)
        # Most recent flush's device top-K, already name-resolved:
        # [(resource, blocked_weight)] — the "what is being throttled
        # right now" read, no extra host round-trip.
        self.last_blocked_topk: List[Tuple[str, int]] = []
        # Engine-clock-relative per-second aggregates for the metric
        # log: sec -> [flushes, ops, host_ms_sum]. Bounded: the timer
        # drains it every second; a stopped timer must not leak, so
        # inserts evict the oldest past _SEC_CAP.
        self._sec: Dict[int, List[float]] = {}
        self._SEC_CAP = 600

    # ------------------------------------------------------------------
    # naming-compat aliases: ``sketch``/``sketch_k`` predate the
    # statistics sketch tier — the blocked-weight fold lives under its
    # own name so the two planes stay distinguishable.
    # ------------------------------------------------------------------
    @property
    def sketch(self) -> SpaceSaving:
        """Deprecated alias of :attr:`blocked_sketch`."""
        return self.blocked_sketch

    @property
    def sketch_k(self) -> int:
        """Deprecated alias of :attr:`blocked_topk_k`."""
        return self.blocked_topk_k

    @property
    def export_topk_k(self) -> int:
        """How many blocked-top-K rows the exports list — the ONE home
        of the former hand-rolled ``sketch_k or 10`` (Prometheus, the
        ``telemetry`` command, and the sketch tier's candidate listing
        all read this)."""
        return self.blocked_topk_k or config.get_int(
            config.TELEMETRY_TOPK_EXPORT, 10
        )

    # ------------------------------------------------------------------
    # span lifecycle (engine hot path)
    # ------------------------------------------------------------------
    def begin_span(
        self,
        t0: float,
        depth: int,
        inflight: int,
        n_entries: int,
        n_exits: int,
        n_bulk: int,
        n_bulk_exits: int,
        deferred: bool,
        now_rel_ms: int,
    ) -> FlushSpan:
        with self._lock:
            fid = self._next_id
            self._next_id += 1
            span = FlushSpan(
                flush_id=fid, t0=t0, depth=depth, inflight=inflight,
                n_entries=n_entries, n_exits=n_exits, n_bulk=n_bulk,
                n_bulk_exits=n_bulk_exits, deferred=deferred,
            )
            self._spans.append(span)
            self.counters["flushes"] += 1
            if deferred:
                self.counters["deferred_flushes"] += 1
            self.counters["ops"] += span.rows
            sec = (now_rel_ms // 1000) * 1000
            agg = self._sec.get(sec)
            if agg is None:
                if len(self._sec) >= self._SEC_CAP:
                    self._sec.pop(min(self._sec), None)
                agg = self._sec[sec] = [0.0, 0.0, 0.0]
            agg[0] += 1
            agg[1] += span.rows
        return span

    def dispatch_done(self, span: FlushSpan) -> None:
        """Encode+dispatch times are on the span; record the deferred
        flush's host-blocking cost now (its settle overlaps later host
        work by design)."""
        if span.deferred:
            self.hist_flush.record(span.encode_ms + span.dispatch_ms)
            self._add_sec_host_ms(span.encode_ms + span.dispatch_ms)

    def settle(self, span: FlushSpan, settle_t0: float, end: float) -> None:
        """Verdicts materialized: close the span, record histograms."""
        span.settle_t0 = settle_t0
        span.settle_end = end
        span.settle_ms = max(0.0, (end - settle_t0) * 1e3)
        span.settled = True
        if not span.deferred:
            self.hist_flush.record(span.host_ms)
            self._add_sec_host_ms(span.host_ms)
        self.hist_e2e.record(max(0.0, (end - span.t0) * 1e3))

    def _add_sec_host_ms(self, ms: float) -> None:
        with self._lock:
            # Attribute to the newest live second — per-second host-ms
            # is a rate diagnostic, not an exact ledger.
            if self._sec:
                self._sec[max(self._sec)][2] += ms

    def note_drain(self, ms: float) -> None:
        self.hist_drain.record(ms)

    def note_fallback(self, n: int = 1) -> None:
        with self._lock:
            self.counters["coalesced_fallbacks"] += n

    def note_arena(self, hits: int, misses: int) -> None:
        with self._lock:
            self.counters["arena_hits"] += hits
            self.counters["arena_misses"] += misses

    def note_health(self, frm: str, to: str, reason: str,
                    now_ms: int = 0) -> None:
        """One failover state transition (span-mark analog: spans that
        settle as quarantined carry the per-flush view; this is the
        engine-level event stream)."""
        with self._lock:
            self.counters["health_transitions"] += 1
            self.health_events.append((now_ms, frm, to, reason))

    def note_degraded(self, admits: int, blocks: int) -> None:
        with self._lock:
            self.counters["degraded_admits"] += admits
            self.counters["degraded_blocks"] += blocks

    def note_probe(self) -> None:
        with self._lock:
            self.counters["probe_flushes"] += 1

    # ------------------------------------------------------------------
    # speculative tier (runtime/speculative.py)
    # ------------------------------------------------------------------
    def note_speculative(self, admits: int, blocks: int) -> None:
        with self._lock:
            self.counters["spec_admits"] += admits
            self.counters["spec_blocks"] += blocks

    def note_spec_declined(self, n: int = 1) -> None:
        with self._lock:
            self.counters["spec_declined"] += n

    def note_spec_drift(self, over: int, under: int) -> None:
        with self._lock:
            self.counters["spec_over_admits"] += over
            self.counters["spec_under_admits"] += under

    def note_spec_window(self, net_over: int) -> None:
        """One closed drift window: its NET excess-admit count joins
        the drift histogram (the bound is per window, so the histogram
        is per window too — raw per-direction mismatches ride the
        counters only)."""
        self.hist_spec_drift.record(float(net_over))

    def note_spec_suspended(self) -> None:
        with self._lock:
            self.counters["spec_suspensions"] += 1

    def note_spec_shaped(self, n: int = 1) -> None:
        with self._lock:
            self.counters["spec_shaped"] += n

    def note_spec_system_block(self, n: int = 1) -> None:
        with self._lock:
            self.counters["spec_system_blocks"] += n

    def note_ingest_shed(self, n: int = 1) -> None:
        with self._lock:
            self.counters["ingest_shed"] += n

    # ------------------------------------------------------------------
    # the capture journal (runtime/capture.py)
    # ------------------------------------------------------------------
    def note_capture(
        self, chunks: int, records: int, nbytes: int,
        rollovers: int = 0, args_dropped: int = 0,
    ) -> None:
        """One journal flush interval's deltas — the capture journal
        batches its counter publishes so the hot path stays at one
        attribute read plus the spill itself."""
        with self._lock:
            self.counters["capture_chunks"] += chunks
            self.counters["capture_records"] += records
            self.counters["capture_bytes"] += nbytes
            self.counters["capture_rollovers"] += rollovers
            self.counters["capture_args_dropped"] += args_dropped

    def note_capture_freeze(self, n: int = 1) -> None:
        with self._lock:
            self.counters["capture_freezes"] += n

    def note_window(self, reqs: int) -> None:
        """One adapter-edge batch window flushed with ``reqs`` coalesced
        requests (runtime/window.py)."""
        with self._lock:
            self.counters["ingest_window_reqs"] += reqs
            self.counters["ingest_window_flushes"] += 1

    # ------------------------------------------------------------------
    # statistics sketch tier (runtime/sketch.py)
    # ------------------------------------------------------------------
    def note_sketch_keys(self, n: int) -> None:
        with self._lock:
            self.counters["sketch_keys"] += n

    def note_sketch_promotion(self, n: int = 1) -> None:
        with self._lock:
            self.counters["sketch_promotions"] += n

    def note_sketch_demotion(self, n: int = 1) -> None:
        with self._lock:
            self.counters["sketch_demotions"] += n

    def note_sketch_host_fold(self, n: int = 1) -> None:
        with self._lock:
            self.counters["sketch_host_folds"] += n

    def note_param_path(self, closed: bool) -> None:
        """One encoded param batch routed to the closed-form rank path
        (``closed``) or the rounds/scan family."""
        with self._lock:
            self.counters[
                "param_closed_form" if closed else "param_scan"
            ] += 1

    def note_autotune_decision(self, n: int = 1) -> None:
        with self._lock:
            self.counters["autotune_decisions"] += n

    def note_cluster_wait(self, ms: int) -> None:
        """Milliseconds actually slept honoring cluster SHOULD_WAIT
        verdicts (already bounded by the per-op-batch cap)."""
        with self._lock:
            self.counters["cluster_wait_ms"] += ms

    def note_sketch_cold_block(self, n: int = 1) -> None:
        with self._lock:
            self.counters["sketch_cold_blocks"] += n

    # ------------------------------------------------------------------
    # multi-process ingest plane (ipc/plane.py)
    # ------------------------------------------------------------------
    def note_ipc_frames(self, frames: int, rows: int) -> None:
        with self._lock:
            self.counters["ipc_frames"] += frames
            self.counters["ipc_requests"] += rows

    def note_ipc_shed(self, n: int = 1) -> None:
        with self._lock:
            self.counters["ipc_sheds"] += n

    def note_ipc_worker_death(self, released: int) -> None:
        with self._lock:
            self.counters["ipc_worker_deaths"] += 1
            self.counters["ipc_auto_exits"] += released

    def note_ipc_reconnect(self) -> None:
        with self._lock:
            self.counters["ipc_worker_reconnects"] += 1

    def fold_blocked_topk(self, pairs: Sequence[Tuple[str, int]]) -> None:
        """Fold one flush's device top-K (already name-resolved) into
        the running space-saving summary."""
        for key, w in pairs:
            self.blocked_sketch.offer(key, w)
        self.last_blocked_topk = list(pairs)

    # ------------------------------------------------------------------
    # readers
    # ------------------------------------------------------------------
    def spans(self) -> List[FlushSpan]:
        with self._lock:
            return list(self._spans)

    def counters_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counters)

    def drain_second_aggregates(self, upto_rel_ms: int) -> List[Tuple[int, int, int, float]]:
        """Completed engine-clock seconds strictly before
        ``upto_rel_ms`` (second-aligned), removed from the bus:
        [(sec_rel_ms, flushes, ops, host_ms_sum)] ascending — the
        metric-log timer's pull."""
        out = []
        with self._lock:
            for sec in sorted(self._sec):
                if sec >= upto_rel_ms:
                    break
                f, o, ms = self._sec.pop(sec)
                out.append((sec, int(f), int(o), ms))
        return out

    def snapshot(self, engine=None) -> dict:
        """Everything the ``telemetry`` transport command serves."""
        out = {
            "enabled": self.enabled,
            "ring_size": self.ring_size,
            "spans_recorded": self._next_id,
            "counters": self.counters_snapshot(),
            "flush_ms": self.hist_flush.summary(),
            "drain_ms": self.hist_drain.summary(),
            "e2e_ms": self.hist_e2e.summary(),
            "spec_drift_per_window": self.hist_spec_drift.summary(),
            "blocked_topk": [
                {"resource": k, "weight": c, "max_error": e}
                for k, c, e in self.blocked_sketch.topk(self.export_topk_k)
            ],
            "last_flush_blocked_topk": [
                {"resource": k, "weight": w} for k, w in self.last_blocked_topk
            ],
            "recent_spans": [s.as_dict() for s in self.spans()[-16:]],
            "health_events": [
                {"now_ms": ms, "from": f, "to": t, "reason": r}
                for ms, f, t, r in list(self.health_events)
            ],
        }
        if engine is not None:
            out["pipeline"] = engine.pipeline_stats()
            out["pipeline_depth"] = engine.pipeline_depth
            out["last_flush_host_ms"] = engine.last_flush_host_ms
            spec = getattr(engine, "speculative", None)
            if spec is not None and spec.enabled:
                out["speculative"] = spec.snapshot()
            valve = getattr(engine, "ingest", None)
            if valve is not None and valve.armed:
                out["ingest"] = valve.snapshot()
            rm = getattr(engine, "resource_metrics", None)
            if rm is not None and rm.enabled:
                out["resource_metrics"] = rm.snapshot()
            pindex = getattr(engine, "param_index", None)
            if pindex is not None and hasattr(pindex, "cache_stats"):
                out["param_cache"] = pindex.cache_stats()
            tier = getattr(engine, "sketch", None)
            if tier is not None and tier.armed:
                out["sketch_tier"] = tier.snapshot()
            at = getattr(engine, "autotune", None)
            if at is not None and at.enabled:
                out["autotune"] = at.snapshot()
        return out

    def bench_summary(self) -> dict:
        """Compact summary for a benchmark's JSON line."""
        c = self.counters_snapshot()
        denom = c["arena_hits"] + c["arena_misses"]
        return {
            "flushes": c["flushes"],
            "ops": c["ops"],
            "flush_ms_p50": self.hist_flush.percentile(0.5),
            "flush_ms_p99": self.hist_flush.percentile(0.99),
            "e2e_ms_p50": self.hist_e2e.percentile(0.5),
            "e2e_ms_p99": self.hist_e2e.percentile(0.99),
            "drain_ms_p99": self.hist_drain.percentile(0.99),
            "arena_hit_rate": round(c["arena_hits"] / denom, 4) if denom else 0.0,
            "coalesced_fallbacks": c["coalesced_fallbacks"],
            "blocked_topk": [
                [k, c_] for k, c_, _ in self.blocked_sketch.topk(5)
            ],
        }


# ----------------------------------------------------------------------
# Chrome trace-event export (Perfetto-loadable)
# ----------------------------------------------------------------------
def spans_to_trace(
    spans: Sequence[FlushSpan], pid: int = 1, records: Sequence = None
) -> dict:
    """Convert flight-recorder spans to the Chrome trace-event JSON
    object format (Perfetto loads it directly). The emission mechanics
    and layout live in :func:`metrics.perfetto.spans_to_trace` — the
    shared home of trace-event building for tracedump / fleetdump /
    replay; this name stays as the stable import surface."""
    from sentinel_tpu_torch.metrics.perfetto import spans_to_trace as _impl

    return _impl(spans, pid=pid, records=records)
