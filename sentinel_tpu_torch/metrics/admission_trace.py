"""Admission tracing: per-request verdict provenance and W3C trace context
(port of ``sentinel_tpu/metrics/admission_trace.py``).

* :class:`TraceContext`, :func:`parse_traceparent` and
  ``TraceContext.to_traceparent``: W3C trace-context
  (https://www.w3.org/TR/trace-context/) parse and render, for inbound
  extraction and outbound injection, so a block is attributable across
  service hops;
* :class:`AdmissionTracer`: an engine-scoped, bounded ring of
  :class:`AdmissionRecord` (trace and span ids, resource, origin, context
  name, the verdict's reason code, the deciding flush span's seq and the
  enqueue-to-verdict latency), fed by ``Engine._fill_results`` when the
  verdicts materialize, so the records are exact on the pipelined flush
  too;
* head sampling (one ``random()`` per submit, or the inbound
  traceparent's sampled flag as it is) and an always-sample-blocked mode:
  blocked verdicts are recorded whatever the head decision.

Hot-path contract: with ``sentinel.tpu.trace.enabled`` false the engine
pays one bool read per submit and one ``None`` check per op at fill; on,
an unsampled admitted op pays one ``perf_counter`` and one ``random()`` at
submit and nothing at fill. Ids are minted at record time, never for
unsampled traffic.

Config keys (all ``sentinel.tpu.trace.*``)::

    sentinel.tpu.trace.enabled         default true
    sentinel.tpu.trace.ring            record ring capacity, default 2048
    sentinel.tpu.trace.sample.rate     head sample probability, default 0.01
    sentinel.tpu.trace.sample.blocked  always record blocked, default true
    sentinel.tpu.trace.bulk.cap        rows recorded per bulk group per
                                       class (blocked / sampled), default 4
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from operator import itemgetter
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from sentinel_tpu_torch.core import errors as E
from sentinel_tpu_torch.core.context import ContextUtil
from sentinel_tpu_torch.metrics.histogram import LatencyHistogram
from sentinel_tpu_torch.utils.config import config

TRACEPARENT_HEADER = "traceparent"
TRACESTATE_HEADER = "tracestate"

_rand = random.Random()
_HEX = "0123456789abcdef"


def new_trace_id() -> str:
    """A random 32-hex-char (128-bit) nonzero W3C trace id."""
    return f"{_rand.getrandbits(128) or 1:032x}"


def new_span_id() -> str:
    """A random 16-hex-char (64-bit) nonzero W3C span id."""
    return f"{_rand.getrandbits(64) or 1:016x}"


def _is_hex(s: str) -> bool:
    return bool(s) and all(c in _HEX for c in s)


@dataclass(frozen=True, slots=True)
class TraceContext:
    """One hop's W3C trace identity: the trace id, the CURRENT span id
    (the parent of any span created under it), the sampled flag, and
    the opaque ``tracestate`` passed through unmodified (the spec's
    vendor list — this library neither reads nor edits it)."""

    trace_id: str
    span_id: str
    sampled: bool = True
    tracestate: str = ""

    def child(self) -> "TraceContext":
        """A child hop: same trace, fresh span id, decision inherited —
        what outbound injection writes on the wire."""
        return TraceContext(self.trace_id, new_span_id(), self.sampled,
                            self.tracestate)

    def to_traceparent(self) -> str:
        return (
            f"00-{self.trace_id}-{self.span_id}-"
            f"{'01' if self.sampled else '00'}"
        )


def parse_traceparent(
    value: Optional[str], tracestate: str = ""
) -> Optional[TraceContext]:
    """Parse a W3C ``traceparent`` header; None on anything invalid
    (the spec says a receiver that cannot parse MUST restart the trace
    — returning None lets the caller do exactly that). Future versions
    (``version != 00``) are accepted as long as the four base fields
    parse, per the spec's forward-compatibility rule; version ``ff``
    is explicitly invalid."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or not _is_hex(version) or version == "ff":
        return None
    if version == "00" and len(parts) != 4:
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id) or trace_id == "0" * 32:
        return None
    if len(span_id) != 16 or not _is_hex(span_id) or span_id == "0" * 16:
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    return TraceContext(
        trace_id=trace_id,
        span_id=span_id,
        sampled=bool(int(flags, 16) & 0x01),
        tracestate=tracestate or "",
    )


def inject_trace_headers(headers, parent: Optional[TraceContext] = None):
    """Outbound W3C injection: write ``traceparent`` (and
    ``tracestate``) for a CHILD span of the ambient trace (or an
    explicit ``parent``) into a mutable header mapping. No ambient
    trace → no-op returning None: outbound guards never mint trace ids
    for untraced calls (the head decision belongs to the inbound edge).
    Returns the injected child context."""
    tc = parent if parent is not None else ContextUtil.get_trace()
    if tc is None:
        return None
    child = tc.child()
    headers[TRACEPARENT_HEADER] = child.to_traceparent()
    if child.tracestate:
        headers[TRACESTATE_HEADER] = child.tracestate
    return child


class TraceTag(NamedTuple):
    """The per-op submit-time stamp (``_EntryOp.trace`` /
    ``BulkOp.trace``): the inbound parent (if any), the head sampling
    decision, and the enqueue ``perf_counter``. Ids are minted at
    record time, so an unsampled tag allocates nothing but this tuple."""

    parent: Optional[TraceContext]
    sampled: bool
    t0: float


# A tag's fields by position, for reads of a chunk's tags without a Python
# frame a tag.
_SAMPLED, _T0 = itemgetter(1), itemgetter(2)


@dataclass(slots=True)
class AdmissionRecord:
    """One sampled admission's verdict provenance."""

    trace_id: str
    span_id: str
    parent_span_id: str  # inbound hop's span id ("" when trace-rooted)
    resource: str
    origin: str
    context_name: str
    admitted: bool
    reason: int  # errors.PASS / BLOCK_*
    reason_name: str  # shared errors.BLOCK_EXC_NAMES spelling; "" = pass
    flush_seq: int  # deciding FlushSpan.flush_id (-1: telemetry off)
    t0: float  # perf_counter at enqueue
    latency_ms: float  # enqueue -> verdict materialized
    head_sampled: bool  # False = recorded by the always-blocked mode
    # Verdict provenance: decided by the host fallback admitter while
    # the engine was DEGRADED (reason BLOCK_FAILOVER for policy sheds;
    # degraded ADMITS keep reason PASS but carry this mark).
    degraded: bool = False
    # Tier provenance: "device" (settled on-device, the default),
    # "degraded" (host fallback, device lost), or "speculative" (host
    # fast tier — runtime/speculative.py; the speculative→settled
    # story: ``flush_seq`` names the settling flush and
    # ``settled_match`` whether the device agreed; None = never
    # settled, e.g. quarantined by a device fault).
    provenance: str = "device"
    settled_match: Optional[bool] = None

    def as_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "resource": self.resource,
            "origin": self.origin,
            "context_name": self.context_name,
            "admitted": self.admitted,
            "reason": self.reason,
            "reason_name": self.reason_name,
            "flush_seq": self.flush_seq,
            "latency_ms": round(self.latency_ms, 4),
            "head_sampled": self.head_sampled,
            "degraded": self.degraded,
            "provenance": self.provenance,
            "settled_match": self.settled_match,
        }


class BulkTraceGroups:
    """The bulk groups of one chunk to trace, as columns: one list a field,
    a group's entries at one index, so that a chunk of thousands of groups
    makes a few lists and no object a group. The verdicts are the groups'
    rows one after another (``admitted`` and ``reasons``, one array each,
    as the chunk's verdict columns hold them), ``lens`` rows a group."""

    __slots__ = ("tags", "resources", "origins", "context_names", "admitted", "reasons", "lens", "degraded",
                 "provenance", "settled_match")

    def __init__(self, tags: List[TraceTag], resources: List[str], origins: List[str], context_names: List[str],
                 admitted, reasons, lens, degraded: List[bool], provenance: List[str],
                 settled_match: Optional[List[Optional[bool]]] = None) -> None:
        self.tags, self.resources, self.origins, self.context_names = tags, resources, origins, context_names
        self.admitted, self.reasons, self.lens = admitted, reasons, lens
        self.degraded, self.provenance = degraded, provenance
        self.settled_match = [None] * len(tags) if settled_match is None else settled_match

    def __len__(self) -> int:
        return len(self.tags)

    def select(self, idx: List[int]) -> "BulkTraceGroups":
        """The groups at ``idx``, in that order, without their verdicts."""
        def pick(col):
            return [col[i] for i in idx]

        return BulkTraceGroups(pick(self.tags), pick(self.resources), pick(self.origins), pick(self.context_names),
                               None, None, None, pick(self.degraded), pick(self.provenance), pick(self.settled_match))


class _BulkRecords:
    """One chunk's bulk trace records as columns, in record order: each
    record's group (``gi`` into ``groups``), verdict, reason, latency and
    random id words. The ring's oldest ``skip`` of them have left it."""

    __slots__ = ("groups", "gi", "admitted", "reason", "rooted", "words", "off", "latency", "flush_seq", "skip")

    def __init__(self, groups: BulkTraceGroups, gi, admitted, reason, rooted, words, off, latency,
                 flush_seq: int) -> None:
        self.groups, self.gi, self.admitted, self.reason = groups, gi, admitted, reason
        self.rooted, self.words, self.off, self.latency = rooted, words, off, latency
        self.flush_seq = flush_seq
        self.skip = 0

    def __len__(self) -> int:
        return self.gi.size - self.skip

    def _id(self, at: int, n: int) -> str:
        return f"{int.from_bytes(self.words[at:at + n].tobytes(), 'little') or 1:0{8 * n}x}"

    def trace_id(self, j: int) -> str:
        if self.rooted[j]:
            return self._id(int(self.off[j]), 4)
        return self.groups.tags[self.gi[j]].parent.trace_id

    def materialize(self, skip: int) -> List[AdmissionRecord]:
        g = self.groups
        out = []
        for j in range(skip, self.gi.size):
            i = int(self.gi[j])
            tag, degraded = g.tags[i], g.degraded[i]
            admitted, reason = bool(self.admitted[j]), int(self.reason[j])
            parent = tag.parent
            out.append(AdmissionRecord(
                trace_id=self.trace_id(j),
                span_id=self._id(int(self.off[j]) + (4 if self.rooted[j] else 0), 2),
                parent_span_id=parent.span_id if parent is not None else "",
                resource=g.resources[i], origin=g.origins[i], context_name=g.context_names[i], admitted=admitted,
                reason=reason, reason_name="" if admitted else E.exc_name_for_code(reason), flush_seq=self.flush_seq,
                t0=tag.t0, latency_ms=float(self.latency[j]), head_sampled=tag.sampled, degraded=degraded,
                provenance=g.provenance[i] or ("degraded" if degraded else "device"),
                settled_match=g.settled_match[i],
            ))
        return out


class AdmissionTracer:
    """Engine-scoped sampled admission-trace ring (one per
    Engine, like the TelemetryBus)."""

    def __init__(
        self,
        enabled: Optional[bool] = None,
        ring: Optional[int] = None,
        sample_rate: Optional[float] = None,
        sample_blocked: Optional[bool] = None,
        bulk_cap: Optional[int] = None,
    ) -> None:
        self.enabled = (
            config.get_bool(config.TRACE_ENABLED, True)
            if enabled is None
            else bool(enabled)
        )
        self.ring_size = max(
            1,
            ring if ring is not None else config.get_int(config.TRACE_RING, 2048),
        )
        rate = (
            sample_rate
            if sample_rate is not None
            else config.get_float(config.TRACE_SAMPLE_RATE, 0.01)
        )
        self.sample_rate = min(1.0, max(0.0, float(rate)))
        self.sample_blocked = (
            config.get_bool(config.TRACE_SAMPLE_BLOCKED, True)
            if sample_blocked is None
            else bool(sample_blocked)
        )
        self.bulk_cap = max(
            0,
            bulk_cap
            if bulk_cap is not None
            else config.get_int(config.TRACE_BULK_CAP, 4),
        )
        # The newest ``ring_size`` records: AdmissionRecords and chunks'
        # columns (_BulkRecords), ``_ring_n`` records in all.
        self._ring: "deque[AdmissionRecord | _BulkRecords]" = deque()
        self._ring_n = 0
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "recorded": 0,
            "head_sampled": 0,
            "blocked_sampled": 0,
        }
        # Tagged but neither head- nor blocked-sampled. Kept OUTSIDE
        # the lock: at the default 1% rate this bumps for ~99% of ops
        # on the verdict-fill hot path, and a diagnostic counter does
        # not justify a mutex acquisition per op (int += under the GIL
        # is close enough; exactness is not load-bearing).
        self._skipped = 0
        # Sampled admission enqueue→verdict latencies — the histogram
        # whose `_bucket` series carries the exemplars below, so
        # exemplar values and bucket counts measure the SAME quantity.
        self.hist_latency = LatencyHistogram()
        # Latest exemplar per latency bucket: idx -> (trace_id, ms).
        self._exemplars: Dict[int, Tuple[str, float]] = {}

    # ------------------------------------------------------------------
    # submit hot path
    # ------------------------------------------------------------------
    def make_tag(self) -> TraceTag:
        """The per-submit stamp. An inbound traceparent's sampled flag
        is the head decision (propagated, per W3C); trace-rooted
        admissions sample probabilistically."""
        parent = ContextUtil.get_trace()
        if parent is not None:
            sampled = parent.sampled
        else:
            r = self.sample_rate
            sampled = r >= 1.0 or (r > 0.0 and _rand.random() < r)
        return TraceTag(parent, sampled, time.perf_counter())

    # ------------------------------------------------------------------
    # verdict materialization (engine fill path)
    # ------------------------------------------------------------------
    def record_admission(
        self,
        tag: TraceTag,
        resource: str,
        origin: str,
        context_name: str,
        admitted: bool,
        reason: int,
        flush_seq: int,
        end_pc: float,
        degraded: bool = False,
        provenance: str = "",
        settled_match: Optional[bool] = None,
    ) -> Optional[AdmissionRecord]:
        """Record one settled admission if the tag (or the blocked
        override) selects it; returns the record or None."""
        if not (tag.sampled or (not admitted and self.sample_blocked)):
            self._skipped += 1
            return None
        if not provenance:
            provenance = "degraded" if degraded else "device"
        parent = tag.parent
        rec = AdmissionRecord(
            trace_id=parent.trace_id if parent is not None else new_trace_id(),
            span_id=new_span_id(),
            parent_span_id=parent.span_id if parent is not None else "",
            resource=resource,
            origin=origin,
            context_name=context_name,
            admitted=bool(admitted),
            reason=int(reason),
            reason_name="" if admitted else E.exc_name_for_code(reason),
            flush_seq=int(flush_seq),
            t0=tag.t0,
            latency_ms=max(0.0, (end_pc - tag.t0) * 1e3),
            head_sampled=tag.sampled,
            degraded=degraded,
            provenance=provenance,
            settled_match=settled_match,
        )
        self.hist_latency.record(rec.latency_ms)
        bucket = self.hist_latency.bucket_of(rec.latency_ms)
        with self._lock:
            self._push(rec, 1)
            self.counters["recorded"] += 1
            if tag.sampled:
                self.counters["head_sampled"] += 1
            else:
                self.counters["blocked_sampled"] += 1
            self._exemplars[bucket] = (rec.trace_id, rec.latency_ms)
        return rec

    def record_bulk(
        self,
        tag: TraceTag,
        resource: str,
        origin: str,
        context_name: str,
        admitted,
        reasons,
        flush_seq: int,
        end_pc: float,
        degraded: bool = False,
        provenance: str = "",
        settled_match: Optional[bool] = None,
    ) -> None:
        """Bounded per-row records for one bulk group: up to
        ``bulk_cap`` blocked rows (always-blocked mode) plus, when the
        group's head tag sampled, up to ``bulk_cap`` admitted rows —
        never a full walk of the group. Bulk rows have no per-request
        inbound identity, so each record is trace-rooted unless the
        SUBMITTING call carried one (then all rows share its trace)."""
        self.record_bulk_groups(
            BulkTraceGroups([tag], [resource], [origin], [context_name], np.asarray(admitted, dtype=bool),
                            np.asarray(reasons), np.array([len(admitted)]), [degraded], [provenance], [settled_match]),
            flush_seq, end_pc,
        )

    def record_bulk_groups(self, groups: BulkTraceGroups, flush_seq: int, end_pc: float) -> None:
        """:meth:`record_bulk` for the bulk groups of one chunk, in their
        order: the records a group at a time would give, in that order,
        with one pass over the chunk's rows.

        The records enter the ring as columns (:class:`_BulkRecords`) and
        become :class:`AdmissionRecord` objects when the ring is read, so a
        chunk costs the same whatever share of its records the ring keeps.
        The counters, the histogram, the exemplars and the ids' random
        draws are those of a record at a time."""
        cap = self.bulk_cap
        ng = len(groups)
        if cap <= 0 or ng == 0:
            return
        lens, adm, rsn = groups.lens, groups.admitted, groups.reasons
        gidx = np.repeat(np.arange(ng), lens)
        starts = np.cumsum(lens) - lens
        sampled = np.fromiter(map(_SAMPLED, groups.tags), dtype=bool, count=ng)

        def first(mask: np.ndarray, want: np.ndarray) -> np.ndarray:
            # The first ``cap`` rows of ``mask`` in each group that wants them.
            csum = np.cumsum(mask)
            before = csum[starts] - mask[starts]
            return np.flatnonzero(mask & (csum - before[gidx] <= cap) & want[gidx])

        rows_b = first(~adm, sampled | self.sample_blocked)
        rows_a = first(adm, sampled)
        rows = np.concatenate([rows_b, rows_a])
        kind = np.concatenate([np.zeros(rows_b.size, np.int8), np.ones(rows_a.size, np.int8)])
        rows = rows[np.lexsort((rows, kind, gidx[rows]))]
        if rows.size == 0:
            return
        used, gi = np.unique(gidx[rows], return_inverse=True)
        kept = groups.select(used.tolist())
        rooted = np.array([t.parent is None for t in kept.tags], dtype=bool)[gi]
        # A record draws a trace id (4 words) unless it has a parent, then a
        # span id (2 words): one getrandbits call yields the same words in
        # the same order, lowest first.
        n_words = np.where(rooted, 6, 2)
        total = int(n_words.sum())
        words = np.frombuffer(_rand.getrandbits(32 * total).to_bytes(4 * total, "little"), dtype="<u4")
        t0 = np.fromiter(map(_T0, kept.tags), dtype=np.float64, count=used.size)
        lat = np.maximum(0.0, (end_pc - t0) * 1e3)[gi]
        batch = _BulkRecords(kept, gi, adm[rows], rsn[rows], rooted, words, np.cumsum(n_words) - n_words, lat,
                             int(flush_seq))
        bucket = self.hist_latency.record_each(lat)
        # The exemplar of each latency bucket is its last record.
        _, first_at = np.unique(bucket, return_index=True)
        _, last_rev = np.unique(bucket[::-1], return_index=True)
        exemplars = [(int(bucket[f]), rows.size - 1 - int(lr)) for f, lr in sorted(zip(first_at, last_rev))]
        exemplars = [(b, (batch.trace_id(j), float(lat[j]))) for b, j in exemplars]
        n_head = int(sampled[used][gi].sum())
        with self._lock:
            self._push(batch, rows.size)
            self.counters["recorded"] += rows.size
            self.counters["head_sampled"] += n_head
            self.counters["blocked_sampled"] += rows.size - n_head
            for b, ex in exemplars:
                self._exemplars[b] = ex

    def _push(self, item, n: int) -> None:
        """Append ``n`` records (one record, or a chunk's columns) to the
        ring and drop its oldest beyond ``ring_size``. Under the lock."""
        ring = self._ring
        ring.append(item)
        self._ring_n += n
        while self._ring_n > self.ring_size:
            head = ring[0]
            excess = self._ring_n - self.ring_size
            if isinstance(head, _BulkRecords) and len(head) > excess:
                head.skip += excess
                self._ring_n -= excess
            else:
                ring.popleft()
                self._ring_n -= len(head) if isinstance(head, _BulkRecords) else 1

    # ------------------------------------------------------------------
    # readers
    # ------------------------------------------------------------------
    def records(
        self,
        n: Optional[int] = None,
        resource: Optional[str] = None,
        reason: Optional[int] = None,
    ) -> List[AdmissionRecord]:
        """Ring snapshot, oldest first, optionally filtered by resource
        and/or reason code; ``n`` keeps only the newest n AFTER the
        filters (the ``traces`` command's semantics)."""
        with self._lock:
            items = [(it, it.skip) if isinstance(it, _BulkRecords) else (it, 0) for it in self._ring]
        out: List[AdmissionRecord] = []
        for it, skip in items:
            if isinstance(it, _BulkRecords):
                out.extend(it.materialize(skip))
            else:
                out.append(it)
        if resource is not None:
            out = [r for r in out if r.resource == resource]
        if reason is not None:
            out = [r for r in out if r.reason == reason]
        if n is not None and n > 0:
            out = out[-n:]
        return out

    def counters_snapshot(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.counters)
        out["skipped"] = self._skipped
        return out

    def exemplars(self) -> Dict[int, Tuple[str, float]]:
        """Latest (trace_id, latency_ms) exemplar per ``hist_latency``
        bucket — the OpenMetrics exemplar payload for
        ``transport/prometheus.py``."""
        with self._lock:
            return dict(self._exemplars)

    def snapshot(self) -> dict:
        """Config + counters view for the ``traces`` command."""
        return {
            "enabled": self.enabled,
            "ring_size": self.ring_size,
            "sample_rate": self.sample_rate,
            "sample_blocked": self.sample_blocked,
            "bulk_cap": self.bulk_cap,
            "counters": self.counters_snapshot(),
            "latency_ms": self.hist_latency.summary(),
        }

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._ring_n = 0
            self._exemplars.clear()
            for k in self.counters:
                self.counters[k] = 0
        self._skipped = 0
        self.hist_latency.reset()
