"""Chrome trace-event (Perfetto) emission (port of
``sentinel_tpu/metrics/perfetto.py``).

The flight recorder's spans render as a timeline for ui.perfetto.dev
through :func:`spans_to_trace`; this module is the one home of the event
mechanics:

* :class:`TraceBuilder` — event list + emit-once ``process_name`` /
  ``thread_name`` metadata, ``X`` complete slices, ``i`` instants, and
  ``s``/``f`` flow-arrow pairs with the finish-timestamp clamp
  (Perfetto silently drops an arrow whose finish is earlier than its
  start; one ruler beat of residual cross-process skew can produce
  exactly that).
* :class:`SlotTracks` — greedy interval→track assignment for
  overlapping windows (depth-K in-flight fetches, concurrent sampled
  admissions): the first track whose last end precedes the new start
  is reused, optionally capped so a dump with thousands of concurrent
  intervals overflows onto the last track instead of exploding the
  track count.
* :func:`spans_to_trace` — the flight-recorder conversion itself
  (flush encode/dispatch/inflight + sampled-admission request tracks
  with decide arrows), which ``metrics/telemetry.py`` delegates to.

All timestamps are microseconds (trace-event convention); callers pick
their own time base.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

# (ts_us, pid, tid) — a flow-arrow endpoint.
Anchor = Tuple[float, int, int]


class TraceBuilder:
    """Accumulates trace events; ``build()`` wraps them in the JSON
    object format (``{"traceEvents": [...], "displayTimeUnit": "ms"}``)
    that Perfetto and chrome://tracing load directly."""

    def __init__(self) -> None:
        self.events: List[dict] = []
        self._pids: Dict[str, int] = {}
        self._tids: Dict[Tuple[int, str], int] = {}
        self._named_threads: set = set()
        self._next_pid = 1

    # -- metadata (emit-once) -------------------------------------------
    def process(self, name: str, pid: Optional[int] = None) -> int:
        """Register a Perfetto process; emits ``process_name`` metadata
        the first time a name is seen. Explicit ``pid`` (e.g. the real
        OS pid) wins; otherwise pids auto-increment."""
        if name in self._pids and pid is None:
            return self._pids[name]
        if pid is None:
            pid = self._next_pid
            self._next_pid += 1
        if self._pids.get(name) != pid:
            self._pids[name] = pid
            self.events.append({
                "name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": name},
            })
        return pid

    def thread(self, pid: int, name: str, tid: Optional[int] = None) -> int:
        """Register a thread track inside ``pid``; emits
        ``thread_name`` metadata once per (pid, tid)."""
        key = (pid, name)
        if tid is None:
            tid = self._tids.get(key)
            if tid is None:
                tid = len([k for k in self._tids if k[0] == pid]) + 1
        self._tids.setdefault(key, tid)
        if (pid, tid) not in self._named_threads:
            self._named_threads.add((pid, tid))
            self.events.append({
                "ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                "args": {"name": name},
            })
        return tid

    # -- events ----------------------------------------------------------
    def slice(
        self, pid: int, tid: int, name: str, ts: float, dur: float,
        cat: Optional[str] = None, args: Optional[dict] = None,
    ) -> None:
        ev: dict = {"ph": "X", "pid": pid, "tid": tid, "name": name,
                    "ts": ts, "dur": dur}
        if cat is not None:
            ev["cat"] = cat
        if args is not None:
            ev["args"] = args
        self.events.append(ev)

    def instant(
        self, pid: int, tid: int, name: str, ts: float,
        cat: Optional[str] = None, args: Optional[dict] = None,
    ) -> None:
        ev: dict = {"ph": "i", "pid": pid, "tid": tid, "name": name,
                    "ts": ts, "s": "t"}
        if cat is not None:
            ev["cat"] = cat
        if args is not None:
            ev["args"] = args
        self.events.append(ev)

    def flow(
        self, flow_id, name: str, src: Anchor, dst: Anchor,
        cat: Optional[str] = None,
    ) -> None:
        """One ``s``/``f`` arrow pair. The finish timestamp is clamped
        to ``max(dst.ts, src.ts)`` — Perfetto drops backwards arrows,
        and residual cross-process clock skew can put the target stamp
        marginally before the source's."""
        s_ts, s_pid, s_tid = src
        f_ts, f_pid, f_tid = dst
        base: dict = {"name": name, "id": flow_id}
        if cat is not None:
            base["cat"] = cat
        self.events.append({**base, "ph": "s", "pid": s_pid,
                            "tid": s_tid, "ts": s_ts})
        self.events.append({**base, "ph": "f", "bp": "e", "pid": f_pid,
                            "tid": f_tid, "ts": max(f_ts, s_ts)})

    def build(self) -> dict:
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}


class SlotTracks:
    """Greedy interval→slot assignment: ``assign(start, end)`` returns
    the first slot whose last end precedes ``start`` (epsilon for fp
    jitter), growing the slot set as needed — capped at ``max_tracks``
    when given (overflow shares the last slot)."""

    def __init__(self, max_tracks: Optional[int] = None, eps: float = 1e-3) -> None:
        self.ends: List[float] = []
        self.max_tracks = max_tracks
        self.eps = eps

    def assign(self, start: float, end: float) -> int:
        slot = None
        for i, e in enumerate(self.ends):
            if e <= start + self.eps:
                slot = i
                break
        if slot is None:
            if self.max_tracks is None or len(self.ends) < self.max_tracks:
                slot = len(self.ends)
                self.ends.append(0.0)
            else:
                slot = self.max_tracks - 1
        self.ends[slot] = max(self.ends[slot], end)
        return slot


# ----------------------------------------------------------------------
# flight-recorder conversion (the telemetry delegate)
# ----------------------------------------------------------------------
def spans_to_trace(
    spans: Sequence[Any], pid: int = 1, records: Sequence = None
) -> dict:
    """Convert flight-recorder spans (telemetry.FlushSpan) to the
    Chrome trace-event object format.

    Layout: every span's ``encode`` and ``dispatch`` slices go on tid 1
    (``host``) — flush dispatches are serialized under the engine's
    flush lock, so they never overlap. The dispatch→settle window of a
    deferred flush (``inflight``: device execution + fetch latency)
    goes on the first free ``inflight-N`` tid (greedy interval
    assignment), so a depth-K pipeline shows K parallel tracks whose
    slices overlap the NEXT flush's encode on the host track — the
    visual proof that host encode overlaps device execution.

    ``records`` (admission_trace.AdmissionRecord) adds ``requests-N``
    tracks: one slice per sampled admission spanning enqueue→verdict,
    plus a Perfetto flow arrow from the admission to the flush span
    that DECIDED it (matched on ``flush_seq``) — you can see a 429'd
    call, hover its trace id, and follow the arrow into the flush that
    produced the verdict.

    All ``ts``/``dur`` are µs relative to the earliest span/record."""
    spans = list(spans)
    records = list(records) if records else []
    if not spans and not records:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min([s.t0 for s in spans] + [r.t0 for r in records])

    def us(t: float) -> float:
        return (t - base) * 1e6

    tb = TraceBuilder()
    tb.thread(pid, "host", tid=1)
    inflight = SlotTracks()
    # flush_id -> a ts inside that span's dispatch slice (flow-arrow
    # anchor: a flow endpoint must land within a slice on its tid).
    dispatch_anchor: Dict[int, float] = {}
    for s in sorted(spans, key=lambda s: s.t0):
        enc_start = us(s.t0)
        enc_dur = s.encode_ms * 1e3
        disp_start = enc_start + enc_dur
        disp_dur = s.dispatch_ms * 1e3
        args = {
            "flush_id": s.flush_id, "rows": s.rows, "depth": s.depth,
            "inflight": s.inflight, "deferred": s.deferred,
        }
        tb.slice(pid, 1, "encode", enc_start, enc_dur, cat="flush", args=args)
        tb.slice(pid, 1, "dispatch", disp_start, disp_dur, cat="flush",
                 args=args)
        dispatch_anchor[s.flush_id] = disp_start + disp_dur * 0.5
        if s.settled and s.settle_end > s.t0:
            fly_start = disp_start + disp_dur
            fly_end = us(s.settle_end)
            fly_dur = max(fly_end - fly_start, 0.0)
            slot = inflight.assign(fly_start, fly_start + fly_dur)
            tid = tb.thread(pid, f"inflight-{slot}", tid=10 + slot)
            tb.slice(pid, tid, "inflight", fly_start, fly_dur,
                     cat="device", args=args)
    if records:
        # Concurrent admissions overlap in time (a whole chunk settles
        # together), so request slices get the same greedy slot-track
        # assignment as the inflight windows: tids 100+N, capped — a
        # dump with thousands of concurrent sampled requests overflows
        # onto the last track rather than exploding the track count.
        REQ_TID0, REQ_TRACKS_MAX = 100, 16
        req_tracks = SlotTracks(max_tracks=REQ_TRACKS_MAX)
        for i, r in enumerate(sorted(records, key=lambda r: r.t0)):
            req_start = us(r.t0)
            req_dur = max(r.latency_ms * 1e3, 1.0)
            slot = req_tracks.assign(req_start, req_start + req_dur)
            tid = tb.thread(pid, f"requests-{slot}", tid=REQ_TID0 + slot)
            tb.slice(pid, tid, r.resource, req_start, req_dur,
                     cat="admission", args={
                         "trace_id": r.trace_id, "span_id": r.span_id,
                         "admitted": r.admitted, "reason": r.reason,
                         "reason_name": r.reason_name,
                         "flush_seq": r.flush_seq,
                         "origin": r.origin,
                     })
            anchor = dispatch_anchor.get(r.flush_seq)
            if anchor is None or anchor < req_start:
                # No linkable flush span in the dump (telemetry off,
                # span evicted from the ring, or clock skew) — the
                # request slice still renders, just without an arrow.
                continue
            # Arrow: admission enqueue (request track) → deciding
            # flush's dispatch slice (tid 1). Chrome flows require
            # s.ts <= f.ts; an op is always enqueued before its flush
            # dispatches, and the start is clamped below the anchor in
            # case the dispatch followed within the nudge.
            tb.flow(
                i + 1, "decide",
                (min(req_start + min(req_dur * 0.25, 1.0), anchor), pid, tid),
                (anchor, pid, 1),
                cat="admission",
            )
    return tb.build()
