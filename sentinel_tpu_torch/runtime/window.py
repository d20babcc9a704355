"""Adapter-edge batch window: columnar admission for per-request servers
(port of ``sentinel_tpu/runtime/window.py``).

A per-request caller feeds the engine one op at a time through
``entry_sync``: a full submit + flush round trip of host Python per
request. The batch window coalesces concurrent in-flight requests into
per-``(resource, context, origin, entry_type)`` groups and rides each
group through :meth:`Engine.submit_bulk` as ONE columnar op (per-request
``ts``/``acquire`` columns, args as
:class:`~sentinel_tpu_torch.rules.param_table.ArgsColumns`), then fans
the array verdicts back out per request. One flush decides the whole
window.

Contract highlights (held against the JAX package by tests/test_torch_window.py):

* **Off by default** — ``sentinel.tpu.ingest.batch.window.ms`` = 0
  keeps today's per-request behavior exactly (the adapters fall back to
  ``api.entry``/``entry_async``; this module is never constructed hot).
* **Verdict parity** — batched-window verdicts are bit-identical
  (admitted/reason/wait_ms) to the sequential per-request path at any
  pipeline depth: each request keeps its own submit-time ``ts``, and
  the kernel's bulk admission is differential-pinned against the
  sequential oracle. Rule classes ``submit_bulk`` declines (cluster
  mode, THREAD-grade param rules, collection values) fall back to
  per-request ``submit_entry`` ops riding the same flush.
* **Speculative fast path preserved** — when the speculative tier is
  on, ``submit_bulk``'s immediate host verdicts fan out without
  waiting for the settling flush (``Verdict.speculative`` rides each
  request's verdict), exactly like ``entry_sync``.
* **Shed before assembly** — the ingest valve runs at window JOIN time
  (a shed request never occupies a window slot), queued window contents
  count toward ``sentinel.tpu.ingest.max.pending.bulk`` (see
  :meth:`IngestValve.check_bulk`), and a whole window can still shed at
  flush if the bulk queue filled meanwhile (the dense
  ``BLOCK_SHED`` arrays fan out per request). Exits never ride the
  window at all.
* **Per-request trace identity** — the admission-trace stamp is taken
  on the caller's thread at join (:attr:`WindowRequest.tag`), where the
  inbound traceparent is ambient, and each request's record is written
  at fan-out; the group tag ``submit_bulk`` stamps is dropped.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from sentinel_tpu_torch.utils.config import config


class WindowRequest:
    """One request's slot in a batch window (the fan-out target)."""

    __slots__ = (
        "resource", "context_name", "origin", "acquire", "entry_type",
        "args", "ts", "tag", "event", "future", "loop",
        "verdict", "rows", "pass_through", "error",
        "param_rows", "cluster_tokens", "bulk_exit",
        "abandoned", "released",
    )

    def __init__(
        self, resource, context_name, origin, acquire, entry_type, args,
        ts, tag,
    ) -> None:
        self.resource = resource
        self.context_name = context_name
        self.origin = origin
        self.acquire = acquire
        self.entry_type = entry_type
        self.args = args
        self.ts = ts
        self.tag = tag  # the admission trace's TraceTag (caller-thread stamp)
        self.event: Optional[threading.Event] = None  # shared per window
        self.future = None  # asyncio future (async callers)
        self.loop = None
        self.verdict = None
        self.rows: Tuple[int, int, int, int] = (-1, -1, -1, -1)
        self.pass_through = False
        self.error: Optional[BaseException] = None
        # Per-request exit bookkeeping the Entry needs: per-value
        # THREAD rows / held cluster tokens exist only on the singles
        # fallback path; bulk-fanned entries may batch their exits
        # columnar through the window (bulk_exit).
        self.param_rows: tuple = ()
        self.cluster_tokens: list = []
        self.bulk_exit = False
        # Caller cancelled while awaiting the verdict (asyncio task
        # cancellation on client disconnect): an ADMITTED abandoned
        # request must be auto-exited or its concurrency-gauge charge
        # leaks forever. ``released`` is the run-once claim, taken
        # under the window lock by whichever side (fan-out or the
        # cancel handler) sees both facts first.
        self.abandoned = False
        self.released = False


class _OpenWindow:
    """The currently assembling window: requests + one shared wake."""

    __slots__ = ("reqs", "event", "loops", "deadline")

    def __init__(self, deadline: float) -> None:
        self.reqs: List[WindowRequest] = []
        self.event = threading.Event()
        # loop -> [futures]: one call_soon_threadsafe per loop at
        # fan-out, not one per request.
        self.loops: Dict[object, list] = {}
        self.deadline = deadline


class BatchWindow:
    """Engine-scoped batch window (one per :class:`Engine`).

    Hot-path contract: ``armed`` False (the default) costs one
    attribute read at each adapter helper; no thread is ever started
    and :attr:`pending_n` stays 0 (the valve's read is free)."""

    def __init__(self, engine) -> None:
        self._engine = engine
        self.window_ms = max(
            0.0, config.get_float(config.INGEST_BATCH_WINDOW_MS, 0.0)
        )
        self.batch_max = max(1, config.get_int(config.INGEST_BATCH_MAX, 256))
        self.armed = self.window_ms > 0.0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._open: Optional[_OpenWindow] = None
        self._ready: List[_OpenWindow] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        # Columnar exit batching: windowed entries' completions buffer
        # here ((rows, resource, ts, rt, count, err, speculative)
        # tuples) and drain as ONE submit_exit_bulk group per
        # (rows, resource) at the next window flush — the exit-side
        # twin of the entry window (256 single _ExitOps per flush were
        # a measurable share of the window flush cost).
        self._exit_buf: List[tuple] = []
        # Lock-free count of window-queued requests (list-len/int reads
        # are atomic under the GIL) — the ingest valve adds this to the
        # engine's bulk-pending count so queued window contents are
        # bounded by sentinel.tpu.ingest.max.pending.bulk.
        self.pending_n = 0
        self.counters: Dict[str, int] = {"reqs": 0, "flushes": 0}
        # Dispatch->fan-out latency EWMA (ms): the extra wait a request
        # pays beyond the assembly window itself — the latency-pressure
        # signal the autotuner's window controller reads
        # (runtime/autotune.py). Single writer (the flusher thread);
        # float reads are atomic under the GIL.
        self.fanout_ms = 0.0

    # ------------------------------------------------------------------
    # join (request threads / tasks)
    # ------------------------------------------------------------------
    def join(self, req: WindowRequest, loop=None) -> WindowRequest:
        """Add one request to the assembling window. Sync callers then
        block on ``req.event``; async callers pass their running
        ``loop`` and await ``req.future`` instead."""
        with self._cond:
            if self._stop:
                raise RuntimeError("BatchWindow is closed")
            if self._thread is None:
                self._start_locked()
            w = self._open
            if w is None:
                w = self._open = _OpenWindow(
                    time.monotonic() + self.window_ms / 1e3
                )
                self._cond.notify_all()
            req.event = w.event
            if loop is not None:
                req.loop = loop
                req.future = loop.create_future()
                w.loops.setdefault(loop, []).append(req.future)
            w.reqs.append(req)
            self.pending_n += 1
            self.counters["reqs"] += 1
            if len(w.reqs) >= self.batch_max:
                self._open = None
                self._ready.append(w)
                self._cond.notify_all()
        return req

    # ------------------------------------------------------------------
    # flusher thread
    # ------------------------------------------------------------------
    def _start_locked(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="sentinel-ingest-window", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        # The flusher thread launches device work: it enters the engine's
        # device and stream, as the auto-flusher does.
        with self._engine._thread_context():
            self._run_loop()

    def _run_loop(self) -> None:
        # Dispatched-but-not-fanned-out windows (the window-level
        # software pipeline): under backlog — more windows already
        # assembled — fan-out of window N defers until N+1 has
        # dispatched, so the device works on N while the host encodes
        # N+1 (bounded by the engine's pipeline depth; empty-backlog
        # windows fan out immediately, so idle latency never pays).
        inflight: List[Tuple[_OpenWindow, list, float]] = []
        while True:
            stop = False
            with self._cond:
                while True:
                    if self._ready:
                        w = self._ready.pop(0)
                        break
                    if self._stop:
                        w = self._open
                        self._open = None
                        stop = w is None
                        break
                    if inflight:
                        # Never sleep on deferred fan-outs: drain them
                        # before waiting for the next window.
                        w = None
                        break
                    if self._open is not None:
                        timeout = self._open.deadline - time.monotonic()
                        if timeout <= 0:
                            w = self._open
                            self._open = None
                            break
                        self._cond.wait(timeout)
                    else:
                        if self._exit_buf:
                            w = None
                            break
                        self._cond.wait()
                backlog = bool(self._ready)
            if w is not None:
                t0 = time.monotonic()
                inflight.append((w, self._dispatch_window(w), t0))
            else:
                self._drain_exits_guarded()
            max_defer = (
                self._engine._pipeline_depth if backlog and w is not None
                else 0
            )
            while len(inflight) > max_defer:
                wf, settled, t0 = inflight.pop(0)
                self._fan_out_window(wf, settled)
                ms = (time.monotonic() - t0) * 1e3
                self.fanout_ms = (
                    ms if self.fanout_ms == 0.0
                    else self.fanout_ms + 0.25 * (ms - self.fanout_ms)
                )
            if stop:
                return

    # ------------------------------------------------------------------
    # the columnar flush
    # ------------------------------------------------------------------
    def _dispatch_window(self, w: _OpenWindow) -> list:
        """Group → submit_bulk → flush dispatch. Returns the settled
        group list for :meth:`_fan_out_window`; on a device error the
        window's waiters are poisoned here (fan-out then just wakes)."""
        eng = self._engine
        reqs = w.reqs
        with self._cond:
            # Under the lock: join()'s += and this -= are both
            # read-modify-writes — an unlocked decrement racing a
            # locked increment would permanently drift the count the
            # ingest valve reads.
            self.pending_n -= len(reqs)
        self.counters["flushes"] += 1
        settled: List[Tuple[List[WindowRequest], object, bool]] = []
        try:
            tele = eng.telemetry
            if tele.enabled:
                tele.note_window(len(reqs))
            self._drain_exits()
            groups: Dict[tuple, List[WindowRequest]] = {}
            for r in reqs:
                groups.setdefault(
                    (r.resource, r.context_name, r.origin, r.entry_type), []
                ).append(r)
            all_spec = True
            for (res, ctx, origin, etype), grp in groups.items():
                op, is_bulk = self._submit_group(res, ctx, origin, etype, grp)
                settled.append((grp, op, is_bulk))
                if is_bulk:
                    spec = op is not None and op.spec_admitted is not None
                else:
                    spec = False
                all_spec = all_spec and (op is None or spec)
            if all_spec and eng.speculative.enabled:
                # Every group got immediate host verdicts: the groups
                # still ride the flush for settlement on the
                # speculative tier's own cadence (entry_sync parity).
                eng._spec_maybe_settle()
            elif eng.has_pending():
                # At pipeline depth > 0 this dispatches WITHOUT the
                # fetch — the fan-out's array reads materialize it.
                eng.flush()
        except BaseException as exc:  # device error: poison every waiter
            for r in reqs:
                if r.verdict is None and r.error is None:
                    r.error = exc
        return settled

    def _fan_out_window(self, w: _OpenWindow, settled: list) -> None:
        """Materialize verdict arrays and wake every waiter — always,
        even when materialization itself fails (the error re-raises
        from each caller, like a failed sync flush). The abandoned
        requests' auto-exits are queued before the wake, so a survivor
        that exits and flushes finds them in the exit buffer; a failed
        release still wakes the waiters."""
        try:
            for grp, op, is_bulk in settled:
                if is_bulk:
                    self._fan_out_bulk(grp, op)
                else:
                    self._fan_out_entries(grp, op)
        except BaseException as exc:
            for r in w.reqs:
                if r.verdict is None and r.error is None:
                    r.error = exc
        finally:
            try:
                for r in w.reqs:
                    if r.abandoned:
                        self.release_abandoned(r)
            finally:
                self._wake(w)

    def release_abandoned(self, r: WindowRequest) -> None:
        """Run-once auto-exit for a request whose caller cancelled
        while waiting: an admitted slot with no Entry to exit it would
        leak the concurrency gauge on every client disconnect. Called
        by BOTH the fan-out (verdict just landed, abandon flag seen)
        and the cancel handler (abandon just flagged, verdict already
        there) — the claim under the window lock makes it exactly
        once."""
        v = r.verdict
        if v is None or not v.admitted or r.pass_through:
            return
        with self._cond:
            if r.released:
                return
            r.released = True
        try:
            if r.param_rows or r.cluster_tokens:
                # Singles-fallback bookkeeping: the full per-request
                # exit (releases per-value THREAD rows; cluster tokens
                # release separately below).
                self._engine.submit_exit(
                    r.rows, rt=0, count=r.acquire, err=0,
                    resource=r.resource, param_rows=r.param_rows,
                    speculative=v.speculative or v.degraded,
                )
                if r.cluster_tokens:
                    from sentinel_tpu_torch.runtime.engine import (
                        release_cluster_tokens,
                    )

                    release_cluster_tokens(r.cluster_tokens)
                    r.cluster_tokens = []
            else:
                self.note_exit(
                    r.rows, r.resource, 0, r.acquire, 0,
                    v.speculative or v.degraded,
                )
        except BaseException:
            from sentinel_tpu_torch.utils.record_log import record_log

            record_log.error(
                "[BatchWindow] abandoned-entry release failed",
                exc_info=True,
            )

    def _submit_group(self, resource, context_name, origin, entry_type, grp):
        """One group's columnar submit; returns ``(op, is_bulk)``.
        ``is_bulk`` False means the per-request fallback ran (rule
        classes submit_bulk declines) and ``op`` is the list of
        per-request _EntryOps."""
        eng = self._engine
        n = len(grp)
        ts_col = np.fromiter((r.ts for r in grp), dtype=np.int32, count=n)
        acq_col = np.fromiter(
            (r.acquire for r in grp), dtype=np.int32, count=n
        )
        args_column = None
        if any(r.args for r in grp):
            from sentinel_tpu_torch.rules.param_table import ArgsColumns

            width = max(len(r.args) for r in grp)
            args_column = ArgsColumns(
                n,
                {
                    i: [
                        r.args[i] if i < len(r.args) else None for r in grp
                    ]
                    for i in range(width)
                },
            )
        try:
            op = eng.submit_bulk(
                resource, n, ts=ts_col, acquire=acq_col,
                context_name=context_name, origin=origin,
                entry_type=entry_type, args_column=args_column,
            )
        except ValueError:
            # Cluster-mode rules / THREAD-grade param rules / collection
            # values: per-request semantics are load-bearing there
            # (per-entry expansion, held concurrency tokens) — ride the
            # same flush as individual ops instead. submit_many (not a
            # submit_entry loop) so a QPS-grade cluster group resolves
            # its token verdicts with ONE batched RPC per window
            # instead of one round trip per request.
            ops = eng.submit_many([
                {
                    "resource": r.resource,
                    "context_name": r.context_name,
                    "origin": r.origin,
                    "acquire": r.acquire,
                    "entry_type": r.entry_type,
                    "ts": r.ts,
                    "args": r.args,
                }
                for r in grp
            ])
            return ops, False
        if op is not None:
            # Per-request trace identity: the window records per request
            # at fan-out instead of bounded group rows at fill.
            op.trace = None
        return op, True

    def _fan_out_bulk(self, grp: List[WindowRequest], op) -> None:
        from sentinel_tpu_torch.runtime.engine import Verdict
        from sentinel_tpu_torch.core import errors as E

        if op is None:
            # Over the resource cap (or the global switch off): the
            # whole group passes through unchecked, like submit_entry
            # returning None.
            for r in grp:
                r.pass_through = True
                r.verdict = Verdict(True, E.PASS, 0, None)
            return
        pend = op._pending
        flush_seq = pend._seq if pend is not None else -1
        spec = op.spec_admitted is not None
        adm = op.admitted  # materializes a pending fetch if needed
        # tolist() once per column: per-row numpy scalar indexing costs
        # ~3x a list read at fan-out sizes.
        adm_l = adm.tolist()
        rsn_l = op.reason.tolist()
        wait_l = op.wait_ms.tolist()
        rows = op.rows
        degraded = bool(op.spec_degraded) if spec else False
        for i, r in enumerate(grp):
            r.rows = rows
            r.bulk_exit = True
            r.verdict = Verdict(
                admitted=adm_l[i],
                reason=rsn_l[i],
                wait_ms=wait_l[i],
                blocked_rule=None,
                speculative=spec,
                degraded=degraded,
            )
        self._record_traces(grp, flush_seq, "speculative" if spec else "")

    def _fan_out_entries(self, grp: List[WindowRequest], ops) -> None:
        from sentinel_tpu_torch.runtime.engine import Verdict
        from sentinel_tpu_torch.core import errors as E

        for r, op in zip(grp, ops):
            if op is None:
                r.pass_through = True
                r.verdict = Verdict(True, E.PASS, 0, None)
                continue
            r.rows = op.rows
            r.param_rows = tuple(op.param_thread_rows)
            r.cluster_tokens = list(op.cluster_tokens)
            r.verdict = op.verdict  # materializes; full singles verdict
        # Singles carry their own records: submit_entry stamped op.trace on
        # the flusher thread, so the window writes none for them.

    def _record_traces(self, grp: List[WindowRequest], flush_seq: int, provenance: str) -> None:
        tracer = self._engine.admission_trace
        if not tracer.enabled:
            return
        end_pc = time.perf_counter()
        for r in grp:
            if r.tag is None or r.verdict is None:
                continue
            tracer.record_admission(
                r.tag, r.resource, r.origin, r.context_name,
                r.verdict.admitted, r.verdict.reason, flush_seq, end_pc,
                degraded=r.verdict.degraded, provenance=provenance,
            )
            r.tag = None

    # ------------------------------------------------------------------
    # columnar exit batching (the Entry._exit_sink target)
    # ------------------------------------------------------------------
    def note_exit(
        self, rows, resource, rt, count, err, speculative
    ) -> None:
        """One windowed entry's completion, buffered for the next
        window flush's grouped ``submit_exit_bulk`` ride. Falls back to
        a direct single exit when the flusher is not running (engine
        closing / window never started) — a completion must never
        strand in a buffer nobody drains."""
        eng = self._engine
        ts = eng.clock.now_ms()
        with self._cond:
            if self._thread is not None and not self._stop:
                self._exit_buf.append(
                    (rows, resource, ts, rt, count, err, speculative)
                )
                if self._open is None and not self._ready:
                    self._cond.notify_all()
                return
        eng.submit_exit(rows, rt=rt, count=count, err=err,
                        resource=resource, speculative=speculative)

    def _drain_exits_guarded(self) -> None:
        """The flusher's idle-path drain: an exit-submit error (device
        fault with failover off, flush-on-size inside submit_exit_bulk)
        must never kill the flusher thread — a dead flusher strands
        every windowed request forever. Errors are logged; the exits
        that raised are lost to the engine exactly like a failed sync
        submit would be."""
        try:
            self._drain_exits()
        except BaseException:
            from sentinel_tpu_torch.utils.record_log import record_log

            record_log.error(
                "[BatchWindow] exit drain failed", exc_info=True
            )

    def _drain_exits(self) -> None:
        """Buffered completions → one submit_exit_bulk per
        (rows, resource, speculative) group."""
        with self._cond:
            buf, self._exit_buf = self._exit_buf, []
        if not buf:
            return
        eng = self._engine
        groups: Dict[tuple, list] = {}
        for item in buf:
            groups.setdefault((item[0], item[1], item[6]), []).append(item)
        for (rows, resource, spec), items in groups.items():
            n = len(items)
            eng.submit_exit_bulk(
                rows, n,
                ts=np.fromiter((i[2] for i in items), np.int64, n),
                rt=np.fromiter((i[3] for i in items), np.int64, n),
                count=np.fromiter((i[4] for i in items), np.int64, n),
                err=np.fromiter((i[5] for i in items), np.int64, n),
                resource=resource,
                speculative=spec,
            )

    def _wake(self, w: _OpenWindow) -> None:
        w.event.set()
        for loop, futs in w.loops.items():
            try:
                loop.call_soon_threadsafe(_finish_futures, futs)
            except RuntimeError:
                pass  # loop already closed; its waiters are gone

    # ------------------------------------------------------------------
    # lifecycle / readers
    # ------------------------------------------------------------------
    def retune(
        self,
        window_ms: Optional[float] = None,
        batch_max: Optional[int] = None,
    ) -> None:
        """Runtime window-geometry change (the autotuner's apply hook).
        ``window_ms`` takes effect from the NEXT window — the currently
        assembling window keeps the deadline it promised its joined
        requests. ``batch_max`` applies immediately (join() reads it
        live for the early-flush check); a raise lets the assembling
        window keep filling, a cut flushes it at the next join — both
        bounded by the unchanged deadline either way. A zero/negative
        ``window_ms`` is refused: arming/disarming the window is a
        config decision, not a tuning one."""
        with self._cond:
            if window_ms is not None and window_ms > 0.0:
                self.window_ms = float(window_ms)
            if batch_max is not None and batch_max >= 1:
                self.batch_max = int(batch_max)

    def close(self, join_timeout_s: float = 5.0) -> None:
        """Flush anything assembling and stop the flusher. Waiters of
        the final window are served, not stranded."""
        with self._cond:
            t = self._thread
            self._stop = True
            self._cond.notify_all()
        if t is not None:
            t.join(join_timeout_s)
            if t.is_alive():
                self._engine.closed_dirty = True
        with self._cond:
            self._thread = None
            self._stop = False
        # Completions that raced the shutdown still reach the engine.
        self._drain_exits()

    def snapshot(self) -> dict:
        return {
            "armed": self.armed,
            "window_ms": self.window_ms,
            "batch_max": self.batch_max,
            "pending": self.pending_n,
            "reqs": self.counters["reqs"],
            "flushes": self.counters["flushes"],
            "fanout_ms": round(self.fanout_ms, 3),
        }


def _finish_futures(futs) -> None:
    for f in futs:
        if not f.done():
            f.set_result(None)
