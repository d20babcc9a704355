"""IngestClient: the worker-process side of the multi-process plane.

A worker process speaks the same entry/exit/bulk surface the adapters
speak, but every decision is made by the ONE engine process: requests
encode into columnar frames on the shared-memory MPSC request ring,
verdicts come back on this worker's SPSC response ring. The client
holds no device state and takes no engine locks — it is pure encode +
wait, safe to call from many threads of a GIL-bound server process.

Failure stances (the worker half of the plane's failure matrix):

* **ring full** → a local ``BLOCK_SHED`` verdict with cause
  ``ipc_ring`` — never a stall. The shed count is published through
  the control header so the engine's IngestValve accounting sees it
  (backpressure stays observable fleet-side even though the decision
  was made here).
* **engine dead** (health word CLOSED, heartbeat stale past
  ``sentinel.tpu.ipc.engine.dead.ms``, or a verdict wait past
  ``...timeout.ms``) → verdicts come from the per-resource
  fail-open/closed failover policy snapshot the plane published into
  the control header, marked ``degraded`` — the same stance the
  in-process engine takes when the DEVICE dies (runtime/failover.py).
* **exits are never shed and never policy-served**: a completion is
  how gauges drain, so the client retries a full ring briefly and only
  drops a completion once the engine is provably gone (a dead engine
  has no gauges left to leak).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from struct import error as struct_error
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sentinel_tpu_torch.core import errors as E
from sentinel_tpu_torch.ipc import frames as fr
from sentinel_tpu_torch.ipc.ring import (
    HEALTH_CLOSED,
    HEALTH_HANDOFF,
    ControlBlock,
    ShmRing,
    _wall_ms,
    resolve_spin_us,
)
from sentinel_tpu_torch.metrics.spans import get_journal
from sentinel_tpu_torch.metrics.spans import wall_ms as _span_wall_ms
from sentinel_tpu_torch.utils.config import config


@dataclass
class PlaneChannel:
    """Everything a worker needs to attach: shared-memory segment names
    + geometry + the producer claim lock. Picklable through
    ``multiprocessing`` process spawning (the lock travels via mp's own
    reduction, so workers must be descendants of the plane's
    process)."""

    control_name: str
    request_name: str
    response_name: str  # THIS worker slot's SPSC response ring
    ring_slots: int
    slot_bytes: int
    resp_slots: int
    workers_max: int
    request_lock: object = field(repr=False, default=None)
    # Adaptive-wakeup doorbells (multiprocessing.Semaphore, travel like
    # the claim lock): None in "sleep" wakeup mode.
    request_doorbell: object = field(repr=False, default=None)
    response_doorbell: object = field(repr=False, default=None)


class _Waiter:
    __slots__ = ("event", "verdicts", "need")

    def __init__(self, need: int) -> None:
        self.event = threading.Event()
        self.verdicts: Dict[int, tuple] = {}
        self.need = need


def _byte_chunks(sizes: Sequence[int], budget: int, what: str) -> List[Tuple[int, int]]:
    """Greedy byte-budget chunking shared by ``bulk()`` and the
    micro-window flusher: ``[lo, hi)`` windows whose encoded rows fit
    one slot's frame budget. A single row over the budget is a
    config/caller mismatch, not backpressure — ValueError, never a
    shed."""
    chunks: List[Tuple[int, int]] = []
    lo = 0
    size = 0
    for j, rb in enumerate(sizes):
        if rb > budget:
            raise ValueError(
                f"{what}: row {j}'s encoded args ({rb}B) exceed the "
                f"frame budget ({budget}B) — raise "
                "sentinel.tpu.ipc.slot.bytes or shrink the args"
            )
        if size + rb > budget and j > lo:
            chunks.append((lo, j))
            lo = j
            size = 0
        size += rb
    if sizes:
        chunks.append((lo, len(sizes)))
    return chunks


class IngestClient:
    """One worker's connection to the plane (one per process; its
    methods are thread-safe)."""

    def __init__(
        self,
        channel: PlaneChannel,
        worker_id: int,
        heartbeat: bool = True,
    ) -> None:
        if not (0 <= worker_id < channel.workers_max):
            raise ValueError(
                f"worker_id {worker_id} out of range 0..{channel.workers_max - 1}"
            )
        self.worker_id = int(worker_id)
        self.channel = channel
        self.control = ControlBlock(
            channel.control_name, channel.workers_max
        )
        self.request = ShmRing(
            channel.request_name, channel.ring_slots, channel.slot_bytes,
            lock=channel.request_lock, doorbell=channel.request_doorbell,
        )
        self.response = ShmRing(
            channel.response_name, channel.resp_slots, channel.slot_bytes,
            doorbell=channel.response_doorbell,
        )
        self.heartbeat_ms = max(1, config.get_int(config.IPC_HEARTBEAT_MS, 100))
        self.engine_dead_ms = max(
            1, config.get_int(config.IPC_ENGINE_DEAD_MS, 1000)
        )
        self.timeout_ms = max(1, config.get_int(config.IPC_TIMEOUT_MS, 5000))
        # Death confirmation (sentinel.tpu.ipc.engine.dead.confirm.ms):
        # with confirm > 0 a stale wall clock alone does not declare the
        # engine dead — the worker opens a SUSPICION episode, rings the
        # request doorbell once (wakes a parked drainer) and probes the
        # published engine pid; a provably-alive engine gets up to
        # dead.ms + confirm.ms before the declaration lands, so
        # sub-second dead.ms on a pegged box has a measured
        # false-positive story instead of a flappy one. 0 (default) is
        # the plain wall-staleness predicate.
        self.dead_confirm_ms = max(
            0, config.get_int(config.IPC_ENGINE_DEAD_CONFIRM_MS, 0)
        )
        self.handoff_wait_ms = max(
            0, config.get_int(config.IPC_HANDOFF_WAIT_MS, 3000)
        )
        # Episode state has its OWN lock: engine_alive() runs under the
        # client lock on the window-flush path, so it must never take it.
        self._suspect_lock = threading.Lock()
        self._suspect_epoch = -1
        self._suspect_declared = False
        self._in_handoff = False
        # Adaptive wakeup (sentinel.tpu.ipc.wakeup=adaptive): the
        # reader spins briefly then parks on the response-ring doorbell
        # instead of the fixed 200 µs sleep-poll. Only meaningful when
        # the plane shipped a doorbell in the channel.
        wake = (config.get(config.IPC_WAKEUP) or "sleep").strip().lower()
        self.adaptive_wakeup = (
            wake == "adaptive" and channel.response_doorbell is not None
        )
        self._spin_s = resolve_spin_us(
            config.get_int(config.IPC_WAKEUP_SPIN_US, -1)
        ) / 1e6
        self._park_s = max(
            1, config.get_int(config.IPC_WAKEUP_PARK_MS, 5)
        ) / 1e3
        self._lock = threading.Lock()
        self._seq = 0
        # Per-connection intern table: each string crosses the boundary
        # exactly once per intern generation. _fresh buffers the
        # (id, bytes) records the NEXT frame must carry.
        self._intern: Dict[str, int] = {}
        self._fresh: List[Tuple[int, bytes]] = []
        self._intern_gen = self.control.intern_gen()
        self._next_id = 1
        self._waiters: Dict[int, _Waiter] = {}
        # Fleet span journal (metrics/spans.py): admission spans on
        # the control header's wall-ms ruler. Disabled (default) is
        # one bool read per call site.
        self._spans = get_journal("worker")
        self._shed_total = 0
        self.counters: Dict[str, int] = {
            "entries": 0, "bulk_rows": 0, "exits": 0, "exits_dropped": 0,
            "sheds": 0, "policy_served": 0, "frames": 0,
            "window_flushes": 0, "reconnects": 0, "exits_buffered": 0,
            "dead_suspicions": 0, "dead_false_alarms": 0,
            "dead_declared": 0, "handoff_holds": 0,
        }
        # Engine hot-restart reconnect (sentinel.tpu.ipc.reconnect.*):
        # the client keeps its OWN live-admission ledger — one line per
        # (identity, mirror-charged?, acquire) still running — so that
        # when the control header's boot epoch bumps (a NEW engine
        # attached to the same rings) it can re-assert exactly what is
        # live into the new world, and completions that could not be
        # delivered during the dead window buffer (bounded) for replay
        # instead of dropping. Off: no ledger writes,
        # dead-window completions drop, a returning engine starts cold.
        self.reconnect_enabled = config.get_bool(config.IPC_RECONNECT, True)
        self.reconnect_exits_max = max(
            0, config.get_int(config.IPC_RECONNECT_EXITS_MAX, 4096)
        )
        # (resource, context, origin, entry_type, spec_b, acquire) ->
        # live admitted count (engine-decided admits only — policy
        # verdicts never reached the engine and must not re-assert).
        # ``_live_new`` holds admits decided by a NEW engine boot before
        # our reconnect completed: the new plane ledgered those at
        # fan-out, so re-asserting them would double-charge the gauges —
        # they merge into ``_live`` once the reassert lands.
        self._live: Dict[tuple, int] = {}
        self._live_new: Dict[tuple, int] = {}
        self._dead_exits: List[tuple] = []
        self._boot = self.control.engine_boot()
        self._reassert_boot: Optional[int] = None
        self._reassert_rows: List[tuple] = []
        self._reassert_head = True
        self._stop = threading.Event()
        # Micro-window (sentinel.tpu.ipc.client.window.{ms,max}):
        # concurrent entry/bulk/exit calls coalesce into one columnar
        # frame per bounded window — the client-side twin of
        # runtime/window.py's BatchWindow. Off (window.ms=0, the
        # default) keeps per-call framing: no flusher
        # thread, no buffered state, the armed check is one bool read.
        self.window_ms = max(
            0.0, config.get_float(config.IPC_CLIENT_WINDOW_MS, 0.0)
        )
        self.window_max = max(
            1, config.get_int(config.IPC_CLIENT_WINDOW_MAX, 256)
        )
        self.window_armed = self.window_ms > 0.0
        self._win_cond = threading.Condition(self._lock)
        self._win_rows: List[fr.EntryRow] = []
        # Buffered completions as IDENTITY tuples, not encoded rows:
        # exits retry across failed pushes, and a retried payload must
        # re-intern (a failed push rolls its fresh interns back — see
        # exit()'s per-call loop, which rebuilds for the same reason).
        self._win_exits: List[tuple] = []
        # Seqs of windowed rows that came through bulk(): the flusher
        # counts pushed rows into entries vs bulk_rows at flush time,
        # and the waiter may already be gone (caller timeout) by then.
        self._win_bulk: set = set()
        self._win_deadline: Optional[float] = None
        self._win_exit_stall: Optional[float] = None
        self._win_thread: Optional[threading.Thread] = None
        if self.window_armed:
            self._win_thread = threading.Thread(
                target=self._win_loop, name=f"ipc-window-{worker_id}",
                daemon=True,
            )
            self._win_thread.start()
        self._reader = threading.Thread(
            target=self._read_loop, name=f"ipc-reader-{worker_id}", daemon=True
        )
        self._reader.start()
        self._beat: Optional[threading.Thread] = None
        if heartbeat:
            self._beat = threading.Thread(
                target=self._beat_loop, name=f"ipc-beat-{worker_id}",
                daemon=True,
            )
            self._beat.start()
        self.control.beat_worker(self.worker_id, os.getpid())

    # ------------------------------------------------------------------
    # interning
    # ------------------------------------------------------------------
    def _intern_rollback_locked(self, interns: List[Tuple[int, bytes]]) -> None:
        """A frame carrying fresh intern records failed to push: FORGET
        those strings instead of re-queuing the records. A re-queued
        backlog grows without bound under sustained shed (and can push
        every future frame past the slot size — a permanent 100%-shed
        wedge); forgetting just means the string re-interns under a
        NEW id on its next use, which costs one duplicate crossing and
        nothing else (ids are monotonic, never reused for a different
        string, so the plane-side table stays consistent)."""
        for _iid, raw in interns:
            self._intern.pop(raw.decode("utf-8", "surrogatepass"), None)

    def _push_locked(self, encode) -> bool:
        """Encode + push one frame under the client lock. ``encode``
        is called with the intern-record list to carry. When the
        combined payload would exceed the slot (long fresh names past
        the FRAME_RESERVE budget), the interns ship FIRST as a
        zero-row preamble frame — otherwise an over-slot payload would
        read as permanent phantom ring backpressure. A push failure
        rolls the fresh interns back (see _intern_rollback_locked);
        intern records alone exceeding a slot raise ValueError (a
        config/caller mismatch, never backpressure)."""
        interns, self._fresh = self._fresh, []
        try:
            payload = encode(interns)
        except BaseException:
            # An encode failure (e.g. a count/rt outside int32) must
            # leave the intern table consistent: these records were
            # detached from _fresh but never shipped — forget them or
            # every later frame referencing the ids decode-drops.
            self._intern_rollback_locked(interns)
            raise
        if len(payload) > self.channel.slot_bytes and interns:
            pre = fr.encode_entries(
                self.worker_id, [], interns, self._intern_gen,
                self._shed_total,
            )
            if len(pre) > self.channel.slot_bytes:
                self._intern_rollback_locked(interns)
                raise ValueError(
                    "intern records exceed the frame budget — raise "
                    "sentinel.tpu.ipc.slot.bytes or shorten the names"
                )
            if not self.request.try_push(pre):
                self._intern_rollback_locked(interns)
                return False
            self.counters["frames"] += 1
            interns = []
            payload = encode([])
        if self.request.try_push(payload):
            self.counters["frames"] += 1
            return True
        self._intern_rollback_locked(interns)
        return False

    def _intern_locked(self, s: str) -> int:
        gen = self.control.intern_gen()
        if gen != self._intern_gen:
            # Plane restarted / table invalidated: every string crosses
            # again under the new generation.
            self._intern.clear()
            self._fresh = []
            self._intern_gen = gen
        i = self._intern.get(s)
        if i is None:
            i = self._next_id
            self._next_id += 1
            self._intern[s] = i
            self._fresh.append((i, s.encode("utf-8", "surrogatepass")))
        return i

    # ------------------------------------------------------------------
    # live-admission ledger + reconnect (engine hot-restart)
    # ------------------------------------------------------------------
    def _live_note_locked(self, key: tuple) -> None:
        # An admit decided by a newer engine boot than the one we have
        # re-asserted to is ALREADY in the new plane's ledger — keep it
        # out of the next reassert snapshot (merged after reconnect).
        if self.control.engine_boot() != self._boot:
            self._live_new[key] = self._live_new.get(key, 0) + 1
        else:
            self._live[key] = self._live.get(key, 0) + 1

    @staticmethod
    def _dec(d: Dict[tuple, int], k: tuple) -> bool:
        cur = d.get(k, 0)
        if cur <= 0:
            return False
        if cur > 1:
            d[k] = cur - 1
        else:
            d.pop(k, None)
        return True

    def _live_forget_locked(
        self, res, ctx, org, et, spec, count
    ) -> None:
        """Pair one completion with its ledger line: exact key first,
        flipped mirror flag next, then any line with the same identity
        — the client-side twin of the plane's exit pairing (a raw
        ``speculative=None`` exit reads spec 0 = unknown). The
        new-world ledger is tried first (most recent admits complete
        first under typical request lifetimes)."""
        spec_opts = (
            (True, False) if spec == 0
            else ((spec == 1), not (spec == 1))
        )
        for d in (self._live_new, self._live):
            for sb in spec_opts:
                if self._dec(d, (res, ctx, org, et, sb, count)):
                    return
        for d in (self._live_new, self._live):
            for k in list(d):
                if k[0] == res and k[1] == ctx and k[2] == org and k[3] == et:
                    self._dec(d, k)
                    return

    def _forget_exit_tuple_locked(self, t: tuple) -> None:
        res, ctx, org, et, _ts, _rt, count, _err, spec = t
        self._live_forget_locked(res, ctx, org, et, spec, count)

    def _buffer_dead_exits_locked(self, items: List[tuple]) -> None:
        """Completions that could not reach a DEAD engine buffer for
        replay after a hot-restart (their ledger lines stay live so the
        re-assertion still covers them and the replayed exits pair).
        Bounded: overflow drops oldest, counted — the dead-worker reap
        remains the gauge backstop for anything dropped."""
        self._dead_exits.extend(items)
        self.counters["exits_buffered"] += len(items)
        over = len(self._dead_exits) - self.reconnect_exits_max
        if over > 0:
            dropped = self._dead_exits[:over]
            del self._dead_exits[:over]
            self.counters["exits_dropped"] += len(dropped)
            for t in dropped:
                self._forget_exit_tuple_locked(t)

    def _maybe_reconnect(self) -> None:
        """Beat-loop hook: an engine-boot epoch change with a live
        engine means a NEW engine process attached to our rings —
        re-intern happens organically (the new plane bumped the intern
        generation), so the reconnect work is (1) re-assert the live
        ledger, (2) replay the dead-window completion buffer. Chunks
        that fail to push retry on the next beat tick; a SECOND restart
        mid-reassert restarts the sequence from the current ledger."""
        boot = self.control.engine_boot()
        if boot == self._boot or not self.engine_alive():
            return
        if self._boot == 0:
            # First-ever observation (attached before the plane's boot
            # bump landed): nothing was admitted through an older world
            # — but admits decided BETWEEN the bump and this tick were
            # routed to _live_new (note-time boot mismatch); fold them
            # into the main ledger or a LATER restart's reassert
            # snapshot would miss them.
            with self._lock:
                self._boot = boot
                for k, v in self._live_new.items():
                    self._live[k] = self._live.get(k, 0) + v
                self._live_new.clear()
            return
        with self._lock:
            # Refresh the intern generation FIRST: a zero-row head
            # frame (idle worker) never calls _intern_locked, and a
            # frame carrying the dead world's generation would be
            # gen-gated as stale backlog by the new plane — the
            # reconnect would count client-side but never plane-side.
            gen = self.control.intern_gen()
            if gen != self._intern_gen:
                self._intern.clear()
                self._fresh = []
                self._intern_gen = gen
            if self._reassert_boot != boot:
                self._reassert_boot = boot
                self._reassert_rows = [
                    key + (cnt,) for key, cnt in self._live.items()
                ]
                self._reassert_head = True
            budget = self.channel.slot_bytes - fr.FRAME_RESERVE
            cap = max(1, budget // fr.REASSERT_ROW_BYTES)
            while True:
                chunk = self._reassert_rows[:cap]
                rows = [
                    fr.ReassertRow(
                        resource_id=self._intern_locked(res),
                        context_id=self._intern_locked(ctx),
                        origin_id=self._intern_locked(org),
                        entry_type=et,
                        spec=1 if spec_b else 0,
                        acquire=acq,
                        count=cnt,
                    )
                    for (res, ctx, org, et, spec_b, acq, cnt) in chunk
                ]
                try:
                    ok = self._push_locked(
                        lambda interns, rows=rows: fr.encode_reasserts(
                            self.worker_id, rows, interns,
                            self._intern_gen, self._shed_total,
                            head=self._reassert_head,
                        )
                    )
                except Exception:
                    from sentinel_tpu_torch.utils.record_log import record_log

                    record_log.error(
                        "[ipc] reassert encode failed — dropping chunk",
                        exc_info=True,
                    )
                    del self._reassert_rows[: len(chunk)]
                    continue
                if not ok:
                    return  # ring full / engine gone again: next beat
                self._reassert_head = False
                del self._reassert_rows[: len(chunk)]
                if not self._reassert_rows:
                    break
            # Ledger re-asserted: adopt the new world, fold the admits
            # the new engine decided mid-reconnect back into the main
            # ledger (its plane already carries them), and queue the
            # buffered completions for replay BEHIND the reassert
            # (same MPSC ring = FIFO, so they pair at the plane).
            self._boot = boot
            self._reassert_boot = None
            for k, v in self._live_new.items():
                self._live[k] = self._live.get(k, 0) + v
            self._live_new.clear()
            self.counters["reconnects"] += 1
            replay, self._dead_exits = self._dead_exits, []
        if replay:
            if self.window_armed:
                with self._lock:
                    self._win_join_locked(exits=replay)
            else:
                for t in replay:
                    (res, ctx, org, et, ts, rt, count, err, spec) = t
                    self.exit(
                        res, ctx, org, et, rt=rt, count=count, err=err,
                        ts=None if ts < 0 else ts,
                        speculative=(
                            None if spec == 0 else (spec == 1)
                        ),
                    )

    # ------------------------------------------------------------------
    # engine liveness + policy fallback
    # ------------------------------------------------------------------
    def engine_alive(self) -> bool:
        epoch, health, _gen, wall = self.control.engine_view()
        if health == HEALTH_CLOSED:
            return False
        if wall == 0:
            return False  # plane never heartbeat — not serving
        if self._spans.enabled:
            # The header beat IS the shared ruler: remember the latest
            # one so each journal spill carries this process's skew.
            self._spans.note_ruler(wall)
        self._in_handoff = health == HEALTH_HANDOFF
        stale = _wall_ms() - wall
        if stale <= self.engine_dead_ms:
            if self._suspect_epoch != -1:
                self._close_suspicion()
            return True
        if self.dead_confirm_ms <= 0:
            return False
        return self._confirm_alive(epoch, stale)

    def _close_suspicion(self) -> None:
        """The heartbeat resumed while a suspicion episode was open:
        the confirmation step held a pegged-but-alive engine out of the
        policy path — count the would-have-been false positive."""
        with self._suspect_lock:
            if self._suspect_epoch == -1:
                return
            if not self._suspect_declared:
                self.counters["dead_false_alarms"] += 1
            self._suspect_epoch = -1
            self._suspect_declared = False

    def _confirm_alive(self, epoch: int, stale: float) -> bool:
        """Wall clock stale past ``dead.ms`` with confirmation armed:
        defer the death declaration while the engine is PROVABLY alive
        (published pid answers signal 0), up to ``dead.ms +
        dead.confirm.ms``. One doorbell nudge per episode wakes a
        parked drainer whose control thread is merely starved."""
        with self._suspect_lock:
            if self._suspect_epoch != epoch:
                # New episode (keyed on the heartbeat epoch the engine
                # stalled at — a beat-then-stall restarts the clock).
                self._suspect_epoch = epoch
                self._suspect_declared = False
                self.counters["dead_suspicions"] += 1
                self.request.nudge()
            if self._suspect_declared:
                return False
            if stale > self.engine_dead_ms + self.dead_confirm_ms:
                self._suspect_declared = True
                self.counters["dead_declared"] += 1
                return False
            pid = self.control.engine_pid()
            if pid and _pid_alive(pid):
                return True
            self._suspect_declared = True
            self.counters["dead_declared"] += 1
            return False

    def _handoff_hold(self) -> bool:
        """The control header published HANDOFF: the old engine is
        draining in-flight work for a successor that attaches to the
        SAME rings. Hold this NEW admission (bounded by
        ``handoff.wait.ms``) until the successor beats and our beat
        loop has adopted its boot epoch — a planned handoff then serves
        ZERO policy verdicts. The hold spans the old world's
        detach->successor-attach gap (HANDOFF word with a stale wall
        still means "wait", not "dead"). Returns True when the push may
        proceed against the new world, False when the hold expired."""
        self.counters["handoff_holds"] += 1
        deadline = time.monotonic() + self.handoff_wait_ms / 1e3
        while time.monotonic() < deadline:
            if self._stop.is_set():
                return False
            _epoch, health, _gen, wall = self.control.engine_view()
            if health == HEALTH_CLOSED or wall == 0:
                return False
            if health != HEALTH_HANDOFF:
                self._in_handoff = False
                # Successor up: wait for OUR reconnect (beat loop) to
                # adopt its boot — pushing before the intern-generation
                # refresh would be gen-gated as dead-world backlog.
                if self._boot in (0, self.control.engine_boot()):
                    return (_wall_ms() - wall) <= self.engine_dead_ms
            time.sleep(0.002)
        return False

    def _policy_verdict(self, resource: str) -> fr.IpcVerdict:
        default, overrides = self.control.read_policy()
        mode = overrides.get(resource, default)
        self.counters["policy_served"] += 1
        if mode == "closed":
            return fr.IpcVerdict(
                False, E.BLOCK_FAILOVER, 0, degraded=True
            )
        return fr.IpcVerdict(True, E.PASS, 0, degraded=True)

    def _shed_verdict(self, n: int = 1) -> fr.IpcVerdict:
        with self._lock:
            self._shed_total += n
            self.counters["sheds"] += n
            # Cumulative count in our control slot (the plane folds the
            # delta into the engine's valve accounting even when no
            # frame ever gets through). Under the lock: the slot write
            # is a read-modify-write, and two shedding threads must not
            # lose an update.
            try:
                self.control.note_worker_shed(self.worker_id, n)
            except (ValueError, TypeError):
                pass
        return fr.IpcVerdict(False, E.BLOCK_SHED, 0, limit_type="ipc_ring")

    # ------------------------------------------------------------------
    # micro-window (sentinel.tpu.ipc.client.window.*)
    # ------------------------------------------------------------------
    def _win_join_locked(self, rows=(), exits=()) -> None:
        """Join the assembling micro-window (caller holds the client
        lock). The flusher wakes at the window deadline or when the
        row count reaches ``window.max`` — one ring claim + publish
        then answers for the whole window."""
        self._win_rows.extend(rows)
        self._win_exits.extend(exits)
        if self._win_deadline is None:
            self._win_deadline = time.monotonic() + self.window_ms / 1e3
            self._win_cond.notify_all()
        elif len(self._win_rows) >= self.window_max:
            self._win_cond.notify_all()

    def _win_due_locked(self) -> bool:
        if not self._win_rows and not self._win_exits:
            return False
        if len(self._win_rows) >= self.window_max:
            return True
        d = self._win_deadline
        return d is not None and time.monotonic() >= d

    def _win_loop(self) -> None:
        while True:
            with self._win_cond:
                while not self._stop.is_set() and not self._win_due_locked():
                    if self._win_rows or self._win_exits:
                        left = (
                            (self._win_deadline or time.monotonic())
                            - time.monotonic()
                        )
                        self._win_cond.wait(left if left > 0 else 0.0005)
                    else:
                        self._win_cond.wait(0.05)
                rows, self._win_rows = self._win_rows, []
                self._win_deadline = None
                try:
                    self._win_flush_locked(rows)
                except BaseException:
                    # Last-resort guard (the per-chunk and per-exit
                    # guards inside make this unreachable on known
                    # paths): a dead flusher strands every future
                    # windowed caller and leaks gauges forever — shed
                    # whatever is still unanswered instead. A row whose
                    # frame DID push before the failure keeps no waiter
                    # after this shed; its late verdict is tolerated
                    # (the reader pops waiters with a None default).
                    from sentinel_tpu_torch.utils.record_log import record_log

                    record_log.error(
                        "[ipc] micro-window flush failed — shedding "
                        "the window", exc_info=True,
                    )
                    try:
                        self._win_shed_locked(rows)
                        if self._win_exits:
                            self.counters["exits_dropped"] += len(
                                self._win_exits
                            )
                            if self.reconnect_enabled:
                                for t in self._win_exits:
                                    self._forget_exit_tuple_locked(t)
                            self._win_exits = []
                    except BaseException:
                        pass
                if (
                    self._stop.is_set()
                    and not self._win_rows
                    and not self._win_exits
                ):
                    return

    def _win_flush_locked(self, rows: List[fr.EntryRow]) -> None:
        """Encode + push one window: the entry rows in greedy
        byte-budget chunks (per-row over-budget was refused at the API
        edge, so every chunk fits a slot), then the buffered exits.
        Caller holds the client lock."""
        budget = self.channel.slot_bytes - fr.FRAME_RESERVE
        chunks = _byte_chunks(
            [fr.ENTRY_ROW_BYTES + len(r.args) for r in rows], budget,
            "window",
        )
        spj = self._spans
        t_flush = _span_wall_ms() if (spj.enabled and rows) else 0.0
        for ci, (clo, chi) in enumerate(chunks):
            sub = rows[clo:chi]
            try:
                ok = self._push_locked(
                    lambda interns, sub=sub: fr.encode_entries(
                        self.worker_id, sub, interns, self._intern_gen,
                        self._shed_total,
                    )
                )
            except Exception:
                # An encode failure must not kill the flusher thread —
                # that would strand every future windowed caller and
                # leak the engine-side gauges permanently (the worker
                # keeps heartbeating, so the dead-worker reap never
                # fires). Shed this chunk and the rest of the window
                # (the per-call twin of an unanswerable call).
                from sentinel_tpu_torch.utils.record_log import record_log

                record_log.error(
                    "[ipc] micro-window encode failed — shedding the "
                    "window's remaining chunks", exc_info=True,
                )
                for (slo, shi) in chunks[ci:]:
                    self._win_shed_locked(rows[slo:shi])
                break
            if ok:
                self.counters["window_flushes"] += 1
                # Per-call parity for the amortization counters: an
                # entry/bulk row counts only once its frame actually
                # pushed (a shed window must not read as served
                # entries in frames-per-entry).
                for r in sub:
                    if r.seq in self._win_bulk:
                        self._win_bulk.discard(r.seq)
                        self.counters["bulk_rows"] += 1
                    else:
                        self.counters["entries"] += 1
                continue
            # Ring full: this chunk AND every later chunk of the window
            # shed (per-call parity — a failed push is a local
            # BLOCK_SHED, never a stall; later chunks may reference
            # intern ids the failed push just rolled back, so pushing
            # them anyway would decode-drop at the plane). A dead
            # engine instead leaves the waiters to their own policy
            # fallback in _await_one — but the bookkeeping set must
            # still forget the rows, or every engine-dead window with
            # bulk rows grows it forever.
            if self.engine_alive():
                for (slo, shi) in chunks[ci:]:
                    self._win_shed_locked(rows[slo:shi])
            else:
                for (slo, shi) in chunks[ci:]:
                    for r in rows[slo:shi]:
                        self._win_bulk.discard(r.seq)
            break
        if spj.enabled and rows:
            spj.record(
                "win.flush", "worker", t_flush,
                _span_wall_ms() - t_flush,
                wid=self.worker_id, rows=len(rows),
                seq_lo=rows[0].seq, seq_hi=rows[-1].seq,
            )
        self._win_drain_exits_locked()

    def _win_shed_locked(self, sub: List[fr.EntryRow]) -> None:
        """Fan a shed verdict out to a failed chunk's waiters (caller
        holds the client lock; the inline twin of _shed_verdict)."""
        n = len(sub)
        self._shed_total += n
        self.counters["sheds"] += n
        try:
            self.control.note_worker_shed(self.worker_id, n)
        except (ValueError, TypeError):
            pass
        hit: Dict[_Waiter, bool] = {}
        for r in sub:
            self._win_bulk.discard(r.seq)
            w = self._waiters.pop(r.seq, None)
            if w is None:
                continue
            w.verdicts[r.seq] = (0, E.BLOCK_SHED, 0, 0)
            hit[w] = True
        for w in hit:
            w.event.set()

    def _win_drain_exits_locked(self) -> None:
        """Buffered completions → KIND_EXIT frames. Exits never shed:
        a full ring re-buffers them for the next window tick, bounded
        by the stall clock — dropped (and counted) only once the
        engine is gone or the stall outlives ``timeout.ms``, exactly
        the per-call exit() stance."""
        cap = max(1, (self.channel.slot_bytes - fr.FRAME_RESERVE)
                  // fr.EXIT_ROW_BYTES)
        if (
            self._win_exits
            and self.reconnect_enabled
            and not self._stop.is_set()
            and not self.engine_alive()
        ):
            # Dead engine: frames pushed now would be dead-world backlog
            # the next plane drops — buffer the window's completions for
            # post-restart replay instead (see exit()).
            moved, self._win_exits = self._win_exits, []
            self._buffer_dead_exits_locked(moved)
            self._win_exit_stall = None
            return
        while self._win_exits:
            chunk = self._win_exits[: cap]
            # (Re)intern per attempt: a failed push rolled its fresh
            # interns back, so a retried payload must carry fresh
            # records (stale ids decode-drop at the plane).
            rows = []
            for (res, ctx, org, et, ts, rt, count, err, spec) in chunk:
                seq = self._seq
                self._seq += 1
                rows.append(fr.ExitRow(
                    seq=seq,
                    resource_id=self._intern_locked(res),
                    context_id=self._intern_locked(ctx),
                    origin_id=self._intern_locked(org),
                    entry_type=et, ts=ts, rt=rt, count=count, err=err,
                    spec=spec,
                ))
            try:
                ok = self._push_locked(
                    lambda interns, rows=rows: fr.encode_exits(
                        self.worker_id, rows, interns, self._intern_gen,
                        self._shed_total,
                    )
                )
            except Exception:
                # An unencodable completion (e.g. a count outside
                # int32) must not kill the flusher: drop the chunk,
                # counted, and keep draining the rest.
                from sentinel_tpu_torch.utils.record_log import record_log

                record_log.error(
                    "[ipc] micro-window exit encode failed — dropping "
                    "the chunk", exc_info=True,
                )
                self.counters["exits_dropped"] += len(chunk)
                if self.reconnect_enabled:
                    for t in chunk:
                        self._forget_exit_tuple_locked(t)
                del self._win_exits[: len(chunk)]
                self._win_exit_stall = None
                continue
            if ok:
                if self.reconnect_enabled:
                    for t in chunk:
                        self._forget_exit_tuple_locked(t)
                del self._win_exits[: len(chunk)]
                self.counters["exits"] += len(chunk)
                self._win_exit_stall = None
                continue
            now = time.monotonic()
            if self._win_exit_stall is None:
                self._win_exit_stall = now
            dead = not self.engine_alive()
            if dead and self.reconnect_enabled and not self._stop.is_set():
                # Engine gone: buffer the window's completions for
                # replay after a hot-restart instead of dropping them
                # (their ledger lines stay live — see exit()).
                moved, self._win_exits = self._win_exits, []
                self._buffer_dead_exits_locked(moved)
                self._win_exit_stall = None
            elif (
                dead
                or (now - self._win_exit_stall) > self.timeout_ms / 1e3
                or self._stop.is_set()
            ):
                if self.reconnect_enabled:
                    for t in self._win_exits:
                        self._forget_exit_tuple_locked(t)
                self.counters["exits_dropped"] += len(self._win_exits)
                self._win_exits = []
                self._win_exit_stall = None
            elif self._win_deadline is None:
                # Schedule a retry tick even if no new joins arrive.
                self._win_deadline = now + max(self.window_ms, 1.0) / 1e3
            break

    # ------------------------------------------------------------------
    # the API surface
    # ------------------------------------------------------------------
    def entry(
        self,
        resource: str,
        context_name: str = "",
        origin: str = "",
        acquire: int = 1,
        entry_type: int = 1,  # models.constants.EntryType.OUT — the engine API default
        args: Sequence[object] = (),
        ts: Optional[int] = None,
        trace=None,
        timeout_ms: Optional[int] = None,
    ) -> fr.IpcVerdict:
        """One blocking admission through the plane. ``trace`` is an
        object with ``trace_id``/``span_id``/``sampled`` (e.g. a
        TraceContext); None reads the ambient contextvar so adapter
        code keeps working unchanged inside a worker."""
        _check_entry_type(entry_type)
        alive = self.engine_alive()
        if self._in_handoff:
            alive = self._handoff_hold()
        if not alive:
            return self._policy_verdict(resource)
        if trace is None:
            trace = _ambient_trace()
        packed = (
            fr.pack_trace(trace.trace_id, trace.span_id, trace.sampled)
            if trace is not None
            else fr.EMPTY_TRACE
        )
        spj = self._spans
        t_join = _span_wall_ms() if spj.enabled else 0.0
        args_blob = fr.encode_args(args)
        if (
            fr.ENTRY_ROW_BYTES + len(args_blob)
            > self.channel.slot_bytes - fr.FRAME_RESERVE
        ):
            # A row that can never fit a slot is a config/caller
            # mismatch, not backpressure — it must not read as a shed.
            raise ValueError(
                "entry: encoded args exceed the frame budget — raise "
                "sentinel.tpu.ipc.slot.bytes or shrink the args"
            )
        with self._lock:
            seq = self._seq
            self._seq += 1
            row = fr.EntryRow(
                seq=seq,
                resource_id=self._intern_locked(resource),
                context_id=self._intern_locked(context_name),
                origin_id=self._intern_locked(origin),
                entry_type=int(entry_type),
                acquire=int(acquire),
                ts=-1 if ts is None else int(ts),
                trace=packed,
                args=args_blob,
            )
            w = _Waiter(1)
            self._waiters[seq] = w
            if self.window_armed:
                # Micro-window: the flusher ships one frame for every
                # call that lands inside the window (shed/policy
                # outcomes fan back through the same waiter).
                self._win_join_locked(rows=[row])
                ok = True
            else:
                ok = self._push_locked(
                    lambda interns: fr.encode_entries(
                        self.worker_id, [row], interns, self._intern_gen,
                        self._shed_total,
                    )
                )
                if not ok:
                    del self._waiters[seq]
        if not ok:
            return self._shed_verdict()
        t_push = _span_wall_ms() if spj.enabled else 0.0
        if not self.window_armed:
            # Windowed entries count at flush time instead, once their
            # frame actually pushes — a later window shed must not
            # have pre-counted the row.
            self.counters["entries"] += 1
        out = self._await_one(
            w, seq, resource, timeout_ms,
            live_ident=(resource, context_name, origin, int(entry_type),
                        int(acquire)),
        )
        if spj.enabled:
            # One span per admission: t0 at join, `push_ms` when the
            # frame (or window join) was in the ring, `v` the wall-ms
            # verdict stamp the alignment test pins against the
            # engine's frame-drain span.
            t_v = _span_wall_ms()
            spj.record(
                "admit", "worker", t_join, t_v - t_join,
                wid=self.worker_id, seq=seq,
                push_ms=round(t_push - t_join, 3),
                v=round(t_v, 3),
                win=int(self.window_armed), adm=int(out.admitted),
                trace=(trace.trace_id if trace is not None else None),
            )
        return out

    def bulk(
        self,
        resource: str,
        n: int,
        ts=None,
        acquire=1,
        context_name: str = "",
        origin: str = "",
        entry_type: int = 1,  # EntryType.OUT, like the engine API
        args_column: Optional[Sequence] = None,
        timeout_ms: Optional[int] = None,
    ):
        """One pre-grouped columnar group (the worker-side
        ``submit_bulk``): returns dense ``(admitted, reason, wait_ms,
        flags)`` arrays of length n. Groups larger than one slot's
        frame budget split transparently — by BYTES, not rows: args
        payloads count toward the slot budget, so an args-heavy group
        just splits into more frames instead of building one the ring
        can never accept (which would read as phantom ring
        backpressure). A single row whose args alone exceed the budget
        raises ValueError — that is a config/caller mismatch, not
        backpressure."""
        if n < 1:
            raise ValueError("bulk: n must be >= 1")
        _check_entry_type(entry_type)
        alive = self.engine_alive()
        if self._in_handoff:
            alive = self._handoff_hold()
        if not alive:
            v = self._policy_verdict(resource)
            return _dense(n, v)
        ts_col = np.broadcast_to(
            np.asarray(-1 if ts is None else ts, dtype=np.int64), (n,)
        )
        acq_col = np.broadcast_to(
            np.asarray(acquire, dtype=np.int32), (n,)
        )
        budget = self.channel.slot_bytes - fr.FRAME_RESERVE
        args_blobs: Optional[List[bytes]] = None
        if args_column is not None:
            args_blobs = [fr.encode_args(a) for a in args_column]
        chunks = _byte_chunks(
            [
                fr.ENTRY_ROW_BYTES
                + (len(args_blobs[j]) if args_blobs is not None else 0)
                for j in range(n)
            ],
            budget, "bulk",
        )
        out_a = np.zeros(n, dtype=bool)
        out_r = np.zeros(n, dtype=np.int16)
        out_w = np.zeros(n, dtype=np.int32)
        out_f = np.zeros(n, dtype=np.uint8)
        if self.window_armed:
            # Micro-window ride: the whole group joins the assembling
            # window (the flusher re-chunks by bytes across EVERYTHING
            # in the window); per-row budget was validated above.
            with self._lock:
                base = self._seq
                self._seq += n
                rid = self._intern_locked(resource)
                cid = self._intern_locked(context_name)
                oid = self._intern_locked(origin)
                rows = [
                    fr.EntryRow(
                        seq=base + j,
                        resource_id=rid, context_id=cid, origin_id=oid,
                        entry_type=int(entry_type),
                        acquire=int(acq_col[j]),
                        ts=int(ts_col[j]),
                        trace=fr.EMPTY_TRACE,
                        args=(
                            args_blobs[j] if args_blobs is not None else b""
                        ),
                    )
                    for j in range(n)
                ]
                w = _Waiter(n)
                for j in range(n):
                    self._waiters[base + j] = w
                self._win_bulk.update(range(base, base + n))
                self._win_join_locked(rows=rows)
            # bulk_rows counts at flush time (see _win_flush_locked) —
            # per-call parity: a shed window never counts.
            got = self._await_many(
                w, range(base, base + n), resource, timeout_ms,
                live_base=(resource, context_name, origin,
                           int(entry_type)),
                acq=acq_col,
            )
            for j, (adm, rsn, wms, fl) in enumerate(got):
                out_a[j] = adm
                out_r[j] = rsn
                out_w[j] = wms
                out_f[j] = fl
            return out_a, out_r, out_w, out_f
        spj = self._spans
        for lo, hi in chunks:
            m = hi - lo
            t_join = _span_wall_ms() if spj.enabled else 0.0
            with self._lock:
                base = self._seq
                self._seq += m
                rid = self._intern_locked(resource)
                cid = self._intern_locked(context_name)
                oid = self._intern_locked(origin)
                rows = [
                    fr.EntryRow(
                        seq=base + j,
                        resource_id=rid, context_id=cid, origin_id=oid,
                        entry_type=int(entry_type),
                        acquire=int(acq_col[lo + j]),
                        ts=int(ts_col[lo + j]),
                        trace=fr.EMPTY_TRACE,
                        args=(
                            args_blobs[lo + j]
                            if args_blobs is not None else b""
                        ),
                    )
                    for j in range(m)
                ]
                w = _Waiter(m)
                for j in range(m):
                    self._waiters[base + j] = w
                ok = self._push_locked(
                    lambda interns: fr.encode_entries(
                        self.worker_id, rows, interns, self._intern_gen,
                        self._shed_total, kind=fr.KIND_BULK,
                    )
                )
                if not ok:
                    for j in range(m):
                        del self._waiters[base + j]
            if not ok:
                sv = self._shed_verdict(m)
                out_a[lo:hi] = sv.admitted
                out_r[lo:hi] = sv.reason
                continue
            self.counters["bulk_rows"] += m
            got = self._await_many(
                w, range(base, base + m), resource, timeout_ms,
                live_base=(resource, context_name, origin,
                           int(entry_type)),
                acq=acq_col[lo:hi],
            )
            for j, (adm, rsn, wms, fl) in enumerate(got):
                out_a[lo + j] = adm
                out_r[lo + j] = rsn
                out_w[lo + j] = wms
                out_f[lo + j] = fl
            if spj.enabled:
                t_v = _span_wall_ms()
                spj.record(
                    "admit.bulk", "worker", t_join, t_v - t_join,
                    wid=self.worker_id, seq=base, rows=m,
                    v=round(t_v, 3),
                )
        return out_a, out_r, out_w, out_f

    def exit(
        self,
        resource: str,
        context_name: str = "",
        origin: str = "",
        entry_type: int = 1,  # EntryType.OUT, like the engine API
        rt: int = 0,
        count: int = 1,
        err: int = 0,
        ts: Optional[int] = None,
        speculative: Optional[bool] = None,
    ) -> bool:
        """One completion. Never shed: retries a full ring with a short
        backoff, dropping only once the engine is gone (False).

        The (resource, context, origin, entry_type) identity MUST
        match the entry's — it is how the engine-side plane resolves
        the node rows to release and how the live-admission ledger
        pairs the completion with its admit (a mismatched identity
        releases the wrong rows AND leaves the ledger entry live for a
        spurious dead-worker release later). The in-process API has
        the same contract, just structural: there the caller passes
        the entry's ``rows`` tuple back.

        One bounded exception to "never dropped while the engine
        lives": a ring that stays full past ``timeout.ms`` with a
        still-heartbeating engine means the DRAINER is wedged (the
        control thread beats independently) — the completion is then
        dropped and counted in ``exits_dropped`` rather than pinning
        this caller thread forever; the dead-worker reap releases the
        admission once this worker eventually exits.

        With the micro-window armed the completion instead buffers for
        the next window flush and this returns True immediately (=
        accepted for delivery; the flusher applies the same bounded
        retry-then-drop stance on the caller's behalf)."""
        _check_entry_type(entry_type)
        if self.window_armed:
            with self._lock:
                self._win_join_locked(exits=[(
                    resource, context_name, origin, int(entry_type),
                    -1 if ts is None else int(ts),
                    int(rt), int(count), int(err),
                    0 if speculative is None else (1 if speculative else 2),
                )])
            return True
        deadline = time.monotonic() + self.timeout_ms / 1e3
        delay = 0.0002
        spec_wire = 0 if speculative is None else (1 if speculative else 2)
        if self.reconnect_enabled and not self.engine_alive():
            # A frame pushed into a DEAD engine's ring is dead-world
            # backlog the next plane must (and does) drop — buffer the
            # completion for replay after the hot-restart instead.
            with self._lock:
                self._buffer_dead_exits_locked([(
                    resource, context_name, origin, int(entry_type),
                    -1 if ts is None else int(ts),
                    int(rt), int(count), int(err), spec_wire,
                )])
            return True
        while True:
            # (Re)build under the lock on EVERY attempt: a failed push
            # rolled its fresh interns back, so a retried payload must
            # re-intern (carrying stale ids the plane never learned
            # would decode-drop the completion).
            with self._lock:
                seq = self._seq
                self._seq += 1
                row = fr.ExitRow(
                    seq=seq,
                    resource_id=self._intern_locked(resource),
                    context_id=self._intern_locked(context_name),
                    origin_id=self._intern_locked(origin),
                    entry_type=int(entry_type),
                    ts=-1 if ts is None else int(ts),
                    rt=int(rt), count=int(count), err=int(err),
                    spec=spec_wire,
                )
                ok = self._push_locked(
                    lambda interns: fr.encode_exits(
                        self.worker_id, [row], interns, self._intern_gen,
                        self._shed_total,
                    )
                )
                if ok and self.reconnect_enabled:
                    self._live_forget_locked(
                        resource, context_name, origin, int(entry_type),
                        spec_wire, int(count),
                    )
            if ok:
                self.counters["exits"] += 1
                return True
            if not self.engine_alive():
                if self.reconnect_enabled:
                    # Buffer for replay after a hot-restart — the
                    # ledger line stays live so the re-assertion covers
                    # the admission and the replayed exit pairs.
                    with self._lock:
                        self._buffer_dead_exits_locked([(
                            resource, context_name, origin,
                            int(entry_type), -1 if ts is None else int(ts),
                            int(rt), int(count), int(err), spec_wire,
                        )])
                    return True
                with self._lock:
                    self.counters["exits_dropped"] += 1
                return False
            if time.monotonic() > deadline:
                with self._lock:
                    self.counters["exits_dropped"] += 1
                    if self.reconnect_enabled:
                        self._live_forget_locked(
                            resource, context_name, origin,
                            int(entry_type), spec_wire, int(count),
                        )
                return False
            time.sleep(delay)
            delay = min(delay * 2, 0.005)

    # ------------------------------------------------------------------
    # waiting
    # ------------------------------------------------------------------
    def _await_one(
        self, w: _Waiter, seq: int, resource: str,
        timeout_ms: Optional[int], live_ident: Optional[tuple] = None,
    ) -> fr.IpcVerdict:
        t = (timeout_ms or self.timeout_ms) / 1e3
        deadline = time.monotonic() + t
        while True:
            if w.event.wait(timeout=0.05):
                v = w.verdicts.get(seq)
                if v is not None:
                    out = _to_verdict(v)
                    if (
                        self.reconnect_enabled
                        and out.admitted
                        and live_ident is not None
                    ):
                        # Engine-decided admit: one live ledger line
                        # until its completion pairs (policy verdicts
                        # below never reached the engine — no line).
                        res_, ctx_, org_, et_, acq_ = live_ident
                        with self._lock:
                            self._live_note_locked(
                                (res_, ctx_, org_, et_,
                                 out.speculative or out.degraded, acq_)
                            )
                    return out
                w.event.clear()
            # During a planned handoff the stale wall (and the exiting
            # old engine's pid) must not convert a parked caller into a
            # policy verdict — the old world answers in-flight frames
            # before detaching; only the deadline bounds the wait.
            # engine_alive() itself refreshes _in_handoff.
            if time.monotonic() > deadline or (
                not self.engine_alive() and not self._in_handoff
            ):
                with self._lock:
                    self._waiters.pop(seq, None)
                return self._policy_verdict(resource)

    def _await_many(
        self, w: _Waiter, seqs, resource: str, timeout_ms: Optional[int],
        live_base: Optional[tuple] = None, acq=None,
    ) -> List[tuple]:
        t = (timeout_ms or self.timeout_ms) / 1e3
        deadline = time.monotonic() + t
        while True:
            if w.event.wait(timeout=0.05):
                if len(w.verdicts) >= w.need:
                    break
                w.event.clear()
            if time.monotonic() > deadline or (
                not self.engine_alive() and not self._in_handoff
            ):
                break
        with self._lock:
            for s in seqs:
                self._waiters.pop(s, None)
        out = []
        notes: List[tuple] = []
        pol = None
        for i, s in enumerate(seqs):
            v = w.verdicts.get(s)
            if v is None:
                if pol is None:
                    p = self._policy_verdict(resource)
                    pol = (
                        1 if p.admitted else 0, p.reason, 0,
                        fr.F_DEGRADED,
                    )
                v = pol
            elif (
                self.reconnect_enabled and live_base is not None and v[0]
            ):
                res_, ctx_, org_, et_ = live_base
                notes.append(
                    (res_, ctx_, org_, et_,
                     bool(v[3] & (fr.F_SPECULATIVE | fr.F_DEGRADED)),
                     int(acq[i]) if acq is not None else 1)
                )
            out.append(v)
        if notes:
            with self._lock:
                for k in notes:
                    self._live_note_locked(k)
        return out

    def _read_loop(self) -> None:
        park = 0.0005
        spj = self._spans
        while not self._stop.is_set():
            payloads = self.response.pop_all(limit=64)
            if not payloads:
                if self.adaptive_wakeup:
                    # Spin-then-park: the verdict frame usually lands
                    # within the spin; the park (doorbell-ended, timeout
                    # growing to the cap) bounds idle burn.
                    if spj.enabled:
                        t_p = _span_wall_ms()
                        if self.response.wait_readable(self._spin_s, park):
                            # Productive wakes only — an idle client
                            # parking forever must not flood the ring.
                            spj.record(
                                "wake", "worker", t_p,
                                _span_wall_ms() - t_p,
                                wid=self.worker_id,
                            )
                        else:
                            park = min(park * 2, self._park_s)
                    elif not self.response.wait_readable(
                        self._spin_s, park
                    ):
                        park = min(park * 2, self._park_s)
                else:
                    time.sleep(0.0002)
                continue
            park = 0.0005
            for p in payloads:
                try:
                    f = fr.decode_frame(p)
                except (ValueError, struct_error):
                    continue
                if f.kind != fr.KIND_VERDICT:
                    continue
                seqs = f.columns["seq"].tolist()
                adm = f.columns["admitted"].tolist()
                rsn = f.columns["reason"].tolist()
                wms = f.columns["wait_ms"].tolist()
                fl = f.columns["flags"].tolist()
                with self._lock:
                    hit: Dict[_Waiter, bool] = {}
                    for i, s in enumerate(seqs):
                        w = self._waiters.pop(s, None)
                        if w is None:
                            continue
                        w.verdicts[s] = (adm[i], rsn[i], wms[i], fl[i])
                        hit[w] = True
                for w in hit:
                    w.event.set()

    def _beat_loop(self) -> None:
        pid = os.getpid()
        while not self._stop.wait(self.heartbeat_ms / 1e3):
            try:
                self.control.beat_worker(self.worker_id, pid)
            except (ValueError, TypeError):
                return
            if self.reconnect_enabled:
                try:
                    self._maybe_reconnect()
                except Exception:
                    from sentinel_tpu_torch.utils.record_log import record_log

                    record_log.error(
                        "[ipc] reconnect attempt failed — retrying on "
                        "the next beat", exc_info=True,
                    )

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def close(self, clear_slot: bool = True) -> None:
        self._stop.set()
        if self._win_thread is not None:
            # Wake the flusher so the final window (buffered rows and
            # completions) ships before the rings close.
            with self._win_cond:
                self._win_cond.notify_all()
            self._win_thread.join(timeout=2.0)
            self._win_thread = None
        self._reader.join(timeout=2.0)
        if self._beat is not None:
            self._beat.join(timeout=2.0)
        with self._lock:
            if self._dead_exits:
                # Undeliverable completions die with the client — the
                # plane's dead-worker reap releases their admissions.
                self.counters["exits_dropped"] += len(self._dead_exits)
                self._dead_exits = []
        if clear_slot:
            try:
                self.control.clear_worker(self.worker_id)
            except (ValueError, TypeError):
                pass
        if self._spans.enabled:
            # Final journal spill: a worker's spans must survive its
            # exit for fleetdump to merge.
            try:
                self._spans.spill()
            except OSError:
                pass
        self.request.close()
        self.response.close()
        self.control.close()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "worker_id": self.worker_id,
                "engine_alive": self.engine_alive(),
                "counters": dict(self.counters),
                "interned": len(self._intern),
                "pending_waits": len(self._waiters),
                "window_armed": self.window_armed,
                "window_ms": self.window_ms,
                "window_max": self.window_max,
                "window_pending": len(self._win_rows) + len(self._win_exits),
                "adaptive_wakeup": self.adaptive_wakeup,
                "reconnect_enabled": self.reconnect_enabled,
                "engine_boot": self._boot,
                "live_admissions": (
                    sum(self._live.values()) + sum(self._live_new.values())
                ),
                "buffered_exits": len(self._dead_exits),
            }


def _check_entry_type(entry_type) -> None:
    # Validate at the API edge: the wire carries a bare int8, and the
    # plane per-row-sheds anything it cannot map back to an EntryType
    # — failing HERE turns a silent shed into the caller's bug report.
    if int(entry_type) not in (0, 1):
        raise ValueError(
            f"entry_type must be 0 (IN) or 1 (OUT), got {entry_type!r}"
        )


def _pid_alive(pid: int) -> bool:
    """Signal-0 probe (same host by shared-memory construction).
    EPERM still means "exists" — a privilege boundary is not death."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True


def _ambient_trace():
    from sentinel_tpu_torch.core.context import ContextUtil

    return ContextUtil.get_trace()


def _to_verdict(v: tuple) -> fr.IpcVerdict:
    adm, rsn, wms, fl = v
    return fr.IpcVerdict(
        admitted=bool(adm),
        reason=int(rsn),
        wait_ms=int(wms),
        limit_type="ipc_ring" if rsn == E.BLOCK_SHED else "",
        degraded=bool(fl & fr.F_DEGRADED),
        speculative=bool(fl & fr.F_SPECULATIVE),
    )


def _dense(n: int, v: fr.IpcVerdict):
    fl = (fr.F_SPECULATIVE if v.speculative else 0) | (
        fr.F_DEGRADED if v.degraded else 0
    )
    return (
        np.full(n, v.admitted, dtype=bool),
        np.full(n, v.reason, dtype=np.int16),
        np.full(n, v.wait_ms, dtype=np.int32),
        np.full(n, fl, dtype=np.uint8),
    )
