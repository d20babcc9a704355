"""IngestPlane: the engine-process drainer of the multi-process plane.

One plane per engine. It owns every shared-memory segment (control
header, MPSC request ring, one SPSC response ring per worker slot) and
a drainer thread that:

* pops request frames, decodes the columns, and rides admissions
  through the SAME columnar spine the batch window uses — grouped
  ``submit_bulk`` with per-request ts/acquire columns, per-request
  ``submit_entry`` fallback for the rule classes bulk declines
  (cluster mode, THREAD-grade param rules, collection values) — so
  worker-path verdicts are bit-identical to the in-process oracle;
* fans speculative fast-tier verdicts back WITHOUT waiting for the
  settling flush (``entry_windowed`` parity: the device settles on the
  tier's own cadence);
* reconstructs each row's packed W3C traceparent and records
  per-request admission traces (the trace identity survives the process
  boundary);
* keeps the **live-admission ledger** per worker: every admitted
  THREAD-charged row is recorded so a dead worker's heartbeat (stale
  past ``sentinel.tpu.ipc.worker.dead.ms``) triggers an auto-exit of
  exactly its live admissions — device and mirror THREAD gauges return
  to exactly 0, the plane's analog of the batch window's
  abandoned-entry release;
* publishes the engine heartbeat + health word and the per-resource
  fail-open/closed failover-policy snapshot into the control header —
  what workers serve from when this process dies;
* folds worker-side ring-full shed counts into the engine's
  IngestValve accounting (cause ``ring``) so shedding stays one
  fleet-visible number.

Nothing here touches the engine submit hot path: a disabled plane is
never constructed, and an enabled one costs the engine exactly the
work the frames carry.
"""

from __future__ import annotations

import multiprocessing
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from sentinel_tpu_torch.core import errors as E
from sentinel_tpu_torch.ipc import frames as fr
from sentinel_tpu_torch.ipc.ring import (
    HEALTH_CLOSED,
    HEALTH_DEGRADED,
    HEALTH_HANDOFF,
    HEALTH_HEALTHY,
    ControlBlock,
    ShmRing,
    resolve_spin_us,
)
from sentinel_tpu_torch.ipc.worker import PlaneChannel
from sentinel_tpu_torch.metrics.spans import get_journal
from sentinel_tpu_torch.metrics.spans import wall_ms as _span_wall_ms
from sentinel_tpu_torch.utils.config import config


class _WorkerState:
    """Engine-side per-worker-slot state: the intern decode table and
    the live-admission ledger."""

    __slots__ = (
        "names", "live", "last_epoch", "last_seen", "shed_seen", "attached",
    )

    def __init__(self) -> None:
        self.names: Dict[int, str] = {}
        # (rows, resource, speculative, acquire) -> live admitted count.
        self.live: Dict[Tuple[tuple, str, bool, int], int] = {}
        self.last_epoch = 0
        self.last_seen = 0.0
        self.shed_seen = 0
        self.attached = False


class IngestPlane:
    """Engine-scoped multi-process ingest plane (see module doc)."""

    def __init__(self, engine, start: bool = True, handles=None) -> None:
        self._engine = engine
        self.workers_max = max(1, config.get_int(config.IPC_WORKERS_MAX, 8))
        self.ring_slots = config.get_int(config.IPC_RING_SLOTS, 1024)
        self.slot_bytes = max(
            1024, config.get_int(config.IPC_SLOT_BYTES, 16384)
        )
        self.resp_slots = config.get_int(config.IPC_RESP_SLOTS, 1024)
        self.worker_dead_ms = max(
            1, config.get_int(config.IPC_WORKER_DEAD_MS, 1000)
        )
        self.heartbeat_ms = max(1, config.get_int(config.IPC_HEARTBEAT_MS, 100))
        self.poll_us = max(10, config.get_int(config.IPC_POLL_US, 200))
        # Adaptive wakeups (sentinel.tpu.ipc.wakeup=adaptive): the
        # drainer spins briefly then parks on a doorbell semaphore a
        # publishing producer rings; "sleep" (the default) keeps the
        # plain sleep-poll backoff (no semaphores exist).
        wake = (config.get(config.IPC_WAKEUP) or "sleep").strip().lower()
        self.adaptive_wakeup = wake == "adaptive"
        self.spin_s = resolve_spin_us(
            config.get_int(config.IPC_WAKEUP_SPIN_US, -1)
        ) / 1e6
        self.park_s = max(
            1, config.get_int(config.IPC_WAKEUP_PARK_MS, 5)
        ) / 1e3
        self._mp = multiprocessing.get_context("spawn")
        # Named segments (sentinel.tpu.ipc.shm.prefix / supervisor
        # handles): a deterministic prefix lets a RESTARTED engine
        # process re-attach to the EXISTING rings — workers keep their
        # mappings, nothing re-spawns. "" (the default) keeps the
        # anonymous segments. The producer claim lock
        # and doorbells cannot live in shared memory; in supervised
        # mode they come from the SUPERVISOR's handles (so they outlive
        # any one engine process), otherwise this plane creates its own
        # — an unsupervised re-attach then must not add NEW producers
        # through channel() while old workers still hold the old lock.
        if handles is not None:
            self.prefix = (handles.prefix or "").strip()
            self._req_lock = handles.request_lock
            self._req_doorbell = (
                handles.request_doorbell if self.adaptive_wakeup else None
            )
            self._handle_bells = list(handles.response_doorbells or [])
        else:
            self.prefix = (config.get(config.IPC_SHM_PREFIX) or "").strip()
            self._req_lock = self._mp.Lock()
            self._req_doorbell = (
                self._mp.Semaphore(0) if self.adaptive_wakeup else None
            )
            self._handle_bells = None
        self.attached = False
        # Who unlinks the named segments at close: a handles-mode
        # (supervised) plane NEVER does — the rings must outlive this
        # engine process for the next one to re-attach warm; the
        # SUPERVISOR unlinks at final shutdown
        # (supervise.unlink_segments). A prefix-without-handles plane
        # owns them like the anonymous case.
        self._own_segments = handles is None
        if self.prefix:
            ctl_name = f"{self.prefix}-ctl"
            try:
                self.control = ControlBlock(ctl_name, self.workers_max)
                self.attached = True
            except FileNotFoundError:
                try:
                    self.control = ControlBlock(
                        ctl_name, self.workers_max, create=True
                    )
                except FileExistsError:
                    self.control = ControlBlock(ctl_name, self.workers_max)
                    self.attached = True
            self.control._owner = self._own_segments
            self.request = self._attach_or_create_ring(
                f"{self.prefix}-req", self.ring_slots,
                lock=self._req_lock, doorbell=self._req_doorbell,
            )
        else:
            self.control = ControlBlock(None, self.workers_max, create=True)
            self.request = ShmRing(
                None, self.ring_slots, self.slot_bytes, create=True,
                lock=self._req_lock, doorbell=self._req_doorbell,
            )
        # Response rings allocate LAZILY at channel() time: eagerly
        # mapping workers_max rings would hold ~workers_max x
        # resp_slots x slot_bytes of /dev/shm (~134 MB at defaults)
        # for worker slots that may never attach.
        self.responses: List[Optional[ShmRing]] = [
            None for _ in range(self.workers_max)
        ]
        self._resp_doorbells: List[Optional[object]] = [
            None for _ in range(self.workers_max)
        ]
        self._workers: List[_WorkerState] = [
            _WorkerState() for _ in range(self.workers_max)
        ]
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "frames": 0, "requests": 0, "bulk_rows": 0, "exits": 0,
            "exits_unpaired": 0, "worker_sheds": 0, "decode_drops": 0,
            "worker_deaths": 0, "auto_exits": 0, "responses_dropped": 0,
            "stalled_skips": 0, "worker_reconnects": 0, "reasserts": 0,
            "stale_frames": 0,
        }
        self._policy_published: Optional[str] = None
        # Fleet span journal: per-frame drain spans on the same
        # wall-ms ruler this plane's control header publishes.
        self._spans = get_journal("engine")
        self._last_sweep = 0.0
        # World generation: bumped by on_engine_reset so a decision
        # batch that STARTED before a reset cannot insert ledger
        # entries for the dead world after the ledgers were dropped
        # (a later reap would release them against fresh gauges).
        self._world = 0
        # Worker ids handed out by claim_worker_slots but not yet seen
        # attached — keeps a second run_workers from reusing a slot
        # whose child is still booting.
        self._claimed: set = set()
        self._stop = threading.Event()
        self.closed = False
        # Planned-handoff drain (handoff()): while set, the control
        # heartbeat publishes HANDOFF — workers hold new admissions for
        # the successor instead of serving policy verdicts.
        self._handoff = False
        self._thread: Optional[threading.Thread] = None
        self._ctrl: Optional[threading.Thread] = None
        # The intern generation starts at 1 so a worker attaching to a
        # RESTARTED plane under recycled shm names can never alias
        # generation 0 reads from the zeroed header.
        self.control.bump_intern_gen()
        # Hot-restart generation: one bump per plane attach/create —
        # workers react to the change with the reconnect protocol
        # (re-intern, ledger re-assert, buffered-exit replay).
        self.engine_epoch = self.control.bump_engine_boot()
        # Engine pid for the worker-side death-confirmation probe
        # (dead.confirm.ms): a stale wall clock + a live pid means
        # pegged-not-dead.
        import os as _os

        self.control.set_engine_pid(_os.getpid())
        # Frames still in a re-attached ring belong to the DEAD world:
        # their callers were policy-served long ago and their intern ids
        # mean nothing here — drop anything below the post-attach
        # generation instead of guessing (fresh planes never gate).
        self._min_gen = self.control.intern_gen() if self.attached else 0
        if self.attached:
            # Shed-fold baselines: the control slots carry each worker's
            # CUMULATIVE shed count from the old world — folding from 0
            # would recount every old shed into the new engine's valve.
            for wid in range(self.workers_max):
                try:
                    _e, _w, pid, shed = self.control.worker_view(wid)
                except (ValueError, TypeError):
                    continue
                if pid != 0:
                    self._workers[wid].shed_seen = shed
        engine.ipc_plane = self
        if start:
            self.start()

    def _attach_or_create_ring(self, name, slots, lock=None, doorbell=None):
        try:
            ring = ShmRing(
                name, slots, self.slot_bytes, lock=lock, doorbell=doorbell
            )
        except FileNotFoundError:
            try:
                ring = ShmRing(
                    name, slots, self.slot_bytes, create=True, lock=lock,
                    doorbell=doorbell,
                )
            except FileExistsError:
                ring = ShmRing(
                    name, slots, self.slot_bytes, lock=lock,
                    doorbell=doorbell,
                )
        ring._owner = self._own_segments
        return ring

    # ------------------------------------------------------------------
    # attach surface
    # ------------------------------------------------------------------
    def claim_worker_slots(self, n: int) -> List[int]:
        """Reserve ``n`` free worker ids for a spawner (the
        ``api.run_workers`` allocation): a slot is free when no live
        worker is attached, its control slot is clear, and no earlier
        claim is still pending attach. Without this, a second
        run_workers on the same engine would reuse ids 0..n-1 — two
        clients on one response ring race its tail pointer and each
        steals half the other's verdicts."""
        out: List[int] = []
        with self._lock:
            for wid in range(self.workers_max):
                if len(out) == n:
                    break
                ws = self._workers[wid]
                if ws.attached or wid in self._claimed:
                    continue
                try:
                    _epoch, _wall, pid, _shed = self.control.worker_view(wid)
                except (ValueError, TypeError):
                    continue
                if pid != 0:
                    continue
                out.append(wid)
            if len(out) < n:
                raise ValueError(
                    f"claim_worker_slots: only {len(out)} of {n} worker "
                    f"slots free (workers.max={self.workers_max}; stopped "
                    "workers free their slots at the dead-worker sweep)"
                )
            self._claimed.update(out)
        return out

    def _ensure_response_locked(self, worker_id: int):
        """The worker's SPSC response ring, created (or, in named mode,
        re-attached after a hot-restart) lazily; caller holds
        ``self._lock``."""
        if self.responses[worker_id] is not None:
            return self.responses[worker_id]
        bell = None
        if self.adaptive_wakeup:
            if self._handle_bells is not None and worker_id < len(
                self._handle_bells
            ):
                bell = self._handle_bells[worker_id]
            else:
                bell = self._mp.Semaphore(0)
        self._resp_doorbells[worker_id] = bell
        if self.prefix:
            ring = self._attach_or_create_ring(
                f"{self.prefix}-resp{worker_id}", self.resp_slots,
                doorbell=bell,
            )
        else:
            ring = ShmRing(
                None, self.resp_slots, self.slot_bytes, create=True,
                doorbell=bell,
            )
        self.responses[worker_id] = ring
        return ring

    def channel(self, worker_id: int) -> PlaneChannel:
        if not (0 <= worker_id < self.workers_max):
            raise ValueError(f"worker_id {worker_id} out of range")
        with self._lock:
            self._ensure_response_locked(worker_id)
            resp_name = self.responses[worker_id].name
            resp_bell = self._resp_doorbells[worker_id]
        return PlaneChannel(
            control_name=self.control.name,
            request_name=self.request.name,
            response_name=resp_name,
            ring_slots=self.ring_slots,
            slot_bytes=self.slot_bytes,
            resp_slots=self.resp_slots,
            workers_max=self.workers_max,
            request_lock=self._req_lock,
            request_doorbell=self._req_doorbell,
            response_doorbell=resp_bell,
        )

    def spawn_context(self):
        """The plane's (spawn) multiprocessing context — workers must
        be descendants of this process for the claim lock to travel."""
        return self._mp

    # ------------------------------------------------------------------
    # drainer
    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._publish_control(force=True)
        self._thread = threading.Thread(
            target=self._run, name="sentinel-ipc-plane", daemon=True
        )
        self._thread.start()
        # Control-plane duties on their OWN thread: the drainer blocks
        # inside engine flushes (a first-compile runs for seconds), and
        # a heartbeat that rides the drain loop would starve exactly
        # then — workers would declare a merely-busy engine dead.
        self._ctrl = threading.Thread(
            target=self._control_loop, name="sentinel-ipc-control",
            daemon=True,
        )
        self._ctrl.start()

    def _run(self) -> None:
        # The drainer flushes the engine: it enters the engine's device
        # and stream, as the batch window's flusher does, so that its
        # launches never land on this thread's current device.
        with self._engine._thread_context():
            self._run_loop()

    def _run_loop(self) -> None:
        idle_s = self.poll_us / 1e6
        delay = idle_s
        park = 0.0005
        # The park timeout is additionally capped by the heartbeat
        # cadence: the worker-death sweep rides this loop and must keep
        # its clock even when the doorbell never rings.
        park_cap = min(self.park_s, max(0.001, self.heartbeat_ms / 1e3))
        while not self._stop.is_set():
            try:
                worked = self._drain_once()
            except Exception:
                from sentinel_tpu_torch.utils.record_log import record_log

                record_log.error("[IngestPlane] drain failed", exc_info=True)
                worked = False
            if worked:
                delay = idle_s
                park = 0.0005
            elif self.adaptive_wakeup:
                # Spin-then-park: bounded spin keeps the hot round trip
                # off the scheduler; the park (exponentially growing
                # timeout, producer-rung doorbell) bounds idle burn.
                self.request.wait_readable(self.spin_s, park)
                park = min(park * 2, park_cap)
            else:
                time.sleep(delay)
                delay = min(delay * 2, 0.002)

    def _control_loop(self) -> None:
        """Heartbeat + policy publishing ONLY: this thread must never
        block on engine work (a reap's flush can compile for seconds,
        and a starved heartbeat reads as engine death to every worker).
        The worker death sweep runs on the drainer, which is allowed to
        be busy."""
        while not self._stop.wait(self.heartbeat_ms / 1e3):
            try:
                self._publish_control()
            except Exception:
                from sentinel_tpu_torch.utils.record_log import record_log

                record_log.error(
                    "[IngestPlane] control tick failed", exc_info=True
                )

    def _drain_once(self) -> bool:
        """One drainer iteration; True when any frame was processed."""
        now = time.monotonic()
        if (now - self._last_sweep) * 1e3 >= self.heartbeat_ms:
            self._last_sweep = now
            self._check_workers(now)
        payloads = self.request.pop_all(limit=128)
        if not payloads:
            if self.request.maybe_skip_stalled(self.worker_dead_ms / 1e3):
                self.counters["stalled_skips"] += 1
                return True
            return False
        eng = self._engine
        tele = eng.telemetry
        spj = self._spans
        t_drain = _span_wall_ms() if spj.enabled else 0.0
        frame_meta: Optional[List[tuple]] = [] if spj.enabled else None
        groups: Dict[tuple, list] = {}
        exits: List[tuple] = []
        responses: Dict[int, list] = {}
        n_rows = 0
        for payload in payloads:
            try:
                f = fr.decode_frame(payload)
            except (ValueError, fr.struct.error):
                self.counters["decode_drops"] += 1
                continue
            if not (0 <= f.worker_id < self.workers_max):
                self.counters["decode_drops"] += 1
                continue
            ws = self._workers[f.worker_id]
            if self._min_gen and f.intern_gen < self._min_gen:
                # Dead-world backlog: a frame pushed before THIS plane
                # attached (its engine died with it undrained). The
                # callers were policy-served long ago and the intern ids
                # belong to a table that died with the old process —
                # answer any still-parked waiter with a fast shed
                # rather than admitting ghosts into the new world.
                self.counters["stale_frames"] += 1
                if f.kind in (fr.KIND_ENTRY, fr.KIND_BULK):
                    out = responses.setdefault(f.worker_id, [])
                    for s in f.columns["seq"].tolist():
                        out.append((int(s), 0, E.BLOCK_SHED, 0, 0))
                continue
            ws.attached = True
            self._claimed.discard(f.worker_id)
            for iid, raw in f.interns:
                ws.names[iid] = raw.decode("utf-8", "surrogatepass")
            self._fold_sheds(f.worker_id, f.shed_count)
            self.counters["frames"] += 1
            if f.kind in (fr.KIND_ENTRY, fr.KIND_BULK):
                n_rows += f.n
                if frame_meta is not None and f.n:
                    s = f.columns["seq"]
                    frame_meta.append(
                        (f.worker_id, int(s[0]), int(s[f.n - 1]), int(f.n))
                    )
                self._collect_entries(f, ws, groups, responses)
            elif f.kind == fr.KIND_EXIT:
                self._collect_exits(f, ws, exits)
            elif f.kind == fr.KIND_REASSERT:
                self._apply_reasserts(f, ws)
        if n_rows:
            self.counters["requests"] += n_rows
            if tele.enabled:
                tele.note_ipc_frames(len(payloads), n_rows)
        self._apply_exits(exits)
        if groups:
            self._decide_groups(groups, responses)
        self._send_responses(responses)
        if spj.enabled:
            # One drain span for the batch plus one per entry/bulk
            # frame carrying the (wid, seq range) correlation key the
            # worker's admit spans point at. The frame spans share the
            # drain interval: dequeue happened at t_drain, the verdict
            # left with _send_responses.
            t_end = _span_wall_ms()
            dur = t_end - t_drain
            spj.record(
                "drain", "engine", t_drain, dur,
                frames=len(payloads), rows=n_rows,
            )
            for wid, lo, hi, n in frame_meta or ():
                spj.record(
                    "frame", "engine", t_drain, dur,
                    wid=wid, seq_lo=lo, seq_hi=hi, rows=n,
                )
        return True

    # -- decode helpers -------------------------------------------------
    def _name(self, ws: _WorkerState, iid: int) -> Optional[str]:
        if iid == 0:
            return ""
        return ws.names.get(iid)

    def _collect_entries(self, f, ws, groups, responses) -> None:
        from sentinel_tpu_torch.models import constants as C

        cols = f.columns
        seqs = cols["seq"]
        ts = cols["ts"]
        acq = cols["acquire"]
        etype = cols["entry_type"]
        rid = cols["resource_id"]
        cid = cols["context_id"]
        oid = cols["origin_id"]
        aoff = cols["args_off"]
        alen = cols["args_len"]
        out = responses.setdefault(f.worker_id, [])
        now_ms = self._engine.clock.now_ms()
        for i in range(f.n):
            res = self._name(ws, int(rid[i]))
            ctx = self._name(ws, int(cid[i]))
            org = self._name(ws, int(oid[i]))
            if res is None or ctx is None or org is None:
                # Undecodable id (a skipped frame lost the intern): a
                # distinct fast shed, never a guess at a resource.
                out.append((int(seqs[i]), 0, E.BLOCK_SHED, 0, 0))
                self.counters["decode_drops"] += 1
                continue
            t = int(ts[i])
            if t < 0:
                t = now_ms
            args = ()
            if alen[i]:
                try:
                    args = fr.decode_args(
                        f.varbytes[int(aoff[i]) : int(aoff[i]) + int(alen[i])]
                    )
                except (ValueError, IndexError, fr.struct.error):
                    out.append((int(seqs[i]), 0, E.BLOCK_SHED, 0, 0))
                    self.counters["decode_drops"] += 1
                    continue
            et = int(etype[i])
            if et not in (0, 1):  # EntryType.IN / EntryType.OUT
                # Malformed wire value: the same per-row fast shed as
                # an undecodable id — one bad row must never abort the
                # rest of the drained batch.
                out.append((int(seqs[i]), 0, E.BLOCK_SHED, 0, 0))
                self.counters["decode_drops"] += 1
                continue
            trace = f.traces[i * 26 : (i + 1) * 26]
            key = (res, ctx or C.CONTEXT_DEFAULT_NAME, org,
                   C.EntryType(et))
            groups.setdefault(key, []).append(
                (f.worker_id, int(seqs[i]), t, int(acq[i]), args, trace)
            )

    def _collect_exits(self, f, ws, exits) -> None:
        cols = f.columns
        now_ms = self._engine.clock.now_ms()
        for i in range(f.n):
            res = self._name(ws, int(cols["resource_id"][i]))
            ctx = self._name(ws, int(cols["context_id"][i]))
            org = self._name(ws, int(cols["origin_id"][i]))
            if res is None or ctx is None or org is None:
                self.counters["decode_drops"] += 1
                continue
            et = int(cols["entry_type"][i])
            if et not in (0, 1):
                self.counters["decode_drops"] += 1
                continue
            t = int(cols["ts"][i])
            exits.append(
                (
                    f.worker_id, res, ctx, org, et,
                    now_ms if t < 0 else t,
                    int(cols["rt"][i]), int(cols["count"][i]),
                    int(cols["err"][i]), int(cols["spec"][i]),
                )
            )

    # -- exits ----------------------------------------------------------
    def _apply_exits(self, exits: List[tuple]) -> None:
        """Grouped columnar exits: one submit_exit_bulk per
        (rows, resource, speculative) — completions NEVER shed, and the
        per-worker live ledger gates which completions apply at all.

        Pairing comes FIRST: an exit that finds no live ledger
        admission is dropped (counted in ``exits_unpaired``), because
        each of its causes means the engine-side gauge was never (or no
        longer) charged — a policy-served caller whose entry never
        reached the engine (transient engine-dead read at the client),
        a dead-worker reap that already auto-exited the admission, or a
        post-reset completion from the dead world. Applying any of
        those would double-release and drive THREAD gauges negative;
        the reap remains the backstop for the complementary case
        (admission without a completion)."""
        if not exits:
            return
        from sentinel_tpu_torch.models import constants as C

        eng = self._engine
        by_key: Dict[tuple, list] = {}
        # One engine-lock resolve per distinct identity, not per row —
        # exits repeat identities heavily by construction, and the
        # engine lock is every submitting thread's critical section.
        # Rows resolve OUTSIDE the plane lock (_rows_for nests the
        # engine lock), then one plane-lock pass pairs the whole batch.
        rows_memo: Dict[tuple, object] = {}
        resolved: List[tuple] = []
        for (wid, res, ctx, org, et, ts, rt, count, err, spec) in exits:
            ident = (res, ctx or C.CONTEXT_DEFAULT_NAME, org, int(et))
            if ident in rows_memo:
                rows = rows_memo[ident]
            else:
                rows = rows_memo[ident] = self._rows_for(
                    ident[0], ident[1], ident[2], C.EntryType(ident[3])
                )
            if rows is None:
                continue  # pass-through admissions charge no gauge
            # spec: unknown(0)/speculative(1) release mirror
            resolved.append((wid, rows, res, spec != 2, ts, rt, count, err))
        unpaired = 0
        with self._lock:
            for (wid, rows, res, spec_b, ts, rt, count, err) in resolved:
                live = self._workers[wid].live
                # The exit's spec flag may disagree with the admit-time
                # ledger key (a worker's default speculative=None reads
                # as mirror-release True while a spec-off admit was
                # recorded False) — try the exact key, then the flipped
                # flag, and RELEASE with the admit-time flag (the
                # mirror was charged, or not, at admit).
                paired = False
                for k in (
                    (rows, res, spec_b, count),
                    (rows, res, not spec_b, count),
                ):
                    cur = live.get(k, 0)
                    if cur > 0:
                        if cur > 1:
                            live[k] = cur - 1
                        else:
                            live.pop(k, None)
                        spec_b = k[2]
                        paired = True
                        break
                if not paired:
                    # Partial-count completion: Entry.exit(count) may
                    # release fewer (or more) than the admit acquired —
                    # in-process parity applies the EXIT's count. Pair
                    # with any live admission of the same (rows,
                    # resource), preferring the exit's spec flag, and
                    # forget that admission so the reap cannot
                    # re-release it; the acquire/count difference stays
                    # charged, exactly like the in-process gauge.
                    cand = None
                    for k in live:
                        if k[0] == rows and k[1] == res:
                            cand = k
                            if k[2] == spec_b:
                                break
                    if cand is not None:
                        cur = live[cand]
                        if cur > 1:
                            live[cand] = cur - 1
                        else:
                            live.pop(cand, None)
                        spec_b = cand[2]
                        paired = True
                if not paired:
                    unpaired += 1
                    continue
                by_key.setdefault((rows, res, spec_b), []).append(
                    (wid, ts, rt, count, err)
                )
        if unpaired:
            self.counters["exits_unpaired"] += unpaired
        for (rows, res, spec_b), items in by_key.items():
            n = len(items)
            eng.submit_exit_bulk(
                rows, n,
                ts=np.fromiter((i[1] for i in items), np.int64, n),
                rt=np.fromiter((i[2] for i in items), np.int64, n),
                count=np.fromiter((i[3] for i in items), np.int64, n),
                err=np.fromiter((i[4] for i in items), np.int64, n),
                resource=res,
                speculative=spec_b,
            )
            self.counters["exits"] += n

    def _apply_reasserts(self, f, ws: _WorkerState) -> None:
        """Worker reconnect after an engine hot-restart: rebuild this
        worker's live-admission ledger from its re-assertion and charge
        what the NEW world never saw admitted — +1 device THREAD gauge
        per live admission (the restore installs gauges at zero; see
        failover.restore_durable) and the persistent mirror's live
        counter for mirror-charged admits. The worker replays its
        buffered dead-window completions BEHIND this frame on the same
        FIFO ring, so they pair against exactly these ledger lines."""
        from sentinel_tpu_torch.models import constants as C

        eng = self._engine
        if f.flags & fr.F_FRAME_RECONNECT:
            self.counters["worker_reconnects"] += 1
            if eng.telemetry.enabled:
                eng.telemetry.note_ipc_reconnect()
        cols = f.columns
        charged = 0
        for i in range(f.n):
            res = self._name(ws, int(cols["resource_id"][i]))
            ctx = self._name(ws, int(cols["context_id"][i]))
            org = self._name(ws, int(cols["origin_id"][i]))
            et = int(cols["entry_type"][i])
            cnt = int(cols["count"][i])
            acq = int(cols["acquire"][i])
            if res is None or ctx is None or org is None or cnt <= 0:
                self.counters["decode_drops"] += 1
                continue
            if et not in (0, 1):
                self.counters["decode_drops"] += 1
                continue
            rows = self._rows_for(
                res, ctx or C.CONTEXT_DEFAULT_NAME, org, C.EntryType(et)
            )
            if rows is None:
                continue  # pass-through admissions charge no gauge
            spec_b = int(cols["spec"][i]) == 1
            with self._lock:
                k = (rows, res, spec_b, acq)
                live = ws.live
                live[k] = live.get(k, 0) + cnt
            eng._submit_gauge_comp(rows, cnt)
            if spec_b and eng.speculative.enabled:
                eng.failover.fallback.assert_live(res, cnt)
            charged += cnt
        if charged:
            self.counters["reasserts"] += charged
            eng.flush()

    def _rows_for(self, res, ctx, org, etype):
        eng = self._engine
        with eng._lock:
            return eng.resolve_entry_rows(res, ctx, org, etype)

    # -- admissions -----------------------------------------------------
    def _decide_groups(self, groups: Dict[tuple, list], responses) -> None:
        """The batch window's dispatch shape, frame-fed: one columnar
        submit_bulk per (resource, ctx, origin, entry_type) group with
        per-request ts/acquire columns; rule classes bulk declines fall
        back to per-request submit_entry on the same flush."""
        eng = self._engine
        with self._lock:
            world = self._world
        settled: List[tuple] = []
        all_spec = True
        for (res, ctx, org, etype), reqs in groups.items():
            n = len(reqs)
            ts_col = np.fromiter((r[2] for r in reqs), np.int32, n)
            acq_col = np.fromiter((r[3] for r in reqs), np.int32, n)
            args_col = None
            if any(r[4] for r in reqs):
                args_col = [r[4] for r in reqs]
            try:
                op = eng.submit_bulk(
                    res, n, ts=ts_col, acquire=acq_col, context_name=ctx,
                    origin=org, entry_type=etype, args_column=args_col,
                )
                is_bulk = True
                if op is not None:
                    # Per-request trace identity (the group-level tag
                    # would record bounded group rows at fill).
                    op.trace = None
                    spec = op.spec_admitted is not None
                else:
                    spec = True  # pass-through: nothing to settle
            except ValueError:
                op = [
                    eng.submit_entry(
                        res, ctx, org, int(acq_col[i]), etype,
                        ts=int(ts_col[i]), args=reqs[i][4],
                    )
                    for i in range(n)
                ]
                is_bulk = False
                spec = False
            settled.append(((res, ctx, org, etype), reqs, op, is_bulk))
            all_spec = all_spec and spec
        if all_spec and eng.speculative.enabled:
            eng._spec_maybe_settle()
        elif eng.has_pending():
            eng.flush()
        for key, reqs, op, is_bulk in settled:
            if is_bulk:
                self._fan_out_bulk(key, reqs, op, responses, world)
            else:
                self._fan_out_entries(key, reqs, op, responses, world)

    def _fan_out_bulk(self, key, reqs, op, responses, world) -> None:
        res, ctx, org, _etype = key
        if op is None:
            for (wid, seq, _ts, _acq, _args, trace) in reqs:
                responses.setdefault(wid, []).append(
                    (seq, 1, E.PASS, 0, 0)
                )
                self._record_trace(trace, res, org, ctx, True, E.PASS, -1, "")
            return
        # A never-enqueued group (valve shed, cold-ceiling block) was
        # already trace-recorded by the engine's own record_bulk at
        # submit — the plane must not record the same rows again.
        recorded_at_submit = op.src is None
        flush_seq = -1
        pend = op._pending
        if pend is not None:
            flush_seq = pend._seq
        spec = op.spec_admitted is not None
        adm = op.admitted  # materializes a pending fetch if needed
        adm_l = adm.tolist()
        rsn_l = op.reason.tolist()
        wait_l = op.wait_ms.tolist()
        degraded = bool(op.spec_degraded) if spec else False
        fl = (fr.F_SPECULATIVE if spec else 0) | (
            fr.F_DEGRADED if degraded else 0
        )
        rows = op.rows
        with self._lock:
            ledger_live = self._world == world
            for i, (wid, seq, _ts, acq, _args, trace) in enumerate(reqs):
                responses.setdefault(wid, []).append(
                    (seq, 1 if adm_l[i] else 0, rsn_l[i], wait_l[i], fl)
                )
                if adm_l[i] and ledger_live:
                    live = self._workers[wid].live
                    k = (rows, res, spec or degraded, acq)
                    live[k] = live.get(k, 0) + 1
        if recorded_at_submit:
            return
        prov = "speculative" if spec else ""
        for i, (_wid, _seq, _ts, _acq, _args, trace) in enumerate(reqs):
            self._record_trace(
                trace, res, org, ctx, bool(adm_l[i]), int(rsn_l[i]),
                flush_seq, prov, degraded=degraded,
            )

    def _fan_out_entries(self, key, reqs, ops, responses, world) -> None:
        res, ctx, org, _etype = key
        verdicts = [op.verdict if op is not None else None for op in ops]
        with self._lock:
            ledger_live = self._world == world
            for (wid, seq, _ts, acq, _args, _trace), op, v in zip(
                reqs, ops, verdicts
            ):
                if op is None:
                    responses.setdefault(wid, []).append(
                        (seq, 1, E.PASS, 0, 0)
                    )
                    continue
                fl = (fr.F_SPECULATIVE if v.speculative else 0) | (
                    fr.F_DEGRADED if v.degraded else 0
                )
                responses.setdefault(wid, []).append(
                    (seq, 1 if v.admitted else 0, v.reason, v.wait_ms, fl)
                )
                if v.admitted and ledger_live:
                    live = self._workers[wid].live
                    k = (op.rows, res, v.speculative or v.degraded, acq)
                    live[k] = live.get(k, 0) + 1
        # Singles carry the engine's own trace records (submit_entry
        # stamped op.trace on the plane thread) — same stance as the
        # batch window's fallback path.

    def _record_trace(
        self, trace: bytes, res, org, ctx, admitted, reason, flush_seq,
        provenance, degraded: bool = False,
    ) -> None:
        tracer = self._engine.admission_trace
        if not tracer.enabled:
            return
        from sentinel_tpu_torch.metrics.admission_trace import TraceContext, TraceTag

        unpacked = fr.unpack_trace(trace)
        if unpacked is not None:
            tid, sid, sampled = unpacked
            tag = TraceTag(
                TraceContext(tid, sid, sampled), sampled, time.perf_counter()
            )
        else:
            tag = tracer.make_tag()
        tracer.record_admission(
            tag, res, org, ctx, admitted, reason, flush_seq,
            time.perf_counter(), degraded=degraded, provenance=provenance,
        )

    # -- responses ------------------------------------------------------
    def _send_responses(self, responses: Dict[int, list]) -> None:
        for wid, rows in responses.items():
            if not rows:
                continue
            ring = self.responses[wid]
            if ring is None and self.prefix:
                # Named mode: the worker attached through a PREVIOUS
                # plane's channel, but the ring name is deterministic —
                # re-attach and keep answering (the hot-restart case).
                try:
                    with self._lock:
                        ring = self._ensure_response_locked(wid)
                except (OSError, ValueError):
                    ring = None
            if ring is None:
                # Frames from a worker slot that never took a channel
                # from THIS plane object (stale attach): nowhere to
                # answer — the callers' waits fall to the policy path.
                self.counters["responses_dropped"] += len(rows)
                continue
            n = len(rows)
            seqs = np.fromiter((r[0] for r in rows), np.uint64, n)
            adm = np.fromiter((r[1] for r in rows), np.uint8, n)
            rsn = np.fromiter((r[2] for r in rows), np.int16, n)
            wms = np.fromiter((r[3] for r in rows), np.int32, n)
            fl = np.fromiter((r[4] for r in rows), np.uint8, n)
            cap = max(1, (self.slot_bytes - 64) // 16)
            for lo in range(0, n, cap):
                hi = min(n, lo + cap)
                payload = fr.encode_verdicts(
                    wid, seqs[lo:hi], adm[lo:hi], rsn[lo:hi], wms[lo:hi],
                    fl[lo:hi],
                )
                deadline = time.monotonic() + 0.25
                while not ring.try_push(payload):
                    if time.monotonic() > deadline:
                        self.counters["responses_dropped"] += hi - lo
                        break
                    time.sleep(0.0002)

    # -- control-plane duties -------------------------------------------
    def _publish_control(self, force: bool = False) -> None:
        from sentinel_tpu_torch.runtime.failover import HEALTHY, parse_policy

        eng = self._engine
        health = HEALTH_HEALTHY
        fo = eng.failover
        if fo.armed and fo.state != HEALTHY:
            health = HEALTH_DEGRADED
        if self._handoff:
            health = HEALTH_HANDOFF
        if self.closed:
            health = HEALTH_CLOSED
        self.control.beat_engine(health)
        if self._spans.enabled:
            # The engine IS the ruler source: its skew to the header
            # beat is ~0, but noting it keeps the journal meta uniform
            # across roles.
            _e, _h, _g, wall = self.control.engine_view()
            self._spans.note_ruler(wall)
        raw = config.get(config.FAILOVER_POLICY) or "open"
        if force or raw != self._policy_published:
            default, overrides = parse_policy(raw)
            self.control.publish_policy(default, overrides)
            self._policy_published = raw

    def _fold_sheds(self, wid: int, cumulative: int) -> None:
        ws = self._workers[wid]
        delta = (cumulative - ws.shed_seen) & 0xFFFFFFFF
        if 0 < delta < (1 << 31):
            ws.shed_seen = cumulative
            self.counters["worker_sheds"] += delta
            eng = self._engine
            eng.ingest.note_ipc_shed(delta)
            if eng.telemetry.enabled:
                eng.telemetry.note_ipc_shed(delta)

    def _check_workers(self, now: float) -> None:
        """Heartbeat sweep: a worker whose epoch stopped advancing for
        ``worker.dead.ms`` is dead — auto-exit its live admissions so
        the device AND mirror THREAD gauges return to exactly 0."""
        for wid in range(self.workers_max):
            ws = self._workers[wid]
            try:
                epoch, _wall, pid, shed = self.control.worker_view(wid)
            except (ValueError, TypeError):
                continue
            if pid == 0 and not ws.attached:
                continue
            if pid != 0:
                self._fold_sheds(wid, shed)
            if epoch != ws.last_epoch:
                ws.last_epoch = epoch
                ws.last_seen = now
                if pid != 0:
                    ws.attached = True
                    self._claimed.discard(wid)
                continue
            if not ws.attached:
                continue
            if (now - ws.last_seen) * 1e3 >= self.worker_dead_ms:
                self._reap_worker(wid, ws)

    def _reap_worker(self, wid: int, ws: _WorkerState) -> None:
        with self._lock:
            live, ws.live = ws.live, {}
            ws.attached = False
            self._claimed.discard(wid)
            ws.last_epoch = 0
            # The control slot is about to zero: a replacement worker
            # on this id restarts its cumulative shed count from 0, so
            # the fold baseline must follow or its first sheds read as
            # a giant (ignored) wraparound delta.
            ws.shed_seen = 0
        self.control.clear_worker(wid)
        self.counters["worker_deaths"] += 1
        eng = self._engine
        n_released = 0
        for (rows, res, spec_b, acq), n in live.items():
            if n <= 0:
                continue
            # Chunked to max_batch: submit_exit_bulk refuses oversized
            # groups, and an aborted release loop would leak every
            # remaining key's gauge charge forever (the ledger was
            # already swapped out).
            for lo in range(0, n, eng.max_batch):
                eng.submit_exit_bulk(
                    rows, min(eng.max_batch, n - lo), rt=0, count=acq,
                    err=0, resource=res, speculative=spec_b,
                )
            n_released += n
        if n_released:
            self.counters["auto_exits"] += n_released
            eng.flush()
        if eng.telemetry.enabled:
            eng.telemetry.note_ipc_worker_death(n_released)

    def on_engine_reset(self) -> None:
        """Engine.reset() hook: the engine just rebuilt its node rows
        and zeroed every gauge, so the per-worker live-admission
        ledgers reference a dead world — releasing them later would
        drive fresh gauges negative. Drop the ledgers (the reset
        already zeroed what they tracked) and bump the intern
        generation so workers re-intern against the fresh plane state."""
        with self._lock:
            self._world += 1
            for ws in self._workers:
                ws.live = {}
                ws.names = {}
        self.control.bump_intern_gen()

    # ------------------------------------------------------------------
    # readers / lifecycle
    # ------------------------------------------------------------------
    def live_workers(self) -> int:
        return sum(1 for ws in self._workers if ws.attached)

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
            live = [
                {
                    "worker_id": wid,
                    "attached": ws.attached,
                    "live_admissions": sum(ws.live.values()),
                    "interned": len(ws.names),
                }
                for wid, ws in enumerate(self._workers)
                if ws.attached or ws.names
            ]
        return {
            "enabled": True,
            "closed": self.closed,
            "workers_max": self.workers_max,
            "live_workers": self.live_workers(),
            "ring_slots": self.request.slots,
            "slot_bytes": self.slot_bytes,
            "ring_occupancy": round(self.request.occupancy(), 4),
            "wakeup": "adaptive" if self.adaptive_wakeup else "sleep",
            "intern_gen": self.control.intern_gen(),
            "engine_epoch": self.engine_epoch,
            "shm_prefix": self.prefix,
            "reattached": self.attached,
            "handoff": self._handoff,
            "counters": counters,
            "workers": live,
        }

    def handoff(self, wait_ms: Optional[int] = None) -> dict:
        """Planned live handoff, old-world side: publish HANDOFF on
        the control header (workers HOLD new admissions for the
        successor instead of serving policy verdicts), keep draining
        until the request ring stays empty for a couple of heartbeats
        (in-flight admissions and completions settle against THIS
        engine), then detach abandon-style — no CLOSED word, no worker
        reap, no unlink — leaving the rings, the worker ledgers and the
        HANDOFF word in place for the successor's attach (boot-epoch
        bump -> normal reconnect/reassert). Returns drain stats."""
        if self.closed:
            return {"drained": False, "drain_ms": 0.0}
        if wait_ms is None:
            wait_ms = config.get_int(config.IPC_HANDOFF_WAIT_MS, 3000)
        self._handoff = True
        try:
            self._publish_control(force=True)
        except (ValueError, TypeError):
            pass
        # Sustained-empty: one observation of an empty ring can race a
        # worker mid-push; require it to STAY empty for two heartbeat
        # periods (covers the worker window flusher and any frame the
        # drainer is currently deciding — the thread join below waits
        # out the final _drain_once).
        quiet_s = 2.0 * self.heartbeat_ms / 1e3
        deadline = time.monotonic() + max(1, int(wait_ms)) / 1e3
        t0 = time.monotonic()
        quiet_since: Optional[float] = None
        drained = False
        while time.monotonic() < deadline:
            if self.request.occupancy() > 0.0:
                quiet_since = None
            elif quiet_since is None:
                quiet_since = time.monotonic()
            elif time.monotonic() - quiet_since >= quiet_s:
                drained = True
                break
            time.sleep(0.001)
        drain_ms = (time.monotonic() - t0) * 1e3
        self.closed = True
        self._stop.set()
        for t in (self._thread, self._ctrl):
            if t is not None:
                t.join(5.0)
        self._thread = None
        self._ctrl = None
        # Straggler sweep: a worker that read a pre-HANDOFF health word
        # and then got descheduled can land a frame between the quiet
        # window's last occupancy read and the drainer join above — it
        # would otherwise sit in the ring as dead-world backlog (gen-
        # gated by the successor) with its caller parked to the policy
        # timeout. Answer it from THIS world before detaching.
        try:
            while self.request.occupancy() > 0.0:
                if not self._drain_once():
                    break
        except (ValueError, OSError):
            pass
        if self._engine.ipc_plane is self:
            self._engine.ipc_plane = None
        if self._spans.enabled:
            try:
                self._spans.spill()
            except OSError:
                pass
        self.request.close()
        for r in self.responses:
            if r is not None:
                r.close()
        self.control.close()
        return {"drained": drained, "drain_ms": round(drain_ms, 3)}

    def abandon(self) -> None:
        """Chaos/test hook: die like ``kill -9`` would — stop the
        threads and drop the shm mappings WITHOUT publishing CLOSED,
        reaping workers, or unlinking the segments. Workers observe a
        stale heartbeat (policy-served verdicts), the segments persist,
        and a new plane on the same prefix re-attaches warm. Never part
        of a graceful path — ``close()`` is."""
        if self.closed:
            return
        self.closed = True
        self._stop.set()
        for t in (self._thread, self._ctrl):
            if t is not None:
                t.join(5.0)
        self._thread = None
        self._ctrl = None
        if self._engine.ipc_plane is self:
            self._engine.ipc_plane = None
        self.request.close()
        for r in self.responses:
            if r is not None:
                r.close()
        self.control.close()

    def close(self, join_timeout_s: float = 5.0) -> None:
        """Stop serving: publish CLOSED (workers fail over to the
        policy snapshot), drain what is already in the ring, stop the
        drainer, release every worker's live admissions, and unlink the
        segments."""
        if self.closed:
            return
        self.closed = True
        try:
            self.control.set_health(HEALTH_CLOSED)
            self.control.beat_engine(HEALTH_CLOSED)
        except (ValueError, TypeError):
            pass
        self._stop.set()
        for t in (self._thread, self._ctrl):
            if t is not None:
                t.join(join_timeout_s)
                if t.is_alive():
                    self._engine.closed_dirty = True
        self._thread = None
        self._ctrl = None
        # Final sweep: live admissions from still-attached workers are
        # released like a death — the engine is leaving, its gauges
        # must not stay charged by callers it can no longer hear.
        for wid, ws in enumerate(self._workers):
            if ws.attached and ws.live:
                self._reap_worker(wid, ws)
        if self._engine.ipc_plane is self:
            self._engine.ipc_plane = None
        if self._spans.enabled:
            try:
                self._spans.spill()
            except OSError:
                pass
        self.request.destroy()
        for r in self.responses:
            if r is not None:
                r.destroy()
        self.control.destroy()
