"""Engine supervision, warm standby and planned handoff for the
multi-process plane (the JAX package's ``ipc/supervise.py``).

One engine process feeding N worker processes is a single point of
failure: with the engine dead, every worker serves the failover-policy
snapshot. This module closes the loop:

* the **supervisor** (this process) owns the named shared-memory segments
  and the cross-process primitives (the request ring's claim lock and the
  adaptive-wakeup doorbells, which cannot live in shared memory), so they
  outlive any one engine process;
* the **engine child** builds its Engine on the supervisor's device, loads
  rules (the ``setup`` callable), warm-starts from the durable checkpoint
  (``sentinel.tpu.failover.checkpoint.path`` through
  ``FailoverManager.restore_durable``), then attaches an
  :class:`~sentinel_tpu_torch.ipc.plane.IngestPlane` to the EXISTING rings,
  bumping the control header's engine-boot epoch;
* **workers** are worker-mode children: while the engine is dead they serve
  the policy snapshot; when the epoch bumps they re-intern, re-assert their
  live-admission ledgers and replay buffered completions
  (``ipc/worker.py``);
* a crashed engine child is respawned on :class:`~sentinel_tpu_torch.
  datasource.backoff.Backoff` (``sentinel.tpu.supervise.backoff.{ms,max.ms}``),
  bounded by ``sentinel.tpu.supervise.restarts.max`` (0 = unlimited).

With ``sentinel.tpu.supervise.standby.enabled`` the supervisor also keeps a
**warm standby**: a second engine child (``standby_main``) that loads its
kernel libraries, loads rules, launches the flush kernels on its own CUDA
context (``FailoverManager.warm_probe``) and re-warms from the durable
checkpoint every ``standby.warm.interval.ms``, parked off the rings. On the
primary's death the supervisor sends it ``attach`` instead of a cold
respawn, and pre-forks the next standby. ``EngineSupervisor.handoff()``
(SIGUSR1 to the serving child, or ``Engine.handoff_requested``) is a
**planned handoff**: the primary publishes HANDOFF (workers HOLD new
admissions instead of serving policy verdicts), settles its flushes, spills
a final durable checkpoint, marks its capture segments orderly-closed and
exits with ``EXIT_HANDOFF``; the standby takes over with no policy-served
verdict.

Where the port differs from the JAX package:

* every child runs on the supervisor's ``device`` (None = the card, as
  ``utils/device.resolve_device``); a supervisor asked for the card on a
  host without CUDA raises before it spawns anything;
* a standby whose ``warm_probe`` raises
  :class:`~sentinel_tpu_torch.utils.cuda_build.KernelBuildError` exits with
  ``EXIT_KERNEL_BUILD`` and never reports ready (the JAX standby logs a
  failed probe and reports ready anyway): a promotion then finds it
  unusable;
* the standby reports each periodic re-warm's time (``standby_rewarm_ms``);
* ``stop()`` also stops the workers ``spawn_worker`` started.

The public faces are ``api.run_engine_supervised`` and
``python -m sentinel_tpu_torch.ipc.launch --supervise``.
"""

from __future__ import annotations

import multiprocessing
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch

from sentinel_tpu_torch.utils.config import config
from sentinel_tpu_torch.utils.device import DeviceLike

# Exit code of an engine child that completed a planned handoff drain: the
# watcher promotes the standby at once, without backoff or restart budget.
EXIT_HANDOFF = 42
# Exit code of a standby whose flush kernels did not build or load.
EXIT_KERNEL_BUILD = 43


def check_device(device: DeviceLike) -> None:
    """Refuse, before any child is spawned, a device this host cannot give:
    None or a CUDA device without CUDA. Opens no CUDA context."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sentinel_tpu_torch: the engine supervisor's children run on the card, and no CUDA device is "
            "available; pass device='cpu' to supervise CPU engines"
        )


@dataclass
class PlaneHandles:
    """What an engine child (and the worker channels) need to share one set
    of named segments across engine restarts. Picklable through
    ``multiprocessing`` spawn; the lock and semaphores travel by mp's own
    reduction, so every consumer must descend from the supervisor."""

    prefix: str
    workers_max: int
    ring_slots: int
    slot_bytes: int
    resp_slots: int
    n_workers: int
    request_lock: object = field(repr=False, default=None)
    request_doorbell: object = field(repr=False, default=None)
    response_doorbells: Optional[List[object]] = field(repr=False, default=None)

    def channel(self, worker_id: int):
        """The worker-side attach record for one slot (the supervised twin
        of ``IngestPlane.channel``: the names are deterministic)."""
        from sentinel_tpu_torch.ipc.worker import PlaneChannel

        bells = self.response_doorbells or []
        return PlaneChannel(
            control_name=f"{self.prefix}-ctl", request_name=f"{self.prefix}-req",
            response_name=f"{self.prefix}-resp{worker_id}", ring_slots=self.ring_slots,
            slot_bytes=self.slot_bytes, resp_slots=self.resp_slots, workers_max=self.workers_max,
            request_lock=self.request_lock, request_doorbell=self.request_doorbell,
            response_doorbell=bells[worker_id] if worker_id < len(bells) else None,
        )


def make_handles(ctx, prefix: str, n_workers: int) -> PlaneHandles:
    """The shared primitives from the current config (the supervisor side;
    the geometry keys replay into every child)."""
    adaptive = (config.get(config.IPC_WAKEUP) or "sleep").strip().lower() == "adaptive"
    workers_max = max(1, config.get_int(config.IPC_WORKERS_MAX, 8))
    return PlaneHandles(
        prefix=prefix, workers_max=workers_max, ring_slots=config.get_int(config.IPC_RING_SLOTS, 1024),
        slot_bytes=max(1024, config.get_int(config.IPC_SLOT_BYTES, 16384)),
        resp_slots=config.get_int(config.IPC_RESP_SLOTS, 1024), n_workers=max(0, min(n_workers, workers_max)),
        request_lock=ctx.Lock(), request_doorbell=ctx.Semaphore(0) if adaptive else None,
        response_doorbells=[ctx.Semaphore(0) for _ in range(workers_max)] if adaptive else None,
    )


def _unlink_stale(name: str) -> None:
    """Remove a segment left by a DEAD supervisor. Safe: the engine child and
    the workers are daemon children of the supervisor, so nothing live can
    still map these names."""
    from multiprocessing import shared_memory

    try:
        s = shared_memory.SharedMemory(name)
    except (FileNotFoundError, OSError, ValueError):
        return
    try:
        s.close()
        s.unlink()
    except OSError:
        pass


def create_segments(handles: PlaneHandles):
    """Create every named segment from the SUPERVISOR, so that they outlive
    any one engine process and workers can attach before the first engine
    is up. A segment left by a crashed supervisor is unlinked and created
    fresh. Returns the owner objects: keep them alive; ``destroy_segments``
    unlinks them at the final shutdown."""
    from sentinel_tpu_torch.ipc.ring import ControlBlock, ShmRing

    def fresh(factory, name):
        try:
            return factory()
        except FileExistsError:
            _unlink_stale(name)
            return factory()

    p = handles.prefix
    segs = [fresh(lambda: ControlBlock(f"{p}-ctl", handles.workers_max, create=True), f"{p}-ctl")]
    segs.append(fresh(lambda: ShmRing(f"{p}-req", handles.ring_slots, handles.slot_bytes, create=True), f"{p}-req"))
    for wid in range(handles.n_workers):
        name = f"{p}-resp{wid}"
        segs.append(fresh(lambda name=name: ShmRing(name, handles.resp_slots, handles.slot_bytes, create=True), name))
    return segs


def destroy_segments(segs) -> None:
    for s in segs:
        try:
            s.destroy()
        except Exception:
            pass


def _child_engine(overrides, device):
    """Replay the supervisor's config into this child and build its engine
    on ``device``. The child builds its plane itself from the handles: a
    replayed ipc.enabled=true must not start a second, anonymous plane."""
    for k, v in (overrides or {}).items():
        config.set(k, v)
    config.set(config.IPC_ENABLED, "false")
    from sentinel_tpu_torch.core import api

    return api.reset(device=device)


def _run_setup(eng, setup, setup_args, who: str) -> None:
    from sentinel_tpu_torch.utils.record_log import record_log

    if setup is None:
        return
    try:
        setup(eng, *(setup_args or ()))
    except Exception:
        record_log.error(f"[{who}] engine setup failed — serving without it", exc_info=True)


def _on_term(stop: threading.Event) -> None:
    def handler(_sig, _frm):
        stop.set()

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)


def engine_main(handles: PlaneHandles, overrides, setup, setup_args, device=None) -> None:
    """Spawn target: one engine child's whole life.

    Rules first (``setup``), then the durable warm start (the restore wants
    the rule indexes built so that the fingerprints match), and the plane
    LAST: workers reconnect only once the warm state is installed, so their
    ledger re-assertions land on the restored world."""
    from sentinel_tpu_torch.ipc.plane import IngestPlane
    from sentinel_tpu_torch.utils.record_log import record_log

    stop = threading.Event()
    _on_term(stop)
    eng = _child_engine(overrides, device)
    _run_setup(eng, setup, setup_args, "supervise")
    if eng.failover.armed and eng.failover.durable_path:
        try:
            eng.failover.restore_durable()
        except Exception:
            # restore_durable never raises by contract; a warm start is an
            # optimization, never a liveness requirement.
            record_log.error("[supervise] durable restore raised — cold start", exc_info=True)
    IngestPlane(eng, handles=handles)
    record_log.info("[supervise] engine child up (pid %d, epoch %d, %s)", os.getpid(),
                    eng.ipc_plane.engine_epoch, eng.device)
    raise SystemExit(_serve(eng, stop))


def _serve(eng, stop: threading.Event) -> int:
    """Park an ATTACHED engine child until shutdown. Returns the exit code:
    0 after a SIGTERM close, ``EXIT_HANDOFF`` after a planned handoff drain
    (SIGUSR1 or ``Engine.handoff_requested``)."""
    handoff_evt = threading.Event()

    def _on_usr1(_sig, _frm):
        handoff_evt.set()

    try:
        signal.signal(signal.SIGUSR1, _on_usr1)
    except (ValueError, OSError):
        pass
    requested = getattr(eng, "handoff_requested", None)
    while not stop.is_set():
        if handoff_evt.is_set() or (requested is not None and requested.is_set()):
            _perform_handoff(eng)
            return EXIT_HANDOFF
        stop.wait(0.2)
    eng.close()
    return 0


def _perform_handoff(eng) -> None:
    """The old world's half of a planned handoff, in drain order: (1) arm a
    one-shot checkpoint, so that the settling flush carries the freshest
    state; (2) ``plane.handoff()``: publish HANDOFF (workers hold), drain
    the request ring until it stays empty, detach without the CLOSED word,
    so that the rings and the workers' ledgers survive for the successor;
    (3) settle the flushes in flight; (4) spill the final durable checkpoint
    synchronously; (5) mark the capture segments orderly-closed, so that the
    successor's death sweep files them as ``frozen-close-*``; (6) close the
    engine (the plane is already detached: no CLOSED is published)."""
    from sentinel_tpu_torch.utils.record_log import record_log

    fo = eng.failover
    durable = fo.armed and fo.durable_path
    if durable:
        fo.request_checkpoint()
    plane = eng.ipc_plane
    if plane is not None:
        try:
            record_log.info("[supervise] handoff drain: %s", plane.handoff())
        except Exception:
            record_log.error("[supervise] handoff drain failed — closing anyway", exc_info=True)
    try:
        eng.flush()
        eng.drain()
    except Exception:
        record_log.error("[supervise] handoff settle failed", exc_info=True)
    if durable:
        fo.spill_durable_now()
    if eng.capture is not None:
        try:
            eng.capture.mark_orderly_close("handoff")
        except Exception:
            record_log.error("[supervise] orderly-close marker failed", exc_info=True)
    eng.close()


def standby_main(handles: PlaneHandles, overrides, setup, setup_args, conn, device=None) -> None:
    """Spawn target: a warm STANDBY engine child. It does what
    ``engine_main`` does but attach: builds its engine on ``device``, loads
    rules, warm-starts from the durable checkpoint, launches the flush
    kernels (``warm_probe``), then parks, re-warming from the durable file
    every ``standby.warm.interval.ms``, until the supervisor sends
    ``attach`` (the primary died or drained). Then it restores once more,
    re-arms the flight recorder and attaches to the existing rings.

    Pipe protocol: the child sends ``("ready", warm_boot_ms)`` once warm,
    ``("rewarm", ms)`` after each periodic re-warm and ``("attached",
    attach_ms)`` once its plane is up; the parent sends ``"attach"`` or
    ``"stop"``. A kernel build error in the warm probe ends the child with
    ``EXIT_KERNEL_BUILD`` before any ``ready``. The flight recorder stays
    DISARMED until the promotion: a standby's journal would run its boot's
    death sweep against the LIVE primary's segments."""
    from sentinel_tpu_torch.ipc.plane import IngestPlane
    from sentinel_tpu_torch.utils.cuda_build import KernelBuildError
    from sentinel_tpu_torch.utils.record_log import record_log

    stop = threading.Event()
    _on_term(stop)
    t0 = time.perf_counter()
    cap_override = (overrides or {}).get(config.CAPTURE_ENABLED, "")
    eng = _child_engine(dict(overrides or {}, **{config.CAPTURE_ENABLED: "false"}), device)
    _run_setup(eng, setup, setup_args, "standby")
    warm_s = max(0.05, config.get_int(config.SUPERVISE_STANDBY_WARM_MS, 2000) / 1e3)

    def _rewarm() -> float:
        t = time.perf_counter()
        if eng.failover.armed and eng.failover.durable_path:
            try:
                eng.failover.restore_durable()
            except Exception:
                record_log.error("[standby] durable re-warm raised — keeping the last state", exc_info=True)
        return (time.perf_counter() - t) * 1e3

    _rewarm()
    try:
        # The restore may have probed already; this makes sure the flush
        # kernels are loaded and launched on this context either way.
        eng.failover.warm_probe()
    except KernelBuildError:
        record_log.error("[standby] the flush kernels did not build — not ready", exc_info=True)
        eng.close()
        raise SystemExit(EXIT_KERNEL_BUILD)
    except Exception:
        record_log.error("[standby] warm probe failed — reporting ready anyway", exc_info=True)
    warm_boot_ms = (time.perf_counter() - t0) * 1e3
    try:
        conn.send(("ready", warm_boot_ms))
    except (OSError, ValueError):
        return
    record_log.info("[standby] warm and parked (pid %d, %.0f ms boot, %s)", os.getpid(), warm_boot_ms, eng.device)
    while not stop.is_set():
        try:
            msg = conn.recv() if conn.poll(warm_s) else None
        except (EOFError, OSError):
            return  # the supervisor died: the fleet dies with it
        if msg == "stop":
            eng.close()
            return
        if msg != "attach":
            if msg is None:
                ms = _rewarm()
                try:
                    conn.send(("rewarm", ms))
                except (OSError, ValueError):
                    return
            continue
        # Promotion: a last warm pass, the flight recorder re-armed (its
        # death sweep now runs after the predecessor stopped writing), and
        # the plane LAST, so that worker re-assertions land on this world.
        _rewarm()
        if cap_override:
            config.set(config.CAPTURE_ENABLED, cap_override)
            try:
                from sentinel_tpu_torch.runtime.capture import maybe_build_capture

                eng.capture = maybe_build_capture(eng)
            except Exception:
                record_log.error("[standby] capture re-arm failed — serving without the flight recorder",
                                 exc_info=True)
        t_att = time.perf_counter()
        IngestPlane(eng, handles=handles)
        attach_ms = (time.perf_counter() - t_att) * 1e3
        try:
            conn.send(("attached", attach_ms))
        except (OSError, ValueError):
            pass
        record_log.info("[standby] took over (pid %d, epoch %d, attach %.1f ms)", os.getpid(),
                        eng.ipc_plane.engine_epoch, attach_ms)
        raise SystemExit(_serve(eng, stop))
    eng.close()


class EngineSupervisor:
    """Keeps one engine child alive on the shared rings (see the module
    doc). ``kill_engine()`` is the chaos hook of the tests and the smoke.

    ``setup_args`` travel to each child through its spawn pipe: keep them
    small. Above a pipe's 64 KiB, each ``start()`` waits until the child has
    imported its target's modules, and the children boot one after another."""

    def __init__(self, setup=None, setup_args: Sequence[object] = (), n_workers: int = 0,
                 prefix: Optional[str] = None, device: DeviceLike = None) -> None:
        from sentinel_tpu_torch.datasource.backoff import Backoff

        check_device(device)
        self.device = device
        self._ctx = multiprocessing.get_context("spawn")
        if prefix is None:
            prefix = (config.get(config.IPC_SHM_PREFIX) or "").strip()
        if not prefix:
            prefix = f"stpu-{os.getpid()}-{int(time.time() * 1000) & 0xFFFFFF:x}"
        self.prefix = prefix
        # Children replay the runtime config: the prefix must be in it so
        # that any path that re-reads config agrees on the names.
        config.set(config.IPC_SHM_PREFIX, prefix)
        self.handles = make_handles(self._ctx, prefix, n_workers)
        self._segs = create_segments(self.handles)
        self._setup = setup
        self._setup_args = tuple(setup_args or ())
        self._overrides = config.runtime_snapshot("sentinel.tpu.")
        self.restarts = 0
        self.restarts_max = max(0, config.get_int(config.SUPERVISE_RESTARTS_MAX, 0))
        self._backoff = Backoff(
            base_s=max(1, config.get_int(config.SUPERVISE_BACKOFF_MS, 500)) / 1e3,
            cap_s=max(1, config.get_int(config.SUPERVISE_BACKOFF_MAX_MS, 10000)) / 1e3,
        )
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.gave_up = False
        # Warm standby: one pre-forked, warmed engine child parked off the
        # rings; on the primary's death (or a planned handoff) it attaches
        # instead of a cold respawn, and the next one is pre-forked at once.
        self.standby_enabled = config.get_bool(config.SUPERVISE_STANDBY, False)
        self.standby_takeovers = 0
        self.handoffs = 0
        self.standby_warm_boot_ms: Optional[float] = None
        self.standby_attach_ms: Optional[float] = None
        self._standby: Optional[dict] = None
        # Set while a promotion runs: the next standby is not spawned yet.
        self._promoting = threading.Event()
        # Promoted standbys keep their pipe here (the reader thread still
        # takes the "attached" ack after the promotion).
        self._retired: List[dict] = []
        self._workers: List[object] = []
        self._proc = self._spawn_engine()
        if self.standby_enabled:
            self._standby = self._spawn_standby()
        self._watcher = threading.Thread(target=self._watch, name="sentinel-supervisor", daemon=True)
        self._watcher.start()

    # -- lifecycle ------------------------------------------------------
    def _spawn_engine(self):
        p = self._ctx.Process(target=engine_main, args=(self.handles, self._overrides, self._setup,
                                                        self._setup_args, self.device), daemon=True)
        p.start()
        return p

    def _spawn_standby(self) -> dict:
        parent, child = self._ctx.Pipe()
        p = self._ctx.Process(target=standby_main, args=(self.handles, self._overrides, self._setup,
                                                         self._setup_args, child, self.device), daemon=True)
        p.start()
        child.close()
        sb = {"proc": p, "conn": parent, "ready": threading.Event(), "attached": threading.Event(),
              "warm_ms": None, "attach_ms": None, "rewarm_ms": None}
        threading.Thread(target=self._standby_reader, args=(sb,), name="sentinel-standby-reader",
                         daemon=True).start()
        return sb

    def _standby_reader(self, sb: dict) -> None:
        """Owns every RECEIVE on one standby's pipe (sends may come from any
        thread); runs until the child closes its end."""
        while True:
            try:
                msg = sb["conn"].recv()
            except (EOFError, OSError):
                return
            if not (isinstance(msg, tuple) and msg):
                continue
            if msg[0] == "ready":
                sb["warm_ms"] = msg[1]
                sb["ready"].set()
            elif msg[0] == "rewarm":
                sb["rewarm_ms"] = msg[1]
            elif msg[0] == "attached":
                sb["attach_ms"] = msg[1]
                sb["attached"].set()

    def _promote_standby(self, planned: bool, timeout_s: float = 180.0) -> bool:
        """Hand the rings to the warm standby: wait for its ready report (a
        standby still booting is still ahead of a cold respawn), send
        ``attach``, adopt it as the serving child and pre-fork the next
        standby. False (the caller falls back to a cold respawn) when no
        usable standby exists."""
        sb = self._standby
        if sb is None:
            return False
        self._promoting.set()
        self._standby = None
        try:
            return self._promote(sb, planned, timeout_s)
        finally:
            self._promoting.clear()

    def _promote(self, sb: dict, planned: bool, timeout_s: float) -> bool:
        from sentinel_tpu_torch.utils.record_log import record_log

        proc = sb["proc"]
        deadline = time.monotonic() + timeout_s
        while proc.is_alive() and not sb["ready"].is_set() and time.monotonic() < deadline \
                and not self._stop.is_set():
            time.sleep(0.01)
        if not proc.is_alive() or not sb["ready"].is_set():
            record_log.warn("[supervise] standby unusable (alive=%s ready=%s exit %s) — falling back to a cold "
                            "respawn", proc.is_alive(), sb["ready"].is_set(), proc.exitcode)
            if proc.is_alive():
                proc.terminate()
                proc.join(5.0)
            try:
                sb["conn"].close()
            except OSError:
                pass
            return False
        try:
            sb["conn"].send("attach")
        except (OSError, ValueError):
            return False
        self.standby_warm_boot_ms = sb["warm_ms"]
        # Counted before the child is adopted: whoever sees the new engine
        # (handoff(), a caller polling engine_pid()) sees the count too. A
        # takeover is not a restart: the budget and the backoff meter crash
        # loops of the cold path, and a planned drain is not a crash.
        if planned:
            self.handoffs += 1
        else:
            self.standby_takeovers += 1
        with self._lock:
            self._proc = proc
        self._retired.append(sb)
        deadline = time.monotonic() + timeout_s
        while not sb["attached"].wait(0.05):
            if self._stop.is_set() or not proc.is_alive() or time.monotonic() > deadline:
                break
        if sb["attached"].is_set():
            self.standby_attach_ms = sb["attach_ms"]
        record_log.info("[supervise] standby promoted (pid %d, %s, warm boot %.0f ms)", proc.pid,
                        "planned handoff" if planned else "crash takeover", sb["warm_ms"] or -1.0)
        if not self._stop.is_set():
            self._standby = self._spawn_standby()
        return True

    def _watch(self) -> None:
        from sentinel_tpu_torch.utils.record_log import record_log

        spawned_at = time.monotonic()
        while not self._stop.is_set():
            with self._lock:
                p = self._proc
            p.join(timeout=0.2)
            if p.is_alive():
                # A child that stayed up past the backoff cap ran healthy:
                # the next incident pays the base delay again.
                if self._backoff.failures and time.monotonic() - spawned_at > self._backoff.cap:
                    self._backoff.reset()
                continue
            if self._stop.is_set():
                continue
            planned = p.exitcode == EXIT_HANDOFF
            if self.standby_enabled and self._promote_standby(planned):
                spawned_at = time.monotonic()
                continue
            if self.restarts_max and self.restarts >= self.restarts_max:
                self.gave_up = True
                record_log.error("[supervise] engine died (exit %s) and the restart budget (%d) is spent — giving "
                                 "up; workers stay on the policy snapshot", p.exitcode, self.restarts_max)
                return
            delay = self._backoff.next_delay()
            record_log.warn("[supervise] engine died (exit %s) — restarting in %.2fs (restart #%d)", p.exitcode,
                            delay, self.restarts + 1)
            if self._stop.wait(delay):
                return
            with self._lock:
                if self._stop.is_set():
                    return
                self.restarts += 1
                self._proc = self._spawn_engine()
            spawned_at = time.monotonic()

    def spawn_context(self):
        """The supervisor's spawn context: queues for worker targets come from
        here so that they travel to descendants."""
        return self._ctx

    def spawn_worker(self, target, worker_id: int, args: Sequence[object] = ()):
        """One worker-mode child on slot ``worker_id`` (the supervised twin of
        ``api.run_workers``' spawn; the supervisor owns the id space)."""
        from sentinel_tpu_torch.ipc import worker_mode

        p = self._ctx.Process(target=worker_mode.worker_main, args=(self.handles.channel(worker_id), worker_id,
                                                                    self._overrides, target, tuple(args)),
                              daemon=True)
        p.start()
        self._workers.append(p)
        return p

    # -- observability / chaos -----------------------------------------
    def engine_pid(self) -> Optional[int]:
        with self._lock:
            return self._proc.pid if self._proc.is_alive() else None

    def _current_standby(self, timeout_s: float) -> Optional[dict]:
        """The standby, waiting out a promotion that has not spawned the
        next one yet; None when standby mode is off or none is coming."""
        deadline = time.monotonic() + timeout_s
        while True:
            sb = self._standby
            if sb is not None or not self._promoting.is_set() or time.monotonic() > deadline:
                return sb
            time.sleep(0.01)

    def standby_pid(self) -> Optional[int]:
        sb = self._standby
        return sb["proc"].pid if sb is not None and sb["proc"].is_alive() else None

    @property
    def standby_rewarm_ms(self) -> Optional[float]:
        """The current standby's last periodic re-warm, in ms (None before
        its first)."""
        sb = self._standby
        return None if sb is None else sb["rewarm_ms"]

    def alive(self) -> bool:
        with self._lock:
            return self._proc.is_alive()

    def kill_engine(self) -> Optional[int]:
        """SIGKILL the serving engine child: no cleanup, no CLOSED word.
        Returns the killed pid (None when already down)."""
        with self._lock:
            p = self._proc
        if not p.is_alive() or p.pid is None:
            return None
        os.kill(p.pid, signal.SIGKILL)
        return p.pid

    def kill_standby(self) -> Optional[int]:
        """SIGKILL the parked standby (chaos): the next death of the primary
        then finds no usable standby and respawns cold."""
        sb = self._current_standby(30.0)
        if sb is None or not sb["proc"].is_alive():
            return None
        os.kill(sb["proc"].pid, signal.SIGKILL)
        sb["proc"].join(5.0)
        return sb["proc"].pid

    def wait_standby_ready(self, timeout_s: float = 180.0) -> bool:
        """Block until the CURRENT standby reports warm. False when standby
        mode is off, or the report never comes (the child died or its
        kernels did not build)."""
        deadline = time.monotonic() + timeout_s
        sb = self._current_standby(timeout_s)
        if sb is None:
            return False
        while not sb["ready"].wait(0.05):
            if not sb["proc"].is_alive() or time.monotonic() > deadline:
                return sb["ready"].is_set()
        return True

    def handoff(self, timeout_s: float = 120.0) -> bool:
        """Operator-triggered planned handoff: SIGUSR1 the serving engine; it
        drains (workers HOLD on the HANDOFF word), spills a final durable
        checkpoint and exits ``EXIT_HANDOFF``; the watcher promotes the
        standby. True once a DIFFERENT engine child publishes a fresh
        heartbeat."""
        with self._lock:
            p = self._proc
        if not p.is_alive() or p.pid is None:
            return False
        old_pid = p.pid
        try:
            os.kill(old_pid, signal.SIGUSR1)
        except OSError:
            return False
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and not self._stop.is_set():
            with self._lock:
                cur = self._proc
            if cur.pid != old_pid and cur.is_alive() and self.wait_engine_up(timeout_s=1.0):
                return True
            time.sleep(0.02)
        return False

    def wait_engine_up(self, timeout_s: float = 120.0) -> bool:
        """Block until the CURRENT engine child publishes a heartbeat (the
        control header's wall time fresh): readiness, not liveness."""
        from sentinel_tpu_torch.ipc.ring import HEALTH_CLOSED, ControlBlock, _wall_ms

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                ctl = ControlBlock(f"{self.prefix}-ctl", self.handles.workers_max)
            except (OSError, ValueError):
                time.sleep(0.05)
                continue
            try:
                _epoch, health, _gen, wall = ctl.engine_view()
            finally:
                ctl.close()
            if wall and health != HEALTH_CLOSED and _wall_ms() - wall < 1000:
                return True
            time.sleep(0.05)
        return False

    def stop(self, timeout_s: float = 10.0) -> None:
        """Shutdown: stop supervising, SIGTERM the engine child (it closes its
        engine), stop the standby and the workers, then unlink the segments.
        Leaves no child alive."""
        self._stop.set()
        with self._lock:
            p = self._proc
        if p.is_alive() and p.pid is not None:
            try:
                os.kill(p.pid, signal.SIGTERM)
            except OSError:
                pass
        p.join(timeout_s)
        if p.is_alive():
            p.terminate()
            p.join(5.0)
        self._watcher.join(timeout=5.0)
        sb = self._standby
        self._standby = None
        if sb is not None:
            try:
                sb["conn"].send("stop")
            except (OSError, ValueError):
                pass
            sb["proc"].join(timeout_s)
            if sb["proc"].is_alive():
                sb["proc"].terminate()
                sb["proc"].join(5.0)
            try:
                sb["conn"].close()
            except OSError:
                pass
        for w in self._workers:
            if w.is_alive():
                w.terminate()
            w.join(5.0)
        for sb in self._retired:
            try:
                sb["conn"].close()
            except OSError:
                pass
        destroy_segments(self._segs)
        self._segs = []


def probe_live(cli, resource: str, timeout_s: float, entry_timeout_ms: int) -> None:
    """Probe until the engine serves a device-backed verdict."""
    deadline = time.monotonic() + timeout_s
    while True:
        v = cli.entry(resource, timeout_ms=entry_timeout_ms)
        if v.admitted and not v.degraded:
            cli.exit(resource)
            return
        if time.monotonic() > deadline:
            raise RuntimeError("engine never served a live verdict")
        time.sleep(0.02)


def measure_kill_outage(sup, cli, resource: str, timeout_s: float = 180.0, entry_timeout_ms: int = 3000) -> dict:
    """``kill -9`` the serving child and time how long callers stay on policy
    verdicts until an engine serves again; raises without a recovery."""
    killed_pid = sup.kill_engine()
    t0 = time.monotonic()
    saw_dead = False
    policy_served = 0
    while time.monotonic() - t0 < timeout_s:
        v = cli.entry(resource, timeout_ms=entry_timeout_ms)
        if v.degraded or not v.admitted:
            # Policy-served (the engine read dead) or the dead world's frame
            # shed by the new plane: the outage, from the caller's seat.
            saw_dead = True
            policy_served += 1
        else:
            cli.exit(resource)
            if saw_dead:
                outage_ms = (time.monotonic() - t0) * 1e3
                # The reconnect rides the beat loop and may land a tick after
                # the first live verdict.
                grace = time.monotonic() + 10.0
                while cli.counters.get("reconnects", 0) == 0 and time.monotonic() < grace:
                    time.sleep(0.05)
                return {"outage_ms": outage_ms, "policy_served": policy_served, "restarts": sup.restarts,
                        "reconnects": cli.counters.get("reconnects", 0), "killed_pid": killed_pid}
        time.sleep(0.002)
    raise RuntimeError(f"no recovery within {timeout_s}s (restarts={sup.restarts}, "
                       f"takeovers={sup.standby_takeovers})")


def measure_restart_outage(setup, resource: str, prefix: Optional[str] = None, timeout_s: float = 180.0,
                           entry_timeout_ms: int = 3000, device: DeviceLike = None) -> dict:
    """The zero -> kill -> recover cycle as one measurement (the launcher's
    restart smoke and the chaos tests): start a supervised engine, probe
    from an IngestClient in THIS process until it serves device-backed
    verdicts, ``kill -9`` the engine child, and time how long callers stay
    on policy verdicts until the restarted engine serves again. Raises
    without a recovery."""
    from sentinel_tpu_torch.ipc.worker import IngestClient

    sup = EngineSupervisor(setup=setup, n_workers=1, prefix=prefix, device=device)
    cli = None
    try:
        if not sup.wait_engine_up(timeout_s):
            raise RuntimeError("supervised engine never came up")
        cli = IngestClient(sup.handles.channel(0), 0)
        probe_live(cli, resource, timeout_s, entry_timeout_ms)
        return measure_kill_outage(sup, cli, resource, timeout_s, entry_timeout_ms)
    finally:
        if cli is not None:
            cli.close()
        sup.stop()


def _standby_supervisor(setup, prefix, device, what: str) -> EngineSupervisor:
    if not config.get_bool(config.SUPERVISE_STANDBY, False):
        # Measuring the cold path under this name would report a lie.
        raise RuntimeError(f"{what} needs {config.SUPERVISE_STANDBY}=true")
    return EngineSupervisor(setup=setup, n_workers=1, prefix=prefix, device=device)


def measure_standby_outage(setup, resource: str, prefix: Optional[str] = None, timeout_s: float = 180.0,
                           entry_timeout_ms: int = 30000, device: DeviceLike = None) -> dict:
    """``measure_restart_outage`` with a warm standby armed: the supervisor
    promotes the pre-forked standby instead of a cold boot, so the outage is
    about the detection window (``ipc.engine.dead.ms``). The caller must
    have set ``sentinel.tpu.supervise.standby.enabled``."""
    from sentinel_tpu_torch.ipc.worker import IngestClient

    sup = _standby_supervisor(setup, prefix, device, "measure_standby_outage")
    cli = None
    try:
        if not sup.wait_engine_up(timeout_s):
            raise RuntimeError("supervised engine never came up")
        if not sup.wait_standby_ready(timeout_s):
            raise RuntimeError("standby never reported warm")
        cli = IngestClient(sup.handles.channel(0), 0)
        probe_live(cli, resource, timeout_s, entry_timeout_ms)
        out = measure_kill_outage(sup, cli, resource, timeout_s, entry_timeout_ms)
        out.update(standby_takeovers=sup.standby_takeovers, standby_warm_boot_ms=sup.standby_warm_boot_ms,
                   standby_attach_ms=sup.standby_attach_ms)
        return out
    finally:
        if cli is not None:
            cli.close()
        sup.stop()


def probe_through_handoff(sup, cli, resource: str, timeout_s: float = 180.0,
                          entry_timeout_ms: int = 30000) -> dict:
    """Probe continuously through ``sup.handoff()`` until the successor has
    served three live verdicts. Returns the worst gap between consecutive
    live verdicts (callers were HELD, not failed, that long) and the
    policy-served and not-admitted counts, which an orderly handoff keeps
    at zero."""
    pol0 = cli.counters.get("policy_served", 0)
    old_pid = sup.engine_pid()
    result: dict = {}
    ho = threading.Thread(target=lambda: result.update(ok=sup.handoff(timeout_s)), daemon=True)
    t0 = time.monotonic()
    ho.start()
    last_live = t0
    max_gap = 0.0
    not_admitted = 0
    live_after = 0
    while time.monotonic() - t0 < timeout_s:
        v = cli.entry(resource, timeout_ms=entry_timeout_ms)
        now = time.monotonic()
        if v.admitted and not v.degraded:
            cli.exit(resource)
            max_gap = max(max_gap, now - last_live)
            last_live = now
            if not ho.is_alive() and sup.engine_pid() not in (None, old_pid):
                live_after += 1
                if live_after >= 3:
                    break
        else:
            not_admitted += 1
        time.sleep(0.002)
    ho.join(timeout_s)
    if not result.get("ok"):
        raise RuntimeError(f"handoff never completed (handoffs={sup.handoffs})")
    return {"handoff_outage_ms": max_gap * 1e3, "policy_served": cli.counters.get("policy_served", 0) - pol0,
            "not_admitted": not_admitted, "handoffs": sup.handoffs, "standby_warm_boot_ms": sup.standby_warm_boot_ms,
            "standby_attach_ms": sup.standby_attach_ms, "reconnects": cli.counters.get("reconnects", 0)}


def measure_handoff_outage(setup, resource: str, prefix: Optional[str] = None, timeout_s: float = 180.0,
                           entry_timeout_ms: int = 30000, device: DeviceLike = None) -> dict:
    """One planned handoff cycle under continuous probing: start a supervised
    engine with a warm standby, probe until live, then
    ``probe_through_handoff``."""
    from sentinel_tpu_torch.ipc.worker import IngestClient

    sup = _standby_supervisor(setup, prefix, device, "measure_handoff_outage")
    cli = None
    try:
        if not sup.wait_engine_up(timeout_s):
            raise RuntimeError("supervised engine never came up")
        if not sup.wait_standby_ready(timeout_s):
            raise RuntimeError("standby never reported warm")
        cli = IngestClient(sup.handles.channel(0), 0)
        probe_live(cli, resource, timeout_s, entry_timeout_ms)
        return probe_through_handoff(sup, cli, resource, timeout_s, entry_timeout_ms)
    finally:
        if cli is not None:
            cli.close()
        sup.stop()
