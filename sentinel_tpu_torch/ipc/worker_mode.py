"""Worker mode: run a whole process's ``api.entry`` surface through its
:class:`~sentinel_tpu_torch.ipc.worker.IngestClient`.

The plane gives worker processes the raw ``entry``/``exit``/``bulk``
client; this module closes the last mile of the multi-worker scale-out story:
with ``sentinel.tpu.ipc.worker.mode`` on and a client attached, the
public API — ``api.entry``, ``api.try_entry``, ``api.entry_async``,
``api.entry_windowed(_async)`` — and therefore every adapter built on
it — route through the client instead of a local engine. The process never
constructs an :class:`Engine` (no device memory, no flush threads); it
is pure encode + wait against the plane's shared-memory rings, and the
client's micro-window (``sentinel.tpu.ipc.client.window.*``) is the
worker-side coalescing tier the adapter batch window plays in-process.

Deployment is one line: ``api.run_workers(target, n=4)`` ensures the
plane on the global engine, spawns ``n`` worker processes (descendants,
so the claim lock and doorbells travel), each calling
``target(worker_id, *args)`` in worker mode, and returns a
:class:`WorkerSet`.

Verdict surface parity: blocked admissions raise the same
:class:`BlockError` subclasses (``errors.error_for_verdict`` from the
wire reason code), admitted ones return a :class:`WorkerEntry` with the
``Entry`` contract the adapters rely on (``exit()`` / ``set_error()`` /
context-manager / ``verdict`` provenance — ``speculative``/``degraded``
ride the verdict flags across the boundary). Rule beans do not cross
the process boundary, so ``verdict.blocked_rule`` is always None here.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

from sentinel_tpu_torch.core import errors as E
from sentinel_tpu_torch.utils.config import config

_lock = threading.Lock()
_client = None  # this process's ROUTED IngestClient (worker mode on)
_attached = None  # last client attach() created, routed or not


def attach(channel, worker_id: int, route: Optional[bool] = None,
           heartbeat: bool = True):
    """Attach this process to a plane channel. ``route`` None reads
    ``sentinel.tpu.ipc.worker.mode``; True installs the api hook so the
    whole entry surface rides the client. A previously attached client
    — routed or not — is detached (and closed) first: two clients on
    one response ring would race its tail pointer and strand half the
    verdicts."""
    from sentinel_tpu_torch.ipc.worker import IngestClient

    global _client, _attached
    detach(close=True)
    cli = IngestClient(channel, worker_id, heartbeat=heartbeat)
    if route is None:
        route = config.get_bool(config.IPC_WORKER_MODE, False)
    with _lock:
        _attached = cli
        _client = cli if route else None
    if route:
        from sentinel_tpu_torch.core import api

        api.set_worker_client(cli)
    return cli


def detach(close: bool = True) -> None:
    """Uninstall the api hook and (by default) close the client —
    including a non-routed one, which would otherwise keep its reader
    and heartbeat threads alive with no handle to stop them."""
    global _client, _attached
    with _lock:
        cli, _client, _attached = _attached, None, None
    from sentinel_tpu_torch.core import api

    api.set_worker_client(None)
    if cli is not None and close:
        try:
            cli.close()
        except Exception:
            # The caller may have closed a non-routed client directly.
            pass


def current():
    """This process's routed client, or None (worker mode off)."""
    return _client


class WorkerEntry:
    """The worker-mode twin of :class:`api.Entry`: same public surface
    (``exit()``, ``set_error()``, ``verdict``, context manager, ambient
    context-stack bookkeeping), completion delivered through the
    client's exit path instead of ``engine.submit_exit``. RT is wall
    time measured here — the worker has no engine clock; the plane
    stamps its own ts at decode."""

    __slots__ = (
        "resource", "context_name", "origin", "entry_type", "acquire",
        "verdict", "context", "error", "pass_through",
        "_cli", "_create_pc", "_exited",
    )

    def __init__(self, cli, resource, context_name, origin, entry_type,
                 acquire, verdict, context) -> None:
        self.resource = resource
        self.context_name = context_name
        self.origin = origin
        self.entry_type = int(entry_type)
        self.acquire = acquire
        self.verdict = verdict  # frames.IpcVerdict (wire provenance)
        self.context = context
        self.error: Optional[BaseException] = None
        self.pass_through = False
        self._cli = cli
        self._create_pc = time.monotonic()
        self._exited = False

    def set_error(self, e: BaseException) -> None:
        from sentinel_tpu_torch.core import api

        try:
            traceable = api.should_trace(e)
        except Exception:
            from sentinel_tpu_torch.utils.record_log import record_log

            record_log.error(
                "[Tracer] exception predicate/filter raised — not tracing",
                exc_info=True,
            )
            traceable = False
        if traceable and self.error is None:
            self.error = e

    def exit(self, count: Optional[int] = None) -> None:
        if self._exited:
            return
        self._exited = True
        from sentinel_tpu_torch.core.context import ContextUtil

        rt = int((time.monotonic() - self._create_pc) * 1000)
        n = count if count is not None else self.acquire
        err = 0
        if self.error is not None and not isinstance(self.error, E.BlockError):
            err = n
        v = self.verdict
        # The mirror-release gate: speculative/degraded admits charged
        # the engine-side host mirror — the exit's spec flag must say
        # so (the plane's ledger pairing relies on it too).
        self._cli.exit(
            self.resource, self.context_name, self.origin, self.entry_type,
            rt=rt, count=n, err=err,
            speculative=bool(v.speculative or v.degraded),
        )
        ctx = self.context
        if ctx is not None and ctx.entry_stack and ctx.entry_stack[-1] is self:
            ctx.entry_stack.pop()
            if not ctx.entry_stack and ctx.auto:
                ContextUtil.exit()

    def __enter__(self) -> "WorkerEntry":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self.set_error(exc)
        self.exit()
        return False


def client_entry(
    cli,
    resource: str,
    entry_type,
    count: int,
    origin: Optional[str],
    args: Sequence[object],
    with_context: bool,
    prio: bool = False,
) -> WorkerEntry:
    """The worker-mode body of ``api.entry``/``entry_async``/
    ``entry_windowed``: same context bookkeeping as ``_do_entry``, the
    admission decided by the plane through this process's client (the
    client's micro-window coalesces concurrent calls when armed).
    Raises the mapped BlockError on a declined verdict.

    Prioritized (occupy/borrow) entries are refused loudly: the wire
    format carries no prio bit and the plane's columnar spine declines
    prio ops anyway — silently downgrading them to normal admission
    would change verdicts (a borrow-admit would read as a block)."""
    if prio:
        raise ValueError(
            "prio entries are not supported in ipc worker mode — the "
            "frame format carries no occupy semantics; serve "
            "prioritized resources from the engine process"
        )
    from sentinel_tpu_torch.core.context import ContextUtil
    from sentinel_tpu_torch.models import constants as C

    ctx = ContextUtil.get_context()
    if ctx is None:
        # detached_enter, NOT true_enter: the latter resolves the
        # entrance row via get_engine(), lazily constructing a full
        # Engine (device memory, flush threads — and, with ipc.enabled
        # replayed, a second IngestPlane) inside the worker on the
        # first request.
        ctx = ContextUtil.detached_enter(C.CONTEXT_DEFAULT_NAME, origin or "")
    eff_origin = origin if origin is not None else ctx.origin
    context_name = ctx.name if not ctx.is_null else C.CONTEXT_DEFAULT_NAME
    v = cli.entry(
        resource,
        context_name=context_name,
        origin=eff_origin,
        acquire=count,
        entry_type=int(entry_type),
        args=tuple(args),
    )
    if not v.admitted:
        if ctx.auto and not ctx.entry_stack:
            ContextUtil.exit()
        raise E.error_for_verdict(
            v.reason, resource, limit_type=v.limit_type
        )
    if v.wait_ms > 0:
        time.sleep(v.wait_ms / 1e3)
    e = WorkerEntry(
        cli, resource, context_name, eff_origin, entry_type, count, v,
        ctx if with_context else None,
    )
    if with_context:
        ctx.entry_stack.append(e)
    elif ctx.auto and not ctx.entry_stack:
        ContextUtil.exit()
    return e


def worker_main(channel, worker_id: int, overrides, target, args) -> object:
    """Spawn bootstrap (top-level so ``multiprocessing`` spawn children
    import it by name): replay the parent's runtime config, arm worker
    mode, attach, run ``target(worker_id, *args)``, detach."""
    for k, v in (overrides or {}).items():
        config.set(k, v)
    config.set(config.IPC_WORKER_MODE, "true")
    # A worker is never an engine host: the parent's replayed runtime
    # config may carry ipc.enabled=true (how IT armed the plane), and
    # any stray get_engine() here would then build a SECOND IngestPlane
    # — new shm rings, drainer threads, per-worker device memory.
    config.set(config.IPC_ENABLED, "false")
    attach(channel, worker_id)
    try:
        return target(worker_id, *args)
    finally:
        detach()


class WorkerSet:
    """Handle on a spawned worker fleet (``api.run_workers``)."""

    def __init__(self, procs, plane) -> None:
        self.procs = list(procs)
        self.plane = plane

    def __iter__(self):
        return iter(self.procs)

    def __len__(self) -> int:
        return len(self.procs)

    def alive(self) -> int:
        return sum(1 for p in self.procs if p.is_alive())

    def join(self, timeout: Optional[float] = None) -> None:
        for p in self.procs:
            p.join(timeout)

    def stop(self, timeout: float = 5.0) -> None:
        """Terminate the workers (their live admissions auto-release
        through the plane's dead-worker sweep / final close sweep)."""
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(timeout)
