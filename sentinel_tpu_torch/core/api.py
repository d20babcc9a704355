"""Public entry/exit API, the SphU / SphO / Tracer facade (port of
``sentinel_tpu/core/api.py``).

* ``entry(resource, ...)`` ≙ ``SphU.entry``: raises a :class:`BlockError`
  when blocked, else returns an :class:`Entry`, usable as a context
  manager;
* ``try_entry`` ≙ ``SphO.entry``: the Entry or ``None``;
* ``entry_async`` ≙ ``SphU.asyncEntry``: an Entry off the context's
  stack;
* ``trace`` ≙ ``Tracer.trace``: marks the current entry's business
  exception, counted at exit;
* ``entry_windowed`` / ``entry_windowed_async``: ``entry`` through the
  engine's batch window (runtime/window.py) when it is armed;
* ``run_workers``: an N-process deployment through the multi-process
  ingest plane (ipc/): in worker mode every entry function above rides
  the process's :class:`~sentinel_tpu_torch.ipc.worker.IngestClient`.

A process-global :class:`Engine` plays ``Env.sph``; ``get_engine()``
builds it on first use on the card (``cuda:0``), or on the device the
last ``reset(device=...)`` named. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence, Tuple

from sentinel_tpu_torch.core import errors as E
from sentinel_tpu_torch.core.context import Context, ContextUtil
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.runtime.engine import Engine, Verdict, release_cluster_tokens
from sentinel_tpu_torch.utils.clock import Clock
from sentinel_tpu_torch.utils.device import DeviceLike

_engine: Optional[Engine] = None
_engine_lock = threading.RLock()
# The engine under construction, visible only to re-entrant calls from
# the initializing thread; ``_engine`` is published fully initialized.
_boot_engine: Optional[Engine] = None
# The device the next engine is built on (None = the card).
_device: DeviceLike = None
# ipc worker mode (ipc/worker_mode.py): this process's routed client and
# the (client, client_entry) pair the entry functions read, one read each.
_worker_client = None
_worker_hook = None


def _reapply_all_managers(engine: Engine) -> None:
    """Push rules loaded before the engine existed into it."""
    from sentinel_tpu_torch.rules import all_managers
    from sentinel_tpu_torch.utils.record_log import record_log

    for mgr in all_managers():
        try:
            mgr.re_apply(engine)
        except Exception:
            record_log.error("[InitExecutor] %s re_apply failed", type(mgr).__name__, exc_info=True)


def get_engine() -> Engine:
    global _engine, _boot_engine
    eng = _engine
    if eng is not None:
        return eng
    initialized = False
    with _engine_lock:
        if _engine is None:
            if _boot_engine is not None:
                return _boot_engine  # re-entrant call during init
            _boot_engine = Engine(device=_device)
            try:
                _run_init_funcs()
                _reapply_all_managers(_boot_engine)
                _engine = _boot_engine
                initialized = True
            finally:
                _boot_engine = None
    if initialized:
        # A load_rules() that stored rules during init may have been
        # missed by the first pass; re-apply once the engine is published.
        _reapply_all_managers(_engine)
    return _engine


def peek_engine() -> Optional[Engine]:
    """The fully initialized global engine, or None (never constructs)."""
    return _engine


def _run_init_funcs() -> None:
    """The registry's one-time init callbacks, ``InitFunc``
    (InitExecutor.doInit, sentinel-core/.../init/InitExecutor.java:33-95)."""
    from sentinel_tpu_torch.utils.record_log import record_log
    from sentinel_tpu_torch.utils.registry import Registry

    for fn in Registry.of("InitFunc").load_instance_list_sorted():
        try:
            fn.init() if hasattr(fn, "init") else fn()
        except Exception:
            record_log.error("[InitExecutor] InitFunc failed", exc_info=True)


def set_engine(engine: Optional[Engine]) -> Optional[Engine]:
    """Swap the global engine (tests); returns the previous one."""
    global _engine
    with _engine_lock:
        prev = _engine
        _engine = engine
        return prev


def set_worker_client(cli) -> None:
    """Install or clear the ipc worker-mode client hook (see
    sentinel_tpu_torch.ipc.worker_mode; not a public API)."""
    global _worker_client, _worker_hook
    if cli is not None:
        from sentinel_tpu_torch.ipc.worker_mode import client_entry

        _worker_hook = (cli, client_entry)
        _worker_client = cli
    else:
        _worker_client = None
        _worker_hook = None


def reset(clock: Optional[Clock] = None, device: DeviceLike = None) -> Engine:
    """Full reset: a fresh engine on ``device`` (None = the card) with an
    optional test clock, and cleared rules. Later ``get_engine()`` calls
    that must rebuild the engine use the same device."""
    from sentinel_tpu_torch.rules import all_managers
    from sentinel_tpu_torch.utils.record_log import record_log

    global _engine, _device
    with _engine_lock:
        if _engine is not None:
            try:
                _engine.close()  # decide anything still queued
            except Exception:
                record_log.error("[api.reset] quiescing the pre-reset engine failed", exc_info=True)
        # The window geometry is engine-scoped: a fresh engine starts at the
        # default 2 x 500 ms second window, and the geometry properties are
        # cleared, so that a re-push of the same value after the reset
        # retunes again (a None update is a no-op in their listeners).
        from sentinel_tpu_torch.metrics import nodes as _nodes
        from sentinel_tpu_torch.metrics import window_properties as _wp

        _nodes.set_second_window(C.DEFAULT_SAMPLE_COUNT, C.DEFAULT_WINDOW_INTERVAL_MS)
        _wp.sample_count_property.update_value(None)
        _wp.interval_property.update_value(None)
        _device = device
        _engine = Engine(clock=clock, device=device)
    ContextUtil.replace_context(None)
    reset_tracer_filters()
    for mgr in all_managers():
        mgr.clear()
    return _engine


class Entry:
    """A live protected invocation (reference: CtEntry.java:35-150)."""

    def __init__(
        self,
        resource: str,
        rows: Tuple[int, int, int, int],
        context: Optional[Context],
        create_ts: int,
        acquire: int,
        pass_through: bool = False,
        verdict: Optional[Verdict] = None,
        param_rows: Sequence[int] = (),
        cluster_tokens: Sequence = (),
    ) -> None:
        self.resource = resource
        self.rows = rows
        self.context = context
        self.create_ts = create_ts
        # The admitting verdict (None for pass-through entries): its
        # provenance, ``verdict.speculative`` for a fast-tier admit the
        # device settles later and ``verdict.degraded`` for a host-fallback
        # admit while the device was lost (runtime/speculative.py,
        # runtime/failover.py).
        self.verdict = verdict
        # Wall-clock anchor: RT must survive an epoch rebase.
        self.create_wall = get_engine().clock.to_wall(create_ts)
        self.acquire = acquire
        self.error: Optional[BaseException] = None
        self.pass_through = pass_through
        self.param_rows = tuple(param_rows)  # per-value thread gauges to release
        # Held cluster concurrency tokens [(service, token_id)], released at
        # exit (the reference's releaseConcurrentToken on completion).
        self.cluster_tokens = list(cluster_tokens)
        self._exited = False
        # A windowed entry may batch its exit columnar through the window
        # (BatchWindow.note_exit); None = the normal per-request exit.
        self._exit_sink = None

    def set_error(self, e: BaseException) -> None:
        """Tracer.traceEntry: the one choke point every trace path goes
        through, so the Tracer filters apply uniformly. Never raises."""
        try:
            traceable = should_trace(e)
        except Exception:
            from sentinel_tpu_torch.utils.record_log import record_log

            record_log.error("[Tracer] exception predicate/filter raised — not tracing", exc_info=True)
            traceable = False
        if traceable and self.error is None:
            self.error = e

    def exit(self, count: Optional[int] = None) -> None:
        """CtEntry.trueExit: record RT + success, release the thread slot."""
        if self._exited:
            return
        self._exited = True
        engine = get_engine()
        if not self.pass_through:
            rt = engine.clock.wall_ms() - self.create_wall
            err = 0
            if self.error is not None and not isinstance(self.error, E.BlockError):
                err = count if count is not None else self.acquire
            # Was the admit charged to the host mirror? Degraded fills
            # (speculative False, degraded True) charge the persistent
            # mirror's THREAD counter as speculative admits do.
            spec = (self.verdict.speculative or self.verdict.degraded) if self.verdict is not None else None
            sink = self._exit_sink
            if sink is not None and not self.param_rows and not self.cluster_tokens:
                sink(self.rows, self.resource, rt, count if count is not None else self.acquire, err,
                     spec if spec is not None else False)
            else:
                engine.submit_exit(
                    self.rows, rt=rt, count=count if count is not None else self.acquire,
                    err=err, resource=self.resource, param_rows=self.param_rows, speculative=spec,
                )
        if self.cluster_tokens:
            release_cluster_tokens(self.cluster_tokens)
            self.cluster_tokens = []
        ctx = self.context
        if ctx is not None and ctx.entry_stack and ctx.entry_stack[-1] is self:
            ctx.entry_stack.pop()
            if not ctx.entry_stack and ctx.auto:
                ContextUtil.exit()

    def __enter__(self) -> "Entry":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        # The context-manager form auto-traces non-Block exceptions (the
        # @SentinelResource aspect behaviour).
        if exc is not None:
            self.set_error(exc)
        self.exit()
        return False


def _do_entry(
    resource: str,
    entry_type: C.EntryType,
    acquire: int,
    origin: Optional[str],
    prio: bool,
    args: Sequence[object] = (),
    with_context: bool = True,
) -> Tuple[Optional[Entry], Verdict]:
    """One synchronous admission. ``with_context=False`` (``entry_async``)
    keeps the Entry off the context's entry stack and leaves no implicit
    context ambient."""
    engine = get_engine()
    ctx = ContextUtil.get_context()
    if ctx is None:
        ctx = ContextUtil.true_enter(C.CONTEXT_DEFAULT_NAME, origin or "")
    eff_origin = origin if origin is not None else ctx.origin
    context_name = ctx.name if not ctx.is_null else C.CONTEXT_DEFAULT_NAME
    op, verdict = engine.entry_sync(
        resource, context_name=context_name, origin=eff_origin, acquire=acquire,
        entry_type=entry_type, prio=prio, args=args,
    )
    if op is None:
        # Above the resource cap: pass-through entry with no statistics.
        e = Entry(resource, (-1, -1, -1, -1), ctx if with_context else None, engine.clock.now_ms(), acquire,
                  pass_through=True)
        if with_context:
            ctx.entry_stack.append(e)
        elif ctx.auto and not ctx.entry_stack:
            ContextUtil.exit()
        return e, verdict
    if not verdict.admitted:
        if ctx.auto and not ctx.entry_stack:
            ContextUtil.exit()
        return None, verdict
    if verdict.wait_ms > 0:
        # A queued pass (rate limiter, throttled value, borrowed window)
        # waits: the reference sleeps inside canPass
        # (RateLimiterController.java:80, DefaultController.java:66); here
        # the wait surfaces after the batched decision.
        engine.clock.sleep_ms(verdict.wait_ms)
    e = Entry(resource, op.rows, ctx if with_context else None, op.ts, acquire, verdict=verdict,
              param_rows=op.param_thread_rows, cluster_tokens=op.cluster_tokens)
    if with_context:
        ctx.entry_stack.append(e)
    elif ctx.auto and not ctx.entry_stack:
        # A detached entry created an implicit context: do not leave it
        # ambient (SphU.asyncEntry clears it in initializeAsyncContext).
        ContextUtil.exit()
    return e, verdict


def entry(
    resource: str,
    entry_type: C.EntryType = C.EntryType.OUT,
    count: int = 1,
    origin: Optional[str] = None,
    prio: bool = False,
    args: Sequence[object] = (),
) -> Entry:
    """SphU.entry: returns an Entry or raises a BlockError subclass. In
    ipc worker mode (``sentinel.tpu.ipc.worker.mode``) the admission rides
    this process's IngestClient to the engine process instead: the same
    Entry/BlockError surface, no local engine."""
    hook = _worker_hook
    if hook is not None:
        return hook[1](hook[0], resource, entry_type, count, origin, args, with_context=True, prio=prio)
    e, verdict = _do_entry(resource, entry_type, count, origin, prio, args=args)
    if e is None:
        raise _block_error(verdict, resource)
    return e


def _block_error(verdict: Verdict, resource: str) -> E.BlockError:
    return E.error_for_verdict(verdict.reason, resource, limit_type=verdict.limit_type, slot_name=verdict.slot_name,
                               rule=verdict.blocked_rule)


def try_entry(
    resource: str,
    entry_type: C.EntryType = C.EntryType.OUT,
    count: int = 1,
    origin: Optional[str] = None,
    args: Sequence[object] = (),
) -> Optional[Entry]:
    """SphO.entry: the Entry on pass, None on block."""
    hook = _worker_hook
    if hook is not None:
        try:
            return hook[1](hook[0], resource, entry_type, count, origin, args, with_context=True)
        except E.BlockError:
            return None
    e, _ = _do_entry(resource, entry_type, count, origin, False, args=args)
    return e


def entry_async(
    resource: str,
    entry_type: C.EntryType = C.EntryType.OUT,
    count: int = 1,
    origin: Optional[str] = None,
    args: Sequence[object] = (),
) -> Entry:
    """SphU.asyncEntry: not pushed on the context's entry stack; exit it
    from anywhere. Raises a BlockError subclass when blocked."""
    hook = _worker_hook
    if hook is not None:
        return hook[1](hook[0], resource, entry_type, count, origin, args, with_context=False)
    e, verdict = _do_entry(resource, entry_type, count, origin, False, args=args, with_context=False)
    if e is None:
        raise _block_error(verdict, resource)
    return e


# ---------------------------------------------------------------------------
# Batch-window admission (runtime/window.py). In ipc worker mode both
# functions route through the process's IngestClient, whose own
# micro-window is the worker-side coalescing tier.
# ---------------------------------------------------------------------------


def _window_join(engine: Engine, resource, entry_type, count, origin, args):
    """The head of the windowed paths: context bookkeeping and the shed
    before assembly (a shed request never occupies a window slot, and the
    window's queued requests count toward the valve's bulk bound). Returns
    ``(req, ctx)``. The admission trace's tag is stamped here, on the
    caller's thread, where the inbound traceparent is ambient: the
    window's flusher thread has no request identity."""
    from sentinel_tpu_torch.runtime.window import WindowRequest

    ctx = ContextUtil.get_context()
    if ctx is None:
        ctx = ContextUtil.true_enter(C.CONTEXT_DEFAULT_NAME, origin or "")
    eff_origin = origin if origin is not None else ctx.origin
    context_name = ctx.name if not ctx.is_null else C.CONTEXT_DEFAULT_NAME
    if engine.ingest.armed:
        cause = engine.ingest.check_bulk(1)
        if cause is not None:
            op = engine._shed_entry(resource, context_name, eff_origin, count, cause)
            if ctx.auto and not ctx.entry_stack:
                ContextUtil.exit()
            raise _block_error(op.verdict, resource)
    tracer = engine.admission_trace
    tag = tracer.make_tag() if tracer.enabled else None
    req = WindowRequest(resource, context_name, eff_origin, count, entry_type, tuple(args), engine.clock.now_ms(),
                        tag)
    return req, ctx


def _window_entry_tail(engine: Engine, req, ctx, resource, count, with_context: bool) -> Entry:
    """The fanned-out verdict as an Entry or a BlockError, with
    :func:`_do_entry`'s context bookkeeping. The rate limiter's wait is
    the caller's to pay."""
    if req.error is not None:
        raise req.error
    v = req.verdict
    if req.pass_through:
        e = Entry(resource, (-1, -1, -1, -1), ctx if with_context else None, req.ts, count, pass_through=True)
        if with_context:
            ctx.entry_stack.append(e)
        elif ctx.auto and not ctx.entry_stack:
            ContextUtil.exit()
        return e
    if not v.admitted:
        if ctx.auto and not ctx.entry_stack:
            ContextUtil.exit()
        raise _block_error(v, resource)
    e = Entry(resource, req.rows, ctx if with_context else None, req.ts, count, verdict=v,
              param_rows=req.param_rows, cluster_tokens=req.cluster_tokens)
    if req.bulk_exit:
        e._exit_sink = engine.ingest_window.note_exit
    if with_context:
        ctx.entry_stack.append(e)
    elif ctx.auto and not ctx.entry_stack:
        ContextUtil.exit()
    return e


def entry_windowed(
    resource: str,
    entry_type: C.EntryType = C.EntryType.OUT,
    count: int = 1,
    origin: Optional[str] = None,
    args: Sequence[object] = (),
    detached: bool = False,
) -> Entry:
    """:func:`entry` (or, ``detached=True``, :func:`entry_async`) through
    the batch window when it is armed (``sentinel.tpu.ingest.batch.window.ms``
    > 0): the admission joins concurrent requests in one columnar
    ``submit_bulk`` flush and its verdict fans back out, with the same
    Entry/BlockError surface and the same verdicts. Window off (the
    default) is exactly the per-request call."""
    hook = _worker_hook
    if hook is not None:
        return hook[1](hook[0], resource, entry_type, count, origin, args, with_context=not detached)
    engine = get_engine()
    w = engine.ingest_window
    if not w.armed:
        if detached:
            return entry_async(resource, entry_type, count, origin, args)
        return entry(resource, entry_type, count, origin, args=args)
    req, ctx = _window_join(engine, resource, entry_type, count, origin, args)
    w.join(req)
    req.event.wait()
    e = _window_entry_tail(engine, req, ctx, resource, count, with_context=not detached)
    if req.verdict is not None and req.verdict.wait_ms > 0:
        engine.clock.sleep_ms(req.verdict.wait_ms)  # a queued pass waits after the batched decision
    return e


async def entry_windowed_async(
    resource: str,
    entry_type: C.EntryType = C.EntryType.OUT,
    count: int = 1,
    origin: Optional[str] = None,
    args: Sequence[object] = (),
    detached: bool = True,
) -> Entry:
    """The awaitable :func:`entry_windowed`: the event loop stays free
    while the window assembles and flushes (the fan-out wakes the task on
    its own loop). A cancelled awaiter whose slot was admitted is exited
    by the window. Window off falls back to the blocking per-request call.
    In ipc worker mode the blocking client call runs in a thread
    (``asyncio.to_thread``, which carries the task's contextvars, so the
    ambient traceparent reaches the frame), and the loop stays free."""
    import asyncio

    hook = _worker_hook
    if hook is not None:
        return await asyncio.to_thread(hook[1], hook[0], resource, entry_type, count, origin, args,
                                       with_context=not detached)
    engine = get_engine()
    w = engine.ingest_window
    if not w.armed:
        if detached:
            return entry_async(resource, entry_type, count, origin, args)
        return entry(resource, entry_type, count, origin, args=args)
    req, ctx = _window_join(engine, resource, entry_type, count, origin, args)
    w.join(req, loop=asyncio.get_running_loop())
    try:
        await req.future
    except asyncio.CancelledError:
        req.abandoned = True
        if req.verdict is not None:
            w.release_abandoned(req)
        if ctx.auto and not ctx.entry_stack:
            ContextUtil.exit()
        raise
    e = _window_entry_tail(engine, req, ctx, resource, count, with_context=not detached)
    if req.verdict is not None and req.verdict.wait_ms > 0:
        await asyncio.sleep(req.verdict.wait_ms / 1e3)
    return e


def run_workers(target, n: int = 2, args: Sequence[object] = (), engine: Optional[Engine] = None):
    """An N-process worker deployment in one line: ensure the
    multi-process ingest plane on the (global) engine, spawn ``n`` worker
    processes and run ``target(worker_id, *args)`` in each, with the whole
    entry surface routed through that process's IngestClient (worker
    mode). ``target`` must be a top-level (picklable) callable; the
    parent's runtime ``sentinel.tpu.ipc.*`` config is replayed into each
    child. Returns a :class:`~sentinel_tpu_torch.ipc.worker_mode.WorkerSet`
    (``join()``, ``stop()``, ``alive()``). A worker builds no engine and
    touches no device."""
    from sentinel_tpu_torch.ipc import worker_mode
    from sentinel_tpu_torch.ipc.plane import IngestPlane
    from sentinel_tpu_torch.utils.config import config

    eng = engine if engine is not None else get_engine()
    plane = eng.ipc_plane
    if plane is None:
        plane = IngestPlane(eng)
    if n > plane.workers_max:
        raise ValueError(f"run_workers: n={n} exceeds sentinel.tpu.ipc.workers.max={plane.workers_max}")
    # Ids come from the plane, not 0..n-1: a second run_workers on the
    # same engine must never put two clients on one response ring.
    ids = plane.claim_worker_slots(n)
    overrides = config.runtime_snapshot("sentinel.tpu.ipc.")
    ctx = plane.spawn_context()
    procs = []
    for w in ids:
        p = ctx.Process(target=worker_mode.worker_main,
                        args=(plane.channel(w), w, overrides, target, tuple(args)), daemon=True)
        p.start()
        procs.append(p)
    return worker_mode.WorkerSet(procs, plane)


def run_engine_supervised(setup=None, setup_args: Sequence[object] = (), n_workers: int = 0,
                          prefix: Optional[str] = None, device: DeviceLike = None):
    """Run the ENGINE in a supervised child process on named shared-memory
    rings (``sentinel_tpu_torch/ipc/supervise.py``): a crashed engine is
    restarted on the shared Backoff and re-attaches to the EXISTING rings;
    workers keep their mappings, see the engine-boot epoch bump, re-assert
    their live-admission ledgers and get device-backed verdicts again. With
    ``sentinel.tpu.failover.checkpoint.path`` set (and failover enabled)
    the new engine warm-starts from the durable checkpoint.

    ``setup`` (top-level and picklable, called as ``setup(engine,
    *setup_args)`` in the child) loads rules; ``n_workers`` sizes the
    response rings created up front; every child builds its engine on
    ``device`` (None = the card: ``RuntimeError`` before anything is
    spawned when CUDA is absent). Returns an
    :class:`~sentinel_tpu_torch.ipc.supervise.EngineSupervisor`
    (``spawn_worker()``, ``kill_engine()``, ``handoff()``, ``restarts``,
    ``stop()``). This process must not also host an engine on the same
    plane."""
    from sentinel_tpu_torch.ipc.supervise import EngineSupervisor

    return EngineSupervisor(setup=setup, setup_args=setup_args, n_workers=n_workers, prefix=prefix, device=device)


# Tracer exception filters (Tracer.java:33-34, 129-186): BlockError is
# never traced; a predicate, when set, decides alone; otherwise
# ignore-classes beat trace-classes, and a set trace-list is exhaustive.
_trace_classes: Optional[Tuple[type, ...]] = None
_ignore_classes: Optional[Tuple[type, ...]] = None
_exception_predicate: Optional[Callable[[BaseException], bool]] = None


def _check_exc_classes(classes: Tuple[type, ...], what: str) -> None:
    for c in classes:
        if not (isinstance(c, type) and issubclass(c, BaseException)):
            raise ValueError(f"{what} classes must be exception types, got {c!r}")


def set_exceptions_to_trace(*classes: type) -> None:
    """Tracer.setExceptionsToTrace (Tracer.java:129)."""
    global _trace_classes
    _check_exc_classes(classes, "trace")
    _trace_classes = tuple(classes)


def set_exceptions_to_ignore(*classes: type) -> None:
    """Tracer.setExceptionsToIgnore (Tracer.java:155)."""
    global _ignore_classes
    _check_exc_classes(classes, "ignore")
    _ignore_classes = tuple(classes)


def set_exception_predicate(pred: Callable[[BaseException], bool]) -> None:
    """Tracer.setExceptionPredicate (Tracer.java:183)."""
    global _exception_predicate
    if pred is None:
        raise ValueError("exception predicate must not be None")
    _exception_predicate = pred


def reset_tracer_filters() -> None:
    global _trace_classes, _ignore_classes, _exception_predicate
    _trace_classes = None
    _ignore_classes = None
    _exception_predicate = None


def should_trace(e: Optional[BaseException]) -> bool:
    """Tracer.shouldTrace (Tracer.java:201-225)."""
    if e is None or isinstance(e, E.BlockError):
        return False
    if _exception_predicate is not None:
        return bool(_exception_predicate(e))
    if _ignore_classes is not None and isinstance(e, _ignore_classes):
        return False
    if _trace_classes is not None:
        return isinstance(e, _trace_classes)
    return True


def trace(e: BaseException, count: int = 1) -> None:
    """Tracer.trace: attach a business exception to the current entry;
    it is counted at exit with the exit's count (StatisticSlot)."""
    ctx = ContextUtil.get_context()
    if ctx is None:
        return
    cur = ctx.cur_entry
    if isinstance(cur, Entry):
        cur.set_error(e)


def trace_context(e: BaseException, ctx: Context, count: int = 1) -> None:
    """Tracer.traceContext: attach a business exception to ``ctx``'s
    current entry."""
    cur = ctx.cur_entry
    if isinstance(cur, Entry):
        cur.set_error(e)
