"""Public entry/exit API, the SphU / SphO / Tracer facade (port of
``sentinel_tpu/core/api.py``).

* ``entry(resource, ...)`` ≙ ``SphU.entry``: raises a :class:`BlockError`
  when blocked, else returns an :class:`Entry`, usable as a context
  manager;
* ``try_entry`` ≙ ``SphO.entry``: the Entry or ``None``;
* ``entry_async`` ≙ ``SphU.asyncEntry``: an Entry off the context's
  stack;
* ``trace`` ≙ ``Tracer.trace``: marks the current entry's business
  exception, counted at exit.

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


def set_engine(engine: Optional[Engine]) -> Optional[Engine]:
    """Swap the global engine (tests); returns the previous one."""
    global _engine
    with _engine_lock:
        prev = _engine
        _engine = engine
        return prev


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
            engine.submit_exit(
                self.rows, rt=rt, count=count if count is not None else self.acquire,
                err=err, resource=self.resource, param_rows=self.param_rows,
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
    """SphU.entry: returns an Entry or raises a BlockError subclass."""
    e, verdict = _do_entry(resource, entry_type, count, origin, prio, args=args)
    if e is None:
        raise _block_error(verdict, resource)
    return e


def _block_error(verdict: Verdict, resource: str) -> E.BlockError:
    return E.error_for_verdict(verdict.reason, resource, limit_type=verdict.limit_type, rule=verdict.blocked_rule)


def try_entry(
    resource: str,
    entry_type: C.EntryType = C.EntryType.OUT,
    count: int = 1,
    origin: Optional[str] = None,
    args: Sequence[object] = (),
) -> Optional[Entry]:
    """SphO.entry: the Entry on pass, None on block."""
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
    from anywhere. Raises a BlockError subclass when blocked. The IPC
    worker hook of the JAX function belongs to ROADMAP Queue 1 item 10."""
    e, verdict = _do_entry(resource, entry_type, count, origin, False, args=args, with_context=False)
    if e is None:
        raise _block_error(verdict, resource)
    return e


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
