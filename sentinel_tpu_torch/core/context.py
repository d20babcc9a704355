"""Per-task invocation context and call tree (port of
``sentinel_tpu/core/context.py``; reference: context/Context.java,
context/ContextUtil.java:120-190, CtEntry.java:35-110).

A ``contextvars.ContextVar`` holds the current :class:`Context` for
threads and asyncio tasks alike. Each context name gets an entrance-node
row, capped at MAX_CONTEXT_NAME_SIZE=2000 like ContextUtil.trueEnter;
beyond the cap a NULL context is returned and the entrance dimension is
not recorded.
"""

from __future__ import annotations

import contextvars
from typing import List, Optional

from sentinel_tpu_torch.models import constants as C


class Context:
    """One invocation chain: (name, origin) plus the current entry stack."""

    __slots__ = ("name", "origin", "entry_stack", "auto", "_is_null", "trace")

    def __init__(self, name: str, origin: str = "", *, is_null: bool = False) -> None:
        self.name = name
        self.origin = origin
        self.entry_stack: List[object] = []  # stack of Entry, parent chaining
        # True when implicitly created for the default context: such
        # contexts auto-exit when their last entry exits.
        self.auto = False
        self._is_null = is_null
        # The W3C trace identity riding this chain (an
        # admission_trace.TraceContext), set through ContextUtil.set_trace
        # and carried with the Context across threads.
        self.trace: Optional[object] = None

    @property
    def is_null(self) -> bool:
        """True when the 2000-context cap was hit (NullContext.java)."""
        return self._is_null

    @property
    def cur_entry(self) -> Optional[object]:
        return self.entry_stack[-1] if self.entry_stack else None

    def __repr__(self) -> str:  # pragma: no cover
        return f"Context(name={self.name!r}, origin={self.origin!r}, depth={len(self.entry_stack)})"


_current: contextvars.ContextVar[Optional[Context]] = contextvars.ContextVar(
    "sentinel_tpu_torch_context", default=None
)

# The ambient trace identity outside a named context; a Context created
# while a trace is ambient captures it onto itself.
_trace: contextvars.ContextVar[Optional[object]] = contextvars.ContextVar(
    "sentinel_tpu_torch_trace", default=None
)


class ContextUtil:
    """Static facade mirroring the reference's ContextUtil."""

    @staticmethod
    def enter(name: str, origin: str = "") -> Context:
        if name == C.CONTEXT_DEFAULT_NAME:
            # ContextUtil.enter throws ContextNameDefineException.
            raise ValueError(f"The {C.CONTEXT_DEFAULT_NAME} can't be permitted to defined!")
        return ContextUtil.true_enter(name, origin)

    @staticmethod
    def detached_enter(name: str, origin: str) -> Context:
        """The engine-free twin of :meth:`true_enter` for ipc worker mode:
        the node registry lives in the engine process, so no entrance row
        is resolved here, and no Engine is ever built in the worker
        (``true_enter`` builds one through ``get_engine()``). The context
        NAME crosses the wire; the plane resolves the entrance row."""
        ctx = _current.get()
        if ctx is None:
            ctx = Context(name, origin, is_null=False)
            ctx.auto = name == C.CONTEXT_DEFAULT_NAME
            ctx.trace = _trace.get()
            _current.set(ctx)
        return ctx

    @staticmethod
    def true_enter(name: str, origin: str) -> Context:
        ctx = _current.get()
        if ctx is None:
            from sentinel_tpu_torch.core import api

            if api._worker_client is not None:
                # ipc worker mode: resolving the entrance row here would
                # build a whole Engine (device state, flush threads) in
                # the worker.
                return ContextUtil.detached_enter(name, origin)
            row = api.get_engine().nodes.entrance_row(name)
            ctx = Context(name, origin, is_null=row is None)
            ctx.auto = name == C.CONTEXT_DEFAULT_NAME
            ctx.trace = _trace.get()
            _current.set(ctx)
        return ctx

    @staticmethod
    def get_context() -> Optional[Context]:
        return _current.get()

    @staticmethod
    def exit() -> None:
        ctx = _current.get()
        if ctx is not None and not ctx.entry_stack:
            _current.set(None)

    @staticmethod
    def replace_context(ctx: Optional[Context]) -> Optional[Context]:
        """Swap the ambient context (async hand-off); returns the old one."""
        old = _current.get()
        _current.set(ctx)
        return old

    @staticmethod
    def run_on_context(ctx: Context, fn, *args, **kwargs):
        """Execute ``fn`` with ``ctx`` ambient (ContextUtil.runOnContext)."""
        old = ContextUtil.replace_context(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            ContextUtil.replace_context(old)

    # --- the W3C trace-context carrier (metrics/admission_trace.py) ---
    @staticmethod
    def set_trace(tc):
        """Make ``tc`` (a TraceContext, or None) the ambient trace identity,
        and stamp the current Context, if any. Returns the token for
        :meth:`reset_trace`, which restores the Context's prior trace."""
        ctx = _current.get()
        prev = ctx.trace if ctx is not None else None
        if ctx is not None:
            ctx.trace = tc
        return (_trace.set(tc), ctx, prev)

    @staticmethod
    def get_trace():
        """The current Context's trace, else the ambient one, else None."""
        ctx = _current.get()
        if ctx is not None and ctx.trace is not None:
            return ctx.trace
        return _trace.get()

    @staticmethod
    def reset_trace(token) -> None:
        var_token, ctx, prev = token
        if ctx is not None:
            ctx.trace = prev
        _trace.reset(var_token)


def context_enter(name: str, origin: str = "") -> Context:
    """ContextUtil.enter(name, origin)."""
    return ContextUtil.enter(name, origin)


def context_exit() -> None:
    ContextUtil.exit()
