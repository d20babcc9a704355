"""Deterministic device-fault injection for the failure-domain tests
(port of ``sentinel_tpu/testing/faults.py``).

The failover state machine (runtime/failover.py) has four trigger
classes — a failed kernel dispatch, a failed wait for a flush's copy back,
a *hung* wait, and a failed checkpoint restore — none of which a real
device produces on demand. This injector makes each one reproducible:
faults are keyed on the engine's monotonic **flush sequence number**
(``Engine.flush_seq``; one per dispatched chunk and per probe flush),
so a test can say "the fetch of flush 7 fails" and get exactly that,
every run, with no flaky device in the loop.

Plans are NOT one-shot: a plan keyed to seq N fires every time seq N's
dispatch/fetch is attempted. Sequence numbers never repeat, so in
practice a plan fires once — except when the engine itself retries the
same seq (the coalesced-drain per-record fallback re-fetches a failed
record alone), which is exactly when the repeat firing is the point:
the failure stays attributed to the faulted record.

Usage::

    inj = FaultInjector().install(engine)
    inj.fail_fetch(engine.flush_seq + 1)   # next flush's fetch fails
    engine.flush()                         # -> failover quarantines it

Hooks are called by the engine on its own threads (and, with failover
armed, on the watchdog waiter thread — which is what lets a hang be
timed out rather than wedging a submitter).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple


class InjectedFault(RuntimeError):
    """The default raised fault — tests assert on this type to prove a
    caller never saw a raw device exception leak through failover."""


class FaultInjector:
    """Deterministic fault plans keyed on engine flush sequence
    numbers. Thread-safe; ``fired`` records every trigger in order."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._dispatch: Dict[int, BaseException] = {}
        self._fetch: Dict[int, BaseException] = {}
        # seq -> (sleep_seconds, optional release Event): the hang
        # blocks the fetch for up to sleep_seconds (or until the event
        # is set) BEFORE the real wait on the chunk's event.
        self._hangs: Dict[int, Tuple[float, Optional[threading.Event]]] = {}
        self._restore: List[BaseException] = []
        self.fired: List[Tuple[str, int]] = []

    # ------------------------------------------------------------------
    # planning (test side)
    # ------------------------------------------------------------------
    def install(self, engine) -> "FaultInjector":
        engine.faults = self
        return self

    def fail_dispatch(self, seq: int, exc: Optional[BaseException] = None) -> None:
        with self._lock:
            self._dispatch[int(seq)] = exc or InjectedFault(
                f"injected dispatch fault at flush seq {seq}"
            )

    def fail_fetch(self, seq: int, exc: Optional[BaseException] = None) -> None:
        with self._lock:
            self._fetch[int(seq)] = exc or InjectedFault(
                f"injected fetch fault at flush seq {seq}"
            )

    def hang_fetch(
        self,
        seq: int,
        seconds: float = 60.0,
        until: Optional[threading.Event] = None,
    ) -> None:
        """Make seq's fetch block for ``seconds`` (or until ``until``
        is set) before proceeding — the wedged-wait simulation
        the flush watchdog must time out."""
        with self._lock:
            self._hangs[int(seq)] = (float(seconds), until)

    def fail_restore(
        self, exc: Optional[BaseException] = None, times: int = 1
    ) -> None:
        """Fail the next ``times`` checkpoint restores (RECOVERING
        re-entry attempts)."""
        with self._lock:
            for _ in range(max(1, int(times))):
                self._restore.append(
                    exc or InjectedFault("injected checkpoint-restore fault")
                )

    def clear(self) -> None:
        with self._lock:
            self._dispatch.clear()
            self._fetch.clear()
            self._hangs.clear()
            self._restore.clear()

    # ------------------------------------------------------------------
    # engine hooks
    # ------------------------------------------------------------------
    def _note(self, kind: str, seq: int) -> None:
        with self._lock:
            self.fired.append((kind, int(seq)))

    def on_dispatch(self, seq: int) -> None:
        with self._lock:
            exc = self._dispatch.get(seq)
        if exc is not None:
            self._note("dispatch", seq)
            raise exc

    def on_fetch(self, seqs: Sequence[int]) -> None:
        """Fires for every planned seq in the fetch — a coalesced drain
        covering seqs {3,4} fails if either has a plan, and the
        per-record fallback then re-attributes by firing again on
        exactly the faulted record's own fetch."""
        for seq in seqs:
            with self._lock:
                hang = self._hangs.get(seq)
            if hang is not None:
                self._note("hang", seq)
                seconds, ev = hang
                if ev is not None:
                    ev.wait(seconds)
                else:
                    time.sleep(seconds)
            with self._lock:
                exc = self._fetch.get(seq)
            if exc is not None:
                self._note("fetch", seq)
                raise exc

    def on_restore(self) -> None:
        with self._lock:
            exc = self._restore.pop(0) if self._restore else None
        if exc is not None:
            self._note("restore", -1)
            raise exc
