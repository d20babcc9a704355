"""Circuit-breaker state-change observers (port of
``sentinel_tpu/rules/breaker_events.py``; reference: EventObserverRegistry
and CircuitBreakerStateChangeObserver.onStateChange(prevState, newState,
rule, snapshotValue)).

Transitions happen inside the flush's kernels on device state
(rules/degrade_table.py), so observers are fed by a post-flush diff of the
breaker states that rides the verdicts' copy back
(``Engine._apply_breaker_snapshot``): no extra device round trip, and the
zero-observer path is unchanged. A whole flush's transitions surface at
once, so a rule that trips and recovers within one flush reports the net
edge. Transitions of flushes that ran with no observer registered are not
replayed (the first observed flush resyncs silently), and a rule reload
starts a fresh epoch, so a deferred fill from the old rule world never
fires against the new one.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from sentinel_tpu_torch.utils.record_log import record_log

# State codes (rules/degrade_table.py:39-41).
STATE_NAMES = {0: "CLOSED", 1: "OPEN", 2: "HALF_OPEN"}

# observer(prev_state, new_state, rule, resource) — prev/new are the
# int codes above; ``rule`` is the DegradeRule that transitioned.
StateChangeObserver = Callable[[int, int, object, str], None]

_lock = threading.Lock()
_observers: Dict[str, StateChangeObserver] = {}


def add_state_change_observer(name: str, observer: StateChangeObserver) -> None:
    """EventObserverRegistry.addStateChangeObserver."""
    if not name or observer is None:
        raise ValueError("observer name and callable are required")
    with _lock:
        _observers[name] = observer


def remove_state_change_observer(name: str) -> bool:
    """EventObserverRegistry.removeStateChangeObserver."""
    with _lock:
        return _observers.pop(name, None) is not None


def get_state_change_observer(name: str) -> Optional[StateChangeObserver]:
    with _lock:
        return _observers.get(name)


def has_observers() -> bool:
    return bool(_observers)


def clear() -> None:
    with _lock:
        _observers.clear()


def fire_transitions(prev_states, new_states, dindex) -> None:
    """Diff two host state vectors and notify every observer of each
    changed rule. Observer exceptions are logged, never propagated —
    a broken alert hook must not fail the flush's verdict fill."""
    with _lock:
        observers = list(_observers.items())
    if not observers:
        return
    for gid in range(min(len(prev_states), len(new_states))):
        prev, new = int(prev_states[gid]), int(new_states[gid])
        if prev == new:
            continue
        rule = dindex.rules[gid] if gid < len(dindex.rules) else None
        resource = getattr(rule, "resource", "")
        for name, obs in observers:
            try:
                obs(prev, new, rule, resource)
            except Exception:
                record_log.error(
                    f"[BreakerEvents] observer {name!r} failed", exc_info=True
                )
