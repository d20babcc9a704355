"""Circuit-breaker state-change observers (the surface of
``sentinel_tpu/rules/breaker_events.py``; reference:
EventObserverRegistry.java).

The breakers themselves are ported (``rules/degrade_table.py``); the
host-side post-flush state diff that feeds observers is not yet. So
registering an observer raises rather than silently never firing."""

from __future__ import annotations

_ROADMAP_METRICS = "ROADMAP Queue 1 item 8 (metrics and observability)"


def add_state_change_observer(name: str, observer) -> None:
    """EventObserverRegistry.addStateChangeObserver: not ported yet."""
    raise NotImplementedError(
        f"sentinel_tpu_torch: breaker state-change observers are not ported yet ({_ROADMAP_METRICS})"
    )
