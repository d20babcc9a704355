"""Circuit-breaker state-change observers (the surface of
``sentinel_tpu/rules/breaker_events.py``; reference:
EventObserverRegistry.java).

The breakers themselves are ported (``rules/degrade_table.py``); the
host-side post-flush state diff that feeds observers is not yet. So
registering an observer raises rather than silently never firing."""

from __future__ import annotations

from sentinel_tpu_torch.utils.unported import ROADMAP_METRICS, unported


def add_state_change_observer(name: str, observer) -> None:
    """EventObserverRegistry.addStateChangeObserver: not ported yet."""
    raise unported("breaker state-change observers", ROADMAP_METRICS)
