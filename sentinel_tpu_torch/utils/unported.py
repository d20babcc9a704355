"""What the port does not have yet, and the ROADMAP item that owns it.

Every feature of the JAX package that the port lacks raises
``NotImplementedError`` naming its ROADMAP Queue 1 item, never
``AttributeError`` and never a silent no-op. Item numbers are stable
labels: tests match on them.
"""

from __future__ import annotations

ROADMAP_TIERS = "ROADMAP Queue 1 item 7 (engine tiers)"
ROADMAP_METRICS = "ROADMAP Queue 1 item 8 (metrics and observability)"
ROADMAP_ADAPTERS = "ROADMAP Queue 1 item 11 (transport, datasources, adapters, dashboard)"


def unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"sentinel_tpu_torch: {what} is not ported yet ({item})")

