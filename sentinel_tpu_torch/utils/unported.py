"""What the port does not have yet, and the ROADMAP item that owns it.

Every feature of the JAX package that the port lacks raises
``NotImplementedError`` naming its ROADMAP Queue 1 item, never
``AttributeError`` and never a silent no-op. Item numbers are stable
labels: tests match on them.
"""

from __future__ import annotations

ROADMAP_TIERS = "ROADMAP Queue 1 item 7 (engine tiers)"
ROADMAP_METRICS = "ROADMAP Queue 1 item 8 (metrics and observability)"
ROADMAP_CLUSTER = "ROADMAP Queue 1 item 9 (cluster token plane)"
ROADMAP_IPC = "ROADMAP Queue 1 item 10 (IPC plane)"


def unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"sentinel_tpu_torch: {what} is not ported yet ({item})")


class UnportedName:
    """Stands in for a public name of the JAX package whose module is not
    ported: calling it, or reading an attribute of it, raises."""

    def __init__(self, name: str, item: str) -> None:
        self._name = name
        self._item = item

    def __call__(self, *args, **kwargs):
        raise unported(self._name, self._item)

    def __getattr__(self, attr: str):
        if attr.startswith("__") or attr in ("_name", "_item"):
            raise AttributeError(attr)
        raise unported(f"{self._name}.{attr}", self._item)

    def __repr__(self) -> str:
        return f"<{self._name}: not ported yet ({self._item})>"
