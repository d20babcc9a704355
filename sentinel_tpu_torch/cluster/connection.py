"""Per-namespace connection accounting for the token server (port of
``sentinel_tpu/cluster/connection.py``).

Reference: ConnectionManager / ConnectionGroup
(sentinel-cluster-server-default/.../server/connection/
ConnectionManager.java:40-120, ConnectionGroup.java:40-90): each client
connection is registered under the namespace it announced in its ping
(TokenServerHandler.handlePingRequest, TokenServerHandler.java:94-106),
and ``getConnectedCount(namespace)`` feeds the AVG_LOCAL global
threshold (ClusterFlowChecker.java:38-48,
ClusterParamFlowChecker.calcGlobalThreshold).

A connection that has not announced a namespace yet counts under
``default`` (the reference's clients always ping before requesting;
counting the un-announced under the default group keeps the invariant
that every live connection is counted somewhere).
"""

from __future__ import annotations

import threading
from typing import Dict, Set

DEFAULT_NAMESPACE = "default"


class ConnectionManager:
    """Tracks live connections per namespace; an address belongs to
    exactly one namespace at a time (re-announcing moves it, the
    reference's ConnectionManager keeps a CONN_MAP address→namespace
    alongside the groups for exactly this)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._groups: Dict[str, Set[str]] = {}
        self._ns_of: Dict[str, str] = {}

    def on_connect(self, address: str) -> None:
        """Register a new connection under the default namespace until
        it announces one."""
        self.bind(address, DEFAULT_NAMESPACE)

    def bind(self, address: str, namespace: str) -> int:
        """Bind (or move) ``address`` to ``namespace``; returns the
        namespace's new connected count (the reference ping response
        carries it)."""
        namespace = namespace or DEFAULT_NAMESPACE
        with self._lock:
            old = self._ns_of.get(address)
            if old is not None and old != namespace:
                group = self._groups.get(old)
                if group is not None:
                    group.discard(address)
                    if not group:
                        del self._groups[old]
            self._ns_of[address] = namespace
            group = self._groups.setdefault(namespace, set())
            group.add(address)
            return len(group)

    def on_disconnect(self, address: str) -> None:
        with self._lock:
            ns = self._ns_of.pop(address, None)
            if ns is None:
                return
            group = self._groups.get(ns)
            if group is not None:
                group.discard(address)
                if not group:
                    del self._groups[ns]

    def count(self, namespace: str) -> int:
        """getConnectedCount(namespace) — 0 when the namespace has no
        live connections (callers clamp to >=1 for thresholds, matching
        the reference's embedded-server self-connection floor)."""
        with self._lock:
            group = self._groups.get(namespace or DEFAULT_NAMESPACE)
            return len(group) if group else 0

    def total(self) -> int:
        with self._lock:
            return len(self._ns_of)

    def snapshot(self) -> Dict[str, int]:
        """Namespace → connected count, for /cluster/server/stats."""
        with self._lock:
            return {ns: len(group) for ns, group in self._groups.items()}

    def clear(self) -> None:
        with self._lock:
            self._groups.clear()
            self._ns_of.clear()
