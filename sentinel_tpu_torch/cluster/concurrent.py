"""Cluster concurrent (in-flight) flow control (port of
``sentinel_tpu/cluster/concurrent.py``).

Reference: ConcurrentClusterFlowChecker
(sentinel-cluster-server-default/.../flow/ConcurrentClusterFlowChecker.
java:30-100) + CurrentConcurrencyManager (statistic/concurrent/
CurrentConcurrencyManager.java) + TokenCacheNode/TokenCacheNodeManager
(statistic/concurrent/TokenCacheNode.java:20-75): the server hands out
*held* tokens — acquire bumps a per-flowId concurrency gauge against
``count × (GLOBAL ? 1 : connectedCount)``, release (or timeout) drops
it. This is scalar per-rule bookkeeping on the control plane, not the
per-entry hot path — a plain dict + lock is the right tool here; the
batched kernels remain the QPS/flow decision path.

Token expiry: the reference schedules a regular sweep that force-frees
tokens held past the rule's ``resourceTimeout`` (client died / never
released). Here the sweep runs opportunistically on acquire/release
(at most once per ``SWEEP_INTERVAL_MS``) and on demand via
:meth:`sweep_expired` — no background thread needed for correctness.
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass
from typing import Dict, Optional

from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.utils.clock import Clock, default_clock
from sentinel_tpu_torch.utils.record_log import record_log


@dataclass
class TokenCacheNode:
    """One held concurrency token (TokenCacheNode.java:20-75).

    The reference also stamps a clientTimeout (clientOfflineTime grace
    before a disconnected client's tokens expire); the JAX package's TCP
    server frees a vanished client's tokens eagerly on disconnect
    (:meth:`ConcurrentFlowManager.release_client`), so only the resource
    timeout is tracked."""

    token_id: int
    flow_id: int
    acquire_count: int
    client_address: str
    resource_timeout_at: int  # ms, rel clock


class ConcurrentFlowManager:
    """Per-service concurrency gauges + held-token cache
    (CurrentConcurrencyManager + TokenCacheNodeManager combined)."""

    SWEEP_INTERVAL_MS = 1000

    def __init__(self, clock: Optional[Clock] = None) -> None:
        self.clock = clock or default_clock()
        self._lock = threading.RLock()
        self._now_calls: Dict[int, int] = {}
        self._tokens: Dict[int, TokenCacheNode] = {}
        self._last_sweep = -(10**9)

    # ------------------------------------------------------------------
    def now_calls(self, flow_id: int) -> int:
        with self._lock:
            return self._now_calls.get(int(flow_id), 0)

    def held_tokens(self) -> int:
        with self._lock:
            return len(self._tokens)

    @staticmethod
    def _threshold(rule, connected_count: int) -> float:
        """calcGlobalThreshold (ConcurrentClusterFlowChecker.java:33-45):
        GLOBAL → count; AVG_LOCAL → count × connectedCount."""
        cc = rule.cluster_config
        if cc.threshold_type == C.FLOW_THRESHOLD_GLOBAL:
            return float(rule.count)
        return float(rule.count) * max(1, connected_count)

    def acquire(self, client_address: str, rule, acquire_count: int,
                connected_count: int = 1):
        """acquireConcurrentToken (java:48-76). Returns
        (status, token_id): OK grants and caches a token; BLOCKED when
        ``nowCalls + acquire`` would exceed the global threshold."""
        from sentinel_tpu_torch.cluster import stat_log

        flow_id = int(rule.cluster_config.flow_id)
        now = self.clock.now_ms()
        threshold = self._threshold(rule, connected_count)
        with self._lock:
            self._maybe_sweep(now)
            calls = self._now_calls.get(flow_id, 0)
            if calls + acquire_count > threshold:
                # At capacity: force a sweep — expired tokens must not
                # keep the flow blocked until the next throttled sweep.
                self._sweep_locked(now)
                calls = self._now_calls.get(flow_id, 0)
            blocked = calls + acquire_count > threshold
            token_id = 0
            if not blocked:
                self._now_calls[flow_id] = calls + acquire_count
                token_id = uuid.uuid4().int >> 65  # 63-bit, like the UUID msb
                cc = rule.cluster_config
                self._tokens[token_id] = TokenCacheNode(
                    token_id=token_id,
                    flow_id=flow_id,
                    acquire_count=acquire_count,
                    client_address=client_address,
                    resource_timeout_at=now + int(cc.resource_timeout),
                )
        # Stat-log outside the lock: the interval roll does file IO and
        # must not stall acquire/release cluster-wide on a disk hiccup.
        if blocked:
            stat_log.log("concurrent", "block", flow_id, acquire_count)
            return C.TokenResultStatus.BLOCKED, 0
        stat_log.log("concurrent", "pass", flow_id, acquire_count)
        return C.TokenResultStatus.OK, token_id

    def release(self, token_id: int):
        """releaseConcurrentToken (java:78-99). Returns the status:
        RELEASE_OK, or ALREADY_RELEASE when the token is unknown
        (double release / expired-and-swept)."""
        from sentinel_tpu_torch.cluster import stat_log

        with self._lock:
            self._maybe_sweep(self.clock.now_ms())
            node = self._tokens.pop(int(token_id), None)
            if node is not None:
                self._drop_locked(node)
        if node is None:
            return C.TokenResultStatus.ALREADY_RELEASE
        stat_log.log("concurrent", "release", node.flow_id, node.acquire_count)
        return C.TokenResultStatus.RELEASE_OK

    def _drop_locked(self, node: TokenCacheNode) -> None:
        calls = self._now_calls.get(node.flow_id, 0)
        self._now_calls[node.flow_id] = max(0, calls - node.acquire_count)

    def release_client(self, client_address: str) -> int:
        """Free every token a disconnected client still holds (the
        clientOfflineTime story: ConnectionManager disconnect →
        tokens time out; freeing eagerly on disconnect is strictly
        tighter). Returns the number released."""
        with self._lock:
            mine = [t for t in self._tokens.values()
                    if t.client_address == client_address]
            for node in mine:
                del self._tokens[node.token_id]
                self._drop_locked(node)
            return len(mine)

    def sweep_expired(self, now: Optional[int] = None) -> int:
        """Force-free tokens held past their resource timeout; returns
        the number swept (the reference's scheduled expire task)."""
        now = self.clock.now_ms() if now is None else now
        with self._lock:
            return self._sweep_locked(now)

    def _maybe_sweep(self, now: int) -> None:
        if now - self._last_sweep >= self.SWEEP_INTERVAL_MS:
            self._sweep_locked(now)

    def _sweep_locked(self, now: int) -> int:
        self._last_sweep = now
        expired = [t for t in self._tokens.values() if now >= t.resource_timeout_at]
        for node in expired:
            del self._tokens[node.token_id]
            self._drop_locked(node)
            record_log.info(
                "[ConcurrentFlow] token %d (flow %d) expired after resourceTimeout",
                node.token_id, node.flow_id,
            )
        return len(expired)

    def clear(self) -> None:
        with self._lock:
            self._now_calls.clear()
            self._tokens.clear()
            self._last_sweep = -(10**9)
