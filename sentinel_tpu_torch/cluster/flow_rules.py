"""Cluster-side rule and server-config managers (port of
``sentinel_tpu/cluster/flow_rules.py``).

Reference: ClusterFlowRuleManager (namespace-scoped flow rules keyed by
flowId), ClusterParamFlowRuleManager, and ClusterServerConfigManager
(port / idleSeconds / namespaces / maxAllowedQps / exceedCount /
maxOccupyRatio).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Set

from sentinel_tpu_torch.core.property import FuncListener, SentinelProperty
from sentinel_tpu_torch.models.rules import FlowRule
from sentinel_tpu_torch.utils.record_log import record_log


class ClusterServerConfig:
    """Flow-related server config (ClusterServerFlowConfig + transport)."""

    def __init__(self) -> None:
        self.port = 18730
        self.idle_seconds = 600
        self.exceed_count = 1.0
        self.max_occupy_ratio = 1.0
        self.max_allowed_qps = 30000.0  # GlobalRequestLimiter default
        self.namespaces: Set[str] = {"default"}


class ClusterServerConfigManager:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self.config = ClusterServerConfig()
        self._listeners: List = []

    def load_global_flow_config(
        self,
        exceed_count: Optional[float] = None,
        max_occupy_ratio: Optional[float] = None,
        max_allowed_qps: Optional[float] = None,
    ) -> None:
        with self._lock:
            if exceed_count is not None:
                self.config.exceed_count = exceed_count
            if max_occupy_ratio is not None:
                self.config.max_occupy_ratio = max_occupy_ratio
            if max_allowed_qps is not None:
                self.config.max_allowed_qps = max_allowed_qps
        self._notify()

    def load_server_namespace_set(self, namespaces: Sequence[str]) -> None:
        with self._lock:
            self.config.namespaces = set(namespaces) or {"default"}
        self._notify()

    def set_port(self, port: int) -> None:
        with self._lock:
            self.config.port = port

    def add_listener(self, fn) -> None:
        self._listeners.append(fn)

    def _notify(self) -> None:
        for fn in list(self._listeners):
            try:
                fn(self.config)
            except Exception:
                record_log.error("[ClusterServerConfigManager] listener failed", exc_info=True)


class ClusterFlowRuleManager:
    """Namespace -> {flow_id -> rule} (ClusterFlowRuleManager.java). Rules
    arrive per namespace, directly or through a registered property."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._rules: Dict[str, Dict[int, FlowRule]] = {}
        self._props: Dict[str, SentinelProperty] = {}
        self._listeners: List = []

    def load_rules(self, namespace: str, rules: Sequence[FlowRule]) -> None:
        by_id: Dict[int, FlowRule] = {}
        for r in rules:
            if not r.cluster_mode or r.cluster_config is None or r.cluster_config.flow_id is None:
                record_log.warn("[ClusterFlowRuleManager] ignoring non-cluster rule %s", r)
                continue
            by_id[int(r.cluster_config.flow_id)] = r
        with self._lock:
            self._rules[namespace] = by_id
        for fn in list(self._listeners):
            fn(namespace)

    def register_property(self, namespace: str, prop: SentinelProperty) -> None:
        with self._lock:
            self._props[namespace] = prop
        prop.add_listener(FuncListener(lambda rules: self.load_rules(namespace, rules or [])))

    def get_rule_by_id(self, flow_id: int) -> Optional[FlowRule]:
        with self._lock:
            for by_id in self._rules.values():
                if flow_id in by_id:
                    return by_id[flow_id]
        return None

    def namespace_of(self, flow_id: int) -> Optional[str]:
        with self._lock:
            for ns, by_id in self._rules.items():
                if flow_id in by_id:
                    return ns
        return None

    def all_flow_ids(self) -> List[int]:
        with self._lock:
            return [fid for by_id in self._rules.values() for fid in by_id]

    def add_listener(self, fn) -> None:
        self._listeners.append(fn)

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()


cluster_flow_rule_manager = ClusterFlowRuleManager()
cluster_server_config_manager = ClusterServerConfigManager()
