"""Rule dataclasses.

Field names/defaults mirror the reference rule beans so JSON rule files
interoperate (reference: FlowRule.java:52-90, DegradeRule.java:59-84,
SystemRule.java:43-50, AuthorityRule.java, ParamFlowRule.java:45-83,
ClusterFlowConfig.java:34-51). Rules are *immutable values*; compilation
into device tensors happens in rule managers (double-buffered swap, the
analog of the reference's volatile map swap in FlowRuleManager.java:159).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sentinel_tpu_torch.models import constants as C


def _freeze(obj: Any) -> Any:
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, set)):
        return tuple(_freeze(v) for v in obj)
    return obj


@dataclass(frozen=True)
class AbstractRule:
    """Common rule base (reference: slots/block/AbstractRule.java)."""

    resource: str = ""
    limit_app: str = C.LIMIT_APP_DEFAULT

    def is_valid(self) -> bool:
        return bool(self.resource and self.resource.strip())

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class ClusterFlowConfig:
    """Cluster-mode per-rule config (reference: ClusterFlowConfig.java:34-51)."""

    flow_id: Optional[int] = None
    threshold_type: int = C.FLOW_THRESHOLD_AVG_LOCAL
    fallback_to_local_when_fail: bool = True
    sample_count: int = 10  # ClusterRuleConstant.DEFAULT_CLUSTER_SAMPLE_COUNT
    window_interval_ms: int = C.DEFAULT_WINDOW_INTERVAL_MS
    acquire_refuse_strategy: int = C.DEFAULT_BLOCK_STRATEGY
    # Concurrent (held-token) mode timeouts, ms (ClusterFlowConfig.java:
    # resourceTimeout / clientOfflineTime defaults).
    resource_timeout: int = 2000
    client_offline_time: int = 2000


@dataclass(frozen=True)
class FlowRule(AbstractRule):
    """Flow-control rule (reference: FlowRule.java:52-90).

    grade: FLOW_GRADE_QPS (default) or FLOW_GRADE_THREAD.
    strategy: DIRECT / RELATE(ref_resource) / CHAIN(entrance context).
    control_behavior: DEFAULT / WARM_UP / RATE_LIMITER / WARM_UP_RATE_LIMITER.
    """

    grade: int = C.FLOW_GRADE_QPS
    count: float = 0.0
    strategy: int = C.STRATEGY_DIRECT
    ref_resource: Optional[str] = None
    control_behavior: int = C.CONTROL_BEHAVIOR_DEFAULT
    warm_up_period_sec: int = 10
    max_queueing_time_ms: int = 500
    cluster_mode: bool = False
    cluster_config: Optional[ClusterFlowConfig] = None
    # True only on rules the sketch tier synthesized for a promoted
    # unconfigured resource (runtime/sketch.py). A user rule reload
    # never carries it, so the tier can tell its own synthetics apart
    # when rebuilding the rule set on promotion/demotion.
    from_sketch: bool = False

    def is_valid(self) -> bool:
        # Reference: FlowRuleUtil.isValidRule — non-null resource, count >= 0,
        # valid strategy/behavior; RELATE/CHAIN need refResource.
        if not super().is_valid() or self.count < 0:
            return False
        if self.grade not in (C.FLOW_GRADE_THREAD, C.FLOW_GRADE_QPS):
            return False
        if self.strategy not in (C.STRATEGY_DIRECT, C.STRATEGY_RELATE, C.STRATEGY_CHAIN):
            return False
        if self.strategy != C.STRATEGY_DIRECT and not self.ref_resource:
            return False
        if self.control_behavior not in (
            C.CONTROL_BEHAVIOR_DEFAULT,
            C.CONTROL_BEHAVIOR_WARM_UP,
            C.CONTROL_BEHAVIOR_RATE_LIMITER,
            C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER,
        ):
            return False
        if self.cluster_mode and (self.cluster_config is None or self.cluster_config.flow_id is None):
            return False
        return True


@dataclass(frozen=True)
class DegradeRule(AbstractRule):
    """Circuit-breaking rule (reference: DegradeRule.java:59-84).

    grade RT → slow-call-ratio breaker with ``count`` = max RT (ms) and
    ``slow_ratio_threshold``; grade EXCEPTION_RATIO / EXCEPTION_COUNT →
    exception breaker. ``time_window`` is the recovery (OPEN) timeout in
    seconds; ``stat_interval_ms`` the breaker's own sliding window.
    """

    grade: int = C.DEGRADE_GRADE_RT
    count: float = 0.0
    time_window: int = 0
    min_request_amount: int = C.DEGRADE_DEFAULT_MIN_REQUEST_AMOUNT
    slow_ratio_threshold: float = 1.0
    stat_interval_ms: int = 1000

    def is_valid(self) -> bool:
        # Reference: DegradeRuleManager.isValidRule.
        if not super().is_valid() or self.count < 0 or self.time_window <= 0:
            return False
        if self.min_request_amount <= 0 or self.stat_interval_ms <= 0:
            return False
        if self.grade == C.DEGRADE_GRADE_RT:
            return self.slow_ratio_threshold >= 0
        if self.grade == C.DEGRADE_GRADE_EXCEPTION_RATIO:
            return 0 <= self.count <= 1
        return self.grade == C.DEGRADE_GRADE_EXCEPTION_COUNT


@dataclass(frozen=True)
class SystemRule(AbstractRule):
    """Global inbound protection thresholds (reference: SystemRule.java:43-50).

    -1 disables a dimension; the effective system config is the min over
    all loaded rules per dimension (SystemRuleManager.loadSystemConf).
    """

    highest_system_load: float = -1.0
    highest_cpu_usage: float = -1.0
    qps: float = -1.0
    avg_rt: int = -1
    max_thread: int = -1


@dataclass(frozen=True)
class AuthorityRule(AbstractRule):
    """Origin white/black list (reference: authority/AuthorityRule.java).

    ``limit_app`` holds the comma-separated origin list, like the
    reference (AuthorityRuleChecker.java:31-60).
    """

    strategy: int = C.AUTHORITY_WHITE

    def is_valid(self) -> bool:
        return super().is_valid() and bool(self.limit_app and self.limit_app.strip())


@dataclass(frozen=True)
class ParamFlowItem:
    """Per-value threshold exception (reference: ParamFlowItem.java)."""

    object: str = ""
    count: int = 0
    class_type: str = "java.lang.String"


@dataclass(frozen=True)
class ParamFlowRule(AbstractRule):
    """Hot-parameter rule (reference: ParamFlowRule.java:45-83)."""

    grade: int = C.FLOW_GRADE_QPS
    param_idx: Optional[int] = None
    count: float = 0.0
    control_behavior: int = C.CONTROL_BEHAVIOR_DEFAULT
    max_queueing_time_ms: int = 0
    burst_count: int = 0
    duration_in_sec: int = 1
    param_flow_item_list: Tuple[ParamFlowItem, ...] = field(default_factory=tuple)
    # Sketch-native mode (runtime/sketch.py): cold values are tracked
    # only by the fixed-size device sketch and PASS without a dense
    # row; sketch-detected heavy hitters are promoted into exact dense
    # rows (threshold = this rule's count, hot items still override)
    # and demoted back on decay. With the sketch tier disabled the
    # flag is ignored and the rule dense-tracks every value as before.
    sketch_mode: bool = False
    cluster_mode: bool = False
    # ParamFlowClusterConfig (reference: ParamFlowClusterConfig.java:30-49)
    # shares ClusterFlowConfig's shape: flowId, thresholdType,
    # fallbackToLocalWhenFail, sampleCount, windowIntervalMs.
    cluster_config: Optional[ClusterFlowConfig] = None

    def __post_init__(self) -> None:
        if isinstance(self.param_flow_item_list, list):
            object.__setattr__(self, "param_flow_item_list", tuple(self.param_flow_item_list))

    def is_valid(self) -> bool:
        # Reference: ParamFlowRuleUtil.isValidRule.
        if self.cluster_mode and (
            self.cluster_config is None or self.cluster_config.flow_id is None
        ):
            return False
        return (
            super().is_valid()
            and self.count >= 0
            and self.grade in (C.FLOW_GRADE_THREAD, C.FLOW_GRADE_QPS)
            and self.param_idx is not None
            and self.duration_in_sec > 0
        )


@functools.lru_cache(maxsize=1024)
def _snake(name: str) -> str:
    """``countMode`` -> ``count_mode`` (a rule file's few key names, cached)."""
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


def rules_from_json(
    data: Sequence[Dict[str, Any]], rule_cls: type, aliases: Optional[Dict[str, str]] = None
) -> List[Any]:
    """Build rules from JSON-ish dicts, accepting both this framework's
    snake_case and the reference's camelCase field names (so rule files
    written for the Java dashboard load unchanged)."""

    field_names = {f.name for f in dataclasses.fields(rule_cls)}
    result = []
    for item in data:
        kwargs: Dict[str, Any] = {}
        for k, v in item.items():
            key = _snake(k)
            if aliases and key in aliases:
                key = aliases[key]
            if key in field_names:
                if key == "cluster_config" and isinstance(v, dict):
                    v = ClusterFlowConfig(
                        **{
                            _snake(ck): cv
                            for ck, cv in v.items()
                            if _snake(ck) in {f.name for f in dataclasses.fields(ClusterFlowConfig)}
                        }
                    )
                if key == "param_flow_item_list" and isinstance(v, list):
                    v = tuple(
                        ParamFlowItem(
                            object=str(it.get("object", "")),
                            count=int(it.get("count", 0)),
                            class_type=str(it.get("classType", it.get("class_type", "java.lang.String"))),
                        )
                        for it in v
                    )
                kwargs[key] = v
        result.append(rule_cls(**kwargs))
    return result
