"""System rule manager (port of ``sentinel_tpu/rules/system_manager.py``;
reference: SystemRuleManager.java:298-353).

The effective config is the minimum across rules per dimension, as in
loadSystemConf; the engine checks it against the global inbound row in
the flush (``runtime/flush.py:system_check``)."""

from __future__ import annotations

from typing import List, NamedTuple

from sentinel_tpu_torch.models.rules import SystemRule
from sentinel_tpu_torch.rules.manager_base import RuleManager


class SystemConfig(NamedTuple):
    highest_system_load: float = -1.0
    highest_cpu_usage: float = -1.0
    qps: float = -1.0
    max_rt: int = -1
    max_thread: int = -1

    @property
    def any_enabled(self) -> bool:
        return (
            self.highest_system_load >= 0
            or self.highest_cpu_usage >= 0
            or self.qps >= 0
            or self.max_rt >= 0
            or self.max_thread >= 0
        )


def _min_enabled(cur: float, new: float) -> float:
    if new < 0:
        return cur
    return new if cur < 0 else min(cur, new)


class SystemRuleManager(RuleManager[SystemRule]):
    rule_kind = "system"

    def __init__(self) -> None:
        super().__init__()
        self.effective = SystemConfig()

    def _apply(self, rules: List[SystemRule], engine) -> None:
        cfg = SystemConfig()
        for r in rules:
            cfg = SystemConfig(
                highest_system_load=_min_enabled(cfg.highest_system_load, r.highest_system_load),
                highest_cpu_usage=_min_enabled(cfg.highest_cpu_usage, r.highest_cpu_usage),
                qps=_min_enabled(cfg.qps, r.qps),
                max_rt=int(_min_enabled(cfg.max_rt, r.avg_rt)),
                max_thread=int(_min_enabled(cfg.max_thread, r.max_thread)),
            )
        self.effective = cfg
        if engine is not None:
            engine.set_system_config(cfg)


system_rule_manager = SystemRuleManager()
