"""Flow rule manager (reference: FlowRuleManager.java:56-170).

``load_rules`` validates + compiles the rule set to the device SoA table
(FlowIndex) and swaps it into the engine — the analog of
FlowRuleUtil.buildFlowRuleMap + the volatile map swap
(FlowRuleUtil.java:84-161, FlowRuleManager.java:159).
"""

from __future__ import annotations

from typing import List

from sentinel_tpu_torch.models.rules import FlowRule
from sentinel_tpu_torch.rules.manager_base import RuleManager


class FlowRuleManager(RuleManager[FlowRule]):
    rule_kind = "flow"

    def _apply(self, rules: List[FlowRule], engine) -> None:
        if engine is not None:
            engine.set_flow_rules(rules)

    def is_other_origin(self, origin: str, resource: str) -> bool:
        from sentinel_tpu_torch.core.api import get_engine

        return get_engine().flow_index.is_other_origin(origin, resource)


flow_rule_manager = FlowRuleManager()
