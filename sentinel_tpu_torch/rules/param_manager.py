"""Hot-parameter flow rule manager (port of
``sentinel_tpu/rules/param_manager.py``; reference:
sentinel-extension/sentinel-parameter-flow-control/.../ParamFlowRuleManager.java).
Valid rules go to the engine, which builds a fresh value index for them
(``rules/param_table.ParamIndex``)."""

from __future__ import annotations

from typing import Dict, List

from sentinel_tpu_torch.models.rules import ParamFlowRule
from sentinel_tpu_torch.rules.manager_base import RuleManager


class ParamFlowRuleManager(RuleManager[ParamFlowRule]):
    rule_kind = "param-flow"

    def __init__(self) -> None:
        # Fields _apply reads must exist before super().__init__(): the
        # base attaches the property listener there, which fires a load
        # on this half-built instance.
        self.by_resource: Dict[str, List[ParamFlowRule]] = {}
        # Converted gateway rules contribute alongside user rules.
        self._gateway_rules: List[ParamFlowRule] = []
        super().__init__()

    def set_gateway_rules(self, rules: List[ParamFlowRule]) -> None:
        from sentinel_tpu_torch.core.api import peek_engine

        with self._lock:
            self._gateway_rules = list(rules)
            self._version += 1
            engine = peek_engine()
            if engine is not None:
                self._applied_version = self._version
            self._apply(self._rules, engine)

    def _has_pending_state(self) -> bool:
        return bool(self._rules or self._gateway_rules)

    def _apply(self, rules: List[ParamFlowRule], engine) -> None:
        # engine.set_param_rules builds a fresh ParamIndex: every
        # value -> row mapping is dropped on reload, like the reference
        # clearing ParameterMetric.
        by_res: Dict[str, List[ParamFlowRule]] = {}
        for r in list(rules) + self._gateway_rules:
            if r.is_valid():
                by_res.setdefault(r.resource, []).append(r)
        self.by_resource = by_res
        if engine is not None:
            engine.set_param_rules(by_res)


param_flow_rule_manager = ParamFlowRuleManager()
