"""Degrade (circuit breaker) rule manager (port of
``sentinel_tpu/rules/degrade_manager.py``; reference:
DegradeRuleManager.java). Valid rules go to the engine, which compiles
them into the breaker table (``rules/degrade_table.py``)."""

from __future__ import annotations

from typing import List

from sentinel_tpu_torch.models.rules import DegradeRule
from sentinel_tpu_torch.rules.manager_base import RuleManager


class DegradeRuleManager(RuleManager[DegradeRule]):
    rule_kind = "degrade"

    def _apply(self, rules: List[DegradeRule], engine) -> None:
        if engine is not None:
            engine.set_degrade_rules([r for r in rules if r.is_valid()])


degrade_rule_manager = DegradeRuleManager()
