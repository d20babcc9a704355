"""Authority rule manager (port of ``sentinel_tpu/rules/authority_manager.py``;
reference: AuthorityRuleManager.java + AuthorityRuleChecker.java:31-60).

Origin white/black lists, one rule per resource. The check is decided on
the host when an entry is submitted and rides the batch as ``e_auth_ok``."""

from __future__ import annotations

from typing import Dict, List

from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.models.rules import AuthorityRule
from sentinel_tpu_torch.rules.manager_base import RuleManager


class AuthorityRuleManager(RuleManager[AuthorityRule]):
    rule_kind = "authority"

    def __init__(self) -> None:
        super().__init__()
        # resource -> rule (the reference keeps one rule per resource).
        self.by_resource: Dict[str, AuthorityRule] = {}

    def _apply(self, rules: List[AuthorityRule], engine) -> None:
        self.by_resource = {r.resource: r for r in rules if r.is_valid()}
        if engine is not None:
            engine.set_authority_rules(self.by_resource)

    @staticmethod
    def passes(rule: AuthorityRule, origin: str) -> bool:
        """AuthorityRuleChecker.passCheck: contains-check on the comma
        list, then white -> must contain, black -> must not contain."""
        if not origin or not rule.limit_app:
            return True
        apps = {a.strip() for a in rule.limit_app.split(",")}
        contains = origin in apps
        if rule.strategy == C.AUTHORITY_BLACK:
            return not contains
        return contains


authority_rule_manager = AuthorityRuleManager()
