"""Common rule-manager machinery.

Every reference rule manager follows one shape (reference:
FlowRuleManager.java:56-170): a static rule map, a SentinelProperty it
listens on, ``loadRules`` = ``property.updateValue``, and
``register2Property`` to re-bind to a datasource's property. This base
class reproduces that shape; subclasses implement ``_apply`` to compile
and push the new rule set into the engine.
"""

from __future__ import annotations

import threading
from typing import Generic, List, Optional, Sequence, TypeVar

from sentinel_tpu_torch.core.property import (
    DynamicSentinelProperty,
    PropertyListener,
    SentinelProperty,
)
from sentinel_tpu_torch.utils.record_log import record_log

R = TypeVar("R")


class RuleManager(Generic[R]):
    rule_kind = "rule"

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._rules: List[R] = []
        # Monotonic store counter vs. the last version pushed into an
        # engine: lets the boot path's second re-apply pass skip
        # managers whose rules were already applied (no double compile).
        self._version = 0
        self._applied_version = 0
        self._listener = _ManagerListener(self)
        self._property: SentinelProperty = DynamicSentinelProperty()
        self._property.add_listener(self._listener)

    def load_rules(self, rules: Optional[Sequence[R]]) -> None:
        """FlowRuleManager.loadRules: push through the property so
        datasource-driven and manual updates share one path."""
        self._property.update_value(list(rules) if rules else [])

    def register_property(self, prop: SentinelProperty) -> None:
        """FlowRuleManager.register2Property."""
        with self._lock:
            self._property.remove_listener(self._listener)
            self._property = prop
            prop.add_listener(self._listener)

    def get_rules(self) -> List[R]:
        with self._lock:
            return list(self._rules)

    def has_rules(self) -> bool:
        with self._lock:
            return bool(self._rules)

    def clear(self) -> None:
        """Imperative reset (api.reset / tests) — deliberately NOT a
        ``load_rules([])``: the property dedups equal values, so a
        clear while the stored list is already empty would never fire
        ``_apply`` — yet _apply must still run, because it also pushes
        manager-held derived state (e.g. the gateway-converted param
        rules) into the CURRENT engine, which api.reset has just
        replaced with a fresh one. The property's cached value resets
        too, so a later datasource re-push of the same config is not
        silently deduped either."""
        reset = getattr(self._property, "reset_value", None)
        if reset is not None:
            reset()
            self._on_update([])
        elif not self._property.update_value(None):
            # Custom property without reset_value: update_value(None)
            # clears the cache AND fires _on_update through the
            # listener; when the cache was already None (deduped), the
            # apply still must run — it re-pushes manager-held derived
            # state into the current engine.
            self._on_update([])

    def re_apply(self, engine) -> None:
        """Push the stored rules into the given engine if they haven't
        been pushed yet. Called by ``api.get_engine()`` on first engine
        construction, so rules loaded before any entry call (the
        reference allows loadRules before InitExecutor.doInit runs) are
        not lost."""
        with self._lock:
            if self._version == self._applied_version:
                return
            self._applied_version = self._version
            if self._has_pending_state():
                self._apply(self._rules, engine)

    def _has_pending_state(self) -> bool:
        return bool(self._rules)

    # -- internal --
    def _on_update(self, rules: Optional[Sequence[R]]) -> None:
        from sentinel_tpu_torch.core.api import peek_engine

        rules = list(rules) if rules else []
        with self._lock:
            self._rules = rules
            self._version += 1
            # Do not force engine construction from a rule load: module
            # import instantiates the managers with an empty load, and
            # creating the Engine allocates device tensors — importing
            # this library must never touch a device. When no
            # engine exists, _apply still runs (manager-local derived
            # state like SystemRuleManager.effective must track the
            # stored rules) with engine=None, and the engine push
            # happens when the engine first comes up (re_apply).
            # NOTE: the peek must happen AFTER storing self._rules (the
            # boot thread's post-publication re_apply pass then cannot
            # miss them), and _apply receives the peeked engine rather
            # than calling get_engine() — taking api._engine_lock while
            # holding self._lock would invert the boot path's lock order
            # (ABBA deadlock with _reapply_all_managers).
            engine = peek_engine()
            applied = engine is not None
            if applied:
                self._applied_version = self._version
            try:
                self._apply(rules, engine)
            except Exception:
                record_log.error(
                    "[%s] Failed to apply rules", type(self).__name__, exc_info=True
                )
        record_log.info(
            "[%s] Rules loaded: %d%s",
            type(self).__name__,
            len(rules),
            "" if applied else " (stored; engine not yet up)",
        )

    def _apply(self, rules: List[R], engine) -> None:
        raise NotImplementedError


class _ManagerListener(PropertyListener):
    def __init__(self, mgr: RuleManager) -> None:
        self._mgr = mgr

    def config_update(self, value) -> None:
        self._mgr._on_update(value)
