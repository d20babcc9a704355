"""Flow rule compilation and per-entry rule-slot resolution (port of
``sentinel_tpu/rules/flow_table.py``).

Compiles ``FlowRule`` beans into per-rule tensors on the engine's device
(:class:`FlowTableDevice`, padded to a power of two; padding always
passes) and a host index for per-entry node selection
(FlowRuleChecker.selectNodeByRequesterAndStrategy, FlowRuleChecker.java:
96-165): each entry gets up to K ``(rule_gid, check_row)`` slots, and a
rule that does not apply contributes no slot.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.metrics.nodes import NodeRegistry
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.models.rules import FlowRule
from sentinel_tpu_torch.utils.device import DeviceLike, resolve_device
from sentinel_tpu_torch.utils.numeric import pad_pow2 as _pad_pow2
from sentinel_tpu_torch.utils.record_log import record_log


class FlowTableDevice(NamedTuple):
    """Per-rule static parameters on device (padded; padding = always-pass)."""

    grade: torch.Tensor  # int32 [NR] FLOW_GRADE_THREAD / FLOW_GRADE_QPS
    count: torch.Tensor  # float32 [NR] threshold
    behavior: torch.Tensor  # int32 [NR] CONTROL_BEHAVIOR_*
    max_queueing_time_ms: torch.Tensor  # int32 [NR] (rate limiter)
    cost1_ms: torch.Tensor  # int32 [NR] round(1000/count), host-computed in float64
    warmup_warning_token: torch.Tensor  # int32 [NR] (warm up)
    warmup_max_token: torch.Tensor  # int32 [NR]
    warmup_slope: torch.Tensor  # float32 [NR]
    warmup_refill_threshold: torch.Tensor  # int32 [NR]

    @property
    def n_rules(self) -> int:
        return self.grade.shape[0]


class FlowRuleDynState(NamedTuple):
    """Per-rule mutable shaping state carried across flushes
    (RateLimiterController.latestPassedTime, WarmUpController.storedTokens
    / lastFilledTime). The DEFAULT controller never touches it."""

    latest_passed_time: torch.Tensor  # int32 [NR]
    stored_tokens: torch.Tensor  # float32 [NR]
    last_filled_time: torch.Tensor  # int32 [NR]


_FLOAT_FIELDS = ("count", "warmup_slope", "stored_tokens")


def flow_table_from_numpy(
    table, dyn, device
) -> Tuple[FlowTableDevice, Optional[FlowRuleDynState]]:
    """Flow tables on ``device`` from numpy arrays laid out as
    :class:`FlowTableDevice` and :class:`FlowRuleDynState` (the shape of
    ``jax.device_get`` of the JAX package's tables); ``dyn`` may be None."""

    def conv(cls, vals):
        out = {}
        for name, a in zip(cls._fields, vals):
            dt = np.float32 if name in _FLOAT_FIELDS else np.int32
            out[name] = torch.tensor(np.asarray(a, dtype=dt), device=device)
        return cls(**out)

    return conv(FlowTableDevice, table), (None if dyn is None else conv(FlowRuleDynState, dyn))


def _cost1_ms(count: float) -> int:
    """The acquire==1 rate-limiter cost: Java Math.round(1.0/count*1000)
    in float64 (Math.round is floor(x+0.5))."""
    return int(1.0 / count * 1000 + 0.5)


def _warmup_constants(r: FlowRule, cold_factor: int) -> Tuple[int, int, float, int]:
    """Guava SmoothWarmingUp-derived constants, computed exactly as the
    reference does (WarmUpController.construct, reference: controller/
    WarmUpController.java:84-107):

    *   warningToken = (int)(warmupSec * count) / (coldFactor-1)
        [int cast of the product, then INTEGER division]
    *   maxToken = warningToken + (int)(2*warmupSec*count/(1+coldFactor))
    *   slope = (coldFactor - 1) / count / (maxToken - warningToken)
    *   refill gate: passQps < (int)count / coldFactor
        ((int) binds to count; then integer division)."""
    cf = cold_factor
    warning = int(r.warm_up_period_sec * r.count) // (cf - 1)
    max_tok = warning + int(2 * r.warm_up_period_sec * r.count / (1.0 + cf))
    slope = (
        (cf - 1.0) / r.count / (max_tok - warning)
        if r.count > 0 and max_tok > warning
        else 0.0
    )
    return warning, max_tok, slope, int(r.count) // cf


@dataclass
class CompiledFlowRule:
    gid: int
    rule: FlowRule


class FlowIndex:
    """Host-side compiled view of the active flow rules."""

    def __init__(
        self, rules: Sequence[FlowRule], cold_factor: int = 3, device: DeviceLike = None
    ) -> None:
        # None means the card, as for the engine (no silent CPU).
        self.torch_device = resolve_device(device)
        # (resource, context, origin) -> resolved slots; see resolve_slots.
        self._slot_cache: Dict[Tuple[str, str, str], List[Tuple[int, int]]] = {}
        valid: List[FlowRule] = []
        for r in rules:
            if isinstance(r, dict):
                from sentinel_tpu_torch.models.rules import rules_from_json

                r = rules_from_json([r], FlowRule)[0]
            if r.is_valid():
                valid.append(r)
            else:
                record_log.warn("[FlowIndex] Ignoring invalid flow rule: %s", r)

        # FlowRuleComparator: origin-specific first, LIMIT_APP_OTHER next,
        # LIMIT_APP_DEFAULT last (stable within class).
        def order_key(r: FlowRule) -> int:
            if r.limit_app == C.LIMIT_APP_DEFAULT:
                return 2
            if r.limit_app == C.LIMIT_APP_OTHER:
                return 1
            return 0

        self.rules: List[CompiledFlowRule] = []
        self.by_resource: Dict[str, List[CompiledFlowRule]] = {}
        self.limit_apps: Dict[str, Set[str]] = {}
        by_res: Dict[str, List[FlowRule]] = {}
        for r in valid:
            by_res.setdefault(r.resource, []).append(r)
        for res, rs in by_res.items():
            rs_sorted = sorted(rs, key=order_key)
            compiled = []
            for r in rs_sorted:
                cr = CompiledFlowRule(gid=len(self.rules), rule=r)
                self.rules.append(cr)
                compiled.append(cr)
            self.by_resource[res] = compiled
            self.limit_apps[res] = {r.limit_app for r in rs}

        self.cold_factor = cold_factor
        self.device = self._build_device()
        # Rules the shaping stage decides (RATE_LIMITER, WARM_UP,
        # WARM_UP_RATE_LIMITER): their slots ride the shaping batch.
        self.shaping_gids = {
            cr.gid for cr in self.rules if cr.rule.control_behavior != C.CONTROL_BEHAVIOR_DEFAULT
        }
        self.has_shaping = bool(self.shaping_gids)
        self._shaping_mirror_cache: Dict[int, tuple] = {}
        # Cluster-mode rules route through the token service
        # (FlowRuleChecker.passClusterCheck) instead of the local check.
        self.cluster_gids = {cr.gid: cr.rule for cr in self.rules if cr.rule.cluster_mode}

    def _build_device(self) -> FlowTableDevice:
        n = _pad_pow2(len(self.rules))
        grade = [C.FLOW_GRADE_QPS] * n
        count = [float("inf")] * n  # padding threshold: always pass
        behavior = [C.CONTROL_BEHAVIOR_DEFAULT] * n
        maxq = [0] * n
        cost1 = [0] * n
        w_warn = [0] * n
        w_max = [0] * n
        w_slope = [0.0] * n
        w_refill = [0] * n
        for cr in self.rules:
            r = cr.rule
            grade[cr.gid] = r.grade
            count[cr.gid] = float(r.count)
            behavior[cr.gid] = r.control_behavior
            maxq[cr.gid] = int(r.max_queueing_time_ms)
            if r.count > 0:
                cost1[cr.gid] = _cost1_ms(r.count)
            if r.control_behavior in (
                C.CONTROL_BEHAVIOR_WARM_UP,
                C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER,
            ):
                warning, max_tok, slope, refill = _warmup_constants(r, self.cold_factor)
                w_warn[cr.gid] = warning
                w_max[cr.gid] = max_tok
                w_slope[cr.gid] = slope
                w_refill[cr.gid] = refill
        table, _ = flow_table_from_numpy(
            (grade, count, behavior, maxq, cost1, w_warn, w_max, w_slope, w_refill),
            None,
            self.torch_device,
        )
        return table

    def make_dyn_state(self) -> FlowRuleDynState:
        """Fresh mutable columns (a reload builds new controllers with
        fresh state, FlowRuleUtil.java:141-161)."""
        n = self.device.n_rules
        dev = self.torch_device
        return FlowRuleDynState(
            latest_passed_time=torch.full((n,), -(10**9), dtype=torch.int32, device=dev),
            stored_tokens=torch.zeros((n,), dtype=torch.float32, device=dev),
            last_filled_time=torch.full((n,), -(10**9), dtype=torch.int32, device=dev),
        )

    def is_other_origin(self, origin: str, resource: str) -> bool:
        """Reference: FlowRuleManager.isOtherOrigin — origin counts as
        "other" iff no rule of this resource names it as limitApp."""
        if not origin:
            return False
        return origin not in self.limit_apps.get(resource, set())

    def resolve_slots(
        self,
        resource: str,
        context_name: str,
        origin: str,
        nodes: NodeRegistry,
    ) -> List[Tuple[int, int]]:
        """(rule_gid, check_row) for every rule that applies to this entry.

        Mirrors selectNodeByRequesterAndStrategy
        (FlowRuleChecker.java:96-165). A rule returning "no node" there is
        simply omitted (it passes trivially).

        Memoized per (resource, context, origin): node rows are stable
        once interned and the rule set is frozen per index, so repeat
        submissions skip the per-rule row selection (the submit hot
        path — the analog of the reference caching one slot chain per
        resource, CtSph.lookProcessChain). The cache assumes one
        NodeRegistry per index, which the engine guarantees (a reload
        builds a fresh index; reset builds both fresh). Callers must
        not mutate the returned list.
        """
        key = (resource, context_name, origin)
        hit = self._slot_cache.get(key)
        if hit is not None:
            return hit
        out: List[Tuple[int, int]] = []
        cacheable = True
        for cr in self.by_resource.get(resource, ()):
            r = cr.rule
            row = self._select_row(r, resource, context_name, origin, nodes)
            if row is not None:
                out.append((cr.gid, row))
            elif (
                r.strategy == C.STRATEGY_RELATE
                and r.ref_resource
                and nodes.lookup_cluster_row(r.ref_resource) is None
            ):
                # RELATE omission is TRANSIENT: the referenced
                # resource's node appears when it first sees traffic
                # (lookup is non-creating, matching selectReferenceNode
                # returning null until then) — pinning the omission
                # would disable the cross-resource limit forever.
                cacheable = False
        if cacheable:
            self._slot_cache[key] = out
        return out

    def _select_row(
        self,
        r: FlowRule,
        resource: str,
        context_name: str,
        origin: str,
        nodes: NodeRegistry,
    ) -> Optional[int]:
        la = r.limit_app
        if la == origin and origin not in (C.LIMIT_APP_DEFAULT, C.LIMIT_APP_OTHER):
            if r.strategy == C.STRATEGY_DIRECT:
                return nodes.origin_row(resource, origin)
            return self._reference_row(r, resource, context_name, nodes)
        if la == C.LIMIT_APP_DEFAULT:
            if r.strategy == C.STRATEGY_DIRECT:
                return nodes.cluster_row(resource)
            return self._reference_row(r, resource, context_name, nodes)
        if la == C.LIMIT_APP_OTHER and self.is_other_origin(origin, resource):
            if r.strategy == C.STRATEGY_DIRECT:
                return nodes.origin_row(resource, origin)
            return self._reference_row(r, resource, context_name, nodes)
        return None

    def _reference_row(
        self, r: FlowRule, resource: str, context_name: str, nodes: NodeRegistry
    ) -> Optional[int]:
        # Reference: FlowRuleChecker.selectReferenceNode.
        if not r.ref_resource:
            return None
        if r.strategy == C.STRATEGY_RELATE:
            return nodes.lookup_cluster_row(r.ref_resource)
        if r.strategy == C.STRATEGY_CHAIN:
            if r.ref_resource != context_name:
                return None
            return nodes.default_row(resource, context_name)
        return None

    def rule_of_gid(self, gid: int) -> Optional[FlowRule]:
        if 0 <= gid < len(self.rules):
            return self.rules[gid].rule
        return None

    def get_rules(self) -> List[FlowRule]:
        return [cr.rule for cr in self.rules]

    def user_rules(self) -> List[FlowRule]:
        """The rules without the sketch tier's synthetics (``from_sketch``):
        the base a promotion or demotion rebuild puts its synthetic guards
        on (runtime/sketch.py)."""
        return [cr.rule for cr in self.rules if not getattr(cr.rule, "from_sketch", False)]

    def mirror_shaping_info(self, gid: int):
        """``(rule, behavior, count, max_queueing_time_ms, cost1_ms,
        warning_token, max_token, slope, refill_threshold)`` of a shaping
        rule, for the host mirrors (``rules/shaping.mirror_shaping_decide``),
        or None for other gids. ``cost1_ms`` is the exact int the device
        table carries. Cached per index."""
        hit = self._shaping_mirror_cache.get(gid)
        if hit is None:
            if gid not in self.shaping_gids:
                return None
            rule = self.rule_of_gid(gid)
            if rule is None:
                return None
            cost1 = _cost1_ms(rule.count) if rule.count > 0 else 0
            warning = max_tok = refill = 0
            slope = 0.0
            if rule.control_behavior in (C.CONTROL_BEHAVIOR_WARM_UP, C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER):
                warning, max_tok, slope, refill = _warmup_constants(rule, self.cold_factor)
            hit = self._shaping_mirror_cache[gid] = (
                rule, rule.control_behavior, float(rule.count), int(rule.max_queueing_time_ms), cost1,
                float(warning), float(max_tok), float(slope), float(refill),
            )
        return hit
