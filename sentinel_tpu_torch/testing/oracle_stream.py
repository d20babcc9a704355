"""A seeded stream of single entries held against the sequential oracle
(:mod:`sentinel_tpu_torch.testing.oracle`).

Flow rules of three behaviors (DEFAULT QPS, RATE_LIMITER and WARM_UP) on
eight resources; each entry is its own flush, at a strictly later
ManualClock time than the last, so the engine decides it as the reference
would, one request at a time; an admitted entry exits at once. The oracle
takes the same calls: ``OracleFlowEngine`` for the QPS rules, an
``OracleRateLimiter`` a paced rule, an ``OracleWarmUp`` with its
``OracleNode`` a warm-up rule. ``chip_smoke.py`` phase 4m (e) and
tests/test_torch_kernels_gpu.py run it on the card, tests/test_torch_oracle.py
on the CPU.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.models.rules import FlowRule
from sentinel_tpu_torch.testing import oracle as O

QPS = {"q0": 3, "q1": 5, "q2": 8, "q3": 12}
PACED = {"rl0": (10, 200), "rl1": (5, 300)}  # count, max queueing ms
WARM = {"wu0": (10, 4), "wu1": (20, 2)}  # count, warm-up seconds
RESOURCES = list(QPS) + list(PACED) + list(WARM)


def stream_rules() -> List[FlowRule]:
    rules = [FlowRule(r, count=c) for r, c in QPS.items()]
    rules += [FlowRule(r, count=c, control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER, max_queueing_time_ms=q)
              for r, (c, q) in PACED.items()]
    rules += [FlowRule(r, count=c, control_behavior=C.CONTROL_BEHAVIOR_WARM_UP, warm_up_period_sec=w)
              for r, (c, w) in WARM.items()]
    return rules


def oracle_stream(engine, clock, seed: int = 0, n: int = 600) -> Tuple[list, list]:
    """Runs ``n`` entries through ``engine`` (its rules are replaced by
    :func:`stream_rules`; ``clock`` is its ManualClock) and through the
    oracle. Returns the two lists of (resource, t, admitted, wait_ms)."""
    engine.set_flow_rules(stream_rules())
    rng = np.random.default_rng(seed)
    flow = O.OracleFlowEngine()
    for r, c in QPS.items():
        flow.set_qps_rule(r, float(c))
    paced = {r: O.OracleRateLimiter(float(c), q) for r, (c, q) in PACED.items()}
    warm = {r: (O.OracleWarmUp(float(c), w), O.OracleNode()) for r, (c, w) in WARM.items()}
    got, want = [], []
    t = clock.now_ms()
    for _ in range(n):
        t += int(rng.choice([1, 3, 7, 37, 110]))
        clock.set_ms(t)
        res = RESOURCES[int(rng.integers(0, len(RESOURCES)))]
        op = engine.submit_entry(res, ts=t)
        engine.flush()
        v = op.verdict
        got.append((res, t, bool(v.admitted), int(v.wait_ms)))
        if res in QPS:
            ok, wait = flow.entry(res, t), 0
        elif res in PACED:
            ok, wait = paced[res].can_pass(t)
        else:
            ctl, node = warm[res]
            ok, wait = ctl.can_pass(node, t), 0
            node.add_pass(t, 1) if ok else node.add_block(t, 1)
        want.append((res, t, bool(ok), int(wait)))
        if v.admitted:
            engine.submit_exit(op.rows, rt=0, ts=t, resource=res)
        if ok:
            if res in QPS:
                flow.exit(res, t, 0)
            elif res in WARM:
                warm[res][1].add_rt_and_success(t, 0, 1)
    engine.flush()
    return got, want
