"""Parity of the port's DEFAULT-path flush (sentinel_tpu_torch/runtime/
flush.py, plain PyTorch versions on the CPU) with the JAX package's
flush, bit for bit: ``flow_admission`` and ``flush_step`` with and
without exits, QPS and THREAD grades, two rule slots per entry whose
check rows differ from the accounting rows (RELATE/CHAIN), timestamps
near 2**31 - 1, equal timestamps on one row, ties in the blocked top-K
and fewer than 8 blocked rows. Every FlushResult output and every state
tensor is compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.rules.degrade_table import DegradeIndex
from sentinel_tpu.rules.flow_table import FlowRuleDynState as JDyn
from sentinel_tpu.rules.flow_table import FlowTableDevice as JTable
from sentinel_tpu.rules.param_table import make_param_state
from sentinel_tpu.runtime import flush as jflush
from sentinel_tpu_torch.metrics import nodes as tnodes
from sentinel_tpu_torch.rules.flow_table import flow_table_from_numpy
from sentinel_tpu_torch.runtime import flush as tflush

from test_torch_nodes import _jax_stats, _random_stats
from torch_parity import INF, assert_same, random_flow_table, random_flush_batch

CPU = torch.device("cpu")


def _jax_batch(b):
    return jflush.FlushBatch(*(jnp.asarray(a) for a in b))


_jax_flow_admission = jax.jit(lambda s, t, b: jflush.flow_admission(s, t, b, with_occupy=False))


def _jax_tables(table, dyn):
    return JTable(*(jnp.asarray(a) for a in table)), JDyn(*(jnp.asarray(a) for a in dyn))


CASES = {
    # name: (n, k, n_valid, m_valid, near_max, table (lo, hi))
    "qps_thread_k2": (64, 2, 60, 0, False, (0, 8)),
    "k1_exits": (32, 1, 32, 8, False, (0, 6)),
    "near_int32_max": (32, 2, 30, 8, True, (0, 8)),
    "few_blocked": (32, 1, 20, 4, False, (12, 20)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flow_admission_parity(case):
    n, k, n_valid, _, near_max, (lo, hi) = CASES[case]
    rng = np.random.default_rng(len(case))
    n_rows, nr = 32, 16
    now = 2**31 - 1 - 7 if near_max else 654_321
    arrs = _random_stats(rng, n_rows, now)
    table, dyn = random_flow_table(rng, nr, lo=lo, hi=hi)
    b = random_flush_batch(rng, n, k, n_rows, nr, now, n_valid, near_max=near_max)
    jt, _ = _jax_tables(table, dyn)
    slot_ok, flow_pass, *_ = _jax_flow_admission(_jax_stats(arrs), jt, _jax_batch(b))
    tt, _ = flow_table_from_numpy(table, dyn, CPU)
    got = tflush.flow_admission(tnodes.stats_from_numpy(arrs, CPU), tt, tflush.batch_from_numpy(b, CPU))
    assert_same(slot_ok, got.slot_ok, "slot_ok")
    assert_same(flow_pass, got.flow_pass, "flow_pass")


def _jax_flush_step(stats, table, dyn, batch, with_exits, topk):
    dindex = DegradeIndex([])
    sysdev = jflush.SystemDevice(*(jnp.float32(v) for v in (INF, INF, INF, -1.0, -1.0, -1.0, -1.0)))
    out = jflush.flush_step_jit(
        stats, table, dyn, dindex.device, dindex.make_dyn_state(), make_param_state(8), sysdev,
        batch, with_occupy=False, with_system=False, with_degrade=False, with_exits=with_exits,
        blk_topk=topk,
    )
    return out[0], out[5]


@pytest.mark.parametrize("case", sorted(CASES))
def test_flush_step_parity(case):
    n, k, n_valid, m_valid, near_max, (lo, hi) = CASES[case]
    rng = np.random.default_rng(100 + len(case))
    n_rows, nr = 32, 16
    now = 2**31 - 1 - 700 if near_max else 1_234_567
    arrs = _random_stats(rng, n_rows, now)
    table, dyn = random_flow_table(rng, nr, lo=lo, hi=hi)
    jstats = _jax_stats(arrs)
    tstats = tnodes.stats_from_numpy(arrs, CPU)
    tt, _ = flow_table_from_numpy(table, dyn, CPU)
    jt, jd = _jax_tables(table, dyn)
    # Two flushes in a row, the second one window later: state carries.
    for step in range(2):
        b = random_flush_batch(rng, n, k, n_rows, nr, now + 600 * step, n_valid, m_valid=m_valid, near_max=near_max)
        with_exits = m_valid > 0
        jstats, jres = _jax_flush_step(jstats, jt, jd, _jax_batch(b), with_exits, 8)
        tstats, tres = tflush.flush_step(tstats, tt, tflush.batch_from_numpy(b, CPU), with_exits=with_exits, blk_topk=8)
        for name in ("admitted", "reason", "slot_ok", "wait_ms", "blk_rows", "blk_weight"):
            assert_same(getattr(jres, name), getattr(tres, name), f"step {step} {name}")
        assert_same(jax.device_get(jstats), tnodes.stats_to_numpy(tstats), f"step {step} stats")
        if case == "few_blocked":
            assert int((np.asarray(jres.blk_weight) > 0).sum()) < 8


def test_topk_ties_order_lowest_row_first():
    """Equal blocked weights rank by row ascending, as lax.top_k does."""
    n_rows = 16
    arrs = _random_stats(np.random.default_rng(0), n_rows, 5_000)
    n = 16
    rows = np.array([3, 9, 5, 9, 3, 5, 12, 1] * 2, np.int32)
    b = list(random_flush_batch(np.random.default_rng(1), n, 1, n_rows, 8, 5_000, n))
    b[4] = np.stack([rows, rows, np.full(n, -1), np.full(n, -1)], axis=1).astype(np.int32)
    b[3] = np.ones(n, np.int32)
    b[5] = np.zeros((n, 1), np.int32)
    b[6] = rows[:, None]
    b[8] = np.ones(n, bool)
    b[9] = np.ones(n, bool)
    table, dyn = random_flow_table(np.random.default_rng(2), 8, thread_frac=0.0, lo=0, hi=1)  # count 0: all block
    tt, _ = flow_table_from_numpy(table, dyn, CPU)
    _, res = tflush.flush_step(tnodes.stats_from_numpy(arrs, CPU), tt, tflush.batch_from_numpy(b, CPU), with_exits=False, blk_topk=8)
    jt, jd = _jax_tables(table, dyn)
    _, jres = _jax_flush_step(_jax_stats(arrs), jt, jd, _jax_batch(b), False, 8)
    assert_same(jres.blk_rows, res.blk_rows)
    assert_same(jres.blk_weight, res.blk_weight)
    assert res.blk_rows.tolist()[:5] == [3, 5, 9, 1, 12]


def test_flow_index_matches_jax():
    """The compiled rule table and the per-entry slot resolution equal the
    JAX package's, for every grade, strategy, limit app and behavior."""
    from sentinel_tpu.metrics.nodes import NodeRegistry as JReg
    from sentinel_tpu.models.rules import FlowRule as JRule
    from sentinel_tpu.rules.flow_table import FlowIndex as JIndex
    from sentinel_tpu_torch.metrics.nodes import NodeRegistry
    from sentinel_tpu_torch.models import constants as C
    from sentinel_tpu_torch.models.rules import FlowRule
    from sentinel_tpu_torch.rules.flow_table import FlowIndex

    specs = [
        dict(resource="a", count=5), dict(resource="a", grade=C.FLOW_GRADE_THREAD, count=2),
        dict(resource="a", count=3, limit_app="app1"), dict(resource="a", count=4, limit_app="other"),
        dict(resource="b", count=7, strategy=C.STRATEGY_RELATE, ref_resource="a"),
        dict(resource="c", count=9, strategy=C.STRATEGY_CHAIN, ref_resource="ctx"),
        dict(resource="d", count=33, control_behavior=C.CONTROL_BEHAVIOR_WARM_UP, warm_up_period_sec=7),
        dict(resource="d", count=6, control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER),
        dict(resource="", count=1),  # invalid: ignored by both
    ]
    j, t = JIndex([JRule(**s) for s in specs]), FlowIndex([FlowRule(**s) for s in specs], device=CPU)
    assert_same(jax.device_get(j.device), t.device)
    assert_same(jax.device_get(j.make_dyn_state()), t.make_dyn_state())
    jreg, treg = JReg(), NodeRegistry()
    for res in ("a", "b", "c", "d", "e"):
        for ctx in ("sentinel_default_context", "ctx"):
            for origin in ("", "app1", "app2"):
                assert j.resolve_slots(res, ctx, origin, jreg) == t.resolve_slots(res, ctx, origin, treg)
