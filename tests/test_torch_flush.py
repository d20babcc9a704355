"""Parity of the port's flush (sentinel_tpu_torch/runtime/flush.py, plain
PyTorch versions on the CPU) with the JAX package's flush, bit for bit:
``flow_admission`` and ``flush_step`` with and without exits, QPS and
THREAD grades, two rule slots per entry whose check rows differ from the
accounting rows (RELATE/CHAIN), timestamps near 2**31 - 1, equal
timestamps on one row, ties in the blocked top-K and fewer than 8
blocked rows; and ``flush_step`` over the whole slot chain (occupy,
system, breakers) with every stage on and with each one off. Every
FlushResult output and every state tensor is compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.rules import degrade_table as jdt
from sentinel_tpu.rules.degrade_table import DegradeIndex
from sentinel_tpu.rules.flow_table import FlowRuleDynState as JDyn
from sentinel_tpu.rules.flow_table import FlowTableDevice as JTable
from sentinel_tpu.rules.param_table import make_param_state
from sentinel_tpu.runtime import flush as jflush
from sentinel_tpu_torch.metrics import nodes as tnodes
from sentinel_tpu_torch.rules import degrade_table as tdt
from sentinel_tpu_torch.rules.flow_table import flow_table_from_numpy
from sentinel_tpu_torch.runtime import flush as tflush

from test_torch_nodes import _jax_stats, _random_stats
from torch_parity import (
    INF,
    assert_same,
    borrowable_stats,
    random_chain_batch,
    random_degrade,
    random_flow_table,
    random_flush_batch,
    system_thresholds,
)

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
    # The kernel's routes and keys: every slot on one row (ts out of entry
    # order), ts on both sides of 0 (the packed key's sign flip), n*k on
    # either side of the one-block route's 2,048, top-8 with fewer than 8
    # blocked rows over many blocks.
    "one_row": (48, 1, 44, 4, False, (10, 30)),
    "negative_ts": (64, 2, 60, 8, False, (0, 8)),
    "nk_2048": (1024, 2, 1000, 8, False, (0, 40)),
    "nk_2049": (2049, 1, 2000, 8, False, (0, 40)),
    "few_blocked_2049": (2049, 1, 2049, 8, False, (190, 260)),
}
# The window update takes ts >= 0 only (ms relative to the epoch), so the
# step runs every case but the negative timestamps.
STEP_CASES = sorted(c for c in CASES if c != "negative_ts")
# Inputs beyond the tuple: random_flush_batch keyword arguments, and
# "now" (the flush time of the first step).
CASE_EXTRA = {
    "one_row": dict(one_row=True),
    "negative_ts": dict(now=300),
    "few_blocked_2049": dict(one_row=True),
}


def _case_batch(rng, case, n_rows, nr, now, m_valid=0):
    n, k, n_valid, _, near_max, _ = CASES[case]
    kw = {key: v for key, v in CASE_EXTRA.get(case, {}).items() if key != "now"}
    return random_flush_batch(rng, n, k, n_rows, nr, now, n_valid, m_valid=m_valid, near_max=near_max, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flow_admission_parity(case):
    n, k, n_valid, _, near_max, (lo, hi) = CASES[case]
    rng = np.random.default_rng(len(case))
    n_rows, nr = 32, 16
    now = CASE_EXTRA.get(case, {}).get("now", 2**31 - 1 - 7 if near_max else 654_321)
    arrs = _random_stats(rng, n_rows, now)
    table, dyn = random_flow_table(rng, nr, lo=lo, hi=hi)
    b = _case_batch(rng, case, n_rows, nr, now)
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


@pytest.mark.parametrize("case", STEP_CASES)
def test_flush_step_parity(case):
    n, k, n_valid, m_valid, near_max, (lo, hi) = CASES[case]
    rng = np.random.default_rng(100 + len(case))
    n_rows, nr = 32, 16
    now = CASE_EXTRA.get(case, {}).get("now", 2**31 - 1 - 700 if near_max else 1_234_567)
    arrs = _random_stats(rng, n_rows, now)
    table, dyn = random_flow_table(rng, nr, lo=lo, hi=hi)
    jstats = _jax_stats(arrs)
    tstats = tnodes.stats_from_numpy(arrs, CPU)
    tt, _ = flow_table_from_numpy(table, dyn, CPU)
    jt, jd = _jax_tables(table, dyn)
    # Two flushes in a row, the second one window later: state carries.
    for step in range(2):
        b = _case_batch(rng, case, n_rows, nr, now + 600 * step, m_valid=m_valid)
        with_exits = m_valid > 0
        jstats, jres = _jax_flush_step(jstats, jt, jd, _jax_batch(b), with_exits, 8)
        tstats, tres = tflush.flush_step(tstats, tt, tflush.batch_from_numpy(b, CPU), with_exits=with_exits, blk_topk=8)
        for name in ("admitted", "reason", "slot_ok", "wait_ms", "blk_rows", "blk_weight"):
            assert_same(getattr(jres, name), getattr(tres, name), f"step {step} {name}")
        assert_same(jax.device_get(jstats), tnodes.stats_to_numpy(tstats), f"step {step} stats")
        if case.startswith("few_blocked"):
            assert 0 < int((np.asarray(jres.blk_weight) > 0).sum()) < 8


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


# --- the whole slot chain: occupy, system and breakers --------------------

CHAIN_FLAGS = {
    # name: (with_occupy, with_system, with_degrade)
    "all_on": (True, True, True),
    "occupy_off": (False, True, True),
    "system_off": (True, False, True),
    "degrade_off": (True, True, False),
}
RESULT_FIELDS = ("admitted", "reason", "slot_ok", "wait_ms", "sys_type", "dslot_ok", "flow_live", "occupied",
                 "occ_slot", "blk_rows", "blk_weight")


@pytest.mark.parametrize("flags", sorted(CHAIN_FLAGS))
def test_flush_step_chain_parity(flags):
    with_occupy, with_system, with_degrade = CHAIN_FLAGS[flags]
    rng = np.random.default_rng(sorted(CHAIN_FLAGS).index(flags))
    n_rows, nr, nd, n, k, kd, m = 32, 16, 16, 64, 2, 2, 32
    now = 3_456_000 + int(rng.integers(0, 500))
    arrs = borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    table, dyn = random_flow_table(rng, nr, thread_frac=0.2, lo=2, hi=10)
    dtable, ddyn = random_degrade(rng, nd, now)
    sys_vals = system_thresholds("all")
    jstats, jt, jd = _jax_stats(arrs), *_jax_tables(table, dyn)
    jddev = jdt.DegradeTableDevice(*map(jnp.asarray, dtable))
    jddyn = jdt.DegradeDynState(*map(jnp.asarray, ddyn))
    jsys = jflush.SystemDevice(*(jnp.float32(v) for v in sys_vals))
    tstats = tnodes.stats_from_numpy(arrs, CPU)
    tt, _ = flow_table_from_numpy(table, dyn, CPU)
    tddev, tddyn = tdt.degrade_table_from_numpy(dtable, CPU), tdt.degrade_state_from_numpy(ddyn, CPU)
    tsys = tflush.SystemDevice(*sys_vals)
    for step in range(3):
        b = random_chain_batch(rng, n, k, kd, n_rows, nr, nd, now + 300 * step, m)
        out = jflush.flush_step_jit(
            jstats, jt, jd, jddev, jddyn, make_param_state(8), jsys, _jax_batch(b), occupy_timeout_ms=1000,
            with_occupy=with_occupy, with_system=with_system, with_degrade=with_degrade, with_exits=True,
            blk_topk=8,
        )
        jstats, jddyn, jres = out[0], out[2], out[5]
        tstats, tres = tflush.flush_step(
            tstats, tt, tflush.batch_from_numpy(b, CPU), with_exits=True, blk_topk=8, ddev=tddev, ddyn=tddyn,
            sysdev=tsys, occupy_timeout_ms=1000, with_occupy=with_occupy, with_system=with_system,
            with_degrade=with_degrade,
        )
        for name in RESULT_FIELDS:
            assert_same(getattr(jres, name), getattr(tres, name), f"step {step} {name}")
        assert_same(jax.device_get(jstats), tnodes.stats_to_numpy(tstats), f"step {step} stats")
        assert_same(jax.device_get(jddyn), tdt.degrade_state_to_numpy(tddyn), f"step {step} breakers")
    reasons = set(np.asarray(jres.reason).tolist())
    assert len(reasons) >= 3, f"the batch exercises several stages: {reasons}"


# --- the sharded step's hooks of flush_entries --------------------------------------

_jax_flush_entries = jax.jit(
    jflush.flush_entries,
    static_argnames=("commit", "occupy_timeout_ms", "with_occupy", "with_system", "with_degrade", "shaping_rounds",
                     "param_rounds", "blk_topk"),
)
HOOK_CASES = ["demand_pass", "probe_allowed", "precomputed_verdicts", "every_stage_route"]


@pytest.mark.parametrize("case", HOOK_CASES)
def test_flush_entries_hooks_parity(case):
    """flush_entries with the sharded step's hooks against the JAX one:
    ``commit=False`` with a shaping and a param batch (the verdicts equal,
    and stats, breakers, pacer and param state are left exactly as they
    were), ``probe_allowed``, ``param_pre``/``shaping_pre`` verdicts, and
    the every-stage route on a DEFAULT-only batch (equal to the JAX
    default flags and to the port's own DEFAULT specialisation)."""
    from sentinel_tpu.rules import param_table as jpt
    from sentinel_tpu.rules import shaping as jsh
    from sentinel_tpu_torch.rules import param_table as tpt
    from sentinel_tpu_torch.rules import shaping as tsh
    from torch_parity import random_param_batch_for, random_param_state, random_shaped_flow_table, shaping_batch_for

    rng = np.random.default_rng(HOOK_CASES.index(case) + 60)
    n_rows, nr, nd, n, k, kd, m, pr = 32, 16, 16, 64, 2, 2, 32, 32
    now = 3_456_000 + int(rng.integers(0, 500))
    arrs = borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    table, dyn = random_shaped_flow_table(rng, nr)
    if case == "every_stage_route":
        table = (table[0], table[1], np.zeros(nr, np.int32)) + table[3:]
    dtable, ddyn = random_degrade(rng, nd, now)
    pdyn = random_param_state(rng, pr, now)
    sys_vals = system_thresholds("all" if case != "every_stage_route" else "off")
    b = random_chain_batch(rng, n, k, kd, n_rows, nr, nd, now, m)
    if case == "every_stage_route":
        b[7] = np.zeros(n, bool)
        b[10] = np.full((n, kd), -1, np.int32)
    sb = shaping_batch_for(b, table) if case == "demand_pass" else None
    pb = random_param_batch_for(rng, b, pr) if case == "demand_pass" else None
    kw_j, kw_t = {}, {}
    if case == "probe_allowed":
        allowed = rng.random(nd) < 0.5
        kw_j["probe_allowed"], kw_t["probe_allowed"] = jnp.asarray(allowed), torch.from_numpy(allowed)
    if case == "precomputed_verdicts":
        p_ok, p_wait = rng.random(n) < 0.8, rng.integers(0, 300, n).astype(np.int32)
        s = 24
        sp = (rng.random(s) < 0.8, rng.integers(0, n * k, s).astype(np.int32), rng.integers(0, n, s).astype(np.int32),
              rng.random(s) < 0.6, rng.integers(0, 500, s).astype(np.int32))
        kw_j["param_pre"], kw_t["param_pre"] = (jnp.asarray(p_ok), jnp.asarray(p_wait)), (
            torch.from_numpy(p_ok), torch.from_numpy(p_wait))
        kw_j["shaping_pre"] = tuple(jnp.asarray(a) for a in sp)
        kw_t["shaping_pre"] = tuple(torch.from_numpy(a) for a in sp)
    commit = case != "demand_pass"
    jt, jd = _jax_tables(table, dyn)
    jout = _jax_flush_entries(
        _jax_stats(arrs), jt, jd, jdt.DegradeTableDevice(*map(jnp.asarray, dtable)),
        jdt.DegradeDynState(*map(jnp.asarray, ddyn)), jpt.ParamDynState(*map(jnp.asarray, pdyn)),
        jflush.SystemDevice(*(jnp.float32(v) for v in sys_vals)), _jax_batch(b),
        None if sb is None else jsh.ShapingBatch(*map(jnp.asarray, sb)),
        None if pb is None else jpt.ParamBatch(*map(jnp.asarray, pb)), commit=commit, occupy_timeout_ms=1000, **kw_j,
    )
    tstats = tnodes.stats_from_numpy(arrs, CPU)
    tt, td = flow_table_from_numpy(table, dyn, CPU)
    tddyn, tpd = tdt.degrade_state_from_numpy(ddyn, CPU), tpt.param_state_from_numpy(pdyn, CPU)
    tb = tflush.batch_from_numpy(b, CPU)

    def port(with_stages=True, stats=None, ddyn_t=None):
        return tflush.flush_entries(
            stats if stats is not None else tstats, tt, tb, 0, tdt.degrade_table_from_numpy(dtable, CPU),
            ddyn_t if ddyn_t is not None else tddyn, tflush.SystemDevice(*sys_vals), 1000, with_stages, with_stages,
            with_stages, td, tpd, None if sb is None else tsh.shaping_batch_from_numpy(sb, CPU),
            None if pb is None else tpt.param_batch_from_numpy(pb, CPU), commit=commit, **kw_t,
        )[1]

    tres = port()
    for name in RESULT_FIELDS[:-2]:
        assert_same(getattr(jout[4], name), getattr(tres, name), f"{case} {name}")
    assert_same(jax.device_get(jout[0]), tnodes.stats_to_numpy(tstats), f"{case} stats")
    assert_same(jax.device_get(jout[2]), tdt.degrade_state_to_numpy(tddyn), f"{case} breakers")
    if commit:
        assert_same(tuple(jax.device_get(jout[1])), tuple(t.numpy() for t in td), f"{case} pacers")
        assert_same(tuple(jax.device_get(jout[3])), tuple(t.numpy() for t in tpd), f"{case} param state")
    else:  # the demand pass writes nothing
        assert_same(arrs, tnodes.stats_to_numpy(tstats), "stats untouched")
        assert_same(ddyn, tdt.degrade_state_to_numpy(tddyn), "breakers untouched")
        assert_same(dyn, tuple(t.numpy() for t in td), "pacers untouched")
        assert_same(pdyn, tuple(t.numpy() for t in tpd), "param state untouched")
        reasons = set(np.asarray(jout[4].reason).tolist())
        assert {1, 2, 5} <= reasons, reasons
    if case == "every_stage_route":  # the DEFAULT specialisation decides the same
        fresh = tnodes.stats_from_numpy(arrs, CPU)
        spec = port(False, fresh, tdt.degrade_state_from_numpy(ddyn, CPU))
        for name in ("admitted", "reason", "slot_ok", "wait_ms"):
            assert_same(getattr(tres, name), getattr(spec, name), f"specialised {name}")
        assert_same(tnodes.stats_to_numpy(tstats), tnodes.stats_to_numpy(fresh), "specialised stats")
