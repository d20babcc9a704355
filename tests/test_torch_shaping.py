"""Parity of the port's traffic shaping (sentinel_tpu_torch/rules/shaping.py
and rules/recurrence.py, plain PyTorch versions on the CPU) with the JAX
package, bit for bit: ``run_shaping`` in every mode the JAX code has
(the closed form -1, the scan 0, unrolled rounds 1-4 and the fori_loop
rounds 16 and 32) on mixed behaviors over several seconds, a hot rule and
the one-timestamp rate-limiter shape; the warm-up line at its last bit
(the JAX CPU result is the fused multiply-add); a saturating pacer cost;
the flush's shaping inputs and ``flush_step`` with shaping (and hot
parameters) on; the host mirrors; and the engine cases of
tests/test_shaping.py, test_shaping_closed_form.py and test_scan_rounds.py
run on both packages. Tolerance is zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.rules import degrade_table as jdt
from sentinel_tpu.rules import param_table as jpt
from sentinel_tpu.rules import shaping as jsh
from sentinel_tpu.rules.flow_table import FlowRuleDynState as JDyn
from sentinel_tpu.rules.flow_table import FlowTableDevice as JTable
from sentinel_tpu.runtime import flush as jflush
from sentinel_tpu.testing.oracle import OracleNode, OracleRateLimiter, OracleWarmUp
from sentinel_tpu_torch.metrics import nodes as tnodes
from sentinel_tpu_torch.rules import degrade_table as tdt
from sentinel_tpu_torch.rules import param_table as tpt
from sentinel_tpu_torch.rules import shaping as tsh
from sentinel_tpu_torch.rules.flow_table import flow_table_from_numpy
from sentinel_tpu_torch.runtime import flush as tflush

from test_torch_nodes import _jax_stats
from torch_parity import (
    assert_same,
    borrowable_stats,
    fma_warning_case,
    out_of_range_rule_ids,
    random_chain_batch,
    random_degrade,
    random_param_batch_for,
    random_param_state,
    random_shaped_flow_table,
    random_shaping_case,
    run_on_both,
    shaping_batch_for,
    system_thresholds,
)

CPU = torch.device("cpu")

_jax_run_shaping = jax.jit(jsh.run_shaping, static_argnames=("interval_sec", "rounds"))


def _both(case, rounds):
    """run_shaping on both packages; returns (JAX, port) outputs."""
    table, dyn, sb, ppc, prev = case
    want = _jax_run_shaping(
        JTable(*map(jnp.asarray, table)), JDyn(*map(jnp.asarray, dyn)), jsh.ShapingBatch(*map(jnp.asarray, sb)),
        jnp.asarray(ppc), jnp.asarray(prev), interval_sec=1.0, rounds=rounds,
    )
    tt, td = flow_table_from_numpy(table, dyn, CPU)
    got = tsh.run_shaping(tt, td, tsh.shaping_batch_from_numpy(sb, CPU), torch.tensor(ppc), torch.tensor(prev),
                          1.0, rounds)
    return want, got


def _assert_shaping(want, got, what):
    assert_same(want[1], got[1], f"{what} ok")
    assert_same(want[2], got[2], f"{what} wait")
    assert_same(tuple(jax.device_get(want[0])), tuple(t.numpy() for t in got[0]), f"{what} dyn")


SHAPING_CASES = {
    "mixed": dict(s=256, nr=16),
    "hot_rule": dict(s=256, nr=8, n_hot=96),
    "one_ts_rate_limiter": dict(s=256, nr=8, behaviors=(2,), one_ts=True, acquire=1),
}


@pytest.mark.parametrize("rounds", [-1, 0, 1, 2, 4, 16, 32])
@pytest.mark.parametrize("case", sorted(SHAPING_CASES))
def test_run_shaping_parity(case, rounds):
    rng = np.random.default_rng(sorted(SHAPING_CASES).index(case) * 10 + rounds + 1)
    want, got = _both(random_shaping_case(rng, **SHAPING_CASES[case]), rounds)
    _assert_shaping(want, got, f"{case} rounds={rounds}")
    if rounds in (0, 32) and case != "one_ts_rate_limiter":
        ok, wait = np.asarray(want[1]), np.asarray(want[2])
        assert ok.any() and not ok.all() and (wait > 0).any(), "the case admits, blocks and queues"


@pytest.mark.parametrize("rounds", [0, 4])
def test_warning_line_is_the_fused_multiply_add(rounds):
    """WARM_UP items whose verdict turns on the last bit of the warning line:
    JAX on the CPU fuses ``above * slope + 1 / count``, and the port does."""
    want, got = _both(fma_warning_case(), rounds)
    _assert_shaping(want, got, "fma")
    ok = np.asarray(want[1])
    assert ok.any() and not ok.all()


def test_saturating_pacer_cost_pinned():
    """A cold WARM_UP_RATE_LIMITER at a count near 0 with acquire 2: the cost
    acquire / warningQps * 1000 is far outside int32. XLA saturates the
    conversion to 2**31 - 1: from an idle pacer (latest -1e9 or 0) the
    expected time lies ~2**31 ms out and the item blocks; from latest 5000
    or 2**30 the int32 sum wraps negative and the item passes at once
    (latest = ts). The port gives the same."""
    nr = s = 4
    one = np.ones(nr, np.int32)
    table = (one, np.full(nr, 1e-7, np.float32), np.full(nr, 3, np.int32), np.full(nr, 500, np.int32),
             np.full(nr, 2**31 - 1, np.int32), np.full(nr, 10, np.int32), np.full(nr, 100, np.int32),
             np.full(nr, 1e-3, np.float32), np.zeros(nr, np.int32))
    dyn = (np.array([-(10**9), 0, 5000, 2**30], np.int32), np.full(nr, 50, np.float32), np.full(nr, 5000, np.int32))
    idx = np.arange(s, dtype=np.int32)
    sb = (np.ones(s, bool), idx, idx, idx, idx, np.full(s, 5100, np.int32), np.full(s, 2, np.int32))
    case = (table, dyn, sb, np.zeros(s, np.int32), np.zeros(s, np.int32))
    for rounds in (0, 1):
        want, got = _both(case, rounds)
        _assert_shaping(want, got, f"rounds={rounds}")
    assert np.asarray(want[1]).tolist() == [False, False, True, True]
    assert np.asarray(want[0].latest_passed_time).tolist() == [-(10**9), 0, 5100, 5100]


def test_prev_second_pass_and_inputs():
    rng = np.random.default_rng(3)
    now, n_rows, s, n, k = 700_123, 32, 64, 32, 2
    arrs = borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    rows = rng.integers(-2, n_rows + 2, s).astype(np.int32)
    ts = (now - rng.integers(0, 3000, s)).astype(np.int32)
    want = jflush._prev_second_pass(_jax_stats(arrs), jnp.asarray(rows), jnp.asarray(ts))
    stats = tnodes.stats_from_numpy(arrs, CPU)
    got = tsh.prev_second_pass(stats.minute, torch.tensor(rows), torch.tensor(ts))
    assert_same(want, got, "prev pass")
    assert (np.asarray(want) > 0).any()
    sb = (rng.random(s) < 0.8, rng.integers(0, 8, s).astype(np.int32), rows, rng.integers(-1, n + 1, s).astype(np.int32),
          rng.integers(-1, n * k + 1, s).astype(np.int32), ts, np.ones(s, np.int32))
    live = rng.random(n) < 0.7
    ppc = rng.integers(0, 50, n * k).astype(np.int32)
    valid, ppc_s, prev_s = tsh.shaping_inputs(tsh.shaping_batch_from_numpy(sb, CPU), torch.tensor(live),
                                              torch.tensor(ppc), stats.minute)
    assert_same(sb[0] & live[np.clip(sb[3], 0, n - 1)], valid, "valid")
    assert_same(ppc[np.clip(sb[4], 0, n * k - 1)], ppc_s, "ppc")
    assert_same(want, prev_s, "prev")


# --- K9's edges: one item, the one-block threshold, one rule, no valid item --

EDGE_CASES = {
    # name: (random_shaping_case arguments, rounds)
    "one_item": (dict(s=1, nr=4), (0, -1)),
    "one_block_threshold": (dict(s=tsh.SHAPING_SMALL_MAX, nr=64), (0, 4)),
    "one_rule_holds_every_item": (dict(s=512, nr=4, n_hot=512), (0,)),
    "all_invalid": (dict(s=64, nr=8), (0, -1)),
    "rounds_1_long_segments": (dict(s=256, nr=4, n_hot=128), (1,)),
    "rounds_3_long_segments": (dict(s=256, nr=4, n_hot=128), (3,)),
}

_jax_prev_pass = jax.jit(jflush._prev_second_pass)


def _edge_case(name):
    kwargs, _ = EDGE_CASES[name]
    rng = np.random.default_rng(sorted(EDGE_CASES).index(name) + 50)
    if name == "one_item":
        kwargs = dict(kwargs, behaviors=(2,), one_ts=True, acquire=1)
    table, dyn, sb, ppc, prev = random_shaping_case(rng, **kwargs)
    if name == "all_invalid":
        sb = (np.zeros_like(sb[0]),) + sb[1:]
    return rng, (table, dyn, sb, ppc, prev)


def _stage_both(rng, case, rounds):
    """The flush's shaping stage on both packages: the inputs gathered
    (entry liveness, the slot's pass-plus-charge, the minute window's
    previous second) and K9 on them. JAX's stage is flush_entries' own
    lines (:759-764) around run_shaping; the port's is shaping_stage."""
    table, dyn, sb, ppc, _ = case
    s = sb[0].shape[0]
    now = int(sb[5].max()) + 300
    arrs = borrowable_stats(rng, int(table[0].shape[0]), now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    live = rng.random(s) < 0.8
    jstats = _jax_stats(arrs)
    j_valid = jnp.asarray(sb[0] & live[np.clip(sb[3], 0, s - 1)])
    j_prev = _jax_prev_pass(jstats, jnp.asarray(sb[2]), jnp.asarray(sb[5]))
    j_sb = jsh.ShapingBatch(*map(jnp.asarray, sb))._replace(valid=j_valid)
    want = _jax_run_shaping(JTable(*map(jnp.asarray, table)), JDyn(*map(jnp.asarray, dyn)), j_sb,
                            jnp.asarray(ppc)[jnp.clip(j_sb.flat_pos, 0, s - 1)], j_prev, interval_sec=1.0,
                            rounds=rounds)
    tt, td = flow_table_from_numpy(table, dyn, CPU)
    valid, ok, wait = tsh.shaping_stage(tt, td, tsh.shaping_batch_from_numpy(sb, CPU), torch.tensor(live),
                                        torch.tensor(ppc), tnodes.stats_from_numpy(arrs, CPU).minute, 1.0, rounds)
    assert_same(j_valid, valid, "valid")
    return want, (td, ok, wait)


@pytest.mark.parametrize("form", ["run_shaping", "shaping_stage"])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_shaping_edges_match_jax(case, form):
    """run_shaping and the flush's shaping stage at K9's edges: one item;
    S at the one-block threshold of the card's route; one rule holding
    every item (one long segment); no valid item; rounds 1 and 3 with
    segments longer than that (their tails stay unresolved)."""
    for rounds in EDGE_CASES[case][1]:
        rng, inputs = _edge_case(case)
        if form == "run_shaping":
            want, got = _both(inputs, rounds)
        else:
            want, got = _stage_both(rng, inputs, rounds)
        _assert_shaping(want, got, f"{case} {form} rounds={rounds}")
        ok = np.asarray(want[1])
        if case == "all_invalid":
            assert ok.all() and not np.asarray(want[2]).any()
        elif case.startswith("rounds_"):
            assert not ok.all(), "the walked items block some"


@pytest.mark.parametrize("rounds", [0, 2, -1])
def test_out_of_range_rule_ids_count_as_invalid(rounds):
    """run_shaping takes a valid item whose rule id lies outside [0, nr)
    (two different negative ids, nr, past nr, the int32 extremes) as
    invalid: the same verdicts and state as with those items marked
    invalid, which JAX matches."""
    rng = np.random.default_rng(62)
    kw = dict(behaviors=(2,), one_ts=True, acquire=1) if rounds == -1 else {}
    table, dyn, sb, ppc, prev = random_shaping_case(rng, s=256, nr=8, **kw)
    bad, invalid = out_of_range_rule_ids(rng, sb, 8)
    want, _ = _both((table, dyn, invalid, ppc, prev), rounds)
    tt, td = flow_table_from_numpy(table, dyn, CPU)
    got = tsh.run_shaping(tt, td, tsh.shaping_batch_from_numpy(bad, CPU), torch.tensor(ppc), torch.tensor(prev),
                          1.0, rounds)
    _assert_shaping(want, got, f"rounds={rounds}")
    assert not np.asarray(want[1]).all(), "the walked items block some"


# --- flush_step with shaping and hot parameters on ---------------------------

RESULT_FIELDS = ("admitted", "reason", "slot_ok", "wait_ms", "sys_type", "dslot_ok", "flow_live", "occupied",
                 "occ_slot", "blk_rows", "blk_weight")

FLUSH_VARIANTS = {
    # name: (shaping, param, occupy/system/degrade)
    "shaping": (True, False, False),
    "shaping_chain": (True, False, True),
    "param": (False, True, False),
    "param_chain": (False, True, True),
    "both": (True, True, False),
    "both_chain": (True, True, True),
}


def run_flush_parity(variant, steps=3):
    """flush_step over ``steps`` flushes on both packages, every result
    field and every state tensor (stats, shaping state, param state,
    breakers) compared after each."""
    with_shaping, with_param, chain = FLUSH_VARIANTS[variant]
    rng = np.random.default_rng(sorted(FLUSH_VARIANTS).index(variant) + 40)
    n_rows, nr, nd, n, k, kd, m, pr = 32, 16, 16, 64, 2, 2, 32, 32
    now = 3_456_000 + int(rng.integers(0, 500))
    arrs = borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    table, dyn = random_shaped_flow_table(rng, nr)
    dtable, ddyn = random_degrade(rng, nd, now)
    pdyn = random_param_state(rng, pr, now)
    sys_vals = system_thresholds("all")
    jstats, jt, jd = _jax_stats(arrs), JTable(*map(jnp.asarray, table)), JDyn(*map(jnp.asarray, dyn))
    jddev, jddyn = jdt.DegradeTableDevice(*map(jnp.asarray, dtable)), jdt.DegradeDynState(*map(jnp.asarray, ddyn))
    jpd = jpt.ParamDynState(*map(jnp.asarray, pdyn))
    jsys = jflush.SystemDevice(*(jnp.float32(v) for v in sys_vals))
    tstats = tnodes.stats_from_numpy(arrs, CPU)
    tt, td = flow_table_from_numpy(table, dyn, CPU)
    tddev, tddyn = tdt.degrade_table_from_numpy(dtable, CPU), tdt.degrade_state_from_numpy(ddyn, CPU)
    tpd = tpt.param_state_from_numpy(pdyn, CPU)
    tsys = tflush.SystemDevice(*sys_vals)
    reasons, waits = set(), 0
    for step in range(steps):
        b = random_chain_batch(rng, n, k, kd, n_rows, nr, nd, now + 450 * step, m)
        if not chain:
            b[7] = np.zeros(n, bool)  # no prioritized entries
        sb = shaping_batch_for(b, table) if with_shaping else None
        pb = random_param_batch_for(rng, b, pr) if with_param else None
        rounds_sh = [0, 4, 16][step % 3]
        rounds_p = [4, 0, 16][step % 3]
        common = (jstats, jt, jd, jddev, jddyn, jpd, jsys, jflush.FlushBatch(*map(jnp.asarray, b)))
        kw = dict(occupy_timeout_ms=1000, with_occupy=chain, with_system=chain, with_degrade=chain,
                  with_exits=True, shaping_rounds=rounds_sh, param_rounds=rounds_p, blk_topk=8)
        jsb = None if sb is None else jsh.ShapingBatch(*map(jnp.asarray, sb))
        jpb = None if pb is None else jpt.ParamBatch(*map(jnp.asarray, pb))
        if jsb is not None and jpb is not None:
            out = jflush.flush_step_full_jit(*common, jsb, jpb, **kw)
        elif jsb is not None:
            out = jflush.flush_step_shaping_jit(*common, jsb, **kw)
        else:
            out = jflush.flush_step_param_jit(*common, jpb, **kw)
        jstats, jd, jddyn, jpd, jres = out[0], out[1], out[2], out[3], out[5]
        tstats, tres = tflush.flush_step(
            tstats, tt, tflush.batch_from_numpy(b, CPU), with_exits=True, blk_topk=8, ddev=tddev, ddyn=tddyn,
            sysdev=tsys, occupy_timeout_ms=1000, with_occupy=chain, with_system=chain, with_degrade=chain,
            flow_dyn=td, pdyn=tpd,
            shaping=None if sb is None else tsh.shaping_batch_from_numpy(sb, CPU),
            param=None if pb is None else tpt.param_batch_from_numpy(pb, CPU),
            shaping_rounds=rounds_sh, param_rounds=rounds_p,
        )
        for name in RESULT_FIELDS:
            assert_same(getattr(jres, name), getattr(tres, name), f"step {step} {name}")
        assert_same(jax.device_get(jstats), tnodes.stats_to_numpy(tstats), f"step {step} stats")
        assert_same(tuple(jax.device_get(jd)), tuple(t.numpy() for t in td), f"step {step} shaping state")
        assert_same(tuple(jax.device_get(jpd)), tuple(t.numpy() for t in tpd), f"step {step} param state")
        assert_same(jax.device_get(jddyn), tdt.degrade_state_to_numpy(tddyn), f"step {step} breakers")
        reasons |= set(np.asarray(jres.reason).tolist())
        waits += int((np.asarray(jres.wait_ms) > 0).sum())
    return reasons, waits


@pytest.mark.parametrize("variant", ["shaping", "shaping_chain", "both", "both_chain"])
def test_flush_step_with_shaping_parity(variant):
    reasons, waits = run_flush_parity(variant)
    assert 1 in reasons, "the shaping stage blocked entries"
    assert waits > 0, "some shaping slot queued"
    if variant.startswith("both"):
        assert 5 in reasons, "the param stage blocked entries"


# --- the host mirrors ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_host_mirrors_match_jax(seed):
    """mirror_pacer_cost, mirror_shaping_decide and mirror_pacer_bulk of both
    packages on the same random streams."""
    from sentinel_tpu.rules.flow_table import FlowIndex as JIndex
    from sentinel_tpu_torch.rules.flow_table import FlowIndex as TIndex
    import sentinel_tpu as jst
    import sentinel_tpu_torch as st

    rng = np.random.default_rng(seed)
    for _ in range(200):
        acq, cnt, c1 = int(rng.integers(0, 5)), float(rng.random() * 30 + 0.01), int(rng.integers(0, 400))
        assert jsh.mirror_pacer_cost(acq, cnt, c1) == tsh.mirror_pacer_cost(acq, cnt, c1)
    specs = [dict(resource=f"r{b}", count=float(rng.integers(1, 30)), control_behavior=b, warm_up_period_sec=3,
                  max_queueing_time_ms=int(rng.integers(0, 900))) for b in (1, 2, 3)]
    jinfo = [JIndex([jst.FlowRule(**sp)]).mirror_shaping_info(0) for sp in specs]
    tinfo = [TIndex([st.FlowRule(**sp)], device="cpu").mirror_shaping_info(0) for sp in specs]
    for ji, ti in zip(jinfo, tinfo):
        assert ji[1:] == ti[1:] and ji[0].to_dict() == ti[0].to_dict()

    class Rec:
        def __init__(self):
            self.latest, self.stored, self.lastfill, self.pass_prev = -(10**9), 0.0, -(10**9), 0
            self.window = []

        def passq(self, ts):
            return sum(1 for t in self.window if ts - t < 1000)

    for ji, ti in zip(jinfo, tinfo):
        a, b = Rec(), Rec()
        ts = 1000
        for _ in range(300):
            ts += int(rng.choice([0, 13, 90, 400]))
            acq = int(rng.integers(0, 3))
            wa, wb = jsh.mirror_shaping_decide(a, ji, ts, acq), tsh.mirror_shaping_decide(b, ti, ts, acq)
            assert wa == wb
            assert (a.latest, a.stored, a.lastfill) == (b.latest, b.stored, b.lastfill)
            if wa[0]:
                a.window.append(ts)
                b.window.append(ts)
            if ts % 1000 < 20:
                a.pass_prev = b.pass_prev = a.passq(ts)
    for _ in range(200):
        args = (int(rng.integers(-3000, 3000)), float(rng.integers(0, 30)), int(rng.integers(0, 900)),
                int(rng.integers(0, 300)), int(rng.integers(0, 3000)), np.arange(1, int(rng.integers(1, 40))))
        ja, ta = jsh.mirror_pacer_bulk(*args), tsh.mirror_pacer_bulk(*args)
        np.testing.assert_array_equal(ja[0], ta[0])
        np.testing.assert_array_equal(ja[1], ta[1])
        assert ja[2] == ta[2]


# --- the engine cases of test_shaping.py, test_shaping_closed_form.py and
# test_scan_rounds.py, on both packages ---------------------------------------


def _rate_rule(lib, resource, count, maxq):
    return lib.st.FlowRule(resource, count=count, control_behavior=lib.C.CONTROL_BEHAVIOR_RATE_LIMITER,
                           max_queueing_time_ms=maxq)


def _paces_requests(lib):
    lib.st.flow_rule_manager.load_rules([_rate_rule(lib, "paced", 10, 500)])
    oracle = OracleRateLimiter(10, 500)
    out = []
    for _ in range(10):
        t = lib.clock.now_ms()
        e = lib.st.try_entry("paced")
        want_ok, _ = oracle.can_pass(t)
        assert (e is not None) == want_ok
        out.append((e is not None, lib.clock.now_ms()))
        if e is not None:
            e.exit()
    return out


def _block_beyond_queue(lib):
    lib.st.flow_rule_manager.load_rules([_rate_rule(lib, "q", 10, 300)])
    ops = [lib.engine.submit_entry("q", ts=0) for _ in range(8)]
    lib.engine.flush()
    got = [(op.verdict.admitted, op.verdict.wait_ms) for op in ops]
    oracle = OracleRateLimiter(10, 300)
    assert got == [oracle.can_pass(0) for _ in range(8)]
    return got


def _spaced_stream(lib):
    lib.st.flow_rule_manager.load_rules([_rate_rule(lib, "s", 5, 1000)])
    oracle = OracleRateLimiter(5, 1000)
    rng = np.random.default_rng(1)
    t, out = 0, []
    for _ in range(60):
        t += int(rng.choice([10, 50, 150, 400]))
        lib.clock.set_ms(t)
        e = lib.st.try_entry("s")
        assert (e is not None) == oracle.can_pass(t)[0]
        out.append(e is not None)
        if e is not None:
            t = lib.clock.now_ms()
            e.exit()
    return out


def _count_zero_blocks(lib):
    lib.st.flow_rule_manager.load_rules([_rate_rule(lib, "z", 0, 500)])
    return [lib.st.try_entry("z") is None]


def _warm_up_rule(lib, resource, count=20, warmup=10, behavior=None, maxq=0):
    return lib.st.FlowRule(resource, count=count, warm_up_period_sec=warmup, max_queueing_time_ms=maxq,
                           control_behavior=lib.C.CONTROL_BEHAVIOR_WARM_UP if behavior is None else behavior)


def _cold_start(lib):
    lib.st.flow_rule_manager.load_rules([_warm_up_rule(lib, "wu")])
    lib.clock.set_ms(100)
    ops = [lib.engine.submit_entry("wu", ts=100) for _ in range(20)]
    lib.engine.flush()
    admitted = sum(op.verdict.admitted for op in ops)
    assert admitted == 6
    return [admitted]


def _warm_up_oracle(lib, count, warmup, steps, stride):
    lib.st.flow_rule_manager.load_rules([_warm_up_rule(lib, "wo", count=count, warmup=warmup)])
    oracle, onode = OracleWarmUp(count, warmup, 3), OracleNode()
    t, out = 0, []
    for _ in range(steps):
        t += stride
        lib.clock.set_ms(t)
        e = lib.st.try_entry("wo")
        want = oracle.can_pass(onode, t)
        if want:
            onode.add_pass(t, 1)
        else:
            onode.add_block(t, 1)
        assert (e is not None) == want, f"t={t}"
        out.append(want)
        if e is not None:
            e.exit()
            onode.add_rt_and_success(t, 0, 1)
    return out


def _cold_pacing(lib):
    lib.st.flow_rule_manager.load_rules([_warm_up_rule(
        lib, "wrl", behavior=lib.C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER, maxq=2000)])
    lib.clock.set_ms(50)
    ops = [lib.engine.submit_entry("wrl", ts=50) for _ in range(4)]
    lib.engine.flush()
    waits = [op.verdict.wait_ms for op in ops]
    assert all(op.verdict.admitted for op in ops) and waits == [0, 150, 300, 450]
    return waits


def _bulk_ladder(lib):
    """test_shaping_closed_form's engine bulk ladder: one ts, one acquire,
    the closed-form path, against separate flushes of singles."""
    lib.st.flow_rule_manager.load_rules([_rate_rule(lib, "lad", 20, 700)])
    out = []
    for t, n in ((1000, 40), (1030, 5), (1800, 64), (5000, 3)):
        lib.clock.set_ms(t)
        g = lib.engine.submit_bulk("lad", n, ts=t)
        lib.engine.flush()
        out.append((g.admitted.tolist(), g.wait_ms.tolist()))
    return out


def _mixed_behavior_bulk(lib):
    """Shaping slots of two behaviors in one flush: not closed-form eligible."""
    lib.st.flow_rule_manager.load_rules([_rate_rule(lib, "m1", 10, 500), _warm_up_rule(lib, "m2", count=10)])
    out = []
    for t in (100, 700, 2100):
        lib.clock.set_ms(t)
        g1 = lib.engine.submit_bulk("m1", 12, ts=t)
        g2 = lib.engine.submit_bulk("m2", 12, ts=t)
        lib.engine.flush()
        out.append((g1.admitted.tolist(), g1.wait_ms.tolist(), g2.admitted.tolist()))
    return out


def _scan_fallback_above_cap(lib):
    """test_scan_rounds: 40 items on one rule (above the 16 bucket cap, the
    scan) beside rules of a few items each (the rounds path)."""
    rules = [_rate_rule(lib, "hot", 50, 900)] + [_warm_up_rule(lib, f"c{i}", count=5 + i, warmup=2) for i in range(3)]
    lib.st.flow_rule_manager.load_rules(rules)
    out = []
    for t in (1000, 1600, 2500, 4200):
        lib.clock.set_ms(t)
        ops = [lib.engine.submit_entry("hot", ts=t - i % 7) for i in range(40)]
        ops += [lib.engine.submit_entry(f"c{i % 3}", ts=t - i) for i in range(9)]
        lib.engine.flush()
        out.append([(op.verdict.admitted, op.verdict.wait_ms) for op in ops])
    return out


ENGINE_CASES = {
    "paces_requests": _paces_requests,
    "block_beyond_queue": _block_beyond_queue,
    "spaced_stream": _spaced_stream,
    "count_zero_blocks": _count_zero_blocks,
    "cold_start": _cold_start,
    "warm_up_oracle": lambda lib: _warm_up_oracle(lib, 10, 4, 200, 37),
    "warm_state_full_count": lambda lib: _warm_up_oracle(lib, 10, 2, 96, 83),
    "cold_pacing": _cold_pacing,
    "bulk_ladder_closed_form": _bulk_ladder,
    "mixed_behavior_bulk": _mixed_behavior_bulk,
    "scan_fallback_above_cap": _scan_fallback_above_cap,
}


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_engine_shaping_lockstep(name):
    run_on_both(ENGINE_CASES[name])


def test_engine_picks_the_closed_form():
    """The host mode selection: -1 for one ts, one acquire, only plain
    rate limiters; the rounds bound otherwise (0 above 16 per rule)."""
    from sentinel_tpu_torch.rules.flow_table import FlowIndex
    from sentinel_tpu_torch.runtime.engine import Engine
    import sentinel_tpu_torch as st

    idx = FlowIndex([st.FlowRule("a", count=5, control_behavior=2), st.FlowRule("b", count=5, control_behavior=1)],
                    device="cpu")
    pick = Engine._shaping_rounds_for
    one = np.ones(20, np.int32)
    assert pick(0 * one, 7 * one, one, idx) == -1
    assert pick(np.r_[0 * one, one], 7 * np.r_[one, one], np.r_[one, one], idx) == 0  # b is WARM_UP, 20 each
    assert pick(0 * one[:3], np.array([1, 2, 3], np.int32), one[:3], idx) == 4
    assert pick(0 * one, 7 * one, 2 * one, idx) == -1
    assert pick(0 * one, 7 * one, 0 * one, idx) == 0
