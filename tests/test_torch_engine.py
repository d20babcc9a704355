"""The port's engine slice as a whole (sentinel_tpu_torch Engine on the
CPU, plain PyTorch versions) against the JAX package's Engine, bit for
bit: each runs under its own ManualClock from the same start, gets the
same flow rules and the same stream of submit_entry / submit_bulk /
submit_exit / submit_exit_bulk calls, and flushes that span several
second-window boundaries. After every flush the verdicts, reasons,
slot_ok attribution, the blocked top-K and every state tensor must be
identical. Also: the cases of tests/test_flow_default.py against the
port, the features of the slices accepted, and the features outside them
raising NotImplementedError."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sentinel_tpu as jst
import sentinel_tpu_torch as st
from sentinel_tpu.runtime.engine import Engine as JEngine
from sentinel_tpu.testing.oracle import OracleFlowEngine
from sentinel_tpu.utils.clock import ManualClock as JClock
from sentinel_tpu_torch.core import api
from sentinel_tpu_torch.metrics import nodes as tnodes
from sentinel_tpu_torch.metrics.nodes import stats_to_numpy
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.models.rules import FlowRule
from sentinel_tpu_torch.parallel import make_mesh
from sentinel_tpu_torch.rules.degrade_table import degrade_state_to_numpy
from sentinel_tpu_torch.runtime import flush as tflush
from sentinel_tpu_torch.runtime.engine import Engine
from sentinel_tpu_torch.utils import clock as tclock
from sentinel_tpu_torch.utils.config import config

from torch_parity import assert_same

RULES = [
    dict(resource="A", count=5),
    dict(resource="A", grade=C.FLOW_GRADE_THREAD, count=3),
    dict(resource="B", count=8, limit_app="appX"),
    dict(resource="B", count=12),
    dict(resource="B", count=2, limit_app="other"),
    dict(resource="C", count=4, strategy=C.STRATEGY_RELATE, ref_resource="A"),
    dict(resource="D", count=3, strategy=C.STRATEGY_CHAIN, ref_resource="ctx1"),
    dict(resource="E", grade=C.FLOW_GRADE_THREAD, count=2),
]
RESOURCES = ["A", "B", "C", "D", "E", "F"]
# The rest of the slot chain, for the chain stream: breakers of all three
# grades, a system config, authority rules on some origins.
DEGRADE_RULES = [
    dict(resource="A", grade=C.DEGRADE_GRADE_EXCEPTION_RATIO, count=0.3, time_window=1, min_request_amount=3),
    dict(resource="B", grade=C.DEGRADE_GRADE_RT, count=40, slow_ratio_threshold=0.5, time_window=1,
         min_request_amount=2, stat_interval_ms=500),
    dict(resource="E", grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, count=1, time_window=2, min_request_amount=1),
    dict(resource="F", grade=C.DEGRADE_GRADE_EXCEPTION_RATIO, count=0.5, time_window=1, min_request_amount=2),
]
SYSTEM_CONFIG = dict(qps=60, max_thread=12, highest_system_load=3.0)
AUTHORITY_RULES = [
    dict(resource="B", limit_app="appX", strategy=C.AUTHORITY_WHITE),
    dict(resource="F", limit_app="appY", strategy=C.AUTHORITY_BLACK),
]


def _rules(cls, specs=RULES):
    return [cls(**r) for r in specs]


PINNED_LOAD, PINNED_CPU = 4.0, 0.2  # what the chain streams' system samplers read


@pytest.fixture
def pinned_samplers():
    """Both packages' system samplers forced to (PINNED_LOAD, PINNED_CPU)
    for the test, then set back to what they read before and unforced, so
    that no later test depends on what this one left behind. Yields the
    two samplers (JAX, port)."""
    from sentinel_tpu.utils.system_status import sampler as jsampler
    from sentinel_tpu_torch.utils.system_status import sampler as tsampler

    saved = [(smp, smp.read()) for smp in (jsampler, tsampler)]
    for smp, _ in saved:
        smp.force(load=PINNED_LOAD, cpu=PINNED_CPU)
    try:
        yield jsampler, tsampler
    finally:
        for smp, (load, cpu) in saved:
            smp.force(load=load, cpu=cpu)
            smp.unforce()


def _assert_pinned(samplers):
    for smp in samplers:
        assert smp.read() == (PINNED_LOAD, PINNED_CPU), "a system sampler is not pinned"


class _Pair:
    """The two engines driven in lockstep. ``chain`` also loads degrade,
    system and authority rules on both; a test that drives it takes the
    ``pinned_samplers`` fixture, so that both system samplers read fixed
    values."""

    def __init__(self, start_ms, chain=False):
        self.jclock = JClock(start_ms)
        self.tclock = tclock.ManualClock(start_ms)
        self.j = JEngine(clock=self.jclock)
        self.t = Engine(clock=self.tclock, device="cpu")
        self.j_topk = []
        self.j._fold_blocked_sketch = lambda rows, w: self.j_topk.append((np.asarray(rows), np.asarray(w)))
        self.j.set_flow_rules(_rules(jst.FlowRule))
        self.t.set_flow_rules(_rules(FlowRule))
        self.chain = chain
        if chain:
            from sentinel_tpu.rules.system_manager import SystemConfig as JSystemConfig
            from sentinel_tpu_torch.rules.system_manager import SystemConfig

            self.j.set_degrade_rules(_rules(jst.DegradeRule, DEGRADE_RULES))
            self.t.set_degrade_rules(_rules(st.DegradeRule, DEGRADE_RULES))
            self.j.set_system_config(JSystemConfig(**SYSTEM_CONFIG))
            self.t.set_system_config(SystemConfig(**SYSTEM_CONFIG))
            self.j.set_authority_rules({r["resource"]: jst.AuthorityRule(**r) for r in AUTHORITY_RULES})
            self.t.set_authority_rules({r["resource"]: st.AuthorityRule(**r) for r in AUTHORITY_RULES})

    def set_ms(self, ms):
        self.jclock.set_ms(ms)
        self.tclock.set_ms(ms)

    def both(self, name, *args, **kw):
        return getattr(self.j, name)(*args, **kw), getattr(self.t, name)(*args, **kw)

    def flush_and_compare(self, singles, groups, step):
        self.j.flush()
        self.t.flush()
        for jo, to in singles:
            assert (jo is None) == (to is None)
            if jo is None:
                continue
            jv, tv = jo.verdict, to.verdict
            assert (jv.admitted, jv.reason, jv.wait_ms, jv.limit_type) == (
                tv.admitted, tv.reason, tv.wait_ms, tv.limit_type), step
            jr = None if jv.blocked_rule is None else jv.blocked_rule.to_dict()
            tr = None if tv.blocked_rule is None else tv.blocked_rule.to_dict()
            assert jr == tr, f"{step}: attribution"
        for jg, tg in groups:
            for name in ("admitted", "reason", "wait_ms"):
                assert_same(getattr(jg, name), getattr(tg, name), f"{step}: bulk {name}")
        assert_same(jax.device_get(self.j.stats), stats_to_numpy(self.t.stats), f"{step}: stats")
        if self.chain:
            assert_same(jax.device_get(self.j.degrade_dyn), degrade_state_to_numpy(self.t.degrade_dyn),
                        f"{step}: breakers")
        if self.j_topk:
            assert_same(self.j_topk[-1][0], self.t.last_blocked_topk[0], f"{step}: blk_rows")
            assert_same(self.j_topk[-1][1], self.t.last_blocked_topk[1], f"{step}: blk_weight")


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_stream_parity(seed):
    """Every flush carries 40 entries (singles plus one bulk group) and 20
    exits (singles plus one bulk group), so both engines see one padded
    shape per slot count and the JAX side compiles its step only once or
    twice."""
    rng = np.random.default_rng(seed)
    now = 10_000
    pair = _Pair(now)
    live = []  # admitted singles awaiting exit: (rows, ts)
    last_group = None
    for step in range(20):
        now += int(rng.choice([0, 40, 180, 420, 700]))
        pair.set_ms(now)
        singles, groups = [], []
        n_single = int(rng.integers(0, 12))
        for _ in range(n_single):
            res = str(rng.choice(RESOURCES))
            ctx = "ctx1" if rng.random() < 0.3 else C.CONTEXT_DEFAULT_NAME
            origin = str(rng.choice(["", "appX", "appY"]))
            et = C.EntryType.IN if rng.random() < 0.5 else C.EntryType.OUT
            ts = now - int(rng.integers(0, 60))
            singles.append(pair.both(
                "submit_entry", res, context_name=ctx, origin=origin,
                acquire=int(rng.integers(1, 3)), entry_type=et, ts=max(ts, 0),
            ))
        n = 40 - n_single
        ts = np.sort(now - rng.integers(0, 300, n)).astype(np.int32)
        acq = rng.integers(1, 3, n).astype(np.int32)
        groups.append(pair.both("submit_bulk", str(rng.choice(RESOURCES)), n, ts=ts, acquire=acq,
                                origin=str(rng.choice(["", "appX"]))))
        n_exit = 0
        for rows, t0 in list(live[: int(rng.integers(0, min(len(live), 10) + 1))]):
            if rng.random() < 0.15:
                pair.both("submit_trace", rows, count=1, ts=now)
                n_exit += 1
            pair.both("submit_exit", rows, rt=int(now - t0), count=1,
                      err=int(rng.random() < 0.2), ts=now)
            n_exit += 1
            live.remove((rows, t0))
        rows = last_group.rows if last_group is not None else (-1, -1, -1, -1)
        pair.both("submit_exit_bulk", rows, 20 - n_exit, rt=int(rng.integers(0, 90)), ts=now)
        pair.flush_and_compare(singles, groups, step)
        last_group = groups[0][1]
        for jo, to in singles:
            if to is not None and to.verdict.admitted:
                live.append((to.rows, to.ts))
    for res in RESOURCES:
        assert pair.j.cluster_node_stats(res) == pair.t.cluster_node_stats(res), res
    assert pair.j.entry_node_stats() == pair.t.entry_node_stats()
    assert any(w.max() > 0 for _, w in pair.j_topk), "the stream must have blocked something"
    # The ~22-day epoch rebase shifts every stored window start alike.
    pair.both("_apply_rebase", 60_000)
    assert_same(jax.device_get(pair.j.stats), stats_to_numpy(pair.t.stats), "rebased stats")


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_chain_stream_parity(seed, pinned_samplers):
    """The stream of test_engine_stream_parity with the whole slot chain
    loaded: breakers on four resources, a system config (QPS, threads
    and BBR load), authority rules on two, prioritized singles, and exits
    that complete the breakers. Verdicts, wait_ms, limit types,
    attribution, stats and breaker state must agree after every flush."""
    _assert_pinned(pinned_samplers)
    config.set(config.OCCUPY_TIMEOUT_MS, "1000")
    from sentinel_tpu.utils.config import config as jconfig

    jconfig.set(jconfig.OCCUPY_TIMEOUT_MS, "1000")
    try:
        rng = np.random.default_rng(100 + seed)
        now = 20_000
        pair = _Pair(now, chain=True)
        live = []  # admitted singles awaiting exit: (rows, ts, resource)
        last_group = None
        blocked = set()
        for step in range(24):
            now += int(rng.choice([0, 40, 180, 420, 700, 1300]))
            pair.set_ms(now)
            singles, groups = [], []
            for _ in range(int(rng.integers(2, 14))):
                res = str(rng.choice(RESOURCES))
                singles.append((res, pair.both(
                    "submit_entry", res, context_name="ctx1" if rng.random() < 0.3 else C.CONTEXT_DEFAULT_NAME,
                    origin=str(rng.choice(["", "appX", "appY"])), acquire=int(rng.integers(1, 3)),
                    entry_type=C.EntryType.IN if rng.random() < 0.6 else C.EntryType.OUT,
                    prio=bool(rng.random() < 0.3), ts=max(now - int(rng.integers(0, 60)), 0),
                )))
            n = 40 - len(singles)
            ts = np.sort(now - rng.integers(0, 300, n)).astype(np.int32)
            groups.append(pair.both("submit_bulk", str(rng.choice(RESOURCES)), n, ts=ts,
                                    acquire=rng.integers(1, 3, n).astype(np.int32),
                                    origin=str(rng.choice(["", "appX", "appY"])),
                                    entry_type=C.EntryType.IN))
            n_exit = 0
            for rows, t0, res in list(live[: int(rng.integers(0, min(len(live), 10) + 1))]):
                pair.both("submit_exit", rows, rt=int(rng.choice([5, 90])), count=1,
                          err=int(rng.random() < 0.35), ts=now, resource=res)
                n_exit += 1
                live.remove((rows, t0, res))
            rows = last_group.rows if last_group is not None else (-1, -1, -1, -1)
            pair.both("submit_exit_bulk", rows, 20 - n_exit, rt=int(rng.integers(0, 90)),
                      err=(rng.random(20 - n_exit) < 0.3).astype(np.int32), ts=now,
                      resource=last_group.resource if last_group is not None else None)
            pair.flush_and_compare([p for _, p in singles], groups, step)
            last_group = groups[0][1]
            for res, (jo, to) in singles:
                if to is not None:
                    if to.verdict.admitted:
                        live.append((to.rows, to.ts, res))
                    blocked.add(to.verdict.reason)
            blocked.update(groups[0][1].reason.tolist())
        assert {0, 1, 2, 3, 4} <= blocked, f"every stage blocked something: {blocked}"
        for res in RESOURCES:
            assert pair.j.cluster_node_stats(res) == pair.t.cluster_node_stats(res), res
        assert pair.j.entry_node_stats() == pair.t.entry_node_stats()
        # The ~22-day epoch rebase shifts breaker windows and deadlines too.
        pair.both("_apply_rebase", 60_000)
        assert_same(jax.device_get(pair.j.degrade_dyn), degrade_state_to_numpy(pair.t.degrade_dyn), "rebased")
    finally:
        config.reset()
        jconfig.reset()


# --- row growth under lockstep: every rule kind, with reloads ----------------

GROWTH_RESOURCES = [f"g{i}" for i in range(24)]


def _growth_specs(rng):
    """Random rule sets as (flow, degrade, param) specs: a flow rule of each
    of the four behaviours in turn on every resource, breakers of three
    grades on half of them, param rules (QPS with burst, a throttle, the
    THREAD grade) on ten."""
    flow, degrade, param = [], [], {}
    for i, res in enumerate(GROWTH_RESOURCES):
        flow.append(dict(resource=res, count=float(rng.integers(2, 25)), control_behavior=i % 4,
                         warm_up_period_sec=int(rng.integers(1, 4)), max_queueing_time_ms=int(rng.choice([0, 300, 800]))))
        if i % 2 == 0:
            grade = (i // 2) % 3
            count = (0.3, 0.5, 2)[grade] if grade else 40
            degrade.append(dict(resource=res, grade=grade, count=count, time_window=1, min_request_amount=2,
                                slow_ratio_threshold=0.5, stat_interval_ms=500))
        if i < 10:
            kind = i % 3
            param[res] = [dict(resource=res, param_idx=0, count=int(rng.integers(1, 6)), burst_count=int(kind == 0),
                               control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER if kind == 1 else 0,
                               max_queueing_time_ms=400, grade=C.FLOW_GRADE_THREAD if kind == 2 else C.FLOW_GRADE_QPS)]
    return flow, degrade, param


def _load_growth_rules(pair, specs):
    flow, degrade, param = specs
    pair.j.set_flow_rules(_rules(jst.FlowRule, flow))
    pair.t.set_flow_rules(_rules(FlowRule, flow))
    pair.j.set_degrade_rules(_rules(jst.DegradeRule, degrade))
    pair.t.set_degrade_rules(_rules(st.DegradeRule, degrade))
    pair.j.set_param_rules({r: _rules(jst.ParamFlowRule, s) for r, s in param.items()})
    pair.t.set_param_rules({r: _rules(st.ParamFlowRule, s) for r, s in param.items()})


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_row_growth_lockstep(seed, pinned_samplers):
    """The two engines from sentinel.tpu.rows.initial = 16, grown to 256 rows
    by the stream: flow rules of all four behaviours, breakers and param
    rules, reloaded now and then; singles with args, prio and origins, a
    bulk group with an args column, exits releasing the param rows.
    Verdicts, reasons, wait_ms, limit types, attribution, stats, breakers,
    the flow rules' shaping state and the param state after every flush.
    What fixes a flush's shapes (which resources, contexts, origins and
    args values it touches, how many entries and exits) comes from one
    plan for both seeds, so the JAX side compiles its steps once; the seed
    draws the rules' thresholds, the timestamps, acquires and completions.
    Both system samplers are pinned (the chain loads a BBR load threshold),
    so the result does not depend on the machine's load or on what an
    earlier test left in them."""
    from sentinel_tpu.utils.config import config as jconfig

    _assert_pinned(pinned_samplers)

    for cfg in (config, jconfig):
        cfg.set(cfg.INITIAL_ROWS, "16")
    try:
        plan = np.random.default_rng(77)
        rng = np.random.default_rng(300 + seed)
        now = 30_000
        pair = _Pair(now, chain=True)
        _assert_pinned(pinned_samplers)
        assert pair.j.stats.second.counts.shape[0] == pair.t.stats.n_rows == 16
        _load_growth_rules(pair, _growth_specs(rng))
        live = []  # admitted singles awaiting exit: (rows, resource, param rows)
        last_group = None
        for step in range(20):
            now += int(rng.choice([0, 40, 180, 420, 700, 1300]))
            pair.set_ms(now)
            if step in (7, 14):
                _load_growth_rules(pair, _growth_specs(rng))
            # Twelve singles: one on each of four param resources (both QPS
            # kinds, the throttle, the THREAD grade), two on other DEFAULT
            # resources, six on other shaping ones.
            picks = ([0, 1, 3, 5] + list(plan.choice([12, 16, 20], 2, replace=False))
                     + list(plan.choice([i for i in range(10, 24) if i % 4], 6, replace=False)))
            singles = []
            for j, i in enumerate(picks):
                res = GROWTH_RESOURCES[i]
                singles.append((res, pair.both(
                    "submit_entry", res, context_name=str(plan.choice(["c1", "c2", "c3", C.CONTEXT_DEFAULT_NAME])),
                    origin=str(plan.choice(["", "appX", "appY", "appZ", "appW"])), acquire=int(rng.integers(1, 3)),
                    entry_type=C.EntryType.IN if rng.random() < 0.5 else C.EntryType.OUT,
                    prio=j < 2, ts=now - int(rng.integers(0, 60)), args=(f"v{int(plan.integers(0, 4))}",),
                )))
            # The bulk group's args column, on the QPS param rule with burst:
            # two items on each of 14 values.
            groups = [pair.both("submit_bulk", "g0", 28, ts=np.sort(now - rng.integers(0, 300, 28)).astype(np.int32),
                                acquire=rng.integers(1, 3, 28).astype(np.int32), origin="appX",
                                args_column=[(f"v{i % 14}",) for i in range(28)])]
            for rows, r, prows in live[:5]:
                pair.both("submit_exit", rows, rt=int(rng.choice([5, 90])), count=1, err=int(rng.random() < 0.3),
                          ts=now, resource=r, param_rows=prows)
            del live[:5]
            rows = last_group.rows if last_group is not None else (-1, -1, -1, -1)
            pair.both("submit_exit_bulk", rows, 2, rt=int(rng.integers(0, 90)), ts=now, resource="g0")
            pair.flush_and_compare([p for _, p in singles], groups, step)
            assert_same(tuple(jax.device_get(pair.j.flow_dyn)), tuple(a.numpy() for a in pair.t.flow_dyn),
                        f"{step}: flow state")
            assert_same(tuple(jax.device_get(pair.j.param_dyn)), tuple(a.numpy() for a in pair.t.param_dyn),
                        f"{step}: param state")
            last_group = groups[0][1]
            for r, (jo, to) in singles:
                if to is not None and to.verdict.admitted:
                    live.append((to.rows, r, tuple(to.param_thread_rows)))
        assert pair.t.stats.n_rows == pair.j.stats.second.counts.shape[0] == 256
    finally:
        config.reset()
        jconfig.reset()


# --- the cases of tests/test_flow_default.py, against the port -----------


@pytest.fixture
def manual_clock():
    clock = tclock.ManualClock(start_ms=0)
    prev = tclock.set_default_clock(clock)
    api.reset(clock=clock, device="cpu")
    yield clock
    tclock.set_default_clock(prev)
    api.reset(device="cpu")


@pytest.fixture
def engine(manual_clock):
    return api.get_engine()


class TestFlowQpsDemo:
    def test_qps_rule_pins_pass_rate(self, manual_clock, engine):
        st.flow_rule_manager.load_rules([st.FlowRule("demo", count=20)])
        passes = blocks = 0
        for sec in range(5):
            sec_pass = 0
            for i in range(100):
                manual_clock.set_ms(sec * 1000 + i * 10)
                try:
                    e = st.entry("demo")
                    e.exit()
                    passes += 1
                    sec_pass += 1
                except st.FlowBlockError:
                    blocks += 1
            assert sec_pass == 20, f"second {sec}: expected 20 passes, got {sec_pass}"
        assert passes == 100
        assert blocks == 400

    def test_window_slide_refills(self, manual_clock, engine):
        st.flow_rule_manager.load_rules([st.FlowRule("res", count=2)])
        manual_clock.set_ms(0)
        assert st.try_entry("res") is not None
        assert st.try_entry("res") is not None
        assert st.try_entry("res") is None
        manual_clock.set_ms(1000)
        assert st.try_entry("res") is None
        manual_clock.set_ms(1001)
        assert st.try_entry("res") is not None

    def test_blocked_rule_attribution(self, manual_clock, engine):
        rule = st.FlowRule("attrib", count=0)
        st.flow_rule_manager.load_rules([rule])
        with pytest.raises(st.FlowBlockError) as ei:
            st.entry("attrib")
        assert ei.value.rule == rule
        assert ei.value.resource == "attrib"


class TestThreadGrade:
    def test_concurrency_limit(self, manual_clock, engine):
        st.flow_rule_manager.load_rules([st.FlowRule("svc", grade=C.FLOW_GRADE_THREAD, count=2)])
        e1 = st.try_entry("svc")
        e2 = st.try_entry("svc")
        assert e1 is not None and e2 is not None
        assert st.try_entry("svc") is None
        e1.exit()
        manual_clock.advance(1)
        e3 = st.try_entry("svc")
        assert e3 is not None
        e2.exit()
        e3.exit()

    def test_thread_gauge_reads(self, manual_clock, engine):
        st.flow_rule_manager.load_rules([st.FlowRule("g", grade=C.FLOW_GRADE_THREAD, count=10)])
        entries = [st.try_entry("g") for _ in range(3)]
        assert engine.cluster_node_stats("g")["cur_thread_num"] == 3
        for e in entries:
            e.exit()
        assert engine.cluster_node_stats("g")["cur_thread_num"] == 0


class TestMultiRuleSameNode:
    def test_two_rules_same_node_admit_min(self, manual_clock, engine):
        st.flow_rule_manager.load_rules([st.FlowRule("r", count=10), st.FlowRule("r", count=7)])
        ops = [engine.submit_entry("r", ts=0) for _ in range(10)]
        engine.flush()
        admitted = [op.verdict.admitted for op in ops]
        assert admitted == [True] * 7 + [False] * 3


class TestBatchedParity:
    @pytest.mark.parametrize("seed", [0, 7])
    def test_deferred_batch_matches_oracle(self, manual_clock, engine, seed):
        rng = np.random.default_rng(seed)
        st.flow_rule_manager.load_rules([st.FlowRule("A", count=10), st.FlowRule("B", count=3)])
        oracle = OracleFlowEngine()
        oracle.set_qps_rule("A", 10)
        oracle.set_qps_rule("B", 3)
        resources = rng.choice(["A", "B"], 80)
        ts = np.sort(rng.integers(0, 400, 80))
        manual_clock.set_ms(int(ts[-1]))
        ops = [engine.submit_entry(res, ts=int(t), entry_type=C.EntryType.IN) for res, t in zip(resources, ts)]
        engine.flush()
        got = [op.verdict.admitted for op in ops]
        want = [oracle.entry(res, int(t)) for res, t in zip(resources, ts)]
        assert got == want

    def test_sync_stream_matches_oracle_across_windows(self, manual_clock, engine):
        st.flow_rule_manager.load_rules([st.FlowRule("S", count=5)])
        oracle = OracleFlowEngine()
        oracle.set_qps_rule("S", 5)
        rng = np.random.default_rng(3)
        t = 0
        for _ in range(300):
            t += int(rng.choice([1, 5, 30, 120], p=[0.4, 0.3, 0.2, 0.1]))
            manual_clock.set_ms(t)
            got = st.try_entry("S")
            assert (got is not None) == oracle.entry("S", t), f"t={t}"
            if got is not None:
                got.exit()
                oracle.exit("S", t, 0)


# --- outside the slice: loud, never ignored -------------------------------


def _cpu_engine():
    return Engine(clock=tclock.ManualClock(0), device="cpu")


def _add_breaker_observer(e):
    from sentinel_tpu_torch.rules import breaker_events

    breaker_events.add_state_change_observer("t", lambda *a: None)


def _cluster_param_rule(e):
    """A cluster-mode param rule loads; asking for it through a token
    client (client mode) is what is not ported."""
    from sentinel_tpu_torch.cluster import ClusterStateManager
    from sentinel_tpu_torch.models.rules import ClusterFlowConfig

    e.set_param_rules({"r": [st.ParamFlowRule("r", param_idx=0, count=5, cluster_mode=True,
                                              cluster_config=ClusterFlowConfig(flow_id=1))]})
    ClusterStateManager.set_to_client()


@pytest.mark.parametrize(
    "call",
    [
        _add_breaker_observer,
        _cluster_param_rule,
        lambda e: make_mesh(8, [e.device, torch.device("meta")]),
    ],
    ids=["degrade", "param", "mesh"],
)
def test_out_of_slice_raises(call):
    """Features outside the port so far; for degrade rules, which the port
    now runs, that is the breaker state-change observers, for cluster-mode
    param rules the token client, and for the mesh, which runs its shards
    on the engine's device, shards on more than one device (NCCL)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(_cpu_engine())


@pytest.mark.parametrize(
    "call,item",
    [
        (lambda e: e.retune_second_window(4, 1000), 8),
    ],
    ids=["retune_second_window"],
)
def test_unported_engine_methods_raise(call, item):
    """The JAX Engine's methods that the port lacks raise NotImplementedError
    naming their ROADMAP item, not AttributeError."""
    with pytest.raises(NotImplementedError, match=rf"ROADMAP Queue 1 item {item}\b"):
        call(_cpu_engine())


@pytest.mark.parametrize(
    "call",
    [
        lambda e: e.set_flow_rules([FlowRule("r", count=5, control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER)]),
        lambda e: e.set_flow_rules([FlowRule("r", count=5, control_behavior=C.CONTROL_BEHAVIOR_WARM_UP)]),
        lambda e: e.set_flow_rules([FlowRule("r", count=5,
                                             control_behavior=C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER)]),
        lambda e: e.set_param_rules({"r": [st.ParamFlowRule("r", param_idx=0, count=5)]}),
        lambda e: (e.set_param_rules({"r": [st.ParamFlowRule("r", param_idx=0, count=5)]}),
                   e.submit_bulk("r", 4, args_column=[("a",)] * 4)),
        lambda e: (e.set_param_rules({"r": [st.ParamFlowRule("r", param_idx=0, count=5)]}),
                   e.submit_entry("r", args=("a",))),
        lambda e: e.submit_exit((1, 2, -1, -1), rt=3, param_rows=[0]),
    ],
    ids=["rate_limiter", "warm_up", "warm_up_rate_limiter", "param", "args_column", "args", "param_rows"],
)
def test_slice_three_features_accepted(call):
    """Shaping behaviors, param rules, args on entries and bulk groups and
    param rows on exits load and flush on the port."""
    eng = _cpu_engine()
    call(eng)
    eng.flush()


@pytest.mark.parametrize(
    "call",
    [
        lambda e: e.set_degrade_rules([st.DegradeRule("r", grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, count=1,
                                                      time_window=1)]),
        lambda e: e.set_system_config(st.system_rule_manager.effective._replace(qps=5.0)),
        lambda e: e.set_authority_rules({"r": st.AuthorityRule("r", limit_app="a")}),
        lambda e: e.submit_entry("r", prio=True),
    ],
    ids=["degrade", "system", "authority", "prio"],
)
def test_slice_two_features_accepted(call):
    """Degrade, system and authority rules and prioritized entries load
    and flush on the port."""
    eng = _cpu_engine()
    call(eng)
    eng.flush()


def test_cluster_mode_rule_raises():
    """Cluster-mode flow rules load and are decided by the embedded token
    service (tests/test_torch_cluster.py); client mode, the other way to
    decide them, raises."""
    from sentinel_tpu_torch.cluster import ClusterStateManager
    from sentinel_tpu_torch.models.rules import ClusterFlowConfig

    rule = FlowRule("r", count=5, cluster_mode=True, cluster_config=ClusterFlowConfig(flow_id=1))
    eng = _cpu_engine()
    eng.set_flow_rules([rule])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ClusterStateManager.set_to_client()
    assert not ClusterStateManager.is_client()


@pytest.mark.parametrize(
    "key,value",
    [
        (config.GOSSIP_ENABLED, "true"), (config.SPECULATIVE_ENABLED, "true"),
        (config.FAILOVER_ENABLED, "true"), (config.CAPTURE_ENABLED, "true"),
        (config.AUTOTUNE_ENABLED, "true"), (config.IPC_ENABLED, "true"),
    ],
)
def test_unported_config_raises(key, value):
    config.set(key, value)
    if key == config.GOSSIP_ENABLED:
        config.set(config.SKETCH_ENABLED, "true")  # the tier runs; its gossip transport does not
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _cpu_engine()
    finally:
        config.reset()


# --- the scenarios of tests/test_relate.py, on both engines in lockstep ---


def _relate(lib, count):
    return lib.st.FlowRule("A", count=count, strategy=lib.C.STRATEGY_RELATE, ref_resource="B")


def _batch(lib, reqs):
    now = lib.engine.clock.now_ms()
    ops = lib.engine.submit_many([{"resource": r, "ts": now} for r in reqs])
    lib.engine.flush()
    return [op.verdict.admitted for op in ops]


def _relate_checks_ref_stats(lib):
    lib.st.flow_rule_manager.load_rules([_relate(lib, 5)])
    lib.clock.set_ms(100)
    out = [lib.st.try_entry("B") is not None for _ in range(3)]
    out += [lib.st.try_entry("A") is not None for _ in range(10)]
    b, a = lib.engine.cluster_node_stats("B"), lib.engine.cluster_node_stats("A")
    assert out == [True] * 13 and b["pass_qps"] == 3.0 and a["total_pass_minute"] == 10
    return out + [b, a]


def _relate_blocks_over_count(lib):
    lib.st.flow_rule_manager.load_rules([_relate(lib, 2)])
    lib.clock.set_ms(100)
    for _ in range(2):
        lib.st.try_entry("B")
    out = [lib.st.try_entry("A") is None]
    lib.clock.set_ms(1500)
    out.append(lib.st.try_entry("A") is not None)
    assert out == [True, True]
    return out


def _relate_same_batch(lib):
    lib.st.flow_rule_manager.load_rules([_relate(lib, 5)])
    lib.clock.set_ms(100)
    for _ in range(3):
        lib.st.try_entry("B")
    out = _batch(lib, ["A"] * 10)
    assert out == [True] * 10
    return out


def _relate_ruled_b_charges(lib):
    lib.st.flow_rule_manager.load_rules([_relate(lib, 5), lib.st.FlowRule("B", count=100)])
    lib.clock.set_ms(100)
    for _ in range(3):
        lib.st.try_entry("B")
    out = _batch(lib, ["B"] * 2 + ["A"] * 10)
    assert out[:2] == [True, True] and sum(out[2:]) == 0
    return out


def _relate_unruled_b_next_flush(lib):
    lib.st.flow_rule_manager.load_rules([_relate(lib, 5)])
    lib.clock.set_ms(100)
    for _ in range(3):
        lib.st.try_entry("B")
    out = _batch(lib, ["B"] * 2 + ["A"] * 10) + _batch(lib, ["A"] * 3)
    assert out == [True] * 12 + [False] * 3
    return out


def _relate_direct_exact(lib):
    lib.st.flow_rule_manager.load_rules([_relate(lib, 5), lib.st.FlowRule("D", count=4)])
    lib.clock.set_ms(100)
    out = _batch(lib, ["D"] * 10)
    assert sum(out) == 4
    return out


def _relate_after_ref_appears(lib):
    lib.st.flow_rule_manager.load_rules([_relate(lib, 0)])
    lib.clock.set_ms(100)
    out = [lib.st.try_entry(r) is not None for r in ("A", "B", "A")]
    assert out == [True, True, False]
    return out


RELATE_SCENARIOS = {
    "checks_ref_resource_stats": _relate_checks_ref_stats,
    "blocks_when_ref_over_count": _relate_blocks_over_count,
    "same_batch_matches_sequential": _relate_same_batch,
    "same_batch_ruled_b_charges": _relate_ruled_b_charges,
    "same_batch_unruled_b_next_flush": _relate_unruled_b_next_flush,
    "direct_rules_stay_exact": _relate_direct_exact,
    "enforced_after_ref_appears": _relate_after_ref_appears,
}


@pytest.mark.parametrize("name", sorted(RELATE_SCENARIOS))
def test_relate_scenario_lockstep(name):
    from torch_parity import run_on_both

    run_on_both(RELATE_SCENARIOS[name])


def test_rebase_large_offset_keeps_breaker_floor():
    """The real ~22-day rebase shifts by about 1.9e9 ms. A breaker that
    never saw an exit keeps its window-start floor (-1e9), an OPEN
    breaker's deadline and a live window move by the offset, and a window
    whose interval does not divide the offset lands on its own grid. (The
    JAX engine's int32 shift wraps the floor to about +1.4e9 here: see
    ROADMAP Queue 3.)"""
    eng = _cpu_engine()
    eng.set_degrade_rules([
        st.DegradeRule("a", grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, count=1, time_window=1),
        st.DegradeRule("b", grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, count=1, time_window=1),
        st.DegradeRule("c", grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, count=1, time_window=1, stat_interval_ms=333),
    ])
    d = eng.degrade_dyn
    d.state[1], d.next_retry[1], d.ws[1] = 1, 1_950_000_500, 1_950_000_000
    d.ws[2] = 1_950_000_000 - 1_950_000_000 % 333
    offset = 1_900_020_000
    eng._apply_rebase(offset)
    assert int(d.ws[0]) == -(10**9) and int(d.ws[3]) == -(10**9)
    assert (int(d.next_retry[1]), int(d.ws[1])) == (49_980_500, 49_980_000)
    unaligned = 1_950_000_000 - 1_950_000_000 % 333 - offset
    assert int(d.ws[2]) % 333 == 0 and unaligned - 333 < int(d.ws[2]) <= unaligned


# --- the slab horizon: the sweep (K1) runs only while a borrow may be held ----------


@pytest.fixture
def occupy_timeout():
    """Sets both packages' occupy timeout; both configs are reset after."""
    from sentinel_tpu.utils.config import config as jconfig

    def set_ms(ms):
        for c in (jconfig, config):
            c.set(c.OCCUPY_TIMEOUT_MS, str(ms))

    try:
        yield set_ms
    finally:
        jconfig.reset()
        config.reset()


def _borrow_flush(pair, now, prio=0, plain=1, step=""):
    """One flush at ``now`` on both engines: ``prio`` prioritized entries
    and ``plain`` others on "res", one on "other"; verdicts and every state
    tensor compared. Returns the port's sweeps in it (flush_step.sweeps)."""
    pair.set_ms(now)
    singles = [pair.both("submit_entry", "res", prio=True, ts=now) for _ in range(prio)]
    singles += [pair.both("submit_entry", "res", ts=now) for _ in range(plain)]
    singles.append(pair.both("submit_entry", "other", ts=now))
    before = tflush.flush_step.sweeps
    pair.flush_and_compare(singles, [], step)
    return tflush.flush_step.sweeps - before


@pytest.mark.parametrize("timeout", [500, 1000])
@pytest.mark.parametrize("now_mod", [0, 1, 499])
def test_engine_borrow_horizon_lockstep(now_mod, timeout, occupy_timeout):
    """The port's engine and the JAX engine in lockstep across a borrow's
    life. Two passes in the window before w and two in w (count 4), then
    five prioritized entries at w + now_mod: they borrow the next window,
    and, once w has started, the one after. Then DEFAULT flushes at each
    target - 1, at the target, at the target + interval, at the horizon
    and past it, with a rebase of 60,000 ms after the first of them. Every
    state tensor is compared after every flush. The port's flush sweeps
    (K1) from the first borrow until a flush at or past the horizon, and
    never once the slab is clean."""
    occupy_timeout(timeout)
    empty = tnodes.SECOND_CFG.empty_ws
    w = 200_000
    pair = _Pair(w - 490)
    pair.j.set_flow_rules([jst.FlowRule("res", count=4), jst.FlowRule("other", count=100)])
    pair.t.set_flow_rules([FlowRule("res", count=4), FlowRule("other", count=100)])
    assert _borrow_flush(pair, w - 490, plain=2, step="previous window") == 0
    assert _borrow_flush(pair, w, plain=2, step="window w") == 0
    t0 = w + now_mod
    assert _borrow_flush(pair, t0, prio=5, plain=0, step="borrows") == 0  # the slab was empty: no sweep
    horizon = tflush.borrow_horizon(t0, timeout)
    assert pair.t._slab_horizon == horizon
    fws = pair.t.stats.future_ws
    borrowed = fws != empty
    assert bool(borrowed.any()) == (horizon is not None)
    if horizon is None:  # no step may grant: the slab stays empty, and unswept
        assert _borrow_flush(pair, t0 + 600, step="no borrow") == 0
        return
    targets = sorted({int(x) for x in fws[borrowed]})
    assert targets[-1] <= horizon
    times = sorted({t + d for t in targets + [horizon] for d in (-1, 0, 1000)})
    offset, swept, passed = 0, 0, False
    for i, x in enumerate(times):
        if i == 1:
            pair.both("_apply_rebase", 60_000)
            offset = 60_000
            assert pair.t._slab_horizon == horizon - offset
            assert_same(jax.device_get(pair.j.stats), stats_to_numpy(pair.t.stats), "rebased stats")
        got = _borrow_flush(pair, x - offset, step=f"flush at {x}")
        assert got == int(not passed), f"flush at {x} (horizon {horizon}): {got} sweeps"
        swept += got
        passed |= x >= horizon
    assert swept >= 2 and passed and pair.t._slab_horizon is None
    stats = stats_to_numpy(pair.t.stats)
    assert (stats.future_ws == empty).all() and (stats.future_pass == 0).all()
    for x in (horizon + 1500, horizon + 5000):
        assert _borrow_flush(pair, x - offset, step=f"past the horizon, {x}") == 0


@pytest.mark.parametrize("timeout", [500, 1000])
@pytest.mark.parametrize("now", [0, 1, 499, 500, 1_250, 2**31 - 501, 2**31 - 500, 2**31 - 250, 2**31 - 2,
                                 2**31 - 1])
def test_borrow_horizon_bounds_jax_borrows(now, timeout):
    """The JAX step's borrows never lie past the port's horizon: on an
    empty slab, every entry prioritized against QPS rules of count 2-9,
    the largest window start in the JAX step's slab afterwards is at most
    flush.borrow_horizon(now, timeout); where that is None, no entry
    borrows. Near 2^31 the horizon is not wrapped: there the JAX step
    grants a borrow whose target wraps, and writes no slab cell for it."""
    from sentinel_tpu.rules import degrade_table as jdt
    from sentinel_tpu.rules.param_table import make_param_state
    from sentinel_tpu.runtime import flush as jflush
    from test_torch_nodes import _jax_stats
    from torch_parity import (borrowable_stats, random_degrade, random_flow_table, random_flush_batch,
                              system_thresholds)

    rng = np.random.default_rng(now % 997 + timeout)
    n_rows, nr, n = 32, 16, 64
    cfg = tnodes.SECOND_CFG
    second, minute, threads, fpass, fws = borrowable_stats(rng, n_rows, now, cfg, tnodes.MINUTE_CFG)
    arrs = (second, minute, threads, np.zeros_like(fpass), np.full_like(fws, cfg.empty_ws))
    table, dyn = random_flow_table(rng, nr, thread_frac=0.0, lo=2, hi=10)
    b = list(random_flush_batch(rng, n, 1, n_rows, nr, now, n))
    b[2] = np.maximum(b[2], 0)  # e_ts >= 0
    b[7] = np.ones(n, bool)  # every entry prioritized
    dtable, ddyn = random_degrade(rng, 8, now)
    out = jflush.flush_step_jit(
        _jax_stats(arrs), jflush.FlowTableDevice(*map(jnp.asarray, table)),
        jflush.FlowRuleDynState(*map(jnp.asarray, dyn)), jdt.DegradeTableDevice(*map(jnp.asarray, dtable)),
        jdt.DegradeDynState(*map(jnp.asarray, ddyn)), make_param_state(8),
        jflush.SystemDevice(*(jnp.float32(v) for v in system_thresholds("off"))),
        jflush.FlushBatch(*map(jnp.asarray, b)), occupy_timeout_ms=timeout, with_occupy=True, with_exits=False,
    )
    after = np.asarray(out[0].future_ws)
    borrowed = after != cfg.empty_ws
    occupied = np.asarray(out[5].occupied)
    horizon = tflush.borrow_horizon(now, timeout)
    if horizon is None:
        assert not occupied.any() and not borrowed.any()
    else:
        assert occupied.any(), "the batch must borrow"
        # Near 2^31 a granted borrow whose target wraps is not written.
        assert borrowed.any() or horizon > 2**31 - 1
        assert not borrowed.any() or int(after[borrowed].max()) <= horizon


# --- submit_many (tests/test_engine_bulk.py's cases), on both engines ---------------


def _verdicts(ops):
    return [None if o is None else (bool(o.verdict.admitted), int(o.verdict.reason), int(o.verdict.wait_ms))
            for o in ops]


def _many_bulk_parity(lib):
    """A bulk group decides like the same entries through submit_many
    (test_bulk_parity_with_submit_many), singles and bulk share one flush
    (test_bulk_mixed_with_singles), bulk exits apply before submit_many's
    entries (test_bulk_exits_apply_before_singles_entries)."""
    eng = lib.engine
    eng.set_flow_rules([lib.st.FlowRule("res", count=20), lib.st.FlowRule("mx", count=10),
                        lib.st.FlowRule("ord", grade=lib.C.FLOW_GRADE_THREAD, count=4)])
    lib.clock.set_ms(1000)
    ops = eng.submit_many([{"resource": "res", "ts": 1000} for _ in range(64)])
    eng.flush()
    out = _verdicts(ops)
    assert sum(v[0] for v in out) == 20
    ops = eng.submit_many([{"resource": "mx", "ts": 1000} for _ in range(6)])
    g = eng.submit_bulk("mx", 16, ts=1000)
    eng.flush()
    assert sum(o.verdict.admitted for o in ops) + g.admitted_count == 10
    out += _verdicts(ops) + [np.asarray(g.admitted).tolist()]
    g = eng.submit_bulk("ord", 4)
    eng.flush()
    eng.submit_exit_bulk(g.rows, 4, rt=5, resource="ord")
    ops = eng.submit_many([{"resource": "ord"} for _ in range(4)])
    eng.flush()
    assert sum(o.verdict.admitted for o in ops) == 4
    return out + _verdicts(ops)


def _many_param_column_parity(lib):
    """test_param_column_parity_with_submit_many: per-value budgets of a
    bulk args column equal submit_many's with the same args."""
    eng = lib.engine
    eng.set_flow_rules([lib.st.FlowRule("gw", count=1000)])
    eng.set_param_rules({"gw": [lib.st.ParamFlowRule("gw", param_idx=0, count=3)]})
    lib.clock.set_ms(1000)
    values = [f"ip-{i % 5}" for i in range(40)]
    ops = eng.submit_many([{"resource": "gw", "ts": 1000, "args": (v,)} for v in values])
    eng.flush()
    out = _verdicts(ops)
    assert sum(v[0] for v in out) == 15
    return out


def _many_order_and_fallbacks(lib):
    """Request order survives flush-on-size (the ops queued so far are
    decided, the rest go through submit_entry) and a request with a key
    submit_entry does not take raises there, after the ones before it
    were enqueued."""
    eng = lib.engine
    eng.set_flow_rules([lib.st.FlowRule("o", count=7)])
    eng.max_batch = 5
    lib.clock.set_ms(2000)
    ops = eng.submit_many([{"resource": "o", "ts": 2000, "acquire": 1 + i % 2} for i in range(12)])
    decided_early = [o.verdict is not None for o in ops]
    eng.flush()
    out = [decided_early, _verdicts(ops)]
    with pytest.raises(TypeError):
        eng.submit_many([{"resource": "o"}, {"resource": "o", "bogus": 1}])
    eng.flush()
    out.append(eng.cluster_node_stats("o"))
    assert decided_early[:5] == [True] * 5
    return out


SUBMIT_MANY_SCENARIOS = {
    "bulk_parity": _many_bulk_parity,
    "param_column_parity": _many_param_column_parity,
    "order_and_fallbacks": _many_order_and_fallbacks,
}


@pytest.mark.parametrize("name", sorted(SUBMIT_MANY_SCENARIOS))
def test_submit_many_matches_jax(name):
    from torch_parity import run_on_both

    run_on_both(SUBMIT_MANY_SCENARIOS[name])
