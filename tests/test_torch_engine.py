"""The port's engine slice as a whole (sentinel_tpu_torch Engine on the
CPU, plain PyTorch versions) against the JAX package's Engine, bit for
bit: each runs under its own ManualClock from the same start, gets the
same flow rules and the same stream of submit_entry / submit_bulk /
submit_exit / submit_exit_bulk calls, and flushes that span several
second-window boundaries. After every flush the verdicts, reasons,
slot_ok attribution, the blocked top-K and every state tensor must be
identical. Also: the cases of tests/test_flow_default.py against the
port, and the features outside the slice raising NotImplementedError."""

import jax
import numpy as np
import pytest

import sentinel_tpu as jst
import sentinel_tpu_torch as st
from sentinel_tpu.runtime.engine import Engine as JEngine
from sentinel_tpu.testing.oracle import OracleFlowEngine
from sentinel_tpu.utils.clock import ManualClock as JClock
from sentinel_tpu_torch.core import api
from sentinel_tpu_torch.metrics.nodes import stats_to_numpy
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.models.rules import FlowRule
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


def _rules(cls):
    return [cls(**r) for r in RULES]


class _Pair:
    """The two engines driven in lockstep."""

    def __init__(self, start_ms):
        self.jclock = JClock(start_ms)
        self.tclock = tclock.ManualClock(start_ms)
        self.j = JEngine(clock=self.jclock)
        self.t = Engine(clock=self.tclock, device="cpu")
        self.j_topk = []
        self.j._fold_blocked_sketch = lambda rows, w: self.j_topk.append((np.asarray(rows), np.asarray(w)))
        self.j.set_flow_rules(_rules(jst.FlowRule))
        self.t.set_flow_rules(_rules(FlowRule))

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
            assert (jv.admitted, jv.reason, jv.wait_ms) == (tv.admitted, tv.reason, tv.wait_ms), step
            jr = None if jv.blocked_rule is None else jv.blocked_rule.to_dict()
            tr = None if tv.blocked_rule is None else tv.blocked_rule.to_dict()
            assert jr == tr, f"{step}: attribution"
        for jg, tg in groups:
            for name in ("admitted", "reason", "wait_ms"):
                assert_same(getattr(jg, name), getattr(tg, name), f"{step}: bulk {name}")
        assert_same(jax.device_get(self.j.stats), stats_to_numpy(self.t.stats), f"{step}: stats")
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


@pytest.mark.parametrize(
    "call",
    [
        lambda e: e.set_degrade_rules([object()]),
        lambda e: e.set_param_rules({"r": [object()]}),
        lambda e: e.set_system_config(object()),
        lambda e: e.set_authority_rules({"r": object()}),
        lambda e: e.set_flow_rules([FlowRule("r", count=5, control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER)]),
        lambda e: e.set_flow_rules([FlowRule("r", count=5, control_behavior=C.CONTROL_BEHAVIOR_WARM_UP)]),
        lambda e: e.submit_entry("r", prio=True),
        lambda e: e.enable_mesh(8),
        lambda e: e.flush_async(),
        lambda e: e.submit_bulk("r", 4, args_column=[("a",)] * 4),
    ],
    ids=["degrade", "param", "system", "authority", "rate_limiter", "warm_up", "prio", "mesh",
         "flush_async", "args_column"],
)
def test_out_of_slice_raises(call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(_cpu_engine())


def test_cluster_mode_rule_raises():
    from sentinel_tpu_torch.models.rules import ClusterFlowConfig

    rule = FlowRule("r", count=5, cluster_mode=True, cluster_config=ClusterFlowConfig(flow_id=1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _cpu_engine().set_flow_rules([rule])


@pytest.mark.parametrize(
    "key,value",
    [
        (config.SKETCH_ENABLED, "true"), (config.SPECULATIVE_ENABLED, "true"),
        (config.FAILOVER_ENABLED, "true"), (config.CAPTURE_ENABLED, "true"),
        (config.AUTOTUNE_ENABLED, "true"), (config.IPC_ENABLED, "true"),
        (config.PIPELINE_DEPTH, "2"),
    ],
)
def test_unported_config_raises(key, value):
    config.set(key, value)
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _cpu_engine()
    finally:
        config.reset()
