"""The port's engine in mesh mode (``Engine.enable_mesh(8)``: 8 shards of
the CPU, plain PyTorch versions): the cases of tests/test_engine_mesh.py
(TestEngineMesh and TestMeshLifecycle), test_engine_bulk.py:150 and
test_conservatism.py:118 with their asserted numbers, and a lockstep
stream against the JAX engine's ``enable_mesh(8)`` on the 8-device CPU
mesh (verdicts, reasons, wait_ms, attribution, stats and breaker state
equal). Where the JAX case compares its mesh engine with a single-chip
engine, the port's mesh engine is compared with the port's single-device
engine. Tolerance is zero."""

import numpy as np
import pytest
import torch

import sentinel_tpu_torch as st
from sentinel_tpu_torch.core import api
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.models.rules import AuthorityRule
from sentinel_tpu_torch.runtime.engine import Engine
from sentinel_tpu_torch.utils import clock as tclock
from sentinel_tpu_torch.utils.config import config

from torch_parity import run_on_both


@pytest.fixture()
def clock():
    c = tclock.ManualClock(0)
    prev = tclock.set_default_clock(c)
    api.reset(clock=c, device="cpu")
    yield c
    config.reset()
    tclock.set_default_clock(prev)
    api.reset(device="cpu")


@pytest.fixture()
def mesh_engine(clock):
    eng = api.get_engine()
    eng.enable_mesh(8)
    return eng


def _ref(clock):
    return Engine(clock=clock, device="cpu")


def _admitted(ops):
    return sum(op.verdict.admitted for op in ops)


# --- tests/test_engine_mesh.py: TestEngineMesh -----------------------------------


def test_budget_conserved_through_engine_api(mesh_engine):
    st.flow_rule_manager.load_rules([st.FlowRule("res", count=20)])
    now = mesh_engine.clock.now_ms()
    ops = mesh_engine.submit_many([{"resource": "res", "ts": now} for _ in range(128)])
    mesh_engine.flush()
    assert _admitted(ops) == 20
    stats = mesh_engine.cluster_node_stats("res")
    assert stats["pass_qps"] == pytest.approx(20.0)
    assert stats["total_block_minute"] == 108


def test_thread_grade_and_exits_on_mesh(mesh_engine):
    st.flow_rule_manager.load_rules([st.FlowRule("svc", grade=0, count=4)])
    ops = mesh_engine.submit_many([{"resource": "svc"} for _ in range(16)])
    mesh_engine.flush()
    assert _admitted(ops) == 4
    assert mesh_engine.cluster_node_stats("svc")["cur_thread_num"] == 4
    first = next(op for op in ops if op.verdict.admitted)
    for _ in range(2):
        mesh_engine.submit_exit(first.rows, rt=5, resource="svc")
    ops2 = mesh_engine.submit_many([{"resource": "svc"} for _ in range(8)])
    mesh_engine.flush()
    assert _admitted(ops2) == 2


def test_breaker_trips_and_recovers_on_mesh(mesh_engine, clock):
    st.flow_rule_manager.load_rules([st.FlowRule("d", count=1000)])
    st.degrade_rule_manager.load_rules([st.DegradeRule(resource="d", grade=1, count=0.5, time_window=2,
                                                       min_request_amount=5)])
    clock.set_ms(1000)
    ops = mesh_engine.submit_many([{"resource": "d"} for _ in range(8)])
    mesh_engine.flush()
    assert all(op.verdict.admitted for op in ops)
    for op in ops:
        mesh_engine.submit_exit(op.rows, rt=5, err=1, resource="d")
    mesh_engine.flush()
    clock.set_ms(1100)
    blocked = mesh_engine.submit_many([{"resource": "d"} for _ in range(8)])
    mesh_engine.flush()
    assert not any(op.verdict.admitted for op in blocked)
    clock.set_ms(3200)
    probe = mesh_engine.submit_many([{"resource": "d"} for _ in range(8)])
    mesh_engine.flush()
    assert _admitted(probe) == 1


def test_breaker_counts_survive_multi_chip_window_roll(mesh_engine, clock):
    st.flow_rule_manager.load_rules([st.FlowRule("w", count=1000)])
    st.degrade_rule_manager.load_rules([st.DegradeRule(resource="w", grade=1, count=0.5, time_window=5,
                                                       min_request_amount=4)])
    clock.set_ms(500)
    ops = mesh_engine.submit_many([{"resource": "w", "ts": 500} for _ in range(4)])
    mesh_engine.flush()
    for i, op in enumerate(ops):
        mesh_engine.submit_exit(op.rows, rt=5, err=1 if i < 2 else 0, resource="w", ts=500)
    mesh_engine.flush()
    clock.set_ms(1500)
    ops2 = mesh_engine.submit_many([{"resource": "w", "ts": 1500} for _ in range(4)])
    mesh_engine.flush()
    for op in ops2:
        mesh_engine.submit_exit(op.rows, rt=5, err=1, resource="w", ts=1500)
    mesh_engine.flush()
    clock.set_ms(1600)
    blocked = mesh_engine.submit_many([{"resource": "w"} for _ in range(8)])
    mesh_engine.flush()
    assert not any(op.verdict.admitted for op in blocked)


def test_occupy_borrows_conserved_on_mesh_engine(mesh_engine, clock):
    config.set(config.OCCUPY_TIMEOUT_MS, "1000")
    mesh_engine.enable_mesh(8)  # the sharded steps are rebuilt with the new timeout
    st.flow_rule_manager.load_rules([st.FlowRule("p", count=4)])
    clock.set_ms(1000)
    ops = mesh_engine.submit_many([{"resource": "p", "ts": 1000} for _ in range(4)])
    mesh_engine.flush()
    assert _admitted(ops) == 4
    clock.set_ms(1100)
    prio = mesh_engine.submit_many([{"resource": "p", "ts": 1100, "prio": True} for _ in range(16)])
    mesh_engine.flush()
    granted = [op for op in prio if op.verdict.admitted]
    assert len(granted) == 4  # the borrow budget is maxCount
    assert all(op.verdict.wait_ms > 0 for op in granted)
    assert mesh_engine.cluster_node_stats("p")["waiting"] == 4


def _mesh_vs_single(mesh_engine, clock, set_rules, batches, key=lambda o: o.verdict.admitted):
    """The same op batches through the mesh engine and a single-device
    engine; returns the per-batch verdict keys of both."""
    ref = _ref(clock)
    set_rules(mesh_engine)
    set_rules(ref)
    got, want = [], []
    for t, reqs in batches:
        clock.set_ms(t)
        ops_m = mesh_engine.submit_many([dict(r) for r in reqs])
        mesh_engine.flush()
        ops_r = ref.submit_many([dict(r) for r in reqs])
        ref.flush()
        got.append([key(o) for o in ops_m])
        want.append([key(o) for o in ops_r])
    assert got == want
    return got


def test_rate_limiter_parity_with_single_chip(mesh_engine, clock):
    rules = [st.FlowRule("rl", count=10, control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER,
                         max_queueing_time_ms=500)]
    reqs = [{"resource": "rl", "ts": 1000 + 7 * i} for i in range(24)]
    (got,) = _mesh_vs_single(mesh_engine, clock, lambda e: e.set_flow_rules(rules), [(1000, reqs)],
                             key=lambda o: (o.verdict.admitted, o.verdict.wait_ms))
    assert 1 < sum(a for a, _ in got) < len(reqs)


def test_warmup_parity_with_single_chip(mesh_engine, clock):
    rules = [st.FlowRule("wu", count=100, control_behavior=C.CONTROL_BEHAVIOR_WARM_UP, warm_up_period_sec=10)]
    got = _mesh_vs_single(mesh_engine, clock, lambda e: e.set_flow_rules(rules),
                          [(t, [{"resource": "wu", "ts": t} for _ in range(64)]) for t in (1000, 2500)])
    assert all(0 < sum(g) < 64 for g in got)


def test_warmup_parity_with_upstream_blocked_entries(mesh_engine, clock):
    rules = [st.FlowRule("wb", count=100, control_behavior=C.CONTROL_BEHAVIOR_WARM_UP, warm_up_period_sec=10)]
    auth = {"wb": AuthorityRule(resource="wb", limit_app="bad", strategy=C.AUTHORITY_BLACK)}

    def set_rules(e):
        e.set_flow_rules(rules)
        e.set_authority_rules(auth)

    reqs = [{"resource": "wb", "ts": 1000, "origin": "bad" if i % 3 == 0 else "ok"} for i in range(48)]
    (got,) = _mesh_vs_single(mesh_engine, clock, set_rules, [(1000, reqs)],
                             key=lambda o: (o.verdict.admitted, o.verdict.reason))
    assert any(not a for a, _ in got)


def test_param_bucket_conserved_and_parity_on_mesh(mesh_engine, clock):
    rules = {"pp": [st.ParamFlowRule(resource="pp", param_idx=0, count=5)]}
    (got,) = _mesh_vs_single(mesh_engine, clock, lambda e: e.set_param_rules(rules),
                             [(1000, [{"resource": "pp", "ts": 1000, "args": ("user-1",)} for _ in range(16)])])
    assert sum(got) == 5


def test_param_thread_grade_with_exits_on_mesh(mesh_engine):
    mesh_engine.set_param_rules({"tg": [st.ParamFlowRule(resource="tg", param_idx=0, count=3,
                                                         grade=C.FLOW_GRADE_THREAD)]})
    ops = mesh_engine.submit_many([{"resource": "tg", "args": ("v",)} for _ in range(8)])
    mesh_engine.flush()
    assert _admitted(ops) == 3
    winner = next(op for op in ops if op.verdict.admitted)
    for _ in range(2):
        mesh_engine.submit_exit(winner.rows, rt=5, resource="tg", param_rows=winner.param_thread_rows)
    ops2 = mesh_engine.submit_many([{"resource": "tg", "args": ("v",)} for _ in range(8)])
    mesh_engine.flush()
    assert _admitted(ops2) == 2


def test_shaping_and_default_budget_together_on_mesh(mesh_engine, clock):
    rules = [st.FlowRule("mix", count=20),
             st.FlowRule("mix", count=50, control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER, max_queueing_time_ms=500)]
    (got,) = _mesh_vs_single(mesh_engine, clock, lambda e: e.set_flow_rules(rules),
                             [(1000, [{"resource": "mix", "ts": 1000} for _ in range(128)])])
    assert sum(got) == 20


def test_origin_split_budget_is_exact(mesh_engine, clock):
    rules = [st.FlowRule("os", count=10, limit_app=C.LIMIT_APP_OTHER)]
    pre = [{"resource": "os", "origin": "o1", "ts": 1000} for _ in range(6)]
    reqs = [{"resource": "os", "origin": "o1" if i % 2 == 0 else "o2", "ts": 1100} for i in range(16)]
    got = _mesh_vs_single(mesh_engine, clock, lambda e: e.set_flow_rules(rules), [(1000, pre), (1100, reqs)])
    assert sum(got[0]) == 6 and sum(got[1]) == 12
    for origin in ("o1", "o2"):
        assert sum(a for a, r in zip(got[1], reqs) if r["origin"] == origin) <= 10


# --- TestMeshLifecycle, test_engine_bulk.py:150, test_conservatism.py:118 ---------


def test_non_pow2_mesh_rejected(clock):
    with pytest.raises(ValueError, match="power of two"):
        api.get_engine().enable_mesh(3)


def test_disable_mesh_returns_to_single_chip(mesh_engine):
    mesh_engine.disable_mesh()
    assert mesh_engine.mesh is None
    mesh_engine.set_flow_rules([st.FlowRule("s", count=10, control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER)])
    op = mesh_engine.submit_entry("s")
    mesh_engine.flush()
    assert op.verdict.admitted


def test_bulk_on_mesh(mesh_engine):
    mesh_engine.set_flow_rules([st.FlowRule("m", count=20)])
    g = mesh_engine.submit_bulk("m", 128, ts=mesh_engine.clock.now_ms())
    mesh_engine.flush()
    assert g.admitted_count == 20


def _conservatism_rules():
    return [
        st.FlowRule("r0", count=30), st.FlowRule("r1", count=24), st.FlowRule("r2", count=40),
        st.FlowRule("r3", count=18),
        st.FlowRule("A1", count=20, strategy=C.STRATEGY_RELATE, ref_resource="B1"),
        st.FlowRule("A2", count=15, strategy=C.STRATEGY_RELATE, ref_resource="B2"),
        st.FlowRule("B1", count=25), st.FlowRule("B2", count=20),
        st.FlowRule("os", count=25, limit_app=C.LIMIT_APP_OTHER),
    ]


def test_overblock_rate_mesh(mesh_engine, clock):
    """tests/test_conservatism.py's workload (seed 43, 30 flushes of about
    24 ops) on the port's mesh engine against a sequential engine (one
    flush per op): never more admitted, over-block rate under 5%."""
    weights = [("r0", 3), ("r1", 2), ("r2", 3), ("r3", 2), ("A1", 3), ("A2", 2), ("B1", 2), ("B2", 2), ("os", 5)]
    mesh_engine.set_flow_rules(_conservatism_rules())
    seq = _ref(clock)
    seq.set_flow_rules(_conservatism_rules())
    rng = np.random.default_rng(43)
    pool = [r for r, w in weights for _ in range(w)]
    t, adm_b, adm_o = 1000, 0, 0
    for _ in range(30):
        t += int(rng.integers(40, 180))
        clock.set_ms(t)
        reqs = []
        for _ in range(max(1, int(rng.poisson(24)))):
            res = pool[int(rng.integers(0, len(pool)))]
            req = {"resource": res, "ts": t}
            if res == "os":
                req["origin"] = ["o1", "o2", "o3"][int(rng.integers(0, 3))]
            reqs.append(req)
        ops = mesh_engine.submit_many([dict(r) for r in reqs])
        mesh_engine.flush()
        adm_b += _admitted(ops)
        for req in reqs:
            op = seq.submit_entry(**req)
            seq.flush()
            adm_o += int(op.verdict.admitted)
    assert adm_b <= adm_o
    assert (adm_o - adm_b) / max(adm_o, 1) < 0.05


# --- lockstep against the JAX engine's mesh -----------------------------------------


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mesh_stream(lib):
    """Six flushes on an 8-shard mesh engine through submit_many,
    submit_bulk, exits and traces: DEFAULT QPS and THREAD rules, an
    origin-split rule, a RELATE rule, breakers of two grades, prioritized
    entries, authority refusals. Every flush has the same padded shapes
    (64 entries, 16 exit ops, two rule slots, one breaker slot)."""
    eng, st_, C_ = lib.engine, lib.st, lib.C
    lib.config.set(lib.config.OCCUPY_TIMEOUT_MS, "1000")
    eng.enable_mesh(8)
    st_.flow_rule_manager.load_rules([
        st_.FlowRule("a", count=12), st_.FlowRule("a", grade=C_.FLOW_GRADE_THREAD, count=9),
        st_.FlowRule("b", count=6, limit_app=C_.LIMIT_APP_OTHER), st_.FlowRule("c", count=8),
        st_.FlowRule("r", count=10, strategy=C_.STRATEGY_RELATE, ref_resource="c"),
    ])
    st_.degrade_rule_manager.load_rules([
        st_.DegradeRule("c", grade=1, count=0.3, time_window=1, min_request_amount=3),
        st_.DegradeRule("a", grade=0, count=50, time_window=1, slow_ratio_threshold=0.5, min_request_amount=3),
    ])
    st_.authority_rule_manager.load_rules([st_.AuthorityRule("b", limit_app="evil", strategy=C_.AUTHORITY_BLACK)])
    rng = np.random.default_rng(12)
    out, held = [], []
    for step in range(6):
        t = 1000 + 400 * step
        lib.clock.set_ms(t)
        reqs = []
        for i in range(40):
            res = ["a", "b", "c", "r"][i % 4]
            req = {"resource": res, "ts": t - int(rng.integers(0, 300))}
            if res == "b":
                req["origin"] = ["o1", "o2", "evil"][int(rng.integers(0, 3))]
            if res in ("a", "c") and rng.random() < 0.2:
                req["prio"] = True
            reqs.append(req)
        ops = eng.submit_many(reqs)
        g = eng.submit_bulk("c", 24, ts=t)
        rows = [o.rows for o in held[:16]]
        for i in range(16):
            if i < len(rows):
                eng.submit_exit(rows[i], rt=int(rng.integers(1, 120)), err=int(rng.random() < 0.4), ts=t,
                                resource=held[i].resource)
            else:
                eng.submit_trace(ops[i].rows, count=1, ts=t)
        eng.flush()
        held = [o for o in ops if o.verdict.admitted and not o.verdict.wait_ms]
        out.append([(o.verdict.admitted, o.verdict.reason, o.verdict.wait_ms,
                     None if o.verdict.blocked_rule is None else o.verdict.blocked_rule.to_dict()) for o in ops])
        out.append([_np(g.admitted).tolist(), _np(g.reason).tolist(), _np(g.wait_ms).tolist()])
        out.append([eng.cluster_node_stats(r, flush=False) for r in ("a", "b", "c", "r")])
        out.append([_np(x).tolist() for x in eng.degrade_dyn])
    reasons = {v[1] for flush in out[0::4] for v in flush}
    assert {0, 1, 2, 4} <= reasons, reasons
    return out


@pytest.mark.mesh
def test_mesh_engine_lockstep_with_jax():
    run_on_both(_mesh_stream)


def test_make_mesh_and_unavailable_reason():
    from sentinel_tpu_torch.parallel import make_mesh, mesh_unavailable_reason

    assert make_mesh(8, "cpu") == (8, torch.device("cpu"))
    assert mesh_unavailable_reason(8, "cpu") is None
    assert "power of two" in mesh_unavailable_reason(6, "cpu")
    with pytest.raises(ValueError, match="power of two"):
        make_mesh(6, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        make_mesh(2, ["cpu", "meta"])
