"""The port's host pipeline (sentinel_tpu_torch/runtime/engine.py) against
the JAX engine's, on the CPU: flush_async and lazy materialization, the
depth-K flush, the encode arena, last_flush_host_ms, the auto-flusher,
Engine.reset and st.entry_async.

The lockstep streams run the JAX Engine and the port's Engine(device="cpu")
at the same pipeline depth (and the port at depth 0) on identical streams
with a rule reload while chunks are in flight, and require the verdicts,
wait_ms, attribution, stats, param state and blocked top-K to be equal bit
for bit after the queue drains. The cases of tests/test_flush_pipeline.py,
tests/test_engine_async.py, tests/test_engine_concurrency.py
(TestAutoFlush, TestLifecycle), tests/test_api.py::test_entry_async_detached
and tests/test_host_ingest.py::TestFastPathDifferentialSmoke follow on the
port. Shapes stay constant across flushes, so the JAX side compiles each
step once."""

import sys
import threading
import time

import jax
import numpy as np
import pytest

import sentinel_tpu as jst
import sentinel_tpu_torch as st
from sentinel_tpu.models import constants as JC
from sentinel_tpu.runtime.engine import Engine as JEngine
from sentinel_tpu.utils.clock import ManualClock as JClock
from sentinel_tpu.utils.config import config as jconfig
from sentinel_tpu_torch.core import api
from sentinel_tpu_torch.core.context import ContextUtil
from sentinel_tpu_torch.metrics.nodes import stats_to_numpy
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.rules.degrade_table import degrade_state_to_numpy
from sentinel_tpu_torch.rules.param_table import param_state_to_numpy
from sentinel_tpu_torch.runtime import engine as tengine_mod
from sentinel_tpu_torch.runtime.engine import Engine
from sentinel_tpu_torch.utils.clock import ManualClock
from sentinel_tpu_torch.utils.config import config

from test_torch_engine import _Pair, _assert_pinned, pinned_samplers  # noqa: F401 (fixture)
from torch_parity import assert_same, run_on_both

JAX_LIB = (jst, JC)
PORT_LIB = (st, C)


def _port(clock=None, depth=0, **kw):
    eng = Engine(clock=clock or ManualClock(0), device="cpu", **kw)
    eng.pipeline_depth = depth
    return eng


@pytest.fixture(autouse=True)
def _clean_config():
    yield
    config.reset()
    jconfig.reset()


# --- the lockstep stream: the twin of tests/test_flush_pipeline.py's ---------


def _load_rules(side, flow_count=6.0, param_count=3):
    eng, (lib, _) = side
    eng.set_flow_rules([lib.FlowRule("pp", count=flow_count), lib.FlowRule("qq", count=1e9)])
    eng.set_param_rules({"qq": [lib.ParamFlowRule("qq", param_idx=0, count=param_count)]})


def _run_stream(sides, set_ms, rng, rounds, reload_at=None, use_async=False):
    """tests/test_flush_pipeline.py's ``_run_stream`` over engines of both
    packages (``sides``: (engine, (package, constants)) pairs): the same
    random op stream (flow-limited bulk, mixed-ts hot-param bulk, deferred
    singles, bulk exits) through every engine, flushing each per round
    without reading a verdict; returns (bulk groups, single ops) per
    engine after every queue drained."""
    collected = [([], []) for _ in sides]
    t = 1000
    for r in range(rounds):
        set_ms(t)
        n_pp = 16
        ts_pp = t + rng.integers(0, 40, n_pp).astype(np.int32)
        ts_pp.sort()
        acq_pp = rng.integers(1, 3, n_pp).astype(np.int32)
        n_qq = 12
        vals = [f"v{int(rng.integers(0, 3))}" for _ in range(n_qq)]
        ts_qq = np.where(np.arange(n_qq) < rng.integers(1, n_qq), np.int32(t), np.int32(t + 700)).astype(np.int32)
        singles = [{"resource": "qq", "ts": int(t + rng.integers(0, 50)), "args": (f"v{int(rng.integers(0, 3))}",)}
                   for _ in range(4)]
        for (eng, (_, lc)), (groups, ops) in zip(sides, collected):
            g1 = eng.submit_bulk("pp", n_pp, ts=ts_pp, acquire=acq_pp)
            g2 = eng.submit_bulk("qq", n_qq, ts=ts_qq, args_column=[(v,) for v in vals])
            ops.extend(eng.submit_many([dict(s) for s in singles]))
            rows = eng.resolve_entry_rows("pp", lc.CONTEXT_DEFAULT_NAME, "", lc.EntryType.OUT)
            eng.submit_exit_bulk(rows, 4, rt=10, ts=np.full(4, t, np.int32))
            if use_async:
                eng.flush_async()
                assert len(eng._pending_fetches) <= eng.max_inflight
            else:
                eng.flush()
                assert len(eng._pending_fetches) <= eng.pipeline_depth
            groups.extend([g1, g2])
        if reload_at is not None and r == reload_at:
            # Reload while chunks are in flight: each record keeps the
            # index snapshot it was dispatched with.
            for side in sides:
                _load_rules(side, flow_count=4.0, param_count=2)
        t += int(rng.integers(100, 900))
    for eng, _ in sides:
        eng.drain()
        assert not eng._pending_fetches
    return collected


def _rule_dict(v):
    return None if v.blocked_rule is None else v.blocked_rule.to_dict()


def _assert_same_streams(ref, other, what):
    (rg, ro), (og, oo) = ref, other
    assert len(rg) == len(og) and len(ro) == len(oo)
    for i, (a, b) in enumerate(zip(rg, og)):
        for name in ("admitted", "reason", "wait_ms"):
            assert_same(np.asarray(getattr(a, name)), getattr(b, name), f"{what}: group {i} {name}")
    for i, (a, b) in enumerate(zip(ro, oo)):
        assert (a is None) == (b is None)
        if a is None:
            continue
        va, vb = a.verdict, b.verdict
        assert (va.admitted, va.reason, va.wait_ms, va.limit_type, _rule_dict(va)) == (
            vb.admitted, vb.reason, vb.wait_ms, vb.limit_type, _rule_dict(vb)), f"{what}: single {i}"


@pytest.mark.parametrize("mode", ["depth1", "depth2", "async"])
def test_pipelined_stream_matches_jax_and_depth0(mode):
    """The port at depth 1 or 2, or through flush_async, against the JAX
    engine run the same way and against the port at depth 0, across a
    reload at round 2: verdicts, wait_ms, attribution, stats, param state,
    node stats and the last blocked top-K."""
    depth = {"depth1": 1, "depth2": 2, "async": 0}[mode]
    jclock, tclock, t0clock = JClock(0), ManualClock(0), ManualClock(0)
    j = JEngine(clock=jclock)
    j.pipeline_depth = depth
    j_topk = []
    j._fold_blocked_sketch = lambda rows, w: j_topk.append((np.asarray(rows), np.asarray(w)))
    t = _port(tclock, depth)
    t0 = _port(t0clock, 0)
    sides = [(j, JAX_LIB), (t, PORT_LIB), (t0, PORT_LIB)]
    for side in sides:
        _load_rules(side)

    def set_ms(ms):
        for c in (jclock, tclock, t0clock):
            c.set_ms(ms)

    collected = _run_stream(sides, set_ms, np.random.default_rng(depth + 7), rounds=5, reload_at=2,
                            use_async=mode == "async")
    _assert_same_streams(collected[0], collected[1], f"{mode}: JAX vs port")
    _assert_same_streams(collected[2], collected[1], f"{mode}: port depth 0 vs port")
    assert_same(jax.device_get(j.stats), stats_to_numpy(t.stats), "stats")
    assert_same(jax.device_get(j.param_dyn), param_state_to_numpy(t.param_dyn), "param state")
    assert_same(stats_to_numpy(t0.stats), stats_to_numpy(t.stats), "stats at depth 0")
    assert_same(j_topk[-1][0], t.last_blocked_topk[0], "blk_rows")
    assert_same(j_topk[-1][1], t.last_blocked_topk[1], "blk_weight")
    assert any(w.max() > 0 for _, w in j_topk), "the stream must block something"
    for res in ("pp", "qq"):
        assert j.cluster_node_stats(res) == t.cluster_node_stats(res) == t0.cluster_node_stats(res), res
    assert t.pipeline_stats() == j.pipeline_stats()
    if mode == "depth2":
        # The first flush samples 1 in flight, the other four 2.
        assert t.pipeline_stats() == {"dispatches": 5.0, "mean_inflight": 1.8}


def test_chain_stream_at_depth2(pinned_samplers):
    """The slot chain (breakers, a system config, authority rules,
    prioritized entries that borrow) at depth 2 on both engines and at
    depth 0 on the port. The slab horizon is set at dispatch: after every
    flush it equals the depth-0 engine's. Exits come from entries three
    flushes back, whose verdicts the depth-2 trim has already filled."""
    _assert_pinned(pinned_samplers)
    config.set(config.OCCUPY_TIMEOUT_MS, "1000")
    jconfig.set(jconfig.OCCUPY_TIMEOUT_MS, "1000")
    rng = np.random.default_rng(31)
    now = 20_000
    pair = _Pair(now, chain=True)
    ref = _Pair(now, chain=True)  # its port engine runs at depth 0
    pair.j.pipeline_depth = pair.t.pipeline_depth = 2
    engines = (pair.j, pair.t, ref.t)
    clocks = (pair.jclock, pair.tclock, ref.tclock)
    ops = []  # per step: (singles per engine, groups per engine)
    resources = ["A", "B", "C", "D", "E", "F"]
    for step in range(16):
        now += int(rng.choice([0, 40, 180, 420, 700, 1300]))
        for c in clocks:
            c.set_ms(now)
        specs = [(str(rng.choice(resources)), "ctx1" if rng.random() < 0.3 else C.CONTEXT_DEFAULT_NAME,
                  str(rng.choice(["", "appX", "appY"])), int(rng.integers(1, 3)), bool(rng.random() < 0.6),
                  bool(rng.random() < 0.4), max(now - int(rng.integers(0, 60)), 0)) for _ in range(8)]
        n = 32
        ts = np.sort(now - rng.integers(0, 300, n)).astype(np.int32)
        acq = rng.integers(1, 3, n).astype(np.int32)
        g_res = str(rng.choice(resources))
        origin = str(rng.choice(["", "appX", "appY"]))
        step_ops = []
        for eng, lc in zip(engines, (JC, C, C)):
            singles = [eng.submit_entry(res, context_name=ctx, origin=org, acquire=acq1,
                                        entry_type=lc.EntryType.IN if inb else lc.EntryType.OUT, prio=prio, ts=t1)
                       for res, ctx, org, acq1, inb, prio, t1 in specs]
            group = eng.submit_bulk(g_res, n, ts=ts, acquire=acq, origin=origin, entry_type=lc.EntryType.IN)
            step_ops.append((singles, group))
        if step >= 3:
            rt = int(rng.integers(0, 90))
            for eng, (singles, group) in zip(engines, ops[step - 3]):
                for i, o in enumerate(singles):
                    if o is not None and o.verdict.admitted:
                        eng.submit_exit(o.rows, rt=int(5 + 85 * (i % 2)), count=1, err=int(i % 3 == 0), ts=now,
                                        resource=o.resource)
                k = int(group.admitted_count)
                if k:
                    eng.submit_exit_bulk(group.rows, k, rt=rt, err=(np.arange(k) % 4 == 0).astype(np.int32), ts=now,
                                         resource=group.resource)
        ops.append(step_ops)
        for eng in engines:
            eng.flush()
        assert len(pair.t._pending_fetches) == 2 or step < 1
        assert pair.t._slab_horizon == ref.t._slab_horizon, step
    for eng in engines:
        eng.drain()
    borrowed = 0
    for step, step_ops in enumerate(ops):
        (js, jg), (ts_, tg), (rs, rg) = step_ops
        for a, b, c0 in zip(js, ts_, rs):
            va, vb, vc = a.verdict, b.verdict, c0.verdict
            rec = [(v.admitted, v.reason, v.wait_ms, v.limit_type, _rule_dict(v)) for v in (va, vb, vc)]
            assert rec[0] == rec[1] == rec[2], step
            borrowed += va.wait_ms > 0
        for name in ("admitted", "reason", "wait_ms"):
            assert_same(np.asarray(getattr(jg, name)), getattr(tg, name), f"{step}: bulk {name}")
            assert_same(getattr(rg, name), getattr(tg, name), f"{step}: bulk {name} at depth 0")
    assert borrowed > 0, "no prioritized entry borrowed"
    assert_same(jax.device_get(pair.j.stats), stats_to_numpy(pair.t.stats), "stats")
    assert_same(stats_to_numpy(ref.t.stats), stats_to_numpy(pair.t.stats), "stats at depth 0")
    assert_same(jax.device_get(pair.j.degrade_dyn), degrade_state_to_numpy(pair.t.degrade_dyn), "breakers")
    assert_same(degrade_state_to_numpy(ref.t.degrade_dyn), degrade_state_to_numpy(pair.t.degrade_dyn),
                "breakers at depth 0")


SKETCH_CONFIG = {
    "sentinel.tpu.sketch.enabled": "true",
    "sentinel.tpu.sketch.promote.qps": "5",
    "sentinel.tpu.sketch.resource.qps": "50",
    "sentinel.tpu.sketch.window.ms": "1000",
    "sentinel.tpu.sketch.demote.windows": "2",
}


def test_sketch_promotions_at_depth2():
    """The sketch tier at depth 2: the candidate table rides each chunk's
    copy back, and the controller runs at materialization, FIFO. The port
    at depth 2 equals the JAX engine at depth 2 (verdicts, promotions) and
    promotes what the port at depth 0 promotes."""
    for key, value in SKETCH_CONFIG.items():
        config.set(key, value)
        jconfig.set(key, value)
    jclock, tclock, t0clock = JClock(1000), ManualClock(1000), ManualClock(1000)
    j = JEngine(clock=jclock)
    t = _port(tclock, 2)
    t0 = _port(t0clock, 0)
    j.pipeline_depth = 2
    engines = ((j, jst), (t, st), (t0, st))
    for eng, lib in engines:
        assert eng.sketch.armed
        eng.set_param_rules({"api": [lib.ParamFlowRule(resource="api", param_idx=0, count=3.0, sketch_mode=True)]})
    hot = [f"hot{i}" for i in range(16)]
    groups = []
    uid = 0
    for step in range(12):
        col = [(f"v{uid + i}",) for i in range(96)] + [(h,) for h in hot for _ in range(4)]
        uid += 96
        groups.append([eng.submit_bulk("api", n=len(col), args_column=col) for eng, _ in engines])
        for eng, _ in engines:
            eng.flush()
        for c in (jclock, tclock, t0clock):
            c.advance(250)
    for eng, _ in engines:
        eng.flush()  # empty: settles the queue; the controller's actions queue
        eng.flush()  # and land here
    for step, (gj, gt, _) in enumerate(groups):
        for name in ("admitted", "reason", "wait_ms"):
            assert_same(np.asarray(getattr(gj, name)), getattr(gt, name), f"{step}: bulk {name}")
    promoted = t.sketch.promoted_values.get("api", frozenset())
    assert set(hot) <= promoted
    assert j.sketch.promoted_values == t.sketch.promoted_values == t0.sketch.promoted_values
    assert j.sketch.candidates_snapshot(64) == t.sketch.candidates_snapshot(64)
    assert_same(jax.device_get(j.stats), stats_to_numpy(t.stats), "stats")


# --- flush_async: the cases of tests/test_engine_async.py ----------------------


def _engine(rules, clock=None, **kw):
    eng = _port(clock or ManualClock(0), **kw)
    eng.set_flow_rules(rules)
    return eng


def test_flush_async_defers_and_materializes_on_access():
    clock = ManualClock(1000)
    eng = _engine([st.FlowRule("r", count=50)], clock)
    ops = [eng.submit_entry("r", ts=clock.now_ms()) for _ in range(100)]
    assert len(eng.flush_async()) == 100
    assert ops[0]._verdict is None
    assert len(eng._pending_fetches) == 1
    assert ops[0].verdict is not None  # the first read materializes the whole chunk
    assert all(o._verdict is not None and o._pending is None for o in ops)
    assert len(eng._pending_fetches) == 0
    assert sum(o.verdict.admitted for o in ops) == 50


def test_bulk_async_lazy_arrays():
    clock = ManualClock(1000)
    eng = _engine([st.FlowRule("r", count=30)], clock)
    g = eng.submit_bulk("r", 100, ts=clock.now_ms())
    eng.flush_async()
    assert g._admitted is None
    assert g.admitted_count == 30
    assert g._admitted is not None and g._reason is not None and g._wait_ms is not None
    assert int((~g.admitted).sum()) == 70


def test_drain_and_sync_flush_materialize_everything():
    clock = ManualClock(1000)
    eng = _engine([st.FlowRule("r", count=10)], clock)
    o1 = [eng.submit_entry("r", ts=clock.now_ms()) for _ in range(20)]
    eng.flush_async()
    eng.drain()
    assert all(o._verdict is not None for o in o1)
    o2 = [eng.submit_entry("r", ts=clock.now_ms()) for _ in range(20)]
    eng.flush_async()
    o3 = [eng.submit_entry("r", ts=clock.now_ms()) for _ in range(5)]
    eng.flush()  # settles the async dispatch first
    assert all(o._verdict is not None for o in o2 + o3)
    assert sum(o.verdict.admitted for o in o1 + o2 + o3) == 10


def test_inflight_bound_fifo():
    clock = ManualClock(1000)
    eng = _engine([st.FlowRule("r", count=1e9)], clock)
    eng.max_inflight = 2
    groups = []
    for _ in range(5):
        groups.append(eng.submit_bulk("r", 64, ts=clock.now_ms()))
        eng.flush_async()
    assert len(eng._pending_fetches) == 2
    assert all(g._admitted is not None for g in groups[:3])
    assert all(g._admitted is None for g in groups[3:])
    eng.drain()
    assert all(g.admitted_count == 64 for g in groups)


def _random_stream_verdicts(make, async_mode):
    """tests/test_engine_async.py's random stream: entries on three rules
    (one THREAD grade) and a breaker, flushed every seventh op, exits of
    earlier admitted ops every eleventh."""
    eng, lib, clock = make()
    rng = np.random.default_rng(42)
    stream = []
    t = 1000
    for _ in range(300):
        t += int(rng.integers(0, 40))
        stream.append((str(rng.choice(["a", "b", "c"])), t))
    eng.set_flow_rules([lib.FlowRule(resource="a", count=7), lib.FlowRule(resource="b", count=3, grade=0),
                        lib.FlowRule(resource="c", count=20)])
    eng.set_degrade_rules([lib.DegradeRule(resource="a", grade=1, count=0.5, time_window=5)])
    ops = []
    for i, (res, ts) in enumerate(stream):
        clock.set_ms(ts)
        ops.append(eng.submit_entry(res, ts=ts))
        if i % 7 == 3:
            eng.flush_async() if async_mode else eng.flush()
        if i % 11 == 5:
            o = ops[int(rng.integers(0, len(ops)))]
            if o is not None and o.verdict is not None and o.verdict.admitted:
                eng.submit_exit(o.rows, ts=ts, count=1, rt=5)
    if async_mode:
        eng.flush_async()
        eng.drain()
    else:
        eng.flush()
    return [(o.verdict.admitted, o.verdict.reason, o.verdict.wait_ms) for o in ops if o is not None]


def test_async_equals_sync_on_random_stream():
    """The same stream through flush_async and through sync flushes on the
    port, and through flush_async on the JAX engine: identical verdicts."""
    def port():
        clock = ManualClock(0)
        return _port(clock), st, clock

    def jax_engine():
        clock = JClock(0)
        return JEngine(clock=clock), jst, clock

    sync = _random_stream_verdicts(port, False)
    assert _random_stream_verdicts(port, True) == sync
    assert _random_stream_verdicts(jax_engine, True) == sync


def test_reload_between_dispatch_and_materialize_keeps_attribution():
    clock = ManualClock(1000)
    eng = _engine([st.FlowRule("r", count=0)], clock)
    op = eng.submit_entry("r", ts=clock.now_ms())
    eng.flush_async()
    eng.set_flow_rules([st.FlowRule("r", count=100)])
    v = op.verdict
    assert v is not None and not v.admitted
    assert v.blocked_rule is not None and v.blocked_rule.count == 0


def test_failed_fetch_raises_to_every_reader(monkeypatch):
    """A failed wait for the copy back surfaces on every later read of the
    chunk's verdicts, never as "nothing admitted"; the queue is not
    stranded, and no path retries the chunk."""
    clock = ManualClock(1000)
    eng = _engine([st.FlowRule("r", count=5)], clock)
    g = eng.submit_bulk("r", 16, ts=clock.now_ms())
    op = eng.submit_entry("r", ts=clock.now_ms())
    eng.flush_async()
    pooled = sum(len(v) for v in eng._arena._pool.values())

    def broken(refs, seqs):
        raise RuntimeError("copy back failed")

    monkeypatch.setattr(eng, "_fetch_refs", broken)
    with pytest.raises(RuntimeError, match="copy back failed"):
        eng.drain()
    with pytest.raises(RuntimeError, match="copy back failed"):
        g.admitted_count
    with pytest.raises(RuntimeError, match="copy back failed"):
        op.verdict
    assert g._admitted is None and op._verdict is None
    assert sum(len(v) for v in eng._arena._pool.values()) == pooled  # the failed chunk's staging is dropped
    monkeypatch.undo()
    g2 = eng.submit_bulk("r", 8, ts=clock.now_ms())
    eng.flush_async()
    assert g2.admitted_count == 0  # the failed chunk's entries were counted on the device
    eng.drain()


def test_reset_settles_pending_async_flushes(monkeypatch):
    """reset() settles the dispatched chunks first; a failed settle is
    logged and reset completes; readers of the old ops still see the
    failure, and post-reset flushes do not."""
    clock = ManualClock(1000)
    eng = _engine([st.FlowRule("r", count=0)], clock)
    ops = [eng.submit_entry("r", ts=clock.now_ms()) for _ in range(4)]
    eng.flush_async()
    eng.reset()
    assert all(o._verdict is not None and not o._verdict.admitted for o in ops)
    assert len(eng._pending_fetches) == 0
    op = eng.submit_entry("r", ts=clock.now_ms())
    eng.flush()
    assert op.verdict.admitted  # the count=0 rule was cleared by reset

    eng2 = _engine([st.FlowRule("q", count=5)], clock)
    op2 = eng2.submit_entry("q", ts=clock.now_ms())
    eng2.flush_async()
    monkeypatch.setattr(eng2, "_fill_results", lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("wedged")))
    eng2.reset()  # logs, does not raise
    monkeypatch.undo()
    op3 = eng2.submit_entry("q", ts=clock.now_ms())
    eng2.flush()
    assert op3.verdict is not None
    with pytest.raises(RuntimeError, match="wedged"):
        op2.verdict


def test_flush_async_on_empty_engine_is_noop():
    eng = _engine([st.FlowRule("r", count=5)])
    assert eng.flush_async() == []
    assert len(eng._pending_fetches) == 0
    assert eng.pipeline_stats()["dispatches"] == 0.0
    eng.drain()


def test_flush_async_on_mesh_conserves_budget():
    """The sharded step dispatched the same way: 128 same-window entries
    against count 20 over 8 shards admit 20, lazily."""
    clock = ManualClock(1000)
    eng = _engine([st.FlowRule("r", count=20)], clock)
    eng.enable_mesh(8)
    ops = [eng.submit_entry("r", ts=clock.now_ms()) for _ in range(128)]
    eng.flush_async()
    assert ops[0]._verdict is None
    assert sum(o.verdict.admitted for o in ops) == 20
    eng.drain()
    eng.disable_mesh()


def test_async_pipeline_under_thread_contention():
    """Two submitters dispatching flush_async and a reader materializing
    concurrently, with a short switch interval: no deadlock, exact totals."""
    clock = ManualClock(1000)
    eng = _engine([st.FlowRule("r", count=1e9)], clock)
    groups = []
    glock = threading.Lock()
    stop = threading.Event()
    errors = []

    def submitter():
        try:
            while not stop.is_set():
                g = eng.submit_bulk("r", 32, ts=clock.now_ms())
                with glock:
                    groups.append(g)
                eng.flush_async()
        except Exception as exc:  # reported below
            errors.append(exc)

    def reader():
        try:
            while not stop.is_set():
                with glock:
                    g = groups[-1] if groups else None
                if g is not None:
                    g.admitted_count
        except Exception as exc:
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        threads = [threading.Thread(target=submitter) for _ in range(2)] + [threading.Thread(target=reader)]
        for th in threads:
            th.start()
        time.sleep(1.0)
        stop.set()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive(), "deadlocked thread"
    finally:
        sys.setswitchinterval(old)
    assert not errors
    eng.drain()
    assert groups and all(g.admitted_count == 32 for g in groups)
    assert eng.cluster_node_stats("r")["total_pass_minute"] == 32 * len(groups)


# --- the mechanics of tests/test_flush_pipeline.py::TestPipelineMechanics ----


def test_flush_settles_queue_fifo():
    clock = ManualClock(1000)
    eng = _engine([st.FlowRule("ff", count=8)], clock, depth=1)
    g1 = eng.submit_bulk("ff", 8, ts=np.full(8, 1000, np.int32))
    eng.flush()
    assert g1._admitted is None
    g2 = eng.submit_bulk("ff", 8, ts=np.full(8, 1000, np.int32))
    eng.flush()
    assert g1._admitted is not None and g2._admitted is None
    assert g1.admitted_count == 8
    assert g2.admitted_count == 0
    assert len(eng._pending_fetches) == 0
    assert eng.pipeline_stats() == {"dispatches": 2.0, "mean_inflight": 1.0}
    assert eng.pipeline_stats(reset=True)["dispatches"] == 2.0
    assert eng.pipeline_stats() == {"dispatches": 0.0, "mean_inflight": 0.0}


def test_verdict_buffers_do_not_alias_across_inflight():
    """Three chunks in flight share pooled staging; the verdict arrays
    share no memory with each other or with any pooled staging set."""
    clock = ManualClock(1000)
    eng = _engine([st.FlowRule("al", count=10)], clock, depth=3)
    groups = []
    for _ in range(3):
        groups.append(eng.submit_bulk("al", 8, ts=np.full(8, 1000, np.int32)))
        eng.flush()
    assert len(eng._pending_fetches) == 3
    eng.drain()
    # A fourth flush reuses a pooled set: the earlier verdicts stay as filled.
    g4 = eng.submit_bulk("al", 8, ts=np.full(8, 1000, np.int32))
    eng.flush()
    eng.drain()
    assert eng._arena.hits >= 1
    arrays = [a for g in groups + [g4] for a in (g.admitted, g.reason, g.wait_ms)]
    for i, a in enumerate(arrays):
        for b in arrays[i + 1:]:
            assert not np.shares_memory(a, b)
    for sets in eng._arena._pool.values():
        for bufs in sets:
            views = list(bufs.views.values()) if hasattr(bufs, "views") else [bufs.numpy()]
            for buf in views:
                for a in arrays:
                    assert not np.shares_memory(a, buf)
    assert [g.admitted_count for g in groups + [g4]] == [8, 2, 0, 0]


def test_arena_sized_to_depth():
    eng = _port(depth=0)
    base = eng._arena.per_key
    eng.pipeline_depth = 7
    assert eng._arena.per_key >= 8 and eng._arena.per_key >= base
    eng.max_inflight = 11
    assert eng._arena.per_key >= 12


def test_empty_flush_settles_whole_queue():
    clock = ManualClock(1000)
    eng = _engine([st.FlowRule("ef", count=4)], clock, depth=2)
    g = eng.submit_bulk("ef", 8, ts=np.full(8, 1000, np.int32))
    eng.flush()
    assert len(eng._pending_fetches) == 1
    eng.flush()
    assert len(eng._pending_fetches) == 0
    assert g._admitted is not None and g.admitted_count == 4


def test_close_settles_pipeline():
    clock = ManualClock(1000)
    eng = _engine([st.FlowRule("cl", count=4)], clock, depth=2)
    g = eng.submit_bulk("cl", 8, ts=np.full(8, 1000, np.int32))
    eng.flush()
    eng.close()
    assert len(eng._pending_fetches) == 0
    assert g._admitted is not None and g.admitted_count == 4


def test_set_depth_drains_down_to_the_new_depth():
    """set_depth lowers the bound only after settling the excess, as the
    JAX engine does; raising it settles nothing."""
    def scenario(lib):
        eng = lib.engine
        eng.set_flow_rules([lib.st.FlowRule("sd", count=5)])
        eng.set_depth(3)
        groups = []
        for _ in range(3):
            groups.append(eng.submit_bulk("sd", 4, ts=np.full(4, 0, np.int32)))
            eng.flush()
        seen = [len(eng._pending_fetches), eng.has_pending()]
        eng.set_depth(1)
        seen += [eng.pipeline_depth, len(eng._pending_fetches), [g._admitted is not None for g in groups]]
        eng.set_depth(4)
        seen += [len(eng._pending_fetches), [g.admitted_count for g in groups]]
        return seen

    assert run_on_both(scenario) == [3, False, 1, 1, [True, True, False], 1, [4, 1, 0]]


def test_pipeline_config_is_read_at_construction():
    """An engine built under sentinel.tpu.host.pipeline.depth=2 and
    sentinel.tpu.flush.max.inflight=3 pipelines at depth 2, as the JAX
    engine built under the same keys does."""
    for cfg in (config, jconfig):
        cfg.set(cfg.PIPELINE_DEPTH, "2")
        cfg.set(cfg.FLUSH_MAX_INFLIGHT, "3")
    j = JEngine(clock=JClock(1000))
    fresh = Engine(clock=ManualClock(1000), device="cpu")
    assert (fresh.pipeline_depth, fresh.max_inflight) == (j.pipeline_depth, j.max_inflight) == (2, 3)
    fresh.set_flow_rules([st.FlowRule("pc", count=3)])
    gs = []
    for _ in range(3):
        gs.append(fresh.submit_bulk("pc", 2, ts=1000))
        fresh.flush()
    assert len(fresh._pending_fetches) == 2
    assert [g.admitted_count for g in gs] == [2, 1, 0]


# --- last_flush_host_ms --------------------------------------------------------


def test_last_flush_host_ms_keys_match_jax():
    j = JEngine(clock=JClock(1000))
    t = _port(ManualClock(1000))
    assert t.last_flush_host_ms == j.last_flush_host_ms == {
        "encode_ms": 0.0, "dispatch_ms": 0.0, "kernel_ms": 0.0, "drain_ms": 0.0}
    t.set_flow_rules([st.FlowRule("h", count=5)])
    t.submit_bulk("h", 16, ts=1000)
    t.flush()
    got = t.last_flush_host_ms
    assert set(got) == set(j.last_flush_host_ms)
    assert got["encode_ms"] > 0 and got["dispatch_ms"] > 0
    assert got["kernel_ms"] >= got["dispatch_ms"] and got["drain_ms"] == 0.0
    got["encode_ms"] = -1.0  # a snapshot copy
    assert t.last_flush_host_ms["encode_ms"] > 0


def test_empty_flush_keeps_the_breakdown():
    t = _engine([st.FlowRule("h", count=5)], ManualClock(1000))
    t.submit_bulk("h", 16, ts=1000)
    t.flush()
    before = t.last_flush_host_ms
    t.flush()
    t.flush_async()
    assert t.last_flush_host_ms == before


def test_drain_ms_accumulates():
    """A deferred flush counts its dispatch in kernel_ms; the waits of the
    chunks that materialize later add to drain_ms of the breakdown
    current then."""
    t = _engine([st.FlowRule("h", count=5)], ManualClock(1000), depth=3)
    for _ in range(3):
        t.submit_bulk("h", 16, ts=1000)
        t.flush()
    split = t.last_flush_host_ms
    assert split["drain_ms"] == 0.0 and split["kernel_ms"] == pytest.approx(split["dispatch_ms"])
    t.drain()
    assert t.last_flush_host_ms["drain_ms"] > 0
    g = t.submit_bulk("h", 16, ts=1000)
    t.flush()
    assert t.last_flush_host_ms["drain_ms"] == 0.0  # a new breakdown
    g.admitted  # the read materializes the chunk
    assert t.last_flush_host_ms["drain_ms"] > 0


# --- the auto-flusher: TestAutoFlush and TestLifecycle ---------------------


@pytest.fixture
def tengine():
    clock = ManualClock(0)
    api.reset(clock=clock, device="cpu")
    eng = api.get_engine()
    yield eng
    eng.close()
    api.reset(device="cpu")


def test_auto_flush_decides_pending_ops(tengine):
    tengine.set_flow_rules([st.FlowRule("af", count=100)])
    tengine.start_auto_flush(interval_ms=5)
    try:
        op = tengine.submit_entry("af")
        deadline = time.monotonic() + 5.0
        while op._verdict is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert op.verdict is not None and op.verdict.admitted
    finally:
        tengine.stop_auto_flush()


def test_auto_flush_idempotent_start_stop(tengine):
    tengine.start_auto_flush(interval_ms=5)
    tengine.start_auto_flush(interval_ms=5)  # no second thread
    assert tengine._auto_flush_thread is not None
    tengine.stop_auto_flush()
    assert tengine._auto_flush_thread is None
    tengine.stop_auto_flush()  # no-op
    assert not tengine.closed_dirty


def test_auto_flush_restart_with_new_interval(tengine):
    tengine.start_auto_flush(interval_ms=5)
    t1 = tengine._auto_flush_thread
    tengine.start_auto_flush()  # no interval: no-op
    assert tengine._auto_flush_thread is t1
    tengine.start_auto_flush(interval_ms=50)  # explicit: restart
    assert tengine._auto_flush_thread is not t1
    assert tengine._auto_flush_interval_s == pytest.approx(0.050)
    t2 = tengine._auto_flush_thread
    tengine.start_auto_flush(interval_ms=50)
    assert tengine._auto_flush_thread is t2
    tengine.start_auto_flush(interval_ms=0)  # clamped, not a busy spin
    assert tengine._auto_flush_interval_s == pytest.approx(1e-4)
    tengine.stop_auto_flush()
    assert not t1.is_alive() and not t2.is_alive()


def test_auto_flush_concurrent_explicit_intervals(tengine):
    ivs = [3, 7, 11, 13]
    threads = [threading.Thread(target=tengine.start_auto_flush, kwargs={"interval_ms": iv}) for iv in ivs]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    assert tengine._auto_flush_thread is not None
    assert tengine._auto_flush_interval_s in [iv / 1000.0 for iv in ivs]
    tengine.start_auto_flush(interval_ms=29)
    assert tengine._auto_flush_interval_s == pytest.approx(0.029)
    tengine.stop_auto_flush()
    assert sum(th.name == "sentinel-auto-flush" and th.is_alive() for th in threading.enumerate()) == 0


def test_auto_flush_with_concurrent_submitters(tengine):
    """The flusher racing threaded bulk and singles submitters, at depth 2:
    every op decided, the admitted total equals the submitted total."""
    tengine.set_flow_rules([st.FlowRule("c", count=1e9)])
    tengine.pipeline_depth = 2
    tengine.start_auto_flush(interval_ms=1)
    errs, groups, ops_all = [], [], []
    lock = threading.Lock()

    def worker(i):
        try:
            for _ in range(10):
                if i % 2 == 0:
                    g = tengine.submit_bulk("c", 50)
                    with lock:
                        groups.append(g)
                else:
                    ops = tengine.submit_many([{"resource": "c"} for _ in range(20)])
                    with lock:
                        ops_all.extend(ops)
        except Exception as exc:  # reported below
            errs.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    tengine.flush()
    tengine.stop_auto_flush()
    tengine.drain()
    assert not errs
    assert all(op.verdict is not None for op in ops_all)
    total = sum(g.n for g in groups) + len(ops_all)
    admitted = sum(g.admitted_count for g in groups) + sum(op.verdict.admitted for op in ops_all)
    assert admitted == total
    assert tengine.cluster_node_stats("c")["total_pass_minute"] == total


def test_auto_flush_matches_jax():
    """start_auto_flush / stop_auto_flush on both packages: the flusher
    decides a queued entry with no caller flushing, keeps its cadence on a
    bare restart, takes a new explicit one, and is gone after the stop."""
    def scenario(lib):
        eng = lib.engine
        eng.set_flow_rules([lib.st.FlowRule("am", count=1)])
        eng.start_auto_flush(interval_ms=5)
        first = eng._auto_flush_thread
        ops = [eng.submit_entry("am", ts=0) for _ in range(3)]
        deadline = time.monotonic() + 10.0
        while any(o._verdict is None for o in ops) and time.monotonic() < deadline:
            time.sleep(0.01)
        eng.start_auto_flush()
        seen = [eng._auto_flush_thread is first, eng._auto_flush_interval_s]
        eng.start_auto_flush(interval_ms=20)
        seen += [eng._auto_flush_thread is first, eng._auto_flush_interval_s, eng.has_pending()]
        eng.stop_auto_flush()
        seen += [eng._auto_flush_thread is None, first.is_alive(), eng.closed_dirty,
                 [(o.verdict.admitted, o.verdict.reason) for o in ops]]
        return seen

    assert run_on_both(scenario) == [True, 0.005, False, 0.02, False, True, False, False,
                                     [(True, 0), (False, 1), (False, 1)]]


def test_reset_stops_old_auto_flusher(tengine):
    """api.reset() ends the old engine's flusher through close(), and the op
    queued behind the stopped flusher is decided."""
    tengine.set_flow_rules([st.FlowRule("rs", count=1e9)])
    tengine.start_auto_flush(interval_ms=5)
    old_thread = tengine._auto_flush_thread
    assert old_thread is not None and old_thread.is_alive()
    tengine.stop_auto_flush()
    tengine.start_auto_flush(interval_ms=3_600_000)  # never ticks
    queued = tengine.submit_entry("rs")
    api.reset(clock=tengine.clock, device="cpu")
    assert queued.verdict is not None and queued.verdict.admitted
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and old_thread.is_alive():
        time.sleep(0.02)
    assert not old_thread.is_alive()
    assert not any(th.name == "sentinel-auto-flush" and th.is_alive() for th in threading.enumerate())


def test_close_quiesces_and_decides(tengine):
    tengine.set_flow_rules([st.FlowRule("lc", count=1e9)])
    tengine.pipeline_depth = 2
    tengine.start_auto_flush(interval_ms=50)
    ops = [tengine.submit_entry("lc") for _ in range(5)]
    tengine.close()
    assert tengine._auto_flush_thread is None
    assert not tengine._pending_fetches
    assert all(op._verdict is not None and op._verdict.admitted for op in ops)
    tengine.close()  # idempotent
    op = tengine.submit_entry("lc")
    tengine.flush()
    assert op.verdict.admitted


# --- reset, entry_async, the fast path -------------------------------------


def test_reset_matches_jax():
    """Engine.reset on both packages after pipelined traffic: pending chunks
    settle, the queue and every table are cleared, stats start from zero at
    the same row count, and the next entries decide under no rules."""
    def scenario(lib):
        eng = lib.engine
        eng.pipeline_depth = 2
        eng.set_flow_rules([lib.st.FlowRule("rr", count=2)])
        lib.st.system_rule_manager.load_rules([lib.st.SystemRule(qps=1000)])
        g = eng.submit_bulk("rr", 6, ts=np.full(6, 0, np.int32))
        eng.flush()
        queued = eng.submit_entry("rr", ts=0)  # still queued at reset: dropped
        rows = eng.stats.second.counts.shape[0]
        eng.reset()
        seen = [g._admitted is not None, g.admitted_count, len(eng._pending_fetches), eng.has_pending(),
                queued._verdict is None, eng.flow_index.get_rules(), eng.system_config, len(eng.nodes),
                eng.stats.second.counts.shape[0] == rows]
        g2 = eng.submit_bulk("rr", 6, ts=np.full(6, 0, np.int32))
        eng.flush()
        eng.drain()
        seen += [g2.admitted_count, eng.cluster_node_stats("rr")]
        return seen

    got = run_on_both(scenario)
    assert got[:5] == [True, 2, 0, False, True] and got[9] == 6


def test_entry_async_detached():
    """st.entry_async: the Entry stays off the context's stack and can exit
    from anywhere; a blocked one raises (tests/test_api.py)."""
    def scenario(lib):
        lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("blocked-res", count=0)])
        e = lib.st.entry_async("async-res")
        ctx = ContextUtil.get_context() if lib.st is st else None
        seen = [e.context is None, ctx is None or e not in ctx.entry_stack]
        e.exit()
        seen.append(lib.engine.cluster_node_stats("async-res")["success_qps"])
        try:
            lib.st.entry_async("blocked-res")
            seen.append("pass")
        except lib.st.BlockError as exc:
            seen.append(type(exc).__name__)
        return seen

    assert run_on_both(scenario) == [True, True, 1.0, "FlowBlockError"]
    assert st.entry_async is api.entry_async


@pytest.mark.parametrize("depth", [0, 2])
def test_fast_path_differential(depth):
    """The fast path (encode arena, value intern cache; the default) and
    the exact path (sentinel.tpu.host.fastpath=false: a fresh staging set
    per chunk, never pooled) give identical verdicts on heavy-hitter
    param traffic, across a param-rule reload."""
    clock = ManualClock(0)
    route = "smoke_route"
    prules = {route: [st.ParamFlowRule(route, param_idx=0, count=3)]}
    fast = _port(clock, depth)
    fast.set_flow_rules([st.FlowRule(route, count=1e9)])
    fast.set_param_rules(prules)
    config.set(config.HOST_FASTPATH, "false")
    try:
        slow = _port(clock, depth)
        slow.set_flow_rules([st.FlowRule(route, count=1e9)])
        slow.set_param_rules(prules)
    finally:
        config.reset()
    assert slow._arena is None and fast._arena is not None
    assert fast.param_index._use_value_cache and not slow.param_index._use_value_cache
    rng = np.random.default_rng(7)
    t = 1000
    pairs = []
    for round_no in range(6):
        clock.set_ms(t)
        n = int(rng.integers(16, 64))
        hot = [f"10.0.0.{h}" for h in range(3)]
        ips = [hot[int(rng.integers(0, 3))] if rng.random() < 0.8
               else f"10.9.{int(rng.integers(0, 256))}.{int(rng.integers(0, 256))}" for _ in range(n)]
        ts = np.full(n, t, dtype=np.int32)
        pairs.append([eng.submit_bulk(route, n, ts=ts, args_column=[(ip,) for ip in ips]) for eng in (fast, slow)])
        for eng in (fast, slow):
            eng.flush()
        if round_no == 1:
            for eng in (fast, slow):
                eng.set_param_rules(prules)
        t += int(rng.integers(50, 400))
    for eng in (fast, slow):
        eng.drain()
    for round_no, (gf, gs) in enumerate(pairs):
        assert gf.admitted.tolist() == gs.admitted.tolist(), f"fast/exact divergence in round {round_no}"
        assert gf.reason.tolist() == gs.reason.tolist()
    assert fast._arena.hits > 0
    assert_same(stats_to_numpy(fast.stats), stats_to_numpy(slow.stats), "stats")


def test_staging_views_and_upload_on_cpu():
    """On the CPU the batch tensors are views of the staging buffer (the
    zero-copy hazard the arena rule covers); each column starts on a
    256-byte boundary."""
    cols = (("a", np.dtype(np.bool_), (5,)), ("b", np.dtype(np.int32), (3, 4)))
    stg = tengine_mod._StagingSet(cols, pinned=False)
    stg.views["a"][:] = [True, False, True, False, True]
    stg.views["b"][:] = np.arange(12).reshape(3, 4)
    dev = stg.upload(stg.host.device)
    assert dev["a"].tolist() == [True, False, True, False, True]
    assert dev["b"].tolist() == np.arange(12).reshape(3, 4).tolist()
    assert dev["b"].data_ptr() - stg.host.data_ptr() == 256
    assert np.shares_memory(stg.views["b"], dev["b"].numpy())
