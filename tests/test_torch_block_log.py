"""The port's block log, metric extensions and breaker state-change
observers against the JAX package's, on lockstep streams: the
``sentinel-block.log`` lines (singles with each rule's limit app, bulk
groups by first failing slot, the valve's sheds, degraded fills), the
cluster stat log's file sink, every extension call, and every observer
event (trips, probes, recoveries; a reload starts a fresh epoch)."""

import os
import tempfile

import numpy as np
import pytest

from sentinel_tpu.metrics import block_log as jbl
from sentinel_tpu_torch.metrics import block_log as tbl

from torch_lockstep import run_lockstep


def _pkg(lib, mod):
    pkg = "sentinel_tpu_torch" if lib.name == "port" else "sentinel_tpu"
    return __import__(f"{pkg}.{mod}", fromlist=["x"])


def test_block_logger_files_match_jax():
    """The logger alone: per-second aggregation, the key cap, the roll to
    shifted backups, maybe_flush, and the lines read back, byte for byte."""
    out = {}
    for name, mod in (("jax", jbl), ("port", tbl)):
        d = tempfile.mkdtemp(prefix=f"bl-{name}-")
        lg = mod.BlockLogger(base_dir=d, max_entry_count=5, max_file_size=300, max_backup_index=2)
        for t in range(0, 9000, 350):
            lg.log_batch([(f"r{i % 7}", "FlowException", "default", "o", i + 1) for i in range(t % 9)], t)
            lg.log_blocked("r1", 2, "app", "", 3, t)
            lg.maybe_flush(t + 200)
        lg.stat("concurrent", "block", "7", count=4, now_wall_ms=9999)
        lg.flush()
        out[name] = {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}
        out[name + "_entries"] = lg.read_entries()
    assert out["jax"] == out["port"] and len(out["port"]) == 3
    assert out["jax_entries"] == out["port_entries"]


def test_cluster_stat_log_file_sink():
    """ClusterServerStatLogUtil writes through a BlockLogger into
    ``sentinel-cluster.log`` (set_logger swaps it, None goes back to the
    file in the log directory), the counters beside it."""
    from sentinel_tpu_torch.cluster import stat_log
    from sentinel_tpu_torch.utils.config import config

    d = tempfile.mkdtemp(prefix="cstat-")
    config.set(config.LOG_DIR, d)
    try:
        stat_log.set_logger(None)
        stat_log.reset_counters()
        stat_log.log("concurrent", "block", 7, 2)
        stat_log.log_many([("flow", "pass", 3, 5), ("flow", "block", 3, 1)])
        stat_log.flush()
        assert stat_log._get_logger().path == os.path.join(d, "sentinel-cluster.log")
        lines = open(os.path.join(d, "sentinel-cluster.log")).read().splitlines()
        assert sorted(ln.split("|", 2)[2] for ln in lines) == ["concurrent,block,7|2", "flow,block,3|1",
                                                               "flow,pass,3|5"]
        assert stat_log.counters_snapshot() == {"concurrent.block": 2, "flow.pass": 5, "flow.block": 1}
        mine = tbl.BlockLogger(base_dir=d, file_name="mine.log")
        stat_log.set_logger(mine)
        stat_log.log("flow", "pass", 1)
        stat_log.flush()
        assert open(os.path.join(d, "mine.log")).read().endswith("|count|flow,pass,1|1\n")
    finally:
        stat_log.set_logger(None)
        stat_log.reset_counters()
        config.reset()


class _Ext:
    """A metric extension that records every call (the BlockError as its
    class name and its rule's resource)."""

    def __init__(self, base):
        calls = self.calls = []

        class Ext(base):
            def add_pass(self, resource, n, *args):
                calls.append(("pass", resource, n, args))

            def add_block(self, resource, n, origin, err, *args):
                calls.append(("block", resource, n, origin, type(err).__name__, getattr(err, "limit_type", ""), args))

            def add_success(self, resource, n, *args):
                calls.append(("success", resource, n))

            def add_exception(self, resource, n, throwable):
                calls.append(("exception", resource, n))

            def add_rt(self, resource, rt_ms, *args):
                calls.append(("rt", resource, rt_ms))

            def increase_thread_num(self, resource, *args):
                calls.append(("inc", resource))

            def decrease_thread_num(self, resource, *args):
                calls.append(("dec", resource))

        self.ext = Ext()


def _plane_stream(lib, depth, chaos, seed=5):
    """Flow rules with limit apps, an authority rule, a system rule, a
    breaker on two resources (exceptions trip it; the probe recovers it),
    a param rule; singles with origins and args, bulk groups (several
    slots, so first-failing-slot attribution), bulk exits with RT and
    errors, the valve's sheds; with ``chaos`` a device fault while
    failover is armed. The block log, the extension calls and the observer
    events; a rule reload midway starts a fresh observer epoch."""
    st, C = lib.st, lib.C
    ext_mod = _pkg(lib, "metrics.extension")
    bev = _pkg(lib, "rules.breaker_events")
    rng = np.random.default_rng(seed)
    d = tempfile.mkdtemp(prefix=f"plane-{lib.name}-")
    lib.config.set(lib.config.LOG_DIR, d)
    rec = _Ext(ext_mod.MetricExtension)
    events = []
    ext_mod.MetricExtensionProvider.clear()
    ext_mod.MetricExtensionProvider.register(rec.ext)
    bev.clear()
    bev.add_state_change_observer("t", lambda prev, new, rule, res: events.append((prev, new, res, rule.count)))
    bev.add_state_change_observer("boom", lambda *a: 1 / 0)  # a failing observer is logged, never raised
    lib.clock.set_ms(1000)
    cfg = dict(INGEST_MAX_PENDING_BULK="48")
    if chaos:
        cfg.update(FAILOVER_ENABLED="true", FAILOVER_PROBE_FLUSHES="1")
    eng = lib.mk(depth, **cfg)
    inj = lib.FaultInjector().install(eng) if chaos else None
    try:
        rules = [st.FlowRule("a", count=4, limit_app="default"), st.FlowRule("a", count=2, limit_app="o1"),
                 st.FlowRule("b", count=10), st.FlowRule("c", count=3, limit_app="other")]
        eng.set_flow_rules(rules)
        eng.set_degrade_rules([st.DegradeRule("b", grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, count=2, time_window=1,
                                              min_request_amount=1),
                               st.DegradeRule("c", grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, count=1, time_window=1,
                                              min_request_amount=1)])
        eng.set_authority_rules({"d": st.AuthorityRule("d", limit_app="bad", strategy=C.AUTHORITY_BLACK)})
        eng.set_param_rules({"e": [st.ParamFlowRule("e", param_idx=0, count=1)]})
        held = []
        for step in range(14):
            t = 1000 + 450 * step
            lib.clock.set_ms(t)
            if step == 7:
                eng.set_degrade_rules([st.DegradeRule("b", grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, count=3,
                                                      time_window=1, min_request_amount=1)])
            for op in held:
                eng.submit_exit(op.rows, rt=int(rng.integers(1, 40)), count=1, err=int(rng.random() < 0.6),
                                resource=op.resource)
            ops = []
            for _ in range(int(rng.integers(6, 16))):
                r = "abcde"[int(rng.integers(0, 5))]
                origin = ("", "o1", "bad")[int(rng.integers(0, 3))]
                args = (f"k{int(rng.integers(0, 2))}",) if r == "e" else ()
                ops.append(eng.submit_entry(r, origin=origin, args=args))
            g = eng.submit_bulk("a", int(rng.integers(1, 12)), origin="o1")
            eng.submit_bulk("c", 40)
            eng.submit_bulk("c", 40)  # over the bulk bound: shed
            if g is not None and step % 3 == 0:
                eng.submit_exit_bulk(g.rows, 3, rt=np.array([5, 7, 9], np.int32), count=1,
                                     err=np.array([0, 1, 0], np.int32), resource="a")
            if chaos and step == 5:
                inj.fail_fetch(eng.flush_seq + 1)
            eng.flush()
            eng.drain()
            held = [op for op in ops if op is not None and op.verdict is not None and op.verdict.admitted]
        eng.block_log.flush()
        return [eng.block_log.read_entries(), rec.calls, events]
    finally:
        ext_mod.MetricExtensionProvider.clear()
        bev.clear()


@pytest.mark.parametrize("depth,chaos", [(0, False), (2, False), (0, True)], ids=["sync", "depth2", "failover"])
def test_block_log_extensions_and_observers_match_jax(depth, chaos):
    """The block log's lines, the extension calls and the breaker
    observer events of one stream equal the JAX engine's."""
    blocks, calls, events = run_lockstep(_plane_stream, depth, chaos)
    names = {b[1][1] for b in blocks}
    assert {"FlowException", "DegradeException", "AuthorityException", "ParamFlowException"} <= names
    assert any(b[1][2] == "o1" for b in blocks) and any(c[0] == "rt" for c in calls)
    assert {(0, 1), (1, 2)} <= {(e[0], e[1]) for e in events}


def test_observer_registry_matches_jax():
    """add/remove/get/has/clear, and a name or callable missing raises."""
    from sentinel_tpu.rules import breaker_events as jbev
    from sentinel_tpu_torch.rules import breaker_events as tbev

    for bev in (jbev, tbev):
        bev.clear()
        with pytest.raises(ValueError):
            bev.add_state_change_observer("", lambda *a: None)
        with pytest.raises(ValueError):
            bev.add_state_change_observer("x", None)
        f = lambda *a: None  # noqa: E731
        bev.add_state_change_observer("x", f)
        assert bev.has_observers() and bev.get_state_change_observer("x") is f
        assert bev.remove_state_change_observer("x") and not bev.remove_state_change_observer("x")
        assert not bev.has_observers()
    assert jbev.STATE_NAMES == tbev.STATE_NAMES
