"""The live retune of the second-window geometry on the port, against the
JAX package (tests/test_window_retune.py's cases), and the reads of the
geometry that a retune swaps: ``nodes.SECOND_CFG`` through the module in
the engine's rebase, its slab horizon and its stats dict.

Reference semantics (node/SampleCountProperty.java:33-52 and
IntervalProperty.java): updating either property rebuilds every node's
rolling second counter and resets its second-window statistics; the
minute windows and the thread gauges stay."""

import numpy as np
import pytest

from torch_lockstep import run_lockstep, verdicts
from torch_parity import run_on_both


def _nodes(lib_or_st):
    """The nodes module of the package under test."""
    if lib_or_st.__name__.startswith("sentinel_tpu_torch"):
        from sentinel_tpu_torch.metrics import nodes
    else:
        from sentinel_tpu.metrics import nodes
    return nodes


def _admitted(st, n, resource="res"):
    return sum(st.try_entry(resource) is not None for _ in range(n))


def _geometry(lib):
    cfg = _nodes(lib.st).SECOND_CFG
    return (cfg.sample_count, cfg.interval_ms, cfg.window_len_ms)


def _swap_mid_stream(lib):
    st, eng = lib.st, lib.engine
    st.flow_rule_manager.load_rules([st.FlowRule("res", count=10)])
    out = [_admitted(st, 15), tuple(eng.stats.second.counts.shape)]
    eng.retune_second_window(4, 1000)
    out += [_geometry(lib), tuple(eng.stats.second.counts.shape), tuple(eng.stats.future_pass.shape)]
    out.append(_admitted(st, 15))  # the statistics reset: the full budget again
    lib.clock.advance(1001)
    out.append(_admitted(st, 15))
    return out


def _interval_only(lib):
    st, eng = lib.st, lib.engine
    st.flow_rule_manager.load_rules([st.FlowRule("res", count=5)])
    out = [_admitted(st, 10)]
    eng.retune_second_window(2, 2000)
    out += [tuple(eng.stats.second.counts.shape), _admitted(st, 20)]  # count 5 over 2 s: 10 a window
    lib.clock.advance(2001)
    out.append(_admitted(st, 20))
    return out


def _minute_and_threads_survive(lib):
    st, eng = lib.st, lib.engine
    st.flow_rule_manager.load_rules([st.FlowRule("res", count=100)])
    e1, e2 = st.entry("res"), st.entry("res")
    for _ in range(10):
        ee = st.try_entry("res")
        if ee is not None:
            ee.exit()
    before = eng.cluster_node_stats("res")
    eng.retune_second_window(4, 1000)
    after = eng.cluster_node_stats("res")
    e1.exit()
    e2.exit()
    return [before, after, eng.cluster_node_stats("res")]


def _invalid_geometry(lib):
    st, eng = lib.st, lib.engine
    st.flow_rule_manager.load_rules([st.FlowRule("res", count=5)])
    out = [_admitted(st, 3)]
    with pytest.raises(ValueError):
        eng.retune_second_window(3, 1000)  # 3 does not divide 1000
    out += [_geometry(lib), _admitted(st, 5)]  # nothing was touched: 2 of the budget remain
    return out


def _noop(lib):
    st, eng = lib.st, lib.engine
    st.flow_rule_manager.load_rules([st.FlowRule("res", count=5)])
    out = [_admitted(st, 3)]
    eng.retune_second_window(lib.C.DEFAULT_SAMPLE_COUNT, lib.C.DEFAULT_WINDOW_INTERVAL_MS)
    out.append(_admitted(st, 5))  # the same geometry: no reset
    return out


def _properties(lib):
    st = lib.st
    st.sample_count_property.update_value(4)
    out = [_geometry(lib), tuple(st.get_engine().stats.second.counts.shape)]
    st.interval_property.update_value(2000)
    out.append(_geometry(lib))
    st.sample_count_property.update_value(3)  # 3 does not divide 2000: ignored, not raised
    out.append(_geometry(lib))
    return out


def _reset_restores_default(lib):
    lib.api.get_engine().retune_second_window(4, 2000)
    out = [_geometry(lib)]
    lib.st.sample_count_property.update_value(4)
    lib.api.reset(clock=lib.clock, **({"device": "cpu"} if lib.st.__name__.startswith("sentinel_tpu_torch") else {}))
    out.append(_geometry(lib))
    lib.st.sample_count_property.update_value(4)  # the same value as before the reset retunes again
    out += [_geometry(lib), tuple(lib.api.get_engine().stats.second.counts.shape)]
    return out


RETUNE_CASES = {
    "geometry_swap_mid_stream": _swap_mid_stream,
    "interval_only_change": _interval_only,
    "minute_window_and_threads_survive": _minute_and_threads_survive,
    "invalid_geometry_rejected": _invalid_geometry,
    "noop_retune_keeps_state": _noop,
    "properties_drive_retune": _properties,
    "reset_restores_default_geometry": _reset_restores_default,
}


@pytest.mark.parametrize("case", sorted(RETUNE_CASES))
def test_retune_cases_match_jax(case):
    """tests/test_window_retune.py's cases on the port's public API and on
    the JAX package's, each under its own ManualClock: the admissions, the
    geometries, the tensor shapes and the stats dicts equal."""

    def scenario(lib):
        try:
            return RETUNE_CASES[case](lib)
        finally:
            _nodes(lib.st).set_second_window(lib.C.DEFAULT_SAMPLE_COUNT, lib.C.DEFAULT_WINDOW_INTERVAL_MS)

    run_on_both(scenario)


GEOMETRIES = [(4, 1000), (10, 1000), (2, 2000)]


def _retuned_stream(lib, depth, seed):
    """The slot chain (a QPS rule with prioritized entries that borrow, a
    breaker, a thread rule) and a DEFAULT resource, retuned between
    flushes to 4 x 1,000, 10 x 1,000 and 2 x 2,000 ms: every verdict and
    every state tensor after every flush."""
    st, C = lib.st, lib.C
    rng = np.random.default_rng(seed)
    lib.config.set(lib.config.OCCUPY_TIMEOUT_MS, "1000")
    eng = lib.mk(depth)
    eng.set_flow_rules([st.FlowRule("chain", count=6), st.FlowRule("plain", count=20),
                        st.FlowRule("thr", count=3, grade=C.FLOW_GRADE_THREAD)])
    eng.set_degrade_rules([st.DegradeRule("chain", grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, count=2, time_window=1,
                                          min_request_amount=1)])
    obs = []
    t = 1000
    held = []
    for step in range(12):
        if step in (3, 6, 9):
            sc, iv = GEOMETRIES[step // 3 - 1]
            eng.retune_second_window(sc, iv)
            obs.append(("geometry", _geometry(lib), tuple(eng.stats.second.counts.shape)))
        lib.clock.set_ms(t)
        ops = []
        for _ in range(int(rng.integers(4, 12))):
            res = ("chain", "plain", "thr")[int(rng.integers(0, 3))]
            ops.append(eng.submit_entry(res, prio=bool(rng.random() < 0.4), ts=t + int(rng.integers(0, 40))))
        g = eng.submit_bulk("plain", 16, ts=t)
        for op in held:
            eng.submit_exit(op.rows, rt=int(rng.integers(1, 50)), count=1, err=int(rng.random() < 0.5),
                            resource=op.resource)
        eng.flush()
        eng.drain()
        held = [op for op in ops if op is not None and op.verdict.admitted and op.resource != "plain"]
        obs.append(("verdicts", step, verdicts(ops), g.admitted, g.reason, g.wait_ms))
        obs.append(("states", step, lib.states(eng)))
        t += int(rng.integers(150, 700))
    return obs


@pytest.mark.parametrize("depth", [0, 2])
def test_retuned_stream_lockstep(depth):
    """A slot-chain stream with borrows, breakers and a thread rule on the
    JAX engine and the port's, retuned between flushes: verdicts and every
    state tensor after every flush equal, at pipeline depth 0 and 2."""

    def scenario(lib, depth):
        nodes = _nodes(lib.st)
        try:
            return _retuned_stream(lib, depth, 7)
        finally:
            nodes.set_second_window(lib.C.DEFAULT_SAMPLE_COUNT, lib.C.DEFAULT_WINDOW_INTERVAL_MS)

    run_lockstep(scenario, depth)


def test_rebase_and_stats_after_retune():
    """The reads of the geometry that a retune swaps: the epoch rebase's
    floor for the second window and the slab (their empty start follows
    the interval), the slab horizon that gates K1, and the QPS divisor of
    ``cluster_node_stats``, after an interval change, equal the JAX
    engine's."""

    def scenario(lib):
        st = lib.st
        nodes = _nodes(st)
        lib.config.set(lib.config.OCCUPY_TIMEOUT_MS, "1500")
        eng = lib.mk()
        try:
            eng.set_flow_rules([st.FlowRule("r", count=4)])
            out = []
            lib.clock.set_ms(100_000)
            eng.retune_second_window(4, 2000)
            for i in range(10):
                eng.submit_entry("r", prio=True, ts=100_000 + 10 * i)
            eng.flush()
            out.append(eng.cluster_node_stats("r"))
            eng._apply_rebase(60_000)
            out.append(lib.states(eng))
            lib.clock.set_ms(100_000 - 60_000 + 2500)
            out.append(eng.cluster_node_stats("r"))
            out.append(verdicts([eng.submit_entry("r", prio=True) for _ in range(6)]))
            eng.flush()
            out.append(lib.states(eng))
            return out
        finally:
            nodes.set_second_window(lib.C.DEFAULT_SAMPLE_COUNT, lib.C.DEFAULT_WINDOW_INTERVAL_MS)

    run_lockstep(scenario)


def test_no_module_binds_second_cfg_by_value():
    """Every reader of the second-window geometry in the port takes it
    through ``nodes`` at call time: no ``from ...nodes import SECOND_CFG``."""
    import pathlib

    pkg = pathlib.Path(__file__).resolve().parent.parent / "sentinel_tpu_torch"
    offenders = []
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        for stmt in text.split("from sentinel_tpu_torch.metrics.nodes import")[1:]:
            head = stmt.split(")")[0] if stmt.lstrip().startswith("(") else stmt.split("\n")[0]
            if "SECOND_CFG" in head:
                offenders.append(str(path.relative_to(pkg)))
    assert not offenders, offenders


def test_set_second_window_rejects_invalid():
    from sentinel_tpu_torch.metrics import nodes

    before = nodes.SECOND_CFG
    for sc, iv in ((3, 1000), (0, 1000), (2, 0), (-2, 1000)):
        with pytest.raises(ValueError):
            nodes.set_second_window(sc, iv)
    assert nodes.SECOND_CFG is before
