"""The port's speculative admission tier (sentinel_tpu_torch/runtime/
speculative.py) against the JAX package's, bit for bit, on the CPU.

Every in-slice case of tests/test_speculative.py runs here on both engines
in lockstep (tests/torch_lockstep.py): immediate verdicts with their
speculative and degraded marks, the reconciliation counters, drift
accounting and every state tensor after settlement must be identical, and
the test's own assertions run on both.

With the control surface ported (ROADMAP item 11, part 1):
``test_custom_slot_runs_once_per_entry`` (the slot chain runs once an
entry and a distinct bulk acquire, though admit and settle both see the
op) and ``test_telemetry_and_prometheus_export`` with its Prometheus lines
(the wall-time families excluded by name, tests/torch_transport_env.py).
The speculative trace records, settled and degraded, and the tier's
provenance columns are held in tests/test_torch_admission_trace.py and
test_torch_provenance.py."""

import numpy as np
import pytest

from torch_lockstep import group, health, run_lockstep, verdict, verdicts


def _mk(lib, spec=True, depth=0, failover=False, flush_batch=10000, overadmit_max=0, window_ms=1000, ckpt_every=1,
        probes=1):
    return lib.mk(depth=depth, SPECULATIVE_ENABLED="true" if spec else "false", SPECULATIVE_FLUSH_BATCH=flush_batch,
                  SPECULATIVE_OVERADMIT_MAX=overadmit_max, SPECULATIVE_WINDOW_MS=window_ms,
                  FAILOVER_ENABLED="true" if failover else "false", FAILOVER_CHECKPOINT_EVERY=ckpt_every,
                  FAILOVER_PROBE_FLUSHES=probes, FAILOVER_RETRY_MS=100000)


def _spec(eng):
    return eng.speculative.snapshot()


# --- TestFastPath ------------------------------------------------------------


def _immediate_verdicts_match_oracle_and_reconcile_clean(lib):
    spec_e = _mk(lib, spec=True)
    oracle = _mk(lib, spec=False)
    for eng in (spec_e, oracle):
        eng.set_flow_rules([lib.st.FlowRule("r", count=5)])
    lib.clock.set_ms(1000)
    sv = [spec_e.entry_sync("r")[1] for _ in range(8)]
    assert all(v.speculative and not v.degraded for v in sv)
    assert spec_e.flush_seq == 0
    ov = [oracle.entry_sync("r")[1] for _ in range(8)]
    assert not any(v.speculative for v in ov)
    assert [(v.admitted, v.reason) for v in sv] == [(v.admitted, v.reason) for v in ov]
    spec_e.flush()
    spec_e.drain()
    snap = _spec(spec_e)
    assert snap["counters"]["reconciled"] == 8
    assert snap["counters"]["over_admits"] == 0 and snap["counters"]["under_admits"] == 0
    return [[verdict(v) for v in sv], snap, lib.states(spec_e)]


def _declines_take_the_device_path(lib):
    eng = _mk(lib, spec=True)
    eng.set_flow_rules([lib.st.FlowRule("plain", count=100),
                        lib.st.FlowRule("shaped", count=100, control_behavior=lib.C.CONTROL_BEHAVIOR_RATE_LIMITER)])
    lib.clock.set_ms(1000)
    _, v1 = eng.entry_sync("plain", prio=True)
    assert not v1.speculative
    _, v2 = eng.entry_sync("shaped")
    assert v2.speculative
    assert eng.speculative.counters["spec_declined"] >= 1 and eng.speculative.counters["spec_shaped"] >= 1
    _, v3 = eng.entry_sync("plain")
    assert v3.speculative
    eng.flush()
    eng.drain()
    return [[verdict(v) for v in (v1, v2, v3)], _spec(eng), lib.states(eng)]


def _shaping_mirror_off_restores_decline(lib):
    lib.config.set(lib.config.SPECULATIVE_SHAPING, "false")
    eng = _mk(lib, spec=True)
    eng.set_flow_rules([lib.st.FlowRule("shaped", count=100, control_behavior=lib.C.CONTROL_BEHAVIOR_RATE_LIMITER)])
    lib.clock.set_ms(1000)
    _, v = eng.entry_sync("shaped")
    assert not v.speculative
    assert eng.speculative.counters["spec_declined"] >= 1
    return [verdict(v), _spec(eng)]


def _bulk_immediate_and_reconciled(lib):
    spec_e = _mk(lib, spec=True)
    oracle = _mk(lib, spec=False)
    for eng in (spec_e, oracle):
        eng.set_flow_rules([lib.st.FlowRule("b", count=50)])
    lib.clock.set_ms(1000)
    now = lib.clock.now_ms()
    g = spec_e.submit_bulk("b", 128, ts=now)
    assert spec_e.flush_seq == 0
    assert g.admitted is not None and g.admitted_count == 50 and g.speculative
    og = oracle.submit_bulk("b", 128, ts=now)
    oracle.flush()
    assert list(g.admitted) == list(og.admitted)
    spec_e.flush()
    spec_e.drain()
    c = spec_e.speculative.counters
    assert c["reconciled"] == 128 and c["over_admits"] == 0 and c["under_admits"] == 0
    return [group(g), _spec(spec_e), lib.states(spec_e)]


def _entry_api_exposes_provenance(lib):
    lib.config.set(lib.config.SPECULATIVE_ENABLED, "true")
    kw = dict(clock=lib.clock, **lib.device_kw)
    eng = lib.api.reset(**kw)
    try:
        lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("api", count=10)])
        lib.clock.set_ms(1000)
        e = lib.st.entry("api")
        assert e.verdict is not None and e.verdict.speculative
        e.exit()
        eng.flush()
        eng.drain()
        return [verdict(e.verdict), _spec(eng), lib.states(eng)]
    finally:
        lib.config.set(lib.config.SPECULATIVE_ENABLED, "false")
        lib.api.reset(**lib.device_kw)


# --- TestDifferentialDrift -----------------------------------------------------


def _max_over_admit_per_window_bounded(lib, depth):
    T = 10
    spec_e = _mk(lib, spec=True, depth=depth, failover=True)
    oracle = _mk(lib, spec=False, depth=0)
    for eng in (spec_e, oracle):
        eng.set_flow_rules([lib.st.FlowRule("w", count=float(T))])
    inj = lib.FaultInjector().install(spec_e)
    rng = np.random.default_rng(11)
    windows, fault_round = 6, 3
    spec_admits, oracle_admits, seen = {}, {}, []
    for w in range(windows):
        base = 1000 + w * 1000
        offs = np.sort(rng.integers(0, 1000, 3 * T)).astype(np.int64)
        if w == fault_round:
            inj.fail_fetch(spec_e.flush_seq + 1)
        for i, off in enumerate(offs):
            lib.clock.set_ms(int(base + off))
            _, v = spec_e.entry_sync("w")
            seen.append(verdict(v))
            if v.admitted:
                spec_admits[w] = spec_admits.get(w, 0) + 1
            _, ov = oracle.entry_sync("w")
            if ov.admitted:
                oracle_admits[w] = oracle_admits.get(w, 0) + 1
            if i % 8 == 7:
                spec_e.flush()
        if w == fault_round:
            assert spec_e.failover.state == "DEGRADED"
        if w == fault_round + 1:
            inj.clear()
            assert spec_e.failover.try_recover(), spec_e.failover.last_fault
    spec_e.flush()
    spec_e.drain()
    for w in range(windows):
        over = spec_admits.get(w, 0) - oracle_admits.get(w, 0)
        assert over <= (T if w == 0 else 3), (w, spec_admits, oracle_admits)
    assert spec_e.speculative.max_over_admit_window <= T
    assert spec_e.speculative.counters["spec_declined"] == 0
    return [seen, spec_admits, oracle_admits, _spec(spec_e), health(spec_e), lib.states(spec_e)]


def _trip_is_zero_transition_for_the_mirror(lib):
    eng = _mk(lib, spec=True, failover=True)
    eng.set_flow_rules([lib.st.FlowRule("z", count=3)])
    inj = lib.FaultInjector().install(eng)
    lib.clock.set_ms(1000)
    got = [eng.entry_sync("z")[1] for _ in range(4)]
    assert [v.admitted for v in got] == [True, True, True, False]
    eng.flush()
    inj.fail_fetch(eng.flush_seq + 1)
    eng.submit_entry("z")
    eng.flush()
    assert eng.failover.state == "DEGRADED"
    _, v = eng.entry_sync("z")
    assert v.speculative and v.degraded and not v.admitted, "a trip must not re-mint a full bucket"
    lib.clock.set_ms(2500)
    _, v2 = eng.entry_sync("z")
    assert v2.admitted and v2.speculative and v2.degraded
    assert eng.failover.try_recover(), eng.failover.last_fault
    _, v3 = eng.entry_sync("z")
    assert v3.speculative and not v3.degraded
    eng.flush()
    eng.drain()
    return [[verdict(x) for x in got + [v, v2, v3]], _spec(eng), health(eng), lib.states(eng)]


# --- TestReconciliation ----------------------------------------------------------


def _over_admit_clamps_bucket_and_suspends_at_valve(lib):
    eng = _mk(lib, spec=True, overadmit_max=3, window_ms=100000)
    eng.set_flow_rules([lib.st.FlowRule("v", count=2)])
    lib.clock.set_ms(1000)
    _, v = eng.entry_sync("v")
    assert v.admitted and v.speculative
    mirror = eng.speculative.mirror
    with mirror._lock:
        (_rule, bucket), = mirror._buckets.values()
        bucket.tokens = 100.0  # cheat the mirror generous
    vs = [eng.entry_sync("v")[1] for _ in range(6)]
    assert all(x.admitted and x.speculative for x in vs)
    eng.flush()
    eng.drain()
    c = eng.speculative.counters
    assert c["over_admits"] >= 3 and c["bucket_clamps"] >= 1 and c["suspensions"] == 1
    assert eng.speculative.suspended
    _, vd = eng.entry_sync("v")
    assert not vd.speculative
    lib.clock.set_ms(1000 + 100000)
    _, vr = eng.entry_sync("v")
    assert vr.speculative
    eng.flush()
    eng.drain()
    return [[verdict(x) for x in [v] + vs + [vd, vr]], _spec(eng), lib.states(eng)]


def _thread_gauge_compensation_under_admit(lib):
    eng = _mk(lib, spec=True)
    eng.set_flow_rules([lib.st.FlowRule("t", grade=lib.C.FLOW_GRADE_THREAD, count=5)])
    lib.clock.set_ms(1000)
    eng.speculative.mirror._threads["t"] = 5  # cheat the mirror full
    vs = [eng.entry_sync("t")[1] for _ in range(3)]
    assert all(not x.admitted and x.speculative for x in vs)
    for _ in range(2):
        eng.flush()
        eng.drain()
    c = eng.speculative.counters
    assert c["under_admits"] == 3 and c["comp_minus"] == 3
    assert eng.cluster_node_stats("t")["cur_thread_num"] == 0, "the gauge must not leak"
    return [[verdict(x) for x in vs], _spec(eng), lib.states(eng)]


def _thread_gauge_compensation_over_admit_with_exits(lib):
    eng = _mk(lib, spec=True)
    eng.set_flow_rules([lib.st.FlowRule("t", grade=lib.C.FLOW_GRADE_THREAD, count=2)])
    lib.clock.set_ms(1000)
    ops = [eng.entry_sync("t") for _ in range(2)]
    assert all(v.admitted for _, v in ops)
    eng.flush()
    eng.drain()
    eng.speculative.mirror._threads["t"] = 0  # cheat the mirror empty
    op3, v3 = eng.entry_sync("t")
    assert v3.admitted and v3.speculative
    eng.flush()
    eng.drain()
    c = eng.speculative.counters
    assert c["over_admits"] == 1 and c["comp_plus"] == 1
    for op, _v in ops + [(op3, v3)]:
        eng.submit_exit(op.rows, rt=1, resource="t", speculative=True)
    eng.flush()
    eng.drain()
    assert eng.cluster_node_stats("t")["cur_thread_num"] == 0, "the gauge must not leak"
    return [[verdict(v) for _, v in ops + [(op3, v3)]], _spec(eng), lib.states(eng)]


def _bulk_exit_releases_mirror_thread_counter(lib):
    eng = _mk(lib, spec=True)
    eng.set_flow_rules([lib.st.FlowRule("bt", grade=lib.C.FLOW_GRADE_THREAD, count=8)])
    lib.clock.set_ms(1000)
    out = []
    for round_no in range(4):
        g = eng.submit_bulk("bt", 8)
        assert g.admitted_count == 8, (round_no, eng.speculative.mirror.snapshot()["live_threads"])
        eng.flush()
        eng.drain()
        eng.submit_exit_bulk(g.rows, g.admitted_count, rt=1, resource="bt")
        eng.flush()
        eng.drain()
        out.append(group(g))
    assert eng.speculative.mirror.snapshot()["live_threads"].get("bt", 0) == 0
    assert eng.cluster_node_stats("bt")["cur_thread_num"] == 0
    return [out, _spec(eng), lib.states(eng)]


def _degraded_fill_admit_releases_persistent_mirror(lib):
    for key, value in (("SPECULATIVE_ENABLED", "true"), ("FAILOVER_ENABLED", "true"),
                       ("FAILOVER_CHECKPOINT_EVERY", "1"), ("FAILOVER_PROBE_FLUSHES", "1"),
                       ("FAILOVER_RETRY_MS", "100000")):
        lib.config.set(getattr(lib.config, key), value)
    eng = lib.api.reset(clock=lib.clock, **lib.device_kw)
    try:
        lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("dt", grade=lib.C.FLOW_GRADE_THREAD, count=2)])
        inj = lib.FaultInjector().install(eng)
        lib.clock.set_ms(1000)
        lib.st.entry("dt").exit()
        eng.flush()
        eng.drain()
        mirror = eng.speculative.mirror
        assert mirror.snapshot()["live_threads"].get("dt", 0) == 0
        inj.fail_fetch(eng.flush_seq + 1)
        lib.st.entry("dt").exit()
        eng.flush()
        assert eng.failover.state == "DEGRADED"
        e = lib.st.entry("dt", prio=True)  # the tier declines prio: a degraded fill
        assert e.verdict.degraded and not e.verdict.speculative
        assert mirror.snapshot()["live_threads"].get("dt", 0) == 1
        e.exit()
        assert mirror.snapshot()["live_threads"].get("dt", 0) == 0
        inj.clear()
        return [verdict(e.verdict), _spec(eng), health(eng)]
    finally:
        for key in ("SPECULATIVE_ENABLED", "FAILOVER_ENABLED"):
            lib.config.set(getattr(lib.config, key), "false")
        lib.api.reset(**lib.device_kw)


def _rule_reload_retires_mirrors(lib):
    eng = _mk(lib, spec=True)
    eng.set_flow_rules([lib.st.FlowRule("r", count=3)])
    lib.clock.set_ms(1000)
    vs = [eng.entry_sync("r")[1] for _ in range(4)]
    assert [v.admitted for v in vs] == [True, True, True, False]
    eng.set_flow_rules([lib.st.FlowRule("r", count=3)])
    vs2 = [eng.entry_sync("r")[1] for _ in range(4)]
    assert [v.admitted for v in vs2] == [True, True, True, False]
    eng.flush()
    eng.drain()
    return [[verdict(v) for v in vs + vs2], _spec(eng), lib.states(eng)]


# --- TestProvenance (the verdict half), TestDisabledParity --------------------


def _degraded_fill_keeps_speculative_verdicts(lib):
    eng = _mk(lib, spec=True, failover=True)
    eng.set_flow_rules([lib.st.FlowRule("q", count=4)])
    inj = lib.FaultInjector().install(eng)
    lib.clock.set_ms(1000)
    _, v0 = eng.entry_sync("q")
    assert v0.admitted and v0.speculative
    eng.flush()
    eng.drain()
    inj.fail_fetch(eng.flush_seq + 1)
    vs = [eng.entry_sync("q")[1] for _ in range(4)]
    assert [v.admitted for v in vs] == [True, True, True, False]
    eng.flush()
    assert eng.failover.state == "DEGRADED"
    c = eng.speculative.counters
    assert c["spec_admits"] == 4 and c["spec_blocks"] == 1
    return [[verdict(v) for v in [v0] + vs], _spec(eng), health(eng)]


def _disabled_tier_changes_nothing(lib):
    engines = [_mk(lib, spec=False, depth=0), _mk(lib, spec=False, depth=2)]
    rng = np.random.default_rng(5)
    for eng in engines:
        eng.set_flow_rules([lib.st.FlowRule("d", count=6)])
    seqs = [[] for _ in engines]
    t = 1000
    for _ in range(4):
        lib.clock.set_ms(t)
        ts = t + np.sort(rng.integers(0, 50, 10)).astype(np.int64)
        for i, eng in enumerate(engines):
            ops = [eng.submit_entry("d", ts=int(x)) for x in ts]
            eng.flush()
            seqs[i].append(verdicts(ops))
        t += 300
    for eng in engines:
        eng.drain()
    assert seqs[0] == seqs[1]
    assert all(not v[5] for r in seqs[0] for v in r)
    return [seqs[0], lib.states(engines[1])]


def _custom_slot_runs_once_per_entry(lib):
    from torch_transport_env import module_of

    slots = module_of(lib, "core.slots")
    calls = []

    class Counting(slots.ProcessorSlot):
        name = "counting"

        def entry(self, ctx):
            calls.append((ctx.resource, ctx.acquire))
            return None

    slots.SlotChainRegistry.clear()
    slots.SlotChainRegistry.register(Counting())
    try:
        eng = _mk(lib, spec=True)
        eng.set_flow_rules([lib.st.FlowRule("c", count=100)])
        lib.clock.set_ms(1000)
        vs = []
        for _ in range(5):
            _, v = eng.entry_sync("c")
            assert v.speculative and v.admitted
            vs.append(verdict(v))
        g = eng.submit_bulk("c", 8)
        assert g.admitted_count == 8
        eng.flush()
        eng.drain()
        # 5 singles and 1 distinct acquire of the bulk group, each checked
        # exactly once though admit and settle both see it.
        assert [c for c, _ in calls].count("c") == 6, calls
        return [vs, group(g), calls, _spec(eng), lib.states(eng)]
    finally:
        slots.SlotChainRegistry.clear()


def _telemetry_and_prometheus_export(lib):
    from torch_transport_env import comparable, module_of, reset_process_counters

    # Every admission traced: head sampling draws from each package's own
    # random source (the trace families are in the lines compared).
    lib.config.set(lib.config.TRACE_SAMPLE_RATE, "1.0")
    eng = _mk(lib, spec=True)
    eng.set_flow_rules([lib.st.FlowRule("m", count=2)])
    lib.clock.set_ms(1000)
    vs = [verdict(eng.entry_sync("m")[1]) for _ in range(4)]
    eng.flush()
    eng.drain()
    tc = eng.telemetry.counters_snapshot()
    assert tc["spec_admits"] == 2 and tc["spec_blocks"] == 2
    reset_process_counters(lib)
    text = "\n".join(module_of(lib, "transport.prometheus").engine_telemetry_lines(eng))
    assert "sentinel_engine_speculative_admits_total 2" in text
    assert "sentinel_engine_speculative_enabled 1" in text
    assert "sentinel_engine_speculative_drift_per_window" in text
    snap = eng.speculative.snapshot()
    assert snap["mirror"]["qps_buckets"] == 1
    # The arena's hits and misses follow each package's staging layout.
    tc = {k: v for k, v in tc.items() if not k.startswith("arena_")}
    return [vs, tc, comparable(text), _spec(eng)]


CASES = {
    "custom_slot_runs_once_per_entry": _custom_slot_runs_once_per_entry,
    "telemetry_and_prometheus_export": _telemetry_and_prometheus_export,
    "immediate_verdicts_match_oracle_and_reconcile_clean": _immediate_verdicts_match_oracle_and_reconcile_clean,
    "declines_take_the_device_path": _declines_take_the_device_path,
    "shaping_mirror_off_restores_decline": _shaping_mirror_off_restores_decline,
    "bulk_immediate_and_reconciled": _bulk_immediate_and_reconciled,
    "entry_api_exposes_provenance": _entry_api_exposes_provenance,
    "trip_is_zero_transition_for_the_mirror": _trip_is_zero_transition_for_the_mirror,
    "over_admit_clamps_bucket_and_suspends_at_valve": _over_admit_clamps_bucket_and_suspends_at_valve,
    "thread_gauge_compensation_under_admit": _thread_gauge_compensation_under_admit,
    "thread_gauge_compensation_over_admit_with_exits": _thread_gauge_compensation_over_admit_with_exits,
    "bulk_exit_releases_mirror_thread_counter": _bulk_exit_releases_mirror_thread_counter,
    "degraded_fill_admit_releases_persistent_mirror": _degraded_fill_admit_releases_persistent_mirror,
    "rule_reload_retires_mirrors": _rule_reload_retires_mirrors,
    "degraded_fill_keeps_speculative_verdicts": _degraded_fill_keeps_speculative_verdicts,
    "disabled_tier_changes_nothing": _disabled_tier_changes_nothing,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_speculative_lockstep(case):
    run_lockstep(CASES[case])


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_max_over_admit_per_window_bounded_lockstep(depth):
    """The acceptance differential of the tier, across a fault and its
    recovery, at pipeline depths 0, 1 and 2."""
    run_lockstep(_max_over_admit_per_window_bounded, depth)


def _shaped_and_system_stream(lib, seed):
    """A mixed stream through the tier's host shaping pacer, the host
    system gate and hot-param buckets (singles and bulk groups), settled
    and reconciled every few ops."""
    eng = _mk(lib, spec=True, overadmit_max=8)
    eng.set_flow_rules([
        lib.st.FlowRule("p", count=20, control_behavior=lib.C.CONTROL_BEHAVIOR_RATE_LIMITER, max_queueing_time_ms=300),
        lib.st.FlowRule("q", count=7),
        lib.st.FlowRule("t", grade=lib.C.FLOW_GRADE_THREAD, count=4),
    ])
    eng.set_param_rules({"h": [lib.st.ParamFlowRule("h", param_idx=0, count=3)]})
    eng.set_system_config(lib.st.system_rule_manager.effective._replace(qps=30.0, max_thread=6))
    rng = np.random.default_rng(seed)
    seen, live = [], []
    t = 1000
    for step in range(24):
        t += int(rng.choice([0, 20, 150, 400]))
        lib.clock.set_ms(t)
        for _ in range(int(rng.integers(2, 8))):
            res = str(rng.choice(["p", "q", "t", "h"]))
            et = lib.C.EntryType.IN if rng.random() < 0.5 else lib.C.EntryType.OUT
            args = (str(rng.choice(["a", "b"])),) if res == "h" else ()
            op, v = eng.entry_sync(res, entry_type=et, args=args)
            seen.append(verdict(v))
            if res == "t" and v.admitted:
                live.append((op, v))
        if rng.random() < 0.4:
            g = eng.submit_bulk(str(rng.choice(["p", "q"])), int(rng.integers(4, 16)), ts=t)
            seen.append(group(g))
        for op, v in live[: int(rng.integers(0, len(live) + 1))]:
            eng.submit_exit(op.rows, rt=int(rng.integers(1, 30)), resource="t", speculative=v.speculative)
            live.remove((op, v))
        if step % 3 == 2:
            eng.flush()
            eng.drain()
    eng.flush()
    eng.drain()
    return [seen, _spec(eng), lib.states(eng)]


@pytest.mark.parametrize("seed", [0, 1])
def test_shaped_param_thread_stream_lockstep(seed):
    run_lockstep(_shaped_and_system_stream, seed)
