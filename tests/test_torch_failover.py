"""The port's device-failure domain (sentinel_tpu_torch/runtime/failover.py)
against the JAX package's, bit for bit, on the CPU.

Every in-slice case of tests/test_failover.py runs here on both engines in
lockstep (tests/torch_lockstep.py): each with its own package's
FaultInjector, the same fault plan and its own ManualClock. The verdicts
(admitted, reason, wait_ms, limit_type, the degraded and speculative
marks, the blocking rule), the health transitions and counters, and every
state tensor after recovery must be identical. The test's own assertions
run on both.

``test_prometheus_and_health_snapshot`` runs whole since the control
surface's port (ROADMAP item 11, part 1): the scrape's lines are compared
but the wall-time families (tests/torch_transport_env.py). Custom slots on
the degraded fill are held in tests/test_torch_slots.py. The degraded fill's trace records,
block-log rows and provenance columns (``test_trace_and_telemetry_provenance``'s
ground) are held in tests/test_torch_admission_trace.py,
test_torch_block_log.py and test_torch_provenance.py.

Also here: a kernel that does not build is a defect of the program, not a
device fault: with failover armed it raises to the caller and the engine
stays HEALTHY (a deliberate difference from the JAX package, which trips
on any dispatch exception; ROADMAP Queue 3)."""

import threading
import time

import numpy as np
import pytest

from torch_lockstep import health, run_lockstep, verdict, verdicts

pytestmark = pytest.mark.chaos


def _mk(lib, enabled=True, ckpt_every=1, probes=2, retry_ms=1000, depth=0, policy="open", timeout_ms=10000, **extra):
    return lib.mk(depth=depth, FAILOVER_ENABLED="true" if enabled else "false",
                  FAILOVER_CHECKPOINT_EVERY=ckpt_every, FAILOVER_PROBE_FLUSHES=probes, FAILOVER_RETRY_MS=retry_ms,
                  FAILOVER_POLICY=policy, FAILOVER_FETCH_TIMEOUT_MS=timeout_ms, **extra)


def _round(engines, resource, n, ts=None):
    return [[eng.submit_entry(resource, ts=ts) for _ in range(n)] for eng in engines]


def _vt(ops):
    return [(op.verdict.admitted, op.verdict.reason, op.verdict.wait_ms) for op in ops]


def _degrade(lib, victim, inj, resource="r"):
    victim.submit_entry(resource)
    victim.flush()
    inj.fail_fetch(victim.flush_seq + 1)
    victim.submit_entry(resource)
    victim.flush()
    assert victim.failover.state == "DEGRADED"


# --- TestFetchFaultRecovery ------------------------------------------------


def _fetch_fault_policy_verdicts_and_oracle_parity(lib):
    victim = _mk(lib, ckpt_every=1, probes=2)
    oracle = _mk(lib, enabled=False)
    for eng in (victim, oracle):
        eng.set_flow_rules([lib.st.FlowRule("r", count=5)])
    inj = lib.FaultInjector().install(victim)
    obs = []
    lib.clock.set_ms(1000)
    v_ops, o_ops = _round([victim, oracle], "r", 8)
    victim.flush()
    oracle.flush()
    assert _vt(v_ops) == _vt(o_ops)
    assert victim.failover.snapshot()["checkpoint"] is not None
    obs += [verdicts(v_ops), health(victim)]
    inj.fail_fetch(victim.flush_seq + 1)
    lib.clock.set_ms(1300)
    lost = [victim.submit_entry("r") for _ in range(4)]
    victim.flush()
    assert victim.failover.state == "DEGRADED"
    assert all(op.verdict.degraded and op.verdict.admitted for op in lost)
    obs += [verdicts(lost), health(victim)]
    assert victim.failover.try_recover()
    assert victim.failover.state == "HEALTHY"
    assert victim.failover.counters["probe_flushes"] == 2
    obs += [health(victim), lib.states(victim), inj.fired]
    lib.clock.set_ms(1600)
    v2, o2 = _round([victim, oracle], "r", 10)
    victim.flush()
    oracle.flush()
    assert _vt(v2) == _vt(o2)
    assert all(not op.verdict.degraded for op in v2)
    return obs + [verdicts(v2), lib.states(victim)]


def _fetch_hang_watchdog_bounds_the_flush(lib):
    victim = _mk(lib, ckpt_every=1, probes=1)
    victim.set_flow_rules([lib.st.FlowRule("r", count=100)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    [victim.submit_entry("r") for _ in range(4)]
    victim.flush()
    victim.failover.fetch_timeout_ms = 300
    seq = victim.flush_seq + 1
    release = threading.Event()
    # The hang raises after its release so the abandoned waiter never
    # waits on the device concurrently with the recovery.
    inj.hang_fetch(seq, seconds=5.0, until=release)
    inj.fail_fetch(seq)
    lib.clock.set_ms(1200)
    try:
        ops = [victim.submit_entry("r") for _ in range(4)]
        t0 = time.monotonic()
        victim.flush()
        elapsed = time.monotonic() - t0
    finally:
        release.set()
    assert elapsed < 0.9, "the watchdog must bound the wedged wait"
    assert victim.failover.state == "DEGRADED"
    assert victim.failover.counters["fetch_timeouts"] == 1
    assert all(op.verdict.degraded for op in ops)
    obs = [verdicts(ops), health(victim)]
    victim.failover.fetch_timeout_ms = 10000
    time.sleep(0.05)  # the released waiter finishes its abandoned call
    assert victim.failover.try_recover(), victim.failover.last_fault
    assert victim.failover.state == "HEALTHY"
    return obs + [health(victim), lib.states(victim), inj.fired]


def _dispatch_fault_and_failed_restore_stays_degraded(lib):
    victim = _mk(lib, ckpt_every=1, probes=1)
    victim.set_flow_rules([lib.st.FlowRule("r", count=100)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    victim.submit_entry("r")
    victim.flush()
    inj.fail_dispatch(victim.flush_seq + 1)
    ops = [victim.submit_entry("r") for _ in range(2)]
    victim.flush()
    assert victim.failover.state == "DEGRADED"
    assert all(op.verdict.degraded for op in ops)
    obs = [verdicts(ops), health(victim)]
    inj.fail_restore()
    assert not victim.failover.try_recover()
    assert victim.failover.state == "DEGRADED"
    obs.append(health(victim))
    assert victim.failover.try_recover()
    assert victim.failover.state == "HEALTHY"
    return obs + [health(victim), lib.states(victim), inj.fired]


def _auto_recovery_from_flush_after_retry_gap(lib):
    victim = _mk(lib, ckpt_every=1, probes=1, retry_ms=500)
    victim.set_flow_rules([lib.st.FlowRule("r", count=100)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    victim.submit_entry("r")
    victim.flush()
    inj.fail_fetch(victim.flush_seq + 1)
    victim.submit_entry("r")
    victim.flush()
    assert victim.failover.state == "DEGRADED"
    lib.clock.set_ms(1200)
    op = victim.submit_entry("r")
    victim.flush()
    assert victim.failover.state == "DEGRADED" and op.verdict.degraded
    lib.clock.set_ms(1600)
    op2 = victim.submit_entry("r")
    victim.flush()
    assert victim.failover.state == "HEALTHY" and not op2.verdict.degraded
    return [verdicts([op, op2]), health(victim), lib.states(victim)]


# --- TestDepth2Pipeline ----------------------------------------------------


def _inflight_queue_quarantined_no_raw_exception(lib):
    victim = _mk(lib, ckpt_every=1, probes=1, depth=2)
    victim.set_flow_rules([lib.st.FlowRule("r", count=1000)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    batches = []
    for _ in range(3):
        batches.append([victim.submit_entry("r") for _ in range(4)])
        victim.flush()
    inj.fail_fetch(victim.flush_seq)
    batches.append([victim.submit_entry("r") for _ in range(4)])
    victim.flush()
    victim.drain()
    assert victim.failover.state == "DEGRADED"
    assert all(op.verdict is not None for ops in batches for op in ops)
    assert any(op.verdict.degraded for ops in batches for op in ops)
    obs = [[verdicts(ops) for ops in batches], health(victim)]
    assert victim.failover.try_recover()
    ops = [victim.submit_entry("r") for _ in range(4)]
    victim.flush()
    victim.drain()
    assert all(not op.verdict.degraded for op in ops)
    return obs + [verdicts(ops), health(victim), lib.states(victim)]


def _no_fault_parity_depths_0_and_2(lib):
    engines = [_mk(lib, ckpt_every=2, depth=0), _mk(lib, enabled=False, depth=0), _mk(lib, ckpt_every=2, depth=2)]
    rng = np.random.default_rng(7)
    for eng in engines:
        eng.set_flow_rules([lib.st.FlowRule("pp", count=6.0)])
    collected = [[] for _ in engines]
    t = 1000
    for _ in range(6):
        lib.clock.set_ms(t)
        ts = t + np.sort(rng.integers(0, 40, 12)).astype(np.int32)
        for i, eng in enumerate(engines):
            collected[i].append([eng.submit_entry("pp", ts=int(x)) for x in ts])
            eng.flush()
        t += 300
    for eng in engines:
        eng.drain()
    base = [_vt(ops) for ops in collected[0]]
    for i in (1, 2):
        assert [_vt(ops) for ops in collected[i]] == base
    assert engines[0].failover.state == "HEALTHY"
    assert engines[0].failover.counters["checkpoints"] > 0
    return [[verdicts(ops) for ops in collected[0]], [health(e) for e in engines], lib.states(engines[2])]


# --- TestDegradedAdmission ---------------------------------------------------


def _fail_closed_policy_sheds_with_distinct_reason(lib):
    victim = _mk(lib, ckpt_every=1, probes=1, policy="open,shed=closed")
    victim.set_flow_rules([lib.st.FlowRule("shed", count=100), lib.st.FlowRule("keep", count=100)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    _degrade(lib, victim, inj, "keep")
    shed = victim.submit_entry("shed")
    keep = victim.submit_entry("keep")
    victim.flush()
    assert not shed.verdict.admitted and shed.verdict.reason == lib.E.BLOCK_FAILOVER and shed.verdict.degraded
    assert lib.E.exc_name_for_code(lib.E.BLOCK_FAILOVER) == "FailoverException"
    assert keep.verdict.admitted and keep.verdict.degraded
    return [verdicts([shed, keep]), health(victim)]


def _qps_token_bucket_approximation(lib):
    victim = _mk(lib, ckpt_every=1)
    victim.set_flow_rules([lib.st.FlowRule("r", count=3)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    _degrade(lib, victim, inj)
    ops = [victim.submit_entry("r") for _ in range(4)]
    victim.flush()
    assert [op.verdict.admitted for op in ops] == [True, True, False, False]
    assert ops[2].verdict.reason == lib.E.BLOCK_FLOW and ops[2].verdict.blocked_rule is not None
    lib.clock.set_ms(2100)
    ops2 = [victim.submit_entry("r") for _ in range(3)]
    victim.flush()
    assert all(op.verdict.admitted for op in ops2)
    return [verdicts(ops), verdicts(ops2), health(victim)]


def _thread_counter_with_exits(lib):
    victim = _mk(lib, ckpt_every=1)
    victim.set_flow_rules([lib.st.FlowRule("r", grade=lib.C.FLOW_GRADE_THREAD, count=2)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    _degrade(lib, victim, inj)
    ops = [victim.submit_entry("r") for _ in range(3)]
    victim.flush()
    assert [op.verdict.admitted for op in ops] == [True, False, False]
    victim.submit_exit(ops[0].rows, rt=5, resource="r")
    victim.flush()
    op = victim.submit_entry("r")
    victim.flush()
    assert op.verdict.admitted and op.verdict.degraded
    return [verdicts(ops + [op]), health(victim), victim.failover.fallback.peek_gauge_deltas()]


def _thread_release_replayed_after_failed_recovery(lib):
    victim = _mk(lib, ckpt_every=1, probes=1)
    victim.set_flow_rules([lib.st.FlowRule("x", count=1e9),
                           lib.st.FlowRule("t", grade=lib.C.FLOW_GRADE_THREAD, count=1)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    op1 = victim.submit_entry("t")
    victim.flush()
    assert op1.verdict.admitted
    inj.fail_fetch(victim.flush_seq + 1)
    victim.submit_entry("x")
    victim.flush()
    assert victim.failover.state == "DEGRADED"
    victim.submit_exit(op1.rows, rt=1, resource="t")
    victim.flush()
    inj.fail_restore()
    assert not victim.failover.try_recover()
    assert victim.failover.try_recover(), victim.failover.last_fault
    obs = [health(victim), lib.states(victim)]
    lib.clock.set_ms(1100)
    _op2, v2 = victim.entry_sync("t")
    assert v2.admitted, "the replayed exit must free the THREAD slot"
    return obs + [verdict(v2), lib.states(victim)]


def _quarantined_deferred_exit_releases_thread_slot(lib):
    victim = _mk(lib, ckpt_every=1, probes=1, depth=1)
    victim.set_flow_rules([lib.st.FlowRule("t", grade=lib.C.FLOW_GRADE_THREAD, count=1)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    op1 = victim.submit_entry("t")
    victim.flush()
    victim.drain()
    assert op1.verdict.admitted
    inj.fail_fetch(victim.flush_seq + 1)
    victim.submit_exit(op1.rows, rt=1, resource="t")
    victim.flush()
    victim.drain()
    assert victim.failover.state == "DEGRADED"
    assert victim.failover.try_recover(), victim.failover.last_fault
    obs = [health(victim), lib.states(victim)]
    lib.clock.set_ms(1100)
    _op2, v2 = victim.entry_sync("t")
    assert v2.admitted, "the quarantined exit's release must be replayed"
    return obs + [verdict(v2)]


def _second_recovery_uses_reanchored_checkpoint(lib):
    victim = _mk(lib, ckpt_every=1, probes=1)
    victim.set_flow_rules([lib.st.FlowRule("x", count=1e9),
                           lib.st.FlowRule("t", grade=lib.C.FLOW_GRADE_THREAD, count=1)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    op1 = victim.submit_entry("t")
    victim.flush()
    assert op1.verdict.admitted
    inj.fail_fetch(victim.flush_seq + 1)
    victim.submit_exit(op1.rows, rt=1, resource="t")
    victim.flush()
    assert victim.failover.state == "DEGRADED"
    assert victim.failover.try_recover(), victim.failover.last_fault
    inj.fail_fetch(victim.flush_seq + 1)
    victim.submit_entry("x")
    victim.flush()
    assert victim.failover.state == "DEGRADED"
    assert victim.failover.try_recover(), victim.failover.last_fault
    obs = [health(victim), lib.states(victim)]
    lib.clock.set_ms(1100)
    _op2, v2 = victim.entry_sync("t")
    assert v2.admitted, "the second restore must see the re-anchored gauge"
    return obs + [verdict(v2)]


def _fallback_thread_admit_seeds_restored_gauge(lib):
    victim = _mk(lib, ckpt_every=1, probes=1)
    victim.set_flow_rules([lib.st.FlowRule("x", count=1e9),
                           lib.st.FlowRule("t", grade=lib.C.FLOW_GRADE_THREAD, count=1)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    _degrade(lib, victim, inj, "x")
    opf = victim.submit_entry("t")
    victim.flush()
    assert opf.verdict.admitted and opf.verdict.degraded
    assert victim.failover.try_recover(), victim.failover.last_fault
    obs = [health(victim), lib.states(victim)]
    victim.submit_exit(opf.rows, rt=1, resource="t")
    victim.flush()
    lib.clock.set_ms(1100)
    a = victim.submit_entry("t")
    b = victim.submit_entry("t")
    victim.flush()
    assert [a.verdict.admitted, b.verdict.admitted] == [True, False]
    return obs + [verdicts([a, b]), lib.states(victim)]


def _param_thread_degraded_pair_cancels_in_restored_gauge(lib):
    victim = _mk(lib, ckpt_every=1, probes=1)
    victim.set_flow_rules([lib.st.FlowRule("x", count=1e9)])
    victim.set_param_rules({"t": [lib.st.ParamFlowRule("t", grade=lib.C.FLOW_GRADE_THREAD, param_idx=0, count=3)]})
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    held = [victim.submit_entry("t", args=("u",)) for _ in range(3)]
    victim.flush()
    assert all(op.verdict.admitted for op in held)
    _degrade(lib, victim, inj, "x")
    opf = victim.submit_entry("t", args=("u",))
    victim.flush()
    assert opf.verdict.admitted and opf.verdict.degraded
    victim.submit_exit(opf.rows, rt=1, resource="t", param_rows=opf.param_thread_rows)
    victim.flush()
    assert victim.failover.try_recover(), victim.failover.last_fault
    obs = [health(victim), lib.states(victim)]
    lib.clock.set_ms(1100)
    op = victim.submit_entry("t", args=("u",))
    victim.flush()
    assert not op.verdict.admitted and op.verdict.reason == lib.E.BLOCK_PARAM
    victim.submit_exit(held[0].rows, rt=1, resource="t", param_rows=held[0].param_thread_rows)
    victim.flush()
    op2 = victim.submit_entry("t", args=("u",))
    victim.flush()
    assert op2.verdict.admitted
    return obs + [verdicts([op, op2]), lib.states(victim)]


def _breaker_mirror_blocks_open_resource(lib):
    victim = _mk(lib, ckpt_every=1)
    victim.set_flow_rules([lib.st.FlowRule("r", count=100)])
    victim.set_degrade_rules([lib.st.DegradeRule("r", grade=lib.C.DEGRADE_GRADE_EXCEPTION_COUNT, count=1,
                                                 time_window=10)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    _degrade(lib, victim, inj)
    with victim._breaker_mirror_lock:
        victim._breaker_state_host[:] = 1  # OPEN
        victim._breaker_mirror_valid = True
    op = victim.submit_entry("r")
    victim.flush()
    assert not op.verdict.admitted and op.verdict.reason == lib.E.BLOCK_DEGRADE and op.verdict.degraded
    return [verdicts([op]), health(victim)]


def _bulk_groups_get_array_verdicts(lib):
    victim = _mk(lib, ckpt_every=1)
    victim.set_flow_rules([lib.st.FlowRule("r", count=5)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    _degrade(lib, victim, inj)
    g = victim.submit_bulk("r", n=8, ts=lib.clock.now_ms())
    victim.flush()
    assert g.admitted.shape == (8,) and int(g.admitted.sum()) == 4
    assert set(np.asarray(g.reason)[~g.admitted]) == {lib.E.BLOCK_FLOW}
    return [(g.admitted, g.reason, g.wait_ms), health(victim)]


def _health_snapshot(lib):
    """The health-snapshot half of test_prometheus_and_health_snapshot."""
    victim = _mk(lib, ckpt_every=1)
    victim.set_flow_rules([lib.st.FlowRule("r", count=100)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    _degrade(lib, victim, inj)
    snap = victim.failover.snapshot()
    assert snap["state"] == "DEGRADED" and snap["counters"]["trips"] == 1
    assert snap["events"] and snap["events"][-1]["to"] == "DEGRADED"
    assert "fetch@" in snap["last_fault"]
    snap.pop("durable")  # wall-clock ages
    return [snap]


def _prometheus_and_health_snapshot(lib):
    """test_prometheus_and_health_snapshot: the health gauge and the trip
    counter in the scrape, and the health snapshot."""
    from torch_transport_env import comparable, module_of, reset_process_counters

    # Every admission traced: head sampling draws from each package's own
    # random source (the trace families are in the scrape).
    victim = _mk(lib, ckpt_every=1, TRACE_SAMPLE_RATE="1.0")
    victim.set_flow_rules([lib.st.FlowRule("r", count=100)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    _degrade(lib, victim, inj)
    reset_process_counters(lib)
    text = module_of(lib, "transport.prometheus").render_metrics(victim)
    assert "sentinel_engine_health 1" in text
    assert "sentinel_engine_failover_trips_total 1" in text
    snap = victim.failover.snapshot()
    assert snap["state"] == "DEGRADED" and snap["counters"]["trips"] == 1
    snap.pop("durable")  # wall-clock ages
    return [comparable(text), snap]


# --- TestMeshGate, TestEngineLifecycle -------------------------------------


def _recovery_refuses_under_mesh_with_actionable_reason(lib):
    victim = _mk(lib, ckpt_every=1, probes=1, retry_ms=0)
    victim.set_flow_rules([lib.st.FlowRule("r", count=100)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    victim.submit_entry("r")
    victim.flush()
    victim.enable_mesh(8)
    inj.fail_dispatch(victim.flush_seq + 1)
    op = victim.submit_entry("r")
    victim.flush()
    assert victim.failover.state == "DEGRADED" and op.verdict.degraded
    assert not victim.failover.recovery_due(lib.clock.now_ms())
    assert not victim.failover.try_recover()
    assert "disable_mesh" in victim.failover.last_fault
    op2 = victim.submit_entry("r")
    victim.flush()
    assert op2.verdict.degraded
    victim.disable_mesh()
    assert victim.failover.try_recover(), victim.failover.last_fault
    return [verdicts([op, op2]), health(victim), lib.states(victim)]


def _reset_returns_to_healthy(lib):
    victim = _mk(lib, ckpt_every=1)
    victim.set_flow_rules([lib.st.FlowRule("r", count=100)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    _degrade(lib, victim, inj)
    victim.reset()
    assert victim.failover.state == "HEALTHY"
    assert victim.failover.snapshot()["checkpoint"] is None
    return [health(victim), lib.states(victim)]


def _close_while_degraded_does_not_raise(lib):
    victim = _mk(lib, ckpt_every=1)
    victim.set_flow_rules([lib.st.FlowRule("r", count=100)])
    inj = lib.FaultInjector().install(victim)
    lib.clock.set_ms(1000)
    victim.submit_entry("r")
    victim.flush()
    inj.fail_fetch(victim.flush_seq + 1)
    ops = [victim.submit_entry("r") for _ in range(2)]
    victim.flush()
    victim.close()
    assert all(op.verdict is not None for op in ops)
    assert not victim.closed_dirty
    return [verdicts(ops), health(victim)]


# --- TestChaosSoak ---------------------------------------------------------


def _random_fault_soak_depth4(lib):
    victim = _mk(lib, ckpt_every=2, probes=1, retry_ms=0, depth=4)
    victim.set_flow_rules([lib.st.FlowRule("a", count=20), lib.st.FlowRule("b", count=5)])
    inj = lib.FaultInjector().install(victim)
    rng = np.random.default_rng(1234)
    all_ops = []
    t = 1000
    for _ in range(30):
        lib.clock.set_ms(t)
        if rng.random() < 0.3:
            kind = rng.integers(0, 3)
            seq = victim.flush_seq + int(rng.integers(1, 4))
            if kind == 0:
                inj.fail_fetch(seq)
            elif kind == 1:
                inj.fail_dispatch(seq)
            else:
                inj.fail_fetch(seq)
                inj.fail_dispatch(seq + 1)
        ops = [victim.submit_entry("a" if rng.random() < 0.7 else "b") for _ in range(int(rng.integers(1, 12)))]
        all_ops.extend(ops)
        victim.flush()
        t += int(rng.integers(50, 400))
    victim.drain()
    assert all(op.verdict is not None for op in all_ops)
    inj.clear()
    if victim.failover.state != "HEALTHY":
        assert victim.failover.try_recover(), victim.failover.last_fault
    ops = [victim.submit_entry("a") for _ in range(4)]
    victim.flush()
    victim.drain()
    assert all(not op.verdict.degraded for op in ops)
    return [verdicts(all_ops), verdicts(ops), health(victim), lib.states(victim), inj.fired]


def _speculative_chaos_interleaved_faults_soak(lib):
    overadmit_max = 16
    flush_every = 6
    victim = _mk(lib, ckpt_every=1, probes=1, retry_ms=10**9, depth=1, SPECULATIVE_ENABLED="true",
                 SPECULATIVE_FLUSH_BATCH=10000, SPECULATIVE_OVERADMIT_MAX=overadmit_max, SPECULATIVE_WINDOW_MS=1000)
    victim.set_flow_rules([lib.st.FlowRule("q", count=5),
                           lib.st.FlowRule("t", grade=lib.C.FLOW_GRADE_THREAD, count=3)])
    inj = lib.FaultInjector().install(victim)
    rng = np.random.default_rng(23)
    live, seen = [], []
    n_since_flush = 0
    t = 1000
    for _ in range(30):
        lib.clock.set_ms(t)
        if rng.random() < 0.35:
            seq = victim.flush_seq + int(rng.integers(1, 3))
            if rng.random() < 0.5:
                inj.fail_fetch(seq)
            else:
                inj.fail_dispatch(seq)
        for _ in range(int(rng.integers(2, 7))):
            _op, v = victim.entry_sync("q")
            seen.append(verdict(v))
            n_since_flush += 1
        for _ in range(int(rng.integers(1, 4))):
            op, v = victim.entry_sync("t")
            seen.append(verdict(v))
            if v.admitted:
                live.append((op, v))
            n_since_flush += 1
        n_exit = int(rng.integers(0, len(live) + 1))
        for op, v in live[:n_exit]:
            victim.submit_exit(op.rows, rt=1, resource="t", speculative=v.speculative)
        live = live[n_exit:]
        if n_since_flush >= flush_every or rng.random() < 0.5:
            victim.flush()
            n_since_flush = 0
        if victim.failover.state == "DEGRADED" and rng.random() < 0.5:
            inj.clear()
            assert victim.failover.try_recover(), victim.failover.last_fault
        t += int(rng.integers(100, 500))
    inj.clear()
    if victim.failover.state != "HEALTHY":
        assert victim.failover.try_recover(), victim.failover.last_fault
    for op, v in live:
        victim.submit_exit(op.rows, rt=1, resource="t", speculative=v.speculative)
    for _ in range(2):
        victim.flush()
        victim.drain()
    assert victim.speculative.max_over_admit_window <= overadmit_max + flush_every * 2
    stats = victim.cluster_node_stats("t")
    assert stats["cur_thread_num"] == 0, stats
    assert victim.speculative.mirror.snapshot()["live_threads"].get("t", 0) == 0
    return [seen, health(victim), victim.speculative.snapshot(), lib.states(victim)]


CASES = {
    "fetch_fault_policy_verdicts_and_oracle_parity": _fetch_fault_policy_verdicts_and_oracle_parity,
    "fetch_hang_watchdog_bounds_the_flush": _fetch_hang_watchdog_bounds_the_flush,
    "dispatch_fault_and_failed_restore_stays_degraded": _dispatch_fault_and_failed_restore_stays_degraded,
    "auto_recovery_from_flush_after_retry_gap": _auto_recovery_from_flush_after_retry_gap,
    "inflight_queue_quarantined_no_raw_exception": _inflight_queue_quarantined_no_raw_exception,
    "no_fault_parity_depths_0_and_2": _no_fault_parity_depths_0_and_2,
    "fail_closed_policy_sheds_with_distinct_reason": _fail_closed_policy_sheds_with_distinct_reason,
    "qps_token_bucket_approximation": _qps_token_bucket_approximation,
    "thread_counter_with_exits": _thread_counter_with_exits,
    "thread_release_replayed_after_failed_recovery": _thread_release_replayed_after_failed_recovery,
    "quarantined_deferred_exit_releases_thread_slot": _quarantined_deferred_exit_releases_thread_slot,
    "second_recovery_uses_reanchored_checkpoint": _second_recovery_uses_reanchored_checkpoint,
    "fallback_thread_admit_seeds_restored_gauge": _fallback_thread_admit_seeds_restored_gauge,
    "param_thread_degraded_pair_cancels_in_restored_gauge": _param_thread_degraded_pair_cancels_in_restored_gauge,
    "breaker_mirror_blocks_open_resource": _breaker_mirror_blocks_open_resource,
    "bulk_groups_get_array_verdicts": _bulk_groups_get_array_verdicts,
    "health_snapshot": _health_snapshot,
    "prometheus_and_health_snapshot": _prometheus_and_health_snapshot,
    "recovery_refuses_under_mesh_with_actionable_reason": _recovery_refuses_under_mesh_with_actionable_reason,
    "reset_returns_to_healthy": _reset_returns_to_healthy,
    "close_while_degraded_does_not_raise": _close_while_degraded_does_not_raise,
    "random_fault_soak_depth4": _random_fault_soak_depth4,
    "speculative_chaos_interleaved_faults_soak": _speculative_chaos_interleaved_faults_soak,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_failover_lockstep(case):
    run_lockstep(CASES[case])


def _spec_chaos_with_system_rule_and_shed_valve(lib):
    """The speculative tier on, a system rule configured and the ingest
    valve armed, under interleaved dispatch and fetch faults: no raw
    exception, the system rule narrows the tier without zeroing it, the
    queue stays bounded, drift stays within the valve, and after quiesce
    the device and mirror THREAD gauges are zero."""
    if lib.name == "jax":
        from sentinel_tpu.rules.system_manager import SystemConfig
    else:
        from sentinel_tpu_torch.rules.system_manager import SystemConfig
    overadmit_max = 16
    bound = 64
    victim = _mk(lib, ckpt_every=1, probes=1, retry_ms=10**9, depth=1, SPECULATIVE_ENABLED="true",
                 SPECULATIVE_FLUSH_BATCH=10000, SPECULATIVE_OVERADMIT_MAX=overadmit_max, SPECULATIVE_WINDOW_MS=1000,
                 INGEST_MAX_PENDING=bound)
    victim.set_flow_rules([lib.st.FlowRule("q", count=5),
                           lib.st.FlowRule("t", grade=lib.C.FLOW_GRADE_THREAD, count=3)])
    victim.set_system_config(SystemConfig(qps=40.0, max_thread=64))
    inj = lib.FaultInjector().install(victim)
    rng = np.random.default_rng(31)
    live, seen = [], []
    n_shed = 0
    t = 1000
    for _ in range(30):
        lib.clock.set_ms(t)
        if rng.random() < 0.35:
            seq = victim.flush_seq + int(rng.integers(1, 3))
            if rng.random() < 0.5:
                inj.fail_fetch(seq)
            else:
                inj.fail_dispatch(seq)
        for _ in range(int(rng.integers(2, 7))):
            _op, v = victim.entry_sync("q", entry_type=lib.C.EntryType.IN)
            seen.append(verdict(v))
            if v.reason == lib.E.BLOCK_SHED:
                n_shed += 1
        for _ in range(int(rng.integers(1, 4))):
            op, v = victim.entry_sync("t")
            seen.append(verdict(v))
            if v.reason == lib.E.BLOCK_SHED:
                n_shed += 1
            elif v.admitted:
                live.append((op, v))
        assert len(victim._entries) <= bound
        n_exit = int(rng.integers(0, len(live) + 1))
        for op, v in live[:n_exit]:
            victim.submit_exit(op.rows, rt=1, resource="t", speculative=v.speculative)
        live = live[n_exit:]
        if rng.random() < 0.6:
            victim.flush()
        if victim.failover.state == "DEGRADED" and rng.random() < 0.5:
            inj.clear()
            assert victim.failover.try_recover(), victim.failover.last_fault
        t += int(rng.integers(100, 500))
    inj.clear()
    if victim.failover.state != "HEALTHY":
        assert victim.failover.try_recover(), victim.failover.last_fault
    for op, v in live:
        victim.submit_exit(op.rows, rt=1, resource="t", speculative=v.speculative)
    for _ in range(2):
        victim.flush()
        victim.drain()
    c = victim.speculative.counters
    assert c["spec_declined"] == 0, c
    assert victim.speculative.max_over_admit_window <= overadmit_max + 12
    stats = victim.cluster_node_stats("t")
    assert stats["cur_thread_num"] == 0, stats
    assert victim.speculative.mirror.snapshot()["live_threads"].get("t", 0) == 0
    assert victim.ingest.counters["shed_entries"] == n_shed
    tele = victim.telemetry.counters_snapshot()
    tele.pop("arena_hits")
    tele.pop("arena_misses")
    return [seen, n_shed, health(victim), victim.speculative.snapshot(), victim.ingest.snapshot()["counters"], tele,
            lib.states(victim), inj.fired]


def test_spec_chaos_with_system_rule_and_shed_valve():
    run_lockstep(_spec_chaos_with_system_rule_and_shed_valve)


def _overhead(lib):
    def run(enabled):
        eng = _mk(lib, enabled=enabled, ckpt_every=64)
        eng.set_flow_rules([lib.st.FlowRule("r", count=1e9)])
        lib.clock.set_ms(1000)
        got = []

        def once():
            ops = [eng.submit_entry("r") for _ in range(64)]
            eng.flush()
            got.append(verdicts(ops))

        once()
        n = 30
        t0 = time.perf_counter()
        for _ in range(n):
            once()
        return (time.perf_counter() - t0) / n, got

    base, got_off = min((run(False) for _ in range(3)), key=lambda r: r[0])
    armed, got_on = min((run(True) for _ in range(3)), key=lambda r: r[0])
    assert got_on == got_off
    assert armed <= base * 1.8, (armed, base)
    return got_on


@pytest.mark.slow
def test_failover_overhead_guard():
    """test_failover_overhead_guard on both packages (slow there too): the
    armed-but-healthy flush within 1.8x the disarmed one, same verdicts."""
    run_lockstep(_overhead)


# --- the build-error stance of the port ------------------------------------


def test_kernel_build_error_raises_and_stays_healthy(monkeypatch, tmp_path):
    """A kernel whose source does not build (the real build path, with an
    nvcc that fails) raises KernelBuildError to the caller with failover
    armed; the engine stays HEALTHY, trips nothing, and the next flush
    runs once the kernel builds."""
    from sentinel_tpu_torch.models.rules import FlowRule
    from sentinel_tpu_torch.runtime import flush as tflush
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.utils import cuda_build
    from sentinel_tpu_torch.utils.clock import ManualClock
    from sentinel_tpu_torch.utils.config import config

    real = tflush.flow_admission
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "false")
    monkeypatch.setattr(cuda_build, "_libs", {})
    broken = {"on": True}

    def flow_admission(*a, **kw):
        if broken["on"]:
            cuda_build.load("flow_admission")  # builds with the failing nvcc
        return real(*a, **kw)

    monkeypatch.setattr(tflush, "flow_admission", flow_admission)
    saved = dict(config._runtime)
    config.set(config.FAILOVER_ENABLED, "true")
    config.set(config.FAILOVER_CHECKPOINT_EVERY, "1")
    try:
        eng = Engine(clock=ManualClock(1000), device="cpu")
        eng.set_flow_rules([FlowRule("r", count=5)])
        op = eng.submit_entry("r")
        with pytest.raises(cuda_build.KernelBuildError, match="CUDA kernel build failed"):
            eng.flush()
        assert eng.failover.state == "HEALTHY"
        assert eng.failover.counters["trips"] == 0 and eng.failover.counters["quarantined_records"] == 0
        assert op.verdict is None
        broken["on"] = False
        op2 = eng.submit_entry("r")
        eng.flush()
        assert op2.verdict.admitted and not op2.verdict.degraded
        eng.close()
    finally:
        config._runtime.clear()
        config._runtime.update(saved)


def test_missing_nvcc_and_unloadable_library_are_build_errors(monkeypatch, tmp_path):
    """The three ways a kernel fails to come up are KernelBuildError (and
    so never a failover trip): no nvcc, a failing nvcc, a library that
    does not load."""
    from sentinel_tpu_torch.runtime.failover import is_build_error
    from sentinel_tpu_torch.utils import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    with pytest.raises(cuda_build.KernelBuildError, match="nvcc not found"):
        cuda_build.nvcc_path()
    bad = cuda_build._target("flow_admission")
    bad.parent.mkdir(parents=True, exist_ok=True)
    bad.write_bytes(b"not a shared library")
    with pytest.raises(cuda_build.KernelBuildError, match="did not load") as info:
        cuda_build.load("flow_admission")
    assert is_build_error(info.value) and not is_build_error(RuntimeError("CUDA error 700"))
