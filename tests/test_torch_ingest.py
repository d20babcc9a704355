"""The port's ingest valve (sentinel_tpu_torch/runtime/ingest.py) against
the JAX package's, on the CPU.

Every case of tests/test_ingest_shed.py that the port has runs here on
both engines in lockstep (tests/torch_lockstep.py): the same submits
under the same ManualClock and config. The verdicts (admitted, reason,
wait_ms, limit_type, provenance marks, the blocking rule), the valve's
counters and the telemetry bus's shed counter must be identical, and
each case's own assertions run on both. The trace, block-log and
Prometheus half of ``TestProvenance::test_trace_and_blocklog_and_prometheus``
waits for ROADMAP Queue 1 items 8 and 11; its telemetry counter is held
here.

Also the pin of the fault this slice repaired: before the valve was
ported the port ignored ``sentinel.tpu.ingest.*`` and admitted every
entry (three passes where the JAX engine gives a pass and two
BLOCK_SHED "queue" verdicts)."""

import pytest

from torch_lockstep import run_lockstep, verdict, verdicts

ING = dict(SPECULATIVE_FLUSH_BATCH=100000)


def _mk(lib, spec=False, max_pending=0, max_pending_bulk=0, deadline_ms=0, depth=0, **extra):
    return lib.mk(depth=depth, SPECULATIVE_ENABLED="true" if spec else "false", INGEST_MAX_PENDING=max_pending,
                  INGEST_MAX_PENDING_BULK=max_pending_bulk, INGEST_DEADLINE_MS=deadline_ms, **ING, **extra)


def _valve(eng):
    snap = eng.ingest.snapshot()
    return (snap["armed"], snap["max_pending"], snap["max_pending_bulk"], snap["deadline_ms"], snap["counters"],
            eng.telemetry.counters_snapshot()["ingest_shed"])


# --- the repaired fault: the valve's switches were ignored ------------------


def _pin_max_pending(lib):
    eng = _mk(lib, max_pending=1)
    eng.set_flow_rules([lib.st.FlowRule("r", count=100)])
    ops = [eng.submit_entry("r") for _ in range(3)]
    eng.flush()
    out = verdicts(ops)
    assert [(v[0], v[1], v[3]) for v in out] == [(True, 0, ""), (False, lib.E.BLOCK_SHED, "queue"),
                                                 (False, lib.E.BLOCK_SHED, "queue")]
    return out, _valve(eng)


def _pin_max_pending_bulk(lib):
    eng = _mk(lib, max_pending_bulk=4)
    eng.set_flow_rules([lib.st.FlowRule("r", count=100)])
    g1, g2, g3 = eng.submit_bulk("r", 3), eng.submit_bulk("r", 2), eng.submit_bulk("r", 1)
    eng.flush()
    assert g1.admitted_count == 3 and (g2.reason == lib.E.BLOCK_SHED).all() and g3.admitted_count == 1
    return [g1.admitted, g1.reason, g2.admitted, g2.reason, g3.admitted, g3.reason], _valve(eng)


def _pin_deadline(lib):
    eng = _mk(lib, deadline_ms=50)
    eng.set_flow_rules([lib.st.FlowRule("r", count=100)])
    eng.ingest.force_latency_ms(200.0)
    ops = [eng.submit_entry("r") for _ in range(3)]
    eng.ingest.force_latency_ms(None)
    ops.append(eng.submit_entry("r"))
    eng.flush()
    out = verdicts(ops)
    assert [v[3] for v in out] == ["deadline"] * 3 + [""]
    return out, _valve(eng)


def _pin_batch_window(lib):
    """The window switch arms the engine's batch window, and a window of
    requests decides as the sequential path would. The window (a wall-clock
    deadline) is too long to close between the three joins, so the batch
    closes by count on both sides."""
    eng = _mk(lib, INGEST_BATCH_WINDOW_MS=10000, INGEST_BATCH_MAX=3)
    eng.set_flow_rules([lib.st.FlowRule("r", count=2)])
    win = eng.ingest_window
    assert win.armed and win.window_ms == 10000.0 and win.batch_max == 3
    mod = __import__(type(win).__module__, fromlist=["WindowRequest"])
    reqs = [win.join(mod.WindowRequest("r", "sentinel_default_context", "", 1, lib.C.EntryType.OUT, (), 0, None))
            for _ in range(3)]
    for r in reqs:
        assert r.event.wait(30)
    win.close()
    return [verdict(r.verdict) for r in reqs], win.snapshot()["flushes"], eng.telemetry.counters_snapshot()[
        "ingest_window_reqs"]


@pytest.mark.parametrize("pin", [_pin_max_pending, _pin_max_pending_bulk, _pin_deadline, _pin_batch_window],
                         ids=["max_pending", "max_pending_bulk", "deadline", "batch_window"])
def test_ingest_switches_are_honoured(pin):
    run_lockstep(pin)


# --- TestQueueBound ----------------------------------------------------------


def _saturation(lib, depth):
    bound = 16
    eng = _mk(lib, spec=True, max_pending=bound, depth=depth)
    eng.set_flow_rules([lib.st.FlowRule("t", grade=lib.C.FLOW_GRADE_THREAD, count=100)])
    lib.clock.set_ms(1000)
    live, shed, seen = [], 0, []
    for _ in range(100):
        op, v = eng.entry_sync("t")
        seen.append(verdict(v))
        if v.reason == lib.E.BLOCK_SHED:
            shed += 1
            assert not v.admitted
        elif v.admitted:
            live.append(op)
        assert len(eng._entries) <= bound
    assert shed == 100 - bound and len(live) == bound
    assert eng.ingest.counters["shed_entries"] == shed == eng.ingest.counters["shed_queue"]
    eng.flush()
    eng.drain()
    for op in live:
        eng.submit_exit(op.rows, rt=1, resource="t", speculative=True)
    eng.flush()
    eng.drain()
    stats = eng.cluster_node_stats("t")
    assert stats["cur_thread_num"] == 0
    assert eng.speculative.mirror.snapshot()["live_threads"].get("t", 0) == 0
    _, v = eng.entry_sync("t")
    assert v.reason != lib.E.BLOCK_SHED and v.admitted
    eng.flush()
    eng.drain()
    return seen, verdict(v), _valve(eng), lib.states(eng)


@pytest.mark.parametrize("depth", [0, 2])
def test_saturation_sheds_and_recovers_with_zero_gauges(depth):
    run_lockstep(_saturation, depth)


def _bulk_bound(lib):
    eng = _mk(lib, max_pending_bulk=64)
    eng.set_flow_rules([lib.st.FlowRule("b", count=1e9)])
    lib.clock.set_ms(1000)
    g1 = eng.submit_bulk("b", 48)
    g2 = eng.submit_bulk("b", 32)
    assert (g2.reason == lib.E.BLOCK_SHED).all() and g2.admitted_count == 0
    assert eng.ingest.counters["shed_rows"] == 32
    eng.flush()
    eng.drain()
    assert g1.admitted_count == 48
    g3 = eng.submit_bulk("b", 32)
    eng.flush()
    eng.drain()
    assert g3.admitted_count == 32
    return [g1.admitted, g2.admitted, g2.reason, g3.admitted, g3.reason], _valve(eng), lib.states(eng)


def test_bulk_bound():
    run_lockstep(_bulk_bound)


def _exits_never_shed(lib):
    eng = _mk(lib, spec=True, max_pending=2)
    eng.set_flow_rules([lib.st.FlowRule("x", grade=lib.C.FLOW_GRADE_THREAD, count=10)])
    lib.clock.set_ms(1000)
    ops, seen = [], []
    for _ in range(4):
        op, v = eng.entry_sync("x")
        seen.append(verdict(v))
        if v.admitted and v.reason != lib.E.BLOCK_SHED:
            ops.append(op)
    assert len(ops) == 2
    for op in ops:
        eng.submit_exit(op.rows, rt=1, resource="x", speculative=True)
    assert len(eng._exits) == 2
    eng.flush()
    eng.drain()
    assert eng.cluster_node_stats("x")["cur_thread_num"] == 0
    return seen, _valve(eng), lib.states(eng)


def test_exits_are_never_shed():
    run_lockstep(_exits_never_shed)


def _submit_many_overflow(lib):
    eng = _mk(lib, max_pending=4)
    eng.set_flow_rules([lib.st.FlowRule("m", count=1e9)])
    lib.clock.set_ms(1000)
    ops = eng.submit_many([{"resource": "m"} for _ in range(8)])
    shed = [op for op in ops if op._verdict is not None and op._verdict.reason == lib.E.BLOCK_SHED]
    assert len(shed) == 4 and len(eng._entries) == 4
    eng.flush()
    eng.drain()
    assert all(op.verdict is not None and op.verdict.admitted for op in ops if op not in shed)
    for _ in range(4):
        eng.submit_entry("m")
    ops2 = eng.submit_many([{"resource": "m"} for _ in range(3)])
    assert all(op._verdict is not None and op._verdict.reason == lib.E.BLOCK_SHED for op in ops2)
    eng.flush()
    eng.drain()
    return verdicts(ops), verdicts(ops2), _valve(eng)


def test_submit_many_sheds_only_the_overflow():
    run_lockstep(_submit_many_overflow)


# --- TestDeadline ------------------------------------------------------------


def _deadline(lib):
    eng = _mk(lib, deadline_ms=50)
    eng.set_flow_rules([lib.st.FlowRule("d", count=1e9)])
    lib.clock.set_ms(1000)
    eng.ingest.force_latency_ms(200.0)
    _, v = eng.entry_sync("d")
    assert v.reason == lib.E.BLOCK_SHED and v.limit_type == "deadline"
    assert eng.ingest.counters["shed_deadline"] == 1
    eng.ingest.force_latency_ms(None)
    _, v2 = eng.entry_sync("d")
    assert v2.reason != lib.E.BLOCK_SHED and v2.admitted
    eng.flush()
    eng.drain()
    return verdict(v), verdict(v2), _valve(eng)


def test_deadline_shed_and_recovery():
    run_lockstep(_deadline)


def _ewma(lib, depth):
    eng = _mk(lib, deadline_ms=100000, depth=depth)
    eng.set_flow_rules([lib.st.FlowRule("e", count=1e9)])
    lib.clock.set_ms(1000)
    ops = []
    for _ in range(3):
        ops += [eng.submit_entry("e") for _ in range(4)]
        eng.flush()
    eng.drain()
    snap = eng.ingest.snapshot()
    assert snap["settle_ewma_ms"] > 0.0 and snap["estimate_ms"] > 0.0
    return verdicts(ops), _valve(eng)  # the EWMA itself is a wall time: its sign, not its value, is shared


@pytest.mark.parametrize("depth", [0, 2])
def test_settle_latency_feeds_the_ewma(depth):
    run_lockstep(_ewma, depth)


# --- TestProvenance ----------------------------------------------------------


def _shed_counted(lib):
    eng = _mk(lib, max_pending=1)
    eng.set_flow_rules([lib.st.FlowRule("p", count=1e9)])
    lib.clock.set_ms(1000)
    eng.submit_entry("p")
    _, v = eng.entry_sync("p")
    assert v.reason == lib.E.BLOCK_SHED
    assert eng.telemetry.counters_snapshot()["ingest_shed"] == 1
    eng.flush()
    eng.drain()
    return verdict(v), _valve(eng)


def test_shed_counted_on_the_telemetry_bus():
    run_lockstep(_shed_counted)


def _api_shed_error(lib):
    lib.config.set(lib.config.INGEST_MAX_PENDING, "1")
    eng = lib.api.reset(clock=lib.clock, **lib.device_kw)
    lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("api", count=1e9)])
    lib.clock.set_ms(1000)
    eng.submit_entry("api")
    try:
        lib.st.entry("api")
        raised = None
    except lib.E.BlockError as exc:
        raised = type(exc).__name__
    assert raised == "IngestShedError"
    eng.flush()
    eng.drain()
    return raised, _valve(eng)


def test_api_entry_raises_ingest_shed_error():
    run_lockstep(_api_shed_error)


def _disarmed(lib):
    eng = _mk(lib)
    assert not eng.ingest.armed
    eng.set_flow_rules([lib.st.FlowRule("z", count=5)])
    lib.clock.set_ms(1000)
    vs = [verdict(eng.entry_sync("z")[1]) for _ in range(7)]
    assert [v[0] for v in vs] == [True] * 5 + [False] * 2
    assert eng.ingest.counters["shed_entries"] == 0
    return vs, _valve(eng)


def test_disarmed_is_free_and_unchanged():
    run_lockstep(_disarmed)


def test_verdict_fields_match_jax():
    """Repaired: the port's Verdict lacked ``slot_name``, so a positional
    Verdict set ``degraded`` where the JAX one sets ``slot_name``."""
    from sentinel_tpu.runtime.engine import Verdict as JVerdict
    from sentinel_tpu_torch.runtime.engine import Verdict

    assert Verdict._fields == JVerdict._fields
    assert Verdict._field_defaults == JVerdict._field_defaults
    v = Verdict(True, 0, 0, None, "", "slot")
    assert v.slot_name == "slot" and not v.degraded
