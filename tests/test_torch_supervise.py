"""The engine supervisor's in-process pieces on the port
(sentinel_tpu_torch/ipc/supervise.py, the plane's re-attach and handoff,
the worker's reconnect and death confirmation, the failover tier's
one-shot checkpoint and the port's ``Backoff``), in lockstep with the
JAX package through ``tests/torch_lockstep.run_lockstep``.

* F2 (ROADMAP queue 3): ``FailoverManager.request_checkpoint`` arms a
  one-shot checkpoint that the next flush takes whatever the cadence; the
  forced checkpoint and the durable file spilled from it equal the JAX
  package's.
* The in-process cases of tests/test_restart.py (``TestReattachReassert``,
  ``TestSupervisorUnits``) and tests/test_standby.py
  (``TestPlannedHandoffInProcess``, ``TestDeathConfirmation``): a plane
  re-attached to the same named rings, the client's ledger re-assert and
  buffered-exit replay, the HANDOFF hold, the pid-probe confirmation of a
  stale heartbeat. Each scenario runs on both packages (each its own
  engine, plane and client on the CPU) and the observations must agree.
* ``Backoff`` against the JAX ``Backoff`` with the jitter's random source
  pinned on both sides.

Real processes (the supervisor's children) are in
tests/test_torch_standby.py. Tolerance: exact equality."""

from __future__ import annotations

import importlib
import random
import subprocess
import threading
import time
import uuid

import pytest

from torch_lockstep import canon, run_lockstep


def _wait_for(pred, timeout_s=30.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _pkg(lib):
    return lib.Engine.__module__.split(".")[0]


def _ipc(lib):
    """The package's IngestPlane and IngestClient."""
    pkg = _pkg(lib)
    plane = importlib.import_module(f"{pkg}.ipc.plane")
    worker = importlib.import_module(f"{pkg}.ipc.worker")
    return plane.IngestPlane, worker.IngestClient


def _supervise(lib):
    return importlib.import_module(f"{_pkg(lib)}.ipc.supervise")


# --- F2: the one-shot checkpoint of a planned handoff -------------------------


def _forced_checkpoint(lib, tmp, depth):
    """Cadence 8; two flushes checkpoint nothing; ``request_checkpoint()``
    then makes flush 3 checkpoint, and flush 4 (the flag spent) does not.
    The spilled file holds flush 3's state."""
    path = str(tmp / f"{lib.name}-f2.bin")
    eng = lib.mk(depth=depth, FAILOVER_ENABLED="true", FAILOVER_CHECKPOINT_EVERY=8, FAILOVER_CKPT_PATH=path,
                 FAILOVER_CKPT_INTERVAL_MS=0)
    eng.set_flow_rules([lib.st.FlowRule("r", count=5),
                        lib.st.FlowRule("t", grade=lib.C.FLOW_GRADE_THREAD, count=3)])
    fo = eng.failover
    lib.clock.set_ms(5000)
    for _ in range(2):
        for res in ("r", "t"):
            eng.submit_entry(res, ts=5000)
        eng.flush()
    eng.drain()
    before = (fo.counters["checkpoints"], fo._ckpt is None)
    fo.request_checkpoint()
    ops = [eng.submit_entry("r", ts=5000) for _ in range(3)]
    eng.flush()
    eng.drain()
    forced = (eng.flush_seq, fo.counters["checkpoints"], fo._ckpt.seq, fo._ckpt.now_ms)
    eng.submit_entry("t", ts=5000)
    eng.flush()
    eng.drain()
    after = (eng.flush_seq, fo.counters["checkpoints"], fo._ckpt.seq)
    # The writer thread spills flush 3's checkpoint; wait for it, then
    # the synchronous spill of the handoff writes the same one again.
    _wait_for(lambda: fo.last_durable is not None and fo.last_durable[1] == fo._ckpt.seq, what="the durable write")
    spilled = fo.spill_durable_now()
    header, leaves = lib.durable.read_checkpoint(path)
    head = {k: header[k] for k in ("seq", "components", "fingerprints", "node_keys", "stats_rows", "win")}
    verdicts = [(op.verdict.admitted, int(op.verdict.reason)) for op in ops]
    eng.close()
    return [before, forced, after, spilled, head, leaves, verdicts]


@pytest.mark.parametrize("depth", [0, 2])
def test_request_checkpoint_forces_one_checkpoint(depth, tmp_path):
    """F2: the forced flush's checkpoint and the spilled durable file equal
    the JAX package's (the parent port had no ``request_checkpoint``)."""
    out = run_lockstep(_forced_checkpoint, tmp_path, depth)
    before, forced, after = out[0], out[1], out[2]
    assert before == [0, True]
    assert forced[1:3] == [1, 3] and after[1:] == [1, 3]
    assert out[3] is True


# --- the plane's re-attach and the client's reconnect (test_restart.py) -------


def _reattach_cfg(depth: int = 0, **extra):
    cfg = dict(IPC_SHM_PREFIX=f"stpu-t-{uuid.uuid4().hex[:8]}", IPC_HEARTBEAT_MS=50, IPC_ENGINE_DEAD_MS=300,
               SPECULATIVE_ENABLED="true", PIPELINE_DEPTH=depth, INITIAL_ROWS=256)
    cfg.update(extra)
    return cfg


def _close_all(*objs):
    for o in objs:
        if o is not None:
            o.close()


def _gauges(lib, eng, res):
    eng.flush()
    eng.drain()
    return (eng.cluster_node_stats(res)["cur_thread_num"],
            eng.speculative.mirror.snapshot()["live_threads"].get(res, 0))


def _oracle_thread_verdicts(lib, live: int, probes: int = 3):
    """A never-killed engine holding ``live`` admissions of the THREAD rule
    (count 3): the next ``probes`` verdicts."""
    oracle = lib.mk(IPC_SHM_PREFIX="")
    oracle.set_flow_rules([lib.st.FlowRule("tr", count=3, grade=lib.C.FLOW_GRADE_THREAD)])
    for _ in range(live):
        oracle.submit_entry("tr")
    oracle.flush()
    oracle.drain()
    want = []
    for _ in range(probes):
        op = oracle.submit_entry("tr")
        oracle.flush()
        oracle.drain()
        want.append((bool(op.verdict.admitted), int(op.verdict.reason)))
    oracle.close()
    return want


def _kill_reattach_reassert(lib, depth):
    """Engine A dies holding the client's two live THREAD admissions; engine
    B re-attaches to the same rings, the client re-asserts its ledger and
    replays the completion it buffered in the dead window; the verdicts
    after equal a never-killed engine's and both gauges end at 0."""
    IngestPlane, IngestClient = _ipc(lib)
    cfg = _reattach_cfg(depth)
    rule = lambda: [lib.st.FlowRule("tr", count=3, grade=lib.C.FLOW_GRADE_THREAD)]  # noqa: E731
    a = lib.mk(depth=depth, **cfg)
    a.set_flow_rules(rule())
    plane_a = IngestPlane(a)
    cli = IngestClient(plane_a.channel(0), 0)
    b = plane_b = None
    obs = []
    try:
        for _ in range(2):
            v = cli.entry("tr", timeout_ms=60000)
            assert v.admitted and not v.degraded
        a.flush()
        a.drain()
        assert a.cluster_node_stats("tr")["cur_thread_num"] == 2
        plane_a.abandon()  # the kill -9 surrogate: threads stop, segments stay
        a.close()
        _wait_for(lambda: not cli.engine_alive(), what="engine death")
        assert cli.exit("tr")
        obs.append(cli.snapshot()["buffered_exits"])
        obs.append(cli.entry("tr", timeout_ms=400).degraded)
        b = lib.mk(depth=depth, **cfg)
        b.set_flow_rules(rule())
        plane_b = IngestPlane(b)
        obs.append((plane_b.attached, plane_b.engine_epoch))
        _wait_for(lambda: cli.counters["reconnects"] >= 1 and plane_b.snapshot()["counters"]["exits"] >= 1,
                  what="client reconnect + exit replay")
        snap = plane_b.snapshot()["counters"]
        obs.append((snap["worker_reconnects"], snap["reasserts"]))
        obs.append(_gauges(lib, b, "tr"))
        want = _oracle_thread_verdicts(lib, live=1)
        got = [(bool(v.admitted), int(v.reason)) for v in (cli.entry("tr", timeout_ms=60000) for _ in range(3))]
        assert got == want, (got, want)
        obs.append(got)
        for _ in range(3):
            cli.exit("tr")
        _wait_for(lambda: plane_b.snapshot()["counters"]["exits"] >= 4, what="exits drained")
        obs.append(_gauges(lib, b, "tr"))
        obs.append(cli.snapshot()["live_admissions"])
    finally:
        cli.close()
        _close_all(plane_b, b)
    return obs


@pytest.mark.parametrize("depth", [0, 2])
def test_kill_reattach_reassert_parity_and_gauges(depth):
    obs = run_lockstep(_kill_reattach_reassert, depth)
    # One buffered exit, a policy verdict in the outage, the successor at
    # epoch 2 with 1 reconnect and 2 re-asserts, 2 - 1 = 1 live on the device
    # and in the mirror; admit, admit, block; both gauges 0 after quiesce.
    assert obs[:5] == canon([1, True, [True, 2], [1, 2], [1, 1]])
    assert [g[0] for g in obs[5]] == [True, True, False] and obs[6:] == [[0, 0], 0]


def _idle_client_reconnect(lib):
    """An idle client's zero-row re-assert must carry the new world's
    generation: the plane counts the reconnect, no stale frame."""
    IngestPlane, IngestClient = _ipc(lib)
    cfg = _reattach_cfg()
    a = lib.mk(**cfg)
    plane_a = IngestPlane(a)
    cli = IngestClient(plane_a.channel(0), 0)
    b = plane_b = None
    try:
        a.set_flow_rules([lib.st.FlowRule("r", count=1e9)])
        assert cli.entry("r", timeout_ms=60000).admitted
        assert cli.exit("r")
        _wait_for(lambda: plane_a.snapshot()["counters"]["exits"] >= 1, what="exit drained")
        plane_a.abandon()
        a.close()
        _wait_for(lambda: not cli.engine_alive(), what="engine death")
        b = lib.mk(**cfg)
        plane_b = IngestPlane(b)
        _wait_for(lambda: plane_b.snapshot()["counters"]["worker_reconnects"] >= 1, what="plane-side reconnect")
        return [cli.counters["reconnects"], plane_b.snapshot()["counters"]["stale_frames"]]
    finally:
        cli.close()
        _close_all(plane_b, b)


def test_idle_client_reconnect_counts_plane_side():
    assert run_lockstep(_idle_client_reconnect) == [1, 0]


def _first_boot_merges_ledger(lib):
    """Admissions decided between the plane's boot bump and the client's
    first beat land in the new-world ledger; the first observation of the
    boot folds them into the main ledger (not a restart)."""
    IngestPlane, IngestClient = _ipc(lib)
    a = lib.mk(**_reattach_cfg())
    a.set_flow_rules([lib.st.FlowRule("r", count=1e9)])
    plane_a = IngestPlane(a)
    cli = IngestClient(plane_a.channel(0), 0, heartbeat=False)
    try:
        with cli._lock:
            cli._boot = 0  # attach before the first boot: the pre-bump view
        assert cli.entry("r", timeout_ms=60000).admitted
        with cli._lock:
            before = (sum(cli._live_new.values()), sum(cli._live.values()))
        cli._maybe_reconnect()  # the beat tick's body
        with cli._lock:
            after = (cli._boot == plane_a.control.engine_boot(), sum(cli._live.values()), len(cli._live_new))
        return [before, after, cli.counters["reconnects"]]
    finally:
        cli.close()
        _close_all(plane_a, a)


def test_first_boot_observation_merges_new_world_ledger():
    assert run_lockstep(_first_boot_merges_ledger) == [[1, 0], [True, 1, 0], 0]


def _reconnect_disabled(lib):
    """``ipc.reconnect.enabled=false``: no ledger, no buffering (a
    dead-window exit goes to the ring and the new plane gates it away), no
    re-assert on an epoch bump."""
    IngestPlane, IngestClient = _ipc(lib)
    cfg = _reattach_cfg(IPC_RECONNECT="false")
    a = lib.mk(**cfg)
    a.set_flow_rules([lib.st.FlowRule("r", count=1e9)])
    plane_a = IngestPlane(a)
    cli = IngestClient(plane_a.channel(0), 0)
    b = plane_b = None
    try:
        obs = [cli.entry("r", timeout_ms=60000).admitted, cli.snapshot()["live_admissions"]]
        plane_a.abandon()
        a.close()
        _wait_for(lambda: not cli.engine_alive(), what="engine death")
        obs += [cli.exit("r"), cli.snapshot()["buffered_exits"]]
        b = lib.mk(**cfg)
        b.set_flow_rules([lib.st.FlowRule("r", count=1e9)])
        plane_b = IngestPlane(b)
        _wait_for(cli.engine_alive, what="engine up")
        time.sleep(0.3)  # several beat ticks: no re-assert may fire
        return obs + [cli.counters["reconnects"], plane_b.snapshot()["counters"]["worker_reconnects"]]
    finally:
        cli.close()
        _close_all(plane_b, b)


def test_reconnect_disabled_is_pr14_behavior():
    assert run_lockstep(_reconnect_disabled) == [True, 0, True, 0, 0, 0]


# --- the supervisor's segments (TestSupervisorUnits) --------------------------


def _stale_segments(lib):
    """A crashed SUPERVISOR leaves its named segments behind; a relaunch on
    the same prefix unlinks them and creates them fresh."""
    import multiprocessing

    sv = _supervise(lib)
    ctx = multiprocessing.get_context("spawn")
    h = sv.make_handles(ctx, f"stpu-su-{uuid.uuid4().hex[:8]}", n_workers=1)
    stale = sv.create_segments(h)
    for s in stale:
        s.close()  # the crash: handles gone, segments left
    fresh = sv.create_segments(h)
    try:
        return [len(stale), len(fresh), [type(s).__name__ for s in fresh]]
    finally:
        sv.destroy_segments(fresh)


def test_create_segments_survives_stale_leftovers():
    assert run_lockstep(_stale_segments)[:2] == [3, 3]


# --- the planned handoff, in process (TestPlannedHandoffInProcess) -------------


def _handoff_cfg(depth: int = 0, **extra):
    cfg = dict(IPC_SHM_PREFIX=f"stpu-ho-{uuid.uuid4().hex[:8]}", IPC_HEARTBEAT_MS=50, IPC_ENGINE_DEAD_MS=300,
               IPC_HANDOFF_WAIT_MS=30000, SPECULATIVE_ENABLED="true", PIPELINE_DEPTH=depth, INITIAL_ROWS=256)
    cfg.update(extra)
    return cfg


def _handoff_holds(lib, depth):
    """The old plane publishes HANDOFF and drains; an admission that arrives
    in the gap is HELD, not policy-served; the successor re-homes the
    client's ledger; the verdicts after equal a never-killed engine's; both
    gauges end at 0; no verdict was policy-served."""
    IngestPlane, IngestClient = _ipc(lib)
    cfg = _handoff_cfg(depth)
    rule = lambda: [lib.st.FlowRule("tr", count=3, grade=lib.C.FLOW_GRADE_THREAD)]  # noqa: E731
    a = lib.mk(depth=depth, **cfg)
    a.set_flow_rules(rule())
    plane_a = IngestPlane(a)
    cli = IngestClient(plane_a.channel(0), 0)
    b = plane_b = None
    held: dict = {}
    obs = []
    try:
        for _ in range(2):
            v = cli.entry("tr", timeout_ms=60000)
            assert v.admitted and not v.degraded
        a.flush()
        a.drain()
        stats = plane_a.handoff()
        obs.append((stats["drained"], a.ipc_plane is None))
        a.close()
        t = threading.Thread(target=lambda: held.update(verdict=cli.entry("tr", timeout_ms=60000)), daemon=True)
        t.start()
        _wait_for(lambda: cli.counters["handoff_holds"] >= 1, what="handoff hold")
        obs.append("verdict" in held)  # held, not answered
        b = lib.mk(depth=depth, **cfg)
        b.set_flow_rules(rule())
        plane_b = IngestPlane(b)
        obs.append((plane_b.attached, plane_b.engine_epoch))
        t.join(60.0)
        assert not t.is_alive(), "held entry never released"
        v = held["verdict"]
        obs.append((bool(v.admitted), bool(v.degraded), cli.counters["policy_served"], cli.counters["reconnects"],
                    plane_b.snapshot()["counters"]["reasserts"]))
        b.flush()
        b.drain()
        obs.append(b.cluster_node_stats("tr")["cur_thread_num"])
        want = _oracle_thread_verdicts(lib, live=3)
        got = [(bool(v.admitted), int(v.reason)) for v in (cli.entry("tr", timeout_ms=60000) for _ in range(3))]
        assert got == want, (got, want)
        obs.append(got)
        for _ in range(3):
            cli.exit("tr")
        _wait_for(lambda: plane_b.snapshot()["counters"]["exits"] >= 3, what="exits drained")
        obs.append(_gauges(lib, b, "tr"))
        obs.append(cli.counters["policy_served"])
    finally:
        cli.close()
        _close_all(plane_b, b)
    return obs


@pytest.mark.parametrize("depth", [0, 2])
def test_handoff_holds_then_successor_parity_and_gauges(depth):
    obs = run_lockstep(_handoff_holds, depth)
    assert obs[:5] == canon([[True, True], False, [True, 2], [True, False, 0, 1, 2], 3])
    assert [g[0] for g in obs[5]] == [False, False, False] and obs[6:] == [[0, 0], 0]


def _handoff_hold_expires(lib):
    """No successor attaches: ``handoff.wait.ms`` ends the hold and the
    caller gets an honest policy verdict."""
    IngestPlane, IngestClient = _ipc(lib)
    a = lib.mk(**_handoff_cfg(IPC_HANDOFF_WAIT_MS=400))
    a.set_flow_rules([lib.st.FlowRule("r", count=1e9)])
    plane_a = IngestPlane(a)
    cli = IngestClient(plane_a.channel(0), 0)
    try:
        obs = [cli.entry("r", timeout_ms=60000).admitted, cli.exit("r")]
        plane_a.handoff()
        a.close()
        t0 = time.monotonic()
        v = cli.entry("r", timeout_ms=60000)
        waited_ms = (time.monotonic() - t0) * 1e3
        assert waited_ms >= 300, waited_ms  # held to the bound
        return obs + [bool(v.degraded), cli.counters["handoff_holds"], cli.counters["policy_served"]]
    finally:
        cli.close()


def test_handoff_hold_expires_to_policy_when_no_successor():
    assert run_lockstep(_handoff_hold_expires) == [True, True, True, 1, 1]


# --- sub-second death detection (TestDeathConfirmation) -----------------------


def _confirm_plane(lib, dead_ms, confirm_ms):
    IngestPlane, IngestClient = _ipc(lib)
    eng = lib.mk(IPC_SHM_PREFIX=f"stpu-fp-{uuid.uuid4().hex[:8]}", IPC_HEARTBEAT_MS=50, IPC_ENGINE_DEAD_MS=dead_ms,
                 IPC_ENGINE_DEAD_CONFIRM_MS=confirm_ms, INITIAL_ROWS=256)
    eng.set_flow_rules([lib.st.FlowRule("fp", count=1e9)])
    plane = IngestPlane(eng)
    return eng, plane, IngestClient(plane.channel(0), 0)


def _pegged_alive(lib):
    """Sub-second ``dead.ms`` with the confirmation armed: an engine whose
    heartbeat publisher is starved (process and drainer alive) is never
    declared dead, on any poll; the episode closes as a counted false
    alarm once the heartbeat resumes."""
    eng, plane, cli = _confirm_plane(lib, 150, 10000)
    try:
        _wait_for(cli.engine_alive, what="first heartbeat")
        plane._publish_control = lambda *a, **k: None  # the pegged box
        deadline = time.monotonic() + 10.0
        while cli.counters["dead_suspicions"] == 0:
            assert cli.engine_alive(), "pegged-but-alive declared dead"
            assert time.monotonic() < deadline, "wall never went stale"
            time.sleep(0.01)
        for _ in range(50):
            assert cli.engine_alive(), "pegged-but-alive declared dead"
            time.sleep(0.005)
        v = cli.entry("fp", timeout_ms=60000)
        obs = [cli.counters["dead_declared"], bool(v.admitted), bool(v.degraded), cli.exit("fp"),
               cli.counters["policy_served"]]
        del plane._publish_control  # the class method again
        deadline = time.monotonic() + 10.0
        while cli.counters["dead_false_alarms"] == 0:
            cli.engine_alive()
            assert time.monotonic() < deadline, "false alarm lost"
            time.sleep(0.01)
        return obs + [cli.engine_alive()]
    finally:
        cli.close()
        _close_all(plane, eng)


def test_pegged_alive_engine_never_declared_dead():
    assert run_lockstep(_pegged_alive) == [0, True, False, True, 0, True]


def _confirmation_off(lib):
    """``dead.confirm.ms=0`` (the default): a stale wall is death, no pid
    probe, no suspicion counted."""
    eng, plane, cli = _confirm_plane(lib, 150, 0)
    try:
        _wait_for(cli.engine_alive, what="first heartbeat")
        plane._publish_control = lambda *a, **k: None
        _wait_for(lambda: not cli.engine_alive(), what="stale-wall death")
        return [cli.counters["dead_suspicions"], cli.counters["dead_false_alarms"]]
    finally:
        del plane._publish_control
        cli.close()
        _close_all(plane, eng)


def test_confirmation_off_is_pr15_stale_wall_death():
    assert run_lockstep(_confirmation_off) == [0, 0]


def _dead_pid_declared(lib):
    """The confirmation must not delay a really dead engine: the pid probe
    fails and the engine is declared dead on the first confirm pass."""
    p = subprocess.Popen(["true"])
    p.wait()  # a pid that provably does not exist
    eng, plane, cli = _confirm_plane(lib, 150, 60000)
    try:
        _wait_for(cli.engine_alive, what="first heartbeat")
        plane.control.set_engine_pid(p.pid)
        plane.abandon()  # the kill -9 surrogate: the wall goes stale
        eng.close()
        t0 = time.monotonic()
        _wait_for(lambda: not cli.engine_alive(), timeout_s=10.0, what="confirmed death")
        assert time.monotonic() - t0 < 5.0  # not bounded by confirm.ms
        return [cli.counters["dead_declared"] >= 1]
    finally:
        cli.close()


def test_dead_pid_declared_within_probe_window():
    assert run_lockstep(_dead_pid_declared) == [True]


# --- Backoff ------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(base_s=0.2, cap_s=10.0), dict(base_s=0.0001, cap_s=0.0005, factor=3.0),
                                dict(base_s=1.0, cap_s=30.0, jitter=0.0), dict(base_s=0.5, factor=0.5, jitter=2.0)],
                         ids=["default", "floors", "no_jitter", "clamped"])
def test_backoff_matches_jax(kw):
    """The same delays and streaks as the JAX ``Backoff`` with the jitter's
    random source pinned on both sides; the exponent stops at the cap (no
    overflow after 1,100 failures) and a reset starts over."""
    from sentinel_tpu.datasource.backoff import Backoff as JBackoff
    from sentinel_tpu_torch.datasource.backoff import Backoff

    def trace(cls):
        b = cls(rng=random.Random(7), **kw)
        out = [(b.base, b.cap, b.factor, b.jitter)]
        out += [(b.next_delay(), b.failures) for _ in range(1100)]
        b.reset()
        out += [b.failures, b.next_delay(), b.failures]
        return out

    got, want = trace(Backoff), trace(JBackoff)
    assert got == want
    assert max(d for d, _ in got[1:1101]) <= got[0][1]
