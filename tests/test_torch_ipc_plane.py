"""The port's multi-process ingest plane (sentinel_tpu_torch/ipc) on the
CPU, held against the in-process oracle and against the JAX package's
plane: the cases of tests/test_ipc_plane.py and tests/test_ipc_fastpath.py
(but the adapters'), run on the port.

* Worker-path verdicts, reasons and ``wait_ms`` equal the in-process
  oracle (the port's CPU engine fed the same stream through
  ``submit_bulk``, as the plane regroups it) and the JAX plane fed the same
  stream, at pipeline depths {0, 2} x the speculative tier on/off x the
  client micro-window on/off; the final stats equal too.
* A JAX ``IngestClient`` in a thread against the port's plane, and a port
  client against the JAX plane: each client takes the other package's
  channel, rebuilt field by field; the verdicts equal the oracle's.
* Ring-full sheds, the valve's accounting, the engine-death policy, the
  live-admission ledger, the intern protocol, the frame budget, the
  micro-window's coalescing and sheds, adaptive wakeups.
* Real spawned workers (``mp``): parity across the process boundary, the
  traceparent identity, a killed worker's THREAD gauges back to exactly 0
  on the device state and in the mirror, the engine's close, and a worker
  that exits while the plane lives on.

Tolerance: exact equality."""

from __future__ import annotations

import os
import signal
import threading
import time

import jax
import numpy as np
import pytest

from sentinel_tpu.ipc import worker as jworker
from sentinel_tpu.ipc.plane import IngestPlane as JPlane
from sentinel_tpu.models.rules import FlowRule as JFlowRule
from sentinel_tpu.models.rules import ParamFlowRule as JParamFlowRule
from sentinel_tpu.runtime.engine import Engine as JEngine
from sentinel_tpu.utils.clock import ManualClock as JClock
from sentinel_tpu.utils.config import config as jconfig
from sentinel_tpu_torch.core import errors as E
from sentinel_tpu_torch.ipc import frames as fr
from sentinel_tpu_torch.ipc import worker as tworker
from sentinel_tpu_torch.ipc.plane import IngestPlane
from sentinel_tpu_torch.ipc.ring import ShmRing
from sentinel_tpu_torch.ipc.worker import IngestClient
from sentinel_tpu_torch.metrics.nodes import stats_to_numpy
from sentinel_tpu_torch.models.rules import FlowRule, ParamFlowRule
from sentinel_tpu_torch.runtime.engine import Engine
from sentinel_tpu_torch.testing import ipc_procs
from sentinel_tpu_torch.utils.clock import ManualClock
from sentinel_tpu_torch.utils.config import config
from torch_parity import assert_same


@pytest.fixture(autouse=True)
def _config_sandbox():
    saved = []
    for c in (config, jconfig):
        with c._lock:
            saved.append(dict(c._runtime))
    yield
    for c, s in zip((config, jconfig), saved):
        with c._lock:
            c._runtime.clear()
            c._runtime.update(s)


def _set(**cfg) -> None:
    """The same settings in both packages' config."""
    for k, v in cfg.items():
        config.set(getattr(config, k), v)
        jconfig.set(getattr(jconfig, k), v)


def _engine(clock=None) -> Engine:
    return Engine(clock=clock, initial_rows=256, device="cpu")


def _rules(eng) -> None:
    port = isinstance(eng, Engine)
    fr_, pr_ = (FlowRule, ParamFlowRule) if port else (JFlowRule, JParamFlowRule)
    eng.set_flow_rules([fr_(resource="flow-res", count=3)])
    eng.set_param_rules({"param-res": [pr_(resource="param-res", param_idx=0, count=2)]})


def _wait_for(pred, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _oracle_decide(eng, res, n, ts_list, args_list):
    """The plane's group semantics in-process: one columnar submit_bulk
    (per-request submit_entry when bulk declines), a speculative group
    answered before its settle, else a flush."""
    ts_col = np.asarray(ts_list, dtype=np.int32)
    args_col = list(args_list) if any(args_list) else None
    try:
        op = eng.submit_bulk(res, n, ts=ts_col, args_column=args_col)
        if op is None:
            return [(True, E.PASS, 0)] * n
        if op.spec_admitted is not None:
            eng._spec_maybe_settle()
        else:
            eng.flush()
        return list(zip(op.admitted.tolist(), op.reason.tolist(), op.wait_ms.tolist()))
    except ValueError:
        ops = [eng.submit_entry(res, ts=ts_list[i], args=args_list[i]) for i in range(n)]
        eng.flush()
        return [(op.verdict.admitted, op.verdict.reason, op.verdict.wait_ms) for op in ops]


def _stream():
    """Flow-rule singles, param values (repeats that block at count=2)
    and bulk groups, each with an explicit ts."""
    reqs = [("entry", "flow-res", 1000, ()) for _ in range(6)]
    reqs += [("entry", "param-res", 1000, (f"ip{i % 2}",)) for i in range(7)]
    reqs += [("bulk", "flow-res", 2200, 5), ("bulk", "unknown-res", 2200, 3)]
    return reqs


def _drive_client(cli, reqs=None):
    got = []
    for req in reqs or _stream():
        if req[0] == "entry":
            _, res, ts, args = req
            v = cli.entry(res, ts=ts, args=args, timeout_ms=30000)
            got.append((bool(v.admitted), int(v.reason), int(v.wait_ms)))
        else:
            _, res, ts, n = req
            a, r, w, _f = cli.bulk(res, n, ts=ts, timeout_ms=30000)
            got.extend(zip(a.tolist(), r.tolist(), w.tolist()))
    return got


def _drive_oracle(eng):
    want = []
    for req in _stream():
        if req[0] == "entry":
            _, res, ts, args = req
            want.extend(_oracle_decide(eng, res, 1, [ts], [args]))
        else:
            _, res, ts, n = req
            want.extend(_oracle_decide(eng, res, n, [ts] * n, [()] * n))
    return [(bool(a), int(r), int(w)) for a, r, w in want]


def _settle(eng):
    eng.flush()
    eng.drain()


def _jax_stats(eng):
    return jax.device_get(eng.stats)


def _channel_as(ch, mod):
    """``ch`` rebuilt field by field as the other package's PlaneChannel."""
    return mod.PlaneChannel(
        control_name=ch.control_name, request_name=ch.request_name, response_name=ch.response_name,
        ring_slots=ch.ring_slots, slot_bytes=ch.slot_bytes, resp_slots=ch.resp_slots, workers_max=ch.workers_max,
        request_lock=ch.request_lock, request_doorbell=ch.request_doorbell, response_doorbell=ch.response_doorbell,
    )


# ---------------------------------------------------------------------------
# parity: the oracle, the JAX plane, the cross-package clients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [False, True], ids=["percall", "window"])
@pytest.mark.parametrize("spec", [False, True], ids=["specoff", "specon"])
@pytest.mark.parametrize("depth", [0, 2])
def test_bit_identical_to_oracle_and_jax_plane(depth, spec, window):
    _set(PIPELINE_DEPTH=str(depth), SPECULATIVE_ENABLED="true" if spec else "false",
         IPC_CLIENT_WINDOW_MS="2" if window else "0")
    oracle = _engine(ManualClock(1000))
    _rules(oracle)
    eng = _engine(ManualClock(1000))
    _rules(eng)
    jeng = JEngine(clock=JClock(1000), initial_rows=256)
    _rules(jeng)
    plane = IngestPlane(eng)
    jplane = JPlane(jeng)
    cli = IngestClient(plane.channel(0), 0)
    jcli = jworker.IngestClient(jplane.channel(0), 0)
    try:
        assert cli.window_armed == window
        want = _drive_oracle(oracle)
        got = _drive_client(cli)
        jgot = _drive_client(jcli)
        assert got == want, f"depth={depth} spec={spec} window={window}"
        assert jgot == want
        for e in (oracle, eng, jeng):
            _settle(e)
        assert_same(_jax_stats(jeng), stats_to_numpy(eng.stats), "plane stats vs the JAX plane's")
        assert_same(stats_to_numpy(oracle.stats), stats_to_numpy(eng.stats), "plane stats vs the oracle's")
    finally:
        cli.close()
        jcli.close()
        plane.close()
        jplane.close()
        for e in (eng, jeng, oracle):
            e.close()


@pytest.mark.parametrize("direction", ["jax_client_port_plane", "port_client_jax_plane"])
def test_cross_package_client_and_plane(direction):
    """The wire is one format: a JAX client (in a thread of this process)
    drives the port's plane, and a port client the JAX plane, each through
    the other package's channel rebuilt field by field; the verdicts equal
    the oracle's, and the exits release the gauges on the serving side."""
    _set(PIPELINE_DEPTH="0")
    oracle = _engine(ManualClock(1000))
    _rules(oracle)
    want = _drive_oracle(oracle)
    if direction == "jax_client_port_plane":
        eng = _engine(ManualClock(1000))
        plane = IngestPlane(eng)
        mk_client, ch_mod = jworker.IngestClient, jworker
    else:
        eng = JEngine(clock=JClock(1000), initial_rows=256)
        plane = JPlane(eng)
        mk_client, ch_mod = IngestClient, tworker
    _rules(eng)
    fr_ = FlowRule if isinstance(eng, Engine) else JFlowRule
    eng.set_flow_rules([fr_(resource="flow-res", count=3), fr_(resource="thr", count=1e9)])
    out = {}

    def client_thread():
        cli = mk_client(_channel_as(plane.channel(0), ch_mod), 0)
        try:
            out["got"] = _drive_client(cli)
            for _ in range(3):
                assert cli.entry("thr", ts=2300, timeout_ms=30000).admitted
            for _ in range(3):
                assert cli.exit("thr", ts=2400)
        finally:
            cli.close()

    t = threading.Thread(target=client_thread)
    t.start()
    t.join(120)
    try:
        assert out["got"] == want
        _wait_for(lambda: plane.snapshot()["counters"]["exits"] >= 3, what="exits drained")
        _settle(eng)
        assert eng.cluster_node_stats("thr")["cur_thread_num"] == 0
    finally:
        plane.close()
        eng.close()
        oracle.close()


def test_speculative_flag_carried():
    _set(SPECULATIVE_ENABLED="true")
    eng = _engine(ManualClock(1000))
    _rules(eng)
    plane = IngestPlane(eng)
    cli = IngestClient(plane.channel(0), 0)
    try:
        v = cli.entry("flow-res", ts=1000, timeout_ms=30000)
        assert v.admitted and v.speculative and not v.degraded
    finally:
        cli.close()
        plane.close()
        eng.close()


# ---------------------------------------------------------------------------
# ring-full sheds, engine death, the ledger, the intern protocol
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [False, True], ids=["percall", "window"])
def test_ring_full_shed_bounded_and_valve_accounted(window):
    """A full ring: every further call is a fast local BLOCK_SHED with the
    cause ``ipc_ring`` (a windowed call's whole window sheds); the ring
    never grows; entries count on a pushed frame only; the cumulative shed
    count folds into the engine's valve (cause "ring") and telemetry."""
    config.set(config.IPC_RING_SLOTS, "2")
    if window:
        config.set(config.IPC_CLIENT_WINDOW_MS, "1")
    eng = _engine(ManualClock(0))
    eng.set_flow_rules([FlowRule(resource="flow-res", count=1e9)])
    plane = IngestPlane(eng, start=False)
    plane._publish_control(force=True)  # the engine reads alive
    cli = IngestClient(plane.channel(0), 0)
    try:
        for _ in range(2):  # queued frames: their waits time out into the policy path
            assert cli.entry("flow-res", ts=1000, timeout_ms=60).degraded
        assert plane.request.occupancy() == 1.0
        for _ in range(5):
            v = cli.entry("flow-res", ts=1000, timeout_ms=60)
            assert (v.admitted, v.reason, v.limit_type) == (False, E.BLOCK_SHED, "ipc_ring")
        assert cli.counters["sheds"] == 5 and cli.counters["entries"] == 2
        assert plane.request.occupancy() == 1.0
        plane.start()
        _wait_for(lambda: eng.ingest.counters["shed_ring"] >= 5, what="shed_ring fold")
        assert eng.ingest.counters["shed_entries"] >= 5
        assert plane.snapshot()["counters"]["worker_sheds"] >= 5
        assert eng.telemetry.counters_snapshot()["ipc_sheds"] >= 5
    finally:
        cli.close()
        plane.close()
        eng.close()


def test_closed_plane_serves_policy():
    config.set(config.FAILOVER_POLICY, "open,shut-res=closed")
    eng = _engine(ManualClock(0))
    eng.set_flow_rules([FlowRule(resource="flow-res", count=1e9)])
    plane = IngestPlane(eng)
    cli = IngestClient(plane.channel(0), 0)
    try:
        v = cli.entry("flow-res", ts=1000, timeout_ms=30000)
        assert v.admitted and not v.degraded
        plane.close()
        v = cli.entry("flow-res", ts=1000)
        assert v.admitted and v.degraded and v.reason == E.PASS
        v = cli.entry("shut-res", ts=1000)
        assert not v.admitted and v.degraded and v.reason == E.BLOCK_FAILOVER
        a, r, _w, f = cli.bulk("shut-res", 3)
        assert not a.any() and r.tolist() == [E.BLOCK_FAILOVER] * 3
        assert all(fl & fr.F_DEGRADED for fl in f.tolist())
        assert plane.request.occupancy() == 0.0 and plane.control.intern_gen() == 0  # closed reads degrade
        assert plane.snapshot()["closed"]
    finally:
        cli.close()
        plane.close()
        eng.close()


def test_disabled_is_one_attribute_and_config_autostarts():
    eng = _engine(ManualClock(0))
    try:
        assert eng.ipc_plane is None and not eng.handoff_requested.is_set()
    finally:
        eng.close()
    config.set(config.IPC_ENABLED, "true")
    eng = _engine()
    try:
        assert eng.ipc_plane is not None and eng.ipc_plane.snapshot()["enabled"]
        assert eng.ipc_plane._thread.is_alive()
    finally:
        eng.close()
        config.set(config.IPC_ENABLED, "false")
    assert eng.ipc_plane is None  # close() tears the plane down


def test_spec_off_exit_clears_ledger_no_reap_double_release():
    """With the tier off the admit-time ledger key says spec=False while a
    default exit reads as mirror-release True: the pairing still matches
    them, so a later reap releases nothing and the gauge reads 0."""
    eng = _engine(ManualClock(0))
    eng.set_flow_rules([FlowRule(resource="pair-res", count=1e9)])
    plane = IngestPlane(eng)
    cli = IngestClient(plane.channel(0), 0)
    try:
        for _ in range(3):
            assert cli.entry("pair-res", ts=1000, timeout_ms=30000).admitted
        for _ in range(3):
            assert cli.exit("pair-res")
        _wait_for(lambda: plane.snapshot()["counters"]["exits"] >= 3, what="exits drained")
        with plane._lock:
            assert not plane._workers[0].live
        plane._reap_worker(0, plane._workers[0])
        assert plane.snapshot()["counters"]["auto_exits"] == 0
        _settle(eng)
        assert eng.cluster_node_stats("pair-res")["cur_thread_num"] == 0
    finally:
        cli.close()
        plane.close()
        eng.close()


def test_unpaired_exit_never_applies_and_partial_count_pairs():
    eng = _engine(ManualClock(0))
    eng.set_flow_rules([FlowRule(resource="u", count=1e9)])
    plane = IngestPlane(eng)
    cli = IngestClient(plane.channel(0), 0)
    try:
        assert cli.exit("u", rt=5)  # no admission ever made
        _wait_for(lambda: plane.snapshot()["counters"]["exits_unpaired"] >= 1, what="unpaired exit dropped")
        _settle(eng)
        assert eng.cluster_node_stats("u")["cur_thread_num"] == 0
        assert cli.entry("u", acquire=2, ts=1000, timeout_ms=30000).admitted
        assert cli.exit("u", count=1)  # fewer than acquired: released now, the admission forgotten
        _wait_for(lambda: plane.snapshot()["counters"]["exits"] >= 1, what="partial exit applied")
        assert plane.snapshot()["counters"]["exits_unpaired"] == 1
        _settle(eng)
        assert eng.cluster_node_stats("u")["cur_thread_num"] == 0
        assert plane.snapshot()["workers"][0]["live_admissions"] == 0
    finally:
        cli.close()
        plane.close()
        eng.close()


def test_intern_once_and_generation_bump_reinterns():
    eng = _engine(ManualClock(0))
    eng.set_flow_rules([FlowRule(resource="flow-res", count=1e9)])
    plane = IngestPlane(eng)
    cli = IngestClient(plane.channel(0), 0)
    try:
        for _ in range(3):
            assert cli.entry("flow-res", ts=1000, timeout_ms=30000).admitted
        with cli._lock:
            assert "flow-res" in cli._intern
        assert plane.snapshot()["workers"][0]["interned"] >= 1
        plane.control.bump_intern_gen()
        assert cli.entry("flow-res", ts=1000, timeout_ms=30000).admitted
        with cli._lock:
            assert cli._intern_gen == plane.control.intern_gen() and "flow-res" in cli._intern
    finally:
        cli.close()
        plane.close()
        eng.close()


def test_engine_reset_drops_ledgers_and_reinterns():
    eng = _engine(ManualClock(0))
    eng.set_flow_rules([FlowRule(resource="r", count=1e9)])
    plane = IngestPlane(eng)
    cli = IngestClient(plane.channel(0), 0)
    try:
        assert cli.entry("r", ts=1000, timeout_ms=30000).admitted
        gen = plane.control.intern_gen()
        eng.reset()
        assert plane.control.intern_gen() == gen + 1
        assert plane.snapshot()["workers"][0]["live_admissions"] == 0
        plane._reap_worker(0, plane._workers[0])
        assert plane.snapshot()["counters"]["auto_exits"] == 0
        assert cli.entry("r", ts=1000, timeout_ms=30000).admitted  # unruled now: passes
    finally:
        cli.close()
        plane.close()
        eng.close()


def test_frame_budget_bytes_and_intern_preamble():
    """An args-heavy bulk splits by bytes (no phantom ring backpressure);
    a row no slot can carry is the caller's error; long fresh names ship
    as a zero-row intern preamble frame."""
    config.set(config.IPC_SLOT_BYTES, "2048")
    eng = _engine(ManualClock(0))
    long_res = "r" + "x" * 1400
    eng.set_flow_rules([FlowRule(resource="argsy", count=1e9), FlowRule(resource=long_res, count=1e9)])
    plane = IngestPlane(eng)
    cli = IngestClient(plane.channel(0), 0)
    try:
        a, r, _w, _f = cli.bulk("argsy", 60, ts=1000, args_column=[("v" * 120,)] * 60, timeout_ms=60000)
        assert a.all(), r[~a]
        assert cli.counters["sheds"] == 0 and cli.counters["frames"] > 2
        with pytest.raises(ValueError):
            cli.bulk("argsy", 1, args_column=[("x" * 4000,)])
        with pytest.raises(ValueError):
            cli.entry("argsy", args=("x" * 4000,))
        assert cli.entry(long_res, ts=1000, timeout_ms=60000).admitted and cli.counters["sheds"] == 0
        with pytest.raises(ValueError):
            cli.entry("r" + "y" * 4000, ts=1000)
    finally:
        cli.close()
        plane.close()
        eng.close()


def test_claim_worker_slots_never_reuses_live_ids():
    eng = _engine(ManualClock(0))
    plane = IngestPlane(eng)
    try:
        a = plane.claim_worker_slots(2)
        b = plane.claim_worker_slots(2)
        assert len(set(a) | set(b)) == 4, (a, b)
        with pytest.raises(ValueError):
            plane.claim_worker_slots(plane.workers_max)
        with pytest.raises(ValueError):
            plane.channel(plane.workers_max)
    finally:
        plane.close()
        eng.close()


# ---------------------------------------------------------------------------
# the client's micro-window and the adaptive wakeups
# ---------------------------------------------------------------------------
def test_window_off_is_per_call_framing():
    eng = _engine(ManualClock(0))
    eng.set_flow_rules([FlowRule(resource="r", count=1e9)])
    plane = IngestPlane(eng)
    cli = IngestClient(plane.channel(0), 0)
    try:
        assert not cli.window_armed and cli._win_thread is None
        for _ in range(5):
            assert cli.entry("r", ts=1000, timeout_ms=30000).admitted
        assert cli.counters["frames"] == 5 and cli.counters["window_flushes"] == 0
    finally:
        cli.close()
        plane.close()
        eng.close()


def test_concurrent_callers_coalesce_and_windowed_exits_release():
    config.set(config.IPC_CLIENT_WINDOW_MS, "3")
    config.set(config.SPECULATIVE_ENABLED, "true")
    eng = _engine(ManualClock(0))
    eng.set_flow_rules([FlowRule(resource="c", count=1e9)])
    plane = IngestPlane(eng)
    cli = IngestClient(plane.channel(0), 0)
    try:
        def worker():
            for _ in range(10):
                assert cli.entry("c", ts=1000, timeout_ms=30000).admitted
                assert cli.exit("c")

        ts = [threading.Thread(target=worker) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert cli.counters["entries"] == 80
        assert cli.counters["frames"] * 2 <= 160, cli.counters  # 80 entries and 80 exits
        _wait_for(lambda: plane.snapshot()["counters"]["exits"] >= 80, what="windowed exits drained")
        _settle(eng)
        assert eng.cluster_node_stats("c")["cur_thread_num"] == 0
        assert eng.speculative.mirror.snapshot()["live_threads"].get("c", 0) == 0
    finally:
        cli.close()
        plane.close()
        eng.close()


def test_flusher_survives_unencodable_exit():
    config.set(config.IPC_CLIENT_WINDOW_MS, "1")
    eng = _engine(ManualClock(0))
    eng.set_flow_rules([FlowRule(resource="x", count=1e9)])
    plane = IngestPlane(eng)
    cli = IngestClient(plane.channel(0), 0)
    try:
        assert cli.entry("x", ts=1000, timeout_ms=30000).admitted
        assert cli.exit("x", count=2 ** 40)  # buffered; its encode fails
        _wait_for(lambda: cli.counters["exits_dropped"] >= 1, what="unencodable exit dropped")
        assert cli.entry("x", ts=1000, timeout_ms=30000).admitted
        assert cli.exit("x")
        _wait_for(lambda: cli.counters["exits"] >= 1, what="later exit drained")
        assert cli._win_thread.is_alive()
    finally:
        cli.close()
        plane.close()
        eng.close()


def test_doorbell_wakes_parked_consumer():
    import multiprocessing

    bell = multiprocessing.get_context("spawn").Semaphore(0)
    ring = ShmRing(None, 8, 64, create=True, doorbell=bell)
    try:
        woke = {}

        def consumer():
            t0 = time.monotonic()
            woke["ok"] = ring.wait_readable(0.0, 5.0)
            woke["dt"] = time.monotonic() - t0

        t = threading.Thread(target=consumer)
        t.start()
        time.sleep(0.05)
        assert ring.try_push(b"x")
        t.join(timeout=10)
        assert woke["ok"] and woke["dt"] < 1.0
        assert ring.try_pop() == b"x"
        assert ring.try_push(b"y") and ring.wait_readable(0.0, 0.001)
    finally:
        ring.destroy()


def test_adaptive_wakeup_parity_and_idle_burn():
    """The wakeup strategy changes latency, never verdicts; idle, the
    spin-then-park waits burn a bounded share of a CPU."""
    _set(IPC_WAKEUP="adaptive", SPECULATIVE_ENABLED="true")
    oracle = _engine(ManualClock(1000))
    _rules(oracle)
    eng = _engine(ManualClock(1000))
    _rules(eng)
    plane = IngestPlane(eng)
    cli = IngestClient(plane.channel(0), 0)
    try:
        assert plane.adaptive_wakeup and cli.adaptive_wakeup
        assert _drive_client(cli) == _drive_oracle(oracle)
        time.sleep(0.1)
        cpu0, t0 = time.process_time(), time.monotonic()
        time.sleep(1.0)
        cpu, wall = time.process_time() - cpu0, time.monotonic() - t0
        assert cpu < 0.5 * wall, f"idle adaptive wait burned {cpu:.3f}s CPU over {wall:.3f}s"
    finally:
        cli.close()
        plane.close()
        eng.close()
        oracle.close()


# ---------------------------------------------------------------------------
# real worker processes (the mp tier)
# ---------------------------------------------------------------------------
def _spawn(plane, target, wid, *args):
    ctx = plane.spawn_context()
    q = ctx.Queue()
    p = ctx.Process(target=target, args=(plane.channel(wid), wid, *args, q), daemon=True)
    p.start()
    return p, q


def _reap_proc(p):
    if p is None:
        return
    p.join(timeout=5)
    if p.is_alive():
        p.terminate()
        p.join(timeout=5)


def _script_and_want(oracle):
    script, want = [], []
    for req in _stream():
        if req[0] == "entry":
            _, res, ts, args = req
            script.append({"kind": "entry", "resource": res, "ts": ts, "args": list(args), "timeout_ms": 50000})
            want.append(("entry",) + tuple(_oracle_decide(oracle, res, 1, [ts], [args])[0]))
        else:
            _, res, ts, n = req
            script.append({"kind": "bulk", "resource": res, "n": n, "ts": ts, "timeout_ms": 50000})
            vs = _oracle_decide(oracle, res, n, [ts] * n, [()] * n)
            want.append(("bulk", [v[0] for v in vs], [v[1] for v in vs], [v[2] for v in vs]))
    return script, want


@pytest.mark.mp
@pytest.mark.parametrize("mode", ["percall", "window_adaptive"])
def test_parity_across_process_boundary(mode):
    """The same stream from a spawned port worker (depth 2, the tier on;
    with the micro-window and the doorbells, which travel the spawn like
    the claim lock) equals the oracle; the worker never set up CUDA."""
    _set(PIPELINE_DEPTH="2", SPECULATIVE_ENABLED="true")
    cfg = {}
    if mode == "window_adaptive":
        _set(IPC_WAKEUP="adaptive")
        cfg = {config.IPC_CLIENT_WINDOW_MS: "2", config.IPC_WAKEUP: "adaptive"}
    oracle = _engine(ManualClock(1000))
    _rules(oracle)
    eng = _engine(ManualClock(1000))
    _rules(eng)
    plane = IngestPlane(eng)
    script, want = _script_and_want(oracle)
    p = None
    try:
        p, q = _spawn(plane, ipc_procs.run_script_cfg, 0, cfg, script)
        tag, wid, out = q.get(timeout=55)
        assert tag == "done" and wid == 0
        got = [("entry", s[1], s[2], s[3]) if s[0] == "entry" else ("bulk", s[1], s[2], s[3]) for s in out]
        assert got == want
    finally:
        _reap_proc(p)
        plane.close()
        eng.close()
        oracle.close()


@pytest.mark.mp
def test_traceparent_identity_and_worker_exit_keeps_the_plane():
    """The engine's trace record carries the worker's inbound trace id and
    parent span; the worker then exits while the plane lives on: its
    segments stay (the child's exit unlinks nothing), the dead-worker
    sweep frees its slot, and a new worker on the same slot is served."""
    config.set(config.IPC_HEARTBEAT_MS, "50")
    config.set(config.IPC_WORKER_DEAD_MS, "300")
    eng = _engine()
    eng.set_flow_rules([FlowRule(resource="flow-res", count=1e9)])
    plane = IngestPlane(eng)
    tid, sid = "a1" * 16, "b2" * 8
    p = p2 = None
    try:
        p, q = _spawn(plane, ipc_procs.entry_with_trace, 0, "flow-res", f"00-{tid}-{sid}-01")
        tag, _wid, (admitted, _reason) = q.get(timeout=55)
        assert tag == "done" and admitted
        _wait_for(lambda: any(r.trace_id == tid and r.parent_span_id == sid
                              for r in eng.admission_trace.records()), what="trace record")
        rec = next(r for r in eng.admission_trace.records() if r.trace_id == tid)
        assert rec.resource == "flow-res" and rec.head_sampled
        p.join(timeout=20)
        assert p.exitcode == 0
        names = [plane.control.name, plane.request.name, plane.responses[0].name]
        for n in names:
            assert os.path.exists(f"/dev/shm/{n}"), n
        _wait_for(lambda: plane.snapshot()["counters"]["worker_deaths"] >= 1, timeout_s=20,
                  what="dead-worker sweep")
        p2, q2 = _spawn(plane, ipc_procs.run_script, 0, [{"kind": "entry", "resource": "flow-res", "ts": 1000,
                                                          "timeout_ms": 50000}])
        tag, _wid, out = q2.get(timeout=55)
        assert tag == "done" and out[0][1] is True and out[0][5] is False
    finally:
        _reap_proc(p)
        _reap_proc(p2)
        plane.close()
        eng.close()
    for n in names:
        assert not os.path.exists(f"/dev/shm/{n}"), n  # the plane's close unlinks


@pytest.mark.mp
def test_worker_kill_gauges_exactly_zero():
    """kill -9 a worker holding live admissions on a THREAD-grade rule:
    the heartbeat sweep auto-exits them, and the device THREAD gauge (read
    through the stats read) and the mirror's both read exactly 0."""
    from sentinel_tpu_torch.models import constants as C

    config.set(config.SPECULATIVE_ENABLED, "true")
    config.set(config.IPC_HEARTBEAT_MS, "50")
    config.set(config.IPC_WORKER_DEAD_MS, "300")
    eng = _engine()  # the real clock: the heartbeat's staleness is wall time
    eng.set_flow_rules([FlowRule(resource="kill-res", count=1000, grade=C.FLOW_GRADE_THREAD)])
    plane = IngestPlane(eng)
    n = 5
    p = None
    try:
        p, q = _spawn(plane, ipc_procs.admit_and_hang, 0, "kill-res", n)
        tag, _wid, admitted, cuda = q.get(timeout=55)
        assert tag == "admitted" and admitted == n and cuda is False
        _settle(eng)
        assert eng.cluster_node_stats("kill-res")["cur_thread_num"] == n
        os.kill(p.pid, signal.SIGKILL)
        # The reap counts the death before its auto exits: wait on the exits.
        _wait_for(lambda: plane.snapshot()["counters"]["auto_exits"] >= n, timeout_s=30,
                  what="worker death sweep")
        assert plane.snapshot()["counters"]["auto_exits"] == n
        assert plane.snapshot()["counters"]["worker_deaths"] == 1
        _settle(eng)
        assert eng.cluster_node_stats("kill-res")["cur_thread_num"] == 0
        assert eng.speculative.mirror.snapshot()["live_threads"].get("kill-res", 0) == 0
        assert eng.telemetry.counters_snapshot()["ipc_worker_deaths"] == 1
        assert eng.telemetry.counters_snapshot()["ipc_auto_exits"] == n
    finally:
        _reap_proc(p)
        plane.close()
        eng.close()


@pytest.mark.mp
def test_engine_close_fails_over_and_quiesces():
    config.set(config.SPECULATIVE_ENABLED, "true")
    eng = _engine()
    eng.set_flow_rules([FlowRule(resource="die-res", count=1e9)])
    plane = IngestPlane(eng)
    p = None
    try:
        p, q = _spawn(plane, ipc_procs.entries_until_dead, 0, "die-res")
        _wait_for(lambda: plane.snapshot()["counters"]["requests"] >= 3, timeout_s=40, what="live traffic")
        plane.close()
        tag, _wid, served = q.get(timeout=40)
        assert tag == "done" and served
        live = [s for s in served if not s[2]]
        assert live and all(s[0] for s in live)
        assert served[-1][2] is True and served[-1][0] is True  # fail-open policy
        _settle(eng)
        assert eng.cluster_node_stats("die-res")["cur_thread_num"] == 0
        assert eng.speculative.mirror.snapshot()["live_threads"].get("die-res", 0) == 0
    finally:
        _reap_proc(p)
        plane.close()
        eng.close()
