"""Worker mode on the port (sentinel_tpu_torch/ipc/worker_mode.py and the
API's hooks): the cases of tests/test_ipc_fastpath.py's worker-mode
classes, the adapters' aside (the adapters are not ported). With
``sentinel.tpu.ipc.worker.mode`` on and a client attached, ``api.entry``,
``try_entry``, ``entry_async`` and ``entry_windowed`` ride the client; the
verdicts equal the same calls on an in-process engine; no Engine is built
in the worker and no CUDA set up; a killed worker-mode process leaves the
THREAD gauges at exactly 0; ``api.run_workers`` deploys N processes (the
supervised deployment, ``api.run_engine_supervised``, is held in
tests/test_torch_standby.py). Tolerance: exact equality."""

from __future__ import annotations

import asyncio
import os
import signal
import time

import pytest

from sentinel_tpu_torch.core import api
from sentinel_tpu_torch.core import errors as E
from sentinel_tpu_torch.core.context import ContextUtil
from sentinel_tpu_torch.ipc import worker_mode
from sentinel_tpu_torch.ipc.plane import IngestPlane
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.models.rules import FlowRule
from sentinel_tpu_torch.runtime.engine import Engine
from sentinel_tpu_torch.testing import ipc_procs
from sentinel_tpu_torch.utils.clock import ManualClock
from sentinel_tpu_torch.utils.config import config


@pytest.fixture(autouse=True)
def _sandbox():
    with config._lock:
        saved = dict(config._runtime)
    yield
    worker_mode.detach()
    with config._lock:
        config._runtime.clear()
        config._runtime.update(saved)
    api.reset(device="cpu")


def _wait_for(pred, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _engine(clock=None) -> Engine:
    return Engine(clock=clock, initial_rows=256, device="cpu")


def _rules(eng) -> None:
    eng.set_flow_rules([FlowRule(resource="open", count=1e9), FlowRule(resource="closed", count=0),
                        FlowRule(resource="three", count=3)])


def test_api_surface_routes_through_client():
    config.set(config.IPC_WORKER_MODE, "true")
    config.set(config.SPECULATIVE_ENABLED, "true")
    eng = _engine(ManualClock(0))
    _rules(eng)
    plane = IngestPlane(eng)
    cli = worker_mode.attach(plane.channel(0), 0)
    try:
        assert worker_mode.current() is cli and api._worker_client is cli
        e = api.entry("open")
        assert e.verdict.admitted and e.verdict.speculative
        e.exit()
        with pytest.raises(E.FlowBlockError):
            api.entry("closed")
        assert api.try_entry("closed") is None
        with pytest.raises(ValueError):  # occupy semantics cannot cross the wire
            api.entry("open", prio=True)
        api.entry_windowed("open").exit()
        api.entry_async("open").exit()
        asyncio.run(api.entry_windowed_async("open")).exit()
        with api.entry("open") as e4:
            e4.set_error(RuntimeError("biz"))
        _wait_for(lambda: plane.snapshot()["counters"]["exits"] >= 5, what="worker-mode exits")
        eng.flush()
        eng.drain()
        assert eng.cluster_node_stats("open")["cur_thread_num"] == 0
        assert eng.speculative.mirror.snapshot()["live_threads"].get("open", 0) == 0
        assert ContextUtil.get_context() is None  # the auto context left the stack
    finally:
        worker_mode.detach()
        plane.close()
        eng.close()
    assert worker_mode.current() is None and api._worker_client is None and api._worker_hook is None


def test_true_enter_in_worker_mode_builds_no_engine():
    config.set(config.IPC_WORKER_MODE, "true")
    eng = _engine(ManualClock(0))
    plane = IngestPlane(eng)
    prev = api.set_engine(None)
    worker_mode.attach(plane.channel(0), 0)
    try:
        ctx = ContextUtil.enter("ctx-a", "o")
        assert ctx.name == "ctx-a" and not ctx.is_null
        assert api.peek_engine() is None
        ContextUtil.exit()
    finally:
        worker_mode.detach()
        api.set_engine(prev)
        plane.close()
        eng.close()


def test_worker_mode_off_is_parity():
    """The key off: attach() makes a plain client and installs no hook."""
    eng = _engine(ManualClock(0))
    plane = IngestPlane(eng)
    cli = worker_mode.attach(plane.channel(0), 0)
    try:
        assert worker_mode.current() is None and api._worker_client is None
        cli.close()
    finally:
        worker_mode.detach()
        plane.close()
        eng.close()


_CALLS = [("entry", "open", {}), ("entry", "closed", {}), ("try_entry", "closed", {}),
          ("entry_async", "open", {}), ("entry_windowed", "three", {}), ("entry", "three", {}),
          ("entry", "three", {}), ("try_entry", "three", {}), ("entry", "free", {})]


def _oracle_results(calls, depth):
    """The same calls on the in-process API over a CPU engine with the
    same rules: what the worker-mode verdicts must equal."""
    config.set(config.PIPELINE_DEPTH, str(depth))
    api.reset(clock=ManualClock(1000), device="cpu")
    _rules(api.get_engine())
    out = []
    for fn, resource, kwargs in calls:
        try:
            e = getattr(api, fn)(resource, **kwargs)
        except E.BlockError as exc:
            out.append((fn, resource, False, type(exc).__name__))
            continue
        if e is None:
            out.append((fn, resource, False, "None"))
            continue
        out.append((fn, resource, True, int(e.verdict.reason) if e.verdict is not None else E.PASS))
        e.exit()
    return out


@pytest.mark.mp
@pytest.mark.parametrize("depth", [0, 2])
def test_worker_process_api_parity(depth):
    want = _oracle_results(_CALLS, depth)
    eng = _engine(ManualClock(1000))
    _rules(eng)
    eng.pipeline_depth = depth
    plane = IngestPlane(eng)
    ctx = plane.spawn_context()
    q = ctx.Queue()
    p = ctx.Process(target=ipc_procs.worker_mode_entries, args=(plane.channel(0), 0, {}, _CALLS, q), daemon=True)
    p.start()
    try:
        tag, _wid, got, engine_free, cuda = q.get(timeout=55)
        assert tag == "done" and got == want, f"depth={depth}"
        assert engine_free and cuda is False
    finally:
        p.join(timeout=10)
        if p.is_alive():
            p.terminate()
        plane.close()
        eng.close()


@pytest.mark.mp
def test_kill9_mid_serve_drains_gauges_to_zero():
    config.set(config.SPECULATIVE_ENABLED, "true")
    config.set(config.IPC_HEARTBEAT_MS, "50")
    config.set(config.IPC_WORKER_DEAD_MS, "300")
    eng = _engine()  # the real clock: the heartbeat's staleness is wall time
    eng.set_flow_rules([FlowRule(resource="hang", count=100, grade=C.FLOW_GRADE_THREAD)])
    plane = IngestPlane(eng)
    ctx = plane.spawn_context()
    q = ctx.Queue()
    n = 4
    p = ctx.Process(target=ipc_procs.worker_mode_admit_and_hang, args=(plane.channel(0), 0, "hang", n, q),
                    daemon=True)
    p.start()
    try:
        tag, _wid, admitted, engine_free = q.get(timeout=55)
        assert tag == "admitted" and admitted == n and engine_free
        eng.flush()
        eng.drain()
        assert eng.cluster_node_stats("hang")["cur_thread_num"] == n
        os.kill(p.pid, signal.SIGKILL)
        # The reap counts the death before its auto exits: wait on the exits.
        _wait_for(lambda: plane.snapshot()["counters"]["auto_exits"] >= n, timeout_s=30, what="death sweep")
        assert plane.snapshot()["counters"]["auto_exits"] == n
        assert plane.snapshot()["counters"]["worker_deaths"] == 1
        eng.flush()
        eng.drain()
        assert eng.cluster_node_stats("hang")["cur_thread_num"] == 0
        assert eng.speculative.mirror.snapshot()["live_threads"].get("hang", 0) == 0
    finally:
        p.join(timeout=5)
        if p.is_alive():
            p.terminate()
        plane.close()
        eng.close()


@pytest.mark.mp
def test_run_workers_deploys_worker_mode_processes():
    """``api.run_workers`` on an engine without a plane builds one, hands
    out free worker ids, replays the ipc config and runs the target in
    worker mode in each process; the ids of a second call never collide
    with live ones."""
    config.set(config.IPC_CLIENT_WINDOW_MS, "1")
    eng = _engine(ManualClock(1000))
    eng.set_flow_rules([FlowRule(resource="three", count=3)])
    assert eng.ipc_plane is None
    ws = None
    try:
        import multiprocessing

        q = multiprocessing.get_context("spawn").Queue()
        ws = api.run_workers(ipc_procs.api_entries, n=2, args=("three", 4, q), engine=eng)
        assert eng.ipc_plane is not None and len(ws) == 2
        got = sorted(q.get(timeout=55) for _ in range(2))
        ws.join(timeout=20)
        assert [g[0] for g in got] == [0, 1]
        assert sum(g[1] for g in got) == 3 and sum(g[2] for g in got) == 5  # one window of count 3
        assert all(g[3] is False and g[4] is False for g in got)  # no engine, no CUDA in the workers
        assert ws.alive() == 0
        with pytest.raises(ValueError):
            api.run_workers(ipc_procs.api_entries, n=eng.ipc_plane.workers_max + 1, engine=eng)
    finally:
        if ws is not None:
            ws.stop()
        eng.close()
