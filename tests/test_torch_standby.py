"""The port's engine supervisor with real processes
(sentinel_tpu_torch/ipc/supervise.py), its children on the CPU
(``device="cpu"``), held to the assertions and the oracle of the JAX
package's real-process tests:

* tests/test_restart.py::TestSupervisedChaos: ``kill -9`` of a supervised
  engine under load is a bounded outage; the supervisor restarts it on the
  same rings and the probing client reconnects;
* tests/test_standby.py::TestStandbyChaos: with a warm standby armed a
  ``kill -9`` is a takeover, not a cold restart, and the THREAD verdicts
  after it equal a never-killed engine's (the port's CPU engine) at
  pipeline depths 0 and 2, with the gauges-are-0 probe after quiesce; a
  planned handoff under continuous probing serves no policy verdict;
* tests/test_capture_chaos.py::TestCaptureKill9: the flight recorder
  across a supervised ``kill -9``: the restarted child keeps the dead
  boot's segments as ``frozen-death-*`` and the port's replay verifies
  them with zero diffs.

And the port's own refusals and faults: a standby whose flush kernels do
not build never reports ready, and the promotion falls back to a cold
respawn; ``run_engine_supervised`` asked for the card on a host without
CUDA raises before it spawns anything, and on the CPU returns a
supervisor whose engine serves a worker; the launcher refuses the WSGI
wrap (ROADMAP item 11) and runs its restart smoke with ``--device cpu``.

Detection thresholds are loose on purpose (the JAX tests' stance): every
process here shares a loaded CPU, and these tests pin the protocol, not
the detection latency. Tolerance: exact equality."""

from __future__ import annotations

import multiprocessing
import os
import time

import pytest

from sentinel_tpu_torch.ipc import launch, supervise
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.models.rules import FlowRule
from sentinel_tpu_torch.runtime.engine import Engine
from sentinel_tpu_torch.testing import ipc_procs
from sentinel_tpu_torch.utils.config import config


@pytest.fixture(autouse=True)
def _config_sandbox():
    with config._lock:
        saved = dict(config._runtime)
    yield
    with config._lock:
        config._runtime.clear()
        config._runtime.update(saved)


def _wait_for(pred, timeout_s=30.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _segments(prefix):
    return [n for n in os.listdir("/dev/shm") if n.startswith(prefix)]


def _standby_config(tmp_path, depth):
    config.set(config.IPC_HEARTBEAT_MS, "50")
    config.set(config.IPC_ENGINE_DEAD_MS, "2000")
    config.set(config.IPC_ENGINE_DEAD_CONFIRM_MS, "1000")
    # A descheduled client beat thread must not be reaped mid-test: the
    # auto-exit would drop the re-asserted admissions the oracle expects.
    config.set(config.IPC_WORKER_DEAD_MS, "60000")
    config.set(config.IPC_HANDOFF_WAIT_MS, "30000")
    config.set(config.SUPERVISE_BACKOFF_MS, "200")
    config.set(config.SUPERVISE_STANDBY, "true")
    config.set(config.SUPERVISE_STANDBY_WARM_MS, "500")
    config.set(config.SPECULATIVE_ENABLED, "true")
    config.set(config.PIPELINE_DEPTH, str(depth))
    config.set(config.FAILOVER_ENABLED, "true")
    config.set(config.FAILOVER_CHECKPOINT_EVERY, "2")
    config.set(config.FAILOVER_CKPT_PATH, str(tmp_path / "ck.bin"))


def _live(cli, resource, timeout_s=120):
    deadline = time.monotonic() + timeout_s
    while True:
        v = cli.entry(resource, timeout_ms=3000)
        if v.admitted and not v.degraded:
            cli.exit(resource)
            return
        assert time.monotonic() < deadline, "no live verdict"
        time.sleep(0.02)


def _decided(cli, resource, n, timeout_s=120):
    """``n`` engine-decided verdicts (a policy verdict on a starved box
    charges nothing and proves nothing: it is retried)."""
    got, deadline = [], time.monotonic() + timeout_s
    while len(got) < n:
        v = cli.entry(resource, timeout_ms=30000)
        if v.degraded:
            assert time.monotonic() < deadline, "decisions stalled"
            time.sleep(0.02)
            continue
        got.append((bool(v.admitted), int(v.reason)))
    return got


# --- TestSupervisedChaos ------------------------------------------------------


@pytest.mark.mp
def test_kill9_bounded_outage_and_reconnect(tmp_path):
    """kill -9 mid-load with in-flight micro-windows: the supervisor restarts
    the engine on the SAME rings, the probing client's policy-served
    interval ends, it reconnects and gets device-backed verdicts again."""
    config.set(config.IPC_HEARTBEAT_MS, "50")
    config.set(config.IPC_ENGINE_DEAD_MS, "2000")
    config.set(config.IPC_CLIENT_WINDOW_MS, "0.5")
    config.set(config.SUPERVISE_BACKOFF_MS, "200")
    config.set(config.FAILOVER_ENABLED, "true")
    config.set(config.FAILOVER_CHECKPOINT_EVERY, "2")
    config.set(config.FAILOVER_CKPT_PATH, str(tmp_path / "ck.bin"))
    out = supervise.measure_restart_outage(ipc_procs.restart_setup, "chaos-res", timeout_s=200, device="cpu")
    assert out["restarts"] >= 1, out
    assert out["reconnects"] >= 1, out
    assert out["outage_ms"] < 150_000, out


# --- TestStandbyChaos ---------------------------------------------------------


@pytest.mark.mp
@pytest.mark.parametrize("depth", [0, 2])
def test_kill9_standby_takeover_parity(depth, tmp_path):
    """kill -9 of the PRIMARY with a warm standby armed: a takeover
    (``restarts`` stays 0), the client reconnects onto the standby's world,
    the THREAD verdicts after equal a never-killed engine's, and after
    quiesce exactly ``count`` admissions pass."""
    from sentinel_tpu_torch.ipc.worker import IngestClient

    _standby_config(tmp_path, depth)
    # Engine-decided verdicts only (whether an old-world admission was
    # charged to the mirror depends on timing): exact parity is the device's.
    config.set(config.SPECULATIVE_ENABLED, "false")
    sup = supervise.EngineSupervisor(setup=ipc_procs.standby_setup, n_workers=1, device="cpu")
    cli = None
    try:
        assert sup.wait_engine_up(180), "primary never up"
        assert sup.wait_standby_ready(180), "standby never warm"
        cli = IngestClient(sup.handles.channel(0), 0)
        _live(cli, "chaos-res")
        charged, deadline = 0, time.monotonic() + 120
        while charged < 2:  # two live THREAD admissions the takeover must carry
            v = cli.entry("sb-thread", timeout_ms=30000)
            if v.admitted and not v.degraded:
                charged += 1
                continue
            assert not v.admitted or v.degraded
            assert time.monotonic() < deadline, "live charge stalled"
            time.sleep(0.02)
        assert sup.kill_engine() is not None
        _live(cli, "chaos-res")
        _wait_for(lambda: sup.standby_takeovers >= 1, what="takeover accounting")
        assert sup.restarts == 0, "cold respawn on the standby path"
        assert sup.standby_warm_boot_ms is not None
        _wait_for(lambda: cli.counters["reconnects"] >= 1, what="client reconnect")

        config.set(config.IPC_SHM_PREFIX, "")
        oracle = Engine(initial_rows=256, device="cpu")
        oracle.set_flow_rules([FlowRule("sb-thread", count=3, grade=C.FLOW_GRADE_THREAD)])
        for _ in range(2):
            oracle.submit_entry("sb-thread")
        oracle.flush()
        oracle.drain()
        want = []
        for _ in range(3):
            op = oracle.submit_entry("sb-thread")
            oracle.flush()
            oracle.drain()
            want.append((op.verdict.admitted, op.verdict.reason))
        oracle.close()
        got = _decided(cli, "sb-thread", 3)
        assert got == want, (got, want)
        assert [g[0] for g in got] == [True, False, False]

        for _ in range(3):  # quiesce: 2 re-asserted + 1 admitted probe
            cli.exit("sb-thread")
        deadline = time.monotonic() + 120
        while True:
            vs = [cli.entry("sb-thread", timeout_ms=30000) for _ in range(4)]
            admits = [v.admitted for v in vs]
            for v in vs:
                if v.admitted and not v.degraded:
                    cli.exit("sb-thread")
            if not any(v.degraded for v in vs) and admits == [True, True, True, False]:
                break
            assert time.monotonic() < deadline, admits
            time.sleep(0.1)
    finally:
        if cli is not None:
            cli.close()
        sup.stop()
    assert not _segments(sup.prefix)
    assert not multiprocessing.active_children()


@pytest.mark.mp
def test_planned_handoff_soak_zero_policy_served(tmp_path):
    """Continuous probing through an operator's handoff: the standby takes
    over with no policy-served and no refused verdict (callers were held),
    counted as a handoff, not a takeover or a restart."""
    _standby_config(tmp_path, 0)
    config.set(config.IPC_CLIENT_WINDOW_MS, "0.5")
    out = supervise.measure_handoff_outage(ipc_procs.standby_setup, "chaos-res", timeout_s=200, device="cpu")
    assert out["handoffs"] == 1, out
    assert out["policy_served"] == 0, out
    assert out["not_admitted"] == 0, out
    assert out["reconnects"] >= 1, out
    assert out["handoff_outage_ms"] < 150_000, out


# --- TestCaptureKill9, through the supervisor -----------------------------------


@pytest.mark.mp
def test_kill9_preserves_parseable_replayable_capture(tmp_path):
    """A supervised engine child records its stream, is ``kill -9``'d under
    load, and the restarted child keeps the dead boot's live segments as
    ``frozen-death-*`` before writing its own; every file parses, and the
    dead boot's capture replays with zero diffs."""
    from sentinel_tpu_torch.runtime import capture as cap_mod
    from sentinel_tpu_torch.runtime import replay

    cap_dir = str(tmp_path / "blackbox")
    config.set(config.IPC_HEARTBEAT_MS, "50")
    config.set(config.IPC_ENGINE_DEAD_MS, "2000")
    config.set(config.SUPERVISE_BACKOFF_MS, "200")
    config.set(config.CAPTURE_ENABLED, "true")
    config.set(config.CAPTURE_DIR, cap_dir)
    out = supervise.measure_restart_outage(ipc_procs.restart_setup, "chaos-res", timeout_s=200, device="cpu")
    assert out["restarts"] >= 1, out
    files = sorted(os.listdir(cap_dir))
    death = [f for f in files if f.startswith("frozen-death-")]
    assert death, files
    boots = set()
    for fn in files:
        header, recs = cap_mod.read_segment(os.path.join(cap_dir, fn))  # a torn tail ends cleanly
        boots.add(header["boot_id"])
        assert all(rec.rkind in cap_mod._RECORD_NAMES for rec in recs)
    assert len(boots) == 2  # the killed boot and its replacement
    decoded = cap_mod.decode_capture([os.path.join(cap_dir, f) for f in death])
    chunks = [ck for k, ck in decoded["stream"] if k == "chunk"]
    assert chunks
    # The drainer groups a resource's frames into bulk groups.
    assert any(e["resource"] == "chaos-res" for ck in chunks for e in ck.entries + [r for g in ck.bulk for r in g])
    report = replay.verify(decoded, depth=0, device="cpu")
    assert report["diffs"] == 0, report
    assert report["compared"] > 0, report


# --- the port's refusals and faults ------------------------------------------


@pytest.mark.mp
def test_standby_kernel_build_error_is_never_ready(tmp_path):
    """A standby whose ``warm_probe`` raises ``KernelBuildError`` exits with
    ``EXIT_KERNEL_BUILD`` and no ``ready`` (the JAX standby reports ready
    anyway); the primary's death then finds it unusable and the watcher
    respawns cold."""
    _standby_config(tmp_path, 0)
    sup = supervise.EngineSupervisor(setup=ipc_procs.build_error_setup, n_workers=1, device="cpu")
    try:
        assert sup.wait_engine_up(180), "primary never up"
        sb = sup._standby
        assert not sup.wait_standby_ready(120)
        sb["proc"].join(30)
        assert sb["proc"].exitcode == supervise.EXIT_KERNEL_BUILD
        assert sup.kill_engine() is not None
        _wait_for(lambda: sup.restarts == 1, timeout_s=60, what="the cold respawn")
        assert sup.wait_engine_up(180), "respawned engine never up"
        assert sup.standby_takeovers == 0 and sup.handoffs == 0
    finally:
        sup.stop()
    assert not _segments(sup.prefix)


def test_run_engine_supervised_needs_cuda_for_the_card(monkeypatch):
    """``device=None`` means the card: with no CUDA the supervisor raises
    before it creates a segment or spawns a child."""
    import torch

    from sentinel_tpu_torch.core import api

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prefix = "stpu-nocuda-test"
    children = multiprocessing.active_children()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.run_engine_supervised(setup=ipc_procs.restart_setup, n_workers=1, prefix=prefix)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        supervise.EngineSupervisor(n_workers=1, prefix=prefix, device="cuda:0")
    assert multiprocessing.active_children() == children
    assert not _segments(prefix)


@pytest.mark.mp
def test_run_engine_supervised_serves_a_worker():
    """``api.run_engine_supervised(..., device="cpu")`` returns an
    ``EngineSupervisor`` whose engine serves a worker-mode child: a QPS rule
    of count 3 admits 3 of 5 calls, which only the engine decides (a policy
    verdict admits all or none); the worker builds no engine and sets up no
    CUDA."""
    from sentinel_tpu_torch.core import api

    config.set(config.IPC_ENGINE_DEAD_MS, "10000")
    config.set(config.IPC_WORKER_DEAD_MS, "60000")
    sup = api.run_engine_supervised(setup=ipc_procs.rules_setup, setup_args=([("q3", 3, C.FLOW_GRADE_QPS)],),
                                    n_workers=1, device="cpu")
    try:
        assert isinstance(sup, supervise.EngineSupervisor)
        assert sup.wait_engine_up(180), "engine never up"
        q = sup.spawn_context().Queue()
        p = sup.spawn_worker(ipc_procs.api_entries, 0, ("q3", 5, q))
        assert q.get(timeout=180) == (0, 3, 2, False, False)
        p.join(30)
        assert p.exitcode == 0
    finally:
        sup.stop()
    assert not multiprocessing.active_children()


def test_launcher_wrap_waits_for_item_11():
    with pytest.raises(NotImplementedError, match="item 11"):
        launch.main(["--supervise", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 11"):
        launch.main(["--smoke", "wsgi", "--device", "cpu"])


@pytest.mark.mp
def test_launcher_restart_smoke_on_the_cpu(capsys):
    assert launch.main(["--smoke", "restart", "--device", "cpu"]) == 0
    assert "restart smoke OK" in capsys.readouterr().out
