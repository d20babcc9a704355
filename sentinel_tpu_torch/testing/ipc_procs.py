"""Spawn targets for worker processes of the multi-process ingest plane.

``multiprocessing`` spawn children import these by module name, so every
function here is top-level and imports what it needs itself. A worker
touches only the client surface (``ipc.worker``, ``ipc.worker_mode`` and
the public API in worker mode): no engine, no device. Each reports, when
asked, whether torch has set up CUDA in its process
(``torch.cuda.is_initialized()``), which must read False.

The targets serve the tests (``tests/test_torch_ipc_plane.py``,
``tests/test_torch_worker_mode.py``, ``tests/test_torch_standby.py``) and
``chip_smoke.py`` phases 4j (:func:`serve`, a worker that runs the
parent's commands in turn) and 4l. The ``*_setup`` functions are the
engine supervisor's setup callables (``setup(engine, *setup_args)`` in
each engine child)."""

from __future__ import annotations

import json
import os
import threading
import time


def cuda_initialized() -> bool:
    """Whether torch has set up CUDA in this process (a worker must not)."""
    import torch

    return torch.cuda.is_initialized()


def _apply_cfg(cfg) -> None:
    from sentinel_tpu_torch.utils.config import config

    for k, v in (cfg or {}).items():
        config.set(k, v)


def _run_steps(cli, script, out) -> None:
    """Steps ``{"kind": "entry"|"bulk"|"exit"|"sleep", ...}``; a verdict
    tuple a step lands in ``out``."""
    for step in script:
        kind = step["kind"]
        if kind == "entry":
            v = cli.entry(
                step["resource"], origin=step.get("origin", ""), acquire=step.get("acquire", 1),
                entry_type=step.get("entry_type", 1), args=tuple(step.get("args", ())), ts=step.get("ts"),
                timeout_ms=step.get("timeout_ms"),
            )
            out.append(("entry", v.admitted, v.reason, v.wait_ms, v.speculative, v.degraded))
        elif kind == "bulk":
            a, r, w, f = cli.bulk(
                step["resource"], step["n"], ts=step.get("ts"), acquire=step.get("acquire", 1),
                args_column=step.get("args_column"), timeout_ms=step.get("timeout_ms"),
            )
            out.append(("bulk", a.tolist(), r.tolist(), w.tolist(), f.tolist()))
        elif kind == "exit":
            cli.exit(
                step["resource"], rt=step.get("rt", 0), count=step.get("count", 1), err=step.get("err", 0),
                ts=step.get("ts"), speculative=step.get("speculative"),
            )
            out.append(("exit",))
        elif kind == "sleep":
            time.sleep(step["s"])


def run_script(channel, wid, script, q):
    """Run a scripted request sequence and report every verdict back as
    ``("done", wid, [per-step tuples])``."""
    from sentinel_tpu_torch.ipc.worker import IngestClient

    cli = IngestClient(channel, wid)
    out = []
    try:
        _run_steps(cli, script, out)
        q.put(("done", wid, out))
    finally:
        cli.close()


def run_script_cfg(channel, wid, cfg, script, q):
    """:func:`run_script` after a config replay: spawn children start from
    the defaults, so the micro-window or wakeup mode under test ships in
    (``api.run_workers`` does the same for a deployment)."""
    _apply_cfg(cfg)
    run_script(channel, wid, script, q)


def admit_and_hang(channel, wid, resource, n, q):
    """Admit ``n`` entries (charging THREAD gauges), report, then hang
    without exiting them: the parent kills this process as a crashed
    worker, and the plane's heartbeat sweep must auto-exit the
    admissions."""
    from sentinel_tpu_torch.ipc.worker import IngestClient

    cli = IngestClient(channel, wid)
    admitted = 0
    for _ in range(n):
        # A long verdict timeout: a policy-served verdict would admit
        # without charging the gauges the parent asserts on.
        v = cli.entry(resource, timeout_ms=120000)
        if v.admitted and not v.degraded:
            admitted += 1
    q.put(("admitted", wid, admitted, cuda_initialized()))
    while True:
        time.sleep(1.0)


def entry_with_trace(channel, wid, resource, traceparent, q):
    """One traced admission: the inbound W3C context is ambient in THIS
    process and must reach the engine's admission-trace records."""
    from sentinel_tpu_torch.core.context import ContextUtil
    from sentinel_tpu_torch.ipc.worker import IngestClient
    from sentinel_tpu_torch.metrics.admission_trace import parse_traceparent

    ContextUtil.set_trace(parse_traceparent(traceparent))
    cli = IngestClient(channel, wid)
    try:
        v = cli.entry(resource)
        q.put(("done", wid, (v.admitted, int(v.reason))))
    finally:
        cli.close()


def entries_until_dead(channel, wid, resource, q, max_n=2000):
    """Blocking entries until the engine reads dead (a policy-served
    verdict); reports how the worker saw the death."""
    from sentinel_tpu_torch.ipc.worker import IngestClient

    cli = IngestClient(channel, wid)
    served = []
    try:
        for _ in range(max_n):
            v = cli.entry(resource, timeout_ms=2000)
            served.append((v.admitted, int(v.reason), v.degraded))
            if v.degraded:
                break
            time.sleep(0.01)
        q.put(("done", wid, served))
    finally:
        cli.close()


def run_entries_spanned(channel, wid, cfg, resource, n, q):
    """A span-armed worker: replay ``cfg`` (spans on and the spill dir in
    it), run ``n`` blocking entries, close (which spills the journal) and
    report the journal's path, which the parent loads."""
    _apply_cfg(cfg)
    from sentinel_tpu_torch.ipc.worker import IngestClient
    from sentinel_tpu_torch.metrics.spans import get_journal

    cli = IngestClient(channel, wid)
    verdicts = []
    try:
        for _ in range(n):
            v = cli.entry(resource, timeout_ms=120000)
            verdicts.append((v.admitted, int(v.reason), v.degraded))
        q.put(("done", wid, verdicts, get_journal().spill_path()))
    finally:
        cli.close()


def worker_mode_entries(channel, wid, cfg, calls, q):
    """Worker mode end to end: THIS process arms
    ``sentinel.tpu.ipc.worker.mode``, attaches, and runs ``calls`` through
    the public API (``[(fn, resource, kwargs)]``, fn one of "entry",
    "try_entry", "entry_async", "entry_windowed"), exiting each admitted
    entry. Reports ``[(fn, resource, admitted, reason)]``, whether an
    Engine was built here (it must not be) and whether CUDA was set up."""
    _apply_cfg(cfg)
    from sentinel_tpu_torch.utils.config import config

    config.set(config.IPC_WORKER_MODE, "true")
    from sentinel_tpu_torch.core import api
    from sentinel_tpu_torch.core import errors as E
    from sentinel_tpu_torch.ipc import worker_mode

    worker_mode.attach(channel, wid)
    try:
        results = []
        for fn, resource, kwargs in calls:
            try:
                e = getattr(api, fn)(resource, **kwargs)
            except E.BlockError as exc:
                results.append((fn, resource, False, type(exc).__name__))
                continue
            if e is None:
                results.append((fn, resource, False, "None"))
                continue
            results.append((fn, resource, True, int(e.verdict.reason)))
            e.exit()
        q.put(("done", wid, results, api.peek_engine() is None, cuda_initialized()))
    finally:
        worker_mode.detach()


def worker_mode_admit_and_hang(channel, wid, resource, n, q):
    """Worker-mode kill target: hold ``n`` admitted ``api.entry`` calls
    open, each on a thread of its own, and never exit them; the parent
    kills this process mid-serve."""
    import threading

    from sentinel_tpu_torch.utils.config import config

    config.set(config.IPC_WORKER_MODE, "true")
    from sentinel_tpu_torch.core import api
    from sentinel_tpu_torch.ipc import worker_mode

    worker_mode.attach(channel, wid)
    hold = threading.Event()
    admitted = []

    def call():
        try:
            with api.entry(resource):
                admitted.append(1)
                hold.wait()  # never set: the entry stays live until the kill
        except BaseException:
            pass

    for _ in range(n):
        threading.Thread(target=call, daemon=True).start()
    while len(admitted) < n:
        time.sleep(0.05)
    q.put(("admitted", wid, len(admitted), api.peek_engine() is None))
    while True:
        time.sleep(1.0)


def api_entries(wid, resource, n, q):
    """An ``api.run_workers`` target: ``n`` ``api.entry`` calls in worker
    mode, each exited; reports ``(wid, admitted, blocked, engine built
    here?, CUDA set up?)``."""
    from sentinel_tpu_torch.core import api
    from sentinel_tpu_torch.core import errors as E

    admitted = blocked = 0
    for _ in range(n):
        try:
            with api.entry(resource):
                admitted += 1
        except E.BlockError:
            blocked += 1
    q.put((wid, admitted, blocked, api.peek_engine() is not None, cuda_initialized()))


# ---------------------------------------------------------------------------
# chip_smoke.py phase 4j: one worker process serving the parent's commands
# ---------------------------------------------------------------------------
def _loop_bulk(cli, resources, n, seconds, seed, timeout_ms=60000):
    """``bulk(res, n)`` in a loop for ``seconds`` of wall time, a random
    resource of ``resources`` each call, each call waiting at most
    ``timeout_ms``: (calls, rows, round trips in ms)."""
    import random

    rng = random.Random(seed)
    rtt = []
    t_end = time.perf_counter() + seconds
    while True:
        t0 = time.perf_counter()
        if t0 >= t_end:
            break
        cli.bulk(rng.choice(resources), n, timeout_ms=timeout_ms)
        rtt.append((time.perf_counter() - t0) * 1e3)
    return len(rtt), len(rtt) * n, rtt


def _loop_entry(cli, resources, seconds, threads, seed):
    """``entry(res)`` in a loop on ``threads`` threads for ``seconds``:
    (calls, round trips in ms)."""
    import random
    import threading

    rtts = [[] for _ in range(threads)]
    t_end = time.perf_counter() + seconds

    def run(i):
        rng = random.Random(seed * 100 + i)
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end:
                return
            cli.entry(rng.choice(resources), timeout_ms=60000)
            rtts[i].append((time.perf_counter() - t0) * 1e3)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    rtt = [x for r in rtts for x in r]
    return len(rtt), rtt


def _serve_commands(cli, wid, cmd_q, out_q, reattach=None) -> None:
    """Run the parent's commands on ``cli`` until ``("stop",)`` (see
    :func:`serve`)."""
    while True:
        cmd = cmd_q.get()
        kind = cmd[0]
        if kind == "stop":
            return
        if kind == "client":
            cli = reattach(cli, cmd[1])
            out_q.put(("client", wid, cuda_initialized()))
        elif kind == "script":
            out = []
            _run_steps(cli, cmd[1], out)
            out_q.put(("script", wid, out, cuda_initialized()))
        elif kind == "loop_bulk":
            frames0 = cli.counters["frames"]
            calls, rows, rtt = _loop_bulk(cli, *cmd[1:])
            out_q.put(("loop_bulk", wid, calls, rows, rtt, cli.counters["frames"] - frames0, cuda_initialized()))
        elif kind == "loop_entry":
            frames0 = cli.counters["frames"]
            calls, rtt = _loop_entry(cli, *cmd[1:])
            out_q.put(("loop_entry", wid, calls, rtt, cli.counters["frames"] - frames0, dict(cli.counters),
                       cuda_initialized()))
        elif kind == "counters":
            out_q.put(("counters", wid, dict(cli.counters), cuda_initialized()))


def serve(channel, wid, cmd_q, out_q):
    """A worker that runs the parent's commands in turn, each answered on
    ``out_q`` as ``(tag, wid, ...)``:

    * ``("client", cfg)``: replay ``cfg`` and attach a fresh IngestClient
      (the previous one closes first);
    * ``("script", steps)``: run the steps on the client (``_run_steps``);
    * ``("loop_bulk", resources, n, seconds, seed[, timeout_ms])`` and
      ``("loop_entry", resources, seconds, threads, seed)``: timed loops;
    * ``("counters",)``: the client's counters;
    * ``("stop",)``: close the client and return.

    Every answer carries ``cuda_initialized()`` last."""
    from sentinel_tpu_torch.ipc.worker import IngestClient

    held = [None]  # the client in use, closed however the loop ends

    def reattach(cli, cfg):
        if cli is not None:
            cli.close(clear_slot=False)
        _apply_cfg(cfg)
        held[0] = IngestClient(channel, wid)
        return held[0]

    try:
        _serve_commands(None, wid, cmd_q, out_q, reattach)
    finally:
        if held[0] is not None:
            held[0].close()
    out_q.put(("stopped", wid, cuda_initialized()))


def serve_worker_mode(wid, cmd_q, out_q):
    """:func:`serve` as a worker-mode target (``EngineSupervisor.spawn_worker``
    and ``api.run_workers``): the commands run on the client worker mode
    attached in this process, which ``worker_main`` closes; no
    ``("client", cfg)``."""
    from sentinel_tpu_torch.ipc import worker_mode

    _serve_commands(worker_mode.current(), wid, cmd_q, out_q)
    out_q.put(("stopped", wid, cuda_initialized()))


# ---------------------------------------------------------------------------
# the engine supervisor's setup callables (run in each engine child)
# ---------------------------------------------------------------------------
def restart_setup(engine):
    """The hot-restart chaos tests' rules: one wide-open resource."""
    from sentinel_tpu_torch.models.rules import FlowRule

    engine.set_flow_rules([FlowRule(resource="chaos-res", count=1e9)])


def standby_setup(engine):
    """The warm-standby chaos tests' rules: the open chaos resource and a
    THREAD-grade rule (count 3) whose gauge survives a takeover only if the
    ledger re-assert carried it."""
    from sentinel_tpu_torch.models import constants as C
    from sentinel_tpu_torch.models.rules import FlowRule

    engine.set_flow_rules([FlowRule(resource="chaos-res", count=1e9),
                           FlowRule(resource="sb-thread", count=3, grade=C.FLOW_GRADE_THREAD)])


def build_error_setup(engine):
    """:func:`standby_setup` with the flush kernels made to fail their build:
    the child's ``warm_probe`` raises ``KernelBuildError``."""
    from sentinel_tpu_torch.utils.cuda_build import KernelBuildError

    standby_setup(engine)

    def warm_probe(k: int = 1) -> float:
        raise KernelBuildError("flow_admission.cu: nvcc failed (injected)")

    engine.failover.warm_probe = warm_probe


def rules_setup(engine, flow=(), param=(), qps_rules=0, qps_count=20):
    """Rules from plain tuples: ``qps_rules`` DEFAULT QPS rules ``r0``,
    ``r1``, ... of count ``qps_count`` first, then ``flow`` as (resource,
    count, grade); ``param`` as (resource, param_idx, count). The QPS rules
    are made here, not shipped: a spawn argument above a pipe's 64 KiB
    blocks the parent's ``start()`` until the child has imported torch."""
    from sentinel_tpu_torch.models.rules import FlowRule, ParamFlowRule

    engine.set_flow_rules([FlowRule(resource=f"r{i}", count=qps_count) for i in range(qps_rules)]
                          + [FlowRule(resource=r, count=c, grade=g) for r, c, g in flow])
    rules = {}
    for r, idx, c in param:
        rules.setdefault(r, []).append(ParamFlowRule(resource=r, param_idx=idx, count=c))
    engine.set_param_rules(rules)


def _launch_counts() -> dict:
    from sentinel_tpu_torch.metrics import metric_array as ma
    from sentinel_tpu_torch.rules import param_table as tpt
    from sentinel_tpu_torch.runtime import flush

    return {"window_update": ma.update.launches, "flow_admission": flush.flow_admission.launches,
            "run_param": tpt.run_param.launches}


def _process_age_s() -> float:
    """Seconds since this process started (``/proc``; -1 where it is not)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return -1.0


def _reserved_mib(device) -> float:
    """The CUDA caching allocator's reserved MiB on ``device`` (0 on the CPU)."""
    import torch

    return torch.cuda.memory_reserved(device) / 2**20 if device.type == "cuda" else 0.0


def launch_report_setup(engine, report_dir, rules=None, interval_s=0.5):
    """:func:`rules_setup` with the keywords ``rules``, then report this child to
    ``report_dir/child-<pid>.json`` when it comes up, when its plane
    attaches and every ``interval_s`` after: its pid, ``engine.device``, whether its plane is
    attached, the launch counts of K2 (``window_update``), K4
    (``flow_admission``) and K10 (``run_param``) in all and since the plane
    attached, the drains that carried frames, the plane's request count, the
    CUDA allocator's reserved MiB, and the process's age when the setup began
    and the setup's seconds (where a child's boot goes).
    A launch in a child is invisible to its parent's counters; the report
    is how ``chip_smoke.py`` phase 4l reads them."""
    age_s = _process_age_s()
    t0 = time.perf_counter()
    rules_setup(engine, **(rules or {}))
    boot = {"age_at_setup_s": age_s, "setup_s": time.perf_counter() - t0}
    path = os.path.join(report_dir, f"child-{os.getpid()}.json")
    seen = {"plane": None, "base": None, "drains": 0}

    def count_drains(plane):
        drain = plane._drain_once

        def drain_and_count():
            worked = drain()
            if worked:
                seen["drains"] += 1
            return worked

        plane._drain_once = drain_and_count  # the drainer looks it up each call

    def write() -> None:
        plane = engine.ipc_plane
        counts = _launch_counts()
        if plane is not None and seen["plane"] is not plane:
            seen["plane"], seen["base"] = plane, dict(counts)
            count_drains(plane)
        base = seen["base"] or {k: 0 for k in counts}
        report = {"pid": os.getpid(), "device": str(engine.device), "t": time.time(), "attached": plane is not None,
                  "launches": counts, "launches_attached": {k: counts[k] - base[k] for k in counts},
                  "drains": seen["drains"], "reserved_mib": _reserved_mib(engine.device), **boot,
                  "requests": plane.snapshot()["counters"]["requests"] if plane is not None else 0}
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(report, f)
        os.replace(tmp, path)

    def loop() -> None:
        # The plane's attach is looked for every 10 ms, so that the launches
        # "since attached" start within 10 ms of it.
        last = time.monotonic()
        while True:
            time.sleep(0.01)
            if time.monotonic() - last >= interval_s or (engine.ipc_plane is not None) != (seen["plane"] is not None):
                last = time.monotonic()
                try:
                    write()
                except Exception:  # a report must never take the engine down
                    pass

    write()
    threading.Thread(target=loop, name="sentinel-launch-report", daemon=True).start()


def read_reports(report_dir) -> dict:
    """The children's reports by pid (``launch_report_setup``)."""
    out = {}
    for name in os.listdir(report_dir):
        if name.startswith("child-") and name.endswith(".json"):
            try:
                with open(os.path.join(report_dir, name)) as f:
                    rep = json.load(f)
            except (OSError, ValueError):
                continue
            out[rep["pid"]] = rep
    return out
