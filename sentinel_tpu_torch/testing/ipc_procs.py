"""Spawn targets for worker processes of the multi-process ingest plane.

``multiprocessing`` spawn children import these by module name, so every
function here is top-level and imports what it needs itself. A worker
touches only the client surface (``ipc.worker``, ``ipc.worker_mode`` and
the public API in worker mode): no engine, no device. Each reports, when
asked, whether torch has set up CUDA in its process
(``torch.cuda.is_initialized()``), which must read False.

The targets serve the tests (``tests/test_torch_ipc_plane.py``,
``tests/test_torch_worker_mode.py``) and ``chip_smoke.py`` phase 4j
(:func:`serve`, a worker that runs the parent's commands in turn)."""

from __future__ import annotations

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
def _loop_bulk(cli, resources, n, seconds, seed):
    """``bulk(res, n)`` in a loop for ``seconds`` of wall time, a random
    resource of ``resources`` each call: (calls, rows, round trips in ms)."""
    import random

    rng = random.Random(seed)
    rtt = []
    t_end = time.perf_counter() + seconds
    while True:
        t0 = time.perf_counter()
        if t0 >= t_end:
            break
        cli.bulk(rng.choice(resources), n, timeout_ms=60000)
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


def serve(channel, wid, cmd_q, out_q):
    """A worker that runs the parent's commands in turn, each answered on
    ``out_q`` as ``(tag, wid, ...)``:

    * ``("client", cfg)``: replay ``cfg`` and attach a fresh IngestClient
      (the previous one closes first);
    * ``("script", steps)``: run the steps on the client (``_run_steps``);
    * ``("loop_bulk", resources, n, seconds, seed)`` and
      ``("loop_entry", resources, seconds, threads, seed)``: timed loops;
    * ``("stop",)``: close the client and return.

    Every answer carries ``cuda_initialized()`` last."""
    from sentinel_tpu_torch.ipc.worker import IngestClient

    cli = None
    try:
        while True:
            cmd = cmd_q.get()
            kind = cmd[0]
            if kind == "stop":
                break
            if kind == "client":
                if cli is not None:
                    cli.close(clear_slot=False)
                _apply_cfg(cmd[1])
                cli = IngestClient(channel, wid)
                out_q.put(("client", wid, cuda_initialized()))
            elif kind == "script":
                out = []
                _run_steps(cli, cmd[1], out)
                out_q.put(("script", wid, out, cuda_initialized()))
            elif kind == "loop_bulk":
                frames0 = cli.counters["frames"]
                calls, rows, rtt = _loop_bulk(cli, *cmd[1:])
                out_q.put(("loop_bulk", wid, calls, rows, rtt, cli.counters["frames"] - frames0,
                           cuda_initialized()))
            elif kind == "loop_entry":
                frames0 = cli.counters["frames"]
                calls, rtt = _loop_entry(cli, *cmd[1:])
                out_q.put(("loop_entry", wid, calls, rtt, cli.counters["frames"] - frames0,
                           dict(cli.counters), cuda_initialized()))
    finally:
        if cli is not None:
            cli.close()
    out_q.put(("stopped", wid, cuda_initialized()))
