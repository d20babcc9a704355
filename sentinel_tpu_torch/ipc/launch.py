"""N-process worker deployment of the multi-process ingest plane, the CLI
face of ``api.run_workers`` and ``api.run_engine_supervised`` (the port of
the JAX package's ``tools/ipc_launch.py``)::

    python -m sentinel_tpu_torch.ipc.launch myservice:app --workers 4 --port 8080 --no-wrap
    python -m sentinel_tpu_torch.ipc.launch --supervise --setup mymod:load_rules --workers 4 --no-wrap
    python -m sentinel_tpu_torch.ipc.launch --smoke --device cpu

The engine runs in this process, or with ``--supervise`` in a supervised
child on named shared-memory rings (``ipc/supervise.py``): a crashed engine
restarts on the shared Backoff and re-attaches to the EXISTING rings, and
the workers ride out the outage on the failover-policy snapshot, then
re-assert their live-admission ledgers. Each worker process runs in ipc
worker mode and serves the WSGI app on ``port + worker_id``. The engine
runs on the card unless ``--device cpu`` is given.

Wrapping the app in the Sentinel WSGI middleware (the default without
``--no-wrap``) needs the adapters, which are not ported yet: it raises,
naming ROADMAP item 11, and so does the smoke's worker-mode WSGI phase
(``--smoke wsgi``). ``--smoke`` runs the restart phase (a supervised engine
``kill -9``'d mid-probing must come back on the same rings with the
probing client reconnected) and the standby phase (a warm standby's
takeover after ``kill -9``, then a planned handoff with no policy-served
verdict).
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import tempfile
import time

from sentinel_tpu_torch.utils.unported import ROADMAP_ADAPTERS, unported

SMOKE_PHASES = ("wsgi", "restart", "standby")


def _load(spec: str):
    mod, _, attr = spec.partition(":")
    return getattr(importlib.import_module(mod), attr or "app")


def _demo_app(environ, start_response):
    start_response("200 OK", [("Content-Type", "text/plain")])
    return [b"ok\n"]


def serve_wsgi(worker_id: int, spec: str, port: int) -> None:
    """Worker target: serve the WSGI app, as it is, on ``port + worker_id``
    (top level, so that spawn children import it by name)."""
    from wsgiref.simple_server import make_server

    app = _demo_app if spec == "-" else _load(spec)
    srv = make_server("127.0.0.1", port + worker_id, app)
    print(f"[ipc.launch] worker {worker_id} serving on http://127.0.0.1:{port + worker_id}", flush=True)
    srv.serve_forever()


def smoke_engine_setup(engine) -> None:
    """Supervised-engine setup of the smoke: the wide-open rule it probes."""
    from sentinel_tpu_torch.models.rules import FlowRule

    engine.set_flow_rules([FlowRule(resource="web-total", count=1e9)])


def _smoke_config(ckpt_name: str) -> str:
    """Liveness settings for a loaded box (each engine child pays torch's
    import and its engine's build on boot) and a durable checkpoint file;
    returns its path."""
    from sentinel_tpu_torch.utils.config import config

    config.set(config.IPC_HEARTBEAT_MS, "50")
    config.set(config.IPC_ENGINE_DEAD_MS, "2000")
    config.set(config.IPC_WORKER_DEAD_MS, "60000")
    config.set(config.SUPERVISE_BACKOFF_MS, "200")
    config.set(config.FAILOVER_ENABLED, "true")
    config.set(config.FAILOVER_CHECKPOINT_EVERY, "2")
    ckpt_dir = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()
    ckpt = os.path.join(ckpt_dir, f"{ckpt_name}-{os.getpid()}.bin")
    config.set(config.FAILOVER_CKPT_PATH, ckpt)
    return ckpt


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _smoke_restart(device) -> None:
    """The engine's recovery loop end to end: a supervised engine up, a
    probing client on the rings, ``kill -9`` of the engine child; the
    supervisor must bring a new engine up on the SAME rings, and the client
    must reconnect and get device-backed verdicts again."""
    from sentinel_tpu_torch.ipc.supervise import measure_restart_outage

    ckpt = _smoke_config("stpu-smoke-ckpt")
    try:
        out = measure_restart_outage(smoke_engine_setup, "web-total", timeout_s=240, device=device)
        if out["restarts"] < 1 or out["reconnects"] < 1:
            raise RuntimeError(f"restart smoke: no restart or no reconnect: {out}")
        print(f"[ipc.launch] restart smoke OK: outage {out['outage_ms']:.0f} ms, {out['policy_served']} "
              f"policy-served probes, {out['restarts']} restart(s), {out['reconnects']} client reconnect(s)",
              flush=True)
    finally:
        _unlink(ckpt)


def _smoke_standby(device) -> None:
    """A warm standby's takeover after ``kill -9`` (an outage bounded by the
    detection window, not a cold boot), then a planned handoff that ends
    with no policy-served verdict."""
    from sentinel_tpu_torch.ipc.supervise import measure_handoff_outage, measure_standby_outage
    from sentinel_tpu_torch.utils.config import config

    ckpt = _smoke_config("stpu-smoke-sb")
    config.set(config.IPC_ENGINE_DEAD_CONFIRM_MS, "1000")
    config.set(config.IPC_HANDOFF_WAIT_MS, "30000")
    config.set(config.SUPERVISE_STANDBY, "true")
    config.set(config.SUPERVISE_STANDBY_WARM_MS, "500")
    try:
        out = measure_standby_outage(smoke_engine_setup, "web-total", timeout_s=240, device=device)
        if out["standby_takeovers"] < 1 or out["restarts"] != 0:
            raise RuntimeError(f"standby smoke: not a takeover: {out}")
        print(f"[ipc.launch] standby smoke OK: outage {out['outage_ms']:.0f} ms (warm boot "
              f"{out['standby_warm_boot_ms']:.0f} ms off the outage path), {out['policy_served']} policy-served "
              f"probes, {out['standby_takeovers']} takeover(s)", flush=True)
        out = measure_handoff_outage(smoke_engine_setup, "web-total", timeout_s=240, device=device)
        if out["handoffs"] < 1 or out["policy_served"] or out["not_admitted"]:
            raise RuntimeError(f"handoff smoke: {out}")
        print(f"[ipc.launch] handoff smoke OK: worst verdict gap {out['handoff_outage_ms']:.0f} ms, 0 "
              f"policy-served, {out['handoffs']} handoff(s)", flush=True)
    finally:
        _unlink(ckpt)


def smoke(phases, device) -> int:
    """The self-test: each named phase in order; raises on the first that
    fails, else returns 0."""
    for phase in phases:
        if phase == "wsgi":
            raise unported("the worker-mode WSGI smoke (SentinelWSGIMiddleware)", ROADMAP_ADAPTERS)
        (_smoke_restart if phase == "restart" else _smoke_standby)(device)
    return 0


def _serve_supervised(args) -> int:
    from sentinel_tpu_torch.core import api

    setup = _load(args.setup) if args.setup else None
    sup = api.run_engine_supervised(setup=setup, n_workers=args.workers, device=args.device)
    procs = [sup.spawn_worker(serve_wsgi, wid, (args.app, args.port)) for wid in range(args.workers)]
    print(f"[ipc.launch] supervised engine up (pid {sup.engine_pid()}), {len(procs)} workers (ports {args.port}.."
          f"{args.port + args.workers - 1}); Ctrl-C stops", flush=True)
    seen = 0
    try:
        while True:
            time.sleep(1.0)
            if sup.restarts != seen:
                seen = sup.restarts
                print(f"[ipc.launch] engine restarted (#{seen}, pid {sup.engine_pid()})", flush=True)
            if sup.gave_up:
                print("[ipc.launch] supervisor gave up (restart budget spent)", flush=True)
                return 1
    except KeyboardInterrupt:
        print("[ipc.launch] stopping", flush=True)
    finally:
        sup.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("app", nargs="?", default="-", help="WSGI app as module:attr ('-' = the built-in demo app)")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--no-wrap", action="store_true", help="serve the app as it is (it is already wrapped)")
    ap.add_argument("--client-window-ms", type=float, default=None, help="arm the worker-side micro-window")
    ap.add_argument("--wakeup", choices=("sleep", "adaptive"), default=None)
    ap.add_argument("--supervise", action="store_true",
                    help="run the engine in a supervised child process (restarted on a crash; workers ride out "
                         "the outage on the policy snapshot and reconnect)")
    ap.add_argument("--setup", default=None,
                    help="module:fn loading rules in the supervised engine child (called as fn(engine))")
    ap.add_argument("--device", default=None, help="the engine's device (default: the card; 'cpu' runs the "
                                                   "kernels' plain versions)")
    ap.add_argument("--smoke", nargs="?", const="restart,standby", default=None, metavar="PHASES",
                    help=f"run the self-test's phases (comma-separated, of {', '.join(SMOKE_PHASES)}; default "
                         "restart,standby) and exit")
    args = ap.parse_args(argv)

    from sentinel_tpu_torch.utils.config import config

    if args.client_window_ms is not None:
        config.set(config.IPC_CLIENT_WINDOW_MS, str(args.client_window_ms))
    if args.wakeup is not None:
        config.set(config.IPC_WAKEUP, args.wakeup)
    if args.smoke is not None:
        phases = [p.strip() for p in args.smoke.split(",") if p.strip()]
        bad = [p for p in phases if p not in SMOKE_PHASES]
        if bad:
            ap.error(f"--smoke: unknown phase(s) {bad}")
        return smoke(phases, args.device)
    if not args.no_wrap:
        raise unported("the WSGI middleware (SentinelWSGIMiddleware)", ROADMAP_ADAPTERS)
    if args.supervise:
        return _serve_supervised(args)

    from sentinel_tpu_torch.core import api

    eng = api.reset(device=args.device)
    ws = api.run_workers(serve_wsgi, n=args.workers, args=(args.app, args.port), engine=eng)
    print(f"[ipc.launch] {len(ws.procs)} workers up (ports {args.port}..{args.port + args.workers - 1}); Ctrl-C stops",
          flush=True)
    try:
        ws.join()
    except KeyboardInterrupt:
        print("[ipc.launch] stopping workers", flush=True)
        ws.stop()
    finally:
        eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
