"""Heartbeat to the dashboard (port of ``sentinel_tpu/transport/heartbeat.py``).

Reference: SimpleHttpHeartbeatSender posts to the dashboard's
``/registry/machine`` every ~10 s with app / ip / port / version
(sentinel-transport-simple-http/.../heartbeat/
SimpleHttpHeartbeatSender.java:36-65); the dashboard feeds these into
its machine discovery (SimpleMachineDiscovery).

Beyond the reference's app/ip/port/version tuple, the heartbeat
carries the machine's admission-plane health so the dashboard's
machine table shows fleet state at a glance without a command-API
round-trip per machine:

* ``health``     — the failover state machine (HEALTHY / DEGRADED /
  RECOVERING; runtime/failover.py);
* ``spec_enabled`` / ``spec_suspended`` — speculative fast tier armed,
  and whether the drift valve currently has it suspended
  (runtime/speculative.py);
* ``ingest_armed`` / ``shed_total`` / ``shedding`` — ingest valve
  state, cumulative shed count, and whether sheds happened since the
  previous heartbeat (runtime/ingest.py).

The fields ride the same GET query; a dashboard that ignores them
(the seed dashboard did) keeps working unchanged.
"""

from __future__ import annotations

import socket
import threading
import time
import urllib.parse
import urllib.request
from typing import Optional

from sentinel_tpu_torch.utils.config import config
from sentinel_tpu_torch.utils.record_log import record_log
from sentinel_tpu_torch.version import __version__


def local_ip() -> str:
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("10.255.255.255", 1))
        ip = s.getsockname()[0]
        s.close()
        return ip
    except OSError:
        return "127.0.0.1"


class HeartbeatSender:
    def __init__(
        self,
        dashboard_addr: str,  # "host:port"
        command_port: int,
        app_name: Optional[str] = None,
        interval_sec: float = 10.0,
        engine=None,
    ) -> None:
        self.dashboard_addr = dashboard_addr
        self.command_port = command_port
        self.app_name = app_name or config.app_name
        self.interval = interval_sec
        # The engine whose health this heartbeat reports. None (the
        # seed signature) falls back to the process-global engine IF
        # one already exists — a heartbeat must never be the thing
        # that constructs the engine.
        self._engine = engine
        # Cumulative shed count as of the last DELIVERED heartbeat:
        # "shedding" means sheds happened since the dashboard last
        # heard from us. The baseline advances only on a successful
        # send (heartbeat_once), so a failed POST can't swallow a
        # shedding episode's edge.
        self._last_shed_total = 0
        self._pending_shed_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _health_params(self) -> dict:
        """The admission-plane health fields (empty dict when no
        engine exists yet — the heartbeat never constructs one)."""
        engine = self._engine
        if engine is None:
            from sentinel_tpu_torch.core.api import peek_engine

            engine = peek_engine()
        if engine is None:
            return {}
        spec = engine.speculative
        valve = engine.ingest
        shed_total = (
            valve.counters["shed_entries"] + valve.counters["shed_rows"]
        )
        if shed_total < self._last_shed_total:
            # The counters went backwards — Engine.reset() zeroed the
            # valve. Re-anchor, or the edge detector stays blind until
            # cumulative sheds re-exceed the pre-reset baseline.
            self._last_shed_total = 0
        shedding = shed_total > self._last_shed_total
        self._pending_shed_total = shed_total
        # Engine lifecycle provenance (PR 15 exposed these in
        # Prometheus; riding the heartbeat lets the dashboard's
        # Machines table flag a recently hot-restarted engine without
        # a scrape round-trip per machine). epoch 1 = first boot of
        # the shared rings; restarts = epoch - 1, matching the
        # sentinel_engine_restarts_total definition.
        plane = getattr(engine, "ipc_plane", None)
        epoch = plane.engine_epoch if plane is not None else 1
        workers = plane.live_workers() if plane is not None else 0
        return {
            "health": engine.failover.state,
            "spec_enabled": int(spec.enabled),
            "spec_suspended": int(spec.enabled and spec.suspended),
            "ingest_armed": int(valve.armed),
            "shed_total": shed_total,
            "shedding": int(shedding),
            "engine_epoch": epoch,
            "restarts_total": max(0, epoch - 1),
            "workers": workers,
        }

    def heartbeat_once(self) -> bool:
        fields = {
            "app": self.app_name,
            "app_type": config.get_int(config.APP_TYPE, 0),
            "version": __version__,
            "v": __version__,
            "hostname": socket.gethostname(),
            "ip": local_ip(),
            "port": self.command_port,
            "pid": 0,
        }
        fields.update(self._health_params())
        params = urllib.parse.urlencode(fields)
        url = f"http://{self.dashboard_addr}/registry/machine?{params}"
        try:
            with urllib.request.urlopen(url, timeout=3) as resp:
                ok = 200 <= resp.status < 300
        except OSError:
            return False
        if ok:
            # The dashboard has seen this interval's shedding flag:
            # only now does the edge detector's baseline advance.
            self._last_shed_total = self._pending_shed_total
        return ok

    def start(self) -> "HeartbeatSender":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="sentinel-heartbeat", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            ok = self.heartbeat_once()
            if not ok:
                record_log.warn("[HeartbeatSender] heartbeat to %s failed", self.dashboard_addr)
            self._stop.wait(self.interval)

    def stop(self) -> None:
        self._stop.set()
