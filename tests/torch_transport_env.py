"""Shared pieces of the control-surface tests (tests/test_torch_transport.py,
test_torch_prometheus.py, test_torch_slots.py and the restored command
cases): one package's surface as a namespace, and a fixture that gives both
packages a global engine under a ManualClock (the port's on the CPU) with a
command center on a loopback port, and puts their globals back afterwards.

Nothing here waits on a wall clock: the commands are answered before the
request returns, and the heartbeat posts once, when asked."""

import importlib
import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

PKGS = ("sentinel_tpu", "sentinel_tpu_torch")

# Families whose values are wall times, or that count each package's own
# staging layout; their lines are not compared.
EXCLUDED = {
    # Histograms of wall-clock durations: the sample counts (``_count``)
    # are compared, the buckets and sums are host timings.
    **{f"sentinel_engine_{h}_{s}": "a wall-time histogram"
       for h in ("flush_duration_ms", "drain_duration_ms", "e2e_duration_ms", "admission_latency_ms")
       for s in ("bucket", "sum")},
    **{f"sentinel_engine_last_flush_{st}": "the last flush's host wall time"
       for st in ("encode_ms", "dispatch_ms", "kernel_ms", "drain_ms")},
    "sentinel_engine_arena_hits_total": "each package's staging layout (one set a chunk in the port)",
    "sentinel_engine_arena_misses_total": "each package's staging layout",
    "sentinel_engine_checkpoint_durable_age_ms": "wall clock since the last spill",
    "sentinel_engine_checkpoint_durable_write_ms": "the spill's wall time",
    "sentinel_engine_ingest_estimate_ms": "an EWMA of settle wall times",
    "sentinel_cluster_rpc_ms_bucket": "a wall-time histogram",
    "sentinel_cluster_rpc_ms_sum": "a wall-time histogram",
    "sentinel_cluster_server_busy_seconds_total": "handler wall seconds",
}


def comparable(text: str) -> list:
    """The lines of a scrape that are compared (see ``EXCLUDED``)."""
    out = []
    for line in text.splitlines():
        if not line.startswith("#"):
            name = line.split("{", 1)[0].split(" ", 1)[0]
            if name in EXCLUDED:
                continue
        out.append(line)
    return out


def module_of(lib, mod: str):
    """A module of a torch_lockstep ``lib``'s package, such as
    ``"transport.prometheus"``."""
    return importlib.import_module(("sentinel_tpu" if lib.name == "jax" else "sentinel_tpu_torch") + "." + mod)


def reset_process_counters(lib) -> None:
    """Zero ``lib``'s process-wide cluster counters (the client's, gossip's
    and the stat log's), which a scrape renders and earlier tests in the
    same process may have moved, as a fresh process has them."""
    module_of(lib, "cluster.client").client_stats.reset()
    module_of(lib, "cluster.gossip").gossip_stats.reset()
    module_of(lib, "cluster.stat_log").reset_counters()


def side(name: str) -> SimpleNamespace:
    """One package's control surface; ``dev`` is the keyword that puts an
    engine on the CPU (the port's; the JAX package takes none)."""
    imp = lambda mod: importlib.import_module(f"{name}.{mod}")  # noqa: E731
    return SimpleNamespace(
        name=name, st=importlib.import_module(name), api=imp("core.api"),
        E=imp("core.errors"), clk=imp("utils.clock"), config=imp("utils.config").config, slots=imp("core.slots"),
        registry=imp("utils.registry"), ds=imp("datasource"), cc=imp("transport.command_center"),
        handlers=imp("transport.handlers"), prom=imp("transport.prometheus"), hb=imp("transport.heartbeat"),
        engine_mod=imp("runtime.engine"), extension=imp("metrics.extension"), cl=imp("cluster"),
        client_mod=imp("cluster.client"), gossip=imp("cluster.gossip"), stat_log=imp("cluster.stat_log"),
        spans=imp("metrics.spans"), faults=imp("testing.faults"),
        dev={"device": "cpu"} if name == "sentinel_tpu_torch" else {},
    )


def http(port: int, path: str, body: bytes = None, **params):
    """(status, body) of one command over loopback HTTP: GET with query
    parameters, or POST of ``body``."""
    qs = urllib.parse.urlencode(params)
    url = f"http://127.0.0.1:{port}/{path}" + (f"?{qs}" if qs else "")
    try:
        with urllib.request.urlopen(url, data=body, timeout=30) as resp:
            return resp.status, resp.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def _clear_globals(p) -> None:
    p.slots.SlotChainRegistry.clear()
    p.ds.WritableDataSourceRegistry.clear()
    p.extension.MetricExtensionProvider.clear()
    for iface in ("InitFunc", "ProcessorSlot", "MetricExtension"):
        with p.registry.Registry._global_lock:
            p.registry.Registry._registries.pop(iface, None)
    p.cl.cluster_flow_rule_manager.clear()
    p.cl.cluster_server_config_manager.load_global_flow_config(exceed_count=1.0, max_allowed_qps=30000.0)
    p.cl.ClusterStateManager.stop()
    p.cl.TokenClientProvider.clear()
    p.cl.EmbeddedClusterTokenServerProvider.clear()
    p.client_mod.client_stats.reset()
    p.gossip.gossip_stats.reset()
    p.stat_log.reset_counters()


class Pair:
    """Both packages, JAX first: ``sides``; each with ``clock``, ``engine``
    (the global one) and ``center`` (its command center)."""

    def __init__(self) -> None:
        self.sides = [side(n) for n in PKGS]

    @property
    def jax(self):
        return self.sides[0]

    @property
    def port(self):
        return self.sides[1]

    def reset(self, **cfg):
        """Fresh global engines on both sides, built after ``cfg``
        (config key name -> value) is set; returns them."""
        out = []
        for p in self.sides:
            for key, value in cfg.items():
                p.config.set(getattr(p.config, key), str(value))
            p.api.reset(clock=p.clock, **p.dev)
            p.engine = p.api.get_engine()
            out.append(p.engine)
        return out

    def set_ms(self, t: int) -> None:
        for p in self.sides:
            p.clock.set_ms(t)

    def get(self, path: str, body: bytes = None, **params):
        """The same command to both command centers: [(status, body)] x 2."""
        return [http(p.center.port, path, body, **params) for p in self.sides]

    def same(self, path: str, body: bytes = None, drop=(), **params):
        """The same command to both; the statuses and the bodies (parsed as
        JSON where they are JSON) must be equal, but for the top-level keys
        in ``drop``. Returns the port's parsed body."""
        got = []
        for status, text in self.get(path, body, **params):
            try:
                val = json.loads(text)
            except ValueError:
                val = text
            if isinstance(val, dict):
                val = {k: v for k, v in val.items() if k not in drop}
            got.append((status, val))
        assert got[1] == got[0], f"/{path} {params}: JAX {got[0]!r:.600} != port {got[1]!r:.600}"
        return got[1][1]


@pytest.fixture
def pair():
    """Both packages with a global engine under a ManualClock at 0 (every
    admission traced) and a command center on loopback port 0; their config,
    default clock, engine and registries are put back afterwards."""
    pr = Pair()
    saved = []
    for p in pr.sides:
        with p.config._lock:
            saved.append(dict(p.config._runtime))
        _clear_globals(p)
        p.clock = p.clk.ManualClock(start_ms=0)
        p.prev_clock = p.clk.set_default_clock(p.clock)
    # Every admission traced: head sampling draws from each package's own
    # random source, so only the rates 0 and 1 give both the same records.
    pr.reset(TRACE_SAMPLE_RATE="1.0")
    for p in pr.sides:
        p.center = p.cc.CommandCenter(port=0).start()
    try:
        yield pr
    finally:
        for p, runtime in zip(pr.sides, saved):
            p.center.stop()
            _clear_globals(p)
            with p.config._lock:
                p.config._runtime.clear()
                p.config._runtime.update(runtime)
            p.clk.set_default_clock(p.prev_clock)
            p.api.reset(**p.dev)


class FakeDashboard:
    """An in-process dashboard that records each heartbeat's query
    (``/registry/machine``) and answers 200."""

    def __init__(self) -> None:
        beats = self.beats = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                beats.append((parsed.path, dict(urllib.parse.parse_qsl(parsed.query))))
                data = b'{"code": 0}'
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
