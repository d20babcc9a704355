"""Shared pieces of the token-plane tests (tests/test_torch_cluster_wire.py,
test_torch_cluster_shards.py, test_torch_gossip.py): one package's cluster
surface as a namespace, and a fixture that resets both packages' cluster
globals, configs and counters around a test.

Socket tests here decide nothing on a wall-clock deadline: a server's death
is a ``stop()`` the test awaits, request timeouts are long (``LONG_S``), and
``wait_for`` only guards a state the test reaches by itself."""

import importlib
import itertools
import time
from types import SimpleNamespace

import pytest

PKGS = ("sentinel_tpu", "sentinel_tpu_torch")
LONG_S = 60.0  # request timeouts: never the path a test takes


class Pkg:
    """One package's cluster surface: modules, and makers of services,
    servers, clients and engines (the port's on the CPU)."""

    def __init__(self, name: str) -> None:
        imp = lambda mod: importlib.import_module(f"{name}.{mod}")  # noqa: E731
        self.name = name
        self.is_torch = name == "sentinel_tpu_torch"
        self.cl = imp("cluster")
        self.protocol = imp("cluster.protocol")
        self.server_mod = imp("cluster.server")
        self.client_mod = imp("cluster.client")
        self.shards = imp("cluster.shards")
        self.gossip = imp("cluster.gossip")
        self.state = imp("cluster.state")
        self.concurrent = imp("cluster.concurrent")
        self.stat_log = imp("cluster.stat_log")
        self.rules = imp("models.rules")
        self.C = imp("models.constants")
        self.clock = imp("utils.clock")
        self.config = imp("utils.config").config
        self.engine_mod = imp("runtime.engine")
        self.dev = {"device": "cpu"} if self.is_torch else {}

    def service(self, clock):
        return self.cl.DefaultTokenService(clock=clock, **self.dev)

    def server(self, clock):
        return self.server_mod.SentinelTokenServer(port=0, service=self.service(clock)).start()

    def client(self, port: int, **kw):
        return self.client_mod.ClusterTokenClient("127.0.0.1", port, request_timeout_sec=LONG_S, **kw).start()

    def engine(self, clock):
        return self.engine_mod.Engine(clock=clock, **self.dev)

    def rule(self, resource, count, flow_id, global_=True, fallback=True, grade=None, param=False):
        cfg = self.rules.ClusterFlowConfig(
            flow_id=flow_id,
            threshold_type=self.C.FLOW_THRESHOLD_GLOBAL if global_ else self.C.FLOW_THRESHOLD_AVG_LOCAL,
            fallback_to_local_when_fail=fallback,
        )
        kw = {} if grade is None else {"grade": grade}
        if param:
            return self.rules.ParamFlowRule(resource, count=count, param_idx=0, cluster_mode=True, cluster_config=cfg,
                                            **kw)
        return self.rules.FlowRule(resource, count=count, cluster_mode=True, cluster_config=cfg, **kw)

    def set_config(self, **keys) -> None:
        for key, value in keys.items():
            self.config.set(getattr(self.config, key), str(value))


def wait_for(pred, what: str, guard_s: float = LONG_S) -> None:
    """Wait until ``pred()`` holds: a state the test brings about itself;
    the guard only ends a hung run."""
    deadline = time.monotonic() + guard_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not reached in {guard_s} s")
        time.sleep(0.005)


def _clear(p: Pkg) -> None:
    p.cl.cluster_flow_rule_manager.clear()
    p.cl.cluster_server_config_manager.load_global_flow_config(exceed_count=1.0, max_allowed_qps=30000.0)
    p.cl.ClusterStateManager.stop()
    p.cl.TokenClientProvider.clear()
    p.cl.EmbeddedClusterTokenServerProvider.clear()
    p.client_mod.client_stats.reset()
    p.gossip.gossip_stats.reset()
    p.stat_log.reset_counters()


def _jax_read_loop_leases_first(self) -> None:
    """``sentinel_tpu.cluster.client.ClusterTokenClient._read_loop`` with the
    port's order: a batch frame's leases stored before its callers wake.
    The JAX loop wakes them first, so whether their next frame sees the
    leases races the reader thread (ROADMAP Queue 3); lockstep runs with
    leases need the JAX client to decide alike run after run."""
    import struct

    from sentinel_tpu.cluster import client as jc

    sock = self._sock
    try:
        while not self._stopped.is_set() and sock is not None:
            payload = jc.protocol.read_frame(sock)
            if payload is None:
                break
            if jc.protocol.peek_msg_type(payload) in (jc.C.MSG_TYPE_FLOW_BATCH, jc.C.MSG_TYPE_PARAM_FLOW_BATCH):
                xid, _mt, rows, leases = jc.protocol.unpack_batch_response(payload)
                if leases:
                    self._store_leases(leases)
                with self._pending_lock:
                    p = self._pending.pop(xid, None)
                if isinstance(p, jc._BatchPending):
                    p.set_batch(rows)
                elif p is not None:
                    p.set(jc.TokenResult(jc.C.TokenResultStatus.FAIL))
                continue
            xid, _mt, status, remaining, wait_ms, token_id = jc.protocol.unpack_response(payload)
            with self._pending_lock:
                p = self._pending.pop(xid, None)
            if p is not None:
                p.set(jc.TokenResult(jc.C.TokenResultStatus(status), remaining, wait_ms, token_id))
    except (OSError, ValueError, struct.error):
        pass
    finally:
        self._close()


@pytest.fixture
def both(monkeypatch):
    """Both packages' surfaces (JAX first), their cluster globals, counters
    and runtime config reset before and after the test; the JAX client
    stores a frame's leases before its callers wake, as the port's does."""
    from sentinel_tpu.cluster import client as jc

    monkeypatch.setattr(jc.ClusterTokenClient, "_read_loop", _jax_read_loop_leases_first)
    pkgs = [Pkg(n) for n in PKGS]
    saved = []
    for p in pkgs:
        with p.config._lock:
            saved.append(dict(p.config._runtime))
        _clear(p)
    try:
        yield pkgs
    finally:
        for p, runtime in zip(pkgs, saved):
            _clear(p)
            with p.config._lock:
                p.config._runtime.clear()
                p.config._runtime.update(runtime)


@pytest.fixture
def fixed_token_ids(monkeypatch):
    """Concurrency token ids from one counter shared by both packages'
    managers (they draw uuid4's bits): call ``reset()`` before each run so
    that equal runs hand out equal ids."""
    seq = {"it": itertools.count(1)}

    def uuid4():
        return SimpleNamespace(int=next(seq["it"]) << 65)

    for name in PKGS:
        mod = importlib.import_module(f"{name}.cluster.concurrent")
        monkeypatch.setattr(mod, "uuid", SimpleNamespace(uuid4=uuid4))
    return SimpleNamespace(reset=lambda: seq.update(it=itertools.count(1)))
