"""The sharded token plane of the port (sentinel_tpu_torch/cluster/shards.py)
against the JAX package's (tests/test_cluster_sharded.py's cases):
``shard_of`` for 10,000 flow ids and 1-16 shards; ``ShardMap.from_config``
on the same configs; the verdicts of a ``ShardedTokenClient`` over several
servers equal one server's, on the wire and through an engine in client
mode, with leases off and on, and equal the JAX plane's; a version reload
swaps the connection set (and notes the new map in the capture journal);
a held token's release goes to the shard that granted it; a dead shard
degrades only its own flows and leases.

A server's death is a ``stop()`` the test awaits; request timeouts are
long. Tolerance zero."""

import numpy as np
import pytest

from torch_cluster_env import LONG_S, both, wait_for  # noqa: F401  (fixtures)


def _servers(p, n, clock=None):
    clock = clock or p.clock.ManualClock(0)
    return [p.server(clock) for _ in range(n)]


def _sharded(p, servers, **kw):
    smap = p.shards.ShardMap(0, [("127.0.0.1", s.port) for s in servers])
    return p.shards.ShardedTokenClient(smap, request_timeout_sec=LONG_S, **kw).start()


def _client(p, servers):
    if len(servers) == 1:
        return p.client(servers[0].port)
    return _sharded(p, servers)


def _flow_on_shard(p, shard, n_shards, start=12000):
    fid = start
    while p.shards.shard_of(fid, n_shards) != shard:
        fid += 1
    return fid


def _stop(client, servers):
    client.stop()
    for s in servers:
        s.stop()


# --- routing and the map ------------------------------------------------------


def test_shard_of_matches_jax(both):
    """10,000 flow ids (the first 5,000, then random i64 of both signs) on
    1-16 shards route alike; the pinned values of the JAX test hold."""
    j, t = both
    rng = np.random.default_rng(5)
    fids = list(range(5000)) + [int(v) for v in rng.integers(-(2**63), 2**63 - 1, 5000, dtype=np.int64)]
    for n in range(1, 17):
        assert [t.shards.shard_of(f, n) for f in fids] == [j.shards.shard_of(f, n) for f in fids], n
    assert [t.shards.shard_of(f, 4) for f in range(10)] == [1, 3, 0, 2, 3, 1, 2, 0, 0, 2]
    assert {t.shards.shard_of(f, 4) for f in range(256)} == {0, 1, 2, 3}


_MAPS = [
    {},
    {"CLUSTER_SHARDS": 2, "CLUSTER_SHARDS_MAP": "127.0.0.1:1001,127.0.0.1:1002", "CLUSTER_SHARDS_MAP_VERSION": 3},
    {"CLUSTER_SHARDS": 4, "CLUSTER_SHARDS_MAP": "127.0.0.1:1001,127.0.0.1:1002"},
    {"CLUSTER_SHARDS": 3, "CLUSTER_SHARDS_MAP": " h1:70, :71 ,bad,h3:x,h4:72,h5:73", "CLUSTER_SHARDS_MAP_VERSION": 9},
    {"CLUSTER_SHARDS": 2, "CLUSTER_SHARDS_MAP": ":1,:2,:3"},
]


@pytest.mark.parametrize("keys", _MAPS, ids=["default", "two", "short", "garbled", "hostless"])
@pytest.mark.parametrize("default_host", ["", "10.0.0.9"])
def test_shard_map_from_config_matches_jax(both, keys, default_host):
    out = []
    for p in both:
        p.set_config(**keys)
        m = p.shards.ShardMap.from_config(default_host=default_host)
        out.append(None if m is None else (m.version, m.endpoints, m.n_shards))
    assert out[1] == out[0]


def test_build_client_picks_sharded(both):
    _, t = both
    t.set_config(CLUSTER_SHARDS=2, CLUSTER_SHARDS_MAP="127.0.0.1:1001,127.0.0.1:1002")
    client = t.state.ClusterClientConfigManager.build_client()
    assert isinstance(client, t.shards.ShardedTokenClient) and client.n_shards == 2
    t.set_config(CLUSTER_SHARDS=1)
    assert t.state.ClusterClientConfigManager.build_client() is None  # no server address either
    t.state.ClusterClientConfigManager.apply("127.0.0.1", 1003, timeout_ms=1500, namespace="ns")
    try:
        client = t.state.ClusterClientConfigManager.build_client()
        assert isinstance(client, t.client_mod.ClusterTokenClient)
        assert (client.port, client.timeout, client.namespace) == (1003, 1.5, "ns")
    finally:
        t.state.ClusterClientConfigManager.apply("", 0, timeout_ms=200, namespace="default")


# --- sharded verdicts against one server's ------------------------------------


def _wire_run(p, n_shards, lease_on):
    """Three windows of flow-batch rows over 6 flows and a param batch over
    2, through ``n_shards`` servers: (statuses, remaining) of each row."""
    flows = [12000 + k for k in range(6)]
    pflows = [12100, 12101]
    p.cl.cluster_flow_rule_manager.load_rules("default", [p.rule(f"r{k}", 4, f) for k, f in enumerate(flows)]
                                              + [p.rule(f"p{k}", 2, f, param=True) for k, f in enumerate(pflows)])
    p.set_config(CLUSTER_LEASE_ENABLED="true" if lease_on else "false", CLUSTER_LEASE_TTL_MS=600000,
                 CLUSTER_LEASE_MIN_BATCH=2)
    rows = [(flows[i % 6], 1, False) for i in range(48)]
    prows = [(pflows[i % 2], 1, ["v%d" % (i % 3)]) for i in range(24)]
    servers = _servers(p, n_shards)
    client = _client(p, servers)
    try:
        out = []
        for _ in range(3):
            for i in range(0, 48, 16):
                out.extend((int(r.status), r.remaining) for r in client.request_tokens_batch(rows[i:i + 16]))
        out.extend((int(r.status), r.remaining) for r in client.request_param_tokens_batch(prows))
        return out
    finally:
        _stop(client, servers)


@pytest.mark.parametrize("lease_on", [False, True], ids=["leases_off", "leases_on"])
def test_sharded_verdicts_equal_single_server(both, lease_on):
    """4 shards and 1 server give the same rows, in each package, and the
    port's equal the JAX package's."""
    j, t = both
    want = _wire_run(j, 1, lease_on)
    assert _wire_run(t, 4, lease_on) == _wire_run(t, 1, lease_on) == want
    assert _wire_run(j, 4, lease_on) == want
    assert {s for s, _ in want} == {0, 1}


def _engine_run(p, n_shards, depth, lease_on):
    """submit_many through an engine in client mode over ``n_shards``
    servers, two windows at pipeline depth ``depth``: the verdicts."""
    flows = [12200 + k for k in range(4)]
    rules = [p.rule(f"s{k}", 5, f) for k, f in enumerate(flows)]
    p.cl.cluster_flow_rule_manager.load_rules("default", rules)
    p.set_config(CLUSTER_LEASE_ENABLED="true" if lease_on else "false", CLUSTER_LEASE_TTL_MS=600000)
    clock = p.clock.ManualClock(1000)
    servers = _servers(p, n_shards, clock)
    client = _client(p, servers)
    p.cl.TokenClientProvider.register(client)
    p.cl.ClusterStateManager.set_to_client()
    eng = p.engine(clock)
    try:
        eng.pipeline_depth = depth
        eng.set_flow_rules(rules)
        ops = []
        for _ in range(2):
            ops += eng.submit_many([{"resource": f"s{i % 4}", "ts": 1000} for i in range(32)])
            eng.flush()
        eng.drain()
        return [(bool(o.verdict.admitted), int(o.verdict.reason)) for o in ops]
    finally:
        eng.close()
        _stop(client, servers)
        p.cl.TokenClientProvider.clear()
        p.cl.ClusterStateManager.stop()


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("lease_on", [False, True], ids=["leases_off", "leases_on"])
def test_engine_sharded_equals_single_server(both, depth, lease_on):
    """The engine's bulk seam over 3 shards: the single-server verdicts, and
    the JAX engine's over 3 shards; 4 flows x count 5 admit 20."""
    j, t = both
    got = _engine_run(t, 3, depth, lease_on)
    assert got == _engine_run(t, 1, depth, lease_on) == _engine_run(j, 3, depth, lease_on)
    assert sum(a for a, _ in got) == 20


# --- the map's version, held tokens, dead shards --------------------------------


class _Capture:
    def __init__(self):
        self.shards = []

    def note_shard(self, version, mapping=""):
        self.shards.append((version, mapping))


def test_version_reload_swaps_the_connection_set(both, monkeypatch):
    """A moved map version rebuilds the connection set at the next entry
    point, and the capture journal of the installed engine notes the new
    map as ``host:port`` pairs (the JAX package joins the endpoint tuples
    there, which raises: ROADMAP Queue 3)."""
    _, t = both
    from sentinel_tpu_torch.core import api

    cap = _Capture()
    monkeypatch.setattr(api, "_engine", type("E", (), {"capture": cap})())
    servers = _servers(t, 2)
    replacement = _servers(t, 2)
    t.set_config(CLUSTER_SHARDS=2, CLUSTER_SHARDS_MAP=",".join("127.0.0.1:%d" % s.port for s in servers),
                 CLUSTER_SHARDS_MAP_VERSION=1)
    t.state.ClusterClientConfigManager.apply("", 0, timeout_ms=int(LONG_S * 1000))
    client = t.state.ClusterClientConfigManager.build_client().start()
    try:
        old_ports = [c.port for c in client.clients]
        assert old_ports == [s.port for s in servers]
        assert client.maybe_reload() is False  # the same version: nothing to do
        new_map = ",".join("127.0.0.1:%d" % s.port for s in replacement)
        t.set_config(CLUSTER_SHARDS_MAP=new_map, CLUSTER_SHARDS_MAP_VERSION=2)
        fid = _flow_on_shard(t, 0, 2)
        t.cl.cluster_flow_rule_manager.load_rules("default", [t.rule("m", 100, fid)])
        out = client.request_tokens_batch([(fid, 1, False)])
        assert int(out[0].status) == int(t.C.TokenResultStatus.OK)
        assert client.shard_map.version == 2
        assert [c.port for c in client.clients] == [s.port for s in replacement]
        assert all(c.connected for c in client.clients)
        assert cap.shards == [(2, new_map)]
        # A map that cannot be used keeps the connection set, stamped once.
        t.set_config(CLUSTER_SHARDS_MAP="127.0.0.1:1", CLUSTER_SHARDS_MAP_VERSION=3)
        assert client.maybe_reload() is False
        assert client.shard_map.version == 3 and [c.port for c in client.clients] == [s.port for s in replacement]
    finally:
        _stop(client, servers + replacement)
        t.state.ClusterClientConfigManager.apply("", 0, timeout_ms=200)


def test_concurrent_release_routes_to_granting_shard(both):
    _, t = both
    fid = _flow_on_shard(t, 1, 2)
    t.cl.cluster_flow_rule_manager.load_rules("default", [t.rule("cc", 8, fid, grade=t.C.FLOW_GRADE_THREAD)])
    servers = _servers(t, 2)
    client = _sharded(t, servers)
    try:
        r = client.request_concurrent_token(fid)
        assert int(r.status) == int(t.C.TokenResultStatus.OK) and r.token_id
        assert servers[1].service.concurrent.now_calls(fid) == 1
        assert servers[0].service.concurrent.now_calls(fid) == 0
        assert int(client.release_concurrent_token(r.token_id).status) == int(t.C.TokenResultStatus.RELEASE_OK)
        assert servers[1].service.concurrent.now_calls(fid) == 0
        # A token the client does not know (a reshard): every shard is asked,
        # the holder answers.
        r2 = client.request_concurrent_token(fid)
        client._token_shards.clear()
        assert int(client.release_concurrent_token(r2.token_id).status) == int(t.C.TokenResultStatus.RELEASE_OK)
        assert servers[1].service.concurrent.held_tokens() == 0
    finally:
        _stop(client, servers)


def test_dead_shard_degrades_only_its_flows_and_leases(both):
    """Stop shard 0's server: its flows answer FAIL and its leases go; shard
    1's flows keep their server's verdicts and their leases serve on."""
    _, t = both
    t.set_config(CLUSTER_LEASE_ENABLED="true", CLUSTER_LEASE_TTL_MS=600000)
    fid0, fid1 = _flow_on_shard(t, 0, 2), _flow_on_shard(t, 1, 2)
    t.cl.cluster_flow_rule_manager.load_rules("default", [t.rule("a", 10000, fid0), t.rule("b", 10000, fid1)])
    servers = _servers(t, 2)
    client = _sharded(t, servers)
    try:
        rows = [(fid0, 1, False)] * 4 + [(fid1, 1, False)] * 4
        assert all(int(r.status) == 0 for r in client.request_tokens_batch(rows))
        assert client.clients[0]._leases and client.clients[1]._leases  # both shards granted
        leases_b = {k: list(v) for k, v in client.clients[1]._leases.items()}
        admits = client.clients[1].stats.snapshot()["lease_admits"]
        servers[0].stop()
        wait_for(lambda: not client.clients[0].connected, "shard 0's client saw its server close")
        assert client.clients[0]._leases == {} and client.clients[0]._lease_reports == {}
        assert client.clients[1]._leases == leases_b
        out = client.request_tokens_batch([(fid0, 1, False), (fid1, 1, False)] * 4)
        assert [int(r.status) for r in out[0::2]] == [int(t.C.TokenResultStatus.FAIL)] * 4
        assert [int(r.status) for r in out[1::2]] == [0] * 4
        assert client.clients[1].stats.snapshot()["lease_admits"] == admits + 4  # served from the lease
        rows_by_shard = {r["shard"]: r for r in client.shard_rows()}
        assert rows_by_shard[0]["fallbacks"] > 0 and not rows_by_shard[0]["connected"]
        assert rows_by_shard[1]["fallbacks"] == 0 and rows_by_shard[1]["connected"]
        snap = client.plane_snapshot()
        assert snap["n_shards"] == 2 and snap["parallel_batches"] >= 2
    finally:
        _stop(client, servers)
