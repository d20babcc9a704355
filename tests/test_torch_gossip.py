"""The sketch gossip agent of the port (sentinel_tpu_torch/cluster/gossip.py)
against the JAX package's (tests/test_gossip.py's cases): the
SKETCH_PUSH/SKETCH_MERGED frame pair, the merge bounds through the wire,
a JAX agent and a port agent exchanging frames both ways (the same fleet
views as two agents of one package), fleet-wide promotion on a mixed
fleet, the foreign-version and dead-peer answers, and an engine with
gossip armed building and stopping its agent (and two such engines
merging each other's frames).

No verdict waits on a wall-clock deadline; the agents' timeouts are long.
Tolerance zero."""

import importlib
import socket

import numpy as np
import pytest

from torch_cluster_env import LONG_S, both  # noqa: F401  (fixtures)


def _sk(p):
    return importlib.import_module(f"{p.name}.runtime.sketch")


class _FakeTelemetry:
    enabled = False


class _FakeEngine:
    telemetry = _FakeTelemetry()
    device = "cpu"
    capture = None


def _tier(p, gossip=True, width=4096, **keys):
    p.set_config(SKETCH_ENABLED="true", GOSSIP_ENABLED="true" if gossip else "false", SKETCH_WIDTH=width, **keys)
    tier = _sk(p).SketchTier(_FakeEngine())
    if p.is_torch:
        import torch

        assert tier.dev_state.cm.device == torch.device("cpu")
    return tier


def _feed(p, tier, key, count):
    """Count one key into the tier's host twin and mirror (the seam the
    drain feeds)."""
    sk = _sk(p)
    ids = np.array([sk.key_id(key)], dtype=np.int64)
    for di in range(tier.depth):
        tier._host_cm[di, sk._hash_np(ids, di, tier.width)[0]] += count
    tier.host_mirror.offer(key, count)


def _vkey(p, v):
    sk = _sk(p)
    return sk._KIND_VALUE + "res" + sk._SEP + v


def _agent(p, tier, origin, peers=()):
    return p.gossip.GossipAgent(tier, origin=origin, port=0, peers=list(peers), timeout_sec=LONG_S).start()


def test_frame_pair_same_bytes(both):
    """The push frame of a tier's snapshot is the same bytes in both
    packages, and a foreign version raises the typed error in both."""
    j, t = both
    frames = []
    for p in (j, t):
        tier = _tier(p)
        _feed(p, tier, _vkey(p, "a"), 7)
        _feed(p, tier, _vkey(p, "b"), 2)
        wid, cm, cands = tier.gossip_snapshot()
        frames.append(p.protocol.pack_sketch_frame(5, p.C.MSG_TYPE_SKETCH_PUSH, "o", wid, cm.shape[0], cm.shape[1],
                                                   cm.astype("<i4").tobytes(), cands))
    assert frames[1] == frames[0]
    bad = bytearray(frames[1][4:])
    bad[5] = t.protocol.GOSSIP_VERSION + 1
    for p in (j, t):
        with pytest.raises(p.protocol.UnsupportedBatchVersion) as ei:
            p.protocol.unpack_sketch_frame(bytes(bad))
        assert (ei.value.xid, ei.value.version) == (5, t.protocol.GOSSIP_VERSION + 1)


def _exchange(pa, pb):
    """Tier a (package ``pa``) and tier b (``pb``) each counted some keys;
    a's agent runs one round against b's, then b's against a's. Returns the
    merge counts, both fleet views and both packages' gossip counters."""
    a, b = _tier(pa), _tier(pb)
    keys = [f"k{i}" for i in range(8)]
    for i, k in enumerate(keys):
        _feed(pa, a, _vkey(pa, k), 3 * i + 1)
        _feed(pb, b, _vkey(pb, k), 50 - 4 * i)
    _feed(pa, a, _vkey(pa, "only-a"), 11)
    _feed(pb, b, _vkey(pb, "only-b"), 22)
    ga, gb = _agent(pa, a, "A"), _agent(pb, b, "B")
    try:
        ga.peers = [("127.0.0.1", gb.port)]
        gb.peers = [("127.0.0.1", ga.port)]
        merged = [ga.run_round(), sorted(a._remote), sorted(b._remote), gb.run_round()]
        views = [a._fleet_by_key({}), b._fleet_by_key({})]
        return merged, views, [pa.gossip.gossip_stats.snapshot(), pb.gossip.gossip_stats.snapshot()], (a, b)
    finally:
        ga.stop()
        gb.stop()


@pytest.mark.parametrize("pairing", ["jax-port", "port-jax", "port-port"])
def test_agents_exchange_both_ways(both, pairing):
    """One round carries both directions; a JAX agent and a port agent
    merge each other's frames, and every fleet view equals the one of two
    JAX agents; the views obey the count-min merge bounds (on these
    collision-free keys, the exact sum)."""
    j, t = both
    pa, pb = {"jax-port": (j, t), "port-jax": (t, j), "port-port": (t, t)}[pairing]
    want_merged, want_views, _, _ = _exchange(j, j)
    for p in (j, t):
        p.gossip.gossip_stats.reset()
    merged, views, stats, (a, b) = _exchange(pa, pb)
    assert merged == want_merged == [1, ["B"], ["A"], 1]
    assert views == want_views
    for i in range(8):
        key = _vkey(t, f"k{i}")
        assert views[0][key] == views[1][key] == (3 * i + 1) + (50 - 4 * i)
    assert views[0][_vkey(t, "only-b")] == 22 and views[1][_vkey(t, "only-a")] == 11
    total = {k: stats[0][k] + (stats[1][k] if pa is not pb else 0) for k in stats[0]}
    assert total["merges"] == 4 and total["errors"] == 0 and total["rounds"] == 2
    assert a.gossip_info()["remote_origins"] == ["B"] and b.gossip_info()["remote_origins"] == ["A"]


@pytest.mark.parametrize("gossip", [True, False], ids=["gossip_on", "gossip_off"])
def test_thin_spread_key_promotes_on_a_mixed_fleet(both, gossip):
    """60 a window on each of a JAX engine's tier and two port tiers (150
    promotes): with gossip every one promotes the key, without none."""
    j, t = both
    fleet = [j, t, t]
    tiers = [_tier(p, gossip=gossip, SKETCH_PROMOTE_QPS=100.0, SKETCH_WINDOW_MS=1000) for p in fleet]
    agents = []
    try:
        if gossip:
            for i, (p, tier) in enumerate(zip(fleet, tiers)):
                _feed(p, tier, _vkey(p, "hot"), 60)
                agents.append(_agent(p, tier, f"E{i}"))
            for i, ga in enumerate(agents):
                ga.peers = [("127.0.0.1", agents[k].port) for k in range(3) if k != i]
            assert [ga.run_round() for ga in agents] == [2, 2, 2]
        promoted = []
        for p, tier in zip(fleet, tiers):
            tier._evaluate({_vkey(p, "hot"): 60}, now_ms=5000)
            promoted.append("hot" in tier.promoted_values.get("res", ()))
    finally:
        for ga in agents:
            ga.stop()
    assert promoted == [gossip] * 3


def test_foreign_version_gets_an_empty_merged_frame(both):
    """A JAX pusher speaking a future version gets an empty merged frame
    from the port's agent, with its xid; the tier stays untouched."""
    j, t = both
    a = _tier(t)
    ga = _agent(t, a, "A")
    try:
        frame = bytearray(j.protocol.pack_sketch_frame(
            9, j.C.MSG_TYPE_SKETCH_PUSH, "alien", 0, a.depth, a.width,
            np.ones((a.depth, a.width), dtype="<i4").tobytes(), [(_vkey(j, "x"), 5)]))
        frame[4 + 4 + 1] = j.protocol.GOSSIP_VERSION + 1
        with socket.create_connection(("127.0.0.1", ga.port), LONG_S) as s:
            s.sendall(bytes(frame))
            payload = j.protocol.read_frame(s)
        out = j.protocol.unpack_sketch_frame(payload)
        assert (out[0], out[1], out[4], out[7]) == (9, j.C.MSG_TYPE_SKETCH_MERGED, 0, [])
        assert a._remote == {}
        assert t.gossip.gossip_stats.snapshot()["version_rejects"] == 1
    finally:
        ga.stop()


def test_dead_peer_costs_one_error(both):
    _, t = both
    a = _tier(t)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))  # a port nothing listens on
    dead = probe.getsockname()[1]
    ga = _agent(t, a, "A", peers=[("127.0.0.1", dead)])
    try:
        assert ga.run_round() == 0
        assert t.gossip.gossip_stats.snapshot()["errors"] == 1
        assert a._remote == {}
    finally:
        ga.stop()
        probe.close()


def test_parse_peers_matches_jax(both):
    j, t = both
    for raw in ("h1:70, h2:71 ,bad,:9,h3:x,", "", "127.0.0.1:1,127.0.0.1:-2,a:b:3", None):
        assert t.gossip.parse_peers(raw) == j.gossip.parse_peers(raw)
    assert t.gossip.parse_peers("h1:70, h2:71 ,bad,:9,h3:x,") == [("h1", 70), ("h2", 71)]


def test_engines_with_gossip_armed(both):
    """An engine with the sketch and gossip enabled builds its agent (a
    listener on a port of its own) and stops it at close; two such engines
    on loopback merge each other's frames; by default there is no agent."""
    _, t = both
    clock = t.clock.ManualClock(1000)
    t.set_config(SKETCH_ENABLED="true", GOSSIP_ENABLED="true", SKETCH_PROMOTE_QPS=5, SKETCH_COLD_QPS=10)
    engines = [t.engine(clock) for _ in range(2)]
    try:
        for eng in engines:
            assert eng.gossip is not None and eng.gossip.port > 0 and eng.sketch.gossip_armed
            eng.set_param_rules({"api": [t.rules.ParamFlowRule("api", param_idx=0, count=3, sketch_mode=True)]})
        for i, eng in enumerate(engines):
            eng.submit_bulk("api", 64, args_column=[(f"HOT{i}",)] * 64)
            eng.flush()
            eng.drain()
        a, b = engines
        a.gossip.peers = [("127.0.0.1", b.gossip.port)]
        assert a.gossip.run_round() == 1
        assert a.sketch.gossip_info()["remote_origins"] == [b.gossip.origin]
        assert b.sketch.gossip_info()["remote_origins"] == [a.gossip.origin]
        assert a.gossip.snapshot()["running"]
    finally:
        for eng in engines:
            eng.close()
    assert all(eng.gossip._server is None for eng in engines)
    t.set_config(GOSSIP_ENABLED="false")
    eng = t.engine(clock)
    try:
        assert eng.gossip is None
    finally:
        eng.close()
