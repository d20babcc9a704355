"""The port's transport plane (sentinel_tpu_torch/transport: the command
center, its 32 handlers and the heartbeat) against the JAX package's, on
the CPU.

Each case sends the same command sequence, over loopback HTTP, to a JAX
CommandCenter and to the port's, each serving its package's global engine
under its own ManualClock fed the same stream (tests/torch_transport_env.py);
the statuses and the parsed bodies must be equal. The cases of
tests/test_transport.py but ``TestDashboard`` (which waits for the
dashboard, ROADMAP Queue 1 item 11), then the commands on the tiers PRs
15-23 ported: ``capture``, ``handoff``, ``health``, ``speculative``,
``sketch``, ``autotune``, ``ipc``, ``traces`` and the cluster commands.
The heartbeat posts to an in-process fake dashboard on both packages.

Excluded by name, each with its reason: ``basicInfo``'s ``currentTime``
(the wall clock of two reads); the rt column of the metric log's
``__engine__`` lines (the flushes' wall time); a trace record's ids and
latency (random ids, wall time); the capture journal's segment byte count
(its header's boot id and wall stamps vary in length); the cluster
commands' server addresses (two servers, two ports) and the client's RPC
latency (wall time); the spans journal's path and pid."""

import http.client
import json
import socket

import pytest

from torch_transport_env import FakeDashboard, http as http_cmd, pair  # noqa: F401


def _rules(p, *rules):
    p.st.flow_rule_manager.load_rules([p.st.FlowRule(*r[:1], **r[1]) for r in rules])


def _traffic(pair):
    """A small stream on both engines: singles with origins and an exit,
    a block, and a bulk group."""
    for p in pair.sides:
        _rules(p, ("api", {"count": 2}), ("b", {"count": 5}))
    pair.set_ms(100)
    for p in pair.sides:
        e = p.st.entry("api")
        p.st.entry("api", origin="o1")
        assert p.st.try_entry("api") is None
        p.clock.set_ms(150)
        e.exit()
        p.engine.submit_bulk("b", 8)
        p.engine.flush()


# --- TestCommandCenter -------------------------------------------------------


def test_api_lists_exactly_the_jax_commands(pair):
    """The port registers the JAX command center's 32 commands, with the
    same descriptions, and ``api`` answers them alike."""
    want = pair.jax.cc.all_commands()
    assert len(want) == 32
    assert pair.port.cc.all_commands() == want
    assert set(pair.same("api")) == set(want)


def test_version_and_api(pair):
    pair.same("version")
    assert pair.get("version")[1] == (200, pair.port.st.__version__)
    assert "getRules" in pair.same("api")
    pair.same("basicInfo", drop=("currentTime",))


def test_rules_roundtrip(pair):
    rules = json.dumps([{"resource": "cc-r", "count": 3}])
    assert pair.same("setRules", type="flow", data=rules) == "success"
    got = pair.same("getRules", type="flow")
    assert got[0]["resource"] == "cc-r" and got[0]["count"] == 3
    for p in pair.sides:  # the rules are live
        for _ in range(3):
            p.st.try_entry("cc-r").exit()
        assert p.st.try_entry("cc-r") is None
    for kind in ("degrade", "system", "authority", "paramFlow"):
        pair.same("getRules", type=kind)
    pair.same("getRules", type="nope")
    pair.same("setRules", type="flow", data="{not json")


def test_set_rules_writes_through_the_writable_datasource(pair, tmp_path):
    """setRules persists through WritableDataSourceRegistry, and the file
    source reads the same rules back on both packages."""
    data = json.dumps([{"resource": "w", "count": 4, "controlBehavior": 0}])
    files = []
    for p in pair.sides:
        path = tmp_path / f"{p.name}.json"
        files.append(path)
        w = p.ds.FileWritableDataSource(str(path), lambda rules: json.dumps([r.to_dict() for r in rules]))
        p.ds.WritableDataSourceRegistry.register("flow", w)
    pair.same("setRules", type="flow", data=data)
    assert files[0].read_text() == files[1].read_text()
    back = []
    for p, path in zip(pair.sides, files):
        src = p.ds.FileRefreshableDataSource(str(path), p.ds.json_converter(p.st.FlowRule), 999)
        assert src.refresh() is True
        back.append([r.to_dict() for r in src.get_property().value])
    assert back[0] == back[1] and back[1][0]["resource"] == "w"


def test_unknown_command(pair):
    (s1, b1), (s2, b2) = pair.get("nope")
    assert s1 == s2 == 400 and b1 == b2


def test_switch(pair):
    for p in pair.sides:
        _rules(p, ("sw", {"count": 0}))
        assert p.st.try_entry("sw") is None
    assert pair.same("getSwitch") is True  # the body "true", parsed as JSON
    pair.same("setSwitch", value="false")
    assert pair.same("getSwitch") is False
    for p in pair.sides:
        e = p.st.try_entry("sw")  # protection off: pass-through
        assert e is not None and e.pass_through
        assert p.engine.submit_bulk("sw", 4) is None and p.engine.submit_many([{"resource": "sw"}]) == [None]
    pair.same("setSwitch", value="maybe")
    pair.same("setSwitch", value="true")
    for p in pair.sides:
        assert p.st.try_entry("sw") is None


def test_tree_cluster_node_and_origin(pair):
    _traffic(pair)
    assert "api" in pair.same("tree")
    nodes = pair.same("clusterNode")
    assert any(n["resourceName"] == "api" for n in nodes)
    assert [o["origin"] for o in pair.same("origin", id="api")] == ["o1"]
    pair.same("origin", id="nope")


def test_system_status(pair):
    _traffic(pair)
    from sentinel_tpu.utils.system_status import sampler as js
    from sentinel_tpu_torch.utils.system_status import sampler as ts

    for s in (js, ts):
        s.force(load=0.25, cpu=0.5)
    try:
        data = pair.same("systemStatus")
    finally:
        for s in (js, ts):
            s.force(load=-1.0, cpu=-1.0)
    assert set(data) >= {"qps", "thread", "rt", "load", "cpu"}


def test_metric_command(pair, tmp_path, monkeypatch):
    """The metric log written by each package's MetricTimer, read back by
    the ``metric`` command."""
    for p in pair.sides:
        _rules(p, ("loop-res", {"count": 100}))
    for sec in range(2):
        for i in range(4):
            pair.set_ms(sec * 1000 + i * 10)
            for p in pair.sides:
                with p.st.entry("loop-res"):
                    pass
    pair.set_ms(2500)
    for p in pair.sides:
        ml = __import__(f"{p.name}.metrics.metric_log", fromlist=["x"])
        d = str(tmp_path / p.name)
        writer = ml.MetricWriter(base_dir=d, app_name="loop-app")
        ml.MetricTimer(p.engine, writer=writer).run_once()
        orig = ml.MetricSearcher.__init__
        monkeypatch.setattr(ml.MetricSearcher, "__init__",
                            lambda self, base_dir=None, app_name=None, _o=orig, _d=d: _o(self, _d, "loop-app"))
    bodies = [_engine_rt_masked(b) for _s, b in pair.get("metric", startTime=0, endTime=2**62)]
    assert bodies[0] == bodies[1] and "|loop-res|" in bodies[1]
    lines = pair.same("metric", startTime=0, endTime=2**62, identity="loop-res").splitlines()
    assert len(lines) == 2 and all("|loop-res|" in ln for ln in lines)
    pair.same("metric", startTime="x")


def _engine_rt_masked(body: str) -> str:
    """A metric-log body with the rt column of the engine's own
    ``__engine__`` lines masked: that column is the flushes' wall time."""
    out = []
    for line in body.splitlines():
        cols = line.split("|")
        if cols[2] == "__engine__":
            cols[7] = "-"
        out.append("|".join(cols))
    return "\n".join(out)


# --- TestCommandCenterRobustness ---------------------------------------------


def test_malformed_posts_and_garbage(pair):
    """Garbage HTTP, a bad Content-Length, a body that is not UTF-8: both
    command centers answer alike and keep serving."""
    out = []
    for p in pair.sides:
        port = p.center.port
        got = []

        def status(method, path, body=None, headers=()):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            if headers:
                conn.putrequest(method, path)
                for k, v in headers:
                    conn.putheader(k, v)
                conn.endheaders()
            else:
                conn.request(method, path, body=body)
            code = conn.getresponse().status
            conn.close()
            return code

        got.append(status("GET", "/api"))
        with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
            s.sendall(b"\xff\xfe NOT HTTP\r\n\r\n")
        got.append(status("GET", "/api"))
        got.append(status("POST", "/setRules", headers=[("Content-Length", "abc")]))
        got.append(status("POST", "/setRules", headers=[("Content-Length", "-4")]))
        got.append(status("POST", "/setRules", body=b"\xff\xfe\xfd"))
        got.append(status("POST", "/setRules", body=b"type=flow&data=%5B%5D"))
        got.append(status("GET", "/api"))
        out.append(got)
    assert out[0] == out[1] == [200, 200, 400, 400, 400, 200, 200]


# --- TestSpansCommand --------------------------------------------------------


def test_spans_snapshot_filter_and_spill(pair, tmp_path):
    for p in pair.sides:
        p.config.set(p.config.SPANS_ENABLED, "true")
        p.config.set(p.config.SPANS_DIR, str(tmp_path / p.name))
        p.spans.reset_journal()
        spj = p.spans.get_journal("engine")
        spj.record("admit", "worker", 100.0, 1.0, wid=0, seq=1)
        spj.record("drain", "engine", 101.0, 0.5, frames=1, rows=1)
    try:
        out = pair.same("spans", drop=("path", "pid"))
        assert out["enabled"] is True and out["role"] == "engine"
        assert out["buffered"] == 2 and "spans" not in out
        out = pair.same("spans", n=10, cat="engine", drop=("path", "pid"))
        assert [s["name"] for s in out["spans"]] == ["drain"]
        pair.same("spans", n="x")
        pair.same("spans", n="-1")
        spilled = [json.loads(b)["spilled_to"] for _s, b in pair.get("spans", spill=1)]
        loaded = [p.spans.load_journal(f) for p, f in zip(pair.sides, spilled)]
        assert [s["name"] for s in loaded[0]["spans"]] == [s["name"] for s in loaded[1]["spans"]] == ["admit",
                                                                                                       "drain"]
    finally:
        for p in pair.sides:
            p.config.set(p.config.SPANS_ENABLED, "false")
            p.config.set(p.config.SPANS_DIR, "")
            p.spans.reset_journal()


# --- TestHeartbeat -----------------------------------------------------------


def _beat(p, dash, monkeypatch, **kw):
    monkeypatch.setattr(p.hb, "local_ip", lambda: "127.0.0.1")
    hb = p.hb.HeartbeatSender(f"127.0.0.1:{dash.port}", command_port=9999, app_name="hb-app", **kw)
    ok = hb.heartbeat_once()
    return ok, dash.beats[-1] if dash.beats else None


def test_heartbeat_fields_equal(pair, monkeypatch):
    """One heartbeat from each package to a fake dashboard: the same
    path and fields, the engine's health fields included."""
    _traffic(pair)
    dash = FakeDashboard()
    try:
        got = [_beat(p, dash, monkeypatch) for p in pair.sides]
    finally:
        dash.close()
    assert got[0][0] is got[1][0] is True
    assert got[0][1] == got[1][1]
    path, fields = got[1][1]
    assert path == "/registry/machine" and fields["app"] == "hb-app" and fields["health"] == "HEALTHY"


def test_heartbeat_failure(pair, monkeypatch):
    for p in pair.sides:
        monkeypatch.setattr(p.hb, "local_ip", lambda: "127.0.0.1")
        assert p.hb.HeartbeatSender("127.0.0.1:1", command_port=1, app_name="x").heartbeat_once() is False


def test_heartbeat_carries_engine_epoch_and_workers(pair, monkeypatch):
    """TestFleetHeartbeat's sender half: with an ingest plane attached the
    heartbeat carries the boot epoch, restarts and live workers."""
    planes = []
    dash = FakeDashboard()
    try:
        got = []
        for p in pair.sides:
            plane_mod = __import__(f"{p.name}.ipc.plane", fromlist=["x"])
            plane = plane_mod.IngestPlane(p.engine)
            planes.append((p, plane))
            p.engine.ipc_plane = plane
            got.append(_beat(p, dash, monkeypatch, engine=p.engine))
    finally:
        for p, plane in planes:
            p.engine.ipc_plane = None
            plane.close()
        dash.close()
    assert got[0] == got[1]
    fields = got[1][1][1]
    assert (fields["engine_epoch"], fields["restarts_total"], fields["workers"]) == ("1", "0", "0")


# --- the tiers' commands -----------------------------------------------------


def test_capture_command(pair, tmp_path):
    """capture: off, then armed with a freeze on demand (the frozen
    segments' names and the journal's counters equal)."""
    assert pair.same("capture") == {"enabled": False, "flush_seq": pair.port.engine.flush_seq}
    for p in pair.sides:
        p.config.set(p.config.CAPTURE_DIR, str(tmp_path / p.name))
    pair.reset(CAPTURE_ENABLED="true")
    _traffic(pair)
    # The segment's header carries the boot id and wall-ms stamps, whose
    # printed lengths vary: its byte count is not compared.
    drop = ("dir", "boot_id", "live", "frozen", "frozen_now", "segment_bytes")
    out = pair.same("capture", drop=drop)
    assert out["enabled"] is True and out["counters"]["chunks"] >= 1
    frozen = [json.loads(b)["frozen_now"] for _s, b in pair.get("capture", freeze="oncall page!")]
    assert frozen[0] and len(frozen[0]) == len(frozen[1])
    assert all(f.startswith("frozen-oncallpage-") for f in frozen[0] + frozen[1])
    pair.same("capture", drop=drop)


def test_handoff_command(pair):
    for p in pair.sides:
        assert not p.engine.handoff_requested.is_set()
    assert pair.same("handoff") == {"ok": True, "handoff": "requested", "ipc_plane": False}
    for p in pair.sides:
        assert p.engine.handoff_requested.is_set()


def test_health_command_with_a_fault(pair):
    """health with failover armed and one injected fetch fault: DEGRADED,
    the same counters, events and fault on both; then speculative, sketch,
    autotune and ipc."""
    pair.reset(FAILOVER_ENABLED="true", FAILOVER_CHECKPOINT_EVERY=1, FAILOVER_RETRY_MS=100000)
    _traffic(pair)
    for p in pair.sides:
        inj = p.faults.FaultInjector().install(p.engine)
        inj.fail_fetch(p.engine.flush_seq + 1)
        p.engine.submit_entry("api")
        p.engine.flush()
    out = pair.same("health", drop=("checkpoint",))
    assert out["state"] == "DEGRADED" and out["counters"]["trips"] == 1
    for cmd in ("speculative", "sketch", "autotune", "ipc", "getClusterMode", "cluster/server/config"):
        pair.same(cmd)
    for p in pair.sides:
        p.engine.faults.clear()


def test_speculative_and_sketch_commands_armed(pair):
    pair.reset(SPECULATIVE_ENABLED="true", SKETCH_ENABLED="true")
    _traffic(pair)
    for p in pair.sides:
        p.engine.entry_sync("b")
        p.engine.flush()
    out = pair.same("speculative")
    assert out["enabled"] is True
    assert pair.same("sketch")["flush_seq"] >= 1


def test_traces_command(pair):
    _traffic(pair)
    out = []
    for _s, body in pair.get("traces", n=10):
        d = json.loads(body)
        d.pop("latency_ms", None)
        for r in d["records"]:
            for k in ("trace_id", "span_id", "parent_span_id", "latency_ms"):
                r.pop(k, None)
        out.append(d)
    assert out[0] == out[1] and out[1]["records"]
    assert pair.get("traces", reason="FlowException", n=5)[0][0] == 200
    for bad in ({"n": "x"}, {"reason": "NoSuchException"}):
        pair.same("traces", **bad)


def test_cluster_commands(pair):
    """setClusterMode, the cluster/server/* and cluster/client/* commands
    and ``cluster``, each package against a token server of its own."""
    servers = []
    try:
        for p in pair.sides:
            server_mod = __import__(f"{p.name}.cluster.server", fromlist=["x"])
            svc = p.cl.DefaultTokenService(clock=p.clock, **p.dev)
            srv = server_mod.SentinelTokenServer(port=0, service=svc)
            servers.append(srv)
            p.cl.EmbeddedClusterTokenServerProvider.register(srv)
        pair.same("setClusterMode", mode=1)
        assert pair.same("getClusterMode") == {"mode": 1}
        pair.same("setClusterMode", mode="x")
        data = json.dumps([{"resource": "cl", "count": 2, "clusterMode": True,
                            "clusterConfig": {"flowId": 77, "thresholdType": 1}}])
        assert pair.same("cluster/server/modifyFlowRules", namespace="default", data=data) == "success"
        rules = pair.same("cluster/server/flowRules", namespace="default")
        assert rules[0]["resource"] == "cl"
        pair.same("cluster/server/modifyFlowRules", data="[")
        pair.same("cluster/server/config")
        stats = pair.same("cluster/server/stats", drop=("port",))
        assert stats["mode"] == 1
        # The client half: each package's client at its own server.
        for p, srv in zip(pair.sides, servers):
            st_ = http_cmd(p.center.port, "cluster/client/modifyConfig", serverHost="127.0.0.1", serverPort=srv.port,
                       requestTimeout=60000)
            assert st_ == (200, "success")
        pair.same("cluster/client/modifyConfig", serverHost="", serverPort=0)
        pair.same("cluster/client/modifyConfig", serverHost="h", serverPort="x")
        cfgs = [json.loads(b) for _s, b in pair.get("cluster/client/config")]
        for c, srv in zip(cfgs, servers):
            assert c.pop("serverPort") == srv.port
        assert cfgs[0] == cfgs[1]
        pair.same("setClusterMode", mode=0)
        for p in pair.sides:
            p.engine.flush()
        out = []
        for (_s, body), srv in zip(pair.get("cluster"), servers):
            d = json.loads(body)
            d["stats"].pop("rpc_ms", None)
            assert d["client"].pop("server") == f"127.0.0.1:{srv.port}"
            out.append(d)
        assert out[0] == out[1]
        assert out[1]["mode"] == 0 and out[1]["client"]["connected"] is True
    finally:
        for p in pair.sides:
            p.cl.ClusterStateManager.stop()
            client = p.cl.TokenClientProvider.get_client()
            if client is not None:
                client.stop()
            p.cl.TokenClientProvider.clear()
        for srv in servers:
            srv.stop()
