"""The port's Prometheus exporter (sentinel_tpu_torch/transport/prometheus.py)
against the JAX package's, on the CPU.

The cases of tests/test_prometheus.py run on both packages: each package's
global engine under its own ManualClock takes the same stream
(tests/torch_transport_env.py), and the rendered text must be equal line for
line, in both dialects, through ``render_metrics`` and over HTTP; the
worker and token-server renders likewise. A seeded stream with breakers,
hot-param rules and exits then renders alike with the speculative tier,
the failure domain, the sketch tier and the pipeline at depth 2 armed, and
the stats behind the per-resource gauges are one read of the stats a scrape
(``row_stats``: one launch on the card). A live autotuner decides from
wall times, so its families are compared idle (tests/test_torch_autotune.py).
Every admission is traced (the rate 1.0): head sampling draws from each
package's own random source.

Lines excluded by name, with the reason, in ``EXCLUDED``
(tests/torch_transport_env.py): every other line
of a scrape, the HELP and TYPE lines included, is compared."""

import numpy as np
import pytest

from torch_transport_env import EXCLUDED, comparable, pair  # noqa: F401

def renders(pair, openmetrics=False):
    texts = [p.prom.render_metrics(p.engine, openmetrics=openmetrics) for p in pair.sides]
    a, b = comparable(texts[0]), comparable(texts[1])
    assert len(a) == len(b), (len(a), len(b))
    for x, y in zip(a, b):
        assert x == y, (x, y)
    return texts[1]


# --- TestRenderMetrics -------------------------------------------------------


def test_gauges_per_resource(pair):
    for p in pair.sides:
        p.st.flow_rule_manager.load_rules([p.st.FlowRule("api", count=2)])
    pair.set_ms(100)
    held = []
    for p in pair.sides:
        held.append(p.st.entry("api"))
        p.st.entry("api")
        assert p.st.try_entry("api") is None
    pair.set_ms(150)
    for e in held:
        e.exit()
    text = renders(pair)
    assert "# TYPE sentinel_pass_qps gauge" in text
    assert 'sentinel_pass_qps{resource="api"} 2.0' in text
    assert 'sentinel_block_qps{resource="api"} 1.0' in text
    assert 'sentinel_cur_thread_num{resource="api"} 1' in text
    assert 'sentinel_block_total_minute{resource="api"} 1' in text
    assert "sentinel_engine_enabled 1" in text
    assert "sentinel_resources 1" in text
    om = renders(pair, openmetrics=True)
    assert om.endswith("# EOF\n") and "# TYPE sentinel_engine_flushes counter" in om


def test_label_escaping(pair):
    for p in pair.sides:
        p.st.flow_rule_manager.load_rules([p.st.FlowRule('we"ird', count=5)])
        p.st.entry('we"ird')
    assert 'resource="we\\"ird"' in renders(pair)


# --- TestMetricsEndpoint -----------------------------------------------------


@pytest.mark.parametrize("fmt", ["", "openmetrics"])
def test_scrape_over_http(pair, fmt):
    import urllib.request

    for p in pair.sides:
        p.st.flow_rule_manager.load_rules([p.st.FlowRule("api", count=10)])
        p.st.entry("api")
    got = []
    for p in pair.sides:
        url = f"http://127.0.0.1:{p.center.port}/metrics" + (f"?format={fmt}" if fmt else "")
        with urllib.request.urlopen(url, timeout=30) as resp:
            got.append((resp.status, resp.headers.get("Content-Type", ""), resp.read().decode()))
    assert got[0][:2] == got[1][:2]
    assert comparable(got[0][2]) == comparable(got[1][2])
    assert got[1][1].startswith("application/openmetrics-text" if fmt else "text/plain")
    assert 'sentinel_pass_qps{resource="api"} 1.0' in got[1][2]


# --- TestWorkerRender --------------------------------------------------------


@pytest.mark.parametrize("om", [False, True])
def test_worker_render_zero_shape(pair, om):
    texts = [p.prom.render_worker_metrics(None, openmetrics=om) for p in pair.sides]
    assert texts[0] == texts[1]
    assert "sentinel_worker_id -1" in texts[1] and "sentinel_worker_entries_total 0" in texts[1]
    if om:
        assert texts[1].endswith("# EOF\n") and "# TYPE sentinel_worker_entries counter" in texts[1]


def test_worker_render_live_client(pair):
    texts = []
    for p in pair.sides:
        plane_mod = __import__(f"{p.name}.ipc.plane", fromlist=["x"])
        worker_mod = __import__(f"{p.name}.ipc.worker", fromlist=["x"])
        p.st.flow_rule_manager.load_rules([p.st.FlowRule("wres", count=100)])
        plane = plane_mod.IngestPlane(p.engine)
        cli = worker_mod.IngestClient(plane.channel(0), 0)
        try:
            for _ in range(3):
                cli.entry("wres", acquire=1)
            cli.bulk("wres", 4)
            texts.append(p.prom.render_worker_metrics(cli))
        finally:
            cli.close()
            plane.close()
    assert texts[0] == texts[1]
    for needle in ("sentinel_worker_entries_total 3", "sentinel_worker_bulk_rows_total 4",
                   "sentinel_worker_engine_alive 1", "sentinel_worker_id 0", "sentinel_worker_frames_per_entry 0.5714",
                   "sentinel_worker_live_admissions 7"):
        assert needle in texts[1], needle


# --- TestClusterServerRender -------------------------------------------------


@pytest.mark.parametrize("om", [False, True])
def test_cluster_server_render_zero_shape(pair, om):
    texts = [p.prom.render_cluster_server_metrics(None, openmetrics=om) for p in pair.sides]
    assert texts[0] == texts[1]
    assert 'sentinel_cluster_server_connections{namespace="default"} 0' in texts[1]


def test_cluster_server_render_live(pair):
    texts = []
    for p in pair.sides:
        server_mod = __import__(f"{p.name}.cluster.server", fromlist=["x"])
        p.stat_log.reset_counters()
        srv = server_mod.SentinelTokenServer(port=0, service=p.cl.DefaultTokenService(**p.dev))
        srv._note_work(5, 0.25)
        srv._note_work(2, 0.125)
        srv.lease_grants = 3
        p.stat_log.log("flow", "pass", 1, 2)
        p.stat_log.log("flow", "block", 1)
        texts.append(p.prom.render_cluster_server_metrics(srv))
        p.stat_log.reset_counters()
    assert texts[0] == texts[1]
    for needle in ("sentinel_cluster_server_decisions_total 7", "sentinel_cluster_server_frames_total 2",
                   "sentinel_cluster_server_busy_seconds_total 0.375", "sentinel_cluster_server_lease_grants_total 3",
                   'outcome="pass"} 2', 'outcome="block"} 1'):
        assert needle in texts[1], needle


# --- the same stream, with the tiers armed ------------------------------------

TIERS = {
    "default": {},
    "speculative+failover": {"SPECULATIVE_ENABLED": "true", "FAILOVER_ENABLED": "true",
                             "FAILOVER_CHECKPOINT_EVERY": 2},
    "sketch": {"SKETCH_ENABLED": "true", "SKETCH_PROMOTE_QPS": 5},
    "depth2": {"PIPELINE_DEPTH": 2},
}


def _stream(pair, seed):
    rng = np.random.default_rng(seed)
    for p in pair.sides:
        st = p.st
        st.flow_rule_manager.load_rules([st.FlowRule(f"r{i}", count=3 + i % 5) for i in range(12)])
        st.degrade_rule_manager.load_rules([st.DegradeRule("r1", grade=2, count=2, time_window=5,
                                                           min_request_amount=1)])
        st.param_flow_rule_manager.load_rules([st.ParamFlowRule("r2", param_idx=0, count=2)])
    for step in range(6):
        now = 1000 + 150 * step
        pair.set_ms(now)
        res = rng.integers(0, 14, 24)
        args = rng.integers(0, 3, 24)
        sizes = rng.integers(1, 9, 3)
        for p in pair.sides:
            for r, a in zip(res, args):
                e = p.st.try_entry(f"r{r}", args=(f"v{a}",))
                if e is not None:
                    if r == 1:
                        e.set_error(RuntimeError("x"))
                    e.exit()
            for j, n in enumerate(sizes):
                p.engine.submit_bulk(f"r{3 + j}", int(n), ts=now)
            p.engine.flush()
            p.engine.drain()


@pytest.mark.parametrize("tier", list(TIERS))
def test_same_stream_same_scrape(pair, tier, monkeypatch):
    pair.reset(**TIERS[tier])
    _stream(pair, seed=7 + len(tier))
    calls = []
    mod = pair.port.engine_mod
    real = mod._read_rows
    monkeypatch.setattr(mod, "_read_rows", lambda *a: calls.append(1) or real(*a))
    text = renders(pair)
    assert calls == [1]  # every resource's gauges from one read of the stats (one row_stats launch)
    assert 'sentinel_block_qps{resource="r0"}' in text
    renders(pair, openmetrics=True)


def test_excluded_lines_are_named(pair):
    """Each excluded family is one the render writes (a typo would exclude
    nothing)."""
    text = pair.port.prom.render_metrics(pair.port.engine)
    names = {ln.split("{", 1)[0].split(" ", 1)[0] for ln in text.splitlines() if not ln.startswith("#")}
    names |= {ln.split("{", 1)[0].split(" ", 1)[0]
              for ln in pair.port.prom.render_cluster_server_metrics(None).splitlines() if not ln.startswith("#")}
    assert set(EXCLUDED) - names <= {"sentinel_engine_ingest_estimate_ms"}  # rendered only with the valve armed
