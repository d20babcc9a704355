"""The port's flight recorder (sentinel_tpu_torch/metrics/{histogram,
telemetry,perfetto}.py and the engine's hooks) against the JAX
package's, on the CPU.

The histogram, the space-saving summary and the Perfetto export are
held on the same seeded inputs through both packages' classes (exact).
The engine's spans and ``counters_snapshot()`` run in lockstep
(tests/torch_lockstep.py) on one stream at depth 0 and 2, with the ring
bound, the lazy settle of pipelined spans, telemetry off, and the
blocked sketch's top-K (bulk acquire weights included). Equal means
equal, with two exclusions: the timing fields of a span (encode,
dispatch and settle ms, the perf_counter stamps, and the histograms'
sums) are wall times, and the arena's hit and miss counts follow each
package's own staging layout (the port stages a chunk in one set, the
JAX engine in one set per column family), so neither is compared.

``TestExports`` runs here since the control surface's port (ROADMAP item
11, part 1): the Prometheus series and the ``telemetry`` command, in
lockstep, their wall-time values left out by name (the scrape's families in
tests/torch_transport_env.py; the command's latency summaries and spans'
timings here). Left out: the wall-clock
``TestOverhead`` (2%), whose number is ``chip_smoke.py`` phase 4h (d)'s,
taken on the card. The mesh step's host recount is held in
tests/test_torch_blocked_topk.py, the metric log's ``__engine__`` lines
in test_torch_metric_log.py."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from torch_lockstep import run_lockstep, verdicts

from sentinel_tpu.metrics import histogram as jhist
from sentinel_tpu.metrics import perfetto as jperf
from sentinel_tpu.metrics import telemetry as jtele
from sentinel_tpu_torch.metrics import histogram as thist
from sentinel_tpu_torch.metrics import perfetto as tperf
from sentinel_tpu_torch.metrics import telemetry as ttele

BOTH = [(jhist, jtele, jperf), (thist, ttele, tperf)]


def _on_both(fn):
    """``fn(hist_mod, tele_mod, perf_mod)`` through both packages; returns
    the port's result after requiring the JAX package's to be equal."""
    got = [fn(*mods) for mods in BOTH]
    assert json.dumps(got[0], sort_keys=True, default=repr) == json.dumps(got[1], sort_keys=True, default=repr)
    return got[1]


def _hist_view(h):
    counts, total = h.snapshot_counts()
    return counts.tolist(), total, [h.percentile(q) for q in (0.01, 0.5, 0.9, 0.99, 0.999, 1.0)], h.summary()


# --- LatencyHistogram --------------------------------------------------------


def test_histogram_bucket_placement():
    def run(hm, _t, _p):
        out = []
        for ms in [0.0, 1.0, 1.5, 2.0, 2.5, 4.0, 7.9, 8.0, 8.1, 1e9, -3.0]:
            h = hm.LatencyHistogram(base_ms=1.0, n_buckets=4)
            h.record(ms)
            out.append((h.snapshot_counts()[0].tolist(), h.bucket_of(ms)))
        return out

    out = _on_both(run)
    assert [c.index(1) for c, _ in out[:10]] == [0, 0, 1, 1, 2, 2, 3, 3, 4, 4]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_record_many_merge_percentiles(seed):
    vals = np.random.default_rng(seed).lognormal(mean=-2.0, sigma=3.0, size=2000)
    vals[::97] = 0.0

    def run(hm, _t, _p):
        a, b, c = hm.LatencyHistogram(), hm.LatencyHistogram(), hm.LatencyHistogram(base_ms=1.0, n_buckets=8)
        for v in vals[:1000]:
            a.record(float(v))
        b.record_many(vals[1000:])
        c.record_many(vals)
        a.merge(b)
        with pytest.raises(ValueError):
            a.merge(c)
        return _hist_view(a), _hist_view(b), _hist_view(c)

    _on_both(run)


def test_histogram_prometheus_lines():
    def run(hm, _t, _p):
        h = hm.LatencyHistogram(base_ms=1.0, n_buckets=3)
        for v in (0.5, 1.5, 3.0, 99.0):
            h.record(v)
        return (h.prometheus_lines("x_ms", "help"), h.prometheus_lines("y_ms", "h", labels='a="b"',
                                                                         exemplars={1: ("tid", 1.5)}))

    lines = _on_both(run)[0]
    counts = [int(line.rsplit(" ", 1)[1]) for line in lines if line.startswith("x_ms_bucket")]
    assert counts == [1, 2, 3, 4]


# --- SpaceSaving -------------------------------------------------------------


def test_space_saving_exact_below_capacity():
    def run(_h, tm, _p):
        s = tm.SpaceSaving(capacity=8)
        for i in range(5):
            s.offer(f"k{i}", i + 1)
        s.offer("k4", 10)
        s.offer("k0", 0)  # weight 0: ignored
        return s.topk(8)

    top = _on_both(run)
    assert dict((k, c) for k, c, _ in top)["k4"] == 15 and all(e == 0 for _, _, e in top)


@pytest.mark.parametrize("seed", [0, 1])
def test_space_saving_bounded_overestimate(seed):
    rng = np.random.default_rng(seed)
    keys = rng.zipf(1.3, size=3000) % 200
    weights = rng.integers(1, 5, size=3000)

    def run(_h, tm, _p):
        s = tm.SpaceSaving(capacity=16)
        for k, w in zip(keys.tolist(), weights.tolist()):
            s.offer(f"r{k}", w)
        return s.topk(16)

    top = _on_both(run)
    true = {}
    for k, w in zip(keys.tolist(), weights.tolist()):
        true[f"r{k}"] = true.get(f"r{k}", 0) + w
    for key, cnt, err in top:
        assert cnt - err <= true[key] <= cnt  # overestimates by at most its error
    floor = min(c for _, c, _ in top)
    assert all(k in dict((kk, c) for kk, c, _ in top) for k, w in true.items() if w > floor)


# --- the Perfetto export -----------------------------------------------------


def test_spans_to_trace_matches_jax():
    rng = np.random.default_rng(3)

    def spans(tm):
        out = []
        t = 100.0
        for i in range(12):
            s = tm.FlushSpan(flush_id=i, t0=t, depth=int(i % 3), inflight=int(i % 2), n_entries=int(rng.integers(0, 9)),
                             n_bulk=64, encode_ms=0.25 + i * 0.01, dispatch_ms=0.125, deferred=bool(i % 2))
            if i != 11:
                s.settled, s.settle_end = True, t + 0.004 + 0.001 * (i % 4)
            out.append(s)
            t += 0.002
        return out

    recs = [SimpleNamespace(t0=100.001 + 0.003 * i, latency_ms=0.5, resource=f"r{i}", trace_id=f"{i:032x}",
                            span_id=f"{i:016x}", admitted=bool(i % 2), reason=0, reason_name="", flush_seq=i,
                            origin="") for i in range(5)]
    state = rng.bit_generator.state

    def run(_h, tm, pm):
        rng.bit_generator.state = state
        sp = spans(tm)
        return tm.spans_to_trace(sp), pm.spans_to_trace(sp, pid=7, records=recs), tm.spans_to_trace([])

    trace = _on_both(run)[0]
    assert len([e for e in trace["traceEvents"] if e["ph"] == "X"]) == 12 * 2 + 11


# --- the engine's recorder, in lockstep --------------------------------------


def _span_view(s):
    return (s.flush_id, s.depth, s.inflight, s.n_entries, s.n_exits, s.n_bulk, s.n_bulk_exits, s.rows, s.deferred,
            s.settled, s.fallbacks, s.quarantined, s.intern_hits, s.intern_misses, s.param_bucket, s.param_path)


def _counters(eng):
    c = eng.telemetry.counters_snapshot()
    c.pop("arena_hits")
    c.pop("arena_misses")
    return c


def _tele_view(eng):
    t = eng.telemetry
    return ([_span_view(s) for s in t.spans()], _counters(eng), t.hist_flush.count, t.hist_e2e.count,
            t.blocked_sketch.topk(64), t.last_blocked_topk, t._next_id)


def _stream(lib, depth, ring):
    eng = lib.mk(depth=depth, TELEMETRY_RING=ring)
    eng.set_flow_rules([lib.st.FlowRule("fr", count=6), lib.st.FlowRule("b", count=40), lib.st.FlowRule("hot", count=1)])
    eng.set_param_rules({"p": [lib.st.ParamFlowRule("p", param_idx=0, count=2)]})
    rng = np.random.default_rng(5)
    ops, groups = [], []
    for step in range(6):
        lib.clock.set_ms(1000 + 250 * step)
        ops += eng.submit_many([{"resource": "fr"} for _ in range(int(rng.integers(1, 9)))])
        ops += [eng.submit_entry("p", args=(f"v{int(rng.integers(0, 4))}",)) for _ in range(5)]
        ops += [eng.submit_entry("hot") for _ in range(3)]
        groups.append(eng.submit_bulk("b", 16, acquire=rng.integers(1, 4, 16).astype(np.int32)))
        if step % 2:
            g = groups[-2]
            eng.submit_exit_bulk(g.rows, int(g.admitted_count) or 1, rt=3, resource="b")
        eng.flush()
    eng.drain()
    tele = eng.telemetry
    assert len(tele.spans()) == min(ring, 6) and tele.counters_snapshot()["flushes"] == 6
    assert all(s.settled for s in tele.spans()) and tele.hist_flush.count == 6 and tele.hist_e2e.count == 6
    assert tele.counters_snapshot()["deferred_flushes"] == (6 if depth else 0)
    return verdicts(ops), [(g.admitted, g.reason) for g in groups], _tele_view(eng), lib.states(eng)


@pytest.mark.parametrize("ring", [4096, 4])
@pytest.mark.parametrize("depth", [0, 2])
def test_engine_spans_and_counters_match_jax(depth, ring):
    run_lockstep(_stream, depth, ring)


def _lazy_settle(lib):
    eng = lib.mk(depth=2)
    eng.set_flow_rules([lib.st.FlowRule("pp", count=1e9)])
    lib.clock.set_ms(1000)
    for _ in range(5):
        eng.submit_bulk("pp", 16)
        eng.flush()
    tele = eng.telemetry
    deferred = [s for s in tele.spans() if s.deferred]
    pending = [s.flush_id for s in deferred if not s.settled]
    assert deferred and pending
    assert tele.hist_flush.count == 5 and tele.hist_e2e.count == 5 - len(pending)
    before = [_span_view(s) for s in tele.spans()]
    eng.drain()
    assert all(s.settled for s in tele.spans()) and all(0 <= s.inflight <= 2 for s in deferred)
    assert tele.counters_snapshot()["deferred_flushes"] == 5 and tele.hist_e2e.count == 5
    return before, pending, _tele_view(eng)


def test_pipelined_spans_settle_lazily():
    run_lockstep(_lazy_settle)


def _disabled(lib):
    eng = lib.mk(TELEMETRY_ENABLED="false")
    assert not eng.telemetry.enabled and eng._blk_topk_k == 0
    eng.set_flow_rules([lib.st.FlowRule("off", count=1)])
    lib.clock.set_ms(1000)
    ops = []
    for _ in range(3):
        ops.append(eng.submit_entry("off"))
        eng.flush()
    assert eng.telemetry.spans() == [] and eng.telemetry.counters_snapshot()["flushes"] == 0
    assert eng.telemetry.blocked_sketch.topk(5) == [] and eng.telemetry.hist_drain.count == 0
    return verdicts(ops), _counters(eng), lib.states(eng)


def test_disabled_records_nothing():
    run_lockstep(_disabled)


def _blocked_topk(lib):
    eng = lib.mk()
    eng.set_flow_rules([lib.st.FlowRule("s_hot", count=1), lib.st.FlowRule("s_warm", count=3),
                        lib.st.FlowRule("s_free", count=1e9), lib.st.FlowRule("s_bulk", count=5)])
    lib.clock.set_ms(100)
    reqs = ([{"resource": "s_hot", "ts": 100}] * 6 + [{"resource": "s_warm", "ts": 100}] * 5
            + [{"resource": "s_free", "ts": 100}] * 4)
    ops = eng.submit_many([dict(r) for r in reqs])
    acquire = np.array([2, 2, 2, 3, 4], dtype=np.int32)
    g = eng.submit_bulk("s_bulk", 5, ts=100, acquire=acquire)
    eng.flush()
    exact = {}
    for op, req in zip(ops, reqs):
        if not op.verdict.admitted:
            exact[req["resource"]] = exact.get(req["resource"], 0) + 1
    exact["s_bulk"] = int(acquire[~g.admitted].sum())
    assert exact["s_bulk"] > 0 and dict(eng.telemetry.last_blocked_topk) == exact
    sk = {k: c for k, c, _ in eng.telemetry.blocked_sketch.topk(8)}
    assert all(sk[k] == w for k, w in exact.items())
    lib.clock.set_ms(1300)
    more = eng.submit_many([{"resource": "s_hot", "ts": 1300}] * 4)
    eng.flush()
    return verdicts(ops + more), g.admitted, _tele_view(eng)


def test_blocked_sketch_topk_matches_jax():
    run_lockstep(_blocked_topk)


def _snapshot(lib):
    eng = lib.mk(INGEST_MAX_PENDING=64, AUTOTUNE_ENABLED="true")
    eng.set_flow_rules([lib.st.FlowRule("s", count=2)])
    lib.clock.set_ms(1000)
    for _ in range(4):
        eng.submit_entry("s")
    eng.flush()
    snap = eng.telemetry.snapshot(engine=eng)
    keep = ("enabled", "ring_size", "spans_recorded", "blocked_topk", "last_flush_blocked_topk", "health_events",
            "pipeline_depth")
    out = {k: snap[k] for k in keep}
    out["counters"] = _counters(eng)
    out["ingest"] = {k: v for k, v in snap["ingest"].items() if k not in ("settle_ewma_ms", "estimate_ms")}
    out["autotune"] = {k: v for k, v in snap["autotune"].items() if k != "param_memo"}
    out["drain_second_aggregates"] = [a[:3] for a in eng.telemetry.drain_second_aggregates(10_000)]
    return out


def test_snapshot_matches_jax():
    run_lockstep(_snapshot)


# --- TestExports ---------------------------------------------------------------


def _prometheus_engine_series(lib):
    from torch_transport_env import comparable, module_of, reset_process_counters

    # Every admission traced: head sampling draws from each package's own
    # random source (the trace families are in the lines compared).
    lib.config.set(lib.config.TRACE_SAMPLE_RATE, "1.0")
    eng = lib.api.reset(clock=lib.clock, **lib.device_kw)
    try:
        lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("pm", count=1)])
        lib.clock.set_ms(50)
        for _ in range(3):
            lib.st.try_entry("pm")
        reset_process_counters(lib)
        text = module_of(lib, "transport.prometheus").render_metrics(eng)
        for needle in ("sentinel_engine_flush_duration_ms_bucket", "sentinel_engine_drain_duration_ms_bucket",
                       "sentinel_engine_e2e_duration_ms_bucket", "sentinel_engine_pipeline_occupancy",
                       "sentinel_engine_pipeline_mean_inflight", "sentinel_engine_last_flush_encode_ms",
                       "sentinel_engine_last_flush_dispatch_ms", "sentinel_engine_flushes_total",
                       "sentinel_engine_coalesced_fallback_total", "sentinel_engine_param_cache_hits_total"):
            assert needle in text, needle
        assert 'sentinel_engine_blocked_weight{resource="pm"}' in text
        count_line = [ln for ln in text.splitlines() if ln.startswith("sentinel_engine_flush_duration_ms_count")][0]
        assert int(count_line.rsplit(" ", 1)[1]) >= 1
        return comparable(text)
    finally:
        lib.api.reset(**lib.device_kw)


def test_prometheus_engine_series():
    run_lockstep(_prometheus_engine_series)


def _pipeline_occupancy_gauge(lib):
    from torch_transport_env import comparable, module_of, reset_process_counters

    eng = lib.mk()
    eng.set_flow_rules([lib.st.FlowRule("po", count=1e9)])
    eng.pipeline_depth = 2
    eng.pipeline_stats(reset=True)
    for _ in range(8):
        eng.submit_bulk("po", 8)
        eng.flush()
    reset_process_counters(lib)
    lines = module_of(lib, "transport.prometheus").engine_telemetry_lines(eng)
    eng.pipeline_depth = 0
    eng.drain()
    occ = [float(ln.rsplit(" ", 1)[1]) for ln in lines if ln.startswith("sentinel_engine_pipeline_occupancy ")][0]
    assert 0.0 < occ <= 1.0
    return comparable("\n".join(lines))


def test_pipeline_occupancy_gauge():
    run_lockstep(_pipeline_occupancy_gauge)


# The telemetry command's values that are wall times.
_WALL_KEYS = ("flush_ms", "drain_ms", "e2e_ms", "last_flush_host_ms")


def _telemetry_command(lib):
    from torch_transport_env import module_of

    handlers = module_of(lib, "transport.handlers")
    req = handlers.CommandRequest
    eng = lib.api.reset(clock=lib.clock, **lib.device_kw)
    try:
        lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("tc", count=1)])
        for _ in range(3):
            lib.st.try_entry("tc")
        resp = handlers.telemetry_handler(req(path="telemetry", params={"spans": "2"}, body=""))
        assert resp.success
        d = json.loads(resp.result)
        assert d["enabled"] is True
        assert d["counters"]["flushes"] >= 3
        assert d["flush_ms"]["count"] >= 3
        assert len(d["spans"]) == 2
        assert {"resource": "tc", "weight": 1} in d["last_flush_blocked_topk"]
        assert d["pipeline_depth"] == 0
        bad = handlers.telemetry_handler(req(path="telemetry", params={"spans": "x"}, body=""))
        assert not bad.success
        counts = {k: d[k]["count"] for k in _WALL_KEYS if isinstance(d.get(k), dict) and "count" in d[k]}
        out = {k: v for k, v in d.items() if k not in _WALL_KEYS + ("spans", "recent_spans")}
        out["counters"] = {k: v for k, v in d["counters"].items() if not k.startswith("arena_")}
        out["spans"] = [_span_view_dict(sp) for sp in d["spans"]]
        return [out, counts, bad.result, eng.flush_seq]
    finally:
        lib.api.reset(**lib.device_kw)


def _span_view_dict(sp: dict) -> dict:
    """A span of the command's answer without its wall times and the arena
    counts (each package's staging layout)."""
    return {k: v for k, v in sp.items()
            if not k.endswith("_ms") and k not in ("t0", "arena_hits", "arena_misses")}


def test_telemetry_command():
    run_lockstep(_telemetry_command)
