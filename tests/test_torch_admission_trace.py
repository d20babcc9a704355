"""The port's admission trace against the JAX package's: W3C trace-context
parse, render and injection, the context carrier, and the engine's
records (head-sampled, always-sample-blocked, an inbound traceparent,
refused entries, bulk groups, speculative and degraded provenance, the
batch window's per-request records) on lockstep streams. Records are
compared without their generated ids and times."""

import threading

import pytest

from sentinel_tpu.metrics import admission_trace as jat
from sentinel_tpu_torch.metrics import admission_trace as tat

from torch_lockstep import run_lockstep

TP = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"

HEADERS = [
    None, "", "garbage", "00-abc-def-01", TP, TP[:-2] + "00",
    "00-" + "0" * 32 + "-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-" + "0" * 16 + "-01",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01-extra",
    "0x-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319X-b7ad6b7169203331-01",
    "cc-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01-future",
    "  " + TP + "  ", TP.upper(), TP[:-2] + "03",
]


def _tc(tc):
    return None if tc is None else (tc.trace_id, tc.span_id, tc.sampled, tc.tracestate, tc.to_traceparent())


@pytest.mark.parametrize("header", HEADERS)
def test_parse_traceparent_matches_jax(header):
    assert _tc(tat.parse_traceparent(header, "v=1")) == _tc(jat.parse_traceparent(header, "v=1"))


def test_inject_and_carrier_match_jax():
    """inject_trace_headers without an ambient trace is a no-op; with one
    (or an explicit parent) it writes a child's traceparent and the
    tracestate; the carrier's set/get/reset and a context hand-off to
    another thread carry the trace."""
    from sentinel_tpu_torch.core.context import ContextUtil

    h = {}
    assert tat.inject_trace_headers(h) is None and h == {}
    parent = tat.parse_traceparent(TP, "vendor=x")
    token = ContextUtil.set_trace(parent)
    try:
        assert ContextUtil.get_trace() is parent
        child = tat.inject_trace_headers(h)
        jh = {}
        jchild = jat.inject_trace_headers(jh, jat.parse_traceparent(TP, "vendor=x"))
        assert child.trace_id == jchild.trace_id and child.sampled == jchild.sampled
        assert set(h) == set(jh) == {"traceparent", "tracestate"}
        assert h["traceparent"].split("-")[1] == jh["traceparent"].split("-")[1] and h["tracestate"] == "vendor=x"
    finally:
        ContextUtil.reset_trace(token)
    assert ContextUtil.get_trace() is None
    from sentinel_tpu_torch.core.context import Context

    ctx = Context("c", "o")
    ctx.trace = parent
    seen = []
    t = threading.Thread(target=lambda: ContextUtil.run_on_context(ctx, lambda: seen.append(ContextUtil.get_trace())))
    t.start()
    t.join()
    assert seen == [parent]


def _records(eng):
    """The tracer's ring without the minted ids and the times."""
    out = []
    for r in eng.admission_trace.records():
        d = r.as_dict()
        for k in ("latency_ms",):
            d.pop(k)
        if not d["parent_span_id"]:
            d.pop("trace_id")
        d.pop("span_id")
        out.append(d)
    return out


def _trace_stream(lib, rate, depth, spec, seed=11):
    """Entries (some under an inbound traceparent), bulk groups, sheds
    (the valve's bulk bound) and sketch-free refusals at a head sample
    rate of 0 or 1 with always-sample-blocked, at depth 0 or 2, with the
    speculative tier on or off; then a device fault with failover armed
    (degraded provenance). The records and the tracer's counters."""
    import numpy as np

    st = lib.st
    pkg = "sentinel_tpu_torch" if lib.name == "port" else "sentinel_tpu"
    ContextUtil = __import__(f"{pkg}.core.context", fromlist=["x"]).ContextUtil
    at = __import__(f"{pkg}.metrics.admission_trace", fromlist=["x"])
    rng = np.random.default_rng(seed)
    lib.clock.set_ms(1000)
    eng = lib.mk(depth, TRACE_SAMPLE_RATE=str(rate), TRACE_BULK_CAP="3", INGEST_MAX_PENDING_BULK="64",
                 SPECULATIVE_ENABLED=str(spec).lower(), SPECULATIVE_FLUSH_BATCH="100000", FAILOVER_ENABLED="true",
                 FAILOVER_PROBE_FLUSHES="1")
    eng.set_flow_rules([st.FlowRule("a", count=4), st.FlowRule("b", count=30)])
    inj = lib.FaultInjector().install(eng)
    for step in range(6):
        t = 1000 + 400 * step
        lib.clock.set_ms(t)
        token = ContextUtil.set_trace(at.parse_traceparent(TP if step % 2 else TP[:-2] + "00"))
        try:
            for _ in range(3):
                eng.submit_entry("a")
        finally:
            ContextUtil.reset_trace(token)
        for _ in range(int(rng.integers(2, 6))):
            eng.submit_entry(("a", "b")[int(rng.integers(0, 2))])
        eng.submit_bulk("b", 40)
        eng.submit_bulk("b", 40)  # over the bulk bound: shed whole
        if step == 3:
            inj.fail_fetch(eng.flush_seq + 1)
        eng.flush()
        eng.drain()
    return [_records(eng), eng.admission_trace.counters_snapshot(), eng.failover.snapshot()["state"]]


@pytest.mark.parametrize("rate,depth,spec", [(0.0, 0, False), (1.0, 0, False), (0.0, 2, False), (1.0, 0, True)],
                         ids=["blocked_only", "all", "blocked_depth2", "speculative"])
def test_trace_records_match_jax(rate, depth, spec):
    """The records (resource, origin, context, verdict, reason and its
    name, the deciding flush, head-sampled or blocked-sampled, degraded
    and speculative provenance, the settled match; the inbound parent's
    trace and span) equal the JAX engine's."""
    recs, counters, _ = run_lockstep(_trace_stream, rate, depth, spec)
    assert counters["blocked_sampled"] > 0
    provs = {r["provenance"] for r in recs}
    assert {"shed", "degraded"} <= provs
    if spec:
        assert "speculative" in provs
    if rate:
        assert any(r["admitted"] for r in recs) and any(r["parent_span_id"] for r in recs)


def _window_stream(lib):
    """The batch window's per-request records: the tag is stamped on the
    caller's thread at join (an inbound traceparent there), the record
    written at fan-out; the group stamp of submit_bulk is dropped."""
    st = lib.st
    pkg = "sentinel_tpu_torch" if lib.name == "port" else "sentinel_tpu"
    ContextUtil = __import__(f"{pkg}.core.context", fromlist=["x"]).ContextUtil
    at = __import__(f"{pkg}.metrics.admission_trace", fromlist=["x"])
    lib.clock.set_ms(1000)
    eng = lib.mk(TRACE_SAMPLE_RATE="1.0")
    eng.set_flow_rules([st.FlowRule("w", count=3)])
    win = eng.ingest_window
    req_cls = __import__(f"{pkg}.runtime.window", fromlist=["x"]).WindowRequest
    reqs = []
    token = ContextUtil.set_trace(at.parse_traceparent(TP))
    try:
        for i in range(5):
            tag = eng.admission_trace.make_tag()
            reqs.append(req_cls("w", "ctx", "", 1, lib.C.EntryType.OUT, (), 1000 + i, tag))
    finally:
        ContextUtil.reset_trace(token)
    w = type("W", (), {})()
    w.reqs, w.event, w.loops = reqs, threading.Event(), {}
    settled = win._dispatch_window(w)
    win._fan_out_window(w, settled)
    return [[(r.verdict.admitted, r.verdict.reason) for r in reqs], _records(eng)]


def test_window_records_match_jax():
    verdicts, recs = run_lockstep(_window_stream)
    assert len(recs) == 5 and all(r["parent_span_id"] == "b7ad6b7169203331" for r in recs)


def _bulk_chunks(lib, seed):
    """Twelve chunks of bulk groups (some under an inbound parent, some
    head-sampled, degraded or speculative) and a single record now and
    then, made from ``seed`` with each package's own types."""
    import numpy as np

    rng = np.random.default_rng(seed)
    chunks = []
    for c in range(12):
        groups = []
        for gi in range(int(rng.integers(0, 30))):
            n = int(rng.integers(1, 12))
            parent = (lib.TraceContext(f"{gi + 1:032x}", f"{gi + 7:016x}", True) if rng.random() < 0.2 else None)
            tag = lib.TraceTag(parent, bool(rng.random() < 0.3) if parent is None else True, 100.0 + rng.random())
            adm = rng.random(n) < 0.5
            rsn = np.where(adm, 0, rng.integers(1, 7, n)).astype(np.int32)
            groups.append((tag, f"r{gi}", "o", "ctx", adm, rsn, bool(rng.random() < 0.2),
                           "speculative" if rng.random() < 0.2 else ""))
        single = rng.random() < 0.3
        chunks.append((c, groups, single, 101.0 + rng.random() * 1e-3))
    return chunks


def _bulk_tracer_state(lib, seed, ring, cap, blocked, grouped):
    """A tracer fed ``_bulk_chunks``: a group at a time through
    ``record_bulk``, or (the port, ``grouped``) a chunk at a time through
    ``record_bulk_groups``. Its ring with the ids and times, counters,
    exemplars, histogram, and the next head-sampling draw."""
    import numpy as np

    lib._rand.seed(seed)
    tr = lib.AdmissionTracer(enabled=True, ring=ring, sample_rate=0.3, sample_blocked=blocked, bulk_cap=cap)
    for c, groups, single, end in _bulk_chunks(lib, seed):
        if single:
            tr.record_admission(lib.TraceTag(None, True, 99.0), "single", "", "c", False, 2, c, 101.0)
        if grouped:
            tag, res, org, ctx, adm, rsn, deg, prov = ([list(x) for x in zip(*groups)] if groups
                                                       else [[] for _ in range(8)])
            lens = np.array([len(a) for a in adm], dtype=np.int64)
            adm = np.concatenate(adm) if adm else np.zeros(0, bool)
            rsn = np.concatenate(rsn) if rsn else np.zeros(0, np.int32)
            tr.record_bulk_groups(lib.BulkTraceGroups(tag, res, org, ctx, adm, rsn, lens, deg, prov), c, end)
        else:
            for g in groups:
                tr.record_bulk(*g[:6], c, end, degraded=g[6], provenance=g[7])
    counts, total = tr.hist_latency.snapshot_counts()
    return ([(r.as_dict(), r.t0) for r in tr.records()], tr.counters_snapshot(), list(tr.exemplars().items()),
            counts.tolist(), total, lib._rand.random())


@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("cap", [0, 1, 4])
@pytest.mark.parametrize("ring", [1, 5, 37, 2048])
def test_bulk_records_match_jax_record_by_record(ring, cap, blocked):
    """The port's bulk trace records, kept as a chunk's columns and made
    into records when the ring is read, equal the JAX tracer's a record at
    a time: the ring (ids and latencies too) as it drops its oldest, the
    counters, the exemplars, the latency histogram (its float sum exactly)
    and the random draws after them; a group at a time and a chunk at a
    time alike."""
    for seed in range(6):
        want = _bulk_tracer_state(jat, seed, ring, cap, blocked, False)
        assert _bulk_tracer_state(tat, seed, ring, cap, blocked, False) == want
        assert _bulk_tracer_state(tat, seed, ring, cap, blocked, True) == want


def test_histogram_record_each_matches_record():
    """``LatencyHistogram.record_each`` (the bulk records' latencies) gives
    the counts, the float sum and the buckets of ``record`` a value at a
    time, at the buckets' edges too."""
    import numpy as np

    from sentinel_tpu_torch.metrics.histogram import LatencyHistogram

    rng = np.random.default_rng(5)
    one = LatencyHistogram()
    edges = one.bounds_ms
    vals = np.concatenate([rng.random(500) * 50, rng.exponential(3.0, 500), edges, np.nextafter(edges, 0),
                           np.nextafter(edges, np.inf), [0.0, -1.0, 1e12, 2.0 ** 60]])
    for v in vals.tolist():
        one.record(v)
    each = LatencyHistogram()
    buckets = each.record_each(vals)
    assert buckets.tolist() == [one.bucket_of(v) for v in vals.tolist()]
    c1, s1 = one.snapshot_counts()
    c2, s2 = each.snapshot_counts()
    assert c1.tolist() == c2.tolist() and s1 == s2
