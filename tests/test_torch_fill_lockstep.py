"""The engine's fill at scale against the JAX engine's: chunks of about
3,000 bulk groups, blocked by flow, degrade, authority and param rules
(some rules with another limit app than "default"), with the speculative
tier on or off and the admission tracer at its defaults. The trace
records (ids included), the tracer's counters, the block log's lines in
their order (its key cap reached in the middle of a chunk), every metric
extension call and the groups' verdicts equal the JAX engine's."""

import tempfile

import numpy as np
import pytest

from torch_lockstep import run_lockstep

N_RES = 3000  # resources, one bulk group each a flush
FLUSHES = 3
LOG_CAP = 2500  # the block log's keys an interval: reached inside the second flush's chunk
TRIPPING = {f"r{i}" for i in range(0, N_RES, 11)}  # resources whose breakers failing completions trip


def _pkg(lib, mod):
    pkg = "sentinel_tpu_torch" if lib.name == "port" else "sentinel_tpu"
    return __import__(f"{pkg}.{mod}", fromlist=["x"])


def _fill_stream(lib, spec, seed=23):
    st, C = lib.st, lib.C
    ext_mod = _pkg(lib, "metrics.extension")
    at = _pkg(lib, "metrics.admission_trace")
    calls = []

    class Ext(ext_mod.MetricExtension):
        def add_pass(self, resource, n, *args):
            calls.append(("pass", resource, n))

        def add_block(self, resource, n, origin, err, *args):
            calls.append(("block", resource, n, origin, type(err).__name__))

        def add_success(self, resource, n, *args):
            calls.append(("success", resource, n))

        def add_exception(self, resource, n, throwable):
            calls.append(("exception", resource, n))

        def add_rt(self, resource, rt_ms, *args):
            calls.append(("rt", resource, rt_ms))

    rng = np.random.default_rng(seed)
    lib.config.set(lib.config.LOG_DIR, tempfile.mkdtemp(prefix=f"fill-{lib.name}-"))
    lib.clock.set_ms(1000)
    cfg = {"SPECULATIVE_ENABLED": "true", "SPECULATIVE_FLUSH_BATCH": "1000000"} if spec else {}
    eng = lib.mk(0, **cfg)
    eng.block_log.max_entry_count = LOG_CAP
    ext_mod.MetricExtensionProvider.clear()
    ext_mod.MetricExtensionProvider.register(Ext())
    try:
        flow = []
        for i in range(N_RES):
            if i % 19 == 0:  # a rate limiter: the speculative tier declines these groups
                flow.append(st.FlowRule(f"r{i}", count=50, control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER,
                                        max_queueing_time_ms=0))
            else:
                flow.append(st.FlowRule(f"r{i}", count=int(rng.integers(1, 4))))
            if i % 5 == 0:
                flow.append(st.FlowRule(f"r{i}", count=1, limit_app="o1"))
            if i % 9 == 0:
                flow.append(st.FlowRule(f"r{i}", count=2, limit_app="other"))
        eng.set_flow_rules(flow)
        eng.set_degrade_rules([st.DegradeRule(f"r{i}", grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, count=1, time_window=5,
                                              min_request_amount=1, limit_app="o2" if i % 2 else "default")
                               for i in range(0, N_RES, 11)])
        eng.set_authority_rules({f"r{i}": st.AuthorityRule(f"r{i}", limit_app="o2", strategy=C.AUTHORITY_BLACK)
                                 for i in range(0, N_RES, 13)})
        eng.set_param_rules({f"r{i}": [st.ParamFlowRule(f"r{i}", param_idx=0, count=1)] for i in range(3, N_RES, 17)})
        at._rand.seed(seed)  # the same head sampling and ids on both engines
        out, prev = [], []
        for step in range(FLUSHES):
            now = 1000 + 700 * step
            lib.clock.set_ms(now)
            for g in prev:  # failing completions trip the breakers
                if g is not None and g.resource in TRIPPING and g.admitted_count:
                    eng.submit_exit_bulk(g.rows, g.admitted_count, rt=5, ts=now,
                                         err=np.ones(g.admitted_count, np.int32), resource=g.resource)
            groups = []
            for i in range(N_RES):
                n = int(rng.integers(1, 7))
                origin = ("", "o1", "o2", "o3")[int(rng.integers(0, 4))]
                args = [(f"v{int(v)}",) for v in rng.integers(0, 3, n)] if i % 17 == 3 else None
                acq = rng.integers(0, 4, n).astype(np.int32)  # some rows acquire 0
                groups.append(eng.submit_bulk(f"r{i}", n, ts=now - int(rng.integers(0, 50)), acquire=acq,
                                              origin=origin, args_column=args))
            eng.flush()
            eng.drain()
            out.append([(g.admitted, g.reason, g.wait_ms) if g is not None else None for g in groups])
            prev = groups
        eng.block_log.flush()
        recs = [r.as_dict() for r in eng.admission_trace.records()]
        for d in recs:
            d.pop("latency_ms")  # a wall time
        return [out, eng.block_log.read_entries(), recs, eng.admission_trace.counters_snapshot(), calls]
    finally:
        ext_mod.MetricExtensionProvider.clear()


@pytest.mark.parametrize("spec", [False, True], ids=["device", "speculative"])
def test_fill_at_scale_matches_jax(spec):
    """Three flushes of 3,000 bulk groups: records, counters, block-log
    lines and their order, extension calls and verdicts as the JAX
    engine's."""
    verdicts, blocks, recs, counters, calls = run_lockstep(_fill_stream, spec)
    names = {b[1][1] for b in blocks}
    assert {"FlowException", "DegradeException", "AuthorityException", "ParamFlowException"} <= names
    assert {b[1][2] for b in blocks} >= {"default", "o1", "o2"}
    # The cap: the second interval's lines stop at LOG_CAP keys.
    per_sec = {}
    for ts, _key, _n in blocks:
        per_sec[ts] = per_sec.get(ts, 0) + 1
    assert max(per_sec.values()) == LOG_CAP
    assert counters["blocked_sampled"] > 0 and len(recs) > 0
    assert any(c[0] == "block" for c in calls) and any(c[0] == "pass" for c in calls)
    if spec:
        assert any(r["provenance"] == "speculative" for r in recs)
        assert any(r["provenance"] == "device" for r in recs)


@pytest.mark.parametrize("cap", [3, 6, 50])
def test_block_columns_log_as_their_item_tuples(cap):
    """``BlockLogger.log_parts`` with item tuples and ``BlockColumns`` in
    one call writes the lines the JAX logger writes for the same items as
    tuples in one ``log_batch``: the key cap met inside a part, a key
    repeated across parts, "default" limit apps given as None."""
    from sentinel_tpu.metrics import block_log as jbl
    from sentinel_tpu_torch.metrics import block_log as tbl

    rng = np.random.default_rng(cap)
    names = ["BlockException", "FlowException", "DegradeException"]
    res, org = ["a", "b", "c", "a"], ["", "o1", "", "o2"]
    singles = [("a", "FlowException", "default", "", 2), ("z", "SystemBlockException", "default", "o", 1)]
    cols = []
    for _ in range(3):
        g = rng.integers(0, 4, 6)
        r = rng.integers(1, 3, 6)
        la = None if rng.random() < 0.5 else [("default", "o1", "other")[i] for i in rng.integers(0, 3, 6)]
        cols.append(tbl.BlockColumns(res, org, names, g, r, la, rng.integers(0, 5, 6)))
    items = list(singles) + [(*key, n) for c in cols for key, n in zip(c.keys(), c.counts.tolist())]
    out = {}
    for name, mod in (("jax", jbl), ("port", tbl)):
        d = tempfile.mkdtemp(prefix=f"cols-{name}-")
        lg = mod.BlockLogger(base_dir=d, max_entry_count=cap)
        if name == "jax":
            lg.log_batch(items, 5000)
        else:
            lg.log_parts([singles] + cols, 5000)
        lg.flush()
        out[name] = lg.read_entries()
    assert out["port"] == out["jax"] and len(out["port"]) == min(cap, len({it[:4] for it in items}))
