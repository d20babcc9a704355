"""The golden capture corpus (tests/data/capture_corpus/, written by
tests/data/gen_capture_corpus.py) replayed through the port's engine on
the CPU, as the port's gate: flow QPS and THREAD rules, a breaker, a
hot-parameter rule with args on singles and bulk groups, a mid-stream
reload, exits, a rollover and freezes. The corpus is decoded with the
JAX package's capture reader; a fresh port ``Engine(device="cpu")`` at
pipeline depth 0 on a ManualClock gets the rule timeline and the
captured chunks exactly as ``tools/replay.py`` feeds the JAX engine
(``_replay_chunk``), and every captured verdict (admitted, reason,
wait_ms) must come back identical, with every row compared. Health and
freeze records are annotations there and here."""

import os

import numpy as np

from sentinel_tpu.runtime import capture as cap_mod

CORPUS = os.path.join(os.path.dirname(__file__), "data", "capture_corpus")

# The replay's forced overrides (tools/replay.py:_forced_overrides, depth 0).
_FORCED = {
    "sentinel.tpu.capture.enabled": "false",
    "sentinel.tpu.ipc.enabled": "false",
    "sentinel.tpu.ipc.worker.mode": "false",
    "sentinel.tpu.spans.enabled": "false",
    "sentinel.tpu.autotune.enabled": "false",
    "sentinel.tpu.speculative.enabled": "false",
    "sentinel.tpu.failover.enabled": "false",
    "sentinel.tpu.host.pipeline.depth": "0",
}


def _decoded():
    paths = cap_mod.capture_paths(CORPUS, frozen=True)
    assert paths, "corpus missing: run tests/data/gen_capture_corpus.py"
    return cap_mod.decode_capture(paths)


def _apply_rules(eng, kind, rules):
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.models.rules import rules_from_json
    from sentinel_tpu_torch.rules.system_manager import SystemConfig

    if kind == "flow":
        eng.set_flow_rules(rules_from_json(rules, st.FlowRule))
    elif kind == "degrade":
        eng.set_degrade_rules(rules_from_json(rules, st.DegradeRule))
    elif kind == "param":
        by_res = {}
        for r in rules_from_json(rules, st.ParamFlowRule):
            by_res.setdefault(r.resource, []).append(r)
        eng.set_param_rules(by_res)
    elif kind == "authority":
        eng.set_authority_rules({res: rules_from_json([rd], st.AuthorityRule)[0] for res, rd in (rules or {}).items()})
    elif kind == "system":
        eng.set_system_config(SystemConfig(**rules) if rules else None)
    else:
        raise AssertionError(f"a rule kind the replay does not know: {kind}")


def _replay_chunk(eng, clk, ck):
    """tools/replay.py:_replay_chunk against the port's engine."""
    from sentinel_tpu_torch.models import constants as C

    clk.set_ms(int(ck.now_ms))
    entry_ops = [
        eng.submit_entry(
            e["resource"], context_name=e["context"] or C.CONTEXT_DEFAULT_NAME, origin=e["origin"],
            acquire=e["acquire"], entry_type=C.EntryType.IN if e["in"] else C.EntryType.OUT, prio=e["prio"],
            ts=e["ts"], args=e["args"],
        )
        for e in ck.entries
    ]
    bulk_ops = []
    for group in ck.bulk:
        first = group[0]
        args_col = [tuple(e["args"]) for e in group] if any(e["args"] for e in group) else None
        bulk_ops.append(eng.submit_bulk(
            first["resource"], len(group), ts=np.array([e["ts"] for e in group], dtype=np.int64),
            acquire=np.array([e["acquire"] for e in group], dtype=np.int32),
            context_name=first["context"] or C.CONTEXT_DEFAULT_NAME, origin=first["origin"],
            entry_type=C.EntryType.IN if first["in"] else C.EntryType.OUT, args_column=args_col,
        ))
    for x in ck.exits:
        if x["thr"] == -1:
            eng.submit_exit(x["rows"], x["rt"], count=x["count"], err=x["err"], ts=x["ts"], resource=x["resource"],
                            param_rows=x["p_rows"])
        elif x["thr"] == 0:
            eng.submit_trace(x["rows"], count=x["err"], ts=x["ts"])
        else:
            raise AssertionError("a gauge-compensation exit: the speculative tier's hook is not ported")
    for group in ck.bulk_exits:
        first = group[0]
        eng.submit_exit_bulk(
            first["rows"], len(group), rt=np.array([x["rt"] for x in group], dtype=np.int64),
            count=np.array([x["count"] for x in group], dtype=np.int64),
            err=np.array([x["err"] for x in group], dtype=np.int64),
            ts=np.array([x["ts"] for x in group], dtype=np.int64), resource=first["resource"],
        )
    eng.flush()
    return entry_ops, bulk_ops


def _replayed(ck, entry_ops, bulk_ops):
    """(admitted, reason, wait, have) of one replayed chunk in row order."""
    n = ck.rows
    out = np.zeros((4, n), np.int64)
    i = 0
    for op in entry_ops:
        if op is not None and op.verdict is not None:
            v = op.verdict
            out[:, i] = (v.admitted, v.reason, v.wait_ms, 1)
        i += 1
    for gi, g in enumerate(bulk_ops):
        gn = len(ck.bulk[gi])
        if g is not None and g.admitted is not None:
            out[:, i : i + gn] = (g.admitted, g.reason, g.wait_ms, np.ones(gn))
        i += gn
    return out


def test_corpus_replays_on_the_port_with_zero_diffs():
    from sentinel_tpu.ipc import frames

    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.utils.clock import ManualClock
    from sentinel_tpu_torch.utils.config import config

    decoded = _decoded()
    header = decoded["header"]
    skip_bits = frames.F_DEGRADED | frames.F_SPECULATIVE | cap_mod.F_VERDICT_MISSING
    for k, v in (header.get("config") or {}).items():
        config.set(k, v)
    for k, v in _FORCED.items():
        config.set(k, v)
    try:
        clk = ManualClock(start_ms=int(header.get("clock_ms", 0)))
        eng = Engine(clock=clk, device="cpu")
        for kind in ("flow", "degrade", "param", "authority", "system"):
            snap = (header.get("rules") or {}).get(kind)
            if snap:
                _apply_rules(eng, kind, snap)
        rows = compared = 0
        diffs = []
        kinds = set()
        for kind, item in decoded["stream"]:
            kinds.add(kind)
            if kind == "rules":
                assert not item.get("from_sketch")
                _apply_rules(eng, item["kind"], item["rules"])
            elif kind == "chunk":
                got = _replayed(item, *_replay_chunk(eng, clk, item))
                rows += item.rows
                if item.rows == 0:
                    continue  # an exits-only chunk: nothing to compare
                assert item.verdicts is not None, "every chunk with entries carries its verdicts"
                c_adm, c_rea, c_wait, c_flags = item.verdicts
                for i in range(item.rows):
                    assert not int(c_flags[i]) & skip_bits, "no captured row is flagged"
                    assert got[3, i], "every captured row was replayed"
                    compared += 1
                    want = (int(c_adm[i]), int(c_rea[i]), int(c_wait[i]))
                    if want != tuple(int(x) for x in got[:3, i]):
                        diffs.append((item.cap_seq + i, want, tuple(got[:3, i])))
        eng.close()
    finally:
        config.reset()
    assert not diffs, diffs[:20]
    assert compared == rows > 300
    assert {"chunk", "rules", "health", "freeze"} <= kinds
    # What the rows exercise: blocks by the flow, param and breaker stages.
    reasons = {int(r) for _k, ck in decoded["stream"] if _k == "chunk" and ck.rows for r in ck.verdicts[1]}
    assert {0, 1, 2, 5} <= reasons, reasons
