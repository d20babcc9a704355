"""Deterministic replay of a capture journal (runtime/capture.py) on the port.

The port's twin of ``tools/replay.py``. A capture directory holds the
columnar admission stream an engine dispatched — entries, bulk groups,
exits, the settled verdicts, and the timeline (rule reloads, sketch
promotions, shard-map bumps, health transitions) — stamped with the
engine's virtual clock. The replay rebuilds the deciding world (the
segment header's config and rule snapshots, then the rule timeline in
stream order), feeds the captured traffic to a fresh engine on a
``ManualClock`` pinned to each chunk's recorded ``now_ms``, and flushes at
the captured chunk boundaries. Verdicts are functions of (rules, windows,
now), so the replayed verdicts must equal the captured ones bit for bit:
any diff is a real divergence (a codec fault, a nondeterministic slot, or
inputs that cannot replay, such as a dropped bulk args column).

The diff leaves out, counted and reported, captured rows flagged
``F_DEGRADED`` (the host fallback decided while the device was lost),
``F_SPECULATIVE`` (the speculative tier decided before the settle; the
replay runs without it) and ``F_VERDICT_MISSING`` (the capture ended
before the chunk's fill landed). ``--strict`` compares them too.

The replay's engine is on the card unless ``--device cpu`` is given.

Modes::

    python -m sentinel_tpu_torch.runtime.replay --dir CAPDIR --verify [--strict] [--depth K] [--device cpu]
    python -m sentinel_tpu_torch.runtime.replay --dir CAPDIR --bench  [--depth K]
    python -m sentinel_tpu_torch.runtime.replay --dir CAPDIR --explain SEQ
    python -m sentinel_tpu_torch.runtime.replay --dir CAPDIR --trace out.json

``--verify`` prints the differential report (exit 1 on any diff);
``--bench`` uses the capture as a load generator and reports replay rows
per second; ``--explain SEQ`` replays through the chunk that decided
captured row SEQ and prints the deciding rule, its threshold against the
observed one-second window and the admissions around the row; ``--trace``
writes the capture's timeline (chunks, rule reloads, freezes) as Chrome
trace-event JSON through ``metrics/perfetto.py``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from sentinel_tpu_torch.ipc import frames
from sentinel_tpu_torch.runtime import capture as cap
from sentinel_tpu_torch.utils.config import config

# Captured-verdict flag bits a non-strict diff leaves out.
SKIP_BITS = frames.F_DEGRADED | frames.F_SPECULATIVE | cap.F_VERDICT_MISSING


def load_capture(directory: str, frozen: bool = True) -> Dict[str, Any]:
    """Decode a capture directory (:func:`capture.decode_capture`) into the
    replay stream, restricted to one boot, the newest: two boots share no
    virtual clock and no cap_seq space."""
    paths = cap.capture_paths(directory, frozen=frozen)
    if not paths:
        raise SystemExit(f"replay: no capture segments under {directory!r}")
    by_boot: Dict[str, List[str]] = {}
    boot_wall: Dict[str, float] = {}
    for p in paths:
        header = cap.read_header(p)
        b = header.get("boot_id", "?")
        by_boot.setdefault(b, []).append(p)
        boot_wall[b] = max(boot_wall.get(b, 0), header.get("wall_ms", 0))
    boot = max(boot_wall, key=boot_wall.get)
    if len(by_boot) > 1:
        print(f"replay: {len(by_boot)} boots in {directory!r}; replaying newest boot {boot} "
              f"({len(by_boot[boot])}/{len(paths)} segments)")
    return cap.decode_capture(by_boot[boot])


def _forced_overrides(depth: int) -> Dict[str, str]:
    """Config keys the replay's engine overrides after the captured
    snapshot: the journal itself (no recording of the replay), the
    multi-process, batching and async planes (the captured stream is the
    chunk sequence they produced), and the host tiers whose verdicts the
    diff leaves out."""
    return {
        config.CAPTURE_ENABLED: "false",
        config.IPC_ENABLED: "false",
        config.IPC_WORKER_MODE: "false",
        config.SPANS_ENABLED: "false",
        config.INGEST_MAX_PENDING: "0",
        config.INGEST_MAX_PENDING_BULK: "0",
        config.INGEST_DEADLINE_MS: "0",
        config.INGEST_BATCH_WINDOW_MS: "0",
        config.AUTOTUNE_ENABLED: "false",
        config.SPECULATIVE_ENABLED: "false",
        config.FAILOVER_ENABLED: "false",
        config.PIPELINE_DEPTH: str(depth),
    }


def build_engine(header: Dict[str, Any], depth: int = 0, device=None):
    """A fresh engine under the captured config and rule snapshot, on a
    ManualClock anchored at the header's engine-clock ms, on ``device``
    (None: the card). The config stays set: :func:`replay` restores the
    caller's when the stream is done."""
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.utils.clock import ManualClock

    for k, v in (header.get("config") or {}).items():
        config.set(k, v)
    for k, v in _forced_overrides(depth).items():
        config.set(k, v)
    clk = ManualClock(start_ms=int(header.get("clock_ms", 0)))
    eng = Engine(clock=clk, device=device)
    apply_rules(eng, header.get("rules") or {})
    return eng, clk


def apply_rules(eng, snap: Dict[str, Any]) -> None:
    """Apply one header rule snapshot (all five kinds)."""
    _apply_rules_event(eng, "flow", snap.get("flow") or [])
    _apply_rules_event(eng, "degrade", snap.get("degrade") or [])
    _apply_rules_event(eng, "param", snap.get("param") or [])
    _apply_rules_event(eng, "authority", snap.get("authority") or {})
    _apply_rules_event(eng, "system", snap.get("system"))


def _apply_rules_event(eng, kind: str, rules: Any) -> None:
    from sentinel_tpu_torch.models.rules import AuthorityRule, DegradeRule, FlowRule, ParamFlowRule, rules_from_json

    if kind == "flow":
        eng.set_flow_rules(rules_from_json(rules, FlowRule))
    elif kind == "degrade":
        eng.set_degrade_rules(rules_from_json(rules, DegradeRule))
    elif kind == "param":
        by_res: Dict[str, List[ParamFlowRule]] = {}
        for r in rules_from_json(rules, ParamFlowRule):
            by_res.setdefault(r.resource, []).append(r)
        eng.set_param_rules(by_res)
    elif kind == "authority":
        eng.set_authority_rules({res: rules_from_json([rd], AuthorityRule)[0] for res, rd in (rules or {}).items()})
    elif kind == "system":
        from sentinel_tpu_torch.rules.system_manager import SystemConfig

        eng.set_system_config(SystemConfig(**rules) if rules else None)


def _replay_chunk(eng, clk, ck) -> Tuple[list, list]:
    """Submit one captured chunk again and flush at its boundary. Returns
    (entry ops, bulk ops) in the chunk's cap_seq row order."""
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
    for g in ck.bulk:
        bulk_ops.append(eng.submit_bulk(
            g.resource, len(g), ts=g.ts, acquire=g.acquire, context_name=g.context or C.CONTEXT_DEFAULT_NAME,
            origin=g.origin, entry_type=C.EntryType.IN if g.inbound else C.EntryType.OUT,
            args_column=g.args,
        ))
    for x in ck.exits:
        thr = x["thr"]
        if thr == -1:
            eng.submit_exit(x["rows"], x["rt"], count=x["count"], err=x["err"], ts=x["ts"], resource=x["resource"],
                            param_rows=x["p_rows"], speculative=False)
        elif thr == 0:
            # A tracer exit: captured as count=0/err=N (Engine.submit_trace).
            eng.submit_trace(x["rows"], count=x["err"], ts=x["ts"])
        else:
            # The speculative reconciler's gauge compensation (±thr, no stats).
            eng._submit_gauge_comp(x["rows"], thr)
    for gx in ck.bulk_exits:
        eng.submit_exit_bulk(gx.rows, len(gx), rt=gx.rt, count=gx.count, err=gx.err, ts=gx.ts, resource=gx.resource,
                             speculative=False)
    eng.flush()
    return entry_ops, bulk_ops


def replay(decoded: Dict[str, Any], depth: int = 0, stop_after_seq: Optional[int] = None,
           device=None) -> Dict[str, Any]:
    """Drive the whole stream; returns ``{"engine", "clock", "chunks":
    [(CapturedChunk, entry_ops, bulk_ops)], "skipped_rules"}`` with every
    verdict settled. Rule events the sketch tier synthesized are skipped:
    the replay engine's own tier derives its promotions from the same
    traffic. Health, sketch, shard, freeze and close records are
    annotations. The caller's config is restored before it returns; the
    caller closes the engine."""
    saved = config.runtime_snapshot()
    try:
        eng, clk = build_engine(decoded["header"], depth=depth, device=device)
        out: List[Tuple[Any, list, list]] = []
        skipped_rules = 0
        try:
            for kind, item in decoded["stream"]:
                if kind == "rules":
                    if item.get("from_sketch"):
                        skipped_rules += 1
                        continue
                    _apply_rules_event(eng, item["kind"], item["rules"])
                elif kind == "chunk":
                    entry_ops, bulk_ops = _replay_chunk(eng, clk, item)
                    out.append((item, entry_ops, bulk_ops))
                    if stop_after_seq is not None and item.cap_seq + item.rows > stop_after_seq:
                        break
            eng.drain()
        except BaseException:
            eng.close()
            raise
    finally:
        config.reset()
        for k, v in saved.items():
            config.set(k, v)
    return {"engine": eng, "clock": clk, "chunks": out, "skipped_rules": skipped_rules}


def _replayed_arrays(ck, entry_ops, bulk_ops):
    """(admitted u8, reason i16, wait i32, have u8) of one replayed chunk,
    in cap_seq row order."""
    n = ck.rows
    admitted = np.zeros(n, np.uint8)
    reason = np.zeros(n, np.int16)
    wait = np.zeros(n, np.int32)
    have = np.zeros(n, np.uint8)
    i = 0
    for op in entry_ops:
        v = op.verdict if op is not None else None
        if v is not None:
            admitted[i] = 1 if v.admitted else 0
            reason[i] = v.reason
            wait[i] = v.wait_ms
            have[i] = 1
        i += 1
    for gi, g in enumerate(bulk_ops):
        gn = len(ck.bulk[gi])
        if g is not None and g.admitted is not None:
            sl = slice(i, i + gn)
            admitted[sl] = g.admitted
            reason[sl] = g.reason
            wait[sl] = g.wait_ms
            have[sl] = 1
        i += gn
    return admitted, reason, wait, have


def verify(decoded: Dict[str, Any], depth: int = 0, strict: bool = False, device=None) -> Dict[str, Any]:
    """The differential report: replay, and diff against the captured
    RK_VERDICT rows. Returns the counts and at most 20 sample diffs."""
    res = replay(decoded, depth=depth, device=device)
    skip_bits = 0 if strict else SKIP_BITS
    report: Dict[str, Any] = {
        "chunks": len(res["chunks"]),
        "rows": 0,
        "compared": 0,
        "diffs": 0,
        "skipped_flagged": 0,  # degraded / speculative / missing rows
        "no_captured_verdict": 0,
        "not_replayed": 0,  # submit returned None (pass-through)
        "skipped_sketch_rules": res["skipped_rules"],
        "samples": [],
    }
    try:
        for ck, entry_ops, bulk_ops in res["chunks"]:
            report["rows"] += ck.rows
            if ck.verdicts is None:
                report["no_captured_verdict"] += ck.rows
                continue
            c_adm, c_rea, c_wait, c_flags = ck.verdicts
            r_adm, r_rea, r_wait, r_have = _replayed_arrays(ck, entry_ops, bulk_ops)
            skip = (c_flags & skip_bits) != 0
            cmp = ~skip & (r_have != 0)
            diff = cmp & ((c_adm != r_adm) | (c_rea != r_rea) | (c_wait != r_wait))
            report["skipped_flagged"] += int(skip.sum())
            report["not_replayed"] += int((~skip & (r_have == 0)).sum())
            report["compared"] += int(cmp.sum())
            report["diffs"] += int(diff.sum())
            for i in np.flatnonzero(diff)[: 20 - len(report["samples"])].tolist():
                report["samples"].append({
                    "seq": ck.cap_seq + i,
                    "flush_seq": ck.flush_seq,
                    "captured": {"admitted": int(c_adm[i]), "reason": int(c_rea[i]), "wait_ms": int(c_wait[i])},
                    "replayed": {"admitted": int(r_adm[i]), "reason": int(r_rea[i]), "wait_ms": int(r_wait[i])},
                })
    finally:
        res["engine"].close()
    return report


# ---------------------------------------------------------------------------
# --explain
# ---------------------------------------------------------------------------
def _resource_rows(ck, resource: str) -> np.ndarray:
    """Whether each of the chunk's rows is on ``resource`` (a bulk group
    has one resource)."""
    mask = np.zeros(ck.rows, dtype=bool)
    i = 0
    for e in ck.entries:
        mask[i] = e["resource"] == resource
        i += 1
    for g in ck.bulk:
        mask[i: i + len(g)] = g.resource == resource
        i += len(g)
    return mask


def _observed_qps(decoded: Dict[str, Any], resource: str, now: int) -> float:
    """The admitted acquires on ``resource`` in the trailing second before
    ``now``, from the captured stream itself (what the deciding kernel
    saw)."""
    observed = 0.0
    for ck in decoded["chunks"].values():
        if ck.verdicts is None or ck.now_ms > now:
            continue
        c_adm = ck.verdicts[0]
        i = 0
        for e in ck.entries:
            if e["resource"] == resource and now - 1000 < e["ts"] <= now and i < len(c_adm) and c_adm[i]:
                observed += e["acquire"]
            i += 1
        for g in ck.bulk:
            n = len(g)
            if g.resource == resource and i < len(c_adm):
                adm = c_adm[i: i + n] != 0
                m = len(adm)  # rows past the captured verdicts are not admitted
                sel = adm & (now - 1000 < g.ts[:m]) & (g.ts[:m] <= now)
                observed += float(g.acquire[:m][sel].sum())
            i += n
    return observed


def explain(decoded: Dict[str, Any], seq: int, depth: int = 0, device=None) -> Dict[str, Any]:
    """Replay through the chunk that decided captured row ``seq`` and
    attribute its verdict: the deciding rule (the blocked rule), the
    reason, the threshold against the observed one-second window, and
    the resource's admissions in the chunk before and after the row."""
    from sentinel_tpu_torch.core import errors as E

    target_ck = None
    for ck in decoded["chunks"].values():
        if ck.cap_seq <= seq < ck.cap_seq + ck.rows:
            target_ck = ck
            break
    if target_ck is None:
        raise SystemExit(f"replay: seq {seq} is not in this capture")
    row = _row_of(target_ck, seq - target_ck.cap_seq)
    resource = row["resource"]
    now = int(target_ck.now_ms)
    observed_qps = _observed_qps(decoded, resource, now)

    res = replay(decoded, depth=depth, stop_after_seq=seq, device=device)
    try:
        ck, entry_ops, bulk_ops = res["chunks"][-1]
        idx = seq - ck.cap_seq
        v = None
        if idx < len(entry_ops):
            op = entry_ops[idx]
            v = op.verdict if op is not None else None
        else:
            j = idx - len(entry_ops)
            for gi, group in enumerate(ck.bulk):
                if j < len(group):
                    g = bulk_ops[gi]
                    if g is not None and g.admitted is not None:
                        from sentinel_tpu_torch.runtime.engine import Verdict

                        # A bulk verdict carries no rule: attribute it from
                        # the replay engine's live tables by reason.
                        blocked = None if g.admitted[j] else _attribute_rule(res["engine"], resource, int(g.reason[j]))
                        v = Verdict(admitted=bool(g.admitted[j]), reason=int(g.reason[j]),
                                    wait_ms=int(g.wait_ms[j]), blocked_rule=blocked)
                    break
                j -= len(group)

        out: Dict[str, Any] = {
            "seq": seq,
            "flush_seq": ck.flush_seq,
            "now_ms": now,
            "row": row,
            "observed_window_qps": observed_qps,
        }
        if ck.verdicts is not None:
            c_adm = ck.verdicts[0]
            on_res = np.flatnonzero(_resource_rows(ck, resource))
            before = on_res[on_res < idx]
            out["captured"] = {
                "admitted": int(ck.verdicts[0][idx]),
                "reason": int(ck.verdicts[1][idx]),
                "reason_name": E.exc_name_for_code(int(ck.verdicts[1][idx])) if ck.verdicts[1][idx] else "PASS",
                "wait_ms": int(ck.verdicts[2][idx]),
                "flags": int(ck.verdicts[3][idx]),
            }
        if v is not None:
            rule = getattr(v, "blocked_rule", None)
            out["replayed"] = {
                "admitted": bool(v.admitted),
                "reason": int(v.reason),
                "reason_name": E.exc_name_for_code(v.reason) if v.reason else "PASS",
                "wait_ms": int(v.wait_ms),
                "limit_type": v.limit_type,
                "slot_name": v.slot_name,
                "deciding_rule": rule.to_dict() if rule is not None else None,
                "threshold": getattr(rule, "count", None),
            }
        if ck.verdicts is not None:
            admitted_total = int(c_adm[on_res].astype(np.int64).sum())
            out["pre"] = {
                "resource_rows_in_chunk": int(len(on_res)),
                "admitted_before_row": int(c_adm[before].astype(np.int64).sum()),
            }
            out["post"] = {"admitted_total": admitted_total, "blocked_total": int(len(on_res) - admitted_total)}
        return out
    finally:
        res["engine"].close()


def _attribute_rule(eng, resource: str, reason: int):
    """The rule of that kind on that resource in the replay engine's live
    tables: a bulk verdict carries only the reason code."""
    from sentinel_tpu_torch.core import errors as E

    if reason == E.BLOCK_FLOW:
        for r in eng.flow_index.user_rules():
            if r.resource == resource:
                return r
    elif reason == E.BLOCK_DEGRADE:
        for r in eng.degrade_index.rules:
            if r.resource == resource:
                return r
    elif reason == E.BLOCK_PARAM:
        for pairs in eng.param_index.by_resource.values():
            for _gid, r in pairs:
                if r.resource == resource:
                    return r
    elif reason == E.BLOCK_AUTHORITY:
        return eng.authority_rules.get(resource)
    return None


def _row_of(ck, idx: int) -> Dict[str, Any]:
    if idx < len(ck.entries):
        return ck.entries[idx]
    j = idx - len(ck.entries)
    for group in ck.bulk:
        if j < len(group):
            return group[j]
        j -= len(group)
    raise IndexError(f"row {idx} outside chunk of {ck.rows} rows")


# ---------------------------------------------------------------------------
# --bench / --trace
# ---------------------------------------------------------------------------
def bench(decoded: Dict[str, Any], depth: int = 0, device=None) -> Dict[str, Any]:
    """The capture as a load generator: the time of a whole replay
    (submit, flush and drain, the verdicts settled) and its rows/s."""
    rows = sum(ck.rows for ck in decoded["chunks"].values())
    t0 = time.perf_counter()
    res = replay(decoded, depth=depth, device=device)
    elapsed = time.perf_counter() - t0
    eng = res["engine"]
    eng.close()
    return {
        "chunks": len(res["chunks"]),
        "rows": rows,
        "elapsed_s": round(elapsed, 4),
        "rows_per_s": round(rows / elapsed, 1) if elapsed > 0 else 0.0,
        "depth": depth,
        "device": str(eng.device),
    }


def trace_dict(decoded: Dict[str, Any]) -> Dict[str, Any]:
    """The capture's timeline as Chrome trace-event JSON: one slice a
    chunk on a ``chunks`` track, instants for rule reloads, health records
    and freezes (metrics/perfetto.py)."""
    from sentinel_tpu_torch.metrics.perfetto import TraceBuilder

    tb = TraceBuilder()
    pid = tb.process(decoded["header"].get("app", "capture"))
    tid = tb.thread(pid, "chunks")
    ev_tid = tb.thread(pid, "timeline")
    last_ms: Optional[int] = None
    for kind, item in decoded["stream"]:
        if kind == "chunk":
            tb.slice(pid, tid, "chunk", item.now_ms * 1000.0, 1000.0,
                     args={"flush_seq": item.flush_seq, "cap_seq": item.cap_seq, "rows": item.rows})
            last_ms = item.now_ms
        else:
            tb.instant(pid, ev_tid, kind, (last_ms or 0) * 1000.0, args=item)
    return tb.build()


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", required=True, help="capture directory")
    ap.add_argument("--depth", type=int, default=0, help="replay pipeline depth (default 0 = sync)")
    ap.add_argument("--device", default=None, help="the replay engine's device (default: the card; cpu: the "
                                                   "plain versions of the kernels)")
    ap.add_argument("--no-frozen", action="store_true", help="ignore the frozen-* segments")
    ap.add_argument("--verify", action="store_true", help="diff the replayed verdicts against the captured ones")
    ap.add_argument("--strict", action="store_true", help="with --verify: diff degraded/speculative/missing rows too")
    ap.add_argument("--bench", action="store_true", help="time a whole replay as a load generator")
    ap.add_argument("--explain", type=int, default=None, metavar="SEQ",
                    help="attribute the verdict of captured row SEQ")
    ap.add_argument("--trace", default=None, metavar="OUT", help="write the capture timeline as trace-event JSON")
    args = ap.parse_args(argv)

    decoded = load_capture(args.dir, frozen=not args.no_frozen)
    did = False
    if args.trace:
        trace = trace_dict(decoded)
        with open(args.trace, "w", encoding="utf-8") as f:
            json.dump(trace, f)
        print(f"wrote {args.trace}: {len(trace['traceEvents'])} events")
        did = True
    if args.explain is not None:
        print(json.dumps(explain(decoded, args.explain, depth=args.depth, device=args.device), indent=2,
                         default=str))
        did = True
    if args.bench:
        print(json.dumps(bench(decoded, depth=args.depth, device=args.device), indent=2))
        did = True
    if args.verify or not did:
        report = verify(decoded, depth=args.depth, strict=args.strict, device=args.device)
        print(json.dumps(report, indent=2))
        if report["diffs"]:
            raise SystemExit(1)
        print(f"replay verified: {report['compared']} verdicts bit-exact ({report['skipped_flagged']} flagged rows "
              f"skipped, depth {args.depth})")


if __name__ == "__main__":
    main()
