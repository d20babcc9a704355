"""The port's capture journal (sentinel_tpu_torch/runtime/capture.py)
against the JAX package's, on the CPU.

The twins of tests/test_capture.py's write side: arming the journal
changes no verdict and no state bit; the segments decode back to the
traffic; the telemetry counters flow; the rollover is bounded; every
freeze trigger (manual, breaker, shed streak, DEGRADED, trimmed set);
the next boot keeps a dead boot's live segments. Then the format: the
same stream on the JAX engine and on the port's, each with the journal
armed, decodes with the JAX reader to the same records (every field but
the boot id and the wall-ms stamps), at depth 0 and 2; the golden corpus
decodes with the port's reader as with the JAX reader; the port's
columnar spills are byte-identical to the row encoders. And the kill: a
spawned engine process killed with SIGKILL in mid-stream leaves segments
the next boot keeps as ``frozen-death-*``, which the port's replay
verifies with zero diffs (tests/test_capture_chaos.py's case without the
supervisor; its twin through the supervisor is in
tests/test_torch_standby.py).

``TestCaptureCommand`` runs here since the control surface's port (ROADMAP
item 11, part 1): the ``capture`` command off and armed, and the freeze on
demand, on both packages' global engines (tests/torch_transport_env.py)."""

import json
import os
import shutil

import numpy as np
import pytest

from sentinel_tpu.runtime import capture as jcap

from sentinel_tpu_torch.ipc import frames
from sentinel_tpu_torch.models.rules import DegradeRule, FlowRule, ParamFlowRule
from sentinel_tpu_torch.runtime import capture as pcap
from sentinel_tpu_torch.runtime.engine import Engine
from sentinel_tpu_torch.utils.clock import ManualClock
from sentinel_tpu_torch.utils.config import config

from torch_lockstep import run_lockstep
from torch_transport_env import pair  # noqa: F401

CORPUS = os.path.join(os.path.dirname(__file__), "data", "capture_corpus")

RULES = [FlowRule("cap-qps", count=3), FlowRule("cap-open", count=1e9)]


def _drive(eng, clk, windows=6):
    """tests/test_capture.py's mixed traffic; the flat verdict list in
    submission order."""
    out = []
    for _w in range(windows):
        ops = [eng.submit_entry("cap-qps", origin=f"svc-{i % 2}", args=("k", i)) for i in range(5)]
        ops.append(eng.submit_entry("cap-open", acquire=2))
        g = eng.submit_bulk("cap-open", 4, context_name="bulk-ctx")
        eng.flush()
        for op in ops:
            v = op.verdict
            out.append((v.admitted, v.reason, v.wait_ms))
            if v.admitted:
                eng.submit_exit(op.rows, rt=5)
        for j in range(4):
            out.append((bool(g.admitted[j]), int(g.reason[j]), int(g.wait_ms[j])))
        clk.advance(250)
    eng.drain()
    return out


@pytest.fixture()
def cap_dir(tmp_path):
    """The journal armed into a per-test directory; the config restored."""
    d = str(tmp_path / "cap")
    config.set(config.CAPTURE_ENABLED, "true")
    config.set(config.CAPTURE_DIR, d)
    try:
        yield d
    finally:
        config.reset()


def _engine():
    clk = ManualClock(start_ms=0)
    eng = Engine(clock=clk, device="cpu")
    eng.set_flow_rules(RULES)
    return eng, clk


# --- TestCaptureDifferential -------------------------------------------------


def test_disabled_is_one_attribute():
    eng = Engine(clock=ManualClock(0), device="cpu")
    assert eng.capture is None
    eng.close()


def test_capture_on_is_bit_identical(tmp_path):
    """Arming the journal changes nothing: the same traffic on the same
    clock gives identical verdicts and state tensors, with breakers,
    param rules with args on singles and bulk groups, and bulk exits."""
    from torch_lockstep import _port_lib

    states = _port_lib().states

    def run():
        clk = ManualClock(0)
        eng = Engine(clock=clk, device="cpu")
        eng.set_flow_rules(RULES + [FlowRule("cap-b", count=1e9)])
        eng.set_degrade_rules([DegradeRule("cap-b", grade=2, count=2, time_window=1, min_request_amount=1)])
        eng.set_param_rules({"cap-open": [ParamFlowRule("cap-open", param_idx=0, count=3)]})
        out = _drive(eng, clk)
        for w in range(4):
            g = eng.submit_bulk("cap-open", 6, args_column=[(f"v{j % 2}",) for j in range(6)])
            b = eng.submit_bulk("cap-b", 3)
            eng.flush()
            eng.submit_exit_bulk(b.rows, 3, rt=5, err=np.ones(3, np.int32), ts=clk.now_ms(), resource="cap-b")
            out += [g.admitted.tolist(), g.reason.tolist(), b.admitted.tolist(), b.reason.tolist()]
            clk.advance(100)
        eng.flush()
        eng.drain()
        st_ = states(eng)
        snap = eng.capture.snapshot() if eng.capture is not None else None
        eng.close()
        return out, st_, snap

    baseline, base_states, none = run()
    assert none is None
    assert any(not v[0] for v in baseline[:66]) and any(v[0] for v in baseline[:66])
    config.set(config.CAPTURE_ENABLED, "true")
    config.set(config.CAPTURE_DIR, str(tmp_path / "cap"))
    try:
        captured, cap_states, snap = run()
    finally:
        config.reset()
    assert captured == baseline
    for a, b in zip(base_states[:4], cap_states[:4]):
        for x, y in zip(a, b):
            for p, q in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
                assert np.array_equal(p, q)
    assert snap["counters"]["chunks"] == 11 and snap["counters"]["freezes"] >= 1  # the breaker opened


# --- TestCaptureRoundtrip ----------------------------------------------------


def test_segments_decode_back_to_the_traffic(cap_dir):
    eng, clk = _engine()
    live = _drive(eng, clk)
    snap = eng.capture.snapshot()
    eng.close()
    decoded = jcap.decode_capture(jcap.capture_paths(cap_dir))
    hdr = decoded["header"]
    assert hdr["boot_id"] == snap["boot_id"]
    assert hdr["config"][config.CAPTURE_ENABLED] == "true"
    # Segment 0 opened before set_flow_rules: its header's snapshot is empty
    # and the reload rides the timeline, applied before the first chunk.
    assert hdr["rules"]["flow"] == []
    reloads = [d for k, d in decoded["stream"] if k == "rules" and d["kind"] == "flow"]
    assert {r["resource"] for r in reloads[0]["rules"]} == {"cap-qps", "cap-open"}
    all_chunks = [ck for kind, ck in decoded["stream"] if kind == "chunk"]
    chunks = [ck for ck in all_chunks if ck.rows]
    assert len(chunks) == 6  # and the close's exits-only flush
    replayed = []
    for ck in chunks:
        adm, rea, wait, flags = ck.verdicts
        assert not any(int(f) & jcap.F_VERDICT_MISSING for f in flags)
        assert [e["resource"] for e in ck.entries] == ["cap-qps"] * 5 + ["cap-open"]
        assert ck.entries[0]["args"] == ("k", 0)
        assert ck.entries[5]["acquire"] == 2
        assert len(ck.bulk) == 1 and len(ck.bulk[0]) == 4
        assert ck.bulk[0][0]["context"] == "bulk-ctx"
        replayed += [(bool(adm[i]), int(rea[i]), int(wait[i])) for i in range(ck.rows)]
    assert replayed == live
    assert any(ck.exits for ck in all_chunks)
    assert snap["counters"]["chunks"] == 6
    assert snap["counters"]["frames"] > 6 and snap["counters"]["bytes"] > 0


def test_telemetry_counters_flow(cap_dir):
    eng, clk = _engine()
    _drive(eng, clk, windows=2)
    tele = eng.telemetry.counters_snapshot()
    counters = eng.capture.snapshot()["counters"]
    eng.capture.freeze("manual")
    freezes = eng.telemetry.counters_snapshot()["capture_freezes"]
    eng.close()
    assert tele["capture_chunks"] == 2 == counters["chunks"]
    assert 0 < tele["capture_records"] <= counters["frames"]
    assert 0 < tele["capture_bytes"] <= counters["bytes"]
    assert tele["capture_rollovers"] == tele["capture_args_dropped"] == 0
    assert freezes == 1


# --- TestRolloverAndFreeze ---------------------------------------------------


def test_rollover_is_bounded(cap_dir):
    eng, clk = _engine()
    cap = eng.capture
    cap.segment_bytes = 2048  # a roll every couple of chunks
    cap.segments_max = 3
    _drive(eng, clk, windows=30)
    snap = cap.snapshot()
    eng.close()
    assert snap["counters"]["rollovers"] > 3
    assert len(snap["live"]) <= 3
    assert len([f for f in os.listdir(cap_dir) if f.startswith("seg-")]) <= 3
    decoded = pcap.decode_capture(pcap.capture_paths(cap_dir))
    chunks = [ck for k, ck in decoded["stream"] if k == "chunk"]
    assert chunks and any(ck.verdicts is not None for ck in chunks)


def test_manual_freeze_pins_segments(cap_dir):
    eng, clk = _engine()
    _drive(eng, clk, windows=2)
    frozen = eng.capture.freeze("manual")
    assert frozen and all("frozen-manual-" in p for p in frozen)
    _drive(eng, clk, windows=1)  # recording goes on in a fresh segment
    snap = eng.capture.snapshot()
    eng.close()
    assert snap["counters"]["freezes"] == 1
    assert snap["frozen"] and snap["live"]
    _hdr, recs = pcap.read_segment(frozen[0])
    assert recs[-1].rkind == pcap.RK_FREEZE and recs[-1].json()["reason"] == "manual"


def test_breaker_shed_and_degraded_triggers(cap_dir):
    eng, clk = _engine()
    cap = eng.capture
    _drive(eng, clk, windows=1)
    cap.note_breaker_open(["cap-qps"])
    _drive(eng, clk, windows=1)
    cap.note_health({"event": "transition", "to": "DEGRADED"})
    _drive(eng, clk, windows=1)
    cap.shed_streak = 4
    cap.note_shed(3)  # below the streak: no freeze
    assert cap.counters["freezes"] == 2
    cap.note_shed(1)  # crosses it
    snap = cap.snapshot()
    eng.close()
    assert snap["counters"]["freezes"] == 3
    assert {f.split("-")[1] for f in snap["frozen"]} == {"breaker", "degraded", "shed"}
    decoded = pcap.decode_capture(pcap.capture_paths(cap_dir, frozen=True))
    health = [d for k, d in decoded["stream"] if k == "health"]
    assert {"breaker_open"} <= {h.get("event") for h in health}
    assert any(h.get("to") == "DEGRADED" for h in health)


def test_engine_triggers_freeze(cap_dir):
    """The engine's own hooks: a breaker that opens in a fill, the valve's
    shed streak, and a failover trip into DEGRADED each freeze."""
    from sentinel_tpu_torch.testing.faults import FaultInjector

    config.set(config.INGEST_MAX_PENDING, "2")
    config.set(config.CAPTURE_SHED_STREAK, "3")
    config.set(config.FAILOVER_ENABLED, "true")
    eng, clk = _engine()
    eng.set_flow_rules(RULES + [FlowRule("cap-b", count=1e9)])
    eng.set_degrade_rules([DegradeRule("cap-b", grade=2, count=1, time_window=1, min_request_amount=1)])
    b = eng.submit_bulk("cap-b", 2)
    eng.flush()
    eng.submit_exit_bulk(b.rows, 2, rt=5, err=np.ones(2, np.int32), ts=clk.now_ms(), resource="cap-b")
    eng.flush()
    assert eng.capture.counters["freezes"] == 1  # the breaker opened
    ops = [eng.submit_entry("cap-open") for _ in range(5)]  # 3 shed past the bound of 2
    assert eng.capture.counters["freezes"] == 2
    eng.flush()
    inj = FaultInjector().install(eng)
    inj.fail_fetch(eng.flush_seq + 1)
    op = eng.submit_entry("cap-open")
    eng.flush()
    assert op.verdict.degraded and eng.failover.state == "DEGRADED"
    snap = eng.capture.snapshot()
    inj.clear()
    eng.close()
    assert snap["counters"]["freezes"] == 3
    assert {f.split("-")[1] for f in snap["frozen"]} == {"breaker", "shed", "degraded"}
    assert sum(v.verdict.reason == 8 for v in ops) == 3
    decoded = pcap.decode_capture(pcap.capture_paths(cap_dir, frozen=True))
    health = [d for k, d in decoded["stream"] if k == "health"]
    assert [h["event"] for h in health] == ["breaker_open", "failover"]
    assert health[1]["to"] == "DEGRADED"
    # The quarantined chunk's verdicts are the degraded ones, flagged.
    last = [ck for k, ck in decoded["stream"] if k == "chunk" and ck.rows][-1]
    assert last.verdicts[3].tolist() == [frames.F_DEGRADED]


def test_frozen_set_is_trimmed(cap_dir):
    eng, clk = _engine()
    cap = eng.capture
    cap.frozen_max = 2
    for i in range(4):
        _drive(eng, clk, windows=1)
        cap.freeze(f"f{i}")
    frozen = [f for f in os.listdir(cap_dir) if f.startswith("frozen-")]
    eng.close()
    assert len(frozen) <= 2


# --- TestDeathPreservation ---------------------------------------------------


def test_next_boot_preserves_dead_segments(cap_dir):
    """A dead boot leaves live seg-*.cap files; the next boot renames them
    frozen-death-* before it writes a byte, and a torn tail decodes."""
    eng, clk = _engine()
    _drive(eng, clk, windows=3)
    dead_seg = eng.capture._live[-1][1]
    eng.capture.close()  # death: no freeze, the files stay
    eng.close()
    with open(dead_seg, "ab") as f:
        f.write(pcap._REC.pack(pcap.RK_FLUSH, 0, 0, 999, -1, 0, 0))
        f.write(b"{tr")  # the payload cut short
    _hdr, recs = pcap.read_segment(dead_seg)
    assert recs and recs[-1].rkind != 999
    eng2 = Engine(clock=ManualClock(0), device="cpu")
    boot2 = eng2.capture._boot_id
    assert not [f for f in os.listdir(cap_dir) if f.startswith("seg-")
                and pcap.read_segment(os.path.join(cap_dir, f))[0]["boot_id"] != boot2]
    death = sorted(f for f in os.listdir(cap_dir) if f.startswith("frozen-death-"))
    assert death
    decoded = pcap.decode_capture([os.path.join(cap_dir, f) for f in death])
    chunks = [ck for k, ck in decoded["stream"] if k == "chunk"]
    assert len(chunks) == 3 and all(ck.verdicts is not None for ck in chunks)
    eng2.close()


def test_orderly_close_files_as_close(cap_dir):
    eng, clk = _engine()
    _drive(eng, clk, windows=1)
    eng.capture.mark_orderly_close("handoff!")
    eng.close()
    eng2 = Engine(clock=ManualClock(0), device="cpu")
    names = os.listdir(cap_dir)
    eng2.close()
    assert [f for f in names if f.startswith("frozen-close-")]
    assert not [f for f in names if f.startswith("frozen-death-") or f.endswith(".marker")]


# --- the format against the JAX journal --------------------------------------


def _records(cap_dir):
    """Every segment's header and records, read with the JAX reader,
    without the boot id and the wall-ms stamps."""
    out = []
    for path in jcap.capture_paths(cap_dir, frozen=True):
        header, recs = jcap.read_segment(path)
        header = {k: v for k, v in header.items() if k not in ("boot_id", "wall_ms")}
        out.append((os.path.basename(path), header,
                    [(r.rkind, r.flags, r.flush_seq, r.clock_ms, r.payload) for r in recs]))
    return out


def _decoded_stream(cap_dir):
    decoded = jcap.decode_capture(jcap.capture_paths(cap_dir, frozen=True))
    stream = []
    for kind, item in decoded["stream"]:
        if kind == "chunk":
            item = (item.flush_seq, item.now_ms, item.cap_seq, item.rows, item.entries, item.bulk, item.exits,
                    item.bulk_exits, None if item.verdicts is None else [np.asarray(v) for v in item.verdicts])
        elif kind == "close":
            item = {k: v for k, v in item.items() if k != "boot_id"}
        stream.append((kind, item))
    return stream


def _same_stream(lib, depth, tmp):
    """One stream with the journal armed: flow, breaker, param and THREAD
    rules; singles with args and prioritized entries, bulk groups with and
    without args columns, single exits with param rows, bulk exits, a
    reload in mid-stream, a rollover, a breaker that opens and a manual
    freeze. Returns the records and the decoded stream."""
    d = os.path.join(tmp, "cap")  # one path for both: the header's config names it
    shutil.rmtree(d, ignore_errors=True)
    # The header records the runtime config, and a test file run earlier in
    # the same process may have left keys there (tests/test_telemetry.py
    # leaves sentinel.tpu.telemetry.enabled set in the JAX package's): both
    # packages start from an empty one (run_lockstep restores it after).
    with lib.config._lock:
        lib.config._runtime.clear()
    lib.config.set(lib.config.CAPTURE_ENABLED, "true")
    lib.config.set(lib.config.CAPTURE_DIR, d)
    eng = lib.mk(depth=depth)
    eng.capture.segment_bytes = 6000
    st = lib.st
    eng.set_flow_rules([st.FlowRule(f"s{i}", count=12) for i in range(6)] + [st.FlowRule("brk", count=1e9)]
                       + [st.FlowRule("thr", count=4, grade=0)])
    eng.set_degrade_rules([st.DegradeRule("brk", grade=2, count=2, time_window=1, min_request_amount=1)])
    eng.set_param_rules({"s0": [st.ParamFlowRule("s0", param_idx=0, count=3)],
                         "pt": [st.ParamFlowRule("pt", param_idx=0, count=2, grade=0)]})
    clock = lib.clock
    clock.set_ms(1000)
    rng = np.random.default_rng(21)
    held = []
    for step in range(8):
        now = 1000 + 100 * step
        clock.set_ms(now)
        if step == 4:
            eng.set_flow_rules([st.FlowRule(f"s{i}", count=6) for i in range(6)] + [st.FlowRule("brk", count=1e9)]
                               + [st.FlowRule("thr", count=4, grade=0)])
        groups = [eng.submit_bulk(f"s{i}", int(rng.integers(3, 20)), ts=now - int(rng.integers(0, 50)),
                                  origin="o1" if i % 2 else "")
                  for i in range(6)]
        groups.append(eng.submit_bulk("s0", 7, ts=now, args_column=[(f"v{j % 3}",) for j in range(7)]))
        brk = eng.submit_bulk("brk", 3, ts=now)
        singles = [eng.submit_entry("s0", args=("v1",), ts=now), eng.submit_entry("s1", prio=True, ts=now),
                   eng.submit_entry("thr", ts=now, entry_type=lib.C.EntryType.IN),
                   eng.submit_entry("pt", args=(f"p{step % 2}",), ts=now)]
        for op, prows in held:
            eng.submit_exit(op.rows, rt=7, ts=now, resource=op.resource, param_rows=prows)
        held = []
        eng.submit_exit_bulk(brk.rows, 3, rt=np.array([5, 6, 7]), err=np.array([1, 1, 0]), ts=now, resource="brk")
        eng.flush()
        if step == 5:
            eng.capture.freeze("manual")
        for op in singles:
            if op.verdict.admitted and op.resource in ("thr", "pt"):
                held.append((op, op.param_thread_rows))
        clock.set_ms(now + 50)
    eng.flush()
    eng.drain()
    counters = eng.capture.snapshot()["counters"]
    eng.close()
    assert counters["rollovers"] >= 1 and counters["freezes"] >= 2, counters
    return _records(d), _decoded_stream(d), counters


@pytest.mark.parametrize("depth", [0, 2])
def test_same_stream_same_records_as_jax(depth, tmp_path):
    run_lockstep(_same_stream, depth, str(tmp_path))


def test_corpus_decodes_with_the_port_reader_as_with_jax():
    jpaths = jcap.capture_paths(CORPUS, frozen=True)
    assert pcap.capture_paths(CORPUS, frozen=True) == jpaths and len(jpaths) == 3
    for path in jpaths:
        jh, jr = jcap.read_segment(path)
        ph, pr = pcap.read_segment(path)
        assert jh == ph
        assert [(r.rkind, r.flags, r.flush_seq, r.clock_ms, r.wall_ms, r.payload, r.name) for r in jr] == \
            [(r.rkind, r.flags, r.flush_seq, r.clock_ms, r.wall_ms, r.payload, r.name) for r in pr]
        assert pcap._segment_boot_id(path) == jcap._segment_boot_id(path) == jh["boot_id"]
        assert pcap.read_header(path) == jh
    jd = jcap.decode_capture(jpaths)
    pd = pcap.decode_capture(jpaths)
    assert pd["header"] == jd["header"]
    assert sorted(pd["chunks"]) == sorted(jd["chunks"])
    assert len(pd["stream"]) == len(jd["stream"])
    for (jk, ji), (pk, pi) in zip(jd["stream"], pd["stream"]):
        assert jk == pk
        if jk != "chunk":
            assert ji == pi
            continue
        for f in ("flush_seq", "now_ms", "cap_seq", "rows", "entries", "exits"):
            assert getattr(ji, f) == getattr(pi, f), f
        assert all(isinstance(g, pcap.BulkRows) for g in pi.bulk)
        assert ji.bulk == [list(g) for g in pi.bulk]
        assert ji.bulk_exits == [_exit_dicts(gx) for gx in pi.bulk_exits]
        assert (ji.verdicts is None) == (pi.verdicts is None)
        if ji.verdicts is not None:
            for a, b in zip(ji.verdicts, pi.verdicts):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def _exit_dicts(gx):
    """A :class:`BulkExitRows` as the JAX reader's row dicts."""
    return [{"rows": gx.rows, "thr": gx.thr, "ts": int(gx.ts[i]), "rt": int(gx.rt[i]), "count": int(gx.count[i]),
             "err": int(gx.err[i]), "resource": gx.resource, "p_rows": ()} for i in range(len(gx))]


@pytest.mark.parametrize("with_args", [False, True])
def test_columnar_spills_are_the_row_encoders_bytes(with_args):
    """The journal's bulk spill (``encode_entry_groups``, one call a chunk)
    and bulk-exit spill (``encode_exit_columns``) against the row encoders
    the JAX journal calls, a group at a time."""
    rng = np.random.default_rng(3)
    ns = [5, 0, 12, 20]
    ts = rng.integers(0, 5000, sum(ns))
    acq = rng.integers(1, 4, sum(ns))
    interns = [(1, b"res"), (2, "ctxé".encode())]
    metas = [(1, 1, 2, 0, interns), (0, 3, 2, 0, []), (0x41, 4, 5, 6, [(4, b"x")]), (1, 1, 2, 3, [])]
    args = [[frames.encode_args((f"v{i % 4}", i)) if with_args and i % 3 else b"" for i in range(n)] for n in ns]
    groups = [m + (a if with_args and k % 2 == 0 else None,) for k, (m, a) in enumerate(zip(metas, args))]
    got = frames.encode_entry_groups(0, 70, ns, ts, acq, groups, 9)
    lo = 0
    for n, (et, rid, cid, oid, fresh, a), frame in zip(ns, groups, got):
        rows = [frames.EntryRow(seq=70 + lo + i, resource_id=rid, context_id=cid, origin_id=oid, entry_type=et,
                                acquire=int(acq[lo + i]), ts=int(ts[lo + i]), trace=frames.EMPTY_TRACE,
                                args=a[i] if a is not None else b"") for i in range(n)]
        assert frame == frames.encode_entries(0, rows, fresh, 9, 0, kind=frames.KIND_BULK)
        lo += n
    n = 37
    ts, rt, count, err = rng.integers(0, 5000, n), rng.integers(0, 300, n), np.ones(n, np.int64), rng.integers(0, 2, n)
    seq = pcap._pack_exit_seq(-1, 1)
    xrows = [frames.ExitRow(seq=seq, resource_id=3, context_id=4, origin_id=-1, entry_type=-1, ts=int(ts[i]),
                            rt=int(rt[i]), count=1, err=int(err[i]), spec=0) for i in range(n)]
    assert frames.encode_exit_columns(0, seq, 3, 4, -1, -1, ts, rt, count, err, interns, 4) == \
        frames.encode_exits(0, xrows, interns, 4, 0)


# --- the kill (tests/test_capture_chaos.py's case, without the supervisor) ---


@pytest.mark.mp
def test_sigkill_leaves_segments_the_next_boot_keeps_and_replay_verifies(tmp_path):
    import multiprocessing
    import signal

    from sentinel_tpu_torch.runtime import replay
    from sentinel_tpu_torch.testing import capture_procs

    cap_dir = str(tmp_path / "blackbox")
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=capture_procs.record_until_killed, args=(cap_dir, q, 6), daemon=True)
    p.start()
    try:
        assert q.get(timeout=120) == "ready"
    finally:
        os.kill(p.pid, signal.SIGKILL)
        p.join(timeout=30)
    assert p.exitcode == -signal.SIGKILL
    dead = [f for f in os.listdir(cap_dir) if f.startswith("seg-")]
    assert dead
    config.set(config.CAPTURE_ENABLED, "true")
    config.set(config.CAPTURE_DIR, cap_dir)
    try:
        eng = Engine(clock=ManualClock(0), device="cpu")  # the next boot
        boot2 = eng.capture._boot_id
        eng.close()
    finally:
        config.reset()
    files = sorted(os.listdir(cap_dir))
    death = [f for f in files if f.startswith("frozen-death-")]
    assert len(death) == len(dead), files
    boots = set()
    for fn in files:
        header, recs = pcap.read_segment(os.path.join(cap_dir, fn))  # a torn tail ends cleanly
        boots.add(header["boot_id"])
        assert all(r.rkind in pcap._RECORD_NAMES for r in recs)
    assert len(boots) == 2 and boot2 in boots
    decoded = pcap.decode_capture([os.path.join(cap_dir, f) for f in death])
    chunks = [ck for k, ck in decoded["stream"] if k == "chunk"]
    assert len(chunks) >= 6
    report = replay.verify(decoded, depth=0, device="cpu")
    assert report["diffs"] == 0, report
    assert report["compared"] > 0 and report["compared"] + report["no_captured_verdict"] == report["rows"], report


def test_bulk_args_spill_keeps_each_value_type(cap_dir):
    """The bulk spill encodes each distinct args tuple once a chunk; tuples
    that compare equal across types ((1,), (True,), (1.0,)), nested ones,
    lists and empty rows each decode back as given."""
    col = [(1,), (True,), (1.0,), ("a",), ["b", 2], (("x", 1),), (("x", True),), (), ("a",), (None,)]
    eng, clk = _engine()
    eng.submit_bulk("cap-open", len(col), args_column=col)
    eng.submit_bulk("cap-open", 2, args_column=[(1,), (True,)])
    eng.flush()
    eng.close()
    ck = next(ck for k, ck in jcap.decode_capture(jcap.capture_paths(cap_dir))["stream"] if k == "chunk" and ck.rows)
    got = [[e["args"] for e in g] for g in ck.bulk]
    want = [[tuple(t) for t in col], [(1,), (True,)]]
    assert got == want
    assert [[tuple(type(v) for v in a) for a in g] for g in got] == [[tuple(type(v) for v in a) for a in g]
                                                                   for g in want]


# --- TestCaptureCommand ------------------------------------------------------


def test_capture_command_disabled_and_armed(pair, tmp_path):
    """The command off, then armed over two windows of _drive's traffic:
    the same answers from both packages but the journal's paths, boot id
    and segment byte count (its header's wall stamps vary in length); the
    freeze on demand; the capture families in the scrape."""
    from torch_transport_env import comparable

    CommandRequest = pair.port.handlers.CommandRequest
    offs = [json.loads(p.handlers.capture_handler(CommandRequest(path="capture", params={}, body="")).result)
            for p in pair.sides]
    assert offs[0] == offs[1] and offs[1]["enabled"] is False
    for p in pair.sides:
        p.config.set(p.config.CAPTURE_ENABLED, "true")
        p.config.set(p.config.CAPTURE_DIR, str(tmp_path / p.name / "cmdcap"))
    pair.reset()
    drop = ("dir", "boot_id", "live", "frozen", "frozen_now", "segment_bytes")
    got = []
    for p in pair.sides:
        eng = p.engine
        eng.set_flow_rules([p.st.FlowRule(r.resource, count=r.count) for r in RULES])
        verdicts = _drive(eng, p.clock, windows=2)
        d = json.loads(p.handlers.capture_handler(CommandRequest(path="capture", params={}, body="")).result)
        assert d["enabled"] is True and d["counters"]["chunks"] == 2 and d["live"]
        f = json.loads(p.handlers.capture_handler(
            CommandRequest(path="capture", params={"freeze": "oncall page!"}, body="")).result)
        assert f["frozen_now"] and all(n.startswith("frozen-oncallpage-") for n in f["frozen_now"])
        text = p.prom.render_metrics(eng)
        assert "_capture_enabled 1" in text and "_capture_freezes_total" in text
        got.append((verdicts, {k: v for k, v in d.items() if k not in drop},
                    {k: v for k, v in f.items() if k not in drop}, len(f["frozen_now"]),
                    [ln for ln in comparable(text) if "_capture_" in ln]))
    assert got[0] == got[1]
