"""The port's span journal (sentinel_tpu_torch/metrics/spans.py) against
the JAX package's (sentinel_tpu/metrics/spans.py): the cases of
tests/test_spans.py's TestSpanJournal run on both journals and their
spans, snapshots, spill files and loads agree (pid and wall times aside);
then the spans of the port's ipc plane and client: admit spans pin against
the engine's frame spans, the traceparent rides the admit span, and
``sentinel.tpu.spans.enabled`` only observes (verdicts equal off and on);
and across a real spawn, a worker's admit spans land inside the engine's
frame spans on the shared wall-ms ruler. Tolerance: exact equality."""

from __future__ import annotations

import json
import os

import pytest

from sentinel_tpu.metrics import spans as jspans
from sentinel_tpu.utils.config import config as jconfig
from sentinel_tpu_torch.ipc.plane import IngestPlane
from sentinel_tpu_torch.ipc.worker import IngestClient
from sentinel_tpu_torch.metrics import spans as tspans
from sentinel_tpu_torch.metrics.spans import get_journal, load_journal, reset_journal, wall_ms
from sentinel_tpu_torch.models.rules import FlowRule
from sentinel_tpu_torch.runtime.engine import Engine
from sentinel_tpu_torch.testing import ipc_procs
from sentinel_tpu_torch.utils.config import config

BOTH = pytest.mark.parametrize("mod", [jspans, tspans], ids=["jax", "port"])


@pytest.fixture(autouse=True)
def _sandbox():
    saved = []
    for c in (config, jconfig):
        with c._lock:
            saved.append(dict(c._runtime))
    reset_journal()
    jspans.reset_journal()
    yield
    for c, s in zip((config, jconfig), saved):
        with c._lock:
            c._runtime.clear()
            c._runtime.update(s)
    reset_journal()
    jspans.reset_journal()


def _journal_script(mod, base_dir):
    """One script of records, rings, ruler beats and spills on ``mod``'s
    journal; returns what a reader sees at each point."""
    spj = mod.SpanJournal(role="worker", enabled=True, ring=4, spill_every=0, base_dir=base_dir)
    out = []
    spj.record("admit", "worker", 1000.12349, 2.5, wid=3, seq=7, trace=None, adm=1)
    spj.record("neg", "worker", 10.0, -3.0)
    out.append(spj.spans())
    for i in range(40):
        spj.record("x", "engine" if i % 3 else "worker", float(i), 0.1, seq=i)
    out.append(spj.spans())
    out.append(spj.spans(cat="engine"))
    snap = spj.snapshot()
    out.append({k: v for k, v in snap.items() if k != "pid"})
    spj.note_ruler(mod.wall_ms() - 40.0)
    path = spj.spill()
    out.append(os.path.basename(path).replace(str(os.getpid()), "PID"))
    out.append(spj.spill())  # nothing left to write
    spj.record("b", "worker", 2.0, 0.1)
    assert spj.spill() == path  # appended to the same file
    loaded = mod.load_journal(path)
    meta = loaded["meta"]
    out.append((meta["role"], meta["meta"], 35.0 <= meta["ruler_off_ms"] <= 45.0))
    out.append(loaded["spans"])
    out.append({k: v for k, v in spj.snapshot().items() if k != "pid"})
    auto = mod.SpanJournal(role="w", enabled=True, ring=64, spill_every=3, base_dir=base_dir)
    for i in range(3):
        auto.record("x", "worker", float(i), 0.1)
    out.append((auto.snapshot()["spilled_total"], auto.snapshot()["buffered"]))
    return out


def test_journal_cases_equal(tmp_path):
    """Records round and drop None fields, a negative duration clamps to
    0, the ring's floor is 16, the category filter, the snapshot, the
    spill with its ruler offset, the append, the auto spill: the same on
    both journals."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    want = _journal_script(jspans, str(jdir))
    got = _journal_script(tspans, str(tdir))
    assert got == want
    assert got[0][0] == {"name": "admit", "cat": "worker", "t0": 1000.123, "dur": 2.5, "wid": 3, "seq": 7,
                         "adm": 1}
    assert got[0][1]["dur"] == 0.0 and len(got[1]) == 16 and got[1][0]["seq"] == 24


def test_spill_file_lines_equal(tmp_path):
    """A spill written by the port reads line for line as the JAX
    journal's (meta keys, span keys), and each package loads the other's."""
    files = {}
    for mod, sub in ((jspans, "jax"), (tspans, "port")):
        spj = mod.SpanJournal(role="engine", enabled=True, ring=64, spill_every=0, base_dir=str(tmp_path / sub))
        spj.record("drain", "engine", 500.0, 1.25, frames=2, rows=9)
        spj.record("frame", "engine", 500.0, 1.25, wid=1, seq_lo=3, seq_hi=5, rows=3)
        files[sub] = spj.spill()
    jl = [json.loads(x) for x in open(files["jax"])]
    tl = [json.loads(x) for x in open(files["port"])]
    assert [sorted(x) for x in jl] == [sorted(x) for x in tl]
    assert jl[1:] == tl[1:]
    assert tspans.load_journal(files["jax"])["spans"] == jspans.load_journal(files["port"])["spans"] == jl[1:]


@BOTH
def test_load_skips_malformed_tail(mod, tmp_path):
    path = tmp_path / "crash.jsonl"
    path.write_text(
        json.dumps({"meta": 1, "role": "w", "pid": 1}) + "\n"
        + json.dumps({"name": "a", "cat": "worker", "t0": 1.0, "dur": 0.1}) + "\n"
        + '["not a span"]\n' + '{"no_name": 1}\n' + '{"name": "trunc", "t0": 2.'
    )
    loaded = mod.load_journal(str(path))
    assert loaded["meta"]["role"] == "w" and [s["name"] for s in loaded["spans"]] == ["a"]


def test_get_journal_first_role_wins_and_reset_rereads_config():
    assert get_journal("shard").role == "shard"
    assert get_journal("worker").role == "shard"  # one journal a process
    assert get_journal().enabled is False  # the default config
    reset_journal()
    config.set(config.SPANS_ENABLED, "true")
    config.set(config.SPANS_RING, "32")
    spj = get_journal("worker")
    assert spj.role == "worker" and spj.enabled is True and spj.snapshot()["ring"] == 32


def test_spill_path_in_the_log_dir(tmp_path):
    config.set(config.LOG_DIR, str(tmp_path))
    spj = tspans.SpanJournal(role="engine", enabled=True)
    assert spj.spill_path() == os.path.join(str(tmp_path), f"{config.app_name}-spans-engine-{os.getpid()}.jsonl")


# ---------------------------------------------------------------------------
# the plane's and the client's spans
# ---------------------------------------------------------------------------
def _plane(count=1e9):
    eng = Engine(initial_rows=256, device="cpu")
    eng.set_flow_rules([FlowRule(resource="span-res", count=count)])
    plane = IngestPlane(eng)
    return eng, plane, IngestClient(plane.channel(0), 0)


def _close(eng, plane, cli):
    cli.close()
    plane.close()
    eng.close()


def test_admit_and_frame_spans_correlate():
    config.set(config.SPANS_ENABLED, "true")
    eng, plane, cli = _plane()
    try:
        for _ in range(4):
            assert cli.entry("span-res").admitted
        spj = get_journal()
        admits = [s for s in spj.spans(cat="worker") if s["name"] == "admit"]
        frames = [s for s in spj.spans(cat="engine") if s["name"] == "frame"]
        drains = [s for s in spj.spans(cat="engine") if s["name"] == "drain"]
        assert len(admits) == 4 and drains and frames
        for a in admits:
            assert a["wid"] == 0 and a["adm"] == 1 and a["win"] == 0 and a["push_ms"] >= 0.0
            assert a["t0"] <= a["v"] <= a["t0"] + a["dur"] + 0.002
            (f,) = [f for f in frames if f["wid"] == 0 and f["seq_lo"] <= a["seq"] <= f["seq_hi"]]
            assert a["t0"] <= f["t0"] + 0.002 and a["v"] >= f["t0"] - 0.002
        assert all(d["frames"] >= 1 and d["rows"] >= 1 for d in drains)
    finally:
        _close(eng, plane, cli)


def test_traceparent_rides_the_admit_span():
    from sentinel_tpu_torch.core.context import ContextUtil
    from sentinel_tpu_torch.metrics.admission_trace import parse_traceparent

    config.set(config.SPANS_ENABLED, "true")
    eng, plane, cli = _plane()
    try:
        ContextUtil.set_trace(parse_traceparent("00-0123456789abcdef0123456789abcdef-00f067aa0ba902b7-01"))
        cli.entry("span-res")
        ContextUtil.set_trace(None)
        (a,) = [s for s in get_journal().spans(cat="worker") if s["name"] == "admit"]
        assert a["trace"] == "0123456789abcdef0123456789abcdef"
    finally:
        ContextUtil.set_trace(None)
        _close(eng, plane, cli)


def test_disabled_records_nothing_and_verdicts_equal(tmp_path):
    """The journal only observes: the verdict stream is the same with it
    off and on, and off it records nothing."""

    def drive():
        eng, plane, cli = _plane(count=3)
        out = []
        try:
            for _ in range(6):
                v = cli.entry("span-res")
                out.append((v.admitted, int(v.reason), v.wait_ms, v.limit_type, v.degraded, v.speculative))
            a, r, w, f = cli.bulk("span-res", 4)
            out.append((a.tolist(), r.tolist(), w.tolist(), f.tolist()))
        finally:
            _close(eng, plane, cli)
        return out

    off = drive()
    assert get_journal().snapshot()["recorded_total"] == 0
    config.set(config.SPANS_ENABLED, "true")
    config.set(config.SPANS_DIR, str(tmp_path))
    reset_journal()
    on = drive()
    assert get_journal().snapshot()["recorded_total"] > 0
    assert on == off


@pytest.mark.mp
def test_worker_span_pins_inside_engine_frame(tmp_path):
    """A spawned worker's admit spans align with this engine's frame spans
    on the shared wall-ms ruler (the property a merged fleet timeline
    rests on)."""
    config.set(config.SPANS_ENABLED, "true")
    config.set(config.SPANS_DIR, str(tmp_path))
    eng = Engine(initial_rows=256, device="cpu")
    eng.set_flow_rules([FlowRule(resource="mp-span-res", count=1e9)])
    plane = IngestPlane(eng)
    cfg = {config.SPANS_ENABLED: "true", config.SPANS_DIR: str(tmp_path)}
    ctx = plane.spawn_context()
    q = ctx.Queue()
    p = ctx.Process(target=ipc_procs.run_entries_spanned, args=(plane.channel(0), 0, cfg, "mp-span-res", 6, q),
                    daemon=True)
    p.start()
    try:
        tag, wid, verdicts, child_path = q.get(timeout=50)
        assert tag == "done" and wid == 0 and all(adm and not deg for adm, _r, deg in verdicts)
        p.join(timeout=20)
        child = load_journal(child_path)
        assert child["meta"]["role"] == "worker" and abs(child["meta"].get("ruler_off_ms", 0.0)) < 5000.0
        admits = [s for s in child["spans"] if s["name"] == "admit"]
        assert len(admits) == 6
        frames = [s for s in get_journal().spans(cat="engine") if s["name"] == "frame" and s["wid"] == 0]
        for a in admits:
            (f,) = [f for f in frames if f["seq_lo"] <= a["seq"] <= f["seq_hi"]]
            assert a["t0"] <= f["t0"] + 2.0
            assert f["t0"] - 2.0 <= a["v"] <= f["t0"] + f["dur"] + 1000.0
        assert abs(wall_ms() - child["meta"]["wall_ms"]) < 60000.0
    finally:
        if p.is_alive():
            p.terminate()
        p.join(timeout=10)
        plane.close()
        eng.close()
