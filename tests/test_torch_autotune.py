"""The port's autotuner (sentinel_tpu_torch/runtime/autotune.py) against
the JAX package's, on the CPU.

The pure decisions (``decide_depth``, ``decide_window``, ``pick_path``,
``ParamPathMemo``) run on the same seeded synthetic snapshots through
both packages: every decision must be identical. The engine cases of
tests/test_autotune.py run in lockstep (tests/torch_lockstep.py): the
runtime depth flip 2 -> 0 -> 2 against the depth-0 oracle, "enabled is
verdict parity", ``_apply_depth``, "blind without telemetry", the window
retune, the param seed file (good, bad, missing) and the force-path
seam. A live tuner decides from wall times, which differ between the
two runs, so there only the verdicts and state are compared across
packages (each run also holds its tuned engine against its static one);
decisions taken on synthetic snapshots are compared exactly.

The ``autotune`` command and the Prometheus families run here since the
control surface's port (ROADMAP item 11, part 1), on an idle tuner: the
command's answer and the scrape's lines equal but the wall-time families
(tests/torch_transport_env.py). Left out: the convergence of a live tuner
on wall-clock timings, which ``chip_smoke.py`` phase 4h (c) drives on the
card."""

import json

import numpy as np
import pytest

from torch_lockstep import canon, run_lockstep

from sentinel_tpu.runtime import autotune as jat
from sentinel_tpu_torch.runtime import autotune as tat


def _snaps(mod, seed, n=1500):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        depth = int(rng.integers(0, 6))
        out.append(mod.TuneSnapshot(
            now_ms=int(rng.integers(0, 10**6)), depth=depth, flushes=int(rng.integers(0, 20)),
            mean_inflight=float(rng.uniform(0, depth + 0.5)), encode_ms=float(rng.exponential(10.0)),
            dispatch_ms=float(rng.exponential(2.0)), settle_ms=float(rng.exponential(8.0) * rng.integers(0, 2)),
            drain_ms=float(rng.exponential(8.0) * rng.integers(0, 2)), shed=int(rng.integers(0, 3) // 2),
            window_armed=bool(rng.integers(0, 4)), window_reqs=int(rng.integers(0, 5000)),
            window_flushes=int(rng.integers(0, 8)), window_ms=float(rng.choice([0.25, 0.5, 2.0, 4.0, 20.0, 30.0])),
            window_batch_max=int(rng.choice([0, 1, 64, 256, 4096])), window_fanout_ms=float(rng.exponential(6.0)),
        ))
    return out


def _limits(mod, seed):
    rng = np.random.default_rng(seed + 100)
    return [mod.TuneLimits(), mod.TuneLimits(depth_max=2, min_flushes=1, idle_ticks=1, window_batch_cap=512,
                                            window_ms_min=float(rng.uniform(0.25, 2.0)))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decisions_match_jax(seed):
    got = []
    for mod in (jat, tat):
        out = []
        for lim in _limits(mod, seed):
            streak = 0
            for s in _snaps(mod, seed):
                d, reason, streak = mod.decide_depth(s, lim, streak)
                out.append((d, reason, streak, mod.decide_window(s, lim), s.occupancy, s.host_ms, s.device_wait_ms))
        got.append(out)
    assert got[0] == got[1]
    reasons = {o[1] for o in got[1]}
    assert {"insufficient-samples", "ingest-pressure", "drain-stall", "hide-device-wait", "at-max",
            "underutilized"} <= reasons


@pytest.mark.parametrize("seed", [0, 1])
def test_pick_path_and_memo_match_jax(seed):
    got = []
    for mod in (jat, tat):
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(400):
            c, s = mod.PathStats(), mod.PathStats()
            for _ in range(int(rng.integers(0, 5))):
                c.note(float(rng.exponential(1.0)))
            for _ in range(int(rng.integers(0, 5))):
                s.note(float(rng.exponential(1.0)))
            out.append(mod.pick_path(c, s, int(rng.choice([mod.PATH_CLOSED, mod.PATH_SCAN])),
                                     int(rng.integers(1, 4)), float(rng.uniform(0, 0.5))))
        memo = mod.ParamPathMemo(explore=2, margin=0.15)
        for _ in range(600):
            b = mod.ParamPathMemo.bucket_of(int(rng.integers(1, 5000)), int(rng.integers(1, 9)))
            p, why = memo.pick(b)
            memo.note(b, p, float(rng.exponential(1.0 if p == mod.PATH_CLOSED else 1.3)))
            out.append((b, p, why))
        memo.seed((8, 1), 1.0, 2.0)
        out.append(memo.snapshot())
        got.append(json.dumps(out))
    assert got[0] == got[1]


# --- the engine, in lockstep -------------------------------------------------


def _load_rules(lib, engines):
    for eng in engines:
        eng.set_flow_rules([lib.st.FlowRule("pp", count=6.0), lib.st.FlowRule("qq", count=1e9)])
        eng.set_param_rules({"qq": [lib.st.ParamFlowRule("qq", param_idx=0, count=3)]})


def _mixed_stream(lib, engines, rounds, seed, on_round=None):
    rng = np.random.default_rng(seed)
    collected = [[] for _ in engines]
    t = 1000
    for r in range(rounds):
        lib.clock.set_ms(t)
        ts_pp = np.sort(t + rng.integers(0, 40, 16).astype(np.int32))
        acq = rng.integers(1, 3, 16).astype(np.int32)
        vals = [f"v{int(rng.integers(0, 3))}" for _ in range(12)]
        ts_qq = np.where(np.arange(12) < rng.integers(1, 12), np.int32(t), np.int32(t + 700)).astype(np.int32)
        for eng, coll in zip(engines, collected):
            g1 = eng.submit_bulk("pp", 16, ts=ts_pp, acquire=acq)
            g2 = eng.submit_bulk("qq", 12, ts=ts_qq, args_column=[(v,) for v in vals])
            eng.flush()
            assert len(eng._pending_fetches) <= eng.pipeline_depth
            coll.extend([g1, g2])
        if on_round is not None:
            on_round(r)
        t += int(rng.integers(100, 900))
    for eng in engines:
        eng.drain()
    return [[(g.admitted, g.reason, g.wait_ms) for g in coll] for coll in collected]


def _flip(lib):
    engines = [lib.mk(depth=0), lib.mk(depth=2)]
    _load_rules(lib, engines)

    def on_round(r):
        if r == 2:
            engines[1].set_depth(0)
            assert len(engines[1]._pending_fetches) == 0 and engines[1].pipeline_depth == 0
        elif r == 4:
            engines[1].set_depth(2)
            assert engines[1].pipeline_depth == 2

    got = _mixed_stream(lib, engines, 8, 12, on_round)
    assert canon(got[0]) == canon(got[1])
    for res in ("pp", "qq"):
        assert engines[1].cluster_node_stats(res) == engines[0].cluster_node_stats(res)
    return got[1], lib.states(engines[1])


def test_depth_flip_2_0_2_matches_depth0_oracle():
    run_lockstep(_flip)


def _arena(lib):
    eng = lib.mk(depth=0)
    eng.set_depth(3)
    assert eng.pipeline_depth == 3 and eng._arena.per_key >= 4
    eng.set_depth(1)
    return eng.pipeline_depth, eng._arena.per_key >= 4


def test_set_depth_raise_resizes_arena():
    run_lockstep(_arena)


def _path_counters(lib):
    eng = lib.mk()
    eng.set_flow_rules([lib.st.FlowRule("mx", count=1e9)])
    eng.set_param_rules({"mx": [lib.st.ParamFlowRule("mx", param_idx=0, count=3)]})
    lib.clock.set_ms(1000)
    out = []
    for ts in ((1000 + np.arange(12) * 100).astype(np.int32), np.full(8, 1000, np.int32)):
        g = eng.submit_bulk("mx", len(ts), ts=ts, args_column=[("k",)] * len(ts))
        eng.flush()
        eng.drain()
        c = eng.telemetry.counters_snapshot()
        out.append((g.admitted, g.reason, c["param_closed_form"], c["param_scan"]))
    assert [o[2:] for o in out] == [(0, 1), (1, 1)]  # past the segment bound: scan; one ts: the rank path
    return out


def test_param_path_counters():
    run_lockstep(_path_counters)


def _disabled_by_default(lib):
    eng = lib.mk()
    assert eng.autotune.enabled is False and eng.autotune.param_active is False
    eng.set_flow_rules([lib.st.FlowRule("d", count=10.0)])
    for _ in range(3):
        eng.submit_entry("d")
        eng.flush()
    eng.drain()
    snap = eng.autotune.snapshot()
    assert snap["counters"]["ticks"] == 0 and snap["decisions"] == []
    assert eng.telemetry.counters_snapshot()["autotune_decisions"] == 0
    return snap


def test_disabled_by_default():
    run_lockstep(_disabled_by_default)


def _verdict_parity(lib, depth):
    static = lib.mk(depth=depth, AUTOTUNE_ENABLED="false")
    tuned = lib.mk(depth=depth, AUTOTUNE_ENABLED="true", AUTOTUNE_INTERVAL_MS=1, AUTOTUNE_COOLDOWN_MS=1,
                   AUTOTUNE_MIN_FLUSHES=1, AUTOTUNE_PARAM_EXPLORE=1)
    assert tuned.autotune.enabled and tuned.autotune.param_active and not static.autotune.enabled
    engines = [static, tuned]
    _load_rules(lib, engines)
    got = _mixed_stream(lib, engines, 10, 7)
    assert canon(got[0]) == canon(got[1])
    assert tuned.autotune.counters["ticks"] > 0
    memo = tuned.autotune.memo.snapshot()
    assert memo and all(b["closed_n"] >= 1 and b["scan_n"] >= 1 for b in memo if b["closed_n"] + b["scan_n"] > 2)
    for res in ("pp", "qq"):
        assert tuned.cluster_node_stats(res) == static.cluster_node_stats(res)
    return got[1], lib.states(tuned)


@pytest.mark.parametrize("depth", [0, 2])
def test_enabled_is_verdict_parity(depth):
    run_lockstep(_verdict_parity, depth)


def _apply_depth(lib):
    eng = lib.mk(AUTOTUNE_ENABLED="true")
    at = eng.autotune
    mod = __import__(type(at).__module__, fromlist=["TuneSnapshot"])

    def snap(**kw):
        base = dict(now_ms=1000, depth=0, flushes=16, mean_inflight=0.0, encode_ms=16.0, dispatch_ms=4.0,
                    settle_ms=0.0, drain_ms=0.0, shed=0)
        base.update(kw)
        return mod.TuneSnapshot(**base)

    at._apply_depth(snap(now_ms=5000, depth=0, settle_ms=30.0, encode_ms=10.0))
    assert eng.pipeline_depth == 1
    dec = list(at.decisions)[-1]
    assert dec["knob"] == "depth" and (dec["from"], dec["to"]) == (0, 1) and dec["reason"] == "hide-device-wait"
    assert eng.telemetry.counters_snapshot()["autotune_decisions"] == 1
    at._apply_depth(snap(now_ms=5001, depth=1, mean_inflight=1.0, drain_ms=30.0, encode_ms=10.0))
    assert eng.pipeline_depth == 1  # the cooldown holds
    at._apply_depth(snap(now_ms=5000 + at.cooldown_ms, depth=1, mean_inflight=1.0, drain_ms=15.0, encode_ms=10.0))
    assert eng.pipeline_depth == 2
    at._apply_depth(snap(now_ms=9000, depth=2, shed=3))
    assert eng.pipeline_depth == 1
    return list(at.decisions), at.counters, eng.telemetry.counters_snapshot()["autotune_decisions"]


def test_apply_depth_moves_engine_and_logs():
    run_lockstep(_apply_depth)


def _blind(lib):
    eng = lib.mk(AUTOTUNE_ENABLED="true", TELEMETRY_ENABLED="false")
    assert eng.autotune.blind is True and eng.autotune.param_active is False
    eng.autotune.maybe_tick(10_000)
    assert eng.autotune.counters["ticks"] == 0 and eng.autotune.snapshot()["blind"] is True
    return eng.autotune.snapshot()


def test_blind_without_telemetry():
    run_lockstep(_blind)


def _window_retune(lib):
    eng = lib.mk(INGEST_BATCH_WINDOW_MS=2, AUTOTUNE_ENABLED="true")
    w = eng.ingest_window
    w.retune(window_ms=4.0, batch_max=512)
    assert (w.window_ms, w.batch_max) == (4.0, 512)
    w.retune(window_ms=0.0)
    assert w.window_ms == 4.0
    at = eng.autotune
    mod = __import__(type(at).__module__, fromlist=["TuneSnapshot"])
    at._apply_window(mod.TuneSnapshot(now_ms=3000, window_armed=True, window_reqs=1024, window_flushes=2,
                                      window_ms=4.0, window_batch_max=512, window_fanout_ms=1.0))
    at._apply_window(mod.TuneSnapshot(now_ms=9000, window_armed=True, window_reqs=10, window_flushes=2,
                                      window_ms=4.0, window_batch_max=1024, window_fanout_ms=1.0))
    return w.snapshot(), list(at.decisions), at.counters


def test_window_retune_applies():
    run_lockstep(_window_retune)


def _tick_keeps_pipeline_stats(lib):
    eng = lib.mk(depth=2, AUTOTUNE_ENABLED="true", AUTOTUNE_INTERVAL_MS=1, AUTOTUNE_MIN_FLUSHES=1,
                 AUTOTUNE_DEPTH_MAX=2)
    eng.set_flow_rules([lib.st.FlowRule("ps", count=1e9)])
    t = 1000
    groups = []
    for _ in range(6):
        lib.clock.set_ms(t)
        groups.append(eng.submit_bulk("ps", 32, ts=np.full(32, t, np.int32)))
        eng.flush()
        t += 500
    eng.drain()
    assert eng.autotune.counters["ticks"] > 1 and eng.pipeline_stats()["dispatches"] >= 6
    return [g.admitted for g in groups], lib.states(eng)


def test_tick_does_not_reset_pipeline_stats():
    run_lockstep(_tick_keeps_pipeline_stats)


def _seed_file(tmp_path, buckets):
    p = tmp_path / "seed.json"
    p.write_text(json.dumps({"format": "sentinel-param-seed-v1", "buckets": buckets}))
    return str(p)


def _seeded(lib, path):
    eng = lib.mk(AUTOTUNE_ENABLED="true", AUTOTUNE_PARAM_SEED_FILE=path)
    at = eng.autotune
    mod = __import__(type(at).__module__, fromlist=["PATH_CLOSED"])
    assert at.seeded_buckets == 2
    picks = [at.memo.pick((256, 1)), at.memo.pick((1024, 2)), at.memo.pick((1024, 2)), at.memo.pick((64, 1))]
    assert picks[:3] == [(mod.PATH_CLOSED, "cost-hold"), (mod.PATH_SCAN, "cost-switch"), (mod.PATH_SCAN, "cost-hold")]
    assert picks[3][1].startswith("explore") and at.snapshot()["param_seed_buckets"] == 2
    return picks, at.memo.snapshot()


def test_seeded_memo_starts_committed(tmp_path):
    path = _seed_file(tmp_path, [{"rows_bucket": 256, "segments": 1, "closed_ms": 1.0, "scan_ms": 5.0},
                                 {"rows_bucket": 1024, "segments": 2, "closed_ms": 9.0, "scan_ms": 2.0}])
    run_lockstep(_seeded, path)


def _bad_seed(lib, path, want):
    eng = lib.mk(AUTOTUNE_ENABLED="true", AUTOTUNE_PARAM_SEED_FILE=path)
    assert eng.autotune.seeded_buckets == want
    return eng.autotune.memo.snapshot()


@pytest.mark.parametrize("case", ["missing", "bad_json", "not_a_list", "mixed"])
def test_bad_or_missing_seed_file_is_ignored(tmp_path, case):
    if case == "missing":
        path, want = str(tmp_path / "nope.json"), 0
    elif case == "bad_json":
        (tmp_path / "bad.json").write_text("{not json")
        path, want = str(tmp_path / "bad.json"), 0
    elif case == "not_a_list":
        (tmp_path / "scalar.json").write_text("7")
        path, want = str(tmp_path / "scalar.json"), 0
    else:
        path = _seed_file(tmp_path, [{"rows_bucket": 8, "segments": 1, "closed_ms": 1.0, "scan_ms": 2.0},
                                     {"rows_bucket": "x"}, {"closed_ms": -1}])
        want = 1
    run_lockstep(_bad_seed, path, want)


def _force_path(lib):
    eng = lib.mk(AUTOTUNE_ENABLED="true", AUTOTUNE_PARAM_EXPLORE=1)
    eng.set_param_rules({"mx": [lib.st.ParamFlowRule("mx", param_idx=0, count=3)]})
    lib.clock.set_ms(1000)
    out = []
    for force, key in (("scan", "param_scan"), ("closed", "param_closed_form"), ("scan", "param_scan")):
        eng.param_force_path = force
        g = eng.submit_bulk("mx", 8, ts=np.full(8, 1000, np.int32), args_column=[("k",)] * 8)
        c0 = eng.telemetry.counters_snapshot()
        eng.flush()
        eng.drain()
        c1 = eng.telemetry.counters_snapshot()
        assert c1[key] == c0[key] + 1, force
        out.append((g.admitted, g.reason))
    eng.param_force_path = None
    # The seam comes before the tuner: its memo saw no pick while pinned.
    assert eng.autotune.memo.snapshot() == []
    return out, lib.states(eng)


def test_force_path_seam_pins_attribution():
    run_lockstep(_force_path)


def _autotune_command_and_prometheus(lib):
    from torch_transport_env import comparable, module_of, reset_process_counters

    handlers = module_of(lib, "transport.handlers")
    eng = lib.api.reset(clock=lib.clock, **lib.device_kw)
    try:
        resp = handlers.autotune_handler(handlers.CommandRequest(path="autotune", params={}, body=""))
        assert resp.success
        d = json.loads(resp.result)
        assert d["enabled"] is False
        assert "decisions" in d and "param_memo" in d
        reset_process_counters(lib)
        text = module_of(lib, "transport.prometheus").render_metrics(eng)
        for fam in ("sentinel_engine_autotune_enabled", "sentinel_engine_autotune_decisions_total",
                    "sentinel_engine_autotune_depth", "sentinel_engine_autotune_window_ms",
                    "sentinel_engine_autotune_window_batch_max", "sentinel_engine_param_closed_form_total",
                    "sentinel_engine_param_scan_total"):
            assert fam in text, fam
        return [d, [ln for ln in comparable(text) if "autotune" in ln or "_param_" in ln]]
    finally:
        lib.api.reset(**lib.device_kw)


def test_autotune_command_and_prometheus():
    run_lockstep(_autotune_command_and_prometheus)
