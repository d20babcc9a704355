"""The port's durable checkpoints (sentinel_tpu_torch/runtime/durable.py and
the failover tier's spill and restore) against the JAX package's, on the
CPU, and the host-mirror pieces the failover and speculative tiers read.

* The STPUCKP1 file format: both packages write the same bytes for the
  same header and leaves, and each reads the other's; magic, truncation,
  crc and header faults raise DurableCheckpointError in both.
* A file the JAX engine spilled restores into the port's engine, and one
  the port spilled restores into the JAX engine, on the same rules and
  keys: the restored states and the verdicts after them agree bit for bit.
* The engine cases of tests/test_restart.py (TestDurableCheckpoint and
  TestSketchCheckpointRestore) in lockstep (tests/torch_lockstep.py): warm
  restores, a remapped node registry through ``adopt_keys``, and corrupt,
  truncated, stale or mismatched files as counted cold starts. The
  re-attach and supervisor cases there are in tests/test_torch_supervise.py
  and tests/test_torch_standby.py.
* ``mirror_info``, ``mirror_any_open``, ``mirror_bucket``, ``adopt_keys``
  and ``make_probe_batch`` against the JAX package's."""

import os
import time

import numpy as np
import pytest

from torch_lockstep import canon, health, run_lockstep, verdicts


def _wait_for(pred, what, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _wait_write(eng, n=1):
    _wait_for(lambda: eng.failover.counters["durable_writes"] >= n, "a durable checkpoint write")


def _wait_final_write(eng):
    """Until the writer has spilled the newest checkpoint (it writes the
    newest pending one, so which one is on disk depends on its timing)."""
    fo = eng.failover
    _wait_for(lambda: fo.last_durable is not None and fo._ckpt is not None and fo.last_durable[1] == fo._ckpt.seq,
              "the newest checkpoint on disk")


def _mk(lib, path="", every=1, stale_ms=0, rules=None, depth=0):
    eng = lib.mk(depth=depth, FAILOVER_ENABLED="true", FAILOVER_CHECKPOINT_EVERY=every, FAILOVER_CKPT_PATH=path,
                 FAILOVER_CKPT_INTERVAL_MS=0, FAILOVER_CKPT_STALE_MS=stale_ms)
    if rules is not None:
        eng.set_flow_rules(rules)
    return eng


def _durable_modules():
    from sentinel_tpu.runtime import durable as jd
    from sentinel_tpu_torch.runtime import durable as td

    return jd, td


# --- the file format ---------------------------------------------------------


def test_same_bytes_both_ways(tmp_path):
    jd, td = _durable_modules()
    leaves = [np.arange(12, dtype=np.int32).reshape(3, 4), np.ones(5, dtype=np.float32), np.zeros(0, np.int32)]
    header = {"seq": 7, "wall_ms": 1, "components": {"stats": 3}}
    nj = jd.write_checkpoint(str(tmp_path / "j.bin"), header, leaves)
    nt = td.write_checkpoint(str(tmp_path / "t.bin"), header, leaves)
    assert nj == nt and (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()
    for reader, path in ((td, "j.bin"), (jd, "t.bin")):
        h, got = reader.read_checkpoint(str(tmp_path / path))
        assert h["seq"] == 7 and h["version"] == 1 and h["n_leaves"] == 3
        for a, b in zip(got, leaves):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_atomic_replace_keeps_no_temp(tmp_path):
    _, td = _durable_modules()
    path = str(tmp_path / "ck.bin")
    td.write_checkpoint(path, {"seq": 1}, [np.zeros(2)])
    td.write_checkpoint(path, {"seq": 2}, [np.ones(2)])
    assert td.read_checkpoint(path)[0]["seq"] == 2
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".ck.bin.tmp")]


@pytest.mark.parametrize("corrupt", ["magic", "truncate", "crc", "header", "leaves"])
def test_corruption_raises_in_both(tmp_path, corrupt):
    jd, td = _durable_modules()
    path = str(tmp_path / "ck.bin")
    td.write_checkpoint(path, {"seq": 3}, [np.arange(8)])
    blob = bytearray(open(path, "rb").read())
    if corrupt == "magic":
        blob[0] ^= 0xFF
    elif corrupt == "truncate":
        blob = blob[: len(blob) // 2]
    elif corrupt == "crc":
        blob[-1] ^= 0xFF
    elif corrupt == "header":
        blob[12] ^= 0xFF
    if corrupt == "leaves":
        # A header that claims more leaves than the payload holds.
        header, leaves = td.read_checkpoint(path)
        header.pop("version")
        td.write_checkpoint(path, dict(header), leaves)
        raw = open(path, "rb").read()
        blob = bytearray(raw.replace(b'"n_leaves":1', b'"n_leaves":2'))
    open(path, "wb").write(bytes(blob))
    for mod in (jd, td):
        with pytest.raises(mod.DurableCheckpointError):
            mod.read_checkpoint(path)


def test_rules_fingerprint_agrees():
    import sentinel_tpu as jst
    import sentinel_tpu_torch as st
    from sentinel_tpu.rules.flow_table import FlowIndex as JFlowIndex
    from sentinel_tpu_torch.rules.flow_table import FlowIndex

    jd, td = _durable_modules()
    specs = [dict(resource="a", count=3), dict(resource="b", grade=0, count=2, limit_app="x"),
             dict(resource="c", count=9, control_behavior=2, max_queueing_time_ms=100)]
    j = JFlowIndex([jst.FlowRule(**r) for r in specs])
    t = FlowIndex([st.FlowRule(**r) for r in specs], device="cpu")
    assert jd.rules_fingerprint(j.rules) == td.rules_fingerprint(t.rules)
    dr = [dict(resource="a", grade=2, count=1, time_window=3)]
    assert jd.rules_fingerprint([jst.DegradeRule(**r) for r in dr]) == td.rules_fingerprint(
        [st.DegradeRule(**r) for r in dr])


# --- across the packages -------------------------------------------------------


def _drive(lib, eng):
    """Traffic that fills QPS windows, a THREAD gauge, a breaker and
    hot-param rows."""
    lib.clock.set_ms(5000)
    ops = [eng.submit_entry("r", ts=5000) for _ in range(8)]
    ops += [eng.submit_entry("t", ts=5000) for _ in range(3)]
    ops += [eng.submit_entry("p", ts=5000, args=(v,)) for v in ("hot", "hot", "hot", "hot", "cold")]
    eng.flush()
    eng.submit_exit(ops[0].rows, rt=20, err=1, resource="r", ts=5000)
    eng.flush()
    eng.drain()
    return verdicts(ops)


def _world(lib, eng):
    eng.set_flow_rules([lib.st.FlowRule("r", count=5), lib.st.FlowRule("t", grade=lib.C.FLOW_GRADE_THREAD, count=5),
                        lib.st.FlowRule("p", count=1000)])
    eng.set_degrade_rules([lib.st.DegradeRule("r", grade=lib.C.DEGRADE_GRADE_EXCEPTION_COUNT, count=5,
                                              time_window=10)])
    eng.set_param_rules({"p": [lib.st.ParamFlowRule("p", param_idx=0, count=3)]})


def _spill(lib, path):
    a = _mk(lib, path)
    _world(lib, a)
    obs = _drive(lib, a)
    _wait_final_write(a)
    a.close()
    return obs


def _restore(lib, src, register_first=()):
    # A copy of its own: the restoring engine spills to its path too.
    path = f"{src}.{lib.name}"
    with open(src, "rb") as f, open(path, "wb") as g:
        g.write(f.read())
    b = _mk(lib, path)
    _world(lib, b)
    for name in register_first:
        b.resolve_entry_rows(name, lib.C.CONTEXT_DEFAULT_NAME, "", lib.C.EntryType.OUT)
    assert b.failover.restore_durable() is True
    assert b.failover.state == "HEALTHY" and b.failover.counters["durable_load_cold"] == 0
    restored = lib.states(b)
    after = [b.submit_entry("r", ts=5000), b.submit_entry("t", ts=5000)]
    after += [b.submit_entry("p", ts=5000, args=(v,)) for v in ("hot", "cold", "new")]
    b.flush()
    b.drain()
    _wait_final_write(b)
    out = [restored, verdicts(after), lib.states(b), health(b), b.nodes.keys_snapshot()]
    b.close()
    return out


@pytest.mark.parametrize("register_first", [(), ("zzz", "p")], ids=["same_keys", "remapped_keys"])
def test_cross_package_restore(tmp_path, register_first):
    """JAX spills and the port restores, and the port spills and JAX
    restores; each restore agrees bit for bit with the same package
    restoring its own file (and with the other package). With
    ``register_first`` the restoring registry already holds other rows, so
    the stats come back through the ``adopt_keys`` remap."""
    run_lockstep(lambda lib: _spill(lib, str(tmp_path / f"{lib.name}.bin")))
    files = {"jax": str(tmp_path / "jax.bin"), "port": str(tmp_path / "port.bin")}
    jd, td = _durable_modules()
    hj, lj = jd.read_checkpoint(files["jax"])
    ht, lt = td.read_checkpoint(files["port"])
    for key in ("components", "fingerprints", "node_keys", "stats_rows", "param_values", "param_rows", "win", "seq"):
        assert hj[key] == ht[key], key
    assert canon(lj) == canon(lt)
    results = {}
    for src in ("jax", "port"):
        results[src] = run_lockstep(lambda lib, src=src: _restore(lib, files[src], register_first))
    assert results["jax"] == results["port"]


# --- the engine cases of tests/test_restart.py ---------------------------------


def _unset_path_writes_nothing(lib, tmp):
    eng = lib.mk(FAILOVER_ENABLED="true", FAILOVER_CHECKPOINT_EVERY=1)
    eng.set_flow_rules([lib.st.FlowRule("r", count=5)])
    lib.clock.set_ms(1000)
    eng.submit_entry("r")
    eng.flush()
    eng.drain()
    fo = eng.failover
    assert fo.counters["checkpoints"] >= 1 and fo.counters["durable_writes"] == 0
    assert fo._durable_thread is None and fo.snapshot()["durable"]["path"] == ""
    eng.close()
    return [health(eng)]


def _warm_restore_qps_window_and_thread_zero(lib, tmp):
    path = str(tmp / f"{lib.name}.bin")
    lib.clock.set_ms(5000)
    a = _mk(lib, path, rules=[lib.st.FlowRule("r", count=5)])
    ops = [a.submit_entry("r", ts=5000) for _ in range(8)]
    a.flush()
    a.drain()
    assert sum(op.verdict.admitted for op in ops) == 5
    assert a.cluster_node_stats("r")["cur_thread_num"] == 5
    _wait_write(a)
    a.close()
    b = _mk(lib, path, rules=[lib.st.FlowRule("r", count=5)])
    assert b.failover.restore_durable() is True
    assert b.failover.state == "HEALTHY"
    assert b.failover.counters["durable_loads"] == 1 and b.failover.counters["durable_load_cold"] == 0
    assert b.cluster_node_stats("r")["cur_thread_num"] == 0
    ops_b = [b.submit_entry("r", ts=5000) for _ in range(5)]
    b.flush()
    b.drain()
    assert not any(op.verdict.admitted for op in ops_b)
    _wait_final_write(b)
    b.close()
    return [verdicts(ops), verdicts(ops_b), lib.states(b), health(b)]


def _warm_restore_param_value_rows_survive(lib, tmp):
    path = str(tmp / f"{lib.name}.bin")
    lib.clock.set_ms(5000)
    prules = {"p": [lib.st.ParamFlowRule("p", param_idx=0, count=3)]}
    a = _mk(lib, path, rules=[lib.st.FlowRule("p", count=1000)])
    a.set_param_rules(prules)
    ops = [a.submit_entry("p", ts=5000, args=("hot",)) for _ in range(5)]
    a.flush()
    a.drain()
    assert sum(op.verdict.admitted for op in ops) == 3
    _wait_write(a)
    a.close()
    b = _mk(lib, path, rules=[lib.st.FlowRule("p", count=1000)])
    b.set_param_rules(prules)
    assert b.failover.restore_durable() is True
    assert b.failover.counters["durable_load_cold"] == 0
    hot = [b.submit_entry("p", ts=5000, args=("hot",)) for _ in range(3)]
    cold = [b.submit_entry("p", ts=5000, args=("new",)) for _ in range(3)]
    b.flush()
    b.drain()
    assert not any(op.verdict.admitted for op in hot) and all(op.verdict.admitted for op in cold)
    b.close()
    return [verdicts(hot + cold), lib.states(b)]


def _param_rule_change_restores_param_cold(lib, tmp):
    path = str(tmp / f"{lib.name}.bin")
    lib.clock.set_ms(5000)
    a = _mk(lib, path, rules=[lib.st.FlowRule("p", count=1000)])
    a.set_param_rules({"p": [lib.st.ParamFlowRule("p", param_idx=0, count=3)]})
    for _ in range(5):
        a.submit_entry("p", ts=5000, args=("hot",))
    a.flush()
    a.drain()
    _wait_write(a)
    a.close()
    b = _mk(lib, path, rules=[lib.st.FlowRule("p", count=1000)])
    b.set_param_rules({"p": [lib.st.ParamFlowRule("p", param_idx=0, count=4)]})
    assert b.failover.restore_durable() is True
    ops = [b.submit_entry("p", ts=5000, args=("hot",)) for _ in range(4)]
    b.flush()
    b.drain()
    assert all(op.verdict.admitted for op in ops)
    b.close()
    return [verdicts(ops), lib.states(b)]


def _corrupt_file_cold_start_counted(lib, tmp):
    path = str(tmp / f"{lib.name}.bin")
    with open(path, "wb") as f:
        f.write(b"this is not a checkpoint")
    b = _mk(lib, path, rules=[lib.st.FlowRule("r", count=5)])
    assert b.failover.restore_durable() is False
    assert b.failover.counters["durable_load_cold"] == 1 and b.failover.state == "HEALTHY"
    op = b.submit_entry("r", ts=1000)
    b.flush()
    b.drain()
    assert op.verdict.admitted
    _wait_final_write(b)
    b.close()
    return [verdicts([op]), health(b)]


def _truncated_file_cold_start_counted(lib, tmp):
    path = str(tmp / f"{lib.name}.bin")
    lib.clock.set_ms(1000)
    a = _mk(lib, path, rules=[lib.st.FlowRule("r", count=5)])
    a.submit_entry("r", ts=1000)
    a.flush()
    a.drain()
    _wait_write(a)
    a.close()
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[: len(blob) - 7])
    b = _mk(lib, path, rules=[lib.st.FlowRule("r", count=5)])
    assert b.failover.restore_durable() is False
    assert b.failover.counters["durable_load_cold"] == 1 and b.failover.state == "HEALTHY"
    b.close()
    return [health(b)]


def _missing_file_is_a_silent_cold_start(lib, tmp):
    b = _mk(lib, str(tmp / "nope.bin"), rules=[lib.st.FlowRule("r", count=5)])
    assert b.failover.restore_durable() is False
    assert b.failover.counters["durable_load_cold"] == 0
    b.close()
    return [health(b)]


def _stale_file_cold_start_counted(lib, tmp):
    path = str(tmp / f"{lib.name}.bin")
    lib.clock.set_ms(1000)
    a = _mk(lib, path, rules=[lib.st.FlowRule("r", count=5)])
    a.submit_entry("r", ts=1000)
    a.flush()
    a.drain()
    _wait_write(a)
    a.close()
    time.sleep(0.05)
    b = _mk(lib, path, stale_ms=1, rules=[lib.st.FlowRule("r", count=5)])
    assert b.failover.restore_durable() is False
    assert b.failover.counters["durable_load_cold"] == 1
    b.close()
    return [health(b)]


def _window_geometry_mismatch_restores_stats_fresh(lib, tmp):
    path = str(tmp / f"{lib.name}.bin")
    lib.clock.set_ms(5000)
    a = _mk(lib, path, rules=[lib.st.FlowRule("r", count=5)])
    for _ in range(8):
        a.submit_entry("r", ts=5000)
    a.flush()
    a.drain()
    _wait_write(a)
    a.close()
    header, leaves = lib.durable.read_checkpoint(path)
    header["win"] = [4, 2000, 4900]
    header.pop("version")
    header.pop("n_leaves")
    lib.durable.write_checkpoint(path, header, leaves)
    b = _mk(lib, path, rules=[lib.st.FlowRule("r", count=5)])
    assert b.failover.restore_durable() is True
    ops = [b.submit_entry("r", ts=5000) for _ in range(5)]
    b.flush()
    b.drain()
    assert all(op.verdict.admitted for op in ops)
    b.close()
    return [verdicts(ops), lib.states(b)]


def _snapshot_reports_durable(lib, tmp):
    path = str(tmp / f"{lib.name}.bin")
    a = _mk(lib, path, rules=[lib.st.FlowRule("r", count=5)])
    a.submit_entry("r", ts=1000)
    a.flush()
    a.drain()
    _wait_write(a)
    snap = a.failover.snapshot()["durable"]
    assert snap["writes"] >= 1 and snap["path"] == path
    assert snap["last"] is not None and snap["last"]["bytes"] > 0 and snap["last"]["age_ms"] >= 0
    a.close()
    return [snap["writes"], snap["last"]["seq"]]


def _sketch_cfg(lib):
    for key, value in (("SKETCH_ENABLED", "true"), ("SKETCH_PROMOTE_QPS", "5"), ("SKETCH_WINDOW_MS", "1000"),
                       ("SKETCH_DEMOTE_WINDOWS", "2"), ("FAILOVER_ENABLED", "true"),
                       ("FAILOVER_CHECKPOINT_EVERY", "1"), ("FAILOVER_PROBE_FLUSHES", "2")):
        lib.config.set(getattr(lib.config, key), value)


def _drive_until_promoted(eng, clk, hot="HOT", max_windows=6):
    for step in range(max_windows * 4):
        col = [(f"cold{step}_{j}",) for j in range(32)] + [(hot,)] * 32
        eng.submit_bulk("api", n=64, args_column=col)
        eng.flush()
        eng.drain()
        if hot in eng.sketch.promoted_values.get("api", ()):
            return step
        clk.advance(250)
    raise AssertionError("HOT never promoted")


def _sketch_rules(lib):
    return {"api": [lib.st.ParamFlowRule(resource="api", param_idx=0, count=3.0, sketch_mode=True)]}


def _promoted_key_survives_in_process_restore(lib, tmp):
    _sketch_cfg(lib)
    lib.clock.set_ms(1000)
    eng = lib.mk()
    eng.set_param_rules(_sketch_rules(lib))
    inj = lib.FaultInjector().install(eng)
    steps = _drive_until_promoted(eng, lib.clock)
    eng.drain()
    ck = eng.failover._ckpt
    assert ck is not None and len(ck.states) == 5 and ck.states[4] is not None
    inj.fail_fetch(eng.flush_seq + 1)
    g = eng.submit_bulk("api", n=4, args_column=[("HOT",)] * 4)
    eng.flush()
    assert eng.failover.state == "DEGRADED"
    degraded = (g.admitted, g.reason)
    # The sketch folded the degraded chunk into its host mirror.
    mirror = dict(eng.sketch.host_mirror.counts)
    assert eng.failover.try_recover()
    assert "HOT" in eng.sketch.promoted_values.get("api", ())
    assert int(np.asarray(lib.states(eng)[4].cand_cnt).max()) > 0
    return [steps, degraded, mirror, health(eng), lib.states(eng)]


def _durable_checkpoint_carries_sketch(lib, tmp):
    _sketch_cfg(lib)
    path = str(tmp / f"{lib.name}.bin")
    lib.config.set(lib.config.FAILOVER_CKPT_PATH, path)
    lib.config.set(lib.config.FAILOVER_CKPT_INTERVAL_MS, "0")
    lib.clock.set_ms(1000)
    a = lib.mk()
    a.set_param_rules(_sketch_rules(lib))
    _drive_until_promoted(a, lib.clock)
    a.drain()
    _wait_final_write(a)
    a.close()
    header, _ = lib.durable.read_checkpoint(path)
    assert header["components"]["sketch"] > 0
    b = lib.mk()
    b.set_param_rules(_sketch_rules(lib))
    assert b.failover.restore_durable() is True
    assert int(np.asarray(lib.states(b)[4].cand_cnt).max()) > 0
    b.close()
    return [header["components"], lib.states(b)]


CASES = {
    "unset_path_writes_nothing": _unset_path_writes_nothing,
    "warm_restore_qps_window_and_thread_zero": _warm_restore_qps_window_and_thread_zero,
    "warm_restore_param_value_rows_survive": _warm_restore_param_value_rows_survive,
    "param_rule_change_restores_param_cold": _param_rule_change_restores_param_cold,
    "corrupt_file_cold_start_counted": _corrupt_file_cold_start_counted,
    "truncated_file_cold_start_counted": _truncated_file_cold_start_counted,
    "missing_file_is_a_silent_cold_start": _missing_file_is_a_silent_cold_start,
    "stale_file_cold_start_counted": _stale_file_cold_start_counted,
    "window_geometry_mismatch_restores_stats_fresh": _window_geometry_mismatch_restores_stats_fresh,
    "snapshot_reports_durable": _snapshot_reports_durable,
    "promoted_key_survives_in_process_restore": _promoted_key_survives_in_process_restore,
    "durable_checkpoint_carries_sketch": _durable_checkpoint_carries_sketch,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_durable_lockstep(case, tmp_path):
    run_lockstep(CASES[case], tmp_path)


def test_restore_copies_never_aliases():
    """Two restores of one checkpoint install the same world: the first
    restore's tensors (updated in place by later flushes) never share
    memory with the checkpoint's host arrays."""
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.testing.faults import FaultInjector
    from sentinel_tpu_torch.utils.clock import ManualClock
    from sentinel_tpu_torch.utils.config import config

    saved = dict(config._runtime)
    config.set(config.FAILOVER_ENABLED, "true")
    config.set(config.FAILOVER_CHECKPOINT_EVERY, "1")
    config.set(config.FAILOVER_PROBE_FLUSHES, "1")
    try:
        clock = ManualClock(1000)
        eng = Engine(clock=clock, device="cpu")
        eng.set_flow_rules([st.FlowRule("r", count=50)])
        inj = FaultInjector().install(eng)
        [eng.submit_entry("r") for _ in range(5)]
        eng.flush()
        ck = eng.failover._ckpt
        before = canon(ck.states)
        for _ in range(2):
            inj.fail_fetch(eng.flush_seq + 1)
            eng.submit_entry("r")
            eng.flush()
            assert eng.failover.state == "DEGRADED"
            ck = eng.failover._ckpt
            before = canon(ck.states)
            assert eng.failover.try_recover()
            [eng.submit_entry("r") for _ in range(3)]
            eng.flush()  # updates the restored tensors in place
            assert canon(ck.states) == before
        eng.close()
    finally:
        config._runtime.clear()
        config._runtime.update(saved)


# --- the host-mirror pieces ------------------------------------------------------


def test_mirror_info_and_bucket_parity():
    import sentinel_tpu as jst
    import sentinel_tpu.models.rules as jrules
    import sentinel_tpu_torch as st
    import sentinel_tpu_torch.models.rules as trules
    from sentinel_tpu.metrics.nodes import NodeRegistry as JReg
    from sentinel_tpu.rules.flow_table import FlowIndex as JFlowIndex
    from sentinel_tpu.rules.param_table import ParamIndex as JParamIndex
    from sentinel_tpu_torch.metrics.nodes import NodeRegistry
    from sentinel_tpu_torch.rules.flow_table import FlowIndex
    from sentinel_tpu_torch.rules.param_table import ParamIndex

    rng = np.random.default_rng(3)
    specs = [dict(resource=f"r{i % 5}", grade=int(rng.integers(0, 2)), count=float(rng.integers(0, 40)),
                  control_behavior=int(rng.choice([0, 0, 1, 2, 3])), max_queueing_time_ms=int(rng.integers(0, 900)))
             for i in range(12)]
    j = JFlowIndex([jst.FlowRule(**r) for r in specs])
    t = FlowIndex([st.FlowRule(**r) for r in specs], device="cpu")
    for gid in range(-1, 14):
        a, b = j.mirror_info(gid), t.mirror_info(gid)
        assert (a is None) == (b is None)
        if a is not None:
            assert a[0].to_dict() == b[0].to_dict() and a[1:] == b[1:]
        a, b = j.mirror_shaping_info(gid), t.mirror_shaping_info(gid)
        assert (a is None) == (b is None) and (a is None or a[1:] == b[1:])
    pr = [dict(resource="p", param_idx=0, count=3, burst_count=2, duration_in_sec=2),
          dict(resource="p", param_idx=1, count=7, param_flow_item_list=[("v", 11)])]

    def prules(lib):
        return {"p": [lib.ParamFlowRule(**{k: v for k, v in r.items() if k != "param_flow_item_list"},
                                        param_flow_item_list=[lib.ParamFlowItem(object=o, count=c)
                                                              for o, c in r.get("param_flow_item_list", [])])
                      for r in pr]}

    jp, tp = JParamIndex(prules(jrules)), ParamIndex(prules(trules))
    for args in (("a", "v"), ("b", "w"), ("a", "x")):
        js, ts = jp.slots_for("p", args), tp.slots_for("p", args)
        assert [s.mirror_bucket() for s in js] == [s.mirror_bucket() for s in ts]
        assert [s.prow for s in js] == [s.prow for s in ts]
    jr, tr = JReg(), NodeRegistry()
    for reg in (jr, tr):
        for res in ("a", "b", "c"):
            reg.cluster_row(res)
            reg.default_row(res, "ctx")
            reg.origin_row(res, "app")
        reg.entrance_row("ctx")
    assert jr.keys_snapshot() == tr.keys_snapshot()
    keys = jr.keys_snapshot()
    for pre in ((), ("zz", "b")):
        j2, t2 = JReg(), NodeRegistry()
        for reg in (j2, t2):
            for res in pre:
                reg.cluster_row(res)
        assert j2.adopt_keys(keys) == t2.adopt_keys(keys)
        assert j2.keys_snapshot() == t2.keys_snapshot()


def test_mirror_any_open_and_probe_batch_parity():
    import torch
    from sentinel_tpu.rules.degrade_table import mirror_any_open as jmao
    from sentinel_tpu.runtime.flush import make_probe_batch as jprobe
    from sentinel_tpu_torch.rules.degrade_table import mirror_any_open
    from sentinel_tpu_torch.runtime.flush import make_probe_batch

    rng = np.random.default_rng(5)
    mirror = rng.integers(0, 3, 16).astype(np.int32)
    for _ in range(40):
        gids = list(rng.integers(-2, 20, int(rng.integers(0, 5))))
        assert jmao(mirror, gids) == mirror_any_open(mirror, gids)
    for shape in ((8, 8, 1, 1), (16, 8, 2, 4)):
        a = jprobe(1234, *shape)
        b = make_probe_batch(1234, torch.device("cpu"), *shape)
        assert int(a.now) == b.now
        for name in a._fields[1:]:
            x, y = np.asarray(getattr(a, name)), getattr(b, name).numpy()
            assert x.shape == y.shape and x.dtype.kind == y.dtype.kind and np.array_equal(x, y), name
