"""System protection and authority rules on the port
(sentinel_tpu_torch/runtime/flush.py:system_check, plain PyTorch version
on the CPU; rules/system_manager.py, rules/authority_manager.py) against
the JAX package, bit for bit: ``system_check`` on seeded batches with
thresholds under which every one of the five dimensions blocks at once
(and subsets of them), the ``SystemDevice`` the engine builds, and the
scenarios of tests/test_system_authority.py on both engines in lockstep,
with both system samplers pinned to the same values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.runtime import flush as jflush
from sentinel_tpu_torch.metrics import nodes as tnodes
from sentinel_tpu_torch.runtime import flush as tflush

from test_torch_nodes import _jax_stats, _random_stats
from torch_parity import (
    SYSTEM_EDGE_CASES,
    assert_same,
    block_of,
    random_flush_batch,
    run_on_both,
    system_edge_case,
    system_edge_thresholds,
    system_thresholds,
)

CPU = torch.device("cpu")
NOW = 1_000_250


def _row0_stats(rng, n_rows):
    """Random stats whose global inbound row holds a known second window:
    pass 20, success 10, RT sum 600 (avg 60 ms), min RT 20 and 30, no
    threads; so BBR's capacity is 10 * 2 * 20 / 1000 = 0.4 threads."""
    second, minute, threads, fpass, fws = _random_stats(rng, n_rows, NOW)
    counts, min_rt, ws = (a.copy() for a in second)
    counts[0] = 0
    counts[0, :, 0] = 10  # PASS
    counts[0, :, 3] = 5  # SUCCESS
    counts[0, :, 4] = 300  # RT
    min_rt[0] = [20, 30]
    ws[0] = [NOW - NOW % 1000, NOW - NOW % 1000 - 500]
    threads = threads.copy()
    threads[0] = 0
    return ((counts, min_rt, ws), minute, threads, fpass, fws)


_j_system_check = None


def _jax_system_check(stats, sysdev, batch, live):
    global _j_system_check
    if _j_system_check is None:
        import jax

        _j_system_check = jax.jit(jflush.system_check)
    return _j_system_check(stats, sysdev, batch, live)


@pytest.mark.parametrize("case", ["all", "qps_thread_load_cpu", "load_cpu", "cpu", "off"])
@pytest.mark.parametrize("seed", range(2))
def test_system_check_parity(case, seed):
    rng = np.random.default_rng(seed)
    n_rows = 32
    arrs = _row0_stats(rng, n_rows)
    b = random_flush_batch(rng, 64, 1, n_rows, 16, NOW, 60)
    live = b[1] & (rng.random(64) < 0.9)
    vals = system_thresholds(case)
    j_ok, j_type = _jax_system_check(
        _jax_stats(arrs), jflush.SystemDevice(*(jnp.float32(v) for v in vals)),
        jflush.FlushBatch(*(jnp.asarray(a) for a in b)), jnp.asarray(live),
    )
    t_ok, t_type = tflush.system_check(
        tnodes.stats_from_numpy(arrs, CPU), tflush.SystemDevice(*vals), tflush.batch_from_numpy(b, CPU),
        torch.tensor(live),
    )
    assert_same(j_ok, t_ok, "ok")
    assert_same(j_type, t_type, "sys_type")
    seen = set(np.asarray(j_type).tolist())
    want = {"all": {1, 2, 3}, "qps_thread_load_cpu": {1, 2, 4, 5}, "load_cpu": {4, 5}, "cpu": {5}, "off": {0}}[case]
    assert want <= seen, f"{case}: dimensions seen {seen}"


@pytest.mark.parametrize("case", SYSTEM_EDGE_CASES)
@pytest.mark.parametrize("n", [1, 8, 64])
def test_system_check_parity_edges(n, case):
    """The (ts, arrival) order and the wrapping sums the card's routes
    keep: one entry, no entry checked, one ts, ts at INT_MIN and INT_MAX
    beside unchecked entries (which tie a checked entry's sort key at
    INT_MAX), and acquires whose inbound sum passes 2^31."""
    rng = np.random.default_rng(40 + n)
    arrs = _row0_stats(rng, 32)
    b, live = system_edge_case(rng, n, case, NOW)
    for vals in system_edge_thresholds(n):
        j_ok, j_type = _jax_system_check(
            _jax_stats(arrs), jflush.SystemDevice(*(jnp.float32(v) for v in vals)),
            jflush.FlushBatch(*(jnp.asarray(a) for a in b)), jnp.asarray(live),
        )
        t_ok, t_type = tflush.system_check(
            tnodes.stats_from_numpy(arrs, CPU), tflush.SystemDevice(*vals), tflush.batch_from_numpy(b, CPU),
            torch.tensor(live),
        )
        assert_same(j_ok, t_ok, "ok")
        assert_same(j_type, t_type, "sys_type")
    if case == "unchecked":
        assert bool(np.asarray(j_ok).all())


def test_system_device_matches_jax_engine():
    """The engine's SystemDevice equals the JAX engine's for the same
    config and pinned sampler values."""
    from sentinel_tpu.rules.system_manager import SystemConfig as JCfg
    from sentinel_tpu.runtime.engine import Engine as JEngine
    from sentinel_tpu.utils.clock import ManualClock
    from sentinel_tpu.utils.system_status import sampler

    cfg = dict(highest_system_load=1.5, highest_cpu_usage=0.7, qps=123.4, max_rt=-1, max_thread=9)
    eng = JEngine(clock=ManualClock(0))
    eng.system_config = JCfg(**cfg)
    sampler.force(load=2.25, cpu=0.3)
    try:
        want = tflush.system_device_from_numpy(eng._system_device())
    finally:
        sampler.force(load=-1.0, cpu=-1.0)
    from sentinel_tpu_torch.rules.system_manager import SystemConfig

    assert tflush.make_system_device(SystemConfig(**cfg), 2.25, 0.3) == want


# --- the scenarios of tests/test_system_authority.py, on both engines -----


def _inbound(lib, name):
    return lambda: lib.st.entry(name, entry_type=lib.C.EntryType.IN)


def _qps_inbound_only(lib):
    lib.st.system_rule_manager.load_rules([lib.st.SystemRule(qps=3)])
    out = [block_of(_inbound(lib, f"in{i}")) for i in range(4)]
    out.append(block_of(lambda: lib.st.entry("out", entry_type=lib.C.EntryType.OUT)))
    assert out == ["pass"] * 3 + [("SystemBlockError", "qps", None), "pass"]
    return out


def _thread_limit(lib):
    lib.st.system_rule_manager.load_rules([lib.st.SystemRule(max_thread=2)])
    held = [lib.st.entry(r, entry_type=lib.C.EntryType.IN) for r in "abc"]
    out = [block_of(_inbound(lib, "d"))]
    for e in held:
        e.exit()
    assert out == [("SystemBlockError", "thread", None)]
    return out


def _avg_rt_limit(lib):
    lib.st.system_rule_manager.load_rules([lib.st.SystemRule(avg_rt=50)])
    lib.clock.set_ms(0)
    e = lib.st.entry("slow", entry_type=lib.C.EntryType.IN)
    lib.clock.advance(200)
    e.exit()
    out = [block_of(_inbound(lib, "next"))]
    assert out == [("SystemBlockError", "rt", None)]
    return out


def _load_bbr(lib):
    lib.st.system_rule_manager.load_rules([lib.st.SystemRule(highest_system_load=1.0)])
    lib.sampler.force(load=5.0, cpu=-1.0)
    try:
        e1 = lib.st.entry("l1", entry_type=lib.C.EntryType.IN)
        e2 = lib.st.entry("l2", entry_type=lib.C.EntryType.IN)
        out = [block_of(_inbound(lib, "l3"))]
        e1.exit()
        e2.exit()
    finally:
        lib.sampler.force(load=-1.0, cpu=-1.0)
    assert out == [("SystemBlockError", "load", None)]
    return out


def _cpu_limit(lib):
    lib.st.system_rule_manager.load_rules([lib.st.SystemRule(highest_cpu_usage=0.5)])
    lib.sampler.force(load=-1.0, cpu=0.9)
    try:
        out = [block_of(_inbound(lib, "c1"))]
    finally:
        lib.sampler.force(load=-1.0, cpu=-1.0)
    assert out == [("SystemBlockError", "cpu", None)]
    return out


def _min_across_rules(lib):
    lib.st.system_rule_manager.load_rules([lib.st.SystemRule(qps=100), lib.st.SystemRule(qps=2)])
    eff = lib.st.system_rule_manager.effective
    assert eff.qps == 2
    return list(eff)


def _block_counts_stats(lib):
    lib.st.system_rule_manager.load_rules([lib.st.SystemRule(qps=1)])
    out = [block_of(_inbound(lib, "s1")), block_of(_inbound(lib, "s2"))]
    g = lib.engine.entry_node_stats()
    assert g["pass_qps"] == 1 and g["block_qps"] == 1
    return out + [g]


def _white_list(lib):
    rule = lib.st.AuthorityRule("api", limit_app="appA,appB", strategy=lib.C.AUTHORITY_WHITE)
    lib.st.authority_rule_manager.load_rules([rule])
    lib.st.context_enter("cw", origin="appA")
    out = [block_of(lambda: lib.st.entry("api"))]
    lib.st.context_exit()
    lib.st.context_enter("cw2", origin="appC")
    out.append(block_of(lambda: lib.st.entry("api")))
    lib.st.context_exit()
    assert out == ["pass", ("AuthorityBlockError", "", rule.to_dict())]
    return out


def _black_list(lib):
    rule = lib.st.AuthorityRule("api2", limit_app="evil", strategy=lib.C.AUTHORITY_BLACK)
    lib.st.authority_rule_manager.load_rules([rule])
    lib.st.context_enter("cb", origin="evil")
    out = [block_of(lambda: lib.st.entry("api2"))]
    lib.st.context_exit()
    lib.st.context_enter("cb2", origin="good")
    out.append(block_of(lambda: lib.st.entry("api2")))
    lib.st.context_exit()
    assert out == [("AuthorityBlockError", "", rule.to_dict()), "pass"]
    return out


def _empty_origin_passes(lib):
    lib.st.authority_rule_manager.load_rules(
        [lib.st.AuthorityRule("api3", limit_app="appA", strategy=lib.C.AUTHORITY_WHITE)])
    out = [block_of(lambda: lib.st.entry("api3"))]
    assert out == ["pass"]
    return out


def _authority_beats_system_and_flow(lib):
    """Reason precedence on one blocked entry: authority > system > flow."""
    lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("p", count=0)])
    lib.st.system_rule_manager.load_rules([lib.st.SystemRule(qps=0)])
    lib.st.authority_rule_manager.load_rules(
        [lib.st.AuthorityRule("p", limit_app="bad", strategy=lib.C.AUTHORITY_BLACK)])
    lib.st.context_enter("pc", origin="bad")
    out = [block_of(lambda: lib.st.entry("p", entry_type=lib.C.EntryType.IN))]
    lib.st.context_exit()
    out.append(block_of(lambda: lib.st.entry("p", entry_type=lib.C.EntryType.IN)))
    out.append(block_of(lambda: lib.st.entry("p")))
    assert [o[0] for o in out] == ["AuthorityBlockError", "SystemBlockError", "FlowBlockError"]
    return out


SCENARIOS = {
    "qps_inbound_only": _qps_inbound_only,
    "thread_limit": _thread_limit,
    "avg_rt_limit": _avg_rt_limit,
    "load_bbr": _load_bbr,
    "cpu_limit": _cpu_limit,
    "min_across_rules": _min_across_rules,
    "block_counts_stats": _block_counts_stats,
    "white_list": _white_list,
    "black_list": _black_list,
    "empty_origin_passes": _empty_origin_passes,
    "precedence": _authority_beats_system_and_flow,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_system_authority_scenario_lockstep(name):
    run_on_both(SCENARIOS[name])
