"""Parity of the port's hot-parameter rules (sentinel_tpu_torch/rules/
param_table.py, param_manager.py and the engine's param path, plain
PyTorch versions on the CPU) with the JAX package, bit for bit:
``run_param`` in every mode (the closed forms -8, -2 and -1, the scan 0,
rounds 1, 4 and 16) on every grade and behavior, LRU resets and exit
releases, the one-acquire gateway shape at one and at several
timestamps, and one heavy value; ``flush_step`` with the param stage on;
``ParamIndex`` interning, LRU eviction, hot items, bulk columns and the
value snapshot; the engine cases of tests/test_param_flow.py and
test_param_closed_form.py and examples/param_flow_demo.py on both
packages; and the epoch rebase of the param state. Tolerance is zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.rules import param_table as jpt
from sentinel_tpu_torch.rules import param_table as tpt

from test_torch_shaping import run_flush_parity
from torch_parity import PARAM_NEVER, assert_same, random_param_case, run_on_both

CPU = torch.device("cpu")

_jax_run_param = jax.jit(jpt.run_param, static_argnames=("rounds",))

PARAM_CASES = {
    # name: (random_param_case kwargs, rounds)
    "every_grade": (dict(s=256, pr=32), [0, 1, 4, 16]),
    "closed_one_ts": (dict(s=256, pr=32, closed=True, nts=1), [-1, 0, 16]),
    "closed_mixed_ts": (dict(s=256, pr=32, closed=True, nts=5), [-8, -2, 0]),
    "closed_heavy": (dict(s=512, pr=16, closed=True, nts=2, heavy=True), [-2, 0]),
    "heavy_value": (dict(s=512, pr=16, heavy=True), [0, 4]),
    # The kernel's routes: one item, no valid item, one throttled row of
    # about 1,000 items in random ts order (a walk over many 32-record
    # chunks), and s on either side of the one-block route's 2,048.
    "one_item": (dict(s=1, pr=8), [0, 1, -1]),
    "all_invalid": (dict(s=64, pr=8, valid_frac=0.0), [0, 4, -2]),
    "long_row": (dict(s=1000, pr=8, heavy=True, heavy_row=1, sorted_ts=False), [0, 100]),
    "s_2048": (dict(s=2048, pr=64), [0, 4]),
    "s_2049": (dict(s=2049, pr=64), [0, 16]),
    "closed_2049": (dict(s=2049, pr=64, closed=True, nts=5), [-8]),
}
# Cases whose verdicts need not mix admits and blocks.
UNMIXED = {"one_item", "all_invalid"}
PARAM_RUNS = [(c, r) for c in sorted(PARAM_CASES) for r in PARAM_CASES[c][1]]


@pytest.mark.parametrize("case,rounds", PARAM_RUNS, ids=[f"{c}-{r}" for c, r in PARAM_RUNS])
def test_run_param_parity(case, rounds):
    rng = np.random.default_rng(sorted(PARAM_CASES).index(case) * 7 + 3)
    pb, dyn = random_param_case(rng, **PARAM_CASES[case][0])
    want = _jax_run_param(jpt.ParamDynState(*map(jnp.asarray, dyn)), jpt.ParamBatch(*map(jnp.asarray, pb)),
                          rounds=rounds)
    got = tpt.run_param(tpt.param_state_from_numpy(dyn, CPU), tpt.param_batch_from_numpy(pb, CPU), rounds)
    assert_same(want[1], got[1], "ok")
    assert_same(want[2], got[2], "wait")
    assert_same(tuple(jax.device_get(want[0])), tuple(t.numpy() for t in got[0]), "state")
    ok = np.asarray(want[1])
    if case == "all_invalid":
        assert ok.all() and not np.asarray(want[2]).any()
    elif case not in UNMIXED and (rounds <= 0 or case == "every_grade"):
        # a small bound leaves a heavy row's tail unresolved (ok)
        assert ok.any() and not ok.all()
    if case == "every_grade" and rounds in (0, 16):
        assert (np.asarray(want[2]) > 0).any(), "some throttled value queued"


def test_closed_form_refill_across_flushes():
    """test_param_closed_form's boundary: spend the window, nothing at +100
    ms, the budget again at exactly duration + 1 later."""
    n = 40
    out = []
    for pkg, mk, run in ((jpt, lambda a: jnp.asarray(a), _jax_run_param),
                         (tpt, lambda a: torch.tensor(a), None)):
        dyn = jpt.make_param_state(2) if run else tpt.make_param_state(2, "cpu")
        got = []
        for ts in (1000, 1100, 2101):
            pb = pkg.ParamBatch(*(mk(a) for a in (
                np.ones(n, bool), np.zeros(n, np.int32), np.arange(n, dtype=np.int32), np.full(n, ts, np.int32),
                np.ones(n, np.int32), np.ones(n, np.int32), np.zeros(n, np.int32), np.full(n, 3, np.int32),
                np.zeros(n, np.int32), np.full(n, 1000, np.int32), np.zeros(n, np.int32), np.zeros(n, np.int32),
                np.full(8, -1, np.int32), np.full(8, -1, np.int32))))
            dyn, ok, _ = run(dyn, pb, rounds=-1) if run else pkg.run_param(dyn, pb, -1)
            got.append(int(np.asarray(ok).sum()) if run else int(ok.sum()))
        out.append(got)
    assert out[0] == out[1] == [3, 0, 3]


@pytest.mark.parametrize("variant", ["param", "param_chain"])
def test_flush_step_with_params_parity(variant):
    reasons, waits = run_flush_parity(variant)
    assert 5 in reasons, "the param stage blocked entries"


# --- ParamIndex ----------------------------------------------------------------


def _rules(pkg, C):
    return {
        "r": [pkg.ParamFlowRule("r", param_idx=0, count=2,
                                param_flow_item_list=[pkg.ParamFlowItem(object="vip", count=9)]),
              pkg.ParamFlowRule("r", param_idx=1, count=5, control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER,
                                duration_in_sec=2, max_queueing_time_ms=300)],
        "t": [pkg.ParamFlowRule("t", param_idx=0, count=3, grade=C.FLOW_GRADE_THREAD)],
    }


def _index_trace(pkg, C, index_cls, args_cls, fastpath):
    from types import SimpleNamespace

    idx = index_cls(_rules(SimpleNamespace(ParamFlowRule=pkg.ParamFlowRule, ParamFlowItem=pkg.ParamFlowItem), C))
    idx._use_value_cache = fastpath
    idx._caps = [4, 3, 4]
    out = []
    rng = np.random.default_rng(5)
    for step in range(30):
        vals = [f"v{int(x)}" for x in rng.integers(0, 7, 3)]
        slots = idx.slots_for("r", (vals[0], [vals[1], "vip"]))
        out.append([(s.prow, s.grade, s.behavior, s.token_count, s.burst, s.duration_ms, s.maxq, s.cost_ms,
                     s.value_key) for s in slots])
        col = [(f"v{int(x)}", f"w{int(x) % 3}") for x in rng.integers(0, 9, 12)]
        if step % 3 == 0:
            col = args_cls(12, {0: [c[0] for c in col], 1: [c[1] for c in col]})
        cols = idx.bulk_cols("r", col)
        out.append([(c[1].tolist(), c[2].tolist(), c[3].tolist(), c[4].tolist()) for c in cols])
        out.append(idx.take_resets())
    out.append(idx.values_snapshot())
    out.append(idx.cache_stats())
    fresh = index_cls(_rules(SimpleNamespace(ParamFlowRule=pkg.ParamFlowRule, ParamFlowItem=pkg.ParamFlowItem), C))
    out.append(fresh.adopt_values(idx.values_snapshot()))
    out.append(fresh.adopt_values(idx.values_snapshot()))  # refused: already holds values
    return out


@pytest.mark.parametrize("fastpath", [True, False])
def test_param_index_matches_jax(fastpath):
    """Interning, per-rule LRU caps, hot items, collection expansion, bulk
    columns (tuples and ArgsColumns, the cached and the exact resolution),
    the eviction resets, the snapshot and its adoption."""
    import sentinel_tpu.models.rules as jrules
    import sentinel_tpu_torch.models.rules as trules
    from sentinel_tpu.models import constants as JC
    from sentinel_tpu_torch.models import constants as TC

    want = _index_trace(jrules, JC, jpt.ParamIndex, jpt.ArgsColumns, fastpath)
    got = _index_trace(trules, TC, tpt.ParamIndex, tpt.ArgsColumns, fastpath)
    assert got == want


def test_sketch_mode_with_an_armed_tier_raises():
    """An armed sketch tier no longer raises (the tier is ported): a
    sketch-mode rule gives dense slots only to the tier's promoted values,
    on the entry path and the bulk path, as the JAX index does; without a
    tier or with it disarmed it dense-tracks every value."""
    from types import SimpleNamespace

    import sentinel_tpu.models.rules as jrules
    import sentinel_tpu_torch.models.rules as trules

    def trace(rules_mod, index_cls):
        rules = {"r": [rules_mod.ParamFlowRule("r", param_idx=0, count=2, sketch_mode=True),
                       rules_mod.ParamFlowRule("r", param_idx=1, count=3)]}
        out = []
        for tier in (None, SimpleNamespace(armed=False), SimpleNamespace(armed=True, promoted_values={}),
                     SimpleNamespace(armed=True, promoted_values={"r": frozenset({"hot", "7"})})):
            idx = index_cls(rules, sketch_tier=tier)
            out.append(sorted(idx.sketch_idx_by_resource.items()))
            for args in (("hot", "x"), ("cold", "x"), (7, "y"), (["hot", "cold"], "z")):
                out.append([(s.prow, s.token_count, s.value_key) for s in idx.slots_for("r", args)])
            cols = idx.bulk_cols("r", [("hot", "a"), ("cold", "b"), (None, "a"), ("hot", "c")])
            out.append([(c[1].tolist(), c[2].tolist(), c[3].tolist()) for c in cols])
            out.append(idx.n_rows)
        return out

    assert trace(trules, tpt.ParamIndex) == trace(jrules, jpt.ParamIndex)


# --- the engine cases of test_param_flow.py / test_param_closed_form.py and
# examples/param_flow_demo.py, on both packages ------------------------------


def _qps_rule(lib, resource, count, idx=0, burst=0, duration=1, items=()):
    return lib.st.ParamFlowRule(resource, grade=lib.C.FLOW_GRADE_QPS, param_idx=idx, count=count,
                                burst_count=burst, duration_in_sec=duration, param_flow_item_list=tuple(items))


def _item(lib, obj, count):
    import importlib

    return importlib.import_module(lib.st.__name__ + ".models.rules").ParamFlowItem(object=obj, count=count)


def _tries(lib, res, args_list, ts=None):
    out = []
    for args in args_list:
        if ts is not None:
            lib.clock.set_ms(ts)
        e = lib.st.try_entry(res, args=args)
        out.append(e is not None)
        if e is not None:
            e.exit()
    return out


def _per_value_isolation(lib):
    lib.st.param_flow_rule_manager.load_rules([_qps_rule(lib, "api", 2)])
    got = _tries(lib, "api", [("a",), ("a",), ("a",), ("b",)])
    assert got == [True, True, False, True]
    return got


def _refill_after_duration(lib):
    lib.st.param_flow_rule_manager.load_rules([_qps_rule(lib, "r", 2, duration=1)])
    got = _tries(lib, "r", [("k",)] * 3, ts=0) + _tries(lib, "r", [("k",)] * 3, ts=1500)
    assert got == [True, True, False] * 2
    return got


def _burst_and_hot_items(lib):
    item = _item(lib, "vip", 5)
    lib.st.param_flow_rule_manager.load_rules([_qps_rule(lib, "b", 1, burst=2), _qps_rule(lib, "h", 1, items=[item])])
    got = _tries(lib, "b", [("x",)] * 4) + _tries(lib, "h", [("vip",)] * 6 + [("pleb",)] * 2)
    assert got == [True] * 3 + [False] + [True] * 5 + [False, True, False]
    return got


def _zero_missing_collection(lib):
    lib.st.param_flow_rule_manager.load_rules([_qps_rule(lib, "z", 0), _qps_rule(lib, "m", 1, idx=2),
                                               _qps_rule(lib, "c", 1)])
    got = _tries(lib, "z", [("v",)]) + _tries(lib, "m", [("only-one",)] * 2)
    got += _tries(lib, "c", [(["u1", "u2"],), (["u3", "u1"],)])
    assert got == [False, True, True, True, False]
    return got


def _batched_deferred(lib):
    lib.st.param_flow_rule_manager.load_rules([_qps_rule(lib, "d", 3)])
    ops = [lib.engine.submit_entry("d", ts=0, args=("k",)) for _ in range(6)]
    lib.engine.flush()
    got = [op.verdict.admitted for op in ops]
    assert got == [True] * 3 + [False] * 3
    return got


def _throttle(lib):
    lib.st.param_flow_rule_manager.load_rules([lib.st.ParamFlowRule(
        "t", grade=lib.C.FLOW_GRADE_QPS, param_idx=0, count=10,
        control_behavior=lib.C.CONTROL_BEHAVIOR_RATE_LIMITER, max_queueing_time_ms=250)])
    lib.clock.set_ms(0)
    out = []
    for _ in range(4):
        e = lib.st.try_entry("t", args=("v",))
        out.append((e is not None, lib.clock.now_ms()))
        if e is not None:
            e.exit()
    assert out == [(True, 0), (True, 100), (True, 200), (True, 300)]
    lib.clock.set_ms(1000)
    ops = [lib.engine.submit_entry("t", ts=1000, args=("w",)) for _ in range(8)]
    lib.engine.flush()
    out.append([(op.verdict.admitted, op.verdict.wait_ms) for op in ops])
    return out


def _thread_grade(lib):
    lib.st.param_flow_rule_manager.load_rules([lib.st.ParamFlowRule("svc", grade=lib.C.FLOW_GRADE_THREAD,
                                                                    param_idx=0, count=2)])
    e1, e2 = lib.st.try_entry("svc", args=("u",)), lib.st.try_entry("svc", args=("u",))
    got = [e1 is not None, e2 is not None, lib.st.try_entry("svc", args=("u",)) is not None]
    w = lib.st.try_entry("svc", args=("w",))
    got.append(w is not None)
    e1.exit()
    got.append(lib.st.try_entry("svc", args=("u",)) is not None)
    assert got == [True, True, False, True, True]
    return got


def _lru_eviction(lib):
    lib.st.param_flow_rule_manager.load_rules([_qps_rule(lib, "ev", 1)])
    lib.engine.param_index._caps[0] = 2
    got = _tries(lib, "ev", [("a",), ("b",), ("a",), ("c",), ("b",)])
    assert got == [True, True, False, True, True]
    return got


def _heavy_hitter_bulk(lib):
    lib.engine.set_flow_rules([lib.st.FlowRule("hh", count=100000)])
    lib.engine.set_param_rules({"hh": [lib.st.ParamFlowRule("hh", param_idx=0, count=4)]})
    lib.clock.set_ms(1000)
    n = 600
    col = [("a",) if i % 2 == 0 else ("b",) for i in range(n)]
    g = lib.engine.submit_bulk("hh", n, ts=np.full(n, 1000, dtype=np.int32), args_column=col)
    lib.engine.flush()
    adm = np.asarray(g.admitted)
    assert adm[::2].sum() == 4 and adm[1::2].sum() == 4
    return adm.tolist()


def _mixed_ts_segmented(lib):
    lib.engine.set_flow_rules([lib.st.FlowRule("mx", count=100000)])
    lib.engine.set_param_rules({"mx": [lib.st.ParamFlowRule("mx", param_idx=0, count=2)]})
    ops = [lib.engine.submit_entry("mx", ts=t, args=("k",)) for t in [1000] * 4 + [2500] * 4]
    lib.engine.flush()
    adm = [op.verdict.admitted for op in ops]
    assert sum(adm[:4]) == 2 and sum(adm[4:]) == 2
    return adm


def _throttle_not_closed(lib):
    lib.engine.set_flow_rules([lib.st.FlowRule("th", count=100000)])
    lib.engine.set_param_rules({"th": [lib.st.ParamFlowRule(
        "th", param_idx=0, count=10, control_behavior=lib.C.CONTROL_BEHAVIOR_RATE_LIMITER,
        max_queueing_time_ms=500)]})
    lib.clock.set_ms(1000)
    ops = [lib.engine.submit_entry("th", ts=1000, args=("k",)) for _ in range(8)]
    lib.engine.flush()
    got = [(op.verdict.admitted, op.verdict.wait_ms) for op in ops]
    assert got == [(True, w) for w in (0, 100, 200, 300, 400)] + [(False, 0)] * 3
    return got


def _param_demo(lib):
    """examples/param_flow_demo.py's sequence."""
    lib.st.param_flow_rule_manager.load_rules([lib.st.ParamFlowRule(
        resource="buy", param_idx=0, count=2,
        param_flow_item_list=[_item(lib, "flash-sale", 5)])])
    out = {}
    for product in ("normal-item", "flash-sale"):
        out[product] = sum(_tries(lib, "buy", [(product,)], ts=100 + i)[0] for i in range(7))
    assert out == {"normal-item": 2, "flash-sale": 5}
    return [out]


def _attribution(lib):
    """BLOCK_PARAM raises ParamFlowBlockError naming the entry's first param
    rule; a flow block on the same entry keeps the flow rule."""
    lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("x", count=3)])
    lib.st.param_flow_rule_manager.load_rules([_qps_rule(lib, "x", 1), _qps_rule(lib, "x", 9, idx=1)])
    out = []
    for args in [("a", "b")] * 2 + [("c", "d")] * 3:
        try:
            lib.st.entry("x", args=args).exit()
            out.append("pass")
        except Exception as exc:
            out.append((type(exc).__name__, exc.rule.to_dict()))
    return out


def _gateway_bulk_and_stream(lib):
    """Bulk args columns in the gateway shape (one ts and acquire: the closed
    form) beside singles with a throttle and a THREAD rule, over several
    windows; the final param state is compared too."""
    st, C = lib.st, lib.C
    lib.engine.set_flow_rules([st.FlowRule("gw", count=10_000)])
    lib.st.param_flow_rule_manager.load_rules([
        st.ParamFlowRule("gw", param_idx=0, count=5, burst_count=2),
        st.ParamFlowRule("api", param_idx=0, count=4, control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER,
                         max_queueing_time_ms=400),
        st.ParamFlowRule("thr", param_idx=0, count=2, grade=C.FLOW_GRADE_THREAD),
    ])
    rng = np.random.default_rng(9)
    out, held = [], []
    for step in range(8):
        t = 1000 + step * 370
        lib.clock.set_ms(t)
        col = [(f"ip{int(x)}",) for x in rng.zipf(1.5, 200) % 17]
        g = lib.engine.submit_bulk("gw", 200, ts=t, args_column=col)
        ops = [lib.engine.submit_entry("api", ts=t, args=(f"u{i % 3}",)) for i in range(6)]
        ops += [lib.engine.submit_entry("thr", ts=t, args=(f"k{i % 2}",)) for i in range(3)]
        lib.engine.flush()
        out.append((g.admitted.tolist(), [(o.verdict.admitted, o.verdict.wait_ms) for o in ops]))
        for o in ops[6:]:
            if o.verdict.admitted:
                held.append(o)
        if step % 2:
            for o in held:
                lib.engine.submit_exit(o.rows, rt=5, ts=t, param_rows=o.param_thread_rows)
            held = []
    lib.engine.flush()
    out.append([np.asarray(a.cpu() if hasattr(a, "cpu") else a).tolist() for a in lib.engine.param_dyn])
    return out


ENGINE_CASES = {
    "per_value_isolation": _per_value_isolation,
    "refill_after_duration": _refill_after_duration,
    "burst_and_hot_items": _burst_and_hot_items,
    "zero_missing_collection": _zero_missing_collection,
    "batched_deferred": _batched_deferred,
    "throttle": _throttle,
    "thread_grade": _thread_grade,
    "lru_eviction": _lru_eviction,
    "heavy_hitter_bulk_closed_form": _heavy_hitter_bulk,
    "mixed_ts_segmented": _mixed_ts_segmented,
    "throttle_not_closed_form": _throttle_not_closed,
    "param_flow_demo": _param_demo,
    "attribution": _attribution,
    "gateway_bulk_and_stream": _gateway_bulk_and_stream,
}


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_engine_param_lockstep(name):
    run_on_both(ENGINE_CASES[name])


def test_engine_param_modes():
    """The host mode selection (Engine._param_rounds_for), as the JAX
    engine's: -1 one ts; -S mixed ts up to 8 per row; acquire 0 and the
    throttle are not eligible; and param_force_path = "scan"."""
    from sentinel_tpu.runtime.engine import Engine as JEngine
    from sentinel_tpu_torch.runtime.engine import Engine

    rng = np.random.default_rng(2)
    for _ in range(40):
        n = int(rng.integers(1, 30))
        args = (rng.integers(0, 5, n).astype(np.int32), np.where(rng.random(n) < 0.9, 1, 0).astype(np.int32),
                np.where(rng.random(n) < 0.9, 0, 2).astype(np.int32),
                (1000 + rng.integers(0, int(rng.integers(1, 12)), n) * 100).astype(np.int32),
                np.full(n, int(rng.integers(0, 3)), np.int32))
        assert Engine._param_rounds_for(*args) == JEngine._param_rounds_for(*args)
    eng = Engine(device="cpu")
    import sentinel_tpu_torch as st

    eng.set_param_rules({"p": [st.ParamFlowRule("p", param_idx=0, count=2)]})
    ops = [eng.submit_entry("p", ts=5, args=("k",)) for _ in range(4)]
    assert eng._encode_param(ops, [], eng.param_index)[1] == -1
    eng.param_force_path = "scan"
    assert eng._encode_param(ops, [], eng.param_index)[1] == 4


# --- the epoch rebase of the param state ---------------------------------------


def test_rebase_large_offset_keeps_param_never():
    """The real ~22-day rebase shifts by about 1.9e9 ms. A value never seen
    keeps PARAM_NEVER in last_add and latest, and a live time moves by the
    offset. (The JAX engine's int32 shift wraps PARAM_NEVER - 1.9e9 to
    about +1.32e9 here: see ROADMAP Queue 3.)"""
    from sentinel_tpu_torch.runtime.engine import Engine
    import sentinel_tpu_torch as st

    eng = Engine(device="cpu")
    eng.set_param_rules({"p": [st.ParamFlowRule("p", param_idx=0, count=2)]})
    d = eng.param_dyn
    d.last_add[1], d.latest[2] = 1_950_000_500, 1_950_001_000
    offset = 1_900_020_000
    eng._apply_rebase(offset)
    assert int(d.last_add[0]) == PARAM_NEVER and int(d.latest[0]) == PARAM_NEVER
    assert int(d.latest[1]) == PARAM_NEVER and int(d.last_add[2]) == PARAM_NEVER
    assert (int(d.last_add[1]), int(d.latest[2])) == (49_980_500, 49_981_000)
    # What the JAX shift gives for the same never-seen row:
    jax_never = int(jnp.maximum(jnp.int32(PARAM_NEVER) - jnp.int32(offset), jnp.int32(PARAM_NEVER)))
    assert jax_never == 1_321_205_472


def test_rebase_parity_small_offset():
    """At a 60,000 ms offset nothing wraps and the two engines agree on the
    shifted param state, the flow shaping state and the windows."""
    import sentinel_tpu as jst
    import sentinel_tpu_torch as st
    from sentinel_tpu.runtime.engine import Engine as JEngine
    from sentinel_tpu_torch.runtime.engine import Engine

    rng = np.random.default_rng(4)
    pr = 8
    arrs = (rng.integers(-3, 9, pr), np.where(rng.random(pr) < 0.4, PARAM_NEVER, rng.integers(-2**29, 90_000, pr)),
            np.where(rng.random(pr) < 0.4, PARAM_NEVER, rng.integers(-2**29, 90_000, pr)), rng.integers(0, 3, pr))
    arrs = [np.asarray(a, np.int32) for a in arrs]
    j, t = JEngine(), Engine(device="cpu")
    j.set_param_rules({"p": [jst.ParamFlowRule("p", param_idx=0, count=2)]})
    t.set_param_rules({"p": [st.ParamFlowRule("p", param_idx=0, count=2)]})
    j.param_dyn = jpt.ParamDynState(*map(jnp.asarray, arrs))
    t.param_dyn = tpt.param_state_from_numpy(arrs, CPU)
    j._apply_rebase(60_000)
    t._apply_rebase(60_000)
    assert_same(tuple(jax.device_get(j.param_dyn)), tuple(a.numpy() for a in t.param_dyn), "param state")
    assert_same(tuple(jax.device_get(j.flow_dyn)), tuple(a.numpy() for a in t.flow_dyn), "flow state")
