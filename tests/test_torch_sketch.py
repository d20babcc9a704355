"""The sketch tier of the port (sentinel_tpu_torch/runtime/sketch.py)
against the JAX package, bit for bit: the fold K11's plain version
against the JAX ``sketch_fold`` over seeded inputs (decay, padding,
duplicate ids, a full candidate table with touched candidates, equal
counts, depths 1-8, widths 8 to 2^16) and its key edges (the id 2^31 - 1,
duplicates, few distinct ids, estimates wrapped negative, ties at the
top-C boundary); the host hashes and the
space-saving mirror; and the JAX Engine and the port's
``Engine(device="cpu")`` with the tier armed, driven in lockstep through
the cases of tests/test_sketch.py (promotion and demotion of values and
of unconfigured and over-cap resources, the grant budget, a user reload,
both cold ceilings, gossip frames between two tiers), compared after every
flush: verdicts, the count-min array, the candidate table, the promoted
values and resources and the flow rules. Tolerance zero."""

import zlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.models.rules import FlowRule as JFlowRule
from sentinel_tpu.models.rules import ParamFlowRule as JParamFlowRule
from sentinel_tpu.runtime import sketch as js
from sentinel_tpu.runtime.engine import Engine as JEngine
from sentinel_tpu.utils.clock import ManualClock as JClock
from sentinel_tpu.utils.config import config as jconfig
from sentinel_tpu_torch.core import errors as E
from sentinel_tpu_torch.metrics.nodes import stats_to_numpy
from sentinel_tpu_torch.models.rules import FlowRule, ParamFlowRule
from sentinel_tpu_torch.runtime import sketch as ts
from sentinel_tpu_torch.runtime.engine import Engine
from sentinel_tpu_torch.utils.clock import ManualClock
from sentinel_tpu_torch.utils.config import config

from torch_parity import SKETCH_EDGE_CASES, assert_same, block_of, run_on_both, sketch_edge_case

# --- K11: sketch_fold ------------------------------------------------------


def _fold_case(rng, depth, width, c, s, *, equal=False, dup=True, full=True):
    """(cm, cand_ids, cand_cnt, ids, w) as numpy: a populated count-min
    array, a candidate table (full, or with empty slots) whose ids partly
    recur in the batch, and a batch with duplicate ids and -1 padding."""
    cm = rng.integers(0, 60, (depth, width)).astype(np.int32)
    pool = rng.choice(1 << 31, size=4 * (c + s), replace=False).astype(np.int32)
    cand = pool[:c].copy()
    if not full:
        cand[rng.random(c) < 0.4] = -1
    cnt = np.where(cand >= 0, rng.integers(1, 200, c), 0).astype(np.int32)
    ids = pool[c : c + s].copy()
    touched = rng.random(s) < 0.3
    ids[touched] = rng.choice(cand[cand >= 0], size=int(touched.sum())) if (cand >= 0).any() else ids[touched]
    if dup:
        ids[s // 2 : s // 2 + s // 8] = ids[: s // 8]
    ids[-(s // 6) :] = -1
    w = (np.full(s, 3) if equal else rng.integers(1, 5, s)).astype(np.int32)
    if equal:
        cm[:] = 7
        cnt[cand >= 0] = 7
    return cm, cand, cnt, ids, w


def _fold_both(case, decay):
    cm, cand, cnt, ids, w = case
    jout = js.sketch_fold(
        js.SketchState(jnp.asarray(cm), jnp.asarray(cand), jnp.asarray(cnt)),
        js.SketchBatch(jnp.asarray(ids), jnp.asarray(w)),
        decay=decay,
    )
    state = ts.sketch_state_from_numpy((cm, cand, cnt), "cpu")
    got = ts.sketch_fold(state, ts.SketchBatch(torch.from_numpy(ids.copy()), torch.from_numpy(w.copy())), decay)
    assert got is state  # updated in place
    return jax.device_get(jout), ts.sketch_state_to_numpy(state)


@pytest.mark.parametrize("decay", [False, True])
@pytest.mark.parametrize(
    "depth,width,c,s,kw",
    [
        (4, 2048, 64, 512, {}),
        (1, 8, 16, 256, {}),  # collisions everywhere
        (8, 1 << 16, 64, 1024, {}),
        (4, 2048, 64, 256, dict(equal=True)),  # every count equal: the tie order
        (2, 64, 32, 128, dict(full=False)),  # empty candidate slots
        (8, 8, 5, 64, dict(dup=False)),  # more batch keys than candidates, tiny width
    ],
    ids=["default", "depth1-width8", "depth8-width65536", "ties", "empty-slots", "depth8-width8"],
)
@pytest.mark.parametrize("seed", [0, 1])
def test_sketch_fold_matches_jax(seed, depth, width, c, s, kw, decay):
    rng = np.random.default_rng(seed * 31 + depth)
    want, got = _fold_both(_fold_case(rng, depth, width, c, s, **kw), decay)
    assert_same(want, got, "sketch state")
    assert (got.cand_ids >= 0).any()


@pytest.mark.parametrize("decay", [False, True])
@pytest.mark.parametrize("case", SKETCH_EDGE_CASES)
def test_sketch_fold_edges_match_jax(case, decay):
    """The key edges of the fold (torch_parity.sketch_edge_case): the id
    2^31 - 1 in the batch (added, never a head) and as a candidate;
    duplicate ids next to each other and far apart; fewer distinct ids
    than free slots; estimates wrapped negative and a negative count left
    in the table; candidates touched at the top-C boundary among equal
    counts."""
    cm, cand, cnt, ids, w = sketch_edge_case(case)
    want, got = _fold_both((cm, cand, cnt, ids, w), decay)
    assert_same(want, got, case)
    if case == "id_max":
        assert int((want.cand_ids == 2**31 - 1).sum()) <= 1, "the id 2^31 - 1 became a head"
    elif case == "few_distinct":
        empty = want.cand_ids == -1
        assert empty.any() and not want.cand_cnt[empty].any()
    elif case == "negative_estimates":
        assert (js.cm_estimate(np.asarray(want.cm), ids[ids >= 0]) < 0).any(), "no estimate wrapped"


def test_sketch_fold_all_padding_and_zero_weights():
    """A batch of padding only halves (or keeps) the table; weight-0 keys
    still enter the candidates at their estimate."""
    rng = np.random.default_rng(5)
    cm, cand, cnt, ids, w = _fold_case(rng, 4, 256, 16, 64)
    for case in ((cm, cand, cnt, np.full(64, -1, np.int32), w), (cm, cand, cnt, ids, np.zeros(64, np.int32))):
        for decay in (False, True):
            want, got = _fold_both(case, decay)
            assert_same(want, got, "sketch state")


def test_host_hash_and_estimate_match_jax():
    """crc32_batch (with a prefix state), key_id, _hash_np and cm_estimate:
    the same ids and cells as the JAX package's twins and zlib, and the
    host estimate equal to the device fold's."""
    rng = np.random.default_rng(3)
    keys = ["", "\x01res", "\x02api\x1fv1", "é¿ሴ日本語", "v" * 300] + [f"k{i}" for i in range(200)]
    raw = [k.encode("utf-8", "surrogatepass") for k in keys]
    for init in (0, zlib.crc32(b"\x02api\x1f")):
        want = np.array([zlib.crc32(b, init) for b in raw], dtype=np.uint32)
        np.testing.assert_array_equal(ts.crc32_batch(raw, init=init), want)
        np.testing.assert_array_equal(ts.crc32_batch(raw, init=init), js.crc32_batch(raw, init=init))
    assert [ts.key_id(k) for k in keys] == [js.key_id(k) for k in keys]
    ids = np.r_[rng.integers(0, 1 << 31, 500), [0, 2**31 - 1, -1]].astype(np.int64)
    for d in range(8):
        for width in (8, 2048, 1 << 16):
            np.testing.assert_array_equal(ts._hash_np(ids, d, width), js._hash_np(ids, d, width))
            np.testing.assert_array_equal(
                ts._hash_torch(torch.from_numpy(ids & 0xFFFFFFFF), d, width).numpy(), js._hash_np(ids, d, width)
            )
    cm, cand, cnt, bids, w = _fold_case(rng, 4, 1024, 16, 256)
    _, got = _fold_both((cm, cand, cnt, bids, w), False)
    est = ts.cm_estimate(got.cm, got.cand_ids[got.cand_ids >= 0])
    np.testing.assert_array_equal(est, js.cm_estimate(got.cm, got.cand_ids[got.cand_ids >= 0]))
    assert (est >= got.cand_cnt[got.cand_ids >= 0]).all()


def test_host_space_saving_matches_jax():
    rng = np.random.default_rng(9)
    a, b = js._HostSpaceSaving(8), ts._HostSpaceSaving(8)
    for step in range(400):
        if step % 37 == 36:
            a.decay()
            b.decay()
            continue
        key, wt = f"k{int(rng.zipf(1.3)) % 40}", int(rng.integers(0, 6))
        a.offer(key, wt)
        b.offer(key, wt)
        assert a.counts == b.counts
    a.clear()
    b.clear()
    assert a.counts == b.counts == {}


# --- the engine with the tier armed, JAX and port in lockstep ---------------

SKETCH_CONFIG = {
    config.SKETCH_ENABLED: "true",
    config.SKETCH_PROMOTE_QPS: "5",
    config.SKETCH_RESOURCE_QPS: "50",
    config.SKETCH_WINDOW_MS: "1000",
    config.SKETCH_DEMOTE_WINDOWS: "2",
}
COLD_CONFIG = {config.SKETCH_ENABLED: "true", config.SKETCH_WINDOW_MS: "1000", config.SKETCH_COLD_QPS: "10"}


class _Pair:
    """A JAX Engine and a port Engine(device="cpu") under their own
    ManualClocks, both built with ``cfg`` set; every call goes to both."""

    def __init__(self, cfg, start_ms=0):
        for key, value in cfg.items():
            config.set(key, value)
            jconfig.set(key, value)
        try:
            self.jclock, self.tclock = JClock(start_ms), ManualClock(start_ms)
            self.j = JEngine(clock=self.jclock)
            self.t = Engine(clock=self.tclock, device="cpu")
        finally:
            config.reset()
            jconfig.reset()
        assert self.t.sketch.armed
        self.pending = []

    def advance(self, ms):
        self.jclock.advance(ms)
        self.tclock.advance(ms)

    def both(self, name, *args, **kw):
        out = getattr(self.j, name)(*args, **kw), getattr(self.t, name)(*args, **kw)
        if name in ("submit_bulk", "submit_entry"):
            self.pending.append(out)
        return out

    def rules(self, name, jrules, trules):
        getattr(self.j, name)(jrules)
        getattr(self.t, name)(trules)

    def flush(self, step=""):
        self.j.flush()
        self.t.flush()
        self.compare(step)

    def compare(self, step=""):
        for jo, to in self.pending:
            assert (jo is None) == (to is None), step
            if jo is None:
                continue
            if hasattr(jo, "n"):
                for name in ("admitted", "reason", "wait_ms"):
                    assert_same(np.asarray(getattr(jo, name)), getattr(to, name), f"{step}: bulk {name}")
            else:
                jv, tv = jo.verdict, to.verdict
                assert (jv.admitted, jv.reason, jv.wait_ms, jv.limit_type) == (
                    tv.admitted, tv.reason, tv.wait_ms, tv.limit_type), step
        self.pending = []
        jt, tt = self.j.sketch, self.t.sketch
        assert_same(jax.device_get(jt.dev_state), ts.sketch_state_to_numpy(tt.dev_state), f"{step}: sketch state")
        assert jt.promoted_values == tt.promoted_values, step
        assert sorted(jt._promoted_res) == sorted(tt._promoted_res), step
        assert (jt.cold_blocks, jt.cold_value_blocks) == (tt.cold_blocks, tt.cold_value_blocks), step
        assert jt.candidates_snapshot(64) == tt.candidates_snapshot(64), step
        assert [(r.resource, r.count, r.from_sketch) for r in self.j.flow_index.get_rules()] == [
            (r.resource, r.count, r.from_sketch) for r in self.t.flow_index.get_rules()], step
        assert self.j.param_index.n_rows == self.t.param_index.n_rows, step
        if jt._host_cm is not None:
            np.testing.assert_array_equal(jt._host_cm, tt._host_cm, err_msg=step)
        assert_same(jax.device_get(self.j.stats), stats_to_numpy(self.t.stats), f"{step}: stats")


def _sketch_rules(count=3.0):
    return ({"api": [JParamFlowRule(resource="api", param_idx=0, count=count, sketch_mode=True)]},
            {"api": [ParamFlowRule(resource="api", param_idx=0, count=count, sketch_mode=True)]})


def test_param_value_promotion_and_demotion():
    """bench.py's _run_sketch_stage scaled down: a high-cardinality value
    stream (every value distinct) with 16 hot values that must promote
    into dense rows; then the hot values go cold and demote, releasing
    their rows."""
    pair = _Pair(SKETCH_CONFIG, start_ms=1000)
    pair.rules("set_param_rules", *_sketch_rules())
    hot = [f"hot{i}" for i in range(16)]
    uid = 0
    for step in range(16):
        col = [(f"v{uid + j}",) for j in range(96)] + [(h,) for h in hot for _ in range(4)]
        uid += 96
        pair.both("submit_bulk", "api", n=len(col), args_column=col)
        pair.both("submit_entry", "api", args=(hot[step % 16],))
        pair.flush(f"warm {step}")
        pair.advance(250)
    promoted = pair.t.sketch.promoted_values.get("api", frozenset())
    assert set(hot) <= promoted and pair.t.param_index.n_rows >= 1
    for step in range(12):
        pair.both("submit_bulk", "api", n=8, args_column=[("c",)] * 8)
        pair.flush(f"cool {step}")
        pair.advance(1100)
    assert not set(hot) & pair.t.sketch.promoted_values.get("api", frozenset())
    pair.flush("release")  # the demotions' row releases land at the next flush
    assert "hot0" not in pair.t.param_index._values[0]


def test_unconfigured_resource_synthetic_rule_and_demotion():
    pair = _Pair(SKETCH_CONFIG)
    for step in range(6):
        pair.both("submit_bulk", "burst", n=256)
        pair.flush(f"burst {step}")
        pair.advance(400)
    rules = {r.resource: r for r in pair.t.flow_index.get_rules()}
    assert rules["burst"].from_sketch and rules["burst"].count == 50.0
    pair.both("submit_bulk", "burst", n=200)
    pair.flush("guarded")
    for step in range(10):
        pair.both("submit_bulk", "other", n=8)
        pair.flush(f"cool {step}")
        pair.advance(1100)
    pair.flush("after")
    assert "burst" not in {r.resource for r in pair.t.flow_index.get_rules()}


def test_over_cap_promotion_and_grant_budget():
    """An over-cap resource (pass-through, noted as unrouted) promotes
    past the cap; then a churn of 12 over-cap promotions stops at the
    cumulative grant budget of 8 x promote.max."""
    pair = _Pair(SKETCH_CONFIG)
    for eng in (pair.j, pair.t):
        eng.nodes.max_resources = 2
    pair.both("submit_bulk", "r1", n=1)
    pair.both("submit_bulk", "r2", n=1)
    assert pair.both("submit_bulk", "capped-hot", n=64) == (None, None)  # pass-through over the cap
    for step in range(6):
        pair.both("submit_bulk", "capped-hot", n=256)
        pair.flush(f"capped {step}")
        pair.advance(400)
    assert "capped-hot" in {r.resource for r in pair.t.flow_index.get_rules()}
    pair.both("submit_bulk", "capped-hot", n=200)
    pair.flush("guarded")
    for eng, rule_cls in ((pair.j, JFlowRule), (pair.t, FlowRule)):
        tier = eng.sketch
        eng.nodes.max_resources = 0
        tier.promote_max = 1
        with tier._lock:
            for i in range(12):
                tier._promoted_res[f"churn{i}"] = rule_cls(resource=f"churn{i}", count=50.0, from_sketch=True)
            tier._actions.append(("flow", None))
        tier.apply_actions()
    assert len(pair.t.sketch._cap_grants) == len(pair.j.sketch._cap_grants) == 8
    assert sorted(pair.t.sketch._promoted_res) == sorted(pair.j.sketch._promoted_res)
    pair.compare("budget")


def test_user_reload_reasserts_synthetics():
    pair = _Pair(SKETCH_CONFIG)
    for step in range(6):
        pair.both("submit_bulk", "burst", n=256)
        pair.flush(f"burst {step}")
        pair.advance(400)
    pair.rules("set_flow_rules", [JFlowRule("user-res", count=100)], [FlowRule("user-res", count=100)])
    assert "burst" not in {r.resource for r in pair.t.flow_index.get_rules()}
    for step in range(3):
        pair.both("submit_bulk", "burst", n=256)
        pair.flush(f"again {step}")
        pair.advance(400)
    names = {r.resource for r in pair.t.flow_index.get_rules()}
    assert "burst" in names and "user-res" in names


def test_cold_resource_ceiling():
    """The resource ceiling (2 x 10 qps x 1 s): singles and bulk groups
    refused at the door, configured, degrade-guarded and promoted
    resources exempt, over-cap resources covered, lifted by decay."""
    pair = _Pair(COLD_CONFIG, start_ms=1000)
    pair.rules("set_flow_rules", [JFlowRule("ruled", count=1e9)], [FlowRule("ruled", count=1e9)])
    pair.both("submit_bulk", "coldhot", n=64)
    pair.both("submit_bulk", "ruled", n=64)
    pair.flush("heat")
    g = pair.both("submit_bulk", "coldhot", n=8)[1]
    assert g.reason.tolist() == [E.BLOCK_SKETCH] * 8
    op = pair.both("submit_entry", "coldhot")[1]
    assert (op.verdict.reason, op.verdict.limit_type) == (E.BLOCK_SKETCH, "cold")
    pair.both("submit_bulk", "ruled", n=8)
    pair.flush("blocked")
    for eng in (pair.j, pair.t):
        eng.nodes.max_resources = eng.nodes._n_resources  # every new resource is over the cap
    assert pair.both("submit_bulk", "capped", n=64) == (None, None)
    pair.both("submit_bulk", "ruled", n=1)  # a routed op: the flush runs a chunk
    pair.flush("capped")
    g = pair.both("submit_bulk", "capped", n=8)[1]
    assert g is not None and g.reason.tolist() == [E.BLOCK_SKETCH] * 8
    pair.compare("over cap")
    for step in range(3):
        pair.advance(1100)
        pair.both("submit_bulk", "ruled", n=1)
        pair.flush(f"decay {step}")
    g = pair.both("submit_bulk", "coldhot", n=4)[1]
    pair.flush("lifted")
    assert g.admitted.all()
    assert pair.t.sketch.cold_blocks >= 16


def test_cold_value_ceiling():
    """The value ceiling on a sketch-mode rule: the hot value refused
    (limit type cold_value), another value untouched, a uniform hot bulk
    group refused whole, a mixed one declined, a promoted value exempt."""
    pair = _Pair(COLD_CONFIG, start_ms=1000)
    pair.rules("set_param_rules", *_sketch_rules(count=1e9))
    pair.both("submit_bulk", "api", n=64, args_column=[("hot-ip",)] * 64)
    pair.flush("heat")
    op = pair.both("submit_entry", "api", args=("hot-ip",))[1]
    assert (op.verdict.reason, op.verdict.limit_type) == (E.BLOCK_SKETCH, "cold_value")
    op2 = pair.both("submit_entry", "api", args=("cold-ip",))[1]
    g = pair.both("submit_bulk", "api", n=6, args_column=[("hot-ip",)] * 6)[1]
    assert g.reason.tolist() == [E.BLOCK_SKETCH] * 6
    for eng in (pair.j, pair.t):
        with pytest.raises(ValueError):
            eng.submit_bulk("api", n=2, args_column=[("hot-ip",), ("cold-ip",)])
    pair.flush("blocked")
    assert op2.verdict.admitted
    for eng in (pair.j, pair.t):
        eng.sketch.promoted_values = {"api": frozenset({"hot-ip"})}
    pair.both("submit_entry", "api", args=("hot-ip",))
    pair.flush("promoted")
    assert pair.t.sketch.cold_value_blocks == 7


def test_gossip_snapshot_and_merge():
    """Two tiers with gossip armed (the frames go from tier to tier by hand
    here; tests/test_torch_gossip.py carries them between agents over TCP):
    each takes the other's snapshot, and a key hot only fleet-wide promotes
    on both packages alike."""
    cfg = dict(SKETCH_CONFIG, **{config.GOSSIP_ENABLED: "true", config.SKETCH_PROMOTE_QPS: "40"})
    pair = _Pair(SKETCH_CONFIG)
    pair.rules("set_param_rules", *_sketch_rules())
    for key, value in cfg.items():
        config.set(key, value)
        jconfig.set(key, value)
    try:
        tiers = {"j": [js.SketchTier(pair.j), js.SketchTier(pair.j)], "t": [ts.SketchTier(pair.t),
                                                                           ts.SketchTier(pair.t)]}
    finally:
        config.reset()
        jconfig.reset()
    pindex = {"j": pair.j.param_index, "t": pair.t.param_index}
    findex = {"j": pair.j.flow_index, "t": pair.t.flow_index}
    out = {}
    for pkg, (a, b) in tiers.items():
        assert a.gossip_armed
        seen = []
        for step, now in enumerate((1000, 1400, 2100, 2600)):
            for t_i, tier in enumerate((a, b)):
                col = [("fleet-hot",)] * 30 + [(f"{t_i}-{step}-{j}",) for j in range(10)]
                g = SimpleNamespace(resource="api", acquire=np.ones(len(col), np.int32), args_column=col)
                ids, w = tier.encode_chunk([], [g], findex[pkg], pindex[pkg])
                tier.decay_due(now)
                order = np.argsort(-w, kind="stable")[:8]
                tier.on_drain(ids[order], w[order], now)
            for src, dst, origin in ((a, b, "a"), (b, a, "b")):
                wid, cm, cands = src.gossip_snapshot()
                assert dst.merge_remote(origin, wid, cm, cands)
                assert not dst.merge_remote(origin, wid, cm[:, :4], cands)  # foreign geometry dropped
            seen.append((a.gossip_snapshot()[2], b.gossip_snapshot()[2], dict(a.promoted_values),
                         dict(b.promoted_values), a.gossip_info()["merges"], b._fleet_by_key({})))
        out[pkg] = seen
    assert out["t"] == out["j"]
    assert "fleet-hot" in out["t"][-1][2].get("api", ())


def _cold_api_scenario(lib):
    """st.entry on an unconfigured resource over the cold ceiling raises the
    sketch's block error; a configured one passes."""
    for key, value in COLD_CONFIG.items():
        lib.config.set(key, value)
    kw = {} if lib.st.__name__ == "sentinel_tpu" else {"device": "cpu"}
    lib.api.reset(clock=lib.clock, **kw)
    lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("ruled", count=1e9)])
    lib.clock.set_ms(1000)
    out = []
    for step in range(30):
        lib.clock.set_ms(1000 + step * 10)
        out.append(block_of(lambda: lib.st.entry("coldhot")))
        out.append(block_of(lambda: lib.st.entry("ruled")))
    for now in (2100, 3100):  # flushes in two later windows halve the estimate
        lib.clock.set_ms(now)
        out.append(block_of(lambda: lib.st.entry("ruled")))
    lib.clock.set_ms(3500)
    out.append(block_of(lambda: lib.st.entry("coldhot")))
    blocked = [o for o in out if o != "pass"]
    assert blocked and all(b[0] == "SketchColdBlockError" for b in blocked)
    assert out[-1] == "pass"
    return out


def test_api_cold_ceiling_block_error():
    run_on_both(_cold_api_scenario)
