"""The embedded cluster token service of the port (sentinel_tpu_torch/
cluster/) against the JAX package, bit for bit: the decision pass K12's
plain version against the JAX ``_batch_decide`` (plain and atomic,
namespace guards that trip, batches that are not powers of two, rows that
grow, window buckets that roll); the ``DefaultTokenService`` of both
packages in lockstep (GLOBAL and AVG_LOCAL thresholds, NO_RULE_EXISTS,
TOO_MANY_REQUEST, param tokens, held concurrency tokens, flow_stats);
and both engines in embedded server mode on the cases of
tests/test_cluster.py, test_cluster_param.py and test_cluster_concurrent.py
(through ``run_on_both``). Tolerance zero."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.cluster import token_service as jts
from sentinel_tpu.metrics import metric_array as jma
from sentinel_tpu_torch.cluster import token_service as tts
from sentinel_tpu_torch.metrics import metric_array as tma

from torch_parity import assert_same, block_of, run_on_both

CPU = torch.device("cpu")


# --- K12: _batch_decide -----------------------------------------------------


def _decide_both(jstate, tstate, arrays, now, atomic):
    jout = jts._batch_decide(jstate, *(jnp.asarray(a) for a in arrays), jnp.int32(now), atomic=atomic)
    tout = tts.unpack_decision(tts.batch_decide(tstate, *(torch.from_numpy(a.copy()) for a in arrays), now,
                                                atomic=atomic))
    return jout[0], jax.device_get(jout[1:]), tout


def _per_group_charges(keys, acquire):
    """The charge of each request as a plain per-group exclusive sum
    (int32-wrapped): what JAX's cumsum-minus-cummax equals while the
    batch's acquire sum stays below 2^31."""
    out = np.zeros(len(keys), dtype=np.int64)
    for k in np.unique(keys):
        idx = np.flatnonzero(keys == k)
        out[idx] = np.cumsum(acquire[idx].astype(np.int64)) - acquire[idx]
    return out.astype(np.int32)


@pytest.mark.parametrize("atomic", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, pytest.param(3, id="wrap"), pytest.param(4, id="b1024")])
def test_batch_decide_matches_jax(seed, atomic):
    """Twelve batches of 5-40 requests over 1.5 s (the ten 100 ms buckets
    roll), flow rows on a Zipf-ish draw, namespace guards low enough to
    trip, 10% invalid requests; the state grows by a doubling midway.
    "wrap": acquire near 2^31 / B, so the batch's int32 cumsum passes 2^31
    and JAX's running max picks an earlier group's head (a per-group sum
    would differ: asserted). "b1024": batches of 1,024 requests."""
    rng = np.random.default_rng(seed)
    nrows = 32
    jstate = jma.make_state(nrows, jts.CLUSTER_CFG)
    tstate = tma.make_state(nrows, tts.CLUSTER_CFG, CPU)
    now = 1000
    seen = np.zeros(3, dtype=int)
    trap = 0
    for step in range(12):
        if step == 6:
            nrows *= 2
            jstate = jma.grow(jstate, nrows, jts.CLUSTER_CFG)
            tstate = tma.grow(tstate, nrows, tts.CLUSTER_CFG)
        now += int(rng.choice([0, 40, 100, 230]))
        b = 1024 if seed == 4 else int(rng.choice([5, 8, 13, 24, 40]))
        rows = np.minimum(rng.zipf(1.5, b) - 1, nrows - 5).astype(np.int32)
        ns = np.where(rng.random(b) < 0.8, rng.integers(nrows - 4, nrows, b), -1).astype(np.int32)
        acq = rng.integers(1, 4, b).astype(np.int32)
        thr = rng.choice([3.0, 10.0, 40.0, 1e9], b).astype(np.float32)
        nthr = rng.choice([15.0, 60.0], b).astype(np.float32)
        if seed == 4:
            thr, nthr = thr * 40, nthr * 40
        valid = rng.random(b) < 0.9
        if seed == 3:
            acq = rng.integers(2**31 // b, 3 * (2**31 // b), b).astype(np.int32)
            thr = rng.choice([3.0, 1e9, 1e10, 3e10], b).astype(np.float32)
            nthr = rng.choice([1e9, 1e10, 3e10], b).astype(np.float32)
            keys = np.where(valid & (ns >= 0), ns, nrows)
            trap += int((tts._consumed(torch.from_numpy(keys), torch.from_numpy(acq)).numpy()
                         != _per_group_charges(keys, acq)).any())
        jstate, want, got = _decide_both(jstate, tstate, (rows, ns, acq, thr, nthr, valid), now, atomic)
        assert_same(tuple(want), got, f"step {step}: (admitted, ns_ok, next_remaining)")
        assert_same(tuple(jax.device_get(jstate)), tuple(tstate), f"step {step}: state")
        adm, ns_ok = want[0], want[1]
        seen += [int((adm & valid).sum()), int((~ns_ok).sum()), int((valid & ns_ok & ~adm).sum())]
    assert (seen > 0).all(), f"admitted / namespace-refused / flow-refused counts {seen}"
    if seed == 3:
        assert trap > 0, "no batch's running max picked an earlier group's head"


def test_batch_decide_atomic_charges_nothing_on_a_refusal():
    """One value over budget in an atomic batch: nothing is charged; the
    same batch without it is all admitted and charged."""
    nrows = 16
    jstate = jma.make_state(nrows, jts.CLUSTER_CFG)
    tstate = tma.make_state(nrows, tts.CLUSTER_CFG, CPU)
    b = 8
    rows = np.arange(b, dtype=np.int32)
    rows[-1] = 0  # row 0 twice: over a budget of 1
    arrays = [rows, np.full(b, -1, np.int32), np.ones(b, np.int32), np.full(b, 1.0, np.float32),
              np.zeros(b, np.float32), np.ones(b, bool)]
    jstate, want, got = _decide_both(jstate, tstate, arrays, 500, True)
    assert_same(tuple(want), got, "refused batch")
    assert not want[0][-1] and want[0][:-1].all()
    assert_same(tuple(jax.device_get(jstate)), tuple(tstate), "nothing charged")
    assert int(np.asarray(tstate.counts).sum()) == 0
    arrays[0] = np.arange(b, dtype=np.int32)
    jstate, want, got = _decide_both(jstate, tstate, arrays, 500, True)
    assert_same(tuple(want), got, "admitted batch")
    assert want[0].all()
    assert_same(tuple(jax.device_get(jstate)), tuple(tstate), "all charged")


# --- DefaultTokenService in lockstep ----------------------------------------


def _pkg(name):
    """The cluster surface of one package: (cluster module, rules module,
    constants, service factory)."""
    cl = importlib.import_module(f"{name}.cluster")
    rules = importlib.import_module(f"{name}.models.rules")
    consts = importlib.import_module(f"{name}.models.constants")
    extra = {"device": "cpu"} if name == "sentinel_tpu_torch" else {}
    return cl, rules, consts, lambda clock: cl.DefaultTokenService(clock=clock, **extra)


@pytest.fixture
def cluster_env():
    pkgs = [_pkg("sentinel_tpu"), _pkg("sentinel_tpu_torch")]

    def clear():
        for cl, *_ in pkgs:
            cl.cluster_flow_rule_manager.clear()
            cl.cluster_server_config_manager.load_global_flow_config(exceed_count=1.0, max_allowed_qps=30000.0)
            cl.ClusterStateManager.stop()
            cl.EmbeddedClusterTokenServerProvider.clear()
            cl.TokenClientProvider.clear()

    clear()
    yield pkgs
    clear()


def _cluster_rule(rules, consts, resource, count, flow_id, global_=True, fallback=True, grade=None, param=False,
                  resource_timeout=2000):
    cfg = rules.ClusterFlowConfig(
        flow_id=flow_id, threshold_type=consts.FLOW_THRESHOLD_GLOBAL if global_ else consts.FLOW_THRESHOLD_AVG_LOCAL,
        fallback_to_local_when_fail=fallback, resource_timeout=resource_timeout,
    )
    kw = {} if grade is None else {"grade": grade}
    if param:
        return rules.ParamFlowRule(resource, count=count, param_idx=0, cluster_mode=True, cluster_config=cfg, **kw)
    return rules.FlowRule(resource, count=count, cluster_mode=True, cluster_config=cfg, **kw)


def _service_script(pkg):
    """One token server's life on one package: flow tokens, batches,
    param tokens, held tokens, window rolls and the server view."""
    cl, rules, consts, make = pkg
    clock_mod = importlib.import_module(f"{cl.__name__.rsplit('.', 1)[0]}.utils.clock")
    clock = clock_mod.ManualClock(0)
    cl.cluster_flow_rule_manager.load_rules("default", [
        _cluster_rule(rules, consts, "g", 5, 101),
        _cluster_rule(rules, consts, "avg", 2, 102, global_=False),
        _cluster_rule(rules, consts, "p", 3, 201, param=True),
        _cluster_rule(rules, consts, "c", 3, 301, grade=consts.FLOW_GRADE_THREAD, resource_timeout=500),
    ])
    cl.cluster_flow_rule_manager.load_rules("ns2", [_cluster_rule(rules, consts, "n2", 100, 401)])
    svc = make(clock)
    out = []

    def status(results):
        return [(int(r.status), r.remaining) for r in results]

    out.append(status([svc.request_token(101) for _ in range(7)]))
    svc.set_connected_count(3)
    out.append(status([svc.request_token(102) for _ in range(8)]))  # AVG_LOCAL: 2 x 3
    out.append(status([svc.request_token(999)]))
    out.append(status(svc.request_tokens([(101, 1, False), (999, 1, False), (401, 2, False)] * 3)))
    clock.set_ms(1101)  # the window slides
    out.append(status(svc.request_tokens([(101, 2, False)] * 4 + [(102, 1, False)] * 3)))
    out.append([int(svc.request_param_token(201, 1, [v]).status) for v in ("a", "a", "b", "a", "a")])
    out.append([int(svc.request_param_token(201, 1, ["a", "c"]).status) for _ in range(2)])
    out.append([int(svc.request_param_token(201, 1, ["c"]).status) for _ in range(4)])
    out.append(int(svc.request_param_token(999, 1, ["v"]).status))
    toks = [svc.request_concurrent_token(301) for _ in range(4)]
    out.append([int(t.status) for t in toks])
    out.append(int(svc.release_concurrent_token(toks[0].token_id).status))
    out.append(int(svc.release_concurrent_token(toks[0].token_id).status))
    out.append([int(svc.request_concurrent_token(301, acquire_count=a).status) for a in (1, 2, 0)])
    out.append(int(svc.request_concurrent_token(999).status))
    clock.set_ms(1700)  # held tokens expire (resource timeout 500 ms) at capacity
    out.append([int(svc.request_concurrent_token(301).status) for _ in range(2)])
    out.append(svc.flow_stats())
    cl.cluster_server_config_manager.load_global_flow_config(max_allowed_qps=3.0)
    clock.set_ms(2500)
    out.append(status(svc.request_tokens([(401, 1, False)] * 5)))  # the namespace guard trips
    out.append(status([svc.request_token(401) for _ in range(2)]))
    out.append(dict(svc._flow_rows))
    out.append(dict(svc._ns_rows))
    return out, svc


def test_default_token_service_lockstep(cluster_env):
    (want, jsvc), (got, tsvc) = (_service_script(p) for p in cluster_env)
    assert got == want
    assert_same(tuple(jax.device_get(jsvc.state)), tuple(tsvc.state), "service window state")
    assert any(r[0] == 0 for r in want[0]) and any(r[0] == 1 for r in want[0])  # OK and BLOCKED
    assert any(r[0] == -2 for r in want[-4])  # TOO_MANY_REQUEST
    # The JAX service's state carried into the port's: both decide alike on.
    cl_t = cluster_env[1][0]
    fresh = cl_t.DefaultTokenService(clock=tsvc.clock, device="cpu")
    fresh.load_state(jax.device_get(jsvc.state), jsvc._flow_rows, jsvc._ns_rows)
    assert [r.status for r in fresh.request_tokens([(101, 1, False)] * 3)] == [
        r.status for r in jsvc.request_tokens([(101, 1, False)] * 3)]
    assert_same(tuple(jax.device_get(jsvc.state)), tuple(fresh.state), "adopted state")


# --- the engine in embedded server mode -------------------------------------


def _embed(lib):
    """Register a DefaultTokenService of ``lib``'s package as the embedded
    server and switch to server mode; returns (cluster module, service)."""
    name = lib.st.__name__
    cl, rules, consts, make = _pkg(name)
    svc = make(lib.clock)
    cl.EmbeddedClusterTokenServerProvider.register(svc)
    cl.ClusterStateManager.set_to_server()
    return cl, rules, svc


def _scenario(fn):
    """Run ``fn(lib, cl, rules)`` with the package's cluster globals reset
    around it."""

    def run(lib):
        cl, rules, _, _ = _pkg(lib.st.__name__)
        try:
            return fn(lib, cl, rules)
        finally:
            cl.cluster_flow_rule_manager.clear()
            cl.ClusterStateManager.stop()
            cl.EmbeddedClusterTokenServerProvider.clear()

    return run


def _rule(lib, rules, *a, **kw):
    return _cluster_rule(rules, lib.C, *a, **kw)


@_scenario
def _embedded_server_mode(lib, cl, rules):
    rule = _rule(lib, rules, "svc", 2, 55)
    cl.cluster_flow_rule_manager.load_rules("default", [rule])
    _embed(lib)
    lib.st.flow_rule_manager.load_rules([rule])
    out = [block_of(lambda: lib.st.try_entry("svc")) for _ in range(3)]
    out.append(block_of(lambda: lib.st.entry("svc")))
    lib.clock.set_ms(1200)
    out.append(block_of(lambda: lib.st.entry("svc")))
    assert out[:2] == ["pass", "pass"] and out[3][0] == "FlowBlockError" and out[3][2] == rule.to_dict()
    with pytest.raises(ValueError):
        lib.engine.submit_bulk("svc", 4)  # token verdicts are per entry
    return out


@_scenario
def _fallback_to_local_when_no_service(lib, cl, rules):
    lib.st.flow_rule_manager.load_rules([_rule(lib, rules, "fb", 1, 66, fallback=True)])
    cl.ClusterStateManager.stop()
    out = [lib.st.try_entry("fb") is not None for _ in range(2)]
    assert out == [True, False]
    return out


@_scenario
def _pass_when_no_service_and_no_fallback(lib, cl, rules):
    lib.st.flow_rule_manager.load_rules([_rule(lib, rules, "nf", 1, 67, fallback=False)])
    cl.ClusterStateManager.stop()
    out = [block_of(lambda: lib.st.try_entry("nf")) for _ in range(5)]
    assert out == ["pass"] * 5
    return out


@_scenario
def _embedded_param_conservation(lib, cl, rules):
    rule = _rule(lib, rules, "psvc", 2, 401, param=True)
    cl.cluster_flow_rule_manager.load_rules("default", [rule])
    _embed(lib)
    lib.st.param_flow_rule_manager.load_rules([rule])
    out = [block_of(lambda v=v: lib.st.try_entry("psvc", args=(v,))) for v in ("u1", "u1", "u1", "u2")]
    out.append(block_of(lambda: lib.st.entry("psvc", args=("u1",))))
    assert out[3] == "pass" and out[4][0] == "ParamFlowBlockError" and out[4][2] == rule.to_dict()
    return out


@_scenario
def _param_fallback_and_no_fallback(lib, cl, rules):
    lib.st.param_flow_rule_manager.load_rules([_rule(lib, rules, "pfb", 1, 403, fallback=True, param=True),
                                               _rule(lib, rules, "pnf", 1, 404, fallback=False, param=True)])
    cl.ClusterStateManager.stop()
    out = [lib.st.try_entry("pfb", args=("k",)) is not None for _ in range(2)]
    out += [block_of(lambda: lib.st.try_entry("pnf", args=("k",))) for _ in range(3)]
    assert out == [True, False, "pass", "pass", "pass"]
    return out


@_scenario
def _param_thread_grade_stays_local(lib, cl, rules):
    rule = _rule(lib, rules, "pthr", 1, 405, grade=lib.C.FLOW_GRADE_THREAD, param=True)

    class ExplodingService:
        def request_param_token(self, *a, **k):
            raise AssertionError("THREAD-grade must not ask the token server")

    cl.EmbeddedClusterTokenServerProvider.register(ExplodingService())
    cl.ClusterStateManager.set_to_server()
    lib.st.param_flow_rule_manager.load_rules([rule])
    e = lib.st.try_entry("pthr", args=("k",))
    out = [e is not None, lib.st.try_entry("pthr", args=("k",)) is None]
    e.exit()
    out.append(block_of(lambda: lib.st.try_entry("pthr", args=("k",))))
    assert out == [True, True, "pass"]
    return out


@_scenario
def _concurrent_entry_acquires_and_exit_releases(lib, cl, rules):
    rule = _rule(lib, rules, "csvc", 2, 30, grade=lib.C.FLOW_GRADE_THREAD, fallback=False)
    cl.cluster_flow_rule_manager.load_rules("default", [rule])
    _, _, svc = _embed(lib)
    lib.st.flow_rule_manager.load_rules([rule])
    e1, e2 = lib.st.try_entry("csvc"), lib.st.try_entry("csvc")
    out = [e1 is not None, e2 is not None, svc.concurrent.now_calls(30), lib.st.try_entry("csvc") is None]
    e1.exit()
    out.append(svc.concurrent.now_calls(30))
    e3 = lib.st.try_entry("csvc")
    e2.exit()
    e3.exit()
    out += [svc.concurrent.now_calls(30), svc.concurrent.held_tokens()]
    assert out == [True, True, 2, True, 1, 0, 0]
    # A blocked entry hands its token back at once.
    local = lib.st.FlowRule("mix", count=0)
    mixed = _rule(lib, rules, "mix", 5, 31, grade=lib.C.FLOW_GRADE_THREAD, fallback=False)
    cl.cluster_flow_rule_manager.load_rules("default", [rule, mixed])
    lib.st.flow_rule_manager.load_rules([rule, mixed, local])
    out += [lib.st.try_entry("mix") is None, svc.concurrent.now_calls(31), svc.concurrent.held_tokens()]
    # Deferred ops hand their tokens to submit_exit.
    ops = [lib.engine.submit_entry("csvc") for _ in range(2)]
    lib.engine.flush()
    out += [op.verdict.admitted for op in ops] + [svc.concurrent.now_calls(30)]
    for op in ops:
        lib.engine.submit_exit(op.rows, rt=5, resource="csvc", cluster_tokens=op.cluster_tokens)
    lib.engine.flush()
    out.append(svc.concurrent.now_calls(30))
    assert out[7:] == [True, 0, 0, True, True, 2, 0]
    return out


@_scenario
def _cluster_stream(lib, cl, rules):
    """An st.entry stream on cluster-mode QPS, THREAD and param rules with
    local rules beside them, over several windows: every verdict, the
    server's flow_stats and the held tokens."""
    qps = _rule(lib, rules, "q", 4, 501)
    thr = _rule(lib, rules, "t", 2, 502, grade=lib.C.FLOW_GRADE_THREAD, fallback=False)
    par = _rule(lib, rules, "p", 2, 503, param=True)
    cl.cluster_flow_rule_manager.load_rules("default", [qps, thr, par])
    _, _, svc = _embed(lib)
    lib.st.flow_rule_manager.load_rules([qps, thr, lib.st.FlowRule("q", count=3)])
    lib.st.param_flow_rule_manager.load_rules([par])
    rng = np.random.default_rng(11)
    out, held = [], []
    for step in range(60):
        lib.clock.set_ms(100 + step * 70)
        kind = int(rng.integers(0, 3))
        if kind == 0:
            out.append(block_of(lambda: lib.st.entry("q")))
        elif kind == 1:
            try:
                held.append(lib.st.entry("t"))
                out.append("held")
            except Exception as exc:
                out.append(type(exc).__name__)
            if len(held) > 1 and rng.random() < 0.5:
                held.pop(0).exit()
        else:
            out.append(block_of(lambda: lib.st.entry("p", args=(f"v{int(rng.integers(0, 3))}",))))
    out.append([{k: v for k, v in row.items()} for row in svc.flow_stats()])
    out.append(svc.concurrent.now_calls(502))
    return out


@pytest.mark.parametrize(
    "scenario",
    [_embedded_server_mode, _fallback_to_local_when_no_service, _pass_when_no_service_and_no_fallback,
     _embedded_param_conservation, _param_fallback_and_no_fallback, _param_thread_grade_stays_local,
     _concurrent_entry_acquires_and_exit_releases, _cluster_stream],
    ids=["embedded_server_mode", "fallback_no_service", "pass_no_service_no_fallback", "param_conservation",
         "param_fallback", "param_thread_grade_local", "concurrent_tokens", "stream"],
)
def test_engine_embedded_server_matches_jax(scenario, cluster_env):
    run_on_both(scenario)


def test_client_mode_and_bulk_seam_raise(cluster_env):
    """Client mode, refused until the TCP token client was ported: with a
    server address set (ClusterClientConfigManager, the dashboard's assign
    flow) ``set_to_client`` builds the client, registers and starts it, and
    the engine asks it; ``apply_state(CLUSTER_CLIENT)`` does the same. The
    batched token seam of submit_many asks nothing of an empty batch."""
    from sentinel_tpu_torch.cluster.client import ClusterTokenClient
    from sentinel_tpu_torch.cluster.server import SentinelTokenServer
    from sentinel_tpu_torch.cluster.state import ClusterClientConfigManager
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.utils.clock import ManualClock

    cl = cluster_env[1][0]
    srv = SentinelTokenServer(port=0, service=cl.DefaultTokenService(device="cpu")).start()
    ClusterClientConfigManager.apply("127.0.0.1", srv.port, timeout_ms=60000, namespace="ns1")
    client = None
    try:
        assert cl.ClusterStateManager.set_to_client() and cl.ClusterStateManager.is_client()
        client = cl.TokenClientProvider.get_client()
        assert isinstance(client, ClusterTokenClient) and client.connected
        assert (client.port, client.namespace, client.timeout) == (srv.port, "ns1", 60.0)
        assert Engine._cluster_token_service() is client
        assert cl.ClusterStateManager.set_to_client() and cl.TokenClientProvider.get_client() is client
        cl.ClusterStateManager.stop()
        assert Engine._cluster_token_service() is None
        assert cl.ClusterStateManager.apply_state(cl.ClusterStateManager.CLUSTER_CLIENT)
        assert cl.ClusterStateManager.is_client() and Engine._cluster_token_service() is client
        assert ClusterClientConfigManager.snapshot() == {"serverHost": "127.0.0.1", "serverPort": srv.port,
                                                         "requestTimeout": 60000, "namespace": "ns1"}
    finally:
        if client is not None:
            client.stop()
        srv.stop()
        ClusterClientConfigManager.apply("", 0, timeout_ms=200, namespace="default")
    # The batched token seam of submit_many is ported: an empty batch asks nothing.
    assert Engine(clock=ManualClock(0), device="cpu")._apply_cluster_checks_bulk([]) is None


# --- submit_many's batched token seam (tests/test_cluster_batched.py) ---------------


def _count_batches(svc):
    """Wrap the service's batched calls to count them."""
    calls = {"flow": 0, "param": 0}
    for name, key in (("request_tokens_batch", "flow"), ("request_param_tokens_batch", "param")):
        fn = getattr(svc, name)

        def wrapped(rows, fn=fn, key=key):
            calls[key] += 1
            return fn(rows)

        setattr(svc, name, wrapped)
    return calls


@_scenario
def _many_flow_batched(lib, cl, rules):
    """Cluster flow ops through submit_many take ONE batched token call;
    the verdicts equal per-op submit_entry against an identical fresh
    token world, interleaved local ops included (the deferred tail keeps
    request order)."""
    crule = _rule(lib, rules, "cr", 6, 901)
    reqs = [{"resource": "cr" if i % 2 == 0 else "plain", "ts": 1000} for i in range(16)]
    out = []
    for batched in (True, False):
        cl.cluster_flow_rule_manager.load_rules("default", [crule])
        _, _, svc = _embed(lib)
        calls = _count_batches(svc)
        eng = type(lib.engine)(clock=lib.clock, **({"device": "cpu"} if "torch" in lib.st.__name__ else {}))
        eng.set_flow_rules([crule, lib.st.FlowRule("plain", count=4)])
        ops = eng.submit_many([dict(r) for r in reqs]) if batched else [eng.submit_entry(**r) for r in reqs]
        eng.flush()
        out.append([bool(o.verdict.admitted) for o in ops])
        out.append(calls)
    assert out[0] == out[2] and sum(out[0][0::2]) == 6 and out[1]["flow"] == 1
    return out


@_scenario
def _many_param_batched(lib, cl, rules):
    """Cluster hot-param ops through submit_many: one PARAM batch, the
    per-value verdicts of per-op submit_entry."""
    prule = _rule(lib, rules, "pp", 2, 902, param=True)
    values = ["a", "b", "a", "c", "a", "b", "b", "c", "a", "c"]
    out = []
    for batched in (True, False):
        cl.cluster_flow_rule_manager.load_rules("default", [prule])
        _, _, svc = _embed(lib)
        calls = _count_batches(svc)
        eng = type(lib.engine)(clock=lib.clock, **({"device": "cpu"} if "torch" in lib.st.__name__ else {}))
        eng.set_param_rules({"pp": [prule]})
        reqs = [{"resource": "pp", "ts": 1000, "args": (v,)} for v in values]
        ops = eng.submit_many(reqs) if batched else [eng.submit_entry(**r) for r in reqs]
        eng.flush()
        out.append([bool(o.verdict.admitted) for o in ops])
        out.append(calls)
    assert out[0] == out[2] and out[1]["param"] == 1
    for v in "abc":
        assert sum(a for a, val in zip(out[0], values) if val == v) == 2
    return out


@pytest.mark.parametrize("scenario", [_many_flow_batched, _many_param_batched], ids=["flow", "param"])
def test_submit_many_batched_seam_matches_jax(scenario, cluster_env):
    run_on_both(scenario)
