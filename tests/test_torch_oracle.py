"""The port's sequential oracle (sentinel_tpu_torch/testing/oracle.py)
against the JAX package's, on the CPU.

Each oracle class of both packages takes the same seeded stream of calls;
every answer and, after every call, the whole object state (its buckets,
pacers, tokens and breaker fields, walked recursively) must be equal. The
port's oracle imports only the port's ``metrics/events``."""

import ast
from pathlib import Path

import numpy as np
import pytest

from sentinel_tpu.testing import oracle as jo
from sentinel_tpu_torch.testing import oracle as to

BOTH = (jo, to)
SEEDS = range(4)


def dump(x):
    """An object's state as plain values (enums as ints)."""
    if isinstance(x, (list, tuple)):
        return [dump(v) for v in x]
    if isinstance(x, dict):
        return {str(k): dump(v) for k, v in x.items()}
    if hasattr(x, "__slots__") and not isinstance(x, (int, float, str)):
        return {k: dump(getattr(x, k)) for k in x.__slots__}
    if hasattr(x, "__dict__"):
        return {k: dump(v) for k, v in vars(x).items()}
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    return int(x) if type(x).__name__ == "MetricEvent" else x


def lockstep(make, calls):
    """``make(mod)`` on both packages, then each ``(method, args)`` of
    ``calls``: the answers and the states must be equal after each."""
    objs = [make(m) for m in BOTH]
    assert dump(objs[0]) == dump(objs[1])
    answers = []
    for name, args in calls:
        got = []
        for m, o in zip(BOTH, objs):
            fn = getattr(o, name)
            got.append(fn(*(a(m) if callable(a) else a for a in args)))
        assert dump(got[0]) == dump(got[1]), (name, args, got)
        assert dump(objs[0]) == dump(objs[1]), (name, args)
        answers.append(got[1])
    return answers


def _times(rng, n, span=6000):
    return np.sort(rng.integers(0, span, n)).tolist()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["leap", "future", "occupiable"])
def test_leap_arrays(seed, kind):
    rng = np.random.default_rng(seed)
    cls = {"leap": "OracleLeapArray", "future": "OracleFutureArray", "occupiable": "OracleOccupiableArray"}[kind]
    calls = []
    for t in _times(rng, 200):
        op = int(rng.integers(0, 5))
        ev = int(rng.integers(0, 6))
        if op == 0:
            calls.append(("add", (t, lambda m, e=ev: m.MetricEvent(e), int(rng.integers(1, 5)))))
        elif op == 1:
            calls.append(("add_rt", (t, int(rng.integers(0, 900)))))
        elif op == 2:
            calls.append(("values", (t,)))
        elif op == 3:
            calls.append(("min_rt_value", (t,)))
        elif kind == "occupiable":
            calls.append(("add_waiting", (t + int(rng.integers(1, 1000)), int(rng.integers(1, 4)))))
            calls.append(("materialize", (t,)))
            calls.append(("waiting", (t,)))
            calls.append(("get_window_pass", (t,)))
        elif kind == "future":
            calls.append(("get_window_value", (t,)))
    lockstep(lambda m: getattr(m, cls)(2 if kind != "leap" else 60, 1000 if kind != "leap" else 60000), calls)


@pytest.mark.parametrize("seed", SEEDS)
def test_node_and_default_controller(seed):
    rng = np.random.default_rng(seed)
    calls = []
    for t in _times(rng, 300, span=8000):
        op = int(rng.integers(0, 6))
        acq = int(rng.integers(1, 4))
        if op == 0:
            calls.append(("add_pass", (t, acq)))
        elif op == 1:
            calls.append(("add_block", (t, acq)))
        elif op == 2:
            calls.append(("add_rt_and_success", (t, int(rng.integers(1, 500)), acq)))
        elif op == 3:
            calls.append(("try_occupy_next", (t, acq, float(rng.integers(2, 20)), int(rng.integers(100, 1000)))))
        elif op == 4:
            calls.append(("add_waiting_request", (t + int(rng.integers(1, 900)), acq)))
            calls.append(("add_occupied_pass", (t, acq)))
        else:
            for q in ("pass_qps", "block_qps", "success_qps", "waiting", "materialize"):
                calls.append((q, (t,)))
    lockstep(lambda m: m.OracleNode(), calls)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("grade", [0, 1])
def test_flow_engine_with_prio(seed, grade):
    """OracleFlowEngine (DefaultController, the occupy branch) over a
    seeded stream of entries, prioritized entries and exits."""
    rng = np.random.default_rng(seed)
    calls = [("set_qps_rule" if grade else "set_thread_rule", ("A", float(rng.integers(2, 8)))),
             ("set_qps_rule", ("B", 3.0))]
    for t in _times(rng, 300, span=5000):
        res = "A" if rng.random() < 0.7 else "B"
        op = int(rng.integers(0, 3))
        if op == 0:
            calls.append(("entry", (res, t, int(rng.integers(1, 3)))))
        elif op == 1:
            calls.append(("entry_prio", (res, t, 1, True)))
        else:
            calls.append(("exit", (res, t, int(rng.integers(1, 200)))))
    answers = lockstep(lambda m: m.OracleFlowEngine(), calls)
    assert any(a is False or (isinstance(a, tuple) and a[0] is False) for a in answers)


@pytest.mark.parametrize("seed", SEEDS)
def test_shaping_controllers(seed):
    rng = np.random.default_rng(seed)
    ts = _times(rng, 200, span=10000)
    count = float(rng.integers(5, 50))
    lockstep(lambda m: m.OracleRateLimiter(count, 500),
             [("can_pass", (t, int(rng.integers(0, 3)))) for t in ts])
    # The warm-up controllers read a node: run them against twin nodes.
    for cls, extra in (("OracleWarmUp", ()), ("OracleWarmUpRateLimiter", (400,))):
        nodes = [m.OracleNode() for m in BOTH]
        ctl = [getattr(m, cls)(count, 10, *extra) for m in BOTH]
        assert dump(ctl[0]) == dump(ctl[1])
        for t in ts:
            acq = int(rng.integers(1, 3))
            method = "can_pass_pacer" if cls == "OracleWarmUpRateLimiter" else "can_pass"
            got = [getattr(c, method)(n, t, acq) for c, n in zip(ctl, nodes)]
            assert got[0] == got[1], (cls, t)
            ok = got[1][0] if isinstance(got[1], tuple) else got[1]
            for n in nodes:
                (n.add_pass if ok else n.add_block)(t, acq)
            assert dump(ctl[0]) == dump(ctl[1]) and dump(nodes[0]) == dump(nodes[1])
        assert [ctl[1].warning_qps()] == [ctl[0].warning_qps()]


@pytest.mark.parametrize("seed", SEEDS)
def test_param_bucket_and_throttle(seed):
    rng = np.random.default_rng(seed)
    ts = _times(rng, 250, span=9000)
    lockstep(lambda m: m.OracleParamBucket(3, 2, 1000),
             [("check", (t, int(rng.integers(1, 4)))) for t in ts])
    lockstep(lambda m: m.OracleParamThrottle(4, 1, 600), [("check", (t, int(rng.integers(1, 3)))) for t in ts])
    lockstep(lambda m: m.OracleParamThrottle(0, 1, 600), [("check", (t, 1)) for t in ts[:10]])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("grade", [0, 1, 2])
def test_circuit_breaker(seed, grade):
    rng = np.random.default_rng(seed)
    count = {0: 100.0, 1: 0.4, 2: 3.0}[grade]
    calls = []
    for t in _times(rng, 300, span=20000):
        if rng.random() < 0.5:
            calls.append(("try_pass", (t,)))
        elif rng.random() < 0.1:
            calls.append(("revert_probe", ()))
        else:
            calls.append(("on_complete", (t, int(rng.integers(0, 300)), bool(rng.random() < 0.4))))
    lockstep(lambda m: m.OracleCircuitBreaker(grade, count, 2, min_request=3, slow_ratio=0.5), calls)


def test_same_classes_and_functions():
    """The port's oracle defines exactly the JAX oracle's classes and
    functions, and of either package imports only the port's
    metrics/events."""

    def names(path):
        tree = ast.parse(Path(path).read_text())
        return sorted(n.name for n in tree.body if isinstance(n, (ast.ClassDef, ast.FunctionDef)))

    assert names(to.__file__) == names(jo.__file__)
    tree = ast.parse(Path(to.__file__).read_text())
    mods = [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert [m for m in mods if m.split(".")[0] in ("sentinel_tpu", "sentinel_tpu_torch", "jax")] == [
        "sentinel_tpu_torch.metrics.events"]


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_stream_matches_the_oracle(seed):
    """testing/oracle_stream.py on the port's CPU engine (plain versions):
    every entry's pass/block and wait equal the oracle's, with blocks of
    each behavior in the stream. ``chip_smoke.py`` phase 4m (e) runs it on
    the card."""
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.testing.oracle_stream import oracle_stream
    from sentinel_tpu_torch.utils.clock import ManualClock

    clock = ManualClock(0)
    eng = Engine(clock=clock, device="cpu")
    got, want = oracle_stream(eng, clock, seed=seed, n=400)
    eng.close()
    assert got == want
    blocked = {r for r, _t, ok, _w in got if not ok}
    assert blocked & {"q0", "q1"} and blocked & {"rl0", "rl1"} and blocked & {"wu0", "wu1"}
