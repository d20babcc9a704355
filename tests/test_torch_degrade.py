"""The port's circuit breakers (sentinel_tpu_torch/rules/degrade_table.py,
plain PyTorch versions on the CPU) against the JAX package, bit for bit:
``breaker_on_exits``, ``breaker_try_pass`` and ``apply_probe_transitions``
on seeded inputs with (gid, ts) ties, a hot breaker, exits from
superseded windows, breakers in all three states and of all three
grades, min_request at its padding value and retry deadlines that wrap
int32; the order and window edges of the exits (equal (gid, ts) exits,
HALF_OPEN probes at a shared ts, superseded windows, min_request
2^31 - 1, a hot breaker); the compiled breaker table; the scenarios of
tests/test_degrade.py run on both engines in lockstep; and the
degrade demo's sequence on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.rules import degrade_table as jdt
from sentinel_tpu_torch.rules import degrade_table as tdt

from torch_parity import (BREAKER_EXIT_CASES, assert_same, block_of, breaker_exit_case, many_candidates,
                          random_degrade, random_exits, run_on_both)

CPU = torch.device("cpu")
ND = 16

_j_on_exits = jax.jit(jdt.breaker_on_exits)
_j_try_pass = jax.jit(jdt.breaker_try_pass)
_j_probe = jax.jit(jdt.apply_probe_transitions)


def _both_tables(table, dyn):
    j = (jdt.DegradeTableDevice(*map(jnp.asarray, table)), jdt.DegradeDynState(*map(jnp.asarray, dyn)))
    t = (tdt.degrade_table_from_numpy(table, CPU), tdt.degrade_state_from_numpy(dyn, CPU))
    return j, t


def _t(*arrs):
    return [torch.tensor(np.asarray(a)) for a in arrs]


@pytest.mark.parametrize("near_max", [False, True], ids=["mid", "near_int32_max"])
@pytest.mark.parametrize("seed", range(4))
def test_breaker_on_exits_parity(seed, near_max):
    rng = np.random.default_rng(seed)
    now = 2**31 - 1 - 3000 if near_max else 500_000 + 777 * seed
    table, dyn = random_degrade(rng, ND, now, near_max)
    x = random_exits(rng, 64, 2, ND, now)
    (jt, jd), (tt, td) = _both_tables(table, dyn)
    want = jax.device_get(_j_on_exits(jt, jd, *map(jnp.asarray, x)))
    tdt.breaker_on_exits(tt, td, *_t(*x))
    assert_same(want, tdt.degrade_state_to_numpy(td), "breaker state")
    if seed == 0:
        # The input exercises every transition kind somewhere.
        before, after = dyn[0], want.state
        assert ((before == 0) & (after == 1)).any(), "CLOSED -> OPEN"
        assert ((before == 2) & (after != 2)).any(), "HALF_OPEN resolved"


def _edge_expectations(case, got, w0=700_000):
    """What each order and window edge must do to copy 0's breakers (ids
    0-4), read from the JAX result: the inputs exercise the edge."""
    st, nr, bad, total = got.state, got.next_retry, got.bad, got.total
    t = w0 + 500
    if case == "equal_ts_order":
        assert st[:5].tolist() == [1, 0, 1, 0, 1], "bad then good crosses, good then bad does not"
    elif case == "half_open_shared_ts":
        assert st[:4].tolist() == [1, 0, 1, 0] and nr[0] == t + 5000 and nr[2] == 5000 and total[1] == 0
    elif case == "superseded_then_newer":
        assert st[:4].tolist() == [0, 1, 0, 1] and total[0] == 3 and nr[1] == w0 + 40 + 5000
        assert nr[3] == w0 + 1003 + 5000 and total[2] == 4
    elif case == "all_older":
        assert st[:3].tolist() == [0, 0, 1] and (bad[0], total[0]) == (1, 2) and nr[2] == w0 - 1000 + 5 + 5000
    elif case == "min_request_max":
        assert st[0] == 0


@pytest.mark.parametrize("copies", [1, 3])
@pytest.mark.parametrize("case", BREAKER_EXIT_CASES)
def test_breaker_on_exits_edges_match_jax(case, copies):
    """The order and window edges of breaker_on_exits (torch_parity.
    breaker_exit_case): equal (gid, ts) exits whose bad/good order decides
    a crossing; HALF_OPEN breakers whose first two exits share a ts;
    segments from a superseded window into a newer one; every exit older
    than the window; min_request 2^31 - 1; a hot breaker taking most of the
    batch. One copy, and three interleaved."""
    table, dyn, x = breaker_exit_case(case, copies, seed=copies)
    (jt, jd), (tt, td) = _both_tables(table, dyn)
    want = jax.device_get(_j_on_exits(jt, jd, *map(jnp.asarray, x)))
    tdt.breaker_on_exits(tt, td, *_t(*x))
    assert_same(want, tdt.degrade_state_to_numpy(td), case)
    _edge_expectations(case, want)


@pytest.mark.parametrize("seed", range(4))
def test_breaker_try_pass_and_probe_transitions_parity(seed):
    rng = np.random.default_rng(10 + seed)
    now = 800_000 + seed
    table, dyn = random_degrade(rng, ND, now)
    # A hot breaker, OPEN and due, takes most of the batch.
    dyn[0][1], dyn[1][1] = 1, now - 100
    n, kd = 64, 2
    e_dgid = np.full((n, kd), -1, np.int32)
    e_dgid[:, 0] = np.where(rng.random(n) < 0.6, 1, rng.integers(0, ND, n))
    e_dgid[:, 1] = np.where(rng.random(n) < 0.4, rng.integers(0, ND, n), -1)
    e_ts = (now - rng.integers(0, 300, n)).astype(np.int32)
    e_ts[: n // 3] = e_ts[0]  # ties: the earliest slot position wins
    e_live = rng.random(n) < 0.85
    (jt, jd), (tt, td) = _both_tables(table, dyn)
    j_ok, j_probe = _j_try_pass(jt, jd, *map(jnp.asarray, (e_dgid, e_ts, e_live)))
    t_ok, t_probe = tdt.breaker_try_pass(tt, td, *_t(e_dgid, e_ts, e_live))
    assert_same(j_ok, t_ok, "dslot_ok")
    assert_same(j_probe, t_probe, "probe_slot")
    assert np.asarray(j_probe).sum() >= 1
    admitted = rng.random(n) < 0.7
    j_after = jax.device_get(_j_probe(jd, jnp.asarray(e_dgid), j_probe, jnp.asarray(admitted)))
    tdt.apply_probe_transitions_plain(td, torch.tensor(e_dgid), t_probe, torch.tensor(admitted))
    assert_same(j_after, tdt.degrade_state_to_numpy(td), "after probe transitions")


@pytest.mark.parametrize("masked", [False, True], ids=["all", "probe_allowed"])
@pytest.mark.parametrize("n", [64, 2049])
def test_breaker_try_pass_many_candidates_parity(n, masked):
    """Many candidates of one breaker at one ts: the lowest slot position
    probes (the order the card's election keeps), with and without the
    sharded step's mask."""
    rng = np.random.default_rng(30 + n)
    now = 900_000
    table, dyn, e_dgid, e_ts, e_live = many_candidates(rng, n, 2, ND, now)
    allowed = rng.random(ND) < 0.5
    allowed[1] = True
    (jt, jd), (tt, td) = _both_tables(table, dyn)
    j_extra = (jnp.asarray(allowed),) if masked else ()
    t_extra = (torch.tensor(allowed),) if masked else ()
    j_ok, j_probe = _j_try_pass(jt, jd, *map(jnp.asarray, (e_dgid, e_ts, e_live)), *j_extra)
    t_ok, t_probe = tdt.breaker_try_pass(tt, td, *_t(e_dgid, e_ts, e_live), *t_extra)
    assert_same(j_ok, t_ok, "dslot_ok")
    assert_same(j_probe, t_probe, "probe_slot")
    first = int(np.flatnonzero(e_live)[0])
    assert bool(np.asarray(j_probe)[first, 0]) and int(np.asarray(j_probe)[:, 0].sum()) == 1


def test_degrade_index_matches_jax():
    from sentinel_tpu.models.rules import DegradeRule as JRule
    from sentinel_tpu_torch.models import constants as C
    from sentinel_tpu_torch.models.rules import DegradeRule

    specs = [
        dict(resource="a", grade=C.DEGRADE_GRADE_RT, count=50.4, slow_ratio_threshold=0.5, time_window=3),
        dict(resource="a", grade=C.DEGRADE_GRADE_EXCEPTION_RATIO, count=0.5, time_window=5, min_request_amount=3),
        dict(resource="b", grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, count=4, time_window=2, stat_interval_ms=333),
        dict(resource="c", grade=C.DEGRADE_GRADE_EXCEPTION_RATIO, count=1.5, time_window=5),  # invalid
    ]
    j = jdt.DegradeIndex([JRule(**s) for s in specs])
    t = tdt.DegradeIndex([DegradeRule(**s) for s in specs], device=CPU)
    assert_same(jax.device_get(j.device), t.device, "table")
    assert_same(jax.device_get(j.make_dyn_state()), t.make_dyn_state(), "state")
    for res in ("a", "b", "c", "z"):
        assert j.gids_for(res) == t.gids_for(res)


# --- the scenarios of tests/test_degrade.py, on both engines --------------


def _exc_ratio(lib, resource, ratio=0.5, tw=5, min_req=5):
    return lib.st.DegradeRule(resource, grade=lib.C.DEGRADE_GRADE_EXCEPTION_RATIO, count=ratio,
                              time_window=tw, min_request_amount=min_req)


def _run_one(lib, resource, rt=0, error=False):
    e = lib.st.try_entry(resource)
    if e is None:
        return False
    if rt:
        lib.clock.advance(rt)
    if error:
        e.set_error(RuntimeError("biz"))
    e.exit()
    return True


def _opens_on_error_ratio(lib):
    lib.st.degrade_rule_manager.load_rules([_exc_ratio(lib, "svc", 0.5, tw=5)])
    out = []
    for i in range(5):
        lib.clock.set_ms(i * 10)
        out.append(_run_one(lib, "svc", error=i > 0))
    lib.clock.set_ms(100)
    out.append(block_of(lambda: lib.st.entry("svc")))
    assert out[:5] == [True] * 5 and out[5][0] == "DegradeBlockError"
    return out


def _min_request_gate(lib):
    lib.st.degrade_rule_manager.load_rules([_exc_ratio(lib, "g", 0.1, min_req=10)])
    out = []
    for i in range(9):
        lib.clock.set_ms(i)
        out.append(_run_one(lib, "g", error=True))
    lib.clock.set_ms(20)
    out.append(_run_one(lib, "g"))
    assert out == [True] * 10
    return out


def _half_open_recovers(lib):
    lib.st.degrade_rule_manager.load_rules([_exc_ratio(lib, "rec", 0.4, tw=2)])
    out = []
    for i in range(5):
        lib.clock.set_ms(i)
        out.append(_run_one(lib, "rec", error=True))
    lib.clock.set_ms(100)
    out.append(lib.st.try_entry("rec") is None)
    lib.clock.set_ms(2010)
    e = lib.st.try_entry("rec")
    out.append(e is not None)
    out.append(lib.st.try_entry("rec") is None)  # a second request while HALF_OPEN
    e.exit()
    lib.clock.set_ms(2050)
    out.append(_run_one(lib, "rec"))
    assert out[5:] == [True, True, True, True]
    return out


def _half_open_failure_reopens(lib):
    lib.st.degrade_rule_manager.load_rules([_exc_ratio(lib, "bad", 0.4, tw=1)])
    for i in range(5):
        lib.clock.set_ms(i)
        _run_one(lib, "bad", error=True)
    lib.clock.set_ms(1100)
    e = lib.st.try_entry("bad")
    out = [e is not None]
    e.set_error(RuntimeError("still failing"))
    e.exit()
    lib.clock.set_ms(1200)
    out.append(lib.st.try_entry("bad") is None)
    lib.clock.set_ms(2150)
    out.append(lib.st.try_entry("bad") is not None)
    assert out == [True, True, True]
    return out


def _exception_count_grade(lib):
    lib.st.degrade_rule_manager.load_rules([lib.st.DegradeRule(
        "cnt", grade=lib.C.DEGRADE_GRADE_EXCEPTION_COUNT, count=3, time_window=5, min_request_amount=1)])
    out = []
    for i in range(4):
        lib.clock.set_ms(i)
        out.append(_run_one(lib, "cnt", error=True))
    out.append(lib.st.try_entry("cnt") is None)
    assert out == [True] * 5
    return out


def _rt_opens_on_slow_ratio(lib):
    lib.st.degrade_rule_manager.load_rules([lib.st.DegradeRule(
        "slow", grade=lib.C.DEGRADE_GRADE_RT, count=50, slow_ratio_threshold=0.6, time_window=3,
        min_request_amount=3)])
    out = []
    for i in range(3):
        lib.clock.set_ms(i * 200)
        out.append(_run_one(lib, "slow", rt=100))
    lib.clock.set_ms(600)
    out.append(lib.st.try_entry("slow") is None)
    assert out == [True] * 4
    return out


def _rt_fast_keeps_closed(lib):
    lib.st.degrade_rule_manager.load_rules([lib.st.DegradeRule(
        "fast", grade=lib.C.DEGRADE_GRADE_RT, count=50, slow_ratio_threshold=0.5, time_window=3,
        min_request_amount=3)])
    out = []
    for i in range(10):
        lib.clock.set_ms(i * 20)
        out.append(_run_one(lib, "fast", rt=5))
    assert out == [True] * 10
    return out


def _randomized_stream(grade):
    def scenario(lib):
        from sentinel_tpu.testing.oracle import OracleCircuitBreaker

        if grade == lib.C.DEGRADE_GRADE_RT:
            rule = lib.st.DegradeRule("r", grade=grade, count=30, slow_ratio_threshold=0.5, time_window=2,
                                      min_request_amount=4)
            ob = OracleCircuitBreaker(0, 30, 2, 4, 0.5)
        else:
            rule = lib.st.DegradeRule("r", grade=grade, count=0.5, time_window=2, min_request_amount=4)
            ob = OracleCircuitBreaker(1, 0.5, 2, 4)
        lib.st.degrade_rule_manager.load_rules([rule])
        rng = np.random.default_rng(5)
        t = 0
        out = []
        for step in range(150):
            t += int(rng.choice([5, 40, 300, 1200], p=[0.4, 0.3, 0.2, 0.1]))
            lib.clock.set_ms(t)
            e = lib.st.try_entry("r")
            assert (e is not None) == ob.try_pass(t), f"step {step} t={t}"
            out.append(e is not None)
            if e is not None:
                rt = int(rng.choice([5, 80]))
                err = bool(rng.random() < 0.4)
                lib.clock.advance(rt)
                if err:
                    e.set_error(RuntimeError("x"))
                e.exit()
                ob.on_complete(lib.clock.now_ms(), rt=rt, error=err)
        return out

    return scenario


def _demo(lib):
    """examples/degrade_demo.py's sequence."""
    lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("backend", count=1000)])
    lib.st.degrade_rule_manager.load_rules([lib.st.DegradeRule(
        resource="backend", grade=1, count=0.5, time_window=5, min_request_amount=5)])

    def call(ts, fail):
        lib.clock.set_ms(ts)
        try:
            e = lib.st.entry("backend")
        except lib.st.DegradeBlockError:
            return "BLOCKED (breaker open)"
        if fail:
            e.set_error(RuntimeError("downstream 500"))
        e.exit()
        return "error" if fail else "ok"

    lines = [call(i * 10, fail=True) for i in range(6)]
    lines += [call(1000, fail=False), call(3000, fail=False), call(5200, fail=False), call(5300, fail=False)]
    return lines


DEMO_LINES = ["error"] * 5 + ["BLOCKED (breaker open)"] * 3 + ["ok", "ok"]

SCENARIOS = {
    "opens_on_error_ratio": _opens_on_error_ratio,
    "min_request_gate": _min_request_gate,
    "half_open_recovers": _half_open_recovers,
    "half_open_failure_reopens": _half_open_failure_reopens,
    "exception_count_grade": _exception_count_grade,
    "rt_opens_on_slow_ratio": _rt_opens_on_slow_ratio,
    "rt_fast_keeps_closed": _rt_fast_keeps_closed,
    "random_rt": _randomized_stream(0),
    "random_exception_ratio": _randomized_stream(1),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_degrade_scenario_lockstep(name):
    run_on_both(SCENARIOS[name])


def test_degrade_demo_sequence():
    """The demo's lines on the port's CPU engine, and on the JAX engine."""
    assert run_on_both(_demo) == DEMO_LINES


def test_breaker_observers_raise():
    """The breakers' state-change observers, refused until the metric plane
    was ported (ROADMAP item 8b), now fire: on the demo's sequence and on a
    half-open recovery the events each observer sees equal the JAX
    engine's (a failing observer is logged, never raised)."""
    import importlib

    def scenario(lib):
        bev = importlib.import_module(lib.st.__name__ + ".rules.breaker_events")
        events = []
        bev.clear()
        bev.add_state_change_observer("t", lambda prev, new, rule, res: events.append((prev, new, res, rule.grade)))
        bev.add_state_change_observer("boom", lambda *a: 1 / 0)
        try:
            lines = _demo(lib)
            return [lines, list(events), _half_open_recovers(lib), events]
        finally:
            bev.clear()

    got = run_on_both(scenario)
    assert (0, 1) in {e[:2] for e in got[1]} and {(1, 2), (2, 0)} <= {e[:2] for e in got[3]}
