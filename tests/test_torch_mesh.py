"""Parity of the port's sharded flush (sentinel_tpu_torch/parallel: the
merges K13 and K14, the budget split K15, the global shaping charge K16,
the probe election and the global scans; plain PyTorch versions on the
CPU, 8 shards) with the JAX package's ``make_sharded_flush`` on the
8-device CPU mesh that tests/conftest.py forces, bit for bit: every result
field and every state tensor (stats, shaping, breaker and param state).
Also the engine's mesh mode (``enable_mesh(8)``) against the JAX engine's,
the cases of tests/test_engine_mesh.py on the port, and ``submit_many``.
Tolerance is zero.

The JAX side runs under ``shard_map`` and carries the ``mesh`` marker
(conftest skips it where the capability is absent). Shapes are fixed
across cases and each compiled JAX function is held for the module, so a
function compiles once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu import parallel as jpar
from sentinel_tpu.metrics import nodes as jnodes
from sentinel_tpu.rules import degrade_table as jdt
from sentinel_tpu.rules import param_table as jpt
from sentinel_tpu.rules import shaping as jsh
from sentinel_tpu.rules.flow_table import FlowRuleDynState as JDyn
from sentinel_tpu.rules.flow_table import FlowTableDevice as JTable
from sentinel_tpu.runtime import flush as jflush
from sentinel_tpu_torch import parallel as tpar
from sentinel_tpu_torch.metrics import metric_array as tma
from sentinel_tpu_torch.metrics import nodes as tnodes
from sentinel_tpu_torch.parallel import ici as tici
from sentinel_tpu_torch.rules import degrade_table as tdt
from sentinel_tpu_torch.rules import param_table as tpt
from sentinel_tpu_torch.rules import shaping as tsh
from sentinel_tpu_torch.rules.flow_table import flow_table_from_numpy
from sentinel_tpu_torch.runtime import flush as tflush

from test_torch_nodes import _jax_stats
from test_torch_shaping import RESULT_FIELDS
from torch_parity import (
    assert_same,
    borrowable_stats,
    random_chain_batch,
    random_degrade,
    random_param_batch_for,
    random_param_state,
    random_shaped_flow_table,
    SHAPING_CHARGE_CASES,
    shaping_batch_for,
    shaping_charge_case,
    system_thresholds,
)

CPU = torch.device("cpu")
D = 8

_JAX_STEPS = {}


def _jax_step(occupy_timeout_ms=500, with_shaping=False, with_param=False, sh_rounds=0, p_rounds=0):
    key = (occupy_timeout_ms, with_shaping, with_param, sh_rounds, p_rounds)
    fn = _JAX_STEPS.get(key)
    if fn is None:
        fn = jpar.make_sharded_flush(jpar.make_mesh(D), occupy_timeout_ms=occupy_timeout_ms,
                                     with_shaping=with_shaping, with_param=with_param,
                                     shaping_rounds=sh_rounds, param_rounds=p_rounds)
        _JAX_STEPS[key] = fn
    return fn


def _host(x):
    """Writable numpy copies of a JAX pytree."""
    return jax.tree_util.tree_map(np.array, jax.device_get(x))


class _Both:
    """One sharded state held by both packages: numpy in, the JAX and the
    port's step on the same batches, every output compared."""

    def __init__(self, stats, table, dyn, dtable, ddyn, pdyn, sys_vals, occupy_timeout_ms=500):
        self.occ = occupy_timeout_ms
        self.j = [_jax_stats(stats), JTable(*map(jnp.asarray, table)), JDyn(*map(jnp.asarray, dyn)),
                  jdt.DegradeTableDevice(*map(jnp.asarray, dtable)), jdt.DegradeDynState(*map(jnp.asarray, ddyn)),
                  jpt.ParamDynState(*map(jnp.asarray, pdyn)), jflush.SystemDevice(*(jnp.float32(v) for v in sys_vals))]
        tt, td = flow_table_from_numpy(table, dyn, CPU)
        self.t = [tnodes.stats_from_numpy(stats, CPU), tt, td, tdt.degrade_table_from_numpy(dtable, CPU),
                  tdt.degrade_state_from_numpy(ddyn, CPU), tpt.param_state_from_numpy(pdyn, CPU),
                  tflush.SystemDevice(*sys_vals)]

    def step(self, b, sb=None, pb=None, sh_rounds=0, p_rounds=0, what=""):
        fn = _jax_step(self.occ, sb is not None, pb is not None, sh_rounds, p_rounds)
        extra_j = [x for x in (None if sb is None else jsh.ShapingBatch(*map(jnp.asarray, sb)),
                               None if pb is None else jpt.ParamBatch(*map(jnp.asarray, pb))) if x is not None]
        js, jfd, jdd, jpd, jres = fn(*self.j, jflush.FlushBatch(*map(jnp.asarray, b)), *extra_j)
        self.j[0], self.j[2], self.j[4], self.j[5] = js, jfd, jdd, jpd
        tfn = tpar.make_sharded_flush(tpar.make_mesh(D, CPU), occupy_timeout_ms=self.occ,
                                      with_shaping=sb is not None, with_param=pb is not None,
                                      shaping_rounds=sh_rounds, param_rounds=p_rounds)
        extra_t = [x for x in (None if sb is None else tsh.shaping_batch_from_numpy(sb, CPU),
                               None if pb is None else tpt.param_batch_from_numpy(pb, CPU)) if x is not None]
        ts, tfd, tdd, tpd, tres = tfn(*self.t, tflush.batch_from_numpy(b, CPU), *extra_t)
        self.t[0], self.t[2], self.t[4], self.t[5] = ts, tfd, tdd, tpd
        for name in RESULT_FIELDS:
            assert_same(getattr(jres, name), getattr(tres, name), f"{what} {name}")
        self.check_state(what)
        return jres

    def check_state(self, what=""):
        assert_same(jax.device_get(self.j[0]), tnodes.stats_to_numpy(self.t[0]), f"{what} stats")
        assert_same(tuple(jax.device_get(self.j[2])), tuple(t.numpy() for t in self.t[2]), f"{what} shaping state")
        assert_same(jax.device_get(self.j[4]), tdt.degrade_state_to_numpy(self.t[4]), f"{what} breakers")
        assert_same(tuple(jax.device_get(self.j[5])), tuple(t.numpy() for t in self.t[5]), f"{what} param state")


STREAM_VARIANTS = {  # name: (with_shaping, with_param)
    "plain": (False, False),
    "shaping": (True, False),
    "param": (False, True),
    "shaping_param": (True, True),
}


@pytest.mark.mesh
@pytest.mark.parametrize("variant", sorted(STREAM_VARIANTS))
def test_sharded_step_random_stream(variant):
    """A random 4-flush stream with every stage on: prioritized entries,
    inbound entries under system rules, authority and token-server
    refusals, breakers of every grade and state with exits, and (by
    variant) shaping and param items over the global batch."""
    with_shaping, with_param = STREAM_VARIANTS[variant]
    rng = np.random.default_rng(sorted(STREAM_VARIANTS).index(variant) + 70)
    n_rows, nr, nd, n, k, kd, m, pr = 32, 16, 16, 64, 2, 2, 32, 32
    now = 3_456_000 + int(rng.integers(0, 500))
    table, dyn = random_shaped_flow_table(rng, nr)
    if not with_shaping:  # shaping rules without a shaping batch: their slots pass
        table = (table[0], table[1], np.zeros(nr, np.int32)) + table[3:]
    dtable, ddyn = random_degrade(rng, nd, now)
    both = _Both(borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG), table, dyn, dtable,
                 ddyn, random_param_state(rng, pr, now), system_thresholds("all"), occupy_timeout_ms=1000)
    reasons = set()
    for step in range(4):
        b = random_chain_batch(rng, n, k, kd, n_rows, nr, nd, now + 450 * step, m)
        sb = shaping_batch_for(b, table) if with_shaping else None
        pb = random_param_batch_for(rng, b, pr) if with_param else None
        res = both.step(b, sb, pb, what=f"{variant} step {step}")
        reasons |= set(np.asarray(res.reason).tolist())
    assert {0, 1, 2, 3, 4} <= reasons, reasons


# --- the multichip fixtures (tests/test_multichip.py, test_occupy.py:397) ------


FIX_N, FIX_M, FIX_ROWS = 128, 24, 16


def _fixture(count=20.0, acquire=1, grade=None, n_exits=0, threads0=0, degrade_on_r0=False, exits_dgid0=False,
             breaker_state=None, next_retry=None, x_err0=0):
    """tests/test_multichip.py's _sharded_fixture as numpy, at one fixed
    shape (128 entries, 24 exits, 16 rows: every case shares one compiled
    JAX step). All entries check rule 0 on row 0."""
    from sentinel_tpu.metrics.nodes import make_stats
    from sentinel_tpu.models import constants as JC
    from sentinel_tpu.models.rules import DegradeRule, FlowRule
    from sentinel_tpu.rules.degrade_table import DegradeIndex
    from sentinel_tpu.rules.flow_table import FlowIndex

    stats = _host(make_stats(FIX_ROWS))
    stats.threads[0] = threads0
    index = FlowIndex([FlowRule(resource=f"r{i}", count=count, grade=JC.FLOW_GRADE_QPS if grade is None else grade)
                       for i in range(4)])
    dindex = DegradeIndex([DegradeRule(resource="r0", grade=1, count=0.5, time_window=10)])
    ddyn = _host(dindex.make_dyn_state())
    if breaker_state is not None:
        ddyn.state[0] = breaker_state
    if next_retry is not None:
        ddyn.next_retry[0] = next_retry
    n, m = FIX_N, FIX_M
    rows = np.full((n, 4), -1, np.int32)
    rows[:, 0] = 0
    x_valid = np.zeros(m, bool)
    x_rows = np.full((m, 4), -1, np.int32)
    x_thr = np.zeros(m, np.int32)
    x_valid[:n_exits] = True
    x_rows[:n_exits, 0] = 0
    x_thr[:n_exits] = -1
    x_err = np.zeros(m, np.int32)
    x_err[0] = x_err0
    e_dgid = np.full((n, 1), 0 if degrade_on_r0 else -1, np.int32)
    x_dgid = np.full((m, 1), -1, np.int32)
    if exits_dgid0:
        x_dgid[:n_exits, 0] = 0
    batch = (np.int32(1000), np.ones(n, bool), (600 + np.arange(n) % 400).astype(np.int32),
             np.full(n, acquire, np.int32), rows, np.zeros((n, 1), np.int32), np.zeros((n, 1), np.int32),
             np.zeros(n, bool), np.ones(n, bool), np.ones(n, bool), e_dgid,
             x_valid, np.full(m, 700, np.int32), np.zeros(m, np.int32), x_rows, np.zeros(m, np.int32), x_err, x_thr,
             x_dgid)
    both = _Both(stats, jax.device_get(index.device), jax.device_get(index.make_dyn_state()),
                 jax.device_get(dindex.device), ddyn, jax.device_get(jpt.make_param_state(8)),
                 system_thresholds("off"), occupy_timeout_ms=1000)
    return both, batch


def _admitted(res):
    return int(np.asarray(res.admitted).sum())


def _budget_8x16(both, b):
    res = both.step(b)
    counts = _host(both.j[0]).second.counts[0].sum(axis=0)
    assert (_admitted(res), counts[0], counts[1]) == (20, 20, 108)


def _second_flush_spent(both, b):
    assert _admitted(both.step(b)) == 20
    assert _admitted(both.step((np.int32(1200),) + b[1:])) == 0


def _admits(n):
    def check(both, b):
        assert _admitted(both.step(b)) == n

    return check


def _releases(both, b):
    assert _admitted(both.step(b)) == 20
    assert int(_host(both.j[0]).threads[0]) == 20  # 20 - 20 released + 20 acquired


def _within_grant(both, b):
    assert _admitted(both.step(b)) <= 2


def _breaker_ends(state):
    def check(both, b):
        both.step(b)
        assert int(_host(both.j[4]).state[0]) == state

    return check


FIXTURES = {
    # name: (fixture kwargs, check(both, batch))
    "budget_8x16_count20": (dict(), _budget_8x16),
    "second_flush_spent": (dict(), _second_flush_spent),
    "acquire_units": (dict(acquire=3), _admits(6)),
    "under_capacity": (dict(count=1000.0), _admits(128)),
    "thread_grade_entries": (dict(acquire=3, grade=0), _admits(18)),
    "thread_same_batch_releases": (dict(grade=0, threads0=20, n_exits=20), _releases),
    "thread_no_release": (dict(grade=0, threads0=20), _admits(0)),
    "half_open_probe_within_grant": (dict(count=2.0, degrade_on_r0=True, breaker_state=1, next_retry=500),
                                     _within_grant),
    "half_open_probe_closes": (dict(count=1000.0, n_exits=1, exits_dgid0=True, breaker_state=2),
                               _breaker_ends(jdt.CLOSED)),
    "half_open_probe_reopens": (dict(count=1000.0, n_exits=1, exits_dgid0=True, breaker_state=2, x_err0=1),
                                _breaker_ends(jdt.OPEN)),
}


@pytest.mark.mesh
@pytest.mark.parametrize("case", sorted(FIXTURES))
def test_multichip_fixture(case):
    """Every case of tests/test_multichip.py on both packages, with its
    asserted numbers."""
    kw, check = FIXTURES[case]
    both, b = _fixture(**kw)
    check(both, b)


@pytest.mark.mesh
def test_occupy_borrows_conserved():
    """tests/test_occupy.py:397: 128 prioritized entries over 8 shards
    against a full window borrow at most maxCount - waiting in total, and
    the merged future slab holds exactly the granted tokens."""
    from sentinel_tpu.metrics.nodes import SECOND_CFG

    both, b = _fixture(count=20.0)
    stats = _host(both.j[0])
    sec = stats.second
    sec.window_start[0, 0] = 1000
    sec.counts[0, 0, 0] = 20
    both = _Both(stats, *(jax.device_get(x) for x in both.j[1:6]), system_thresholds("off"), occupy_timeout_ms=1000)
    b = list(b)
    b[0], b[2], b[7] = np.int32(1100), np.full(FIX_N, 1100, np.int32), np.ones(FIX_N, bool)
    res = both.step(tuple(b))
    granted = _admitted(res)
    slab = _host(both.j[0]).future_pass[0].sum()
    assert granted == 20 and slab == granted and (np.asarray(res.wait_ms)[np.asarray(res.admitted)] > 0).all()
    assert SECOND_CFG.interval_ms == 1000


# --- the merges (K13, K14) -------------------------------------------------------

from jax.sharding import PartitionSpec as P  # noqa: E402

from sentinel_tpu.parallel import ici as jici  # noqa: E402
from torch_parity import (  # noqa: E402
    BREAKER_CASES,
    BUDGET_WRAP_CASES,
    budget_wrap_case,
    breaker_merge_table,
    random_flow_table,
    random_flush_batch,
    random_shard_stats,
    random_stats,
    run_on_both,
    shard_breaker_case,
)

_JAX_FNS = {}


def _sharded(name, body, in_specs, out_specs):
    """A jitted shard_map of ``body`` over the 8-device mesh, built once."""
    from jax import shard_map  # absent from older jax: the mesh marker skips these tests there

    fn = _JAX_FNS.get(name)
    if fn is None:
        fn = jax.jit(shard_map(body, mesh=jpar.make_mesh(D), in_specs=in_specs, out_specs=out_specs,
                               check_vma=False))
        _JAX_FNS[name] = fn
    return fn


def _local(tree):
    return jax.tree_util.tree_map(lambda x: x[0], tree)


@pytest.mark.mesh
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_stats_across_matches_jax(seed):
    """Shards that rolled buckets to newer windows (to different ones),
    added in place, or left stale buckets; min RT, the future slab with
    matured and future windows, the thread gauge."""
    rng = np.random.default_rng(seed + 90)
    n_rows, now = 16, 3_456_789
    old = random_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    new = random_shard_stats(rng, old, now, D, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    fn = _sharded("merge_stats", lambda o, nw: jpar.merge_stats_across(o, _local(nw), "data"), (P(), P("data")), P())
    want = fn(_jax_stats(old), _jax_stats(new))
    got = tpar.merge_stats_across(tnodes.stats_from_numpy(old, CPU), tnodes.stats_from_numpy(new, CPU))
    assert_same(jax.device_get(want), tnodes.stats_to_numpy(got), "merged stats")
    g_ws = new[0][2].max(axis=0)
    assert ((new[0][2] == g_ws).sum(axis=0) < D).any() and (old[0][2] != g_ws).any(), "some shards rolled"


def _jax_merge_breaker(ddev, base_ddyn, new_ddyn, now):
    """merge_breaker of sentinel_tpu/parallel/ici.py:471-524, the closure
    inside the JAX sharded step, transcribed line for line so that it runs
    alone under shard_map."""
    axis = "data"
    changed = new_ddyn.state != base_ddyn.state
    cand = jnp.where(changed, new_ddyn.state, jnp.int32(-1))
    best = jax.lax.pmax(cand, axis)
    merged_state = jnp.where(best >= 0, best, base_ddyn.state)
    g_dws = jax.lax.pmax(new_ddyn.ws, axis)
    d_old_cur = base_ddyn.ws == g_dws
    d_new_cur = new_ddyn.ws == g_dws
    base_bad = jnp.where(d_old_cur, base_ddyn.bad, 0)
    base_total = jnp.where(d_old_cur, base_ddyn.total, 0)
    out = type(base_ddyn)(
        state=merged_state,
        next_retry=jax.lax.pmax(new_ddyn.next_retry, axis),
        bad=base_bad + jax.lax.psum(jnp.where(d_new_cur, new_ddyn.bad - base_bad, 0), axis),
        total=base_total + jax.lax.psum(jnp.where(d_new_cur, new_ddyn.total - base_total, 0), axis),
        ws=g_dws,
    )
    trip = jdt.trip_condition(ddev.grade, ddev.threshold, ddev.slow_ratio, out.bad.astype(jnp.float32),
                              out.total.astype(jnp.float32))
    cross = (out.state == jdt.CLOSED) & (out.total >= ddev.min_request) & trip
    return out._replace(state=jnp.where(cross, jdt.OPEN, out.state),
                        next_retry=jnp.where(cross, now + ddev.retry_ms, out.next_retry))




@pytest.mark.mesh
@pytest.mark.parametrize("case", BREAKER_CASES)
def test_merge_breaker_matches_jax(case):
    rng = np.random.default_rng(BREAKER_CASES.index(case) + 30)
    now = 50_000
    dtable, ddyn = breaker_merge_table(rng, 16, now)
    base, new = shard_breaker_case(case, rng, dtable, ddyn, now, D)
    fn = _sharded("merge_breaker", lambda dd, b, nw, t: _jax_merge_breaker(dd, b, _local(nw), t),
                  (P(), P(), P("data"), P()), P())
    want = jax.device_get(fn(jdt.DegradeTableDevice(*map(jnp.asarray, dtable)),
                             jdt.DegradeDynState(*map(jnp.asarray, base)),
                             jdt.DegradeDynState(*map(jnp.asarray, new)), jnp.int32(now)))
    got = tici.merge_breaker(tdt.degrade_table_from_numpy(dtable, CPU), tdt.degrade_state_from_numpy(base, CPU),
                             tdt.degrade_state_from_numpy(new, CPU), now)
    assert_same(want, tdt.degrade_state_to_numpy(got), case)
    expect = {"half_open_to_closed": jdt.CLOSED, "half_open_to_open": jdt.OPEN,
              "two_transitions_max_wins": jdt.OPEN, "trip_on_merged_counts": jdt.OPEN}
    if case in expect:
        assert int(want.state[0]) == expect[case]
    if case == "window_roll_on_some_shards":
        assert (int(want.bad[0]), int(want.total[0])) == (3, 6)


# --- the budgets (cluster_allocate, K15) ----------------------------------------


@pytest.mark.mesh
def test_cluster_allocate_matches_jax():
    """tests/test_cluster.py:192 (8 demands, capacity 10: 5, 3, 2, 0, ...)
    and random per-row demands against per-row capacities."""
    demands = np.array([5, 3, 7, 0, 2, 9, 1, 4], np.int32)
    fn = _sharded("alloc", lambda d, c: jpar.cluster_allocate("data", d, c), (P("data"), P()), P("data"))
    want = np.asarray(fn(jnp.asarray(demands), jnp.int32(10)))
    coll = tpar.ShardCollectives(D)
    got = tpar.cluster_allocate(coll, torch.from_numpy(demands), torch.tensor(10, dtype=torch.int32))
    assert want.tolist() == got.tolist() == [5, 3, 2, 0, 0, 0, 0, 0]
    rng = np.random.default_rng(5)
    dem = rng.integers(0, 9, (D, 16)).astype(np.int32)
    cap = rng.integers(0, 40, 16).astype(np.int32)
    fn2 = _sharded("alloc_before", lambda d, c: jpar.cluster_allocate("data", d[0], c, with_before=True),
                   (P("data"), P()), (P("data"), P("data")))
    wg, wb = (np.asarray(x).reshape(D, 16) for x in fn2(jnp.asarray(dem), jnp.asarray(cap)))
    tg, tb = tpar.cluster_allocate(coll, torch.from_numpy(dem), torch.from_numpy(cap), with_before=True)
    assert_same(wg, tg, "grant")
    assert_same(wb, tb, "before")
    assert (wg.sum(axis=0) == np.minimum(dem.sum(axis=0), cap)).all()


def _budget_case(case, rng):
    n, k, n_rows, nr, now = 64, 2, 16, 8, 3_456_000
    stats = borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    table, _ = random_flow_table(rng, nr, thread_frac={"qps": 0.0, "thread": 1.0}.get(case, 0.4), lo=2, hi=9)
    b = list(random_flush_batch(rng, n, k, n_rows, nr, now, n - 5))
    if case == "origin_split":  # two rules checked against one row (test_engine_mesh.py:328)
        b[6][:, 1] = b[6][:, 0]
        b[5][:, 1] = (b[5][:, 0] + 1) % (nr - 2)
    b[3] = rng.integers(1, 4, n).astype(np.int32)  # acquire > 1
    b[5][rng.random((n, k)) < 0.1] = -1  # invalid slots
    live = rng.random(n) < 0.85
    return stats, table, tuple(b), live


@pytest.mark.mesh
@pytest.mark.parametrize("case", ["qps", "thread", "mixed", "origin_split"])
def test_demote_over_grant_matches_jax(case):
    rng = np.random.default_rng(["qps", "thread", "mixed", "origin_split"].index(case) + 11)
    stats, table, b, live = _budget_case(case, rng)
    fn = _sharded("grant", lambda s, f, bt, lv: jici._demote_over_grant("data", s, f, bt, lv),
                  (P(), P(), jpar.batch_partition_specs("data"), P("data")), P("data"))
    want = np.asarray(fn(_jax_stats(stats), JTable(*map(jnp.asarray, table)), jflush.FlushBatch(*map(jnp.asarray, b)),
                         jnp.asarray(live)))
    tt, _ = flow_table_from_numpy(table, None, CPU)
    got = tici._demote_over_grant(D, tnodes.stats_from_numpy(stats, CPU), tt, tflush.batch_from_numpy(b, CPU),
                                  torch.from_numpy(live))
    assert_same(want, got, case)
    assert want.any() and not want.all(), "some entries demoted, some kept"


@pytest.mark.mesh
def test_demote_over_borrow_matches_jax():
    """The borrow budget against a partly filled future slab."""
    rng = np.random.default_rng(23)
    stats, table, b, _ = _budget_case("qps", rng)
    occ = (rng.random(b[5].shape) < 0.5) & (b[5] >= 0)
    fn = _sharded("borrow", lambda s, f, bt, o: jici._demote_over_borrow("data", s, f, bt, o),
                  (P(), P(), jpar.batch_partition_specs("data"), P("data")), P("data"))
    want = np.asarray(fn(_jax_stats(stats), JTable(*map(jnp.asarray, table)), jflush.FlushBatch(*map(jnp.asarray, b)),
                         jnp.asarray(occ)))
    tt, _ = flow_table_from_numpy(table, None, CPU)
    got = tici._demote_over_borrow(D, tnodes.stats_from_numpy(stats, CPU), tt, tflush.batch_from_numpy(b, CPU),
                                   torch.from_numpy(occ))
    assert_same(want, got, "keep")
    assert want.any() and not want.all()
    assert (stats[3] > 0).any(), "the slab holds waiting tokens"


# --- the budget split past 2**31 (K15's per-shard prefix) ---------------------------

def _jax_wrap_form(form, stats, table, b, cap, n_rows):
    jb = jflush.FlushBatch(*map(jnp.asarray, b))
    bspec = jpar.batch_partition_specs("data")
    all_slots = np.ones(b[5].shape, bool)
    if form == "split":
        fn = _sharded("wrap_split", lambda bt, m, u, c: jici._split_and_spend("data", bt, n_rows, m, u, c),
                      (bspec, P("data"), P("data"), P("data")), P("data"))
        unit = np.repeat(b[3], b[5].shape[1])
        return fn(jb, jnp.asarray(all_slots.reshape(-1)), jnp.asarray(unit), jnp.asarray(cap))
    if form == "grant":
        fn = _sharded("wrap_grant", lambda s, f, bt, lv: jici._demote_over_grant("data", s, f, bt, lv),
                      (P(), P(), bspec, P("data")), P("data"))
        return fn(_jax_stats(stats), JTable(*map(jnp.asarray, table)), jb, jnp.asarray(np.ones(b[1].shape, bool)))
    fn = _sharded("wrap_borrow", lambda s, f, bt, o: jici._demote_over_borrow("data", s, f, bt, o),
                  (P(), P(), bspec, P("data")), P("data"))
    return fn(_jax_stats(stats), JTable(*map(jnp.asarray, table)), jb, jnp.asarray(all_slots))


def _port_wrap_form(form, stats, table, b, cap, n_rows):
    tb = tflush.batch_from_numpy(b, CPU)
    all_slots = torch.ones(tuple(b[5].shape), dtype=torch.bool)
    if form == "split":
        unit = torch.from_numpy(np.repeat(b[3], b[5].shape[1]))
        return tici._split_and_spend(D, tb, n_rows, all_slots.reshape(-1), unit, torch.from_numpy(cap))
    tt, _ = flow_table_from_numpy(table, None, CPU)
    ts = tnodes.stats_from_numpy(stats, CPU)
    if form == "grant":
        return tici._demote_over_grant(D, ts, tt, tb, torch.ones(b[1].shape[0], dtype=torch.bool))
    return tici._demote_over_borrow(D, ts, tt, tb, all_slots)


@pytest.mark.mesh
@pytest.mark.parametrize("form", ["split", "grant", "borrow"])
@pytest.mark.parametrize("case", BUDGET_WRAP_CASES)
def test_budget_split_past_2_31_matches_jax(case, form):
    """The budget split's prefix restarts on every shard, as JAX's
    per-chip ``segment_excl_cumsum`` does, also where the units of the
    earlier shards have carried the running sum past 2**31 (a prefix over
    all shards at once keeps an earlier shard's group base there)."""
    stats, table, b, cap = budget_wrap_case(case, D)
    want = np.asarray(_jax_wrap_form(form, stats, table, b, cap, 8))
    got = _port_wrap_form(form, stats, table, b, cap, 8)
    assert_same(want, got, f"{case} {form}")
    assert want.any() and not want.all(), "some entries demoted, some kept"
    if case == "smallest" and form == "split":
        assert want.astype(int).tolist() == [1, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1, 0, 0, 1]


def _huge_acquires_on_mesh(lib):
    """Entries with acquires near 2**29 on one resource through the mesh
    engine: their units pass 2**31 across the shards."""
    lib.engine.enable_mesh(8)
    lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("big", count=2.0e9)])
    rng = np.random.default_rng(77)
    out = []
    for _ in range(3):
        lib.clock.advance(1000)
        now = lib.clock.now_ms()
        acq = rng.integers(2**28, 2**29 + 2**28, 24)
        ops = lib.engine.submit_many([{"resource": "big", "ts": now - int(d), "acquire": int(a)}
                                      for a, d in zip(acq, rng.integers(0, 50, 24))])
        lib.engine.flush()
        out.append([op.verdict.admitted for op in ops])
    lib.engine.disable_mesh()
    return out


@pytest.mark.mesh
def test_huge_acquires_on_mesh_engine_match_jax():
    got = run_on_both(_huge_acquires_on_mesh)
    assert any(any(v) for v in got) and not all(all(v) for v in got)


# --- the global scans ---------------------------------------------------------------


@pytest.mark.mesh
def test_global_param_scan_matches_jax():
    """Every grade and behavior, exits releasing thread slots, LRU resets,
    entries blocked upstream on their owner shard."""
    rng = np.random.default_rng(33)
    n, pr, now = 64, 32, 3_456_000
    b = random_chain_batch(rng, n, 2, 2, 32, 16, 16, now, 32)
    pb = random_param_batch_for(rng, b, pr)
    pdyn = random_param_state(rng, pr, now)
    live = rng.random(n) < 0.8

    def body(pd, pg, lv):
        new, (ok, wait), _, _ = jici._global_param_scan("data", pd, pg, lv, n // D)
        return new, ok, wait

    fn = _sharded("param_scan", body, (P(), P(), P("data")), (P(), P("data"), P("data")))
    want = fn(jpt.ParamDynState(*map(jnp.asarray, pdyn)), jpt.ParamBatch(*map(jnp.asarray, pb)), jnp.asarray(live))
    tpd = tpt.param_state_from_numpy(pdyn, CPU)
    ok, wait, _ = tici._global_param_scan(tpd, tpt.param_batch_from_numpy(pb, CPU), torch.from_numpy(live))
    assert_same(tuple(jax.device_get(want[0])), tuple(t.numpy() for t in tpd), "param state")
    assert_same(want[1], ok, "param_ok")
    assert_same(want[2], wait, "wait")
    assert not np.asarray(want[1]).all() and (np.asarray(want[2]) > 0).any()


def _jax_charge(stats, sb, now):
    """The global shaping charge as JAX's _global_shaping_scan computes it
    (sentinel_tpu/parallel/ici.py:387-409), from the JAX package's own
    pieces: the passQps input of every item, in item order."""
    valid, _, row, eidx, _, ts, acq = map(jnp.asarray, sb)
    s, r_rows = valid.shape[0], stats[2].shape[0]
    pass_sums = jnodes.ma.window_sums(jnodes.SECOND_CFG, _jax_stats(stats).second, jnp.int32(now))[:, 0]
    rkey = jnp.where(valid, row, jnp.int32(r_rows))
    rk_s, _, p_s = jax.lax.sort((rkey, ts, jnp.arange(s, dtype=jnp.int32)), num_keys=3)
    ei_s = eidx[p_s]
    ones = jnp.ones((1,), dtype=bool)
    new_grp = jnp.concatenate([ones, rk_s[1:] != rk_s[:-1]])
    last = jnp.concatenate([rk_s[1:] != rk_s[:-1], ones]) | jnp.concatenate([ei_s[1:] != ei_s[:-1], ones])
    consumed = jflush._segment_consumed(new_grp, last, jnp.where(valid[p_s], acq[p_s], 0))
    base = pass_sums[jnp.clip(rk_s, 0, r_rows - 1)]
    return jnp.zeros((s,), dtype=jnp.int32).at[p_s].set((base + consumed).astype(jnp.int32))


@pytest.mark.mesh
@pytest.mark.parametrize("case", SHAPING_CHARGE_CASES)
def test_global_shaping_scan_matches_jax(case):
    """The global pacer scan with upstream-blocked entries (their items
    charge the passQps input but advance no pacer), and its charge (K16's
    plain version) against JAX's, on K16's edges: every item invalid, one
    row, ts ties across entries, negative ts, sums past 2^31."""
    rng = np.random.default_rng(37)
    n, k, n_rows, nr, now = 64, 2, 32, 16, 3_456_000
    stats = borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    table, dyn = random_shaped_flow_table(rng, nr)
    b = random_chain_batch(rng, n, k, 2, n_rows, nr, 16, now, 32)
    sb = shaping_charge_case(case, shaping_batch_for(b, table))
    live = rng.random(n) < 0.75
    ppc = tici.mesh_shaping_charge(tnodes.stats_from_numpy(stats, CPU).second, tsh.shaping_batch_from_numpy(sb, CPU),
                                   now)
    assert_same(_jax_charge(stats, sb, now), ppc, f"{case}: charge")

    def body(s, f, fd, sg, bt, lv):
        return jici._global_shaping_scan("data", s, f, fd, sg, bt, lv, n // D, k)

    fn = _sharded("shaping_scan", body, (P(), P(), P(), P(), jpar.batch_partition_specs("data"), P("data")),
                  (P(), P("data")))
    want_fd, want_pre = fn(_jax_stats(stats), JTable(*map(jnp.asarray, table)), JDyn(*map(jnp.asarray, dyn)),
                           jsh.ShapingBatch(*map(jnp.asarray, sb)), jflush.FlushBatch(*map(jnp.asarray, b)),
                           jnp.asarray(live))
    tt, td = flow_table_from_numpy(table, dyn, CPU)
    tsb = tsh.shaping_batch_from_numpy(sb, CPU)
    valid, ok, wait = tici._global_shaping_scan(tnodes.stats_from_numpy(stats, CPU), tt, td, tsb, int(b[0]),
                                                torch.from_numpy(live))
    pre = [tici._shaping_pre_of(tsb, valid, ok, wait, d, n // D, k) for d in range(D)]
    assert_same(tuple(jax.device_get(want_fd)), tuple(t.numpy() for t in td), f"{case}: pacer state")
    for i, name in enumerate(("valid", "flat", "eidx", "ok", "wait")):
        assert_same(want_pre[i], torch.cat([p[i] for p in pre]), f"{case}: {name}")
    assert not np.asarray(want_pre[0]).all()
    if case == "random":
        assert not np.asarray(want_pre[3]).all() and (np.asarray(want_pre[4]) > 0).any()
    if case == "past_2_31":
        assert (ppc < 0).any(), "no charge passed 2^31"


def test_shard_batch_round_trip():
    rng = np.random.default_rng(3)
    b = tflush.batch_from_numpy(random_chain_batch(rng, 64, 2, 2, 32, 16, 16, 5000, 32), CPU)
    parts = tpar.shard_batch(b, D)
    assert len(parts) == D and all(p.e_valid.shape[0] == 8 and p.x_valid.shape[0] == 4 for p in parts)
    for name in tflush.FlushBatch._fields[1:]:
        assert torch.equal(torch.cat([getattr(p, name) for p in parts]), getattr(b, name))
    with pytest.raises(ValueError, match="do not split"):
        tpar.shard_batch(b, 3)
