"""Prioritized entries borrowing future windows on the port
(sentinel_tpu_torch/runtime/flush.py: the occupy branch of
``flow_admission`` and ``commit_borrow_slab``, plain PyTorch versions on
the CPU) against the JAX package, bit for bit, and against the
sequential oracle: seeded batches over a future slab with matured,
current and future cells and a hot row; the tryOccupyNext grid of
tests/test_occupy.py; the borrow commit with same, newer and older
target windows; and the engine scenarios of tests/test_occupy.py on both
engines in lockstep."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.runtime import flush as jflush
from sentinel_tpu.testing.oracle import OracleBucket, OracleDefaultController, OracleNode
from sentinel_tpu_torch.metrics import nodes as tnodes
from sentinel_tpu_torch.rules.flow_table import flow_table_from_numpy
from sentinel_tpu_torch.runtime import flush as tflush

from test_torch_nodes import _jax_stats, _random_stats
from torch_parity import (
    assert_same,
    block_of,
    borrowable_stats,
    random_flow_table,
    random_flush_batch,
    run_on_both,
)

CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _j_admission(timeout):
    return jax.jit(lambda s, t, b, live: jflush.flow_admission(s, t, b, live, timeout, with_occupy=True))


_j_commit = jax.jit(jflush.commit_borrow_slab)


def _jax_table(table):
    from sentinel_tpu.rules.flow_table import FlowTableDevice

    return FlowTableDevice(*(jnp.asarray(a) for a in table))


def _occupy_outputs(j):
    slot_ok, flow_pass, _, occupied, occupy_wait, occ_slot, occ_target = j
    return dict(slot_ok=slot_ok, flow_pass=flow_pass, occupied=occupied, occupy_wait=occupy_wait,
                occ_slot=occ_slot, occ_target=occ_target)


@pytest.mark.parametrize("timeout", [500, 1000])
@pytest.mark.parametrize("seed", range(3))
def test_flow_admission_occupy_parity(seed, timeout):
    rng = np.random.default_rng(seed)
    n_rows, nr, n, k = 32, 16, 64, 2
    now = 1_234_000 + int(rng.integers(0, 500))
    arrs = borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    table, _ = random_flow_table(rng, nr, thread_frac=0.2, lo=2, hi=8)
    b = list(random_flush_batch(rng, n, k, n_rows, nr, now, 60))
    b[7] = rng.random(n) < 0.5  # e_prio
    live = b[1] & (rng.random(n) < 0.9)
    want = _j_admission(timeout)(_jax_stats(arrs), _jax_table(table), jflush.FlushBatch(*map(jnp.asarray, b)),
                                 jnp.asarray(live))
    tt, _ = flow_table_from_numpy(table, None, CPU)
    got = tflush.flow_admission(tnodes.stats_from_numpy(arrs, CPU), tt, tflush.batch_from_numpy(b, CPU), 0,
                                torch.tensor(live), timeout, with_occupy=True, tail=False)
    for name, val in _occupy_outputs(want).items():
        assert_same(val, getattr(got, name), name)
    assert np.asarray(want[3]).any(), "some entry borrowed"


def _slab_state(rng, n_rows, now):
    """Stats whose slab holds, per cell, nothing, an older window, the
    window a borrow will target, or a newer one."""
    arrs = list(_random_stats(rng, n_rows, now))
    base = now - now % 500
    kind = rng.integers(0, 4, (n_rows, 2))
    fws = np.choose(kind, [np.full(kind.shape, -1001), base - 500 + 0 * kind, base + 500 + 500 * (np.arange(2) == 1),
                           base + 1500 + 500 * (np.arange(2) == 0)]).astype(np.int32)
    arrs[3] = np.where(kind == 0, 0, rng.integers(1, 9, kind.shape)).astype(np.int32)
    arrs[4] = fws
    return tuple(arrs)


@pytest.mark.parametrize("seed", range(4))
def test_commit_borrow_slab_parity(seed):
    rng = np.random.default_rng(20 + seed)
    n_rows, n, k = 16, 64, 2
    now = 700_000 + int(rng.integers(0, 500))
    base = now - now % 500
    arrs = _slab_state(rng, n_rows, now)
    occ = rng.random((n, k)) < 0.5
    tgt = (base + rng.choice([500, 1000, 1500, 2000], (n, k))).astype(np.int32)
    acq = rng.integers(1, 4, n).astype(np.int32)
    crow = rng.integers(0, n_rows, (n, k)).astype(np.int32)
    crow[: n // 2, 0] = 3  # a hot row
    want = jax.device_get(_j_commit(_jax_stats(arrs), *map(jnp.asarray, (occ, tgt, acq, crow))))
    got = tflush.commit_borrow_slab(tnodes.stats_from_numpy(arrs, CPU), *(torch.tensor(a) for a in (occ, tgt, acq, crow)))
    assert_same(want.future_pass, got.future_pass, "future_pass")
    assert_same(want.future_ws, got.future_ws, "future_ws")


# --- the tryOccupyNext grid of tests/test_occupy.py ------------------------


def _seed_node(wp_prev, wp_cur, borrow, ws_cur=10000):
    node = OracleNode()
    cur_idx = (ws_cur // 500) % 2
    b_cur = OracleBucket(ws_cur, 4900)
    b_cur.counts[0] = wp_cur
    node.second.buckets[cur_idx] = b_cur
    b_prev = OracleBucket(ws_cur - 500, 4900)
    b_prev.counts[0] = wp_prev
    node.second.buckets[1 - cur_idx] = b_prev
    if borrow:
        bb = OracleBucket(ws_cur + 500, 4900)
        bb.counts[0] = borrow
        node.second.borrow.buckets[1 - cur_idx] = bb
    return node


def _port_occupy(cases, count, acquire, now, timeout):
    """flow_admission (plain) with one (row, prioritized entry) per case
    against one QPS rule of ``count``, then the borrow commit."""
    n = len(cases)
    rows = int(2 ** np.ceil(np.log2(max(n, 2))))
    st = tnodes.make_stats(rows, CPU)
    ws_cur = now - now % 500
    cur_idx = (ws_cur // 500) % 2
    for r, (wp_prev, wp_cur, borrow) in enumerate(cases):
        st.second.window_start[r, cur_idx] = ws_cur
        st.second.counts[r, cur_idx, 0] = wp_cur
        st.second.window_start[r, 1 - cur_idx] = ws_cur - 500
        st.second.counts[r, 1 - cur_idx, 0] = wp_prev
        if borrow:
            st.future_ws[r, 1 - cur_idx] = ws_cur + 500
            st.future_pass[r, 1 - cur_idx] = borrow
    from sentinel_tpu_torch.models.rules import FlowRule
    from sentinel_tpu_torch.rules.flow_table import FlowIndex

    index = FlowIndex([FlowRule(resource="r", count=float(count))], device=CPU)
    valid = np.zeros(rows, bool)
    valid[:n] = True
    e_rows = np.full((rows, 4), -1, np.int32)
    e_rows[:n, 0] = np.arange(n)
    gid = np.where(valid, 0, -1).astype(np.int32)[:, None]
    crow = np.where(valid, np.arange(rows), -1).astype(np.int32)[:, None]
    m = 8
    b = (np.int32(now), valid, np.full(rows, now, np.int32), np.full(rows, acquire, np.int32), e_rows, gid, crow,
         valid, np.ones(rows, bool), np.ones(rows, bool), np.full((rows, 1), -1, np.int32),
         np.zeros(m, bool), np.zeros(m, np.int32), np.zeros(m, np.int32), np.full((m, 4), -1, np.int32),
         np.zeros(m, np.int32), np.zeros(m, np.int32), np.zeros(m, np.int32), np.full((m, 1), -1, np.int32))
    batch = tflush.batch_from_numpy(b, CPU)
    adm = tflush.flow_admission(st, index.device, batch, 0, None, timeout, with_occupy=True, tail=False)
    tflush.commit_borrow_slab(st, adm.occ_slot & (adm.flow_pass & adm.occupied)[:, None], adm.occ_target,
                              batch.e_acquire, batch.e_check_row)
    return adm.flow_pass.numpy()[:n], adm.occupied.numpy()[:n], adm.occupy_wait.numpy()[:n], st


@pytest.mark.parametrize("count,acquire,now_mod,timeout", [
    (2, 1, 100, 500), (2, 1, 100, 1000), (2, 1, 0, 1000), (4, 1, 250, 1000), (4, 2, 100, 1000), (2, 2, 499, 800),
])
def test_try_occupy_next_grid(count, acquire, now_mod, timeout):
    """The unrolled search makes the reference's decision and exact wait,
    including states only the cumulative ``currentPass -= windowPass``
    admits."""
    now = 10000 + now_mod
    cases = [(p, c, b) for p in range(6) for c in range(6) for b in (0, 1, 2, 5)]
    flow_pass, occupied, wait, _ = _port_occupy(cases, count, acquire, now, timeout)
    for i, (wp_prev, wp_cur, borrow) in enumerate(cases):
        ok, w, occ = OracleDefaultController(float(count), 1, occupy_timeout_ms=timeout).can_pass_prio(
            _seed_node(wp_prev, wp_cur, borrow), now, acquire)
        label = f"wp_prev={wp_prev} wp_cur={wp_cur} borrow={borrow}"
        assert bool(flow_pass[i]) == ok, label
        assert bool(occupied[i]) == occ, label
        if occ:
            assert int(wait[i]) == w, label


def test_slab_commit_lands_on_target_window():
    _, occupied, wait, st = _port_occupy([(0, 3, 0)], count=2, acquire=1, now=10100, timeout=1000)
    assert bool(occupied[0]) and int(wait[0]) == 900
    b = int(np.argmax(st.future_ws[0].numpy()))
    assert int(st.future_ws[0, b]) == 11000 and int(st.future_pass[0, b]) == 1


# --- the engine scenarios of tests/test_occupy.py, on both engines --------


def _setup(lib, count, timeout=1000):
    lib.config.set(lib.config.OCCUPY_TIMEOUT_MS, str(timeout))
    lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("res", count=count)])


def _prio_entry(lib, ts, acq=1, prio=True):
    """(admitted, slept ms) of one entry at ``ts``, left un-exited."""
    lib.clock.set_ms(ts)
    try:
        lib.api.entry("res", count=acq, prio=prio)
    except lib.st.FlowBlockError:
        return (False, 0)
    return (True, lib.clock.now_ms() - ts)


SEQ = [  # (ts, prio, acquire, expect ok, expect wait)
    (1510, False, 1, True, 0), (1520, False, 1, True, 0),
    (2100, True, 1, True, 400), (2110, True, 1, True, 390),
    (2120, True, 1, False, 0),  # borrow cap
    (2505, False, 5, False, 0),  # touch
    (2550, False, 1, False, 0),
    (2620, True, 1, True, 880),  # cumulative search
    (2630, True, 1, True, 870),
    (2640, True, 1, False, 0),  # cap again
    (3505, False, 5, False, 0),
    (3600, False, 1, False, 0),
    (3610, True, 1, True, 890),
]


def _sequence(lib):
    _setup(lib, 2.0)
    out = [_prio_entry(lib, ts, acq, prio) for ts, prio, acq, _, _ in SEQ]
    assert out == [(ok, w) for _, _, _, ok, w in SEQ]
    return out


def _maturation_conservative(lib):
    _setup(lib, 2.0)
    out = [_prio_entry(lib, ts, prio=False) for ts in (1510, 1520)]
    out += [_prio_entry(lib, ts) for ts in (2100, 2110)]
    out.append(_prio_entry(lib, 2610, prio=False))
    assert out[-1] == (False, 0)
    return out


def _waiting_and_minute(lib):
    _setup(lib, 2.0)
    for ts in (1510, 1520):
        _prio_entry(lib, ts, prio=False)
    for ts in (2100, 2110):
        _prio_entry(lib, ts)
    lib.clock.set_ms(2130)
    s1 = lib.engine.cluster_node_stats("res")
    assert (s1["waiting"], s1["total_pass_minute"], s1["pass_qps"], s1["cur_thread_num"]) == (2, 4, 2.0, 4)
    lib.clock.set_ms(2600)
    s2 = lib.engine.cluster_node_stats("res")
    assert s2["waiting"] == 0 and s2["pass_qps"] == 2.0
    return [s1, s2]


def _non_prio_blocks(lib):
    _setup(lib, 1.0)
    out = [_prio_entry(lib, 1000, prio=False), _prio_entry(lib, 1100, prio=False), _prio_entry(lib, 1200)]
    assert out[1] == (False, 0) and out[2][0] and out[2][1] > 0
    return out


def _vetoed_borrow_not_committed(lib):
    lib.config.set(lib.config.OCCUPY_TIMEOUT_MS, "1000")
    lib.st.flow_rule_manager.load_rules([
        lib.st.FlowRule("res", count=1.0), lib.st.FlowRule("res", grade=lib.C.FLOW_GRADE_THREAD, count=1)])
    lib.clock.set_ms(1000)
    e1 = lib.api.entry("res")
    lib.clock.set_ms(1100)
    out = [block_of(lambda: lib.api.entry("res", prio=True))]
    s = lib.engine.cluster_node_stats("res")
    e1.exit()
    assert out[0][0] == "FlowBlockError" and s["waiting"] == 0
    return out + [s]


def _timeout_denies(lib):
    _setup(lib, 1.0, timeout=500)
    out = [_prio_entry(lib, 1000, prio=False), _prio_entry(lib, 1100)]
    assert out[1] == (False, 0)
    return out


SCENARIOS = {
    "sequence": _sequence,
    "maturation_conservative": _maturation_conservative,
    "waiting_and_minute_accounting": _waiting_and_minute,
    "non_prio_blocks_where_prio_borrows": _non_prio_blocks,
    "vetoed_borrow_not_committed": _vetoed_borrow_not_committed,
    "timeout_denies_prio": _timeout_denies,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_occupy_scenario_lockstep(name):
    run_on_both(SCENARIOS[name])
