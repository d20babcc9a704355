"""Parity of the port's stats read (sentinel_tpu_torch/metrics/nodes.py
``rows_stats_plain``, the plain version of the ``row_stats`` kernel, and
``Engine.rows_stats``) with the JAX package's, bit for bit: each column of
a record against the JAX function that reads it (``window_sums`` of both
windows, ``window_min_rt``, the gauge, ``occupied_in_window`` and
``waiting_tokens``, as ``Engine._all_stats_arrays`` combines them) at the
asked rows, and the two engines' stats dicts over a stream with occupy
borrows. Tolerance is zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.metrics import metric_array as jma
from sentinel_tpu.metrics import nodes as jnodes
from sentinel_tpu.utils.config import config as jconfig
from sentinel_tpu_torch.metrics import nodes as tnodes
from sentinel_tpu_torch.utils.config import config

from test_torch_engine import RESOURCES, _Pair
from test_torch_nodes import _jax_stats
from torch_parity import STATS_READ_CASES, STATS_READ_ROWS, assert_same, stats_read_case, stats_read_rows

CPU = torch.device("cpu")


def _jax_records(arrs, rows, now):
    """The JAX engine's six stats arrays at ``rows``, as one [R', 16] record."""
    js = _jax_stats(arrs)
    n = jnp.int32(now)
    cols = [
        jma.window_sums(jnodes.SECOND_CFG, js.second, n),
        jma.window_sums(jnodes.MINUTE_CFG, js.minute, n),
        jma.window_min_rt(jnodes.SECOND_CFG, js.second, n)[:, None],
        js.threads[:, None],
        jnodes.occupied_in_window(js, n)[:, None],
        jnodes.waiting_tokens(js, n)[:, None],
    ]
    return np.concatenate([np.asarray(c, dtype=np.int32) for c in cols], axis=1)[rows]


@pytest.mark.parametrize("rows_kind", STATS_READ_ROWS)
@pytest.mark.parametrize("case", STATS_READ_CASES)
def test_rows_stats_plain_matches_jax(case, rows_kind):
    arrs, now = stats_read_case(case, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    rows = stats_read_rows(rows_kind, 64)
    got = tnodes.rows_stats(tnodes.stats_from_numpy(arrs, CPU), torch.from_numpy(rows), now)
    assert got.shape == (len(rows), tnodes.RS_WIDTH)
    assert_same(_jax_records(arrs, rows, now), got, f"{case} {rows_kind}")


def test_rows_stats_record_columns():
    """Each RS_* column holds what its name says, and the edges the cases
    build are there: occupied counts age 1,000 and not 1,001, waiting
    counts now + 1 and not now, the wrap case's sums pass 2^31."""
    arrs, now = stats_read_case("age_edges", tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    rec = tnodes.rows_stats_plain(tnodes.stats_from_numpy(arrs, CPU), torch.arange(64, dtype=torch.int32), now)
    fpass, fws = arrs[3], arrs[4]
    age = now - fws.astype(np.int64)
    assert_same(np.where((age >= 0) & (age <= 1000), fpass, 0).sum(1).astype(np.int32), rec[:, tnodes.RS_OCCUPIED])
    assert_same(np.where(fws > now, fpass, 0).sum(1).astype(np.int32), rec[:, tnodes.RS_WAITING])
    assert_same(arrs[2], rec[:, tnodes.RS_THREADS])
    assert (age == 1000).any() and (age == 1001).any() and (age == 0).any() and (age == -1).any()
    wrap, now_w = stats_read_case("wrap", tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    rec = tnodes.rows_stats_plain(tnodes.stats_from_numpy(wrap, CPU), torch.arange(64, dtype=torch.int32), now_w)
    exact = wrap[1][0].astype(np.int64).sum(1)
    assert (exact > 2**31).all()
    assert_same((exact % 2**32).astype(np.uint32).view(np.int32), rec[:, tnodes.RS_MINUTE])


def test_rows_stats_clips_rows_as_window_reduce():
    """Rows outside [0, R) read the nearest row, as K3's gather does."""
    arrs, now = stats_read_case("random", tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    stats = tnodes.stats_from_numpy(arrs, CPU)
    got = tnodes.rows_stats(stats, torch.tensor([-5, 0, 63, 64, 999], dtype=torch.int32), now)
    assert_same(_jax_records(arrs, np.array([0, 0, 63, 63, 63]), now), got)


def _borrow_stream(pair, rng, steps):
    """Flushes of 40 entries (prioritized singles and one bulk group) and
    20 exits on the resources of test_torch_engine's rules; yields after
    each flush."""
    now = 50_000
    last = None
    for step in range(steps):
        now += int(rng.choice([0, 40, 180, 420, 700]))
        pair.set_ms(now)
        singles = []
        for _ in range(10):
            res = str(rng.choice(RESOURCES))
            singles.append(pair.both("submit_entry", res, acquire=int(rng.integers(1, 3)),
                                     prio=bool(rng.random() < 0.5), ts=now - int(rng.integers(0, 60))))
        ts = np.sort(now - rng.integers(0, 300, 30)).astype(np.int32)
        groups = [pair.both("submit_bulk", str(rng.choice(RESOURCES)), 30, ts=ts,
                            acquire=rng.integers(1, 3, 30).astype(np.int32))]
        rows = last.rows if last is not None else (-1, -1, -1, -1)
        pair.both("submit_exit_bulk", rows, 20, rt=int(rng.integers(0, 90)), ts=now,
                  resource=last.resource if last is not None else None)
        pair.flush_and_compare(singles, groups, step)
        last = groups[0][1]
        yield step


def test_engine_stats_read_lockstep():
    """The JAX engine against the port's on the CPU over a stream with
    occupy borrows: after every flush ``rows_stats`` of 50 rows (unsorted,
    with duplicates) and ``cluster_node_stats`` of every resource agree."""
    config.set(config.OCCUPY_TIMEOUT_MS, "1000")
    jconfig.set(jconfig.OCCUPY_TIMEOUT_MS, "1000")
    try:
        rng = np.random.default_rng(5)
        pair = _Pair(50_000)
        borrowed = waiting = False
        for step in _borrow_stream(pair, rng, 16):
            rows = [int(r) for r in rng.integers(0, 64, 50)]
            j, t = pair.both("rows_stats", rows)
            assert j == t, f"step {step}: rows_stats"
            for res in RESOURCES:
                j, t = pair.both("cluster_node_stats", res, flush=False)
                assert j == t, f"step {step}: cluster_node_stats({res})"
                waiting |= bool(t and t["waiting"] > 0)
            assert pair.j.entry_node_stats(flush=False) == pair.t.entry_node_stats(flush=False)
            fws = tnodes.stats_to_numpy(pair.t.stats).future_ws
            borrowed |= bool((fws != tnodes.SECOND_CFG.empty_ws).any())
        assert borrowed and waiting, "the stream made no occupy borrow"
    finally:
        config.reset()
        jconfig.reset()


def test_engine_rows_stats_out_of_range_raises():
    """A row outside the stats raises IndexError (the JAX engine's numpy
    read raises at R too); an empty list reads nothing."""
    pair = _Pair(1_000)
    n = pair.t.stats.n_rows
    with pytest.raises(IndexError):
        pair.j.rows_stats([n])
    for bad in ([n], [0, -1], [3, n + 7]):
        with pytest.raises(IndexError):
            pair.t.rows_stats(bad)
    assert pair.t.rows_stats([]) == {} == pair.j.rows_stats([])
    assert pair.t.rows_stats([n - 1]) == pair.j.rows_stats([n - 1])
