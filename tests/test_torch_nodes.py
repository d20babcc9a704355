"""Parity of the port's node statistics (sentinel_tpu_torch/metrics/
nodes.py, plain PyTorch versions on the CPU) with the JAX package's, bit
for bit: the matured-borrow sweep over matured, live, future and expired
slab cells, and ``apply_updates`` with the thread gauge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.metrics import nodes as jnodes
from sentinel_tpu_torch.metrics import nodes as tnodes
from sentinel_tpu_torch.metrics.events import NUM_EVENTS

from torch_parity import assert_same, random_stats

CPU = torch.device("cpu")


def _random_stats(rng, n_rows, now):
    return random_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)


def _jax_stats(arrs):
    second, minute, threads, fpass, fws = arrs
    return jnodes.StatsState(
        second=jax.tree_util.tree_map(jnp.asarray, jnodes.ma.MetricArrayState(*second)),
        minute=jax.tree_util.tree_map(jnp.asarray, jnodes.ma.MetricArrayState(*minute)),
        threads=jnp.asarray(threads), future_pass=jnp.asarray(fpass), future_ws=jnp.asarray(fws),
    )


@pytest.mark.parametrize("now", [5_250, 987_654, 2**31 - 1])
def test_materialize_matured_parity(now):
    rng = np.random.default_rng(now % 97)
    arrs = _random_stats(rng, 32, now)
    want = jnodes.materialize_matured(_jax_stats(arrs), jnp.int32(now))
    got = tnodes.materialize_matured(tnodes.stats_from_numpy(arrs, CPU), now)
    assert_same(jax.device_get(want), tnodes.stats_to_numpy(got), f"now={now}")


@pytest.mark.parametrize("now", [0, 5_250, 2**31 - 1])
def test_materialize_matured_empty_starts_parity(now):
    """Slab cells whose start is empty_ws but whose tokens are not 0 (what
    the rebase's clamp leaves), beside random cells, over an odd row count:
    JAX zeroes the tokens of every matured cell, and so must the port."""
    rng = np.random.default_rng(now % 89)
    arrs = _random_stats(rng, 33, now)
    second, minute, threads, fpass, fws = arrs
    empty = rng.random(fws.shape) < 0.5
    fws = np.where(empty, tnodes.SECOND_CFG.empty_ws, fws).astype(np.int32)
    fpass = np.where(empty, rng.integers(0, 7, fws.shape), fpass).astype(np.int32)
    arrs = (second, minute, threads, fpass, fws)
    want = jnodes.materialize_matured(_jax_stats(arrs), jnp.int32(now))
    got = tnodes.materialize_matured(tnodes.stats_from_numpy(arrs, CPU), now)
    assert_same(jax.device_get(want), tnodes.stats_to_numpy(got), f"now={now}")
    if now - tnodes.SECOND_CFG.empty_ws < 2**31:  # else the age wraps below 0: nothing matures
        assert not tnodes.stats_to_numpy(got).future_pass[empty].any()


def test_stats_numpy_roundtrip():
    rng = np.random.default_rng(3)
    arrs = _random_stats(rng, 8, 10_000)
    stats = tnodes.stats_from_numpy(arrs, CPU)
    assert_same(jax.device_get(_jax_stats(arrs)), tnodes.stats_to_numpy(stats))
    # The tensors are copies: in-place updates never reach the caller's
    # arrays (which JAX may share zero-copy).
    stats.second.counts.add_(1)
    stats.threads.add_(1)
    assert_same(jax.device_get(_jax_stats(arrs)).second.counts, stats.second.counts - 1)
    assert_same(arrs[2], stats.threads - 1)


_jax_apply_updates = jax.jit(jnodes.apply_updates)


@pytest.mark.parametrize("with_rt", [False, True])
def test_apply_updates_parity(with_rt):
    rng = np.random.default_rng(11 + with_rt)
    n_rows, now, m = 16, 400_000, 96
    arrs = _random_stats(rng, n_rows, now)
    js = _jax_stats(arrs)
    ts_ = tnodes.stats_from_numpy(arrs, CPU)
    for _ in range(2):
        rows = rng.integers(-1, n_rows, m).astype(np.int32)
        ts = (now + rng.integers(-1500, 1500, m)).astype(np.int32)
        deltas = rng.integers(0, 5, (m, NUM_EVENTS)).astype(np.int32)
        rt = rng.integers(0, 5000, m).astype(np.int32)
        thr = rng.integers(-1, 2, m).astype(np.int32)
        mask = (rows >= 0) & (rng.random(m) < 0.9)
        minute = rng.integers(0, 5, (m, NUM_EVENTS)).astype(np.int32)
        js = _jax_apply_updates(
            js, jnp.asarray(rows), jnp.asarray(ts), jnp.asarray(deltas),
            jnp.asarray(rt) if with_rt else None, jnp.asarray(thr), jnp.asarray(mask),
            minute_deltas=jnp.asarray(minute),
        )
        tnodes.apply_updates(
            ts_, torch.from_numpy(rows), torch.from_numpy(ts), torch.from_numpy(deltas),
            torch.from_numpy(rt) if with_rt else None, torch.from_numpy(thr),
            torch.from_numpy(mask), minute_deltas=torch.from_numpy(minute),
        )
        assert_same(jax.device_get(js), tnodes.stats_to_numpy(ts_))


def test_slab_fold_host_matches_jax_reads():
    """The stats read's slab folds (the occupied and waiting columns of
    ``rows_stats``, which replaced the per-row host fold) against the JAX
    reads, row by row."""
    rng = np.random.default_rng(21)
    now = 77_000
    arrs = _random_stats(rng, 12, now)
    js = _jax_stats(arrs)
    occ = np.asarray(jnodes.occupied_in_window(js, jnp.int32(now)))
    wait = np.asarray(jnodes.waiting_tokens(js, jnp.int32(now)))
    rec = tnodes.rows_stats(tnodes.stats_from_numpy(arrs, CPU), torch.arange(12, dtype=torch.int32), now)
    for r in range(12):
        assert (int(rec[r, tnodes.RS_OCCUPIED]), int(rec[r, tnodes.RS_WAITING])) == (occ[r], wait[r])


def test_registry_rows_match():
    from sentinel_tpu.metrics.nodes import NodeRegistry as JReg

    a, b = JReg(), tnodes.NodeRegistry()
    calls = [("cluster_row", ("r1",)), ("default_row", ("r1", "ctx")), ("origin_row", ("r1", "app")),
             ("entrance_row", ("ctx2",)), ("cluster_row", ("r2",)), ("default_row", ("r2", "ctx"))]
    for name, args in calls:
        assert getattr(a, name)(*args) == getattr(b, name)(*args)
    assert a.keys_snapshot() == b.keys_snapshot()
