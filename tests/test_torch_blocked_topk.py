"""The blocked top-K above 8 on the port against the JAX package: the plain
version at k = 16 and 64 against ``lax.top_k`` of the dense weights (ties
by row, fewer blocked rows than k filled by the lowest zero-weight rows,
wrapping row sums, k above R), the engine's fold at k = 16 and 64 (DEFAULT
path and slot chain), and the mesh's host recount of the blocked weight,
in lockstep with the JAX engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu_torch.runtime import flush as tflush

from torch_lockstep import run_lockstep
from torch_parity import random_flush_batch


def _jax_topk(valid, admitted, acquire, crow_col, r_rows, k):
    """flush_entries :879-897 of the JAX module."""
    blocked_w = jnp.where(jnp.asarray(valid) & ~jnp.asarray(admitted), jnp.asarray(acquire), 0).astype(jnp.int32)
    crow = jnp.clip(jnp.asarray(crow_col), 0, r_rows - 1)
    scat = jnp.where(blocked_w > 0, crow, jnp.int32(r_rows))
    dense = jnp.zeros((r_rows + 1,), dtype=jnp.int32).at[scat].add(blocked_w)
    w, r = jax.lax.top_k(dense[:r_rows], min(k, r_rows))
    return np.asarray(r, np.int32), np.asarray(w, np.int32)


CASES = ["uniform", "few_blocked", "ties", "wrap", "k_above_rows", "none_blocked"]


@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("case", CASES)
def test_blocked_topk_plain_matches_lax_top_k(case, k):
    rng = np.random.default_rng(k + CASES.index(case))
    n, n_rows = 4096, 1024
    if case == "k_above_rows":
        n_rows = 40
    b = list(random_flush_batch(rng, n, 1, n_rows, 8, 5000, n - 64))
    valid, acquire, rows = b[1], b[3].copy(), b[4].copy()
    admitted = rng.random(n) < 0.7
    if case == "few_blocked":
        rows[:, 1] = rng.integers(0, 5, n)  # fewer rows carry weight than k
    elif case == "ties":
        rows[:, 1] = rng.integers(0, 64, n)
        acquire[:] = 1
        admitted[:] = False
        valid[:] = True
        rows[:64, 1] = np.arange(64)
        rows[64:, 1] = np.repeat(np.arange(0, 64, 2), (n - 64) // 32 + 1)[: n - 64]
    elif case == "wrap":
        acquire[:] = rng.integers(2**29, 2**30, n)
        rows[:, 1] = rng.integers(0, 30, n)
    elif case == "none_blocked":
        admitted[:] = True
    b[1], b[3], b[4] = valid, acquire, rows
    batch = tflush.FlushBatch(*[torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a for a in b])
    got_r, got_w = tflush.blocked_topk_wide(batch, torch.from_numpy(admitted), n_rows, k)
    want_r, want_w = _jax_topk(valid, admitted, acquire, rows[:, 1], n_rows, k)
    assert got_r.tolist() == want_r.tolist() and got_w.tolist() == want_w.tolist()
    if case == "few_blocked":
        assert int((want_w > 0).sum()) <= 5 < k


def _topk_stream(lib, k, chain, mesh, depth=0, seed=21):
    """Zipf traffic over 40 resources with a blocked top-K of ``k`` in the
    flight recorder, on the DEFAULT path or the slot chain (breakers and
    prioritized entries), on one device or on the mesh of 8 shards (the
    host recount): the engine's last device top-K and the recorder's
    summary after every flush (the port's device top-K is checked
    beside them)."""
    st, C = lib.st, lib.C
    rng = np.random.default_rng(seed)
    lib.clock.set_ms(1000)
    eng = lib.mk(depth, TELEMETRY_BLOCKED_TOPK_K=str(k))
    if mesh:
        eng.enable_mesh(8)
    res = [f"r{i}" for i in range(40)]
    eng.set_flow_rules([st.FlowRule(r, count=int(rng.integers(1, 6))) for r in res])
    if chain:
        eng.set_degrade_rules([st.DegradeRule("r1", grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, count=1, time_window=1,
                                              min_request_amount=1)])
    obs = []
    for step in range(5):
        t = 1000 + 350 * step
        lib.clock.set_ms(t)
        for _ in range(100):
            r = res[min(int(rng.zipf(1.3)), 40) - 1]
            eng.submit_entry(r, prio=chain and bool(rng.random() < 0.2))
        eng.submit_bulk("r3", 25)
        eng.flush()
        eng.drain()
        snap = eng.telemetry.snapshot()
        obs.append([snap["blocked_topk"], snap["last_flush_blocked_topk"]])
    if lib.name == "port" and not mesh:
        # The device top-K itself: k rows, ranked as lax.top_k ranks them.
        rows, weights = eng.last_blocked_topk
        assert len(rows) == k and list(weights) == sorted(weights, reverse=True)
    return obs


@pytest.mark.parametrize("k,chain", [(16, False), (64, False), (16, True), (64, True)])
def test_engine_blocked_topk_above_8_matches_jax(k, chain):
    """The device top-K at k = 16 and 64 (the wide route on the card) and
    the recorder's blocked-resource summary equal the JAX engine's."""
    obs = run_lockstep(_topk_stream, k, chain, False)
    assert max(len(o[1]) for o in obs) > 8  # more rows carry weight than the fused route keeps


@pytest.mark.parametrize("k", [8, 16])
def test_mesh_blocked_recount_matches_jax(k):
    """The sharded step has no device top-K: the engine recounts each
    chunk's blocked weight per resource on the host and folds it into the
    recorder; the summary equals the JAX mesh engine's."""
    obs = run_lockstep(_topk_stream, k, False, True)
    assert obs[-1][0] and obs[-1][1]
