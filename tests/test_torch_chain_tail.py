"""The slot chain's verdict tail and the borrow commit (K5) of the port
(sentinel_tpu_torch/runtime/flush.py: ``slot_chain_verdict`` and
``commit_borrow_slab``, plain PyTorch versions on the CPU) against the JAX
package, bit for bit, on the same numpy inputs.

The tail has no function of its own in the JAX package: it is the end of
``flush_entries`` (:790-845 and the top-K :879-897). So the tail's cases
run both ``flush_entries`` with the stages on and off in every
combination of the tail's absent inputs: no system stage, no param stage
(``param_pre``), no shaping (``shaping_pre``), no occupy, and no breakers
or breakers without probe transitions (``commit=False``, the mesh's demand
pass). The JAX side runs without jit (``jax.disable_jit``): 48 shapes of
static flags would each compile. Then ties in the blocked top-K: touched
rows of equal weight, and a touched row whose wrapping sum is 0 beside
untouched rows of weight 0. K5's cases: one cell hit by borrows of three
windows (only the newest counts; an older one writes nothing to a newer
slab cell), acquires whose sum wraps past 2**31, slab cells empty, older,
equal and newer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.rules import degrade_table as jdt
from sentinel_tpu.rules import param_table as jpt
from sentinel_tpu.runtime import flush as jflush
from sentinel_tpu_torch.metrics import nodes as tnodes
from sentinel_tpu_torch.rules import degrade_table as tdt
from sentinel_tpu_torch.rules import param_table as tpt
from sentinel_tpu_torch.rules.flow_table import flow_table_from_numpy
from sentinel_tpu_torch.runtime import flush as tflush

from test_torch_flush import RESULT_FIELDS, _jax_batch, _jax_tables
from test_torch_nodes import _jax_stats, _random_stats
from torch_parity import (
    BORROW_SLAB_CASES,
    TAIL_NULLS,
    TIE_PATTERNS,
    assert_same,
    borrowable_stats,
    random_borrow_case,
    random_chain_batch,
    random_degrade,
    random_flow_table,
    random_param_state,
    system_thresholds,
)

CPU = torch.device("cpu")
_j_commit = jax.jit(jflush.commit_borrow_slab)


@pytest.mark.parametrize("case", BORROW_SLAB_CASES)
def test_commit_borrow_slab_cases_match_jax(case):
    rng = np.random.default_rng(BORROW_SLAB_CASES.index(case) + 90)
    n_rows, n, k, now = 16, 64, 2, 700_137
    arrs = list(_random_stats(rng, n_rows, now))
    arrs[3], arrs[4] = random_borrow_case(rng, n, k, n_rows, now, case)[0]
    borrows = random_borrow_case(np.random.default_rng(7), n, k, n_rows, now, case)[1]
    want = jax.device_get(_j_commit(_jax_stats(tuple(arrs)), *map(jnp.asarray, borrows)))
    got = tflush.commit_borrow_slab(tnodes.stats_from_numpy(tuple(arrs), CPU), *map(torch.from_numpy, borrows))
    assert_same(want.future_pass, got.future_pass, "future_pass")
    assert_same(want.future_ws, got.future_ws, "future_ws")
    occ, tgt, acq, crow = borrows
    if case == "three_windows_one_cell":
        cell_tgts = set(tgt[occ & (crow == 3)].tolist())
        assert len({t for t in cell_tgts if (t // 500) % 2 == 1}) == 3, cell_tgts
    if case == "wrap_past_2_31":
        sums = np.zeros((n_rows, 2), np.int64)
        np.add.at(sums, (np.clip(crow, 0, n_rows - 1)[occ], (tgt[occ] // 500) % 2), acq[np.nonzero(occ)[0]])
        assert sums.max() >= 2**31


def _flush_both(seed, nulls, b=None, k=2, blk_topk=8):
    """flush_entries of the JAX package and of the port on one batch with
    the tail's inputs as ``nulls`` says; returns the two results and the
    two breaker states."""
    sys_, param, shape, occupy, breakers = nulls
    rng = np.random.default_rng(seed)
    n_rows, nr, nd, n, kd, m = 32, 16, 16, 64, 2, 8
    now = 3_456_000 + int(rng.integers(0, 500))
    arrs = borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    table, _ = random_flow_table(rng, nr, thread_frac=0.2, lo=2, hi=10)
    dyn = (np.full(nr, -(10**9), np.int32), np.zeros(nr, np.float32), np.full(nr, -(10**9), np.int32))
    dtable, ddyn = random_degrade(rng, nd, now)
    pdyn = random_param_state(rng, 8, now)
    if b is None:
        b = random_chain_batch(rng, n, k, kd, n_rows, nr, nd, now, m)
    n = b[1].shape[0]
    kw_j, kw_t = {}, {}
    if param:
        pre = (rng.random(n) < 0.8, rng.integers(0, 300, n).astype(np.int32))
        kw_j["param_pre"], kw_t["param_pre"] = tuple(map(jnp.asarray, pre)), tuple(map(torch.from_numpy, pre))
    if shape:
        s = 24
        pre = (rng.random(s) < 0.8, rng.integers(0, n * k, s).astype(np.int32), rng.integers(0, n, s).astype(np.int32),
               rng.random(s) < 0.6, rng.integers(0, 500, s).astype(np.int32))
        kw_j["shaping_pre"], kw_t["shaping_pre"] = tuple(map(jnp.asarray, pre)), tuple(map(torch.from_numpy, pre))
    sys_vals = system_thresholds("all")
    commit = breakers != "no_ddyn"
    flags = dict(with_occupy=occupy, with_system=sys_, with_degrade=breakers != "off")
    with jax.disable_jit():
        jout = jflush.flush_entries(
            _jax_stats(arrs), *_jax_tables(table, dyn), jdt.DegradeTableDevice(*map(jnp.asarray, dtable)),
            jdt.DegradeDynState(*map(jnp.asarray, ddyn)), jpt.ParamDynState(*map(jnp.asarray, pdyn)),
            jflush.SystemDevice(*(jnp.float32(v) for v in sys_vals)), _jax_batch(b), commit=commit,
            occupy_timeout_ms=1000, blk_topk=blk_topk, **flags, **kw_j)
    tt, td = flow_table_from_numpy(table, dyn, CPU)
    tddyn = tdt.degrade_state_from_numpy(ddyn, CPU)
    _, tres = tflush.flush_entries(
        tnodes.stats_from_numpy(arrs, CPU), tt, tflush.batch_from_numpy(b, CPU), blk_topk,
        tdt.degrade_table_from_numpy(dtable, CPU), tddyn, tflush.SystemDevice(*sys_vals), 1000, flow_dyn=td,
        pdyn=tpt.param_state_from_numpy(pdyn, CPU), commit=commit, **flags, **kw_t)
    return jout[4], tres, jax.device_get(jout[2]), tdt.degrade_state_to_numpy(tddyn)


@pytest.mark.parametrize("nulls", TAIL_NULLS, ids=lambda v: "-".join(str(x) for x in v))
def test_chain_tail_null_inputs_match_jax(nulls):
    jres, tres, jdd, tdd = _flush_both(TAIL_NULLS.index(nulls) + 30, nulls)
    for name in RESULT_FIELDS:
        assert_same(getattr(jres, name), getattr(tres, name), f"{nulls} {name}")
    assert_same(jdd, tdd, f"{nulls} breakers")
    assert np.asarray(jres.blk_weight)[0] > 0


TIE_CASES = list(TIE_PATTERNS)


@pytest.mark.parametrize("case", TIE_CASES)
def test_chain_tail_topk_ties_match_jax(case):
    """Blocked top-K ties as ``lax.top_k`` breaks them (weight descending,
    row ascending): "touched_rows_tie", rows 9, 5 and 12 blocked the same
    total (5 first, then 9, then 12) below row 20's; "wrapped_zero_beside_untouched",
    row 3's blocked acquires sum to 2**32 (0 after wrapping) beside the
    untouched rows 0-2, 4... of weight 0, and row 7's to 2**31 + 4
    (negative after wrapping), which ranks last. Every entry is blocked
    by authority, so the other stages decide nothing of the weights."""
    rng = np.random.default_rng(TIE_CASES.index(case) + 50)
    b = random_chain_batch(rng, 12, 1, 2, 32, 16, 16, 3_456_000, 8)
    b[1] = np.ones(12, bool)
    b[8] = np.zeros(12, bool)  # e_auth_ok: every entry blocked
    rows, acq = TIE_PATTERNS[case]
    b[4] = b[4].copy()
    b[4][:, 1] = rows
    b[3] = np.asarray(acq, np.int32)
    for nulls in ((True, True, True, True, "ddyn"), (False, False, False, False, "off")):
        jres, tres, _, _ = _flush_both(60, nulls, b=b, k=1)
        assert_same(jres.blk_rows, tres.blk_rows, f"{case} {nulls} rows")
        assert_same(jres.blk_weight, tres.blk_weight, f"{case} {nulls} weights")
        rows_got, w_got = np.asarray(jres.blk_rows), np.asarray(jres.blk_weight)
        if case == "touched_rows_tie":
            assert rows_got[:4].tolist() == [20, 5, 9, 12] and len(set(w_got[1:4].tolist())) == 1
        else:
            assert rows_got.tolist() == [0, 1, 2, 3, 4, 5, 6, 8] and not w_got.any()
