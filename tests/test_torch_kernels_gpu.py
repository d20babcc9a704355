"""The port's hand-written kernels against their plain PyTorch versions,
on the card. Every test needs CUDA, nvcc and triton; without a card each
one skips. This file imports neither JAX nor the JAX package, so it runs
where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

(``--noconftest``: the repository's conftest.py sets JAX up.)
Tolerance is zero: the kernels compute in int32 and float32 exactly as
the plain versions do."""

import numpy as np
import pytest
import torch

from sentinel_tpu_torch.metrics import metric_array as ma
from sentinel_tpu_torch.metrics import nodes as tnodes
from sentinel_tpu_torch.metrics.events import NUM_EVENTS
from sentinel_tpu_torch.rules.flow_table import flow_table_from_numpy
from sentinel_tpu_torch.runtime import flush as tflush

from torch_parity import random_flow_table, random_flush_batch, random_stats, random_window_state

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA, nvcc, triton)")
    return torch.device("cuda", 0)


def _eq(a, b, what):
    assert torch.equal(a.cpu(), b.cpu()), what


def _states_eq(a, b, what):
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, tuple):
            _states_eq(x, y, f"{what}.{name}")
        else:
            _eq(x, y, f"{what}.{name}")


def _clone(state):
    return type(state)(*(_clone(t) if isinstance(t, tuple) else t.clone() for t in state))


@pytest.mark.parametrize("geometry", ["second", "minute"])
@pytest.mark.parametrize("with_rt", [False, True])
@pytest.mark.parametrize("hot", [False, True])
def test_update_kernel(cuda, geometry, with_rt, hot):
    cfg = tnodes.SECOND_CFG if geometry == "second" else tnodes.MINUTE_CFG
    rng = np.random.default_rng(7)
    n_rows, n, now = 64, 5000, 2**31 - 1 - 3 * cfg.interval_ms
    state = ma.state_from_numpy(random_window_state(rng, n_rows, cfg, now), cuda)
    rows = rng.integers(0, n_rows, n).astype(np.int32)
    if hot:
        rows[:] = 5
    ts = (now + rng.integers(-3 * cfg.interval_ms, 3 * cfg.interval_ms, n)).astype(np.int32)
    if hot:
        ts[:] = now + 1
    t = lambda a: torch.from_numpy(a).to(cuda)
    deltas = t(rng.integers(-3, 9, (n, NUM_EVENTS)).astype(np.int32))
    rt = t(rng.integers(0, 6000, n).astype(np.int32)) if with_rt else None
    mask = t(rng.random(n) < 0.9)
    want = ma.update_plain(cfg, _clone(state), t(rows), t(ts), deltas, rt, mask)
    before = ma.update.launches
    got = ma.update(cfg, state, t(rows), t(ts), deltas, rt, mask)
    assert ma.update.launches == before + 1
    _states_eq(want, got, "update")


@pytest.mark.parametrize("geometry", ["second", "minute"])
def test_window_reduce_kernel(cuda, geometry):
    cfg = tnodes.SECOND_CFG if geometry == "second" else tnodes.MINUTE_CFG
    rng = np.random.default_rng(3)
    for now in (123_456, 2**31 - 1):
        state = ma.state_from_numpy(random_window_state(rng, 100, cfg, now), cuda)
        rows = torch.from_numpy(rng.integers(-3, 104, 777).astype(np.int32)).to(cuda)
        for r in (None, rows):
            ws, wm = ma.window_reduce_plain(cfg, state, now, r, with_min=True)
            gs, gm = ma.window_reduce(cfg, state, now, r, with_min=True)
            _eq(ws, gs, "sums")
            _eq(wm, gm, "min_rt")


def test_materialize_kernel(cuda):
    rng = np.random.default_rng(4)
    now = 9_876_543
    arrs = random_stats(rng, 257, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    want = tnodes.materialize_matured_plain(tnodes.stats_from_numpy(arrs, cuda), now)
    got = tnodes.materialize_matured(tnodes.stats_from_numpy(arrs, cuda), now)
    _states_eq(want, got, "materialize")


def test_thread_gauge_kernel(cuda):
    rng = np.random.default_rng(5)
    n = 10_000
    rows = torch.from_numpy(rng.integers(-1, 40, n).astype(np.int32)).to(cuda)
    rows[:3000] = 7
    thr = torch.from_numpy(rng.integers(-1, 2, n).astype(np.int32)).to(cuda)
    mask = rows >= 0
    base = torch.from_numpy(rng.integers(0, 50, 32).astype(np.int32)).to(cuda)
    want = tnodes.thread_gauge_add_plain(base.clone(), rows, thr, mask)
    got = tnodes.thread_gauge_add(base.clone(), rows, thr, mask)
    _eq(want, got, "threads")


CASES = [
    # n, k, n_valid, m_valid, near_max, (lo, hi), n_rows
    (64, 2, 60, 0, False, (0, 8), 32),
    (4096, 2, 4000, 512, False, (0, 40), 64),
    (2048, 1, 2048, 64, True, (0, 8), 16),
    (256, 1, 100, 4, False, (60, 90), 32),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_flush_step_kernels(cuda, case):
    """The kernels' step on the card against the plain versions' step on
    the CPU, on the same inputs, over two flushes."""
    n, k, n_valid, m_valid, near_max, (lo, hi), n_rows = CASES[case]
    rng = np.random.default_rng(case)
    nr = 16
    cpu = torch.device("cpu")
    now = 2**31 - 1 - 700 if near_max else 1_234_567
    arrs = random_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    table, dyn = random_flow_table(rng, nr, lo=lo, hi=hi)
    t_cpu, _ = flow_table_from_numpy(table, dyn, cpu)
    t_gpu, _ = flow_table_from_numpy(table, dyn, cuda)
    plain = tnodes.stats_from_numpy(arrs, cpu)
    kern = tnodes.stats_from_numpy(arrs, cuda)
    for step in range(2):
        b_np = random_flush_batch(
            rng, n, k, n_rows, nr, now + 600 * step, n_valid, m=max(8, m_valid),
            m_valid=m_valid, near_max=near_max,
        )
        b_cpu, b_gpu = tflush.batch_from_numpy(b_np, cpu), tflush.batch_from_numpy(b_np, cuda)
        adm = tflush.flow_admission(plain, t_cpu, b_cpu, 8)
        got = tflush.flow_admission(kern, t_gpu, b_gpu, 8)
        for name, x, y in zip(adm._fields, adm, got):
            _eq(x, y, f"admission {name}")
        _, want = tflush.flush_step(plain, t_cpu, b_cpu, with_exits=m_valid > 0, blk_topk=8)
        _, res = tflush.flush_step(kern, t_gpu, b_gpu, with_exits=m_valid > 0, blk_topk=8)
        for name, x, y in zip(want._fields, want, res):
            _eq(x, y, f"result {name}")
        _states_eq(plain, kern, f"stats step {step}")
