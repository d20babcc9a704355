"""Parity of the port's window tensor (sentinel_tpu_torch/metrics/
metric_array.py, plain PyTorch versions on the CPU) with the JAX
package's, bit for bit: ``update`` with and without RT samples, masks,
duplicate keys and old/same/newer windows, and the windowed reads at the
bucket-age boundary, in both geometries. Also the cases of
tests/test_metric_array.py, run against the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.metrics import metric_array as jma
from sentinel_tpu.metrics import nodes as jnodes
from sentinel_tpu.testing.oracle import OracleLeapArray
from sentinel_tpu_torch.metrics import metric_array as ma
from sentinel_tpu_torch.metrics import nodes as tnodes
from sentinel_tpu_torch.metrics.events import NUM_EVENTS, MetricEvent

from torch_parity import assert_same, random_window_state

CPU = torch.device("cpu")
GEOMETRIES = {"second": (jnodes.SECOND_CFG, tnodes.SECOND_CFG), "minute": (jnodes.MINUTE_CFG, tnodes.MINUTE_CFG)}


_jax_update = jax.jit(jma.update, static_argnums=0)


def _both_states(arrs):
    jax_state = jma.MetricArrayState(*(jnp.asarray(a) for a in arrs))
    return jax_state, ma.state_from_numpy(arrs, CPU)


def _batch(rng, n, n_rows, cfg, now, near_max=False):
    wlen = cfg.window_len_ms
    rows = rng.integers(0, n_rows, n).astype(np.int32)
    rows[: n // 4] = rows[0]  # a hot row: duplicate (row, bucket) keys
    # Old, same and newer windows relative to the state made at `now`.
    ts = (now + rng.integers(-3 * cfg.interval_ms, 2 * cfg.interval_ms, n)).astype(np.int64)
    if near_max:
        ts = 2**31 - 1 - rng.integers(0, 3 * wlen, n)
    ts = np.maximum(ts, 0).astype(np.int32)
    deltas = rng.integers(-2, 9, (n, NUM_EVENTS)).astype(np.int32)
    rt = rng.integers(0, 6000, n).astype(np.int32)
    mask = rng.random(n) < 0.85
    return rows, ts, deltas, rt, mask


@pytest.mark.parametrize("geometry", ["second", "minute"])
@pytest.mark.parametrize("with_rt", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_update_parity(geometry, with_rt, seed):
    jcfg, tcfg = GEOMETRIES[geometry]
    rng = np.random.default_rng(seed)
    n_rows, now = 16, 123_456
    js, ts_ = _both_states(random_window_state(rng, n_rows, tcfg, now))
    for near_max in (False, True):
        rows, ts, deltas, rt, mask = _batch(rng, 64, n_rows, tcfg, now, near_max)
        js = _jax_update(
            jcfg, js, jnp.asarray(rows), jnp.asarray(ts), jnp.asarray(deltas),
            jnp.asarray(rt) if with_rt else None, jnp.asarray(mask),
        )
        ma.update(
            tcfg, ts_, torch.from_numpy(rows), torch.from_numpy(ts), torch.from_numpy(deltas),
            torch.from_numpy(rt) if with_rt else None, torch.from_numpy(mask),
        )
        assert_same(js, ts_, f"{geometry} near_max={near_max}")


def test_update_rejects_negative_ts():
    s = ma.make_state(2, tnodes.SECOND_CFG, CPU)
    with pytest.raises(ValueError):
        ma.update(
            tnodes.SECOND_CFG, s, torch.tensor([0], dtype=torch.int32),
            torch.tensor([-5], dtype=torch.int32), torch.ones((1, NUM_EVENTS), dtype=torch.int32),
        )


@pytest.mark.parametrize("geometry", ["second", "minute"])
def test_window_reads_parity(geometry):
    jcfg, tcfg = GEOMETRIES[geometry]
    rng = np.random.default_rng(5)
    n_rows = 24
    for now in (77_777, 2**31 - 1, 2**31 - 1 - tcfg.interval_ms):
        arrs = random_window_state(rng, n_rows, tcfg, now)
        # Bucket-age boundary: age == interval counts, interval + 1 does not.
        arrs[2][0, 0] = now - tcfg.interval_ms
        arrs[2][1, 0] = now - tcfg.interval_ms - 1
        js, tst = _both_states(arrs)
        jnow = jnp.int32(now)
        assert_same(jma.window_sums(jcfg, js, jnow), ma.window_sums(tcfg, tst, now), "sums")
        assert_same(jma.window_min_rt(jcfg, js, jnow), ma.window_min_rt(tcfg, tst, now), "min_rt")
        rows = rng.integers(-2, n_rows + 2, 40).astype(np.int32)  # clipped into range
        rc = np.clip(rows, 0, n_rows - 1)
        assert_same(
            np.asarray(jma.window_sums(jcfg, js, jnow))[rc],
            ma.window_sums(tcfg, tst, now, rows=torch.from_numpy(rows)),
            "gathered sums",
        )
        assert_same(
            np.asarray(jma.window_min_rt(jcfg, js, jnow))[rc],
            ma.window_min_rt(tcfg, tst, now, rows=torch.from_numpy(rows)),
            "gathered min_rt",
        )


# --- the cases of tests/test_metric_array.py, against the port ----------

CFG = ma.MetricArrayConfig(sample_count=2, interval_ms=1000)


def _upd(state, rows, ts, event, counts, rt=None):
    rows = torch.tensor(rows, dtype=torch.int32)
    n = rows.shape[0]
    deltas = torch.zeros((n, NUM_EVENTS), dtype=torch.int32)
    deltas[:, event] = torch.tensor(counts, dtype=torch.int32)
    rt_arr = None if rt is None else torch.tensor(rt, dtype=torch.int32)
    return ma.update(CFG, state, rows, torch.tensor(ts, dtype=torch.int32), deltas, rt_arr)


def _pass_sum(state, now, row=0):
    return int(ma.window_sums(CFG, state, now)[row, MetricEvent.PASS])


class TestWindowBasics:
    def test_single_window_accumulates(self):
        s = ma.make_state(4, CFG, CPU)
        s = _upd(s, [0, 0, 0], [0, 100, 499], MetricEvent.PASS, [1, 2, 3])
        assert _pass_sum(s, 499) == 6

    def test_two_buckets_within_interval(self):
        s = ma.make_state(4, CFG, CPU)
        s = _upd(s, [0, 0], [0, 600], MetricEvent.PASS, [1, 10])
        assert _pass_sum(s, 900) == 11

    def test_old_bucket_deprecated_on_read(self):
        s = ma.make_state(4, CFG, CPU)
        s = _upd(s, [0], [0], MetricEvent.PASS, [5])
        assert _pass_sum(s, 1400) == 0
        assert _pass_sum(s, 1000) == 5

    def test_rollover_resets_bucket(self):
        s = ma.make_state(4, CFG, CPU)
        s = _upd(s, [0], [0], MetricEvent.PASS, [5])
        s = _upd(s, [0], [1000], MetricEvent.PASS, [7])
        assert _pass_sum(s, 1000) == 7

    def test_stale_entry_in_same_batch_dropped(self):
        s = ma.make_state(4, CFG, CPU)
        s = _upd(s, [0, 0], [0, 1000], MetricEvent.PASS, [5, 7])
        assert _pass_sum(s, 1000) == 7

    def test_rows_independent(self):
        s = ma.make_state(4, CFG, CPU)
        s = _upd(s, [0, 1, 2], [0, 0, 0], MetricEvent.PASS, [1, 2, 3])
        sums = ma.window_sums(CFG, s, 0)
        assert [int(sums[r, MetricEvent.PASS]) for r in range(3)] == [1, 2, 3]

    def test_min_rt_tracking(self):
        s = ma.make_state(2, CFG, CPU)
        s = _upd(s, [0, 0], [0, 1], MetricEvent.RT, [30, 12], rt=[30, 12])
        assert int(ma.window_min_rt(CFG, s, 10)[0]) == 12
        assert int(ma.window_min_rt(CFG, s, 10)[1]) == CFG.max_rt
        assert int(ma.window_min_rt(CFG, s, 5000)[0]) == CFG.max_rt

    def test_mask_drops_entries(self):
        s = ma.make_state(2, CFG, CPU)
        deltas = torch.ones((2, NUM_EVENTS), dtype=torch.int32)
        s = ma.update(
            CFG, s, torch.tensor([0, 1], dtype=torch.int32), torch.tensor([0, 0], dtype=torch.int32),
            deltas, mask=torch.tensor([True, False]),
        )
        sums = ma.window_sums(CFG, s, 0)
        assert int(sums[0].sum()) == NUM_EVENTS
        assert int(sums[1].sum()) == 0


class TestOracleParity:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_randomized_batch_parity(self, seed):
        rng = np.random.default_rng(seed)
        n_rows, n_ops = 5, 400
        rows = rng.integers(0, n_rows, n_ops)
        ts = np.cumsum(rng.choice([0, 1, 3, 40, 700], n_ops, p=[0.3, 0.4, 0.2, 0.08, 0.02]))
        counts = rng.integers(1, 5, n_ops)
        oracles = [OracleLeapArray(2, 1000) for _ in range(n_rows)]
        for r, t, c in zip(rows, ts, counts):
            oracles[r].add(int(t), MetricEvent.PASS, int(c))
        s = ma.make_state(n_rows, CFG, CPU)
        for lo in range(0, n_ops, 64):
            hi = min(lo + 64, n_ops)
            s = _upd(s, rows[lo:hi], ts[lo:hi], MetricEvent.PASS, counts[lo:hi])
        now = int(ts[-1])
        got = ma.window_sums(CFG, s, now)
        for r in range(n_rows):
            assert int(got[r, MetricEvent.PASS]) == oracles[r].values(now)[MetricEvent.PASS], f"row {r}"
