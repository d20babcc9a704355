"""Shared helpers for the port's parity tests (tests/test_torch_*.py):
inputs made with numpy from a seed go through the JAX function and its
PyTorch counterpart, and every output must agree bit for bit."""

import numpy as np
import torch


def np_of(x):
    """numpy view of a JAX array, a torch tensor, or a (nested) tuple."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, tuple):
        return type(x)(*(np_of(v) for v in x)) if hasattr(x, "_fields") else tuple(np_of(v) for v in x)
    return np.asarray(x)


def assert_same(jax_val, torch_val, what=""):
    """Zero-tolerance equality of one array or of two matching tuples."""
    a, b = np_of(jax_val), np_of(torch_val)
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), what
        names = getattr(a, "_fields", range(len(a)))
        for name, x, y in zip(names, a, b):
            assert_same(x, y, f"{what}.{name}")
        return
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    assert a.dtype == b.dtype or (a.dtype.kind == b.dtype.kind == "b"), f"{what}: dtype {a.dtype} vs {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def random_window_state(rng, n_rows, cfg, now):
    """A window state with live, stale, empty and future buckets, as
    (counts, min_rt, window_start) numpy arrays."""
    b = cfg.sample_count
    wlen = cfg.window_len_ms
    counts = rng.integers(0, 50, (n_rows, b, 6)).astype(np.int32)
    min_rt = rng.integers(1, cfg.max_rt + 1, (n_rows, b)).astype(np.int32)
    base = now - now % wlen
    ages = rng.integers(-1, 2 * b + 2, (n_rows, b))
    ws = (base - ages * wlen).astype(np.int64)
    ws = np.where(ages < 0, cfg.empty_ws, ws)
    ws = np.where(ws < 0, cfg.empty_ws, ws).astype(np.int32)
    return counts, min_rt, ws


INF = float("inf")


def random_stats(rng, n_rows, now, second_cfg, minute_cfg):
    """Stats arrays laid out as StatsState, with slab cells that are
    future, matured and live, matured and expired, and empty."""
    cfg = second_cfg
    wlen = cfg.window_len_ms
    second = random_window_state(rng, n_rows, cfg, now)
    minute = random_window_state(rng, n_rows, minute_cfg, now)
    threads = rng.integers(0, 9, n_rows).astype(np.int32)
    base = now - now % wlen
    # Slab cells: future (ahead of now), matured and live, matured and
    # expired (older than the interval), and empty.
    kind = rng.integers(0, 4, (n_rows, cfg.sample_count))
    offs = np.choose(kind, [wlen * rng.integers(1, 3, kind.shape), 0 * kind,
                            -wlen * rng.integers(3, 6, kind.shape), 0 * kind])
    fws = (base + offs).astype(np.int64)
    fws = np.where(kind == 3, cfg.empty_ws, fws)
    # Matured-and-live cells land on the bucket's own window half the time.
    same = (kind == 1) & (rng.random(kind.shape) < 0.5)
    fws = np.where(same, second[2], fws).astype(np.int32)
    fpass = np.where(kind == 3, 0, rng.integers(1, 20, kind.shape)).astype(np.int32)
    return (second, minute, threads, fpass, fws)


def random_flow_table(rng, nr, thread_frac=0.3, lo=0, hi=8):
    grade = np.where(rng.random(nr) < thread_frac, 0, 1).astype(np.int32)
    count = rng.integers(lo, hi, nr).astype(np.float32)
    count[-2:] = INF  # padding rules pass
    z = np.zeros(nr, dtype=np.int32)
    table = (grade, count, z, z, z, z, z, np.zeros(nr, np.float32), z)
    dyn = (np.full(nr, -(10**9), np.int32), np.zeros(nr, np.float32), np.full(nr, -(10**9), np.int32))
    return table, dyn


def random_flush_batch(rng, n, k, n_rows, nr, now, n_valid, m=8, m_valid=0, near_max=False):
    e_valid = np.zeros(n, bool)
    e_valid[:n_valid] = True
    span = 40 if near_max else 900
    e_ts = (now - rng.integers(0, span, n)).astype(np.int32)
    e_ts[: n // 4] = e_ts[0]  # equal ts on the hot row
    e_acq = rng.integers(1, 3, n).astype(np.int32)
    res = rng.integers(1, n_rows // 2, n)
    res[: n // 4] = res[0]
    e_rows = np.stack(
        [res + n_rows // 2 - 1, res, np.where(rng.random(n) < 0.3, res % 3 + n_rows - 4, -1),
         np.where(rng.random(n) < 0.5, 0, -1)], axis=1,
    ).astype(np.int32)
    gid = np.full((n, k), -1, np.int32)
    crow = np.full((n, k), -1, np.int32)
    gid[:, 0] = res % (nr - 2)
    crow[:, 0] = res
    if k > 1:
        # Second slot: a RELATE-style check on another resource's row (not
        # accounted by this entry), or a CHAIN-style check on its default row.
        other = rng.random(n) < 0.5
        gid[:, 1] = np.where(rng.random(n) < 0.8, (res + 1) % (nr - 2), -1)
        crow[:, 1] = np.where(other, (res + 3) % (n_rows // 2) + 1, e_rows[:, 0])
    e_auth = rng.random(n) < 0.95
    e_cluster = rng.random(n) < 0.97
    x_valid = np.zeros(m, bool)
    x_valid[:m_valid] = True
    xres = rng.integers(1, n_rows // 2, m)
    x_rows = np.stack([xres + n_rows // 2 - 1, xres, np.full(m, -1), np.zeros(m)], axis=1).astype(np.int32)
    x_ts = (now - rng.integers(0, span, m)).astype(np.int32)
    x_count = rng.integers(0, 3, m).astype(np.int32)
    x_rt = rng.integers(0, 300, m).astype(np.int32)
    x_err = rng.integers(0, 2, m).astype(np.int32)
    x_thr = np.where(rng.random(m) < 0.8, -1, 0).astype(np.int32)
    return (
        np.int32(now), e_valid, e_ts, e_acq, e_rows, gid, crow, np.zeros(n, bool), e_auth,
        e_cluster, np.full((n, 1), -1, np.int32),
        x_valid, x_ts, x_count, x_rows, x_rt, x_err, x_thr, np.full((m, 1), -1, np.int32),
    )
