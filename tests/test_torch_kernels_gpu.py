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

from sentinel_tpu_torch.cluster import token_service as tts
from sentinel_tpu_torch.metrics import metric_array as ma
from sentinel_tpu_torch.metrics import nodes as tnodes
from sentinel_tpu_torch.metrics.events import NUM_EVENTS
from sentinel_tpu_torch.parallel import ici as tici
from sentinel_tpu_torch.parallel import make_mesh, make_sharded_flush
from sentinel_tpu_torch.rules import degrade_table as tdt
from sentinel_tpu_torch.rules import param_table as tpt
from sentinel_tpu_torch.rules import shaping as tsh
from sentinel_tpu_torch.rules.flow_table import flow_table_from_numpy
from sentinel_tpu_torch.runtime import flush as tflush
from sentinel_tpu_torch.runtime import sketch as tsk

from torch_parity import (
    BORROW_SLAB_CASES,
    BREAKER_EXIT_CASES,
    SKETCH_EDGE_CASES,
    TAIL_NULLS,
    breaker_exit_case,
    sketch_edge_case,
    BREAKER_CASES,
    BUDGET_WRAP_CASES,
    budget_wrap_case,
    SYSTEM_EDGE_CASES,
    many_candidates,
    system_edge_case,
    system_edge_thresholds,
    breaker_merge_table,
    random_shard_stats,
    shard_breaker_case,
    borrowable_stats,
    fma_warning_case,
    out_of_range_rule_ids,
    random_param_batch_for,
    random_param_case,
    random_param_state,
    random_shaped_flow_table,
    random_shaping_case,
    shaping_batch_for,
    random_borrow_case,
    random_chain_batch,
    random_degrade,
    random_exits,
    random_flow_table,
    random_flush_batch,
    random_stats,
    random_tail_case,
    random_window_state,
    system_thresholds,
    TIE_PATTERNS,
    tie_rows,
    SHAPING_CHARGE_CASES,
    shaping_charge_case,
    STATS_READ_CASES,
    STATS_READ_ROWS,
    stats_read_case,
    stats_read_rows,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA, nvcc, triton)")
    return torch.device("cuda", 0)


def _eq(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert torch.equal(a.cpu(), b.cpu()), what


def _states_eq(a, b, what):
    for name, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
        if isinstance(x, tuple):
            _states_eq(x, y, f"{what}.{name}")
        else:
            _eq(x, y, f"{what}.{name}")


def _clone(state):
    return type(state)(*(_clone(t) if isinstance(t, tuple) else t.clone() for t in state))


GEOMETRY = {"second": tnodes.SECOND_CFG, "minute": tnodes.MINUTE_CFG, "cluster": tts.CLUSTER_CFG}


@pytest.mark.parametrize("geometry", ["second", "minute", "cluster"])
@pytest.mark.parametrize("with_rt", [False, True])
@pytest.mark.parametrize("hot", [False, True, "zipf"])
def test_update_kernel(cuda, geometry, with_rt, hot):
    """5,000 updates over 64 rows (old, same and newer windows), all of them
    on one cell (hot), or 524,288 Zipf(1.1) updates over 65,536 rows (the
    main path's width); each call is one launch of the wrapper."""
    cfg = GEOMETRY[geometry]
    rng = np.random.default_rng(7)
    n_rows, n, now = 64, 5000, 2**31 - 1 - 3 * cfg.interval_ms
    if hot == "zipf":
        n_rows, n = 1 << 16, 1 << 19
    state = ma.state_from_numpy(random_window_state(rng, n_rows, cfg, now), cuda)
    rows = rng.integers(0, n_rows, n).astype(np.int32)
    if hot is True:
        rows[:] = 5
    elif hot == "zipf":
        rows = (np.minimum(rng.zipf(1.1, n), n_rows) - 1).astype(np.int32)
    ts = (now + rng.integers(-3 * cfg.interval_ms, 3 * cfg.interval_ms, n)).astype(np.int32)
    if hot is True:
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


@pytest.mark.parametrize("geometry", ["second", "minute", "cluster"])
def test_window_reduce_kernel(cuda, geometry):
    """K3 (csrc/window_reduce.cu) on every geometry, over all rows and a
    clipped gather, with and without the min RT; also every bucket counting
    with sums past 2^31 and min RTs above max_rt (stats_read_case "wrap")."""
    cfg = GEOMETRY[geometry]
    rng = np.random.default_rng(3)
    wrap, now_w = stats_read_case("wrap", cfg, cfg, 100)
    states = [(ma.state_from_numpy(random_window_state(rng, 100, cfg, now), cuda), now) for now in (123_456, 2**31 - 1)]
    for state, now in states + [(ma.state_from_numpy(wrap[1], cuda), now_w)]:
        rows = torch.from_numpy(rng.integers(-3, 104, 777).astype(np.int32)).to(cuda)
        for r in (None, rows):
            for with_min in (False, True):
                ws, wm = ma.window_reduce_plain(cfg, state, now, r, with_min=with_min)
                before = ma.window_reduce.launches
                gs, gm = ma.window_reduce(cfg, state, now, r, with_min=with_min)
                assert ma.window_reduce.launches == before + 1
                _eq(ws, gs, "sums")
                _eq(wm, gm, "min_rt")


@pytest.mark.parametrize("rows_kind", ["three"] + STATS_READ_ROWS)
@pytest.mark.parametrize("case", STATS_READ_CASES)
def test_rows_stats_kernel(cuda, case, rows_kind):
    """row_stats against rows_stats_plain on each stats-read case (now
    2^31 - 1, ages at the interval's edge, empty starts with tokens, sums
    past 2^31) for 3 rows, every row, rows unsorted with duplicates, none;
    one launch a call."""
    arrs, now = stats_read_case(case, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    stats = tnodes.stats_from_numpy(arrs, cuda)
    rows = np.array([5, 63, 0], np.int32) if rows_kind == "three" else stats_read_rows(rows_kind, 64)
    idx = torch.from_numpy(rows).to(cuda)
    before = tnodes.rows_stats.launches
    got = tnodes.rows_stats(stats, idx, now)
    assert tnodes.rows_stats.launches == before + (len(rows) > 0)
    _eq(tnodes.rows_stats_plain(stats, idx, now), got, f"{case} {rows_kind}")


def test_rows_stats_gathered_kernel(cuda):
    """row_stats at the main path's width: 131,072 gathered rows (Zipf,
    unsorted, with duplicates, and 16 outside [0, R) to clip) of 65,536."""
    rng = np.random.default_rng(13)
    n_rows, now = 1 << 16, 5_000_000
    stats = tnodes.stats_from_numpy(random_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG), cuda)
    rows = (np.minimum(rng.zipf(1.1, 1 << 17), n_rows) - 1).astype(np.int32)
    rows[:16] = [-1, n_rows, -(2**31), 2**31 - 1] * 4
    idx = torch.from_numpy(rows).to(cuda)
    _eq(tnodes.rows_stats_plain(stats, idx, now), tnodes.rows_stats(stats, idx, now), "records")


def _per_call(fn, calls=5, tries=3):
    """(kernels, device-to-host copies) of one call of ``fn``, from
    torch.profiler over ``calls`` calls (each count rounded up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name.lower() for e in prof.events() if e.device_type == DeviceType.CUDA]
        kernels = sum(not n.startswith(("memcpy", "memset")) for n in names)
        dtoh = sum(n.startswith("memcpy dtoh") for n in names)
        if kernels:
            return -(-kernels // calls), -(-dtoh // calls)
    raise AssertionError("torch.profiler recorded no device kernel")


@pytest.mark.parametrize("n_rows_asked", [1, 50, 1000])
def test_engine_rows_stats_one_launch_one_copy(cuda, n_rows_asked):
    """Engine.rows_stats on the card: one row_stats launch and one copy back
    a call, whatever the number of rows; its dicts equal the plain read's."""
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.utils.clock import ManualClock

    arrs, now = stats_read_case("random", tnodes.SECOND_CFG, tnodes.MINUTE_CFG, n_rows=1024)
    eng = Engine(clock=ManualClock(now), device=cuda)
    eng.stats = tnodes.stats_from_numpy(arrs, cuda)
    rows = [int(r) for r in np.random.default_rng(1).integers(0, 1024, n_rows_asked)]
    before = (tnodes.rows_stats.launches, ma.window_reduce.launches)
    got = eng.rows_stats(rows)
    assert (tnodes.rows_stats.launches, ma.window_reduce.launches) == (before[0] + 1, before[1])
    assert _per_call(lambda: eng.rows_stats(rows)) == (1, 1)
    cpu = Engine(clock=ManualClock(now), device="cpu")
    cpu.stats = tnodes.stats_from_numpy(arrs, torch.device("cpu"))
    assert got == cpu.rows_stats(rows)


def _slab_stats(rng, n_rows, now, kind, device):
    """Stats for K1 over ``n_rows`` rows: the second window of
    random_window_state, the slab by ``kind``: "random" (future, matured
    live, matured expired and empty cells, random_stats), "empty" (every
    cell (empty_ws, 0): the swept slab) or "empty_pass" (empty_ws starts,
    half of them with tokens, which the sweep zeroes). The minute window
    stands in as the second one: K1 does not read it."""
    cfg = tnodes.SECOND_CFG
    second = random_window_state(rng, n_rows, cfg, now)
    shape = (n_rows, cfg.sample_count)
    fws = np.full(shape, cfg.empty_ws, np.int32)
    fpass = np.zeros(shape, np.int32)
    if kind == "random":
        base = now - now % cfg.window_len_ms
        off = rng.integers(-6, 3, shape) * cfg.window_len_ms
        fws = np.where(rng.random(shape) < 0.7, np.clip(base + off, -(2**31), 2**31 - 1), fws).astype(np.int32)
        same = rng.random(shape) < 0.2
        fws = np.where(same, second[2], fws).astype(np.int32)
        fpass = np.where(fws != cfg.empty_ws, rng.integers(0, 20, shape), 0).astype(np.int32)
    elif kind == "empty_pass":
        fpass = np.where(rng.random(shape) < 0.5, rng.integers(1, 20, shape), 0).astype(np.int32)
    threads = np.zeros(n_rows, np.int32)
    return tnodes.stats_from_numpy((second, second, threads, fpass, fws), device)


@pytest.mark.parametrize("n_rows", [1, 257, 1 << 20])
@pytest.mark.parametrize("kind", ["random", "empty", "empty_pass"])
@pytest.mark.parametrize("now", [0, 9_876_543, 2**31 - 1])
def test_materialize_kernel(cuda, n_rows, kind, now):
    """K1 against its plain version: one row (2 cells: the scalar tail),
    257 (an odd cell count over 4), the main path's 1,048,576; a random
    slab, the swept slab, empty starts with tokens; now at 0 and 2^31 - 1.
    One launch a call."""
    rng = np.random.default_rng(n_rows + now % 7)
    want = tnodes.materialize_matured_plain(_slab_stats(rng, n_rows, now, kind, cuda), now)
    rng = np.random.default_rng(n_rows + now % 7)
    before = tnodes.materialize_matured.launches
    got = tnodes.materialize_matured(_slab_stats(rng, n_rows, now, kind, cuda), now)
    assert tnodes.materialize_matured.launches == before + 1
    _states_eq(want, got, "materialize")


@pytest.mark.parametrize("offset", [1, 3])
def test_materialize_kernel_row_view(cuda, offset):
    """A view of the stats from an odd row on: its slab pointers are 8 bytes
    past a 16-byte boundary, which the scalar path takes. The rows before
    the view are left as they were."""
    rng = np.random.default_rng(40 + offset)
    now = 1_234_567
    full = _slab_stats(rng, 300, now, "random", cuda)
    view = lambda s: type(s)(*(view(t) if isinstance(t, tuple) else t[offset:] for t in s))
    want_full = _clone(full)
    tnodes.materialize_matured_plain(view(want_full), now)
    assert view(full).future_ws.data_ptr() % 16 != 0
    tnodes.materialize_matured(view(full), now)
    _states_eq(want_full, full, "materialize on a row view")


def test_materialize_kernel_profile(cuda):
    """torch.profiler: K1 is one kernel and no memset a call, on the swept
    slab and with matured cells."""
    from gpu_timing import device_profile

    rng = np.random.default_rng(9)
    now = 5_000_000
    swept = _slab_stats(rng, 1 << 16, now, "empty", cuda)
    assert device_profile(lambda: tnodes.materialize_matured(swept, now))[:2] == (1, 0)
    fresh = _slab_stats(rng, 1 << 16, now, "random", cuda)
    assert device_profile(lambda: tnodes.materialize_matured(_clone(fresh), now))[:2] == (1, 0)


def _update_batch(rng, n, n_rows, now, hot):
    """n updates over n_rows rows: rows from -3 to n_rows + 2 (out of range
    both ways), a tenth masked out, ts over three minutes (old, same and
    newer windows of both geometries); ``hot``: half of them on row 5."""
    rows = rng.integers(-3, n_rows + 3, n).astype(np.int32)
    if hot:
        rows[: n // 2] = 5
    ts = (now + rng.integers(-180_000, 3_000, n)).astype(np.int32)
    deltas = rng.integers(-3, 9, (n, NUM_EVENTS)).astype(np.int32)
    return rows, ts, deltas, rng.integers(0, 6000, n).astype(np.int32), rng.integers(-1, 2, n).astype(np.int32), (
        rng.random(n) < 0.9)


@pytest.mark.parametrize("n", [1, 8, 32, 1 << 19])
@pytest.mark.parametrize("with_rt", [False, True])
@pytest.mark.parametrize("with_minute", [False, True])
def test_apply_updates_kernel(cuda, n, with_rt, with_minute):
    """The fused apply_updates (both windows and the gauge, one C call)
    against its plain version: masked and out-of-range rows, duplicates on
    a hot row, with and without RT samples and the minute window's own
    deltas. Each call counts one launch of the window update and of the
    gauge."""
    rng = np.random.default_rng(n + 2 * with_rt + with_minute)
    n_rows, now = 4096, 3_600_000
    arrs = random_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    rows, ts, deltas, rt, thr, mask = (torch.from_numpy(a).to(cuda) for a in _update_batch(rng, n, n_rows, now, True))
    minute = torch.from_numpy(rng.integers(0, 5, (n, NUM_EVENTS)).astype(np.int32)).to(cuda) if with_minute else None
    rt = rt if with_rt else None
    want = tnodes.apply_updates_plain(tnodes.stats_from_numpy(arrs, cuda), rows, ts, deltas, rt, thr, mask, minute)
    before = (ma.update.launches, tnodes.thread_gauge_add.launches)
    got = tnodes.apply_updates(tnodes.stats_from_numpy(arrs, cuda), rows, ts, deltas, rt, thr, mask, minute)
    assert (ma.update.launches, tnodes.thread_gauge_add.launches) == (before[0] + 1, before[1] + 1)
    _states_eq(want, got, "apply_updates")


def test_apply_updates_kernel_profile(cuda):
    """torch.profiler: the fused apply_updates is two kernels and no memset
    a call, at the entry accounting's 4N = 524,288 updates and at 32."""
    from gpu_timing import device_profile

    rng = np.random.default_rng(31)
    n_rows, now = 1 << 16, 3_600_000
    stats = tnodes.stats_from_numpy(random_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG), cuda)
    rows, ts, deltas, _, thr, mask = (torch.from_numpy(a).to(cuda) for a in _update_batch(rng, 1 << 19, n_rows, now,
                                                                                          False))
    for m in (1 << 19, 32):
        call = lambda: tnodes.apply_updates(stats, rows[:m], ts[:m], deltas[:m], None, thr[:m], mask[:m])
        assert device_profile(call)[:2] == (2, 0), m


def test_thread_gauge_kernel(cuda):
    """The gauge rides in apply_updates' second launch: its result there
    equals the plain scatter (hot row, masked and out-of-range rows), and
    thread_gauge_add on a CUDA tensor raises, naming apply_updates."""
    rng = np.random.default_rng(5)
    n, n_rows = 10_000, 32
    rows = torch.from_numpy(rng.integers(-1, 40, n).astype(np.int32)).to(cuda)
    rows[:3000] = 7
    thr = torch.from_numpy(rng.integers(-1, 2, n).astype(np.int32)).to(cuda)
    mask = rows >= 0
    base = torch.from_numpy(rng.integers(0, 50, n_rows).astype(np.int32)).to(cuda)
    want = tnodes.thread_gauge_add_plain(base.clone(), rows, thr, mask)
    stats = tnodes.make_stats(n_rows, cuda)._replace(threads=base.clone())
    ts = torch.full((n,), 1_000_000, dtype=torch.int32, device=cuda)
    deltas = torch.zeros((n, NUM_EVENTS), dtype=torch.int32, device=cuda)
    got = tnodes.apply_updates(stats, rows, ts, deltas, None, thr, mask).threads
    _eq(want, got, "threads")
    with pytest.raises(ValueError, match="apply_updates"):
        tnodes.thread_gauge_add(base.clone(), rows, thr, mask)


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


# --- the rest of the slot chain: K4 with occupy, K5, K6, K7, K8, the tail --


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("case", ["all", "qps_thread_load_cpu", "load_cpu", "off"])
def test_system_check_kernel(cuda, case):
    rng = np.random.default_rng(11)
    now, n_rows, n = 1_000_250, 64, 20_000
    arrs = borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    b = random_flush_batch(rng, n, 1, n_rows, 16, now, n - 100)
    live = b[1] & (rng.random(n) < 0.9)
    sysdev = tflush.SystemDevice(*system_thresholds(case))
    want = tflush.system_check_plain(tnodes.stats_from_numpy(arrs, cuda), sysdev,
                                     tflush.batch_from_numpy(b, cuda), _t(live, cuda))
    before = tflush.system_check.launches
    got = tflush.system_check(tnodes.stats_from_numpy(arrs, cuda), sysdev, tflush.batch_from_numpy(b, cuda),
                              _t(live, cuda))
    assert tflush.system_check.launches == before + 1
    _eq(want[0], got[0], "ok")
    _eq(want[1], got[1], "sys_type")


def _sizes(small_max):
    return {"1": 1, "8": 8, "threshold": small_max, "threshold+1": small_max + 1, "131072": 131072}


def _system_inputs(cuda, n, case):
    rng = np.random.default_rng(n + len(case))
    now = 1_000_250
    arrs = borrowable_stats(rng, 64, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    b, live = system_edge_case(rng, n, case, now)
    return tnodes.stats_from_numpy(arrs, cuda), tflush.batch_from_numpy(b, cuda), _t(live, cuda)


@pytest.mark.parametrize("case", SYSTEM_EDGE_CASES)
@pytest.mark.parametrize("size", ["1", "8", "threshold", "threshold+1", "131072"])
def test_system_check_routes_kernel(cuda, size, case):
    """K6 on both routes (one block up to SYSTEM_CHECK_SMALL_MAX entries,
    CUB's sort and the look-back scan above) against the plain version:
    no entry checked, one ts, ts at INT_MIN and INT_MAX beside unchecked
    entries, acquire sums past 2^31. One launch counted per call."""
    n = _sizes(tflush.SYSTEM_CHECK_SMALL_MAX)[size]
    stats, batch, live = _system_inputs(cuda, n, case)
    for vals in system_edge_thresholds(n):
        sysdev = tflush.SystemDevice(*vals)
        want = tflush.system_check_plain(stats, sysdev, batch, live)
        before = tflush.system_check.launches
        got = tflush.system_check(stats, sysdev, batch, live)
        assert tflush.system_check.launches == before + 1
        _eq(want[0], got[0], f"{case} n={n} ok")
        _eq(want[1], got[1], f"{case} n={n} sys_type")


@pytest.mark.parametrize("n", [2048, 4096, 8192])
def test_system_check_forced_routes_kernel(cuda, monkeypatch, n):
    """K6 at the sizes where the route is chosen, through each route in
    turn: the one-block route at its capacity of 8,192 (64 KB of dynamic
    shared memory) and the many-block route below the threshold."""
    stats, batch, live = _system_inputs(cuda, n, "mixed")
    sysdev = tflush.SystemDevice(*system_edge_thresholds(n)[1])
    want = tflush.system_check_plain(stats, sysdev, batch, live)
    for small_max in (8192, 0):
        monkeypatch.setattr(tflush, "SYSTEM_CHECK_SMALL_MAX", small_max)
        got = tflush.system_check(stats, sysdev, batch, live)
        _eq(want[0], got[0], f"small_max={small_max} ok")
        _eq(want[1], got[1], f"small_max={small_max} sys_type")


def _zero_buffer(cuda):
    from sentinel_tpu_torch.utils import cuda_build

    st = torch.cuda.current_stream(cuda).cuda_stream
    with cuda_build.scratch(cuda, st, 0, 8):  # made zeroed if no call has asked for it yet
        pass
    return cuda_build._SCRATCH.get((True, cuda, st))


def _assert_zeroed(cuda, what):
    torch.cuda.synchronize()
    buf = _zero_buffer(cuda)
    assert buf is not None and int(buf.count_nonzero()) == 0, f"{what}: the zeroed scratch is dirty"


@pytest.mark.parametrize("masked", [False, True], ids=["all", "probe_allowed"])
@pytest.mark.parametrize("size", ["1", "8", "threshold", "threshold+1", "131072", "2049-one-breaker"])
def test_breaker_try_pass_routes_kernel(cuda, size, masked):
    """K8 on both routes (one block up to TRY_PASS_SMALL_MAX slots, the
    election and the verdicts as two launches above) against the plain
    version, with and without the mask; "2049-one-breaker": 2,049
    candidates of one breaker at one ts, where the slot decides. The
    election's cells in the zeroed scratch read zero after every call."""
    kd = 1
    if size == "2049-one-breaker":
        rng = np.random.default_rng(2049)
        n, nd, now = 2049, 64, 700_000
        table, dyn, e_dgid, e_ts, e_live = many_candidates(rng, n, kd, nd, now)
    else:
        n = _sizes(tdt.TRY_PASS_SMALL_MAX)[size]
        rng = np.random.default_rng(n)
        nd, now = 1024, 700_000
        table, dyn = random_degrade(rng, nd, now)
        e_dgid = np.where(rng.random((n, kd)) < 0.9, rng.integers(0, nd, (n, kd)), -1).astype(np.int32)
        e_ts = (now - rng.integers(-3000, 3000, n)).astype(np.int32)
        e_ts[: n // 4] = e_ts[0]
        e_live = rng.random(n) < 0.85
    ddev, ddyn = tdt.degrade_table_from_numpy(table, cuda), tdt.degrade_state_from_numpy(dyn, cuda)
    allowed = _t(rng.random(nd) < 0.5, cuda) if masked else None
    if masked and size == "2049-one-breaker":
        allowed[1] = True
    args = (_t(e_dgid, cuda), _t(e_ts, cuda), _t(e_live, cuda), allowed)
    want = tdt.breaker_try_pass_plain(ddev, ddyn, *args)
    before = tdt.breaker_try_pass.launches
    got = tdt.breaker_try_pass(ddev, ddyn, *args)
    assert tdt.breaker_try_pass.launches == before + 1
    _eq(want[0], got[0], "dslot_ok")
    _eq(want[1], got[1], "probe_slot")
    _assert_zeroed(cuda, size)
    if size == "2049-one-breaker":
        assert int(got[1].sum()) == 1 and bool(got[1][int(np.flatnonzero(e_live)[0]), 0])


def test_breaker_try_pass_nd_changes_kernel(cuda):
    """ND shrinking and then growing between calls, on both routes: the
    cells of the largest table so far stay zero, and so do the ones a
    smaller table leaves untouched."""
    rng = np.random.default_rng(81)
    now = 700_000
    for nd in (4096, 16, 65536, 8, 100_000):
        table, dyn = random_degrade(rng, nd, now)
        ddev, ddyn = tdt.degrade_table_from_numpy(table, cuda), tdt.degrade_state_from_numpy(dyn, cuda)
        for n in (64, tdt.TRY_PASS_SMALL_MAX + 1):
            e_dgid = _t(rng.integers(-1, nd, (n, 2)).astype(np.int32), cuda)
            e_ts = _t((now - rng.integers(-3000, 3000, n)).astype(np.int32), cuda)
            e_live = _t(rng.random(n) < 0.9, cuda)
            want = tdt.breaker_try_pass_plain(ddev, ddyn, e_dgid, e_ts, e_live)
            got = tdt.breaker_try_pass(ddev, ddyn, e_dgid, e_ts, e_live)
            _eq(want[0], got[0], f"nd={nd} n={n} ok")
            _eq(want[1], got[1], f"nd={nd} n={n} probe")
            _assert_zeroed(cuda, f"nd={nd} n={n}")


def test_breaker_try_pass_refusals_kernel(cuda):
    """After the table checks are cached, a new table with a wrong tensor
    still raises; a call the C side refuses (cells smaller than the
    table) launches nothing; the zeroed scratch stays zero throughout."""
    from sentinel_tpu_torch.utils import cuda_build

    rng = np.random.default_rng(82)
    nd, n, now = 256, 512, 700_000
    table, dyn = random_degrade(rng, nd, now)
    ddev, ddyn = tdt.degrade_table_from_numpy(table, cuda), tdt.degrade_state_from_numpy(dyn, cuda)
    args = (_t(rng.integers(0, nd, (n, 1)).astype(np.int32), cuda),
            _t((now - rng.integers(-3000, 3000, n)).astype(np.int32), cuda), _t(rng.random(n) < 0.9, cuda))
    tdt.breaker_try_pass(ddev, ddyn, *args)  # the checks of (ddev, ddyn) are now cached
    bad = ddyn._replace(next_retry=ddyn.next_retry.to(torch.int64))
    with pytest.raises(ValueError, match="dyn.next_retry"):
        tdt.breaker_try_pass(ddev, bad, *args)
    with pytest.raises(ValueError, match="ddev.grade"):
        tdt.breaker_try_pass(ddev._replace(grade=ddev.grade.float()), ddyn, *args)
    _assert_zeroed(cuda, "after the refused tables")
    lib = tdt._lib("breaker_try_pass", tdt._setup_try)
    out = torch.ones((2, n, 1), dtype=torch.bool, device=cuda)
    st = torch.cuda.current_stream(cuda).cuda_stream
    with cuda_build.scratch(cuda, st, 0, 8 * nd) as (_, _, win):
        code = lib.breaker_try_pass(args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(), n, 1, nd,
                                    ddyn.state.data_ptr(), ddyn.next_retry.data_ptr(), None, win, 8 * nd - 8,
                                    out.data_ptr(), out[1].data_ptr(), tdt.TRY_PASS_SMALL_MAX, st)
    assert code != 0
    assert bool(out.all()), "a refused call wrote its outputs"
    _assert_zeroed(cuda, "after the refused call")


@pytest.mark.parametrize("which", ["system_check", "breaker_try_pass", "breaker_try_pass_mask", "shaping_stage",
                                   "mesh_split_grant", "mesh_split_borrow", "breaker_on_exits", "sketch_fold",
                                   "sketch_fold_decay"])
def test_small_batch_is_one_kernel(cuda, which):
    """At 8 entries K6 and K8 (with and without the mask), at 8 items K9
    with its inputs, at 8 slots K15 (both demotions), at 8 exits K7 and at
    8 keys K11 (with and without decay) issue one device kernel and no
    memset a call (torch.profiler through gpu_timing)."""
    from gpu_timing import device_profile

    if which == "breaker_on_exits":
        fn = _exits_call(cuda, 8)[1]
    elif which.startswith("sketch_fold"):
        fn = _fold_call(cuda, 8, "default", which.endswith("decay"))[1]
    elif which == "shaping_stage":
        table, dyn, sb, live, ppc, stats = _stage_inputs(cuda, 8, "scan")
        tt, td = flow_table_from_numpy(table, dyn, cuda)
        fn = lambda: tsh.shaping_stage(tt, td, sb, live, ppc, stats.minute, 1.0, 0)
    elif which.startswith("mesh_split"):
        fn = _mesh_split_call(cuda, 4, which.endswith("grant"))[1]
    elif which == "system_check":
        stats, batch, live = _system_inputs(cuda, 8, "mixed")
        sysdev = tflush.SystemDevice(*system_edge_thresholds(8)[1])
        fn = lambda: tflush.system_check(stats, sysdev, batch, live)
    else:
        rng = np.random.default_rng(83)
        nd, now = 64, 700_000
        table, dyn = random_degrade(rng, nd, now)
        ddev, ddyn = tdt.degrade_table_from_numpy(table, cuda), tdt.degrade_state_from_numpy(dyn, cuda)
        allowed = _t(rng.random(nd) < 0.5, cuda) if which.endswith("mask") else None
        args = (_t(rng.integers(0, nd, (8, 1)).astype(np.int32), cuda),
                _t(np.full(8, now, np.int32), cuda), _t(np.ones(8, bool), cuda), allowed)
        fn = lambda: tdt.breaker_try_pass(ddev, ddyn, *args)
    kernels, memsets, _ = device_profile(fn)
    assert (kernels, memsets) == (1, 0)


@pytest.mark.parametrize("near_max", [False, True])
@pytest.mark.parametrize("m", [64, 20_000])
def test_breaker_kernels(cuda, near_max, m):
    rng = np.random.default_rng(12 + m)
    nd = 1024
    now = 2**31 - 1 - 3000 if near_max else 500_000
    table, dyn = random_degrade(rng, nd, now, near_max)
    x = random_exits(rng, m, 2, nd, now)
    ddev = tdt.degrade_table_from_numpy(table, cuda)
    want = tdt.breaker_on_exits_plain(ddev, tdt.degrade_state_from_numpy(dyn, cuda), *(_t(a, cuda) for a in x))
    got = tdt.breaker_on_exits(ddev, tdt.degrade_state_from_numpy(dyn, cuda), *(_t(a, cuda) for a in x))
    _states_eq(want, got, "breaker_on_exits")
    # Entries against the post-exit state.
    n = m
    e_dgid = np.where(rng.random((n, 2)) < 0.8, rng.integers(0, nd, (n, 2)), -1).astype(np.int32)
    e_dgid[: n // 3, 0] = 1
    e_ts = (now - rng.integers(0, 300, n)).astype(np.int32)
    e_ts[: n // 4] = e_ts[0]
    live = rng.random(n) < 0.85
    args = (_t(e_dgid, cuda), _t(e_ts, cuda), _t(live, cuda))
    w_ok, w_probe = tdt.breaker_try_pass_plain(ddev, got, *args)
    g_ok, g_probe = tdt.breaker_try_pass(ddev, got, *args)
    _eq(w_ok, g_ok, "dslot_ok")
    _eq(w_probe, g_probe, "probe_slot")


@pytest.mark.parametrize("timeout", [500, 1000])
def test_occupy_and_commit_kernels(cuda, timeout):
    rng = np.random.default_rng(13)
    n_rows, nr, n, k = 256, 64, 8192, 2
    now = 4_321_000 + 123
    arrs = borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    table, _ = random_flow_table(rng, nr, thread_frac=0.2, lo=2, hi=12)
    tt, _ = flow_table_from_numpy(table, None, cuda)
    b = list(random_flush_batch(rng, n, k, n_rows, nr, now, n - 50))
    b[7] = rng.random(n) < 0.4
    batch = tflush.batch_from_numpy(b, cuda)
    live = _t(b[1] & (rng.random(n) < 0.9), cuda)
    stats = tnodes.stats_from_numpy(arrs, cuda)
    want = tflush.flow_admission_plain(stats, tt, batch, 0, live, timeout, with_occupy=True, tail=False)
    before = tflush.flow_admission.occupy_launches
    got = tflush.flow_admission(stats, tt, batch, 0, live, timeout, with_occupy=True, tail=False)
    assert tflush.flow_admission.occupy_launches == before + 1
    tflush.flow_admission(stats, tt, batch, 0, live, timeout, with_occupy=False, tail=False)
    assert tflush.flow_admission.occupy_launches == before + 1
    for name, x, y in zip(want._fields, want, got):
        _eq(x, y, f"admission {name}")
    assert bool(want.occupied.any())
    gate = want.occ_slot & (want.flow_pass & want.occupied)[:, None]
    w = tflush.commit_borrow_slab_plain(tnodes.stats_from_numpy(arrs, cuda), gate, want.occ_target,
                                        batch.e_acquire, batch.e_check_row)
    g = tflush.commit_borrow_slab(tnodes.stats_from_numpy(arrs, cuda), gate, want.occ_target,
                                  batch.e_acquire, batch.e_check_row)
    _states_eq(w, g, "commit_borrow_slab")


@pytest.mark.parametrize("flags", [(True, True, True), (False, True, True), (True, False, True),
                                   (True, True, False), (True, False, False)])
def test_chain_flush_step_kernels(cuda, flags):
    """The whole slot chain: the kernels' step on the card against the plain
    versions' step on the CPU, over three flushes."""
    with_occupy, with_system, with_degrade = flags
    rng = np.random.default_rng(sum(f << i for i, f in enumerate(flags)))
    cpu = torch.device("cpu")
    n_rows, nr, nd, n, k, kd, m = 128, 32, 64, 4096, 2, 2, 1024
    now = 3_456_000 + 77
    arrs = borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    table, dyn = random_flow_table(rng, nr, thread_frac=0.2, lo=2, hi=40)
    dtable, ddyn = random_degrade(rng, nd, now)
    sysdev = tflush.SystemDevice(*system_thresholds("all"))
    states = {}
    for dev in (cpu, cuda):
        states[dev.type] = (tnodes.stats_from_numpy(arrs, dev), flow_table_from_numpy(table, dyn, dev)[0],
                            tdt.degrade_table_from_numpy(dtable, dev), tdt.degrade_state_from_numpy(ddyn, dev))
    for step in range(3):
        b = random_chain_batch(rng, n, k, kd, n_rows, nr, nd, now + 300 * step, m)
        res = {}
        for dev in (cpu, cuda):
            stats, tt, ddev, dd = states[dev.type]
            _, res[dev.type] = tflush.flush_step(
                stats, tt, tflush.batch_from_numpy(b, dev), True, 8, ddev, dd, sysdev, 1000,
                with_occupy, with_system, with_degrade,
            )
        for name, x, y in zip(res["cpu"]._fields, res["cpu"], res["cuda"]):
            _eq(x, y, f"step {step} {name}")
        _states_eq(states["cpu"][0], states["cuda"][0], f"stats step {step}")
        _states_eq(states["cpu"][3], states["cuda"][3], f"breakers step {step}")


# --- K9 (shaping) and K10 (hot parameters), K4's pass-plus-charge output -----

SHAPING_GPU_CASES = {
    # name: (the case's inputs from a seeded rng, rounds)
    "a_behaviors": (lambda rng: random_shaping_case(rng, 4096, 64), (0, 4, 16, 32)),
    "c_closed_form": (lambda rng: random_shaping_case(rng, 4096, 16, behaviors=(2,), one_ts=True, acquire=1), (-1,)),
    "d_heavy_rule": (lambda rng: random_shaping_case(rng, 2048, 4, n_hot=2048), (0,)),
    "fma_warning_line": (lambda rng: fma_warning_case(), (0,)),
}


@pytest.mark.parametrize("case", sorted(SHAPING_GPU_CASES))
def test_shaping_kernel(cuda, case):
    build, rounds_list = SHAPING_GPU_CASES[case]
    table, dyn, sb, ppc, prev = build(np.random.default_rng(21))
    for rounds in rounds_list:
        out = []
        for fn in (tsh.run_shaping_plain, tsh.run_shaping):
            tt, td = flow_table_from_numpy(table, dyn, cuda)
            before = tsh.run_shaping.launches
            out.append(fn(tt, td, tsh.shaping_batch_from_numpy(sb, cuda), _t(ppc, cuda), _t(prev, cuda), 1.0,
                          rounds))
        assert tsh.run_shaping.launches == before + 1
        (wd, wok, ww), (gd, gok, gw) = out
        _eq(wok, gok, f"{case} rounds={rounds} ok")
        _eq(ww, gw, f"{case} rounds={rounds} wait")
        _states_eq(wd, gd, f"{case} rounds={rounds} state")
        assert bool(wok.any()) and not bool(wok.all())


SHAPING_ROUNDS = {"scan": 0, "rounds_3": 3, "closed_form": -1}


def _shaping_sizes():
    return {"1": 1, "8": 8, "threshold": tsh.SHAPING_SMALL_MAX, "threshold+1": tsh.SHAPING_SMALL_MAX + 1,
            "16384": 16384}


def _shaping_case(rng, s, mode, one_rule=False):
    kw = dict(behaviors=(2,), one_ts=True, acquire=1) if mode == "closed_form" else {}
    return random_shaping_case(rng, s, 4 if one_rule else max(4, s // 16), n_hot=s if one_rule else 0, **kw)


def _shaping_on_both(cuda, case, rounds):
    table, dyn, sb, ppc, prev = case
    out = []
    for fn in (tsh.run_shaping_plain, tsh.run_shaping):
        tt, td = flow_table_from_numpy(table, dyn, cuda)
        out.append(fn(tt, td, tsh.shaping_batch_from_numpy(sb, cuda), _t(ppc, cuda), _t(prev, cuda), 1.0, rounds))
    (wd, wok, ww), (gd, gok, gw) = out
    return (wok, ww, wd), (gok, gw, gd)


def _eq_shaping(want, got, what):
    _eq(want[0], got[0], f"{what} ok")
    _eq(want[1], got[1], f"{what} wait")
    _states_eq(want[2], got[2], f"{what} state")


@pytest.mark.parametrize("mode", sorted(SHAPING_ROUNDS))
@pytest.mark.parametrize("size", ["1", "8", "threshold", "threshold+1", "16384"])
def test_shaping_routes_kernel(cuda, size, mode):
    """K9 on both routes (one block up to SHAPING_SMALL_MAX items, CUB's
    sort, the heads and the walk above) in every rounds mode against the
    plain version. One launch counted per call."""
    s = _shaping_sizes()[size]
    rounds = SHAPING_ROUNDS[mode]
    case = _shaping_case(np.random.default_rng(s + rounds + 7), s, mode)
    before = tsh.run_shaping.launches
    want, got = _shaping_on_both(cuda, case, rounds)
    assert tsh.run_shaping.launches == before + 1
    _eq_shaping(want, got, f"s={s} {mode}")


@pytest.mark.parametrize("small_max", [8192, 0], ids=["one_block", "many_blocks"])
@pytest.mark.parametrize("rounds", [0, 3])
def test_shaping_one_rule_warp_walk_kernel(cuda, monkeypatch, small_max, rounds):
    """One rule holding 4,096 items: its segment is walked by a warp on
    either route (rounds 3 stops it after three items)."""
    monkeypatch.setattr(tsh, "SHAPING_SMALL_MAX", small_max)
    want, got = _shaping_on_both(cuda, _shaping_case(np.random.default_rng(4096), 4096, "scan", one_rule=True), rounds)
    _eq_shaping(want, got, f"one rule small_max={small_max} rounds={rounds}")
    assert bool(want[0].any()) and not bool(want[0].all())


@pytest.mark.parametrize("s", [2048, 4096, 8192])
def test_shaping_forced_routes_kernel(cuda, monkeypatch, s):
    """K9 at the sizes where the route is chosen, through each route in
    turn: the one-block route at its capacity of 8,192 and the many-block
    route below the threshold."""
    for mode in ("scan", "closed_form"):
        case = _shaping_case(np.random.default_rng(s + 3), s, mode)
        for small_max in (8192, 0):
            monkeypatch.setattr(tsh, "SHAPING_SMALL_MAX", small_max)
            want, got = _shaping_on_both(cuda, case, SHAPING_ROUNDS[mode])
            _eq_shaping(want, got, f"s={s} {mode} small_max={small_max}")


@pytest.mark.parametrize("small_max", [8192, 0], ids=["one_block", "many_blocks"])
@pytest.mark.parametrize("mode", sorted(SHAPING_ROUNDS))
def test_shaping_out_of_range_ids_kernel(cuda, monkeypatch, small_max, mode):
    """Valid items whose rule ids lie outside [0, nr) (two different
    negative ids, nr, past nr, the int32 extremes) count as invalid on
    either route, as in the plain version."""
    monkeypatch.setattr(tsh, "SHAPING_SMALL_MAX", small_max)
    rng = np.random.default_rng(63)
    table, dyn, sb, ppc, prev = _shaping_case(rng, 2048, mode)
    bad, _ = out_of_range_rule_ids(rng, sb, int(table[0].shape[0]))
    want, got = _shaping_on_both(cuda, (table, dyn, bad, ppc, prev), SHAPING_ROUNDS[mode])
    _eq_shaping(want, got, f"{mode} small_max={small_max}")


def _stage_inputs(cuda, s, mode):
    rng = np.random.default_rng(s + 11)
    table, dyn, sb, ppc, _ = _shaping_case(rng, s, mode)
    now = int(sb[5].max()) + 300
    stats = tnodes.stats_from_numpy(borrowable_stats(rng, int(table[0].shape[0]), now, tnodes.SECOND_CFG,
                                                     tnodes.MINUTE_CFG), cuda)
    return table, dyn, tsh.shaping_batch_from_numpy(sb, cuda), _t(rng.random(s) < 0.8, cuda), _t(ppc, cuda), stats


@pytest.mark.parametrize("mode", sorted(SHAPING_ROUNDS))
@pytest.mark.parametrize("s", [8, 2049, 16384])
def test_shaping_stage_kernel(cuda, s, mode):
    """K9 with its inputs (one host call) against shaping_inputs_plain and
    run_shaping_plain, and the inputs alone against shaping_inputs_plain."""
    table, dyn, sb, live, ppc, stats = _stage_inputs(cuda, s, mode)
    rounds = SHAPING_ROUNDS[mode]
    out = []
    before = tsh.shaping_stage.launches
    for fn in (tsh.shaping_stage_plain, tsh.shaping_stage):
        tt, td = flow_table_from_numpy(table, dyn, cuda)
        out.append((fn(tt, td, sb, live, ppc, stats.minute, 1.0, rounds), td))
    assert tsh.shaping_stage.launches == before + 1
    (w, wd), (g, gd) = out
    for name, x, y in zip(("valid", "ok", "wait"), w, g):
        _eq(x, y, f"s={s} {mode} {name}")
    _states_eq(wd, gd, f"s={s} {mode} state")
    want_in = tsh.shaping_inputs_plain(sb, live, ppc, stats.minute)
    got_in = tsh.shaping_inputs(sb, live, ppc, stats.minute)
    for name, x, y in zip(("valid", "pass_consumed", "prev_pass"), want_in, got_in):
        _eq(x, y, f"s={s} inputs {name}")


PARAM_GPU_CASES = {
    "b_every_grade": (dict(s=4096, pr=256), (0, 1, 4, 16)),
    "c_closed_one_ts": (dict(s=4096, pr=256, closed=True, nts=1), (-1,)),
    "c_closed_mixed_ts": (dict(s=4096, pr=256, closed=True, nts=7), (-8, -4)),
    "d_heavy_value": (dict(s=4096, pr=16, heavy=True), (0,)),
    # Either side of the one-block route's 2,048 items, on the rounds, scan
    # and closed routes; heavy rows walked by a warp (token bucket and
    # throttle, with rounds bounding the walk).
    "e_s8": (dict(s=8, pr=8), (0, 1, 4)),
    "e_s2048": (dict(s=2048, pr=64), (0, 4, 16)),
    "e_s2049": (dict(s=2049, pr=64), (0, 4, 16)),
    "e_closed_s8": (dict(s=8, pr=4, closed=True, nts=2), (-1, -8)),
    "e_closed_s2048": (dict(s=2048, pr=64, closed=True, nts=5), (-8, -1)),
    "e_closed_s2049": (dict(s=2049, pr=64, closed=True, nts=5), (-8, -2)),
    "e_heavy_s2048": (dict(s=2048, pr=16, heavy=True), (0, 100)),
    "e_heavy_throttle_s2048": (dict(s=2048, pr=16, heavy=True, heavy_row=1, sorted_ts=False), (0,)),
    "e_heavy_throttle_s4096": (dict(s=4096, pr=16, heavy=True, heavy_row=1), (0, 200)),
}


@pytest.mark.parametrize("case", sorted(PARAM_GPU_CASES))
def test_param_kernel(cuda, case):
    kwargs, rounds_list = PARAM_GPU_CASES[case]
    pb, dyn = random_param_case(np.random.default_rng(22), **kwargs)
    for rounds in rounds_list:
        out = []
        for fn in (tpt.run_param_plain, tpt.run_param):
            before = tpt.run_param.launches
            out.append(fn(tpt.param_state_from_numpy(dyn, cuda), tpt.param_batch_from_numpy(pb, cuda), rounds))
        assert tpt.run_param.launches == before + 1
        (wd, wok, ww), (gd, gok, gw) = out
        _eq(wok, gok, f"{case} rounds={rounds} ok")
        _eq(ww, gw, f"{case} rounds={rounds} wait")
        _states_eq(wd, gd, f"{case} rounds={rounds} state")
        assert bool(wok.any()) and not bool(wok.all())


K4_CASES = [(nk, topk, False) for nk in (8, 64, 2048, 2049, 131072) for topk in (0, 8)] + [
    (nk, 8, True) for nk in (64, 2049, 131072)]


@pytest.mark.parametrize("nk,topk,few", K4_CASES, ids=[f"{nk}-top{t}{'-few' if f else ''}" for nk, t, f in K4_CASES])
def test_flow_admission_routes_kernel(cuda, nk, topk, few):
    """K4 on both of its routes (one block up to 2,048 slots, many blocks
    above): the DEFAULT path with its fused tail and top-K, and the slot
    chain's stage with occupy and the pass plus charge, against the plain
    version on the card. ``few``: every entry on one resource under high
    counts, so fewer than 8 rows carry blocked weight. One launch counted
    per call."""
    rng = np.random.default_rng(nk + topk + few)
    k = 2 if nk % 2 == 0 and nk <= 2048 else 1
    n, nr = nk // k, 64
    n_rows = 32 if nk <= 64 else 1024
    now = 4_321_000 + 123
    arrs = borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    lo, hi = (5000, 6000) if few else (2, 40)
    table, _ = random_flow_table(rng, nr, thread_frac=0.2, lo=lo, hi=hi)
    tt, _ = flow_table_from_numpy(table, None, cuda)
    b = list(random_flush_batch(rng, n, k, n_rows, nr, now, n - n // 16, one_row=few))
    b[7] = rng.random(n) < 0.4
    batch = tflush.batch_from_numpy(b, cuda)
    live = _t(b[1] & (rng.random(n) < 0.9), cuda)
    stats = tnodes.stats_from_numpy(arrs, cuda)
    for tail in (True, False):
        args = (topk,) if tail else (0, live, 500, True, False, True)
        want = tflush.flow_admission_plain(stats, tt, batch, *args)
        before = tflush.flow_admission.launches
        got = tflush.flow_admission(stats, tt, batch, *args)
        assert tflush.flow_admission.launches == before + 1
        for name, x, y in zip(want._fields, want, got):
            _eq(x, y, f"tail={tail} admission {name}")
    assert bool(want.flow_pass.any()) and (few or nk < 64 or not bool(want.flow_pass.all()))
    if topk and nk > 2048:  # the many-block top-K leaves its zeroed buffer (K8's cells too) all zero
        _assert_zeroed(cuda, f"K4 at {nk}")
    if few and topk:
        adm = tflush.flow_admission_plain(stats, tt, batch, topk)
        assert int((adm.blk_weight > 0).sum()) < 8


def test_flow_admission_pass_plus_charge(cuda):
    rng = np.random.default_rng(23)
    n_rows, nr, n, k = 256, 64, 8192, 2
    now = 4_321_000 + 123
    arrs = borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    table, _ = random_shaped_flow_table(rng, nr)
    tt, _ = flow_table_from_numpy(table, None, cuda)
    batch = tflush.batch_from_numpy(random_flush_batch(rng, n, k, n_rows, nr, now, n - 50), cuda)
    live = _t(rng.random(n) < 0.9, cuda)
    stats = tnodes.stats_from_numpy(arrs, cuda)
    for occupy in (False, True):
        want = tflush.flow_admission_plain(stats, tt, batch, 0, live, 500, occupy, tail=False, with_ppc=True)
        got = tflush.flow_admission(stats, tt, batch, 0, live, 500, occupy, tail=False, with_ppc=True)
        for name, x, y in zip(want._fields, want, got):
            _eq(x, y, f"occupy={occupy} admission {name}")
        assert bool((want.pass_plus_consumed > 0).any())


@pytest.mark.parametrize("chain", [False, True])
def test_shaping_param_flush_step_kernels(cuda, chain):
    """flush_step with shaping and hot parameters on: the kernels' step on
    the card against the plain versions' step on the CPU, three flushes."""
    rng = np.random.default_rng(24 + chain)
    cpu = torch.device("cpu")
    n_rows, nr, nd, n, k, kd, m, pr = 128, 32, 64, 4096, 2, 2, 1024, 512
    now = 3_456_000 + 77
    arrs = borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    table, dyn = random_shaped_flow_table(rng, nr)
    dtable, ddyn = random_degrade(rng, nd, now)
    pdyn = random_param_state(rng, pr, now)
    sysdev = tflush.SystemDevice(*system_thresholds("all"))
    states = {}
    for dev in (cpu, cuda):
        states[dev.type] = (tnodes.stats_from_numpy(arrs, dev), *flow_table_from_numpy(table, dyn, dev),
                            tdt.degrade_table_from_numpy(dtable, dev), tdt.degrade_state_from_numpy(ddyn, dev),
                            tpt.param_state_from_numpy(pdyn, dev))
    for step in range(3):
        b = random_chain_batch(rng, n, k, kd, n_rows, nr, nd, now + 450 * step, m)
        if not chain:
            b[7] = np.zeros(n, bool)
        sb, pb = shaping_batch_for(b, table), random_param_batch_for(rng, b, pr, m_exit=64)
        res = {}
        for dev in (cpu, cuda):
            stats, tt, td, ddev, dd, pd = states[dev.type]
            _, res[dev.type] = tflush.flush_step(
                stats, tt, tflush.batch_from_numpy(b, dev), True, 8, ddev, dd, sysdev, 1000, chain, chain, chain,
                flow_dyn=td, pdyn=pd, shaping=tsh.shaping_batch_from_numpy(sb, dev),
                param=tpt.param_batch_from_numpy(pb, dev), shaping_rounds=[0, 4, 16][step],
                param_rounds=[16, 0, 4][step],
            )
        for name, x, y in zip(res["cpu"]._fields, res["cpu"], res["cuda"]):
            _eq(x, y, f"step {step} {name}")
        for j, what in enumerate(("stats", "table", "shaping state", "breaker table", "breakers", "params")):
            _states_eq(states["cpu"][j], states["cuda"][j], f"{what} step {step}")


# --- K11: the sketch fold, at the shapes of chip_smoke.py phase 2d ----------


def _sketch_case(cuda, case, rng):
    """(state, batch) on the card: (a) the default tier (depth 4, width
    2,048, 64 candidates) after eight earlier folds, 131,072 distinct ids;
    (b) a widened tier (depth 8, width 2^20, 1,024 candidates), ids from a
    Zipf law over 10^6 keys with duplicate rows and padding; (c) equal
    weights; (d) 4,096 candidates (tiles of 8,192 keys in the top-C)."""
    s = 1 << 17
    depth, width, c = {"widened": (8, 1 << 20, 1024), "many": (2, 1 << 16, 4096)}.get(case, (4, 2048, 64))
    state = tsk.make_sketch_state(depth, width, c, cuda)
    keys = np.unique(rng.integers(0, 2**31 - 1, 3 * 10**6))[: 10**6]
    keys = rng.permutation(keys).astype(np.int32)

    def batch(ids, w):
        return tsk.SketchBatch(torch.from_numpy(ids).to(cuda), torch.from_numpy(w.astype(np.int32)).to(cuda))

    for k in range(8):  # the prior folds: the table is full, and a third of it recurs below
        ids = keys[k * (s // 8) : (k + 1) * (s // 8)]
        tsk.sketch_fold_plain(state, batch(ids, rng.integers(1, 5, ids.shape[0])), decay=k == 4)
    if case == "widened":
        ids = keys[np.minimum(rng.zipf(1.1, s), 10**6) - 1]
        ids[s // 2 : s // 2 + 512] = ids[:512]
        ids[-1000:] = -1
    else:
        ids = keys[s : 2 * s].copy()  # distinct, and new to the table
        cand = state.cand_ids.cpu().numpy()
        ids[: c // 3] = cand[: c // 3]
    w = np.full(s, 2) if case == "ties" else rng.integers(1, 5, s)
    return state, batch(ids, w)


@pytest.mark.parametrize("decay", [False, True])
@pytest.mark.parametrize("case", ["default", "widened", "ties", "many"])
def test_sketch_fold_kernel(cuda, case, decay):
    rng = np.random.default_rng(41)
    state, sk = _sketch_case(cuda, case, rng)
    want = tsk.sketch_fold_plain(_clone(state), sk, decay)
    before = tsk.sketch_fold.launches
    got = tsk.sketch_fold(state, sk, decay)
    assert tsk.sketch_fold.launches == before + 1
    _states_eq(want, got, f"sketch ({case})")
    assert int((got.cand_ids >= 0).sum()) == got.cand_ids.shape[0]


# --- K12: the token decision, at the shapes of chip_smoke.py phase 2e -------


def _token_batch(rng, cuda, b, n_flows, n_ns, nrows):
    t = lambda a: torch.from_numpy(a).to(cuda)
    flow = np.minimum(rng.zipf(1.1, b) - 1, n_flows - 1)
    rows = flow.astype(np.int32)
    # Namespace 0 holds the even flows (half the traffic: its guard trips).
    ns = (n_flows + np.where(flow % 2 == 0, 0, 1 + (flow // 2) % (n_ns - 1))).astype(np.int32)
    acq = rng.integers(1, 4, b).astype(np.int32)
    thr = rng.integers(50, 501, n_flows).astype(np.float32)[flow]
    # The default namespace guard (30,000 QPS) at 16,384 requests a batch,
    # scaled with the batch so that namespace 0 trips it at every size.
    nthr = np.full(b, 30000.0 * b / 16384, np.float32)
    valid = rng.random(b) < 0.98
    return [t(a) for a in (rows, ns, acq, thr, nthr, valid)]


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("b", [8, 13, 64, 1024, 2048, 3000, 16384])
def test_token_decide_kernel(cuda, b, wrap):
    """Batches of b requests over 65,536 flows in 16 namespaces, 2 s of
    clock in 50 ms steps (the buckets roll), plain and atomic in turns:
    kernel and plain version in lockstep on states of their own; b <= 2,048
    takes the one-block route, larger b the many-block one. With ``wrap``
    acquire is near 2^31 / b, so each batch's int32 cumsum passes 2^31.
    Otherwise OK, BLOCKED and TOO_MANY_REQUEST all occur."""
    rng = np.random.default_rng(43)
    n_flows, n_ns = 1 << 16, 16
    nrows = n_flows + n_ns
    kern = ma.make_state(nrows, tts.CLUSTER_CFG, cuda)
    plain = ma.make_state(nrows, tts.CLUSTER_CFG, cuda)
    seen = torch.zeros(3, dtype=torch.int64)
    for step in range(40):
        arrays = _token_batch(rng, cuda, b, n_flows, n_ns, nrows)
        if wrap:
            arrays[2] = torch.from_numpy(rng.integers(2**31 // b, 3 * (2**31 // b), b).astype(np.int32)).to(cuda)
            arrays[3] = arrays[3] * 1e8
            arrays[4] = torch.from_numpy(rng.choice([1e9, 1e10, 3e10], b).astype(np.float32)).to(cuda)
        now = 1000 + 50 * step
        atomic = step % 2 == 1
        want = tts.batch_decide_plain(plain, *arrays, now, atomic=atomic)
        before = tts.batch_decide.launches
        got = tts.batch_decide(kern, *arrays, now, atomic=atomic)
        assert tts.batch_decide.launches == before + 1
        _eq(want, got, f"step {step}: (admitted, ns_ok, next_remaining)")
        _states_eq(plain, kern, f"step {step} state")
        adm, ns_ok, _ = tts.unpack_decision(want.cpu())
        seen += torch.tensor([int(adm.sum()), int((~ns_ok).sum()), int((ns_ok & ~adm).sum())])
    if not wrap:
        assert (seen > 0).all(), seen


def test_token_decide_atomic_kernel(cuda):
    """8,192 values of one param flow: a batch with one value over budget
    charges nothing; a batch within budget is all admitted."""
    t = lambda a: torch.from_numpy(a).to(cuda)
    b = 8192
    for over in (True, False):
        state = ma.make_state(b, tts.CLUSTER_CFG, cuda)
        rows = np.arange(b, dtype=np.int32)
        if over:
            rows[-1] = 0
        arrays = [t(rows), t(np.full(b, -1, np.int32)), t(np.ones(b, np.int32)), t(np.full(b, 1.0, np.float32)),
                  t(np.zeros(b, np.float32)), t(np.ones(b, bool))]
        plain = _clone(state)
        want = tts.batch_decide_plain(plain, *arrays, 700, atomic=True)
        got = tts.batch_decide(state, *arrays, 700, atomic=True)
        _eq(want, got, f"atomic over={over}")
        _states_eq(plain, state, f"atomic state over={over}")
        assert int(state.counts.sum()) == (0 if over else b)


def test_shared_scratch_across_threads(cuda):
    """K12 at 16,384 requests, K4 with its top-8 tail at 131,072 entries,
    K10 at 4,096 items, K6 at 131,072 entries, K8 at 131,072 slots over
    65,536 breakers, K9 at 16,384 items and K15 at 131,072 slots over 8
    shards, each in a host thread of its own and all on the default
    stream: the seven share the stream's scratch and its zeroed buffer
    (K4's top-K, K8's election cells, K15's demand), which start empty so
    that they grow during the run. Every call equals its plain version,
    computed beforehand, and the zeroed buffer reads zero at the end."""
    import threading

    from sentinel_tpu_torch.utils import cuda_build

    iters = 20
    rng = np.random.default_rng(47)
    # K12
    n_flows, n_ns = 1 << 16, 16
    td_state = ma.make_state(n_flows + n_ns, tts.CLUSTER_CFG, cuda)
    td_args = _token_batch(rng, cuda, 16384, n_flows, n_ns, n_flows + n_ns)
    td_plain = _clone(td_state)
    td_want = tts.batch_decide_plain(td_plain, *td_args, 1000, atomic=False)
    # K4
    n, n_rows, nr, now = 131072, 1024, 64, 4_321_000 + 123
    stats = tnodes.stats_from_numpy(borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG), cuda)
    tt, _ = flow_table_from_numpy(random_flow_table(rng, nr, thread_frac=0.2, lo=2, hi=40)[0], None, cuda)
    batch = tflush.batch_from_numpy(random_flush_batch(rng, n, 1, n_rows, nr, now, n - n // 16), cuda)
    fa_want = tflush.flow_admission_plain(stats, tt, batch, 8)
    # K10
    pb, dyn = random_param_case(np.random.default_rng(22), s=4096, pr=256)
    pa_batch, pa_dyn = tpt.param_batch_from_numpy(pb, cuda), tpt.param_state_from_numpy(dyn, cuda)
    pa_want = tpt.run_param_plain(_clone(pa_dyn), pa_batch, 4)
    # K6
    sc_stats, sc_batch, sc_live = _system_inputs(cuda, n, "mixed")
    sc_dev = tflush.SystemDevice(*system_edge_thresholds(n)[1])
    sc_want = tflush.system_check_plain(sc_stats, sc_dev, sc_batch, sc_live)
    # K8
    nd = 1 << 16
    bt_table, bt_dyn = random_degrade(rng, nd, now)
    bt_ddev, bt_ddyn = tdt.degrade_table_from_numpy(bt_table, cuda), tdt.degrade_state_from_numpy(bt_dyn, cuda)
    bt_args = (_t(rng.integers(-1, nd, (n, 1)).astype(np.int32), cuda),
               _t((now - rng.integers(-3000, 3000, n)).astype(np.int32), cuda), _t(rng.random(n) < 0.9, cuda))
    bt_want = tdt.breaker_try_pass_plain(bt_ddev, bt_ddyn, *bt_args)
    # K9
    sh_table, sh_dyn, sh_sb, sh_ppc, sh_prev = _shaping_case(np.random.default_rng(48), 16384, "scan")
    sh_tt, sh_td = flow_table_from_numpy(sh_table, sh_dyn, cuda)
    sh_args = (tsh.shaping_batch_from_numpy(sh_sb, cuda), _t(sh_ppc, cuda), _t(sh_prev, cuda), 1.0, 4)
    sh_want = tsh.run_shaping_plain(sh_tt, _clone(sh_td), *sh_args)
    # K15
    ms_plain, ms_call = _mesh_split_call(cuda, 65536, True)
    ms_want = ms_plain()
    torch.cuda.synchronize()

    got = {"td": [], "fa": [], "pa": [], "sc": [], "bt": [], "sh": [], "ms": []}
    start = threading.Barrier(7)
    errors = []

    def run(name, call):
        try:
            start.wait()
            for _ in range(iters):
                got[name].append(call())
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    def td():
        state = _clone(td_state)
        return tts.batch_decide(state, *td_args, 1000, atomic=False), state

    calls = {"td": td, "fa": lambda: tflush.flow_admission(stats, tt, batch, 8),
             "pa": lambda: tpt.run_param(_clone(pa_dyn), pa_batch, 4),
             "sc": lambda: tflush.system_check(sc_stats, sc_dev, sc_batch, sc_live),
             "bt": lambda: tdt.breaker_try_pass(bt_ddev, bt_ddyn, *bt_args),
             "sh": lambda: tsh.run_shaping(sh_tt, _clone(sh_td), *sh_args), "ms": ms_call}
    cuda_build._SCRATCH.clear()
    threads = [threading.Thread(target=run, args=item) for item in calls.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    assert not errors, errors
    for i, (out, state) in enumerate(got["td"]):
        _eq(td_want, out, f"K12 call {i}")
        _states_eq(td_plain, state, f"K12 call {i} state")
    for i, adm in enumerate(got["fa"]):
        for name, x, y in zip(fa_want._fields, fa_want, adm):
            _eq(x, y, f"K4 call {i} {name}")
    for i, (d, ok, wait) in enumerate(got["pa"]):
        _eq(pa_want[1], ok, f"K10 call {i} ok")
        _eq(pa_want[2], wait, f"K10 call {i} wait")
        _states_eq(pa_want[0], d, f"K10 call {i} state")
    for i, (ok, sys_type) in enumerate(got["sc"]):
        _eq(sc_want[0], ok, f"K6 call {i} ok")
        _eq(sc_want[1], sys_type, f"K6 call {i} sys_type")
    for i, (ok, probe) in enumerate(got["bt"]):
        _eq(bt_want[0], ok, f"K8 call {i} ok")
        _eq(bt_want[1], probe, f"K8 call {i} probe")
    for i, (d, ok, wait) in enumerate(got["sh"]):
        _eq(sh_want[1], ok, f"K9 call {i} ok")
        _eq(sh_want[2], wait, f"K9 call {i} wait")
        _states_eq(sh_want[0], d, f"K9 call {i} state")
    for i, keep in enumerate(got["ms"]):
        _eq(ms_want, keep, f"K15 call {i}")
    _assert_zeroed(cuda, "after the threads")
    assert fa_want.blk_weight is not None and bool((fa_want.blk_weight > 0).any())
    assert bool(bt_want[1].any())


# --- the sharded step: K13-K16 and K8's probe_allowed --------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_mesh_merge_stats_kernel(cuda, seed):
    rng = np.random.default_rng(seed + 200)
    now = 3_456_789
    old = random_stats(rng, 64, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    new = random_shard_stats(rng, old, now, 8, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    want = tici.merge_stats_across_plain(tnodes.stats_from_numpy(old, cuda), tnodes.stats_from_numpy(new, cuda))
    before = tici.merge_stats_across.launches
    got = tici.merge_stats_across(tnodes.stats_from_numpy(old, cuda), tnodes.stats_from_numpy(new, cuda))
    assert tici.merge_stats_across.launches == before + 1
    _states_eq(want, got, "merged")


@pytest.mark.parametrize("case", BREAKER_CASES)
def test_mesh_merge_breaker_kernel(cuda, case):
    rng = np.random.default_rng(BREAKER_CASES.index(case) + 210)
    now = 2**31 - 700  # now + retry_ms wraps
    dtable, ddyn = breaker_merge_table(rng, 64, now)
    base, new = shard_breaker_case(case, rng, dtable, ddyn, now, 8)
    ddev = tdt.degrade_table_from_numpy(dtable, cuda)
    want = tici.merge_breaker_plain(ddev, tdt.degrade_state_from_numpy(base, cuda), tdt.degrade_state_from_numpy(new, cuda), now)
    got = tici.merge_breaker(ddev, tdt.degrade_state_from_numpy(base, cuda), tdt.degrade_state_from_numpy(new, cuda), now)
    _states_eq(want, got, case)


@pytest.mark.parametrize("mode", ["grant_qps", "grant_thread", "grant_origin_split", "borrow"])
@pytest.mark.parametrize("n", [64, 16384])
def test_mesh_split_spend_kernel(cuda, mode, n):
    rng = np.random.default_rng(n + len(mode))
    k, n_rows, nr, now = 2, 64, 16, 3_456_000
    stats = tnodes.stats_from_numpy(borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG), cuda)
    table, _ = random_flow_table(rng, nr, thread_frac=1.0 if mode == "grant_thread" else 0.0, lo=2, hi=9)
    b = list(random_flush_batch(rng, n, k, n_rows, nr, now, n - 5))
    if mode == "grant_origin_split":
        b[6][:, 1] = b[6][:, 0]
        b[5][:, 1] = (b[5][:, 0] + 1) % (nr - 2)
    b[3] = rng.integers(1, 4, n).astype(np.int32)
    batch = tflush.batch_from_numpy(b, cuda)
    ft, _ = flow_table_from_numpy(table, None, cuda)
    live = torch.from_numpy(rng.random(n) < 0.85).to(cuda)
    occ = torch.from_numpy((rng.random((n, k)) < 0.5) & (b[5] >= 0)).to(cuda)
    grant = mode != "borrow"
    kw = dict(live=live) if grant else dict(occ_slot=occ)
    want = tici.mesh_split_spend_plain(8, stats, ft, batch, grant, **kw)
    got = tici.mesh_split_spend(8, stats, ft, batch, grant, **kw)
    _eq(want, got, mode)
    assert bool(want.any()) and not bool(want.all())


def _mesh_split_call(cuda, n, grant, k=2, seed=0):
    """(plain call, kernel call) of one demotion over 8 shards of n entries
    (K = 2) on 4,096 rows, Zipf(1.1) resources."""
    rng = np.random.default_rng(n + seed + (7 if grant else 0))
    n_rows, nr, now = 4096, 64, 3_456_000
    stats = tnodes.stats_from_numpy(borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG), cuda)
    table, _ = random_flow_table(rng, nr, thread_frac=0.3, lo=2, hi=60)
    b = list(random_flush_batch(rng, n, k, n_rows, nr, now, n - n // 8))
    res = np.minimum(rng.zipf(1.1, n), n_rows // 2 - 1).astype(np.int32)
    b[6][:, 0] = res
    b[3] = rng.integers(1, 4, n).astype(np.int32)
    batch = tflush.batch_from_numpy(b, cuda)
    ft, _ = flow_table_from_numpy(table, None, cuda)
    kw = (dict(live=_t(rng.random(n) < 0.85, cuda)) if grant
          else dict(occ_slot=_t((rng.random((n, k)) < 0.5) & (b[5] >= 0), cuda)))
    return (lambda: tici.mesh_split_spend_plain(8, stats, ft, batch, grant, **kw),
            lambda: tici.mesh_split_spend(8, stats, ft, batch, grant, **kw))


@pytest.mark.parametrize("grant", [True, False], ids=["grant", "borrow"])
@pytest.mark.parametrize("size", ["8_slots", "threshold", "threshold+8", "131072_slots"])
def test_mesh_split_routes_kernel(cuda, size, grant):
    """K15 on both routes (one block up to MESH_SPLIT_SMALL_MAX slots; prep,
    CUB's sort, the per-shard look-back decisions and the demand's reset
    above) against the plain version, K = 2 over 8 shards; the zeroed
    scratch reads zero after the call. One launch counted per call."""
    half = tici.MESH_SPLIT_SMALL_MAX // 2
    n = {"8_slots": 4, "threshold": half, "threshold+8": half + 4, "131072_slots": 65536}[size]
    plain, kernel = _mesh_split_call(cuda, n, grant)
    want = plain()
    before = tici.mesh_split_spend.launches
    got = kernel()
    assert tici.mesh_split_spend.launches == before + 1
    _eq(want, got, f"n={n}")
    _assert_zeroed(cuda, f"K15 n={n}")
    if n >= 512:
        assert bool(want.any()) and not bool(want.all())


@pytest.mark.parametrize("nk", [2048, 4096, 8192])
def test_mesh_split_forced_routes_kernel(cuda, monkeypatch, nk):
    """K15 at the sizes where the route is chosen, through each route in
    turn (the one-block route at its capacity of 8,192 slots)."""
    for grant in (True, False):
        plain, kernel = _mesh_split_call(cuda, nk // 2, grant, seed=1)
        want = plain()
        for small_max in (8192, 0):
            monkeypatch.setattr(tici, "MESH_SPLIT_SMALL_MAX", small_max)
            _eq(want, kernel(), f"nk={nk} grant={grant} small_max={small_max}")
            _assert_zeroed(cuda, f"K15 nk={nk}")


@pytest.mark.parametrize("small_max", [8192, 0], ids=["one_block", "many_blocks"])
@pytest.mark.parametrize("grant", [True, False], ids=["grant", "borrow"])
@pytest.mark.parametrize("case", BUDGET_WRAP_CASES)
def test_mesh_split_past_2_31_kernel(cuda, monkeypatch, case, grant, small_max):
    """K15 where the shards' units pass 2**31 (the cases the CPU tests hold
    the plain version to JAX's per-chip prefix with): equal to the plain
    version on both routes."""
    monkeypatch.setattr(tici, "MESH_SPLIT_SMALL_MAX", small_max)
    stats, table, b, _ = budget_wrap_case(case)
    batch = tflush.batch_from_numpy(b, cuda)
    ft, _ = flow_table_from_numpy(table, None, cuda)
    ts = tnodes.stats_from_numpy(stats, cuda)
    kw = (dict(live=torch.ones(b[1].shape[0], dtype=torch.bool, device=cuda)) if grant
          else dict(occ_slot=torch.ones(tuple(b[5].shape), dtype=torch.bool, device=cuda)))
    want = tici.mesh_split_spend_plain(8, ts, ft, batch, grant, **kw)
    _eq(want, tici.mesh_split_spend(8, ts, ft, batch, grant, **kw), f"{case} grant={grant}")
    _assert_zeroed(cuda, case)
    assert bool(want.any()) and not bool(want.all())


@pytest.mark.parametrize("short", ["workspace", "sort"])
def test_mesh_split_refusals_kernel(cuda, monkeypatch, short):
    """A K15 call the C side refuses on the many-block route leaves the
    zeroed scratch zero: "workspace", too few bytes for the keys (nothing
    launched, -1); "sort", too few for CUB's storage, refused after
    ms_prep has added the demand into the zeroed cells. A call after it
    equals the plain version. The short sizes come from the call's own
    need (mesh_split_workspace), not from the shared scratch buffer, which
    earlier calls may have grown past it."""
    plain, kernel = _mesh_split_call(cuda, 65536, True)
    nk = 2 * 65536
    lib = tici._mb2_lib()

    class Short:
        def __getattr__(self, name):
            return getattr(lib, name)

        def mesh_split(self, a, buf, size, st):
            need = lib.mesh_split_workspace(a)  # CUB's storage last: its alternate keys alone take 8 nk
            return lib.mesh_split(a, buf, 8 * nk if short == "workspace" else need - 8 * nk, st)

    monkeypatch.setattr(tici, "_mb2_lib", Short)
    with pytest.raises(RuntimeError, match="CUDA error -1$" if short == "workspace" else r"CUDA error [1-9]\d*$"):
        kernel()
    _assert_zeroed(cuda, f"after the refused call ({short})")
    monkeypatch.undo()
    _eq(plain(), kernel(), "after the refused call")
    _assert_zeroed(cuda, "after the call that follows")


def _charge_inputs(cuda, s, case="random"):
    """K16's inputs: s items (90% valid) of entries in order, one to a few
    items each, on 64 rows of a 256-row second window, ts over 900 ms,
    changed for ``case`` (torch_parity.shaping_charge_case)."""
    rng = np.random.default_rng(s)
    n_rows, now = 256, 3_456_000
    stats = tnodes.stats_from_numpy(borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG), cuda)
    eidx = np.sort(rng.integers(0, s, s)).astype(np.int32)
    sb = (rng.random(s) < 0.9, rng.integers(0, 8, s).astype(np.int32), rng.integers(0, n_rows // 4, s).astype(np.int32),
          eidx, (eidx * 2).astype(np.int32), (now - rng.integers(0, 900, s)).astype(np.int32),
          rng.integers(1, 4, s).astype(np.int32))
    return stats.second, tsh.shaping_batch_from_numpy(shaping_charge_case(case, sb), cuda), now


@pytest.mark.parametrize("case", SHAPING_CHARGE_CASES)
@pytest.mark.parametrize("s", [1, 8, 64, 1023, 1024, 1025, 16384])
def test_mesh_shaping_charge_kernel(cuda, s, case):
    """K16 against its plain version on both sides of the one-block route's
    1,024 items and at 16,384, on every edge of shaping_charge_case; one
    launch a call."""
    second, shaping, now = _charge_inputs(cuda, s, case)
    want = tici.mesh_shaping_charge_plain(second, shaping, now)
    before = tici.mesh_shaping_charge.launches
    _eq(want, tici.mesh_shaping_charge(second, shaping, now), f"ppc s={s} {case}")
    assert tici.mesh_shaping_charge.launches == before + 1


@pytest.mark.parametrize("small_max", [8192, 0], ids=["one_block", "many_blocks"])
@pytest.mark.parametrize("s", [8, 2048, 8192])
def test_mesh_shaping_charge_routes_kernel(cuda, monkeypatch, s, small_max):
    """Each route forced at sizes the default sends to the other."""
    monkeypatch.setattr(tici, "MESH_CHARGE_SMALL_MAX", small_max)
    for case in ("random", "past_2_31"):
        second, shaping, now = _charge_inputs(cuda, s, case)
        _eq(tici.mesh_shaping_charge_plain(second, shaping, now), tici.mesh_shaping_charge(second, shaping, now),
            f"ppc s={s} small_max={small_max} {case}")


def test_mesh_shaping_charge_refusal_kernel(cuda, monkeypatch):
    """A K16 call whose workspace cannot hold the keys raises (-1) with
    nothing launched; the call after it equals the plain version."""
    second, shaping, now = _charge_inputs(cuda, 16384)
    lib = tici._mb2_lib()

    class Short:
        def __getattr__(self, name):
            return getattr(lib, name)

        def mesh_charge(self, a, buf, size, st):
            return lib.mesh_charge(a, buf, 1024, st)  # below the keys' 128 KB

    monkeypatch.setattr(tici, "_mb2_lib", Short)
    before = tici.mesh_shaping_charge.launches
    with pytest.raises(RuntimeError, match="CUDA error -1$"):
        tici.mesh_shaping_charge(second, shaping, now)
    assert tici.mesh_shaping_charge.launches == before
    monkeypatch.undo()
    _eq(tici.mesh_shaping_charge_plain(second, shaping, now), tici.mesh_shaping_charge(second, shaping, now),
        "after the refused call")


def test_breaker_try_pass_probe_allowed_kernel(cuda):
    rng = np.random.default_rng(220)
    nd, n, kd, now = 64, 4096, 2, 5000
    dtable, ddyn = random_degrade(rng, nd, now)
    ddev, dyn = tdt.degrade_table_from_numpy(dtable, cuda), tdt.degrade_state_from_numpy(ddyn, cuda)
    dgid = torch.from_numpy(rng.integers(-1, nd, (n, kd)).astype(np.int32)).to(cuda)
    ts = torch.from_numpy((now - rng.integers(-2000, 2000, n)).astype(np.int32)).to(cuda)
    live = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    allowed = torch.from_numpy(rng.random(nd) < 0.5).to(cuda)
    want = tdt.breaker_try_pass_plain(ddev, dyn, dgid, ts, live, allowed)
    got = tdt.breaker_try_pass(ddev, dyn, dgid, ts, live, allowed)
    _eq(want[0], got[0], "ok")
    _eq(want[1], got[1], "probe")
    free = tdt.breaker_try_pass(ddev, dyn, dgid, ts, live)
    assert int(free[1].sum()) > int(got[1].sum()) > 0


@pytest.mark.parametrize("with_shaping,with_param", [(False, False), (True, True)])
def test_sharded_step_kernels(cuda, with_shaping, with_param):
    """The sharded step through the kernels on the card against the plain
    versions on the CPU, three flushes: results and every state tensor
    equal."""
    rng = np.random.default_rng(230 + with_shaping)
    n_rows, nr, nd, n, k, kd, m, pr = 64, 16, 16, 256, 2, 2, 64, 32
    now = 3_456_000
    arrs = borrowable_stats(rng, n_rows, now, tnodes.SECOND_CFG, tnodes.MINUTE_CFG)
    table, dyn = random_shaped_flow_table(rng, nr)
    dtable, ddyn = random_degrade(rng, nd, now)
    pdyn = random_param_state(rng, pr, now)
    sys_vals = system_thresholds("all")
    devs = {"plain": torch.device("cpu"), "kernel": cuda}
    states, steps = {}, {}
    for route, dev in devs.items():
        ft, fd = flow_table_from_numpy(table, dyn, dev)
        states[route] = [tnodes.stats_from_numpy(arrs, dev), ft, fd, tdt.degrade_table_from_numpy(dtable, dev),
                         tdt.degrade_state_from_numpy(ddyn, dev), tpt.param_state_from_numpy(pdyn, dev),
                         tflush.SystemDevice(*sys_vals)]
        steps[route] = make_sharded_flush(make_mesh(8, dev), 1000, with_shaping, with_param)
    for i in range(3):
        b = random_chain_batch(rng, n, k, kd, n_rows, nr, nd, now + 450 * i, m)
        sb = shaping_batch_for(b, table) if with_shaping else None
        pb = random_param_batch_for(rng, b, pr) if with_param else None
        outs = {}
        for route, dev in devs.items():
            extra = [x for x in (None if sb is None else tsh.shaping_batch_from_numpy(sb, dev),
                                 None if pb is None else tpt.param_batch_from_numpy(pb, dev)) if x is not None]
            st_ = states[route]
            out = steps[route](*st_, tflush.batch_from_numpy(b, dev), *extra)
            st_[0], st_[2], st_[4], st_[5] = out[0], out[1], out[2], out[3]
            outs[route] = out
        for name in tflush.FlushResult._fields[:9]:
            _eq(getattr(outs["plain"][4], name), getattr(outs["kernel"][4], name), f"flush {i} {name}")
        _states_eq(outs["plain"][0], outs["kernel"][0], f"flush {i} stats")
        for j, what in ((1, "pacers"), (2, "breakers"), (3, "param state")):
            _states_eq(outs["plain"][j], outs["kernel"][j], f"flush {i} {what}")


# --- the slot chain's verdict tail and K5 (the borrow commit) -----------------

def _tail_call(cuda, n, rows="uniform", nulls=(True, True, True, True, "ddyn"), n_rows=1 << 16, seed=0, wrap=False,
               blocked=None):
    """(plain, kernel): the verdict tail at n entries (K = KD = 2, 64
    breakers, top-8 over n_rows rows) on one random case, each call on its
    own copy of the breaker states; ``nulls`` = (system, param, shaping,
    occupy, breakers "off"/"ddyn"/"no_ddyn") says which inputs are given.
    ``blocked``: (cluster rows, acquires) of the n entries, every entry
    valid and blocked by authority."""
    sys_, param, shape, occupy, breakers = nulls
    c = random_tail_case(np.random.default_rng(seed + n), n, 2, 2, 64, n_rows, rows, wrap)
    if blocked is not None:
        b = c["batch"]
        b[1], b[8], b[4] = np.ones(n, bool), np.zeros(n, bool), b[4].copy()
        b[4][:, 1], b[3] = blocked
    batch = tflush.batch_from_numpy(c["batch"], cuda)
    g = {name: _t(c[name], cuda) for name in c if name != "batch"}
    adm = tflush.Admission(g["flow_pass"][:, None].expand(n, 2).contiguous(), g["flow_pass"], None, None, None, None,
                           *((g["occupied"], g["occupy_wait"], g["occ_slot"], g["occ_target"]) if occupy else ()))
    dslot_ok, probe = (g["dslot_ok"], g["probe_slot"]) if breakers != "off" else (None, None)
    state = g["state"]

    def call(fn):
        def run():
            dd = tdt.DegradeDynState(*(state.clone() if i == 0 else None for i in range(5)))
            v = fn(batch, adm, g["sys_ok"] if sys_ else None, dslot_ok, probe, dd if breakers == "ddyn" else None,
                   n_rows, 8, g["param_ok"] if param else None, g["wait_param"] if param else None,
                   g["shape_wait"] if shape else None)
            return v, dd.state

        return run

    return call(tflush.slot_chain_verdict_plain), call(tflush.slot_chain_verdict)


def _route(monkeypatch, const, route, mod=tflush):
    if route != "default":
        monkeypatch.setattr(mod, const, 8192 if route == "one_block" else 0)


def _tail_sizes():
    t = tflush.CHAIN_VERDICT_SMALL_MAX
    return {"0": 0, "1": 1, "8": 8, "threshold-1": t - 1, "threshold": t, "threshold+1": t + 1}


@pytest.mark.parametrize("route", ["default", "one_block", "many_blocks"])
@pytest.mark.parametrize("rows", ["uniform", "zipf", "six_rows_wrap"])
@pytest.mark.parametrize("size", ["0", "1", "8", "threshold-1", "threshold", "threshold+1"])
def test_chain_verdict_routes_kernel(cuda, monkeypatch, size, rows, route):
    """The verdict tail with every stage's input given, on the route the
    threshold picks and on each route forced, at 0, 1, 8 and the threshold
    -1, +0, +1 entries: uniform and Zipf(1.1) cluster rows over 65,536, and
    six rows with acquires near 2^30 (the row sums wrap; top-8 over 6 rows).
    Equal to the plain version, the probe transitions too; one launch
    counted a call; the zeroed scratch reads zero after it."""
    n = _tail_sizes()[size]
    _route(monkeypatch, "CHAIN_VERDICT_SMALL_MAX", route)
    wrap = rows == "six_rows_wrap"
    plain, kernel = _tail_call(cuda, n, "zipf" if wrap else rows, n_rows=6 if wrap else 1 << 16, wrap=wrap)
    want = plain()
    before = tflush.slot_chain_verdict.launches
    got = kernel()
    assert tflush.slot_chain_verdict.launches == before + 1
    _states_eq(want[0], got[0], f"n={n} {rows} {route}")
    _eq(want[1], got[1], "breaker states")
    _assert_zeroed(cuda, f"n={n} {rows} {route}")
    if n > 8:
        assert bool(want[0].blk_weight[0] != 0)


@pytest.mark.parametrize("route", ["one_block", "many_blocks"])
@pytest.mark.parametrize("nulls", TAIL_NULLS, ids=lambda v: "-".join(str(x) for x in v))
def test_chain_verdict_null_inputs_kernel(cuda, monkeypatch, nulls, route):
    """Every combination of the tail's absent inputs (no system stage, no
    param stage, no shaping, no occupy, no breakers or breakers without the
    probe transitions) on both routes, at 3,000 entries."""
    _route(monkeypatch, "CHAIN_VERDICT_SMALL_MAX", route)
    plain, kernel = _tail_call(cuda, 3000, "zipf", nulls)
    want, got = plain(), kernel()
    _states_eq(want[0], got[0], str(nulls))
    _eq(want[1], got[1], "breaker states")
    _assert_zeroed(cuda, str(nulls))


@pytest.mark.parametrize("route", ["one_block", "many_blocks"])
@pytest.mark.parametrize("size", ["12", "threshold-1", "threshold", "threshold+1", "8192"])
@pytest.mark.parametrize("case", list(TIE_PATTERNS))
def test_chain_verdict_tie_cases_kernel(cuda, monkeypatch, case, size, route):
    """The top-K ties of tests/test_torch_chain_tail.py on each route, at
    12 entries (the pattern once), the threshold -1, +0, +1 and 8,192 (the
    pattern repeated over four groups of rows, 4,096 rows): touched rows of
    one weight rank by row, and a row whose wrapping sum comes back to 0
    after each copy of the pattern (an add that finds its low half zero
    is not its first) is listed once, among the untouched rows of weight
    0. Equal to the plain version; the zeroed scratch reads zero after."""
    n = {"12": 12, "8192": 8192, **_tail_sizes()}[size]
    _route(monkeypatch, "CHAIN_VERDICT_SMALL_MAX", route)
    plain, kernel = _tail_call(cuda, n, n_rows=1 << 12, blocked=tie_rows(case, n))
    want, got = plain(), kernel()
    _states_eq(want[0], got[0], f"{case} n={n} {route}")
    _eq(want[1], got[1], "breaker states")
    _assert_zeroed(cuda, f"{case} n={n} {route}")
    top = got[0].blk_rows.cpu().tolist()
    if case == "wrapped_zero_beside_untouched":
        assert top.count(3) == 1 and 0 in top, top
    else:
        assert len(set(top)) == 8, top


def _halves(n):
    """Cluster rows and acquires of n entries: lanes 0 and 1 of each of the
    first w warps (w odd: n // 32 or one fewer) on row 3 with 2**30 each,
    every other entry acquiring 0 (it touches no row). Each warp adds 2**31
    to row 3, so every second add finds the row's wrapping sum at 0, and
    the sum ends at -2**31."""
    rows, acq = (np.arange(n) % 1024).astype(np.int32), np.zeros(n, np.int32)
    w = n // 32 if (n // 32) % 2 else n // 32 - 1
    hit = (np.arange(w)[:, None] * 32 + np.arange(2)).ravel()
    rows[hit], acq[hit] = 3, 2**30
    return rows, acq


@pytest.mark.parametrize("route, n", [("one_block", 8192), ("many_blocks", 8192), ("default", 131072)])
def test_chain_verdict_first_touch_kernel(cuda, monkeypatch, route, n):
    """A row touched again and again while its wrapping sum is 0 (``_halves``)
    is listed once and ranks last at -2**31, below the untouched rows 0-2
    and 4-8 of weight 0. At 131,072 entries over 1,024 rows the many-block
    top-K reads the list in two rounds a thread: a row listed again at an
    add that found its sum at 0 would read its own zeroed cell in the
    second round and rank among the rows of weight 0. Equal to the plain
    version; the zeroed scratch reads zero after."""
    _route(monkeypatch, "CHAIN_VERDICT_SMALL_MAX", route)
    plain, kernel = _tail_call(cuda, n, n_rows=1 << 10, blocked=_halves(n))
    want, got = plain(), kernel()
    _states_eq(want[0], got[0], f"n={n} {route}")
    _eq(want[1], got[1], "breaker states")
    _assert_zeroed(cuda, f"n={n} {route}")
    assert got[0].blk_rows.cpu().tolist() == [0, 1, 2, 4, 5, 6, 7, 8]


def _borrow_call(cuda, nk, case="slab_kinds", n_rows=1 << 16, seed=0):
    """(plain, kernel): K5 at nk slots (K = 2) over an [n_rows, 2] slab, each
    call on its own copy of the slab; returns the slab."""
    now = 700_137
    (fpass, fws), borrows = random_borrow_case(np.random.default_rng(seed + nk), max(nk // 2, 0), 2, n_rows, now,
                                               case)
    occ, tgt, acq, crow = (_t(a, cuda) for a in borrows)
    slab = (_t(fpass, cuda), _t(fws, cuda))
    threads = torch.zeros(n_rows, dtype=torch.int32, device=cuda)

    def call(fn):
        def run():
            st = tnodes.StatsState(None, None, threads, slab[0].clone(), slab[1].clone())
            out = fn(st, occ, tgt, acq, crow)
            return out.future_pass, out.future_ws

        return run

    return call(tflush.commit_borrow_slab_plain), call(tflush.commit_borrow_slab)


def _borrow_sizes():
    t = tflush.COMMIT_BORROW_SMALL_MAX
    return {"0": 0, "2": 2, "8": 8, "threshold-2": t - 2, "threshold": t, "threshold+2": t + 2}


@pytest.mark.parametrize("route", ["default", "one_block", "many_blocks"])
@pytest.mark.parametrize("case", BORROW_SLAB_CASES)
@pytest.mark.parametrize("size", ["0", "2", "8", "threshold-2", "threshold", "threshold+2"])
def test_commit_borrow_routes_kernel(cuda, monkeypatch, size, case, route):
    """K5 on the route the threshold picks and on each route forced, at 0,
    2, 8 slots and the threshold -2, +0, +2 (K = 2): one cell hit by borrows
    of three windows, acquires whose cell sums wrap past 2^31, slab cells
    empty, older, equal and newer on uniform and on Zipf(1.1) rows. Equal
    to the plain version; one launch counted a call; the zeroed scratch
    reads zero after it."""
    nk = _borrow_sizes()[size]
    _route(monkeypatch, "COMMIT_BORROW_SMALL_MAX", route)
    plain, kernel = _borrow_call(cuda, nk, case)
    want = plain()
    before = tflush.commit_borrow_slab.launches
    got = kernel()
    assert tflush.commit_borrow_slab.launches == before + (1 if nk else 0)
    _eq(want[0], got[0], f"future_pass nk={nk} {case} {route}")
    _eq(want[1], got[1], f"future_ws nk={nk} {case} {route}")
    _assert_zeroed(cuda, f"nk={nk} {case} {route}")


@pytest.mark.parametrize("which", ["slot_chain_verdict", "commit_borrow_slab"])
def test_tail_and_commit_refusals_kernel(cuda, monkeypatch, which):
    """A many-block call that the C side refuses for too few zeroed bytes
    (-1, nothing launched) leaves the zeroed scratch zero, and the call
    after it equals the plain version."""
    if which == "slot_chain_verdict":
        plain, kernel = _tail_call(cuda, 65536)
        lib, entry, getter = tflush._fa_lib(), "chain_verdict", "_fa_lib"
    else:
        plain, kernel = _borrow_call(cuda, 65536, "zipf")
        lib, entry, getter = tflush._cb_lib(), "commit_borrow", "_cb_lib"
    kernel()  # the zeroed buffer is grown

    class Short:
        def __getattr__(self, name):
            return getattr(lib, name)

    setattr(Short, entry, staticmethod(lambda a, zero, size, st: getattr(lib, entry)(a, zero, size - 8, st)))
    monkeypatch.setattr(tflush, getter, Short)
    with pytest.raises(RuntimeError, match="CUDA error -1$"):
        kernel()
    _assert_zeroed(cuda, f"after the refused call ({which})")
    monkeypatch.undo()
    _states_eq(plain(), kernel(), "after the refused call")
    _assert_zeroed(cuda, "after the call that follows")


@pytest.mark.parametrize("which", ["slot_chain_verdict", "commit_borrow_slab"])
def test_tail_and_commit_launch_sequences_kernel(cuda, which):
    """torch.profiler: at 8 entries (16 slots) one kernel and no memset a
    call; at 131,072 entries the tail takes at most 2 kernels, K5 at most 3
    (no sort), neither a memset."""
    from gpu_timing import device_profile, kernel_times

    if which == "slot_chain_verdict":
        small, full, most = _tail_call(cuda, 8)[1], _tail_call(cuda, 131072)[1], 2
    else:
        small, full, most = _borrow_call(cuda, 16)[1], _borrow_call(cuda, 262144, "zipf")[1], 3
    full()  # the zeroed buffer is grown
    assert device_profile(small)[:2] == (1, 0)
    kernels, memsets, _ = device_profile(full)
    names = kernel_times(full)
    assert kernels <= most and memsets == 0, names
    assert not any("Sort" in name for name in names), names


def test_tail_and_commit_threads_kernel(cuda):
    """The tail (131,072 entries, top-8) and K5 (262,144 slots) in two host
    threads on the default stream, 20 calls each, both on their many-block
    routes over the shared zeroed scratch, which starts empty: every call
    equals its plain version, and the buffer reads zero at the end."""
    import threading

    from sentinel_tpu_torch.utils import cuda_build

    tail_plain, tail = _tail_call(cuda, 131072, "zipf")
    cb_plain, cb = _borrow_call(cuda, 262144, "zipf")
    want = {"tail": tail_plain(), "cb": cb_plain()}
    torch.cuda.synchronize()
    got = {"tail": [], "cb": []}
    start = threading.Barrier(2)
    errors = []

    def run(name, call):
        try:
            start.wait()
            for _ in range(20):
                got[name].append(call())
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    cuda_build._SCRATCH.clear()
    threads = [threading.Thread(target=run, args=item) for item in (("tail", tail), ("cb", cb))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    assert not errors, errors
    for name, outs in got.items():
        for i, out in enumerate(outs):
            _states_eq(want[name], out, f"{name} call {i}")
    _assert_zeroed(cuda, "after the threads")


# --- K7 and K11 redesigned: routes, edges, the zeroed scratch ----------------


def _exits_call(cuda, m, skew="uniform", nd=1 << 16, seed=0):
    """(plain, kernel): K7 at m exit slots over nd breakers, each call on its
    own copy of the state; returns the state. "uniform": random_exits (half
    the exits on breaker 1, ts ties, superseded windows); "zipf": Zipf(1.1)
    breakers; "kd2": two slots an exit."""
    rng = np.random.default_rng(seed + m)
    now = 700_137
    table, dyn = random_degrade(rng, nd, now)
    kd = 2 if skew == "kd2" else 1
    x = list(random_exits(rng, max(m // kd, 1), kd, nd, now))
    if skew == "zipf":
        x[0] = (np.minimum(rng.zipf(1.1, (m, 1)), nd - 3) - 1).astype(np.int32)
    ddev = tdt.degrade_table_from_numpy(table, cuda)
    dyn0 = tdt.degrade_state_from_numpy(dyn, cuda)
    xs = [_t(a, cuda) for a in x]

    def call(fn):
        return lambda: fn(ddev, _clone(dyn0), *xs)

    return call(tdt.breaker_on_exits_plain), call(tdt.breaker_on_exits)


def _exit_sizes():
    t = tdt.BREAKER_EXITS_SMALL_MAX
    return {"1": 1, "8": 8, "threshold-1": t - 1, "threshold": t, "threshold+1": t + 1, "32768": 32768}


@pytest.mark.parametrize("route", ["default", "one_block", "many_blocks"])
@pytest.mark.parametrize("skew", ["uniform", "zipf", "kd2"])
@pytest.mark.parametrize("size", ["1", "8", "threshold-1", "threshold", "threshold+1", "32768"])
def test_breaker_on_exits_routes_kernel(cuda, monkeypatch, size, skew, route):
    """K7 on the route the threshold picks and on each route forced, at 1
    and 8 slots, the threshold -1, +0, +1 and 32,768, on uniform, Zipf(1.1)
    and two-slot exits: equal to the plain version; one launch counted a
    call; the zeroed scratch reads zero after it."""
    m = _exit_sizes()[size]
    _route(monkeypatch, "BREAKER_EXITS_SMALL_MAX", route, tdt)
    plain, kernel = _exits_call(cuda, m, skew)
    want = plain()
    before = tdt.breaker_on_exits.launches
    got = kernel()
    assert tdt.breaker_on_exits.launches == before + 1
    _states_eq(want, got, f"breaker_on_exits m={m} {skew} {route}")
    _assert_zeroed(cuda, f"m={m} {skew} {route}")


@pytest.mark.parametrize("route", ["one_block", "many_blocks"])
@pytest.mark.parametrize("case", BREAKER_EXIT_CASES)
def test_breaker_on_exits_edges_kernel(cuda, monkeypatch, case, route):
    """The CPU tests' order and window edges (torch_parity.
    breaker_exit_case) at some 6,000 slots on the one-block route and some
    32,768 on the many-block one, copies of each case interleaved: equal to
    the plain version, the zeroed scratch zero after it."""
    per_copy = breaker_exit_case(case, 1)[2][0].shape[0]
    copies = max((6000 if route == "one_block" else 32768) // per_copy, 1)
    table, dyn, x = breaker_exit_case(case, copies, seed=5)
    _route(monkeypatch, "BREAKER_EXITS_SMALL_MAX", route, tdt)
    ddev = tdt.degrade_table_from_numpy(table, cuda)
    xs = [_t(a, cuda) for a in x]
    want = tdt.breaker_on_exits_plain(ddev, tdt.degrade_state_from_numpy(dyn, cuda), *xs)
    got = tdt.breaker_on_exits(ddev, tdt.degrade_state_from_numpy(dyn, cuda), *xs)
    _states_eq(want, got, f"{case} ({copies} copies, {route})")
    _assert_zeroed(cuda, f"{case} {route}")


def _fold_call(cuda, s, tier="default", decay=False, seed=0, case=None):
    """(plain, kernel): K11 on s keys, each call on its own copy of the
    state; returns the state. Tiers: "default" (depth 4, width 2,048, 64
    candidates) and "wide" (depth 8, width 2^16, 1,024), after two earlier
    folds; the batch Zipf(1.1) ids over a pool (duplicates), a tenth
    padding, some candidates. ``case``: torch_parity.sketch_edge_case's."""
    depth, width, c = (8, 1 << 16, 1024) if tier == "wide" else (4, 2048, 64)
    if case is not None:
        arrays = sketch_edge_case(case, depth, width, c, s, seed)
        state0 = tsk.sketch_state_from_numpy(arrays[:3], cuda)
        ids, w = arrays[3], arrays[4]
    else:
        rng = np.random.default_rng(seed + s)
        state0 = tsk.make_sketch_state(depth, width, c, cuda)
        pool = rng.choice(2**31 - 1, 4 * s + 4 * c, replace=False).astype(np.int32)
        for k in range(2):
            tsk.sketch_fold_plain(state0, tsk.SketchBatch(_t(pool[k * s:(k + 1) * s], cuda),
                                                          _t(rng.integers(1, 5, s).astype(np.int32), cuda)), k == 1)
        ids = pool[np.minimum(rng.zipf(1.1, s), 2 * s) - 1 + 2 * s * (rng.random(s) >= 0.2)]
        cand = state0.cand_ids.cpu().numpy()
        ids[: min(c // 3, s)] = cand[: min(c // 3, s)]
        ids[rng.random(s) < 0.1] = -1
        w = rng.integers(1, 5, s).astype(np.int32)
    sk = tsk.SketchBatch(_t(np.asarray(ids, np.int32), cuda), _t(np.asarray(w, np.int32), cuda))

    def call(fn):
        return lambda: fn(_clone(state0), sk, decay)

    return call(tsk.sketch_fold_plain), call(tsk.sketch_fold)


def _fold_sizes():
    t = tsk.SKETCH_FOLD_SMALL_MAX
    return {"1": 1, "8": 8, "threshold-1": t - 1, "threshold": t, "threshold+1": t + 1, "131072": 1 << 17}


@pytest.mark.parametrize("route", ["default", "one_block", "many_blocks"])
@pytest.mark.parametrize("decay", [False, True])
@pytest.mark.parametrize("tier", ["default", "wide"])
@pytest.mark.parametrize("size", ["1", "8", "threshold-1", "threshold", "threshold+1", "131072"])
def test_sketch_fold_routes_kernel(cuda, monkeypatch, size, tier, decay, route):
    """K11 on the route the threshold picks and on each route forced, at 1
    and 8 keys, the threshold -1, +0, +1 and 131,072, on two tiers, without
    and with decay: equal to the plain version; one launch counted a call;
    the zeroed scratch reads zero after it."""
    s = _fold_sizes()[size]
    _route(monkeypatch, "SKETCH_FOLD_SMALL_MAX", route, tsk)
    plain, kernel = _fold_call(cuda, s, tier, decay)
    want = plain()
    before = tsk.sketch_fold.launches
    got = kernel()
    assert tsk.sketch_fold.launches == before + 1
    _states_eq(want, got, f"sketch_fold s={s} {tier} decay={decay} {route}")
    _assert_zeroed(cuda, f"s={s} {tier} decay={decay} {route}")


@pytest.mark.parametrize("decay", [False, True])
@pytest.mark.parametrize("route", ["one_block", "many_blocks", "many_blocks_wide"])
@pytest.mark.parametrize("case", SKETCH_EDGE_CASES)
def test_sketch_fold_edges_kernel(cuda, monkeypatch, case, route, decay):
    """The CPU tests' key edges (torch_parity.sketch_edge_case) at 2,048 keys
    on the one-block route, at 131,072 keys on the many-block one, on the
    default tier (64 candidates, the count-min summed per block first) and
    on a wide one (depth 8, width 2^16, 1,024 candidates): equal to the
    plain version, the zeroed scratch zero after it."""
    _route(monkeypatch, "SKETCH_FOLD_SMALL_MAX", route.removesuffix("_wide"), tsk)
    s = 2048 if route == "one_block" else 1 << 17
    tier = "wide" if route.endswith("wide") else "default"
    plain, kernel = _fold_call(cuda, s, tier, decay, seed=3, case=case)
    _states_eq(plain(), kernel(), f"{case} {route} decay={decay}")
    _assert_zeroed(cuda, f"{case} {route}")


@pytest.mark.parametrize("which", ["breaker_on_exits", "sketch_fold"])
def test_exits_and_sketch_refusals_kernel(cuda, monkeypatch, which):
    """A call that the C side refuses for too few zeroed bytes (-1, nothing
    launched) leaves the zeroed scratch zero, and the call after it equals
    the plain version; on both routes of K7 and the many-block route of
    K11 (its one block takes no zeroed bytes)."""
    for route in ("one_block", "many_blocks"):
        _route(monkeypatch, "BREAKER_EXITS_SMALL_MAX" if which == "breaker_on_exits" else "SKETCH_FOLD_SMALL_MAX",
               route, tdt if which == "breaker_on_exits" else tsk)
        if which == "breaker_on_exits":
            plain, kernel = _exits_call(cuda, 32768 if route == "many_blocks" else 4096, "zipf")
            lib, mod, getter = tdt._lib("breaker_on_exits", tdt._setup_exits), tdt, "_lib"
            entry = "breaker_on_exits"
        else:
            plain, kernel = _fold_call(cuda, 1 << 17 if route == "many_blocks" else 2048, "wide")
            lib, mod, getter = tsk._sf_lib(), tsk, "_sf_lib"
            entry = "sketch_fold"
        kernel()  # the zeroed buffer is grown
        if route == "one_block" and which == "sketch_fold":
            continue  # the one-block fold takes no zeroed bytes
        class Short:
            def __getattr__(self, name):
                return getattr(lib, name)

        setattr(Short, entry, staticmethod(
            lambda a, buf, size, zero, zb, st: getattr(lib, entry)(a, buf, size, zero, zb - 8, st)))
        saved = getattr(mod, getter)
        monkeypatch.setattr(mod, getter, (lambda *_: Short()) if which == "breaker_on_exits" else Short)
        with pytest.raises(RuntimeError, match="CUDA error -1$"):
            kernel()
        _assert_zeroed(cuda, f"after the refused call ({which}, {route})")
        monkeypatch.setattr(mod, getter, saved)
        _states_eq(plain(), kernel(), f"after the refused call ({route})")
        _assert_zeroed(cuda, f"after the call that follows ({route})")


@pytest.mark.parametrize("which", ["breaker_on_exits", "sketch_fold", "sketch_fold_decay"])
def test_exits_and_sketch_launch_sequences_kernel(cuda, which):
    """torch.profiler: K7 at 32,768 exits takes CUB's radix-sort kernels
    and at most 3 of its own; K11 at 131,072 keys at most 2 kernels, 3 with
    decay, and no memset, no sort."""
    from gpu_timing import device_profile, kernel_times

    if which == "breaker_on_exits":
        full = _exits_call(cuda, 32768, "zipf", nd=1 << 20)[1]
    else:
        full = _fold_call(cuda, 1 << 17, "default", which.endswith("decay"))[1]
    full()  # the zeroed buffer is grown
    kernels, memsets, _ = device_profile(full)
    names = kernel_times(full)
    own = [n for n in names if n.startswith(("bo_", "sf_"))]
    if which == "breaker_on_exits":
        assert len(own) <= 3, names
        assert all(n in own or "DeviceRadixSort" in n or n == "Memset" for n in names), names
    else:
        assert kernels == len(own) <= (3 if which.endswith("decay") else 2) and memsets == 0, names


def test_exits_and_sketch_threads_kernel(cuda):
    """K7 (32,768 Zipf exits) and K11 (131,072 keys, the wide tier, with
    decay) in two host threads on the default stream, 20 calls each, both
    on their many-block routes over the shared zeroed scratch, which starts
    empty: every call equals its plain version, and the buffer reads zero
    at the end."""
    import threading

    from sentinel_tpu_torch.utils import cuda_build

    bo_plain, bo = _exits_call(cuda, 32768, "zipf")
    sf_plain, sf = _fold_call(cuda, 1 << 17, "wide", True)
    want = {"bo": bo_plain(), "sf": sf_plain()}
    torch.cuda.synchronize()
    got = {"bo": [], "sf": []}
    start = threading.Barrier(2)
    errors = []

    def run(name, call):
        try:
            start.wait()
            for _ in range(20):
                got[name].append(call())
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    cuda_build._SCRATCH.clear()
    threads = [threading.Thread(target=run, args=item) for item in (("bo", bo), ("sf", sf))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    assert not errors, errors
    for name, outs in got.items():
        for i, out in enumerate(outs):
            _states_eq(want[name], out, f"{name} call {i}")
    _assert_zeroed(cuda, "after the threads")


# --- the engine's host pipeline on the card ----------------------------------


def _pipeline_stream(eng, st_mod, step, rng, groups, singles):
    """One round of a DEFAULT + hot-parameter stream (flow-limited bulk, a
    param bulk with two timestamps, singles with args, bulk exits), the
    same calls on every engine given the same ``rng`` state."""
    t = 1000 + 170 * step
    eng.clock.set_ms(t)
    ts = np.sort(t + rng.integers(0, 40, 64)).astype(np.int32)
    acq = rng.integers(1, 3, 64).astype(np.int32)
    vals = [(f"v{int(v)}",) for v in rng.integers(0, 5, 48)]
    ts_q = np.where(np.arange(48) < 30, t, t + 600).astype(np.int32)
    groups.append(eng.submit_bulk("pp", 64, ts=ts, acquire=acq))
    groups.append(eng.submit_bulk("qq", 48, ts=ts_q, args_column=vals))
    singles.extend(eng.submit_entry("qq", ts=int(t + d), args=(f"v{int(v)}",))
                   for d, v in zip(rng.integers(0, 50, 6), rng.integers(0, 5, 6)))
    c = st_mod.constants
    rows = eng.resolve_entry_rows("pp", c.CONTEXT_DEFAULT_NAME, "", c.EntryType.OUT)
    eng.submit_exit_bulk(rows, 8, rt=10, ts=np.full(8, t, np.int32))


def _pipeline_engine(device, depth):
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.utils.clock import ManualClock

    eng = Engine(clock=ManualClock(0), device=device)
    eng.pipeline_depth = depth
    eng.set_flow_rules([st.FlowRule("pp", count=20), st.FlowRule("qq", count=1e9)])
    eng.set_param_rules({"qq": [st.ParamFlowRule("qq", param_idx=0, count=4)]})
    return eng


def test_engine_depth2_with_pending_work_matches_cpu(cuda):
    """A depth-2 stream on the card, a torch.cuda._sleep spin queued on the
    engine's stream before each flush, so that the copies and kernels of
    earlier flushes are still pending while the next encode reuses pooled
    staging: verdicts and final state equal the CPU engine's at depth 0."""
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.metrics.nodes import stats_to_numpy

    out = {}
    for name, device, depth in (("cpu", "cpu", 0), ("card", cuda, 2)):
        eng = _pipeline_engine(device, depth)
        rng = np.random.default_rng(3)
        groups, singles = [], []
        for step in range(12):
            _pipeline_stream(eng, st, step, rng, groups, singles)
            if device != "cpu":
                with torch.cuda.stream(eng._stream):
                    torch.cuda._sleep(20_000_000)  # ~10 ms of device time
            eng.flush()
            if device != "cpu":
                assert len(eng._pending_fetches) == min(step + 1, 2)
        eng.drain()
        if device != "cpu":
            assert eng._arena.hits > 0, "no staging set was reused"
        out[name] = ([(g.admitted.copy(), g.reason.copy(), g.wait_ms.copy()) for g in groups],
                     [(o.verdict.admitted, o.verdict.reason, o.verdict.wait_ms) for o in singles],
                     stats_to_numpy(eng.stats), eng.last_blocked_topk)
    (cg, cs, cstats, ctop), (gg, gs, gstats, gtop) = out["cpu"], out["card"]
    for i, (a, b) in enumerate(zip(cg, gg)):
        for x, y in zip(a, b):
            assert np.array_equal(x, y), f"group {i}"
    assert cs == gs
    for name in cstats._fields:
        a, b = getattr(cstats, name), getattr(gstats, name)
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert np.array_equal(x, y), name
    assert all(np.array_equal(x, y) for x, y in zip(ctop, gtop))
    assert any(not a.all() for a, _, _ in cg), "the stream must block something"


def test_engine_auto_flush_while_caller_sets_a_side_stream(cuda):
    """The auto-flusher and a caller that flushes under a side stream of
    its own (queued busy with a spin) share one engine at depth 2: every
    dispatch runs on the engine's stream, so each flush sees the window
    counts of the one before. 240 same-window entries against count 50
    admit exactly 50."""
    import time

    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.utils.clock import ManualClock

    eng = Engine(clock=ManualClock(1000), device=cuda)
    eng.pipeline_depth = 2
    eng.set_flow_rules([st.FlowRule("af", count=50)])
    side = torch.cuda.Stream(cuda)
    assert side != eng._stream
    groups = []
    eng.start_auto_flush(interval_ms=1)
    try:
        with torch.cuda.stream(side):
            for i in range(24):
                torch.cuda._sleep(5_000_000)
                groups.append(eng.submit_bulk("af", 10, ts=1000))
                if i % 3 == 0:
                    eng.flush()
                time.sleep(0.001)
            assert torch.cuda.current_stream(cuda) == side
    finally:
        eng.stop_auto_flush()
    eng.flush()
    eng.drain()
    assert not eng.closed_dirty
    assert sum(g.admitted_count for g in groups) == 50
    stats = eng.cluster_node_stats("af")
    assert (stats["total_pass_minute"], stats["total_block_minute"]) == (50, 190)
