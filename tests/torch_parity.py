"""Shared helpers for the port's parity tests (tests/test_torch_*.py):
inputs made with numpy from a seed go through the JAX function and its
PyTorch counterpart, and every output must agree bit for bit."""

from types import SimpleNamespace

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


def random_flush_batch(rng, n, k, n_rows, nr, now, n_valid, m=8, m_valid=0, near_max=False, one_row=False):
    """``one_row``: every entry on one resource (its ts out of entry
    order, a quarter of them equal)."""
    e_valid = np.zeros(n, bool)
    e_valid[:n_valid] = True
    span = 40 if near_max else 900
    e_ts = (now - rng.integers(0, span, n)).astype(np.int32)
    e_ts[: n // 4] = e_ts[0]  # equal ts on the hot row
    e_acq = rng.integers(1, 3, n).astype(np.int32)
    res = rng.integers(1, n_rows // 2, n)
    res[: n // 4] = res[0]
    if one_row:
        res[:] = res[0]
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


I32_MAX = 2**31 - 1
WS_FLOOR = -(10**9)


def random_degrade(rng, nd, now, near_max=False):
    """A breaker table and state as numpy arrays (the layouts of
    DegradeTableDevice and DegradeDynState): all three grades, the last
    three rules padding, rule 0 with min_request at the padding value,
    breakers CLOSED, OPEN (due and not) and HALF_OPEN, windows current,
    superseded and never started. ``near_max`` puts retry deadlines where
    ``ts + retry_ms`` wraps int32."""
    grade = rng.integers(0, 3, nd)
    thr = np.where(grade == 0, rng.integers(20, 120, nd),
                   np.where(grade == 1, rng.choice([0.0, 0.2, 0.5, 0.9, 1.0], nd), rng.integers(0, 6, nd)))
    slow = rng.choice([0.0, 0.3, 0.5, 1.0], nd)
    min_req = rng.integers(1, 6, nd)
    min_req[0] = I32_MAX
    interval = rng.choice([333, 500, 1000, 2000], nd)
    retry = rng.choice([1000, 5000], nd)
    max_rt = np.where(grade == 0, np.floor(thr + 0.5), I32_MAX)
    pad = slice(nd - 3, nd)
    grade[pad], thr[pad], slow[pad], min_req[pad] = 0, INF, 1.0, I32_MAX
    interval[pad], retry[pad], max_rt[pad] = 1000, 0, I32_MAX
    table = (grade.astype(np.int32), thr.astype(np.float32), slow.astype(np.float32), min_req.astype(np.int32),
             interval.astype(np.int32), retry.astype(np.int32), max_rt.astype(np.int32))
    state = rng.integers(0, 3, nd)
    state[pad] = 0
    if near_max:
        next_retry = np.where(rng.random(nd) < 0.5, I32_MAX - rng.integers(0, 50, nd), now - rng.integers(0, 500, nd))
    else:
        next_retry = now + rng.integers(-3000, 3000, nd)
    bad = rng.integers(0, 6, nd)
    total = bad + rng.integers(0, 6, nd)
    ws = now - now % interval - rng.integers(0, 3, nd) * interval
    ws = np.where(rng.random(nd) < 0.2, WS_FLOOR, ws)
    dyn = tuple(np.asarray(a, dtype=np.int32) for a in (state, next_retry, bad, total, ws))
    return table, dyn


def random_exits(rng, m, kd, nd, now, span=2500):
    """Exit columns (x_dgid, x_ts, x_rt, x_err, x_valid): one hot breaker
    takes half the exits, (gid, ts) ties, exits from superseded windows,
    errors on about 30%."""
    dgid = np.full((m, kd), -1, np.int32)
    dgid[:, 0] = np.where(rng.random(m) < 0.5, 1, rng.integers(0, nd - 3, m))
    if kd > 1:
        dgid[:, 1] = np.where(rng.random(m) < 0.5, rng.integers(0, nd, m), -1)
    ts = (now - rng.integers(0, span, m)).astype(np.int32)
    ts[: m // 4] = ts[0]
    rt = rng.integers(0, 200, m).astype(np.int32)
    err = (rng.random(m) < 0.3).astype(np.int32)
    valid = rng.random(m) < 0.9
    return dgid, ts, rt, err, valid


def system_thresholds(case):
    """(qps, max_thread, max_rt, load threshold, cpu threshold, cur load,
    cur cpu) of a SystemDevice; "all" makes every dimension block some
    entries at once."""
    inf = float("inf")
    return {
        "all": (40.0, 9.0, 10.0, 1.0, 0.5, 5.0, 0.9),
        "qps_thread_load_cpu": (40.0, 9.0, inf, 1.0, 0.5, 5.0, 0.9),
        "load_cpu": (inf, inf, inf, 1.0, 0.5, 5.0, 0.9),
        "cpu": (inf, inf, inf, -1.0, 0.5, -1.0, 0.9),
        "off": (inf, inf, inf, -1.0, -1.0, -1.0, -1.0),
    }[case]


def borrowable_stats(rng, n_rows, now, second_cfg, minute_cfg):
    """Random stats where borrows can fit: the window expiring next holds
    most of the pass, the current one little, and the slab a few future
    tokens, matured cells and empty ones."""
    second, minute, threads, fpass, fws = random_stats(rng, n_rows, now, second_cfg, minute_cfg)
    counts, min_rt, ws = (a.copy() for a in second)
    wlen = second_cfg.window_len_ms
    cur = now - now % wlen
    idx = (cur // wlen) % 2
    ws[:, idx], ws[:, 1 - idx] = cur, cur - wlen
    ws[: n_rows // 4, 1 - idx] = cur - 3 * wlen  # a superseded expiring bucket
    counts[:, idx, 0] = rng.integers(0, 2, n_rows)
    counts[:, 1 - idx, 0] = rng.integers(0, 12, n_rows)
    fpass = np.where(rng.random(fpass.shape) < 0.3, fpass % 3, 0).astype(np.int32)
    return ((counts, min_rt, ws), minute, threads, fpass, fws)


def random_chain_batch(rng, n, k, kd, n_rows, nr, nd, now, m):
    """A batch for the whole slot chain: prioritized entries, breaker ids
    on entries (one hot breaker) and on exits, inbound entries."""
    b = list(random_flush_batch(rng, n, k, n_rows, nr, now, n - 4, m=m, m_valid=m - 2))
    b[7] = rng.random(n) < 0.4  # e_prio
    e_dgid = np.full((n, kd), -1, np.int32)
    e_dgid[:, 0] = np.where(rng.random(n) < 0.7, rng.integers(0, nd - 3, n), -1)
    e_dgid[: n // 4, 0] = 1  # a hot breaker
    b[10] = e_dgid
    x_dgid, x_ts, x_rt, x_err, _ = random_exits(rng, m, kd, nd, now, span=600)
    b[12], b[15], b[16], b[18] = x_ts, x_rt, x_err, x_dgid
    return b


def _run_jax(scenario):
    import sentinel_tpu as jst
    from sentinel_tpu.core import api
    from sentinel_tpu.models import constants
    from sentinel_tpu.utils import clock as jclock
    from sentinel_tpu.utils.config import config
    from sentinel_tpu.utils.system_status import sampler

    clock = jclock.ManualClock(start_ms=0)
    prev = jclock.set_default_clock(clock)
    api.reset(clock=clock)
    try:
        return scenario(SimpleNamespace(st=jst, api=api, clock=clock, engine=api.get_engine(), config=config,
                             sampler=sampler, C=constants))
    finally:
        config.reset()
        jclock.set_default_clock(prev)
        api.reset()


def _run_port(scenario):
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.core import api
    from sentinel_tpu_torch.models import constants
    from sentinel_tpu_torch.utils import clock as tclock
    from sentinel_tpu_torch.utils.config import config
    from sentinel_tpu_torch.utils.system_status import sampler

    clock = tclock.ManualClock(start_ms=0)
    prev = tclock.set_default_clock(clock)
    api.reset(clock=clock, device="cpu")
    try:
        return scenario(SimpleNamespace(st=st, api=api, clock=clock, engine=api.get_engine(), config=config,
                             sampler=sampler, C=constants))
    finally:
        config.reset()
        tclock.set_default_clock(prev)
        api.reset(device="cpu")


def run_on_both(scenario):
    """Run ``scenario(lib)`` on the JAX package and on the port's CPU
    engine, each under its own ManualClock, and require the same
    observations (the list each run returns). ``lib`` holds one package's
    public surface: ``st`` (the package), ``api``, ``clock`` (a
    ManualClock from 0, installed as the default), ``engine``, ``config``,
    ``sampler`` (the system load/CPU sampler) and ``C`` (constants). The
    scenario may assert the reference's expected values itself."""
    want = _run_jax(scenario)
    got = _run_port(scenario)
    assert got == want, f"port {got} != JAX {want}"
    return got


def block_of(fn):
    """Call ``fn`` (an entry); return "pass" (exiting the entry) or the
    BlockError's class name, limit type and rule as a dict."""
    try:
        e = fn()
    except Exception as exc:  # a BlockError of either package
        if not hasattr(exc, "resource"):
            raise
        rule = getattr(exc, "rule", None)
        return (type(exc).__name__, getattr(exc, "limit_type", ""), None if rule is None else rule.to_dict())
    if e is not None:
        e.exit()
    return "pass"


# --- shaping (K9) and hot-parameter (K10) inputs ---------------------------

PARAM_NEVER = -(2**30)


def random_shaping_case(rng, s, nr, behaviors=(1, 2, 3), t0=1000, span=5000, n_hot=0, one_ts=False, acquire=None):
    """(table, dyn, batch, pass_consumed, prev_pass) as numpy arrays in the
    layouts of FlowTableDevice, FlowRuleDynState and ShapingBatch: rules of
    the given behaviors (rule 0 at a count near 0, so a warm-up rate
    limiter's cost saturates int32), warm-up rules cold and warm, pacers
    idle and backlogged, items over several seconds (so syncToken refills)
    or at one ts, about 10% invalid, ``n_hot`` items on rule 1."""
    beh = rng.choice(np.asarray(behaviors, np.int32), nr).astype(np.int32)
    count = (rng.random(nr) * 40 + 0.5).astype(np.float32)
    count[0] = 1e-7
    count[-1] = 0.0
    warn = rng.integers(1, 80, nr).astype(np.int32)
    cost1 = np.where(count > 0, np.floor(1.0 / np.maximum(count.astype(np.float64), 1e-30) * 1000 + 0.5), 0)
    table = (np.ones(nr, np.int32), count, beh, rng.integers(0, 900, nr).astype(np.int32),
             np.minimum(cost1, 2**31 - 1).astype(np.int32), warn, warn + rng.integers(1, 160, nr).astype(np.int32),
             (rng.random(nr) * 1e-2).astype(np.float32), rng.integers(1, 30, nr).astype(np.int32))
    stored = np.where(rng.random(nr) < 0.5, warn + rng.integers(0, 150, nr), rng.integers(0, 40, nr))
    dyn = ((t0 + rng.integers(-1500, 1500, nr)).astype(np.int32), stored.astype(np.float32),
           np.where(rng.random(nr) < 0.3, -(10**9), t0 - rng.integers(0, 3000, nr)).astype(np.int32))
    gid = rng.integers(0, nr, s).astype(np.int32)
    gid[:n_hot] = 1
    valid = rng.random(s) < 0.9
    if one_ts:
        ts = np.full(s, t0 + 7, np.int32)
    else:
        ts = np.sort(t0 + rng.integers(0, span, s)).astype(np.int32)
    acq = rng.integers(0, 4, s).astype(np.int32) if acquire is None else np.full(s, acquire, np.int32)
    eidx = np.arange(s, dtype=np.int32)
    batch = (valid, gid, gid, eidx, eidx, ts, acq)
    return table, dyn, batch, rng.integers(0, 60, s).astype(np.int32), rng.integers(0, 60, s).astype(np.int32)


def out_of_range_rule_ids(rng, sb, nr):
    """(the shaping batch ``sb`` with some valid items' rule ids moved out
    of [0, nr): two different negative ids, nr, past nr and the int32
    extremes; the same batch with those items marked invalid instead)."""
    valid, gid = sb[0].copy(), sb[1].copy()
    pick = np.flatnonzero(valid)[:: 5]
    bad = np.asarray([-1, -2, nr, nr + 5, -(2**31), 2**31 - 1], np.int64)
    gid[pick] = bad[np.arange(pick.size) % bad.size].astype(np.int32)
    invalid = valid.copy()
    invalid[pick] = False
    return (valid, gid) + tuple(sb[2:]), (invalid, gid) + tuple(sb[2:])


def random_param_case(rng, s, pr, closed=False, nts=1, heavy=False, t0=5000, heavy_row=5, valid_frac=0.9,
                      sorted_ts=True):
    """(batch, dyn) as numpy arrays in the layouts of ParamBatch and
    ParamDynState. Open: every grade and behavior (token bucket, throttle
    with queueing, THREAD), hot-item thresholds, acquire 0-2, rows never
    seen and warm, LRU resets and exit releases. ``closed``: the engine's
    closed-form shape (QPS-grade DEFAULT, one acquire >= 1, at most
    ``nts`` timestamps 700 ms apart). ``heavy``: every item on one row
    (``heavy_row``: 5 a token bucket, 1 a throttle). ``valid_frac``: the
    share of valid items. ``sorted_ts=False``: open items' ts in random
    order."""
    prow = rng.integers(0, pr, s).astype(np.int32)
    prow[: s // 4] = 3
    if heavy:
        prow[:] = heavy_row
    valid = rng.random(s) < valid_frac
    if closed:
        grade = np.ones(s, np.int32)
        beh = np.zeros(s, np.int32)
        acq = np.full(s, 2, np.int32)
        ts = (t0 + rng.integers(0, nts, s) * 700).astype(np.int32)
    else:
        grade = np.where(prow % 4 == 0, 0, 1).astype(np.int32)
        beh = np.where(prow % 3 == 1, 2, 0).astype(np.int32)
        acq = rng.integers(0, 3, s).astype(np.int32)
        ts = t0 + rng.integers(0, 4000, s)
        ts = (np.sort(ts) if sorted_ts else ts).astype(np.int32)
    tc = np.array([3, 5, 0, 7, 2, 9, 4, 6], np.int32)[prow % 8]
    burst = (prow % 3).astype(np.int32)
    dur = ((prow % 3) * 1000).astype(np.int32)
    maxq = ((prow % 5) * 100).astype(np.int32)
    cost = np.array([0, 100, 250, 333, 1000], np.int32)[prow % 5]
    resets = np.array([5, -1, 7, pr + 3], np.int32)
    exits = np.array([3, -1, 4, 4], np.int32)
    batch = (valid, prow, np.arange(s, dtype=np.int32), ts, acq, grade, beh, tc, burst, dur, maxq, cost,
             resets, exits)
    dyn = (rng.integers(-5, 10, pr).astype(np.int32),
           np.where(rng.random(pr) < 0.3, PARAM_NEVER, t0 - rng.integers(0, 3000, pr)).astype(np.int32),
           np.where(rng.random(pr) < 0.3, PARAM_NEVER, t0 + rng.integers(-2000, 2000, pr)).astype(np.int32),
           rng.integers(0, 4, pr).astype(np.int32))
    return batch, dyn


def fma_warning_case():
    """WARM_UP items whose admission turns on the last bit of the warning
    line ``1 / (above * slope + 1 / count)``: found by search so that the
    fused multiply-add and the separately rounded product and sum put the
    line on opposite sides of ``passQps + acquire``. Returns (table, dyn,
    batch, pass_consumed, prev_pass) for run_shaping."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    found = []
    while len(found) < 24:
        k = int(rng.integers(3, 40))
        above = f32(rng.integers(1, 200))
        cnt = f32(k * (1 + rng.random() * 3))
        inv_c = f32(1) / cnt
        base = (1.0 / k - float(inv_c)) / float(above)
        if base <= 0:
            continue
        for d in range(-3, 4):
            sl = f32(base * (1 + d * 1e-7))
            sep = f32(f32(above * sl) + inv_c)
            fused = f32(float(above) * float(sl) + float(inv_c))
            w_sep = np.nextafter(f32(1) / sep, f32(np.inf))
            w_fused = np.nextafter(f32(1) / fused, f32(np.inf))
            if (k <= w_sep) != (k <= w_fused):
                found.append((k, float(above), float(sl), float(cnt)))
    nr = s = len(found)
    ones, zeros = np.ones(nr, np.int32), np.zeros(nr, np.int32)
    table = (ones, np.array([c[3] for c in found], np.float32), ones, zeros, zeros, np.full(nr, 10, np.int32),
             np.full(nr, 10_000, np.int32), np.array([c[2] for c in found], np.float32), zeros)
    dyn = (zeros, np.array([10 + c[1] for c in found], np.float32), np.full(nr, 5000, np.int32))
    idx = np.arange(s, dtype=np.int32)
    batch = (np.ones(s, bool), idx, idx, idx, idx, np.full(s, 5100, np.int32), np.ones(s, np.int32))
    return table, dyn, batch, np.array([c[0] - 1 for c in found], np.int32), np.zeros(s, np.int32)


def random_shaped_flow_table(rng, nr, lo=2, hi=40):
    """A flow table (numpy, FlowTableDevice layout) where about half the
    rules shape (RATE_LIMITER, WARM_UP, WARM_UP_RATE_LIMITER, with the
    warm-up constants the host computes) and the rest are DEFAULT; the last
    two rules are padding. Returns (table, dyn)."""
    table, dyn = random_flow_table(rng, nr, thread_frac=0.15, lo=lo, hi=hi)
    grade, count, beh, maxq, cost1, warn, maxtok, slope, refill = (np.array(a) for a in table)
    shaped = rng.random(nr) < 0.5
    shaped[-2:] = False
    beh = np.where(shaped, rng.integers(1, 4, nr), 0).astype(np.int32)
    grade = np.where(shaped, 1, grade).astype(np.int32)
    count = np.where(shaped, np.maximum(count, 1), count).astype(np.float32)
    maxq = np.where(shaped, rng.integers(0, 800, nr), 0).astype(np.int32)
    cost1 = np.where(shaped, np.floor(1000.0 / np.maximum(count, 1) + 0.5), 0).astype(np.int32)
    warn = np.where(shaped, rng.integers(2, 60, nr), 0).astype(np.int32)
    maxtok = np.where(shaped, warn + rng.integers(1, 100, nr), 0).astype(np.int32)
    slope = np.where(shaped, rng.random(nr) * 1e-2, 0).astype(np.float32)
    refill = np.where(shaped, rng.integers(1, 20, nr), 0).astype(np.int32)
    stored = np.where(shaped & (rng.random(nr) < 0.5), maxtok, 0).astype(np.float32)
    dyn = (np.full(nr, -(10**9), np.int32), stored, np.full(nr, -(10**9), np.int32))
    return (grade, count, beh, maxq, cost1, warn, maxtok, slope, refill), dyn


def shaping_batch_for(batch, table):
    """The engine's shaping batch for a flush batch (numpy): one item per
    (entry, slot) whose rule shapes, padded to a power of two."""
    e_valid, e_ts, e_acq, gid, crow = batch[1], batch[2], batch[3], batch[5], batch[6]
    n, k = gid.shape
    beh = table[2]
    sel = (gid >= 0) & (crow >= 0) & e_valid[:, None] & (beh[np.clip(gid, 0, len(beh) - 1)] != 0)
    e, j = np.nonzero(sel)
    total = len(e)
    s = 8
    while s < total:
        s *= 2

    def pad(a, fill=0):
        out = np.full(s, fill, np.int32)
        out[:total] = a
        return out

    valid = np.zeros(s, bool)
    valid[:total] = True
    return (valid, pad(gid[e, j]), pad(crow[e, j]), pad(e), pad(e * k + j), pad(e_ts[e]), pad(e_acq[e], 1))


def random_param_batch_for(rng, batch, pr, m_exit=16):
    """A hot-param batch (numpy, ParamBatch layout) for a flush batch:
    about a third of the valid entries carry one or two param slots on
    rows of every grade and behavior, plus LRU resets and exit releases."""
    e_valid, e_ts, e_acq = batch[1], batch[2], batch[3]
    ents = [e for e in np.nonzero(e_valid)[0] if rng.random() < 0.35]
    items = []
    for e in ents:
        for _ in range(1 + int(rng.random() < 0.3)):
            items.append((e, int(rng.integers(0, pr - 4)) if rng.random() < 0.6 else 2))
    s = 8
    while s < len(items):
        s *= 2
    prow = np.zeros(s, np.int32)
    eidx = np.zeros(s, np.int32)
    valid = np.zeros(s, bool)
    for a, (e, r) in enumerate(items):
        valid[a], eidx[a], prow[a] = True, e, r
    ts = np.where(valid, e_ts[eidx], 0).astype(np.int32)
    acq = np.where(valid, e_acq[eidx], 1).astype(np.int32)
    grade = np.where(prow % 4 == 0, 0, 1).astype(np.int32)
    beh = np.where((prow % 3 == 1) & (grade == 1), 2, 0).astype(np.int32)
    tc = np.array([3, 5, 1, 7, 2, 9, 4, 6], np.int32)[prow % 8]
    burst = (prow % 3).astype(np.int32)
    dur = np.where(prow % 5 == 0, 1000, 2000).astype(np.int32)
    maxq = ((prow % 5) * 100).astype(np.int32)
    cost = np.where(beh == 2, np.floor(1000.0 * dur / 1000 / np.maximum(tc, 1) + 0.5), 0).astype(np.int32)
    resets = np.full(8, -1, np.int32)
    resets[:2] = rng.integers(0, pr, 2)
    exits = np.full(max(8, m_exit), -1, np.int32)
    exits[:m_exit // 2] = rng.integers(0, pr, m_exit // 2)
    return (valid, prow, eidx, ts, acq, grade, beh, tc, burst, dur, maxq, cost, resets, exits)


def random_param_state(rng, pr, t0):
    """ParamDynState arrays: rows never seen, warm and throttled, thread
    gauges of a few."""
    return (rng.integers(0, 8, pr).astype(np.int32),
            np.where(rng.random(pr) < 0.4, PARAM_NEVER, t0 - rng.integers(0, 3000, pr)).astype(np.int32),
            np.where(rng.random(pr) < 0.4, PARAM_NEVER, t0 + rng.integers(-1500, 800, pr)).astype(np.int32),
            rng.integers(0, 4, pr).astype(np.int32))


# --- the sharded step (parallel/ici.py) ------------------------------------------

CLOSED, OPEN, HALF_OPEN = 0, 1, 2
BREAKER_CASES = ["half_open_to_closed", "half_open_to_open", "two_transitions_max_wins", "trip_on_merged_counts",
                 "window_roll_on_some_shards"]


def _shard_windows(rng, arrs, now, cfg, d_count):
    """D per-shard copies of one window array that wrote into it: cells
    kept, cells added to in their window, cells rolled to a newer window
    (different shards to different windows), stale cells untouched."""
    counts, min_rt, ws = arrs
    out = []
    for _ in range(d_count):
        c, m, w = counts.copy(), min_rt.copy(), ws.copy()
        kind = rng.integers(0, 4, w.shape)
        add = kind == 1
        c[add] += rng.integers(0, 5, (int(add.sum()), c.shape[2])).astype(np.int32)
        m[add] = np.minimum(m[add], rng.integers(1, 4000, int(add.sum())))
        roll = kind == 2
        base = now - now % cfg.window_len_ms
        w[roll] = base + cfg.window_len_ms * rng.integers(0, 3, int(roll.sum()))
        c[roll] = rng.integers(0, 9, (int(roll.sum()), c.shape[2]))
        m[roll] = rng.integers(1, 4000, int(roll.sum()))
        out.append((c, m, w.astype(np.int32)))
    return tuple(np.stack([o[i] for o in out]).astype(np.int32) for i in range(3))


def random_shard_stats(rng, arrs, now, d_count, second_cfg, minute_cfg):
    """``d_count`` shards' copies of stats arrays (``random_stats``
    layout, stacked on a leading shard axis) that each wrote into their
    copy: window cells rolled, added to or left stale, thread gauges
    moved, slab cells added to or rolled to later windows."""
    second, minute, threads, fpass, fws = arrs
    sec = _shard_windows(rng, second, now, second_cfg, d_count)
    mnt = _shard_windows(rng, minute, now, minute_cfg, d_count)
    thr = np.stack([threads + rng.integers(-2, 3, threads.shape) for _ in range(d_count)]).astype(np.int32)
    fp, fw = [], []
    for _ in range(d_count):
        kind = rng.integers(0, 3, fws.shape)
        p, w = fpass.copy(), fws.copy()
        p[kind == 1] += rng.integers(1, 4, int((kind == 1).sum()))
        w[kind == 2] = fws[kind == 2] + 500 * rng.integers(1, 3, int((kind == 2).sum()))
        p[kind == 2] = rng.integers(1, 6, int((kind == 2).sum()))
        fp.append(p)
        fw.append(w)
    return sec, mnt, thr, np.stack(fp).astype(np.int32), np.stack(fw).astype(np.int32)


def _wrap32(v: int) -> int:
    return ((v + 2**31) % 2**32) - 2**31


def breaker_merge_table(rng, nd, now):
    """``random_degrade`` with breaker 0 an exception-count breaker (more
    than 3 errors, at least 2 requests)."""
    dtable, ddyn = random_degrade(rng, nd, now)
    dtable = [a.copy() for a in dtable]
    dtable[0][0], dtable[1][0], dtable[3][0] = 2, 3.0, 2
    return tuple(dtable), ddyn


def shard_breaker_case(case, rng, dtable, ddyn, now, d_count):
    """(base, ``d_count`` shard states stacked) numpy for one breaker-merge
    case on breaker 0, with noise on breakers 5 and up."""
    base = [a.copy() for a in ddyn]
    st_, nr, bad, total, ws = base
    shards = [[a.copy() for a in base] for _ in range(d_count)]
    if case == "half_open_to_closed":
        st_[0] = HALF_OPEN
        for s in shards:
            s[0][0] = HALF_OPEN
        shards[3][0][0], shards[3][2][0], shards[3][3][0] = CLOSED, 0, 0
    elif case == "half_open_to_open":
        st_[0] = HALF_OPEN
        for s in shards:
            s[0][0] = HALF_OPEN
        shards[5][0][0], shards[5][1][0] = OPEN, _wrap32(now + 5000)
    elif case == "two_transitions_max_wins":
        st_[0] = HALF_OPEN
        for s in shards:
            s[0][0] = HALF_OPEN
        shards[1][0][0] = CLOSED
        shards[6][0][0], shards[6][1][0] = OPEN, _wrap32(now + 7000)
    elif case == "trip_on_merged_counts":
        st_[0], bad[0], total[0], ws[0] = CLOSED, 0, 0, now - now % dtable[4][0]
        for s in shards:  # one error per shard: no shard alone crosses
            s[0][0], s[4][0] = CLOSED, ws[0]
            s[2][0], s[3][0] = 1, 1
    elif case == "window_roll_on_some_shards":
        st_[0] = CLOSED
        for d, s in enumerate(shards):
            s[0][0] = CLOSED
            if d % 3 == 0:  # rolled to the next window
                s[4][0], s[2][0], s[3][0] = ws[0] + dtable[4][0], 1, 2
            else:
                s[2][0], s[3][0] = bad[0] + 1, total[0] + 1
    for s in shards:  # noise on the other breakers
        s[0][5:] = np.where(rng.random(len(st_) - 5) < 0.2, rng.integers(0, 3, len(st_) - 5), s[0][5:])
        s[2][5:] += rng.integers(0, 2, len(st_) - 5)
        s[3][5:] = s[2][5:] + rng.integers(0, 3, len(st_) - 5)
    return tuple(base), tuple(np.stack([s[i] for s in shards]).astype(np.int32) for i in range(5))


I32_MIN = -(2**31)
SYSTEM_EDGE_CASES = ("mixed", "unchecked", "same_ts", "ts_extremes", "wrap")


def system_edge_case(rng, n, case, now, n_rows=32):
    """(batch arrays, live) for system_check at n entries: "mixed" a
    random batch, half of it inbound; "unchecked" no entry both live and
    inbound; "same_ts" one ts for all; "ts_extremes" ts at INT_MIN and
    INT_MAX beside unchecked entries (a checked entry at INT_MAX ties
    their sort key); "wrap" acquires whose inbound sum passes 2^31."""
    b = list(random_flush_batch(rng, n, 1, n_rows, 16, now, n - n // 16))
    live = b[1] & (rng.random(n) < 0.9)
    if case == "unchecked":
        live &= b[4][:, 3] < 0
    elif case == "same_ts":
        b[2] = np.full(n, now - 7, np.int32)
    elif case == "ts_extremes":
        b[2] = rng.choice(np.array([I32_MIN, I32_MAX, now], np.int32), n)
        b[2][:: max(1, n // 5)] = I32_MAX
    elif case == "wrap":
        lo = min(2**31 // max(1, n // 4), 2**30)
        b[3] = rng.integers(lo, 2 * lo - 1, n).astype(np.int32)
    return tuple(b), live


def system_edge_thresholds(n):
    """SystemDevice values for n entries: QPS and threads that block part
    of the inbound entries, once alone and once beside BBR load and CPU."""
    inf = float("inf")
    qps, thr = max(1.0, 0.3 * n), max(1.0, 0.15 * n)
    return [(qps, thr, inf, -1.0, -1.0, -1.0, -1.0), (qps, thr, inf, 1.0, 0.5, 5.0, 0.9)]


def many_candidates(rng, n, kd, nd, now):
    """Breaker table, state and entries where every slot's first breaker is
    breaker 1, OPEN and due, at one ts: n candidates, the slot decides."""
    table, dyn = random_degrade(rng, nd, now)
    dyn[0][1], dyn[1][1] = 1, now - 100
    e_dgid = np.full((n, kd), -1, np.int32)
    e_dgid[:, 0] = 1
    if kd > 1:
        e_dgid[:, 1] = np.where(rng.random(n) < 0.5, rng.integers(0, nd, n), -1)
    e_ts = np.full(n, now - 5, np.int32)
    e_live = rng.random(n) < 0.9
    return table, dyn, e_dgid, e_ts, e_live


# --- the mesh budget split past 2**31 (K15) ---------------------------------------

def _window_cfgs():
    from sentinel_tpu_torch.metrics import nodes

    return nodes.SECOND_CFG, nodes.MINUTE_CFG


BUDGET_WRAP_CASES = ["smallest", "all_shards_pass", "one_shard_passes", "origin_split_k2"]


def budget_wrap_case(case, d_count=8):
    """Budget inputs whose masked units pass 2**31 across the shards. Each
    slot has a rule of its own whose count is the slot's cap; the stats
    hold no pass, threads or borrows, so the grant and the borrow cap are
    floor(count). Returns (stats, table, batch, cap [N*K]):

    * ``smallest``: ``d_count`` = 8 shards of 2 entries, K = 1, every slot masked, one
      ts (the smallest input found where a prefix over all shards differs
      from JAX's per-chip prefix);
    * ``all_shards_pass``: 4 entries a shard on 4 rows, acquires up to
      2**29: the shards' units together pass 2**31, no shard's alone;
    * ``one_shard_passes``: as above, and shard 2's own units pass 2**31;
    * ``origin_split_k2``: K = 2, both slots of an entry on one row under
      two rules."""
    rng = np.random.default_rng(BUDGET_WRAP_CASES.index(case) + 70)
    now = 3_456_000
    if case == "smallest":
        n, k = 16, 1
        rows = np.array([1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0], np.int32)
        acq = np.array([2, 603740710, 3, 2, 3, 851543336, 2, 834345985, 1, 2, 1, 2, 780960580, 691715872, 3,
                        758542948], np.int32)
        cap = np.array([1759114057, 872974300, 89514544, 1954121989, 2020595744, 92485438, 1274239748,
                        1766748282, 1696194208, 892030427, 1846657787, 1781990488, 243444659, 21377256,
                        219536274, 783930654], np.int32)
        ts = np.full(n, now - 100, np.int32)
    else:
        n, k = 32, 2 if case == "origin_split_k2" else 1
        rows = rng.integers(0, 4, n).astype(np.int32)
        acq = np.where(rng.random(n) < 0.5, rng.integers(2**27, 2**29, n), rng.integers(1, 4, n)).astype(np.int32)
        if case == "one_shard_passes":
            acq[8:12] = rng.integers(2**29 + 2**28, 2**30, 4)
        cap = rng.integers(2**30, 2**31 - 2**8, n * k).astype(np.int32)
        ts = (now - rng.integers(0, 40, n)).astype(np.int32)
    n_rows = 8
    stats = random_stats(rng, n_rows, now, *_window_cfgs())
    for a in (stats[0][0], stats[1][0], stats[2], stats[3]):
        a[...] = 0
    nr = n * k + 2
    table, _ = random_flow_table(rng, nr, thread_frac=0.0)
    table[1][: n * k] = cap.astype(np.float32)
    b = list(random_flush_batch(rng, n, k, n_rows, nr, now, n))
    b[2], b[3] = ts, acq
    b[5] = np.arange(n * k, dtype=np.int32).reshape(n, k)
    b[6] = np.repeat(rows[:, None], k, axis=1)
    # The caps the demotions compute: float32 counts, floored.
    cap = np.floor(table[1][: n * k]).astype(np.int64).clip(max=2**31 - 1).astype(np.int32)
    units = acq.astype(np.int64).repeat(k).reshape(d_count, -1).sum(axis=1)
    assert units.sum() >= 2**31
    if case != "origin_split_k2":
        assert (units.max() >= 2**31) == (case == "one_shard_passes")
    return stats, table, tuple(b), cap


def _tail_rows(rng, n, n_rows, rows):
    """Cluster rows: uniform, Zipf(1.1), or all on one row ("one")."""
    if rows == "zipf":
        return (np.minimum(rng.zipf(1.1, n), n_rows) - 1).astype(np.int32)
    if rows == "one":
        return np.full(n, min(3, n_rows - 1), np.int32)
    return rng.integers(0, n_rows, n).astype(np.int32)


# The tail's absent inputs, every combination: (system stage, param stage,
# shaping, occupy, breakers: "off", "ddyn" with the probe transitions,
# "no_ddyn" without them).
TAIL_NULLS = [(sys_, param, shape, occupy, breakers) for sys_ in (False, True) for param in (False, True)
              for shape in (False, True) for occupy in (False, True) for breakers in ("off", "ddyn", "no_ddyn")]


def random_tail_case(rng, n, k, kd, nd, n_rows, rows="uniform", wrap=False):
    """The inputs of the slot chain's verdict tail (``slot_chain_verdict``)
    as numpy arrays: a batch (``random_flush_batch``'s fields; cluster rows
    ``e_rows[:, 1]`` uniform, Zipf(1.1) or one row, some out of range;
    breaker ids [n, kd]), the stages' verdicts as an Admission's fields and
    the stage inputs (sys_ok, param_ok, wait_param, shape_wait, dslot_ok,
    probe_slot), and breaker states [nd]. ``wrap``: acquires near 2**30,
    so that a row's blocked sum wraps past 2**31."""
    b = list(random_flush_batch(rng, max(n, 1), k, max(n_rows, 8), 16, 1_000_000, n - n // 16))
    b[1:11] = [a[:n] for a in b[1:11]]
    crow = _tail_rows(rng, n, n_rows, rows)
    crow[rng.random(n) < 0.02] = n_rows + 7  # clamped to the last row
    b[4] = b[4].copy()
    b[4][:, 1] = crow
    b[3] = (rng.integers(2**30 - 8, 2**30 + 8, n) if wrap else rng.integers(0, 4, n)).astype(np.int32)
    b[10] = rng.integers(0, nd, (n, kd)).astype(np.int32)
    occupied = rng.random(n) < 0.3
    return dict(
        batch=b,
        flow_pass=rng.random(n) < 0.7, occupied=occupied, occupy_wait=rng.integers(-5, 400, n).astype(np.int32),
        occ_slot=(rng.random((n, k)) < 0.6) & occupied[:, None], occ_target=rng.integers(0, 10**6, (n, k)).astype(np.int32),
        sys_ok=rng.random(n) < 0.9, param_ok=rng.random(n) < 0.9, wait_param=rng.integers(0, 300, n).astype(np.int32),
        shape_wait=rng.integers(0, 500, n).astype(np.int32), dslot_ok=rng.random((n, kd)) < 0.8,
        probe_slot=rng.random((n, kd)) < 0.2, state=rng.integers(0, 3, nd).astype(np.int32),
    )


# Ties in the blocked top-K: twelve entries' cluster rows and acquires.
# "touched_rows_tie": rows 9, 5 and 12 block the same total, below row
# 20's; "wrapped_zero_beside_untouched": row 3's acquires sum to 2**32 (0
# after wrapping) beside the untouched rows 0-2, 4..., row 7's to 2**31 + 4.
TIE_PATTERNS = {
    "touched_rows_tie": ([9, 5, 12, 20, 9, 5, 12, 20, 9, 5, 12, 20], [2, 3, 1, 9, 2, 1, 3, 9, 2, 2, 2, 9]),
    "wrapped_zero_beside_untouched": ([3, 3, 3, 7, 7, 7, 7, 7, 7, 7, 7, 7],
                                      [2**31 - 1, 2**31 - 1, 2, 2**31 - 1, 5] + [0] * 7),
}


def tie_rows(case, n, groups=4):
    """Cluster rows and acquires of n entries: ``TIE_PATTERNS[case]``
    repeated, its j-th copy on rows 32 * (j % groups) higher, so that each
    row takes the pattern's adds again and again (a row of
    "wrapped_zero_beside_untouched" comes back to a sum of 0 after every
    copy)."""
    rows, acq = (np.asarray(a, np.int64) for a in TIE_PATTERNS[case])
    i = np.arange(n)
    return (rows[i % 12] + 32 * ((i // 12) % groups)).astype(np.int32), acq[i % 12].astype(np.int32)


BORROW_SLAB_CASES = ["three_windows_one_cell", "wrap_past_2_31", "slab_kinds", "zipf"]


def random_borrow_case(rng, n, k, n_rows, now, case="slab_kinds"):
    """The inputs of the borrow commit (``commit_borrow_slab``, second
    window: 500 ms buckets, two of them): the slab (future_pass, future_ws
    [n_rows, 2]) whose cells are empty, older than, equal to or newer than
    the windows the borrows target, and the borrows (occ [n, k], tgt
    [n, k], acq [n], crow [n, k], some rows out of range). Targets lie on
    four windows after now, three of them in one bucket. Cases:
    "three_windows_one_cell", every borrow on one row; "wrap_past_2_31",
    acquires near 2**30 on a few rows; "slab_kinds", uniform rows; "zipf",
    Zipf(1.1) rows."""
    wlen = 500
    base = now - now % wlen
    kind = rng.integers(0, 4, (n_rows, 2))
    tgt_of = base + wlen * np.array([1, 2, 3, 5])  # buckets 1, 0, 1, 1 of base's parity
    fws = np.choose(kind, [np.full(kind.shape, -wlen * 2 - 1), np.full(kind.shape, base - wlen),
                           np.where(np.arange(2) == (base // wlen + 1) % 2, tgt_of[2], tgt_of[1]) + 0 * kind,
                           np.full(kind.shape, base + 7 * wlen)]).astype(np.int32)
    fpass = np.where(kind == 0, 0, rng.integers(1, 9, kind.shape)).astype(np.int32)
    rows = {"three_windows_one_cell": "one", "wrap_past_2_31": "zipf", "slab_kinds": "uniform", "zipf": "zipf"}[case]
    crow = _tail_rows(rng, n * k, min(n_rows, 4) if case == "wrap_past_2_31" else n_rows, rows).reshape(n, k)
    crow[rng.random((n, k)) < 0.02] = n_rows + 5
    crow[rng.random((n, k)) < 0.01] = -1
    tgt = tgt_of[rng.integers(0, 4, (n, k))].astype(np.int32)
    acq = (rng.integers(2**30 - 8, 2**30 + 8, n) if case == "wrap_past_2_31" else rng.integers(1, 5, n)).astype(np.int32)
    occ = rng.random((n, k)) < 0.5
    return (fpass, fws), (occ, tgt, acq, crow)


# --- the breaker completions' order and window edges (K7) -------------------

BREAKER_EXIT_CASES = ["equal_ts_order", "half_open_shared_ts", "superseded_then_newer", "all_older",
                      "min_request_max", "hot_breaker"]


def _breaker_unit(case, w0, rng, n_hot):
    """(breakers, exits) of one copy of a case: breakers as dicts of the
    table and state fields, exits as (breaker, ts, rt, err) in slot order."""
    def brk(grade=1, thr=0.5, min_req=1, state=0, bad=0, total=0, ws=w0, max_rt=I32_MAX, slow=1.0, next_retry=0):
        return dict(grade=grade, thr=thr, slow=slow, min_req=min_req, state=state, next_retry=next_retry, bad=bad,
                    total=total, ws=ws, max_rt=max_rt)

    t = w0 + 500
    if case == "equal_ts_order":
        # Equal (breaker, ts): bad then good crosses a ratio of 0.5 at
        # min_request 1, good then bad does not; the same for slow calls;
        # a count breaker crosses at its second bad call.
        brks = [brk(), brk(), brk(grade=0, thr=50, max_rt=50, slow=0.5), brk(grade=0, thr=50, max_rt=50, slow=0.5),
                brk(grade=2, thr=1)]
        exits = [(0, t, 0, 1), (0, t, 0, 0), (1, t, 0, 0), (1, t, 0, 1), (2, t, 90, 0), (2, t, 5, 0),
                 (3, t, 5, 0), (3, t, 90, 0), (4, t, 0, 1), (4, t, 0, 1), (4, t, 0, 0)]
    elif case == "half_open_shared_ts":
        # HALF_OPEN breakers whose first two exits share a ts: bad then
        # good reopens from that ts, good then bad closes; a first exit at
        # a negative ts retries from 0.
        brks = [brk(state=2, bad=3, total=4), brk(state=2, bad=3, total=4), brk(state=2), brk(state=2, grade=2, thr=0)]
        exits = [(0, t, 0, 1), (0, t, 0, 0), (0, t + 7, 0, 1), (1, t, 0, 0), (1, t, 0, 1), (1, t + 7, 0, 1),
                 (2, -5, 0, 1), (2, t, 0, 0), (3, t - 1, 0, 0), (3, t - 1, 0, 1)]
    elif case == "superseded_then_newer":
        # Segments that start in a superseded window and end in a newer
        # one: a crossing in the older window does not count; a crossing
        # in the newest does, from its first crossing ts; exits older
        # than the breaker's window are skipped.
        old = w0 - 1000
        brks = [brk(min_req=2, ws=old, total=1), brk(min_req=2, ws=old, total=1), brk(min_req=2, total=2, bad=0),
                brk(grade=2, thr=2, ws=old, bad=2, total=2)]
        exits = [(0, old + 10, 0, 1), (0, old + 10, 0, 1), (0, old + 20, 0, 1), (0, w0 + 10, 0, 0),
                 (0, w0 + 20, 0, 0), (0, w0 + 30, 0, 0),
                 (1, old + 5, 0, 1), (1, old + 6, 0, 1), (1, w0 + 20, 0, 0), (1, w0 + 30, 0, 1), (1, w0 + 40, 0, 1),
                 (1, w0 + 50, 0, 1),
                 (2, old + 1, 0, 1), (2, old + 2, 0, 1), (2, old + 3, 0, 1), (2, w0 + 1, 0, 1), (2, w0 + 2, 0, 1),
                 (3, old + 900, 0, 1), (3, w0 + 1000 + 1, 0, 1), (3, w0 + 1000 + 2, 0, 1), (3, w0 + 1000 + 3, 0, 1)]
    elif case == "all_older":
        # Every exit older than the breaker's window: the counts stay, a
        # HALF_OPEN breaker is still decided by its first exit.
        older = [w0 - 2000 + 3, w0 - 1000 + 5, w0 - 1000 + 5]
        brks = [brk(bad=1, total=2), brk(state=2, bad=1, total=2), brk(state=2, bad=1, total=2),
                brk(state=1, next_retry=w0 + 4000, bad=5, total=5)]
        exits = [(0, older[0], 0, 1), (0, older[1], 0, 1), (0, older[2], 0, 1), (1, older[0], 0, 0),
                 (1, older[1], 0, 1), (2, older[1], 0, 1), (2, older[2], 0, 0), (3, older[0], 0, 1)]
    elif case == "min_request_max":
        # min_request 2^31 - 1 (2^31 in float32): never reached from small
        # counts; reached by counts near 2^31, which then wrap.
        big = I32_MAX
        brks = [brk(min_req=big), brk(min_req=big, total=big - 2, bad=big - 3), brk(grade=2, thr=0, min_req=big,
                                                                              total=big - 100, bad=1),
                brk(grade=0, thr=10, max_rt=10, slow=0.0, min_req=big, total=big - 1)]
        exits = [(0, t, 0, 1)] * 5 + [(1, t, 0, 1), (1, t + 1, 0, 1), (1, t + 2, 0, 0), (2, t, 0, 1),
                                      (2, t + 3, 0, 0), (3, t, 50, 0), (3, t, 5, 0)]
    else:  # hot_breaker: one breaker takes most of the exits, over three windows
        brks = [brk(min_req=5, ws=w0 - 1000, total=3, bad=1)] + [
            brk(grade=int(g), thr=0.5 if g == 1 else 2, state=int(s), max_rt=60, slow=0.5)
            for g, s in zip(rng.integers(0, 3, 31), rng.choice([0, 0, 1, 2], 31))]
        n = n_hot + n_hot // 8
        g = np.where(np.arange(n) < n_hot, 0, rng.integers(1, 32, n))
        ts = w0 - 1000 + rng.integers(0, 2000, n)
        ts[: n // 4] = ts[0]
        exits = list(zip(g, ts, rng.integers(0, 120, n), (rng.random(n) < 0.3).astype(int)))
        exits = [exits[i] for i in rng.permutation(n)]
    return brks, exits


def breaker_exit_case(case, copies=1, seed=0, n_hot=512):
    """A breaker table and state and exit columns (table, dyn, (x_dgid,
    x_ts, x_rt, x_err, x_valid)) as numpy for the order and window edges
    of ``breaker_on_exits``: ``copies`` copies of a case's breakers (each
    copy on breakers of its own) whose exits interleave at random, each
    copy's exits in their own order; a tenth of the slots empty or
    invalid. ``hot_breaker``: one breaker takes ``n_hot`` of each copy's
    exits (the copies share it)."""
    rng = np.random.default_rng(seed)
    now = 700_137
    w0 = now - now % 1000
    fields = ("grade", "thr", "slow", "min_req", "interval", "retry", "max_rt", "state", "next_retry", "bad",
              "total", "ws")
    cols = {f: [] for f in fields}
    per_copy = []
    for c in range(copies):
        brks, exits = _breaker_unit(case, w0, rng, n_hot)
        base = len(cols["grade"])
        for b in brks:
            for f in fields:
                cols[f].append({"interval": 1000, "retry": 5000}.get(f, b.get(f)))
        shared = case == "hot_breaker"
        per_copy.append([((0 if shared and g == 0 else base + g), ts, rt, err) for g, ts, rt, err in exits])
    nd = 8
    while nd < len(cols["grade"]) + 3:
        nd <<= 1
    for f, v in (("grade", 0), ("thr", INF), ("slow", 1.0), ("min_req", I32_MAX), ("interval", 1000), ("retry", 0),
                 ("max_rt", I32_MAX), ("state", 0), ("next_retry", 0), ("bad", 0), ("total", 0), ("ws", WS_FLOOR)):
        cols[f] += [v] * (nd - len(cols[f]))
    table = tuple(np.asarray(cols[f], dtype=np.float32 if f in ("thr", "slow") else np.int32)
                  for f in fields[:7])
    dyn = tuple(np.asarray(cols[f], dtype=np.int32) for f in fields[7:])
    # Interleave the copies at random, each copy's exits in their order.
    total = sum(len(e) for e in per_copy)
    perm = rng.permutation(total)
    out = [None] * total
    at = 0
    for exits in per_copy:
        for pos, e in zip(np.sort(perm[at:at + len(exits)]), exits):
            out[pos] = e
        at += len(exits)
    g, ts, rt, err = (np.asarray(c) for c in zip(*out))
    m = total + total // 10
    x_dgid = np.full((m, 1), -1, np.int32)
    x_ts = (now - rng.integers(0, 3000, m)).astype(np.int32)
    x_rt, x_err = rng.integers(0, 100, m).astype(np.int32), rng.integers(0, 2, m).astype(np.int32)
    x_valid = np.ones(m, bool)
    slots = np.sort(rng.choice(m, total, replace=False))
    x_dgid[slots, 0], x_ts[slots], x_rt[slots], x_err[slots] = g, ts, rt, err
    rest = np.setdiff1d(np.arange(m), slots)
    x_valid[rest[: len(rest) // 2]] = False  # invalid exits with a breaker
    x_dgid[rest[: len(rest) // 2], 0] = rng.integers(0, nd, len(rest) // 2)
    return table, dyn, (x_dgid, x_ts, x_rt, x_err, x_valid)


# --- the sketch fold's key edges (K11) ---------------------------------------

SKETCH_EDGE_CASES = ["id_max", "duplicates", "few_distinct", "negative_estimates", "boundary_ties"]


def sketch_edge_case(case, depth=4, width=2048, c=64, s=512, seed=0):
    """(cm, cand_ids, cand_cnt, ids, w) as numpy for the edges of
    ``sketch_fold``: "id_max", a batch holding the id 2^31 - 1 (added, never
    a head), also as a candidate; "duplicates", ids repeated next to each
    other and far apart; "few_distinct", fewer distinct ids than free
    slots (the rest -1 / 0); "negative_estimates", count-min cells near
    2^31 that the adds wrap negative, and negative ones; "boundary_ties", candidates touched
    at the top-C boundary among equal counts."""
    rng = np.random.default_rng(seed)
    cm = rng.integers(0, 60, (depth, width)).astype(np.int32)
    pool = rng.choice(I32_MAX, size=2 * (c + s), replace=False).astype(np.int32)
    cand = pool[:c].copy()
    cnt = rng.integers(1, 200, c).astype(np.int32)
    ids = pool[c:c + s].copy()
    w = rng.integers(1, 5, s).astype(np.int32)
    if case == "id_max":
        ids[rng.choice(s, max(s // 16, 2), replace=False)] = I32_MAX
        cand[c // 2] = I32_MAX
        ids[: c // 4] = cand[: c // 4]
    elif case == "duplicates":
        ids[1::2] = ids[0::2][: len(ids[1::2])]  # adjacent
        ids[s // 2:s // 2 + s // 8] = ids[: s // 8]  # far apart
        ids[-(s // 8):] = -1
        ids[: c // 8] = np.repeat(cand[: c // 16 + 1], 2)[: c // 8]
    elif case == "few_distinct":
        cand[c // 3:] = -1
        cnt[c // 3:] = 0
        k = max(c // 8, 1)
        ids = np.where(np.arange(s) < s // 2, rng.choice(pool[c:c + k], s), -1).astype(np.int32)
        ids[: c // 6] = cand[: c // 6]
    elif case == "negative_estimates":
        cm[:, :] = rng.integers(2**31 - 40, 2**31 - 1, (depth, width))
        cm[:, ::3] = rng.integers(0, 60, (depth, (width + 2) // 3))
        cm[:, 1::7] = rng.integers(-90, 0, (depth, len(range(1, width, 7))))  # negative under decay too
        ids[: c // 3] = cand[: c // 3]
        cnt[::5] = -7  # a negative count left in the table
    else:  # boundary_ties
        cm[:, :] = 5
        w[:] = 2
        cnt[:] = 7
        cnt[: c // 2] = 9
        ids[: c // 4] = cand[c // 2 - c // 8:c // 2 + c // 8]  # touched around the boundary count
    return cm, cand, cnt, ids.astype(np.int32), w
