"""Smoke run of the PyTorch/CUDA port (sentinel_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from the sources in this checkout
(one nvcc per CUDA source, started together; Triton compiles on first
launch) and then, failing on the first mismatch:

1. prints the card's name and power limit (nvidia-smi);
2. holds every kernel against its plain PyTorch version on the card, at
   the shapes of the main path: 1,048,576 stats rows, 131,072 entries
   with one rule slot, window updates of 4 x 131,072; plus a Zipf-skewed
   case with exits. Equality is exact (int32 state, float32 compares in
   the same order). Times each kernel, its plain version and, where one
   PyTorch call computes the same function, that call;
3. runs flush_step at that shape with exits off, then on, through the
   kernels and through the plain versions: identical results and state;
   prints ms per flush and entries/s, and a torch.profiler breakdown of
   one step's device time;
4. drives the engine through the public API (6,000 DEFAULT QPS rules,
   10 simulated seconds of Zipf-skewed submit_bulk traffic in
   32,768-entry flushes, st.entry calls and exits) on the card, with
   every kernel launch counter set to 0 just before and read just after,
   and the same stream on the port's CPU engine: identical verdicts and
   final state;
5. runs the flow_qps_demo scenario on the card: 8 threads, 3 s of real
   clock, st.entry against a QPS = 20 rule; prints pass/s and the
   st.entry latency percentiles.

Its output ends with a ``{"kernels": [...]}`` line, the card's name and
power limit, and ``{"ok": true, "device": {...}}`` as the last line. It
exits non-zero, with no result, without CUDA or without the rest of the
checkout beside it.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
    sys.exit(2)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
try:
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.core import api
    from sentinel_tpu_torch.metrics import metric_array as ma
    from sentinel_tpu_torch.metrics import nodes
    from sentinel_tpu_torch.metrics.events import NUM_EVENTS
    from sentinel_tpu_torch.rules.flow_table import FlowTableDevice, flow_table_from_numpy
    from sentinel_tpu_torch.runtime import flush
    from sentinel_tpu_torch.utils import clock as tclock
    from sentinel_tpu_torch.utils import cuda_build
except ImportError as exc:
    print(f"chip_smoke: the sentinel_tpu_torch package is not beside this script ({exc})",
          file=sys.stderr)
    sys.exit(2)

DEV = torch.device("cuda", 0)
R = 1 << 20  # stats rows (north-star scale)
N = 1 << 17  # entries per flush
I32 = torch.int32


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a, b) -> int:
    """Largest absolute difference over two tensors or (nested) tuples."""
    if isinstance(a, tuple):
        return max((max_abs_err(x, y) for x, y in zip(a, b) if x is not None), default=0)
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def require_equal(a, b, what: str) -> int:
    err = max_abs_err(a, b)
    if err != 0:
        fail(f"{what}: kernel and plain version differ (max abs err {err})")
    return err


def clone(x):
    if isinstance(x, tuple):
        return type(x)(*(clone(v) for v in x))
    return x.clone()


def bound(bytes_moved: float, ops: float = 0.0):
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------


def make_window_state(cfg, now: int, gen) -> ma.MetricArrayState:
    """A populated window state on the card: live, stale and empty buckets."""
    b, wlen = cfg.sample_count, cfg.window_len_ms
    counts = torch.randint(0, 40, (R, b, NUM_EVENTS), generator=gen, device=DEV, dtype=I32)
    min_rt = torch.randint(1, cfg.max_rt + 1, (R, b), generator=gen, device=DEV, dtype=I32)
    age = torch.randint(-1, 2 * b + 2, (R, b), generator=gen, device=DEV, dtype=I32)
    ws = (now - now % wlen) - age * wlen
    ws = torch.where((age < 0) | (ws < 0), torch.full_like(ws, cfg.empty_ws), ws).to(I32)
    return ma.MetricArrayState(counts, min_rt, ws.contiguous())


def make_stats(now: int, gen, matured_frac: float = 0.0) -> nodes.StatsState:
    cfg = nodes.SECOND_CFG
    s = nodes.StatsState(
        second=make_window_state(cfg, now, gen),
        minute=make_window_state(nodes.MINUTE_CFG, now, gen),
        threads=torch.randint(0, 4, (R,), generator=gen, device=DEV, dtype=I32),
        future_pass=torch.zeros((R, cfg.sample_count), device=DEV, dtype=I32),
        future_ws=torch.full((R, cfg.sample_count), cfg.empty_ws, device=DEV, dtype=I32),
    )
    if matured_frac > 0:
        # Borrowed tokens: matured-live (same or newer than the bucket),
        # matured-expired, and still in the future.
        pick = torch.rand((R, cfg.sample_count), generator=gen, device=DEV) < matured_frac
        wlen = cfg.window_len_ms
        base = now - now % wlen
        off = torch.randint(-4, 3, (R, cfg.sample_count), generator=gen, device=DEV, dtype=I32) * wlen
        s.future_ws.copy_(torch.where(pick, base + off, s.future_ws))
        s.future_pass.copy_(torch.where(pick, torch.randint(1, 9, (R, cfg.sample_count), generator=gen,
                                                            device=DEV, dtype=I32), 0))
    return s


def zipf_rows(rng, n: int, n_rows: int, a: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, n_rows + 1, dtype=np.float64)
    p = ranks ** -a
    p /= p.sum()
    return rng.choice(n_rows, size=n, p=p).astype(np.int32)


def make_batch(rng, now: int, skewed: bool, with_exits: bool) -> flush.FlushBatch:
    """The bench's headline batch (bench.py _run_stage): one rule per
    resource, rows = resource ids, entry rows (res, res, -1, 0), ts in the
    first 400 ms; ``skewed`` draws resources from a Zipf law instead."""
    res = zipf_rows(rng, N, R) if skewed else rng.integers(0, R, N).astype(np.int32)
    rows = np.stack([res, res, np.full(N, -1), np.zeros(N)], axis=1).astype(np.int32)
    m = N // 4
    x_res = zipf_rows(rng, m, R) if skewed else rng.integers(0, R, m).astype(np.int32)
    b = (
        np.int32(now), np.ones(N, bool), np.sort(rng.integers(0, 400, N)).astype(np.int32) + now - 400,
        np.ones(N, np.int32), rows, res[:, None].copy(), res[:, None].copy(), np.zeros(N, bool),
        np.ones(N, bool), np.ones(N, bool), np.full((N, 1), -1, np.int32),
        np.full(m, with_exits), np.sort(rng.integers(0, 400, m)).astype(np.int32) + now - 400,
        np.ones(m, np.int32), np.stack([x_res, x_res, np.full(m, -1), np.zeros(m)], axis=1).astype(np.int32),
        rng.integers(1, 200, m).astype(np.int32), (rng.random(m) < 0.1).astype(np.int32),
        np.full(m, -1, np.int32), np.full((m, 1), -1, np.int32),
    )
    return flush.batch_from_numpy(b, DEV)


def make_table() -> FlowTableDevice:
    """R DEFAULT QPS rules with count 20 (bench.py _run_stage)."""
    z = np.zeros(R, np.int32)
    table, _ = flow_table_from_numpy(
        (np.ones(R, np.int32), np.full(R, 20.0, np.float32), z, z, np.full(R, 50, np.int32),
         z, z, np.zeros(R, np.float32), z),
        None, DEV,
    )
    return table


def entry_updates(batch: flush.FlushBatch, admitted: torch.Tensor):
    """The entry-accounting update batch (4N rows) flush_entries builds."""
    rows = batch.e_rows.reshape(-1)
    a4 = admitted.repeat_interleave(4)
    q4 = batch.e_acquire.repeat_interleave(4)
    d = torch.zeros((rows.shape[0], NUM_EVENTS), dtype=I32, device=DEV)
    d[:, 0] = torch.where(a4, q4, 0)
    d[:, 1] = torch.where(a4, 0, q4)
    mask = (rows >= 0) & batch.e_valid.repeat_interleave(4)
    return rows, batch.e_ts.repeat_interleave(4), d, a4.to(I32), mask


def exit_updates(batch: flush.FlushBatch):
    m = batch.x_valid.shape[0]
    rows = batch.x_rows.reshape(-1)
    c4, rt4, thr4 = (v.repeat_interleave(4) for v in (batch.x_count, batch.x_rt, batch.x_thr))
    d = torch.zeros((4 * m, NUM_EVENTS), dtype=I32, device=DEV)
    d[:, 3], d[:, 4], d[:, 2] = c4, rt4, batch.x_err.repeat_interleave(4)
    sample = torch.where((thr4 < 0) & (c4 > 0), rt4, 2**31 - 1).to(I32)
    mask = (rows >= 0) & batch.x_valid.repeat_interleave(4)
    return rows, batch.x_ts.repeat_interleave(4), d, sample, thr4, mask


def plain_flush_step(stats, table, batch, with_exits: bool, topk: int):
    """flush_step with every kernel replaced by its plain version."""
    nodes.materialize_matured_plain(stats, batch.now)

    def updates(rows, ts, deltas, rt, thr, mask):
        ma.update_plain(nodes.SECOND_CFG, stats.second, rows, ts, deltas, rt, mask)
        ma.update_plain(nodes.MINUTE_CFG, stats.minute, rows, ts, deltas, rt, mask)
        nodes.thread_gauge_add_plain(stats.threads, rows, thr, mask)

    if with_exits:
        updates(*exit_updates(batch))
    adm = flush.flow_admission_plain(stats, table, batch, topk)
    rows, ts, d, thr, mask = entry_updates(batch, adm.admitted)
    updates(rows, ts, d, None, thr, mask)
    return stats, adm


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def update_bytes(cfg, state, rows, ts, deltas, rt, mask) -> float:
    """Least bytes of one window update on these inputs: each input read
    once; each touched bucket reads its window start, and an adding one its
    counts and min RT too; each touched bucket writes counts, min RT and
    window start."""
    n = rows.shape[0]
    b, wlen = cfg.sample_count, cfg.window_len_ms
    m = mask.cpu().numpy()
    key = (rows.cpu().numpy().astype(np.int64) * b + (ts.cpu().numpy() // wlen) % b)[m]
    ws = (ts.cpu().numpy() - ts.cpu().numpy() % wlen)[m]
    order = np.argsort(key, kind="stable")
    key, ws = key[order], ws[order]
    uniq, start = np.unique(key, return_index=True)
    seg_ws = np.maximum.reduceat(ws, start) if len(start) else ws[:0]
    old = state.window_start.reshape(-1)[torch.from_numpy(uniq).to(DEV)].cpu().numpy()
    same = int((seg_ws == old).sum())
    touched = int((seg_ws >= old).sum())
    per_entry = 4 + 4 + 1 + 4 * NUM_EVENTS + (4 if rt is not None else 0)
    return n * per_entry + len(uniq) * 4 + same * (4 * NUM_EVENTS + 4) + touched * (4 * NUM_EVENTS + 8)


def phase2(results: dict) -> None:
    log("phase 2: kernels against their plain versions at the main path's shapes")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2)
    rng = np.random.default_rng(2)
    now = 1_000_000
    table = make_table()

    for skewed in (False, True):
        tag = "zipf" if skewed else "uniform"
        stats = make_stats(now, gen, matured_frac=0.02 if skewed else 0.0)
        batch = make_batch(rng, now, skewed=skewed, with_exits=skewed)

        # K1 materialize_matured [R, 2]
        want = nodes.materialize_matured_plain(clone(stats), now)
        got = nodes.materialize_matured(clone(stats), now)
        err1 = require_equal(want, got, f"materialize_matured ({tag})")
        # K3 window sums at the sorted check rows (N rows of [R, 2, 6]), and all rows
        rows_g = torch.sort(batch.e_check_row.reshape(-1)).values
        for r in (rows_g, None):
            w = ma.window_reduce_plain(nodes.SECOND_CFG, stats.second, now, r, with_min=True)
            g = ma.window_reduce(nodes.SECOND_CFG, stats.second, now, r, with_min=True)
            err3 = require_equal(w, g, f"window_sums ({tag}, rows={'gather' if r is not None else 'all'})")
        # K4 flow admission + verdict tail
        adm_w = flush.flow_admission_plain(stats, table, batch, 8)
        adm_g = flush.flow_admission(stats, table, batch, 8)
        err4 = require_equal(adm_w, adm_g, f"flow_admission ({tag})")
        # K2 window update: entries (no RT sample) and, skewed, exits (RT samples)
        e_rows, e_ts, e_d, e_thr, e_mask = entry_updates(batch, adm_g.admitted)
        cases = [(e_rows, e_ts, e_d, None, e_mask)]
        if skewed:
            x_rows, x_ts, x_d, x_rt, x_thr, x_mask = exit_updates(batch)
            cases.append((x_rows, x_ts, x_d, x_rt, x_mask))
        err2 = 0
        for cfg, st_ in ((nodes.SECOND_CFG, stats.second), (nodes.MINUTE_CFG, stats.minute)):
            for rows, ts, d, rt, mask in cases:
                w = ma.update_plain(cfg, clone(st_), rows, ts, d, rt, mask)
                g = ma.update(cfg, clone(st_), rows, ts, d, rt, mask)
                err2 = max(err2, require_equal(w, g, f"window_update ({tag}, B={cfg.sample_count})"))
        # thread gauge
        w = nodes.thread_gauge_add_plain(stats.threads.clone(), e_rows, e_thr, e_mask)
        g = nodes.thread_gauge_add(stats.threads.clone(), e_rows, e_thr, e_mask)
        errg = require_equal(w, g, f"thread_gauge ({tag})")
        for name, err in (("materialize_matured", err1), ("window_sums", err3),
                          ("flow_admission", err4), ("window_update", err2), ("thread_gauge", errg)):
            results[name]["max_abs_err"] = max(results[name].get("max_abs_err", 0), err)
        log(f"  {tag}: all five kernels equal their plain versions (max abs err 0)")
        if skewed:
            continue

        # Timing on the uniform (headline) case.
        m1 = stats.future_ws.numel()
        results["materialize_matured"].update(
            ms=time_ms(lambda: nodes.materialize_matured(stats, now)),
            plain_ms=time_ms(lambda: nodes.materialize_matured_plain(stats, now)),
            library_ms=None,
            shape=f"slab [{R},2], second window [{R},2,6]",
        )
        # Matured cells are none once swept: the sweep reads the slab's
        # window starts and writes nothing.
        results["materialize_matured"]["bound"] = bound(m1 * 4)

        cfg = nodes.SECOND_CFG
        sums, _ = ma.window_reduce(cfg, stats.second, now, rows_g)
        valid = ((now - stats.second.window_start[rows_g.long()]) <= cfg.interval_ms).sum().item()
        results["window_sums"].update(
            ms=time_ms(lambda: ma.window_reduce(cfg, stats.second, now, rows_g)),
            plain_ms=time_ms(lambda: ma.window_reduce_plain(cfg, stats.second, now, rows_g)),
            library_ms=None,
            shape=f"{N} gathered rows of [{R},2,6]",
            bound=bound(rows_g.numel() * (4 + 2 * 4 + NUM_EVENTS * 4) + valid * NUM_EVENTS * 4),
        )

        nk = N
        dense = torch.zeros(R, dtype=I32, device=DEV)
        blocked = ~adm_g.admitted
        dense.index_add_(0, batch.e_rows[:, 1][blocked].long(), batch.e_acquire[blocked])
        results["flow_admission"].update(
            ms=time_ms(lambda: flush.flow_admission(stats, table, batch, 8)),
            plain_ms=time_ms(lambda: flush.flow_admission_plain(stats, table, batch, 8)),
            library_ms=time_ms(lambda: torch.topk(dense, 8)),
            library_call="torch.topk(k=8) over the [R] blocked weights (the top-K step only)",
            shape=f"N={N} entries x K=1 slot, R={R} rows, top-8",
            # Per slot: gid, check row, ts, the gathered pass sum and thread
            # gauge, the rule's grade/count/behavior; per entry: valid,
            # auth, cluster flags, acquire, 4 rows; out: slot_ok, flow_pass,
            # admitted, reason, the top-8.
            bound=bound(nk * (4 + 4 + 4 + 4 + 4 + 12) + N * (3 + 4 + 16) + nk + N * 6 + 64,
                        ops=nk * 4),
        )

        cfg = nodes.MINUTE_CFG
        st_ = stats.minute
        results["window_update"].update(
            ms=time_ms(lambda: ma.update(cfg, st_, e_rows, e_ts, e_d, None, e_mask), iters=5),
            plain_ms=time_ms(lambda: ma.update_plain(cfg, st_, e_rows, e_ts, e_d, None, e_mask), iters=5),
            library_ms=None,
            shape=f"4N={4 * N} entry updates into the minute window [{R},60,6]",
            bound=bound(update_bytes(cfg, st_, e_rows, e_ts, e_d, None, e_mask)),
        )
        touched = torch.unique(e_rows[e_mask & (e_thr != 0)]).numel()
        sel = e_mask & (e_rows >= 0)
        rows_l, thr_l = e_rows[sel].long(), e_thr[sel]
        thr_buf = stats.threads.clone()
        results["thread_gauge"].update(
            ms=time_ms(lambda: nodes.thread_gauge_add(thr_buf, e_rows, e_thr, e_mask)),
            plain_ms=time_ms(lambda: nodes.thread_gauge_add_plain(thr_buf, e_rows, e_thr, e_mask)),
            library_ms=time_ms(lambda: thr_buf.index_add_(0, rows_l, thr_l)),
            library_call="Tensor.index_add_ over the masked-in rows",
            shape=f"4N={4 * N} updates into [{R}]",
            bound=bound(4 * N * 9 + touched * 8),
        )
        del stats
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: flush_step at the north-star shape
# ---------------------------------------------------------------------------


def phase3() -> None:
    log("phase 3: flush_step at R=1,048,576 rows, N=131,072 entries, K=1")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(3)
    rng = np.random.default_rng(3)
    now = 2_000_000
    table = make_table()
    for with_exits in (False, True):
        base = make_stats(now, gen)
        batch = make_batch(rng, now, skewed=False, with_exits=with_exits)
        kern = clone(base)
        plain = clone(base)
        _, res = flush.flush_step(kern, table, batch, with_exits=with_exits, blk_topk=8)
        _, adm = plain_flush_step(plain, table, batch, with_exits, 8)
        for name in ("admitted", "reason", "slot_ok", "blk_rows", "blk_weight"):
            require_equal(getattr(adm, name), getattr(res, name), f"flush_step {name} (exits={with_exits})")
        require_equal(plain, kern, f"flush_step state (exits={with_exits})")
        del base, plain
        torch.cuda.empty_cache()
        k_ms = time_ms(lambda: flush.flush_step(kern, table, batch, with_exits=with_exits, blk_topk=8), iters=10)
        p_ms = time_ms(lambda: plain_flush_step(kern, table, batch, with_exits, 8), iters=5)
        log(f"  exits={'on' if with_exits else 'off'}: kernels {k_ms:.4f} ms/flush "
            f"({N / k_ms * 1e3:,.0f} entries/s), plain {p_ms:.4f} ms/flush "
            f"({N / p_ms * 1e3:,.0f} entries/s); results and state identical")
        profile_step(kern, table, batch, with_exits)
        del kern
        torch.cuda.empty_cache()


def profile_step(stats, table, batch, with_exits: bool, steps: int = 5) -> None:
    """Where one flush_step's device time goes: torch.profiler (CUPTI)
    over ``steps`` steps, self device time per op per step, largest
    first, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            flush.flush_step(stats, table, batch, with_exits=with_exits, blk_topk=8)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / steps
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / steps, e.key))
    rows.sort(reverse=True)
    busy = sum(us for us, _ in rows)
    if busy == 0:
        log("  profiler: no device time recorded (CUPTI unavailable); breakdown not measured")
        return
    log(f"  profile (exits={'on' if with_exits else 'off'}): device busy {busy:.1f} us of "
        f"{wall_us:.1f} us wall per step under the profiler ({busy / wall_us:.1%})")
    for us, name in rows[:12]:
        log(f"    {us:9.1f} us  {us / busy:6.1%}  {name[:90]}")


# ---------------------------------------------------------------------------
# phase 4: the engine through the public API
# ---------------------------------------------------------------------------

N_RULES = 6000  # the reference's MAX_SLOT_CHAIN_SIZE
FLUSH_N = 32768
STEPS = 100  # 100 ms each: 10 simulated seconds


def drive_engine(device: torch.device, seed: int):
    """One stream on one engine; returns (records, final state, seconds per
    bulk flush)."""
    clock = tclock.ManualClock(0)
    api.reset(clock=clock, device=device)
    st.flow_rule_manager.load_rules([st.FlowRule(f"r{i}", count=20) for i in range(N_RULES)])
    eng = api.get_engine()
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, N_RULES + 1, dtype=np.float64) ** -1.1
    p = ranks / ranks.sum()
    records = []
    prev_groups = []
    flush_s = 0.0
    admitted = 0
    for step in range(STEPS):
        now = 1000 + step * 100
        clock.set_ms(now)
        res = rng.choice(N_RULES, size=FLUSH_N, p=p)
        ts = (now - rng.integers(0, 100, FLUSH_N)).astype(np.int32)
        order = np.argsort(res, kind="stable")
        res, ts = res[order], ts[order]
        uniq, start = np.unique(res, return_index=True)
        bounds = list(start) + [FLUSH_N]
        groups = [
            eng.submit_bulk(f"r{r}", int(bounds[i + 1] - bounds[i]), ts=np.sort(ts[bounds[i]:bounds[i + 1]]))
            for i, r in enumerate(uniq)
        ]
        for g in prev_groups[:50]:  # completions of the last step's admitted entries
            if g.admitted_count:
                eng.submit_exit_bulk(g.rows, g.admitted_count, rt=int(rng.integers(1, 300)), ts=now)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.flush()
        flush_s += time.perf_counter() - t0
        records.append(np.concatenate([g.admitted for g in groups]))
        records.append(np.concatenate([g.reason for g in groups]))
        admitted += int(records[-2].sum())
        prev_groups = groups
        for r in ("r0", "r1", "r7"):
            clock.set_ms(now + 50)
            try:
                e = st.entry(r)
                records.append(np.array([1], np.int32))
                clock.set_ms(now + 60)
                e.exit()
            except st.FlowBlockError:
                records.append(np.array([0], np.int32))
    eng.flush()
    final = nodes.stats_to_numpy(eng.stats)
    blk = eng.last_blocked_topk
    return records, final, blk, flush_s / STEPS, admitted


def phase4(results: dict) -> None:
    log("phase 4: the engine through the public API (6,000 rules, 10 simulated s, 32,768-entry flushes)")
    wrappers = {
        "materialize_matured": nodes.materialize_matured,
        "window_update": ma.update,
        "thread_gauge": nodes.thread_gauge_add,
        "window_sums": ma.window_reduce,
        "flow_admission": flush.flow_admission,
    }
    for w in wrappers.values():
        w.launches = 0
    gpu_records, gpu_state, gpu_blk, gpu_flush_s, admitted = drive_engine(DEV, seed=4)
    counts = {name: w.launches for name, w in wrappers.items()}
    log(f"  card: {gpu_flush_s * 1e3:.3f} ms per 32,768-entry flush call "
        f"({FLUSH_N / gpu_flush_s:,.0f} entries/s, host encode and verdict copy included)")
    log(f"  launches on the main path: {counts}")
    for name, c in counts.items():
        if c <= 0:
            fail(f"kernel {name} was not launched on the main path")
        results[name]["launches"] = c
    cpu_records, cpu_state, cpu_blk, cpu_flush_s, _ = drive_engine(torch.device("cpu"), seed=4)
    log(f"  CPU engine (plain versions): {cpu_flush_s * 1e3:.3f} ms per flush call")
    if len(gpu_records) != len(cpu_records) or any(
        not np.array_equal(a, b) for a, b in zip(gpu_records, cpu_records)
    ):
        fail("engine verdicts differ between the card and the CPU")
    for name in gpu_state._fields:
        a, b = getattr(gpu_state, name), getattr(cpu_state, name)
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        for x, y in pairs:
            if not np.array_equal(x, y):
                fail(f"engine state {name} differs between the card and the CPU")
    for x, y in zip(gpu_blk, cpu_blk):
        if not np.array_equal(x, y):
            fail("engine blocked top-K differs between the card and the CPU")
    log(f"  verdicts ({sum(len(r) for r in gpu_records)} values), blocked top-K and final state "
        f"identical on card and CPU; {admitted} bulk entries admitted")
    if admitted <= 0 or admitted >= STEPS * FLUSH_N:
        fail("phase 4 admitted nothing or everything: the stream did not exercise the rules")


# ---------------------------------------------------------------------------
# phase 5: flow_qps_demo on the port
# ---------------------------------------------------------------------------


def phase5() -> None:
    log("phase 5: flow_qps_demo (8 threads, 3 s of real clock, QPS = 20 rule)")
    tclock.set_default_clock(tclock.SystemClock())
    api.reset(device=DEV)
    st.flow_rule_manager.load_rules([st.FlowRule("methodA", count=20)])
    try:
        st.entry("methodA").exit()  # first call: warm the engine
    except st.FlowBlockError:
        pass
    time.sleep(1.1)
    passes = []
    latencies = []
    lock = threading.Lock()
    stop = threading.Event()
    errors = []

    def worker():
        try:
            while not stop.is_set():
                t_call = time.perf_counter()
                try:
                    with st.entry("methodA"):
                        decided = time.perf_counter()
                        with lock:
                            passes.append(time.monotonic())
                except st.FlowBlockError:
                    decided = time.perf_counter()
                with lock:
                    latencies.append(decided - t_call)
                time.sleep(0.001)
        except Exception as exc:  # reported below, never swallowed
            errors.append(exc)

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(8)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    time.sleep(3.0)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    if any(t.is_alive() for t in threads):
        fail("phase 5 worker threads did not stop")
    if errors:
        fail(f"phase 5 worker raised {errors[0]!r}")
    per_sec = [sum(1 for p in passes if t0 + s <= p < t0 + s + 1) for s in range(3)]
    log(f"  pass/s by second: {per_sec} (rule: 20/s)")
    # The sliding window is two 500 ms buckets, and a wall second can
    # straddle a bucket's expiry: one window's worth (20) more may pass in
    # any one wall second.
    if min(per_sec) < 1 or max(per_sec) > 20 + 20:
        fail(f"phase 5 pass rate off: {per_sec}")
    # Sync entry latency: st.entry call to verdict (one flush per call, 8
    # callers contending for the flush lock), on the card's real clock.
    lat = sorted(latencies)
    n = len(lat)
    q = 0.99 if n >= 1000 else 0.9
    log(f"  st.entry latency over {n} calls: p50 {lat[n // 2] * 1e3:.3f} ms, "
        f"p{round(q * 100)} {lat[int(q * n)] * 1e3:.3f} ms, max {lat[-1] * 1e3:.3f} ms")


def main() -> None:
    t_start = time.perf_counter()
    line = card_line()
    log(f"phase 1: {line}")
    t0 = time.perf_counter()
    cuda_build.build_all(["window_update", "flow_admission"])
    log(f"  CUDA kernels built in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")

    meta = {
        "materialize_matured": ("triton", "sentinel_tpu_torch/metrics/nodes.py",
                                "sentinel_tpu/metrics/nodes.py:155"),
        "window_update": ("cuda", "sentinel_tpu_torch/csrc/window_update.cu",
                          "sentinel_tpu/metrics/metric_array.py:101"),
        "thread_gauge": ("cuda", "sentinel_tpu_torch/csrc/window_update.cu",
                         "sentinel_tpu/metrics/nodes.py:223"),
        "window_sums": ("triton", "sentinel_tpu_torch/metrics/metric_array.py",
                        "sentinel_tpu/metrics/metric_array.py:205"),
        "flow_admission": ("cuda", "sentinel_tpu_torch/csrc/flow_admission.cu",
                           "sentinel_tpu/runtime/flush.py:227"),
    }
    results = {name: {} for name in meta}
    phase2(results)
    phase3()
    phase4(results)
    phase5()

    kernels = []
    for name, (route, source, replaces) in meta.items():
        r = results[name]
        bound_ms, bound_by = r["bound"]
        entry = {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r["library_ms"], "shape": r["shape"],
        }
        if "library_call" in r:
            entry["library_call"] = r["library_call"]
        kernels.append(entry)
    for k in kernels:
        log(f"  {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, bound {k['bound_ms']:.5f} "
            f"by {k['bound_by']}, library {k['library_ms']}), {k['launches']} launches on the main path")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
