"""Smoke run of the PyTorch/CUDA port (sentinel_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from the sources in this checkout
(one nvcc per CUDA source, started together; Triton compiles on first
launch) and then, failing on the first mismatch:

1. prints the card's name and power limit (nvidia-smi);
2. holds every kernel against its plain PyTorch version on the card, at
   the shapes of the main path: 1,048,576 stats rows, 131,072 entries
   with one rule slot, window updates of 4 x 131,072; plus a Zipf-skewed
   case with exits. Then the rest of the slot chain at the same width:
   flow admission with the occupy branch (1/8 of the entries
   prioritized, a partly filled future slab), the borrow commit, the
   system check (thresholds under which every dimension blocks), and the
   breakers (1,048,576 breakers of three grades, CLOSED, OPEN and due,
   HALF_OPEN; 32,768 exits, 30% errors) with the verdict tail, uniform
   and Zipf. Equality is exact (int32 state, float32 compares in the
   same order). Times each kernel, its plain version and, where one
   PyTorch call computes the same function, that call;
3. runs flush_step at that shape with exits off, then on, then with
   every stage on (occupy, system, breakers), through the kernels and
   through the plain versions: identical results and state; prints ms
   per flush and entries/s, and a torch.profiler breakdown of one step's
   device time;
4. drives the engine through the public API (6,000 DEFAULT QPS rules,
   4 simulated seconds of Zipf-skewed submit_bulk traffic in
   32,768-entry flushes, st.entry calls and exits) on the card, with
   every kernel launch counter set to 0 just before and read just after,
   and the same stream on the port's CPU engine: identical verdicts and
   final state; nothing borrows, so the matured-borrow sweep (K1) must
   not run; then the slot chain's stream the same way: breakers on a
   third of the resources, system rules, authority rules on some
   origins, prioritized entries (which borrow: K1 must run), and exits
   that complete the breakers: identical verdicts, wait_ms, attribution,
   stats and breaker state;
5. runs the flow_qps_demo scenario on the card: 8 threads, 3 s of real
   clock, st.entry against a QPS = 20 rule; prints pass/s and the
   st.entry latency percentiles;
6. runs examples/degrade_demo.py's sequence on the card and checks its
   lines;
7. runs examples/param_flow_demo.py's sequence on the card and checks its
   lines.

Traffic shaping and hot parameters (the shaping recurrence K9 with its
input gather, the hot-parameter recurrence K10): phase 2c holds them
against their plain versions at bench.py's mixed shape (1,048,576 rules,
131,072 entries, K = 2, 16,384 rate-limiter items, 32,768 param items)
and on four more cases at the same sizes (every shaping behavior over
several seconds; every param grade and behavior with LRU resets and exit
releases; the closed forms; one rule or value holding every item); K9
with its inputs is one host call (``shaping_stage``), profiled at the
mixed shape and at 8 items, both routes timed at 512-8,192 items;
phase 3 also runs flush_step at the mixed shape (1,024 breakers, 32,768
exits) on both routes; phase 4c drives an engine stream with shaping and
param rules through the public API on the card and on the CPU engine.

The sharded flush (parallel/ici.py, 8 shards on the card): phase 2f
holds its kernels against their plain versions at full width (K13 the
stats merge over 1,048,576 rows, K14 the breaker merge over 1,048,576
breakers, K15 the budget split of 131,072 Zipf entries with K = 1, an
origin split and the mixed shape's K = 2, and at full width with acquires
up to 2^29 against counts near 2^31, so that the shards' units pass 2^31
(each shard's own prefix); profiled at full width (grant, borrow, K = 2)
and at 8 slots, both routes timed at 512-8,192 slots, the zeroed
scratch checked after; K16 the global shaping charge at the mixed
shape's 16,384 items and at 8, both routes timed at 512-8,192 items, and
its edges on the default route at 1,024, 1,025 and 16,384 items: every
item invalid, one row, one ts, negative ts, charges past 2^31; K8 with
the probe election's mask); phase 3b runs the sharded step at
the slot chain's and the mixed shape through the kernels and through the
plain versions (identical results and state; ms per step, a profile,
peak device memory); phase 4e drives the engine with enable_mesh(8)
through submit_many, submit_bulk and exits against the CPU engine with
the same mesh, and checks that 128 same-window entries against count 20
admit exactly 20; phase 9 runs examples/mesh_demo.py's sequence.

The token service's decision (K12) is held against its plain version in
phase 2e on a token server's stream at 16,384 requests a batch and at 8,
64 and 1,024, and with each batch's int32 cumsum past 2^31; phase 8
drives it through st.entry on cluster-mode rules. Phases 2, 2b, 2c, 2d,
2e and 2f also print the device kernels, memsets and device time of one
call of the matured-borrow sweep (K1, on the swept slab and with 2% of
its cells matured), the window update (K2), the fused apply_updates (both
windows' K2 and the thread gauge, at 4N updates and at N = 8), the flow
admission (K4, both routes, at
131,072 entries and at 8; its time at 32,768 too), the system check (K6)
and the breaker entry check (K8, and with the mask also at a mesh shard's
4,096 slots) at 131,072 entries and at 8, the shaping and hot-parameter
recurrences (K9 with its inputs, K10; at the mixed shape and at 8 items),
the budget split (K15, at 131,072 entries and 8 slots), the slot chain's
verdict tail, the borrow commit (K5) and the breaker completions (K7; at
131,072 entries or 32,768 exits, uniform and Zipf, also by kernel, and at
8), the sketch fold (K11; at 131,072 keys, with and without decay, also
by kernel, the widened tier's by kernel, and at 8 keys) and K12
(torch.profiler, gpu_timing.py), and fail if the profiler reads no
kernel, if K2 issues more than four kernels and memsets a call, K1
anything but one kernel, apply_updates anything but two, or if K4,
K5, K6, K7, K8, K9, K10, K11, K12, K15 or the tail issue anything but one
kernel at 8 entries, exits, keys, items, slots or requests. For K5-K9,
K11, K15 and the tail they also time both routes at the sizes where the
route is chosen (2,048, 4,096 and 8,192, for K5, K7, K9, K11, K15 and the
tail also 512 and 1,024; with the mask 4,096), each equal to the plain
version. Phase 2 also holds K3 (the windowed sums and min RT) and
row_stats (K3 with the gauge and the slab: the engine's stats read, one
record a row) against their plain versions at 131,072 gathered rows and
profiles them, row_stats also at 3 rows. Phase 4 reads
cluster_node_stats every tenth flush (row_stats, one launch a read), on
the card and on the CPU engine, as a path of its own: K3 is off the flush
path, and the launches of row_stats on the kernels line are those of
these reads (K3's own are 0 there: its launches on the line are the
token service's flow_stats reads, phase 8).

The host pipeline (the engine's encode arena, one copy each way, the
deferred fetch): phases 4 and 5 print the median host split of their
flushes (``Engine.last_flush_host_ms``); phase 4f runs phase 4's stream
again at pipeline depth 2 and through ``flush_async`` (identical to depth
0 and to the CPU engine), then a variant whose verdict reads lag three
flushes (so that flushes stay in flight) at depth 0, depth 2 and through
``flush_async``, in turns, against the CPU engine at depth 0: each
``flush_async`` dispatch under ``torch.cuda.set_sync_debug_mode("error")``
(a sync fails the phase), the syncs of a depth-2 flush counted in "warn"
mode, the flush call's ms, the host split, ``pipeline_stats`` and the
device busy share over ten flushes (torch.profiler); then the 4b-4e
streams again with each bulk dispatch through ``flush_async`` in "warn"
mode, printing the syncs a dispatch, their verdicts equal to the CPU's.

The CPU sides of phases 2c (d), 4-4f and 8 (the plain versions on one
heavy segment, the CPU engines) run in four worker processes, started
before the build, beside the card's phases (phase 3 runs before 2c so
that case (d)'s references are ready); the workers stop with the script.
The run prints its seconds per phase before the kernels line.

Its output ends with a ``{"kernels": [...]}`` line, the card's name and
power limit, and ``{"ok": true, "device": {...}}`` as the last line. It
exits non-zero, with no result, without CUDA or without the rest of the
checkout beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    if WORKERS is not None:
        WORKERS.terminate()
    sys.exit(1)


WORKERS = None  # the worker processes that run the CPU references (main)


if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
    sys.exit(2)

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
try:
    import sentinel_tpu_torch as st
    import sentinel_tpu_torch.cluster as tcl
    from sentinel_tpu_torch.cluster import token_service as tts
    from sentinel_tpu_torch.core import api
    from sentinel_tpu_torch.metrics import metric_array as ma
    from sentinel_tpu_torch.metrics import nodes
    from sentinel_tpu_torch.metrics.events import NUM_EVENTS
    from sentinel_tpu_torch.models import constants as C
    from sentinel_tpu_torch.models.rules import ClusterFlowConfig
    from sentinel_tpu_torch.parallel import ici, make_mesh
    from sentinel_tpu_torch.rules import degrade_table as tdt
    from sentinel_tpu_torch.rules import param_table as tpt
    from sentinel_tpu_torch.rules import shaping as tsh
    from sentinel_tpu_torch.rules.flow_table import FlowTableDevice, flow_table_from_numpy
    from sentinel_tpu_torch.runtime import flush
    from sentinel_tpu_torch.runtime import sketch as tsk
    from sentinel_tpu_torch.utils import clock as tclock
    from sentinel_tpu_torch.utils import cuda_build
    from gpu_timing import TD_B, TD_FLOWS, TD_NS, device_profile, kernel_times, time_ms, time_ms_fresh, token_batch
except ImportError as exc:
    print(f"chip_smoke: the sentinel_tpu_torch package or gpu_timing.py is not beside this script ({exc})",
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


def profile(fn, what: str):
    """:func:`gpu_timing.device_profile` of ``fn``; fails the run when the
    profiler reads no kernel."""
    try:
        return device_profile(fn)
    except RuntimeError as exc:
        fail(f"{what}: {exc}")


def max_abs_err(a, b) -> int:
    """Largest absolute difference over two tensors or (nested) tuples."""
    if isinstance(a, tuple):
        return max((max_abs_err(x, y) for x, y in zip(a, b) if x is not None), default=0)
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    if a.dtype.is_floating_point:  # bit for bit: compare the float32 words
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
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


def sub_batch(batch: flush.FlushBatch, n: int) -> flush.FlushBatch:
    """The first ``n`` entries of ``batch`` (its exits unchanged)."""
    return batch._replace(**{f: getattr(batch, f)[:n] for f in flush.FlushBatch._fields if f.startswith("e_")})


def fa_bytes(n: int, nk: int) -> float:
    """Least bytes of K4's DEFAULT path with its tail and top-8: per slot
    its gid, check row and ts, its row's two second-window buckets (start
    and PASS) and thread gauge, the rule's grade/count/behavior; per entry
    valid, auth, cluster flags, acquire and 4 rows; out: slot_ok,
    flow_pass, admitted, reason, the top-8."""
    return nk * (4 + 4 + 4 + 16 + 4 + 12) + n * (3 + 4 + 16) + nk + n * 6 + 64


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


ND = R  # breakers: one per resource
M = N // 4  # exits per flush


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper the flush step calls swapped for its plain
    version: the comparison side of the slot chain's step."""
    swaps = [
        (flush, "materialize_matured", nodes.materialize_matured_plain),
        (flush, "apply_updates", nodes.apply_updates_plain),
        (flush, "flow_admission", flush.flow_admission_plain),
        (flush, "system_check", flush.system_check_plain),
        (flush, "commit_borrow_slab", flush.commit_borrow_slab_plain),
        (flush, "slot_chain_verdict", flush.slot_chain_verdict_plain),
        (tdt, "breaker_on_exits", tdt.breaker_on_exits_plain),
        (tdt, "breaker_try_pass", tdt.breaker_try_pass_plain),
        (flush, "shaping_stage", tsh.shaping_stage_plain),
        (flush, "run_param", tpt.run_param_plain),
        (flush, "sketch_fold", tsk.sketch_fold_plain),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def make_chain_stats(now: int, gen) -> nodes.StatsState:
    """make_stats where borrows can fit: on half the rows the window that
    expires next holds most of the pass and the current one little; 30%
    of the slab's cells hold a few tokens for the next two windows; the
    global inbound row 0 holds a known window (pass 20, success 10, RT sum
    600, min RT 20/30) and no threads."""
    s = make_stats(now, gen)
    wlen = nodes.SECOND_CFG.window_len_ms
    cur = now - now % wlen
    idx = (cur // wlen) % 2
    pick = torch.rand(R, generator=gen, device=DEV) < 0.5
    ws, counts = s.second.window_start, s.second.counts
    ws[:, idx] = torch.where(pick, cur, ws[:, idx])
    ws[:, 1 - idx] = torch.where(pick, cur - wlen, ws[:, 1 - idx])
    counts[:, idx, 0] = torch.where(pick, torch.randint(0, 2, (R,), generator=gen, device=DEV, dtype=I32),
                                    counts[:, idx, 0])
    counts[:, 1 - idx, 0] = torch.where(pick, torch.randint(15, 30, (R,), generator=gen, device=DEV, dtype=I32),
                                        counts[:, 1 - idx, 0])
    fut = torch.rand((R, 2), generator=gen, device=DEV) < 0.3
    target = torch.tensor([0, 0], dtype=I32, device=DEV)
    target[1 - idx], target[idx] = cur + wlen, cur + 2 * wlen
    s.future_ws.copy_(torch.where(fut, target[None, :], s.future_ws))
    s.future_pass.copy_(torch.where(fut, torch.randint(1, 4, (R, 2), generator=gen, device=DEV, dtype=I32), 0))
    counts[0] = 0
    counts[0, :, 0], counts[0, :, 3], counts[0, :, 4] = 10, 5, 300
    s.second.min_rt[0] = torch.tensor([20, 30], dtype=I32, device=DEV)
    ws[0, idx], ws[0, 1 - idx] = cur, cur - wlen
    s.threads[0] = 0
    return s


def make_chain_batch(rng, now: int, skewed: bool) -> flush.FlushBatch:
    """make_batch with exits, plus: half the entries inbound, 1/8
    prioritized, 3% refused by authority, each entry's and exit's breaker
    (one per resource), errors on 30% of the exits."""
    b = make_batch(rng, now, skewed=skewed, with_exits=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    rows = b.e_rows.clone()
    rows[:, 3] = torch.where(t(rng.random(N) < 0.5), 0, -1)  # half the entries inbound
    return b._replace(
        e_rows=rows,
        e_prio=t(rng.random(N) < 1 / 8), e_auth_ok=t(rng.random(N) < 0.97),
        e_dgid=b.e_rule_gid.clone(), x_dgid=b.x_rows[:, 1:2].contiguous(),
        x_err=t((rng.random(M) < 0.3).astype(np.int32)),
    )


def make_breakers(now: int, gen):
    """ND breakers of the three grades, CLOSED (60%), OPEN (25%, about
    half of them due) and HALF_OPEN (15%), 5% with min_request at its
    padding value, windows current or superseded."""
    def ri(lo, hi):
        return torch.randint(lo, hi, (ND,), generator=gen, device=DEV, dtype=I32)

    u = torch.rand(ND, generator=gen, device=DEV)
    grade = ri(0, 3)
    thr = torch.where(grade == 0, ri(50, 150).float(),
                      torch.where(grade == 1, 0.3 + 0.4 * u, ri(2, 7).float())).float()
    min_req = torch.where(u < 0.05, 2**31 - 1, ri(2, 6)).to(I32)
    table = tdt.DegradeTableDevice(
        grade=grade, threshold=thr.contiguous(), slow_ratio=torch.full((ND,), 0.5, device=DEV),
        min_request=min_req, interval_ms=torch.full((ND,), 1000, dtype=I32, device=DEV),
        retry_ms=torch.full((ND,), 5000, dtype=I32, device=DEV), max_rt=(thr + 0.5).to(I32),
    )
    v = torch.rand(ND, generator=gen, device=DEV)
    state = torch.where(v < 0.6, 0, torch.where(v < 0.85, 1, 2)).to(I32)
    bad = ri(0, 4)
    dyn = tdt.DegradeDynState(
        state=state, next_retry=(now + ri(-2000, 2000)).to(I32), bad=bad, total=(bad + ri(0, 4)).to(I32),
        ws=(now - now % 1000 - 1000 * ri(0, 2)).to(I32),
    )
    return table, dyn


def sys_device(case: str) -> flush.SystemDevice:
    """Thresholds under which every dimension blocks some of a batch's
    N/2 inbound entries: QPS past inbound rank ~0.4 N, threads past 0.25 N;
    with "rt" the average RT (60 ms) blocks the rest, without it BBR load
    blocks from rank 2 and the CPU below that."""
    inf = float("inf")
    rt = 10.0 if case == "rt" else inf
    return flush.SystemDevice(float(0.4 * N), float(0.25 * N), rt, 1.0, 0.5, 5.0, 0.9)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def update_bytes(cfg, state, rows, ts, deltas, rt, mask, with_batch: bool = True) -> float:
    """Least bytes of one window update on these inputs: each input read
    once (``with_batch``); each touched bucket reads its window start, and
    an adding one its counts and min RT too; each touched bucket writes
    counts, min RT and window start."""
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
    per_entry = 4 + 4 + 1 + 4 * NUM_EVENTS + (4 if rt is not None else 0) if with_batch else 0
    return n * per_entry + len(uniq) * 4 + same * (4 * NUM_EVENTS + 4) + touched * (4 * NUM_EVENTS + 8)


def k1_matured(results: dict, stats: nodes.StatsState, now: int, src) -> None:
    """K1 on a slab with 2% of its cells matured (``src``: the slab and the
    second window before the sweep), restored before each call and left
    out of the time; the profile leaves the restoring copies out too."""
    fws, fpass, second = src

    def restore():
        stats.future_ws.copy_(fws)
        stats.future_pass.copy_(fpass)
        for t, s in zip(stats.second, second):
            t.copy_(s)

    sweep = lambda: nodes.materialize_matured(stats, now)
    kern, mems, dev_ms = profile(lambda: (restore(), sweep()), "phase 2: the sweep with matured cells")
    r = results["materialize_matured"]
    r.update(matured_ms=time_ms_fresh(restore, sweep), matured_launches_per_call=kern, matured_memsets_per_call=mems,
             matured_device_ms=dev_ms, matured_cells=int((fws != nodes.SECOND_CFG.empty_ws).sum()))
    log(f"  K1 with {r['matured_cells']:,} borrowed cells (Zipf case): {r['matured_ms']:.4f} ms a call, {kern} "
        f"device kernels, {mems} memsets, {dev_ms:.4f} ms of device time (profiler)")
    if (kern, mems) != (1, 0):
        fail(f"phase 2: K1 with matured cells issued {kern} kernels and {mems} memsets in one call")
    restore()


def row_stats_bytes(stats: nodes.StatsState, rows: torch.Tensor, now: int) -> float:
    """Bytes row_stats must move for ``rows``: each row's index, both
    windows' starts, the counts (and the second window's min RT) of the
    buckets that count, the gauge, the slab, and its 16-int32 record."""
    r = rows.long()
    sec_valid = int(((now - stats.second.window_start[r]) <= nodes.SECOND_CFG.interval_ms).sum())
    min_valid = int(((now - stats.minute.window_start[r]) <= nodes.MINUTE_CFG.interval_ms).sum())
    per_row = 4 + 4 * (nodes.SECOND_CFG.sample_count + nodes.MINUTE_CFG.sample_count) + 4 + 8 * 2 + 4 * nodes.RS_WIDTH
    return r.numel() * per_row + sec_valid * (NUM_EVENTS + 1) * 4 + min_valid * NUM_EVENTS * 4


def row_stats_phase2(results: dict, stats: nodes.StatsState, rows_g: torch.Tensor, now: int) -> None:
    """Times and profiles row_stats at the gathered rows and at 3 rows;
    fails unless each call is one kernel and no memset."""
    full = lambda: nodes.rows_stats(stats, rows_g, now)
    three = rows_g[-3:].contiguous()
    small = lambda: nodes.rows_stats(stats, three, now)
    launches, memsets, dev_ms = profile(full, "phase 2: row_stats")
    s_launches, s_memsets, s_dev = profile(small, "phase 2: row_stats at 3 rows")
    results["row_stats"].update(
        ms=time_ms(full), plain_ms=time_ms(lambda: nodes.rows_stats_plain(stats, rows_g, now)), library_ms=None,
        shape=f"{rows_g.numel():,} gathered rows of both windows, the gauge and the slab of {R:,} rows",
        bound=bound(row_stats_bytes(stats, rows_g, now)), launches_per_call=launches, memsets_per_call=memsets,
        device_ms=dev_ms, small_ms=time_ms(small), small_launches_per_call=s_launches,
        small_memsets_per_call=s_memsets, small_device_ms=s_dev,
        small_bound_ms=bound(row_stats_bytes(stats, three, now))[0],
        small_plain_ms=time_ms(lambda: nodes.rows_stats_plain(stats, three, now)))
    r = results["row_stats"]
    log(f"  row_stats at {rows_g.numel():,} gathered rows: {r['ms']:.4f} ms a call, {launches} device kernels, "
        f"{memsets} memsets, {dev_ms:.4f} ms of device time (bound {r['bound'][0]:.4f} ms); at 3 rows "
        f"{r['small_ms']:.4f} ms, {s_launches} kernels, {s_memsets} memsets, {s_dev:.4f} ms of device time")
    if (launches, memsets) != (1, 0) or (s_launches, s_memsets) != (1, 0):
        fail(f"phase 2: row_stats issued {launches} + {memsets} ({s_launches} + {s_memsets} at 3 rows) kernels "
             "and memsets in one call")


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

        # K1 materialize_matured [R, 2]; the Zipf case's slab has 2% of its
        # cells matured, profiled from a fresh copy each call.
        if skewed:
            k1_src = (stats.future_ws.clone(), stats.future_pass.clone(), clone(stats.second))
        want = nodes.materialize_matured_plain(clone(stats), now)
        got = nodes.materialize_matured(clone(stats), now)
        err1 = require_equal(want, got, f"materialize_matured ({tag})")
        # K3 window sums at the sorted check rows (N rows of [R, 2, 6]), and all rows
        rows_g = torch.sort(batch.e_check_row.reshape(-1)).values
        for r in (rows_g, None):
            w = ma.window_reduce_plain(nodes.SECOND_CFG, stats.second, now, r, with_min=True)
            g = ma.window_reduce(nodes.SECOND_CFG, stats.second, now, r, with_min=True)
            err3 = require_equal(w, g, f"window_sums ({tag}, rows={'gather' if r is not None else 'all'})")
        # row_stats (K3 with the gauge and the slab) at the same rows and at 3
        err_rs = max(require_equal(nodes.rows_stats_plain(stats, r, now), nodes.rows_stats(stats, r, now),
                                   f"row_stats ({tag}, {r.numel()} rows)") for r in (rows_g, rows_g[-3:]))
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
        # The fused apply_updates (both windows and the thread gauge)
        w = nodes.apply_updates_plain(clone(stats), e_rows, e_ts, e_d, None, e_thr, e_mask)
        g = nodes.apply_updates(clone(stats), e_rows, e_ts, e_d, None, e_thr, e_mask)
        errg = require_equal(w, g, f"apply_updates ({tag})")
        if skewed:  # the exits' update: RT samples, negative thread deltas
            w = nodes.apply_updates_plain(clone(stats), x_rows, x_ts, x_d, x_rt, x_thr, x_mask)
            g = nodes.apply_updates(clone(stats), x_rows, x_ts, x_d, x_rt, x_thr, x_mask)
            errg = max(errg, require_equal(w, g, f"apply_updates ({tag}, exits)"))
        for name, err in (("materialize_matured", err1), ("window_sums", err3), ("row_stats", err_rs),
                          ("flow_admission", err4), ("window_update", err2), ("thread_gauge", errg)):
            results[name]["max_abs_err"] = max(results[name].get("max_abs_err", 0), err)
        log(f"  {tag}: all six kernels equal their plain versions (max abs err 0)")
        if skewed:
            k1_matured(results, stats, now, k1_src)
            continue

        # Timing on the uniform (headline) case.
        m1 = stats.future_ws.numel()
        results["materialize_matured"].update(
            ms=time_ms(lambda: nodes.materialize_matured(stats, now)),
            plain_ms=time_ms(lambda: nodes.materialize_matured_plain(stats, now)),
            library_ms=None,
            shape=f"slab [{R},2], second window [{R},2,6]",
        )
        # Matured cells are none once swept: every cell is (empty_ws, 0),
        # which the sweep reads (both words: an empty start may still hold
        # tokens to clear) and does not write.
        results["materialize_matured"]["bound"] = bound(m1 * 8)
        k1_launches, k1_memsets, k1_dev = profile(lambda: nodes.materialize_matured(stats, now),
                                                  "phase 2: the matured-borrow sweep")
        results["materialize_matured"].update(launches_per_call=k1_launches, memsets_per_call=k1_memsets,
                                              device_ms=k1_dev)
        log(f"  K1 on the swept slab: {results['materialize_matured']['ms']:.4f} ms a call, {k1_launches} device "
            f"kernels, {k1_memsets} memsets, {k1_dev:.4f} ms of device time a call (profiler)")
        if (k1_launches, k1_memsets) != (1, 0):
            fail(f"phase 2: K1 issued {k1_launches} kernels and {k1_memsets} memsets in one call")

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
        k3_launches, k3_memsets, k3_dev = profile(lambda: ma.window_reduce(cfg, stats.second, now, rows_g),
                                                  "phase 2: the window sums")
        results["window_sums"].update(launches_per_call=k3_launches, memsets_per_call=k3_memsets, device_ms=k3_dev)
        log(f"  K3 at {N:,} gathered rows: {results['window_sums']['ms']:.4f} ms a call, {k3_launches} device "
            f"kernels, {k3_memsets} memsets, {k3_dev:.4f} ms of device time a call (profiler)")
        row_stats_phase2(results, stats, rows_g, now)

        nk = N
        dense = torch.zeros(R, dtype=I32, device=DEV)
        blocked = ~adm_g.admitted
        dense.index_add_(0, batch.e_rows[:, 1][blocked].long(), batch.e_acquire[blocked])
        fa = lambda: flush.flow_admission(stats, table, batch, 8)
        results["flow_admission"].update(
            ms=time_ms(fa),
            plain_ms=time_ms(lambda: flush.flow_admission_plain(stats, table, batch, 8)),
            library_ms=time_ms(lambda: torch.topk(dense, 8)),
            library_call="torch.topk(k=8) over the [R] blocked weights (the top-K step only)",
            shape=f"N={N} entries x K=1 slot, R={R} rows, top-8; ms_32768 at the first 32,768 entries, "
                  "small_ms at the first 8",
            bound=bound(fa_bytes(N, nk), ops=nk * 4),
        )
        # The same rows at the engine's 32,768-entry flushes and at the 8
        # entries st.entry sends (the one-block route), against the plain
        # version; device kernels and memsets a call from the profiler.
        launches, memsets, dev_ms = profile(fa, f"phase 2: the flow admission at N={N}")
        b32, b8 = sub_batch(batch, 32768), sub_batch(batch, 8)
        for b_, n_ in ((b32, 32768), (b8, 8)):
            err4 = max(err4, require_equal(flush.flow_admission_plain(stats, table, b_, 8),
                                           flush.flow_admission(stats, table, b_, 8), f"flow_admission (N={n_})"))
        small = lambda: flush.flow_admission(stats, table, b8, 8)
        s_launches, s_memsets, s_dev = profile(small, "phase 2: the flow admission at N=8")
        results["flow_admission"].update(
            max_abs_err=err4, launches_per_call=launches, memsets_per_call=memsets, device_ms=dev_ms,
            ms_32768=time_ms(lambda: flush.flow_admission(stats, table, b32, 8)), small_ms=time_ms(small),
            small_launches_per_call=s_launches, small_memsets_per_call=s_memsets, small_device_ms=s_dev,
            small_bound_ms=bound(fa_bytes(8, 8), ops=8 * 4)[0],
        )
        r4 = results["flow_admission"]
        log(f"  K4 at N={N}: {r4['ms']:.4f} ms a call, {launches} device kernels, {memsets} memsets, "
            f"{dev_ms:.4f} ms of device time; N=32,768: {r4['ms_32768']:.4f} ms; N=8: {r4['small_ms']:.4f} ms, "
            f"{s_launches} kernels, {s_memsets} memsets, {s_dev:.4f} ms of device time (profiler)")
        if (s_launches, s_memsets) != (1, 0):
            fail(f"phase 2: K4 at N=8 issued {s_launches} kernels and {s_memsets} memsets in one call")

        cfg = nodes.MINUTE_CFG
        st_ = stats.minute
        results["window_update"].update(
            bound=bound(update_bytes(cfg, st_, e_rows, e_ts, e_d, None, e_mask)),
            ms=time_ms(lambda: ma.update(cfg, st_, e_rows, e_ts, e_d, None, e_mask), iters=5),
            plain_ms=time_ms(lambda: ma.update_plain(cfg, st_, e_rows, e_ts, e_d, None, e_mask), iters=5),
            library_ms=None,
            shape=f"4N={4 * N} entry updates into the minute window [{R},60,6]",
        )
        k2_launches, k2_memsets, k2_dev = profile(lambda: ma.update(cfg, st_, e_rows, e_ts, e_d, None, e_mask),
                                                  "phase 2: the window update")
        results["window_update"].update(launches_per_call=k2_launches, memsets_per_call=k2_memsets, device_ms=k2_dev)
        log(f"  K2 at 4N updates (minute window): {results['window_update']['ms']:.4f} ms a call, "
            f"{k2_launches} device kernels, {k2_memsets} memsets and {k2_dev:.4f} ms of device time a call "
            "(profiler)")
        if k2_launches + k2_memsets > 4:
            fail(f"phase 2: the window update issued {k2_launches} kernels and {k2_memsets} memsets in one call")
        # The thread gauge rides in the fused apply_updates: the call's
        # numbers, at the entry accounting's 4N updates and at N = 8.
        touched = torch.unique(e_rows[e_mask & (e_thr != 0)]).numel()
        sel = e_mask & (e_rows >= 0)
        rows_l, thr_l = e_rows[sel].long(), e_thr[sel]
        thr_buf = stats.threads.clone()
        apply = lambda m: lambda: nodes.apply_updates(stats, e_rows[:m], e_ts[:m], e_d[:m], None, e_thr[:m],
                                                      e_mask[:m])
        apply_b = (4 * N * (4 + 4 + 1 + 4 * NUM_EVENTS + 4) + touched * 8
                   + update_bytes(nodes.SECOND_CFG, stats.second, e_rows, e_ts, e_d, None, e_mask, with_batch=False)
                   + update_bytes(nodes.MINUTE_CFG, stats.minute, e_rows, e_ts, e_d, None, e_mask, with_batch=False))
        results["thread_gauge"].update(
            bound=bound(apply_b),
            ms=time_ms(apply(4 * N)),
            plain_ms=time_ms(lambda: nodes.apply_updates_plain(stats, e_rows, e_ts, e_d, None, e_thr, e_mask), iters=3),
            library_ms=time_ms(lambda: thr_buf.index_add_(0, rows_l, thr_l)),
            library_call="Tensor.index_add_ over the masked-in rows (the gauge step only)",
            shape=f"apply_updates: 4N={4 * N} entry updates into both windows ([{R},2,6], [{R},60,6]) and the "
                  f"gauge [{R}]; small_* at N=8 (32 updates)",
        )
        a_launches, a_memsets, a_dev = profile(apply(4 * N), "phase 2: apply_updates")
        w = nodes.apply_updates_plain(clone(stats), e_rows[:32], e_ts[:32], e_d[:32], None, e_thr[:32], e_mask[:32])
        g = nodes.apply_updates(clone(stats), e_rows[:32], e_ts[:32], e_d[:32], None, e_thr[:32], e_mask[:32])
        errg = max(errg, require_equal(w, g, "apply_updates (N=8)"))
        s_launches, s_memsets, s_dev = profile(apply(32), "phase 2: apply_updates at N=8")
        small_b = (32 * (4 + 4 + 1 + 4 * NUM_EVENTS + 4) + 4 * 8
                   + update_bytes(nodes.SECOND_CFG, stats.second, e_rows[:32], e_ts[:32], e_d[:32], None,
                                  e_mask[:32], with_batch=False)
                   + update_bytes(nodes.MINUTE_CFG, stats.minute, e_rows[:32], e_ts[:32], e_d[:32], None,
                                  e_mask[:32], with_batch=False))
        results["thread_gauge"].update(
            max_abs_err=max(results["thread_gauge"]["max_abs_err"], errg), launches_per_call=a_launches,
            memsets_per_call=a_memsets, device_ms=a_dev, kernel_us=kernel_times(apply(4 * N)),
            small_ms=time_ms(apply(32)), small_launches_per_call=s_launches, small_memsets_per_call=s_memsets,
            small_device_ms=s_dev, small_bound_ms=bound(small_b)[0],
        )
        r = results["thread_gauge"]
        log(f"  apply_updates (both windows and the gauge) at 4N updates: {r['ms']:.4f} ms a call, {a_launches} "
            f"device kernels, {a_memsets} memsets, {a_dev:.4f} ms of device time {r['kernel_us']}; N=8: "
            f"{r['small_ms']:.4f} ms, {s_launches} kernels, {s_memsets} memsets, {s_dev:.4f} ms (profiler)")
        if (a_launches, a_memsets) != (2, 0) or (s_launches, s_memsets) != (2, 0):
            fail(f"phase 2: apply_updates issued {a_launches} + {a_memsets} ({s_launches} + {s_memsets} at N=8) "
                 "kernels and memsets in one call")
        del stats
        torch.cuda.empty_cache()


def sub_adm(adm: flush.Admission, n: int) -> flush.Admission:
    """The admission of the first n entries."""
    return flush.Admission(*(None if t is None else t[:n] for t in adm))


def slab_only(stats: nodes.StatsState) -> nodes.StatsState:
    """The stats with a private copy of the future slab (all K5 writes)."""
    return stats._replace(future_pass=stats.future_pass.clone(), future_ws=stats.future_ws.clone())


def call_profile(results: dict, name: str, call, small_call, small_plain, what: str, small_timed=None) -> None:
    """Device kernels, memsets and device ms a call of ``call`` (full
    width) and of ``small_call`` (8 entries, equal to ``small_plain``); the
    phase fails unless the 8 entries take one kernel and no memset.
    ``small_timed`` (default ``small_call``) is what is profiled and timed
    at 8, for a kernel whose compared calls each start from a fresh copy
    of the state it writes."""
    small_timed = small_timed or small_call
    launches, memsets, dev_ms = profile(call, f"{what}: {name}")
    err = require_equal(small_plain(), small_call(), f"{name} (N=8)")
    s_launches, s_memsets, s_dev = profile(small_timed, f"{what}: {name} at N=8")
    r = results[name]
    r.update(launches_per_call=launches, memsets_per_call=memsets, device_ms=dev_ms, small_ms=time_ms(small_timed),
             small_launches_per_call=s_launches, small_memsets_per_call=s_memsets, small_device_ms=s_dev,
             max_abs_err=max(r.get("max_abs_err", 0), err))
    log(f"    {name}: {launches} device kernels, {memsets} memsets, {dev_ms:.4f} ms of device time a call; N=8: "
        f"{r['small_ms']:.4f} ms, {s_launches} kernels, {s_memsets} memsets, {s_dev:.4f} ms of device time")
    if (s_launches, s_memsets) != (1, 0):
        fail(f"{what}: {name} at N=8 issued {s_launches} kernels and {s_memsets} memsets in one call")


def route_times(results: dict, name: str, mod, const: str, call_at, plain_at, sizes, what: str,
                timed_at=None) -> None:
    """Each size through the one-block route and then the many-block one
    (``mod.<const>`` set to 8,192, the one-block route's capacity, then to
    0), each equal to the plain version: {size: [one-block ms, its device
    ms, many-block ms, its device ms]} under ``routes``, beside the
    threshold in use (``small_max``). ``timed_at`` (default ``call_at``)
    gives what is timed, as ``small_timed`` in :func:`call_profile`."""
    saved = getattr(mod, const)
    routes = {}
    try:
        for n in sizes:
            call = call_at(n)
            timed = (timed_at or call_at)(n)
            want = plain_at(n)()
            row = []
            for small in (8192, 0):
                setattr(mod, const, small)
                require_equal(want, call(), f"{name} at {n} (one-block route up to {small})")
                row += [time_ms(timed), profile(timed, f"{what}: {name} at {n}")[2]]
            routes[str(n)] = row
    finally:
        setattr(mod, const, saved)
    results[name].update(routes=routes, small_max=saved)
    log(f"    {name} routes, [one block ms, device ms, many blocks ms, device ms] by size (threshold {saved}): "
        + ", ".join(f"{n}: [{', '.join(f'{v:.4f}' for v in row)}]" for n, row in routes.items()))


def phase2_chain(results: dict) -> None:
    log("phase 2b: the rest of the slot chain against the plain versions (occupy, borrow commit, "
        "system, breakers, verdict tail)")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(21)
    rng = np.random.default_rng(21)
    now = 1_000_137  # 137 ms into the window: a borrow's wait is under 500 ms
    table = make_table()
    for skewed in (False, True):
        tag = "zipf" if skewed else "uniform"
        stats = make_chain_stats(now, gen)
        batch = make_chain_batch(rng, now, skewed)
        ddev, dyn = make_breakers(now, gen)
        sysdev = sys_device("rt" if not skewed else "bbr")
        errs = {}
        # K6 system_check
        live0 = batch.e_valid & batch.e_auth_ok
        w = flush.system_check_plain(stats, sysdev, batch, live0)
        g = flush.system_check(stats, sysdev, batch, live0)
        errs["system_check"] = require_equal(w, g, f"system_check ({tag})")
        sys_ok, sys_type = g
        live = live0 & sys_ok
        # K4 with the occupy branch
        w = flush.flow_admission_plain(stats, table, batch, 0, live, 500, True, False)
        adm = flush.flow_admission(stats, table, batch, 0, live, 500, True, False)
        errs["flow_admission_occupy"] = require_equal(w, adm, f"flow_admission with occupy ({tag})")
        # K7 breaker_on_exits
        w = tdt.breaker_on_exits_plain(ddev, clone(dyn), batch.x_dgid, batch.x_ts, batch.x_rt, batch.x_err,
                                       batch.x_valid)
        dyn_x = tdt.breaker_on_exits(ddev, clone(dyn), batch.x_dgid, batch.x_ts, batch.x_rt, batch.x_err,
                                     batch.x_valid)
        errs["breaker_on_exits"] = require_equal(w, dyn_x, f"breaker_on_exits ({tag})")
        # K8 breaker_try_pass, against the post-exit state
        e_live = live & adm.flow_pass & batch.e_cluster_ok & ~adm.occupied
        w = tdt.breaker_try_pass_plain(ddev, dyn_x, batch.e_dgid, batch.e_ts, e_live)
        dslot_ok, probe = tdt.breaker_try_pass(ddev, dyn_x, batch.e_dgid, batch.e_ts, e_live)
        errs["breaker_try_pass"] = require_equal(w, (dslot_ok, probe), f"breaker_try_pass ({tag})")
        # The verdict tail with the probe transitions
        dyn_w, dyn_g = clone(dyn_x), clone(dyn_x)
        wv = flush.slot_chain_verdict_plain(batch, adm, sys_ok, dslot_ok, probe, dyn_w, R, 8)
        v = flush.slot_chain_verdict(batch, adm, sys_ok, dslot_ok, probe, dyn_g, R, 8)
        errs["slot_chain_verdict"] = max(require_equal(wv, v, f"slot_chain_verdict ({tag})"),
                                         require_equal(dyn_w, dyn_g, f"probe transitions ({tag})"))
        # K5 commit_borrow_slab of the admitted borrows
        w = flush.commit_borrow_slab_plain(slab_only(stats), v.occ_slot, adm.occ_target, batch.e_acquire,
                                           batch.e_check_row)
        g = flush.commit_borrow_slab(slab_only(stats), v.occ_slot, adm.occ_target, batch.e_acquire,
                                     batch.e_check_row)
        errs["commit_borrow_slab"] = require_equal(w, g, f"commit_borrow_slab ({tag})")
        for name, err in errs.items():
            results[name]["max_abs_err"] = max(results[name].get("max_abs_err", 0), err)
        st_before, st_after = dyn.state, dyn_g.state
        moved = {
            "closed_to_open": int(((st_before == 0) & (dyn_x.state == 1)).sum()),
            "half_open_resolved": int(((st_before == 2) & (dyn_x.state != 2)).sum()),
            "probes_to_half_open": int(((dyn_x.state == 1) & (st_after == 2)).sum()),
        }
        sys_counts = torch.bincount(sys_type, minlength=6).tolist()
        reasons = torch.bincount(v.reason, minlength=5).tolist()
        log(f"  {tag}: K4 occupy, K5, K6, K7, K8 and the tail equal their plain versions (max abs err 0); "
            f"{int(adm.occupied.sum())} entries borrowed, {int(v.occupied.sum())} admitted so; "
            f"sys_type counts {sys_counts}; reasons {reasons}; breaker moves {moved}")
        # QPS, thread and RT show with the RT rule; QPS, thread, load and CPU without.
        shown = (1, 2, 3) if not skewed else (1, 2, 4, 5)
        if min(sys_counts[c] for c in shown) == 0:
            fail(f"phase 2b ({tag}): a system dimension blocked nothing: {sys_counts}")
        if int(v.occupied.sum()) == 0 or min(moved.values()) == 0:
            fail(f"phase 2b ({tag}): the inputs did not exercise occupy or every breaker transition")

        # Timing, on both cases; the uniform case is the one recorded.
        prefix = "" if not skewed else "zipf_"
        adm0 = flush.flow_admission_plain(stats, table, batch, 0, live, 500, False, False)
        eligible = int((~adm0.slot_ok[:, 0] & batch.e_prio & live & batch.e_cluster_ok).sum())
        t = {
            "system_check": (lambda: flush.system_check(stats, sysdev, batch, live0),
                             lambda: flush.system_check_plain(stats, sysdev, batch, live0)),
            "flow_admission_occupy": (
                lambda: flush.flow_admission(stats, table, batch, 0, live, 500, True, False),
                lambda: flush.flow_admission_plain(stats, table, batch, 0, live, 500, True, False)),
            "breaker_on_exits": (
                lambda: tdt.breaker_on_exits(ddev, dyn_s, batch.x_dgid, batch.x_ts, batch.x_rt, batch.x_err,
                                             batch.x_valid),
                lambda: tdt.breaker_on_exits_plain(ddev, dyn_s, batch.x_dgid, batch.x_ts, batch.x_rt,
                                                   batch.x_err, batch.x_valid)),
            "breaker_try_pass": (lambda: tdt.breaker_try_pass(ddev, dyn_x, batch.e_dgid, batch.e_ts, e_live),
                                 lambda: tdt.breaker_try_pass_plain(ddev, dyn_x, batch.e_dgid, batch.e_ts, e_live)),
            "slot_chain_verdict": (
                lambda: flush.slot_chain_verdict(batch, adm, sys_ok, dslot_ok, probe, dyn_s, R, 8),
                lambda: flush.slot_chain_verdict_plain(batch, adm, sys_ok, dslot_ok, probe, dyn_s, R, 8)),
            "commit_borrow_slab": (
                lambda: flush.commit_borrow_slab(slab_s, v.occ_slot, adm.occ_target, batch.e_acquire,
                                                 batch.e_check_row),
                lambda: flush.commit_borrow_slab_plain(slab_s, v.occ_slot, adm.occ_target, batch.e_acquire,
                                                       batch.e_check_row)),
        }
        dyn_s = clone(dyn)  # scratch state for the kernels that write it
        slab_s = slab_only(stats)
        times = {name: (time_ms(k), time_ms(p)) for name, (k, p) in t.items()}
        nk = N  # K = 1
        touched_x = torch.unique(batch.x_dgid[batch.x_valid]).numel()
        touched_e = torch.unique(batch.e_dgid[e_live[:, None].expand_as(batch.e_dgid)]).numel()
        # K5 reads every slot's borrow flag, and the target, row and acquire
        # only in the 32-byte sectors that hold a borrowed slot; it reads and
        # writes the 8 B of each slab cell the borrows touch.
        borrowed = v.occ_slot.reshape(-1).nonzero()[:, 0]
        slot_sectors = torch.unique(borrowed // 8).numel()  # [N, K] int32: 8 slots a sector
        acq_sectors = torch.unique(borrowed // v.occ_slot.shape[1] // 8).numel()
        scfg = nodes.SECOND_CFG
        cell = (batch.e_check_row.clamp(0, R - 1) * scfg.sample_count
                + torch.remainder(torch.div(adm.occ_target, scfg.window_len_ms, rounding_mode="floor"),
                                  scfg.sample_count))
        occ_cells = torch.unique(cell[v.occ_slot]).numel()
        dense = torch.zeros(R, dtype=I32, device=DEV)
        blocked = batch.e_valid & ~v.admitted
        dense.index_add_(0, batch.e_rows[:, 1][blocked].long(), batch.e_acquire[blocked])
        info = {
            "system_check": dict(
                bound=bound(N * (1 + 4 + 4 + 4 + 1 + 4)), library_ms=None,
                shape=f"N={N} inbound entries against row 0 of [{R},2,6]"),
            "flow_admission_occupy": dict(
                # flow_admission's bytes (see phase 2) with the occupy inputs:
                # prio and live flags per entry, each eligible slot's two slab
                # cells and two bucket heads; outputs the borrow verdicts.
                bound=bound(nk * 32 + N * (3 + 2 + 4 + 16) + eligible * 32 + nk * (1 + 1 + 4) + N * (1 + 1 + 4),
                            ops=nk * 4 + eligible * 16),
                library_ms=None, shape=f"N={N} entries x K=1, 1/8 prioritized, {eligible} eligible slots"),
            "breaker_on_exits": dict(
                bound=bound(M * (4 + 4 + 4 + 4 + 1) + touched_x * (28 + 20 + 20)), library_ms=None,
                shape=f"M={M} exits x KD=1 into ND={ND} breakers ({touched_x} touched)"),
            "breaker_try_pass": dict(
                bound=bound(N * (4 + 4 + 1 + 2) + touched_e * 8), library_ms=None,
                shape=f"N={N} entries x KD=1 against ND={ND} breakers"),
            "slot_chain_verdict": dict(
                bound=bound(N * (1 + 1 + 1 + 1 + 1 + 1 + 4 + 1 + 1 + 4 + 1 + 4 + 4) + N * (1 + 4 + 4 + 1 + 1 + 1)),
                library_ms=time_ms(lambda: torch.topk(dense, 8)),
                library_call="torch.topk(k=8) over the [R] blocked weights (the top-K step only)",
                shape=f"N={N} entries, KD=1, R={R} rows, top-8"),
            "commit_borrow_slab": dict(
                bound=bound(nk + (2 * slot_sectors + acq_sectors) * 32 + occ_cells * 16), library_ms=None,
                shape=f"N={N} borrow slots into the slab [{R},2] ({len(borrowed)} borrowed, {occ_cells} cells "
                      "touched)"),
        }
        for name, (k_ms, p_ms) in times.items():
            log(f"    {name}: {k_ms:.4f} ms, plain {p_ms:.4f} ms ({tag})")
            if not skewed:
                results[name].update(ms=k_ms, plain_ms=p_ms, **info[name])
            else:
                results[name].update(zipf_ms=k_ms, zipf_plain_ms=p_ms)
        if skewed:  # the tail, K5 and K7, redesigned: their Zipf device time
            for name in ("slot_chain_verdict", "commit_borrow_slab", "breaker_on_exits"):
                z_l, z_m, z_dev = profile(t[name][0], f"phase 2b: {name} (zipf)")
                z_us = kernel_times(t[name][0])
                results[name].update(zipf_launches_per_call=z_l, zipf_memsets_per_call=z_m, zipf_device_ms=z_dev,
                                     zipf_kernel_us=z_us)
                log(f"    {name} (zipf): {z_l} device kernels, {z_m} memsets, {z_dev:.4f} ms of device time a call; "
                    f"us by kernel {z_us}")
            untouched = torch.ones(R, dtype=torch.bool, device=DEV)
            untouched[batch.e_rows[:, 1][blocked & (batch.e_acquire > 0)].long()] = False
            log(f"    the tail (zipf): {int(blocked.sum())} entries blocked; the lowest untouched row "
                f"{int(untouched.nonzero()[0, 0])}")
        if not skewed:
            # K4's slot-chain route with occupy, K6 and K8: kernels and
            # memsets a call, at N and at the 8 entries st.entry sends (one
            # block); for K6 and K8 each route's time where it is chosen.
            occ = lambda b_, l_: lambda: flush.flow_admission(stats, table, b_, 0, l_, 500, True, False)
            occ_plain = lambda b_, l_: lambda: flush.flow_admission_plain(stats, table, b_, 0, l_, 500, True, False)
            b8, l8 = sub_batch(batch, 8), live[:8]
            call_profile(results, "flow_admission_occupy", occ(batch, live), occ(b8, l8), occ_plain(b8, l8),
                         "phase 2b")
            sc = lambda b_, l_: lambda: flush.system_check(stats, sysdev, b_, l_)
            sc_plain = lambda b_, l_: lambda: flush.system_check_plain(stats, sysdev, b_, l_)
            call_profile(results, "system_check", sc(batch, live0), sc(b8, live0[:8]), sc_plain(b8, live0[:8]),
                         "phase 2b")
            route_times(results, "system_check", flush, "SYSTEM_CHECK_SMALL_MAX",
                        lambda n: sc(sub_batch(batch, n), live0[:n]), lambda n: sc_plain(sub_batch(batch, n), live0[:n]),
                        (2048, 4096, 8192), "phase 2b")
            bt = lambda n: lambda: tdt.breaker_try_pass(ddev, dyn_x, batch.e_dgid[:n], batch.e_ts[:n], e_live[:n])
            bt_plain = lambda n: lambda: tdt.breaker_try_pass_plain(ddev, dyn_x, batch.e_dgid[:n], batch.e_ts[:n],
                                                                    e_live[:n])
            call_profile(results, "breaker_try_pass", bt(N), bt(8), bt_plain(8), "phase 2b")
            route_times(results, "breaker_try_pass", tdt, "TRY_PASS_SMALL_MAX", bt, bt_plain, (2048, 4096, 8192),
                        "phase 2b")
            # The verdict tail and K5 the same way, each route at 512-8,192;
            # K5's compared calls each start from a fresh copy of the slab.
            tail_sizes = (512, 1024, 2048, 4096, 8192)
            def cv(fn):  # the inputs are cut to n entries outside the timed call
                def at(n):
                    args = (sub_batch(batch, n), sub_adm(adm, n), sys_ok[:n], dslot_ok[:n], probe[:n], dyn_s, R, 8)
                    return lambda: fn(*args)

                return at

            call_profile(results, "slot_chain_verdict", cv(flush.slot_chain_verdict)(N),
                         cv(flush.slot_chain_verdict)(8), cv(flush.slot_chain_verdict_plain)(8), "phase 2b")
            route_times(results, "slot_chain_verdict", flush, "CHAIN_VERDICT_SMALL_MAX", cv(flush.slot_chain_verdict),
                        cv(flush.slot_chain_verdict_plain), tail_sizes, "phase 2b")
            def cb(fn, fresh):
                def at(n):
                    args = (v.occ_slot[:n], adm.occ_target[:n], batch.e_acquire[:n], batch.e_check_row[:n])
                    return lambda: fn(slab_only(stats) if fresh else slab_s, *args)

                return at

            call_profile(results, "commit_borrow_slab", cb(flush.commit_borrow_slab, False)(N),
                         cb(flush.commit_borrow_slab, True)(8), cb(flush.commit_borrow_slab_plain, True)(8),
                         "phase 2b", small_timed=cb(flush.commit_borrow_slab, False)(8))
            route_times(results, "commit_borrow_slab", flush, "COMMIT_BORROW_SMALL_MAX",
                        cb(flush.commit_borrow_slab, True), cb(flush.commit_borrow_slab_plain, True), tail_sizes,
                        "phase 2b", timed_at=cb(flush.commit_borrow_slab, False))
            # K7 the same way (its first n exits); the compared calls each
            # start from a fresh copy of the breaker state.
            def bo(fn, fresh):
                def at(n):
                    xs = (batch.x_dgid[:n], batch.x_ts[:n], batch.x_rt[:n], batch.x_err[:n], batch.x_valid[:n])
                    return lambda: fn(ddev, clone(dyn) if fresh else dyn_s, *xs)

                return at

            call_profile(results, "breaker_on_exits", bo(tdt.breaker_on_exits, False)(M),
                         bo(tdt.breaker_on_exits, True)(8), bo(tdt.breaker_on_exits_plain, True)(8), "phase 2b",
                         small_timed=bo(tdt.breaker_on_exits, False)(8))
            results["breaker_on_exits"]["kernel_us"] = kernel_times(bo(tdt.breaker_on_exits, False)(M))
            log(f"    breaker_on_exits: us by kernel {results['breaker_on_exits']['kernel_us']}")
            route_times(results, "breaker_on_exits", tdt, "BREAKER_EXITS_SMALL_MAX", bo(tdt.breaker_on_exits, True),
                        bo(tdt.breaker_on_exits_plain, True), tail_sizes, "phase 2b",
                        timed_at=bo(tdt.breaker_on_exits, False))
        del stats, batch, ddev, dyn, dyn_x, dyn_s, slab_s, adm, adm0, v, wv
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the mixed shape of bench.py (_run_mixed_stage) and phase 2c: K9 and K10
# ---------------------------------------------------------------------------

P_ROWS = 1 << 14  # param rows of the mixed shape
ND_MIXED = 1024  # breakers of the mixed shape
S_SH = N // 8  # shaping items of the mixed shape
S_P = N // 4  # param items of the mixed shape


def tmap(fn, x):
    """``fn`` over the tensors (or arrays) of a nested, possibly named, tuple."""
    if isinstance(x, tuple):
        vals = (tmap(fn, v) for v in x)
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return None if x is None else fn(x)


def i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.int32))).to(DEV)


def make_mixed(rng, now: int) -> dict:
    """bench.py's mixed flush at full width: R = 1,048,576 rules, every 8th
    a RATE_LIMITER (count 20, maxq 500 ms, cost1 50 ms); N = 131,072
    entries over 400 ms, K = 2: slot 1 of every 8th entry on its nearest
    rate limiter (16,384 shaping items); every 4th entry checks one of
    16,384 param rows (QPS, token count 100, 1 s: 32,768 items); a breaker
    per entry (1,024 exception-ratio breakers) and 32,768 exits completing
    them. The rounds bounds are the engine's (``_rounds_bucket``)."""
    from sentinel_tpu_torch.runtime.engine import _rounds_bucket

    beh = np.where(np.arange(R) % 8 == 7, C.CONTROL_BEHAVIOR_RATE_LIMITER, 0).astype(np.int32)
    z = np.zeros(R, np.int32)
    table, dyn = flow_table_from_numpy(
        (np.ones(R, np.int32), np.full(R, 20.0, np.float32), beh, np.full(R, 500, np.int32),
         np.full(R, 50, np.int32), z, z, np.zeros(R, np.float32), z),
        (np.full(R, -(10**9), np.int32), np.zeros(R, np.float32), np.full(R, -(10**9), np.int32)), DEV,
    )
    res = rng.integers(0, R, N)
    idx = np.arange(N)
    ts = (now - 400 + np.sort(rng.integers(0, 400, N))).astype(np.int32)
    gid = np.full((N, 2), -1, np.int32)
    gid[:, 0] = res
    sh = idx % 8 == 7
    sh_gid = ((res // 8) * 8 + 7) % R
    gid[sh, 1] = sh_gid[sh]
    m = N // 4
    x_rows = np.full((m, 4), -1, np.int32)
    x_rows[:, 0] = res[:m]
    b = (
        np.int32(now), np.ones(N, bool), ts, np.ones(N, np.int32),
        np.stack([res, res, np.full(N, -1), np.zeros(N)], axis=1).astype(np.int32), gid, gid.copy(),
        np.zeros(N, bool), np.ones(N, bool), np.ones(N, bool), (res % ND_MIXED).astype(np.int32)[:, None],
        np.ones(m, bool), (now - 400 + np.sort(rng.integers(0, 400, m))).astype(np.int32), np.ones(m, np.int32),
        x_rows, np.full(m, 10, np.int32), (rng.random(m) < 0.5).astype(np.int32), np.full(m, -1, np.int32),
        (res[:m] % ND_MIXED).astype(np.int32)[:, None],
    )
    batch = flush.batch_from_numpy(b, DEV)
    sb = tsh.ShapingBatch(
        valid=torch.ones(S_SH, dtype=torch.bool, device=DEV), gid=i32(sh_gid[sh]), row=i32(sh_gid[sh]),
        eidx=i32(idx[sh]), flat_pos=i32(idx[sh] * 2 + 1), ts=i32(ts[sh]), acquire=i32(np.ones(S_SH)),
    )
    pm = idx % 4 == 0
    prow = rng.integers(0, P_ROWS, S_P).astype(np.int32)
    pb = tpt.ParamBatch(
        valid=torch.ones(S_P, dtype=torch.bool, device=DEV), prow=i32(prow), eidx=i32(idx[pm]), ts=i32(ts[pm]),
        acquire=i32(np.ones(S_P)), grade=i32(np.full(S_P, C.FLOW_GRADE_QPS)), behavior=i32(np.zeros(S_P)),
        token_count=i32(np.full(S_P, 100)), burst=i32(np.zeros(S_P)), duration_ms=i32(np.full(S_P, 1000)),
        maxq=i32(np.zeros(S_P)), cost_ms=i32(np.zeros(S_P)), reset_rows=i32(np.full(8, -1)),
        exit_rows=i32(np.full(8, -1)),
    )
    dindex = tdt.DegradeIndex([st.DegradeRule(f"r{i}", grade=1, count=0.5, time_window=10)
                               for i in range(ND_MIXED)], device=DEV)
    return dict(table=table, dyn=dyn, batch=batch, sb=sb, pb=pb, ddev=dindex.device, ddyn=dindex.make_dyn_state(),
                pdyn=tpt.make_param_state(P_ROWS, DEV), sh_rounds=_rounds_bucket(sh_gid[sh]),
                p_rounds=_rounds_bucket(prow))


def shaping_table(rng, n_shaping: int, behaviors=(1, 2, 3)):
    """R rules whose first ``n_shaping`` shape (the given behaviors; counts
    5-40, queues up to 900 ms, the host's warm-up constants), half of the
    warm-up rules cold; the rest DEFAULT. Returns (table, dyn)."""
    k = n_shaping
    beh = np.zeros(R, np.int32)
    beh[:k] = rng.choice(np.asarray(behaviors, np.int32), k)
    count = np.full(R, 20.0, np.float32)
    count[:k] = rng.integers(5, 40, k)
    maxq = np.zeros(R, np.int32)
    maxq[:k] = rng.integers(0, 900, k)
    cost1 = np.floor(1000.0 / count + 0.5).astype(np.int32)
    warn, maxtok, refill = (np.zeros(R, np.int32) for _ in range(3))
    slope = np.zeros(R, np.float32)
    warn[:k] = rng.integers(2, 60, k)
    maxtok[:k] = warn[:k] + rng.integers(1, 100, k)
    slope[:k] = rng.random(k) * 1e-2
    refill[:k] = rng.integers(1, 20, k)
    stored = np.where((np.arange(R) < k) & (rng.random(R) < 0.5), maxtok, 0).astype(np.float32)
    return flow_table_from_numpy(
        (np.ones(R, np.int32), count, beh, maxq, cost1, warn, maxtok, slope, refill),
        (np.full(R, -(10**9), np.int32), stored, np.full(R, -(10**9), np.int32)), DEV,
    )


def shaping_items(rng, gids, ts, acquire) -> tuple:
    """A ShapingBatch (all valid, flat positions = item index) and random
    pass-plus-charge and previous-second pass columns."""
    s = len(gids)
    ar = np.arange(s)
    sb = tsh.ShapingBatch(torch.ones(s, dtype=torch.bool, device=DEV), i32(gids), i32(gids), i32(ar), i32(ar),
                          i32(ts), i32(acquire))
    return sb, i32(rng.integers(0, 60, s)), i32(rng.integers(0, 60, s))


def param_items(rng, prow, ts, grade, behavior, acquire, token_count, resets=(), exits=()):
    """A ParamBatch: one entry per item; burst, duration, queue and throttle
    cost follow the row (a row is one (rule, value))."""
    s = len(prow)
    prow = np.asarray(prow, np.int32)
    dur = np.where(prow % 3 == 0, 1000, 2000)
    cost = np.where(np.asarray(behavior) == C.CONTROL_BEHAVIOR_RATE_LIMITER,
                    np.floor(dur / np.maximum(token_count, 1) + 0.5), 0)
    rs = np.full(max(8, len(resets)), -1)
    rs[: len(resets)] = resets
    xr = np.full(max(8, len(exits)), -1)
    xr[: len(exits)] = exits
    return tpt.ParamBatch(
        valid=torch.ones(s, dtype=torch.bool, device=DEV), prow=i32(prow), eidx=i32(np.arange(s)), ts=i32(ts),
        acquire=i32(acquire), grade=i32(grade), behavior=i32(behavior), token_count=i32(token_count),
        burst=i32(prow % 3), duration_ms=i32(dur), maxq=i32((prow % 5) * 100), cost_ms=i32(cost),
        reset_rows=i32(rs), exit_rows=i32(xr),
    )


def param_state(rng, now: int) -> tpt.ParamDynState:
    """P_ROWS rows: never seen, warm and throttled, a few threads held."""
    never = tpt.PARAM_NEVER
    return tpt.ParamDynState(
        tokens=i32(rng.integers(0, 8, P_ROWS)),
        last_add=i32(np.where(rng.random(P_ROWS) < 0.4, never, now - rng.integers(0, 3000, P_ROWS))),
        latest=i32(np.where(rng.random(P_ROWS) < 0.4, never, now + rng.integers(-1500, 800, P_ROWS))),
        threads=i32(rng.integers(0, 4, P_ROWS)),
    )


def small_shaping_table(nr: int = 8192):
    """The mixed shape's rate limiters (count 20, maxq 500 ms, cost1 50 ms)
    as a table of ``nr`` rules, every one of them shaping."""
    z = np.zeros(nr, np.int32)
    return flow_table_from_numpy(
        (np.ones(nr, np.int32), np.full(nr, 20.0, np.float32), np.full(nr, C.CONTROL_BEHAVIOR_RATE_LIMITER, np.int32),
         np.full(nr, 500, np.int32), np.full(nr, 50, np.int32), z, z, np.zeros(nr, np.float32), z),
        (np.full(nr, -(10**9), np.int32), np.zeros(nr, np.float32), np.full(nr, -(10**9), np.int32)), DEV,
    )


def stage_call(fn, table, dyn0, sb, n, live, ppc, minute, rounds):
    """A call of ``fn`` (K9 with its inputs, or its plain version) on the
    first ``n`` items of ``sb``, their rules folded onto ``table``, from a
    copy of ``dyn0``: it returns (valid, ok, wait, the state after)."""
    sb_n = sb._replace(**{f: getattr(sb, f)[:n] for f in tsh.ShapingBatch._fields})
    sb_n = sb_n._replace(gid=torch.remainder(sb_n.gid, table.n_rules))

    def call():
        dyn = clone(dyn0)
        return (*fn(table, dyn, sb_n, live, ppc, minute, 1.0, rounds), dyn)

    return call


def check_shaping(tag, table, dyn0, sb, ppc, prev, rounds):
    """K9 on the card against its plain version on the same inputs; returns
    ((dyn, ok, wait), max abs err)."""
    got = tsh.run_shaping(table, clone(dyn0), sb, ppc, prev, 1.0, rounds)
    want = tsh.run_shaping_plain(table, clone(dyn0), sb, ppc, prev, 1.0, rounds)
    return got, require_equal(want, got, f"run_shaping ({tag})")


def check_param(tag, dyn0, pb, rounds):
    """K10 on the card against its plain version; ((dyn, ok, wait), err)."""
    got = tpt.run_param(clone(dyn0), pb, rounds)
    want = tpt.run_param_plain(clone(dyn0), pb, rounds)
    return got, require_equal(want, got, f"run_param ({tag})")


def heavy_inputs() -> tuple:
    """Case (d) of phase 2c on DEV, from a seed of its own: every shaping
    item on one rate limiter whose queue holds two of its costs (so items
    queue, pass and block), every param item on one value row. Returns
    (table, dyn, shaping batch, pass-plus-charge, previous pass, param
    state, param batch)."""
    rng = np.random.default_rng(29)
    now = 2_000_400
    table, dyn = shaping_table(rng, S_SH // 4)
    queue_ok = (table.behavior == C.CONTROL_BEHAVIOR_RATE_LIMITER) & (
        table.max_queueing_time_ms >= 2 * table.cost1_ms)
    gid = int(torch.nonzero(queue_ok)[0])
    sb, ppc, prev = shaping_items(rng, np.full(S_SH, gid), now - 3000 + np.sort(rng.integers(0, 3000, S_SH)),
                                  rng.integers(0, 3, S_SH))
    pst = param_state(rng, now)
    pb = param_items(rng, np.full(S_P, 11), now - 3000 + np.sort(rng.integers(0, 3000, S_P)), np.ones(S_P),
                     np.zeros(S_P), rng.integers(0, 3, S_P), np.full(S_P, 50))
    return table, dyn, sb, ppc, prev, pst, pb


def heavy_plain(kind: str) -> tuple:
    """The plain version of K9 (``kind`` "shaping") or K10 ("param") on
    case (d)'s inputs, run in a CPU worker: one item per round, so the
    segment of S items takes S rounds. Returns numpy (dyn, ok, wait)."""
    table, dyn, sb, ppc, prev, pst, pb = heavy_inputs()
    if kind == "shaping":
        out = tsh.run_shaping_plain(table, dyn, sb, ppc, prev, 1.0, 0)
    else:
        out = tpt.run_param_plain(pst, pb, 0)
    return tmap(lambda t: t.numpy(), out)


def exercised(tag: str, ok: torch.Tensor, wait=None, need_wait: bool = True) -> str:
    n_ok, n = int(ok.sum()), ok.numel()
    n_wait = 0 if wait is None else int((wait > 0).sum())
    if n_ok == 0 or n_ok == n or (need_wait and n_wait == 0):
        fail(f"phase 2c ({tag}): the case did not exercise admits, blocks and queued waits "
             f"({n_ok} of {n} admitted, {n_wait} waited)")
    return f"{n_ok} of {n} admitted, {n_wait} waited"


def phase2_shaping_param(results: dict, cpu_jobs: dict) -> None:
    log(f"phase 2c: K9 (shaping) and K10 (hot parameters) against their plain versions at bench.py's mixed shape "
        f"(R={R:,}, N={N:,}, K=2, {S_SH:,} shaping and {S_P:,} param items) and four more cases")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(23)
    rng = np.random.default_rng(23)
    now = 2_000_400
    mx = make_mixed(rng, now)
    stats = make_stats(now, gen)
    table, batch, sb, pb = mx["table"], mx["batch"], mx["sb"], mx["pb"]
    live = batch.e_valid & batch.e_auth_ok
    errs = {}
    # K4's per-slot pass plus charge, then K9 with its inputs (one host call).
    w = flush.flow_admission_plain(stats, table, batch, 0, live, 500, False, False, True)
    adm = flush.flow_admission(stats, table, batch, 0, live, 500, False, False, True)
    require_equal(w, adm, "flow_admission with the pass-plus-charge output (mixed)")
    ppc_slots, rounds_m = adm.pass_plus_consumed, mx["sh_rounds"]
    w = tsh.shaping_inputs_plain(sb, live, ppc_slots, stats.minute)
    inputs = tsh.shaping_inputs(sb, live, ppc_slots, stats.minute)
    errs["shaping_stage"] = require_equal(w, inputs, "shaping_inputs (mixed)")
    d_k, d_p = clone(mx["dyn"]), clone(mx["dyn"])
    stage_k = tsh.shaping_stage(table, d_k, sb, live, ppc_slots, stats.minute, 1.0, rounds_m)
    stage_p = tsh.shaping_stage_plain(table, d_p, sb, live, ppc_slots, stats.minute, 1.0, rounds_m)
    errs["shaping_stage"] = max(errs["shaping_stage"], require_equal((*stage_p, d_p), (*stage_k, d_k),
                                                                     "shaping_stage (mixed)"))
    valid, ppc_s, prev_s = inputs
    sb_live = sb._replace(valid=valid)
    (dyn_m, ok_m, wait_m), err = check_shaping("mixed", table, mx["dyn"], sb_live, ppc_s, prev_s, rounds_m)
    errs["shaping_stage"] = max(errs["shaping_stage"], err)
    (pd_m, pok_m, _), errs["run_param"] = check_param("mixed", mx["pdyn"], pb, mx["p_rounds"])
    log(f"  mixed (rounds {rounds_m} / {mx['p_rounds']}): K9 {int(ok_m.sum())} of {S_SH} admitted, "
        f"{int((wait_m > 0).sum())} waited; K10 {int(pok_m.sum())} of {S_P} admitted; K9 with its inputs, the "
        f"inputs alone and K4's pass-plus-charge equal too")
    # Timing at the mixed shape (the kernels line).
    dyn_s, pd_s = clone(mx["dyn"]), clone(mx["pdyn"])
    touched_sh = torch.unique(sb.gid).numel()
    touched_p = torch.unique(pb.prow).numel()
    stage = lambda: tsh.shaping_stage(table, dyn_s, sb, live, ppc_slots, stats.minute, 1.0, rounds_m)
    results["shaping_stage"].update(
        ms=time_ms(stage),
        plain_ms=time_ms(lambda: tsh.shaping_stage_plain(table, dyn_s, sb, live, ppc_slots, stats.minute, 1.0,
                                                         rounds_m), iters=3, warmup=1),
        run_ms=time_ms(lambda: tsh.run_shaping(table, dyn_s, sb_live, ppc_s, prev_s, 1.0, rounds_m)),
        inputs_ms=time_ms(lambda: tsh.shaping_inputs(sb, live, ppc_slots, stats.minute)),
        library_ms=None, shape=f"S={S_SH} rate-limiter items over {touched_sh} of R={R} rules, with the gather "
                               f"from N={N} entries and the minute window [{R},60,6]",
        # Per item: valid, gid, eidx, flat_pos, row, ts, acquire; its entry's
        # live, its slot's pass-plus-charge, one minute-window start and pass
        # in; valid, ok and wait out. Per touched rule: its 8 table columns
        # and 3 state columns read, the state written.
        bound=bound(S_SH * (1 + 6 * 4 + 1 + 4 + 8 + 1 + 1 + 4) + touched_sh * (32 + 12 + 12), ops=S_SH * 40),
    )
    # S = 8 and the routes on a table of 8,192 rate limiters (its state is
    # cloned for every call); the items are the mixed shape's first ones.
    tab8, dyn8 = small_shaping_table()
    stage_at = lambda n, fn: stage_call(fn, tab8, dyn8, sb, n, live, ppc_slots, stats.minute, rounds_m)
    call_profile(results, "shaping_stage", stage, stage_at(8, tsh.shaping_stage), stage_at(8, tsh.shaping_stage_plain),
                 "phase 2c")
    route_times(results, "shaping_stage", tsh, "SHAPING_SMALL_MAX", lambda n: stage_at(n, tsh.shaping_stage),
                lambda n: stage_at(n, tsh.shaping_stage_plain), (512, 1024, 2048, 4096, 8192), "phase 2c")
    results["run_param"].update(
        ms=time_ms(lambda: tpt.run_param(pd_s, pb, mx["p_rounds"])),
        plain_ms=time_ms(lambda: tpt.run_param_plain(pd_s, pb, mx["p_rounds"]), iters=3, warmup=1),
        library_ms=None, shape=f"S={S_P} items over {touched_p} of {P_ROWS} param rows",
        # Per item: valid, row, ts and 8 per-item columns in, ok and wait
        # out; per touched row: 4 state columns read, 3 written.
        bound=bound(S_P * (1 + 4 * 10 + 1 + 4) + touched_p * (16 + 12), ops=S_P * 30),
    )
    for name in ("shaping_stage", "run_param"):
        log(f"    {name}: {results[name]['ms']:.4f} ms, plain {results[name]['plain_ms']:.4f} ms, "
            f"bound {results[name]['bound'][0]:.5f} ms ({results[name]['shape']})")
    log(f"    shaping_stage's parts alone: run_shaping {results['shaping_stage']['run_ms']:.4f} ms, shaping_inputs "
        f"{results['shaping_stage']['inputs_ms']:.4f} ms")
    # K10's kernels and memsets a call, at the mixed shape and at the 8 items
    # st.entry sends (the one-block route, against the plain version).
    launches, memsets, dev_ms = profile(lambda: tpt.run_param(pd_s, pb, mx["p_rounds"]),
                                        f"phase 2c: K10 at S={S_P}")
    pb8 = pb._replace(**{f: getattr(pb, f)[:8] for f in tpt.ParamBatch._fields[:12]})
    _, err = check_param("s=8", mx["pdyn"], pb8, 0)
    errs["run_param"] = max(errs["run_param"], err)
    small = lambda: tpt.run_param(pd_s, pb8, 0)
    s_launches, s_memsets, s_dev = profile(small, "phase 2c: K10 at s=8")
    results["run_param"].update(
        launches_per_call=launches, memsets_per_call=memsets, device_ms=dev_ms, small_ms=time_ms(small),
        small_launches_per_call=s_launches, small_memsets_per_call=s_memsets, small_device_ms=s_dev,
        small_bound_ms=bound(8 * (1 + 4 * 10 + 1 + 4) + 8 * (16 + 12), ops=8 * 30)[0],
    )
    log(f"    run_param: {launches} device kernels, {memsets} memsets, {dev_ms:.4f} ms of device time a call; "
        f"s=8: {results['run_param']['small_ms']:.4f} ms, {s_launches} kernels, {s_memsets} memsets, "
        f"{s_dev:.4f} ms of device time (profiler)")
    if (s_launches, s_memsets) != (1, 0):
        fail(f"phase 2c: K10 at s=8 issued {s_launches} kernels and {s_memsets} memsets in one call")
    del stats, adm, inputs, dyn_s, pd_s, d_k, d_p, tab8, dyn8
    torch.cuda.empty_cache()

    def timed(fn):
        ms = time_ms(fn, iters=3, warmup=1)
        return f"{ms:.4f} ms"

    # (a) every shaping behavior, items over four seconds: syncToken refills.
    n_a = S_SH // 4  # 4,096 rules, about 4 items each: the rounds bound 16
    table_a, dyn_a = shaping_table(rng, n_a)
    gids = rng.integers(0, n_a, S_SH)
    ts = now - 4000 + np.sort(rng.integers(0, 4000, S_SH))
    sb_a, ppc_a, prev_a = shaping_items(rng, gids, ts, rng.integers(0, 3, S_SH))
    from sentinel_tpu_torch.runtime.engine import _rounds_bucket

    for rounds in (_rounds_bucket(gids), 0):
        (d, ok, wait), err = check_shaping(f"a, rounds {rounds}", table_a, dyn_a, sb_a, ppc_a, prev_a, rounds)
        errs["shaping_stage"] = max(errs["shaping_stage"], err)
        refilled = int((d.last_filled_time != dyn_a.last_filled_time).sum())
        if refilled == 0:
            fail("phase 2c (a): no warm-up rule refilled")
        log(f"  (a) behaviors 1-3 over 4 s, rounds {rounds}: {exercised('a', ok, wait)}, {refilled} rules refilled; "
            f"K9 {timed(lambda: tsh.run_shaping(table_a, clone(dyn_a), sb_a, ppc_a, prev_a, 1.0, rounds))}")
    # (b) every param grade and behavior, LRU resets and exit releases, through
    # the flush's param stage (exit release, K10, the per-entry fold).
    pst = param_state(rng, now)
    prow = rng.integers(0, P_ROWS, S_P)
    grade = np.where(prow % 4 == 0, C.FLOW_GRADE_THREAD, C.FLOW_GRADE_QPS)
    behavior = np.where((prow % 3 == 1) & (grade == C.FLOW_GRADE_QPS), C.CONTROL_BEHAVIOR_RATE_LIMITER, 0)
    tc = np.where(prow % 7 == 0, 40, np.array([1, 2, 3, 5])[prow % 4])  # hot items: a larger threshold
    pb_b = param_items(rng, prow, now - 2000 + np.sort(rng.integers(0, 2000, S_P)), grade, behavior,
                       rng.integers(0, 3, S_P), tc, resets=rng.integers(0, P_ROWS, 64),
                       exits=rng.integers(0, P_ROWS, 2048))
    live_b = torch.rand(S_P, generator=gen, device=DEV) < 0.95
    for rounds in (_rounds_bucket(prow), 0):
        pk, pp = clone(pst), clone(pst)
        ok_k, w_k = flush._param_stage(pk, pb_b, live_b, rounds)
        with plain_kernels():
            ok_p, w_p = flush._param_stage(pp, pb_b, live_b, rounds)
        err = require_equal((pp, ok_p, w_p), (pk, ok_k, w_k), f"param stage (b, rounds {rounds})")
        errs["run_param"] = max(errs["run_param"], err)
        thr_blocked = int((~ok_k & live_b & i32(grade == C.FLOW_GRADE_THREAD).bool()).sum())
        if thr_blocked == 0:
            fail("phase 2c (b): no THREAD-grade value blocked")
        log(f"  (b) every grade and behavior, 64 LRU resets, 2,048 exit releases, rounds {rounds}: "
            f"{exercised('b', ok_k, w_k)}, {thr_blocked} THREAD-grade blocks; "
            f"K10 {timed(lambda: tpt.run_param(clone(pst), pb_b, rounds))}")
    # (c) the closed forms: shaping -1 (one ts, segments of about 256);
    # param -1 (one ts) and -8 (up to 8 timestamps per row).
    table_c, dyn_c = shaping_table(rng, 64, behaviors=(2,))
    sb_c, ppc_c, prev_c = shaping_items(rng, rng.integers(0, 64, S_SH), np.full(S_SH, now), np.ones(S_SH))
    (d, ok, wait), err = check_shaping("c, closed form", table_c, dyn_c, sb_c, ppc_c, prev_c, -1)
    errs["shaping_stage"] = max(errs["shaping_stage"], err)
    log(f"  (c) shaping closed form (64 rules, one ts): {exercised('c shaping', ok, wait)}; "
        f"K9 {timed(lambda: tsh.run_shaping(table_c, clone(dyn_c), sb_c, ppc_c, prev_c, 1.0, -1))}")
    for nts, rounds in ((1, -1), (7, -8)):
        prow = rng.integers(0, 1024, S_P)
        tc = (prow % 40 + 1) * 2
        ts = now - 700 * rng.integers(0, nts, S_P)
        pb_c = param_items(rng, prow, ts, np.ones(S_P), np.zeros(S_P), np.ones(S_P), tc)
        (d, ok, _), err = check_param(f"c, closed form {rounds}", pst, pb_c, rounds)
        errs["run_param"] = max(errs["run_param"], err)
        log(f"  (c) param closed form {rounds} ({nts} timestamp(s), 1,024 rows): "
            f"{exercised('c param', ok, need_wait=False)}; K10 {timed(lambda: tpt.run_param(clone(pst), pb_c, rounds))}")
    # (d) one heavy segment: every item on one rule / one row, the scan path.
    # The plain versions ran on the same inputs in CPU workers (heavy_plain).
    table_d, dyn_d, sb_d, ppc_d, prev_d, pst_d, pb_d = heavy_inputs()
    d, ok, wait = tsh.run_shaping(table_d, clone(dyn_d), sb_d, ppc_d, prev_d, 1.0, 0)
    err = require_equal(tmap(torch.from_numpy, cpu_result(cpu_jobs, "heavy shaping")),
                        tmap(lambda t: t.cpu(), (d, ok, wait)), "run_shaping (d, one rule)")
    errs["shaping_stage"] = max(errs["shaping_stage"], err)
    k_ms = time_ms(lambda: tsh.run_shaping(table_d, clone(dyn_d), sb_d, ppc_d, prev_d, 1.0, 0), iters=3, warmup=1)
    log(f"  (d) one rate limiter holds all {S_SH:,} shaping items, scan path: {exercised('d shaping', ok, wait)}; "
        f"K9 {k_ms:.4f} ms (one thread walks the segment)")
    results["shaping_stage"]["heavy_ms"] = k_ms
    d, ok, wait = tpt.run_param(clone(pst_d), pb_d, 0)
    err = require_equal(tmap(torch.from_numpy, cpu_result(cpu_jobs, "heavy param")),
                        tmap(lambda t: t.cpu(), (d, ok, wait)), "run_param (d, one row)")
    errs["run_param"] = max(errs["run_param"], err)
    k_ms = time_ms(lambda: tpt.run_param(clone(pst_d), pb_d, 0), iters=3, warmup=1)
    log(f"  (d) one value row holds all {S_P:,} param items, scan path: {exercised('d param', ok, need_wait=False)}; "
        f"K10 {k_ms:.4f} ms (one thread walks the segment)")
    results["run_param"]["heavy_ms"] = k_ms
    for name in ("shaping_stage", "run_param"):
        results[name]["max_abs_err"] = max(results[name].get("max_abs_err", 0), errs[name])
    log(f"  K9, K10 and the input gather equal their plain versions in every case (max abs err {max(errs.values())})")
    del mx, table_a, dyn_a, table_c, dyn_c, table_d, dyn_d
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: flush_step at the north-star shape
# ---------------------------------------------------------------------------


def step_times(run, repeats: int = 5) -> tuple:
    """The median of ``repeats`` timings of 10 steps each, and their range
    as text: the run's own noise on this card."""
    ts = sorted(time_ms(run, iters=10) for _ in range(repeats))
    return ts[len(ts) // 2], f"(median of {repeats}; range {ts[0]:.4f}-{ts[-1]:.4f})"


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
        with plain_kernels():
            _, want = flush.flush_step(plain, table, batch, with_exits=with_exits, blk_topk=8)
        require_equal(want, res, f"flush_step results (exits={with_exits})")
        require_equal(plain, kern, f"flush_step state (exits={with_exits})")
        del base, plain
        torch.cuda.empty_cache()
        k_ms, k_spread = step_times(lambda: flush.flush_step(kern, table, batch, with_exits=with_exits, blk_topk=8))
        with plain_kernels():
            p_ms = time_ms(lambda: flush.flush_step(kern, table, batch, with_exits=with_exits, blk_topk=8), iters=5)
        log(f"  exits={'on' if with_exits else 'off'}: kernels {k_ms:.4f} ms/flush {k_spread} "
            f"({N / k_ms * 1e3:,.0f} entries/s), plain {p_ms:.4f} ms/flush "
            f"({N / p_ms * 1e3:,.0f} entries/s); results and state identical")
        profile_step(lambda: flush.flush_step(kern, table, batch, with_exits=with_exits, blk_topk=8),
                     f"exits={'on' if with_exits else 'off'}")
        del kern
        torch.cuda.empty_cache()

    # Every stage on: prioritized entries, a system rule, ND breakers; 137 ms
    # into the window, so that a borrow's wait can be under 500 ms.
    now += 137
    base = make_chain_stats(now, gen)
    batch = make_chain_batch(rng, now, skewed=False)
    ddev, dyn = make_breakers(now, gen)
    kern, plain, dk, dp = clone(base), clone(base), clone(dyn), clone(dyn)
    del base
    args = dict(with_exits=True, blk_topk=8, ddev=ddev, sysdev=sys_device("rt"), occupy_timeout_ms=500,
                with_occupy=True, with_system=True, with_degrade=True)
    _, res = flush.flush_step(kern, table, batch, ddyn=dk, **args)
    with plain_kernels():
        _, want = flush.flush_step(plain, table, batch, ddyn=dp, **args)
    require_equal(want, res, "flush_step results (every stage on)")
    require_equal(plain, kern, "flush_step state (every stage on)")
    require_equal(dp, dk, "flush_step breaker state (every stage on)")
    del plain
    torch.cuda.empty_cache()
    k_ms, k_spread = step_times(lambda: flush.flush_step(kern, table, batch, ddyn=dk, **args))
    with plain_kernels():
        p_ms = time_ms(lambda: flush.flush_step(kern, table, batch, ddyn=dk, **args), iters=5)
    log(f"  every stage on (occupy, system, {ND:,} breakers, {M:,} exits): kernels {k_ms:.4f} ms/flush {k_spread} "
        f"({N / k_ms * 1e3:,.0f} entries/s), plain {p_ms:.4f} ms/flush ({N / p_ms * 1e3:,.0f} entries/s); "
        f"results and state identical; {int(res.occupied.sum())} borrowed, reasons "
        f"{torch.bincount(res.reason, minlength=5).tolist()}")
    profile_step(lambda: flush.flush_step(kern, table, batch, ddyn=dk, **args), "every stage on")
    del kern
    torch.cuda.empty_cache()

    # bench.py's mixed shape: shaping and hot parameters on, 1,024
    # breakers, 32,768 exits (no system rule, no prioritized entries).
    now += 400
    mx = make_mixed(rng, now)
    base = make_stats(now, gen)
    kern, plain = clone(base), clone(base)
    del base
    st_k = {name: clone(mx[name]) for name in ("dyn", "pdyn", "ddyn")}
    st_p = {name: clone(mx[name]) for name in ("dyn", "pdyn", "ddyn")}
    margs = dict(with_exits=True, blk_topk=8, ddev=mx["ddev"], with_degrade=True, shaping=mx["sb"], param=mx["pb"],
                 shaping_rounds=mx["sh_rounds"], param_rounds=mx["p_rounds"])

    def mixed_step(stats, s):
        return flush.flush_step(stats, mx["table"], mx["batch"], ddyn=s["ddyn"], flow_dyn=s["dyn"], pdyn=s["pdyn"],
                                **margs)

    _, res = mixed_step(kern, st_k)
    with plain_kernels():
        _, want = mixed_step(plain, st_p)
    require_equal(want, res, "flush_step results (mixed)")
    require_equal(plain, kern, "flush_step stats (mixed)")
    for name in ("dyn", "pdyn", "ddyn"):
        require_equal(st_p[name], st_k[name], f"flush_step {name} (mixed)")
    del plain
    torch.cuda.empty_cache()
    k_ms, k_spread = step_times(lambda: mixed_step(kern, st_k))
    with plain_kernels():
        p_ms = time_ms(lambda: mixed_step(kern, st_k), iters=2, warmup=1)
    log(f"  mixed (bench.py _run_mixed_stage: K=2, {S_SH:,} shaping and {S_P:,} param items, {ND_MIXED:,} breakers, "
        f"{M:,} exits): kernels {k_ms:.4f} ms/flush {k_spread} ({N / k_ms * 1e3:,.0f} entries/s), plain "
        f"{p_ms:.4f} ms/flush; results, stats, shaping, param and breaker state identical; reasons "
        f"{torch.bincount(res.reason, minlength=6).tolist()}, {int((res.wait_ms > 0).sum())} waits")
    profile_step(lambda: mixed_step(kern, st_k), "mixed")
    del kern, mx, st_k, st_p
    torch.cuda.empty_cache()

    # The sketch tier on: the DEFAULT step, then the fold (K11) of the
    # chunk's 131,072 keys into the default tier, with the halving.
    gen.manual_seed(33)
    rng_sk = np.random.default_rng(33)
    now += 1000
    base = make_stats(now, gen)
    batch = make_batch(rng_sk, now, skewed=False, with_exits=False)
    sk_base, sk = sketch_inputs(rng_sk, "default")
    kern, plain, sk_k, sk_p = clone(base), clone(base), clone(sk_base), clone(sk_base)
    del base
    _, res = flush.flush_step(kern, table, batch, with_exits=False, blk_topk=8, skstate=sk_k, sk=sk,
                              sketch_decay=True)
    with plain_kernels():
        _, want = flush.flush_step(plain, table, batch, with_exits=False, blk_topk=8, skstate=sk_p, sk=sk,
                                   sketch_decay=True)
    require_equal(want, res, "flush_step results (sketch on)")
    require_equal(plain, kern, "flush_step state (sketch on)")
    require_equal(sk_p, sk_k, "flush_step sketch state (sketch on)")
    del plain
    torch.cuda.empty_cache()
    k_ms, k_spread = step_times(lambda: flush.flush_step(kern, table, batch, with_exits=False, blk_topk=8,
                                                         skstate=sk_k, sk=sk))
    log(f"  sketch on (the default tier, {SK_S:,} keys, decay in the compared step): kernels {k_ms:.4f} ms/flush "
        f"{k_spread}; results, stats and sketch state identical to the plain route")
    del kern, sk_k, sk_p
    torch.cuda.empty_cache()


def profile_step(run, label: str, steps: int = 5) -> None:
    """Where one flush_step's device time goes: torch.profiler (CUPTI)
    over ``steps`` steps, self device time per op per step, largest
    first, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
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
    log(f"  profile ({label}): device busy {busy:.1f} us of "
        f"{wall_us:.1f} us wall per step under the profiler ({busy / wall_us:.1%})")
    for us, name in rows[:12]:
        log(f"    {us:9.1f} us  {us / busy:6.1%}  {name[:90]}")


# ---------------------------------------------------------------------------
# phase 4: the engine through the public API
# ---------------------------------------------------------------------------

SYNC_COUNTS = None  # phase 4f's recount of the 4b-4e streams: (host syncs a dispatch, of a sketch rule rebuild)
# What torch.cuda.set_sync_debug_mode("warn") says of each sync (its first
# warning, that the mode is a prototype, is not one).
SYNC_WARNING = "called a synchronizing CUDA operation"


def count_syncs(fn) -> int:
    """Calls ``fn`` under torch.cuda.set_sync_debug_mode("warn"); returns
    the number of synchronizing operations it warned of."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(SYNC_WARNING in str(w.message) for w in caught)


def flush_engine(eng) -> None:
    """``eng.flush()``; while phase 4f recounts a stream (``SYNC_COUNTS`` a
    pair of lists), the same ops go through ``flush_async`` under
    torch.cuda.set_sync_debug_mode("warn"), with nothing in flight to
    settle, its syncs counted, then through ``drain()``: the same verdicts.
    The sketch's queued rule rebuilds, which flush() and flush_async() apply
    first, are applied and counted apart: a rule reload, not the dispatch."""
    if SYNC_COUNTS is None:
        eng.flush()
        return
    if eng.sketch.armed and eng.sketch.pending_actions:
        SYNC_COUNTS[1].append(count_syncs(eng.sketch.apply_actions))
    eng.max_inflight = 8
    SYNC_COUNTS[0].append(count_syncs(eng.flush_async))
    eng.drain()


N_RULES = 6000  # the reference's MAX_SLOT_CHAIN_SIZE
FLUSH_N = 32768
STEPS = 40  # 100 ms each: 4 simulated seconds


def drive_engine(device: torch.device, seed: int, mode: str = "sync"):
    """One stream on one engine; returns (records, final state, blocked
    top-K, seconds per bulk flush, entries admitted, (the stats reads'
    launches of row_stats and of K3, the seconds of each read, the host
    split of each bulk flush)). ``mode`` "depth2" runs the engine at
    pipeline depth 2, "async" flushes the bulk through flush_async; the
    verdict reads after each flush materialize it in both."""
    clock = tclock.ManualClock(0)
    api.reset(clock=clock, device=device)
    st.flow_rule_manager.load_rules([st.FlowRule(f"r{i}", count=20) for i in range(N_RULES)])
    eng = api.get_engine()
    eng.pipeline_depth = 2 if mode == "depth2" else 0
    splits = []
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, N_RULES + 1, dtype=np.float64) ** -1.1
    p = ranks / ranks.sum()
    records = []
    prev_groups = []
    flush_s = 0.0
    admitted = read_launches = read_k3 = 0
    read_s = []
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
        eng.flush_async() if mode == "async" else eng.flush()
        flush_s += time.perf_counter() - t0
        splits.append(eng.last_flush_host_ms)
        records.append(np.concatenate([g.admitted for g in groups]))
        records.append(np.concatenate([g.reason for g in groups]))
        admitted += int(records[-2].sum())
        prev_groups = groups
        if step % 10 == 9:  # the stats reads (row_stats, one launch a read): a path of their own, off the flush
            for r in ("r0", "r7", "r123"):
                nodes.rows_stats.launches = ma.window_reduce.launches = 0
                t0 = time.perf_counter()
                read = eng.cluster_node_stats(r, flush=False)
                read_s.append(time.perf_counter() - t0)
                read_launches += nodes.rows_stats.launches
                read_k3 += ma.window_reduce.launches
                records.append(np.array([json.dumps(read, sort_keys=True)]))
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
    eng.drain()
    final = nodes.stats_to_numpy(eng.stats)
    blk = eng.last_blocked_topk
    return records, final, blk, flush_s / STEPS, admitted, (read_launches, read_k3, read_s, splits)


def split_line(splits) -> str:
    """The median of each key of ``Engine.last_flush_host_ms`` over flushes."""
    return ", ".join(f"{k} {float(np.median([s[k] for s in splits])):.3f}" for k in splits[0]) + " (ms, median)"


def phase4(results: dict, cpu_jobs: dict) -> None:
    log(f"phase 4: the engine through the public API (6,000 rules, {STEPS} flushes of 32,768 over {STEPS / 10:g} "
        f"simulated s)")
    # The window update and the gauge launch inside apply_updates' one
    # call, which counts one launch of each. No entry is prioritized, so
    # the slab never holds a borrow and the sweep (K1) must not run: its
    # launches come from phase 4b.
    wrappers = {
        "materialize_matured": nodes.materialize_matured,
        "window_update": ma.update,
        "thread_gauge": nodes.thread_gauge_add,
        "flow_admission": flush.flow_admission,
    }
    for w in wrappers.values():
        w.launches = 0
    gpu_records, gpu_state, gpu_blk, gpu_flush_s, admitted, (read_launches, read_k3, read_s, splits) = drive_engine(
        DEV, seed=4)
    counts = {name: w.launches for name, w in wrappers.items()}
    log(f"  card: {gpu_flush_s * 1e3:.3f} ms per 32,768-entry flush call "
        f"({FLUSH_N / gpu_flush_s:,.0f} entries/s, host encode and verdict copy included)")
    log(f"  host split of a flush (Engine.last_flush_host_ms): {split_line(splits)}")
    log(f"  launches on the main path: {counts}")
    if counts.pop("materialize_matured") != 0:
        fail("phase 4: the matured-borrow sweep ran on a stream that borrows nothing")
    for name, c in counts.items():
        if c <= 0:
            fail(f"kernel {name} was not launched on the main path")
        results[name]["launches"] = c
    # K3 is off the flush path (K4 reads the window itself); the stats reads
    # launch row_stats (K3 with the gauge and the slab) once each, counted
    # from 0 around each read; K3 alone not at all.
    log(f"  launches on the stats reads ({len(read_s)} cluster_node_stats(flush=False) calls, off the flush path): "
        f"row_stats {read_launches}, K3 alone {read_k3}; a read {1e3 * min(read_s):.4f}-{1e3 * max(read_s):.4f} ms, "
        f"median {1e3 * float(np.median(read_s)):.4f} ms")
    if read_launches != len(read_s) or read_k3 != 0:
        fail(f"phase 4: {len(read_s)} stats reads launched row_stats {read_launches} times and K3 {read_k3} times")
    results["row_stats"].update(launches=read_launches, read_ms=[1e3 * min(read_s), 1e3 * float(np.median(read_s)),
                                                                 1e3 * max(read_s)])
    cpu_records, cpu_state, cpu_blk, cpu_flush_s, _, _ = cpu_result(cpu_jobs, "4")
    log(f"  CPU engine (plain versions, in a worker process): {cpu_flush_s * 1e3:.3f} ms per flush call")
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
    PHASE4_RESULT.update(card=(gpu_records, gpu_state, gpu_blk), cpu=(cpu_records, cpu_state, cpu_blk))


PHASE4_RESULT = {}  # phase 4's card and CPU results, which phase 4f holds its depths against


CHAIN_STEPS = 24  # 100 ms each: 2.4 simulated seconds


def _verdict_record(v) -> tuple:
    rule = None if v.blocked_rule is None else json.dumps(v.blocked_rule.to_dict(), sort_keys=True, default=str)
    return (v.admitted, v.reason, v.wait_ms, v.limit_type, rule)


def drive_chain_engine(device: torch.device, seed: int):
    """The slot chain's stream on one engine: 6,000 QPS rules, breakers on
    every third resource (RT, exception ratio and exception count in
    turn), system rules (QPS and average RT; the load sampler pinned),
    white lists on every seventh resource, inbound and outbound Zipf bulk
    traffic from three origins, 64 prioritized entries per flush on eight
    cold resources, st.entry calls (one prioritized) and exits that
    complete the breakers with 30% errors. Returns (records, final stats, breaker
    state, bulk verdicts compared)."""
    from sentinel_tpu_torch.utils.system_status import sampler

    clock = tclock.ManualClock(0)
    api.reset(clock=clock, device=device)
    sampler.force(load=3.0, cpu=0.1)
    st.flow_rule_manager.load_rules([st.FlowRule(f"r{i}", count=20) for i in range(N_RULES)])
    st.degrade_rule_manager.load_rules([
        st.DegradeRule(f"r{i}", grade=(i // 3) % 3, count=(100, 0.3, 20)[(i // 3) % 3], time_window=1,
                       slow_ratio_threshold=0.5, min_request_amount=5)
        for i in range(0, N_RULES, 3)
    ])
    st.system_rule_manager.load_rules([st.SystemRule(qps=150_000), st.SystemRule(avg_rt=140)])
    st.authority_rule_manager.load_rules([st.AuthorityRule(f"r{i}", limit_app="appA")
                                          for i in range(0, N_RULES, 7)])
    eng = api.get_engine()
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, N_RULES + 1, dtype=np.float64) ** -1.1
    p = ranks / ranks.sum()
    origins = ["", "appA", "appB"]
    records = []
    reasons = np.zeros(6, np.int64)
    waits = 0
    prev_groups = []
    flush_s = 0.0
    for step in range(CHAIN_STEPS):
        now = 1000 + step * 100
        clock.set_ms(now)
        res = rng.choice(N_RULES, size=FLUSH_N - 64, p=p)
        ts = (now - rng.integers(0, 100, res.size)).astype(np.int32)
        order = np.argsort(res, kind="stable")
        res, ts = res[order], ts[order]
        uniq, start = np.unique(res, return_index=True)
        bounds = list(start) + [res.size]
        groups = [
            eng.submit_bulk(f"r{r}", int(bounds[i + 1] - bounds[i]), ts=np.sort(ts[bounds[i]:bounds[i + 1]]),
                            origin=origins[(r + step) % 3],
                            entry_type=C.EntryType.IN if r % 2 == 0 else C.EntryType.OUT)
            for i, r in enumerate(uniq)
        ]
        # On eight cold resources: behind thousands of same-flush bulk
        # entries (the hot ones) the conservative intra-batch charge leaves
        # no room to borrow.
        singles = [eng.submit_entry(f"r{N_RULES - 8 + j % 8}", origin="appA", prio=True,
                                    ts=now - int(rng.integers(0, 50))) for j in range(64)]
        for g in prev_groups[:100]:
            if g.admitted_count:
                n_x = g.admitted_count
                # The mean RT alternates around the system rule's 140 ms.
                eng.submit_exit_bulk(g.rows, n_x, rt=rng.integers(1, 300 if step % 4 < 2 else 200, n_x).astype(np.int32),
                                     err=(rng.random(n_x) < 0.3).astype(np.int32), ts=now, resource=g.resource)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        flush_engine(eng)
        flush_s += time.perf_counter() - t0
        for g in groups:
            records += [g.admitted, g.reason, g.wait_ms]
            reasons += np.bincount(g.reason, minlength=6)[:6]
        single = [_verdict_record(o.verdict) for o in singles]
        records.append(np.array(single, dtype=object))
        reasons += np.bincount([v[1] for v in single], minlength=6)[:6]
        waits += sum(1 for v in single if v[2] > 0)
        prev_groups = groups
        for r in ("r0", "r1", "r3"):
            clock.set_ms(now + 50)
            try:
                e = st.entry(r, prio=r == "r1")
                records.append(np.array(["pass", clock.now_ms()], dtype=object))
                clock.set_ms(clock.now_ms() + 10)
                e.exit()
            except st.BlockError as exc:
                records.append(np.array([type(exc).__name__, getattr(exc, "limit_type", "")], dtype=object))
    eng.flush()
    sampler.force(load=-1.0, cpu=-1.0)
    stats = nodes.stats_to_numpy(eng.stats)
    return records, stats, tdt.degrade_state_to_numpy(eng.degrade_dyn), flush_s / CHAIN_STEPS, reasons, waits


def phase4_chain(results: dict, cpu_jobs: dict) -> None:
    log(f"phase 4b: the slot chain through the public API (breakers on 2,000 of 6,000 resources, system and "
        f"authority rules, prioritized entries; {CHAIN_STEPS} flushes of 32,768)")
    # name -> (wrapper, counter): K4's occupy branch has a counter of its own,
    # bumped only by the launches that run it.
    counters = {
        "materialize_matured": (nodes.materialize_matured, "launches"), "window_update": (ma.update, "launches"),
        "thread_gauge": (nodes.thread_gauge_add, "launches"),
        "flow_admission_occupy": (flush.flow_admission, "occupy_launches"),
        "commit_borrow_slab": (flush.commit_borrow_slab, "launches"),
        "system_check": (flush.system_check, "launches"), "breaker_on_exits": (tdt.breaker_on_exits, "launches"),
        "breaker_try_pass": (tdt.breaker_try_pass, "launches"),
        "slot_chain_verdict": (flush.slot_chain_verdict, "launches"),
    }
    for w, attr in counters.values():
        setattr(w, attr, 0)
    gpu = drive_chain_engine(DEV, seed=5)
    counts = {name: getattr(w, attr) for name, (w, attr) in counters.items()}
    log(f"  card: {gpu[3] * 1e3:.3f} ms per 32,768-entry flush call (host encode and verdict copy included)")
    log(f"  launches on the slot chain's path: {counts}")
    for name, c in counts.items():
        if c <= 0:
            fail(f"kernel {name} was not launched on the slot chain's path")
    for name in ("materialize_matured", "flow_admission_occupy", "commit_borrow_slab", "system_check",
                 "breaker_on_exits", "breaker_try_pass", "slot_chain_verdict"):
        results[name]["launches"] = counts[name]
    cpu = cpu_result(cpu_jobs, "4b")
    log(f"  CPU engine (plain versions, in a worker process): {cpu[3] * 1e3:.3f} ms per flush call")
    if len(gpu[0]) != len(cpu[0]) or any(not np.array_equal(a, b) for a, b in zip(gpu[0], cpu[0])):
        fail("slot chain engine verdicts, wait_ms or attribution differ between the card and the CPU")
    for what, a_state, b_state in (("stats", gpu[1], cpu[1]), ("breaker state", gpu[2], cpu[2])):
        for name in a_state._fields:
            a, b = getattr(a_state, name), getattr(b_state, name)
            for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
                if not np.array_equal(x, y):
                    fail(f"slot chain engine {what} {name} differs between the card and the CPU")
    reasons, waits = gpu[4], gpu[5]
    log(f"  verdicts, wait_ms, attribution, stats and breaker state identical on card and CPU; reasons "
        f"(pass, flow, degrade, system, authority) {reasons[:5].tolist()}; {waits} prioritized entries waited; "
        f"final breaker states (closed, open, half-open) {np.bincount(gpu[2].state, minlength=3).tolist()}")
    if min(reasons[:5]) == 0 or waits == 0:
        fail("phase 4b: some stage of the slot chain blocked nothing, or no prioritized entry borrowed")


# ---------------------------------------------------------------------------
# phase 4f: the host pipeline (flush_async, the depth-K flush)
# ---------------------------------------------------------------------------

PIPE_STEPS = 30  # 100 ms each: 3 simulated seconds
PIPE_LAG = 3  # exits complete the entries of three flushes back, which the depth-2 trim has already filled
PIPE_WINDOW = 10  # flushes under torch.profiler, from the tenth on


def device_busy_ms(prof) -> float:
    """The union of the device's kernel, copy and memset intervals in a
    torch.profiler session, in ms (nan when it recorded none)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return float("nan")
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return (busy + cur_e - cur_s) / 1e3


def drive_pipeline_engine(device: torch.device, seed: int, mode: str):
    """Phase 4's stream with its reads held back, so that flushes stay in
    flight: 6,000 DEFAULT rules, PIPE_STEPS flushes of 32,768 Zipf entries,
    exits of the admitted entries of PIPE_LAG flushes back, no st.entry,
    every verdict read after the last flush. ``mode``: "sync" (depth 0),
    "depth2", or "async" (flush_async; nothing is settled in the call: the
    lagged reads settle the older dispatches). On the card an "async"
    dispatch runs under set_sync_debug_mode("error"), a "depth2" flush
    under "warn" with its syncs counted, and flushes PIPE_WINDOW to
    2 * PIPE_WINDOW - 1 (their submits and reads too) under torch.profiler.
    Returns (records, final stats, blocked top-K, ms per flush call, host
    splits, pipeline_stats, syncs per depth-2 flush, the device's busy ms
    a flush over the window, the window's wall ms a step, the median wall
    ms of an unprofiled step: submits, exits, flush)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    clock = tclock.ManualClock(0)
    api.reset(clock=clock, device=device)
    st.flow_rule_manager.load_rules([st.FlowRule(f"r{i}", count=20) for i in range(N_RULES)])
    eng = api.get_engine()
    eng.pipeline_depth = 2 if mode == "depth2" else 0
    if mode == "async":
        eng.max_inflight = PIPE_STEPS
    on_card = device.type == "cuda"
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, N_RULES + 1, dtype=np.float64) ** -1.1
    p = ranks / ranks.sum()
    steps, call_ms, splits, syncs, step_ms = [], [], [], [], []
    prof = None
    busy = window_ms = float("nan")
    for step in range(PIPE_STEPS):
        t_step = time.perf_counter()
        now = 1000 + step * 100
        clock.set_ms(now)
        res = rng.choice(N_RULES, size=FLUSH_N, p=p)
        ts = (now - rng.integers(0, 100, FLUSH_N)).astype(np.int32)
        order = np.argsort(res, kind="stable")
        res, ts = res[order], ts[order]
        uniq, start = np.unique(res, return_index=True)
        bounds = list(start) + [FLUSH_N]
        steps.append([
            eng.submit_bulk(f"r{r}", int(bounds[i + 1] - bounds[i]), ts=np.sort(ts[bounds[i]:bounds[i + 1]]))
            for i, r in enumerate(uniq)
        ])
        if step >= PIPE_LAG:
            for g in steps[step - PIPE_LAG][:50]:
                if g.admitted_count:
                    eng.submit_exit_bulk(g.rows, g.admitted_count, rt=int(rng.integers(1, 300)), ts=now)
        if on_card and step == PIPE_WINDOW:
            prof = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t_win = time.perf_counter()
        t0 = time.perf_counter()
        if mode == "async" and on_card:
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng.flush_async()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        elif mode == "async":
            eng.flush_async()
        elif mode == "depth2" and on_card:
            syncs.append(count_syncs(eng.flush))
        else:
            eng.flush()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        splits.append(eng.last_flush_host_ms)
        if prof is None and step > 0:
            step_ms.append((time.perf_counter() - t_step) * 1e3)
        if prof is not None and step == 2 * PIPE_WINDOW - 1:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_win
            prof.__exit__(None, None, None)
            busy, window_ms = device_busy_ms(prof) / PIPE_WINDOW, wall * 1e3 / PIPE_WINDOW
            prof = None
    stats_ = eng.pipeline_stats()
    eng.flush()
    eng.drain()
    records = []
    for groups in steps:
        records += [np.concatenate([g.admitted for g in groups]), np.concatenate([g.reason for g in groups])]
    return (records, nodes.stats_to_numpy(eng.stats), eng.last_blocked_topk, call_ms, splits, stats_, syncs, busy,
            window_ms, float(np.median(step_ms)) if step_ms else float("nan"))


def same_engine_result(got, want, what: str) -> None:
    """Fails unless (records, final stats, blocked top-K) agree exactly."""
    (ra, sa, ba), (rb, sb, bb) = got, want
    if len(ra) != len(rb) or any(not np.array_equal(a, b) for a, b in zip(ra, rb)):
        fail(f"{what}: verdicts differ")
    for name in sa._fields:
        a, b = getattr(sa, name), getattr(sb, name)
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            if not np.array_equal(x, y):
                fail(f"{what}: final state {name} differs")
    if any(not np.array_equal(x, y) for x, y in zip(ba, bb)):
        fail(f"{what}: blocked top-K differs")


def phase4_pipeline(cpu_jobs: dict) -> None:
    global SYNC_COUNTS
    log(f"phase 4f: the host pipeline on the card (depth 0, depth 2 and flush_async; {PIPE_STEPS} flushes of "
        f"32,768 with the reads held back {PIPE_LAG} flushes; syncs a dispatch; {card_line()})")
    for mode in ("depth2", "async"):
        recs, state, blk, flush_s, _, (_, _, _, splits) = drive_engine(DEV, 4, mode)
        same_engine_result((recs, state, blk), PHASE4_RESULT["card"], f"phase 4's stream at {mode} vs depth 0")
        same_engine_result((recs, state, blk), PHASE4_RESULT["cpu"], f"phase 4's stream at {mode} vs the CPU")
        log(f"  phase 4's stream, {mode} (each flush read at once): {flush_s * 1e3:.3f} ms per flush call, "
            f"verdicts, blocked top-K and state identical to depth 0 and to the CPU engine; {split_line(splits)}")
    cpu = cpu_result(cpu_jobs, "4f")
    for mode in ("sync", "depth2", "async", "depth2", "sync"):
        try:
            out = drive_pipeline_engine(DEV, 10, mode)
        except RuntimeError as exc:
            if "synchroniz" in str(exc):
                fail(f"phase 4f: a DEFAULT dispatch synchronized with the host: {exc}")
            raise
        recs, state, blk, call_ms, splits, pstats, syncs, busy, window_ms, step_med = out
        same_engine_result((recs, state, blk), cpu[:3], f"phase 4f ({mode}) vs the CPU engine at depth 0")
        extra = ""
        if mode == "depth2":
            extra = f"; syncs a flush (dispatch and the trim's wait) {min(syncs)}-{max(syncs)}"
        elif mode == "async":
            extra = "; the dispatch raised no sync under set_sync_debug_mode(\"error\")"
        log(f"  {mode}: a flush call {float(np.median(call_ms[1:])):.3f} ms (median; {min(call_ms[1:]):.3f}-"
            f"{max(call_ms[1:]):.3f}); a step (submits, exits, flush) {step_med:.3f} ms (median, unprofiled); "
            f"steps {PIPE_WINDOW}-{2 * PIPE_WINDOW - 1} under torch.profiler {window_ms:.3f} ms a step, the device "
            f"busy {busy:.4f} ms a step ({100 * busy / window_ms:.2f}%); pipeline_stats {pstats}; "
            f"{split_line(splits[1:])}{extra}")
    log("  verdicts, blocked top-K and final state identical at depth 0, depth 2 and through flush_async, and to "
        "the CPU engine at depth 0")
    # The 4b-4e streams again, each bulk dispatch through flush_async under
    # the "warn" sync debug mode: syncs a dispatch, verdicts as before.
    for name, drive, seed in (("4b", drive_chain_engine, 5), ("4c", drive_shaping_engine, 6),
                              ("4d", drive_sketch_engine, 7), ("4e", drive_mesh_engine, 9)):
        SYNC_COUNTS = ([], [])
        try:
            got = drive(DEV, seed)
        finally:
            (counts, reloads), SYNC_COUNTS = SYNC_COUNTS, None
        want = cpu_result(cpu_jobs, name)
        if len(got[0]) != len(want[0]) or any(
            (a is None) != (b is None) or (a is not None and not np.array_equal(a, b)) for a, b in zip(got[0], want[0])
        ):
            fail(f"phase 4f: the {name} stream through flush_async differs from the CPU engine")
        rebuilds = (f"; {len(reloads)} sketch rule rebuilds before a dispatch, {min(reloads)}-{max(reloads)} syncs "
                    f"each (a rule reload: it decides the queued ops, then copies the new table in)") if reloads else ""
        log(f"  {name} route: {min(counts)}-{max(counts)} syncs a dispatch (median "
            f"{float(np.median(counts)):g}) over {len(counts)} dispatches{rebuilds}; verdicts identical to the CPU "
            f"engine")


# ---------------------------------------------------------------------------
# phase 4c: shaping and hot parameters through the public API
# ---------------------------------------------------------------------------

SHAPE_STEPS = 20  # 200 ms each: 4 simulated seconds


# The param rules sit on resources of the flow rules: 6,000 resources is the
# engine's cap (MAX_SLOT_CHAIN_SIZE); a resource past it passes through.
def API(j: int) -> str:
    return f"r{N_RULES - 1000 + j}"


POOL = "r5990"


def GW(j: int) -> str:
    return f"r{N_RULES - 4 + j}"
SHAPE_N = 16384
GW_N = 1024


def drive_shaping_engine(device: torch.device, seed: int):
    """An engine stream with shaping and hot-parameter rules: 6,000 flow
    rules, one in seven of them a RATE_LIMITER, WARM_UP or
    WARM_UP_RATE_LIMITER (warm-up 2 s, so it refills within the run); param
    rules on 300 of those resources (QPS with hot items, throttles), one
    THREAD-grade rule whose held entries exit a step later and release
    their rows, and four gateway resources whose bulk args columns (one ts,
    one acquire: the closed form) draw client IPs: the first uniformly from
    20,000, past its 4,000-value LRU cap, the others Zipf-skewed from 6,000. Zipf bulk traffic, singles with args,
    st.entry calls with args, exits. Returns (records, final state,
    shaping modes, param modes)."""
    clock = tclock.ManualClock(0)
    api.reset(clock=clock, device=device)
    beh = [0, C.CONTROL_BEHAVIOR_RATE_LIMITER, C.CONTROL_BEHAVIOR_WARM_UP, C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER]
    st.flow_rule_manager.load_rules([
        st.FlowRule(f"r{i}", count=20 + i % 13, control_behavior=beh[i % 7] if i % 7 < 4 else 0,
                    warm_up_period_sec=2, max_queueing_time_ms=300 + (i % 5) * 100)
        for i in range(N_RULES)
    ])
    hot = [st.ParamFlowItem(object="vip", count=50)]
    param_rules = [st.ParamFlowRule(API(j), param_idx=0, count=3 + j % 4, burst_count=j % 2,
                                    param_flow_item_list=hot) for j in range(0, 300, 2)]
    param_rules += [st.ParamFlowRule(API(j), param_idx=0, count=5 + j % 3, max_queueing_time_ms=400,
                                     control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER) for j in range(1, 300, 2)]
    param_rules += [st.ParamFlowRule(POOL, param_idx=0, count=2, grade=C.FLOW_GRADE_THREAD)]
    param_rules += [st.ParamFlowRule(GW(j), param_idx=0, count=5, burst_count=2) for j in range(4)]
    st.param_flow_rule_manager.load_rules(param_rules)
    eng = api.get_engine()
    modes = {"shaping": [], "param": []}
    orig_sh, orig_p = flush.shaping_stage, flush.run_param

    def rec_sh(*a, **k):
        modes["shaping"].append(a[7] if len(a) > 7 else k.get("rounds", 0))
        return orig_sh(*a, **k)

    def rec_p(*a, **k):
        modes["param"].append(a[2] if len(a) > 2 else k.get("rounds", 0))
        return orig_p(*a, **k)

    flush.shaping_stage, flush.run_param = rec_sh, rec_p
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, N_RULES + 1, dtype=np.float64) ** -1.1
    p = ranks / ranks.sum()
    ip_p = np.arange(1, 6001, dtype=np.float64) ** -0.8
    ip_p /= ip_p.sum()
    records, held, prev_groups = [], [], []
    flush_s = 0.0
    try:
        for step in range(SHAPE_STEPS):
            now = 1000 + step * 200
            clock.set_ms(now)
            res = np.sort(rng.choice(N_RULES, size=SHAPE_N, p=p))
            ts = (now - rng.integers(0, 150, SHAPE_N)).astype(np.int32)
            uniq, start = np.unique(res, return_index=True)
            bounds = list(start) + [SHAPE_N]
            groups = [eng.submit_bulk(f"r{r}", int(bounds[i + 1] - bounds[i]),
                                      ts=np.sort(ts[bounds[i]:bounds[i + 1]]))
                      for i, r in enumerate(uniq)]
            for g in prev_groups[:60]:
                if g.admitted_count:
                    eng.submit_exit_bulk(g.rows, g.admitted_count, rt=int(rng.integers(1, 200)), ts=now)
            singles = []
            if step % 2 == 0:
                # The gateway shape: one ts, one acquire (the closed form).
                for j in range(4):
                    ips = rng.integers(0, 20000, GW_N) if j == 0 else rng.choice(6000, GW_N, p=ip_p)
                    col = [(f"10.0.{int(x) // 256}.{int(x) % 256}",) for x in ips]
                    groups.append(eng.submit_bulk(GW(j), GW_N, ts=now, args_column=col))
            else:
                users = ["vip"] + [f"u{i}" for i in range(40)]
                singles = [eng.submit_entry(API(int(a)), ts=now - int(rng.integers(0, 60)),
                                            args=(users[int(u)],))
                           for a, u in zip(rng.integers(0, 300, 96), rng.integers(0, 41, 96))]
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            flush_engine(eng)
            flush_s += time.perf_counter() - t0
            for g in groups:
                records += [g.admitted, g.reason, g.wait_ms]
            records.append(np.array([_verdict_record(o.verdict) for o in singles], dtype=object))
            prev_groups = groups[:-4] if step % 2 == 0 else groups
            if step % 5 == 0:
                # One rate limiter alone at one ts: the shaping closed form.
                g = eng.submit_bulk("r1", 400, ts=now + 10)
                eng.flush()
                records += [g.admitted, g.wait_ms]
            # Through the public API: args on st.entry, a THREAD-grade pool
            # whose entries are held for a step.
            for e in held:
                clock.set_ms(now + 20)
                e.exit()
            held = []
            for j, (resource, arg) in enumerate(((API(3), "vip"), (API(4), "u1"), (POOL, "k1"), (POOL, "k1"),
                                                  (POOL, "k1"), ("r1", None))):
                clock.set_ms(now + 50 + j)
                try:
                    e = st.entry(resource, args=(arg,) if arg is not None else ())
                    records.append(np.array(["pass", clock.now_ms()], dtype=object))
                    if resource == POOL:
                        held.append(e)
                    else:
                        e.exit()
                except st.BlockError as exc:
                    rule = getattr(exc, "rule", None)
                    records.append(np.array([type(exc).__name__, None if rule is None else rule.resource],
                                            dtype=object))
        for e in held:
            e.exit()
        eng.flush()
    finally:
        flush.shaping_stage, flush.run_param = orig_sh, orig_p
    state = (nodes.stats_to_numpy(eng.stats), tuple(t.cpu().numpy() for t in eng.flow_dyn),
             tpt.param_state_to_numpy(eng.param_dyn), json.dumps(eng.param_index.values_snapshot()))
    return records, state, modes, flush_s / SHAPE_STEPS, eng.param_index.cache_stats()


def phase4_shaping(results: dict, cpu_jobs: dict) -> None:
    log(f"phase 4c: shaping and hot parameters through the public API ({SHAPE_STEPS} flushes of {SHAPE_N:,} Zipf "
        f"entries over 6,000 rules, one in seven shaping; param rules on 300 resources, a THREAD-grade pool, "
        f"gateway args columns)")
    counters = {  # no prioritized entries: the sweep (K1) does not run here
        "window_update": ma.update, "thread_gauge": nodes.thread_gauge_add,
        "flow_admission": flush.flow_admission, "slot_chain_verdict": flush.slot_chain_verdict,
        "shaping_stage": tsh.shaping_stage, "run_param": tpt.run_param,
    }
    for w in counters.values():
        w.launches = 0
    gpu = drive_shaping_engine(DEV, seed=6)
    counts = {name: w.launches for name, w in counters.items()}
    log(f"  card: {gpu[3] * 1e3:.3f} ms per flush call (host encode and verdict copy included)")
    log(f"  launches on the path: {counts}")
    for name, c in counts.items():
        if c <= 0:
            fail(f"kernel {name} was not launched on the shaping and param path")
    for name in ("shaping_stage", "run_param"):
        results[name]["launches"] = counts[name]
    cpu = cpu_result(cpu_jobs, "4c")
    log(f"  CPU engine (plain versions, in a worker process): {cpu[3] * 1e3:.3f} ms per flush call")
    if len(gpu[0]) != len(cpu[0]) or any(not np.array_equal(a, b) for a, b in zip(gpu[0], cpu[0])):
        fail("shaping/param engine verdicts, wait_ms or attribution differ between the card and the CPU")
    gs, cs = gpu[1], cpu[1]
    for what, a_state, b_state in (("stats", gs[0], cs[0]), ("param state", gs[2], cs[2])):
        for name in a_state._fields:
            a, b = getattr(a_state, name), getattr(b_state, name)
            for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
                if not np.array_equal(x, y):
                    fail(f"shaping/param engine {what} {name} differs between the card and the CPU")
    if any(not np.array_equal(x.view(np.int32), y.view(np.int32)) for x, y in zip(gs[1], cs[1])):
        fail("shaping/param engine flow shaping state differs between the card and the CPU")
    if gs[3] != cs[3]:
        fail("shaping/param engine value interning differs between the card and the CPU")
    if gpu[2] != cpu[2]:
        fail("the card and the CPU engine took different shaping/param modes")
    modes = {k: sorted(set(v)) for k, v in gpu[2].items()}
    log(f"  verdicts, wait_ms, attribution, stats, shaping state, param state and value interning identical on "
        f"card and CPU; shaping modes {modes['shaping']}, param modes {modes['param']}; value cache {gpu[4]}")
    if -1 not in modes["shaping"] or -1 not in modes["param"] or not any(m >= 0 for m in modes["param"]):
        fail("phase 4c: the stream did not take the closed forms and the rounds path")
    if gpu[4]["evictions"] == 0:
        fail("phase 4c: no value row was recycled by the LRU cap")


# ---------------------------------------------------------------------------
# phase 7: examples/param_flow_demo.py on the port
# ---------------------------------------------------------------------------


def phase7() -> None:
    log("phase 7: examples/param_flow_demo.py's sequence on the card (per-value budgets, a hot item)")
    clock = tclock.ManualClock(0)
    prev = tclock.set_default_clock(clock)
    api.reset(clock=clock, device=DEV)
    st.param_flow_rule_manager.load_rules([st.ParamFlowRule(
        resource="buy", param_idx=0, count=2, param_flow_item_list=[st.ParamFlowItem(object="flash-sale", count=5)])])

    def attempt(ts, product):
        clock.set_ms(ts)
        e = st.try_entry("buy", args=(product,))
        if e:
            e.exit()
            return "pass"
        return "BLOCK"

    passes = {}
    for product in ("normal-item", "flash-sale"):
        results = [attempt(100 + i, product) for i in range(7)]
        passes[product] = results.count("pass")
        log(f"  {product:12s}: {' '.join(results)}")
    tclock.set_default_clock(prev)
    log(f"  normal-item passes {passes['normal-item']}, flash-sale passes {passes['flash-sale']}")
    if passes != {"normal-item": 2, "flash-sale": 5}:
        fail(f"param demo passes {passes} != normal-item 2, flash-sale 5")


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
    splits = []
    lock = threading.Lock()
    stop = threading.Event()
    errors = []
    eng = api.get_engine()

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
                split = eng.last_flush_host_ms  # this call's flush or a concurrent caller's
                with lock:
                    latencies.append(decided - t_call)
                    splits.append(split)
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
    log(f"  host split of the flushes (Engine.last_flush_host_ms read after each call): {split_line(splits)}")


# ---------------------------------------------------------------------------
# phase 6: examples/degrade_demo.py on the port
# ---------------------------------------------------------------------------

DEMO_LINES = ["error"] * 5 + ["BLOCKED (breaker open)"] * 3 + ["ok", "ok"]


def phase6() -> None:
    log("phase 6: examples/degrade_demo.py's sequence on the card (exception-ratio breaker)")
    clock = tclock.ManualClock(0)
    prev = tclock.set_default_clock(clock)
    api.reset(clock=clock, device=DEV)
    st.flow_rule_manager.load_rules([st.FlowRule("backend", count=1000)])
    st.degrade_rule_manager.load_rules([
        st.DegradeRule(resource="backend", grade=1, count=0.5, time_window=5, min_request_amount=5)
    ])

    def call(ts, fail_call):
        clock.set_ms(ts)
        try:
            e = st.entry("backend")
        except st.DegradeBlockError:
            return "BLOCKED (breaker open)"
        if fail_call:
            e.set_error(RuntimeError("downstream 500"))
        e.exit()
        return "error" if fail_call else "ok"

    lines = [call(i * 10, True) for i in range(6)]
    lines += [call(1000, False), call(3000, False), call(5200, False), call(5300, False)]
    tclock.set_default_clock(prev)
    log(f"  {lines}")
    if lines != DEMO_LINES:
        fail(f"degrade demo lines {lines} != {DEMO_LINES}")


# ---------------------------------------------------------------------------
# phase 2d: K11, the sketch fold, against its plain version
# ---------------------------------------------------------------------------

SK_S = N  # keys per fold: the north-star batch, every entry a distinct key


def sketch_inputs(rng, case: str):
    """(state, batch) on DEV for phase 2d: (a) "default", the default tier
    (depth 4, width 2,048, 64 candidates) after eight earlier folds of
    131,072 distinct keys (the table is full), then 131,072 distinct keys
    with weights 1-4, a third of the candidates among them; (b) "widened",
    depth 8, width 2^20, 1,024 candidates, 131,072 host-aggregated ids of a
    Zipf(1.1) stream over 10^6 keys (weights = their counts), 1,024
    duplicate rows and 1,024 padding; (c) "ties", (a) with every weight 2."""
    depth, width, c = (8, 1 << 20, 1024) if case == "widened" else (4, 2048, 64)
    state = tsk.make_sketch_state(depth, width, c, DEV)
    keys = rng.permutation(np.unique(rng.integers(0, 2**31 - 1, 14 * SK_S))[: 9 * SK_S]).astype(np.int32)

    def batch(ids, w):
        return tsk.SketchBatch(torch.from_numpy(ids.astype(np.int32)).to(DEV),
                               torch.from_numpy(np.asarray(w, dtype=np.int32)).to(DEV))

    for k in range(8):
        ids = keys[k * SK_S:(k + 1) * SK_S]
        tsk.sketch_fold_plain(state, batch(ids, rng.integers(1, 5, SK_S)), decay=k == 4)
    if case == "widened":
        draws = rng.zipf(1.1, 6 * 10**6)
        uniq, cnt = np.unique(draws[draws <= 10**6], return_counts=True)
        n_agg = SK_S - 2048
        ids = np.concatenate([keys[uniq[:n_agg] - 1], keys[uniq[:1024] - 1], np.full(1024, -1, np.int32)])
        w = np.concatenate([cnt[:n_agg], cnt[:1024], np.zeros(1024, np.int64)])
    else:
        ids = keys[8 * SK_S:9 * SK_S].copy()
        ids[: c // 3] = state.cand_ids[: c // 3].cpu().numpy()
        w = np.full(SK_S, 2) if case == "ties" else rng.integers(1, 5, SK_S)
    return state, batch(ids, w)


def sketch_bytes(state, sk, decay: bool) -> float:
    """Least bytes of one fold: the key batch read once; each count-min cell
    the batch touches read and written once (the whole array with decay);
    the candidate table read and written."""
    d, w = state.cm.shape
    valid = sk.ids >= 0
    uids = sk.ids[valid].to(torch.int64) & 0xFFFFFFFF
    cells = torch.cat([tsk._hash_torch(uids, di, w) + di * w for di in range(d)])
    touched = d * w if decay else torch.unique(cells).numel()
    return sk.ids.numel() * 8 + touched * 8 + state.cand_ids.numel() * 16


def phase2_sketch(results: dict) -> None:
    log("phase 2d: K11 (the sketch fold) against its plain version: the default tier, a widened tier and ties, "
        f"{SK_S:,} keys per fold, decay off and on")
    rng = np.random.default_rng(24)
    err = 0
    for case in ("default", "widened", "ties"):
        base, sk = sketch_inputs(rng, case)
        for decay in (False, True):
            want = tsk.sketch_fold_plain(clone(base), sk, decay)
            got = tsk.sketch_fold(clone(base), sk, decay)
            err = max(err, require_equal(want, got, f"sketch_fold ({case}, decay={decay})"))
            full = int((got.cand_ids >= 0).sum())
            recur = int(torch.isin(base.cand_ids, sk.ids).sum())
            log(f"  {case}, decay={decay}: equal (max abs err 0); {full}/{got.cand_ids.numel()} candidates, "
                f"{recur} of the prior ones in the batch, top count {int(got.cand_cnt.max())}")
        c = base.cand_ids.numel()
        scratch = clone(base)
        k_ms = time_ms(lambda: tsk.sketch_fold(scratch, sk, False))
        p_ms = time_ms(lambda: tsk.sketch_fold_plain(scratch, sk, False), iters=3, warmup=1)
        m_cnt = torch.randint(-1, 5000, (c + SK_S,), device=DEV, dtype=I32)
        topk_ms = time_ms(lambda: torch.topk(m_cnt, c))
        d, w = base.cm.shape
        valid = sk.ids >= 0
        uids = sk.ids[valid].to(torch.int64) & 0xFFFFFFFF
        flat = torch.cat([tsk._hash_torch(uids, di, w) + di * w for di in range(d)])
        wt = sk.w[valid].repeat(d)
        cm_flat = scratch.cm.reshape(-1)
        add_ms = time_ms(lambda: cm_flat.index_add_(0, flat, wt))
        b = bound(sketch_bytes(base, sk, False))
        log(f"    {case}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, torch.topk (the top-C step) {topk_ms:.4f} ms, "
            f"index_add_ (the count-min adds) {add_ms:.4f} ms, bound {b[0]:.5f} ms")
        r = results["sketch_fold"]
        if case == "default":
            r.update(
                ms=k_ms, plain_ms=p_ms, library_ms=topk_ms, index_add_ms=add_ms, bound=b,
                library_call=f"torch.topk(k={c}) over the {c + SK_S} merged counts (the top-C step only); "
                             "index_add_ms: Tensor.index_add_ of the count-min adds",
                shape=f"depth {d}, width {w}, {c} candidates, S={SK_S} distinct keys",
            )
            # Kernels, memsets and device time a call at S keys (and with
            # decay) and at 8, and each route at 512-8,192 keys; the compared
            # calls each start from a fresh copy of the state.
            def fold(fn, fresh, decay=False):
                def at(n):
                    sk_n = tsk.SketchBatch(sk.ids[:n].clone(), sk.w[:n].clone())
                    return lambda: fn(clone(base) if fresh else scratch, sk_n, decay)

                return at

            call_profile(results, "sketch_fold", fold(tsk.sketch_fold, False)(SK_S),
                         fold(tsk.sketch_fold, True)(8), fold(tsk.sketch_fold_plain, True)(8), "phase 2d",
                         small_timed=fold(tsk.sketch_fold, False)(8))
            r["kernel_us"] = kernel_times(fold(tsk.sketch_fold, False)(SK_S))
            decayed = fold(tsk.sketch_fold, False, True)(SK_S)
            r["decay_ms"] = time_ms(decayed)
            r["decay_launches_per_call"], r["decay_memsets_per_call"], r["decay_device_ms"] = profile(
                decayed, "phase 2d: sketch_fold with decay")
            r["decay_kernel_us"] = kernel_times(decayed)
            log(f"    sketch_fold: us by kernel {r['kernel_us']}; with decay {r['decay_ms']:.4f} ms, "
                f"{r['decay_launches_per_call']} kernels, {r['decay_memsets_per_call']} memsets, "
                f"{r['decay_device_ms']:.4f} ms of device time, us by kernel {r['decay_kernel_us']}")
            route_times(results, "sketch_fold", tsk, "SKETCH_FOLD_SMALL_MAX", fold(tsk.sketch_fold, True),
                        fold(tsk.sketch_fold_plain, True), (512, 1024, 2048, 4096, 8192), "phase 2d",
                        timed_at=fold(tsk.sketch_fold, False))
        else:
            r[f"{case}_ms"] = k_ms
            if case == "widened":
                wide = lambda: tsk.sketch_fold(scratch, sk, False)
                _, _, r["widened_device_ms"] = profile(wide, "phase 2d: sketch_fold (widened)")
                r["widened_kernel_us"] = kernel_times(wide)
                log(f"    widened: {r['widened_device_ms']:.4f} ms of device time, us by kernel "
                    f"{r['widened_kernel_us']}")
        del base, sk, scratch, m_cnt, flat, wt
        torch.cuda.empty_cache()
    results["sketch_fold"]["max_abs_err"] = err


# ---------------------------------------------------------------------------
# phase 2e: K12, the token server's decision, against its plain version
# ---------------------------------------------------------------------------

TD_SIZES = (8, 64, 1024)  # the main path's batches (8-64) and the one-block route's edge


def token_bytes(state, arrays, admitted) -> float:
    """Least bytes of one decision: each request's six inputs read and three
    outputs written; each distinct flow and namespace row's ten bucket
    starts and PASS counts read; each charged row's bucket written."""
    rows, ns_rows = arrays[0], arrays[1]
    touched = torch.unique(torch.cat([rows, ns_rows])).numel()
    charged = torch.unique(torch.cat([rows[admitted], ns_rows[admitted & (ns_rows >= 0)]])).numel()
    b = rows.numel()
    return b * (4 + 4 + 4 + 4 + 4 + 1) + b * (1 + 1 + 4) + touched * 10 * 8 + charged * (4 * NUM_EVENTS + 8)


def phase2_token(results: dict) -> None:
    log(f"phase 2e: K12 (the token decision) against its plain version: {TD_FLOWS:,} flows in {TD_NS} namespaces, "
        f"batches of {TD_B:,}, 2 s of clock in 50 ms steps; the atomic variant; K2 and K3 on the 10 x 100 ms "
        "geometry")
    rng = np.random.default_rng(25)
    counts = rng.integers(50, 501, TD_FLOWS).astype(np.float32)
    nrows = TD_FLOWS + TD_NS
    kern = ma.make_state(nrows, tts.CLUSTER_CFG, DEV)
    plain = ma.make_state(nrows, tts.CLUSTER_CFG, DEV)
    status = np.zeros(3, dtype=np.int64)  # OK, BLOCKED, TOO_MANY_REQUEST
    err = 0
    for step in range(40):
        arrays = token_batch(rng, counts, DEV)
        now = 1000 + 50 * step
        if step == 20:
            # K3 and K2 on the cluster geometry, on this stream's state.
            both = torch.cat([arrays[0], arrays[1]])
            err3 = require_equal(ma.window_reduce_plain(tts.CLUSTER_CFG, kern, now, both),
                                 ma.window_reduce(tts.CLUSTER_CFG, kern, now, both), "window_sums (cluster)")
            d = torch.zeros((2 * TD_B, NUM_EVENTS), dtype=I32, device=DEV)
            d[:, 0] = torch.cat([arrays[2], arrays[2]])
            ts_ = torch.full((2 * TD_B,), now, dtype=I32, device=DEV)
            mask = torch.rand(2 * TD_B, device=DEV) < 0.7
            err2 = require_equal(ma.update_plain(tts.CLUSTER_CFG, clone(kern), both, ts_, d, None, mask),
                                 ma.update(tts.CLUSTER_CFG, clone(kern), both, ts_, d, None, mask),
                                 "window_update (cluster)")
            results["window_sums"]["max_abs_err"] = max(results["window_sums"].get("max_abs_err", 0), err3)
            results["window_update"]["max_abs_err"] = max(results["window_update"].get("max_abs_err", 0), err2)
            log("  K3 (2 x 16,384 gathered rows) and K2 (32,768 PASS updates) on the 10 x 100 ms geometry equal "
                "their plain versions")
            t_state, t_arrays, t_now = clone(kern), arrays, now
        want = tts.batch_decide_plain(plain, *arrays, now)
        got = tts.batch_decide(kern, *arrays, now)
        err = max(err, require_equal(want, got, f"token_decide (step {step})"),
                  require_equal(plain, kern, f"token_decide state (step {step})"))
        adm, ns_ok, _ = tts.unpack_decision(got)
        status += [int(adm.sum()), int((ns_ok & ~adm).sum()), int((~ns_ok).sum())]
    log(f"  40 batches equal (max abs err 0): OK {status[0]:,}, BLOCKED {status[1]:,}, "
        f"TOO_MANY_REQUEST {status[2]:,}")
    if (status == 0).any():
        fail(f"phase 2e: the stream did not show OK, BLOCKED and TOO_MANY_REQUEST: {status.tolist()}")
    # (b) the atomic variant: 8,192 values of one flow.
    b = 8192
    for over in (True, False):
        rows = np.arange(b, dtype=np.int32)
        if over:
            rows[-1] = 0  # a value over its budget of 1
        arrays = [torch.from_numpy(a).to(DEV) for a in (rows, np.full(b, -1, np.int32), np.ones(b, np.int32),
                                                         np.ones(b, np.float32), np.zeros(b, np.float32),
                                                         np.ones(b, bool))]
        st_k = ma.make_state(b, tts.CLUSTER_CFG, DEV)
        st_p = clone(st_k)
        want = tts.batch_decide_plain(st_p, *arrays, 700, atomic=True)
        got = tts.batch_decide(st_k, *arrays, 700, atomic=True)
        err = max(err, require_equal(want, got, f"token_decide atomic (over={over})"),
                  require_equal(st_p, st_k, f"token_decide atomic state (over={over})"))
        charged = int(st_k.counts.sum())
        log(f"  atomic, {'one value over budget' if over else 'all within budget'}: equal; "
            f"{int(got[0].sum()):,} admitted, {charged:,} charged")
        if charged != (0 if over else b):
            fail(f"phase 2e: the atomic batch (over={over}) charged {charged}")
    # (c) the other sizes (the one-block route up to 2,048) and the int32
    # wrap, plain and atomic in turns, each on a stream of its own.
    for b, wrap in [(b, False) for b in TD_SIZES] + [(64, True), (TD_B, True)]:
        st_k = ma.make_state(nrows, tts.CLUSTER_CFG, DEV)
        st_p = clone(st_k)
        for step in range(12):
            arrays = token_batch(rng, counts, DEV, b, wrap)
            now = 1000 + 100 * step
            want = tts.batch_decide_plain(st_p, *arrays, now, atomic=step % 2 == 1)
            got = tts.batch_decide(st_k, *arrays, now, atomic=step % 2 == 1)
            err = max(err, require_equal(want, got, f"token_decide (B={b}, wrap={wrap}, step {step})"),
                      require_equal(st_p, st_k, f"token_decide state (B={b}, wrap={wrap}, step {step})"))
        if b == TD_SIZES[0] and not wrap:
            s_state, s_arrays, s_now = clone(st_k), arrays, now + 100
    log(f"  B in {TD_SIZES}, and the int32 wrap at B=64 and B={TD_B:,}: 12 batches each, plain and atomic, "
        "equal (max abs err 0)")
    scratch = clone(t_state)
    decide = lambda: tts.batch_decide(scratch, *t_arrays, t_now)
    k_ms = time_ms(decide)
    launches, memsets, dev_ms = profile(decide, f"phase 2e: the token decision at B={TD_B}")
    small = clone(s_state)
    decide_small = lambda: tts.batch_decide(small, *s_arrays, s_now)
    small_ms = time_ms(decide_small)
    small_launches, small_memsets, small_dev_ms = profile(decide_small,
                                                          f"phase 2e: the token decision at B={TD_SIZES[0]}")
    p_ms = time_ms(lambda: tts.batch_decide_plain(scratch, *t_arrays, t_now), iters=5)
    adm = tts.batch_decide_plain(clone(t_state), *t_arrays, t_now)[0] != 0
    s_adm = tts.batch_decide_plain(clone(s_state), *s_arrays, s_now)[0] != 0
    results["token_decide"].update(
        ms=k_ms, plain_ms=p_ms, library_ms=None, max_abs_err=err, bound=bound(token_bytes(t_state, t_arrays, adm)),
        launches_per_call=launches, memsets_per_call=memsets, device_ms=dev_ms, small_ms=small_ms,
        small_launches_per_call=small_launches, small_memsets_per_call=small_memsets, small_device_ms=small_dev_ms,
        small_bound_ms=bound(token_bytes(s_state, s_arrays, s_adm))[0],
        shape=f"B={TD_B} requests over {TD_FLOWS} flows in {TD_NS} namespaces (the gathered sums, the decision, "
              f"the commit); small_ms at B={TD_SIZES[0]}",
    )
    log(f"  timing (batch 21): kernel {k_ms:.4f} ms a call ({launches} device kernels, {memsets} memsets, "
        f"{dev_ms:.4f} ms of device time), plain {p_ms:.4f} ms; B={TD_SIZES[0]}: {small_ms:.4f} ms a call "
        f"({small_launches} device kernels, {small_memsets} memsets, {small_dev_ms:.4f} ms of device time)")
    if (small_launches, small_memsets) != (1, 0):
        fail(f"phase 2e: the one-block route issued {small_launches} kernels and {small_memsets} memsets for "
             f"B={TD_SIZES[0]}")
    del kern, plain, scratch, t_state, small, s_state
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4d: the engine with the sketch tier armed
# ---------------------------------------------------------------------------

SK_STEPS = 40  # 100 ms each: 4 simulated seconds
SK_VALUES = 8192  # distinct cold values of the sketch-mode rule per flush
SK_NAMES = 100_000  # unconfigured resource names
SK_RES_N = 1024  # unconfigured-resource entries per flush
SKETCH_SETTINGS = {
    "sentinel.tpu.sketch.enabled": "true",
    "sentinel.tpu.sketch.width": "65536",  # ~12,000 keys a flush: the default 2,048 counters would saturate
    "sentinel.tpu.sketch.promote.qps": "20",
    "sentinel.tpu.sketch.resource.qps": "100",
    "sentinel.tpu.sketch.cold.qps": "60",
    "sentinel.tpu.sketch.promote.max": "24",
    "sentinel.tpu.sketch.demote.windows": "1",
}


def drive_sketch_engine(device: torch.device, seed: int):
    """An engine stream with the sketch tier armed: a sketch-mode param rule
    on "api" over 8,192 new values per flush plus 16 hot values (hot for the
    first second, then gone: they promote, then decay and demote), and from
    the sixth flush on unconfigured resources drawn from a Zipf(1.1) law over
    100,000 names (past the 6,000-resource cap) under resource promotion
    (the promotion budget of 24 fills) and the cold ceiling; 40 flushes over
    4 simulated seconds. Returns (records, sketch state, host twin,
    promotions, stats, seconds per flush call)."""
    from sentinel_tpu_torch.utils.config import config

    clock = tclock.ManualClock(0)
    for key, value in SKETCH_SETTINGS.items():
        config.set(key, value)
    try:
        api.reset(clock=clock, device=device)
    finally:
        config.reset()
    eng = api.get_engine()
    st.param_flow_rule_manager.load_rules([st.ParamFlowRule("api", param_idx=0, count=5, sketch_mode=True)])
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, SK_NAMES + 1, dtype=np.float64) ** -1.1
    p = ranks / ranks.sum()
    hot = [f"hot{i}" for i in range(16)]
    records, promos = [], []
    flush_s = 0.0
    for step in range(SK_STEPS):
        now = 1000 + step * 100
        clock.set_ms(now)
        col = [(f"v{step}-{j}",) for j in range(SK_VALUES)]
        if step < 10:
            col += [(h,) for h in hot for _ in range(8)]
        groups = [eng.submit_bulk("api", len(col), ts=now, args_column=col)]
        singles = [eng.submit_entry("api", ts=now, args=(hot[step % 16],))]
        if step >= 5:
            names, n = np.unique(rng.choice(SK_NAMES, size=SK_RES_N, p=p), return_counts=True)
            groups += [eng.submit_bulk(f"u{int(r)}", int(c), ts=now) for r, c in zip(names, n)]
            singles.append(eng.submit_entry(f"u{int(names[0])}", ts=now))
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        flush_engine(eng)
        flush_s += time.perf_counter() - t0
        for g in groups:
            records += ([None] if g is None else [g.admitted, g.reason])
        records.append(np.array([None if o is None else _verdict_record(o.verdict) for o in singles], dtype=object))
        tier = eng.sketch
        promos.append((sorted(tier.promoted_values.get("api", ())), sorted(tier._promoted_res), tier.cold_blocks,
                       tier.candidates_snapshot(64)))
    state = tsk.sketch_state_to_numpy(eng.sketch.dev_state)
    twin = eng.sketch._host_cm.copy()
    stats = nodes.stats_to_numpy(eng.stats)
    return records, state, twin, promos, stats, flush_s / SK_STEPS


def phase4_sketch(results: dict, cpu_jobs: dict) -> None:
    log(f"phase 4d: the sketch tier through the engine ({SK_STEPS} flushes over 4 simulated s: a sketch-mode param "
        f"rule over {SK_VALUES:,} new values per flush plus 16 hot ones, Zipf(1.1) resources over "
        f"{SK_NAMES:,} names under resource promotion and the cold ceiling)")
    wrappers = {"sketch_fold": tsk.sketch_fold, "flow_admission": flush.flow_admission, "run_param": tpt.run_param}
    for w in wrappers.values():
        w.launches = 0
    gpu = drive_sketch_engine(DEV, seed=7)
    counts = {name: w.launches for name, w in wrappers.items()}
    log(f"  card: {gpu[5] * 1e3:.3f} ms per flush call (host encode, key stream and verdict copy included)")
    log(f"  launches on the path: {counts}")
    if counts["sketch_fold"] <= 0:
        fail("kernel sketch_fold was not launched on the sketch path")
    results["sketch_fold"]["launches"] = counts["sketch_fold"]
    cpu = cpu_result(cpu_jobs, "4d")
    log(f"  CPU engine (plain versions, in a worker process): {cpu[5] * 1e3:.3f} ms per flush call")
    if len(gpu[0]) != len(cpu[0]) or any(
        (a is None) != (b is None) or (a is not None and not np.array_equal(a, b)) for a, b in zip(gpu[0], cpu[0])
    ):
        fail("sketch engine verdicts differ between the card and the CPU")
    for name, a, b in zip(("count-min", "candidate ids", "candidate counts"), gpu[1], cpu[1]):
        if not np.array_equal(a, b):
            fail(f"sketch engine {name} differ between the card and the CPU")
    if not np.array_equal(gpu[2], cpu[2]):
        fail("sketch engine host twin differs between the card and the CPU")
    if gpu[3] != cpu[3]:
        fail("sketch engine promotions, cold blocks or candidate tables differ between the card and the CPU")
    for name in gpu[4]._fields:
        a, b = getattr(gpu[4], name), getattr(cpu[4], name)
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            if not np.array_equal(x, y):
                fail(f"sketch engine stats {name} differ between the card and the CPU")
    peak_vals = max(len(v) for v, _, _, _ in gpu[3])
    final_vals, final_res, cold, _ = gpu[3][-1]
    log(f"  verdicts, count-min, candidate tables, host twin, promotions and stats identical on card and CPU; "
        f"up to {peak_vals} values promoted (at the end {len(final_vals)}), {len(final_res)} resources promoted, "
        f"{cold:,} entries refused by the cold ceiling")
    if peak_vals < 16 or len(final_vals) >= peak_vals or not final_res or cold <= 0:
        fail("phase 4d: the stream did not promote the 16 hot values, demote them, promote a resource and refuse "
             "cold entries")


# ---------------------------------------------------------------------------
# phase 8: examples/cluster_demo.py through the embedded token service
# ---------------------------------------------------------------------------

CLUSTER_DEMO = ["OK"] * 3 + ["BLOCKED"] * 2 + ["OK", "OK", "BLOCKED", "RELEASE_OK", "OK"]


def drive_cluster_engine(device: torch.device, seed: int):
    """st.entry calls on cluster-mode QPS, THREAD and param rules (and a
    local rule beside the QPS one) through the embedded token service,
    over 3 simulated seconds. Returns (records, held tokens at the end)."""
    clock = tclock.ManualClock(0)
    prev = tclock.set_default_clock(clock)
    api.reset(clock=clock, device=device)
    svc = tcl.DefaultTokenService(clock=clock, device=device)
    tcl.cluster_flow_rule_manager.clear()
    def cfg(fid, **kw):
        return ClusterFlowConfig(flow_id=fid, threshold_type=C.FLOW_THRESHOLD_GLOBAL, **kw)

    qps = st.FlowRule("cq", count=40, cluster_mode=True, cluster_config=cfg(501))
    thr = st.FlowRule("ct", count=6, grade=C.FLOW_GRADE_THREAD, cluster_mode=True,
                      cluster_config=cfg(502, fallback_to_local_when_fail=False))
    par = st.ParamFlowRule("cp", param_idx=0, count=5, cluster_mode=True, cluster_config=cfg(503))
    tcl.cluster_flow_rule_manager.load_rules("default", [qps, thr, par])
    tcl.EmbeddedClusterTokenServerProvider.register(svc)
    tcl.ClusterStateManager.set_to_server()
    try:
        st.flow_rule_manager.load_rules([qps, thr, st.FlowRule("cq", count=30)])
        st.param_flow_rule_manager.load_rules([par])
        rng = np.random.default_rng(seed)
        records, held = [], []
        for step in range(600):
            clock.set_ms(100 + step * 5)
            kind = int(rng.integers(0, 3))
            resource = ("cq", "ct", "cp")[kind]
            try:
                e = st.entry(resource, args=(f"v{int(rng.integers(0, 8))}",) if kind == 2 else ())
                records.append((resource, "pass"))
                if kind == 1:
                    held.append(e)
                else:
                    e.exit()
            except st.BlockError as exc:
                records.append((resource, type(exc).__name__))
            if len(held) > 4 or (held and rng.random() < 0.3):
                held.pop(0).exit()
        records.append(json.dumps(svc.flow_stats(), sort_keys=True))
        return records, svc.concurrent.now_calls(502)
    finally:
        tcl.ClusterStateManager.stop()
        tcl.EmbeddedClusterTokenServerProvider.clear()
        tcl.cluster_flow_rule_manager.clear()
        tclock.set_default_clock(prev)


def phase8(results: dict, cpu_jobs: dict) -> None:
    log("phase 8: examples/cluster_demo.py's sequence through the embedded DefaultTokenService on the card, then "
        "an st.entry stream on cluster-mode QPS, THREAD and param rules")
    clock = tclock.ManualClock(0)
    svc = tcl.DefaultTokenService(clock=clock, device=DEV)
    cfg = ClusterFlowConfig
    tcl.cluster_flow_rule_manager.load_rules("default", [
        st.FlowRule("api", count=3, cluster_mode=True,
                    cluster_config=cfg(flow_id=100, threshold_type=C.FLOW_THRESHOLD_GLOBAL)),
        st.FlowRule("job", count=2, grade=C.FLOW_GRADE_THREAD, cluster_mode=True, cluster_config=cfg(flow_id=200)),
    ])
    lines = [svc.request_token(100).status.name for _ in range(5)]
    t1, t2, t3 = (svc.request_concurrent_token(200) for _ in range(3))
    lines += [t1.status.name, t2.status.name, t3.status.name]
    lines.append(svc.release_concurrent_token(t1.token_id).status.name)
    lines.append(svc.request_concurrent_token(200).status.name)
    tcl.cluster_flow_rule_manager.clear()
    log(f"  global QPS tokens (count=3): {lines[:5]}; held tokens (count=2): acquire x3 {lines[5:8]}, "
        f"release {lines[8]}, acquire again {lines[9]}")
    if lines != CLUSTER_DEMO:
        fail(f"cluster demo lines {lines} != {CLUSTER_DEMO}")
    tts.batch_decide.launches = ma.window_reduce.launches = 0
    gpu, held_gpu = drive_cluster_engine(DEV, seed=8)
    launches, k3 = tts.batch_decide.launches, ma.window_reduce.launches
    log(f"  launches of token_decide on the stream: {launches}; of K3 (the server's flow_stats): {k3}")
    if launches <= 0 or k3 <= 0:
        fail("kernel token_decide or K3 was not launched on the embedded token service's path")
    results["token_decide"]["launches"] = launches
    results["window_sums"]["launches"] = k3
    cpu, held_cpu = cpu_result(cpu_jobs, "8")
    if gpu != cpu or held_gpu != held_cpu:
        fail("cluster engine verdicts or the server's view differ between the card and the CPU")
    seen = sorted({r[1] for r in gpu[:-1]})
    log(f"  {len(gpu) - 1} st.entry verdicts and the server's flow_stats identical on card and CPU; outcomes {seen}")
    if not {"pass", "FlowBlockError", "ParamFlowBlockError"} <= set(seen):
        fail(f"phase 8: the stream did not pass and block on flow and param rules: {seen}")


# ---------------------------------------------------------------------------
# the sharded step (parallel/ici.py): phases 2f, 3b, 4e and 9
# ---------------------------------------------------------------------------

D_MESH = 8  # shards of the mesh on the card


@contextlib.contextmanager
def plain_mesh_kernels():
    """plain_kernels, plus the sharded step's own kernels (K13-K16) and the
    kernels it calls by name swapped for their plain versions."""
    swaps = [
        (ici, "materialize_matured", nodes.materialize_matured_plain), (ici, "run_param", tpt.run_param_plain),
        (ici, "shaping_stage", tsh.shaping_stage_plain),
        (ici, "merge_stats_across", ici.merge_stats_across_plain), (ici, "merge_breaker", ici.merge_breaker_plain),
        (ici, "mesh_split_spend", ici.mesh_split_spend_plain),
        (ici, "mesh_shaping_charge", ici.mesh_shaping_charge_plain),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    with plain_kernels():
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        try:
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)


def shard_copies(base: nodes.StatsState, gen, now: int) -> nodes.StatsState:
    """D_MESH copies of ``base`` as shards leave them: on each shard 20% of
    the window cells added to in place, 5% rolled to the next window or
    the one after (shards differ), the thread gauges moved, 10% of the
    slab cells rolled to a later window."""
    copies = ici.replicate(base, D_MESH)
    for d in range(D_MESH):
        s = ici.shard_of(copies, d)
        for cfg, w in ((nodes.SECOND_CFG, s.second), (nodes.MINUTE_CFG, s.minute)):
            u = torch.rand(w.window_start.shape, generator=gen, device=DEV)
            add, roll = u < 0.2, (u >= 0.2) & (u < 0.25)
            w.counts.add_(torch.where(add[..., None], torch.randint(0, 3, w.counts.shape, generator=gen,
                                                                     device=DEV, dtype=I32), 0))
            w.window_start.copy_(torch.where(roll, now - now % cfg.window_len_ms + cfg.window_len_ms * (d % 2),
                                             w.window_start))
            w.counts.copy_(torch.where(roll[..., None], torch.randint(0, 9, w.counts.shape, generator=gen, device=DEV,
                                                                      dtype=I32), w.counts))
            w.min_rt.copy_(torch.where(add | roll, torch.randint(1, 4000, w.min_rt.shape, generator=gen, device=DEV,
                                                                 dtype=I32), w.min_rt))
            del u, add, roll
        s.threads.add_(torch.randint(-2, 3, s.threads.shape, generator=gen, device=DEV, dtype=I32))
        fr = torch.rand(s.future_ws.shape, generator=gen, device=DEV) < 0.1
        s.future_ws.copy_(torch.where(fr, now - now % 500 + 500 * (1 + d % 2), s.future_ws))
        s.future_pass.copy_(torch.where(fr, torch.randint(1, 5, fr.shape, generator=gen, device=DEV, dtype=I32),
                                        s.future_pass))
    return copies


def merge_bytes(base: nodes.StatsState, copies: nodes.StatsState) -> float:
    """K13's bytes on these inputs: every shard's and the base's window
    starts, the counts and min RT of the base and of the shards where they
    are on the merged window, the merged state written."""
    total = 0.0
    for o, w, e, has_min in ((base.second, copies.second, NUM_EVENTS, True),
                             (base.minute, copies.minute, NUM_EVENTS, True),
                             (ma.MetricArrayState(base.future_pass[..., None], None, base.future_ws),
                              ma.MetricArrayState(copies.future_pass[..., None], None, copies.future_ws), 1, False)):
        g = w.window_start.amax(0)
        cells = g.numel()
        used = int((o.window_start == g).sum()) + int((w.window_start == g).sum())
        total += (D_MESH + 1) * cells * 4 + used * (e + has_min) * 4 + cells * (e + 1 + has_min) * 4
    return total + (D_MESH + 2) * R * 4


def breaker_copies(dyn: tdt.DegradeDynState, gen, now: int) -> tdt.DegradeDynState:
    """D_MESH copies of a breaker state as shards leave them: 1% of the
    breakers in another state on each shard, 5% rolled to the next window
    with counts of their own, the rest with an exit or none added."""
    copies = ici.replicate(dyn, D_MESH)
    for d in range(D_MESH):
        s = ici.shard_of(copies, d)
        u = torch.rand(ND, generator=gen, device=DEV)
        s.state.copy_(torch.where(u < 0.01, torch.randint(0, 3, (ND,), generator=gen, device=DEV, dtype=I32),
                                  s.state))
        roll = (u >= 0.01) & (u < 0.06)
        s.ws.copy_(torch.where(roll, s.ws + 1000, s.ws))
        s.bad.copy_(torch.where(roll, torch.randint(0, 3, (ND,), generator=gen, device=DEV, dtype=I32),
                                s.bad + (u > 0.9).to(I32)))
        s.total.copy_(torch.where(roll, s.bad + 2, s.total + (u > 0.7).to(I32)))
        s.next_retry.copy_(torch.where(u < 0.01, now + 5000, s.next_retry))
    return copies


def origin_split(batch: flush.FlushBatch) -> flush.FlushBatch:
    """K = 2: each entry's second slot checks another rule on the same row
    (two rules sharing a check row, as an origin-split topology does)."""
    gid = torch.stack([batch.e_rule_gid[:, 0], (batch.e_rule_gid[:, 0] + 1) % R], 1).contiguous()
    return batch._replace(e_rule_gid=gid, e_check_row=torch.cat([batch.e_check_row] * 2, 1).contiguous())


def split_bytes(stats, batch, mask_src, grant: bool) -> float:
    """K15's bytes: per slot its gid, check row and mask, per entry its ts,
    acquire and flags, per touched row its window (or slab) and gauge, per
    touched rule its table row; the keep mask written."""
    n, k = batch.e_rule_gid.shape
    rows = torch.unique(batch.e_check_row.clamp(0, R - 1)).numel()
    rules = torch.unique(batch.e_rule_gid.clamp(0, R - 1)).numel()
    return n * k * 9 + n * (4 + 4 + 1 + 1) + rows * (20 if grant else 16) + rules * 12 + n


def phase2_mesh(results: dict) -> None:
    log(f"phase 2f: the sharded step's kernels against their plain versions: K13 (merge of {D_MESH} shards' stats "
        f"over {R:,} rows), K14 ({ND:,} breakers), K15 ({N:,} entries, {N // D_MESH:,} a shard; K=1, the mixed "
        f"K=2, an origin split), K16 ({S_SH:,} shaping items), K8 with probe_allowed")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(61)
    rng = np.random.default_rng(61)
    now = 4_000_137
    # K13: the rollover-aware merge
    base = make_stats(now, gen, matured_frac=0.2)
    copies = shard_copies(base, gen, now)
    want = ici.merge_stats_across_plain(clone(base), copies)
    got = ici.merge_stats_across(clone(base), copies)
    err = require_equal(want, got, "mesh_merge_stats")
    rolled = int((copies.second.window_start != base.second.window_start[None]).sum())
    del want, got
    torch.cuda.empty_cache()
    scratch = clone(base)
    results["mesh_merge_stats"].update(
        max_abs_err=err, ms=time_ms(lambda: ici.merge_stats_across(scratch, copies), iters=5),
        plain_ms=time_ms(lambda: ici.merge_stats_across_plain(scratch, copies), iters=1, warmup=1),
        bound=bound(merge_bytes(base, copies)), library_ms=None,
        shape=f"{D_MESH} shards x stats [{R},2|60,6] + slab + gauge ({rolled:,} second-window cells rolled)")
    del base, copies, scratch
    torch.cuda.empty_cache()
    # K14: the breaker merge
    ddev, dyn = make_breakers(now, gen)
    dcopies = breaker_copies(dyn, gen, now)
    want = ici.merge_breaker_plain(ddev, clone(dyn), dcopies, now)
    got = ici.merge_breaker(ddev, clone(dyn), dcopies, now)
    err = require_equal(want, got, "mesh_merge_breaker")
    moved = int((got.state != dyn.state).sum())
    scratch = clone(dyn)
    results["mesh_merge_breaker"].update(
        max_abs_err=err, ms=time_ms(lambda: ici.merge_breaker(ddev, scratch, dcopies, now)),
        plain_ms=time_ms(lambda: ici.merge_breaker_plain(ddev, scratch, dcopies, now), iters=3),
        bound=bound(ND * (20 * (D_MESH + 1) + 20 + 20)), library_ms=None,
        shape=f"{D_MESH} shards x {ND:,} breakers ({moved:,} changed state)")
    del dcopies, scratch, want, got
    # K8 with the probe election's mask
    stats = make_chain_stats(now, gen)
    batch = make_chain_batch(rng, now, skewed=False)
    e_live = batch.e_valid & batch.e_auth_ok
    allowed = torch.rand(ND, generator=gen, device=DEV) < 0.5
    want = tdt.breaker_try_pass_plain(ddev, dyn, batch.e_dgid, batch.e_ts, e_live, allowed)
    got = tdt.breaker_try_pass(ddev, dyn, batch.e_dgid, batch.e_ts, e_live, allowed)
    err = require_equal(want, got, "breaker_try_pass with probe_allowed")
    free = tdt.breaker_try_pass(ddev, dyn, batch.e_dgid, batch.e_ts, e_live)
    if not 0 < int(got[1].sum()) < int(free[1].sum()):
        fail("phase 2f: the probe_allowed mask did not hold back some probes")
    touched = torch.unique(batch.e_dgid[e_live[:, None].expand_as(batch.e_dgid)]).numel()
    results["breaker_try_pass_mask"].update(
        max_abs_err=err, ms=time_ms(lambda: tdt.breaker_try_pass(ddev, dyn, batch.e_dgid, batch.e_ts, e_live, allowed)),
        plain_ms=time_ms(lambda: tdt.breaker_try_pass_plain(ddev, dyn, batch.e_dgid, batch.e_ts, e_live, allowed)),
        bound=bound(N * (4 + 4 + 1 + 2) + touched * 9), library_ms=None,
        shape=f"N={N} entries x KD=1 against ND={ND} breakers, half of them allowed a probe")
    # A call at N, at the mesh engine's shard (32,768 entries over 8 shards:
    # 4,096 slots) and at 8 entries; the routes at the shard's size.
    btm = lambda n: lambda: tdt.breaker_try_pass(ddev, dyn, batch.e_dgid[:n], batch.e_ts[:n], e_live[:n], allowed)
    btm_plain = lambda n: lambda: tdt.breaker_try_pass_plain(ddev, dyn, batch.e_dgid[:n], batch.e_ts[:n], e_live[:n],
                                                             allowed)
    call_profile(results, "breaker_try_pass_mask", btm(N), btm(8), btm_plain(8), "phase 2f")
    shard = 32768 // D_MESH
    err = require_equal(btm_plain(shard)(), btm(shard)(), f"breaker_try_pass with probe_allowed at {shard}")
    s_launches, s_memsets, s_dev = profile(btm(shard), f"phase 2f: breaker_try_pass_mask at {shard}")
    results["breaker_try_pass_mask"].update(shard_ms=time_ms(btm(shard)), shard_launches_per_call=s_launches,
                                            shard_memsets_per_call=s_memsets, shard_device_ms=s_dev)
    log(f"    breaker_try_pass_mask at {shard} slots: {results['breaker_try_pass_mask']['shard_ms']:.4f} ms, "
        f"{s_launches} kernels, {s_memsets} memsets, {s_dev:.4f} ms of device time")
    route_times(results, "breaker_try_pass_mask", tdt, "TRY_PASS_SMALL_MAX", btm, btm_plain, (shard,), "phase 2f")
    del ddev, dyn, want, got, free
    # K15: the budget split, on Zipf traffic that overruns the grants
    table = make_table()
    zb = make_chain_batch(rng, now, skewed=True)
    live = zb.e_valid & zb.e_auth_ok & (torch.rand(N, generator=gen, device=DEV) < 0.95)
    occ = (zb.e_prio & (torch.rand(N, generator=gen, device=DEV) < 0.5))[:, None].contiguous()
    mx = make_mixed(rng, now)
    cases = {
        "zipf_grant": (stats, table, zb, True, dict(live=live)),
        "zipf_borrow": (stats, table, zb, False, dict(occ_slot=occ)),
        "origin_split_grant": (stats, table, origin_split(zb), True, dict(live=live)),
        "mixed_k2_grant": (stats, mx["table"], mx["batch"], True, dict(live=mx["batch"].e_valid)),
    }
    errs, demoted = 0, {}
    for tag, (s_, t_, b_, grant, kw) in cases.items():
        w = ici.mesh_split_spend_plain(D_MESH, s_, t_, b_, grant, **kw)
        g = ici.mesh_split_spend(D_MESH, s_, t_, b_, grant, **kw)
        errs = max(errs, require_equal(w, g, f"mesh_split_spend ({tag})"))
        demoted[tag] = int((~g).sum())
    if min(demoted[t] for t in ("zipf_grant", "zipf_borrow", "origin_split_grant")) == 0:
        fail(f"phase 2f: a budget case demoted nothing: {demoted}")
    # The wrap edge at full width: half the acquires 2^27-2^29 against counts
    # of 2^30-2^31, so the shards' units pass 2^31 (each shard's own prefix).
    big = torch.randint(2**27, 2**29, (N,), generator=gen, device=DEV, dtype=torch.int32)
    wb = zb._replace(e_acquire=torch.where(torch.rand(N, generator=gen, device=DEV) < 0.5, big, zb.e_acquire))
    wtable = table._replace(count=torch.empty_like(table.count).uniform_(2.0**30, 2.0**31 - 256, generator=gen))
    for tag, grant, kw in (("wrap_grant", True, dict(live=live)), ("wrap_borrow", False, dict(occ_slot=occ))):
        w = ici.mesh_split_spend_plain(D_MESH, stats, wtable, wb, grant, **kw)
        g = ici.mesh_split_spend(D_MESH, stats, wtable, wb, grant, **kw)
        errs = max(errs, require_equal(w, g, f"mesh_split_spend ({tag})"))
        demoted[tag] = int((~g).sum())
    if not 0 < demoted["wrap_grant"] < N:
        fail(f"phase 2f: the wrap-edge budget kept all or nothing: {demoted}")
    k_args = (D_MESH, stats, table, zb, True)
    grant_call = lambda: ici.mesh_split_spend(*k_args, live=live)
    borrow_call = lambda: ici.mesh_split_spend(D_MESH, stats, table, zb, False, occ_slot=occ)
    mixed_call = lambda: ici.mesh_split_spend(D_MESH, stats, mx["table"], mx["batch"], True, live=mx["batch"].e_valid)
    results["mesh_split_spend"].update(
        max_abs_err=errs, ms=time_ms(grant_call),
        plain_ms=time_ms(lambda: ici.mesh_split_spend_plain(*k_args, live=live), iters=3),
        bound=bound(split_bytes(stats, zb, live, True)), library_ms=None,
        borrow_ms=time_ms(borrow_call), mixed_k2_ms=time_ms(mixed_call),
        grant_then_borrow_ms=time_ms(lambda: (grant_call(), borrow_call())),
        shape=f"{D_MESH} shards x {N // D_MESH:,} Zipf entries x K=1, grant; demoted {demoted}")
    log(f"    mesh_split_spend, the grant then the borrow as the mesh step calls them: "
        f"{results['mesh_split_spend']['grant_then_borrow_ms']:.4f} ms a pair")
    for tag, fn in (("borrow", borrow_call), ("mixed_k2", mixed_call)):
        kern, mems, dev_ms = profile(fn, f"phase 2f: mesh_split_spend ({tag})")
        results["mesh_split_spend"].update(**{f"{tag}_launches_per_call": kern, f"{tag}_memsets_per_call": mems,
                                              f"{tag}_device_ms": dev_ms})
        log(f"    mesh_split_spend ({tag}): {kern} device kernels, {mems} memsets, {dev_ms:.4f} ms of device time")
    # Full width, 8 slots (one per shard) and the routes where they are chosen.
    split_at = lambda n, fn: lambda: fn(D_MESH, stats, table, sub_batch(zb, n), True, live=live[:n])
    call_profile(results, "mesh_split_spend", grant_call, split_at(8, ici.mesh_split_spend),
                 split_at(8, ici.mesh_split_spend_plain), "phase 2f")
    route_times(results, "mesh_split_spend", ici, "MESH_SPLIT_SMALL_MAX", lambda n: split_at(n, ici.mesh_split_spend),
                lambda n: split_at(n, ici.mesh_split_spend_plain), (512, 1024, 2048, 4096, 8192), "phase 2f")
    zero = cuda_build._SCRATCH.get((True, DEV, torch.cuda.current_stream(DEV).cuda_stream))
    if zero is None or int(zero.count_nonzero()) != 0:
        fail("phase 2f: K15 left the zeroed scratch dirty")
    del wb, wtable, big
    # K16: the global shaping charge, the mixed shape's items
    sb = mx["sb"]
    w = ici.mesh_shaping_charge_plain(stats.second, sb, now)
    g = ici.mesh_shaping_charge(stats.second, sb, now)
    err = require_equal(w, g, "mesh_shaping_charge")
    rows = torch.unique(sb.row).numel()
    results["mesh_shaping_charge"].update(
        max_abs_err=err, ms=time_ms(lambda: ici.mesh_shaping_charge(stats.second, sb, now)),
        plain_ms=time_ms(lambda: ici.mesh_shaping_charge_plain(stats.second, sb, now)),
        bound=bound(S_SH * (17 + 4) + rows * 16), library_ms=None,
        shape=f"S={S_SH} global shaping items over {rows:,} rate-limiter rows")
    charge_at = lambda n, fn, b=sb: lambda: fn(stats.second, tsh.ShapingBatch(*(t[:n] for t in b)), now)
    call_profile(results, "mesh_shaping_charge", charge_at(S_SH, ici.mesh_shaping_charge),
                 charge_at(8, ici.mesh_shaping_charge), charge_at(8, ici.mesh_shaping_charge_plain), "phase 2f")
    route_times(results, "mesh_shaping_charge", ici, "MESH_CHARGE_SMALL_MAX",
                lambda n: charge_at(n, ici.mesh_shaping_charge), lambda n: charge_at(n, ici.mesh_shaping_charge_plain),
                (512, 1024, 2048, 4096, 8192), "phase 2f")
    edges, cases = {}, charge_edges(sb, gen)
    for tag, e in cases.items():
        for n in (1024, 1025, S_SH):
            edges[f"{tag} at {n}"] = require_equal(charge_at(n, ici.mesh_shaping_charge_plain, e)(),
                                                   charge_at(n, ici.mesh_shaping_charge, e)(),
                                                   f"mesh_shaping_charge ({tag}, {n} items)")
    results["mesh_shaping_charge"]["edges"] = sorted(edges)
    log(f"    mesh_shaping_charge equal to its plain version on the default route at 1,024, 1,025 and {S_SH:,} "
        f"items: {', '.join(cases)}")
    del cases
    for name in ("mesh_merge_stats", "mesh_merge_breaker", "breaker_try_pass_mask", "mesh_split_spend",
                 "mesh_shaping_charge"):
        r = results[name]
        log(f"    {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, equal ({r['shape']})")
    del stats, batch, zb, mx, table
    torch.cuda.empty_cache()


def charge_edges(sb: tsh.ShapingBatch, gen) -> dict:
    """K16's edges on the mixed shape's items: every item invalid, every
    item on one row, one ts for all, ts below 0 for half of them, and
    acquires of 2^29-2^30, so that a row's charge passes 2^31."""
    n = sb.valid.numel()
    half = torch.rand(n, generator=gen, device=DEV) < 0.5
    return {
        "all_invalid": sb._replace(valid=torch.zeros_like(sb.valid)),
        "one_row": sb._replace(row=torch.full_like(sb.row, int(sb.row[0]))),
        "ts_ties": sb._replace(ts=torch.full_like(sb.ts, int(sb.ts[0]))),
        "negative_ts": sb._replace(ts=torch.where(half, sb.ts.long() - (2**31 - 1), sb.ts.long()).to(I32)),
        "past_2_31": sb._replace(acquire=torch.randint(2**29, 2**30, (n,), generator=gen, device=DEV, dtype=I32)),
    }


def phase3b() -> None:
    log(f"phase 3b: the sharded step ({D_MESH} shards) at R={R:,} rows, N={N:,} entries, through the kernels and "
        f"through the plain versions")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(63)
    rng = np.random.default_rng(63)
    now = 5_000_137
    mesh = make_mesh(D_MESH, DEV)
    table = make_table()
    base = make_chain_stats(now, gen)
    batch = make_chain_batch(rng, now, skewed=True)
    ddev, dyn = make_breakers(now, gen)
    step = ici.make_sharded_flush(mesh, 500)
    sysdev = sys_device("rt")
    pdyn = tpt.make_param_state(8, DEV)
    shapes = {"slot chain": dict(table=table, fdyn=None, ddev=ddev, dyn=dyn, pdyn=pdyn, sysdev=sysdev, batch=batch,
                                 step=step, extra=())}
    for label in ("slot chain", "mixed"):
        if label == "mixed":
            now += 400
            mx = make_mixed(rng, now)
            base = make_stats(now, gen)
            shapes["mixed"] = dict(
                table=mx["table"], fdyn=mx["dyn"], ddev=mx["ddev"], dyn=mx["ddyn"], pdyn=mx["pdyn"],
                sysdev=flush.make_system_device(None, -1.0, -1.0), batch=mx["batch"],
                step=ici.make_sharded_flush(mesh, 500, True, True, mx["sh_rounds"], mx["p_rounds"]),
                extra=(mx["sb"], mx["pb"]))
        c = shapes[label]

        def run(stats, fdyn, pdyn_):
            return c["step"](stats, c["table"], fdyn, c["ddev"], c["dyn"], pdyn_, c["sysdev"], c["batch"], *c["extra"])

        def fresh():
            return clone(base), None if c["fdyn"] is None else clone(c["fdyn"]), clone(c["pdyn"])

        kern = fresh()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out_k = run(*kern)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        plain = fresh()
        with plain_mesh_kernels():
            t0 = time.perf_counter()
            out_p = run(*plain)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        require_equal(out_p[4], out_k[4], f"sharded step results ({label})")
        for i, what in ((0, "stats"), (1, "pacer state"), (2, "breaker state"), (3, "param state")):
            if out_k[i] is not None:
                require_equal(out_p[i], out_k[i], f"sharded step {what} ({label})")
        res = out_k[4]
        del plain, out_p
        torch.cuda.empty_cache()
        k_ms, k_spread = step_times(lambda: run(*kern), repeats=3)
        log(f"  {label}: kernels {k_ms:.4f} ms/step {k_spread} (first step {first_ms:.1f} ms), plain route "
            f"{plain_ms:.1f} ms; results and every state tensor identical; peak device memory "
            f"{peak / 2**30:.2f} GiB; reasons {torch.bincount(res.reason, minlength=6).tolist()}, "
            f"{int(res.occupied.sum())} borrowed, {int((res.wait_ms > 0).sum())} waits")
        profile_step(lambda: run(*kern), f"sharded {label}", steps=2)
        del kern, out_k, res
        torch.cuda.empty_cache()


MESH_STEPS = 20  # 150 ms each: 3 simulated seconds
MESH_BULK = 31744
MESH_SINGLES = 1024


def drive_mesh_engine(device: torch.device, seed: int):
    """The engine in mesh mode (8 shards): 6,000 flow rules (QPS, one in
    eleven THREAD grade, one in thirteen a RATE_LIMITER), breakers on
    every third resource, hot-param rules on 200 resources (QPS with a hot
    item, throttles); per flush a Zipf submit_bulk stream of 31,744
    entries and 1,024 submit_many singles (prioritized ones on cold
    resources, four values a resource on 20 of the param resources), exits completing the
    breakers and releasing held entries. Returns (records, final state,
    seconds per flush call)."""
    clock = tclock.ManualClock(0)
    api.reset(clock=clock, device=device)
    eng = api.get_engine()
    eng.enable_mesh(D_MESH)
    st.flow_rule_manager.load_rules([
        st.FlowRule(f"r{i}", count=20 + i % 7 if i % 11 else 30, grade=C.FLOW_GRADE_THREAD if i % 11 == 5 else 1,
                    control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER if i % 13 == 7 else 0,
                    max_queueing_time_ms=400)
        for i in range(N_RULES)
    ])
    st.degrade_rule_manager.load_rules([
        st.DegradeRule(f"r{i}", grade=(i // 3) % 3, count=(100, 0.3, 20)[(i // 3) % 3], time_window=1,
                       slow_ratio_threshold=0.5, min_request_amount=5)
        for i in range(0, N_RULES, 3)
    ])
    hot = [st.ParamFlowItem(object="vip", count=50)]
    st.param_flow_rule_manager.load_rules(
        [st.ParamFlowRule(API(j), param_idx=0, count=3 + j % 4, param_flow_item_list=hot) for j in range(0, 200, 2)]
        + [st.ParamFlowRule(API(j), param_idx=0, count=5, max_queueing_time_ms=400,
                            control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER) for j in range(1, 200, 2)])
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, N_RULES + 1, dtype=np.float64) ** -1.1
    p = ranks / ranks.sum()
    users = ["vip", "u0", "u1", "u2"]
    records, prev_groups, held = [], [], []
    reasons = np.zeros(6, np.int64)
    flush_s = 0.0
    for step in range(MESH_STEPS):
        now = 1000 + step * 150
        clock.set_ms(now)
        res = np.sort(rng.choice(N_RULES - 1000, size=MESH_BULK, p=p[: N_RULES - 1000] / p[: N_RULES - 1000].sum()))
        ts = (now - rng.integers(0, 150, MESH_BULK)).astype(np.int32)
        uniq, start = np.unique(res, return_index=True)
        bounds = list(start) + [MESH_BULK]
        groups = [eng.submit_bulk(f"r{r}", int(bounds[i + 1] - bounds[i]), ts=np.sort(ts[bounds[i]:bounds[i + 1]]))
                  for i, r in enumerate(uniq)]
        reqs = []
        for j in range(MESH_SINGLES):
            kind = j % 4
            if kind == 0:
                reqs.append({"resource": API(int(rng.integers(0, 20))), "ts": now - int(rng.integers(0, 60)),
                             "args": (users[int(rng.integers(0, len(users)))],)})
            elif kind == 1:
                reqs.append({"resource": f"r{N_RULES - 8 + j % 8}", "ts": now - int(rng.integers(0, 50)),
                             "prio": True})
            else:
                reqs.append({"resource": f"r{int(rng.integers(0, N_RULES - 1000))}", "ts": now})
        singles = eng.submit_many(reqs)
        for g in prev_groups[:80]:
            if g.admitted_count:
                n_x = g.admitted_count
                eng.submit_exit_bulk(g.rows, n_x, rt=rng.integers(1, 250, n_x).astype(np.int32),
                                     err=(rng.random(n_x) < 0.3).astype(np.int32), ts=now, resource=g.resource)
        for op in held:
            eng.submit_exit(op.rows, rt=int(rng.integers(1, 100)), ts=now, resource=op.resource,
                            param_rows=op.param_thread_rows)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        flush_engine(eng)
        flush_s += time.perf_counter() - t0
        for g in groups:
            records += [g.admitted, g.reason, g.wait_ms]
            reasons += np.bincount(g.reason, minlength=6)[:6]
        records.append(np.array([_verdict_record(o.verdict) for o in singles], dtype=object))
        reasons += np.bincount([o.verdict.reason for o in singles], minlength=6)[:6]
        prev_groups = groups
        held = [o for o in singles if o.verdict.admitted and not o.verdict.wait_ms][:200]
    eng.flush()
    # Copies: on the CPU the numpy views would follow the check below.
    state = tmap(np.array, (nodes.stats_to_numpy(eng.stats), tdt.degrade_state_to_numpy(eng.degrade_dyn),
                            tpt.param_state_to_numpy(eng.param_dyn), tuple(t.cpu().numpy() for t in eng.flow_dyn)))
    # The conservation invariant: one rule of count 20, 128 entries of one
    # window over the shards admit exactly 20 (r1 has no breaker).
    eng.set_flow_rules([st.FlowRule("r1", count=20)])
    clock.set_ms(60_000)
    ops = eng.submit_many([{"resource": "r1", "ts": 60_000} for _ in range(128)])
    eng.flush()
    conserved = sum(o.verdict.admitted for o in ops)
    return records, state, flush_s / MESH_STEPS, conserved, reasons


def phase4_mesh(results: dict, cpu_jobs: dict) -> None:
    log(f"phase 4e: the engine in mesh mode ({D_MESH} shards) through the public API ({MESH_STEPS} flushes of "
        f"{MESH_BULK + MESH_SINGLES:,}: Zipf submit_bulk and submit_many over 6,000 rules with THREAD grade, "
        f"rate limiters, breakers, prioritized entries and hot-param rules)")
    counters = {
        "mesh_merge_stats": (ici.merge_stats_across, "launches"), "mesh_merge_breaker": (ici.merge_breaker, "launches"),
        "mesh_split_spend": (ici.mesh_split_spend, "launches"),
        "mesh_shaping_charge": (ici.mesh_shaping_charge, "launches"),
        "breaker_try_pass_mask": (tdt.breaker_try_pass, "mask_launches"),
        "breaker_on_exits": (tdt.breaker_on_exits, "launches"), "shaping_stage": (tsh.shaping_stage, "launches"),
        "run_param": (tpt.run_param, "launches"), "flow_admission_occupy": (flush.flow_admission, "occupy_launches"),
    }
    for w, attr in counters.values():
        setattr(w, attr, 0)
    gpu = drive_mesh_engine(DEV, seed=9)
    counts = {name: getattr(w, attr) for name, (w, attr) in counters.items()}
    log(f"  card: {gpu[2] * 1e3:.3f} ms per flush call (host encode and verdict copy included)")
    log(f"  launches on the mesh path: {counts}")
    for name, c in counts.items():
        if c <= 0:
            fail(f"kernel {name} was not launched on the mesh path")
    for name in ("mesh_merge_stats", "mesh_merge_breaker", "mesh_split_spend", "mesh_shaping_charge",
                 "breaker_try_pass_mask"):
        results[name]["launches"] = counts[name]
    if gpu[3] != 20:
        fail(f"phase 4e: 128 same-window entries against count 20 admitted {gpu[3]} on the mesh")
    cpu = cpu_result(cpu_jobs, "4e")
    log(f"  CPU engine with the same mesh (plain versions, in a worker process): {cpu[2] * 1e3:.3f} ms per flush call")
    if len(gpu[0]) != len(cpu[0]) or any(not np.array_equal(a, b) for a, b in zip(gpu[0], cpu[0])):
        fail("mesh engine verdicts, wait_ms or attribution differ between the card and the CPU")
    for what, a_state, b_state in (("stats", gpu[1][0], cpu[1][0]), ("breaker state", gpu[1][1], cpu[1][1]),
                                   ("param state", gpu[1][2], cpu[1][2])):
        for name in a_state._fields:
            a, b = getattr(a_state, name), getattr(b_state, name)
            for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
                if not np.array_equal(x, y):
                    fail(f"mesh engine {what} {name} differs between the card and the CPU")
    if any(not np.array_equal(x.view(np.int32), y.view(np.int32)) for x, y in zip(gpu[1][3], cpu[1][3])):
        fail("mesh engine shaping state differs between the card and the CPU")
    reasons = gpu[4]
    log(f"  verdicts, wait_ms, attribution, stats, breaker, param and shaping state identical on card and CPU; "
        f"reasons (pass, flow, degrade, system, authority, param) {reasons.tolist()}; 128 same-window entries "
        f"against count 20 admitted {gpu[3]}")
    if min(reasons[c] for c in (0, 1, 2, 5)) == 0:
        fail("phase 4e: the stream did not pass and block on flow, param and breaker rules")


def phase9() -> None:
    log("phase 9: examples/mesh_demo.py's sequence on the card (8 shards, 128 entries against count = 20)")
    api.reset(device=DEV)
    eng = api.get_engine()
    eng.enable_mesh(D_MESH)
    st.flow_rule_manager.load_rules([st.FlowRule("global-api", count=20)])
    now = eng.clock.now_ms()
    ops = eng.submit_many([{"resource": "global-api", "ts": now} for _ in range(128)])
    eng.flush()
    admitted = sum(op.verdict.admitted for op in ops)
    stats = eng.cluster_node_stats("global-api")
    log(f"  128 entries sharded over {D_MESH} shards against count=20:")
    log(f"    admitted {admitted} (exactly the global budget, not 8 x 20)")
    log(f"    minute totals: pass={stats['total_pass_minute']}  block={stats['total_block_minute']}")
    if (admitted, stats["total_pass_minute"], stats["total_block_minute"]) != (20, 20, 108):
        fail(f"phase 9: the mesh demo admitted {admitted} with minute totals {stats}")
    api.reset(device=DEV)


def _cpu_worker() -> None:
    """A worker of WORKERS: its helpers build their inputs on the CPU."""
    global DEV
    DEV = torch.device("cpu")
    torch.set_num_threads(2)


def start_cpu_jobs() -> dict:
    """Starts the CPU references of phases 2c (d), 4-4f and 8 (the port's
    plain versions, one round of a segmented recurrence at a time, and the
    CPU engines) in worker processes, longest first, so that they run while
    the build and the card's phases do; each is the same seeded computation the phase
    would run itself."""
    global WORKERS
    import multiprocessing

    WORKERS = multiprocessing.get_context("spawn").Pool(4, initializer=_cpu_worker)
    cpu = torch.device("cpu")
    return {
        "4c": WORKERS.apply_async(drive_shaping_engine, (cpu, 6)),
        "4e": WORKERS.apply_async(drive_mesh_engine, (cpu, 9)),
        "heavy param": WORKERS.apply_async(heavy_plain, ("param",)),
        "heavy shaping": WORKERS.apply_async(heavy_plain, ("shaping",)),
        "4": WORKERS.apply_async(drive_engine, (cpu, 4)),
        "4b": WORKERS.apply_async(drive_chain_engine, (cpu, 5)),
        "4d": WORKERS.apply_async(drive_sketch_engine, (cpu, 7)),
        "8": WORKERS.apply_async(drive_cluster_engine, (cpu, 8)),
        "4f": WORKERS.apply_async(drive_pipeline_engine, (cpu, 10, "sync")),
    }


def cpu_result(cpu_jobs: dict, name: str):
    """The result of a CPU job, logging how long the card's phase waited."""
    t0 = time.perf_counter()
    out = cpu_jobs[name].get()
    log(f"  (the CPU reference '{name}' came {time.perf_counter() - t0:.1f} s after it was asked for)")
    return out


def main() -> None:
    t_start = time.perf_counter()
    line = card_line()
    log(f"phase 1: {line}")
    cpu_jobs = start_cpu_jobs()
    t0 = time.perf_counter()
    cuda_build.build_all(["slab_sweep", "window_update", "window_reduce", "flow_admission", "system_check",
                          "breaker_on_exits",
                          "breaker_try_pass", "commit_borrow_slab", "shaping_scan", "param_scan", "sketch_fold",
                          "token_decide", "mesh_merge_breaker", "mesh_budget"])
    log(f"  CUDA kernels built in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")

    meta = {
        "materialize_matured": ("cuda", "sentinel_tpu_torch/csrc/slab_sweep.cu",
                                "sentinel_tpu/metrics/nodes.py:155"),
        "window_update": ("cuda", "sentinel_tpu_torch/csrc/window_update.cu",
                          "sentinel_tpu/metrics/metric_array.py:101"),
        "thread_gauge": ("cuda", "sentinel_tpu_torch/csrc/window_update.cu",
                         "sentinel_tpu/metrics/nodes.py:223"),
        "window_sums": ("cuda", "sentinel_tpu_torch/csrc/window_reduce.cu",
                        "sentinel_tpu/metrics/metric_array.py:205"),
        "row_stats": ("cuda", "sentinel_tpu_torch/csrc/window_reduce.cu", "sentinel_tpu/runtime/engine.py:4537"),
        "flow_admission": ("cuda", "sentinel_tpu_torch/csrc/flow_admission.cu",
                           "sentinel_tpu/runtime/flush.py:227"),
        "flow_admission_occupy": ("cuda", "sentinel_tpu_torch/csrc/flow_admission.cu",
                                  "sentinel_tpu/runtime/flush.py:338"),
        "commit_borrow_slab": ("cuda", "sentinel_tpu_torch/csrc/commit_borrow_slab.cu",
                               "sentinel_tpu/runtime/flush.py:434"),
        "system_check": ("cuda", "sentinel_tpu_torch/csrc/system_check.cu", "sentinel_tpu/runtime/flush.py:501"),
        "breaker_on_exits": ("cuda", "sentinel_tpu_torch/csrc/breaker_on_exits.cu",
                             "sentinel_tpu/rules/degrade_table.py:185"),
        "breaker_try_pass": ("cuda", "sentinel_tpu_torch/csrc/breaker_try_pass.cu",
                             "sentinel_tpu/rules/degrade_table.py:291"),
        "slot_chain_verdict": ("cuda", "sentinel_tpu_torch/csrc/flow_admission.cu",
                               "sentinel_tpu/rules/degrade_table.py:342"),
        "shaping_stage": ("cuda", "sentinel_tpu_torch/csrc/shaping_scan.cu", "sentinel_tpu/rules/shaping.py:152"),
        "run_param": ("cuda", "sentinel_tpu_torch/csrc/param_scan.cu", "sentinel_tpu/rules/param_table.py:242"),
        "sketch_fold": ("cuda", "sentinel_tpu_torch/csrc/sketch_fold.cu", "sentinel_tpu/runtime/sketch.py:191"),
        "token_decide": ("cuda", "sentinel_tpu_torch/csrc/token_decide.cu",
                         "sentinel_tpu/cluster/token_service.py:95"),
        "mesh_merge_stats": ("triton", "sentinel_tpu_torch/parallel/ici.py", "sentinel_tpu/parallel/ici.py:48"),
        "mesh_merge_breaker": ("cuda", "sentinel_tpu_torch/csrc/mesh_merge_breaker.cu",
                               "sentinel_tpu/parallel/ici.py:471"),
        "mesh_split_spend": ("cuda", "sentinel_tpu_torch/csrc/mesh_budget.cu", "sentinel_tpu/parallel/ici.py:127"),
        "mesh_shaping_charge": ("cuda", "sentinel_tpu_torch/csrc/mesh_budget.cu", "sentinel_tpu/parallel/ici.py:346"),
        "breaker_try_pass_mask": ("cuda", "sentinel_tpu_torch/csrc/breaker_try_pass.cu",
                                  "sentinel_tpu/rules/degrade_table.py:297"),
    }
    results = {name: {} for name in meta}
    took = {"1": round(time.perf_counter() - t_start, 1)}
    for name, run in (
        ("2", lambda: phase2(results)), ("2b", lambda: phase2_chain(results)), ("3", phase3),
        ("2c", lambda: phase2_shaping_param(results, cpu_jobs)),
        ("4", lambda: phase4(results, cpu_jobs)), ("4b", lambda: phase4_chain(results, cpu_jobs)),
        ("2d", lambda: phase2_sketch(results)), ("2e", lambda: phase2_token(results)),
        ("4c", lambda: phase4_shaping(results, cpu_jobs)), ("4d", lambda: phase4_sketch(results, cpu_jobs)),
        ("2f", lambda: phase2_mesh(results)), ("3b", phase3b), ("4e", lambda: phase4_mesh(results, cpu_jobs)),
        ("4f", lambda: phase4_pipeline(cpu_jobs)),
        ("5", phase5), ("6", phase6), ("7", phase7), ("8", lambda: phase8(results, cpu_jobs)), ("9", phase9),
    ):
        t0 = time.perf_counter()
        run()
        took[name] = round(time.perf_counter() - t0, 1)
    WORKERS.close()
    WORKERS.join()

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
        for extra in ("library_call", "zipf_ms", "zipf_plain_ms", "zipf_launches_per_call", "zipf_memsets_per_call",
                      "zipf_device_ms", "zipf_kernel_us", "heavy_ms", "index_add_ms", "widened_ms",
                      "ties_ms", "borrow_ms", "mixed_k2_ms", "grant_then_borrow_ms", "run_ms", "inputs_ms",
                      "borrow_launches_per_call", "borrow_memsets_per_call", "borrow_device_ms", "mixed_k2_launches_per_call",
                      "mixed_k2_memsets_per_call", "mixed_k2_device_ms", "launches_per_call", "memsets_per_call",
                      "device_ms",
                      "small_ms", "small_launches_per_call", "small_memsets_per_call", "small_device_ms",
                      "small_bound_ms", "ms_32768", "routes", "small_max", "shard_ms", "shard_launches_per_call",
                      "shard_memsets_per_call", "shard_device_ms", "kernel_us", "decay_ms",
                      "decay_launches_per_call", "decay_memsets_per_call", "decay_device_ms", "decay_kernel_us",
                      "widened_device_ms", "widened_kernel_us", "matured_ms", "matured_launches_per_call",
                      "matured_memsets_per_call", "matured_device_ms", "matured_cells", "read_ms", "small_plain_ms",
                      "edges"):
            if extra in r:
                entry[extra] = r[extra]
        kernels.append(entry)
    for k in kernels:
        log(f"  {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, bound {k['bound_ms']:.5f} "
            f"by {k['bound_by']}, library {k['library_ms']}), {k['launches']} launches on the main path")
    log(f"seconds per phase {took}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
