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

The failure domain and the speculative tier (runtime/failover.py,
runtime/speculative.py, runtime/durable.py): phase 4g runs phase 4's
stream (its entries through ``entry_sync``, each flush ``flush_async`` and
``drain``) with failover armed (a checkpoint every 8 flushes, each armed
dispatch under ``set_sync_debug_mode("error")``), then unarmed:
identical verdicts and state, the stats equal to phase 4's, 0 trips; the
flush call and host split of each, and the checkpoint copy's device and
host ms. Then one plan of faults (a failed wait at flush 12, a wait hung
past a 250 ms watchdog at 20, a failed launch at 28 and the next restore
failing; explicit recovery two flushes later) against the CPU engine: the
verdicts with their degraded marks, every health record, the injector's
fired list and the states after recovery identical; the device kernels of
each recovery (torch.profiler) and its K4 launches must not be 0. Then
phase 5's ``st.entry`` traffic on a manual clock with the speculative tier
on, against the CPU engine (immediate verdicts, the tier's counters, the
settled state), and ``st.entry`` latency under 8 threads with the tier on
and off; last a durable checkpoint spilled on the card and restored into a
fresh card engine and a CPU engine (states identical to each other and to
the spilled engine's, THREAD gauges zero). Every phase that injects no
fault asserts 0 trips. Its launches are not on the kernels line, which
counts phase 4's.

The control plane (runtime/window.py, runtime/ingest.py,
runtime/autotune.py, metrics/telemetry.py): phase 4h (a) joins 32 steps
of 4,096 requests (phase 4's rules, hot-param rules on every eighth
resource, Zipf values) in order into the 2 ms batch window (batch.max
4,096) on a ManualClock, K2, the gauge, K4 with the verdict tail and K10
counted from 0 around it, and holds every verdict, state tensor and
telemetry counter against the CPU engine's replay of the windows the card
formed; (b) sends 65,536 joins through the API's join against one pending
bulk flush at max.pending.bulk 16,384, then the deadline legs (the
estimate pinned, then live), against the CPU engine; (c) runs a mixed
stream (phase 4's traffic, param groups with four timestamps a flush)
with the autotuner on, its verdicts equal to an untuned CPU engine's,
K10's two routes each counted by torch.profiler (0 on either fails), its
depth decisions and cost memo printed, then the window controller's
decisions under 8 threads of api.entry_windowed; (d) runs phase 4's
stream with telemetry on, then off (the host splits, the blocked
sketch against the CPU's, spans_to_trace written to build/ and read
back, the DEFAULT dispatch under set_sync_debug_mode("error")); (e) times
api.entry_windowed against st.entry, 8 threads, 1 s each, in turns.

The multi-process ingest plane (ipc/): phase 4j spawns worker processes
from the plane's context (testing/ipc_procs.serve, no CUDA in them): (a)
four workers, 1,500 resources each, run 16 steps of 32,768 entries (Zipf
bulk groups of 64-2,048 rows split into frames, 8 hot-parameter singles
with args, a THREAD-grade group) and their completions through the plane
in lockstep, at depth 0 and at depth 2 with the speculative tier, against
the CPU engine fed each worker's steps in-process (verdicts, reasons,
wait_ms, stats reads, every state tensor), with the launch counters from
0 (K4 must run, K1 must not); (b) a fifth worker admits 64 on a
THREAD-grade rule and is killed: after worker.dead.ms the plane's
auto_exits read 64 and the gauge (row_stats) and the mirror 0; (c) on the
real clock, 1 s each: 1 then 4 workers looping bulk(res, 256), one caller
looping entry, 8 callers with the micro-window off and at 2 ms (requests/s,
round trips, drains/s, the drainer's host split, the frames coalesced),
in-process st.entry and entry_windowed; (d) every worker reports
torch.cuda.is_initialized() False and nvidia-smi lists no second context.

The capture journal (runtime/capture.py) and its replay (runtime/replay.py):
phase 4k (a) runs the slot chain's stream (6,000 rules, breakers on a third
of the resources, hot-param rules with a Zipf args column on every eighth,
as phase 4h (a)'s values, a flow reload before flush 20; 40 flushes of
32,768) on two engines on the card, the journal on one (a directory under
build/ whose segments hold the whole run) and off on the other, a flush
each a step in alternating turns: verdicts, reasons, wait_ms, attribution
and every state tensor identical; K2, K4, K7, K8 and K10 set to 0 before
the run and counted around each engine's steps (0 on the journal's engine
fails); the flush call's median, the host split, the journal's counters,
the bytes a flush and note_chunk's ms; (b) replays the capture through the
port's replay on the card at depths 0 and 2 and its first 3 chunks on the
CPU engine in a worker (the plain K10 walks the hottest value a round an
item): zero diffs, every row compared, rows/s; (c) one engine's shed
streak through the valve, a manual freeze and a DEGRADED transition
through the fault injector, each leaving frozen segments whose chunks
decode; (d) a journal's live segments left as a
killed process leaves them, renamed frozen-death-* by the next journal on
the directory, decoded and replayed on the card with zero diffs; no
process but this one holds a CUDA context.

The engine supervisor (ipc/supervise.py): phase 4l runs it on the card,
the engine in a supervised child process on named rings with a warm
standby (4j's 6,000 rules and its THREAD-grade and hot-parameter rules in
each engine child, loaded by testing/ipc_procs.launch_report_setup, which
reports each child's device and its K2, K4 and K10 launches to a file), 4
supervised workers (spawn_worker, no CUDA in them) and a probe client in
this process: the standby's sizing (nvidia-smi's memory of each process
while the primary and the standby live, the primary's drains/s under a 1 s
bulk(res, 256) loop beside 4j (c)'s, one re-warm); (a) 3 steps of 32,768
entries, then kill -9 of the primary under a bulk loop: a takeover
(restarts 0), every worker reconnected, the THREAD-grade verdicts after it
equal to a never-killed CPU engine fed the same requests (in a worker),
exactly 96 admitted after quiesce; (b) a planned handoff under continuous
probing: no policy-served and no refused probe; (c) the standby killed,
then the primary: a cold respawn on the backoff (restarts 1), the same
checks as (a). Every serving child must run on cuda:0 and launch K4; after
stop() only this process may hold a CUDA context and no segment may be
left in /dev/shm.

The control surface (transport/, core/slots.py, utils/registry.py,
datasource/, testing/oracle.py): phase 4m (after 4l) serves the card's
global engine from a CommandCenter on a loopback port. (a) Phase 4's
6,000 rules reach it through setRules over HTTP, which the writable
datasource persists into a file that a FileRefreshableDataSource then
drives (a reload of one rule in ten before flush 20); two slots come from
the registry (Registry.of("ProcessorSlot")): one vetoes bulk entries of
acquire 2 on every 16th resource and singles whose first arg is "unpaid",
one raises on r7 (the chain fails open); 40 Zipf(1.1) flushes of 32,768
(a quarter at acquire 2, 32 singles from three origins, the exits with
their resources) run in lockstep with a CPU engine: verdicts, reasons
(BLOCK_CUSTOM), slot names, vetoes, every state tensor and the slots'
calls and exits equal after every flush; K2, K4 and row_stats counted
from 0 around it. (b) After every tenth flush /metrics in both dialects,
/clusterNode, /tree and /origin over HTTP on the card's engine and then
on the CPU engine: the same bodies but the named host-timed lines and the
staging pool's counts; each scrape's ms and bytes, row_stats once a
scrape by its wrapper and by torch.profiler. (c) capture (a freeze on
demand), handoff, health with failover armed and one injected launch
fault (the degraded fill's verdicts equal the CPU engine's under the same
plan) and speculative (each entry's slot check once). (d) One heartbeat
of the card's engine and one of a CPU engine to an in-process dashboard:
the same fields. (e) testing/oracle_stream.py's 600 single entries on
QPS, rate-limiter and warm-up rules through an engine on the card: the
oracle's pass/block and waits.

The token plane over TCP (cluster/protocol.py, server.py, client.py,
shards.py, gossip.py): phase 8b (run after 4i) runs its servers as
threads of this process, their services on the card. It first counts
K12's launches by torch.profiler over ten 1,024-row frames through the
server's handler (none fails the phase) and times round trips of
request_tokens_batch at 8, 1,024 and 16,384 rows (p50, p99, frames/s,
decisions/s); then (a) examples/cluster_demo.py's
sequence through a SentinelTokenServer and a ClusterTokenClient on
loopback, equal to the same against a CPU server; (b) an engine in client
mode (set_to_client, submit_many) against a server holding phase 2e's
65,536 flows as cluster-mode QPS rules (a quarter AVG_LOCAL, in 16
namespaces) and a cluster-mode param rule on every 64th resource, five
windows of up to 16,384 Zipf(1.1) requests, leases off and then on, its
verdicts and the counters of server and client equal to a CPU engine's
against a CPU server (in a worker); (e) in the leases-on run the server
stopped and two more windows decided by the local check; (c) the
leases-off stream through a ShardedTokenClient over 4 servers: one
server's verdicts; (d) two engines with the sketch tier and gossip armed
merge each other's frames over loopback and promote a value hot only
fleet-wide, as two CPU engines do. K12, K2 and K4 are counted from 0
around (b), (e) and (c), K11 around (d). Phase 3 also times
``flush.apply_exit_phase`` alone on its exits-on step (device kernels,
device time, bound), and phase 3b prints the sharded step's bound (its
states, batch and result moved once) beside the bytes its shard copies
move.

Each phase logs ``phase <name>: start``; a phase that raises logs ``phase
<name> failed after <s> s: <exception>`` before the script exits non-zero.

The CPU sides of phases 2c (d), 4-4h, 4j, 4k, 4l, 8 and 8b (the plain versions on one
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
import gc
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


# Spawned children (the CPU references, phase 4j's workers) re-run this
# module's top level as __mp_main__: they must not touch CUDA.
if __name__ == "__main__" and not torch.cuda.is_available():
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
    from gpu_timing import (TD_B, TD_FLOWS, TD_NS, copies_per_call, device_profile, kernel_counts, kernel_times,
                            time_ms, time_ms_fresh, token_batch)
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


def exit_phase_bytes(stats: nodes.StatsState, batch: flush.FlushBatch) -> float:
    """Least bytes of ``flush.apply_exit_phase`` (exits on, no breakers) on
    these inputs: each exit's four rows, valid flag, count, RT, thread
    delta, error and ts read once; both windows' touched buckets as
    ``update_bytes`` counts them; each touched thread gauge read and
    written."""
    rows, ts, d, sample, thr4, mask = exit_updates(batch)
    touched = torch.unique(rows[mask & (thr4 != 0)]).numel()
    return (batch.x_valid.shape[0] * (16 + 1 + 4 * 5) + touched * 8
            + update_bytes(nodes.SECOND_CFG, stats.second, rows, ts, d, sample, mask, with_batch=False)
            + update_bytes(nodes.MINUTE_CFG, stats.minute, rows, ts, d, sample, mask, with_batch=False))


def tensor_bytes(x) -> int:
    """Bytes of every tensor in a (nested) tuple; anything else counts 0."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(tensor_bytes(v) for v in x)
    return 0


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
        if with_exits:
            # The exit phase alone (torch glue around K2's apply_updates).
            exit_phase = lambda: flush.apply_exit_phase(kern, batch, True)
            ex_ms = time_ms(exit_phase)
            ex_k, ex_m, ex_dev = profile(exit_phase, "phase 3: apply_exit_phase")
            ex_bound, ex_by = bound(exit_phase_bytes(kern, batch))
            log(f"  apply_exit_phase on this step ({M:,} exits, 4 rows each): {ex_ms:.4f} ms a call, {ex_k} device "
                f"kernels and {ex_m} memsets, {ex_dev:.4f} ms of device time; bound {ex_bound:.5f} ms by {ex_by}")
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


def drive_engine(device: torch.device, seed: int, mode: str = "sync", telemetry: bool = True, steps: int = STEPS,
                 before_flush=None):
    """One stream on one engine; returns (records, final state, blocked
    top-K, seconds per bulk flush, entries admitted, (the stats reads'
    launches of row_stats and of K3, the seconds of each read, the host
    split of each bulk flush with the call's ms and the ms of the garbage
    collections inside it (``call_ms``, ``gc_ms``, ``gc2_ms``: those of
    generation 2), (the telemetry bus's blocked top-K, its span count,
    spans_to_trace of its spans))). ``mode`` "depth2" runs the engine
    at pipeline depth 2, "async" flushes the bulk through flush_async; the
    verdict reads after each flush materialize it in both. ``telemetry``
    False turns the flight recorder off (phase 4h (d)). ``steps`` flushes;
    ``before_flush(step)`` runs before each (phase 4i (c)'s retunes)."""
    from sentinel_tpu_torch.metrics import spans_to_trace
    from sentinel_tpu_torch.utils.config import config

    clock = tclock.ManualClock(0)
    if telemetry:
        api.reset(clock=clock, device=device)
    else:
        _fresh_engine(device, {config.TELEMETRY_ENABLED: "false"}, clock)
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
    gct = GcTimer()
    gc.callbacks.append(gct)
    for step in range(steps):
        now = 1000 + step * 100
        clock.set_ms(now)
        if before_flush is not None:
            before_flush(step)
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
        gct.start()
        t0 = time.perf_counter()
        eng.flush_async() if mode == "async" else eng.flush()
        call_s = time.perf_counter() - t0
        gct.on = False
        flush_s += call_s
        splits.append(dict(eng.last_flush_host_ms, call_ms=call_s * 1e3, gc_ms=sum(gct.ms), gc2_ms=gct.ms[2]))
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
    gc.callbacks.remove(gct)
    eng.flush()
    eng.drain()
    final = nodes.stats_to_numpy(eng.stats)
    blk = eng.last_blocked_topk
    spans = eng.telemetry.spans()
    recorder = (eng.telemetry.blocked_sketch.topk(64), len(spans), spans_to_trace(spans))
    return records, final, blk, flush_s / steps, admitted, (read_launches, read_k3, read_s, splits, recorder)


class GcTimer:
    """A ``gc.callbacks`` entry: the ms of the collections of each
    generation that run while ``on``, since :meth:`start`."""

    def __init__(self) -> None:
        self.on, self.ms, self._t0 = False, [0.0, 0.0, 0.0], 0.0

    def start(self) -> None:
        self.on, self.ms = True, [0.0, 0.0, 0.0]

    def __call__(self, phase: str, info: dict) -> None:
        if not self.on:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms[info["generation"]] += (time.perf_counter() - self._t0) * 1e3


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
    n_objects = len(gc.get_objects())
    for w in wrappers.values():
        w.launches = 0
    gpu_records, gpu_state, gpu_blk, gpu_flush_s, admitted, (read_launches, read_k3, read_s, splits, _) = drive_engine(
        DEV, seed=4)
    counts = {name: w.launches for name, w in wrappers.items()}
    log(f"  card: {gpu_flush_s * 1e3:.3f} ms per 32,768-entry flush call "
        f"({FLUSH_N / gpu_flush_s:,.0f} entries/s, host encode and verdict copy included)")
    log(f"  host split of a flush (Engine.last_flush_host_ms): {split_line(splits)}")
    calls = np.array([s["call_ms"] for s in splits])
    rest = calls - np.array([s["encode_ms"] + s["dispatch_ms"] + s["kernel_ms"] for s in splits])
    slow = np.argsort(calls)[::-1][:3].tolist()
    log(f"  flush calls: median {np.median(calls):.3f}, mean {calls.mean():.3f}, max {calls.max():.3f} ms; outside "
        f"the split (call - encode - dispatch - kernel) median {np.median(rest):.3f}, mean {rest.mean():.3f} ms; "
        f"garbage collections inside the calls {sum(s['gc_ms'] for s in splits):.1f} ms in all, generation 2 "
        f"{sum(s['gc2_ms'] for s in splits):.1f} ms; {n_objects:,} objects tracked by the collector at the start; "
        "the slowest: " + "; ".join(f"flush {i} {calls[i]:.1f} ms (encode {splits[i]['encode_ms']:.1f}, kernel "
                                    f"{splits[i]['kernel_ms']:.1f}, collections {splits[i]['gc_ms']:.1f})"
                                    for i in slow))
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


def drive_chain_engine(device: torch.device, seed: int, steps: int = CHAIN_STEPS, before_flush=None):
    """The slot chain's stream on one engine: 6,000 QPS rules, breakers on
    every third resource (RT, exception ratio and exception count in
    turn), system rules (QPS and average RT; the load sampler pinned),
    white lists on every seventh resource, inbound and outbound Zipf bulk
    traffic from three origins, 64 prioritized entries per flush on eight
    cold resources, st.entry calls (one prioritized) and exits that
    complete the breakers with 30% errors. Returns (records, final stats, breaker
    state, bulk verdicts compared). ``steps`` flushes; ``before_flush(step)``
    runs before each (phase 4i (c)'s retunes)."""
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
    for step in range(steps):
        now = 1000 + step * 100
        clock.set_ms(now)
        if before_flush is not None:
            before_flush(step)
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
    return records, stats, tdt.degrade_state_to_numpy(eng.degrade_dyn), flush_s / steps, reasons, waits


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

PIPE_STEPS = 12  # 100 ms each: 1.2 simulated seconds (30 before phase 4k, 20 before its 40 flushes in turns)
PIPE_LAG = 3  # exits complete the entries of three flushes back, which the depth-2 trim has already filled
PIPE_WINDOW = 6  # flushes under torch.profiler, from the sixth on


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
        recs, state, blk, flush_s, _, (_, _, _, splits, _) = drive_engine(DEV, 4, mode)
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
# phase 4g: the failure domain and the speculative tier on the card
# ---------------------------------------------------------------------------

FO_CKPT_EVERY = 8
FO_TIMEOUT_MS = 250  # the watchdog's bound on a wait in the fault plan
# The fault plan, by bulk flush of phase 4's stream: a failed wait, a hung
# wait (released after the watchdog's bound), a failed launch, and the next
# restore failing. Recovery is explicit, FO_RECOVER_AFTER flushes later.
FO_PLAN = {12: "fetch", 20: "hang", 28: "dispatch"}
FO_RECOVER_AFTER = 2
FO_TURNS = (True, False)  # (a): armed, then unarmed (armed, unarmed, unarmed, armed before phase 4k's 40 flushes)


def _failover_settings(armed: bool, **extra) -> dict:
    from sentinel_tpu_torch.utils.config import config

    out = {config.FAILOVER_ENABLED: "true" if armed else "false",
           config.FAILOVER_CHECKPOINT_EVERY: str(FO_CKPT_EVERY), config.FAILOVER_PROBE_FLUSHES: "2",
           config.FAILOVER_RETRY_MS: str(10**9), config.FAILOVER_FETCH_TIMEOUT_MS: "10000"}
    out.update({getattr(config, k): str(v) for k, v in extra.items()})
    return out


def _fresh_engine(device: torch.device, settings: dict, clock):
    from sentinel_tpu_torch.utils.config import config

    for key, value in settings.items():
        config.set(key, value)
    try:
        api.reset(clock=clock, device=device)
    finally:
        config.reset()
    return api.get_engine()


def _health_record(eng) -> str:
    snap = eng.failover.snapshot()
    events = [(e["now_ms"], e["from"], e["to"], e["reason"]) for e in snap["events"]]
    return json.dumps([snap["state"], snap["counters"], events], sort_keys=True)


def _states_of(eng) -> list:
    fd = eng.flow_dyn
    return [nodes.stats_to_numpy(eng.stats), tuple(t.cpu().numpy() for t in fd),
            tdt.degrade_state_to_numpy(eng.degrade_dyn), tpt.param_state_to_numpy(eng.param_dyn)]


def drive_failover_engine(device: torch.device, seed: int, armed: bool, plan: bool = False):
    """Phase 4's DEFAULT stream (6,000 rules, STEPS Zipf submit_bulk flushes
    of 32,768 with exits, three entries a step) with failover armed
    (a checkpoint every FO_CKPT_EVERY flushes) or not; with ``plan`` the
    fault plan FO_PLAN through the FaultInjector, recovered explicitly
    (the probe flushes' device kernels counted with torch.profiler on the
    card). The entries go through ``entry_sync`` so that their verdicts
    keep their degraded marks. Each flush is ``flush_async`` then
    ``drain``; on the card an armed dispatch (its checkpoint copies too)
    runs under set_sync_debug_mode("error"). Returns (records, health
    records, final states, ms per flush call, host splits, probe kernels
    per recovery, the injector's fired list)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from sentinel_tpu_torch.testing.faults import FaultInjector

    clock = tclock.ManualClock(0)
    eng = _fresh_engine(device, _failover_settings(armed), clock)
    st.flow_rule_manager.load_rules([st.FlowRule(f"r{i}", count=20) for i in range(N_RULES)])
    inj = FaultInjector().install(eng) if plan else None
    on_card = device.type == "cuda"
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, N_RULES + 1, dtype=np.float64) ** -1.1
    p = ranks / ranks.sum()
    records, health, call_ms, splits, probe_kernels = [], [], [], [], []
    prev_groups = []
    recover_at = None
    release = threading.Event()
    for step in range(STEPS):
        now = 1000 + step * 100
        clock.set_ms(now)
        if plan and recover_at == step:
            prof = torch_profile(activities=[ProfilerActivity.CUDA]) if on_card else contextlib.nullcontext()
            fa0 = flush.flow_admission.launches
            with prof:
                ok = eng.failover.try_recover()
                if on_card:
                    torch.cuda.synchronize()
            health.append(f"recover {step} {ok}")
            if on_card and ok:
                from torch.autograd import DeviceType

                probe_kernels.append((sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                                          and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()),
                                      flush.flow_admission.launches - fa0))
            recover_at = None if ok else step + 1
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
        for g in prev_groups[:50]:
            if g.admitted_count:
                eng.submit_exit_bulk(g.rows, g.admitted_count, rt=int(rng.integers(1, 300)), ts=now)
        kind = FO_PLAN.get(step) if plan else None
        if kind == "fetch":
            inj.fail_fetch(eng.flush_seq + 1)
        elif kind == "hang":
            eng.failover.fetch_timeout_ms = FO_TIMEOUT_MS
            inj.hang_fetch(eng.flush_seq + 1, seconds=30.0, until=release)
            inj.fail_fetch(eng.flush_seq + 1)
        elif kind == "dispatch":
            inj.fail_dispatch(eng.flush_seq + 1)
            inj.fail_restore()
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            if on_card and armed:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    eng.flush_async()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            else:
                eng.flush_async()
            eng.drain()
        finally:
            if kind == "hang":
                release.set()
                eng.failover.fetch_timeout_ms = 10000
        call_ms.append((time.perf_counter() - t0) * 1e3)
        splits.append(eng.last_flush_host_ms)
        if kind is not None:
            recover_at = step + FO_RECOVER_AFTER
        records.append(np.concatenate([g.admitted for g in groups]))
        records.append(np.concatenate([g.reason for g in groups]))
        prev_groups = groups
        health.append(_health_record(eng))
        for r in ("r0", "r1", "r7"):
            clock.set_ms(now + 50)
            op, v = eng.entry_sync(r)
            records.append(np.array([json.dumps([v.admitted, v.reason, v.wait_ms, v.degraded, v.speculative])]))
            if v.admitted:
                clock.set_ms(now + 60)
                eng.submit_exit(op.rows, rt=10, resource=r, speculative=v.speculative or v.degraded)
    eng.flush()
    eng.drain()
    health.append(_health_record(eng))
    out = (records, health, _states_of(eng), call_ms, splits, probe_kernels, list(inj.fired) if inj else [])
    if inj is not None:
        inj.clear()
    eng.close()
    return out


def checkpoint_copy_ms(eng, repeats: int = 5) -> tuple:
    """The failover checkpoint's copy of the engine's live states (the copy
    a checkpointing flush queues): device ms between CUDA events around the
    queued copies, and host ms of the queueing, medians over ``repeats``;
    and the bytes copied."""
    dev_ms, host_ms = [], []
    nbytes = 0
    for _ in range(repeats):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with eng._on_stream():
            t0 = time.perf_counter()
            e0.record()
            states = eng._queue_state_copies(eng.sketch.dev_state if eng.sketch.armed else None)
            e1.record()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        e1.synchronize()
        dev_ms.append(e0.elapsed_time(e1))
        from sentinel_tpu_torch.runtime.failover import tree_leaves

        nbytes = sum(a.nbytes for a in tree_leaves(states))
    return float(np.median(dev_ms)), float(np.median(host_ms)), nbytes


SPEC_SIM_MS = 3000  # phase 4g (c)'s simulated seconds of st.entry traffic
SPEC_GAP_MS = 2  # one st.entry every 2 ms of the manual clock (25 x the QPS of the rule)
SPEC_LATENCY_S = 1.0  # phase 4g (c): seconds of st.entry latency with the tier on, then off (2 before phase 4k)


def drive_spec_entries(device: torch.device, seed: int):
    """Phase 5's st.entry traffic (one QPS = 20 rule, "methodA") on a
    ManualClock, one caller, with the speculative tier on: an entry every
    SPEC_GAP_MS ms for SPEC_SIM_MS ms, each admitted one exiting 1-20 ms
    later, settlement by the tier's own cadence; then a flush and a drain.
    Returns (immediate verdicts, the tier's snapshot, final states)."""
    from sentinel_tpu_torch.utils.config import config

    clock = tclock.ManualClock(0)
    tclock.set_default_clock(clock)
    _fresh_engine(device, {config.SPECULATIVE_ENABLED: "true"}, clock)
    eng = api.get_engine()
    st.flow_rule_manager.load_rules([st.FlowRule("methodA", count=20)])
    rng = np.random.default_rng(seed)
    seen, live = [], []
    for t in range(1000, 1000 + SPEC_SIM_MS, SPEC_GAP_MS):
        clock.set_ms(t)
        for e, until in [x for x in live if x[1] <= t]:
            e.exit()
            live.remove((e, until))
        try:
            e = st.entry("methodA")
            seen.append((True, e.verdict.speculative, e.verdict.degraded))
            live.append((e, t + int(rng.integers(1, 20))))
        except st.FlowBlockError:
            seen.append((False,))
    for e, _ in live:
        e.exit()
    eng.flush()
    eng.drain()
    eng.flush()
    eng.drain()
    snap = eng.speculative.snapshot()
    out = (seen, json.dumps(snap, sort_keys=True), _states_of(eng), eng.failover.counters["trips"])
    tclock.set_default_clock(tclock.SystemClock())
    return out


def entry_latency(spec: bool, seconds: float = 2.0, threads: int = 8) -> tuple:
    """Phase 5's harness (8 threads, real clock, st.entry on a QPS = 20
    rule) with the speculative tier on or off: (p50, p99 ms, calls)."""
    from sentinel_tpu_torch.utils.config import config

    tclock.set_default_clock(tclock.SystemClock())
    _fresh_engine(DEV, {config.SPECULATIVE_ENABLED: "true" if spec else "false"}, None)
    st.flow_rule_manager.load_rules([st.FlowRule("methodA", count=20)])
    try:
        st.entry("methodA").exit()  # warm
    except st.FlowBlockError:
        pass
    time.sleep(1.1)
    lat, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def worker():
        try:
            while not stop.is_set():
                t_call = time.perf_counter()
                try:
                    with st.entry("methodA"):
                        decided = time.perf_counter()
                except st.FlowBlockError:
                    decided = time.perf_counter()
                with lock:
                    lat.append(decided - t_call)
                time.sleep(0.001)
        except Exception as exc:
            errors.append(exc)

    ts = [threading.Thread(target=worker, daemon=True) for _ in range(threads)]
    for t in ts:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in ts:
        t.join(timeout=30)
    if errors or any(t.is_alive() for t in ts):
        fail(f"phase 4g: an st.entry latency worker failed ({errors[:1]})")
    eng = api.get_engine()
    eng.flush()
    eng.drain()
    if eng.failover.counters["trips"]:
        fail("phase 4g: a trip in a run that injects no fault")
    lat.sort()
    n = len(lat)
    return lat[n // 2] * 1e3, lat[int(0.99 * n)] * 1e3, n


def _same_states(a, b, what: str) -> None:
    from sentinel_tpu_torch.runtime.failover import tree_leaves

    la, lb = tree_leaves(tuple(a)), tree_leaves(tuple(b))
    if len(la) != len(lb) or any(x.shape != y.shape or x.dtype != y.dtype or
                                 not np.array_equal(x.view(np.int32) if x.dtype == np.float32 else x,
                                                    y.view(np.int32) if y.dtype == np.float32 else y)
                                 for x, y in zip(la, lb)):
        fail(f"phase 4g: {what}: states differ")


def _same_records(a, b, what: str) -> None:
    if len(a) != len(b) or any(not np.array_equal(x, y) for x, y in zip(a, b)):
        fail(f"phase 4g: {what}: verdicts differ")


def phase4_failover(cpu_jobs: dict) -> None:
    line = card_line()
    log(f"phase 4g: the failure domain and the speculative tier on the card ({line})")
    # (a) No faults: armed and unarmed (FO_TURNS); identical to each other and
    # to phase 4's stream on the card (its entries through st.entry there).
    runs = {}
    for armed in FO_TURNS:
        out = drive_failover_engine(DEV, 4, armed)
        recs, health, states, call_ms, splits, _, _ = out
        if json.loads(health[-1])[1]["trips"] != 0:
            fail("phase 4g (a): a trip in a stream with no fault")
        if armed and json.loads(health[-1])[1]["checkpoints"] < STEPS // FO_CKPT_EVERY:
            fail("phase 4g (a): the armed stream took too few checkpoints")
        key = "armed" if armed else "unarmed"
        if key in runs:
            _same_records(recs, runs[key][0], f"(a) {key} run twice")
        runs.setdefault(key, (recs, states))
        log(f"  (a) {key}: a flush call (flush_async + drain) {float(np.median(call_ms[1:])):.3f} ms (median; "
            f"{min(call_ms[1:]):.3f}-{max(call_ms[1:]):.3f}); {split_line(splits[1:])}"
            + ("; each dispatch, its checkpoint copies included, under set_sync_debug_mode(\"error\")" if armed else ""))
    _same_records(runs["armed"][0], runs["unarmed"][0], "(a) armed vs unarmed")
    _same_states(runs["armed"][1], runs["unarmed"][1], "(a) armed vs unarmed")
    _same_states(runs["unarmed"][1][:1], [PHASE4_RESULT["card"][1]], "(a) vs phase 4's final stats")
    eng = api.get_engine()
    dev_ms, host_ms, nbytes = checkpoint_copy_ms(eng)
    log(f"  (a) verdicts and state identical armed and unarmed, and the stats equal to phase 4's; 0 trips; the "
        f"checkpoint copy of {nbytes / 2**20:.2f} MiB: {dev_ms:.4f} ms of device time, {host_ms:.4f} ms on the host "
        f"to queue (medians of 5; {nbytes / (dev_ms * 1e-3) / 1e9:.1f} GB/s)")
    # (b) One plan of faults, against the CPU engine in a worker.
    recs, health, states, call_ms, splits, probe_kernels, fired = drive_failover_engine(DEV, 4, True, plan=True)
    c_recs, c_health, c_states, _, _, _, c_fired = cpu_result(cpu_jobs, "4g")
    _same_records(recs, c_recs, "(b) the fault plan, card vs CPU")
    if health != c_health:
        diff = next(i for i, (x, y) in enumerate(zip(health, c_health)) if x != y)
        fail(f"phase 4g (b): health differs at record {diff}: card {health[diff]} CPU {c_health[diff]}")
    _same_states(states, c_states, "(b) after recovery, card vs CPU")
    if fired != c_fired:
        fail(f"phase 4g (b): the injector fired {fired} on the card, {c_fired} on the CPU")
    final = json.loads(health[-1])
    if final[0] != "HEALTHY" or final[1]["trips"] != len(FO_PLAN) or final[1]["fetch_timeouts"] != 1:
        fail(f"phase 4g (b): after the plan {final[0]} with counters {final[1]}")
    if len(probe_kernels) != len(FO_PLAN) or min(min(k) for k in probe_kernels) <= 0:
        fail(f"phase 4g (b): the probe flushes launched no kernel ({probe_kernels})")
    log(f"  (b) plan {FO_PLAN} (hang bounded at {FO_TIMEOUT_MS} ms, the next restore failing): verdicts with their "
        f"degraded marks, {len(health)} health records (transitions, counters), the injector's fired list "
        f"{fired} and every state tensor after recovery identical on card and CPU; final counters {final[1]}; "
        f"each recovery that succeeded (restore, {2} probe flushes, re-anchor): (device kernels by torch.profiler, "
        f"K4 launches) {probe_kernels}; flush calls with the plan {min(call_ms):.1f}-{max(call_ms):.1f} ms")
    # (c) The speculative tier: phase 5's st.entry traffic, deterministic.
    seen, snap, s_states, trips = drive_spec_entries(DEV, 11)
    c_seen, c_snap, c_s_states, _ = cpu_result(cpu_jobs, "4g spec")
    if seen != c_seen or snap != c_snap:
        fail("phase 4g (c): speculative verdicts or the tier's counters differ between card and CPU")
    _same_states(s_states, c_s_states, "(c) the settled state, card vs CPU")
    if trips:
        fail("phase 4g (c): a trip in a run that injects no fault")
    counters = json.loads(snap)["counters"]
    if counters["spec_admits"] <= 0 or counters["reconciled"] != len(seen):
        fail(f"phase 4g (c): the tier decided nothing or left ops unreconciled: {counters}")
    on50, on99, on_n = entry_latency(True, seconds=SPEC_LATENCY_S)
    off50, off99, off_n = entry_latency(False, seconds=SPEC_LATENCY_S)
    log(f"  (c) {len(seen)} st.entry calls: immediate verdicts, the tier's counters {counters} and the settled "
        f"state identical on card and CPU; st.entry latency, 8 threads, {SPEC_LATENCY_S:g} s: tier on p50 "
        f"{on50:.4f} ms, p99 "
        f"{on99:.4f} ms ({on_n} calls), tier off p50 {off50:.4f} ms, p99 {off99:.4f} ms ({off_n} calls) ({line})")
    # (d) Durable: spill on the card, restore into a fresh card engine and
    # into a CPU engine.
    phase4_durable(line)
    tclock.set_default_clock(tclock.SystemClock())
    api.reset(device=DEV)


def phase4_durable(line: str) -> None:
    from sentinel_tpu_torch.runtime import durable

    path = os.path.join(ROOT, "build", "chip_smoke_4g.ckpt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.unlink(path)
    settings = dict(_failover_settings(True, FAILOVER_CKPT_PATH=path, FAILOVER_CKPT_INTERVAL_MS=0))
    clock = tclock.ManualClock(0)
    a = _fresh_engine(DEV, settings, clock)
    st.flow_rule_manager.load_rules([st.FlowRule(f"r{i}", count=20) for i in range(N_RULES)])
    st.degrade_rule_manager.load_rules([st.DegradeRule(f"r{i}", grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, count=3,
                                                       time_window=5) for i in range(0, N_RULES, 3)])
    st.param_flow_rule_manager.load_rules([st.ParamFlowRule("r1", param_idx=0, count=5)])
    rng = np.random.default_rng(12)
    for step in range(FO_CKPT_EVERY):
        clock.set_ms(1000 + 100 * step)
        for r in rng.integers(0, N_RULES, 64):
            a.submit_bulk(f"r{r}", 32, ts=1000 + 100 * step)
        for v in ("a", "b", "a", "c"):
            a.submit_entry("r1", args=(v,))
        for r in rng.integers(0, 30, 8):
            a.submit_exit(a.resolve_entry_rows(f"r{r}", C.CONTEXT_DEFAULT_NAME, "", C.EntryType.OUT), rt=5, err=1,
                          resource=f"r{r}")
        a.flush()
    a.drain()
    fo = a.failover
    deadline = time.monotonic() + 60
    while not (fo.last_durable is not None and fo._ckpt is not None and fo.last_durable[1] == fo._ckpt.seq):
        if time.monotonic() > deadline or fo.counters["durable_write_errors"]:
            fail(f"phase 4g (d): the durable spill did not land ({fo.snapshot()['durable']})")
        time.sleep(0.01)
    spill_ms = fo.last_durable[2]
    spilled = _states_of(a)
    if a.failover.counters["trips"]:
        fail("phase 4g (d): a trip in a run that injects no fault")
    header, leaves = durable.read_checkpoint(path)
    size = os.path.getsize(path)
    a.close()
    restored = {}
    for where, dev in (("card", DEV), ("cpu", torch.device("cpu"))):
        b = _fresh_engine(dev, settings, tclock.ManualClock(0))
        b.failover.durable_path = ""  # restore only: this engine writes no file
        st.flow_rule_manager.load_rules([st.FlowRule(f"r{i}", count=20) for i in range(N_RULES)])
        st.degrade_rule_manager.load_rules([st.DegradeRule(f"r{i}", grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, count=3,
                                                           time_window=5) for i in range(0, N_RULES, 3)])
        st.param_flow_rule_manager.load_rules([st.ParamFlowRule("r1", param_idx=0, count=5)])
        t0 = time.perf_counter()
        if not b.failover.restore_durable(path):
            fail(f"phase 4g (d): the restore into the {where} engine failed ({b.failover.last_fault})")
        restored[where] = (_states_of(b), (time.perf_counter() - t0) * 1e3, b.failover.counters)
        b.close()
    _same_states(restored["card"][0], restored["cpu"][0], "(d) restored on the card vs on the CPU")
    # The spilled engine's states, with the THREAD gauges zero as a durable
    # restore installs them, are what both restored.
    from sentinel_tpu_torch.runtime.failover import tree_leaves, tree_unflatten

    n = restored["card"][0][0].threads.shape[0]
    if n < len(header["node_keys"]):
        fail(f"phase 4g (d): {n} restored stats rows for {len(header['node_keys'])} keys")
    spilled[0] = tree_unflatten(spilled[0], [a[:n] for a in tree_leaves(spilled[0])])
    spilled[0] = spilled[0]._replace(threads=np.zeros_like(spilled[0].threads))
    spilled[3] = spilled[3]._replace(threads=np.zeros_like(spilled[3].threads))
    _same_states(restored["card"][0], spilled, "(d) restored vs spilled")
    log(f"  (d) durable: {size / 2**20:.2f} MiB, {header['n_leaves']} leaves, components {header['components']}, "
        f"spilled in {spill_ms:.1f} ms (the writer thread); restored into a fresh card engine in {restored['card'][1]:.1f} ms and "
        f"into a CPU engine in {restored['cpu'][1]:.1f} ms: states identical to each other and to the spilled "
        f"engine's (THREAD gauges zero) ({line})")
    os.unlink(path)


# ---------------------------------------------------------------------------
# phase 4h: the control plane (the batch window, the ingest valve, the
# autotuner and the flight recorder) on the card
# ---------------------------------------------------------------------------

CP_WINDOWS = 32  # (a): steps of CP_BATCH requests, each joined in order into the 2 ms window
CP_BATCH = 4096
CP_BURST = 65536  # (b): joins against one pending bulk flush
CP_BULK_BOUND = 16384  # (b): sentinel.tpu.ingest.max.pending.bulk
CP_PENDING = 4096  # (b): the pending bulk flush's rows
CP_DEADLINE = 4096  # (b): joins of each deadline leg
CP_STEPS = 20  # (c): flushes of FLUSH_N on the mixed stream
CP_LATENCY_S = 1.0  # (e): seconds of each turn (2 before phase 4k)
# (d): phase 4's stream with telemetry on, then off, this many times each (5 before phase 4j, 3 before phase
# 4k, 2 before its 40 flushes in turns)
CP_TURNS = 1
CP_PARAM_TS = 4  # (c): distinct timestamps of the param items a flush (K10's closed form stays eligible)


def _cp_rules(with_param: bool = True) -> None:
    """Phase 4's 6,000 DEFAULT QPS rules; with ``with_param`` a hot-param rule
    (count 5 a value) on every eighth resource."""
    st.flow_rule_manager.load_rules([st.FlowRule(f"r{i}", count=20) for i in range(N_RULES)])
    if with_param:
        st.param_flow_rule_manager.load_rules([st.ParamFlowRule(f"r{i}", param_idx=0, count=5)
                                               for i in range(0, N_RULES, 8)])


def _cp_requests(rng, p, now: int, n: int) -> list:
    """``n`` requests (resource, ts, args): Zipf(1.1) resources, a Zipf value
    for the param resources (every eighth)."""
    res = rng.choice(N_RULES, size=n, p=p)
    ts = (now - rng.integers(0, 100, n)).astype(np.int64)
    vals = np.minimum(rng.zipf(1.1, n), 4096)
    return [(f"r{r}", int(t), (f"v{v}",) if r % 8 == 0 else ()) for r, t, v in zip(res.tolist(), ts.tolist(),
                                                                                    vals.tolist())]


def _zipf_p() -> np.ndarray:
    ranks = np.arange(1, N_RULES + 1, dtype=np.float64) ** -1.1
    return ranks / ranks.sum()


def _tele_counters(eng) -> dict:
    """The telemetry bus's counters but the arena's (they follow the staging
    layout, not the stream)."""
    c = eng.telemetry.counters_snapshot()
    c.pop("arena_hits")
    c.pop("arena_misses")
    return c


def _cp_state(eng) -> list:
    return _states_of(eng) + [_tele_counters(eng)]


def drive_window_spine(device: torch.device, seed: int):
    """(a) on the card: CP_WINDOWS steps of CP_BATCH requests, each step's
    requests joined in order into the batch window (2 ms, batch.max 4,096)
    and waited for, on a ManualClock. The windows the flusher formed are
    recorded (each with the clock at its dispatch), so that the CPU engine
    can replay the same split. Returns (verdicts, the split, final states,
    host splits, seconds)."""
    from sentinel_tpu_torch.runtime.window import WindowRequest
    from sentinel_tpu_torch.utils.config import config

    clock = tclock.ManualClock(0)
    eng = _fresh_engine(device, {config.INGEST_BATCH_WINDOW_MS: "2", config.INGEST_BATCH_MAX: str(CP_BATCH)}, clock)
    _cp_rules()
    w = eng.ingest_window
    split, host = [], []
    dispatch = w._dispatch_window

    def recording(win):
        split.append((eng.clock.now_ms(), [(r.resource, r.ts, r.args) for r in win.reqs]))
        out = dispatch(win)
        host.append(eng.last_flush_host_ms)
        return out

    w._dispatch_window = recording
    rng = np.random.default_rng(seed)
    p = _zipf_p()
    verdicts = []
    t0 = time.perf_counter()
    for step in range(CP_WINDOWS):
        now = 1000 + step * 100
        clock.set_ms(now)
        reqs = [WindowRequest(res, C.CONTEXT_DEFAULT_NAME, "", 1, C.EntryType.OUT, args, ts, None)
                for res, ts, args in _cp_requests(rng, p, now, CP_BATCH)]
        for r in reqs:
            w.join(r)
        for r in reqs:
            if not r.event.wait(120) or r.error is not None or r.verdict is None:
                fail(f"phase 4h (a): a windowed request was not decided ({r.error!r})")
            verdicts.append((r.verdict.admitted, r.verdict.reason, r.verdict.wait_ms))
    seconds = time.perf_counter() - t0
    eng.close()
    del w._dispatch_window
    return verdicts, split, _cp_state(eng), host, seconds


def replay_window_spine(device: torch.device, split: list):
    """(a)'s CPU reference: the windows the card formed, each dispatched and
    fanned out in order through the same BatchWindow methods at the same
    clock. Returns (verdicts, final states)."""
    from sentinel_tpu_torch.runtime.window import WindowRequest, _OpenWindow
    from sentinel_tpu_torch.utils.config import config

    clock = tclock.ManualClock(0)
    eng = _fresh_engine(device, {config.INGEST_BATCH_WINDOW_MS: "2", config.INGEST_BATCH_MAX: str(CP_BATCH)}, clock)
    _cp_rules()
    w = eng.ingest_window
    verdicts = []
    for now, reqs in split:
        clock.set_ms(now)
        win = _OpenWindow(deadline=0.0)
        for res, ts, args in reqs:
            r = WindowRequest(res, C.CONTEXT_DEFAULT_NAME, "", 1, C.EntryType.OUT, args, ts, None)
            r.event = win.event
            win.reqs.append(r)
        w.pending_n += len(win.reqs)
        w.counters["reqs"] += len(win.reqs)
        w._fan_out_window(win, w._dispatch_window(win))
        verdicts += [(r.verdict.admitted, r.verdict.reason, r.verdict.wait_ms) for r in win.reqs]
    eng.close()
    return verdicts, _cp_state(eng)


def drive_valve(device: torch.device, seed: int):
    """(b): the window held open (60 s, batch.max above the burst), one bulk
    flush of CP_PENDING rows pending, then CP_BURST joins through the API's
    join (the valve at max.pending.bulk = CP_BULK_BOUND sheds every join past
    the bound); close() serves the window with the pending group. Then the
    deadline legs (deadline 10 s): CP_DEADLINE joins with the settle estimate
    pinned at 20 s (all shed), CP_DEADLINE unpinned (the live EWMA the
    fetches fed). Returns (per-request outcomes, valve snapshot counters,
    the pending group's verdicts, final states, the live EWMA)."""
    from sentinel_tpu_torch.core.context import ContextUtil
    from sentinel_tpu_torch.utils.config import config

    clock = tclock.ManualClock(0)
    eng = _fresh_engine(device, {config.INGEST_BATCH_WINDOW_MS: "60000", config.INGEST_BATCH_MAX: str(2 * CP_BURST),
                                 config.INGEST_MAX_PENDING_BULK: str(CP_BULK_BOUND),
                                 config.INGEST_DEADLINE_MS: "10000"}, clock)
    _cp_rules()
    rng = np.random.default_rng(seed)
    p = _zipf_p()
    clock.set_ms(1000)
    pending = eng.submit_bulk("r1", CP_PENDING, ts=1000)
    outcomes = []

    def leg(n: int, now: int, tag: str) -> None:
        clock.set_ms(now)
        joined = []
        for res, _ts, args in _cp_requests(rng, p, now, n):
            try:
                req, _ = api._window_join(eng, res, C.EntryType.OUT, 1, None, args)
            except st.BlockError as exc:
                outcomes.append(("shed", type(exc).__name__, tag))
                continue
            eng.ingest_window.join(req)
            joined.append(req)
            outcomes.append(req)
        eng.ingest_window.close()
        for r in joined:
            if not r.event.wait(120) or r.error is not None:
                fail(f"phase 4h (b): a joined request was not decided ({r.error!r})")

    leg(CP_BURST, 1000, "burst")
    eng.ingest.force_latency_ms(20000.0)
    leg(CP_DEADLINE, 1500, "pinned")
    eng.ingest.force_latency_ms(None)
    leg(CP_DEADLINE, 2000, "unpinned")
    ContextUtil.replace_context(None)
    out = [o if isinstance(o, tuple) else ("joined", o.verdict.admitted, o.verdict.reason) for o in outcomes]
    snap = eng.ingest.snapshot()
    return (out, snap["counters"], (pending.admitted, pending.reason), _cp_state(eng), snap["settle_ewma_ms"])


def drive_tuned_engine(device: torch.device, seed: int, tuned: bool):
    """(c): the mixed stream (phase 4's bulk traffic and exits, and the param
    resources' groups with args and CP_PARAM_TS timestamps a flush) for
    CP_STEPS flushes, with the autotuner on (a tick every second flush:
    interval 200 ms of the clock, cooldown 1 ms, 2 samples, 2 explorations
    a route, depth up to 2) or off. Returns
    (records, final states, decisions, memo, K10 picks by route, host
    splits)."""
    from sentinel_tpu_torch.utils.config import config

    clock = tclock.ManualClock(0)
    eng = _fresh_engine(device, {config.AUTOTUNE_ENABLED: "true" if tuned else "false",
                                 config.AUTOTUNE_INTERVAL_MS: "200", config.AUTOTUNE_COOLDOWN_MS: "1",
                                 config.AUTOTUNE_MIN_FLUSHES: "2", config.AUTOTUNE_PARAM_EXPLORE: "2",
                                 config.AUTOTUNE_DEPTH_MAX: "2"}, clock)
    _cp_rules()
    rng = np.random.default_rng(seed)
    p = _zipf_p()
    records, splits, prev_groups = [], [], []
    for step in range(CP_STEPS):
        now = 1000 + step * 100
        clock.set_ms(now)
        res = np.sort(rng.choice(N_RULES, size=FLUSH_N, p=p), kind="stable")
        uniq, start = np.unique(res, return_index=True)
        bounds = list(start) + [FLUSH_N]
        groups = []
        for i, r in enumerate(uniq.tolist()):
            n = int(bounds[i + 1] - bounds[i])
            if r % 8 == 0:
                ts = (now - 25 * rng.integers(0, CP_PARAM_TS, n)).astype(np.int32)
                vals = np.minimum(rng.zipf(1.1, n), 4096).tolist()
                groups.append(eng.submit_bulk(f"r{r}", n, ts=np.sort(ts), args_column=[(f"v{v}",) for v in vals]))
            else:
                groups.append(eng.submit_bulk(f"r{r}", n, ts=np.sort((now - rng.integers(0, 100, n)).astype(np.int32))))
        for g in prev_groups[:50]:
            if g.admitted_count:
                eng.submit_exit_bulk(g.rows, g.admitted_count, rt=int(rng.integers(1, 300)), ts=now)
        eng.flush()
        splits.append(eng.last_flush_host_ms)
        for g in groups:
            records += [g.admitted, g.reason, g.wait_ms]
        prev_groups = groups
    eng.flush()
    eng.drain()
    c = eng.telemetry.counters_snapshot()
    at = eng.autotune
    out = (records, _states_of(eng), list(at.decisions), at.memo.snapshot(),
           (c["param_closed_form"], c["param_scan"]), splits)
    eng.close()
    return out


def windowed_latency(windowed: bool, seconds: float = 2.0, threads: int = 8, tuned: bool = False) -> tuple:
    """(e): phase 5's harness (``threads`` callers, real clock, a QPS = 20
    rule) through ``api.entry_windowed`` (window 2 ms, batch.max the thread
    count) or ``st.entry``: (requests/s, p50 ms, p99 ms, calls, the
    autotuner's decisions). ``tuned``: the autotuner on (a tick every
    100 ms, cooldown 200 ms), for (c)'s window controller."""
    from sentinel_tpu_torch.utils.config import config

    tclock.set_default_clock(tclock.SystemClock())
    settings = {config.INGEST_BATCH_WINDOW_MS: "2", config.INGEST_BATCH_MAX: str(threads)} if windowed else {}
    if tuned:
        settings.update({config.AUTOTUNE_ENABLED: "true", config.AUTOTUNE_INTERVAL_MS: "100",
                         config.AUTOTUNE_COOLDOWN_MS: "200"})
    eng = _fresh_engine(DEV, settings, None)
    st.flow_rule_manager.load_rules([st.FlowRule("methodA", count=20)])
    call = api.entry_windowed if windowed else st.entry
    try:
        call("methodA").exit()  # warm
    except st.FlowBlockError:
        pass
    time.sleep(1.1)
    lat, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def worker():
        try:
            while not stop.is_set():
                t_call = time.perf_counter()
                try:
                    with call("methodA"):
                        decided = time.perf_counter()
                except st.FlowBlockError:
                    decided = time.perf_counter()
                with lock:
                    lat.append(decided - t_call)
        except Exception as exc:
            errors.append(exc)

    ts = [threading.Thread(target=worker, daemon=True) for _ in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in ts:
        t.join(timeout=30)
    took = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in ts):
        fail(f"phase 4h (e): a latency worker failed ({errors[:1]})")
    eng.close()
    if windowed and eng.ingest_window.snapshot()["flushes"] <= 0:
        fail("phase 4h (e): the windowed calls flushed no window")
    lat.sort()
    n = len(lat)
    return n / took, lat[n // 2] * 1e3, lat[int(0.99 * n)] * 1e3, n, list(eng.autotune.decisions)


def _same(a, b, what: str) -> None:
    if len(a) != len(b) or any(not np.array_equal(x, y) if isinstance(x, np.ndarray) else x != y
                               for x, y in zip(a, b)):
        fail(f"phase 4h: {what}: card and CPU differ")


def _same_cp_states(a, b, what: str) -> None:
    _same_states(a[:4], b[:4], what)
    if a[4] != b[4]:
        diff = {k: (a[4][k], b[4][k]) for k in a[4] if a[4][k] != b[4].get(k)}
        fail(f"phase 4h: {what}: telemetry counters differ {diff}")


def phase4_control(results: dict, cpu_jobs: dict) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    line = card_line()
    log(f"phase 4h: the control plane on the card: the batch window, the ingest valve, the autotuner and the flight "
        f"recorder (6,000 rules, hot-param rules on every eighth resource; {line})")
    # (a) The window spine: 32 x 4,096 requests, the kernels' launches counted
    # from 0 around it.
    wrappers = {"window_update": ma.update, "thread_gauge": nodes.thread_gauge_add,
                "flow_admission": flush.flow_admission, "run_param": tpt.run_param}
    for wr in wrappers.values():
        wr.launches = 0
    verdicts, split, state, host, seconds = drive_window_spine(DEV, 14)
    counts = {name: wr.launches for name, wr in wrappers.items()}
    for name, c in counts.items():
        if c <= 0:
            fail(f"phase 4h (a): kernel {name} was not launched on the window's path")
        results[name]["launches_4h"] = c
    replay = WORKERS.apply_async(replay_window_spine, (torch.device("cpu"), split))
    n_windows = len(split)
    flushes = state[4]["flushes"]
    log(f"  (a) {len(verdicts):,} requests in {CP_WINDOWS} steps of {CP_BATCH:,} joined into the 2 ms window "
        f"(batch.max {CP_BATCH:,}): {n_windows} windows, {flushes} flushes, {seconds:.2f} s "
        f"({len(verdicts) / seconds:,.0f} requests/s from one joining thread); launches {counts}; host split of a "
        f"window's flush: {split_line(host)} ({line})")
    # (b) The valve against its CPU reference.
    out, valve, pend, v_state, ewma = drive_valve(DEV, 15)
    c_out, c_valve, c_pend, c_v_state, _ = cpu_result(cpu_jobs, "4h b")
    _same(out, c_out, "(b) the burst's outcomes")
    _same(list(pend), list(c_pend), "(b) the pending bulk group")
    if valve != c_valve:
        fail(f"phase 4h (b): valve counters differ: card {valve} CPU {c_valve}")
    _same_cp_states(v_state, c_v_state, "(b) the valve's states")
    shed_q = sum(1 for o in out if o[0] == "shed" and o[2] == "burst")
    shed_d = sum(1 for o in out if o[0] == "shed" and o[2] == "pinned")
    if (shed_q != CP_BURST - (CP_BULK_BOUND - CP_PENDING) or shed_d != CP_DEADLINE
            or (valve["shed_queue"], valve["shed_deadline"], valve["shed_rows"]) != (shed_q, shed_d, shed_q + shed_d)
            or any(o[0] == "shed" and o[1] != "IngestShedError" for o in out)):
        fail(f"phase 4h (b): {shed_q} sheds in the burst and {shed_d} pinned, counters {valve}")
    if not ewma > 0.0:
        fail("phase 4h (b): the card's fetches fed no settle EWMA")
    log(f"  (b) {CP_BURST:,} joins against one pending flush of {CP_PENDING:,} rows at max.pending.bulk "
        f"{CP_BULK_BOUND:,}: {shed_q:,} shed \"queue\" (IngestShedError), then {CP_DEADLINE:,} shed \"deadline\" "
        f"with the estimate pinned, {CP_DEADLINE:,} admitted unpinned; every outcome, the valve's counters {valve} and "
        f"every state tensor identical on card and CPU; the live settle EWMA the card's fetches fed: {ewma:.3f} ms "
        f"({line})")
    # (c) The autotuner on the mixed stream, K10's routes counted by the
    # profiler (pa_small serves batches up to 2,048 items on either route).
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_out = drive_tuned_engine(DEV, 16, True)
        torch.cuda.synchronize()
    recs, t_states, decisions, memo, picks, t_splits = t_out
    k10 = {"pa_closed": 0, "pa_walk": 0, "pa_small": 0}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_kernels += 1
            for k in k10:
                if k in e.name:
                    k10[k] += 1
    if n_kernels == 0:
        fail("phase 4h (c): torch.profiler recorded no device kernel")
    c_recs, c_states, c_decisions, _, c_picks, _ = cpu_result(cpu_jobs, "4h c")
    _same(recs, c_recs, "(c) the tuned card engine vs the untuned CPU engine")
    _same_states(t_states, c_states, "(c) tuned card vs untuned CPU")
    if c_decisions or c_picks[1] != 0:
        fail(f"phase 4h (c): the untuned CPU engine moved a knob ({c_decisions}, picks {c_picks})")
    if k10["pa_closed"] == 0 or k10["pa_walk"] == 0 or picks[0] == 0 or picks[1] == 0:
        fail(f"phase 4h (c): K10 ran one route only (profiler {k10}, picks closed/scan {picks})")
    results["run_param"]["routes_4h"] = {"closed_picks": picks[0], "scan_picks": picks[1], **k10}
    depth = [(d["from"], d["to"], d["reason"]) for d in decisions if d["knob"] == "depth"]
    log(f"  (c) {CP_STEPS} flushes of {FLUSH_N:,} with the autotuner on: verdicts and every state tensor equal to the "
        f"untuned CPU engine's; K10 picks closed {picks[0]}, scan {picks[1]}; K10 kernels by torch.profiler "
        f"{k10}; depth decisions {depth or 'none'}; host split {split_line(t_splits)} ({line})")
    for b in memo:
        log(f"    memo bucket rows<={b['rows_bucket']}, {b['segments']} segment(s): closed {b['closed_ewma_ms']} ms "
            f"({b['closed_n']} samples), scan {b['scan_ewma_ms']} ms ({b['scan_n']}), current {b['current']} "
            f"(dispatch + settle ms of a flush; {line})")
    rps, p50, p99, n, w_decisions = windowed_latency(True, tuned=True)
    window = [(d["knob"], d["from"], d["to"], d["reason"]) for d in w_decisions]
    log(f"  (c) the window controller: api.entry_windowed, 8 threads, 2 s, the autotuner on: decisions "
        f"{window or 'none'}; {rps:,.0f} requests/s, p50 {p50:.4f} ms, p99 {p99:.4f} ms ({n} calls; {line})")
    # (d) The flight recorder: phase 4's stream with telemetry on, then off
    # (CP_TURNS times), the sketch against the CPU's, the trace written and read.
    c4 = cpu_result(cpu_jobs, "4")
    c_topk = c4[5][4][0]
    calls = {True: [], False: []}
    trace_on = n_on = None
    for turn in range(2 * CP_TURNS):
        on = turn % 2 == 0
        recs4, state4, blk4, flush_s, _, (_, _, _, splits4, rec4) = drive_engine(DEV, 4, telemetry=on)
        same_engine_result((recs4, state4, blk4 if on else PHASE4_RESULT["card"][2]), PHASE4_RESULT["card"],
                           f"phase 4h (d): telemetry {'on' if on else 'off'}")
        calls[on].append((flush_s * 1e3, float(np.median([s["encode_ms"] + s["kernel_ms"] for s in splits4])),
                          splits4))
        topk, n_spans, trace = rec4
        if on:
            if topk != c_topk:
                fail(f"phase 4h (d): the blocked sketch's top-K differs from the CPU engine's: {topk[:4]} vs "
                     f"{c_topk[:4]}")
            if n_spans <= 0:
                fail("phase 4h (d): telemetry on recorded no span")
            trace_on, n_on = trace, n_spans
        elif n_spans != 0 or topk:
            fail("phase 4h (d): telemetry off recorded something")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)  # listed in .gitignore
    path = os.path.join(ROOT, "build", "phase4h_trace.json")
    with open(path, "w") as fh:
        json.dump(trace_on, fh)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    encodes = sum(1 for e in events if e.get("ph") == "X" and e.get("name") == "encode")
    if encodes != n_on:
        fail(f"phase 4h (d): the trace holds {encodes} encode events for {n_on} spans")
    on_ms = [c[1] for c in calls[True]]
    off_ms = [c[1] for c in calls[False]]
    resolved = max(on_ms) < min(off_ms) or max(off_ms) < min(on_ms)
    log(f"  (d) phase 4's stream, telemetry on: flush call {', '.join(f'{c[0]:.2f}' for c in calls[True])} ms "
        f"(mean a run), host encode + kernel {', '.join(f'{m:.2f}' for m in on_ms)} ms (median a run); "
        f"host split {split_line([s for c in calls[True] for s in c[2]])} ({line})")
    log(f"      telemetry off: flush call {', '.join(f'{c[0]:.2f}' for c in calls[False])} ms, host encode + kernel "
        f"{', '.join(f'{m:.2f}' for m in off_ms)} ms; host split {split_line([s for c in calls[False] for s in c[2]])}; "
        f"on minus off, medians {float(np.median(on_ms)) - float(np.median(off_ms)):+.3f} ms: "
        f"{'resolved' if resolved else 'not resolved'} against the spread (ranges {min(on_ms):.2f}-{max(on_ms):.2f} "
        f"and {min(off_ms):.2f}-{max(off_ms):.2f}); the blocked sketch's top-K equal to the CPU engine's; "
        f"{encodes} spans written to {os.path.relpath(path, ROOT)} and read back, one encode event a span")
    syncs_ok = default_dispatch_syncs_ok()
    log(f"  (d) the DEFAULT dispatch with telemetry on: {syncs_ok} flush_async dispatches under "
        f"set_sync_debug_mode(\"error\"), 0 syncs")
    # (e) Throughput: entry_windowed and st.entry, 8 threads, in turns.
    turns = []
    for windowed in (True, False, True, False):
        turns.append((windowed, windowed_latency(windowed, seconds=CP_LATENCY_S)))
    for windowed, (rps, p50, p99, n, _) in turns:
        log(f"  (e) {'api.entry_windowed' if windowed else 'st.entry'}, 8 threads, {CP_LATENCY_S:g} s: {rps:,.0f} "
            f"requests/s, "
            f"p50 {p50:.4f} ms, p99 {p99:.4f} ms ({n} calls; {line})")
    # (a)'s CPU replay of the card's split.
    t0 = time.perf_counter()
    c_verdicts, c_state = replay.get()
    log(f"  (the CPU replay of (a) came {time.perf_counter() - t0:.1f} s after it was asked for)")
    _same(verdicts, c_verdicts, "(a) the window's verdicts")
    _same_cp_states(state, c_state, "(a) the window's states")
    adm = sum(1 for v in verdicts if v[0])
    if adm <= 0 or adm >= len(verdicts):
        fail("phase 4h (a): the windows admitted nothing or everything")
    log(f"  (a) verdicts (admitted, reason, wait_ms) of all {len(verdicts):,} requests ({adm:,} admitted), every "
        f"state tensor and the telemetry counters identical to the CPU engine's replay of the same {n_windows} "
        f"windows")
    tclock.set_default_clock(tclock.SystemClock())
    api.reset(device=DEV)


def default_dispatch_syncs_ok(flushes: int = 4) -> int:
    """The DEFAULT route with telemetry on: phase 4's bulk traffic, each
    dispatch through flush_async under set_sync_debug_mode("error") (a sync
    raises), the drain outside it. Returns the dispatches checked."""
    clock = tclock.ManualClock(0)
    eng = _fresh_engine(DEV, {}, clock)
    _cp_rules(with_param=False)
    if not eng.telemetry.enabled:
        fail("phase 4h (d): telemetry is not on by default")
    rng = np.random.default_rng(17)
    p = _zipf_p()
    eng.max_inflight = 8
    for step in range(flushes):
        now = 1000 + 100 * step
        clock.set_ms(now)
        res = np.sort(rng.choice(N_RULES, size=FLUSH_N, p=p), kind="stable")
        uniq, counts = np.unique(res, return_counts=True)
        for r, n in zip(uniq.tolist(), counts.tolist()):
            eng.submit_bulk(f"r{r}", int(n), ts=now)
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.flush_async()
        except RuntimeError as exc:
            fail(f"phase 4h (d): a DEFAULT dispatch with telemetry on synchronized with the host: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        eng.drain()
    if eng.telemetry.counters_snapshot()["flushes"] != flushes:
        fail("phase 4h (d): the checked dispatches recorded no span")
    return flushes


# ---------------------------------------------------------------------------
# phase 5: flow_qps_demo on the port
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 4i: the metric plane (the metric timer with K17, the live retune of
# the second window, the blocked top-K above 8, the mesh's host recount)
# ---------------------------------------------------------------------------

MP_SECONDS = 66  # (a): simulated seconds, one flush of FLUSH_N and one metric-timer pull each: the minute window wraps
MP_TOPK = 16  # (a): the blocked top-K of the flight recorder: above the fused route's 8, so the wide route runs
MP_ROWS_ASKED = 1 << 18  # (b): asked rows of K17 at full width
RT_STEPS = 12  # (c): flushes of each retuned stream
RT_PLAN = {3: ("sample_count", 4), 6: ("sample_count", 10), 9: ("interval", 2000), 10: ("sample_count", 2)}
MESH_TOPK_STEPS = 6  # (e): flushes of the mesh stream


class _CountingExtension:
    """A metric extension (metrics/extension.py) that counts its calls by
    (method, resource) and sums their weights."""

    def __init__(self):
        from collections import Counter

        from sentinel_tpu_torch.metrics.extension import MetricExtension

        calls = self.calls = Counter()

        class Ext(MetricExtension):
            def add_pass(self, resource, n, *args):
                calls[("pass", resource)] += n

            def add_block(self, resource, n, origin, block_error, *args):
                calls[("block", resource, type(block_error).__name__)] += n

            def add_success(self, resource, n, *args):
                calls[("success", resource)] += n

            def add_exception(self, resource, n, throwable):
                calls[("exception", resource)] += n

            def add_rt(self, resource, rt_ms, *args):
                calls[("rt", resource)] += rt_ms

        self.ext = Ext()


def _line_record(ln) -> tuple:
    """A metric line's fields; the ``__engine__`` line's RT (the flushes' host
    ms) is a wall time of the run, left out."""
    v = dict(vars(ln))
    if v["resource"] == "__engine__":
        v["rt"] = None
    return tuple(sorted(v.items()))


def _trace_record(rec) -> tuple:
    d = rec.as_dict()
    for k in ("trace_id", "span_id", "latency_ms"):
        d.pop(k)
    return tuple(sorted(d.items()))


def drive_metric_engine(device: torch.device, seed: int):
    """(a): phase 4's 6,000 rules with a breaker on every third of the first
    600 resources and a hot-param rule on every eighth, telemetry on with a
    blocked top-K of MP_TOPK, the admission tracer at its defaults (1% head
    sampling, every blocked verdict), a counting metric extension, the block
    log and the metric log under build/; MP_SECONDS simulated seconds of
    Zipf submit_bulk traffic (one flush of FLUSH_N a second) with exits that
    complete the breakers, and a MetricTimer.run_once pull after each. On
    the card each pull's K17 read and the JAX-style copy of the whole minute
    window are timed beside it. Returns the pulls' lines, the lines the
    searcher finds, the block log, the trace records and counters, the
    provenance totals, the extension's calls, the final states, the
    recorder's blocked top-K and the timings."""
    from sentinel_tpu_torch.metrics import admission_trace, extension
    from sentinel_tpu_torch.metrics.metric_log import MetricSearcher, MetricTimer, MetricWriter
    from sentinel_tpu_torch.utils.config import config

    d = os.path.join(ROOT, "build", f"phase4i_{device.type}")
    if os.path.isdir(d):
        for n in os.listdir(d):
            os.remove(os.path.join(d, n))
    os.makedirs(d, exist_ok=True)
    clock = tclock.ManualClock(0)
    eng = _fresh_engine(device, {config.LOG_DIR: d, config.TELEMETRY_BLOCKED_TOPK_K: str(MP_TOPK)}, clock)
    _cp_rules(with_param=True)
    st.degrade_rule_manager.load_rules([st.DegradeRule(f"r{i}", grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, count=15,
                                                       time_window=2, min_request_amount=5)
                                        for i in range(0, 600, 3)])
    rec = _CountingExtension()
    extension.MetricExtensionProvider.clear()
    extension.MetricExtensionProvider.register(rec.ext)
    admission_trace._rand.seed(seed)  # the same head sampling on the card and the CPU
    timer = MetricTimer(eng, writer=MetricWriter(base_dir=d, app_name="phase4i"))
    rng = np.random.default_rng(seed)
    p = _zipf_p()
    pulls, read_ms, copy_ms, pull_s, pull_k17 = [], [], [], [], []
    prev_groups, rows = [], []
    try:
        for step in range(MP_SECONDS):
            now = 1000 * step + 500
            clock.set_ms(now)
            res = np.sort(rng.choice(N_RULES, size=FLUSH_N, p=p))
            ts = (now - rng.integers(0, 400, FLUSH_N)).astype(np.int32)
            uniq, start = np.unique(res, return_index=True)
            bounds = list(start) + [FLUSH_N]
            groups = []
            for i, r in enumerate(uniq.tolist()):
                n = int(bounds[i + 1] - bounds[i])
                args = [(f"v{v}",) for v in np.minimum(rng.zipf(1.1, n), 64).tolist()] if r % 8 == 0 else None
                groups.append(eng.submit_bulk(f"r{r}", n, ts=np.sort(ts[bounds[i]:bounds[i + 1]]), args_column=args))
            for g in prev_groups[:300]:  # completions of the last second's admitted entries
                if g.admitted_count:
                    eng.submit_exit_bulk(g.rows, g.admitted_count, rt=int(rng.integers(1, 200)), ts=now,
                                         err=(rng.random(g.admitted_count) < 0.4).astype(np.int32),
                                         resource=g.resource)
            prev_groups = groups
            eng.flush()
            clock.set_ms(now + 1000)
            before = ma.bucket_read.launches
            t0 = time.perf_counter()
            lines = timer.run_once()
            pull_s.append(time.perf_counter() - t0)
            pull_k17.append(ma.bucket_read.launches - before)  # the pull's own K17 launches, not the timings'
            pulls.append([_line_record(ln) for ln in lines])
            if device.type == "cuda" and step % 11 == 10:
                # The pull's read alone, K17 against the JAX-style copy of
                # the whole window, on the engine's stream, synchronized.
                upto = clock.now_ms() // 1000 * 1000
                rows = [eng.nodes.entry_node_row] + [r for _, r in eng.nodes.resources()]
                idx = torch.tensor(rows, dtype=I32, device=device)
                minute = eng.stats.minute

                def k17():
                    ma.bucket_read(nodes.MINUTE_CFG, minute, idx, upto - 1000, upto, clock.now_ms())

                def whole():
                    ws, counts, valid = ma.bucket_windows(nodes.MINUTE_CFG, minute, clock.now_ms())
                    ws.cpu(), counts.cpu(), valid.cpu()

                for fn, out in ((k17, read_ms), (whole, copy_ms)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    out.append((time.perf_counter() - t0) * 1e3)
        eng.block_log.flush()
        searcher = MetricSearcher(base_dir=d, app_name="phase4i")
        found = [_line_record(ln) for ln in searcher.find(0, 2**62, max_lines=2**31)]
        traces = [_trace_record(r) for r in eng.admission_trace.records()]
        out = (pulls, found, eng.block_log.read_entries(), traces, eng.admission_trace.counters_snapshot(),
               eng.resource_metrics.totals(), dict(rec.calls), _states_of(eng),
               eng.telemetry.blocked_sketch.topk(64), (read_ms, copy_ms, pull_s, len(rows), pull_k17))
    finally:
        extension.MetricExtensionProvider.clear()
    return out


def drive_retuned_engine(device: torch.device, seed: int, chain: bool):
    """(c): phase 4's stream (``chain`` False) or 4b's (the slot chain with
    prioritized entries that borrow, so that K1, K5 and the slab run), for
    RT_STEPS flushes, the second window retuned between flushes through
    ``sample_count_property`` and ``interval_property``: 4 x 1,000 ms, then
    10 x 1,000 ms, then 2 x 2,000 ms (by 10 x 2,000). Returns the stream's
    records and final states and the geometries it ran at."""
    seen = []

    def retune(step):
        what = RT_PLAN.get(step)
        if what is not None:
            prop = st.sample_count_property if what[0] == "sample_count" else st.interval_property
            prop.update_value(what[1])
            cfg = nodes.SECOND_CFG
            seen.append((step, cfg.sample_count, cfg.interval_ms, tuple(api.get_engine().stats.second.counts.shape)))

    try:
        if chain:
            out = drive_chain_engine(device, seed, steps=RT_STEPS, before_flush=retune)
            records, stats, breakers = out[0], out[1], out[2]
            states = [stats, breakers]
        else:
            out = drive_engine(device, seed, steps=RT_STEPS, before_flush=retune)
            records, states = out[0], [out[1], out[2]]
        return records, states, seen, _states_of(api.get_engine())
    finally:
        api.reset(device=device)  # back to the default geometry


def drive_mesh_topk(device: torch.device, seed: int):
    """(e): the engine on 8 shards with telemetry on: MESH_TOPK_STEPS Zipf
    flushes of 8,192 entries over phase 4's rules. The sharded step has no
    device top-K, so the engine recounts each chunk's blocked weight on the
    host (``_fold_blocked_recount``). Returns the recorder's blocked top-K
    and its last flush's."""
    clock = tclock.ManualClock(0)
    api.reset(clock=clock, device=device)
    eng = api.get_engine()
    eng.enable_mesh(D_MESH)
    _cp_rules(with_param=False)
    rng = np.random.default_rng(seed)
    p = _zipf_p()
    for step in range(MESH_TOPK_STEPS):
        now = 1000 + 200 * step
        clock.set_ms(now)
        res = np.sort(rng.choice(N_RULES, size=8192, p=p))
        uniq, start = np.unique(res, return_index=True)
        bounds = list(start) + [res.size]
        for i, r in enumerate(uniq.tolist()):
            eng.submit_bulk(f"r{r}", int(bounds[i + 1] - bounds[i]), ts=now)
        eng.flush()
    tele = eng.telemetry
    return tele.blocked_sketch.topk(64), list(tele.last_blocked_topk)


def k17_full_width(results: dict) -> None:
    """(b): K17 on a minute window of R rows (half the cells nonzero, stale
    and empty buckets), MP_ROWS_ASKED asked rows, one second asked and 60,
    through the device's kept reader, as the metric timer reads: a steady
    read is one kernel, no memset and one copy back."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(17)
    now = 7_200_000 + 431
    upto = now - now % 1000
    cfg = nodes.MINUTE_CFG
    state = make_window_state(cfg, now, gen)
    state.counts.mul_((torch.rand(state.window_start.shape, generator=gen, device=DEV) < 0.5).to(I32)[:, :, None])
    idx = torch.randint(0, R, (MP_ROWS_ASKED,), generator=gen, device=DEV, dtype=I32)
    r = results["bucket_read"]
    for seconds in (1, 60):
        begin = upto - 1000 * seconds
        ma.bucket_read.launches = 0
        got = ma.bucket_read(cfg, state, idx, begin, upto, now)
        if ma.bucket_read.launches != 1:
            fail("phase 4i (b): K17 was not launched")
        want = ma.bucket_read_plain(cfg, state, idx, begin, upto, now)

        def sort(t):
            return t[torch.from_numpy(np.lexsort((t[:, 1].numpy(), t[:, 0].numpy())))]

        err = require_equal(sort(want), sort(got), f"phase 4i (b): bucket_read at {seconds} s")
        if got.shape[0] == 0:
            fail("phase 4i (b): K17 found no cell")
        call = lambda: ma.bucket_read(cfg, state, idx, begin, upto, now)  # noqa: E731
        kern, mems, dev_ms = profile(call, f"phase 4i (b): K17 at {seconds} s")
        try:
            copies = copies_per_call(call)
        except RuntimeError as exc:
            fail(f"phase 4i (b): K17's copies at {seconds} s: {exc}")
        if (kern, mems, copies.get("Memcpy DtoH", 0)) != (1, 0, 1):
            fail(f"phase 4i (b): a steady K17 read at {seconds} s took {kern} kernels, {mems} memsets and copies "
                 f"{copies}, not 1, 0 and one copy back")
        n_rec = got.shape[0]
        moved = MP_ROWS_ASKED * 4 + MP_ROWS_ASKED * seconds * (4 + 4 * NUM_EVENTS) + n_rec * 4 * ma.BUCKET_RECORD + 4
        b_ms, b_by = bound(moved)
        timing = dict(ms=time_ms(call), plain_ms=time_ms(lambda: ma.bucket_read_plain(cfg, state, idx, begin, upto,
                                                                                       now)),
                      launches_per_call=kern, memsets_per_call=mems, device_ms=dev_ms, records=n_rec,
                      bound=(b_ms, b_by))
        log(f"  (b) K17 at {MP_ROWS_ASKED:,} of {R:,} rows, {seconds} s asked: {timing['ms']:.4f} ms a call "
            f"(plain {timing['plain_ms']:.4f}), {kern} device kernels, {mems} memsets, copies {copies}, "
            f"{dev_ms:.4f} ms of device time; {n_rec:,} records; bound {b_ms:.5f} ms by {b_by}")
        if seconds == 1:
            r.update(ms=timing["ms"], plain_ms=timing["plain_ms"], library_ms=None, max_abs_err=err,
                     bound=timing["bound"], launches_per_call=kern, memsets_per_call=mems, device_ms=dev_ms,
                     copies_per_call=copies,
                     shape=f"{MP_ROWS_ASKED:,} asked rows of a {R:,}-row minute window, 1 s asked ({n_rec:,} records)")
        else:
            r.update(ms_60s=timing["ms"], plain_ms_60s=timing["plain_ms"], bound_ms_60s=b_ms, device_ms_60s=dev_ms,
                     launches_per_call_60s=kern, memsets_per_call_60s=mems, records_60s=n_rec)


def retuned_kernels() -> None:
    """(c): phase 2's kernel-against-plain checks of K1, K2, K3/row_stats,
    K4 with occupy, K5 and K9 at full width with the second window at
    10 x 100 ms."""
    old = nodes.SECOND_CFG
    nodes.set_second_window(10, 1000)
    try:
        gen = torch.Generator(device=DEV)
        gen.manual_seed(20)
        rng = np.random.default_rng(20)
        now = 3_000_000 + 456
        cfg = nodes.SECOND_CFG
        stats = make_stats(now, gen, matured_frac=0.02)
        want = nodes.materialize_matured_plain(clone(stats), now)
        require_equal(want, nodes.materialize_matured(clone(stats), now), "phase 4i (c): K1 at nb = 10")
        batch = make_batch(rng, now, skewed=True, with_exits=True)
        admitted = torch.rand(N, generator=gen, device=DEV) < 0.7
        rows, ts, dl, _, mask = entry_updates(batch, admitted)
        thr = torch.zeros_like(rows)
        want = nodes.apply_updates_plain(clone(stats), rows, ts, dl, None, thr, mask)
        require_equal(want, nodes.apply_updates(clone(stats), rows, ts, dl, None, thr, mask), "phase 4i (c): K2")
        rows_g = torch.from_numpy(zipf_rows(rng, N, R)).to(DEV)
        require_equal(nodes.rows_stats_plain(stats, rows_g, now), nodes.rows_stats(stats, rows_g, now),
                      "phase 4i (c): row_stats at nb = 10")
        require_equal(ma.window_reduce_plain(cfg, stats.second, now, rows_g, with_min=True),
                      ma.window_reduce(cfg, stats.second, now, rows_g, with_min=True), "phase 4i (c): K3 at nb = 10")
        # Borrowable windows: the bucket that expires next holds most of the
        # pass, a few slab cells future tokens.
        cur = now - now % cfg.window_len_ms
        nb = cfg.sample_count
        stats.future_ws.fill_(cfg.empty_ws)
        stats.future_pass.zero_()
        nxt = ((cur // cfg.window_len_ms) + 1) % nb
        stats.second.window_start[:, nxt] = cur - cfg.interval_ms + cfg.window_len_ms
        stats.second.counts[:, nxt, 0] = torch.randint(15, 30, (R,), generator=gen, device=DEV, dtype=I32)
        fut = torch.rand((R, nb), generator=gen, device=DEV) < 0.1
        stats.future_ws.copy_(torch.where(fut, cur + cfg.window_len_ms, stats.future_ws))
        stats.future_pass.copy_(torch.where(fut, 1, 0).to(I32))
        table = make_table()
        cb = batch._replace(e_prio=torch.from_numpy(rng.random(N) < 0.25).to(DEV))
        live = cb.e_valid
        w = flush.flow_admission_plain(stats, table, cb, 0, live, 1000, True, False, with_ppc=True)
        adm = flush.flow_admission(stats, table, cb, 0, live, 1000, True, False, with_ppc=True)
        require_equal(w, adm, "phase 4i (c): K4 with occupy at nb = 10")
        if not bool(adm.occupied.any()):
            fail("phase 4i (c): no entry borrowed at nb = 10")
        gate = adm.occ_slot & (adm.flow_pass & adm.occupied)[:, None]
        require_equal(flush.commit_borrow_slab_plain(slab_only(stats), gate, adm.occ_target, cb.e_acquire,
                                                     cb.e_check_row),
                      flush.commit_borrow_slab(slab_only(stats), gate, adm.occ_target, cb.e_acquire, cb.e_check_row),
                      "phase 4i (c): K5 at nb = 10")
        sh_table, sh_dyn = small_shaping_table()
        gids = rng.integers(0, sh_table.n_rules, N // 8)
        sb, _, _ = shaping_items(rng, gids, np.sort(rng.integers(now - 400, now, gids.size)), np.ones(gids.size))
        sb = sb._replace(row=i32(rng.integers(0, R, gids.size)), eidx=i32(rng.integers(0, N, gids.size)),
                         flat_pos=i32(rng.integers(0, N, gids.size)))
        for interval_sec in (1.0, 2.0):
            def call(fn):
                dyn = clone(sh_dyn)
                return (*fn(sh_table, dyn, sb, live, adm.pass_plus_consumed, stats.minute, interval_sec), dyn)

            require_equal(call(tsh.shaping_stage_plain), call(tsh.shaping_stage),
                          f"phase 4i (c): K9 at nb = 10 and interval {interval_sec} s")
        log("  (c) K1, K2, K3/row_stats, K4 with occupy, K5 and K9 at nb = 10 (full width) equal their plain versions")
    finally:
        nodes.set_second_window(old.sample_count, old.interval_ms)


def wide_topk(results: dict) -> None:
    """(d): the blocked top-K above 8 on the DEFAULT tail (K4) and on the
    slot chain's tail, at k = 16 and 64, at N entries over R rows and at 8
    entries, against the plain version; the wide route alone (two kernels
    and no memset a call: its selection) timed against its plain version
    and torch.topk of the dense weights (the library call); the zeroed
    scratch stays zero."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(21)
    rng = np.random.default_rng(21)
    now = 4_000_000 + 77
    stats = make_chain_stats(now, gen)
    table = make_table()
    r = results["blocked_topk_wide"]
    for n in (N, 8):
        batch = sub_batch(make_chain_batch(rng, now, skewed=True), n)
        for k in (16, 64):
            flush.blocked_topk_wide.launches = 0
            want = flush.flow_admission_plain(stats, table, batch, k)
            got = flush.flow_admission(stats, table, batch, k)
            err = require_equal(want, got, f"phase 4i (d): the DEFAULT tail at k = {k}, {n} entries")
            adm = flush.flow_admission(stats, table, batch, 0, batch.e_valid, 500, True, False)
            v_want = flush.slot_chain_verdict_plain(batch, adm, None, None, None, None, R, k)
            v_got = flush.slot_chain_verdict(batch, adm, None, None, None, None, R, k)
            err = max(err, require_equal(v_want, v_got, f"phase 4i (d): the chain's tail at k = {k}, {n} entries"))
            if flush.blocked_topk_wide.launches != 2:
                fail(f"phase 4i (d): the wide route ran {flush.blocked_topk_wide.launches} times for two tails")
            zero = cuda_build._SCRATCH.get((True, DEV, torch.cuda.current_stream(DEV).cuda_stream))
            torch.cuda.synchronize()
            if zero is not None and int(zero.count_nonzero()) != 0:
                fail("phase 4i (d): the wide route left the zeroed scratch dirty")
            admitted = got.admitted
            wide = lambda: flush.blocked_topk_wide(batch, admitted, R, k)  # noqa: E731
            plain = lambda: flush._blocked_topk_plain(batch, admitted, R, k)  # noqa: E731
            blocked_w = torch.where(batch.e_valid & ~admitted, batch.e_acquire, 0).to(I32)
            dense = torch.zeros(R + 1, dtype=I32, device=DEV).index_add_(
                0, torch.where(blocked_w > 0, batch.e_rows[:, 1].clamp(0, R - 1), R).long(), blocked_w)[:R]
            lib = lambda: torch.topk(dense, k)  # noqa: E731
            kern, mems, dev_ms = profile(wide, f"phase 4i (d): the wide route at k = {k}")
            if (kern, mems) != (2, 0):
                fail(f"phase 4i (d): the wide route at k = {k}, {n} entries took {kern} kernels and {mems} memsets a "
                     "call, not 2 and 0 (bt_add, bt_select)")
            moved = n * (1 + 1 + 4 + 4) + 8 * k
            b_ms, b_by = bound(moved)
            ms, p_ms, l_ms = time_ms(wide), time_ms(plain), time_ms(lib)
            log(f"  (d) k = {k}, {n:,} entries over {R:,} rows: both tails equal their plain versions; the wide route "
                f"{ms:.4f} ms a call (plain {p_ms:.4f}, torch.topk of the dense weights {l_ms:.4f}), {kern} kernels, "
                f"{mems} memsets, {dev_ms:.4f} ms of device time; bound {b_ms:.6f} ms by {b_by}")
            tag = "" if (n, k) == (N, MP_TOPK) else f"_{n}_k{k}"
            if tag:
                r.update({f"ms{tag}": ms, f"plain_ms{tag}": p_ms, f"library_ms{tag}": l_ms, f"device_ms{tag}": dev_ms,
                          f"launches_per_call{tag}": kern, f"memsets_per_call{tag}": mems})
            else:
                r.update(ms=ms, plain_ms=p_ms, library_ms=l_ms, max_abs_err=err, bound=(b_ms, b_by),
                         launches_per_call=kern, memsets_per_call=mems, device_ms=dev_ms, library_call="torch.topk",
                         shape=f"k = {k}, {n:,} entries over {R:,} rows (the chain tail's verdicts)")


def phase4_metric(results: dict, cpu_jobs: dict) -> None:
    log(f"phase 4i: the metric plane on the card: the metric timer over {MP_SECONDS} simulated s (K17), the retune, "
        f"the blocked top-K above 8, the mesh's host recount")
    # (a) the metric timer on phase 4's stream, counts from 0 around it
    wrappers = {"bucket_read": ma.bucket_read, "blocked_topk_wide": flush.blocked_topk_wide}
    for w in wrappers.values():
        w.launches = 0
    card = drive_metric_engine(DEV, 30)
    counts = {name: w.launches for name, w in wrappers.items()}
    # K17's count is the pulls' own: the side timings of the read launch it
    # too. Each pull asks the one second since the last, one launch each.
    pull_k17 = card[9][4]
    counts["bucket_read"] = sum(pull_k17)
    log(f"  (a) launches on the metric plane's path: {counts}")
    if pull_k17 != [1] * MP_SECONDS:
        fail(f"phase 4i (a): K17 launched {pull_k17} times in the {MP_SECONDS} pulls, not once a pull")
    for name, c in counts.items():
        if c <= 0:
            fail(f"phase 4i (a): kernel {name} was not launched on the metric plane's path")
        results[name]["launches"] = c
    cpu = cpu_result(cpu_jobs, "4i a")
    names = ["pull lines", "searcher lines", "block log", "trace records", "trace counters", "provenance totals",
             "extension calls"]
    for what, a, b in zip(names, card[:7], cpu[:7]):
        if a != b:
            fail(f"phase 4i (a): {what} differ between the card and the CPU")
    _same_states(card[7], cpu[7], "phase 4i (a) states")
    if card[8] != cpu[8]:
        fail("phase 4i (a): the recorder's blocked top-K differs between the card and the CPU")
    read_ms, copy_ms, pull_s, n_rows, _ = card[9]
    n_lines = sum(len(p) for p in card[0])
    if n_lines == 0 or not card[2] or not card[3]:
        fail("phase 4i (a): the stream wrote no metric line, block-log line or trace record")
    if not any(dict(ln)["resource"] == "__engine__" for p in card[0] for ln in p):
        fail("phase 4i (a): no __engine__ line")
    log(f"  (a) {n_lines:,} metric lines over {MP_SECONDS} pulls, {len(card[1]):,} found by the searcher, "
        f"{len(card[2]):,} block-log lines, {len(card[3])} trace records ({card[4]}), "
        f"{len(card[6]):,} extension keys: identical on card and CPU")
    log(f"  (a) a pull (flush, drain, K17 read, lines, write) {1e3 * min(pull_s):.3f}-{1e3 * max(pull_s):.3f} ms, "
        f"median {1e3 * float(np.median(pull_s)):.3f} ms; its read of {n_rows:,} rows: K17 "
        f"{min(read_ms):.4f}-{max(read_ms):.4f} ms against the whole-window copy {min(copy_ms):.4f}-"
        f"{max(copy_ms):.4f} ms (host clock around a synchronized call)")
    results["bucket_read"].update(pull_ms=[1e3 * min(pull_s), 1e3 * float(np.median(pull_s)), 1e3 * max(pull_s)],
                                  read_ms_4i=[min(read_ms), max(read_ms)], copy_ms_4i=[min(copy_ms), max(copy_ms)],
                                  asked_rows_4i=n_rows)
    # (b) K17 at full width
    k17_full_width(results)
    # (c) the retune on phase 4's and 4b's streams, and the kernels at nb = 10
    for tag, chain in (("4i c", False), ("4i c chain", True)):
        got = drive_retuned_engine(DEV, 31, chain)
        want = cpu_result(cpu_jobs, tag)
        if len(got[0]) != len(want[0]) or any(not np.array_equal(a, b) for a, b in zip(got[0], want[0])):
            fail(f"phase 4i (c): verdicts of the retuned {'chain' if chain else 'DEFAULT'} stream differ")
        _same_states(got[3], want[3], f"phase 4i (c) states ({tag})")
        if got[2] != want[2] or [g[1:3] for g in got[2]] != [(4, 1000), (10, 1000), (10, 2000), (2, 2000)]:
            fail(f"phase 4i (c): the geometries {got[2]} (CPU {want[2]})")
        log(f"  (c) {'the slot chain' if chain else 'the DEFAULT stream'} retuned to {[g[1:3] for g in got[2]]}: "
            f"{sum(len(x) for x in got[0]):,} verdict values and every state tensor identical on card and CPU")
    retuned_kernels()
    # (d) the wide top-K
    wide_topk(results)
    # (e) the mesh's host recount
    got = drive_mesh_topk(DEV, 32)
    want = cpu_result(cpu_jobs, "4i e")
    if got != want or not got[0]:
        fail(f"phase 4i (e): the mesh's blocked top-K {got[1][:4]} differs from the CPU engine's {want[1][:4]}")
    log(f"  (e) the mesh's host recount: the recorder's blocked top-K ({len(got[0])} resources) identical on card and "
        "CPU")


# ---------------------------------------------------------------------------
# phase 4j: the ipc plane (sentinel_tpu_torch/ipc) feeding the engine
# ---------------------------------------------------------------------------
IPC_WORKERS = 4
IPC_OWN = N_RULES // IPC_WORKERS  # 1,500 resources a worker: no two workers meet in a rule's window
IPC_ROWS = FLUSH_N // IPC_WORKERS  # 8,192 entries a worker a step: 32,768 a step over the workers
IPC_PARAM, IPC_THREAD, IPC_KILL = "ipc-param", "ipc-thread", "ipc-kill"
IPC_KILL_N = 64
IPC_LOOP_S = 1.0  # (c): seconds of each real-clock loop (3.0 before phase 4k, 1.5 before its 40 flushes in turns)
IPC_STEPS = 16  # (a): steps of FLUSH_N over the workers (40, phase 4's STEPS, before phase 4k)
IPC_SETTINGS = {"IPC_HEARTBEAT_MS": 50, "IPC_WORKER_DEAD_MS": 300}
# (a)'s planes take 64 KiB slots (a frame of up to 970 rows, against 236 at
# the default 16 KiB, which (c) keeps). (a)'s engines run without the
# admission tracer (it records every blocked row; (a) holds verdicts and
# state), and the speculative tier of the depth-2 run is made independent
# of which workers' frames share a drain, as the in-process reference
# needs: it settles after every group (speculative.flush.batch 1), each
# settle's fetch lands at once (flush.max.inflight 0), so a group's
# reconcile precedes its resource's next decision, and it never suspends
# (overadmit.max 0: the over-admission budget is one for all resources, so
# the point where it trips depends on the order of the workers' frames).
IPC_SLOT_BYTES_A = 65536
IPC_DRAINS_PER_S = {}  # (c): drains/s of each loop, which phase 4l prints beside its own
IPC_ENGINE_A = {"TRACE_ENABLED": "false", "SPECULATIVE_FLUSH_BATCH": 1, "SPECULATIVE_OVERADMIT_MAX": 0,
                "FLUSH_MAX_INFLIGHT": 0}


def _ipc_engine(device: torch.device, clock, **settings):
    """An engine of its own (not the api's: three live at once in phase
    4j) with phase 4's 6,000 DEFAULT QPS rules, a THREAD-grade rule (count
    96), a second one for the kill (count 1,000) and a hot-parameter rule."""
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.utils.config import config

    for key, value in settings.items():
        config.set(getattr(config, key), str(value))
    try:
        eng = Engine(clock=clock, device=device)
    finally:
        config.reset()
    eng.set_flow_rules([st.FlowRule(f"r{i}", count=20) for i in range(N_RULES)] + [
        st.FlowRule(IPC_THREAD, count=96, grade=C.FLOW_GRADE_THREAD),
        st.FlowRule(IPC_KILL, count=1000, grade=C.FLOW_GRADE_THREAD)])
    eng.set_param_rules({IPC_PARAM: [st.ParamFlowRule(IPC_PARAM, param_idx=0, count=4)]})
    return eng


def ipc_step(rng, w: int, now: int, p: np.ndarray) -> list:
    """Worker ``w``'s requests of one 100 ms step, as testing/ipc_procs
    script steps: Zipf(1.1) bulk groups of 64-2,048 rows over its own 1,500
    resources (8,192 rows in all, each group's ts sorted in [now - 100,
    now - 1]); worker 1 adds 8 single entries with args on the
    hot-parameter rule, worker 2 a group of 64 on the THREAD-grade rule."""
    out = []
    left = IPC_ROWS
    while left:
        n = min(left, int(rng.integers(64, 2049)))
        if 0 < left - n < 64:
            n = left - 64
        r = w * IPC_OWN + int(rng.choice(IPC_OWN, p=p))
        ts = np.sort(now - rng.integers(1, 101, n)).astype(np.int64)
        out.append({"kind": "bulk", "resource": f"r{r}", "n": n, "ts": ts, "timeout_ms": 120000})
        left -= n
    if w == 1:
        for _ in range(8):
            out.append({"kind": "entry", "resource": IPC_PARAM, "ts": int(now - rng.integers(1, 101)),
                        "args": [f"v{int(rng.integers(0, 6))}"], "timeout_ms": 120000})
    if w == 2:
        out.append({"kind": "bulk", "resource": IPC_THREAD, "n": 64, "ts": np.full(64, now - 50, np.int64),
                    "timeout_ms": 120000})
    return out


def ipc_exits(rng, steps: list, answers: list, now: int) -> list:
    """The completions a worker sends after its step's requests, from their
    verdicts: 4 of the admitted entries of each of its first two groups
    with admissions, and half of the THREAD-grade rule's."""
    out = []
    groups = 0
    for step, ans in zip(steps, answers):
        if ans[0] != "bulk":
            continue
        adm = int(sum(ans[1]))
        if step["resource"] == IPC_THREAD:
            k = adm // 2
        elif groups < 2 and adm:
            groups += 1
            k = min(adm, 4)
        else:
            continue
        out += [{"kind": "exit", "resource": step["resource"], "ts": now - 1, "rt": int(rng.integers(1, 300))}
                for _ in range(k)]
    return out


def _ipc_oracle_run(eng, steps: list, spec: bool) -> list:
    """One worker's steps on an engine in this process, with the plane's
    semantics: each bulk group split into the client's frames by bytes, a
    frame's group one submit_bulk (a speculative group answered before its
    settle, else a flush), an exit one submit_exit_bulk left for the next
    flush. Returns the answers ``testing/ipc_procs`` would."""
    from sentinel_tpu_torch.ipc import frames as ifr
    from sentinel_tpu_torch.ipc.worker import _byte_chunks
    from sentinel_tpu_torch.utils.config import config

    budget = IPC_SLOT_BYTES_A - ifr.FRAME_RESERVE
    out = []
    for step in steps:
        if step["kind"] == "exit":
            with eng._lock:
                rows = eng.resolve_entry_rows(step["resource"], C.CONTEXT_DEFAULT_NAME, "", C.EntryType.OUT)
            eng.submit_exit_bulk(rows, 1, rt=np.array([step["rt"]]), count=np.array([1]), err=np.array([0]),
                                 ts=np.array([step["ts"]]), resource=step["resource"], speculative=spec)
            out.append(("exit",))
            continue
        n = step.get("n", 1)
        ts = np.broadcast_to(np.asarray(step["ts"], np.int64), (n,))
        args = [tuple(step.get("args", ()))] * n
        adm, rsn, wms = [], [], []
        for lo, hi in _byte_chunks([ifr.ENTRY_ROW_BYTES + len(ifr.encode_args(a)) for a in args], budget, "oracle"):
            m = hi - lo
            args_col = args[lo:hi] if any(args[lo:hi]) else None
            op = eng.submit_bulk(step["resource"], m, ts=ts[lo:hi].astype(np.int32),
                                 acquire=np.ones(m, np.int32), args_column=args_col)
            if op.spec_admitted is not None:
                eng._spec_maybe_settle()
            else:
                eng.flush()
            adm += op.admitted.tolist()
            rsn += op.reason.tolist()
            wms += op.wait_ms.tolist()
        if step["kind"] == "entry":
            out.append(("entry", adm[0], rsn[0], wms[0]))
        else:
            out.append(("bulk", adm, rsn, wms))
    return out


def _ipc_answer(ans) -> tuple:
    """A worker's answer as the oracle writes it (no flags)."""
    if ans[0] == "entry":
        return ("entry", bool(ans[1]), int(ans[2]), int(ans[3]))
    if ans[0] == "bulk":
        return ("bulk", [bool(a) for a in ans[1]], [int(r) for r in ans[2]], [int(w) for w in ans[3]])
    return tuple(ans)


def drive_ipc(device: torch.device, seed: int, depth: int, spec: bool, workers=None):
    """Phase 4j (a): IPC_STEPS steps of the four workers' scripts in lockstep.
    A step sets the clock, runs every worker's requests, then every
    worker's completions of the step's admissions, and ends with a settle
    (flush and drain) once the plane has applied them: a worker's exits
    then reach the device at the same point of its own history wherever
    they share a drain with another worker's frames. With ``workers`` (the
    engine, its clock, the plane, and its four workers' queues) the steps go
    through the worker processes; without, through ``_ipc_oracle_run`` on an
    engine of this process (the CPU reference). Returns (the answers a step
    and worker, the final states, stats reads, the CUDA flags the workers
    reported)."""
    p = (np.arange(1, IPC_OWN + 1, dtype=np.float64) ** -1.1)
    p /= p.sum()
    rngs = [np.random.default_rng([seed, w]) for w in range(IPC_WORKERS)]
    exit_rngs = [np.random.default_rng([seed, w, 1]) for w in range(IPC_WORKERS)]
    if workers is None:
        clock = tclock.ManualClock(0)
        eng = _ipc_engine(device, clock, PIPELINE_DEPTH=depth, SPECULATIVE_ENABLED=str(spec).lower(), **IPC_ENGINE_A)
    else:
        eng, clock, plane, cmd_qs, out_q = workers
        exits_seen = plane.snapshot()["counters"]["exits"]
    records, cuda_flags = [], []

    def run(scripts):
        if workers is None:
            return [_ipc_oracle_run(eng, scripts[w], spec) for w in range(IPC_WORKERS)]
        for w in range(IPC_WORKERS):
            cmd_qs[w].put(("script", scripts[w]))
        answers = [None] * IPC_WORKERS
        for _ in range(IPC_WORKERS):
            tag, w, out, cuda = out_q.get(timeout=300)
            if tag != "script":
                fail(f"phase 4j (a): worker {w} answered {tag}")
            answers[w] = [_ipc_answer(a) for a in out]
            cuda_flags.append(cuda)
        return answers

    for s in range(IPC_STEPS):
        now = 1000 + 100 * s
        clock.set_ms(now)
        scripts = [ipc_step(rngs[w], w, now, p) for w in range(IPC_WORKERS)]
        answers = run(scripts)
        exits = [ipc_exits(exit_rngs[w], scripts[w], answers[w], now) for w in range(IPC_WORKERS)]
        run(exits)
        if workers is not None:  # every exit frame applied before the settle
            exits_seen += sum(len(x) for x in exits)
            deadline = time.monotonic() + 60
            while plane.snapshot()["counters"]["exits"] < exits_seen:
                if time.monotonic() > deadline:
                    fail(f"phase 4j (a): the plane applied {plane.snapshot()['counters']['exits']} of "
                         f"{exits_seen} exits")
                time.sleep(0.0005)
        records.append([answers[w] + [("exit",)] * len(exits[w]) for w in range(IPC_WORKERS)])
        eng.flush()
        eng.drain()
    for _ in range(2):  # the second settles what the first's reconciles queued (the tier's gauge compensations)
        eng.flush()
        eng.drain()
    reads = [json.dumps(eng.cluster_node_stats(r, flush=False), sort_keys=True)
             for r in ("r0", "r1500", "r3000", "r4500", IPC_THREAD)]
    states = _ipc_states(eng)
    if workers is None:
        eng.close()
    return records, states, reads, cuda_flags


def _ipc_states(eng) -> list:
    """``_states_of(eng)`` with the stats' rows in the order of their
    registry keys, and the keys: the plane registers the workers' resources
    in the order their frames drain, which differs from run to run."""
    from sentinel_tpu_torch.runtime.failover import tree_leaves

    with eng.nodes._lock:
        keys = list(eng.nodes._keys)
    stats, *rest = _states_of(eng)
    n_rows = stats.threads.shape[0]
    order = np.array(sorted(range(len(keys)), key=keys.__getitem__) + list(range(len(keys), n_rows)))
    return [sorted(keys), tuple(x[order] for x in tree_leaves(tuple(stats))), *rest]


def _ipc_same_states(a, b, what: str) -> None:
    """The registries' keys equal, and every state tensor bit for bit."""
    from sentinel_tpu_torch.runtime.failover import tree_leaves

    if a[0] != b[0]:
        fail(f"phase 4j (a) {what}: the node registries differ")
    for i, (x, y) in enumerate(zip(tree_leaves(tuple(a[1:])), tree_leaves(tuple(b[1:])))):
        if x.shape != y.shape or x.dtype != y.dtype or not np.array_equal(
                x.view(np.int32) if x.dtype == np.float32 else x, y.view(np.int32) if y.dtype == np.float32 else y):
            fail(f"phase 4j (a) {what}: state tensor {i} differs")


class _PlaneMeter:
    """Wraps an engine's ``flush`` and its plane's ``_drain_once`` (instance
    attributes, which the drainer looks up each call) to keep the host split
    of each of the drainer's flushes and the count of drains that carried
    frames; ``take()`` returns and clears them."""

    def __init__(self, eng, plane) -> None:
        self.splits, self.drains, self._lock = [], 0, threading.Lock()
        flush_fn, drain_fn = eng.flush, plane._drain_once

        def flush_and_keep(*a, **k):
            out = flush_fn(*a, **k)
            with self._lock:
                self.splits.append(dict(eng.last_flush_host_ms))
            return out

        def drain_and_count():
            worked = drain_fn()
            if worked:
                with self._lock:
                    self.drains += 1
            return worked

        eng.flush, plane._drain_once = flush_and_keep, drain_and_count

    def take(self):
        with self._lock:
            out = (self.splits, self.drains)
            self.splits, self.drains = [], 0
        return out


def _ipc_spawn(plane, n: int):
    """``n`` testing/ipc_procs.serve workers of ``plane`` (spawned from its
    context), each with a client attached: (processes, command queues, the
    answer queue, the CUDA flags they reported)."""
    from sentinel_tpu_torch.testing import ipc_procs

    ctx = plane.spawn_context()
    out_q = ctx.Queue()
    procs, cmd_qs = [], []
    for w in range(n):
        q = ctx.Queue()
        pr = ctx.Process(target=ipc_procs.serve, args=(plane.channel(w), w, q, out_q), daemon=True)
        pr.start()
        procs.append(pr)
        cmd_qs.append(q)
    return procs, cmd_qs, out_q


def _ipc_attach(cmd_qs, out_q, cfg: dict) -> list:
    for q in cmd_qs:
        q.put(("client", cfg))
    flags = []
    for _ in cmd_qs:
        tag, w, cuda = out_q.get(timeout=300)
        if tag != "client":
            fail(f"phase 4j: worker {w} answered {tag} to its attach")
        flags.append(cuda)
    return flags


def _ipc_stop(procs, cmd_qs, out_q) -> list:
    """Stop the workers (their clients close); the CUDA flags they report."""
    flags = []
    for pr, q in zip(procs, cmd_qs):
        if pr.is_alive():
            q.put(("stop",))
    for pr in procs:
        pr.join(timeout=30)
        if pr.is_alive():
            pr.terminate()
            pr.join(timeout=10)
    while True:
        try:
            msg = out_q.get(timeout=0.5)
        except Exception:
            break
        if msg[0] == "stopped":
            flags.append(msg[-1])
    return flags


def _pcts(rtt) -> str:
    a = np.sort(np.asarray(rtt))
    return f"p50 {a[len(a) // 2]:.3f}, p99 {a[int(0.99 * len(a))]:.3f} ms" if len(a) else "no calls"


def _ipc_loops(eng, plane, cmd_qs, out_q, cuda_flags: list) -> None:
    """(c): on the real clock, IPC_LOOP_S each: 1 worker then 4 looping
    bulk(res, 256), one caller looping entry, then 8 callers in one worker
    with the micro-window off and at 2 ms."""
    meter = _PlaneMeter(eng, plane)
    coalesced = {}
    own = [[f"r{w * IPC_OWN + i}" for i in range(IPC_OWN)] for w in range(IPC_WORKERS)]

    def run(tag, cmds):
        meter.take()
        t0 = time.perf_counter()
        for w, cmd in cmds:
            cmd_qs[w].put(cmd)
        got = [out_q.get(timeout=300) for _ in cmds]
        took = time.perf_counter() - t0
        splits, drains = meter.take()
        for g in got:
            cuda_flags.append(g[-1])
        if tag.startswith("bulk"):
            calls, rows = sum(g[2] for g in got), sum(g[3] for g in got)
            rtt, frames = [x for g in got for x in g[4]], sum(g[5] for g in got)
        else:
            calls = rows = sum(g[2] for g in got)
            rtt, frames = [x for g in got for x in g[3]], sum(g[4] for g in got)
        if calls == 0 or not splits:
            fail(f"phase 4j (c) {tag}: no call went through the plane")
        coalesced[tag] = 1.0 - frames / calls
        IPC_DRAINS_PER_S[tag] = drains / took
        log(f"  (c) {tag}: {rows / took:,.0f} requests/s through the plane ({calls:,} calls, {frames:,} frames in "
            f"{took:.2f} s); round trip {_pcts(rtt)}; {drains / took:,.1f} drains/s; {len(splits):,} drainer "
            f"flushes, host split {split_line(splits)}"
            + ("" if tag.startswith("bulk") else f"; frames coalesced by the micro-window {coalesced[tag]:.1%}"))

    seed = 41
    run("bulk, 1 worker", [(0, ("loop_bulk", own[0], 256, IPC_LOOP_S, seed))])
    run("bulk, 4 workers", [(w, ("loop_bulk", own[w], 256, IPC_LOOP_S, seed + w)) for w in range(IPC_WORKERS)])
    run("entry, 1 caller", [(0, ("loop_entry", own[0], IPC_LOOP_S, 1, seed))])
    run("entry, 8 callers, window 0 ms", [(1, ("loop_entry", own[1], IPC_LOOP_S, 8, seed))])
    _ipc_attach([cmd_qs[1]], out_q, {"sentinel.tpu.ipc.client.window.ms": "2"})
    run("entry, 8 callers, window 2 ms", [(1, ("loop_entry", own[1], IPC_LOOP_S, 8, seed))])
    if coalesced["entry, 8 callers, window 2 ms"] <= 0.0:
        fail("phase 4j (c): the 2 ms micro-window coalesced no frame under 8 callers")


def phase4_ipc(results: dict, cpu_jobs: dict) -> None:
    from sentinel_tpu_torch.ipc.plane import IngestPlane
    from sentinel_tpu_torch.utils.config import config

    log(f"phase 4j: the ipc plane on the card ({IPC_WORKERS} spawned workers, {N_RULES:,} rules, "
        f"{FLUSH_N:,} entries a step over {IPC_STEPS / 10:g} simulated s; {card_line()})")
    t_phase = time.perf_counter()
    clock_a, clock_b = tclock.ManualClock(0), tclock.ManualClock(0)
    eng_a = _ipc_engine(DEV, clock_a, PIPELINE_DEPTH=0, SPECULATIVE_ENABLED="false", **IPC_ENGINE_A)
    eng_b = _ipc_engine(DEV, clock_b, PIPELINE_DEPTH=2, SPECULATIVE_ENABLED="true", **IPC_ENGINE_A)
    eng_c = _ipc_engine(DEV, None)
    planes = []
    for eng in (eng_a, eng_b, eng_c):
        for key, value in IPC_SETTINGS.items():
            config.set(getattr(config, key), str(value))
        if eng is not eng_c:
            config.set(config.IPC_SLOT_BYTES, str(IPC_SLOT_BYTES_A))
        try:
            planes.append(IngestPlane(eng))
        finally:
            config.reset()
    # Four workers a plane, and on the depth-2 plane a fifth for (b), which
    # admits nothing before it. Each spawn imports torch: the depth-0 fleet
    # starts alone, the others import while (a) runs at depth 0.
    fleets = [_ipc_spawn(planes[0], IPC_WORKERS)]
    cuda_flags = _ipc_attach(*fleets[0][1:], {})
    log(f"  {IPC_WORKERS} workers spawned and attached in {time.perf_counter() - t_phase:.1f} s")
    fleets += [_ipc_spawn(planes[1], IPC_WORKERS + 1), _ipc_spawn(planes[2], IPC_WORKERS)]
    wrappers = {"materialize_matured": nodes.materialize_matured, "window_update": ma.update,
                "thread_gauge": nodes.thread_gauge_add, "flow_admission": flush.flow_admission,
                "run_param": tpt.run_param, "row_stats": nodes.rows_stats}
    for w in wrappers.values():
        w.launches = 0
    # (a) parity through the processes: depth 0, then depth 2 with the tier on
    for tag, eng, clock, fleet, depth, spec in (("4j a0", eng_a, clock_a, fleets[0], 0, False),
                                                ("4j a2", eng_b, clock_b, fleets[1], 2, True)):
        if depth:
            t0 = time.perf_counter()
            for f in fleets[1:]:
                cuda_flags += _ipc_attach(*f[1:], {})
            log(f"  the other {len(fleets[1][0]) + len(fleets[2][0])} workers attached {time.perf_counter() - t0:.1f} s "
                "after (a) at depth 0")
        t0 = time.perf_counter()
        got = drive_ipc(DEV, 19, depth, spec, workers=(eng, clock, planes[0 if depth == 0 else 1], fleet[1], fleet[2]))
        took = time.perf_counter() - t0
        cuda_flags += got[3]
        want = cpu_result(cpu_jobs, tag)
        if got[0] != want[0]:
            bad = next((s, w) for s in range(IPC_STEPS) for w in range(IPC_WORKERS) if got[0][s][w] != want[0][s][w])
            fail(f"phase 4j (a) depth {depth}: verdicts differ from the CPU engine's at step {bad[0]}, worker {bad[1]}")
        _ipc_same_states(got[1], want[1], f"depth {depth}")
        if got[2] != want[2]:
            fail(f"phase 4j (a) depth {depth}: the stats reads differ from the CPU engine's")
        n_req = sum(len(a[1]) if a[0] == "bulk" else 1 for step in got[0] for ans in step for a in ans
                    if a[0] != "exit")
        n_adm = sum(sum(a[1]) if a[0] == "bulk" else int(a[1]) for step in got[0] for ans in step for a in ans
                    if a[0] != "exit")
        n_exit = sum(1 for step in got[0] for ans in step for a in ans if a[0] == "exit")
        if not 0 < n_adm < n_req:
            fail(f"phase 4j (a) depth {depth}: {n_adm} of {n_req} admitted: the stream did not exercise the rules")
        snap = planes[0 if depth == 0 else 1].snapshot()["counters"]
        log(f"  (a) depth {depth}, speculative {'on' if spec else 'off'}: {n_req:,} requests ({n_adm:,} admitted) and "
            f"{n_exit:,} exits from {IPC_WORKERS} processes in {took:.1f} s; verdicts, reasons, wait_ms, stats reads "
            f"and every state tensor identical to the CPU engine fed each worker's steps in-process; plane counters "
            f"{snap}")
    counts = {name: w.launches for name, w in wrappers.items()}
    log(f"  (a) launches through the plane (both depths, the stats reads included): {counts}")
    if counts["flow_admission"] <= 0:
        fail("phase 4j (a): the flow admission (K4) was not launched through the plane")
    if counts["materialize_matured"] != 0:
        fail("phase 4j (a): the matured-borrow sweep (K1) ran on a stream that borrows nothing")
    for name, c in counts.items():
        results[name]["launches_4j"] = c
    # (b) the worker-kill chaos on the depth-2 plane (the mirror armed)
    procs, cmd_qs, out_q = fleets[1]
    plane_b = planes[1]
    dead0 = plane_b.snapshot()["counters"]["worker_deaths"]
    auto0 = plane_b.snapshot()["counters"]["auto_exits"]
    kw = IPC_WORKERS
    cmd_qs[kw].put(("script", [{"kind": "entry", "resource": IPC_KILL, "ts": 1000 + 100 * IPC_STEPS,
                                "timeout_ms": 120000}] * IPC_KILL_N))
    tag, _w, ans, cuda = out_q.get(timeout=300)
    cuda_flags.append(cuda)
    if tag != "script" or sum(bool(a[1]) for a in ans) != IPC_KILL_N:
        fail(f"phase 4j (b): the worker admitted {sum(bool(a[1]) for a in ans)} of {IPC_KILL_N}")
    eng_b.flush()
    eng_b.drain()
    before = eng_b.cluster_node_stats(IPC_KILL)["cur_thread_num"]
    t_kill = time.perf_counter()
    os.kill(procs[kw].pid, 9)
    deadline = time.monotonic() + 30
    while plane_b.snapshot()["counters"]["auto_exits"] - auto0 < IPC_KILL_N and time.monotonic() < deadline:
        time.sleep(0.01)
    reaped_s = time.perf_counter() - t_kill
    time.sleep(0.2)  # a second reap would show here
    counters = plane_b.snapshot()["counters"]
    auto, deaths = counters["auto_exits"] - auto0, counters["worker_deaths"] - dead0
    eng_b.flush()
    eng_b.drain()
    nodes.rows_stats.launches = 0
    gauge = eng_b.cluster_node_stats(IPC_KILL)["cur_thread_num"]
    mirror = eng_b.speculative.mirror.snapshot()["live_threads"].get(IPC_KILL, 0)
    log(f"  (b) worker {kw} admitted {IPC_KILL_N} on the THREAD-grade rule (gauge {before}), SIGKILL: reaped after "
        f"{reaped_s:.3f} s (worker.dead.ms {IPC_SETTINGS['IPC_WORKER_DEAD_MS']}), {deaths} death, auto_exits {auto}; "
        f"the device gauge (row_stats, {nodes.rows_stats.launches} launch) {gauge}, the mirror {mirror}")
    if (before, auto, deaths, gauge, mirror) != (IPC_KILL_N, IPC_KILL_N, 1, 0, 0) or (
            DEV.type == "cuda" and nodes.rows_stats.launches != 1):
        fail(f"phase 4j (b): gauge before {before}, deaths {deaths}, auto_exits {auto}, gauge after {gauge}, "
             f"mirror {mirror}")
    # (c) times on the real clock
    _ipc_loops(eng_c, planes[2], fleets[2][1], fleets[2][2], cuda_flags)
    for windowed in (False, True):
        rps, p50, p99, n, _ = windowed_latency(windowed, seconds=IPC_LOOP_S)
        log(f"  (c) in-process {'api.entry_windowed (2 ms window)' if windowed else 'st.entry'}, 8 threads: "
            f"{rps:,.0f} requests/s, p50 {p50:.3f}, p99 {p99:.3f} ms ({n:,} calls)")
    # (d) no worker set CUDA up; nvidia-smi lists no worker's context
    apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.split()
    pids = {str(pr.pid) for procs_, _q, _o in fleets for pr in procs_ if pr.is_alive()}
    for procs_, cmd_qs_, out_q_ in fleets:
        cuda_flags += _ipc_stop(procs_, cmd_qs_, out_q_)
    for pl in planes:
        pl.close()
    for eng in (eng_a, eng_b, eng_c):
        eng.close()
    log(f"  (d) torch.cuda.is_initialized() in the workers: {len(cuda_flags)} reports, "
        f"{sum(bool(f) for f in cuda_flags)} True; nvidia-smi's compute processes while {len(pids)} workers lived: "
        f"{len(apps)} (this one alone holds a context)")
    if any(cuda_flags) or len(apps) > 1:
        fail("phase 4j (d): a worker process set CUDA up")
    log(f"  phase 4j took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 4k: the capture journal (runtime/capture.py) and its replay
# ---------------------------------------------------------------------------

CAP_STEPS = 40  # (a): flushes of FLUSH_N, 100 ms each, on each of the two engines
CAP_RELOAD = 20  # (a): the flow rules reload (count 20 -> 16) before this flush
# (b): the chunks of the capture the CPU replay runs (the plain K10 walks a hot value a round an item)
CAP_CPU_CHUNKS = 3
CAP_DIR = os.path.join(ROOT, "build", "phase4k")
# The whole run in live segments: no rollover deletes a chunk, and the
# breakers' freezes (one a fill that opens one) keep every frozen segment.
CAP_SETTINGS = {"CAPTURE_SEGMENT_BYTES": 256 << 20, "CAPTURE_SEGMENTS_MAX": 64, "CAPTURE_FROZEN_MAX": 4096,
                "CAPTURE_FREEZE_SECONDS": 3600}
CAP_COUNTERS = {"window_update": (ma.update, "launches"), "flow_admission": (flush.flow_admission, "launches"),
                "breaker_on_exits": (tdt.breaker_on_exits, "launches"),
                "breaker_try_pass": (tdt.breaker_try_pass, "launches"), "run_param": (tpt.run_param, "launches")}


def _cap_settings(cap_dir, **extra) -> dict:
    from sentinel_tpu_torch.utils.config import config

    if cap_dir is None:
        return {getattr(config, k): str(v) for k, v in extra.items()}
    out = {config.CAPTURE_ENABLED: "true", config.CAPTURE_DIR: cap_dir}
    out.update({getattr(config, k): str(v) for k, v in {**CAP_SETTINGS, **extra}.items()})
    return out


def _cap_launches() -> dict:
    return {name: getattr(w, attr) for name, (w, attr) in CAP_COUNTERS.items()}


class _CapRun:
    """One engine of (a)'s pair and what it gave: verdict records, flush
    call ms, host splits, kernel launches, note_chunk's ms a flush."""

    def __init__(self, cap_dir):
        from sentinel_tpu_torch.rules.system_manager import SystemConfig

        self.clock = tclock.ManualClock(0)
        self.eng = eng = _cap_engine(_cap_settings(cap_dir), self.clock)
        self.on = eng.capture is not None
        self.records, self.calls, self.splits, self.note_ms = [], [], [], []
        self.launches = dict.fromkeys(CAP_COUNTERS, 0)
        self.prev_groups, self.prev_singles = [], []
        eng.set_flow_rules([st.FlowRule(f"r{i}", count=20) for i in range(N_RULES)])
        eng.set_degrade_rules([
            st.DegradeRule(f"r{i}", grade=(i // 3) % 3, count=(100, 0.3, 20)[(i // 3) % 3], time_window=1,
                           slow_ratio_threshold=0.5, min_request_amount=5)
            for i in range(0, N_RULES, 3)
        ])
        eng.set_system_config(SystemConfig(qps=150_000, max_rt=140))
        eng.set_authority_rules({f"r{i}": st.AuthorityRule(f"r{i}", limit_app="appA") for i in range(0, N_RULES, 7)})
        eng.set_param_rules({f"r{i}": [st.ParamFlowRule(f"r{i}", param_idx=0, count=5)]
                             for i in range(0, N_RULES, 8)})
        if self.on:
            note_chunk = eng.capture.note_chunk

            def timed(*a):
                t0 = time.perf_counter()
                out = note_chunk(*a)
                self.note_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            eng.capture.note_chunk = timed

    def step(self, step: int, now: int, stream: tuple) -> None:
        """One flush of the step's stream (the singles, then the groups, then
        the exits of this engine's own previous admissions)."""
        eng = self.eng
        before = _cap_launches()
        self.clock.set_ms(now)
        if step == CAP_RELOAD:
            eng.set_flow_rules([st.FlowRule(f"r{i}", count=16) for i in range(N_RULES)])
        singles_ts, groups_in, exit_rng = stream
        singles = [eng.submit_entry(f"r{N_RULES - 8 + j % 8}", origin="appA", prio=True, ts=int(t))
                   for j, t in enumerate(singles_ts)]
        groups = [eng.submit_bulk(res, n, ts=ts, origin=origin, entry_type=et, args_column=args)
                  for res, n, ts, origin, et, args in groups_in]
        x = np.random.default_rng(exit_rng)  # the exits' draws: the same on both engines while they agree
        for g in self.prev_groups[:100]:
            if g.admitted_count:
                n_x = g.admitted_count
                eng.submit_exit_bulk(g.rows, n_x, rt=x.integers(1, 300 if step % 4 < 2 else 200, n_x).astype(np.int32),
                                     err=(x.random(n_x) < 0.3).astype(np.int32), ts=now, resource=g.resource)
        for op in self.prev_singles:
            if op.verdict.admitted:
                eng.submit_exit(op.rows, rt=int(x.integers(1, 50)), ts=now, resource=op.resource)
        if DEV.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.flush()
        self.calls.append((time.perf_counter() - t0) * 1e3)
        self.splits.append(eng.last_flush_host_ms)
        for g in groups:
            self.records += [g.admitted, g.reason, g.wait_ms]
        self.records.append(np.array([_verdict_record(o.verdict) for o in singles], dtype=object))
        self.prev_groups, self.prev_singles = groups, singles
        after = _cap_launches()
        for k in self.launches:
            self.launches[k] += after[k] - before[k]

    def finish(self):
        """Drain and close; returns (the journal's counters or None, the states)."""
        before = _cap_launches()
        self.eng.flush()
        self.eng.drain()
        after = _cap_launches()
        for k in self.launches:
            self.launches[k] += after[k] - before[k]
        counters = self.eng.capture.snapshot()["counters"] if self.on else None
        states = _states_of(self.eng)
        self.eng.close()
        return counters, states


def _cap_stream(rng, p, step: int, now: int) -> tuple:
    """One step of (a)'s stream: 64 prioritized singles' timestamps, the Zipf
    bulk groups (resource, n, ts, origin, entry type, args column) and the
    seed of the exits' draws."""
    singles_ts = now - rng.integers(0, 50, 64)
    res = rng.choice(N_RULES, size=FLUSH_N - 64, p=p)
    ts = (now - rng.integers(0, 100, res.size)).astype(np.int32)
    order = np.argsort(res, kind="stable")
    res, ts = res[order], ts[order]
    uniq, start = np.unique(res, return_index=True)
    bounds = list(start) + [res.size]
    vals = np.minimum(rng.zipf(1.1, res.size), 4096)  # as phase 4h (a)'s values
    origins = ["", "appA", "appB"]
    groups = []
    for i, r in enumerate(uniq.tolist()):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        groups.append((f"r{r}", hi - lo, np.sort(ts[lo:hi]), origins[(r + step) % 3],
                       C.EntryType.IN if r % 2 == 0 else C.EntryType.OUT,
                       [(f"v{v}",) for v in vals[lo:hi].tolist()] if r % 8 == 0 else None))
    return singles_ts, groups, int(rng.integers(0, 2**31))


def drive_capture_pair(seed: int, cap_dir: str):
    """(a): the slot chain's stream of phase 4b (6,000 QPS rules, breakers
    on every third resource, system rules, white lists on every seventh,
    Zipf bulk groups from three origins, 64 prioritized entries a flush on
    eight cold resources, bulk exits of the previous flush's admissions
    with 30% errors, single exits of the admitted singles) with hot-param
    rules (count 5 a value) on every eighth resource, whose groups carry a
    Zipf value column; CAP_STEPS flushes of FLUSH_N, the flow rules
    reloaded before flush CAP_RELOAD. Two engines on the card take the same
    stream, the journal on one (armed in ``cap_dir``) and off on the other,
    a flush each a step in alternating turns: the one that went second
    goes first at the next step. The singles are submitted before the
    groups: the replay submits a chunk's singles first, and so registers
    the node rows in the same order. Returns the two :class:`_CapRun`
    (on, off), each with its (counters, states) as ``.end``."""
    rng = np.random.default_rng(seed)
    p = _zipf_p()
    on, off = _CapRun(cap_dir), _CapRun(None)
    for step in range(CAP_STEPS):
        now = 1000 + step * 100
        stream = _cap_stream(rng, p, step, now)
        for run in ((on, off) if step % 2 == 0 else (off, on)):
            run.step(step, now, stream)
    on.end, off.end = on.finish(), off.finish()
    return on, off


def _stream_prefix(decoded: dict, chunks: int) -> dict:
    """A decoded capture up to its ``chunks``-th chunk, with the rule
    timeline before it."""
    stream, n = [], 0
    for kind, item in decoded["stream"]:
        if kind == "chunk":
            if n == chunks:
                break
            n += 1
        stream.append((kind, item))
    return dict(decoded, stream=stream)


def replay_capture_cpu(cap_dir: str, chunks: int):
    """(b)'s CPU replay, in a worker: the first ``chunks`` chunks of the
    capture of (a) verified through the port's replay on the CPU engine.
    Returns (the report, seconds, whether this process set CUDA up)."""
    from sentinel_tpu_torch.runtime import replay

    decoded = _stream_prefix(replay.load_capture(cap_dir), chunks)
    t0 = time.perf_counter()
    report = replay.verify(decoded, device="cpu")
    return report, time.perf_counter() - t0, torch.cuda.is_initialized()


def _cap_frozen(cap_dir: str, reason: str) -> list:
    from sentinel_tpu_torch.runtime import capture as tcap

    paths = [os.path.join(cap_dir, f) for f in sorted(os.listdir(cap_dir)) if f.startswith(f"frozen-{reason}-")]
    if not paths:
        fail(f"phase 4k: no frozen-{reason}-* segment in {cap_dir}")
    decoded = tcap.decode_capture(paths)
    return [ck for k, ck in decoded["stream"] if k == "chunk"]


def _cap_freeze_triggers(cap_dir: str) -> str:
    """(c): a shed streak through the valve, a manual freeze and a DEGRADED
    transition through the fault injector (a failed copy back, as phase
    4g's plan), on one card engine; each leaves frozen segments whose
    chunks decode."""
    import shutil

    from sentinel_tpu_torch.testing.faults import FaultInjector

    shutil.rmtree(cap_dir, ignore_errors=True)
    clock = tclock.ManualClock(1000)
    eng = _fresh_engine(DEV, _cap_settings(cap_dir, INGEST_MAX_PENDING=64, CAPTURE_SHED_STREAK=32,
                                           FAILOVER_ENABLED="true", FAILOVER_RETRY_MS=10**9), clock)
    st.flow_rule_manager.load_rules([st.FlowRule(f"r{i}", count=20) for i in range(64)])
    for step in range(3):
        eng.submit_bulk(f"r{step}", 100, ts=clock.now_ms())
        for j in range(32):
            eng.submit_entry(f"r{j}")
        eng.flush()
        clock.advance(100)
    ops = [eng.submit_entry("r1") for _ in range(64 + 40)]  # past the bound of 64: 40 sheds
    shed = sum(1 for o in ops if o.verdict is not None and o.verdict.reason == 8)
    eng.flush()
    eng.capture.freeze("manual")
    eng.submit_bulk("r3", 50, ts=clock.now_ms())
    eng.flush()
    inj = FaultInjector().install(eng)
    inj.fail_fetch(eng.flush_seq + 1)
    op = eng.submit_entry("r2")
    eng.flush()
    degraded = op.verdict.degraded and eng.failover.state == "DEGRADED"
    inj.clear()
    snap = eng.capture.snapshot()
    eng.close()
    if shed != 40 or not degraded:
        fail(f"phase 4k (c): {shed} sheds (40 expected), degraded {degraded}")
    got = {r: len(_cap_frozen(cap_dir, r)) for r in ("shed", "degraded", "manual")}
    if snap["counters"]["freezes"] != 3 or min(got.values()) == 0:
        fail(f"phase 4k (c): freezes {snap['counters']['freezes']}, frozen chunks {got}")
    return f"freezes {snap['counters']['freezes']}, chunks in the frozen segments by reason {got}"


def _cap_engine(settings: dict, clock):
    """An engine of its own on the card (not the API's: ``api.reset``
    closes the engine before)."""
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.utils.config import config

    for key, value in settings.items():
        config.set(key, value)
    try:
        return Engine(clock=clock, device=DEV)
    finally:
        config.reset()


def _cap_death(cap_dir: str) -> str:
    """(d): a journal's live segments left unclosed, as a killed process
    leaves them; a new journal on the directory renames them
    frozen-death-*, and they decode and replay on the card."""
    import shutil

    from sentinel_tpu_torch.runtime import replay

    shutil.rmtree(cap_dir, ignore_errors=True)
    clock = tclock.ManualClock(1000)
    dead = _cap_engine(_cap_settings(cap_dir), clock)
    dead.set_flow_rules([st.FlowRule(f"r{i}", count=30) for i in range(64)])
    for step in range(6):
        for i in range(64):
            dead.submit_bulk(f"r{i}", 8 + i, ts=clock.now_ms())
        dead.flush()
        clock.advance(100)
    live = [f for f in os.listdir(cap_dir) if f.startswith("seg-")]
    nxt = _cap_engine(_cap_settings(cap_dir), tclock.ManualClock(0))  # the next boot
    death = [f for f in os.listdir(cap_dir) if f.startswith("frozen-death-")]
    nxt.close()
    if not live or len(death) != len(live):
        fail(f"phase 4k (d): {len(live)} live segments, {len(death)} kept as frozen-death-*")
    from sentinel_tpu_torch.runtime import capture as tcap

    decoded = tcap.decode_capture([os.path.join(cap_dir, f) for f in sorted(death)])
    report = replay.verify(decoded, device=DEV)
    dead.close()
    if report["diffs"] or report["compared"] != report["rows"] or report["rows"] == 0:
        fail(f"phase 4k (d): the dead boot's replay {report}")
    return f"{len(death)} segment(s) kept as frozen-death-*, {report['rows']:,} rows replayed on the card, 0 diffs"


def phase4_capture(results: dict, cpu_jobs: dict) -> None:
    import shutil

    from sentinel_tpu_torch.runtime import replay

    log(f"phase 4k: the capture journal and its replay on the card (the slot chain's stream with Zipf hot-param args, "
        f"{CAP_STEPS} flushes of {FLUSH_N:,} on two engines, the journal on and off in turns, a reload; "
        f"{card_line()})")
    t_phase = time.perf_counter()
    shutil.rmtree(CAP_DIR, ignore_errors=True)
    cap_dir = os.path.join(CAP_DIR, "cap")
    # (a) the journal on against off, a flush each in alternating turns; the
    # launch counters are set to 0 here and each engine's share is counted
    for w, attr in CAP_COUNTERS.values():
        setattr(w, attr, 0)
    t0 = time.perf_counter()
    on, off = drive_capture_pair(51, cap_dir)
    log(f"  (a) {CAP_STEPS} flushes on each engine in {time.perf_counter() - t0:.1f} s")
    cpu_jobs["4k b"] = WORKERS.apply_async(replay_capture_cpu, (cap_dir, CAP_CPU_CHUNKS))

    def flat(records):  # the bulk columns of a run in one array each, and the singles' records
        return ([np.concatenate([r for r in records[k::3] if r.dtype != object]) for k in range(3)],
                [r.tolist() for r in records if r.dtype == object])

    have, want = flat(on.records), flat(off.records)
    if len(on.records) != len(off.records) or have[1] != want[1] or any(
            not np.array_equal(a, b) for a, b in zip(have[0], want[0])):
        fail("phase 4k (a): verdicts, reasons or wait_ms differ with the journal on and off")
    _same_states(on.end[1], off.end[1], "phase 4k (a), the journal on against off")
    log(f"  (a) launches with the journal on: {on.launches}; off: {off.launches}")
    for name, c in on.launches.items():
        if c <= 0:
            fail(f"phase 4k (a): kernel {name} was not launched with the journal on")
        results[name]["launches_4k"] = c
    results["thread_gauge"]["launches_4k"] = on.launches["window_update"]
    n_groups = sum(1 for r in off.records if r.dtype != object) // 3
    adm = sum(int(r.sum()) for r in off.records if r.dtype == bool)
    c = on.end[0]
    note = np.array(on.note_ms)
    for run in (on, off):
        extra = ""
        if run.on:
            extra = (f"; note_chunk median {np.median(note):.3f} ms a flush ({np.median(note) / (n_groups / CAP_STEPS) * 1e3:.2f} "
                     f"us a bulk group), journal {c}, {c['bytes'] / CAP_STEPS / 2**20:.2f} MiB a flush")
        log(f"  (a) journal {'on ' if run.on else 'off'}: a flush call median {np.median(run.calls):.3f} ms "
            f"({min(run.calls):.3f}-{max(run.calls):.3f}); {split_line(run.splits)}{extra}")
    log(f"  (a) verdicts, reasons, wait_ms, attribution and every state tensor identical with the journal on and off "
        f"({n_groups:,} bulk groups, {adm:,} admitted rows)")
    # (b) replay on the card at depths 0 and 2, and a prefix on the CPU in a worker
    t0 = time.perf_counter()
    decoded = replay.load_capture(cap_dir)
    load_s = time.perf_counter() - t0
    rows = sum(ck.rows for ck in decoded["chunks"].values())
    for depth in (0, 2):
        flush.flow_admission.launches = 0
        t0 = time.perf_counter()
        report = replay.verify(decoded, depth=depth, device=DEV)
        took = time.perf_counter() - t0
        if report["diffs"] or report["compared"] != report["rows"] or report["chunks"] != CAP_STEPS or \
                flush.flow_admission.launches == 0:
            fail(f"phase 4k (b): the replay on the card at depth {depth}: {report} "
                 f"(K4 {flush.flow_admission.launches} launches)")
        log(f"  (b) replay on the card, depth {depth}: {report['chunks']} chunks, {report['compared']:,} rows "
            f"compared, 0 diffs, {took:.2f} s ({rows / took:,.0f} rows/s, the diff included; decode {load_s:.2f} s), "
            f"K4 {flush.flow_admission.launches} launches")
    report, took, cuda_up = cpu_result(cpu_jobs, "4k b")
    if report["diffs"] or report["compared"] != report["rows"] or report["chunks"] != CAP_CPU_CHUNKS or cuda_up:
        fail(f"phase 4k (b): the CPU replay {report}, CUDA in the worker {cuda_up}")
    log(f"  (b) replay on the CPU engine in a worker, the first {report['chunks']} chunks: {report['compared']:,} rows "
        f"compared, 0 diffs, {took:.2f} s ({report['rows'] / took:,.0f} rows/s); no CUDA in the worker")
    # (c) the freeze triggers; (d) the death sweep
    t0 = time.perf_counter()
    log(f"  (c) {_cap_freeze_triggers(os.path.join(CAP_DIR, 'triggers'))} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    log(f"  (d) {_cap_death(os.path.join(CAP_DIR, 'death'))} ({time.perf_counter() - t0:.1f} s)")
    apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.split()
    if len(apps) > 1:
        fail(f"phase 4k: {len(apps)} processes hold a CUDA context")
    log(f"  nvidia-smi's compute processes: {len(apps)}; phase 4k took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 4l: the engine supervisor, warm standby and planned handoff (ipc/supervise.py)
# ---------------------------------------------------------------------------
SUP_STEPS = 2  # (a): steps of FLUSH_N over the four workers before the kill (3 before its cuts)
SUP_KILL_LOOP_S = 0.5  # (a), (c): worker 0 loops bulk(res, 256) this long around each kill (1.5 s before its cuts)
# The loop's calls wait at most this long: a frame in flight when the engine
# dies is answered by no engine, and a takeover faster than the client's
# death check leaves its caller waiting out the timeout (as in JAX).
SUP_KILL_LOOP_TIMEOUT_MS = 1000
SUP_REPORT_S = 0.1  # how often each engine child rewrites its report
SUP_HOLD = 40  # (c): THREAD-grade admissions held across the cold restart
SUP_PROBE = "sup-probe"  # a resource with no rule: the smoke's own probe client (slot 4)
SUP_PROBE_N = 97  # a THREAD probe of the rule's count (96) and one more
SUP_TS = 1000 + 100 * SUP_STEPS  # the THREAD probes' ts (their verdicts do not read it)
SUP_DIR = os.path.join(ROOT, "build", "phase4l")
# Loose enough for a box whose CPUs the CPU references share: the phase pins
# the takeover, the handoff and the restart, not the detection latency.
SUP_SETTINGS = {"IPC_HEARTBEAT_MS": 50, "IPC_ENGINE_DEAD_MS": 500, "IPC_ENGINE_DEAD_CONFIRM_MS": 1000,
                "IPC_WORKER_DEAD_MS": 60000, "IPC_HANDOFF_WAIT_MS": 30000, "IPC_SLOT_BYTES": IPC_SLOT_BYTES_A,
                "SUPERVISE_BACKOFF_MS": 200, "SUPERVISE_STANDBY": "true", "SUPERVISE_STANDBY_WARM_MS": 1000,
                "FAILOVER_ENABLED": "true", "FAILOVER_CHECKPOINT_EVERY": 2, "TRACE_ENABLED": "false"}


def _sup_rules() -> dict:
    """``_ipc_engine``'s rules, in its order, as ``ipc_procs.rules_setup``
    takes them."""
    return {"qps_rules": N_RULES, "qps_count": 20,
            "flow": [(IPC_THREAD, 96, C.FLOW_GRADE_THREAD), (IPC_KILL, 1000, C.FLOW_GRADE_THREAD)],
            "param": [(IPC_PARAM, 0, 4)]}


def _sup_thread(kind: str, n: int) -> list:
    """Worker 2's THREAD-grade steps: one bulk of ``n``, or ``n`` exits."""
    if kind == "bulk":
        return [{"kind": "bulk", "resource": IPC_THREAD, "n": n, "ts": np.full(n, SUP_TS, np.int64),
                 "timeout_ms": 120000}]
    return [{"kind": "exit", "resource": IPC_THREAD, "ts": SUP_TS, "rt": 1} for _ in range(n)]


def _sup_thread_plan() -> list:
    """The THREAD-grade steps after the first SUP_STEPS steps: (a) the probe after the takeover, the exits
    of every live admission, the gauges-are-0 probe and its exits; (c) a
    group held across the cold restart, the probe after it, the exits, the
    gauges-are-0 probe and its exits. Each probe admits up to the count:
    how many is for the engine to say, so the exits follow the answers."""
    return [("bulk", SUP_PROBE_N, "a probe"), ("exit_live", 0, "a quiesce"), ("bulk", SUP_PROBE_N, "a gauges"),
            ("exit_live", 0, "a exits"), ("bulk", SUP_HOLD, "c hold"), ("bulk", SUP_PROBE_N, "c probe"),
            ("exit_live", 0, "c quiesce"), ("bulk", SUP_PROBE_N, "c gauges"), ("exit_live", 0, "c exits")]


def drive_supervised_oracle(device: torch.device, seed: int):
    """Phase 4l's never-killed reference: the port's engine in this process
    (``_ipc_engine``, depth 0, no speculative tier) fed the same requests
    as the supervised run: SUP_STEPS steps of the four workers' scripts and
    their completions, then worker 2's THREAD-grade plan. Returns the
    admissions worker 2 holds after the steps and the plan's answers by
    label."""
    p = (np.arange(1, IPC_OWN + 1, dtype=np.float64) ** -1.1)
    p /= p.sum()
    rngs = [np.random.default_rng([seed, w]) for w in range(IPC_WORKERS)]
    exit_rngs = [np.random.default_rng([seed, w, 1]) for w in range(IPC_WORKERS)]
    clock = tclock.ManualClock(0)
    eng = _ipc_engine(device, clock, PIPELINE_DEPTH=0, SPECULATIVE_ENABLED="false", TRACE_ENABLED="false")
    held = 0
    for s in range(SUP_STEPS):
        now = 1000 + 100 * s
        clock.set_ms(now)
        scripts = [ipc_step(rngs[w], w, now, p) for w in range(IPC_WORKERS)]
        answers = [_ipc_oracle_run(eng, scripts[w], False) for w in range(IPC_WORKERS)]
        exits = [ipc_exits(exit_rngs[w], scripts[w], answers[w], now) for w in range(IPC_WORKERS)]
        for w in range(IPC_WORKERS):
            _ipc_oracle_run(eng, exits[w], False)
        held += _sup_held(scripts[2], answers[2], exits[2])
        eng.flush()
        eng.drain()
    clock.set_ms(SUP_TS)
    out, live = {}, held
    for kind, n, label in _sup_thread_plan():
        if kind == "exit_live":
            _ipc_oracle_run(eng, _sup_thread("exit", live), False)
            live = 0
            continue
        ans = _ipc_answer(_ipc_oracle_run(eng, _sup_thread("bulk", n), False)[0])
        live += sum(ans[1])
        out[label] = ans
    eng.close()
    return held, out


def _sup_held(script: list, answers: list, exits: list) -> int:
    """The THREAD-grade admissions a worker still holds after one step."""
    adm = sum(sum(a[1]) for st_, a in zip(script, answers) if a[0] == "bulk" and st_["resource"] == IPC_THREAD)
    return adm - sum(1 for x in exits if x["resource"] == IPC_THREAD)


def _sup_ask(cmd_qs, out_q, cmds: list, tag: str) -> dict:
    """Send ``(worker, command)`` pairs; the answers by worker."""
    for w, cmd in cmds:
        cmd_qs[w].put(cmd)
    got = {}
    for _ in cmds:
        ans = out_q.get(timeout=300)
        if ans[0] != tag:
            fail(f"phase 4l: worker {ans[1]} answered {ans[0]} to {tag}")
        if ans[-1]:
            fail(f"phase 4l: worker {ans[1]} set up CUDA")
        got[ans[1]] = ans
    return got


def _sup_reports(report_dir: str, served: dict, want: str) -> str:
    """Each serving child's device and its K2, K4, K10 launches since it
    attached; fails unless it ran on ``want`` and launched K4 (the plain
    versions launch nothing: a CPU rehearsal checks the device alone)."""
    from sentinel_tpu_torch.testing import ipc_procs

    pids = list(served.values())
    deadline = time.monotonic() + 5.0
    while True:
        reps = ipc_procs.read_reports(report_dir)
        missing = [pid for pid in pids if pid not in reps or reps[pid]["launches_attached"]["flow_admission"] <= 0]
        if not missing or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    parts = []
    for role, pid in served.items():
        rep = reps.get(pid)
        if rep is None:
            fail(f"phase 4l {what}: child {pid} wrote no report")
        la = rep["launches_attached"]
        if rep["device"] != want or (want.startswith("cuda") and la["flow_admission"] <= 0):
            fail(f"phase 4l: serving child {pid} ran on {rep['device']} with K4 {la['flow_admission']} launches "
                 f"while attached")
        parts.append(f"{role} (pid {pid}) on {rep['device']}: K2 {la['window_update']}, K4 {la['flow_admission']}, "
                     f"K10 {la['run_param']} launches while serving")
    return "; ".join(parts)


@contextlib.contextmanager
def _light_spawn_main():
    """Spawned children re-run the parent's ``__main__`` as ``__mp_main__``,
    and this script's top level imports the whole port and gpu_timing, some
    seconds a child on a loaded host. The supervisor's children need none of
    it (their targets live in the package), so while phase 4l runs they
    start from ``testing/ipc_procs`` instead, as if this script had been run
    with ``-m`` (``multiprocessing.spawn`` reads ``__main__.__spec__``)."""
    import importlib.util

    main = sys.modules["__main__"]
    saved = main.__dict__.get("__spec__")
    main.__spec__ = importlib.util.find_spec("sentinel_tpu_torch.testing.ipc_procs")
    try:
        yield
    finally:
        main.__spec__ = saved


def _device_used_mib(device) -> float:
    """The card's memory in use by every process, in MiB (inside a container's
    PID namespace nvidia-smi names no process by its pid and its per-process
    figures cannot be told apart)."""
    if device is not None and torch.device(device).type != "cuda":
        return 0.0
    free, total = torch.cuda.mem_get_info()
    return (total - free) / 2**20


def _gpu_apps(query: str = "pid") -> list:
    return [line.strip() for line in subprocess.run(
        ["nvidia-smi", f"--query-compute-apps={query}", "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.splitlines() if line.strip()]


def phase4_supervise(results: dict, cpu_jobs: dict, device=None) -> None:
    """Phase 4l on ``device`` (None: the card; "cpu" rehearses it where there
    is none)."""
    import shutil

    from sentinel_tpu_torch.ipc import supervise
    from sentinel_tpu_torch.ipc.worker import IngestClient
    from sentinel_tpu_torch.testing import ipc_procs
    from sentinel_tpu_torch.utils.config import config

    log(f"phase 4l: the engine supervisor, a warm standby and a planned handoff on the card ({IPC_WORKERS} supervised "
        f"workers, {N_RULES:,} rules, {FLUSH_N:,} entries a step; {card_line()}; load average {os.getloadavg()}, "
        f"{threading.active_count()} threads in this process)")
    t_phase = time.perf_counter()

    def at() -> str:
        return f"[t+{time.perf_counter() - t_phase:.1f} s]"

    shutil.rmtree(SUP_DIR, ignore_errors=True)
    report_dir = os.path.join(SUP_DIR, "reports")
    os.makedirs(report_dir)
    ckpt = f"/dev/shm/stpu-4l-{os.getpid()}.bin"
    with contextlib.suppress(OSError):
        os.unlink(ckpt)
    for key, value in SUP_SETTINGS.items():
        config.set(getattr(config, key), str(value))
    config.set(config.FAILOVER_CKPT_PATH, ckpt)
    sup = cli = None
    procs, cmd_qs, out_q = [], [], None
    used0 = _device_used_mib(device)
    with _light_spawn_main():
        try:
            sup = supervise.EngineSupervisor(setup=ipc_procs.launch_report_setup, setup_args=(report_dir, _sup_rules(), SUP_REPORT_S),
                                             n_workers=IPC_WORKERS + 1, device=device)
            ctx = sup.spawn_context()
            out_q = ctx.Queue()
            for w in range(IPC_WORKERS):
                cmd_qs.append(ctx.Queue())
                procs.append(sup.spawn_worker(ipc_procs.serve_worker_mode, w, (cmd_qs[w], out_q)))
            if not sup.wait_engine_up(120):
                fail("phase 4l: the supervised engine never came up")
            t_up = time.perf_counter() - t_phase
            if not sup.wait_standby_ready(120):
                fail("phase 4l: the standby never reported warm")
            t_ready = time.perf_counter() - t_phase
            _sup_ask(cmd_qs, out_q, [(w, ("counters",)) for w in range(IPC_WORKERS)], "counters")
            primary, standby = sup.engine_pid(), sup.standby_pid()
            reps = ipc_procs.read_reports(report_dir)
            log(f"  {at()} the primary up {t_up:.1f} s, the standby warm {t_ready:.1f} s (warm boot "
                f"{sup._standby['warm_ms']:.0f} ms in the child) and {IPC_WORKERS} workers attached "
                f"{time.perf_counter() - t_phase:.1f} s after the supervisor started; the children's age when their "
                f"setup began {reps[primary]['age_at_setup_s']:.1f} and {reps[standby]['age_at_setup_s']:.1f} s, the "
                f"setup {reps[primary]['setup_s']:.2f} and {reps[standby]['setup_s']:.2f} s; load average "
                f"{os.getloadavg()}, {threading.active_count()} threads in this process")
            apps = _gpu_apps("pid,used_memory")
            log(f"  {at()} the standby's sizing: the card's memory in use rose "
                f"{_device_used_mib(device) - used0:,.0f} MiB with the primary and the standby up (their contexts and "
                f"engines); their allocators hold {reps[primary]['reserved_mib']:,.1f} and "
                f"{reps[standby]['reserved_mib']:,.1f} MiB; nvidia-smi's compute processes beside this one "
                f"({os.getpid()}; primary {primary}, standby {standby}): {apps}")
            cli = IngestClient(sup.handles.channel(IPC_WORKERS), IPC_WORKERS)
            supervise.probe_live(cli, SUP_PROBE, 60, 3000)
            own = [[f"r{w * IPC_OWN + i}" for i in range(IPC_OWN)] for w in range(IPC_WORKERS)]

            def primary_drains():
                time.sleep(1.5 * SUP_REPORT_S)  # a report written after the plane went idle
                return ipc_procs.read_reports(report_dir)[sup.engine_pid()]["drains"]

            d0 = primary_drains()
            g = _sup_ask(cmd_qs, out_q, [(0, ("loop_bulk", own[0], 256, IPC_LOOP_S, 41))], "loop_bulk")[0]
            drains = primary_drains() - d0
            log(f"  {at()} the standby's sizing: the primary's bulk(res, 256) loop from 1 worker with the standby "
                f"parked: {g[3] / IPC_LOOP_S:,.0f} requests/s, {drains / IPC_LOOP_S:,.1f} drains/s (phase 4j (c) in "
                f"this run: {IPC_DRAINS_PER_S.get('bulk, 1 worker', float('nan')):,.1f} drains/s, no standby)")
            oracle_held, oracle = cpu_result(cpu_jobs, "4l")

            # (a) SUP_STEPS steps, then kill -9 the primary under load
            p = (np.arange(1, IPC_OWN + 1, dtype=np.float64) ** -1.1)
            p /= p.sum()
            rngs = [np.random.default_rng([61, w]) for w in range(IPC_WORKERS)]
            exit_rngs = [np.random.default_rng([61, w, 1]) for w in range(IPC_WORKERS)]
            held = 0
            t0 = time.perf_counter()
            for s in range(SUP_STEPS):
                now = 1000 + 100 * s
                scripts = [ipc_step(rngs[w], w, now, p) for w in range(IPC_WORKERS)]
                got = _sup_ask(cmd_qs, out_q, [(w, ("script", scripts[w])) for w in range(IPC_WORKERS)], "script")
                for w in range(IPC_WORKERS):
                    if any(a[0] == "bulk" and any(f & 2 for f in a[4]) or a[0] == "entry" and a[5] for a in got[w][2]):
                        fail(f"phase 4l (a): worker {w} was policy-served before the kill")
                answers = [[_ipc_answer(a) for a in got[w][2]] for w in range(IPC_WORKERS)]
                exits = [ipc_exits(exit_rngs[w], scripts[w], answers[w], now) for w in range(IPC_WORKERS)]
                _sup_ask(cmd_qs, out_q, [(w, ("script", exits[w])) for w in range(IPC_WORKERS)], "script")
                held += _sup_held(scripts[2], answers[2], exits[2])
            steps_s = time.perf_counter() - t0
            if held != oracle_held:
                fail(f"phase 4l (a): worker 2 holds {held} THREAD-grade admissions, the CPU engine {oracle_held}")
            # The standby's last re-warm, read after the steps: the durable file
            # holds their checkpoints by now.
            deadline = time.monotonic() + 10
            while sup.standby_rewarm_ms is None and time.monotonic() < deadline:
                time.sleep(0.05)
            log(f"  {at()} the standby's sizing: one re-warm (restore_durable in the parked standby) "
                f"{sup.standby_rewarm_ms:.1f} ms, every {SUP_SETTINGS['SUPERVISE_STANDBY_WARM_MS']} ms")
            served = {"(a) the primary": primary}

            def kill_under_load(what: str) -> dict:
                cmd_qs[0].put(("loop_bulk", own[0], 256, SUP_KILL_LOOP_S, 43, SUP_KILL_LOOP_TIMEOUT_MS))
                time.sleep(0.2)
                # The serving child's report written after the loop began (its
                # launches die with it).
                pid, t_mark = sup.engine_pid(), time.time()
                deadline = time.monotonic() + 5
                while ipc_procs.read_reports(report_dir).get(pid, {}).get("t", 0) <= t_mark:
                    if time.monotonic() > deadline:
                        fail(f"phase 4l ({what}): the serving child {pid} wrote no report")
                    time.sleep(0.02)
                out = supervise.measure_kill_outage(sup, cli, SUP_PROBE, 60, 3000)
                loop = out_q.get(timeout=300)
                if loop[0] != "loop_bulk":
                    fail(f"phase 4l ({what}): worker 0 answered {loop[0]}")
                out["loop"] = f"{loop[2]} calls, the longest {max(loop[4]):.0f} ms"
                return out

            def reconnected(want: int, what: str) -> None:
                deadline = time.monotonic() + 30
                while True:
                    got = _sup_ask(cmd_qs, out_q, [(w, ("counters",)) for w in range(IPC_WORKERS)], "counters")
                    counts = [got[w][2]["reconnects"] for w in range(IPC_WORKERS)]
                    if min(counts) >= want:
                        return
                    if time.monotonic() > deadline:
                        fail(f"phase 4l ({what}): worker reconnects {counts}, want {want} each")
                    time.sleep(0.1)

            def thread_plan(*labels) -> None:
                nonlocal live
                for kind, n, label in _sup_thread_plan():
                    if label not in labels:
                        continue
                    if kind == "exit_live":
                        _sup_ask(cmd_qs, out_q, [(2, ("script", _sup_thread("exit", live)))], "script")
                        live = 0
                        continue
                    raw = _sup_ask(cmd_qs, out_q, [(2, ("script", _sup_thread("bulk", n)))], "script")[2][2][0]
                    if any(f & 2 for f in raw[4]):
                        fail(f"phase 4l ({label}): the THREAD-grade group was policy-served")
                    ans = _ipc_answer(raw)
                    if ans != oracle[label]:
                        fail(f"phase 4l ({label}): {sum(ans[1])} of {n} admitted, the never-killed CPU engine "
                             f"{sum(oracle[label][1])}")
                    live += sum(ans[1])
                    if label.endswith("gauges") and sum(ans[1]) != 96:
                        fail(f"phase 4l ({label}): {sum(ans[1])} admitted after quiesce, not the count 96")

            live = held
            out_a = kill_under_load("a")
            served["(a) the standby, to (b)"] = sup.engine_pid()
            if sup.standby_takeovers != 1 or sup.restarts != 0:
                fail(f"phase 4l (a): takeovers {sup.standby_takeovers}, restarts {sup.restarts}")
            reconnected(1, "a")
            thread_plan("a probe", "a quiesce", "a gauges", "a exits")
            log(f"  {at()} (a) {SUP_STEPS} steps ({steps_s:.1f} s; worker 2 holds {held} THREAD-grade admissions), "
                f"then kill -9 of the primary under a bulk loop ({out_a['loop']}): standby takeover, outage "
                f"{out_a['outage_ms']:.1f} ms, {out_a['policy_served']} policy-served probes, warm boot "
                f"{sup.standby_warm_boot_ms:.0f} ms off the outage path, attach {sup.standby_attach_ms:.1f} ms; "
                f"takeovers 1, restarts 0; every worker reconnected; THREAD-grade verdicts after it equal the "
                f"never-killed CPU engine's, {SUP_PROBE_N} after quiesce admit exactly 96")

            # (b) a planned handoff under continuous probing
            if not sup.wait_standby_ready(120):
                fail("phase 4l (b): the next standby never reported warm")
            t0 = time.perf_counter()
            out_b = supervise.probe_through_handoff(sup, cli, SUP_PROBE, 60, 30000)
            served["(b) the next standby, to (c)"] = sup.engine_pid()
            if out_b["handoffs"] != 1 or out_b["policy_served"] or out_b["not_admitted"] or sup.standby_takeovers != 1:
                fail(f"phase 4l (b): {out_b}")
            reconnected(2, "b")
            log(f"  {at()} (b) planned handoff under continuous probing: worst verdict gap "
                f"{out_b['handoff_outage_ms']:.1f} ms, 0 policy-served, 0 not admitted, handoffs 1, warm boot "
                f"{out_b['standby_warm_boot_ms']:.0f} ms, attach {out_b['standby_attach_ms']:.1f} ms "
                f"({time.perf_counter() - t0:.1f} s); every worker reconnected")

            # (c) the standby killed, then the primary: a cold respawn on the backoff
            thread_plan("c hold")
            sb_pid = sup.kill_standby()
            out_c = kill_under_load("c")
            served["(c) the cold respawn"] = sup.engine_pid()
            if sup.restarts != 1 or sup.standby_takeovers != 1 or sup.handoffs != 1:
                fail(f"phase 4l (c): restarts {sup.restarts}, takeovers {sup.standby_takeovers}, "
                     f"handoffs {sup.handoffs}")
            reconnected(3, "c")
            thread_plan("c probe", "c quiesce", "c gauges", "c exits")
            log(f"  {at()} (c) the standby ({sb_pid}) killed, then the primary under a bulk loop ({out_c['loop']}): "
                f"cold respawn on the backoff, outage {out_c['outage_ms']:.1f} ms, {out_c['policy_served']} "
                f"policy-served probes; restarts 1; every worker reconnected; THREAD-grade verdicts after it equal "
                f"the never-killed CPU engine's, {SUP_PROBE_N} after quiesce admit exactly 96")
            log(f"  {at()} serving children: {_sup_reports(report_dir, served, device or 'cuda:0')}")
            reps = ipc_procs.read_reports(report_dir)
            for name in ("window_update", "flow_admission", "run_param"):
                results[name]["launches_4l"] = sum(reps[pid]["launches_attached"][name] for pid in served.values())
            results["thread_gauge"]["launches_4l"] = results["window_update"]["launches_4l"]
        finally:
            if cli is not None:
                cli.close()
            for q in cmd_qs:
                q.put(("stop",))
            for pr in procs:
                pr.join(10)
            if sup is not None:
                sup.stop()
            config.reset()
            with contextlib.suppress(OSError):
                os.unlink(ckpt)
    deadline = time.monotonic() + 30
    while len(_gpu_apps()) > 1 and time.monotonic() < deadline:
        time.sleep(0.2)
    apps = _gpu_apps()
    left = [n for n in os.listdir("/dev/shm") if n.startswith(sup.prefix)]
    if len(apps) > 1 or left:
        fail(f"phase 4l: after stop() {len(apps)} processes hold a CUDA context, segments left {left}")
    log(f"  {at()} stop(): no child alive, nvidia-smi's compute processes {len(apps)}, the card's memory in use "
        f"{_device_used_mib(device) - used0:+,.0f} MiB against the phase's start, no segment of '{sup.prefix}' left "
        f"in /dev/shm; phase 4l took {time.perf_counter() - t_phase:.1f} s ({card_line()})")


# ---------------------------------------------------------------------------
# phase 4m: the control surface (ROADMAP item 11, part 1): custom slots from
# the SPI registry, the command center, the file datasource, the heartbeat
# and the sequential oracle, on the card
# ---------------------------------------------------------------------------
CS_STEPS = 40  # (a): flushes of FLUSH_N, 100 ms each, on the card and on the CPU engine in lockstep
CS_SCRAPE_EVERY = 10  # (b): the scrapes after every tenth flush
CS_RELOAD = 20  # (a): the file source reloads one rule in ten (count 20 -> 12) before this flush
CS_SINGLES = 32  # (a): single entries a flush, on r0-r31 from three origins, every fourth "unpaid"
CS_ACQ2 = 0.25  # (a): the share of bulk rows of acquire 2
CS_ORACLE_N = 600  # (e): single entries of the oracle stream
CS_DIR = os.path.join(ROOT, "build", "phase4m")
CS_SCRAPES = (("metrics", {}), ("metrics", {"format": "openmetrics"}), ("clusterNode", {}), ("tree", {}),
              ("origin", {"id": "r0"}))
# The scrape lines that carry host timings (wall clocks of the flushes and
# spills), not compared between the card and the CPU engine.
CS_HOST_TIMED = tuple(f"sentinel_engine_{h}_{s}" for h in ("flush_duration_ms", "drain_duration_ms",
                                                           "e2e_duration_ms", "admission_latency_ms")
                      for s in ("bucket", "sum")) + tuple(
    f"sentinel_engine_last_flush_{s}" for s in ("encode_ms", "dispatch_ms", "kernel_ms", "drain_ms")) + (
    "sentinel_engine_checkpoint_durable_age_ms", "sentinel_engine_checkpoint_durable_write_ms",
    "sentinel_engine_ingest_estimate_ms", "sentinel_cluster_rpc_ms_bucket", "sentinel_cluster_rpc_ms_sum")
# The staging pool's counts, not compared either: on the card each chunk
# also takes a pinned set for its copy back, which the CPU engine has none of.
CS_DEVICE_POOLED = ("sentinel_engine_arena_hits_total", "sentinel_engine_arena_misses_total")


def _cs_slots():
    """Phase 4m's two slots (core/slots.py): ``paywall`` vetoes bulk entries
    of acquire 2 on every 16th resource and singles whose first arg is
    "unpaid", and records its calls and the exits it sees; ``flaky`` raises
    on r7 (the chain fails open)."""
    from sentinel_tpu_torch.core.slots import ProcessorSlot

    class Paywall(ProcessorSlot):
        name, order = "paywall", -10

        def __init__(self):
            self.calls, self.exits = [], []

        def entry(self, ctx):
            self.calls.append((ctx.resource, ctx.acquire, ctx.args))
            if ctx.args:
                return {"reason": "payment required"} if ctx.args[0] == "unpaid" else None
            if ctx.acquire == 2 and ctx.resource[1:].isdigit() and int(ctx.resource[1:]) % 16 == 0:
                return {"reason": "acquire 2"}
            return None

        def exit(self, resource, rt_ms, count, err):
            self.exits.append((resource, int(rt_ms), int(count), int(err)))

    class Flaky(ProcessorSlot):
        name, order = "flaky", 0

        def __init__(self):
            self.raised = 0

        def entry(self, ctx):
            if ctx.resource == "r7":
                self.raised += 1
                raise RuntimeError("phase 4m: a slot that fails")
            return None

    return Paywall(), Flaky()


def _cs_http(port: int, path: str, body: bytes = None, **params) -> tuple:
    """(status, body bytes, ms) of one command over loopback HTTP."""
    import urllib.error
    import urllib.parse
    import urllib.request

    qs = urllib.parse.urlencode(params)
    url = f"http://127.0.0.1:{port}/{path}" + (f"?{qs}" if qs else "")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, data=body, timeout=120) as resp:
            status, data = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, data = e.code, e.read()
    return status, data, (time.perf_counter() - t0) * 1e3


def _cs_comparable(text: str) -> list:
    """A scrape's lines but those of ``CS_HOST_TIMED`` and ``CS_DEVICE_POOLED``."""
    skip = CS_HOST_TIMED + CS_DEVICE_POOLED
    return [ln for ln in text.splitlines() if ln.startswith("#") or ln.split("{", 1)[0].split(" ", 1)[0] not in skip]


def _cs_verdict(v) -> tuple:
    rule = v.blocked_rule
    rule = rule.to_dict() if hasattr(rule, "to_dict") else rule
    return (bool(v.admitted), int(v.reason), int(v.wait_ms), v.limit_type, v.slot_name, json.dumps(rule,
                                                                                                 sort_keys=True))


def _cs_same_states(a, b, what: str) -> None:
    from sentinel_tpu_torch.runtime.failover import tree_leaves

    la, lb = tree_leaves(tuple(a)), tree_leaves(tuple(b))
    if len(la) != len(lb) or any(x.shape != y.shape or x.dtype != y.dtype or
                                 not np.array_equal(x.view(np.int32) if x.dtype == np.float32 else x,
                                                    y.view(np.int32) if y.dtype == np.float32 else y)
                                 for x, y in zip(la, lb)):
        fail(f"phase 4m: {what}: states differ")


def _cs_step(engines, rng, p, step: int, now: int, prev: list) -> list:
    """One flush of (a)'s stream on each engine: Zipf bulk groups with a
    quarter of the rows at acquire 2, the singles, the last step's exits
    (with their resources, so that the slots' exit traversal sees them).
    Returns, per engine, (its groups, its singles, the slot calls and exits
    of its flush, the flush call's seconds)."""
    res = rng.choice(N_RULES, size=FLUSH_N, p=p)
    ts = (now - rng.integers(0, 100, FLUSH_N)).astype(np.int32)
    acq = np.where(rng.random(FLUSH_N) < CS_ACQ2, 2, 1).astype(np.int32)
    order = np.argsort(res, kind="stable")
    res, ts, acq = res[order], ts[order], acq[order]
    uniq, start = np.unique(res, return_index=True)
    bounds = list(start) + [FLUSH_N]
    rts = rng.integers(1, 300, len(uniq))
    out = []
    for k, (eng, slot) in enumerate(engines):
        groups = [eng.submit_bulk(f"r{r}", int(bounds[i + 1] - bounds[i]), ts=np.sort(ts[bounds[i]:bounds[i + 1]]),
                                  acquire=acq[bounds[i]:bounds[i + 1]]) for i, r in enumerate(uniq)]
        singles = [eng.submit_entry(f"r{j}", origin=f"svc-{j % 3}", args=("unpaid" if j % 4 == 0 else "paid",),
                                    ts=now) for j in range(CS_SINGLES)]
        if prev:
            pg, ps = prev[k][0], prev[k][1]
            for g, rt in zip(pg[:50], rts):
                if g.admitted_count:
                    eng.submit_exit_bulk(g.rows, g.admitted_count, rt=int(rt), ts=now, resource=g.resource)
            for op in ps:
                if op.verdict.admitted:
                    eng.submit_exit(op.rows, rt=5, ts=now, resource=op.resource)
        c0, x0 = len(slot.calls), len(slot.exits)
        t0 = time.perf_counter()
        eng.flush()
        call_s = time.perf_counter() - t0
        out.append((groups, singles, slot.calls[c0:], slot.exits[x0:], call_s))
    return out


def _cs_scrapes(port: int, card, cpu, stats: dict, every_scrape_launches: list) -> None:
    """(b): each command of ``CS_SCRAPES`` over HTTP on the card's engine
    and then, through the same command center, on the CPU engine; the bodies
    equal but the host-timed lines. ``row_stats`` launches a card scrape
    into ``every_scrape_launches``; ms and bytes into ``stats``."""
    for path, params in CS_SCRAPES:
        tag = path + ("?" + "&".join(f"{k}={v}" for k, v in params.items()) if params else "")
        api.set_engine(card)
        l0 = nodes.rows_stats.launches
        status, body, ms = _cs_http(port, path, **params)
        every_scrape_launches.append(nodes.rows_stats.launches - l0)
        api.set_engine(cpu)
        status_c, body_c, _ = _cs_http(port, path, **params)
        api.set_engine(card)
        if status != 200 or status_c != 200:
            fail(f"phase 4m (b): /{tag} answered {status} on the card, {status_c} on the CPU engine")
        a, b = body.decode(), body_c.decode()
        if path == "metrics":
            a, b = _cs_comparable(a), _cs_comparable(b)
        if a != b:
            diff = next(((x, y) for x, y in zip(a if isinstance(a, list) else a.splitlines(),
                                                  b if isinstance(b, list) else b.splitlines()) if x != y), None)
            fail(f"phase 4m (b): /{tag} differs between the card and the CPU engine (first: {diff})")
        stats.setdefault(tag, []).append((ms, len(body)))


def _cs_lockstep(port: int, slot, file_src, rules_file) -> dict:
    """(a) and (b): ``CS_STEPS`` flushes on the card's engine (the global one,
    which the command center serves) and on a CPU engine in lockstep."""
    from sentinel_tpu_torch.core import errors as E
    from sentinel_tpu_torch.runtime.engine import Engine

    card = api.get_engine()
    card_clock = card.clock
    cpu_clock = tclock.ManualClock(0)
    cpu = Engine(clock=cpu_clock, device="cpu")
    cpu.set_flow_rules(st.flow_rule_manager.get_rules())
    rng = np.random.default_rng(71)
    ranks = np.arange(1, N_RULES + 1, dtype=np.float64) ** -1.1
    p = ranks / ranks.sum()
    wrappers = {"window_update": ma.update, "thread_gauge": nodes.thread_gauge_add,
                "flow_admission": flush.flow_admission, "row_stats": nodes.rows_stats}
    for w in wrappers.values():
        w.launches = 0
    prev, calls, custom, admitted, exits_seen = [], [], 0, 0, 0
    scrape_stats, scrape_launches = {}, []
    for step in range(CS_STEPS):
        now = 1000 + step * 100
        card_clock.set_ms(now)
        cpu_clock.set_ms(now)
        if step == CS_RELOAD:
            # One rule in ten reloads through the file source: the manager
            # pushes it into the card's engine; the CPU engine takes the same.
            new = [st.FlowRule(f"r{i}", count=12 if i % 10 == 0 else 20) for i in range(N_RULES)]
            with open(rules_file, "w") as f:
                json.dump([r.to_dict() for r in new], f)
            later = time.time() + 5
            os.utime(rules_file, (later, later))
            if not file_src.refresh():
                fail("phase 4m (a): the file source did not see the reload")
            got = st.flow_rule_manager.get_rules()
            if [r.to_dict() for r in got] != [r.to_dict() for r in new]:
                fail("phase 4m (a): the file source's reload did not reach the flow rules")
            cpu.set_flow_rules(got)
        steps = _cs_step([(card, slot), (cpu, slot)], rng, p, step, now, prev)
        (g_a, s_a, c_a, x_a, call_s), (g_b, s_b, c_b, x_b, _) = steps
        va = [_cs_verdict(op.verdict) for op in s_a]
        if va != [_cs_verdict(op.verdict) for op in s_b]:
            fail(f"phase 4m (a): flush {step}: the singles' verdicts differ between the card and the CPU engine")
        for ga, gb in zip(g_a, g_b):
            if not (np.array_equal(ga.admitted, gb.admitted) and np.array_equal(ga.reason, gb.reason)
                    and np.array_equal(ga.wait_ms, gb.wait_ms)):
                fail(f"phase 4m (a): flush {step}: the bulk verdicts of {ga.resource} differ")
        if c_a != c_b or x_a != x_b:
            fail(f"phase 4m (a): flush {step}: the slots saw other calls or exits on the card than on the CPU")
        _cs_same_states(_states_of(card), _states_of(cpu), f"(a) flush {step}")
        custom += sum(v[1] == E.BLOCK_CUSTOM for v in va) + sum(int((g.reason == E.BLOCK_CUSTOM).sum()) for g in g_a)
        admitted += sum(g.admitted_count for g in g_a)
        exits_seen += len(x_a)
        calls.append(call_s)
        prev = [(g_a, s_a), (g_b, s_b)]
        if step % CS_SCRAPE_EVERY == CS_SCRAPE_EVERY - 1:
            _cs_scrapes(port, card, cpu, scrape_stats, scrape_launches)
    counts = {name: w.launches for name, w in wrappers.items()}
    cpu.close()
    return dict(counts=counts, custom=custom, admitted=admitted, exits=exits_seen, calls=calls,
                scrapes=scrape_stats, scrape_launches=scrape_launches, card=card)


class _CsDashboard:
    """(d): an in-process dashboard on a loopback port that records each
    heartbeat's query and answers 200."""

    def __init__(self) -> None:
        import urllib.parse
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        beats = self.beats = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                beats.append((parsed.path, dict(urllib.parse.parse_qsl(parsed.query))))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def _cs_tier_engine(device, settings: dict):
    """An engine under a ManualClock at 1000, built with ``settings`` (config
    key names) on top of the runtime config, which is put back after."""
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.utils.config import config

    saved = config.runtime_snapshot()
    for key, value in settings.items():
        config.set(getattr(config, key), str(value))
    try:
        return Engine(clock=tclock.ManualClock(1000), device=device)
    finally:
        config.reset()
        for key, value in saved.items():
            config.set(key, value)


def _cs_health(port: int, slot) -> str:
    """(c) health: failover armed on the card and on a CPU engine, the
    slots registered, one injected launch fault (fail_dispatch) on each at
    the same flush; every verdict of the degraded fill, the slots' calls and
    the ``health`` answers equal."""
    from sentinel_tpu_torch.testing.faults import FaultInjector

    settings = {"FAILOVER_ENABLED": "true", "FAILOVER_CHECKPOINT_EVERY": 1, "FAILOVER_RETRY_MS": 10**9}
    engines = [_cs_tier_engine(DEV, settings), _cs_tier_engine("cpu", settings)]
    injectors = [FaultInjector().install(e) for e in engines]
    rng = np.random.default_rng(73)
    records = [[], []]
    for step in range(5):
        now = 1000 + 100 * step
        acq = [np.where(rng.random(24) < 0.5, 2, 1).astype(np.int32) for _ in range(4)]
        for k, (eng, inj) in enumerate(zip(engines, injectors)):
            eng.clock.set_ms(now)
            if step == 0:
                eng.set_flow_rules([st.FlowRule(f"r{i}", count=30) for i in range(64)])
            if step == 2:
                inj.fail_dispatch(eng.flush_seq + 1)
            groups = [eng.submit_bulk(f"r{16 * b}", 24, ts=now, acquire=acq[b]) for b in range(4)]
            singles = [eng.submit_entry(f"r{j}", args=("unpaid" if j % 2 else "paid",), ts=now) for j in range(8)]
            c0 = len(slot.calls)
            eng.flush()
            records[k].append(([_cs_verdict(op.verdict) + (op.verdict.degraded,) for op in singles],
                               [[x.tolist() for x in (g.admitted, g.reason, g.wait_ms)] for g in groups],
                               slot.calls[c0:]))
    if records[0] != records[1]:
        fail("phase 4m (c): with a launch fault the degraded fill's verdicts or the slots' calls differ between "
             "the card and the CPU engine")
    answers = []
    for eng in engines:
        api.set_engine(eng)
        status, body, _ = _cs_http(port, "health")
        d = json.loads(body)
        if status != 200 or d["state"] != "DEGRADED" or d["counters"]["trips"] != 1:
            fail(f"phase 4m (c): /health answered {status}: {body[:300]!r}")
        answers.append({k: v for k, v in d.items() if k not in ("checkpoint", "durable")})
    if answers[0] != answers[1]:
        fail("phase 4m (c): /health differs between the card and the CPU engine")
    customs = sum(v[1] == 6 for rec in records[0] for v in rec[0]) + sum(
        r == 6 for rec in records[0] for g in rec[1] for r in g[1])
    for inj, eng in zip(injectors, engines):
        inj.clear()
        eng.close()
    return (f"health: DEGRADED after one launch fault, trips 1; 5 flushes (3 degraded) with the slots: verdicts "
            f"(the degraded mark, {customs} BLOCK_CUSTOM), the slots' calls and /health equal the CPU engine's")


def _cs_commands(port: int, slot) -> list:
    """(c): capture, handoff, health and speculative on live tiers."""
    out = []
    card = api.get_engine()
    # capture: the journal on, a freeze on demand over HTTP
    cap_dir = os.path.join(CS_DIR, "cap")
    cap = _cs_tier_engine(DEV, {"CAPTURE_ENABLED": "true", "CAPTURE_DIR": cap_dir})
    cap.set_flow_rules([st.FlowRule("cap", count=5)])
    for k in range(3):
        cap.clock.set_ms(1000 + 100 * k)
        cap.submit_bulk("cap", 16, ts=1000 + 100 * k)
        cap.flush()
    api.set_engine(cap)
    status, body, _ = _cs_http(port, "capture", freeze="smoke")
    d = json.loads(body)
    on_disk = {name for _dir, _sub, files in os.walk(cap_dir) for name in files}
    if status != 200 or not d.get("enabled") or not d.get("frozen_now") or not set(d["frozen_now"]) <= on_disk \
            or d["counters"]["chunks"] != 3:
        fail(f"phase 4m (c): /capture?freeze= answered {status}: {body[:300]!r}")
    cap.close()
    out.append(f"capture: segments frozen on demand: {len(d['frozen_now'])} "
               f"({', '.join(sorted(d['frozen_now']))}), 3 chunks journaled")
    # handoff: the command sets the engine's trigger
    api.set_engine(card)
    card.handoff_requested.clear()
    status, body, _ = _cs_http(port, "handoff")
    if status != 200 or json.loads(body) != {"ok": True, "handoff": "requested", "ipc_plane": False} or \
            not card.handoff_requested.is_set():
        fail(f"phase 4m (c): /handoff answered {status}: {body!r}")
    card.handoff_requested.clear()
    out.append("handoff: handoff_requested set")
    out.append(_cs_health(port, slot))
    # speculative: each entry's slot check exactly once (admit and settle)
    spec = _cs_tier_engine(DEV, {"SPECULATIVE_ENABLED": "true", "SPECULATIVE_FLUSH_BATCH": 10000})
    spec.set_flow_rules([st.FlowRule("s1", count=100), st.FlowRule("s2", count=100)])
    c0 = len(slot.calls)
    served = [spec.entry_sync("s1", args=("paid",))[1] for _ in range(6)]
    g = spec.submit_bulk("s2", 8, acquire=np.array([1, 2] * 4, dtype=np.int32))
    spec.flush()
    spec.drain()
    n_calls = len(slot.calls) - c0
    api.set_engine(spec)
    status, body, _ = _cs_http(port, "speculative")
    d = json.loads(body)
    if not all(v.speculative and v.admitted for v in served) or g.admitted_count != 8 or n_calls != 8 or \
            status != 200 or not d["enabled"] or d["counters"]["spec_admits"] != 14:
        fail(f"phase 4m (c): the speculative tier ran the slots {n_calls} times for 6 entries and a group of two "
             f"acquires (8 wanted); /speculative answered {status}: {body[:300]!r}")
    spec.close()
    api.set_engine(card)
    out.append(f"speculative: 6 entries and a group of 2 acquires, {n_calls} slot checks (once each), "
               f"{d['counters']['spec_admits']} speculative admits")
    return out


def _cs_heartbeat(port: int, card, cpu_rules) -> str:
    """(d): one heartbeat of the card's engine and one of a CPU engine with
    the same rules and stream state (fresh: both HEALTHY, nothing shed) to
    an in-process dashboard: the same fields."""
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.transport import heartbeat

    cpu = Engine(clock=tclock.ManualClock(card.clock.now_ms()), device="cpu")
    cpu.set_flow_rules(cpu_rules)
    dash = _CsDashboard()
    real_ip = heartbeat.local_ip
    heartbeat.local_ip = lambda: "127.0.0.1"  # the sender's address: no route is looked up
    try:
        oks = [heartbeat.HeartbeatSender(f"127.0.0.1:{dash.port}", command_port=port, app_name="phase4m",
                                         engine=eng).heartbeat_once() for eng in (card, cpu)]
    finally:
        heartbeat.local_ip = real_ip
        dash.close()
        cpu.close()
    if oks != [True, True] or len(dash.beats) != 2 or dash.beats[0] != dash.beats[1]:
        fail(f"phase 4m (d): heartbeats {oks}: {dash.beats}")
    path, fields = dash.beats[0]
    return f"one heartbeat each to {path}: the same {len(fields)} fields (health {fields['health']})"


def _cs_oracle() -> str:
    """(e): the sequential oracle's stream (testing/oracle_stream.py) through
    an engine on the card."""
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.testing.oracle_stream import oracle_stream

    clock = tclock.ManualClock(0)
    eng = Engine(clock=clock, device=DEV)
    k4 = flush.flow_admission.launches
    t0 = time.perf_counter()
    got, want = oracle_stream(eng, clock, seed=72, n=CS_ORACLE_N)
    took = time.perf_counter() - t0
    k4 = flush.flow_admission.launches - k4
    eng.close()
    bad = [(g, w) for g, w in zip(got, want) if g != w]
    blocked = sum(not ok for _r, _t, ok, _w in got)
    if bad or len(got) != CS_ORACLE_N or not blocked or k4 < CS_ORACLE_N:
        fail(f"phase 4m (e): the card's engine against the oracle: {len(bad)} of {len(got)} differ "
             f"(first {bad[:2]}), {blocked} blocked, K4 {k4} launches")
    waits = sum(w > 0 for _r, _t, _ok, w in got)
    return (f"{len(got)} single entries on QPS, rate-limiter and warm-up rules: pass/block and wait equal the "
            f"oracle's ({blocked} blocked, {waits} paced waits); K4 {k4} launches; {took:.1f} s")


def phase4_control_surface(results: dict, cpu_jobs: dict) -> None:
    import shutil
    import urllib.parse

    from sentinel_tpu_torch.core.property import DynamicSentinelProperty
    from sentinel_tpu_torch.core.slots import SlotChainRegistry
    from sentinel_tpu_torch.datasource import (FileRefreshableDataSource, FileWritableDataSource,
                                               WritableDataSourceRegistry, json_converter)
    from sentinel_tpu_torch.transport import CommandCenter
    from sentinel_tpu_torch.utils.config import config
    from sentinel_tpu_torch.utils.registry import Registry

    line = card_line()
    log(f"phase 4m: the control surface on the card: setRules over HTTP, a file source, two custom slots from the "
        f"registry, {CS_STEPS} flushes of {FLUSH_N:,} over {N_RULES:,} rules in lockstep with a CPU engine, the "
        f"scrapes, the tiers' commands, a heartbeat, the oracle ({line})")
    t_phase = time.perf_counter()
    shutil.rmtree(CS_DIR, ignore_errors=True)
    os.makedirs(CS_DIR)
    rules_file = os.path.join(CS_DIR, "flow-rules.json")
    # Only blocked admissions are traced: head sampling draws from one random
    # source that the card's engine and the CPU engine would share here.
    config.set(config.TRACE_SAMPLE_RATE, "0")
    api.reset(clock=tclock.ManualClock(0), device=DEV)
    center = CommandCenter(port=0).start()
    paywall, flaky = _cs_slots()
    reg = Registry.of("ProcessorSlot")
    reg.register(lambda: paywall, name=paywall.name, order=paywall.order)
    reg.register(lambda: flaky, name=flaky.name, order=flaky.order)
    SlotChainRegistry.clear()  # the chain reads the registry at its next use
    try:
        # (a) the rules through setRules over HTTP; the writable source
        # persists them into the file the refreshable source then watches.
        WritableDataSourceRegistry.register("flow", FileWritableDataSource(
            rules_file, lambda rules: json.dumps([r.to_dict() for r in rules])))
        data = json.dumps([{"resource": f"r{i}", "count": 20} for i in range(N_RULES)])
        status, body, set_ms = _cs_http(center.port, "setRules",
                                        body=urllib.parse.urlencode({"type": "flow", "data": data}).encode())
        src = FileRefreshableDataSource(rules_file, json_converter(st.FlowRule), 3600)
        if status != 200 or body != b"success" or not src.refresh():
            fail(f"phase 4m (a): setRules answered {status} {body[:200]!r}, or the file source read nothing")
        st.flow_rule_manager.register_property(src.get_property())
        names = [s.name for s in SlotChainRegistry.slots()]
        if len(st.flow_rule_manager.get_rules()) != N_RULES or names != ["paywall", "flaky"]:
            fail(f"phase 4m (a): {len(st.flow_rule_manager.get_rules())} rules loaded, slots {names}")
        log(f"  (a) setRules of {N_RULES:,} rules over HTTP {set_ms:.1f} ms ({len(data):,} bytes of JSON), written "
            f"to {os.path.relpath(rules_file, ROOT)} by the writable source and read back by the file source; "
            f"slots from the registry {names}")
        t0 = time.perf_counter()
        lk = _cs_lockstep(center.port, paywall, src, rules_file)
        counts = lk["counts"]
        log(f"  (a) {CS_STEPS} flushes on the card and on the CPU engine in lockstep, {time.perf_counter() - t0:.1f} s "
            f"(the scrapes included): "
            f"verdicts, reasons ({lk['custom']:,} BLOCK_CUSTOM), slot_name, blocked_rule, wait_ms, every state "
            f"tensor and the slots' calls and exits ({lk['exits']:,}) equal after every flush; {lk['admitted']:,} "
            f"bulk rows admitted; the reload of one rule in ten through the file source before flush {CS_RELOAD}; "
            f"the raising slot failed open {flaky.raised} times; a card flush call median "
            f"{1e3 * float(np.median(lk['calls'])):.3f} ms ({line})")
        log(f"  (a) launches on the main path: {counts}")
        for name in ("window_update", "thread_gauge", "flow_admission", "row_stats"):
            if counts[name] <= 0:
                fail(f"phase 4m: kernel {name} was not launched on the main path")
            results[name]["launches_4m"] = counts[name]
        n_scrapes = len(CS_SCRAPES) * (CS_STEPS // CS_SCRAPE_EVERY)
        if lk["scrape_launches"] != [1] * n_scrapes or counts["row_stats"] != n_scrapes:
            fail(f"phase 4m (b): row_stats launches a scrape {lk['scrape_launches']}")
        profiled = {}
        for path, params in CS_SCRAPES:
            prof = kernel_counts(lambda path=path, params=params: _cs_http(center.port, path, **params), calls=2)
            profiled[path + ("?" + urllib.parse.urlencode(params) if params else "")] = prof
            if prof.get("rs_rows", 0) != 2:
                fail(f"phase 4m (b): torch.profiler counted {prof} over 2 scrapes of /{path} (rs_rows once each)")
        for tag, rows in lk["scrapes"].items():
            ms = [m for m, _ in rows]
            but = (f" but the {len(CS_HOST_TIMED)} host-timed lines and the {len(CS_DEVICE_POOLED)} staging pool "
                   "counts" if tag.startswith("metrics") else "")
            log(f"  (b) /{tag}: {len(rows)} scrapes at {N_RULES:,} resources equal to the CPU engine's{but}, p50 "
                f"{float(np.median(ms)):.3f} ms, max {max(ms):.3f} ms, {rows[-1][1]:,} bytes; row_stats 1 launch a "
                f"scrape ({line})")
        log(f"  (b) torch.profiler over 2 scrapes of each: {profiled} (rs_rows, the row_stats kernel, once a scrape); "
            f"the wrapper counted {counts['row_stats']} launches on {n_scrapes} scrapes")
        results["row_stats"]["scrape_ms_4m"] = {tag: [float(np.median([m for m, _ in rows])),
                                                      max(m for m, _ in rows), rows[-1][1]]
                                                for tag, rows in lk["scrapes"].items()}
        # (c) the tiers' commands; (d) the heartbeat; (e) the oracle
        t0 = time.perf_counter()
        for text in _cs_commands(center.port, paywall):
            log(f"  (c) {text}")
        log(f"  (c) {time.perf_counter() - t0:.1f} s")
        card = lk["card"]
        log(f"  (d) {_cs_heartbeat(center.port, card, st.flow_rule_manager.get_rules())}")
        log(f"  (e) {_cs_oracle()} ({line})")
    finally:
        center.stop()
        SlotChainRegistry.clear()
        Registry.reset_all()
        WritableDataSourceRegistry.clear()
        st.flow_rule_manager.register_property(DynamicSentinelProperty())
        config.reset()
    took = time.perf_counter() - t_phase
    log(f"  phase 4m took {took:.1f} s ({line})")


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
# phase 8b: the token plane over loopback TCP (cluster/server.py, client.py,
# shards.py, gossip.py); the servers are threads of this process
# ---------------------------------------------------------------------------

TP_FLOWS, TP_NS = TD_FLOWS, TD_NS  # phase 2e's token server: 65,536 flows in 16 namespaces
TP_PARAM_EVERY = 64  # flows 62, 126, ...: their resources also hold a cluster-mode param rule (8 values)
TP_BATCHES = (16384, 8, 1024, 16384, 64)  # submit_many windows of (b), 100 ms apart
TP_KILL_BATCHES = (1024, 8)  # (e): after the server is stopped
TP_SHARDS = 4
TP_RTT = ((8, 40), (1024, 20), (16384, 6))  # (rows, calls) of request_tokens_batch timed
TP_TIMEOUT_S = 120.0  # request timeouts: never the path the phase takes
TP_LEASE = {"CLUSTER_LEASE_ENABLED": "true", "CLUSTER_LEASE_TTL_MS": 600000, "CLUSTER_LEASE_MIN_BATCH": 4}
TP_GOSSIP = {"SKETCH_ENABLED": "true", "GOSSIP_ENABLED": "true", "SKETCH_PROMOTE_QPS": 40, "SKETCH_WIDTH": 4096}
_TP_RULES = []


def _tp_config(settings: dict) -> None:
    from sentinel_tpu_torch.utils.config import config

    for key, value in settings.items():
        config.set(getattr(config, key), str(value))


def tp_rules() -> tuple:
    """(flow rules, param rules by resource) of the token plane's stream:
    65,536 cluster-mode QPS rules (counts 50-500; every fourth AVG_LOCAL, the
    rest GLOBAL; fallback to the local check), a cluster-mode param rule of
    count 3 on every 64th resource (not on the last flow, where the Zipf
    draw's clamp puts a third of the stream; each param row is one K12
    launch on the server); loaded into the cluster rule manager in
    16 namespaces as phase 2e spreads them (the even flows in ns0). Built
    once a process."""
    if not _TP_RULES:
        counts = np.random.default_rng(81).integers(50, 501, TP_FLOWS)
        flows, params = [], {}
        for i in range(TP_FLOWS):
            grade = C.FLOW_THRESHOLD_AVG_LOCAL if i % 4 == 0 else C.FLOW_THRESHOLD_GLOBAL
            flows.append(st.FlowRule(f"c{i}", count=int(counts[i]), cluster_mode=True,
                                     cluster_config=ClusterFlowConfig(flow_id=i + 1, threshold_type=grade)))
        for i in range(TP_PARAM_EVERY - 2, TP_FLOWS, TP_PARAM_EVERY):
            params[f"c{i}"] = [st.ParamFlowRule(
                f"c{i}", param_idx=0, count=3, cluster_mode=True,
                cluster_config=ClusterFlowConfig(flow_id=TP_FLOWS + 1 + i, threshold_type=C.FLOW_THRESHOLD_GLOBAL))]
        _TP_RULES.extend((flows, params))
    flows, params = _TP_RULES
    by_ns = {}
    for i, rule in enumerate(flows):
        ns = 0 if i % 2 == 0 else 1 + (i // 2) % (TP_NS - 1)
        by_ns.setdefault(f"ns{ns}", []).append(rule)
        if rule.resource in params:
            by_ns[f"ns{ns}"] += params[rule.resource]
    tcl.cluster_flow_rule_manager.clear()
    for ns, rules in by_ns.items():
        tcl.cluster_flow_rule_manager.load_rules(ns, rules)
    # The namespace guard is per server: above the stream, so that shards
    # and one server decide alike.
    tcl.cluster_server_config_manager.load_global_flow_config(exceed_count=1.0, max_allowed_qps=1e9)
    return flows, params


def tp_flow_rows(rng, b: int) -> np.ndarray:
    return np.minimum(rng.zipf(1.1, b), TP_FLOWS) - 1


def tp_requests(rng, b: int, now: int) -> list:
    reqs = []
    for f, v in zip(tp_flow_rows(rng, b).tolist(), rng.integers(0, 8, b).tolist()):
        req = {"resource": f"c{f}", "ts": now}
        if f % TP_PARAM_EVERY == TP_PARAM_EVERY - 2:
            req["args"] = (f"v{v}",)
        reqs.append(req)
    return reqs


def tp_servers(n: int, clock, device) -> list:
    from sentinel_tpu_torch.cluster.server import SentinelTokenServer

    return [SentinelTokenServer(port=0, service=tcl.DefaultTokenService(clock=clock, device=device)).start()
            for _ in range(n)]


def tp_client(servers: list):
    from sentinel_tpu_torch.cluster.client import ClusterTokenClient
    from sentinel_tpu_torch.cluster.shards import ShardedTokenClient, ShardMap

    if len(servers) == 1:
        return ClusterTokenClient("127.0.0.1", servers[0].port, request_timeout_sec=TP_TIMEOUT_S).start()
    smap = ShardMap(0, [("127.0.0.1", s.port) for s in servers])
    return ShardedTokenClient(smap, request_timeout_sec=TP_TIMEOUT_S).start()


def wait_until(pred, what: str, guard_s: float = 60.0) -> None:
    t_end = time.monotonic() + guard_s
    while not pred():
        if time.monotonic() > t_end:
            fail(f"{what}: not reached in {guard_s} s")
        time.sleep(0.005)


def drive_token_plane(device: torch.device, seed: int, lease: bool, n_shards: int = 1, kill: bool = False):
    """An engine in client mode (set_to_client, submit_many) against
    ``n_shards`` token servers on ``device`` (one ManualClock for the engine
    and the servers): the windows of TP_BATCHES over the 65,536 rules, leases
    on or off; with ``kill`` the server is then stopped and TP_KILL_BATCHES
    follow (each cluster check FAILs and falls back to the local check).
    Returns (int32 [n, 3] verdict records a window, the servers' work and
    the client's counters)."""
    from sentinel_tpu_torch.cluster.client import client_stats
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.utils.config import config

    flows, params = tp_rules()
    _tp_config(TP_LEASE if lease else {})
    client_stats.reset()
    clock = tclock.ManualClock(1000)
    servers = tp_servers(n_shards, clock, device)
    client = tp_client(servers)
    tcl.TokenClientProvider.register(client)
    tcl.ClusterStateManager.set_to_client()
    eng = Engine(clock=clock, device=device)
    try:
        eng.set_flow_rules(flows)
        eng.set_param_rules(params)
        rng = np.random.default_rng(seed)
        records = []
        for i, b in enumerate(TP_BATCHES + (TP_KILL_BATCHES if kill else ())):
            if kill and i == len(TP_BATCHES):
                servers[0].stop()
                wait_until(lambda: not client.connected, "phase 8b (e): the client saw its server stop")
            clock.set_ms(1000 + 100 * i)
            ops = eng.submit_many(tp_requests(rng, b, clock.now_ms()))
            eng.flush()
            eng.drain()
            records.append(np.array([(o.verdict.admitted, o.verdict.reason, o.verdict.wait_ms) for o in ops],
                                    dtype=np.int32))
        work = {k: sum(s.work_stats()[k] for s in servers) for k in ("frames", "decisions", "lease_grants")}
        snap = client_stats.snapshot()
        return records, work, {k: snap[k] for k in ("requests", "batch_frames", "leases_granted", "lease_admits",
                                                    "fallbacks")}
    finally:
        eng.close()
        client.stop()
        for s in servers:
            s.stop()
        tcl.ClusterStateManager.stop()
        tcl.TokenClientProvider.clear()
        tcl.cluster_flow_rule_manager.clear()
        config.reset()


def cluster_demo_over_tcp(device) -> list:
    """examples/cluster_demo.py's sequence: a SentinelTokenServer whose
    service lives on ``device`` and a ClusterTokenClient on loopback."""
    from sentinel_tpu_torch.cluster.client import ClusterTokenClient

    cfg = ClusterFlowConfig
    tcl.cluster_flow_rule_manager.load_rules("default", [
        st.FlowRule("api", count=3, cluster_mode=True,
                    cluster_config=cfg(flow_id=100, threshold_type=C.FLOW_THRESHOLD_GLOBAL)),
        st.FlowRule("job", count=2, grade=C.FLOW_GRADE_THREAD, cluster_mode=True, cluster_config=cfg(flow_id=200)),
    ])
    (srv,) = tp_servers(1, tclock.ManualClock(0), device)
    cli = ClusterTokenClient(port=srv.port, request_timeout_sec=TP_TIMEOUT_S).start()
    try:
        lines = [cli.request_token(100).status.name for _ in range(5)]
        t1, t2, t3 = (cli.request_concurrent_token(200) for _ in range(3))
        lines += [t1.status.name, t2.status.name, t3.status.name]
        lines.append(cli.release_concurrent_token(t1.token_id).status.name)
        lines.append(cli.request_concurrent_token(200).status.name)
        return lines
    finally:
        cli.stop()
        srv.stop()
        tcl.cluster_flow_rule_manager.clear()


def drive_gossip_pair(device) -> tuple:
    """Two engines with the sketch tier and gossip armed on loopback: each
    folds 40 of one value a window (promotion needs 60: 1.5 x 40 QPS x 1 s)
    beside 100 values of its own; one gossip round; the next flush's drain
    evaluates the fleet view. Returns (rounds merged, remote origins a
    engine, promoted values before and after, the K11 launches)."""
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.utils.config import config

    _tp_config(TP_GOSSIP)
    clock = tclock.ManualClock(1000)
    try:
        engines = [Engine(clock=clock, device=device) for _ in range(2)]
    finally:
        config.reset()
    launches = tsk.sketch_fold.launches
    try:
        for e in engines:
            e.set_param_rules({"api": [st.ParamFlowRule("api", param_idx=0, count=1000, sketch_mode=True)]})

        def window(now):
            clock.set_ms(now)
            for i, e in enumerate(engines):
                col = [("fleet-hot",)] * 40 + [(f"own{i}-{now}-{j}",) for j in range(100)]
                e.submit_bulk("api", len(col), ts=now, args_column=col)
                e.flush()
                e.drain()
            return [sorted(e.sketch.promoted_values.get("api", ())) for e in engines]

        before = window(1000)
        a, b = engines
        a.gossip.peers = [("127.0.0.1", b.gossip.port)]
        merged = a.gossip.run_round()
        origins = [len(e.sketch.gossip_info()["remote_origins"]) for e in engines]
        after = window(1100)
        return merged, origins, before, after, tsk.sketch_fold.launches - launches
    finally:
        for e in engines:
            e.close()


def handler_k12_launches(srv, rows: list, frames: int = 10) -> tuple:
    """K12's launches counted by torch.profiler (``gpu_timing.kernel_counts``)
    over ``frames`` flow frames of ``rows``, each through the server's own
    handler (``server._Handler``) run on this thread over a socket pair
    while a thread of this process sends the frame and reads the answer:
    the server runs its handlers on threads of their own. Returns (K12
    launches seen: td_small or td_prep, one a launch; the kernels seen)."""
    import socket
    from types import SimpleNamespace

    from sentinel_tpu_torch.cluster import protocol
    from sentinel_tpu_torch.cluster import server as tserver

    def one_frame():
        a, b = socket.socketpair()
        answers = []

        def client():
            a.sendall(protocol.pack_flow_batch_request(1, rows))
            answers.append(protocol.unpack_batch_response(protocol.read_frame(a)))
            a.shutdown(socket.SHUT_WR)

        sender = threading.Thread(target=client)
        try:
            sender.start()
            tserver._Handler(b, ("127.0.0.1", 0), SimpleNamespace(token_server=srv))
            sender.join()
        finally:
            a.close()
            b.close()
        if len(answers) != 1 or len(answers[0][2]) != len(rows):
            fail("phase 8b: the server's handler did not answer its frame")

    counts = kernel_counts(one_frame, calls=frames)
    return counts.get("td_small", 0) + counts.get("td_prep", 0), counts


def token_rtt(results: dict) -> None:
    """One server on the card (leases off): K12 counted by torch.profiler
    over 10 frames of 1,024 rows through the server's handler, then round
    trips of request_tokens_batch at TP_RTT's sizes."""
    from sentinel_tpu_torch.cluster.server import SentinelTokenServer

    tp_rules()
    # Counted before the server listens: no thread of the server runs yet.
    srv = SentinelTokenServer(port=0, service=tcl.DefaultTokenService(clock=tclock.ManualClock(1000), device=DEV))
    rng = np.random.default_rng(83)
    try:
        rows = [(int(f) + 1, 1, False) for f in tp_flow_rows(rng, 1024)]
        seen, counts = handler_k12_launches(srv, rows)
        log(f"  torch.profiler over 10 frames of 1,024 rows through the server's handler: {seen} K12 launches on "
            f"the card (the kernels seen: {counts})")
        if seen <= 0:
            fail("phase 8b: torch.profiler saw no K12 launch on the token server's path")
        results["token_decide"]["profiler_launches_8b"] = seen
        cli = tp_client([srv.start()])
        try:
            cli.request_tokens_batch([(1, 1, False)] * 8)
            for rows_n, calls in TP_RTT:
                batches = [[(int(f) + 1, 1, False) for f in tp_flow_rows(rng, rows_n)] for _ in range(calls)]
                srv.reset_work_stats()
                ms = []
                t0 = time.perf_counter()
                for batch in batches:
                    t = time.perf_counter()
                    got = cli.request_tokens_batch(batch)
                    ms.append((time.perf_counter() - t) * 1e3)
                    if len(got) != rows_n or any(r.status == C.TokenResultStatus.FAIL for r in got):
                        fail(f"phase 8b: a request_tokens_batch of {rows_n} rows came back FAIL")
                wall = time.perf_counter() - t0
                w = srv.work_stats()
                log(f"  request_tokens_batch of {rows_n:,} rows, {calls} calls: {_pcts(ms)}; {calls / wall:,.1f} "
                    f"frames/s and {rows_n * calls / wall:,.0f} decisions/s through the client; the server "
                    f"{w['decisions'] / w['busy_s']:,.0f} decisions/s of handler time "
                    f"({w['busy_s'] * 1e3 / calls:.3f} ms a frame)")
                a = np.sort(ms)
                results["token_decide"][f"rtt_ms_{rows_n}"] = [float(a[len(a) // 2]), float(a[int(0.99 * len(a))])]
        finally:
            cli.stop()
    finally:
        srv.stop()
        tcl.cluster_flow_rule_manager.clear()


def phase8b(results: dict, cpu_jobs: dict) -> None:
    log(f"phase 8b: the token plane over loopback TCP: servers in this process with their services on the card; "
        f"(a) cluster_demo's sequence, (b) an engine in client mode over {TP_FLOWS:,} cluster-mode rules (Zipf(1.1), "
        f"windows of {TP_BATCHES}), leases off, then on, (c) the same stream over {TP_SHARDS} shards, (d) two "
        "engines gossiping the sketch tier, (e) the server stopped mid-stream; first K12 counted by torch.profiler "
        "and the round trips of one server")
    t0 = time.perf_counter()
    token_rtt(results)
    card, cpu = cluster_demo_over_tcp(DEV), cluster_demo_over_tcp(torch.device("cpu"))
    log(f"  (a) cluster_demo over TCP, the service on the card: {card}")
    if card != cpu or card != CLUSTER_DEMO:
        fail(f"phase 8b (a): the card's lines {card}, the CPU's {cpu}, expected {CLUSTER_DEMO}")
    counters = {"token_decide": (tts, "batch_decide"), "window_update": (ma, "update"),
                "flow_admission": (flush, "flow_admission")}
    for mod, name in counters.values():
        getattr(mod, name).launches = 0
    runs = {}
    for tag, args in (("b0", (False,)), ("b1", (True, 1, True))):
        t = time.perf_counter()
        runs[tag] = drive_token_plane(DEV, 82, *args)
        want = cpu_result(cpu_jobs, f"8b {tag}")
        if len(runs[tag][0]) != len(want[0]) or any(not np.array_equal(x, y) for x, y in zip(runs[tag][0], want[0])):
            fail(f"phase 8b ({'b' if tag == 'b0' else 'b, e'}): the client-mode engine's verdicts differ between "
                 "the card and the CPU")
        if runs[tag][1:] != want[1:]:
            fail(f"phase 8b: the servers' work or the client's counters differ: card {runs[tag][1:]}, CPU {want[1:]}")
        rec = np.concatenate(runs[tag][0])
        log(f"  ({'b' if tag == 'b0' else 'b, e'}) leases {'on' if tag == 'b1' else 'off'}: {len(rec):,} verdicts "
            f"equal to the CPU engine against a CPU server ({int(rec[:, 0].sum()):,} admitted); server "
            f"{runs[tag][1]}; client {runs[tag][2]}; {time.perf_counter() - t:.1f} s")
    launches = {name: getattr(mod, name_).launches for name, (mod, name_) in counters.items()}
    log(f"  launches on (b) and (e): {launches}")
    if min(launches.values()) <= 0:
        fail(f"phase 8b: a kernel of the client-mode path was not launched: {launches}")
    if runs["b1"][1]["lease_grants"] <= 0 or runs["b1"][2]["lease_admits"] <= 0 or runs["b1"][2]["fallbacks"] <= 0:
        fail("phase 8b: leases were not granted and spent, or the stopped server was not fallen back from")
    fb = np.concatenate(runs["b1"][0][len(TP_BATCHES):])
    log(f"  (e) the server stopped: {len(fb):,} verdicts by the local check ({int(fb[:, 0].sum()):,} admitted), "
        f"{runs['b1'][2]['fallbacks']:,} fallbacks counted by the client")
    t = time.perf_counter()
    sharded = drive_token_plane(DEV, 82, False, TP_SHARDS)
    # Each connection's ping counts one decision: the rows decided are the same.
    if any(not np.array_equal(x, y) for x, y in zip(sharded[0], runs["b0"][0])) or (
            sharded[1]["decisions"] - TP_SHARDS != runs["b0"][1]["decisions"] - 1):
        fail("phase 8b (c): the sharded plane's verdicts differ from one server's")
    log(f"  (c) {TP_SHARDS} shards: the verdicts of one server; server work {sharded[1]}; "
        f"{time.perf_counter() - t:.1f} s")
    launches["token_decide"] = tts.batch_decide.launches
    gossip_card, gossip_cpu = drive_gossip_pair(DEV), drive_gossip_pair(torch.device("cpu"))
    merged, origins, before, after, k11 = gossip_card
    log(f"  (d) gossip: {merged} round merged both ways, remote origins a engine {origins}, promoted before "
        f"{before}, after {after}; {k11} K11 launches")
    if gossip_card[:4] != gossip_cpu[:4] or merged != 1 or origins != [1, 1] or any(before) or not all(after):
        fail(f"phase 8b (d): the gossip pair on the card {gossip_card[:4]}, on the CPU {gossip_cpu[:4]}")
    if k11 <= 0:
        fail("phase 8b (d): kernel sketch_fold was not launched on the gossip engines' path")
    for name, n in launches.items():
        results[name]["launches_8b"] = n
    results["sketch_fold"]["launches_8b"] = k11
    log(f"  phase 8b: {time.perf_counter() - t0:.1f} s")


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
        # Least bytes of the step: its states read once and written once, the
        # batch (and shaping, param items) read once, the result written once;
        # the shard copies alone are written and read back by the merges.
        least = (2 * tensor_bytes((base, c["fdyn"], c["dyn"], c["pdyn"])) + tensor_bytes((c["batch"], *c["extra"]))
                 + tensor_bytes(res))
        s_bound, s_by = bound(least)
        copies = 2 * D_MESH * tensor_bytes((base, c["dyn"]))
        log(f"  {label}: bound {s_bound:.4f} ms by {s_by} ({least / 1e9:.3f} GB: the states, batch and result once); "
            f"the {D_MESH} shard copies alone write and read back {copies / 1e9:.1f} GB a step "
            f"({copies / HBM_BYTES_PER_S * 1e3:.2f} ms at the HBM rate)")
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
    """Starts the CPU references of phases 2c (d), 4-4l, 8 and 8b (the port's
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
        "8b b0": WORKERS.apply_async(drive_token_plane, (cpu, 82, False)),
        "8b b1": WORKERS.apply_async(drive_token_plane, (cpu, 82, True, 1, True)),
        "4f": WORKERS.apply_async(drive_pipeline_engine, (cpu, 10, "sync")),
        "4g": WORKERS.apply_async(drive_failover_engine, (cpu, 4, True, True)),
        "4g spec": WORKERS.apply_async(drive_spec_entries, (cpu, 11)),
        "4h b": WORKERS.apply_async(drive_valve, (cpu, 15)),
        "4h c": WORKERS.apply_async(drive_tuned_engine, (cpu, 16, False)),
        "4i a": WORKERS.apply_async(drive_metric_engine, (cpu, 30)),
        "4i c": WORKERS.apply_async(drive_retuned_engine, (cpu, 31, False)),
        "4i c chain": WORKERS.apply_async(drive_retuned_engine, (cpu, 31, True)),
        "4i e": WORKERS.apply_async(drive_mesh_topk, (cpu, 32)),
        "4j a0": WORKERS.apply_async(drive_ipc, (cpu, 19, 0, False)),
        "4j a2": WORKERS.apply_async(drive_ipc, (cpu, 19, 2, True)),
        "4l": WORKERS.apply_async(drive_supervised_oracle, (cpu, 61)),
    }


def cpu_result(cpu_jobs: dict, name: str):
    """The result of a CPU job, logging how long the card's phase waited."""
    t0 = time.perf_counter()
    out = cpu_jobs[name].get()
    log(f"  (the CPU reference '{name}' came {time.perf_counter() - t0:.1f} s after it was asked for)")
    return out


def phase1() -> dict:
    """The card's line, the CPU references started, every CUDA source built
    (one nvcc each, all started together). Returns the CPU jobs."""
    log(f"phase 1: {card_line()}")
    cpu_jobs = start_cpu_jobs()
    t0 = time.perf_counter()
    cuda_build.build_all(["slab_sweep", "window_update", "window_reduce", "flow_admission", "system_check",
                          "breaker_on_exits",
                          "breaker_try_pass", "commit_borrow_slab", "shaping_scan", "param_scan", "sketch_fold",
                          "token_decide", "mesh_merge_breaker", "mesh_budget", "bucket_read", "blocked_topk"])
    log(f"  CUDA kernels built in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    return cpu_jobs


# name -> (route, source, the JAX function it replaces)
KERNEL_META = {
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
    "bucket_read": ("cuda", "sentinel_tpu_torch/csrc/bucket_read.cu", "sentinel_tpu/metrics/metric_array.py:231"),
    "blocked_topk_wide": ("cuda", "sentinel_tpu_torch/csrc/blocked_topk.cu", "sentinel_tpu/runtime/flush.py:879"),
}


def main() -> None:
    t_start = time.perf_counter()
    log("phase 1: start")
    try:
        cpu_jobs = phase1()
    except BaseException as exc:
        log(f"phase 1 failed after {time.perf_counter() - t_start:.1f} s: {exc!r}")
        raise
    results = {name: {} for name in KERNEL_META}
    took = {"1": round(time.perf_counter() - t_start, 1)}
    for name, run in (
        ("2", lambda: phase2(results)), ("2b", lambda: phase2_chain(results)), ("3", phase3),
        ("2c", lambda: phase2_shaping_param(results, cpu_jobs)),
        ("4", lambda: phase4(results, cpu_jobs)), ("4b", lambda: phase4_chain(results, cpu_jobs)),
        ("2d", lambda: phase2_sketch(results)), ("2e", lambda: phase2_token(results)),
        ("4c", lambda: phase4_shaping(results, cpu_jobs)), ("4d", lambda: phase4_sketch(results, cpu_jobs)),
        ("2f", lambda: phase2_mesh(results)), ("3b", phase3b), ("4e", lambda: phase4_mesh(results, cpu_jobs)),
        ("4f", lambda: phase4_pipeline(cpu_jobs)), ("4g", lambda: phase4_failover(cpu_jobs)),
        ("4h", lambda: phase4_control(results, cpu_jobs)), ("4i", lambda: phase4_metric(results, cpu_jobs)),
        ("8b", lambda: phase8b(results, cpu_jobs)), ("4j", lambda: phase4_ipc(results, cpu_jobs)), ("4k", lambda: phase4_capture(results, cpu_jobs)),
        ("4l", lambda: phase4_supervise(results, cpu_jobs)), ("4m", lambda: phase4_control_surface(results, cpu_jobs)),
        ("5", phase5), ("6", phase6), ("7", phase7), ("8", lambda: phase8(results, cpu_jobs)), ("9", phase9),
    ):
        log(f"phase {name}: start")
        t0 = time.perf_counter()
        try:
            run()
        except BaseException as exc:
            log(f"phase {name} failed after {time.perf_counter() - t0:.1f} s: {exc!r}")
            raise
        took[name] = round(time.perf_counter() - t0, 1)
    WORKERS.close()
    WORKERS.join()

    kernels = []
    for name, (route, source, replaces) in KERNEL_META.items():
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
                      "edges", "launches_4h", "routes_4h", "ms_60s", "plain_ms_60s", "bound_ms_60s",
                      "device_ms_60s", "launches_per_call_60s", "memsets_per_call_60s", "records", "records_60s",
                      "pull_ms", "read_ms_4i", "copy_ms_4i", "asked_rows_4i", "copies_per_call", "launches_4j",
                      "launches_4k", "launches_4l", "launches_4m", "scrape_ms_4m", "launches_8b", "profiler_launches_8b", "rtt_ms_8",
                      "rtt_ms_1024", "rtt_ms_16384") + tuple(
                          f"{m}_{n}_k{k}" for m in ("ms", "plain_ms", "library_ms", "device_ms", "launches_per_call",
                                                    "memsets_per_call") for n, k in ((N, 64), (8, 16), (8, 64))):
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
