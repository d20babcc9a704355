"""Times the window update (K2), the flow admission (K4), the borrow commit
(K5), the system check (K6), the breaker completions (K7), the breaker
entry check (K8), the slot chain's verdict tail, the sketch fold (K11), the shaping recurrence with its inputs (K9), the
hot-parameter recurrence (K10), the token decision (K12) and the mesh
budget split (K15) of one checkout of
sentinel_tpu_torch on the card, so that two commits can be compared on
one card in alternating runs:

    python3 gpu_kernel_ab.py --root path/to/checkout [--tag name] [--only k7,k11|k1,gauge]

It builds that checkout's kernels, then times, with CUDA events around
back-to-back calls (gpu_timing.time_ms):

- K1: the matured-borrow sweep over the slab [1,048,576, 2] of a full
  stats state, swept (every cell empty: what each flush meets on traffic
  without borrows), and with 2% of the cells matured (``k1_matured``,
  chip_smoke.py phase 2's Zipf case: live, newer and expired borrows),
  the slab and the second window restored before each call and left out
  of the time (gpu_timing.time_ms_fresh);
- ``apply_updates`` (the two windows' K2 and the thread gauge) at the
  entry accounting's 4N = 524,288 updates of 131,072 entries (uniform
  rows, 90% admitted) and at its first 32 (``apply_small``, N = 8); the
  gauge alone (``gauge``) where the checkout still has it as a kernel of
  its own;
- K3 (``k3``): the second window's sums at 131,072 sorted gathered rows;
  the stats read ``row_stats`` (``nodes.rows_stats``: both windows, the
  gauge and the slab, one record a row) at the same rows and at 3
  (``row_stats_small``), where the checkout has it; and the engine's
  stats read (``Engine.rows_stats``) of 3 and of 50 of those rows
  (``engine_read3``, ``engine_read50``: the wall ms of a call, which ends
  in its copy back, and its device kernels, memsets and time);
- K16 (``k16``): the global shaping charge of 16,384 items (every eighth
  entry's row, ts over 400 ms) over the same second window, and of its
  first 8 (``k16_small``);
- K7: 32,768 exits (KD = 1, 30% errors, 95% valid, ts over 400 ms) into
  1,048,576 breakers of the three grades (60% CLOSED, 25% OPEN, 15%
  HALF_OPEN), on uniform breakers and on Zipf(1.1) ones (``k7_zipf``),
  and the first 8 exits; the state is updated in place call after call;
- K11: chip_smoke.py phase 2d's tiers at 131,072 keys after eight earlier
  folds: the default tier (depth 4, width 2,048, 64 candidates, distinct
  keys) and the widened one (``k11_widened``: depth 8, width 2^20, 1,024
  candidates, host-aggregated Zipf ids with duplicates and padding), each
  without and with decay (``*_decay``), and the default tier's first 8
  keys;
- K2: 524,288 entry updates (uniform rows, 90% masked in, the last 100 ms
  of clock) into the minute window [1,048,576, 60, 6];
- K4: the DEFAULT path with its tail and top-8 at 131,072 and at 8 entries
  (K = 1, uniform rows, ts over 400 ms) against 1,048,576 QPS rules of
  count 20 and their rows' second windows;
- K6: the same entries (131,072 and 8), all inbound, against row 0, under
  QPS and thread thresholds that block part of them, BBR load and CPU;
- K8: the same entries, one breaker each of 1,048,576 (40% OPEN, half of
  those due), at 131,072 slots with and without the mesh's mask (half the
  breakers), at a mesh shard's 4,096 with it, and at 8;
- K15: the same entries on Zipf(1.1) rows over 8 shards, the flow grant,
  the borrow, the two in turn as the mesh step calls them (``k15_step``,
  a pair a call), and 8 slots;
- the verdict tail (``tail``): the same entries after every stage, each
  stage blocking part of them (system, flow, the breakers of K8's case
  with their probes), 10% occupied, top-8 over the 1,048,576 rows; and
  its first 8 entries; the same on K15's Zipf rows (``tail_zipf``), and
  there with 8% of the entries passing the flow check
  (``tail_zipf_blocked``), each with ``*_first_untouched_row`` (the lowest
  row no blocked entry touched) and ``*_blocked``;
- K5: the same entries, 10% of the slots borrowing one of the next two
  windows on the Zipf rows, into the slab [1,048,576, 2]; and 8 slots;
  the same on the uniform rows (``k5_uniform``);
- K9: 16,384 rate-limiter items (slot 1 of every 8th of 131,072 entries)
  over 1,048,576 rules with their inputs (entry liveness, the slot's
  pass-plus-charge, the minute window of 131,072 rows): the one call of
  shaping_stage where the checkout has it, else shaping_inputs and
  run_shaping; its first 8 items; one rule holding all 16,384 (K9 alone,
  ``k9_heavy_ms``);
- K10: chip_smoke.py's mixed shape (32,768 QPS items over 16,384 value
  rows, token count 100, the engine's rounds bound) and its first 8 items;
- K12: batches of 16,384 and of 8 Zipf(1.1) requests over 65,536 flows in
  16 namespaces, on a token server's state after 20 batches.

Inputs are made here from fixed seeds, the same for every checkout, only
through long-standing functions of the package (batch_from_numpy,
flow_table_from_numpy, the degrade tables' from_numpy, the state tuples,
make_param_state, Admission and the public slot_chain_verdict and
commit_borrow_slab); the token batches are chip_smoke.py's
(gpu_timing.token_batch). Each call's device kernels, memsets and device
time are read from torch.profiler over 20 calls, and for K4, K5, K6, K9,
K10, K15 and the tail at full size the device us a call by kernel
(k4_kernel_us, k5_kernel_us, k7_kernel_us, k7_zipf_kernel_us, k11_kernel_us,
k11_decay_kernel_us, k11_widened_kernel_us, k11_widened_decay_kernel_us, k5_uniform_kernel_us, k6_kernel_us,
k9_kernel_us, k10_kernel_us, k15_kernel_us, k15_borrow_kernel_us,
tail_kernel_us, tail_zipf_kernel_us, tail_zipf_blocked_kernel_us); the
script fails if the profiler reads no kernel. ``--only k7,k11`` times K7
and K11 alone, ``--only k1,gauge`` K1, apply_updates, the gauge, K3 and
K16 alone, ``--only k3,k16`` K3, the stats reads and K16 alone. Prints
one JSON line that
carries the card's name and power limit. Needs CUDA; imports no JAX. The
helpers come from the gpu_timing.py beside this script, whichever
checkout it times.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from gpu_timing import (TD_B, TD_FLOWS, TD_NS, card_line, device_profile, kernel_times, time_ms, time_ms_fresh,
                        token_batch)


def k1_gauge(out: dict, profiled, dev, k3_k16_only: bool = False) -> None:
    """K1 swept and with 2% of the slab matured, apply_updates at 4N and at
    N = 8, the gauge alone where the checkout has it (all three left out
    with ``k3_k16_only``), K3, the stats reads and K16."""
    from sentinel_tpu_torch.metrics import metric_array as ma
    from sentinel_tpu_torch.metrics import nodes
    from sentinel_tpu_torch.metrics.events import NUM_EVENTS
    from sentinel_tpu_torch.parallel import ici
    from sentinel_tpu_torch.rules.shaping import ShapingBatch
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.utils.clock import ManualClock

    i32 = torch.int32
    rows_n, n, now = 1 << 20, 1 << 17, 1_000_000
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)

    def window(cfg):
        b, wlen = cfg.sample_count, cfg.window_len_ms
        age = torch.randint(-1, 2 * b + 2, (rows_n, b), generator=gen, device=dev, dtype=i32)
        ws = (now - now % wlen) - age * wlen
        return ma.MetricArrayState(
            torch.randint(0, 40, (rows_n, b, NUM_EVENTS), generator=gen, device=dev, dtype=i32),
            torch.randint(1, cfg.max_rt + 1, (rows_n, b), generator=gen, device=dev, dtype=i32),
            torch.where((age < 0) | (ws < 0), torch.full_like(ws, cfg.empty_ws), ws).to(i32).contiguous(),
        )

    scfg = nodes.SECOND_CFG
    b = scfg.sample_count
    stats = nodes.StatsState(window(scfg), window(nodes.MINUTE_CFG),
                             torch.randint(0, 4, (rows_n,), generator=gen, device=dev, dtype=i32),
                             torch.zeros((rows_n, b), device=dev, dtype=i32),
                             torch.full((rows_n, b), scfg.empty_ws, device=dev, dtype=i32))
    if not k3_k16_only:
        k1_apply(out, profiled, dev, stats, now, gen)
    rng = np.random.default_rng(12)
    res = rng.integers(0, rows_n, n).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # K3 at 131,072 sorted gathered rows, the stats reads, and K16 over 16,384 items.
    rows_g = torch.sort(t(res)).values
    profiled("k3", lambda: ma.window_reduce(scfg, stats.second, now, rows_g))
    three = rows_g[-3:].contiguous()
    if hasattr(nodes, "rows_stats"):
        profiled("row_stats", lambda: nodes.rows_stats(stats, rows_g, now))
        profiled("row_stats_small", lambda: nodes.rows_stats(stats, three, now))
    else:
        out["row_stats_ms"] = "not in this checkout"
    eng = Engine(clock=ManualClock(now), device=dev)
    eng.stats = stats
    for m in (3, 50):
        asked = rows_g[-m:].tolist()
        read = lambda: eng.rows_stats(asked)
        read()
        t0 = time.perf_counter()
        for _ in range(50):
            read()
        out[f"engine_read{m}_wall_ms"] = (time.perf_counter() - t0) / 50 * 1e3
        out[f"engine_read{m}_launches_per_call"], out[f"engine_read{m}_memsets_per_call"], out[
            f"engine_read{m}_device_ms"] = device_profile(read)
    s16 = n // 8
    sb = ShapingBatch(valid=torch.ones(s16, dtype=torch.bool, device=dev), gid=t(res[::8]), row=t(res[::8]),
                      eidx=t(np.arange(0, n, 8, dtype=np.int32)), flat_pos=t(np.arange(0, n, 8, dtype=np.int32)),
                      ts=t(np.sort(rng.integers(0, 400, s16)).astype(np.int32) + now - 400),
                      acquire=t(np.ones(s16, np.int32)))
    profiled("k16", lambda: ici.mesh_shaping_charge(stats.second, sb, now))
    out["k16_kernel_us"] = kernel_times(lambda: ici.mesh_shaping_charge(stats.second, sb, now))
    sb8 = ShapingBatch(*(x[:8].contiguous() for x in sb))
    profiled("k16_small", lambda: ici.mesh_shaping_charge(stats.second, sb8, now))
    del stats, eng
    torch.cuda.empty_cache()


def k1_apply(out: dict, profiled, dev, stats, now: int, gen) -> None:
    """K1 swept and with 2% of the slab matured, apply_updates at 4N and at
    N = 8, the gauge alone where the checkout has it."""
    from sentinel_tpu_torch.metrics import nodes
    from sentinel_tpu_torch.metrics.events import NUM_EVENTS

    i32 = torch.int32
    rows_n, n = stats.n_rows, 1 << 17
    scfg = nodes.SECOND_CFG
    b = scfg.sample_count
    profiled("k1", lambda: nodes.materialize_matured(stats, now))
    # 2% of the cells borrowed for the windows from 4 back to 2 ahead.
    pick = torch.rand((rows_n, b), generator=gen, device=dev) < 0.02
    wlen = scfg.window_len_ms
    off = torch.randint(-4, 3, (rows_n, b), generator=gen, device=dev, dtype=i32) * wlen
    fws0 = torch.where(pick, now - now % wlen + off, stats.future_ws).to(i32)
    fpass0 = torch.where(pick, torch.randint(1, 9, (rows_n, b), generator=gen, device=dev, dtype=i32), 0).to(i32)
    saved = [t.clone() for t in stats.second]

    def restore():
        stats.future_ws.copy_(fws0)
        stats.future_pass.copy_(fpass0)
        for t, s in zip(stats.second, saved):
            t.copy_(s)

    k1m = lambda: (restore(), nodes.materialize_matured(stats, now))
    out["k1_matured_ms"] = time_ms_fresh(restore, lambda: nodes.materialize_matured(stats, now))
    # The profile leaves the restoring copies out (memcpy, not kernels).
    out["k1_matured_launches_per_call"], out["k1_matured_memsets_per_call"], out["k1_matured_device_ms"] = (
        device_profile(k1m))
    out["k1_matured_cells"] = int(pick.sum())
    del saved, fws0, fpass0, pick, off

    # The entry accounting's update batch: rows (res, res, -1, 0), 90% admitted.
    rng = np.random.default_rng(12)
    res = rng.integers(0, rows_n, n).astype(np.int32)
    adm = rng.random(n) < 0.9
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rows4 = t(np.stack([res, res, np.full(n, -1), np.zeros(n)], axis=1).astype(np.int32).reshape(-1))
    ts4 = t(np.repeat(np.sort(rng.integers(0, 400, n)).astype(np.int32) + now - 400, 4))
    d4 = np.zeros((4 * n, NUM_EVENTS), np.int32)
    d4[:, 0], d4[:, 1] = np.repeat(adm, 4), np.repeat(~adm, 4)
    d4, thr4 = t(d4), t(np.repeat(adm, 4).astype(np.int32))
    mask4 = rows4 >= 0
    apply = lambda m: lambda: nodes.apply_updates(stats, rows4[:m], ts4[:m], d4[:m], None, thr4[:m], mask4[:m])
    profiled("apply", apply(4 * n))
    out["apply_kernel_us"] = kernel_times(apply(4 * n))
    profiled("apply_small", apply(32))
    try:  # the gauge as a kernel of its own (before it rode in apply_updates' second launch)
        profiled("gauge", lambda: nodes.thread_gauge_add(stats.threads, rows4, thr4, mask4))
    except ValueError as exc:
        out["gauge_ms"] = f"not in this checkout ({exc})"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose sentinel_tpu_torch is timed")
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", default="", choices=("", "k7,k11", "k1,gauge", "k3,k16"),
                    help="time K7 and K11; K1, apply_updates, the gauge, K3 and K16; or K3, the stats reads and "
                         "K16, alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gpu_kernel_ab: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from sentinel_tpu_torch.cluster import token_service as tts
    from sentinel_tpu_torch.metrics import metric_array as ma
    from sentinel_tpu_torch.metrics import nodes
    from sentinel_tpu_torch.metrics.events import NUM_EVENTS
    from sentinel_tpu_torch.parallel import ici
    from sentinel_tpu_torch.rules import degrade_table as tdt
    from sentinel_tpu_torch.rules import param_table as tpt
    from sentinel_tpu_torch.rules import shaping as tsh
    from sentinel_tpu_torch.rules.flow_table import flow_table_from_numpy
    from sentinel_tpu_torch.runtime import flush
    from sentinel_tpu_torch.runtime import sketch as tsk
    from sentinel_tpu_torch.runtime.engine import _rounds_bucket
    from sentinel_tpu_torch.utils import cuda_build

    sources = ["window_update", "window_reduce", "token_decide", "flow_admission", "param_scan", "system_check", "breaker_on_exits",
               "breaker_try_pass", "shaping_scan", "mesh_budget", "commit_borrow_slab", "sketch_fold", "slab_sweep"]
    cuda_build.build_all(n for n in sources if (cuda_build.CSRC / f"{n}.cu").exists())  # an older checkout has fewer
    dev = torch.device("cuda", 0)
    i32 = torch.int32
    out = {"tag": args.tag, "root": args.root, "card": card_line(), "torch": torch.__version__}

    def profiled(name, fn):
        out[f"{name}_ms"] = time_ms(fn)
        out[f"{name}_launches_per_call"], out[f"{name}_memsets_per_call"], out[f"{name}_device_ms"] = (
            device_profile(fn))

    if args.only in ("", "k1,gauge", "k3,k16"):
        k1_gauge(out, profiled, dev, k3_k16_only=args.only == "k3,k16")
        if args.only:
            print(json.dumps(out), flush=True)
            return

    # K7: 32,768 exits into 1,048,576 breakers, uniform and Zipf(1.1), and 8.
    rng7 = np.random.default_rng(7)
    nd7, m7, now7 = 1 << 20, 1 << 15, 1_000_000
    t7 = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    ri7 = lambda lo, hi: rng7.integers(lo, hi, nd7).astype(np.int32)
    grade7 = ri7(0, 3)
    thr7 = np.where(grade7 == 0, ri7(50, 150),
                    np.where(grade7 == 1, 0.3 + 0.4 * rng7.random(nd7), ri7(2, 7))).astype(np.float32)
    min_req7 = np.where(rng7.random(nd7) < 0.05, 2**31 - 1, ri7(2, 6)).astype(np.int32)
    dtab7 = tdt.degrade_table_from_numpy(
        (grade7, thr7, np.full(nd7, 0.5, np.float32), min_req7, np.full(nd7, 1000, np.int32),
         np.full(nd7, 5000, np.int32), np.floor(thr7 + 0.5).astype(np.int32)), dev)
    u7, bad7 = rng7.random(nd7), ri7(0, 4)
    ddyn7 = tdt.degrade_state_from_numpy(
        (np.where(u7 < 0.6, 0, np.where(u7 < 0.85, 1, 2)), now7 + ri7(-2000, 2000), bad7, bad7 + ri7(0, 4),
         now7 - now7 % 1000 - 1000 * ri7(0, 2)), dev)
    x7 = (t7(np.sort(now7 - 400 + rng7.integers(0, 400, m7)).astype(np.int32)),
          t7(rng7.integers(0, 200, m7).astype(np.int32)), t7((rng7.random(m7) < 0.3).astype(np.int32)),
          t7(rng7.random(m7) < 0.95))
    for name, gids in (("k7", rng7.integers(0, nd7, m7)), ("k7_zipf", np.minimum(rng7.zipf(1.1, m7), nd7) - 1)):
        xg = t7(gids.astype(np.int32)[:, None])
        k7 = lambda m, xg=xg: lambda: tdt.breaker_on_exits(dtab7, ddyn7, xg[:m], *(a[:m] for a in x7))
        profiled(name, k7(m7))
        out[f"{name}_kernel_us"] = kernel_times(k7(m7))
        if name == "k7":
            profiled("k7_small", k7(8))
    del dtab7, ddyn7, x7, xg

    # K11: phase 2d's default and widened tiers, 131,072 keys, decay off and
    # on; the default tier's first 8 keys.
    rng11 = np.random.default_rng(11)
    s11 = 1 << 17
    keys11 = rng11.permutation(np.unique(rng11.integers(0, 2**31 - 1, 14 * s11))[: 9 * s11]).astype(np.int32)
    sk_batch = lambda ids, w: tsk.SketchBatch(t7(np.asarray(ids, np.int32)), t7(np.asarray(w, np.int32)))
    for name, (depth, width, c) in (("k11", (4, 2048, 64)), ("k11_widened", (8, 1 << 20, 1024))):
        st11 = tsk.make_sketch_state(depth, width, c, dev)
        for k in range(8):
            ids = keys11[k * s11:(k + 1) * s11]
            tsk.sketch_fold_plain(st11, sk_batch(ids, rng11.integers(1, 5, s11)), decay=k == 4)
        if name == "k11_widened":
            draws = rng11.zipf(1.1, 6 * 10**6)
            uniq, cnt = np.unique(draws[draws <= 10**6], return_counts=True)
            n_agg = s11 - 2048
            ids = np.concatenate([keys11[uniq[:n_agg] - 1], keys11[uniq[:1024] - 1], np.full(1024, -1)])
            w = np.concatenate([cnt[:n_agg], cnt[:1024], np.zeros(1024, np.int64)])
        else:
            ids = keys11[8 * s11:9 * s11].copy()
            ids[: c // 3] = st11.cand_ids[: c // 3].cpu().numpy()
            w = rng11.integers(1, 5, s11)
        sk = sk_batch(ids, w)
        for decay in (False, True):
            tag = name + ("_decay" if decay else "")
            fold = lambda sk=sk, decay=decay: tsk.sketch_fold(st11, sk, decay)
            profiled(tag, fold)
            out[f"{tag}_kernel_us"] = kernel_times(fold)
        if name == "k11":
            sk8 = tsk.SketchBatch(sk.ids[:8].clone(), sk.w[:8].clone())
            profiled("k11_small", lambda: tsk.sketch_fold(st11, sk8, False))
    del st11, sk
    torch.cuda.empty_cache()
    if args.only:
        print(json.dumps(out), flush=True)
        return

    # K2: 524,288 entry updates into the minute window of 1,048,576 rows.
    cfg, rows_n, n, now = nodes.MINUTE_CFG, 1 << 20, 1 << 19, 1_000_000
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    b, wlen = cfg.sample_count, cfg.window_len_ms
    age = torch.randint(-1, 2 * b + 2, (rows_n, b), generator=gen, device=dev, dtype=i32)
    ws = (now - now % wlen) - age * wlen
    state = ma.MetricArrayState(
        torch.randint(0, 40, (rows_n, b, NUM_EVENTS), generator=gen, device=dev, dtype=i32),
        torch.randint(1, cfg.max_rt + 1, (rows_n, b), generator=gen, device=dev, dtype=i32),
        torch.where((age < 0) | (ws < 0), torch.full_like(ws, cfg.empty_ws), ws).to(i32).contiguous(),
    )
    rng = np.random.default_rng(2)
    t = lambda a: torch.from_numpy(a).to(dev)
    rows = t(rng.integers(0, rows_n, n).astype(np.int32))
    ts = t((now - rng.integers(0, 100, n)).astype(np.int32))
    deltas = t(rng.integers(0, 3, (n, NUM_EVENTS)).astype(np.int32))
    mask = t(rng.random(n) < 0.9)
    k2 = lambda: ma.update(cfg, state, rows, ts, deltas, None, mask)
    out["k2_ms"] = time_ms(k2, iters=20)
    out["k2_launches_per_call"], out["k2_memsets_per_call"], out["k2_device_ms"] = device_profile(k2)
    del state
    torch.cuda.empty_cache()

    # K4: 131,072 entries (and their first 8) against 1,048,576 rules.
    gen.manual_seed(4)
    scfg, n, now = nodes.SECOND_CFG, 1 << 17, 1_000_000
    b, wlen = scfg.sample_count, scfg.window_len_ms
    age = torch.randint(-1, 2 * b + 2, (rows_n, b), generator=gen, device=dev, dtype=i32)
    ws = (now - now % wlen) - age * wlen
    second = ma.MetricArrayState(
        torch.randint(0, 40, (rows_n, b, NUM_EVENTS), generator=gen, device=dev, dtype=i32),
        torch.randint(1, scfg.max_rt + 1, (rows_n, b), generator=gen, device=dev, dtype=i32),
        torch.where((age < 0) | (ws < 0), torch.full_like(ws, scfg.empty_ws), ws).to(i32).contiguous(),
    )
    # K4 reads the second window, the gauge and the slab; the minute window
    # is not read, so the second one stands in for it.
    stats = nodes.StatsState(second, second, torch.randint(0, 4, (rows_n,), generator=gen, device=dev, dtype=i32),
                             torch.zeros((rows_n, b), device=dev, dtype=i32),
                             torch.full((rows_n, b), scfg.empty_ws, device=dev, dtype=i32))
    z = np.zeros(rows_n, np.int32)
    table, _ = flow_table_from_numpy(
        (np.ones(rows_n, np.int32), np.full(rows_n, 20.0, np.float32), z, z, np.full(rows_n, 50, np.int32), z, z,
         np.zeros(rows_n, np.float32), z), None, dev)
    rng4 = np.random.default_rng(4)
    res = rng4.integers(0, rows_n, n).astype(np.int32)
    m = 8
    batch = flush.batch_from_numpy((
        np.int32(now), np.ones(n, bool), np.sort(rng4.integers(0, 400, n)).astype(np.int32) + now - 400,
        np.ones(n, np.int32), np.stack([res, res, np.full(n, -1), np.zeros(n)], axis=1).astype(np.int32),
        res[:, None].copy(), res[:, None].copy(), np.zeros(n, bool), np.ones(n, bool), np.ones(n, bool),
        np.full((n, 1), -1, np.int32), np.zeros(m, bool), np.full(m, now, np.int32), np.ones(m, np.int32),
        np.full((m, 4), -1, np.int32), np.zeros(m, np.int32), np.zeros(m, np.int32), np.zeros(m, np.int32),
        np.full((m, 1), -1, np.int32)), dev)
    small = batch._replace(**{f: getattr(batch, f)[:8] for f in batch._fields if f.startswith("e_")})
    profiled("k4", lambda: flush.flow_admission(stats, table, batch, 8))
    out["k4_kernel_us"] = kernel_times(lambda: flush.flow_admission(stats, table, batch, 8))
    profiled("k4_small", lambda: flush.flow_admission(stats, table, small, 8))

    # K6: the same entries, every one inbound and live, against row 0.
    sysdev = flush.SystemDevice(0.3 * n, 0.15 * n, float("inf"), 1.0, 0.5, 5.0, 0.9)
    profiled("k6", lambda: flush.system_check(stats, sysdev, batch, batch.e_valid))
    out["k6_kernel_us"] = kernel_times(lambda: flush.system_check(stats, sysdev, batch, batch.e_valid))
    profiled("k6_small", lambda: flush.system_check(stats, sysdev, small, small.e_valid))

    # K8: the same entries, one breaker each of 1,048,576 (40% OPEN, half of
    # those due), with and without the mesh's mask (half the breakers), at
    # 131,072 slots, at a mesh shard's 4,096 and at 8.
    ri = lambda lo, hi: rng4.integers(lo, hi, rows_n).astype(np.int32)
    dtable = tdt.degrade_table_from_numpy(
        (ri(0, 3), np.full(rows_n, 0.5, np.float32), np.full(rows_n, 0.5, np.float32), ri(2, 6),
         np.full(rows_n, 1000, np.int32), np.full(rows_n, 5000, np.int32), ri(50, 150)), dev)
    ddyn = tdt.degrade_state_from_numpy(
        (np.where(rng4.random(rows_n) < 0.4, 1, 0), now + ri(-2000, 2000), ri(0, 4), ri(4, 8),
         np.full(rows_n, now - now % 1000, np.int32)), dev)
    allowed = t(rng4.random(rows_n) < 0.5)
    dgid = t(rng4.integers(0, rows_n, (n, 1)).astype(np.int32))
    k8 = lambda m, mask=None: lambda: tdt.breaker_try_pass(dtable, ddyn, dgid[:m], batch.e_ts[:m], batch.e_valid[:m],
                                                           mask)
    profiled("k8", k8(n))
    profiled("k8_mask", k8(n, allowed))
    profiled("k8_mask_4096", k8(4096, allowed))
    profiled("k8_small", k8(8))

    # K15: the same 131,072 entries on Zipf(1.1) rows over 8 shards, the
    # flow grant (95% budgeted) and the borrow (30% of the slots), and 8.
    zrow = t(np.minimum(rng4.zipf(1.1, n), rows_n).astype(np.int32)[:, None] - 1)
    zb = batch._replace(e_rule_gid=zrow, e_check_row=zrow.clone())
    live15, occ15 = t(rng4.random(n) < 0.95), t(rng4.random((n, 1)) < 0.3)
    k15 = lambda m, grant: lambda: ici.mesh_split_spend(
        8, stats, table, flush.FlushBatch(*(getattr(zb, f)[:m] if f.startswith("e_") else getattr(zb, f)
                                            for f in flush.FlushBatch._fields)),
        grant, **(dict(live=live15[:m]) if grant else dict(occ_slot=occ15[:m])))
    profiled("k15", k15(n, True))
    out["k15_kernel_us"] = kernel_times(k15(n, True))
    profiled("k15_borrow", k15(n, False))
    out["k15_borrow_kernel_us"] = kernel_times(k15(n, False))
    profiled("k15_small", k15(8, True))
    grant15, borrow15 = k15(n, True), k15(n, False)
    profiled("k15_step", lambda: (grant15(), borrow15()))  # the grant then the borrow, as the mesh step calls them

    # The verdict tail: the entries after every stage (system 90% pass,
    # flow 70%, the breakers of K8's case with their probes), 10% occupied,
    # top-8 over the rows. K5: 10% of the slots borrow one of the next two
    # windows on the Zipf rows.
    sub = lambda b_, m: b_._replace(**{f: getattr(b_, f)[:m] for f in b_._fields if f.startswith("e_")})
    tb = batch._replace(e_dgid=dgid, e_auth_ok=t(rng4.random(n) < 0.97))
    occ = t(rng4.random(n) < 0.1)
    base = now - now % scfg.window_len_ms
    tgt = t((base + scfg.window_len_ms * rng4.integers(1, 3, (n, 1))).astype(np.int32))
    adm = flush.Admission(batch.e_valid[:, None].clone(), t(rng4.random(n) < 0.7), None, None, None, None, occ,
                          t(rng4.integers(0, 500, n).astype(np.int32)), occ[:, None].clone(), tgt)
    sys_ok = t(rng4.random(n) < 0.9)
    dslot, probe = tdt.breaker_try_pass(dtable, ddyn, dgid, batch.e_ts, batch.e_valid)
    ddyn_t = tdt.DegradeDynState(*(x.clone() for x in ddyn))

    zrows = batch.e_rows.clone()
    zrows[:, 1] = zrow[:, 0]
    tz = tb._replace(e_rows=zrows)  # the cluster rows on the Zipf law

    def tail(m, b_=tb, adm_=adm):  # the inputs are cut to m entries outside the timed call
        args = (sub(b_, m), flush.Admission(*(None if x is None else x[:m] for x in adm_)), sys_ok[:m], dslot[:m],
                probe[:m], ddyn_t, rows_n, 8)
        return lambda: flush.slot_chain_verdict(*args)

    occ5 = t(rng4.random((n, 1)) < 0.1)
    # On the Zipf rows with 8% passing the flow check, as chip_smoke.py's
    # Zipf case blocks most entries of its hot rows.
    adm_b = adm._replace(flow_pass=t(np.random.default_rng(41).random(n) < 0.08))

    def k5(m, crow=zrow):
        args = (stats, occ5[:m], tgt[:m], batch.e_acquire[:m], crow[:m])
        return lambda: flush.commit_borrow_slab(*args)

    for name, fn in (("tail", tail), ("k5", k5), ("tail_zipf", lambda m: tail(m, tz)),
                     ("tail_zipf_blocked", lambda m: tail(m, tz, adm_b)),
                     ("k5_uniform", lambda m: k5(m, batch.e_check_row))):
        profiled(name, fn(n))
        out[f"{name}_kernel_us"] = kernel_times(fn(n))
        if "_" not in name:
            profiled(f"{name}_small", fn(8))
    # How far cv_entry's last block scans for the k lowest untouched rows,
    # and how many entries the tail blocks.
    for name, a_ in (("tail_zipf", adm), ("tail_zipf_blocked", adm_b)):
        v = tail(n, tz, a_)()
        blocked = tz.e_valid & ~v.admitted & (tz.e_acquire > 0)
        touched = torch.zeros(rows_n, dtype=torch.bool, device=dev)
        touched[tz.e_rows[:, 1][blocked].long()] = True
        out[f"{name}_first_untouched_row"] = int((~touched).nonzero()[0, 0])
        out[f"{name}_blocked"] = int(blocked.sum())
    del stats, second, table, batch, small, dtable, ddyn, allowed, dgid, zb, tb, tz, adm, adm_b, ddyn_t, v
    torch.cuda.empty_cache()

    # K9 with its inputs: 16,384 rate-limiter items (slot 1 of every 8th of
    # 131,072 entries, K = 2) over 1,048,576 rules, every 8th a rate limiter
    # (count 20, queue 500 ms, cost 50 ms), the minute window of 131,072
    # rows; its first 8 items; one rule holding all 16,384 (K9 alone).
    rng9 = np.random.default_rng(9)
    nr9, n9, s9, rows9 = 1 << 20, 1 << 17, 1 << 14, 1 << 17
    z9 = np.zeros(nr9, np.int32)
    t9, d9 = flow_table_from_numpy(
        (np.ones(nr9, np.int32), np.full(nr9, 20.0, np.float32),
         np.where(np.arange(nr9) % 8 == 7, 2, 0).astype(np.int32),
         np.full(nr9, 500, np.int32), np.full(nr9, 50, np.int32), z9, z9, np.zeros(nr9, np.float32), z9),
        (np.full(nr9, -(10**9), np.int32), np.zeros(nr9, np.float32), np.full(nr9, -(10**9), np.int32)), dev)
    gen.manual_seed(9)
    mb = cfg.sample_count
    age = torch.randint(-1, 2 * mb + 2, (rows9, mb), generator=gen, device=dev, dtype=i32)
    ws = (now - now % cfg.window_len_ms) - age * cfg.window_len_ms
    minute = ma.MetricArrayState(
        torch.randint(0, 40, (rows9, mb, NUM_EVENTS), generator=gen, device=dev, dtype=i32),
        torch.randint(1, cfg.max_rt + 1, (rows9, mb), generator=gen, device=dev, dtype=i32),
        torch.where((age < 0) | (ws < 0), torch.full_like(ws, cfg.empty_ws), ws).to(i32).contiguous())
    t32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
    eidx9 = np.arange(s9) * 8 + 7
    gid9 = (rng9.integers(0, nr9 // 8, s9) * 8 + 7).astype(np.int32)
    ts9 = np.sort(now - 400 + rng9.integers(0, 400, s9))
    sb = tsh.ShapingBatch(torch.ones(s9, dtype=torch.bool, device=dev), t32(gid9), t32(gid9 % rows9), t32(eidx9),
                          t32(eidx9 * 2 + 1), t32(ts9), t32(np.ones(s9)))
    live9, ppc9 = t(rng9.random(n9) < 0.95), t32(rng9.integers(0, 40, 2 * n9))
    rounds9 = _rounds_bucket(gid9)

    def k9_at(m):
        sb_m = tsh.ShapingBatch(*(f[:m] for f in sb))
        if hasattr(tsh, "shaping_stage"):
            return lambda: tsh.shaping_stage(t9, d9, sb_m, live9, ppc9, minute, 1.0, rounds9)

        def two_calls():  # the inputs, then the recurrence
            valid, ppc_s, prev_s = tsh.shaping_inputs(sb_m, live9, ppc9, minute)
            return tsh.run_shaping(t9, d9, sb_m._replace(valid=valid), ppc_s, prev_s, 1.0, rounds9)

        return two_calls

    profiled("k9", k9_at(s9))
    out["k9_kernel_us"] = kernel_times(k9_at(s9))
    profiled("k9_small", k9_at(8))
    heavy = sb._replace(gid=t32(np.full(s9, 7)))
    ppc_h, prev_h = t32(rng9.integers(0, 40, s9)), t32(rng9.integers(0, 40, s9))
    out["k9_heavy_ms"] = time_ms(lambda: tsh.run_shaping(t9, d9, heavy, ppc_h, prev_h, 1.0, 0), iters=3, warmup=1)
    del t9, d9, minute, sb, heavy
    torch.cuda.empty_cache()

    # K10: chip_smoke.py's mixed shape, 32,768 items over 16,384 rows.
    rng10 = np.random.default_rng(10)
    s, p_rows = 1 << 15, 1 << 14
    prow = rng10.integers(0, p_rows, s).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
    pb = tpt.ParamBatch(
        valid=torch.ones(s, dtype=torch.bool, device=dev), prow=t(prow), eidx=t(np.arange(s) * 4),
        ts=t(np.sort(now - 400 + rng10.integers(0, 400, s))), acquire=t(np.ones(s)), grade=t(np.ones(s)),
        behavior=t(np.zeros(s)), token_count=t(np.full(s, 100)), burst=t(np.zeros(s)),
        duration_ms=t(np.full(s, 1000)), maxq=t(np.zeros(s)), cost_ms=t(np.zeros(s)), reset_rows=t(np.full(8, -1)),
        exit_rows=t(np.full(8, -1)))
    pdyn = tpt.make_param_state(p_rows, dev)
    rounds = _rounds_bucket(prow)
    pb8 = pb._replace(**{f: getattr(pb, f)[:8] for f in tpt.ParamBatch._fields[:12]})
    profiled("k10", lambda: tpt.run_param(pdyn, pb, rounds))
    out["k10_kernel_us"] = kernel_times(lambda: tpt.run_param(pdyn, pb, rounds))
    profiled("k10_small", lambda: tpt.run_param(pdyn, pb8, 0))
    del pb, pdyn, pb8
    torch.cuda.empty_cache()

    # K12: a token server's state, 65,536 flows in 16 namespaces.
    counts = rng.integers(50, 501, TD_FLOWS).astype(np.float32)
    st = ma.make_state(TD_FLOWS + TD_NS, tts.CLUSTER_CFG, dev)
    for step in range(20):
        tts.batch_decide(st, *token_batch(rng, counts, dev), 1000 + 50 * step)
    for name, bsz in (("k12", TD_B), ("k12_small", 8)):
        arrays = token_batch(rng, counts, dev, bsz)
        fn = lambda: tts.batch_decide(st, *arrays, 2000)
        out[f"{name}_ms"] = time_ms(fn)
        (out[f"{name}_launches_per_call"], out[f"{name}_memsets_per_call"],
         out[f"{name}_device_ms"]) = device_profile(fn)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
