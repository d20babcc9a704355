"""Traffic-shaping controllers: RateLimiter, WarmUp, WarmUpRateLimiter
(port of ``sentinel_tpu/rules/shaping.py``).

The three behaviors carry per-rule state across requests:
``latestPassedTime`` for the leaky-bucket pacer (RateLimiterController.
java:28-90), ``storedTokens``/``lastFilledTime`` for the warm-up ramp
(WarmUpController.java:84-175, WarmUpRateLimiterController.java:25-90).
That makes them a recurrence over each rule's requests: the shaping slots
of a flush are gathered into a compact batch (:class:`ShapingBatch`),
sorted by (rule, ts, arrival) and resolved per rule segment.

:func:`run_shaping` (K9) takes the JAX package's three modes: ``rounds >
0`` resolves at most that many items per rule, ``rounds == 0`` all of
them, and ``rounds == -1`` is the closed-form pacer path the engine
selects when every item is a plain RATE_LIMITER at one timestamp with
one acquire >= 1. :func:`shaping_stage` is what the flush runs: the
inputs (:func:`shaping_inputs`) and then :func:`run_shaping`. On CUDA
tensors each is one host call of ``csrc/shaping_scan.cu`` (one block up
to ``SHAPING_SMALL_MAX`` items; else one CUB sort of a packed (rule, ts)
key, the segment heads and the records in sorted order, then one thread,
or for a long segment one warp, per rule walking its items, or one thread
per item for the closed form); on CPU tensors each runs its plain
version.

Numerics follow the JAX reference on the CPU statement by statement:
float32 throughout, the warm-up line ``above * slope + 1/count`` and the
pacer's ``acquire / qps * 1000 + 0.5`` fused into one FMA (XLA contracts
them there), saturating float->int32 conversion, wrapping int32 times,
floor division and modulo.

The host mirrors (:func:`mirror_pacer_cost`, :func:`mirror_shaping_decide`,
:func:`mirror_pacer_bulk`) are the numpy twins the failover and
speculative tiers decide with.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.metrics import nodes as _nodes
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.rules.flow_table import FlowRuleDynState, FlowTableDevice
from sentinel_tpu_torch.rules.recurrence import run_segmented, sort_order
from sentinel_tpu_torch.utils import cuda_build
from sentinel_tpu_torch.utils.numeric import add_i32, f32_to_i32, fma_f32, mul_i32, sub_i32


class ShapingBatch(NamedTuple):
    """Compact per-slot arrays for shaping-controlled rule slots;
    ``flat_pos`` indexes the [N*K] slot matrix."""

    valid: torch.Tensor  # bool [S]
    gid: torch.Tensor  # int32 [S] rule id
    row: torch.Tensor  # int32 [S] check-node row
    eidx: torch.Tensor  # int32 [S] entry index
    flat_pos: torch.Tensor  # int32 [S] position in the [N*K] slot matrix
    ts: torch.Tensor  # int32 [S]
    acquire: torch.Tensor  # int32 [S]


def shaping_batch_from_numpy(sb, device) -> ShapingBatch:
    """A :class:`ShapingBatch` on ``device`` from numpy arrays in the same
    field order (``jax.device_get`` of the JAX package's)."""
    return ShapingBatch(*(
        torch.tensor(np.asarray(a, dtype=np.bool_ if name == "valid" else np.int32), device=device)
        for name, a in zip(ShapingBatch._fields, sb)
    ))


def _f(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _pacer_cost(acq_f, acq_i, cnt, c1) -> torch.Tensor:
    """RateLimiter pacing cost in ms (int32): the host-computed exact
    ``cost1`` when acquire == 1, else round(acquire / count * 1000)."""
    q = acq_f / torch.maximum(cnt, _f(1e-9, cnt))
    cost_generic = torch.floor(fma_f32(q, _f(1000.0, q), _f(0.5, q)))
    return f32_to_i32(torch.where(acq_i == 1, c1.to(torch.float32), cost_generic))


def _transition(latest, stored, lastfill, x):
    """One item's controller decision and state update, element-wise over
    a vector of items. Invalid items are identity on state with ok = True.
    Returns (ok, wait_out, latest', stored', lastfill')."""
    (valid, ts, acq_f, acq, passq, prevq, b, cnt, mq, c1, wn, mx, sl, rt) = x
    zero = _f(0.0, cnt)
    is_wu = (b == C.CONTROL_BEHAVIOR_WARM_UP) | (b == C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER)

    # --- syncToken (WarmUpController.syncToken / coolDownTokens) ---
    sec = ts - torch.remainder(ts, 1000)
    do_sync = is_wu & (sec > lastfill) & valid
    elapsed = sub_i32(sec, lastfill).to(torch.float32)
    refill_ok = (stored < wn) | ((stored > wn) & (prevq < rt))
    refilled = torch.minimum(torch.floor(stored + elapsed * cnt / _f(1000.0, cnt)), mx)
    stored1 = torch.where(do_sync & refill_ok, refilled, stored)
    stored2 = torch.where(do_sync, torch.maximum(stored1 - prevq, zero), stored1)
    lastfill2 = torch.where(do_sync, sec, lastfill)

    # --- warm-up admitted QPS above the warning line ---
    above = torch.maximum(stored2 - wn, zero)
    inv = fma_f32(above, sl, _f(1.0, cnt) / torch.maximum(cnt, _f(1e-9, cnt)))
    warning_qps = torch.nextafter(_f(1.0, cnt) / inv, _f(float("inf"), cnt))
    cold = stored2 >= wn
    wu_ok = torch.where(cold, passq + acq_f <= warning_qps, passq + acq_f <= cnt)

    # --- pacer cost (RateLimiter / WarmUpRateLimiter) ---
    cost_rl = _pacer_cost(acq_f, acq, cnt, c1).to(torch.float32)
    cost_wurl_cold = torch.floor(fma_f32(acq_f / warning_qps, _f(1000.0, cnt), _f(0.5, cnt)))
    cost_wurl = torch.where(cold, cost_wurl_cold, cost_rl)
    cost = f32_to_i32(torch.where(b == C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER, cost_wurl, cost_rl))

    expected = add_i32(latest, cost)
    imm = expected <= ts
    wait = sub_i32(expected, ts)
    queued = ~imm & (wait <= mq)
    pacer_ok = (imm | queued) & (cnt > 0)
    pacer_ok = pacer_ok | (acq <= 0)  # acquire <= 0 always passes
    latest2 = torch.where(valid & pacer_ok & (acq > 0), torch.where(imm, ts, expected), latest)
    wait_out = torch.where(queued & pacer_ok, wait, torch.zeros_like(wait))

    is_pacer = (b == C.CONTROL_BEHAVIOR_RATE_LIMITER) | (b == C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER)
    ok = torch.where(b == C.CONTROL_BEHAVIOR_WARM_UP, wu_ok, torch.where(is_pacer, pacer_ok, torch.ones_like(wu_ok)))
    ok = ok | ~valid
    wait_out = torch.where(valid & is_pacer, wait_out, torch.zeros_like(wait_out))
    latest3 = torch.where(valid & is_pacer, latest2, latest)
    stored3 = torch.where(valid, stored2, stored)
    lastfill3 = torch.where(valid, lastfill2, lastfill)
    return ok, wait_out, latest3, stored3, lastfill3


def run_shaping(
    flow_dev: FlowTableDevice,
    flow_dyn: FlowRuleDynState,
    shaping: ShapingBatch,
    pass_consumed: torch.Tensor,  # int32 [S] windowed pass sum + intra-batch charge
    prev_pass: torch.Tensor,  # int32 [S] previous 1 s bucket's pass (minute window)
    interval_sec: float,
    rounds: int = 0,
) -> Tuple[FlowRuleDynState, torch.Tensor, torch.Tensor]:
    """Evaluate the shaping slots (K9); returns (flow_dyn, ok [S], wait_ms
    [S]) in the caller's slot order. ``flow_dyn`` is updated in place.
    ``interval_sec`` is the float32 the JAX code divides the pass by.
    ``rounds``: > 0 at most that many items per rule (the host's bound),
    0 every item, -1 the closed-form pacer path (valid only for the
    engine-verified shape; not re-checked here). A valid item whose rule
    id lies outside [0, nr) counts as invalid: ok, no wait, no state
    change (the JAX function walks it on the nearest rule's state; the
    flush sends no such id)."""
    if shaping.valid.is_cuda:
        s = shaping.valid.shape[0]
        ok = torch.empty(s, dtype=torch.bool, device=shaping.valid.device)
        wait = torch.empty(s, dtype=torch.int32, device=shaping.valid.device)
        _k9_call(flow_dev, flow_dyn, shaping, pass_consumed, prev_pass, None, None, None, interval_sec, rounds,
                 ok=ok, wait=wait)
        run_shaping.launches += 1
        return flow_dyn, ok, wait
    return run_shaping_plain(flow_dev, flow_dyn, shaping, pass_consumed, prev_pass, interval_sec, rounds)


run_shaping.launches = 0


def run_shaping_plain(flow_dev, flow_dyn, shaping, pass_consumed, prev_pass, interval_sec, rounds=0):
    """Plain PyTorch version of :func:`run_shaping`."""
    s = shaping.valid.shape[0]
    nr = flow_dev.n_rules
    dev = shaping.valid.device
    f32 = torch.float32
    valid = shaping.valid & (shaping.gid >= 0) & (shaping.gid < nr)
    gid_key = torch.where(valid, shaping.gid, torch.full_like(shaping.gid, nr))
    p_s = sort_order(gid_key, shaping.ts)
    gid_s = gid_key[p_s]
    ts_s = shaping.ts[p_s]
    gid_c = gid_s.clamp(0, nr - 1).long()
    valid_s = valid[p_s]
    acq_i = shaping.acquire[p_s]
    acq_s = acq_i.to(f32)
    passq_s = torch.floor(pass_consumed[p_s].to(f32) / _f(interval_sec, acq_s))
    prevq_s = prev_pass[p_s].to(f32)

    count = flow_dev.count[gid_c]
    maxq = flow_dev.max_queueing_time_ms[gid_c]
    cost1 = flow_dev.cost1_ms[gid_c]
    seg_latest = flow_dyn.latest_passed_time[gid_c]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    new_grp = torch.cat([one, gid_s[1:] != gid_s[:-1]])
    seg_end = torch.cat([gid_s[1:] != gid_s[:-1], one]) & valid_s
    ends = gid_c[seg_end]

    if rounds == -1:
        # Closed-form pacer path: with one ts per rule, at most the first
        # grant is immediate, and each later grant queues one more cost
        # out, so admission is rank math on the segment-start state.
        idx = torch.arange(s, device=dev)
        seg_start = torch.cummax(torch.where(new_grp, idx, torch.zeros_like(idx)), 0).values
        r1 = (idx - seg_start + 1).to(torch.int32)
        cost = _pacer_cost(acq_s, acq_i, count, cost1)
        latest0 = seg_latest
        imm0 = add_i32(latest0, cost) <= ts_s
        gate = count > 0
        big = torch.full_like(cost, 1 << 30)
        zero = torch.zeros_like(cost)
        safe_cost = cost.clamp(min=1)
        g_imm = torch.where(cost > 0, 1 + torch.div(maxq, safe_cost, rounding_mode="floor"), big)
        g_queue = torch.where(
            cost > 0,
            torch.div(sub_i32(add_i32(ts_s, maxq), latest0), safe_cost, rounding_mode="floor").clamp(min=0),
            torch.where(sub_i32(latest0, ts_s) <= maxq, big, zero),
        )
        cap = torch.where(gate, torch.where(imm0, g_imm, g_queue), zero)
        ok_s = (valid_s & (r1 <= cap)) | ~valid_s
        wait_r = torch.where(imm0, mul_i32(r1 - 1, cost), sub_i32(add_i32(latest0, mul_i32(r1, cost)), ts_s))
        wait_s = torch.where(valid_s & ok_s & (wait_r > 0), wait_r, zero)
        granted = torch.minimum(r1, cap)
        latest_here = torch.where(
            granted > 0,
            torch.where(imm0, add_i32(ts_s, mul_i32(granted - 1, cost)), add_i32(latest0, mul_i32(granted, cost))),
            latest0,
        )
        flow_dyn.latest_passed_time[ends] = latest_here[seg_end]
    else:
        items = (
            valid_s, ts_s, acq_s, acq_i, passq_s, prevq_s,
            flow_dev.behavior[gid_c], count, maxq, cost1,
            flow_dev.warmup_warning_token[gid_c].to(f32), flow_dev.warmup_max_token[gid_c].to(f32),
            flow_dev.warmup_slope[gid_c], flow_dev.warmup_refill_threshold[gid_c].to(f32),
        )

        def transition(states, x):
            ok, wait, l2, s2, f2 = _transition(*states, x)
            return (ok, wait), (l2, s2, f2)

        seg_states = (seg_latest, flow_dyn.stored_tokens[gid_c], flow_dyn.last_filled_time[gid_c])
        ok_s, wait_s, (lat_s, sto_s, lf_s) = run_segmented(new_grp, seg_states, items, transition, rounds)
        flow_dyn.latest_passed_time[ends] = lat_s[seg_end]
        flow_dyn.stored_tokens[ends] = sto_s[seg_end]
        flow_dyn.last_filled_time[ends] = lf_s[seg_end]

    ok_out = torch.ones(s, dtype=torch.bool, device=dev)
    wait_out = torch.zeros(s, dtype=torch.int32, device=dev)
    ok_out[p_s] = ok_s
    wait_out[p_s] = wait_s.to(torch.int32)
    return flow_dyn, ok_out, wait_out


# ---------------------------------------------------------------------------
# the flush's inputs to K9 (flush.py:759-764 and _prev_second_pass :583)
# ---------------------------------------------------------------------------


def shaping_inputs(shaping: ShapingBatch, live: torch.Tensor, ppc: torch.Tensor, minute) -> Tuple[
        torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the flush feeds :func:`run_shaping`: each item's validity
    masked by its entry's liveness (an entry an earlier stage blocked must
    not advance pacer state), its slot's windowed pass plus intra-batch
    charge (``ppc`` [N*K] from the flow admission), and the previous 1 s
    bucket's pass of its row in the minute window (``node.previousPassQps()``,
    StatisticNode.java:185). Returns (valid [S], pass_consumed [S],
    prev_pass [S])."""
    if shaping.valid.is_cuda:
        s = shaping.valid.shape[0]
        dev = shaping.valid.device
        valid = torch.empty(s, dtype=torch.bool, device=dev)
        out = torch.empty(2 * s, dtype=torch.int32, device=dev)
        _k9_call(None, None, shaping, None, None, live, ppc, minute, 1.0, 0, valid=valid, ppc_out=out[:s],
                 prev_out=out[s:])
        shaping_inputs.launches += 1
        return valid, out[:s], out[s:]
    return shaping_inputs_plain(shaping, live, ppc, minute)


shaping_inputs.launches = 0


def prev_second_pass(minute, rows: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """Pass count of the previous 1 s bucket of the minute window."""
    cfg = _nodes.MINUTE_CFG
    wlen, b = cfg.window_len_ms, cfg.sample_count
    tprev = sub_i32(ts, wlen)
    aligned = tprev - torch.remainder(tprev, wlen)
    idx = torch.remainder(torch.div(tprev, wlen, rounding_mode="floor"), b).long()
    rows_c = rows.clamp(0, minute.window_start.shape[0] - 1).long()
    ws = minute.window_start[rows_c, idx]
    val = minute.counts[rows_c, idx, 0]  # MetricEvent.PASS
    return torch.where(ws == aligned, val, torch.zeros_like(val))


def shaping_inputs_plain(shaping, live, ppc, minute):
    """Plain PyTorch version of :func:`shaping_inputs`."""
    n = live.shape[0]
    nk = ppc.shape[0]
    valid = shaping.valid & live[shaping.eidx.clamp(0, n - 1).long()]
    ppc_s = ppc[shaping.flat_pos.clamp(0, nk - 1).long()]
    return valid, ppc_s, prev_second_pass(minute, shaping.row, shaping.ts)


def shaping_stage(flow_dev: FlowTableDevice, flow_dyn: FlowRuleDynState, shaping: ShapingBatch,
                  live: torch.Tensor, ppc: torch.Tensor, minute, interval_sec: float, rounds: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9 with its inputs, as the flush's shaping stage runs it:
    :func:`shaping_inputs` then :func:`run_shaping` on the items of live
    entries, in one host call on the card. ``flow_dyn`` is updated in
    place. Returns (valid [S], ok [S], wait_ms [S]): the masked validity
    the stage scatters with, and the verdicts in item order."""
    if shaping.valid.is_cuda:
        s = shaping.valid.shape[0]
        dev = shaping.valid.device
        valid = torch.empty(s, dtype=torch.bool, device=dev)
        ok = torch.empty(s, dtype=torch.bool, device=dev)
        wait = torch.empty(s, dtype=torch.int32, device=dev)
        _k9_call(flow_dev, flow_dyn, shaping, None, None, live, ppc, minute, interval_sec, rounds, valid=valid,
                 ok=ok, wait=wait)
        shaping_stage.launches += 1
        return valid, ok, wait
    return shaping_stage_plain(flow_dev, flow_dyn, shaping, live, ppc, minute, interval_sec, rounds)


shaping_stage.launches = 0


def shaping_stage_plain(flow_dev, flow_dyn, shaping, live, ppc, minute, interval_sec, rounds=0):
    """Plain PyTorch version of :func:`shaping_stage`."""
    valid, ppc_s, prev_s = shaping_inputs_plain(shaping, live, ppc, minute)
    _, ok, wait = run_shaping_plain(flow_dev, flow_dyn, shaping._replace(valid=valid), ppc_s, prev_s,
                                    interval_sec, rounds)
    return valid, ok, wait


# ---------------------------------------------------------------------------
# K9 on the card: one host call (csrc/shaping_scan.cu, shaping_call)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int

# Items of the one-block route (the C side takes at most 8,192): above it
# prep, one CUB sort, the heads and the walk. On the H100 the one block's
# device time ties the many-block route's at 1,024 items and is 1.7x it at
# 2,048 (chip_smoke.py phase 2c's routes).
SHAPING_SMALL_MAX = 1024


class _ShArgs(ctypes.Structure):
    """The ``ShArgs`` of ``csrc/shaping_scan.cu``, field for field."""

    _fields_ = [(name, _P) for name in (
        "behavior", "count", "maxq", "cost1", "warn", "maxtok", "slope", "refill", "latest", "stored", "lastfill",
        "valid", "gid", "ts", "acq", "ppc", "prev", "live", "eidx", "flat_pos", "row", "mws", "mcounts", "ok",
        "wait", "valid_out", "ppc_out", "prev_out",
    )] + [(name, _I) for name in ("s", "nr", "rounds", "n", "nk", "r_rows", "nb", "ne", "wlen", "small_max")] + [
        ("interval_sec", ctypes.c_float)]


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("shaping_scan")
    if not getattr(lib, "_typed", False):
        lib.shaping_workspace.argtypes = [ctypes.POINTER(_ShArgs)]
        lib.shaping_workspace.restype = ctypes.c_longlong
        lib.shaping_call.argtypes = [ctypes.POINTER(_ShArgs), _P, ctypes.c_longlong, _P]
        lib.shaping_call.restype = _I
        lib._typed = True
    return lib


def _check(t: torch.Tensor, what: str, dtype, shape) -> None:
    if t.dtype != dtype or not t.is_contiguous() or not t.is_cuda or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: need a contiguous CUDA {dtype} tensor of shape {tuple(shape)}")


_FLOAT_TABLE = ("count", "warmup_slope")
_TABLE = ("behavior", "count", "max_queueing_time_ms", "cost1_ms", "warmup_warning_token", "warmup_max_token",
          "warmup_slope", "warmup_refill_threshold")  # what K9 reads, in ShArgs order

def _check_tables(flow_dev, flow_dyn, minute) -> None:
    """The rule table is checked once while the engine passes the same one
    flush after flush; the state (a copy on a flush that does not commit)
    and the minute window on every call."""
    if flow_dev is not None:
        nr = flow_dev.n_rules

        def check():
            for name in _TABLE:
                _check(getattr(flow_dev, name), f"flow_dev.{name}",
                       torch.float32 if name in _FLOAT_TABLE else torch.int32, (nr,))

        cuda_build.check_once("shaping", tuple(getattr(flow_dev, f) for f in _TABLE), check)
        for name, t in zip(FlowRuleDynState._fields, flow_dyn):
            _check(t, f"flow_dyn.{name}", torch.float32 if name == "stored_tokens" else torch.int32, (nr,))
    if minute is not None:
        ws, counts = minute.window_start, minute.counts
        _check(ws, "minute.window_start", torch.int32, (ws.shape[0], _nodes.MINUTE_CFG.sample_count))
        _check(counts, "minute.counts", torch.int32, (ws.shape[0], _nodes.MINUTE_CFG.sample_count, counts.shape[2]))


def _k9_call(flow_dev, flow_dyn, shaping, pass_consumed, prev_pass, live, ppc, minute, interval_sec, rounds,
             valid=None, ok=None, wait=None, ppc_out=None, prev_out=None) -> None:
    """One ``shaping_call``: with ``live`` the inputs are gathered (from
    ``ppc`` [N*K] by slot and the minute window), else ``pass_consumed``
    and ``prev_pass`` are the items'; without ``ok`` only the inputs are
    written. Checks only what the call reads."""
    s = shaping.valid.shape[0]
    gather = live is not None
    _check(shaping.valid, "shaping.valid", torch.bool, (s,))
    names = ("ts",) + (("eidx", "flat_pos", "row") if gather else ()) + (("gid", "acquire") if ok is not None else ())
    for name in names:
        _check(getattr(shaping, name), f"shaping.{name}", torch.int32, (s,))
    n = nk = 0
    if gather:
        n, nk = live.shape[0], ppc.shape[0]
        _check(live, "live", torch.bool, (n,))
        _check(ppc, "ppc", torch.int32, (nk,))
        if s and (n == 0 or nk == 0):
            raise ValueError("shaping inputs: items with no entries or slots to gather from")
    else:
        _check(pass_consumed, "pass_consumed", torch.int32, (s,))
        _check(prev_pass, "prev_pass", torch.int32, (s,))
    _check_tables(flow_dev, flow_dyn, minute if gather else None)
    if s == 0:
        return
    if s >= 2**28:
        raise ValueError("shaping: at most 2**28 - 1 items a call")
    ptr = lambda t: None if t is None else t.data_ptr()
    table = (None,) * 11 if flow_dev is None else (*(getattr(flow_dev, f) for f in _TABLE), *flow_dyn)
    run = ok is not None
    items = (shaping.valid, shaping.gid if run else None, shaping.ts, shaping.acquire if run else None,
             ppc if gather else pass_consumed, prev_pass)
    gathered = ((live, shaping.eidx, shaping.flat_pos, shaping.row, minute.window_start, minute.counts) if gather
                else (None,) * 6)
    r_rows, ne = (minute.window_start.shape[0], minute.counts.shape[2]) if gather else (0, 0)
    cfg = _nodes.MINUTE_CFG
    a = _ShArgs(
        *map(ptr, table + items + gathered + (ok, wait, valid, ppc_out, prev_out)),
        s, 0 if flow_dev is None else flow_dev.n_rules, int(rounds), n, nk, r_rows, cfg.sample_count, ne,
        cfg.window_len_ms, SHAPING_SMALL_MAX, float(np.float32(interval_sec)),
    )
    lib = _lib()
    dev = shaping.valid.device
    st = torch.cuda.current_stream(dev).cuda_stream
    with cuda_build.scratch(dev, st, int(lib.shaping_workspace(ctypes.byref(a)))) as (buf, size, _):
        cuda_build.check(lib.shaping_call(ctypes.byref(a), buf, size, st), "shaping_call")


# ---------------------------------------------------------------------------
# Host mirrors of the shaping controllers (numpy; the failover and
# speculative tiers decide with them)
# ---------------------------------------------------------------------------


def mirror_pacer_cost(acquire: int, count: float, cost1_ms: int) -> int:
    """Host twin of :func:`_pacer_cost`: the exact ``cost1_ms`` when
    acquire == 1, else the kernel's float32 formula."""
    if acquire == 1:
        return int(cost1_ms)
    acq = np.float32(acquire)
    cnt = np.float32(max(float(count), 1e-9))
    return int(np.floor(np.float32(np.float32(acq / cnt) * np.float32(1000.0)) + np.float32(0.5)))


def mirror_shaping_decide(st, info, ts: int, acquire: int) -> Tuple[bool, int]:
    """One host decision and state update for a shaping-governed slot,
    step for step as the device transition (syncToken refill, warm-up
    warning line, pacer cost and queueing). ``st`` is the mutable per-rule
    record (``latest``, ``stored``, ``lastfill``, ``pass_prev`` and a
    ``passq(ts)`` reader); ``info`` is ``FlowIndex.mirror_shaping_info``'s
    tuple. Returns ``(ok, wait_ms)``."""
    (_rule, behavior, count, maxq_ms, cost1_ms, warn, maxtok, slope, refill_thr) = info

    is_wu = behavior in (C.CONTROL_BEHAVIOR_WARM_UP, C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER)
    if is_wu:
        sec = ts - ts % 1000
        if sec > st.lastfill:
            prevq = float(st.pass_prev)
            refill_ok = st.stored < warn or (st.stored > warn and prevq < refill_thr)
            if refill_ok:
                elapsed = np.float32(sec - st.lastfill)
                refilled = np.floor(np.float32(
                    np.float32(st.stored)
                    + np.float32(np.float32(elapsed * np.float32(count)) / np.float32(1000.0))
                ))
                st.stored = float(min(refilled, np.float32(maxtok)))
            st.stored = float(np.maximum(np.float32(st.stored) - np.float32(prevq), np.float32(0.0)))
            st.lastfill = sec

    above = np.float32(max(st.stored - warn, 0.0))
    inv = np.float32(above * np.float32(slope) + np.float32(1.0) / np.float32(max(float(count), 1e-9)))
    warning_qps = float(np.nextafter(np.float32(np.float32(1.0) / inv), np.float32(np.inf)))
    cold = st.stored >= warn

    if behavior == C.CONTROL_BEHAVIOR_WARM_UP:
        interval_sec = _nodes.SECOND_CFG.interval_ms / 1000.0
        passq = float(math.floor(st.passq(ts) / interval_sec))
        limit = warning_qps if cold else float(count)
        return passq + acquire <= limit, 0

    if acquire <= 0:
        return True, 0  # acquire <= 0 always passes, no state change
    if count <= 0:
        return False, 0
    cost = mirror_pacer_cost(acquire, count, cost1_ms)
    if behavior == C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER and cold:
        cost = int(np.floor(
            np.float32(np.float32(np.float32(acquire) / np.float32(warning_qps)) * np.float32(1000.0))
            + np.float32(0.5)
        ))
    expected = st.latest + cost
    if expected <= ts:
        st.latest = ts  # an immediate grant pins latest to now
        return True, 0
    wait = expected - ts
    if wait <= maxq_ms:
        st.latest += cost
        return True, int(wait)
    return False, 0


def mirror_pacer_bulk(
    latest0: int, count: float, maxq_ms: int, cost: int, ts: int, ranks: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Closed-form host pacer for one bulk group's RATE_LIMITER slot, the
    host twin of the ``rounds == -1`` path (one timestamp, one acquire >=
    1). ``ranks`` are the 1-indexed grant ranks of the live rows. Returns
    ``(ok, wait_ms, latest')``."""
    n = ranks.shape[0]
    if count <= 0:
        return np.zeros(n, dtype=bool), np.zeros(n, dtype=np.int64), latest0
    big = 1 << 30
    imm0 = latest0 + cost <= ts
    if cost > 0:
        g_imm = 1 + maxq_ms // cost
        g_queue = max((ts + maxq_ms - latest0) // cost, 0)
    else:
        g_imm = big
        g_queue = big if latest0 - ts <= maxq_ms else 0
    cap = g_imm if imm0 else g_queue
    ok = ranks <= cap
    if imm0:
        wait = (ranks.astype(np.int64) - 1) * cost
    else:
        wait = latest0 + ranks.astype(np.int64) * cost - ts
    wait = np.where(ok & (wait > 0), wait, 0)
    granted = int(min(int(ranks.max(initial=0)), cap))
    if granted > 0:
        latest = ts + (granted - 1) * cost if imm0 else latest0 + granted * cost
    else:
        latest = latest0
    return ok, wait, int(latest)
