"""Hot-parameter flow control, batched (port of
``sentinel_tpu/rules/param_table.py``; reference ParamFlowChecker.java:
46-280, ParameterMetric.java:37-108).

The host interns every (rule, value) pair to a **param row**
(:class:`ParamIndex`, LRU-capped per rule like the reference's CacheMap)
whose state lives in SoA columns on the device (:class:`ParamDynState`):

    tokens / last_add   the simplified token bucket (passDefaultLocalCheck)
    latest              the throttle pacer (passThrottleLocalCheck)
    threads             per-value concurrency (FLOW_GRADE_THREAD)

Per-value checks are a recurrence over the value's requests:
:func:`run_param` (K10) sorts the flush's param slots by (row, ts,
arrival) and resolves each row's segment in order. Modes, as in the JAX
package: ``rounds > 0`` at most that many items per row, ``rounds == 0``
all of them, and ``rounds <= -1`` the closed-form rank path with
``-rounds`` timestamp sub-segments per row (the engine selects it when
every item is QPS-grade DEFAULT with one acquire >= 1). On CUDA tensors
it launches ``csrc/param_scan.cu``; on CPU tensors it runs
:func:`run_param_plain`.

Semantics as the reference, single-threaded: first-seen value =>
tokens = maxCount - acquire and pass; within a window decrement if
enough; past the window refill ``passTime * tokenCount / durationMs``
(integer division), clamp at maxCount, reject without touching state if
the balance would go negative; throttle cost round(1000 * acquire *
durationSec / tokenCount) computed on the host, first-seen passes free,
queueing accepts waits STRICTLY below maxQueueingTimeMs; per-value
thread grade ``++threadCount <= threshold`` for entries admitted end to
end, released at exit; hot items override the threshold per value.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.models.rules import ParamFlowRule
from sentinel_tpu_torch.rules.recurrence import run_segmented, sort_order
from sentinel_tpu_torch.utils import cuda_build
from sentinel_tpu_torch.utils.config import config
from sentinel_tpu_torch.utils.device import DeviceLike, resolve_device
from sentinel_tpu_torch.utils.numeric import add_i32, mul_i32, sub_i32
from sentinel_tpu_torch.utils.record_log import record_log

PARAM_NEVER = -(2**30)  # "no state yet" marker for last_add / latest

# Closed-form rank path: at most this many (row, ts) sub-segments per
# value row before the engine falls back to rounds or the scan.
PARAM_CLOSED_MAX_SEGMENTS = 8

# Cache-miss marker of the resolved-value fast path (identity compare).
_MISS = object()
_NO_TRIP = (0, 0, 0)


class ArgsColumns:
    """Columnar args for ``Engine.submit_bulk``: one value column per
    ``param_idx``, equivalent to a length-``n`` column of args tuples
    ``t`` with ``t[idx] = by_idx[idx][j]``. A ``param_idx`` absent from
    ``by_idx`` means "no value for that rule" (the rule passes)."""

    __slots__ = ("n", "by_idx")

    def __init__(self, n: int, by_idx: Dict[int, Sequence[object]]) -> None:
        self.n = int(n)
        for idx, col in by_idx.items():
            if len(col) != self.n:
                raise ValueError(f"ArgsColumns: column for param_idx {idx} has length {len(col)} != n={self.n}")
        self.by_idx = by_idx

    def __len__(self) -> int:
        return self.n


def _extract_arg(args: object, idx: int) -> object:
    """One entry's value for ``param_idx``; a bare scalar arg is a 1-tuple."""
    if isinstance(args, (list, tuple)):
        return args[idx] if idx < len(args) else None
    return args if idx == 0 else None


class ParamDynState(NamedTuple):
    tokens: torch.Tensor  # int32 [PR]
    last_add: torch.Tensor  # int32 [PR]
    latest: torch.Tensor  # int32 [PR]
    threads: torch.Tensor  # int32 [PR]


def make_param_state(n_rows: int, device: DeviceLike = None) -> ParamDynState:
    """Fresh param state on ``device``; None means the card, as for the
    engine (``utils/device.resolve_device``: no silent CPU)."""
    dev = resolve_device(device)
    return ParamDynState(
        tokens=torch.zeros((n_rows,), dtype=torch.int32, device=dev),
        last_add=torch.full((n_rows,), PARAM_NEVER, dtype=torch.int32, device=dev),
        latest=torch.full((n_rows,), PARAM_NEVER, dtype=torch.int32, device=dev),
        threads=torch.zeros((n_rows,), dtype=torch.int32, device=dev),
    )


def grow_param_state(state: ParamDynState, n_rows: int) -> ParamDynState:
    have = state.tokens.shape[0]
    if n_rows <= have:
        return state
    extra = make_param_state(n_rows - have, state.tokens.device)
    return ParamDynState(*(torch.cat([a, b]) for a, b in zip(state, extra)))


def param_state_from_numpy(dyn, device) -> ParamDynState:
    """A :class:`ParamDynState` on ``device`` from numpy arrays in its
    field order (``jax.device_get`` of the JAX package's)."""
    return ParamDynState(*(torch.tensor(np.asarray(a, dtype=np.int32), device=device) for a in dyn))


def param_state_to_numpy(dyn: ParamDynState) -> ParamDynState:
    return ParamDynState(*(t.cpu().numpy() for t in dyn))


class ParamBatch(NamedTuple):
    """Per-slot arrays for this flush's param checks ([S] each)."""

    valid: torch.Tensor  # bool
    prow: torch.Tensor  # int32 param state row
    eidx: torch.Tensor  # int32 entry index
    ts: torch.Tensor  # int32
    acquire: torch.Tensor  # int32
    grade: torch.Tensor  # int32 FLOW_GRADE_*
    behavior: torch.Tensor  # int32 DEFAULT or RATE_LIMITER
    token_count: torch.Tensor  # int32 threshold (hot-item resolved)
    burst: torch.Tensor  # int32
    duration_ms: torch.Tensor  # int32
    maxq: torch.Tensor  # int32 maxQueueingTimeMs
    cost_ms: torch.Tensor  # int32 host-computed throttle cost
    reset_rows: torch.Tensor  # int32 [Q] rows recycled by LRU eviction (-1 pad)
    exit_rows: torch.Tensor  # int32 [SX] thread-grade rows released by exits (-1 pad)


def param_batch_from_numpy(pb, device) -> ParamBatch:
    """A :class:`ParamBatch` on ``device`` from numpy arrays in its field
    order (``jax.device_get`` of the JAX package's)."""
    return ParamBatch(*(
        torch.tensor(np.asarray(a, dtype=np.bool_ if name == "valid" else np.int32), device=device)
        for name, a in zip(ParamBatch._fields, pb)
    ))


@dataclass
class ParamSlotInfo:
    """Host-side resolved slot (before encoding)."""

    prow: int
    grade: int
    behavior: int
    token_count: int
    burst: int
    duration_ms: int
    maxq: int
    cost_ms: int
    rule: Optional[ParamFlowRule] = None  # for block attribution
    value_key: str = ""  # interned value string

    def mirror_bucket(self) -> Tuple[float, float]:
        """``(capacity, window_ms)`` of the host token bucket that mirrors
        this value row's device budget (token_count + burst over
        duration_ms), for the degraded fallback and the speculative tier."""
        return float(self.token_count + self.burst), max(float(self.duration_ms), 1.0)


def _transition(tokens, last, latest, thr_used, x):
    """One param slot's check and state update, element-wise. Invalid
    items are identity on state with ok = True. Returns (ok, wait,
    tokens', last', latest', thr_used')."""
    (valid, ts, acq, grade, beh, tc, burst, dur, maxq, cost, g_threads) = x
    zero = torch.zeros_like(tokens)

    max_count = add_i32(tc, burst)
    never = last == PARAM_NEVER

    # --- token bucket (passDefaultLocalCheck) ---
    first_tokens = sub_i32(max_count, acq)
    pass_time = sub_i32(ts, last)
    refill_win = pass_time > dur
    to_add = torch.div(mul_i32(pass_time, tc), dur, rounding_mode="floor")
    new_qps = torch.where(add_i32(to_add, tokens) > max_count, first_tokens, sub_i32(add_i32(tokens, to_add), acq))
    spent = sub_i32(tokens, acq)
    tb_ok = torch.where(never, torch.ones_like(never), torch.where(refill_win, new_qps >= 0, spent >= 0))
    tb_ok = tb_ok & (tc > 0) & (acq <= max_count)
    tokens2 = torch.where(never, first_tokens, torch.where(refill_win, torch.where(new_qps >= 0, new_qps, tokens), spent))
    tokens2 = torch.where(tb_ok, tokens2, tokens)
    last2 = torch.where(tb_ok & (never | refill_win), ts, last)

    # --- throttle (passThrottleLocalCheck) ---
    t_never = latest == PARAM_NEVER
    expected = add_i32(latest, cost)
    th_imm = expected <= ts
    th_wait = sub_i32(expected, ts)
    th_q = ~th_imm & (th_wait < maxq)  # STRICT < (ParamFlowChecker.java:258)
    th_ok = (t_never | th_imm | th_q) & (tc > 0)
    latest2 = torch.where(t_never | th_imm, ts, torch.where(th_q, expected, latest))
    latest2 = torch.where(th_ok, latest2, latest)
    th_wait_out = torch.where(th_q & th_ok & ~t_never, th_wait.clamp(min=0), zero)

    # --- per-value thread grade ---
    thr_cnt = add_i32(g_threads, thr_used)
    thr_ok = add_i32(thr_cnt, 1) <= tc
    thr_used2 = add_i32(thr_used, thr_ok.to(torch.int32))

    is_qps = grade == C.FLOW_GRADE_QPS
    is_throttle = is_qps & (beh == C.CONTROL_BEHAVIOR_RATE_LIMITER)
    ok = torch.where(is_throttle, th_ok, torch.where(is_qps, tb_ok, thr_ok))
    ok = ok | ~valid
    wait = torch.where(is_throttle & valid, th_wait_out, zero)
    bucket = valid & is_qps & ~is_throttle
    tokens3 = torch.where(bucket, tokens2, tokens)
    last3 = torch.where(bucket, last2, last)
    latest3 = torch.where(valid & is_throttle, latest2, latest)
    thr_used3 = torch.where(valid & ~is_qps, thr_used2, thr_used)
    return ok, wait, tokens3, last3, latest3, thr_used3


def run_param(dyn: ParamDynState, pb: ParamBatch, rounds: int = 0) -> Tuple[ParamDynState, torch.Tensor, torch.Tensor]:
    """Evaluate the param slots (K10); returns (dyn, ok [S], wait_ms [S])
    in the caller's order, ``dyn`` updated in place. Rows recycled by LRU
    eviction (``pb.reset_rows``) are reset first. ``rounds``: > 0 at most
    that many items per row, 0 all of them, <= -1 the closed-form rank
    path with ``-rounds`` timestamp sub-segments per row (valid only for
    the engine-verified shape; not re-checked here)."""
    if pb.valid.is_cuda:
        return _run_param_cuda(dyn, pb, rounds)
    return run_param_plain(dyn, pb, rounds)


run_param.launches = 0


def run_param_plain(dyn: ParamDynState, pb: ParamBatch, rounds: int = 0):
    """Plain PyTorch version of :func:`run_param`."""
    s = pb.valid.shape[0]
    pr = dyn.tokens.shape[0]
    dev = pb.valid.device
    rr = pb.reset_rows
    rr = rr[(rr >= 0) & (rr < pr)].long()
    dyn.tokens[rr] = 0
    dyn.last_add[rr] = PARAM_NEVER
    dyn.latest[rr] = PARAM_NEVER
    dyn.threads[rr] = 0

    key = torch.where(pb.valid, pb.prow, torch.full_like(pb.prow, pr))
    p_s = sort_order(key, pb.ts)
    row_s = key[p_s]
    ts_s = pb.ts[p_s]
    row_c = row_s.clamp(0, pr - 1).long()
    valid_s = pb.valid[p_s]
    acq_s = pb.acquire[p_s]
    tc_s = pb.token_count[p_s]
    burst_s = pb.burst[p_s]
    dur_s = pb.duration_ms[p_s].clamp(min=1)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    new_grp = torch.cat([one, row_s[1:] != row_s[:-1]])
    ok_out = torch.ones(s, dtype=torch.bool, device=dev)
    wait_out = torch.zeros(s, dtype=torch.int32, device=dev)

    if rounds <= -1:
        # Closed-form rank path. Within one (row, ts) sub-segment the
        # refill window opens at most once, so the budget is avail =
        # never ? max_count : refill ? min(tokens + to_add, max_count) :
        # tokens, and with one acquire the greedy admit set is the first
        # floor(avail / acquire) items; the row state carries between the
        # at most -rounds sub-segments.
        nseg = -rounds
        idx = torch.arange(s, device=dev)
        new_sub = new_grp | torch.cat([one, ts_s[1:] != ts_s[:-1]])
        sub_start = torch.cummax(torch.where(new_sub, idx, torch.zeros_like(idx)), 0).values
        sub_rank = (idx - sub_start).to(torch.int32)
        sub_flag = new_sub.to(torch.int64)
        excl = torch.cumsum(sub_flag, 0) - sub_flag
        sub_idx = excl - torch.cummax(torch.where(new_grp, excl, torch.zeros_like(excl)), 0).values + sub_flag - 1
        last_of_sub = torch.cat([new_sub[1:], one])
        max_count = add_i32(tc_s, burst_s)
        gate = (tc_s > 0) & (acq_s <= max_count)
        ok_s = ~valid_s
        zero = torch.zeros_like(acq_s)
        for seg_i in range(nseg):
            in_seg = valid_s & (sub_idx == seg_i)
            cur_tokens = dyn.tokens[row_c]
            cur_last = dyn.last_add[row_c]
            never = cur_last == PARAM_NEVER
            pass_time = sub_i32(ts_s, cur_last)
            refill = pass_time > dur_s
            to_add = torch.div(mul_i32(pass_time, tc_s), dur_s, rounding_mode="floor")
            avail = torch.where(never, max_count,
                                torch.where(refill, torch.minimum(add_i32(cur_tokens, to_add), max_count), cur_tokens))
            cap = torch.where(gate, torch.div(avail, acq_s.clamp(min=1), rounding_mode="floor"), zero)
            ok_s = torch.where(in_seg, gate & (sub_rank < cap), ok_s)
            granted = torch.minimum(sub_rank + 1, cap)
            tok_here = torch.where(granted > 0, sub_i32(avail, mul_i32(granted, acq_s)), cur_tokens)
            last_here = torch.where((granted > 0) & (never | refill), ts_s, cur_last)
            w = in_seg & last_of_sub
            rows_w = row_c[w]
            dyn.tokens[rows_w] = tok_here[w]
            dyn.last_add[rows_w] = last_here[w]
        ok_out[p_s] = ok_s
        return dyn, ok_out, wait_out

    items = (
        valid_s, ts_s, acq_s, pb.grade[p_s], pb.behavior[p_s], tc_s, burst_s, dur_s,
        pb.maxq[p_s], pb.cost_ms[p_s], dyn.threads[row_c],
    )

    def transition(states, x):
        ok, wait, t2, l2, lt2, thr2 = _transition(*states, x)
        return (ok, wait), (t2, l2, lt2, thr2)

    seg_states = (dyn.tokens[row_c], dyn.last_add[row_c], dyn.latest[row_c], torch.zeros_like(acq_s))
    ok_s, wait_s, (tok_s, last_s, lat_s, _) = run_segmented(new_grp, seg_states, items, transition, rounds)
    seg_end = torch.cat([row_s[1:] != row_s[:-1], one]) & valid_s
    ends = row_c[seg_end]
    dyn.tokens[ends] = tok_s[seg_end]
    dyn.last_add[ends] = last_s[seg_end]
    dyn.latest[ends] = lat_s[seg_end]
    ok_out[p_s] = ok_s
    wait_out[p_s] = wait_s
    return dyn, ok_out, wait_out


# ---------------------------------------------------------------------------
# K10 on the card
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


class _PaArgs(ctypes.Structure):
    """The ``PaArgs`` of ``csrc/param_scan.cu``, field for field."""

    _fields_ = [(name, _P) for name in (
        "reset_rows", "valid", "prow", "ts", "acq", "grade", "beh", "tc", "burst", "dur", "maxq", "cost",
        "tokens", "last_add", "latest", "threads", "ok", "wait",
    )] + [(name, _I) for name in ("s", "q", "pr", "rounds")]


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("param_scan")
    if not getattr(lib, "_typed", False):
        lib.param_workspace.argtypes = [_I]
        lib.param_workspace.restype = ctypes.c_longlong
        lib.param_run.argtypes = [ctypes.POINTER(_PaArgs), _P, ctypes.c_longlong, _P]
        lib.param_run.restype = _I
        lib._typed = True
    return lib


def _check(t: torch.Tensor, what: str, dtype, shape) -> None:
    if t.dtype != dtype or t.shape != shape or not t.is_cuda or not t.is_contiguous():
        raise ValueError(f"{what}: need a contiguous CUDA {dtype} tensor of shape {tuple(shape)}")


def _run_param_cuda(dyn: ParamDynState, pb: ParamBatch, rounds: int):
    """K10 in one host call; scratch from the stream's workspace."""
    s = pb.valid.shape[0]
    pr = dyn.tokens.shape[0]
    for name in ParamBatch._fields[:12]:
        _check(getattr(pb, name), f"pb.{name}", torch.bool if name == "valid" else torch.int32, (s,))
    q = pb.reset_rows.shape[0]
    _check(pb.reset_rows, "pb.reset_rows", torch.int32, (q,))
    for name, t in zip(ParamDynState._fields, dyn):
        _check(t, f"dyn.{name}", torch.int32, (pr,))
    if s >= 2**28:
        raise ValueError("run_param: at most 2**28 - 1 items a call")
    dev = pb.valid.device
    ok = torch.empty(s, dtype=torch.bool, device=dev)
    wait = torch.empty(s, dtype=torch.int32, device=dev)
    lib = _lib()
    st = torch.cuda.current_stream(dev).cuda_stream
    a = _PaArgs(
        *(t.data_ptr() for t in (pb.reset_rows, pb.valid, pb.prow, pb.ts, pb.acquire, pb.grade, pb.behavior,
                                 pb.token_count, pb.burst, pb.duration_ms, pb.maxq, pb.cost_ms)),
        *(t.data_ptr() for t in dyn), ok.data_ptr(), wait.data_ptr(), s, q, pr, int(rounds),
    )
    with cuda_build.scratch(dev, st, int(lib.param_workspace(s))) as (buf, size, _):
        cuda_build.check(lib.param_run(ctypes.byref(a), buf, size, st), "param_run")
    run_param.launches += 1
    return dyn, ok, wait


# ---------------------------------------------------------------------------
# host index: value interning, LRU caps, hot items
# ---------------------------------------------------------------------------


class ParamIndex:
    """Host-side compiled hot-param rules and per-rule value interning.

    ``sketch_tier`` (runtime/sketch.SketchTier, optional) activates
    sketch-native resolution for rules with ``sketch_mode=True``: cold
    values get no dense row (they pass, and the device sketch tracks
    them); only values in the tier's promoted set intern into exact rows.
    Without a tier (or with it disarmed) sketch-mode rules dense-track
    every value, as in the JAX package."""

    def __init__(self, by_resource: Dict[str, List[ParamFlowRule]], sketch_tier=None) -> None:
        self.by_resource: Dict[str, List[Tuple[int, ParamFlowRule]]] = {}
        self.rules: List[ParamFlowRule] = []
        for res, rs in by_resource.items():
            lst = []
            for r in rs:
                gid = len(self.rules)
                self.rules.append(r)
                lst.append((gid, r))
            self.by_resource[res] = lst
        self._sketch_tier = sketch_tier
        self.sketch_gids = {
            gid for lst in self.by_resource.values() for gid, r in lst if getattr(r, "sketch_mode", False)
        }
        # resource -> sorted distinct param_idx of its sketch-mode rules:
        # the key-extraction map the tier's encode walks.
        self.sketch_idx_by_resource: Dict[str, Tuple[int, ...]] = {}
        if sketch_tier is not None and getattr(sketch_tier, "armed", False):
            for res, lst in self.by_resource.items():
                idxs = sorted(
                    {r.param_idx for _g, r in lst if getattr(r, "sketch_mode", False) and r.param_idx is not None}
                )
                if idxs:
                    self.sketch_idx_by_resource[res] = tuple(idxs)
        self._sketch_filtering = bool(self.sketch_idx_by_resource)
        # gid -> {value_key -> prow}; LRU by insertion-move.
        self._values: List[Dict[str, int]] = [dict() for _ in self.rules]
        # Per-rule resolved-value cache: value_key -> (prow, token_count, cost_ms).
        self._resolved: List[Dict[str, Tuple[int, int, int]]] = [dict() for _ in self.rules]
        self._use_value_cache = config.get_bool(config.HOST_FASTPATH, True)
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_evictions = 0
        self._hot: List[Dict[str, int]] = [
            {it.object: int(it.count) for it in r.param_flow_item_list} for r in self.rules
        ]
        self._caps: List[int] = [
            min(C.PARAM_FLOW_DEFAULT_CACHE_SIZE * max(1, int(r.duration_in_sec)), 200_000) for r in self.rules
        ]
        self._free_rows: List[int] = []
        self._next_row = 0
        self.pending_resets: List[int] = []

    @property
    def n_rows(self) -> int:
        return self._next_row

    def has_rules(self) -> bool:
        return bool(self.rules)

    def values_snapshot(self) -> dict:
        """JSON-able capture of the value->row interning state (per-gid
        value maps in LRU order, the free-row pool, the row high-water)."""
        return {
            "values": [list(v.items()) for v in self._values],
            "free_rows": list(self._free_rows),
            "next_row": self._next_row,
        }

    def adopt_values(self, snap) -> bool:
        """Install a :meth:`values_snapshot` into this index; False (never
        raising) when the index already interned values, the shape does
        not match the rule count, or a row assignment is inconsistent."""
        try:
            vals = snap["values"]
            free = [int(r) for r in snap["free_rows"]]
            nxt = int(snap["next_row"])
        except (KeyError, TypeError, ValueError):
            return False
        if not isinstance(vals, list) or len(vals) != len(self.rules):
            return False
        if nxt < 0 or any(not (0 <= r < nxt) for r in free):
            return False
        if any(self._values) or self._next_row or self._free_rows:
            return False
        seen: set = set(free)
        if len(seen) != len(free):
            return False
        adopted: List[Dict[str, int]] = []
        for per_gid in vals:
            d: Dict[str, int] = {}
            try:
                for key, row in per_gid:
                    row = int(row)
                    if not (0 <= row < nxt) or row in seen:
                        return False
                    seen.add(row)
                    d[str(key)] = row
            except (TypeError, ValueError):
                return False
            adopted.append(d)
        self._values = adopted
        self._free_rows = free
        self._next_row = nxt
        return True

    def _intern(self, gid: int, key: str) -> int:
        vals = self._values[gid]
        row = vals.get(key)
        if row is not None:
            del vals[key]  # LRU touch
            vals[key] = row
            return row
        if len(vals) >= self._caps[gid]:
            old_key = next(iter(vals))
            old_row = vals.pop(old_key)
            # The recycled row now means another value.
            self._resolved[gid].pop(old_key, None)
            self.pending_resets.append(old_row)
            self.cache_evictions += 1
            row = old_row
        elif self._free_rows:
            row = self._free_rows.pop()
        else:
            row = self._next_row
            self._next_row += 1
        vals[key] = row
        return row

    @staticmethod
    def _value_key(value: object) -> Optional[str]:
        if value is None:
            return None
        if hasattr(value, "param_flow_key"):
            value = value.param_flow_key()  # ParamFlowArgument equivalent
            if value is None:
                return None
        return str(value)

    def slots_for(self, resource: str, args: Sequence[object], max_slots: int = 64) -> List[ParamSlotInfo]:
        """Resolve the entry's param slots (ParamFlowChecker.passCheck: one
        check per rule per value; collections and arrays expand)."""
        out: List[ParamSlotInfo] = []
        for gid, r in self.by_resource.get(resource, ()):
            if r.param_idx is None or r.param_idx >= len(args):
                continue
            promoted = None
            if self._sketch_filtering and gid in self.sketch_gids:
                # Sketch-native rule: only promoted heavy hitters get a
                # dense slot; cold values pass (the sketch tracks them).
                promoted = self._sketch_tier.promoted_values.get(resource)
                if not promoted:
                    continue
            value = args[r.param_idx]
            values = list(value) if isinstance(value, (list, tuple, set, frozenset)) else [value]
            for v in values:
                key = self._value_key(v)
                if key is None or (promoted is not None and key not in promoted):
                    continue
                tc, cost = self._threshold_and_cost(gid, r, key)
                out.append(
                    ParamSlotInfo(
                        prow=self._intern(gid, key),
                        grade=r.grade,
                        behavior=r.control_behavior,
                        token_count=tc,
                        burst=int(r.burst_count),
                        duration_ms=int(r.duration_in_sec) * 1000,
                        maxq=int(r.max_queueing_time_ms),
                        cost_ms=cost,
                        rule=r,
                        value_key=key,
                    )
                )
                if len(out) >= max_slots:
                    record_log.warn("[ParamIndex] truncating param slots for %s at %d", resource, max_slots)
                    return out
        return out

    def _threshold_and_cost(self, gid: int, r: ParamFlowRule, key: str) -> Tuple[int, int]:
        """Hot-item-resolved threshold and the throttle cost for one value
        (Math.round(1.0 * 1000 * durationSec / count) for acquire = 1)."""
        tc = self._hot[gid].get(key, int(r.count))
        cost = (
            int(1000.0 * r.duration_in_sec / tc + 0.5)
            if r.control_behavior == C.CONTROL_BEHAVIOR_RATE_LIMITER and tc > 0
            else 0
        )
        return tc, cost

    def _resolve_value(self, gid: int, r: ParamFlowRule, key: str) -> Tuple[int, int, int]:
        tc, cost = self._threshold_and_cost(gid, r, key)
        trip = (self._intern(gid, key), tc, cost)
        self._resolved[gid][key] = trip
        return trip

    def _resolve_value_col(self, gid, r, values, n):
        """One rule's per-entry value column as ``(valid[n], prow[n],
        token_count[n], cost_ms[n])``; None when a value is a collection
        (callers fall back to the per-entry path).

        Fast path (``sentinel.tpu.host.fastpath``, default on): one dict
        get per request against the resolved-value cache; LRU recency is
        then refreshed by touching the column's distinct keys in sorted
        order, as the exact path does, so both paths evict the same rows.
        A column whose new values would evict restarts on the exact path."""
        if values is None:
            z = np.zeros(n, dtype=np.int32)
            return np.zeros(n, dtype=bool), z, z.copy(), z.copy()
        if self._sketch_filtering and gid in self.sketch_gids:
            return self._resolve_value_col_sketch(gid, r, values, n)
        if not self._use_value_cache:
            return self._resolve_value_col_exact(gid, r, values, n)
        rget = self._resolved[gid].get
        miss = _MISS
        trips = [rget(v, miss) if type(v) is str else miss for v in values]
        hits = n - trips.count(miss)
        misses = 0
        vals = self._values[gid]
        cap = self._caps[gid]
        extra_keys: List[str] = []
        j = 0
        while True:
            try:
                j = trips.index(miss, j)
            except ValueError:
                break
            v = values[j]
            if isinstance(v, (list, tuple, set, frozenset)):
                return None  # collection expansion: per-entry path
            key = self._value_key(v)
            if key is None:
                trips[j] = None
            else:
                trip = rget(key)
                if trip is None:
                    if key not in vals and len(vals) >= cap:
                        # A new key whose intern would evict: restart on the
                        # exact path before any eviction happens.
                        return self._resolve_value_col_exact(gid, r, values, n)
                    misses += 1
                    trip = self._resolve_value(gid, r, key)
                else:
                    hits += 1
                extra_keys.append(key)
                trips[j] = trip
            j += 1
        self.cache_hits += hits
        self.cache_misses += misses
        touch = {v for v in values if type(v) is str}
        touch.update(extra_keys)
        vals_pop = vals.pop
        for key in sorted(touch):
            row = vals_pop(key, None)
            if row is not None:
                vals[key] = row
        valid = np.fromiter((t is not None for t in trips), dtype=bool, count=n)
        if valid.all():
            arr = np.array(trips, dtype=np.int32).reshape(n, 3)
        else:
            arr = np.array([t if t is not None else _NO_TRIP for t in trips], dtype=np.int32).reshape(n, 3)
        return valid, arr[:, 0], arr[:, 1], arr[:, 2]

    def _resolve_value_col_sketch(self, gid, r, values, n):
        """Sketch-native column resolve: only values in the tier's
        promoted set intern into dense rows; every other value is invalid
        (the rule passes it). With nothing promoted no per-value work
        happens at all."""
        promoted = self._sketch_tier.promoted_values.get(r.resource)
        valid = np.zeros(n, dtype=bool)
        z = np.zeros(n, dtype=np.int32)
        if values is None or not promoted:
            return valid, z, z.copy(), z.copy()
        prow = np.zeros(n, dtype=np.int32)
        tc = np.zeros(n, dtype=np.int32)
        cost = np.zeros(n, dtype=np.int32)
        rget = self._resolved[gid].get
        for j, v in enumerate(values):
            if v is None:
                continue
            if isinstance(v, (list, tuple, set, frozenset)):
                return None  # collection expansion: per-entry path
            key = v if type(v) is str else self._value_key(v)
            if key is None or key not in promoted:
                continue
            trip = rget(key)
            if trip is None:
                trip = self._resolve_value(gid, r, key)
            valid[j] = True
            prow[j], tc[j], cost[j] = trip
        return valid, prow, tc, cost

    def release_value(self, resource: str, key: str) -> None:
        """Drop a sketch-mode rule's dense row for ``key`` and queue its
        reset (the inverse of a promotion intern)."""
        for gid, _r in self.by_resource.get(resource, ()):
            if gid not in self.sketch_gids:
                continue
            row = self._values[gid].pop(key, None)
            if row is None:
                continue
            self._resolved[gid].pop(key, None)
            self.pending_resets.append(row)
            self._free_rows.append(row)

    def _resolve_value_col_exact(self, gid, r, values, n):
        """Per-flush np.unique interning with an LRU touch per distinct
        value; also the fast path's reference."""
        col: List[Optional[str]] = [None] * n
        for j, v in enumerate(values):
            if v is None:
                continue
            if isinstance(v, (list, tuple, set, frozenset)):
                return None
            col[j] = self._value_key(v)
        arr_o = np.asarray(col, dtype=object)
        valid = np.asarray([c is not None for c in col], dtype=bool)
        prow = np.zeros(n, dtype=np.int32)
        tc = np.zeros(n, dtype=np.int32)
        cost = np.zeros(n, dtype=np.int32)
        if valid.any():
            uniq, inverse = np.unique(arr_o[valid].astype(str), return_inverse=True)
            u_prow = np.empty(len(uniq), dtype=np.int32)
            u_tc = np.empty(len(uniq), dtype=np.int32)
            u_cost = np.empty(len(uniq), dtype=np.int32)
            for u, key in enumerate(uniq):
                u_prow[u] = self._intern(gid, key)
                u_tc[u], u_cost[u] = self._threshold_and_cost(gid, r, key)
            prow[valid] = u_prow[inverse]
            tc[valid] = u_tc[inverse]
            cost[valid] = u_cost[inverse]
        return valid, prow, tc, cost

    def bulk_cols(self, resource: str, args_column: Sequence):
        """Columnar :meth:`slots_for` over a bulk group: one ``(rule,
        valid[n], prow[n], token_count[n], cost_ms[n])`` per param rule of
        the resource. ``args_column`` is per-entry args tuples or an
        :class:`ArgsColumns`. None when a value is a collection."""
        rules = self.by_resource.get(resource, ())
        if not rules:
            return []
        n = len(args_column)
        flat = isinstance(args_column, ArgsColumns)
        out = []
        for gid, r in rules:
            idx = r.param_idx
            if idx is None:
                values: Optional[Sequence[object]] = None
            elif flat:
                values = args_column.by_idx.get(idx)
            else:
                values = [_extract_arg(a, idx) for a in args_column]
            cols = self._resolve_value_col(gid, r, values, n)
            if cols is None:
                return None
            out.append((r,) + cols)
        return out

    def cache_stats(self) -> Dict[str, int]:
        return {
            "hits": self.cache_hits,
            "misses": self.cache_misses,
            "evictions": self.cache_evictions,
            "interned": sum(len(v) for v in self._values),
        }

    def take_resets(self) -> List[int]:
        out, self.pending_resets = self.pending_resets, []
        return out
