"""Circuit breakers, batched (port of ``sentinel_tpu/rules/degrade_table.py``).

The reference runs one CLOSED/OPEN/HALF_OPEN state machine per degrade
rule with a one-bucket sliding window of its own (reference:
AbstractCircuitBreaker.java:40-150, ExceptionCircuitBreaker.java:35-134,
ResponseTimeCircuitBreaker.java:34-120, DegradeSlot.java:37-90). Here
every breaker is one element of SoA tensors on the engine's device:

static (DegradeTableDevice):  grade / threshold / slow ratio / min
    request / stat interval / retry timeout / max allowed RT
dynamic (DegradeDynState):    state / next retry / bad / total / window start

Exit-side transitions are decided per prefix: the reference evaluates
the threshold after every completion, and an error ratio is not
monotone within a bucket, so (bad, total) are accumulated at every exit
in (rule, ts, arrival) order and a breaker opens at the FIRST prefix
that crosses. Entry-side probing admits one candidate per OPEN breaker
whose retry time has come (the earliest by (ts, slot)); the HALF_OPEN
transition is applied only when that entry is admitted end to end.

Kernels here, each beside its plain PyTorch version:

* :func:`breaker_on_exits` (K7): CUDA C++, ``csrc/breaker_on_exits.cu``,
  one host call (``BoArgs``);
* :func:`breaker_try_pass` (K8): CUDA C++, ``csrc/breaker_try_pass.cu``.

:func:`apply_probe_transitions` has a plain version only: on the card it
is fused into the verdict tail (``runtime/flush.py:slot_chain_verdict``),
which needs the final admission. State updates happen IN PLACE.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.models.rules import DegradeRule
from sentinel_tpu_torch.utils import cuda_build
from sentinel_tpu_torch.utils.numeric import pad_pow2
from sentinel_tpu_torch.utils.record_log import record_log

_NO_GIDS: list = []  # shared empty default for gids_for (never mutated)

# Breaker states (CircuitBreaker.State ordinals).
CLOSED = 0
OPEN = 1
HALF_OPEN = 2

_I32_MAX = 2**31 - 1
WS_FLOOR = -(10**9)  # window start of a breaker that has seen no exit


class DegradeTableDevice(NamedTuple):
    grade: torch.Tensor  # int32 [ND]
    threshold: torch.Tensor  # float32 [ND] rule count (ratio / count / RT)
    slow_ratio: torch.Tensor  # float32 [ND]
    min_request: torch.Tensor  # int32 [ND]
    interval_ms: torch.Tensor  # int32 [ND] statIntervalMs (per-rule window)
    retry_ms: torch.Tensor  # int32 [ND] timeWindow * 1000
    max_rt: torch.Tensor  # int32 [ND] Math.round(count) for RT breakers

    @property
    def n_rules(self) -> int:
        return self.grade.shape[0]


class DegradeDynState(NamedTuple):
    state: torch.Tensor  # int32 [ND]
    next_retry: torch.Tensor  # int32 [ND]
    bad: torch.Tensor  # int32 [ND] slow/error count in the current window
    total: torch.Tensor  # int32 [ND]
    ws: torch.Tensor  # int32 [ND] current window start


_FLOAT_FIELDS = ("threshold", "slow_ratio")


def degrade_table_from_numpy(table, device) -> DegradeTableDevice:
    """A breaker table on ``device`` from numpy arrays laid out as
    :class:`DegradeTableDevice` (``jax.device_get`` of the JAX table)."""
    return DegradeTableDevice(**{
        name: torch.tensor(np.asarray(a, dtype=np.float32 if name in _FLOAT_FIELDS else np.int32), device=device)
        for name, a in zip(DegradeTableDevice._fields, table)
    })


def degrade_state_from_numpy(dyn, device) -> DegradeDynState:
    """Breaker state tensors on ``device`` from numpy arrays (copied: the
    state is updated in place)."""
    return DegradeDynState(*(torch.tensor(np.asarray(a, dtype=np.int32), device=device) for a in dyn))


def degrade_state_to_numpy(dyn: DegradeDynState) -> DegradeDynState:
    return DegradeDynState(*(t.cpu().numpy() for t in dyn))


class DegradeIndex:
    """Host-side compiled degrade rules (the DegradeRuleManager's map)."""

    def __init__(self, rules: Sequence[DegradeRule], device) -> None:
        valid = []
        for r in rules:
            if r.is_valid():
                valid.append(r)
            else:
                record_log.warn("[DegradeIndex] Ignoring invalid degrade rule: %s", r)
        self.rules: List[DegradeRule] = valid
        self.by_resource: Dict[str, List[int]] = {}
        for gid, r in enumerate(valid):
            self.by_resource.setdefault(r.resource, []).append(gid)
        self._device = device
        self.device = self._build_device()

    def _build_device(self) -> DegradeTableDevice:
        n = pad_pow2(len(self.rules), 8)
        grade = [C.DEGRADE_GRADE_RT] * n
        thr = [float("inf")] * n
        slow_ratio = [1.0] * n
        min_req = [_I32_MAX] * n  # padding never trips
        interval = [1000] * n
        retry = [0] * n
        max_rt = [_I32_MAX] * n
        for gid, r in enumerate(self.rules):
            grade[gid] = r.grade
            thr[gid] = float(r.count)
            slow_ratio[gid] = float(r.slow_ratio_threshold)
            min_req[gid] = int(r.min_request_amount)
            interval[gid] = int(r.stat_interval_ms)
            retry[gid] = int(r.time_window) * 1000
            # Java: maxAllowedRt = Math.round(rule.getCount()).
            max_rt[gid] = int(r.count + 0.5)
        return degrade_table_from_numpy(
            (np.array(grade), np.array(thr), np.array(slow_ratio), np.array(min_req),
             np.array(interval), np.array(retry), np.array(max_rt)),
            self._device,
        )

    def make_dyn_state(self) -> DegradeDynState:
        n = self.device.n_rules

        def full(v):
            return torch.full((n,), v, dtype=torch.int32, device=self._device)

        return DegradeDynState(state=full(CLOSED), next_retry=full(0), bad=full(0), total=full(0), ws=full(WS_FLOOR))

    def gids_for(self, resource: str) -> List[int]:
        return self.by_resource.get(resource, _NO_GIDS)

    def rule_of_gid(self, gid: int):
        if 0 <= gid < len(self.rules):
            return self.rules[gid]
        return None


def mirror_any_open(mirror: np.ndarray, gids) -> bool:
    """True when any of ``gids`` is OPEN in the engine's host breaker
    mirror: the one read the degraded fallback and the speculative tier
    share (the engine keeps the mirror from the flushes' copy back)."""
    n = mirror.shape[0]
    for dg in gids:
        if 0 <= dg < n and mirror[dg] == OPEN:
            return True
    return False


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 two's-complement wrap (the JAX int32 overflow)."""
    return (((x + 2**31) % 2**32) - 2**31).to(torch.int32)


def trip_condition(grade, threshold, slow_ratio, bad, total) -> torch.Tensor:
    """The CLOSED -> OPEN threshold predicate in float32: RT breakers open
    when the slow ratio exceeds the configured ratio, with the ratio == 1.0
    boundary opening when the threshold is >= 1
    (ResponseTimeCircuitBreaker.java:120-130); exception ratio compares the
    ratio, exception count the count (ExceptionCircuitBreaker.java:110-134).
    min_request gating is the caller's."""
    one = torch.ones((), dtype=torch.float32, device=bad.device)
    ratio = bad / torch.maximum(total, one)
    is_rt = grade == C.DEGRADE_GRADE_RT
    is_exc_ratio = grade == C.DEGRADE_GRADE_EXCEPTION_RATIO
    rt_trip = (ratio > slow_ratio) | ((slow_ratio >= one) & (ratio >= one))
    return torch.where(is_rt, rt_trip, torch.where(is_exc_ratio, ratio > threshold, bad > threshold))


def _segment_cum(new_grp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Inclusive per-segment cumulative sum (segments flagged at their
    starts), as the JAX code computes it: a wrapping int32 cumsum minus a
    running max of the group-start exclusive values."""
    x = x.to(torch.int32)
    total = torch.cumsum(x.to(torch.int64), 0).to(torch.int32)
    excl = total - x
    base = torch.cummax(torch.where(new_grp, excl, torch.zeros_like(excl)), 0).values
    return total - base


def _order(major: torch.Tensor, minor: torch.Tensor) -> torch.Tensor:
    """The permutation sorting by (major, minor, position): a stable sort
    by the minor key, then a stable sort by the major key."""
    o1 = torch.sort(minor, stable=True).indices
    return o1[torch.sort(major[o1], stable=True).indices]


# ---------------------------------------------------------------------------
# K7: breaker_on_exits
# ---------------------------------------------------------------------------


def breaker_on_exits(ddev, dyn, x_dgid, x_ts, x_rt, x_err, x_valid) -> DegradeDynState:
    """onRequestComplete for a batch of completions (exit ops), in place:
    per breaker, the window roll, the cumulative (bad, total) over exits
    in (gid, ts, arrival) order, OPEN at the first prefix that crosses
    the threshold, and the HALF_OPEN probe outcome decided by the
    breaker's first completion. ``x_dgid`` int32 [M, KD] (-1 empty; a
    non-negative id must be < ND)."""
    if dyn.state.is_cuda:
        return _breaker_on_exits_cuda(ddev, dyn, x_dgid, x_ts, x_rt, x_err, x_valid)
    return breaker_on_exits_plain(ddev, dyn, x_dgid, x_ts, x_rt, x_err, x_valid)


breaker_on_exits.launches = 0


def breaker_on_exits_plain(ddev, dyn, x_dgid, x_ts, x_rt, x_err, x_valid) -> DegradeDynState:
    """Plain PyTorch version of :func:`breaker_on_exits`."""
    m, kd = x_dgid.shape
    nd = ddev.n_rules
    dev = x_dgid.device
    gid_f = x_dgid.reshape(-1)
    eidx = torch.arange(m * kd, device=dev) // kd
    valid = (gid_f >= 0) & x_valid[eidx]
    ts_f = x_ts[eidx]

    gid_key = torch.where(valid, gid_f, torch.full_like(gid_f, nd))
    p_s = _order(gid_key, ts_f)
    gid_s, ts_s = gid_key[p_s], ts_f[p_s]
    gid_c = gid_s.clamp(0, nd - 1).long()
    valid_s = valid[p_s]
    rt_s, err_s = x_rt[eidx][p_s], x_err[eidx][p_s]

    grade = ddev.grade[gid_c]
    is_rt = grade == C.DEGRADE_GRADE_RT
    bad_s = torch.where(is_rt, rt_s > ddev.max_rt[gid_c], err_s > 0) & valid_s
    one = torch.ones(1, dtype=torch.bool, device=dev)
    new_grp = torch.cat([one, gid_s[1:] != gid_s[:-1]])

    # ---- window rollover (per-rule interval, one bucket) ----
    iv = ddev.interval_ms[gid_c].clamp(min=1)
    aligned = ts_s - torch.remainder(ts_s, iv)
    ws_new = dyn.ws.clone()
    ws_new.scatter_reduce_(0, gid_c[valid_s], aligned[valid_s], reduce="amax")
    rolled = ws_new > dyn.ws
    zero_nd = torch.zeros_like(dyn.bad)
    base_bad = torch.where(rolled, zero_nd, dyn.bad)
    base_total = torch.where(rolled, zero_nd, dyn.total)
    # Exits from a superseded window do not count (sequentially the newer
    # request reset the bucket after them).
    in_win = valid_s & (aligned == ws_new[gid_c])

    inc = in_win.to(torch.int32)
    bad_inc = (bad_s & in_win).to(torch.int32)
    cum_total = _segment_cum(new_grp, inc)
    cum_bad = _segment_cum(new_grp, bad_inc)
    run_bad = (base_bad[gid_c] + cum_bad).to(torch.float32)
    run_total = (base_total[gid_c] + cum_total).to(torch.float32)

    # ---- CLOSED -> OPEN: the first prefix crossing the threshold ----
    trip = trip_condition(grade, ddev.threshold[gid_c], ddev.slow_ratio[gid_c], run_bad, run_total)
    crossing = in_win & (run_total >= ddev.min_request[gid_c].to(torch.float32)) & trip
    was_closed = dyn.state == CLOSED
    cross_eff = crossing & was_closed[gid_c]
    first_cross_ts = torch.full((nd,), _I32_MAX, dtype=torch.int32, device=dev)
    first_cross_ts.scatter_reduce_(0, gid_c[cross_eff], ts_s[cross_eff], reduce="amin")
    opened = first_cross_ts < _I32_MAX

    # ---- HALF_OPEN probe outcome: decided by the FIRST completion ----
    was_half = dyn.state == HALF_OPEN
    seg_start = new_grp & valid_s & was_half[gid_c]
    g_first = gid_c[seg_start]
    probe_bad = torch.zeros((nd,), dtype=torch.int32, device=dev)
    probe_bad.scatter_reduce_(0, g_first, bad_s[seg_start].to(torch.int32), reduce="amax")
    probe_seen = torch.zeros((nd,), dtype=torch.bool, device=dev)
    probe_seen[g_first] = True
    probe_ts = torch.zeros((nd,), dtype=torch.int32, device=dev)
    probe_ts.scatter_reduce_(0, g_first, ts_s[seg_start], reduce="amax")

    # ---- per-rule accumulation and state resolution ----
    total_new = base_total.index_add(0, gid_c[in_win], inc[in_win])
    bad_new = base_bad.index_add(0, gid_c[in_win], bad_inc[in_win])
    retry = ddev.retry_ms.to(torch.int64)
    close_open = was_closed & opened
    state = torch.where(close_open, OPEN, dyn.state).to(torch.int32)
    next_retry = torch.where(close_open, _wrap_i32(first_cross_ts.to(torch.int64) + retry), dyn.next_retry)
    half_to_open = was_half & probe_seen & (probe_bad > 0)
    half_to_close = was_half & probe_seen & (probe_bad == 0)
    state = torch.where(half_to_open, OPEN, state).to(torch.int32)
    next_retry = torch.where(half_to_open, _wrap_i32(probe_ts.to(torch.int64) + retry), next_retry)
    state = torch.where(half_to_close, CLOSED, state).to(torch.int32)
    total_new = torch.where(half_to_close, zero_nd, total_new)
    bad_new = torch.where(half_to_close, zero_nd, bad_new)
    for dst, src in ((dyn.state, state), (dyn.next_retry, next_retry), (dyn.bad, bad_new),
                     (dyn.total, total_new), (dyn.ws, ws_new)):
        dst.copy_(src)
    return dyn


# ---------------------------------------------------------------------------
# K8: breaker_try_pass, and apply_probe_transitions
# ---------------------------------------------------------------------------


def breaker_try_pass(ddev, dyn, e_dgid, e_ts, e_live, probe_allowed=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tryPass for a batch of entries. Returns (slot_ok [N, KD], probe_slot
    [N, KD]): a slot passes when its breaker is CLOSED, when it is the one
    probe of an OPEN breaker whose retry time has come (the earliest
    candidate by (ts, slot)), or when the slot is empty or its entry is not
    live. The caller applies the HALF_OPEN transition only for probes
    admitted end to end. ``probe_allowed`` (bool [ND], None = every
    breaker) restricts probe candidacy to the breakers this shard won in
    the sharded step's probe election (``parallel/ici.py``)."""
    if dyn.state.is_cuda:
        return _breaker_try_pass_cuda(ddev, dyn, e_dgid, e_ts, e_live, probe_allowed)
    return breaker_try_pass_plain(ddev, dyn, e_dgid, e_ts, e_live, probe_allowed)


breaker_try_pass.launches = 0
# Launches of K8 with a probe_allowed mask (a subset of ``launches``).
breaker_try_pass.mask_launches = 0


def breaker_try_pass_plain(ddev, dyn, e_dgid, e_ts, e_live, probe_allowed=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`breaker_try_pass`."""
    n, kd = e_dgid.shape
    nd = ddev.n_rules
    dev = e_dgid.device
    gid_f = e_dgid.reshape(-1)
    eidx = torch.arange(n * kd, device=dev) // kd
    valid = (gid_f >= 0) & e_live[eidx]
    ts_f = e_ts[eidx]
    gid_c = gid_f.clamp(0, nd - 1).long()
    st = dyn.state[gid_c]
    candidate = valid & (st == OPEN) & (ts_f >= dyn.next_retry[gid_c])
    if probe_allowed is not None:
        candidate = candidate & probe_allowed[gid_c]

    # The rank-0 candidate of each breaker, in (ts, slot) order, probes.
    gid_key = torch.where(candidate, gid_f, torch.full_like(gid_f, nd))
    p_s = _order(gid_key, ts_f)
    gid_s = gid_key[p_s]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    first_s = torch.cat([one, gid_s[1:] != gid_s[:-1]]) & (gid_s < nd)
    probe = torch.zeros(n * kd, dtype=torch.bool, device=dev)
    probe[p_s] = first_s
    ok = (st == CLOSED) | probe | ~valid
    return ok.reshape(n, kd), (probe & valid).reshape(n, kd)


def apply_probe_transitions_plain(dyn, e_dgid, probe_slot, admitted) -> DegradeDynState:
    """OPEN -> HALF_OPEN for probes whose entry was admitted end to end,
    in place (fused into the verdict tail on the card)."""
    go = probe_slot & admitted[:, None]
    dyn.state[e_dgid[go].long()] = HALF_OPEN
    return dyn


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib(name: str, setup) -> ctypes.CDLL:
    lib = cuda_build.load(name)
    if not getattr(lib, "_typed", False):
        setup(lib)
        lib._typed = True
    return lib


class _BoArgs(ctypes.Structure):
    """The ``BoArgs`` of ``csrc/breaker_on_exits.cu``, field for field."""

    _fields_ = [(name, _P) for name in (
        "x_dgid", "x_ts", "x_rt", "x_err", "x_valid", *DegradeTableDevice._fields, *DegradeDynState._fields,
    )] + [(name, _I) for name in ("m", "kd", "nd", "small_max")]


def _setup_exits(lib) -> None:
    lib.breaker_on_exits_workspace.argtypes = [_I, _I, _I]
    lib.breaker_on_exits_workspace.restype = ctypes.c_longlong
    lib.breaker_on_exits.argtypes = [ctypes.POINTER(_BoArgs), _P, ctypes.c_longlong, _P, ctypes.c_longlong, _P]
    lib.breaker_on_exits.restype = _I


def _setup_try(lib) -> None:
    lib.breaker_try_pass.argtypes = [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, ctypes.c_longlong, _P, _P, _I, _P]
    lib.breaker_try_pass.restype = _I


def _check(t: torch.Tensor, what: str, dtype, shape=None) -> None:
    if t.dtype != dtype or not t.is_contiguous() or not t.is_cuda or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{what}: need a contiguous CUDA {dtype} tensor" + (f" of shape {tuple(shape)}" if shape else ""))


def _check_tables(ddev, dyn) -> None:
    """The (ddev, dyn) pair, checked once while the engine passes the same
    tensors flush after flush (they are updated in place)."""
    nd = ddev.n_rules

    def check():
        for name, t in zip(DegradeTableDevice._fields, ddev):
            _check(t, f"ddev.{name}", torch.float32 if name in _FLOAT_FIELDS else torch.int32, (nd,))
        for name, t in zip(DegradeDynState._fields, dyn):
            _check(t, f"dyn.{name}", torch.int32, (nd,))

    cuda_build.check_once("degrade_table", (*ddev, *dyn), check)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_BO_WORKSPACE: Dict[Tuple[int, int], int] = {}  # (slots, breakers) -> bytes


def _bo_workspace(lib, mk: int, nd: int) -> int:
    """Workspace bytes of K7's many-block route, asked of the C side once
    per shape."""
    got = _BO_WORKSPACE.get((mk, nd))
    if got is None:
        got = _BO_WORKSPACE[(mk, nd)] = int(lib.breaker_on_exits_workspace(mk, nd, 0))
    return got


# Exit slots of K7's one-block route (the C side takes at most 8,192):
# above it the sort is CUB's and the scan a single pass over many blocks,
# which take less device time from 1,024 slots up (chip_smoke.py 2b).
BREAKER_EXITS_SMALL_MAX = 512


def _breaker_on_exits_cuda(ddev, dyn, x_dgid, x_ts, x_rt, x_err, x_valid) -> DegradeDynState:
    """K7 in one host call: one block up to BREAKER_EXITS_SMALL_MAX slots,
    else a CUB sort, a single-pass scan and the write-back; two cells per
    breaker in the zeroed scratch, which the call leaves zeroed. No sort
    or allocation here."""
    m, kd = x_dgid.shape
    _check(x_dgid, "x_dgid", torch.int32, (m, kd))
    for name, t in (("x_ts", x_ts), ("x_rt", x_rt), ("x_err", x_err)):
        _check(t, name, torch.int32, (m,))
    _check(x_valid, "x_valid", torch.bool, (m,))
    _check_tables(ddev, dyn)
    mk = m * kd
    if mk == 0:
        return dyn
    lib = _lib("breaker_on_exits", _setup_exits)
    nd = ddev.n_rules
    a = _BoArgs(x_dgid.data_ptr(), x_ts.data_ptr(), x_rt.data_ptr(), x_err.data_ptr(), x_valid.data_ptr(),
                *(t.data_ptr() for t in ddev), *(t.data_ptr() for t in dyn), m, kd, nd, BREAKER_EXITS_SMALL_MAX)
    need = 0 if mk <= BREAKER_EXITS_SMALL_MAX else _bo_workspace(lib, mk, nd)
    zero_bytes = 16 * nd  # a crossing cell and a probe cell per breaker
    st = _stream(x_dgid)
    with cuda_build.scratch(x_dgid.device, st, need, zero_bytes) as (buf, size, zero):
        cuda_build.check(lib.breaker_on_exits(ctypes.byref(a), buf, size, zero, zero_bytes, st), "breaker_on_exits")
    breaker_on_exits.launches += 1
    return dyn


# Slots of K8's one-block route (the C side takes at most 8,192): above it
# the election and the verdicts are two launches over many blocks.
TRY_PASS_SMALL_MAX = 4096


def _breaker_try_pass_cuda(ddev, dyn, e_dgid, e_ts, e_live, probe_allowed=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8 in one host call: one block up to TRY_PASS_SMALL_MAX slots, else
    two launches; the election's cells are the zeroed scratch, which the
    kernel leaves zeroed."""
    n, kd = e_dgid.shape
    nd = ddev.n_rules
    _check(e_dgid, "e_dgid", torch.int32)
    _check(e_ts, "e_ts", torch.int32, (n,))
    _check(e_live, "e_live", torch.bool, (n,))
    _check_tables(ddev, dyn)
    if probe_allowed is not None:
        _check(probe_allowed, "probe_allowed", torch.bool, (nd,))
    dev = e_dgid.device
    out = torch.empty((2, n, kd), dtype=torch.bool, device=dev)  # slot_ok, probe_slot
    if n * kd == 0:
        return out[0], out[1]
    lib = _lib("breaker_try_pass", _setup_try)
    st = _stream(e_dgid)
    with cuda_build.scratch(dev, st, 0, 8 * nd) as (_, _, win):
        cuda_build.check(
            lib.breaker_try_pass(
                e_dgid.data_ptr(), e_ts.data_ptr(), e_live.data_ptr(), n, kd, nd, dyn.state.data_ptr(),
                dyn.next_retry.data_ptr(), None if probe_allowed is None else probe_allowed.data_ptr(), win, 8 * nd,
                out.data_ptr(), out[1].data_ptr(), TRY_PASS_SMALL_MAX, st,
            ),
            "breaker_try_pass",
        )
    breaker_try_pass.launches += 1
    if probe_allowed is not None:
        breaker_try_pass.mask_launches += 1
    return out[0], out[1]
