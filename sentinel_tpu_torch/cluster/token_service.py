"""The token decision engine (port of ``sentinel_tpu/cluster/token_service.py``).

Reference: DefaultTokenService.requestToken ->
ClusterFlowChecker.acquireClusterToken (ClusterFlowChecker.java:36-118)::

    globalThreshold = count x (GLOBAL ? 1 : connectedCount) x exceedCount
    latestQps = ClusterMetric.getAvg(PASS)
    nextRemaining = globalThreshold - latestQps - acquire
    pass -> metric.add(PASS); else BLOCKED

plus the per-namespace GlobalRequestLimiter QPS guard (default 30000/s)
and the NO_RULE_EXISTS / TOO_MANY_REQUEST statuses.

The server's per-flowId ClusterMetric windows are rows of one window state
on the cluster geometry (10 x 100 ms). A batch of requests is decided by
:func:`batch_decide` (K12): on the card one call of ``csrc/token_decide.cu``
(the gathered PASS sums, both stages and the PASS commit), on the CPU
:func:`batch_decide_plain`. Requests of one batch are charged in batch
order. The JAX package donates the state to its jitted pass; here it is
updated in place under ``DefaultTokenService._lock``, which
``flow_stats`` takes too.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.cluster.flow_rules import cluster_flow_rule_manager, cluster_server_config_manager
from sentinel_tpu_torch.metrics import metric_array as ma
from sentinel_tpu_torch.metrics.events import NUM_EVENTS, MetricEvent
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.utils import cuda_build
from sentinel_tpu_torch.utils.clock import Clock, default_clock
from sentinel_tpu_torch.utils.device import DeviceLike, resolve_device
from sentinel_tpu_torch.utils.numeric import add_i32, pad_pow2, sub_i32, wrap_i32

CLUSTER_CFG = ma.MetricArrayConfig(sample_count=10, interval_ms=1000)


class TokenResult(NamedTuple):
    """Reference: TokenResult.java (status, remaining, waitInMs, tokenId)."""

    status: C.TokenResultStatus
    remaining: int = 0
    wait_in_ms: int = 0
    token_id: int = 0

    @property
    def ok(self) -> bool:
        return self.status == C.TokenResultStatus.OK


class TokenService:
    """Reference: TokenService.java, with the concurrent-token surface."""

    def request_token(self, flow_id: int, acquire_count: int = 1, prioritized: bool = False) -> TokenResult:
        raise NotImplementedError

    def request_param_token(self, flow_id: int, acquire_count: int, params: List[object]) -> TokenResult:
        raise NotImplementedError

    def request_concurrent_token(
        self, flow_id: int, acquire_count: int = 1, client_address: str = "local"
    ) -> TokenResult:
        raise NotImplementedError

    def release_concurrent_token(self, token_id: int) -> TokenResult:
        raise NotImplementedError

    def request_tokens_batch(self, rows) -> List[TokenResult]:
        """rows: [(flow_id, acquire, prioritized)]."""
        return [self.request_token(f, a, p) for f, a, p in rows]

    def request_param_tokens_batch(self, rows) -> List[TokenResult]:
        """rows: [(flow_id, acquire, params)]."""
        return [self.request_param_token(f, a, ps) for f, a, ps in rows]


# ---------------------------------------------------------------------------
# K12: the batched decision
# ---------------------------------------------------------------------------


def batch_decide(
    state: ma.MetricArrayState,
    rows: torch.Tensor,  # int32 [B] metric row per request, in [0, n_rows)
    ns_rows: torch.Tensor,  # int32 [B] namespace-limiter row (-1 none)
    acquire: torch.Tensor,  # int32 [B]
    thresholds: torch.Tensor,  # float32 [B] global threshold per request
    ns_thresholds: torch.Tensor,  # float32 [B]
    valid: torch.Tensor,  # bool [B]
    now: int,
    atomic: bool = False,
) -> torch.Tensor:
    """One decision pass: the namespace guard, then the flow check, both
    charging earlier requests of the batch; admitted requests add PASS
    on their flow and namespace rows (in place). ``atomic`` commits all or
    nothing (a refused valid request charges none: the param path's
    check-all-then-charge-all). Returns one int32 [3, B] tensor: admitted,
    ns_ok and next_remaining (its float32 bits); see
    :func:`unpack_decision`."""
    if state.counts.is_cuda:
        return _batch_decide_cuda(state, rows, ns_rows, acquire, thresholds, ns_thresholds, valid, now, atomic)
    return batch_decide_plain(state, rows, ns_rows, acquire, thresholds, ns_thresholds, valid, now, atomic)


batch_decide.launches = 0


def unpack_decision(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(admitted, ns_ok, next_remaining) of a packed [3, B] decision."""
    return packed[0] != 0, packed[1] != 0, packed[2].view(torch.float32)


def _consumed(keys: torch.Tensor, acquire: torch.Tensor) -> torch.Tensor:
    """Charge of each request within its key group, in (key, position)
    order: the wrapping int32 cumsum minus the running max of the
    group-start values, as the JAX code computes it."""
    k_s, p_s = torch.sort(keys, stable=True)
    acq_s = acquire[p_s]
    excl = sub_i32(wrap_i32(torch.cumsum(acq_s.to(torch.int64), 0)), acq_s)
    head = torch.ones_like(k_s, dtype=torch.bool)
    head[1:] = k_s[1:] != k_s[:-1]
    grp = torch.cummax(torch.where(head, excl, torch.zeros_like(excl)), 0).values
    out = torch.zeros_like(excl)
    out[p_s] = sub_i32(excl, grp)
    return out


def batch_decide_plain(state, rows, ns_rows, acquire, thresholds, ns_thresholds, valid, now, atomic=False):
    """Plain PyTorch version of :func:`batch_decide`, in the kernel's order:
    the gathered PASS sums, both stages, then the roll-and-add commit of
    :func:`metric_array.update_plain`; the same packed result."""
    interval_sec = CLUSTER_CFG.interval_ms / 1000.0
    nrows = state.n_rows
    flow_sum = ma.window_reduce_plain(CLUSTER_CFG, state, now, rows)[0][:, MetricEvent.PASS]
    ns_sum = ma.window_reduce_plain(CLUSTER_CFG, state, now, ns_rows)[0][:, MetricEvent.PASS]
    dump = torch.full_like(rows, nrows)
    acq_f = acquire.to(torch.float32)

    ns_key = torch.where(valid & (ns_rows >= 0), ns_rows, dump)
    ns_qps = add_i32(ns_sum, _consumed(ns_key, acquire)).to(torch.float32) / interval_sec
    ns_ok = (ns_rows < 0) | (ns_qps + acq_f <= ns_thresholds)

    flow_key = torch.where(valid & ns_ok, rows, dump)
    latest_qps = add_i32(flow_sum, _consumed(flow_key, acquire)).to(torch.float32) / interval_sec
    next_remaining = thresholds - latest_qps - acq_f
    admitted = valid & ns_ok & (next_remaining >= 0)
    charged = admitted
    if atomic:
        charged = admitted & bool((admitted | ~valid).all())
    upd_rows = torch.cat([torch.where(charged, rows, dump), torch.where(charged & (ns_rows >= 0), ns_rows, dump)])
    deltas = torch.zeros((upd_rows.shape[0], NUM_EVENTS), dtype=torch.int32, device=rows.device)
    deltas[:, MetricEvent.PASS] = torch.cat([acquire, acquire])
    ma.update_plain(
        CLUSTER_CFG, state, upd_rows.clamp(0, nrows - 1), torch.full_like(upd_rows, int(now)), deltas, None,
        upd_rows < nrows,
    )
    return torch.stack([admitted.to(torch.int32), ns_ok.to(torch.int32), next_remaining.view(torch.int32)])


_P = ctypes.c_void_p
_I = ctypes.c_int


def _td_lib() -> ctypes.CDLL:
    lib = cuda_build.load("token_decide")
    if not getattr(lib, "_typed", False):
        lib.token_decide_workspace.argtypes = [_I]
        lib.token_decide_workspace.restype = ctypes.c_longlong
        lib.token_decide.argtypes = [_P] * 6 + [_I] * 3 + [ctypes.c_float, _I] + [_P] * 3 + [_I] * 4 + [_P] * 2 + [
            ctypes.c_longlong, _P]
        lib.token_decide.restype = _I
        lib._typed = True
    return lib


def _batch_decide_cuda(state, rows, ns_rows, acquire, thresholds, ns_thresholds, valid, now, atomic):
    b = rows.shape[0]
    for name, t, dt in (("rows", rows, torch.int32), ("ns_rows", ns_rows, torch.int32),
                        ("acquire", acquire, torch.int32), ("thresholds", thresholds, torch.float32),
                        ("ns_thresholds", ns_thresholds, torch.float32), ("valid", valid, torch.bool)):
        if t.dtype != dt or not t.is_contiguous() or not t.is_cuda or tuple(t.shape) != (b,):
            raise ValueError(f"batch_decide: {name} must be a contiguous CUDA {dt} tensor of shape ({b},)")
    for name, t in zip(ma.MetricArrayState._fields, state):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"batch_decide: state.{name} must be a contiguous int32 tensor")
    if b == 0:
        raise ValueError("batch_decide: an empty batch (the service pads it to at least 8)")
    lib = _td_lib()
    dev = rows.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((3, b), dtype=torch.int32, device=dev)
    cfg = CLUSTER_CFG
    with cuda_build.scratch(dev, stream, int(lib.token_decide_workspace(b))) as (buf, size, _):
        cuda_build.check(
            lib.token_decide(
                rows.data_ptr(), ns_rows.data_ptr(), acquire.data_ptr(), thresholds.data_ptr(),
                ns_thresholds.data_ptr(), valid.data_ptr(), b, int(now), cfg.interval_ms, cfg.interval_ms / 1000.0,
                int(atomic), state.counts.data_ptr(), state.min_rt.data_ptr(), state.window_start.data_ptr(),
                state.n_rows, cfg.sample_count, cfg.window_len_ms, cfg.max_rt, out.data_ptr(), buf, size, stream,
            ),
            "token_decide",
        )
    batch_decide.launches += 1
    return out


# ---------------------------------------------------------------------------
# the embedded service
# ---------------------------------------------------------------------------


class DefaultTokenService(TokenService):
    """In-process (embeddable) token service over the batched decision.
    Its window state lives on ``device`` (None = the card; pass "cpu" for
    the plain versions)."""

    def __init__(self, clock: Optional[Clock] = None, initial_rows: int = 64, device: DeviceLike = None) -> None:
        from sentinel_tpu_torch.cluster.concurrent import ConcurrentFlowManager

        self.device = resolve_device(device)
        self.clock = clock or default_clock()
        self._lock = threading.RLock()
        self.state = ma.make_state(pad_pow2(initial_rows), CLUSTER_CFG, self.device)
        self._flow_rows: Dict[object, int] = {}  # flow_id, or "p:<flow_id>:<value>" for param rows
        self._ns_rows: Dict[str, int] = {}
        self._next_row = 0
        self.connected_count = 1  # global fallback when no manager is attached
        # Per-namespace connection accounting (the TCP server attaches one;
        # None for an embedded service).
        self.connections = None
        self.concurrent = ConcurrentFlowManager(clock=self.clock)
        self._io_bufs: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def load_state(self, state_arrays, flow_rows: Dict[object, int], ns_rows: Dict[str, int]) -> None:
        """Adopt a window state (``(counts, min_rt, window_start)`` numpy
        arrays, e.g. a JAX service's) and its row maps."""
        with self._lock:
            self.state = ma.state_from_numpy(state_arrays, self.device)
            self._flow_rows = dict(flow_rows)
            self._ns_rows = dict(ns_rows)
            self._next_row = max([*self._flow_rows.values(), *self._ns_rows.values(), -1]) + 1

    def _connected_count(self, namespace: str) -> int:
        """getConnectedCount for AVG_LOCAL thresholds: the rule namespace's
        live connections, floored at 1 (an embedded server counts itself)."""
        if self.connections is not None:
            n = self.connections.count(namespace)
            if n > 0:
                return n
        return max(1, self.connected_count)

    def _row_for(self, table: dict, key) -> int:
        row = table.get(key)
        if row is None:
            row = self._next_row
            self._next_row += 1
            table[key] = row
        return row

    def _ensure_capacity(self) -> None:
        if self._next_row > self.state.n_rows:
            self.state = ma.grow(self.state, pad_pow2(self._next_row), CLUSTER_CFG)

    def set_connected_count(self, n: int) -> None:
        self.connected_count = max(1, n)

    def _threshold(self, rule, flow_id: int) -> float:
        cfg = cluster_server_config_manager.config
        ns = cluster_flow_rule_manager.namespace_of(flow_id) or "default"
        cc = getattr(rule, "cluster_config", None)
        if cc is not None and cc.threshold_type == C.FLOW_THRESHOLD_GLOBAL:
            return rule.count * cfg.exceed_count
        return rule.count * self._connected_count(ns) * cfg.exceed_count

    def _io(self, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch's host and device buffers for ``b`` requests: rows,
        namespace rows and acquire (int32), the two thresholds (float32),
        valid (bool), 21 bytes a request; pinned on the host for the card."""
        bufs = self._io_bufs.get(b)
        if bufs is None:
            cuda = self.device.type == "cuda"
            host = torch.empty(21 * b, dtype=torch.uint8, pin_memory=cuda)
            bufs = self._io_bufs[b] = (host, torch.empty_like(host, device=self.device) if cuda else host)
        return bufs

    def _decide(self, rows, ns_rows, acq, thr, ns_thr, n: int, atomic: bool, pad_acq: int = 1, pad_thr: float = 0.0):
        """Pad to a power of two (padding as the JAX service pads), copy the
        batch to the device in one piece, run K12 under the lock, and bring
        the three outputs back in one copy."""
        b = pad_pow2(n, 8)
        host, dev = self._io(b)
        h = host.numpy()
        i32, f32, ok = h[: 12 * b].view(np.int32), h[12 * b : 20 * b].view(np.float32), h[20 * b :].view(np.bool_)
        for col, (vals, fill) in enumerate(((rows, 0), (ns_rows, -1), (acq, pad_acq))):
            i32[col * b : col * b + n] = vals
            i32[col * b + n : (col + 1) * b] = fill
        for col, (vals, fill) in enumerate(((thr, pad_thr), (ns_thr, 0.0))):
            f32[col * b : col * b + n] = vals
            f32[col * b + n : (col + 1) * b] = fill
        ok[:n] = True
        ok[n:] = False
        if dev is not host:
            dev.copy_(host, non_blocking=True)
        di, df = dev[: 12 * b].view(torch.int32), dev[12 * b : 20 * b].view(torch.float32)
        self._ensure_capacity()
        got = batch_decide(
            self.state, di[:b], di[b : 2 * b], di[2 * b :], df[:b], df[b:], dev[20 * b :].view(torch.bool),
            self.clock.now_ms(), atomic=atomic,
        ).cpu()
        return tuple(t.numpy() for t in unpack_decision(got))

    def request_token(self, flow_id: int, acquire_count: int = 1, prioritized: bool = False) -> TokenResult:
        return self.request_tokens([(flow_id, acquire_count, prioritized)])[0]

    def request_tokens(self, requests) -> List[TokenResult]:
        """Batched entry point: [(flow_id, acquire, prioritized)]."""
        out: List[Optional[TokenResult]] = [None] * len(requests)
        idxs: List[int] = []
        rows: List[int] = []
        ns_rows: List[int] = []
        acq: List[int] = []
        thr: List[float] = []
        cfg = cluster_server_config_manager.config
        with self._lock:
            for i, (flow_id, acquire_count, _prio) in enumerate(requests):
                rule = cluster_flow_rule_manager.get_rule_by_id(int(flow_id))
                if rule is None:
                    out[i] = TokenResult(C.TokenResultStatus.NO_RULE_EXISTS)
                    continue
                ns = cluster_flow_rule_manager.namespace_of(int(flow_id)) or "default"
                idxs.append(i)
                rows.append(self._row_for(self._flow_rows, int(flow_id)))
                ns_rows.append(self._row_for(self._ns_rows, ns))
                acq.append(int(acquire_count))
                thr.append(float(self._threshold(rule, int(flow_id))))
            if not idxs:
                return [r if r is not None else TokenResult(C.TokenResultStatus.FAIL) for r in out]
            n = len(idxs)
            admitted_h, ns_ok_h, rem_h = self._decide(rows, ns_rows, acq, thr, [float(cfg.max_allowed_qps)] * n, n,
                                                      atomic=False)
        from sentinel_tpu_torch.cluster import stat_log

        stat_items = []
        for j, i in enumerate(idxs):
            flow_id, acquire_count, _ = requests[i]
            if not ns_ok_h[j]:
                out[i] = TokenResult(C.TokenResultStatus.TOO_MANY_REQUEST)
                stat_items.append(("flow", "tooManyRequest", flow_id, int(acquire_count)))
            elif admitted_h[j]:
                out[i] = TokenResult(C.TokenResultStatus.OK, remaining=int(max(rem_h[j], 0)))
                stat_items.append(("flow", "pass", flow_id, int(acquire_count)))
            else:
                out[i] = TokenResult(C.TokenResultStatus.BLOCKED)
                stat_items.append(("flow", "block", flow_id, int(acquire_count)))
        if stat_items:
            stat_log.log_many(stat_items)
        return [r if r is not None else TokenResult(C.TokenResultStatus.FAIL) for r in out]

    def request_tokens_batch(self, rows) -> List[TokenResult]:
        return self.request_tokens(rows)

    def request_param_token(self, flow_id: int, acquire_count: int, params: List[object]) -> TokenResult:
        """Cluster hot-param tokens (ClusterParamFlowChecker): each value
        has a row of its own ("p:<flow_id>:<value>", in the flow rows'
        space) checked against the rule's threshold; the whole request
        blocks if one value is refused, and then charges nothing."""
        rule = cluster_flow_rule_manager.get_rule_by_id(int(flow_id))
        if rule is None:
            return TokenResult(C.TokenResultStatus.NO_RULE_EXISTS)
        with self._lock:
            reqs = [self._row_for(self._flow_rows, f"p:{flow_id}:{p}") for p in params]
        threshold = float(self._threshold(rule, int(flow_id)))
        with self._lock:
            n = len(reqs)
            admitted_h, _, _ = self._decide(reqs, [-1] * n, [int(acquire_count)] * n, [threshold] * n, [0.0] * n,
                                            n, atomic=True, pad_acq=int(acquire_count), pad_thr=threshold)
        if bool(admitted_h[:n].all()):
            return TokenResult(C.TokenResultStatus.OK)
        return TokenResult(C.TokenResultStatus.BLOCKED)

    def request_concurrent_token(
        self, flow_id: int, acquire_count: int = 1, client_address: str = "local"
    ) -> TokenResult:
        """requestConcurrentToken -> ConcurrentClusterFlowChecker.acquireConcurrentToken."""
        if acquire_count <= 0:
            return TokenResult(C.TokenResultStatus.BAD_REQUEST)
        rule = cluster_flow_rule_manager.get_rule_by_id(int(flow_id))
        if rule is None:
            return TokenResult(C.TokenResultStatus.FAIL)  # nowCalls missing for an unknown flowId
        ns = cluster_flow_rule_manager.namespace_of(int(flow_id)) or "default"
        status, token_id = self.concurrent.acquire(client_address, rule, int(acquire_count), self._connected_count(ns))
        return TokenResult(status, token_id=token_id)

    def release_concurrent_token(self, token_id: int) -> TokenResult:
        return TokenResult(self.concurrent.release(int(token_id)))

    def flow_stats(self) -> List[dict]:
        """Per-flowId server view: current granted QPS (the flow row's
        windowed PASS, read by K3 under the service lock) and held
        concurrency."""
        with self._lock:
            flows = {fid: row for fid, row in self._flow_rows.items() if isinstance(fid, int)}
            if not flows:
                return []
            sums = ma.window_sums(CLUSTER_CFG, self.state, self.clock.now_ms())[:, MetricEvent.PASS].cpu().numpy()
        interval_sec = CLUSTER_CFG.interval_ms / 1000.0
        out = []
        for fid, row in sorted(flows.items()):
            rule = cluster_flow_rule_manager.get_rule_by_id(fid)
            out.append({
                "flowId": fid,
                "namespace": cluster_flow_rule_manager.namespace_of(fid) or "default",
                "currentQps": float(sums[row]) / interval_sec if row < sums.shape[0] else 0.0,
                "concurrency": self.concurrent.now_calls(fid),
                "threshold": float(rule.count) if rule is not None else None,
            })
        return out

    def reset(self) -> None:
        with self._lock:
            self.state = ma.make_state(self.state.n_rows, CLUSTER_CFG, self.device)
            self._flow_rows.clear()
            self._ns_rows.clear()
            self._next_row = 0
            self.concurrent.clear()
