"""Node registry and per-node statistics state (port of
``sentinel_tpu/metrics/nodes.py``).

Every node of the reference's call tree (DefaultNode per (resource,
context), ClusterNode per resource, origin nodes, EntranceNode per
context, the global inbound ENTRY_NODE) is one row of the shared stats
tensors: the second window, the minute window, the thread gauge, and the
future slab of borrowed tokens. The node "tree" is a host-side id table
(:class:`NodeRegistry`, a copy of the JAX package's); the hot path
touches rows, never objects.

Kernels here, each beside its plain PyTorch version:

* :func:`materialize_matured` (K1): CUDA C++ (``csrc/slab_sweep.cu``),
  one pass over the ``[R, B]`` slab, in place, that writes only the cells
  that change;
* :func:`apply_updates`: both windows' window update (K2) and the
  thread-gauge scatter in one C call of two launches
  (``csrc/window_update.cu``). :func:`thread_gauge_add` is the gauge's
  plain route; on the card the gauge runs only inside that call.

State updates happen IN PLACE (the JAX code donated these buffers).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.metrics import metric_array as ma
from sentinel_tpu_torch.metrics.events import MetricEvent, NUM_EVENTS
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.utils import cuda_build

SECOND_CFG = ma.MetricArrayConfig(
    sample_count=C.DEFAULT_SAMPLE_COUNT, interval_ms=C.DEFAULT_WINDOW_INTERVAL_MS
)
MINUTE_CFG = ma.MetricArrayConfig(
    sample_count=C.MINUTE_SAMPLE_COUNT, interval_ms=C.MINUTE_INTERVAL_MS
)


class StatsState(NamedTuple):
    """Device-resident statistics for all nodes (StatisticNode's 1 s
    window of 2×500 ms, its 60 s window of 60×1 s and its thread gauge,
    node/StatisticNode.java:90-112), plus the future slab of tokens
    borrowed by prioritized entries: ``future_pass[r, b]`` tokens for the
    window starting at ``future_ws[r, b]``."""

    second: ma.MetricArrayState
    minute: ma.MetricArrayState
    threads: torch.Tensor  # int32 [R]
    future_pass: torch.Tensor  # int32 [R, B]
    future_ws: torch.Tensor  # int32 [R, B]

    @property
    def n_rows(self) -> int:
        return self.threads.shape[0]


def make_stats(n_rows: int, device: torch.device) -> StatsState:
    b = SECOND_CFG.sample_count
    return StatsState(
        second=ma.make_state(n_rows, SECOND_CFG, device),
        minute=ma.make_state(n_rows, MINUTE_CFG, device),
        threads=torch.zeros((n_rows,), dtype=torch.int32, device=device),
        future_pass=torch.zeros((n_rows, b), dtype=torch.int32, device=device),
        future_ws=torch.full((n_rows, b), SECOND_CFG.empty_ws, dtype=torch.int32, device=device),
    )


def grow_stats(state: StatsState, new_rows: int) -> StatsState:
    if new_rows <= state.n_rows:
        return state
    extra = make_stats(new_rows - state.n_rows, state.threads.device)
    return StatsState(
        second=ma.grow(state.second, new_rows, SECOND_CFG),
        minute=ma.grow(state.minute, new_rows, MINUTE_CFG),
        threads=torch.cat([state.threads, extra.threads]),
        future_pass=torch.cat([state.future_pass, extra.future_pass]),
        future_ws=torch.cat([state.future_ws, extra.future_ws]),
    )


def stats_from_numpy(d, device) -> StatsState:
    """Stats tensors on ``device`` from numpy arrays laid out as
    :class:`StatsState` (``second`` and ``minute`` as ``(counts, min_rt,
    window_start)``): the JAX package's ``jax.device_get(stats)`` has
    exactly this shape, so state carries across without importing JAX.
    The arrays are copied: state is updated in place, and a caller's
    numpy buffers (which JAX may share zero-copy) must never change."""
    second, minute, threads, future_pass, future_ws = d

    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.int32), device=device)

    return StatsState(
        second=ma.state_from_numpy(second, device),
        minute=ma.state_from_numpy(minute, device),
        threads=t(threads),
        future_pass=t(future_pass),
        future_ws=t(future_ws),
    )


def stats_to_numpy(stats: StatsState) -> StatsState:
    """The inverse of :func:`stats_from_numpy`: a StatsState of numpy arrays."""
    return StatsState(
        second=ma.MetricArrayState(*ma.state_to_numpy(stats.second)),
        minute=ma.MetricArrayState(*ma.state_to_numpy(stats.minute)),
        threads=stats.threads.cpu().numpy(),
        future_pass=stats.future_pass.cpu().numpy(),
        future_ws=stats.future_ws.cpu().numpy(),
    )


# ---------------------------------------------------------------------------
# K1: materialize_matured
# ---------------------------------------------------------------------------


def materialize_matured(state: StatsState, now: int) -> StatsState:
    """Fold matured borrows into the second window and clear their slab
    slots (OccupiableBucketLeapArray.resetWindowTo copying borrowArray's
    bucket into the rolled window, OccupiableBucketLeapArray.java:41-55).
    Runs at the start of a flush, before admission, in place. A slab cell
    matures when ``now - future_ws >= 0``; a matured cell still inside the
    interval adds its tokens to PASS of the bucket at the same index,
    rolling the bucket first when its own window is newer."""
    if state.threads.is_cuda:
        return _materialize_cuda(state, now)
    return materialize_matured_plain(state, now)


materialize_matured.launches = 0


def materialize_matured_plain(state: StatsState, now: int) -> StatsState:
    """Plain PyTorch version of :func:`materialize_matured`."""
    cfg = SECOND_CFG
    ws = state.future_ws
    now_t = torch.tensor(int(now), dtype=torch.int32, device=ws.device)
    age = now_t - ws  # wrapping int32, as in the JAX code
    matured = age >= 0
    live = matured & (age <= cfg.interval_ms)
    sec = state.second
    bws = sec.window_start
    newer = live & (ws > bws)
    same = live & (ws == bws)
    add = torch.where(same | newer, state.future_pass, 0).to(torch.int32)
    sec.counts.masked_fill_(newer[:, :, None], 0)
    sec.counts[:, :, MetricEvent.PASS] += add
    sec.window_start.copy_(torch.where(newer, ws, bws))
    sec.min_rt.masked_fill_(newer, cfg.max_rt)
    state.future_ws.masked_fill_(matured, cfg.empty_ws)
    state.future_pass.masked_fill_(matured, 0)
    return state


def _sweep_lib() -> ctypes.CDLL:
    lib = cuda_build.load("slab_sweep")
    if not getattr(lib, "_typed", False):
        lib.slab_sweep.argtypes = [ma._P] * 5 + [ctypes.c_longlong] + [ma._I] * 4 + [ma._P]
        lib.slab_sweep.restype = ma._I
        lib._typed = True
    return lib


def _materialize_cuda(state: StatsState, now: int) -> StatsState:
    cfg = SECOND_CFG
    sec = state.second
    shape = tuple(state.future_ws.shape)
    for name, t in (("future_ws", state.future_ws), ("future_pass", state.future_pass), *zip(
            ("second.counts", "second.min_rt", "second.window_start"), sec)):
        if t.dtype != torch.int32 or not t.is_contiguous() or not t.is_cuda or tuple(t.shape[:2]) != shape:
            raise ValueError(f"materialize_matured: {name} needs a contiguous CUDA int32 tensor over the slab {shape}")
    n_cells = state.future_ws.numel()
    if n_cells == 0:
        return state
    cuda_build.check(
        _sweep_lib().slab_sweep(
            state.future_ws.data_ptr(), state.future_pass.data_ptr(), sec.counts.data_ptr(), sec.min_rt.data_ptr(),
            sec.window_start.data_ptr(), n_cells, int(now), cfg.interval_ms, cfg.empty_ws, cfg.max_rt,
            ma.stream_of(state.future_ws),
        ),
        "slab_sweep",
    )
    materialize_matured.launches += 1
    return state


# ---------------------------------------------------------------------------
# apply_updates: both windows' K2 and the thread gauge
# ---------------------------------------------------------------------------


def apply_updates(
    state: StatsState,
    rows: torch.Tensor,  # int32 [M]
    ts: torch.Tensor,  # int32 [M]
    deltas: torch.Tensor,  # int32 [M, NUM_EVENTS]
    rt_sample: Optional[torch.Tensor],  # int32 [M] or None
    thread_delta: torch.Tensor,  # int32 [M]
    mask: torch.Tensor,  # bool [M]
    minute_deltas: Optional[torch.Tensor] = None,
) -> StatsState:
    """One update of both windows plus the thread gauge, in place.
    ``minute_deltas`` overrides the event deltas for the minute window
    (occupied entries write PASS + OCCUPIED_PASS there only). On the card
    one C call of two launches; each call counts one launch of the window
    update (``metric_array.update.launches``) and of the gauge
    (``thread_gauge_add.launches``), the kernels it runs."""
    if state.threads.is_cuda:
        return _apply_updates_cuda(state, rows, ts, deltas, rt_sample, thread_delta, mask, minute_deltas)
    return apply_updates_plain(state, rows, ts, deltas, rt_sample, thread_delta, mask, minute_deltas)


def apply_updates_plain(state, rows, ts, deltas, rt_sample, thread_delta, mask, minute_deltas=None) -> StatsState:
    """Plain PyTorch version of :func:`apply_updates`."""
    ma.update_plain(SECOND_CFG, state.second, rows, ts, deltas, rt_sample, mask)
    ma.update_plain(
        MINUTE_CFG, state.minute, rows, ts,
        deltas if minute_deltas is None else minute_deltas, rt_sample, mask,
    )
    thread_gauge_add_plain(state.threads, rows, thread_delta, mask)
    return state


def _apply_updates_cuda(state, rows, ts, deltas, rt_sample, thread_delta, mask, minute_deltas) -> StatsState:
    n = rows.shape[0]
    ma._i32(rows, "rows", (n,))
    ma._i32(ts, "ts", (n,))
    ma._i32(deltas, "deltas", (n, NUM_EVENTS))
    ma._i32(thread_delta, "thread_delta", (n,))
    ma._bool(mask, "mask", n)
    if rt_sample is not None:
        ma._i32(rt_sample, "rt_sample", (n,))
    if minute_deltas is not None:
        ma._i32(minute_deltas, "minute_deltas", (n, NUM_EVENTS))
    r = state.n_rows
    for name, t in (("threads", state.threads), *(
            (f"{w}.{f}", t) for w in ("second", "minute")
            for f, t in zip(ma.MetricArrayState._fields, getattr(state, w)))):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.shape[0] != r:
            raise ValueError(f"state.{name}: need a contiguous int32 tensor of {r} rows")
    if n == 0:
        return state
    sec, mnt = state.second, state.minute
    ptr = lambda t: None if t is None else t.data_ptr()
    cuda_build.check(
        ma._wu_lib().apply_updates(
            rows.data_ptr(), ts.data_ptr(), deltas.data_ptr(), ptr(minute_deltas), ptr(rt_sample),
            thread_delta.data_ptr(), mask.data_ptr(), n, r, SECOND_CFG.max_rt,
            SECOND_CFG.sample_count, SECOND_CFG.window_len_ms,
            sec.counts.data_ptr(), sec.min_rt.data_ptr(), sec.window_start.data_ptr(),
            MINUTE_CFG.sample_count, MINUTE_CFG.window_len_ms,
            mnt.counts.data_ptr(), mnt.min_rt.data_ptr(), mnt.window_start.data_ptr(),
            state.threads.data_ptr(), ma.stream_of(rows),
        ),
        "apply_updates",
    )
    ma.update.launches += 1
    thread_gauge_add.launches += 1
    return state


def thread_gauge_add(threads, rows, thread_delta, mask) -> torch.Tensor:
    """``threads[rows[i]] += thread_delta[i]`` for masked-in rows inside
    ``[0, R)``, in place (the JAX ``.at[].add(mode="drop")``). Its kernel
    runs inside :func:`apply_updates`' second launch (``au_add``), which
    counts it in ``launches``; a CUDA tensor here raises."""
    if threads.is_cuda:
        raise ValueError("thread_gauge_add: on the card the thread gauge runs inside apply_updates (au_add)")
    return thread_gauge_add_plain(threads, rows, thread_delta, mask)


thread_gauge_add.launches = 0


def thread_gauge_add_plain(threads, rows, thread_delta, mask) -> torch.Tensor:
    """Plain PyTorch version of :func:`thread_gauge_add`."""
    sel = mask & (rows >= 0) & (rows < threads.shape[0])
    threads.index_add_(0, rows[sel].long(), thread_delta[sel].to(torch.int32))
    return threads


def waiting_tokens(state: StatsState, now: int) -> torch.Tensor:
    """Tokens borrowed for still-future windows (int32 [R]),
    ``StatisticNode.waiting()`` (node/StatisticNode.java:337)."""
    future = state.future_ws > int(now)
    return torch.where(future, state.future_pass, 0).sum(dim=1, dtype=torch.int64).to(torch.int32)


def slab_fold_host(future_ws: np.ndarray, future_pass: np.ndarray, now: int) -> Tuple[int, int]:
    """(occupied-in-window, waiting) tokens of one row's slab, on the host:
    the read-side folds ``occupied_in_window`` and ``waiting_tokens`` of
    the JAX package for the rows a stats read asks about. int32 wrapping
    arithmetic as there."""
    age = (np.int32(now) - future_ws.astype(np.int32)).astype(np.int32)
    current = (age >= 0) & (age <= SECOND_CFG.interval_ms)
    occ = int(np.where(current, future_pass, 0).astype(np.int32).sum(dtype=np.int32))
    waiting = int(np.where(future_ws > np.int32(now), future_pass, 0).astype(np.int32).sum(dtype=np.int32))
    return occ, waiting


class NodeKind:
    CLUSTER = "C"  # per-resource ClusterNode
    DEFAULT = "D"  # per-(resource, context) DefaultNode
    ORIGIN = "O"  # per-(resource, origin) origin StatisticNode
    ENTRANCE = "E"  # per-context EntranceNode


class NodeRegistry:
    """Host-side name→row table plus the call-tree structure."""

    def __init__(
        self,
        max_resources: int = C.MAX_SLOT_CHAIN_SIZE,
        max_contexts: int = C.MAX_CONTEXT_NAME_SIZE,
    ) -> None:
        self._lock = threading.RLock()
        self._rows: Dict[str, int] = {}
        self._keys: List[str] = []
        self.max_resources = max_resources
        self.max_contexts = max_contexts
        self._n_resources = 0
        self._n_contexts = 0
        # Call tree: entrance row -> child default rows (EntranceNode children).
        self.children: Dict[int, List[int]] = {}
        # Origin rows per cluster row (ClusterNode#originCountMap analog).
        self.origin_rows: Dict[int, Dict[str, int]] = {}
        # The global inbound node is always row 0 (Constants.ENTRY_NODE).
        self.entry_node_row = self._alloc(NodeKind.CLUSTER + ":" + C.TOTAL_IN_RESOURCE_NAME)
        assert self.entry_node_row == 0

    def _alloc(self, key: str) -> int:
        row = self._rows.get(key)
        if row is None:
            row = len(self._keys)
            self._rows[key] = row
            self._keys.append(key)
        return row

    def __len__(self) -> int:
        with self._lock:
            return len(self._keys)

    def key_of(self, row: int) -> str:
        with self._lock:
            return self._keys[row]

    def cluster_row(self, resource: str) -> Optional[int]:
        """Row of the resource's ClusterNode; None above the resource cap."""
        key = NodeKind.CLUSTER + ":" + resource
        with self._lock:
            row = self._rows.get(key)
            if row is not None:
                return row
            if self._n_resources >= self.max_resources:
                return None
            self._n_resources += 1
            return self._alloc(key)

    def default_row(self, resource: str, context: str) -> Optional[int]:
        """Row of the per-context DefaultNode (NodeSelectorSlot.java:135-180)."""
        key = NodeKind.DEFAULT + ":" + resource + "|" + context
        with self._lock:
            row = self._rows.get(key)
            if row is not None:
                return row
            row = self._alloc(key)
            ent = self.entrance_row(context)
            if ent is not None:
                self.children.setdefault(ent, []).append(row)
            return row

    def origin_row(self, resource: str, origin: str) -> Optional[int]:
        """Row of the per-origin node under the resource's ClusterNode
        (ClusterBuilderSlot.java:49+, ClusterNode#getOrCreateOriginNode)."""
        if not origin:
            return None
        crow = self.cluster_row(resource)
        if crow is None:
            return None
        key = NodeKind.ORIGIN + ":" + resource + "|" + origin
        with self._lock:
            row = self._rows.get(key)
            if row is None:
                row = self._alloc(key)
                self.origin_rows.setdefault(crow, {})[origin] = row
            return row

    def entrance_row(self, context: str) -> Optional[int]:
        """Row of the context's EntranceNode; None above the 2000 cap."""
        key = NodeKind.ENTRANCE + ":" + context
        with self._lock:
            row = self._rows.get(key)
            if row is not None:
                return row
            if self._n_contexts >= self.max_contexts:
                return None
            self._n_contexts += 1
            return self._alloc(key)

    def promote_cluster_row(self, resource: str) -> int:
        """Cluster-row allocation that ignores the resource cap: the sketch
        tier's promotion grant for an over-cap heavy hitter. Rows are never
        released, so the tier budgets its grants (8x ``promote.max``,
        ``SketchTier._cap_grants``)."""
        key = NodeKind.CLUSTER + ":" + resource
        with self._lock:
            row = self._rows.get(key)
            if row is not None:
                return row
            self._n_resources += 1
            return self._alloc(key)

    def lookup_cluster_row(self, resource: str) -> Optional[int]:
        with self._lock:
            return self._rows.get(NodeKind.CLUSTER + ":" + resource)

    def resources(self) -> List[Tuple[str, int]]:
        """All (resource, cluster_row) pairs (ClusterBuilderSlot map view)."""
        prefix = NodeKind.CLUSTER + ":"
        with self._lock:
            return [
                (k[len(prefix):], r)
                for k, r in self._rows.items()
                if k.startswith(prefix) and r != self.entry_node_row
            ]

    def keys_snapshot(self) -> List[str]:
        """Row-ordered key list (what a durable checkpoint carries so a
        restarted process can rebuild the name→row mapping)."""
        with self._lock:
            return list(self._keys)

    def entrance_children(self, context: str) -> List[int]:
        with self._lock:
            row = self._rows.get(NodeKind.ENTRANCE + ":" + context)
            if row is None:
                return []
            return list(self.children.get(row, ()))

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()
            self._keys.clear()
            self.children.clear()
            self.origin_rows.clear()
            self._n_resources = 0
            self._n_contexts = 0
            self.entry_node_row = self._alloc(NodeKind.CLUSTER + ":" + C.TOTAL_IN_RESOURCE_NAME)
