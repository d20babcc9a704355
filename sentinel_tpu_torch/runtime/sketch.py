"""Sketch tier: count-min and candidate statistics for unbounded resource
cardinality, with heavy-hitter promotion to exact dense rows (port of
``sentinel_tpu/runtime/sketch.py``).

* **Device plane** (:class:`SketchState` + :func:`sketch_fold`, K11): a
  count-min array (``depth`` hash rows x ``width`` counters of per-key
  acquire volume) and a fixed-size candidate table (the ``C`` heaviest
  keys by count-min estimate). The fold runs inside ``flush_step`` after
  the entries, over the chunk's host-aggregated key ids, and its state
  chains from flush to flush like the statistics (updated in place). The
  candidate table rides the verdict copy of the flush. Counts halve once
  per ``sentinel.tpu.sketch.window.ms``.

* **Host plane** (:class:`SketchTier`): encodes each chunk's key stream
  (unconfigured resources, sketch-mode param values, over-cap resources
  that get no row), resolves drained candidate ids back to names through
  a bounded LRU map, and runs the promotion/demotion controller: a
  candidate over the promotion threshold gets an exact dense row (param
  values through :class:`~sentinel_tpu_torch.rules.param_table.ParamIndex`,
  unconfigured resources through a synthetic ``from_sketch`` flow rule)
  and is demoted after ``demote.windows`` cold windows. The cold ceilings
  (``sentinel.tpu.sketch.cold.qps``) block unpromoted keys whose estimate
  in a host count-min twin is over the ceiling.

Key ids are 31-bit CRC32 hashes of the key string; an id collision only
ever over-estimates, as the count-min bound does.

K11 is CUDA C++ (``csrc/sketch_fold.cu``), one host call (``SfArgs``):
the optional halving, the count-min adds (integer atomics, exact and
wrapping as XLA's add), the post-update estimates, dedupe of the batch's
ids in a hash table, and the top C of the candidates and the batch's
distinct keys by a radix select over one 64-bit key per entry, ordered by
count descending then index ascending as ``lax.top_k`` breaks ties; no
sort of the batch. CPU tensors take :func:`sketch_fold_plain`.

Not ported here: the DEGRADED host fold (``fold_host_chunk``) and the
checkpoint of the sketch state (ROADMAP Queue 1 item 7), the sketch's
telemetry counters and exports (item 8), and the gossip transport
(``sentinel.tpu.gossip.enabled``, the rest of item 9); the gossip
snapshot and merge of the tier itself are here.
"""

from __future__ import annotations

import ctypes
import sys
import threading
import zlib
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.utils import cuda_build
from sentinel_tpu_torch.utils.config import config
from sentinel_tpu_torch.utils.device import DeviceLike, resolve_device
from sentinel_tpu_torch.utils.numeric import pad_pow2 as _pad_pow2
from sentinel_tpu_torch.utils.numeric import wrap_i32

_I32_MAX = 2**31 - 1

# Per-depth-row hash seeds (odd constants; depth is clamped to <= 8).
# csrc/sketch_fold.cu holds the same eight.
_SEEDS = (
    0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
    0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09,
)
_HASH_MUL = 2654435761  # 0x9E3779B1
MAX_DEPTH = len(_SEEDS)

# Promotion fires at PROMOTE_FACTOR x (threshold qps x window); demotion
# arms below DEMOTE_FACTOR of the same. Under per-window halving a
# sustained rate q converges to a count of 2*q*window.
PROMOTE_FACTOR = 1.5
DEMOTE_FACTOR = 0.75
# Cold-key admission ceiling: blocking at 2x (qps x window) caps the
# admitted rate near the configured ceiling (blocked traffic is never
# counted, so the estimate decays back under it).
COLD_ADMIT_FACTOR = 2.0

# Key-kind prefixes (one byte, never part of a user name).
_KIND_RESOURCE = "\x01"
_KIND_VALUE = "\x02"
_SEP = "\x1f"


class SketchState(NamedTuple):
    """Device sketch state, updated in place by :func:`sketch_fold`."""

    cm: torch.Tensor  # int32 [depth, width] count-min counters
    cand_ids: torch.Tensor  # int32 [C] candidate key ids (-1 empty)
    cand_cnt: torch.Tensor  # int32 [C] candidate count-min estimates


class SketchBatch(NamedTuple):
    """One chunk's aggregated key stream ([S] each, -1 id = padding)."""

    ids: torch.Tensor  # int32 [S] 31-bit key ids
    w: torch.Tensor  # int32 [S] acquire weight per id (host-aggregated)


def make_sketch_state(depth: int, width: int, candidates: int, device: DeviceLike = None) -> SketchState:
    dev = resolve_device(device)  # None: the card, as for the engine
    return SketchState(
        cm=torch.zeros((depth, width), dtype=torch.int32, device=dev),
        cand_ids=torch.full((candidates,), -1, dtype=torch.int32, device=dev),
        cand_cnt=torch.zeros((candidates,), dtype=torch.int32, device=dev),
    )


def sketch_state_from_numpy(d, device) -> SketchState:
    """``(cm, cand_ids, cand_cnt)`` numpy arrays (e.g. a JAX state) →
    state tensors on ``device``."""
    return SketchState(*(torch.tensor(np.asarray(a, dtype=np.int32), device=device) for a in d))


def sketch_state_to_numpy(state: SketchState) -> SketchState:
    return SketchState(*(t.cpu().numpy() for t in state))


def key_id(key: str) -> int:
    """Stable 31-bit id of a key string."""
    return zlib.crc32(key.encode("utf-8", "surrogatepass")) & 0x7FFFFFFF


def _build_crc_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, np.uint32(0xEDB88320) ^ (t >> 1), t >> 1)
    return t


_CRC_TABLE = _build_crc_table()


def crc32_batch(chunks: Sequence[bytes], init: int = 0) -> np.ndarray:
    """Vectorized ``zlib.crc32`` over many byte strings: one numpy pass
    per byte column of the padded byte matrix. ``init`` is a running
    ``zlib.crc32`` value (the state of a shared key prefix). Equal to
    ``[zlib.crc32(c, init) for c in chunks]``."""
    n = len(chunks)
    state = np.full(n, (init ^ 0xFFFFFFFF) & 0xFFFFFFFF, dtype=np.uint32)
    if n == 0:
        return state
    lens = np.fromiter(map(len, chunks), dtype=np.int64, count=n)
    maxlen = int(lens.max())
    if maxlen:
        buf = np.frombuffer(b"".join(chunks), dtype=np.uint8)
        mat = np.zeros((n, maxlen), dtype=np.uint8)
        starts = np.cumsum(lens) - lens
        rows = np.repeat(np.arange(n), lens)
        mat[rows, np.arange(len(buf)) - np.repeat(starts, lens)] = buf
        tbl = _CRC_TABLE
        for j in range(maxlen):
            nxt = tbl[(state ^ mat[:, j]) & np.uint32(0xFF)] ^ (state >> np.uint32(8))
            state = np.where(lens > j, nxt, state)
    return state ^ np.uint32(0xFFFFFFFF)


def _hash_np(ids: np.ndarray, d: int, width: int) -> np.ndarray:
    """Host twin of the kernel hash (uint32 wraparound): the cells
    :func:`cm_estimate` and the cold ceilings query."""
    h = (ids.astype(np.uint64) ^ np.uint64(_SEEDS[d])) * np.uint64(_HASH_MUL)
    h = h & np.uint64(0xFFFFFFFF)
    h = h ^ (h >> np.uint64(15))
    return (h & np.uint64(width - 1)).astype(np.int64)


def cm_estimate(cm: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Host count-min point query over a ``cm`` array: the min over depth
    rows of the hashed cells."""
    d, w = cm.shape
    ids = np.asarray(ids, dtype=np.int64)
    est = np.full(ids.shape, _I32_MAX, dtype=np.int64)
    for di in range(d):
        est = np.minimum(est, cm[di][_hash_np(ids, di, w)])
    return est


# ---------------------------------------------------------------------------
# K11: sketch_fold
# ---------------------------------------------------------------------------


def sketch_fold(st: SketchState, sk: SketchBatch, decay: bool = False) -> SketchState:
    """Fold one key batch into the sketch, in place: with ``decay`` halve
    every counter first; count-min adds of the batch's weights; then a
    space-saving merge of the candidate table (candidates touched by the
    batch take their fresh estimate, untouched ones keep their count, and
    the table is the top ``C`` of the union). Returns ``st``."""
    if st.cm.is_cuda:
        return _sketch_fold_cuda(st, sk, decay)
    return sketch_fold_plain(st, sk, decay)


sketch_fold.launches = 0


def _hash_torch(uids: torch.Tensor, d: int, width: int) -> torch.Tensor:
    """The kernel hash on int64 tensors holding uint32 values. The product
    of two 32-bit values does not fit int64, so the multiplier is split in
    16-bit halves and the low 32 bits rebuilt."""
    h = uids ^ _SEEDS[d]
    lo, hi = _HASH_MUL & 0xFFFF, _HASH_MUL >> 16
    h = (h * lo + (((h * hi) & 0xFFFF) << 16)) & 0xFFFFFFFF
    h = h ^ (h >> 15)
    return h & (width - 1)


def _topc_key(cnt: torch.Tensor) -> torch.Tensor:
    """int64 keys whose descending order is (count descending, index
    ascending): count * 2^32 + (2^32 - 1 - index), unique per index."""
    idx = torch.arange(cnt.shape[0], dtype=torch.int64, device=cnt.device)
    return cnt.to(torch.int64) * (1 << 32) + (0xFFFFFFFF - idx)


def sketch_fold_plain(st: SketchState, sk: SketchBatch, decay: bool = False) -> SketchState:
    """Plain PyTorch version of :func:`sketch_fold` (the JAX op sequence;
    the [C, S] membership matrix becomes a set test)."""
    d, w = st.cm.shape
    c = st.cand_ids.shape[0]
    valid = sk.ids >= 0
    if decay:
        st.cm.copy_(st.cm >> 1)
        st.cand_cnt.copy_(st.cand_cnt >> 1)
    wgt = torch.where(valid, sk.w, torch.zeros_like(sk.w)).to(torch.int64)
    uids = sk.ids.to(torch.int64) & 0xFFFFFFFF
    cm64 = st.cm.to(torch.int64)
    cells = [_hash_torch(uids, di, w) for di in range(d)]
    for di in range(d):
        cm64[di].index_add_(0, cells[di][valid], wgt[valid])
    st.cm.copy_(wrap_i32(cm64))  # int32 adds wrap, as XLA's scatter-add does
    est = torch.full(sk.ids.shape, _I32_MAX, dtype=torch.int32, device=sk.ids.device)
    for di in range(d):
        est = torch.minimum(est, st.cm[di][cells[di]])

    key = torch.where(valid, sk.ids, torch.full_like(sk.ids, _I32_MAX))
    ids_s, perm = torch.sort(key, stable=True)
    est_s = est[perm]
    head = torch.ones_like(valid)
    head[1:] = ids_s[1:] != ids_s[:-1]
    head &= ids_s < _I32_MAX
    neg = torch.full_like(ids_s, -1)
    uniq_ids = torch.where(head, ids_s, neg)
    uniq_cnt = torch.where(head, est_s, neg)
    touched = torch.isin(st.cand_ids, ids_s[head])
    keep_cnt = torch.where(touched | (st.cand_ids < 0), torch.full_like(st.cand_cnt, -1), st.cand_cnt)
    m_ids = torch.cat([st.cand_ids, uniq_ids])
    m_cnt = torch.cat([keep_cnt, uniq_cnt])
    top_pos = torch.sort(_topc_key(m_cnt), descending=True).indices[:c]
    top_cnt = m_cnt[top_pos]
    st.cand_ids.copy_(torch.where(top_cnt >= 0, m_ids[top_pos], torch.full_like(top_cnt, -1)))
    st.cand_cnt.copy_(top_cnt.clamp(min=0))
    return st


_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_CANDIDATES = 8192  # candidates the kernel keeps at most
# Keys of K11's one-block route (the C side takes at most 8,192, with C + S
# <= 16,384, and with decay only where one block halves the array).
SKETCH_FOLD_SMALL_MAX = 2048


class _SfArgs(ctypes.Structure):
    """The ``SfArgs`` of ``csrc/sketch_fold.cu``, field for field."""

    _fields_ = [(name, _P) for name in ("cm", "cand_ids", "cand_cnt", "ids", "w")] + [
        (name, _I) for name in ("depth", "width", "c", "s", "decay", "small_max")]


def _sf_lib() -> ctypes.CDLL:
    lib = cuda_build.load("sketch_fold")
    if not getattr(lib, "_typed", False):
        lib.sketch_fold_scratch.argtypes = [ctypes.POINTER(_SfArgs), ctypes.POINTER(ctypes.c_longlong * 2)]
        lib.sketch_fold_scratch.restype = None
        lib.sketch_fold.argtypes = [ctypes.POINTER(_SfArgs), _P, ctypes.c_longlong, _P, ctypes.c_longlong, _P]
        lib.sketch_fold.restype = _I
        lib._typed = True
    return lib


_SF_SCRATCH: Dict[Tuple[int, ...], Tuple[int, int]] = {}  # (d, w, c, s, decay, small_max) -> bytes


def _sf_scratch(lib, a: _SfArgs) -> Tuple[int, int]:
    """(workspace, zeroed) bytes of a fold of this shape, asked of the C
    side once per shape."""
    key = (a.depth, a.width, a.c, a.s, a.decay, a.small_max)
    got = _SF_SCRATCH.get(key)
    if got is None:
        out = (ctypes.c_longlong * 2)()
        lib.sketch_fold_scratch(ctypes.byref(a), ctypes.byref(out))
        got = _SF_SCRATCH[key] = (int(out[0]), int(out[1]))
    return got


def _check_i32(t: torch.Tensor, what: str, shape) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous() or not t.is_cuda or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: need a contiguous CUDA int32 tensor of shape {tuple(shape)}")


def _sketch_fold_cuda(st: SketchState, sk: SketchBatch, decay: bool) -> SketchState:
    """K11 in one host call: one block up to SKETCH_FOLD_SMALL_MAX keys,
    else two launches (three with decay) over the zeroed scratch, which the
    call leaves zeroed. No sort, no allocation."""
    d, w = st.cm.shape
    c = st.cand_ids.shape[0]
    s = sk.ids.shape[0]
    if not (1 <= d <= MAX_DEPTH) or w < 1 or w & (w - 1):
        raise ValueError(f"sketch_fold: depth {d} must be in [1, {MAX_DEPTH}] and width {w} a power of two")
    if not (1 <= c <= MAX_CANDIDATES):
        raise ValueError(f"sketch_fold: the kernel keeps 1 to {MAX_CANDIDATES} candidates, not {c}")
    _check_i32(st.cm, "cm", (d, w))
    _check_i32(st.cand_ids, "cand_ids", (c,))
    _check_i32(st.cand_cnt, "cand_cnt", (c,))
    _check_i32(sk.ids, "ids", (s,))
    _check_i32(sk.w, "w", (s,))
    if s == 0:
        raise ValueError("sketch_fold: an empty key batch (the engine pads it to at least 8)")
    lib = _sf_lib()
    a = _SfArgs(st.cm.data_ptr(), st.cand_ids.data_ptr(), st.cand_cnt.data_ptr(), sk.ids.data_ptr(),
                sk.w.data_ptr(), d, w, c, s, int(decay), SKETCH_FOLD_SMALL_MAX)
    need, zero_bytes = _sf_scratch(lib, a)
    dev = st.cm.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with cuda_build.scratch(dev, stream, need, zero_bytes) as (buf, size, zero):
        cuda_build.check(lib.sketch_fold(ctypes.byref(a), buf, size, zero, zero_bytes, stream), "sketch_fold")
    sketch_fold.launches += 1
    return st


# ---------------------------------------------------------------------------
# host plane
# ---------------------------------------------------------------------------


class _HostSpaceSaving:
    """Tiny host space-saving summary with the same per-window decay (the
    mirror of the candidate table that the gossip snapshot falls back on
    before the first drain)."""

    __slots__ = ("capacity", "counts")

    def __init__(self, capacity: int) -> None:
        self.capacity = max(1, int(capacity))
        self.counts: Dict[str, int] = {}

    def offer(self, key: str, w: int) -> None:
        if w <= 0:
            return
        c = self.counts.get(key)
        if c is not None:
            self.counts[key] = c + w
            return
        if len(self.counts) < self.capacity:
            self.counts[key] = w
            return
        victim = min(self.counts, key=self.counts.__getitem__)
        floor = self.counts.pop(victim)
        self.counts[key] = floor + w

    def decay(self) -> None:
        for k in list(self.counts):
            v = self.counts[k] >> 1
            if v <= 0:
                del self.counts[k]
            else:
                self.counts[k] = v

    def clear(self) -> None:
        self.counts.clear()


class SketchTier:
    """Host controller of the sketch tier (engine-scoped). Disarmed (the
    default) it costs one attribute read per call site and no device
    state exists."""

    def __init__(self, engine) -> None:
        self._engine = engine
        self.enabled = config.get_bool(config.SKETCH_ENABLED, False)
        self.depth = min(max(config.get_int(config.SKETCH_DEPTH, 4), 1), MAX_DEPTH)
        self.width = _pad_pow2(max(config.get_int(config.SKETCH_WIDTH, 2048), 8))
        self.candidates = max(config.get_int(config.SKETCH_CANDIDATES, 64), 1)
        self.window_ms = max(config.get_int(config.SKETCH_WINDOW_MS, 1000), 1)
        self.promote_qps = config.get_float(config.SKETCH_PROMOTE_QPS, 0.0)
        self.resource_qps = config.get_float(config.SKETCH_RESOURCE_QPS, 0.0)
        self.promote_max = max(config.get_int(config.SKETCH_PROMOTE_MAX, 64), 0)
        self.demote_windows = max(config.get_int(config.SKETCH_DEMOTE_WINDOWS, 3), 1)
        self.names_cap = max(config.get_int(config.SKETCH_NAMES_CAP, 65536), self.candidates)
        # Cold-key admission ceiling: armed, a host count-min twin (same
        # hashes, same decay clock) fed from the same key stream answers
        # the submit-time estimate for unpromoted keys.
        self.cold_qps = max(0.0, config.get_float(config.SKETCH_COLD_QPS, 0.0))
        self.cold_armed = self.enabled and self.cold_qps > 0
        # Sketch gossip: the promotion controller evaluates the merged
        # fleet view of remote twins and candidates. The transport that
        # carries the frames is not ported (ROADMAP Queue 1 item 9); the
        # engine refuses the switch, and callers may drive
        # gossip_snapshot / merge_remote directly.
        self.gossip_armed = self.enabled and config.get_bool(config.GOSSIP_ENABLED, False)
        self.gossip_stale_windows = max(1, config.get_int(config.GOSSIP_STALE_WINDOWS, 4))
        # origin -> [int64 cm, {key: count} candidates, local wid at last merge]
        self._remote: Dict[str, list] = {}
        self.gossip_merges = 0
        self._host_cm: Optional[np.ndarray] = (
            np.zeros((self.depth, self.width), dtype=np.int64) if (self.cold_armed or self.gossip_armed) else None
        )
        self.cold_blocks = 0
        self.cold_value_blocks = 0  # the value-grade share of cold_blocks
        self._lock = threading.Lock()
        # id -> key name, bounded LRU (eviction only loses the ability to
        # decode a candidate until it is seen again).
        self._names: "OrderedDict[int, str]" = OrderedDict()
        # Interned key prefix -> (prefix CRC state, {tail -> id}); a pure
        # cache over the stable CRC ids, cleared whole on overflow.
        self._id_memo: Dict[str, Tuple[int, Dict[str, int]]] = {}
        self._id_memo_n = 0
        # Exact host counters of the current candidate ids (the error
        # gauge): id -> [count, tracking_since_window].
        self._exact: Dict[int, List[int]] = {}
        self._pending_unrouted: List[Tuple[str, int]] = []
        self._last_wid: Optional[int] = None
        # Published promotion state; ``promoted_values`` is read lock-free
        # by ParamIndex (mutations swap in a fresh dict of frozensets).
        self.promoted_values: Dict[str, frozenset] = {}
        self._promoted_vals: Dict[str, set] = {}
        self._promoted_res: Dict[str, object] = {}  # resource -> FlowRule
        self._low: Dict[str, List[int]] = {}  # key -> [low_windows, last_window_counted]
        self._actions: List[tuple] = []
        # Resources granted node rows past the registry cap; new grants
        # stop at 8x promote.max (registry rows are never released).
        self._cap_grants: set = set()
        self._last_candidates: List[Tuple[int, Optional[str], int]] = []
        self.est_error_ratio = 0.0
        self.occupancy = 0.0
        self.host_mirror = _HostSpaceSaving(self.candidates)
        self.dev_state: Optional[SketchState] = (
            make_sketch_state(self.depth, self.width, self.candidates, engine.device) if self.enabled else None
        )

    # ------------------------------------------------------------------
    # hot-path surface
    # ------------------------------------------------------------------
    @property
    def armed(self) -> bool:
        return self.enabled

    @property
    def pending_actions(self) -> bool:
        return bool(self._actions)

    @property
    def promoted_count(self) -> int:
        return sum(len(s) for s in self._promoted_vals.values()) + len(self._promoted_res)

    def note_unrouted(self, resource: str, acquire: int) -> None:
        """An over-cap resource's entry passed without an op (the one key
        class the encode never sees): buffered into the next chunk's
        stream when resource promotion or the cold ceiling is armed."""
        if self.resource_qps <= 0 and not self.cold_armed:
            return
        with self._lock:
            self._pending_unrouted.append((resource, int(acquire)))
            if len(self._pending_unrouted) > 65536:
                del self._pending_unrouted[:32768]

    def _ceiling(self) -> float:
        return COLD_ADMIT_FACTOR * self.cold_qps * (self.window_ms / 1000.0)

    def cold_blocked(self, resource: str, findex, pindex, n: int = 1) -> bool:
        """Submit-time cold-key ceiling: True blocks the submit. Applies
        only to unpromoted resources with no user rule of any kind."""
        eng = self._engine
        if (
            resource in self._promoted_res
            or resource in findex.by_resource
            or resource in pindex.by_resource
            or resource in eng.degrade_index.by_resource
            or resource in eng.authority_rules
        ):
            return False
        ceiling = self._ceiling()
        with self._lock:
            cm = self._host_cm
            if cm is None:
                return False
            kid = self._ids_for_locked(_KIND_RESOURCE, [resource])
            if int(cm_estimate(cm, kid)[0]) < ceiling:
                return False
            self.cold_blocks += n  # row-weighted: a blocked bulk group counts n
        return True

    def _value_keys(self, idxs, args) -> List[str]:
        """The sketch-mode value keys one op's args contribute (the keys
        _collect feeds the twin: collections expand, None drops)."""
        from sentinel_tpu_torch.rules.param_table import ParamIndex

        keys: List[str] = []
        for pi in idxs:
            if pi >= len(args):
                continue
            v = args[pi]
            vals = v if isinstance(v, (list, tuple, set, frozenset)) else (v,)
            for vv in vals:
                k = ParamIndex._value_key(vv)
                if k is not None:
                    keys.append(k)
        return keys

    def cold_value_blocked(self, resource: str, pindex, args, n: int = 1) -> bool:
        """The value-grade ceiling: an unpromoted value of a sketch-mode
        rule whose twin estimate is at the ceiling blocks the submit."""
        idxs = pindex.sketch_idx_by_resource.get(resource)
        if not idxs or not args:
            return False
        promoted = self.promoted_values.get(resource) or frozenset()
        keys = [k for k in self._value_keys(idxs, args) if k not in promoted]
        if not keys:
            return False
        ceiling = self._ceiling()
        with self._lock:
            cm = self._host_cm
            if cm is None:
                return False
            kids = self._ids_for_locked(_KIND_VALUE + resource + _SEP, keys)
            if not bool((cm_estimate(cm, kids) >= ceiling).any()):
                return False
            self.cold_blocks += n
            self.cold_value_blocks += n
        return True

    def cold_value_mask(self, resource: str, pindex, args_column, n: int) -> Optional[np.ndarray]:
        """Per-row mask of a bulk group's value-ceiling blocks, or None
        when nothing applies. The caller counts (note_cold_value_rows)."""
        idxs = pindex.sketch_idx_by_resource.get(resource)
        if not idxs or args_column is None:
            return None
        from sentinel_tpu_torch.rules.param_table import ArgsColumns, ParamIndex, _extract_arg

        value_key = ParamIndex._value_key
        promoted = self.promoted_values.get(resource) or frozenset()
        row_keys: List[List[str]] = [[] for _ in range(n)]
        uniq: Dict[str, None] = {}
        for pi in idxs:
            if isinstance(args_column, ArgsColumns):
                col = args_column.by_idx.get(pi)
            else:
                col = [_extract_arg(a, pi) for a in args_column]
            if col is None:
                continue
            for j, v in enumerate(col):
                if v is None:
                    continue
                vals = v if isinstance(v, (list, tuple, set, frozenset)) else (v,)
                for vv in vals:
                    k = value_key(vv)
                    if k is None or k in promoted:
                        continue
                    row_keys[j].append(k)
                    uniq[k] = None
        if not uniq:
            return None
        keys = list(uniq)
        ceiling = self._ceiling()
        with self._lock:
            cm = self._host_cm
            if cm is None:
                return None
            kids = self._ids_for_locked(_KIND_VALUE + resource + _SEP, keys)
            over = cm_estimate(cm, kids) >= ceiling
        hot = {k for k, o in zip(keys, over.tolist()) if o}
        if not hot:
            return None
        mask = np.fromiter((any(k in hot for k in rk) for rk in row_keys), bool, n)
        return mask if mask.any() else None

    def note_cold_value_rows(self, n: int) -> None:
        with self._lock:
            self.cold_blocks += n
            self.cold_value_blocks += n

    def decay_due(self, now_ms: int) -> bool:
        """True exactly once per decay window (the chunk that carries the
        halving fold); the host mirrors halve in the same breath."""
        wid = now_ms // self.window_ms
        with self._lock:
            if self._last_wid is None:
                self._last_wid = wid
                return False
            if wid <= self._last_wid:
                return False
            self._last_wid = wid
            for ent in self._exact.values():
                ent[0] >>= 1
            self.host_mirror.decay()
            if self._host_cm is not None:
                self._host_cm >>= 1
            for origin in list(self._remote):
                ent = self._remote[origin]
                if wid - ent[2] > self.gossip_stale_windows:
                    del self._remote[origin]
                    continue
                ent[0] >>= 1
                ent[1] = {k: c >> 1 for k, c in ent[1].items() if c >= 2}
            return True

    # ------------------------------------------------------------------
    # key-stream encode (one numpy pass per batch)
    # ------------------------------------------------------------------
    def _ids_for_locked(self, prefix: str, tails: List[str]) -> np.ndarray:
        """31-bit ids of ``prefix + tail`` for each tail: memo hits are one
        dict read, misses one CRC pass over the tails seeded with the
        prefix's CRC state. Caller holds ``self._lock``."""
        ent = self._id_memo.get(prefix)
        if ent is None:
            ent = self._id_memo[sys.intern(prefix)] = (zlib.crc32(prefix.encode("utf-8", "surrogatepass")), {})
        pc, memo = ent
        out = np.empty(len(tails), dtype=np.int64)
        miss_j: List[int] = []
        miss_t: List[str] = []
        for j, t in enumerate(tails):
            i = memo.get(t)
            if i is None:
                miss_j.append(j)
                miss_t.append(t)
            else:
                out[j] = i
        if miss_t:
            ids = (
                crc32_batch([t.encode("utf-8", "surrogatepass") for t in miss_t], init=pc) & np.uint32(0x7FFFFFFF)
            ).astype(np.int64)
            out[miss_j] = ids
            for t, i in zip(miss_t, ids.tolist()):
                memo[t] = i
            self._id_memo_n += len(miss_t)
            if self._id_memo_n > self.names_cap:
                self._id_memo = {}
                self._id_memo_n = 0
        return out

    def _collect(self, entries, bulk, findex, pindex) -> Tuple[np.ndarray, np.ndarray]:
        """One chunk's key stream aggregated into sorted ``(ids, weights)``
        int64 columns; updates the id->name LRU, the exact mirror and the
        host twin as side effects."""
        from sentinel_tpu_torch.rules.param_table import ParamIndex

        groups: Dict[str, Tuple[List[str], List[int]]] = {}

        def grp(prefix: str) -> Tuple[List[str], List[int]]:
            g = groups.get(prefix)
            if g is None:
                g = groups[prefix] = ([], [])
            return g

        with self._lock:
            pend, self._pending_unrouted = self._pending_unrouted, []
            track_res = self.resource_qps > 0 or self.cold_armed
            res_memo: Dict[str, bool] = {}

            def tracked(resource: str) -> bool:
                # "Unconfigured" = no flow or param rule names it; a
                # promoted resource stays tracked so demotion sees it cool.
                hit = res_memo.get(resource)
                if hit is None:
                    hit = res_memo[resource] = resource in self._promoted_res or (
                        resource not in findex.by_resource and resource not in pindex.by_resource
                    )
                return hit

            if track_res:
                rt, rw = grp(_KIND_RESOURCE)
                for resource, acq in pend:
                    if acq > 0:
                        rt.append(resource)
                        rw.append(acq)
            sk_idx = getattr(pindex, "sketch_idx_by_resource", None) or {}
            for op in entries:
                if track_res and tracked(op.resource) and op.acquire > 0:
                    rt, rw = grp(_KIND_RESOURCE)
                    rt.append(op.resource)
                    rw.append(op.acquire)
                idxs = sk_idx.get(op.resource)
                if idxs and op.args:
                    vt, vw = grp(_KIND_VALUE + op.resource + _SEP)
                    for pi in idxs:
                        if pi >= len(op.args):
                            continue
                        v = op.args[pi]
                        vals = v if isinstance(v, (list, tuple, set, frozenset)) else (v,)
                        for vv in vals:
                            k = ParamIndex._value_key(vv)
                            if k is not None and op.acquire > 0:
                                vt.append(k)
                                vw.append(op.acquire)
            for g in bulk:
                if track_res and tracked(g.resource):
                    acq = int(g.acquire.sum())
                    if acq > 0:
                        rt, rw = grp(_KIND_RESOURCE)
                        rt.append(g.resource)
                        rw.append(acq)
                idxs = sk_idx.get(g.resource)
                if idxs and g.args_column is not None:
                    vt, vw = grp(_KIND_VALUE + g.resource + _SEP)
                    for pi in idxs:
                        self._bulk_column_keys(g, pi, vt, vw)
            id_cols: List[np.ndarray] = []
            w_cols: List[np.ndarray] = []
            names = self._names
            for prefix, (tails, weights) in groups.items():
                if not tails:
                    continue
                ids = self._ids_for_locked(prefix, tails)
                id_cols.append(ids)
                w_cols.append(np.asarray(weights, dtype=np.int64))
                for i, t in zip(ids.tolist(), tails):
                    if i in names:
                        names.move_to_end(i)
                    else:
                        names[i] = prefix + t
            while len(names) > self.names_cap:
                names.popitem(last=False)
            if not id_cols:
                return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
            all_ids = np.concatenate(id_cols)
            all_w = np.concatenate(w_cols)
            uids, inv = np.unique(all_ids, return_inverse=True)
            wsum = np.bincount(inv, weights=all_w).astype(np.int64)
            keep = wsum > 0
            uids, wsum = uids[keep], wsum[keep]
            if self._exact:
                pos = np.searchsorted(uids, list(self._exact))
                for (i, ent), p in zip(self._exact.items(), pos.tolist()):
                    if p < len(uids) and uids[p] == i:
                        ent[0] += int(wsum[p])
            if self._host_cm is not None and len(uids):
                for di in range(self.depth):
                    np.add.at(self._host_cm[di], _hash_np(uids, di, self.width), wsum)
        return uids, wsum

    @staticmethod
    def _extract_column(g, pi: int):
        from sentinel_tpu_torch.rules.param_table import ArgsColumns, _extract_arg

        col = g.args_column
        if isinstance(col, ArgsColumns):
            return col.by_idx.get(pi)
        return [_extract_arg(a, pi) for a in col]

    def _bulk_column_keys(self, g, pi: int, tails: List[str], weights: List[int]) -> None:
        """One bulk args column reduced to (tail, weight) pairs: np.unique
        over the values and a bincount of acquire; a per-row walk only for
        mixed (unorderable) types."""
        from sentinel_tpu_torch.rules.param_table import ParamIndex

        col = self._extract_column(g, pi)
        if col is None:
            return
        arr = np.asarray(col, dtype=object)
        valid = arr != None  # noqa: E711 (elementwise None mask)
        if not valid.any():
            return
        try:
            uniq, inv = np.unique(arr[valid], return_inverse=True)
        except TypeError:
            for j, v in enumerate(col):
                if v is None:
                    continue
                if isinstance(v, (list, tuple, set, frozenset)):
                    for vv in v:
                        k = ParamIndex._value_key(vv)
                        if k is not None:
                            tails.append(k)
                            weights.append(int(g.acquire[j]))
                    continue
                k = v if type(v) is str else ParamIndex._value_key(v)
                if k is not None:
                    tails.append(k)
                    weights.append(int(g.acquire[j]))
            return
        wsum = np.bincount(inv, weights=g.acquire[valid])
        for v, wv in zip(uniq.tolist(), wsum.tolist()):
            if isinstance(v, (list, tuple, set, frozenset)):
                for vv in v:
                    k = ParamIndex._value_key(vv)
                    if k is not None:
                        tails.append(k)
                        weights.append(int(wv))
                continue
            k = v if type(v) is str else ParamIndex._value_key(v)
            if k is not None:
                tails.append(k)
                weights.append(int(wv))

    def encode_chunk(self, entries, bulk, findex, pindex) -> Tuple[np.ndarray, np.ndarray]:
        """One chunk's aggregated (ids, weights) columns, pow2-padded (-1
        id = padding): the :class:`SketchBatch` payload."""
        uids, wsum = self._collect(entries, bulk, findex, pindex)
        n = len(uids)
        s = _pad_pow2(max(n, 1), 8)
        ids = np.full(s, -1, dtype=np.int32)
        w = np.zeros(s, dtype=np.int32)
        if n:
            ids[:n] = uids.astype(np.int32)
            w[:n] = wsum.clip(0, _I32_MAX).astype(np.int32)
        return ids, w

    # ------------------------------------------------------------------
    # drain and controller
    # ------------------------------------------------------------------
    def on_drain(self, cand_ids: np.ndarray, cand_cnt: np.ndarray, now_ms: int) -> None:
        """Consume one drained candidate table: refresh the error gauge and
        occupancy, then run the promotion/demotion evaluation."""
        by_key: Dict[str, int] = {}
        with self._lock:
            wid = now_ms // self.window_ms
            cand: List[Tuple[int, Optional[str], int]] = []
            new_exact: Dict[int, List[int]] = {}
            errs: List[float] = []
            for i, c in zip(cand_ids.tolist(), cand_cnt.tolist()):
                if i < 0 or c <= 0:
                    continue
                key = self._names.get(i)
                cand.append((i, key, c))
                if key is not None:
                    by_key[key] = c
                ent = self._exact.get(i)
                if ent is None:
                    new_exact[i] = [0, wid]
                else:
                    new_exact[i] = ent
                    if ent[0] > 0 and ent[1] < wid:
                        errs.append(max(0, c - ent[0]) / ent[0])
            self._exact = new_exact
            self._last_candidates = cand
            self.est_error_ratio = float(np.mean(errs)) if errs else 0.0
            self.occupancy = len(cand) / float(self.candidates)
        self._evaluate(by_key, now_ms)

    # ------------------------------------------------------------------
    # sketch gossip (the tier's side; the transport is not ported)
    # ------------------------------------------------------------------
    def gossip_snapshot(self) -> Tuple[int, np.ndarray, List[Tuple[str, int]]]:
        """(window_id, int32 count-min copy, [(key, count)] candidates) of
        the LOCAL view only, so a peer counts this engine once."""
        with self._lock:
            wid = self._last_wid or 0
            if self._host_cm is not None:
                cm = np.clip(self._host_cm, 0, _I32_MAX).astype(np.int32)
            else:
                cm = np.zeros((self.depth, self.width), dtype=np.int32)
            cands = [(key, int(cnt)) for _i, key, cnt in self._last_candidates if key is not None and cnt > 0]
            if not cands and self.host_mirror.counts:
                cands = [(k, int(v)) for k, v in self.host_mirror.counts.items()]
        cands.sort(key=lambda kv: kv[1], reverse=True)
        return wid, cm, cands[: self.candidates]

    def merge_remote(self, origin: str, window_id: int, cm: np.ndarray, cands: Sequence[Tuple[str, int]]) -> bool:
        """Fold one peer frame, replacing that origin's last one. Frames of
        another (depth, width) are dropped; staleness runs on our clock."""
        if not self.gossip_armed:
            return False
        arr = np.asarray(cm, dtype=np.int64)
        if arr.shape != (self.depth, self.width):
            return False
        folded = {str(k): int(c) for k, c in cands if int(c) > 0}
        with self._lock:
            self._remote[origin] = [arr.copy(), folded, self._last_wid or 0]
            self.gossip_merges += 1
        return True

    def _fleet_by_key(self, by_key: Dict[str, int]) -> Dict[str, int]:
        """The controller's input under gossip: each key at max(local
        count, estimate over local + remote twins, saturated to int32),
        over the local and remote candidate keys. Without remotes,
        ``by_key`` untouched."""
        if not self.gossip_armed:
            return by_key
        with self._lock:
            if not self._remote:
                return by_key
            fleet = np.zeros((self.depth, self.width), dtype=np.int64)
            if self._host_cm is not None:
                fleet += self._host_cm
            for ent in self._remote.values():
                fleet += ent[0]
            np.clip(fleet, 0, _I32_MAX, out=fleet)
            keys = set(by_key)
            for ent in self._remote.values():
                keys.update(ent[1])
            key_list = sorted(keys)
            if not key_list:
                return by_key
            ids = np.fromiter((key_id(k) for k in key_list), dtype=np.int64, count=len(key_list))
            ests = cm_estimate(fleet, ids)
        return {k: max(by_key.get(k, 0), int(e)) for k, e in zip(key_list, ests.tolist())}

    def gossip_info(self) -> dict:
        with self._lock:
            return {
                "armed": self.gossip_armed,
                "merges": self.gossip_merges,
                "remote_origins": sorted(self._remote),
                "stale_windows": self.gossip_stale_windows,
            }

    def _evaluate(self, by_key: Dict[str, int], now_ms: int) -> None:
        """The promotion/demotion state machine over one candidate view.
        Value promotions take effect at once (published-set swap); flow
        rule installs and removals queue as actions for the next flush."""
        by_key = self._fleet_by_key(by_key)
        win_s = self.window_ms / 1000.0
        wid = now_ms // self.window_ms
        with self._lock:
            # Re-assert synthetics a user reload wiped.
            if self._promoted_res:
                findex = self._engine.flow_index
                if any(res not in findex.by_resource for res in self._promoted_res):
                    self._actions.append(("flow", None))
            for key, cnt in by_key.items():
                kind = key[:1]
                if kind == _KIND_VALUE and self.promote_qps > 0:
                    resource, _, vkey = key[1:].partition(_SEP)
                    if vkey in self._promoted_vals.get(resource, ()):
                        continue
                    if cnt >= PROMOTE_FACTOR * self.promote_qps * win_s and self.promoted_count < self.promote_max:
                        self._promoted_vals.setdefault(resource, set()).add(vkey)
                        self._publish_promoted_locked()
                        self._low.pop(key, None)
                elif kind == _KIND_RESOURCE and self.resource_qps > 0:
                    resource = key[1:]
                    if resource in self._promoted_res:
                        continue
                    if resource in self._engine.flow_index.by_resource:
                        continue  # a user rule appeared: never stack a synthetic on it
                    if cnt >= PROMOTE_FACTOR * self.resource_qps * win_s and self.promoted_count < self.promote_max:
                        from sentinel_tpu_torch.models.rules import FlowRule

                        self._promoted_res[resource] = FlowRule(
                            resource=resource, count=float(self.resource_qps), from_sketch=True
                        )
                        self._actions.append(("flow", None))
                        self._low.pop(key, None)
            for resource, vals in list(self._promoted_vals.items()):
                for vkey in list(vals):
                    key = _KIND_VALUE + resource + _SEP + vkey
                    if self._cold_locked(key, by_key.get(key, 0), DEMOTE_FACTOR * self.promote_qps * win_s, wid):
                        vals.discard(vkey)
                        if not vals:
                            del self._promoted_vals[resource]
                        self._publish_promoted_locked()
                        self._actions.append(("param_release", resource, vkey))
            for resource in list(self._promoted_res):
                key = _KIND_RESOURCE + resource
                if self._cold_locked(key, by_key.get(key, 0), DEMOTE_FACTOR * self.resource_qps * win_s, wid):
                    del self._promoted_res[resource]
                    self._actions.append(("flow", None))
        # The promotion and demotion counters of the telemetry bus wait for
        # ROADMAP Queue 1 item 8 (metrics and observability), the capture
        # tier's rule-timeline note for item 7 (engine tiers).

    def _cold_locked(self, key: str, cnt: int, floor: float, wid: int) -> bool:
        """One demotion step: at most one cold window per window id; any
        warm sighting clears the streak."""
        if cnt >= floor and floor > 0:
            self._low.pop(key, None)
            return False
        ent = self._low.get(key)
        if ent is None:
            self._low[key] = [1, wid]
            return self.demote_windows <= 1
        if wid > ent[1]:
            ent[0] += 1
            ent[1] = wid
        if ent[0] >= self.demote_windows:
            del self._low[key]
            return True
        return False

    def _publish_promoted_locked(self) -> None:
        self.promoted_values = {r: frozenset(v) for r, v in self._promoted_vals.items() if v}

    # ------------------------------------------------------------------
    # deferred actions (flow-rule rebuilds, param row releases)
    # ------------------------------------------------------------------
    def apply_actions(self) -> None:
        """Apply queued controller actions; called at flush entry, outside
        the flush lock (a rebuild flushes pending ops like any reload)."""
        with self._lock:
            actions, self._actions = self._actions, []
            synth = list(self._promoted_res.items())
        if not actions:
            return
        eng = self._engine
        releases = [a for a in actions if a[0] == "param_release"]
        if releases:
            with eng._lock:
                for _, resource, vkey in releases:
                    eng.param_index.release_value(resource, vkey)
        if any(a[0] == "flow" for a in actions):
            keep = []
            for resource, rule in synth:
                if eng.nodes.lookup_cluster_row(resource) is None:
                    # An over-cap resource's promotion is its row grant,
                    # within the cumulative budget.
                    with self._lock:
                        if resource not in self._cap_grants and len(self._cap_grants) >= 8 * max(
                            self.promote_max, 1
                        ):
                            self._promoted_res.pop(resource, None)
                            continue
                        self._cap_grants.add(resource)
                    eng.nodes.promote_cluster_row(resource)
                keep.append(rule)
            eng.set_flow_rules(eng.flow_index.user_rules() + keep)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def reset_device_state(self) -> None:
        if self.enabled:
            self.dev_state = make_sketch_state(self.depth, self.width, self.candidates, self._engine.device)

    def on_rebase(self, offset_ms: int) -> None:
        """Engine epoch rebase: keep the decay clock monotonic."""
        with self._lock:
            if self._last_wid is not None:
                self._last_wid = max(0, self._last_wid - offset_ms // self.window_ms)
            for ent in self._remote.values():
                ent[2] = max(0, ent[2] - offset_ms // self.window_ms)

    def reset(self) -> None:
        with self._lock:
            self._names.clear()
            self._id_memo = {}
            self._id_memo_n = 0
            self._exact.clear()
            self._pending_unrouted = []
            self._last_wid = None
            self._promoted_vals = {}
            self.promoted_values = {}
            self._promoted_res = {}
            self._low = {}
            self._actions = []
            self._cap_grants = set()
            self._last_candidates = []
            self.est_error_ratio = 0.0
            self.occupancy = 0.0
            self.host_mirror.clear()
            if self._host_cm is not None:
                self._host_cm[:] = 0
            self._remote = {}
            self.gossip_merges = 0
            self.cold_blocks = 0
            self.cold_value_blocks = 0
        self.reset_device_state()

    # ------------------------------------------------------------------
    # readers
    # ------------------------------------------------------------------
    def candidates_snapshot(self, k: Optional[int] = None) -> List[dict]:
        """Decoded view of the last drained candidate table (``k`` defaults
        to the engine's blocked top-K, else sentinel.tpu.telemetry.topk.export)."""
        if k is None:
            k = self._engine._blk_topk_k or config.get_int(config.TELEMETRY_TOPK_EXPORT, 10)
        with self._lock:
            cand = sorted(self._last_candidates, key=lambda t: t[2], reverse=True)[: max(0, int(k))]
            out = []
            for i, key, cnt in cand:
                kind = "unresolved"
                name = None
                if key is not None:
                    if key[:1] == _KIND_RESOURCE:
                        kind, name = "resource", key[1:]
                    elif key[:1] == _KIND_VALUE:
                        resource, _, vkey = key[1:].partition(_SEP)
                        kind, name = "value", f"{resource}|{vkey}"
                out.append({"id": i, "kind": kind, "key": name, "estimate": cnt})
            return out

    def snapshot(self) -> dict:
        with self._lock:
            promoted_vals = {r: sorted(v) for r, v in self._promoted_vals.items()}
            promoted_res = sorted(self._promoted_res)
            host_top = sorted(self.host_mirror.counts.items(), key=lambda kv: kv[1], reverse=True)[:16]
        return {
            "enabled": self.enabled,
            "depth": self.depth,
            "width": self.width,
            "candidates": self.candidates,
            "window_ms": self.window_ms,
            "promote_qps": self.promote_qps,
            "resource_qps": self.resource_qps,
            "promote_max": self.promote_max,
            "demote_windows": self.demote_windows,
            "cold_qps": self.cold_qps,
            "cold_blocks": self.cold_blocks,
            "cold_value_blocks": self.cold_value_blocks,
            "occupancy": round(self.occupancy, 4),
            "est_error_ratio": round(self.est_error_ratio, 6),
            "promoted_count": self.promoted_count,
            "promoted_values": promoted_vals,
            "promoted_resources": promoted_res,
            "gossip": self.gossip_info(),
            "candidates_topk": self.candidates_snapshot(),
            "host_mirror_topk": [{"key": k[1:].replace(_SEP, "|"), "estimate": v} for k, v in host_top],
        }
