"""Pickle-free columnar frame codec for the multi-process ingest plane.

One frame = one ring slot's payload: a fixed header, an intern block
(strings crossing the boundary for the first time on this connection),
fixed numpy columns, and a varbytes region (args values). Strings that
repeat — resource, context, origin — ride as 32-bit **intern ids**
scoped to the (worker, intern generation) connection: each crosses the
boundary exactly once; the engine keeps the per-worker id→name decode
table, and a generation bump in the control header (plane restart)
makes every worker re-intern from scratch.

The admission tracer's W3C trace identity survives the process boundary as a packed
26-byte column per row (16-byte trace id, 8-byte span id, flags,
presence) — the engine-side plane reconstructs the
:class:`~sentinel_tpu_torch.metrics.admission_trace.TraceContext` and records
per-request admission traces exactly like the batch window does.

Frame kinds::

    ENTRY    n single admissions (mixed resources; the plane regroups
             onto the columnar spine) — columns ts/acquire/entry_type/
             resource/context/origin ids + trace + per-row args
    EXIT     n completions — never shed, never blocked; released even
             while the engine is DEGRADED
    BULK     one pre-grouped columnar group (one resource) of n rows —
             the worker-side analog of submit_bulk
    VERDICT  n (req_id, admitted, reason, wait_ms, flags) rows fanned
             back on a worker's response ring

Everything is little-endian and fixed-width; encode is a handful of
``tobytes`` joins, decode a handful of ``np.frombuffer`` views — no
pickle, no per-row Python on the hot columns.
"""

from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

KIND_ENTRY = 1
KIND_EXIT = 2
KIND_BULK = 3
KIND_VERDICT = 4
# Worker reconnect: after an engine hot-restart (control
# header's boot epoch bumped) a worker re-asserts its live-admission
# ledger so the NEW engine can rebuild per-worker ledgers and charge
# the THREAD gauges its world never saw admitted.
KIND_REASSERT = 5

# Frame-header flag bits.
F_FRAME_RECONNECT = 1  # first frame of one reconnect re-assertion

# Frame header: kind u8, flags u8, worker u16, n u32, base_seq u64,
# intern_gen u32, shed u32, n_interns u32, varbytes u32 -> 28 bytes.
_HDR = struct.Struct("<BBHIQIIII")
_INTERN_HDR = struct.Struct("<II")  # id, byte length

_TRACE_BYTES = 26  # 16B trace id + 8B span id + 1B flags + 1B present


class IpcVerdict(NamedTuple):
    """A worker-visible verdict — the wire twin of the engine's
    :class:`~sentinel_tpu_torch.runtime.engine.Verdict` (no rule bean: rule
    objects do not cross the process boundary; ``limit_type`` carries
    the shed cause / system dimension string)."""

    admitted: bool
    reason: int
    wait_ms: int
    limit_type: str = ""
    degraded: bool = False
    speculative: bool = False


# verdict flag bits
F_SPECULATIVE = 1
F_DEGRADED = 2


def pack_trace(
    trace_id: str, span_id: str, sampled: bool
) -> bytes:
    """One row's packed traceparent (the worker encodes the AMBIENT
    inbound context — parent span, not a child: the admission record is
    a child of the inbound hop, and the engine mints its span id at
    record time exactly like the in-process tracer)."""
    try:
        t = bytes.fromhex(trace_id)
        s = bytes.fromhex(span_id)
    except ValueError:
        return b"\x00" * _TRACE_BYTES
    if len(t) != 16 or len(s) != 8:
        return b"\x00" * _TRACE_BYTES
    return t + s + bytes([1 if sampled else 0, 1])


def unpack_trace(raw: bytes) -> Optional[Tuple[str, str, bool]]:
    """(trace_id, span_id, sampled) or None when the row was untraced."""
    if len(raw) != _TRACE_BYTES or raw[25] == 0:
        return None
    return raw[:16].hex(), raw[16:24].hex(), bool(raw[24] & 1)


EMPTY_TRACE = b"\x00" * _TRACE_BYTES


# ---------------------------------------------------------------------------
# args value codec (tag + fixed/length-prefixed payload per value)
# ---------------------------------------------------------------------------
_I64 = struct.Struct("<q")
_I32 = struct.Struct("<i")
_I8 = struct.Struct("<b")
_F64 = struct.Struct("<d")
_U32 = struct.Struct("<I")
_U16 = struct.Struct("<H")
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _enc_value(v, out: List[bytes]) -> None:
    if v is None:
        out.append(b"N")
    elif v is True:
        out.append(b"T")
    elif v is False:
        out.append(b"F")
    elif type(v) is int and _I64_MIN <= v <= _I64_MAX:
        out.append(b"i")
        out.append(_I64.pack(v))
    elif isinstance(v, float):
        out.append(b"f")
        out.append(_F64.pack(v))
    elif isinstance(v, str):
        b = v.encode("utf-8", "surrogatepass")
        out.append(b"s")
        out.append(_U32.pack(len(b)))
        out.append(b)
    elif isinstance(v, bytes):
        out.append(b"b")
        out.append(_U32.pack(len(v)))
        out.append(v)
    elif isinstance(v, (list, tuple, set, frozenset)):
        items = list(v)
        out.append(b"(")
        out.append(_U16.pack(len(items)))
        for it in items:
            _enc_value(it, out)
    else:
        # Arbitrary objects cannot cross pickle-free; their stable
        # string key is what param rules match on anyway.
        b = repr(v).encode("utf-8", "surrogatepass")
        out.append(b"s")
        out.append(_U32.pack(len(b)))
        out.append(b)


def encode_args(args: Sequence[object]) -> bytes:
    if not args:
        return b""
    out: List[bytes] = [_U16.pack(len(args))]
    for v in args:
        _enc_value(v, out)
    return b"".join(out)


def _args_need(buf: bytes, off: int, nbytes: int) -> None:
    # Truncated payloads must raise (never silently short-slice into a
    # misdecoded value): args blobs are now a DURABLE format (capture
    # segments), not just ring slots sliced to exact length.
    if off + nbytes > len(buf):
        raise ValueError(
            f"truncated args payload: need {nbytes} bytes at {off}, "
            f"have {len(buf) - off}"
        )


def _dec_value(buf: bytes, off: int) -> Tuple[object, int]:
    tag = buf[off : off + 1]
    off += 1
    if tag == b"N":
        return None, off
    if tag == b"T":
        return True, off
    if tag == b"F":
        return False, off
    if tag == b"i":
        _args_need(buf, off, 8)
        return _I64.unpack_from(buf, off)[0], off + 8
    if tag == b"f":
        _args_need(buf, off, 8)
        return _F64.unpack_from(buf, off)[0], off + 8
    if tag in (b"s", b"b"):
        _args_need(buf, off, 4)
        n = _U32.unpack_from(buf, off)[0]
        off += 4
        _args_need(buf, off, n)
        raw = buf[off : off + n]
        return (
            raw.decode("utf-8", "surrogatepass") if tag == b"s" else raw
        ), off + n
    if tag == b"(":
        _args_need(buf, off, 2)
        n = _U16.unpack_from(buf, off)[0]
        off += 2
        items = []
        for _ in range(n):
            v, off = _dec_value(buf, off)
            items.append(v)
        return tuple(items), off
    raise ValueError(f"bad args tag {tag!r} at {off - 1}")


def decode_args(buf: bytes) -> Tuple[object, ...]:
    if not buf:
        return ()
    _args_need(buf, 0, 2)
    n = _U16.unpack_from(buf, 0)[0]
    off = 2
    out = []
    for _ in range(n):
        v, off = _dec_value(buf, off)
        out.append(v)
    return tuple(out)


# ---------------------------------------------------------------------------
# request rows (worker -> plane)
# ---------------------------------------------------------------------------
class EntryRow(NamedTuple):
    """One pending single admission on the worker side (ids already
    interned by the client)."""

    seq: int
    resource_id: int
    context_id: int
    origin_id: int
    entry_type: int
    acquire: int
    ts: int  # engine-relative ms, or -1 = plane stamps at decode
    trace: bytes  # packed 26B (EMPTY_TRACE when untraced)
    args: bytes  # encode_args payload ("" = no args)


class ExitRow(NamedTuple):
    seq: int
    resource_id: int
    context_id: int
    origin_id: int
    entry_type: int
    ts: int
    rt: int
    count: int
    err: int
    spec: int  # 0 unknown, 1 speculative, 2 device-decided


class ReassertRow(NamedTuple):
    """One live-admission ledger line re-asserted after an engine
    hot-restart: ``count`` admissions of ``acquire`` each, still live
    in this worker (their exits will arrive later and must pair)."""

    resource_id: int
    context_id: int
    origin_id: int
    entry_type: int
    spec: int  # 1 = mirror-charged (speculative/degraded admit)
    acquire: int
    count: int


def encode_entries(
    worker_id: int,
    rows: Sequence[EntryRow],
    interns: Sequence[Tuple[int, bytes]],
    intern_gen: int,
    shed_count: int,
    kind: int = KIND_ENTRY,
    group_meta: Optional[bytes] = None,
) -> bytes:
    """ENTRY/BULK frame bytes. ``group_meta`` (BULK only) rides at the
    head of the varbytes region (args offsets are relative to its
    end)."""
    n = len(rows)
    meta = group_meta or b""
    seqs = np.fromiter((r.seq for r in rows), np.uint64, n)
    ts = np.fromiter((r.ts for r in rows), np.int64, n)
    acq = np.fromiter((r.acquire for r in rows), np.int32, n)
    etype = np.fromiter((r.entry_type for r in rows), np.int8, n)
    rid = np.fromiter((r.resource_id for r in rows), np.int32, n)
    cid = np.fromiter((r.context_id for r in rows), np.int32, n)
    oid = np.fromiter((r.origin_id for r in rows), np.int32, n)
    traces = b"".join(r.trace for r in rows)
    args_off = np.empty(n, np.uint32)
    args_len = np.empty(n, np.uint32)
    var_parts: List[bytes] = [meta]
    pos = len(meta)
    for i, r in enumerate(rows):
        args_off[i] = pos
        args_len[i] = len(r.args)
        if r.args:
            var_parts.append(r.args)
            pos += len(r.args)
    varbytes = b"".join(var_parts)
    intern_parts: List[bytes] = []
    for iid, raw in interns:
        intern_parts.append(_INTERN_HDR.pack(iid, len(raw)))
        intern_parts.append(raw)
    intern_blob = b"".join(intern_parts)
    hdr = _HDR.pack(
        kind, 0, worker_id, n, int(rows[0].seq) if n else 0,
        intern_gen & 0xFFFFFFFF, shed_count & 0xFFFFFFFF,
        len(interns), len(varbytes),
    )
    return b"".join(
        (
            hdr, intern_blob,
            seqs.tobytes(), ts.tobytes(), acq.tobytes(), etype.tobytes(),
            rid.tobytes(), cid.tobytes(), oid.tobytes(), traces,
            args_off.tobytes(), args_len.tobytes(), varbytes,
        )
    )


def encode_entries_columns(
    worker_id: int,
    base_seq: int,
    ts,
    acquire,
    entry_type: int,
    resource_id: int,
    context_id: int,
    origin_id: int,
    interns: Sequence[Tuple[int, bytes]],
    intern_gen: int,
) -> bytes:
    """BULK frame of one uniform columnar group: one (resource, context,
    origin, entry_type) shared by all rows, ``seq = base_seq + arange(n)``,
    per-row ``ts``/``acquire`` arrays, no traces, no args. Byte-identical
    to ``encode_entries`` over the equivalent EntryRow list; the one-group
    case of :func:`encode_entry_groups`."""
    ts = np.ascontiguousarray(ts, np.int64)
    return encode_entry_groups(worker_id, base_seq, [len(ts)], ts, acquire,
                               [(entry_type, resource_id, context_id, origin_id, interns, None)], intern_gen)[0]


def encode_exits(
    worker_id: int,
    rows: Sequence[ExitRow],
    interns: Sequence[Tuple[int, bytes]],
    intern_gen: int,
    shed_count: int,
    extras: bytes = b"",
) -> bytes:
    """EXIT frame bytes. ``extras`` (optional) rides as the frame's
    varbytes region — the ring clients never set it; the capture
    journal uses it for the per-exit param-thread-row sidecar."""
    n = len(rows)
    seqs = np.fromiter((r.seq for r in rows), np.uint64, n)
    ts = np.fromiter((r.ts for r in rows), np.int64, n)
    rid = np.fromiter((r.resource_id for r in rows), np.int32, n)
    cid = np.fromiter((r.context_id for r in rows), np.int32, n)
    oid = np.fromiter((r.origin_id for r in rows), np.int32, n)
    etype = np.fromiter((r.entry_type for r in rows), np.int8, n)
    rt = np.fromiter((r.rt for r in rows), np.int32, n)
    count = np.fromiter((r.count for r in rows), np.int32, n)
    err = np.fromiter((r.err for r in rows), np.int32, n)
    spec = np.fromiter((r.spec for r in rows), np.int8, n)
    intern_parts: List[bytes] = []
    for iid, raw in interns:
        intern_parts.append(_INTERN_HDR.pack(iid, len(raw)))
        intern_parts.append(raw)
    hdr = _HDR.pack(
        KIND_EXIT, 0, worker_id, n, int(rows[0].seq) if n else 0,
        intern_gen & 0xFFFFFFFF, shed_count & 0xFFFFFFFF,
        len(interns), len(extras),
    )
    return b"".join(
        (
            hdr, b"".join(intern_parts),
            seqs.tobytes(), ts.tobytes(), rid.tobytes(), cid.tobytes(),
            oid.tobytes(), etype.tobytes(), rt.tobytes(), count.tobytes(),
            err.tobytes(), spec.tobytes(), extras,
        )
    )


def encode_entry_groups(
    worker_id: int,
    base_seq: int,
    ns: Sequence[int],
    ts,
    acquire,
    groups: Sequence[Tuple[int, int, int, int, Sequence[Tuple[int, bytes]], Optional[Sequence[bytes]]]],
    intern_gen: int,
) -> List[bytes]:
    """BULK frames of many uniform groups (no traces): group ``i`` has
    ``ns[i]`` rows, seqs following on from ``base_seq`` group after group,
    and ``groups[i] = (entry_type, resource_id, context_id,
    origin_id, interns, args)``, ``args`` one ``encode_args`` payload a row
    (``b""`` for a row without) or None; ``ts`` and ``acquire`` are the
    groups' columns concatenated. Byte-identical to one
    ``encode_entries`` call a group over its EntryRows, but a column of a
    frame is a slice of one buffer of the chunk or a repeated constant:
    no numpy call a group without args (the capture journal's bulk
    spill)."""
    total = int(sum(ns))
    seq_b = memoryview(np.arange(base_seq, base_seq + total, dtype=np.uint64)).cast("B")
    ts_b = memoryview(np.ascontiguousarray(ts, np.int64)).cast("B")
    acq_b = memoryview(np.ascontiguousarray(acquire, np.int32)).cast("B")
    out: List[bytes] = []
    pos = 0
    for n, (etype, rid, cid, oid, interns, args) in zip(ns, groups):
        intern_parts: List[bytes] = []
        for iid, raw in interns:
            intern_parts.append(_INTERN_HDR.pack(iid, len(raw)))
            intern_parts.append(raw)
        if args is None:
            offs_lens, varbytes = bytes(8 * n), b""
        else:
            lens = np.fromiter(map(len, args), np.uint32, n)
            offs = np.zeros(n, np.uint32)
            np.cumsum(lens[:-1], out=offs[1:])
            offs_lens, varbytes = offs.tobytes() + lens.tobytes(), b"".join(args)
        out.append(b"".join((
            _HDR.pack(KIND_BULK, 0, worker_id, n, base_seq + pos if n else 0, intern_gen & 0xFFFFFFFF, 0,
                      len(interns), len(varbytes)),
            b"".join(intern_parts),
            seq_b[8 * pos: 8 * (pos + n)], ts_b[8 * pos: 8 * (pos + n)], acq_b[4 * pos: 4 * (pos + n)],
            _I8.pack(etype) * n, _I32.pack(rid) * n, _I32.pack(cid) * n, _I32.pack(oid) * n,
            EMPTY_TRACE * n, offs_lens, varbytes,
        )))
        pos += n
    return out


def encode_exit_columns(
    worker_id: int,
    seq: int,
    resource_id: int,
    context_id: int,
    origin_id: int,
    entry_type: int,
    ts,
    rt,
    count,
    err,
    interns: Sequence[Tuple[int, bytes]],
    intern_gen: int,
) -> bytes:
    """Vectorized EXIT frame for a uniform columnar exit group: one
    ``seq`` field, (resource, context, origin) and entry_type shared by
    all rows, per-row ``ts``/``rt``/``count``/``err`` arrays, spec 0, no
    extras. Byte-identical to ``encode_exits`` over the equivalent
    ExitRow list (the capture journal's bulk-exit spill)."""
    ts = np.ascontiguousarray(ts, np.int64)
    n = len(ts)
    intern_parts: List[bytes] = []
    for iid, raw in interns:
        intern_parts.append(_INTERN_HDR.pack(iid, len(raw)))
        intern_parts.append(raw)
    hdr = _HDR.pack(
        KIND_EXIT, 0, worker_id, n, int(seq) if n else 0,
        intern_gen & 0xFFFFFFFF, 0, len(interns), 0,
    )
    return b"".join(
        (
            hdr, b"".join(intern_parts),
            np.full(n, seq, np.uint64).tobytes(), ts.tobytes(),
            np.full(n, resource_id, np.int32).tobytes(),
            np.full(n, context_id, np.int32).tobytes(),
            np.full(n, origin_id, np.int32).tobytes(),
            np.full(n, entry_type, np.int8).tobytes(),
            np.ascontiguousarray(rt).astype(np.int32).tobytes(),
            np.ascontiguousarray(count).astype(np.int32).tobytes(),
            np.ascontiguousarray(err).astype(np.int32).tobytes(),
            bytes(n),
        )
    )


def encode_reasserts(
    worker_id: int,
    rows: Sequence[ReassertRow],
    interns: Sequence[Tuple[int, bytes]],
    intern_gen: int,
    shed_count: int,
    head: bool = False,
) -> bytes:
    """REASSERT frame bytes; ``head`` marks the FIRST frame of one
    reconnect sequence (the plane counts reconnect events off it, not
    off every chunk)."""
    n = len(rows)
    rid = np.fromiter((r.resource_id for r in rows), np.int32, n)
    cid = np.fromiter((r.context_id for r in rows), np.int32, n)
    oid = np.fromiter((r.origin_id for r in rows), np.int32, n)
    etype = np.fromiter((r.entry_type for r in rows), np.int8, n)
    spec = np.fromiter((r.spec for r in rows), np.int8, n)
    acq = np.fromiter((r.acquire for r in rows), np.int32, n)
    count = np.fromiter((r.count for r in rows), np.int32, n)
    intern_parts: List[bytes] = []
    for iid, raw in interns:
        intern_parts.append(_INTERN_HDR.pack(iid, len(raw)))
        intern_parts.append(raw)
    hdr = _HDR.pack(
        KIND_REASSERT, F_FRAME_RECONNECT if head else 0, worker_id, n, 0,
        intern_gen & 0xFFFFFFFF, shed_count & 0xFFFFFFFF,
        len(interns), 0,
    )
    return b"".join(
        (
            hdr, b"".join(intern_parts),
            rid.tobytes(), cid.tobytes(), oid.tobytes(), etype.tobytes(),
            spec.tobytes(), acq.tobytes(), count.tobytes(),
        )
    )


class DecodedFrame(NamedTuple):
    kind: int
    worker_id: int
    n: int
    intern_gen: int
    shed_count: int
    interns: List[Tuple[int, bytes]]
    columns: Dict[str, np.ndarray]
    traces: bytes  # ENTRY/BULK: n * 26 bytes ("" otherwise)
    varbytes: bytes
    flags: int = 0


def _need(payload: bytes, off: int, nbytes: int, what: str) -> None:
    # Every region read is bounds-checked up front so a torn segment
    # tail (or a fuzzer's truncation) raises ONE clean ValueError
    # instead of struct.error / a silently short np.frombuffer slice
    # that would misalign every column after it.
    if off + nbytes > len(payload):
        raise ValueError(
            f"truncated frame: {what} needs {nbytes} bytes at {off}, "
            f"payload is {len(payload)}"
        )


class UniformEntries(NamedTuple):
    """An ENTRY/BULK frame whose rows share one resource, context and
    origin and carry no args (:func:`decode_uniform_entries`); the
    columns are read-only views of the payload."""

    n: int
    interns: List[Tuple[int, bytes]]
    seq: np.ndarray
    ts: np.ndarray
    acquire: np.ndarray
    entry_type: np.ndarray
    resource_id: int
    context_id: int
    origin_id: int


def decode_uniform_entries(payload: bytes) -> Optional[UniformEntries]:
    """Decode an ENTRY/BULK frame of one (resource, context, origin) and no
    args with one length check and byte comparisons in place of column
    scans (the capture journal's bulk groups). None for any other frame,
    a truncated one included: :func:`decode_frame` decodes (or refuses)
    those."""
    if len(payload) < _HDR.size:
        return None
    kind, _flags, _worker, n, _base, _gen, _shed, n_interns, var_len = _HDR.unpack_from(payload, 0)
    if kind not in (KIND_ENTRY, KIND_BULK) or var_len or not n:
        return None
    off = _HDR.size
    interns: List[Tuple[int, bytes]] = []
    for _ in range(n_interns):
        if off + _INTERN_HDR.size > len(payload):
            return None
        iid, ln = _INTERN_HDR.unpack_from(payload, off)
        off += _INTERN_HDR.size
        interns.append((iid, payload[off: off + ln]))
        off += ln
    if off + ENTRY_ROW_BYTES * n != len(payload):
        return None
    seq = np.frombuffer(payload, np.uint64, n, off)
    ts = np.frombuffer(payload, np.int64, n, off + 8 * n)
    acquire = np.frombuffer(payload, np.int32, n, off + 16 * n)
    entry_type = np.frombuffer(payload, np.int8, n, off + 20 * n)
    off += 21 * n
    ids = []
    for _ in range(3):
        first = payload[off: off + 4]
        if payload[off: off + 4 * n] != first * n:
            return None
        ids.append(_I32.unpack(first)[0])
        off += 4 * n
    off += _TRACE_BYTES * n + 4 * n  # the traces and args_off are not read
    if payload[off: off + 4 * n] != bytes(4 * n):
        return None  # a row with args
    return UniformEntries(n, interns, seq, ts, acquire, entry_type, *ids)


def decode_frame(payload: bytes) -> DecodedFrame:
    _need(payload, 0, _HDR.size, "header")
    (
        kind, _flags, worker_id, n, _base, gen, shed, n_interns, var_len,
    ) = _HDR.unpack_from(payload, 0)
    off = _HDR.size
    interns: List[Tuple[int, bytes]] = []
    for _ in range(n_interns):
        _need(payload, off, _INTERN_HDR.size, "intern header")
        iid, ln = _INTERN_HDR.unpack_from(payload, off)
        off += _INTERN_HDR.size
        _need(payload, off, ln, "intern bytes")
        interns.append((iid, payload[off : off + ln]))
        off += ln

    def col(dtype, count=n):
        nonlocal off
        _need(payload, off, np.dtype(dtype).itemsize * count, "column")
        a = np.frombuffer(payload, dtype=dtype, count=count, offset=off)
        off += a.nbytes
        return a

    columns: Dict[str, np.ndarray] = {}
    traces = b""
    varbytes = b""
    if kind in (KIND_ENTRY, KIND_BULK):
        columns["seq"] = col(np.uint64)
        columns["ts"] = col(np.int64)
        columns["acquire"] = col(np.int32)
        columns["entry_type"] = col(np.int8)
        columns["resource_id"] = col(np.int32)
        columns["context_id"] = col(np.int32)
        columns["origin_id"] = col(np.int32)
        _need(payload, off, n * _TRACE_BYTES, "trace column")
        traces = payload[off : off + n * _TRACE_BYTES]
        off += n * _TRACE_BYTES
        columns["args_off"] = col(np.uint32)
        columns["args_len"] = col(np.uint32)
        _need(payload, off, var_len, "varbytes")
        varbytes = payload[off : off + var_len]
    elif kind == KIND_EXIT:
        columns["seq"] = col(np.uint64)
        columns["ts"] = col(np.int64)
        columns["resource_id"] = col(np.int32)
        columns["context_id"] = col(np.int32)
        columns["origin_id"] = col(np.int32)
        columns["entry_type"] = col(np.int8)
        columns["rt"] = col(np.int32)
        columns["count"] = col(np.int32)
        columns["err"] = col(np.int32)
        columns["spec"] = col(np.int8)
        _need(payload, off, var_len, "varbytes")
        varbytes = payload[off : off + var_len]
    elif kind == KIND_VERDICT:
        columns["seq"] = col(np.uint64)
        columns["admitted"] = col(np.uint8)
        columns["reason"] = col(np.int16)
        columns["wait_ms"] = col(np.int32)
        columns["flags"] = col(np.uint8)
    elif kind == KIND_REASSERT:
        columns["resource_id"] = col(np.int32)
        columns["context_id"] = col(np.int32)
        columns["origin_id"] = col(np.int32)
        columns["entry_type"] = col(np.int8)
        columns["spec"] = col(np.int8)
        columns["acquire"] = col(np.int32)
        columns["count"] = col(np.int32)
    else:
        raise ValueError(f"unknown frame kind {kind}")
    return DecodedFrame(
        kind, worker_id, n, gen, shed, interns, columns, traces, varbytes,
        _flags,
    )


def encode_verdicts(
    worker_id: int,
    seqs: np.ndarray,
    admitted: np.ndarray,
    reason: np.ndarray,
    wait_ms: np.ndarray,
    flags: np.ndarray,
) -> bytes:
    n = len(seqs)
    hdr = _HDR.pack(
        KIND_VERDICT, 0, worker_id, n, int(seqs[0]) if n else 0, 0, 0, 0, 0
    )
    return b"".join(
        (
            hdr,
            np.ascontiguousarray(seqs, np.uint64).tobytes(),
            np.ascontiguousarray(admitted, np.uint8).tobytes(),
            np.ascontiguousarray(reason, np.int16).tobytes(),
            np.ascontiguousarray(wait_ms, np.int32).tobytes(),
            np.ascontiguousarray(flags, np.uint8).tobytes(),
        )
    )


# Per-row fixed column bytes of an ENTRY/BULK frame:
# seq 8 + ts 8 + acquire 4 + entry_type 1 + resource 4 + context 4 +
# origin 4 + trace 26 + args_off 4 + args_len 4.
ENTRY_ROW_BYTES = 67
# Per-row bytes of an EXIT frame: seq 8 + ts 8 + resource 4 +
# context 4 + origin 4 + entry_type 1 + rt 4 + count 4 + err 4 + spec 1.
EXIT_ROW_BYTES = 42
# Per-row bytes of a REASSERT frame: resource 4 + context 4 + origin 4
# + entry_type 1 + spec 1 + acquire 4 + count 4.
REASSERT_ROW_BYTES = 22
# Header + intern-blob reserve per frame (a fresh connection's intern
# records ride the same slot).
FRAME_RESERVE = 512


def entry_frame_cap(slot_bytes: int, avg_args: int = 0) -> int:
    """Conservative rows-per-frame bound for a slot size. With args the
    caller must budget BYTES, not rows — see the client's greedy
    packing (a frame larger than the slot is refused by the ring and
    would otherwise read as phantom backpressure)."""
    per_row = ENTRY_ROW_BYTES + max(0, avg_args)
    return max(1, (slot_bytes - FRAME_RESERVE) // per_row)
