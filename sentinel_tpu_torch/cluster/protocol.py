"""Cluster wire protocol (port of ``sentinel_tpu/cluster/protocol.py``, byte
for byte: a client of either package talks to a server of the other).

Concepts from the reference's binary codec (reference:
sentinel-cluster-common-default/.../ClusterConstants.java:24-41 — msg
types PING=0 FLOW=1 PARAM_FLOW=2 CONCURRENT acquire/release, 2-byte
length-field framing in NettyTransportServer.java:89; xid request
correlation in TokenClientPromiseHolder.java:30). The byte layout here
is this framework's own (little-endian struct packing), not a copy of
the reference's codec.

Frame:   [u32 length][payload]
Request: [u32 xid][u8 type][body]
  FLOW body:        [i64 flow_id][i32 acquire][u8 prioritized]
  PARAM_FLOW body:  [i64 flow_id][i32 acquire][u16 n][n × (u16 len, bytes)]
  CONCURRENT_FLOW_ACQUIRE body: [i64 flow_id][i32 acquire][u8 0]
  CONCURRENT_FLOW_RELEASE body: [i64 token_id]
  PING body:        [] | [u16 len, bytes namespace]
Response:[u32 xid][u8 type][i8 status][i32 remaining][i32 wait_ms][i64 token_id]

Batched extension (this framework's own — the reference resolves one
token per round trip). One frame carries a whole admission window:

  FLOW_BATCH request:  [u32 xid][u8 type=16][u8 ver][u16 n]
                         n × (i64 flow_id, i32 acquire, u8 flags)  # bit0 prioritized
                       [u16 n_reports] n_reports × (i64 flow_id, i32 consumed)
  PARAM_FLOW_BATCH:    [u32 xid][u8 type=17][u8 ver]
                       [u16 n_interns] n_interns × (u32 vid, u16 len, bytes)
                       [u16 n] n × (i64 flow_id, i32 acquire, u16 nvals, nvals × u32 vid)
  Batch response:      [u32 xid][u8 type][u8 ver][u16 n]
                         n × (i8 status, i32 remaining, i32 wait_ms)
                       [u16 n_leases] n_leases × (i64 flow_id, i32 tokens, i32 valid_ms)

Param values are interned per connection: a value string crosses the
wire once, later rows reference its u32 vid (the IPC plane's dictionary
idea). The lease section lets the server grant local quota (n tokens,
valid valid_ms from receipt) for hot flows; the request-side report rows
reconcile client-local lease consumption for observability. Both batch
types carry an explicit version byte so the layout can evolve without a
new msg type; unknown versions are answered BAD_REQUEST, never parsed.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

from sentinel_tpu_torch.models import constants as C

_REQ_HDR = struct.Struct("<IB")
_FLOW_BODY = struct.Struct("<qiB")
_RELEASE_BODY = struct.Struct("<q")
_RESP = struct.Struct("<IBbiiq")
_LEN = struct.Struct("<I")

# Batched extension structs.
BATCH_VERSION = 1
_U16 = struct.Struct("<H")
_BATCH_ROW = struct.Struct("<qiB")  # flow_id, acquire, flags (bit0 prioritized)
_REPORT_ROW = struct.Struct("<qi")  # flow_id, consumed
_RESP_ROW = struct.Struct("<bii")  # status, remaining, wait_ms
_LEASE_ROW = struct.Struct("<qii")  # flow_id, tokens, valid_ms
_INTERN_HDR = struct.Struct("<IH")  # vid, value byte length
_PBATCH_ROW = struct.Struct("<qiH")  # flow_id, acquire, nvals
_VID = struct.Struct("<I")


def pack_flow_request(xid: int, flow_id: int, acquire: int, prioritized: bool) -> bytes:
    payload = _REQ_HDR.pack(xid, C.MSG_TYPE_FLOW) + _FLOW_BODY.pack(
        flow_id, acquire, 1 if prioritized else 0
    )
    return _LEN.pack(len(payload)) + payload


def pack_param_request(xid: int, flow_id: int, acquire: int, params: List[str]) -> bytes:
    body = _FLOW_BODY.pack(flow_id, acquire, 0) + struct.pack("<H", len(params))
    for p in params:
        raw = str(p).encode("utf-8")[:65535]
        body += struct.pack("<H", len(raw)) + raw
    payload = _REQ_HDR.pack(xid, C.MSG_TYPE_PARAM_FLOW) + body
    return _LEN.pack(len(payload)) + payload


def pack_ping(xid: int, namespace: str = "") -> bytes:
    """PING doubles as the namespace announcement: the reference's ping
    request carries the client namespace and the server registers the
    connection under it (TokenServerHandler.handlePingRequest,
    TokenServerHandler.java:94-106). An empty namespace keeps the legacy
    empty body for wire compat."""
    payload = _REQ_HDR.pack(xid, C.MSG_TYPE_PING)
    if namespace:
        raw = namespace.encode("utf-8")[:65535]
        payload += struct.pack("<H", len(raw)) + raw
    return _LEN.pack(len(payload)) + payload


def pack_concurrent_acquire(xid: int, flow_id: int, acquire: int) -> bytes:
    payload = _REQ_HDR.pack(xid, C.MSG_TYPE_CONCURRENT_FLOW_ACQUIRE) + _FLOW_BODY.pack(
        flow_id, acquire, 0
    )
    return _LEN.pack(len(payload)) + payload


def pack_concurrent_release(xid: int, token_id: int) -> bytes:
    payload = _REQ_HDR.pack(xid, C.MSG_TYPE_CONCURRENT_FLOW_RELEASE) + _RELEASE_BODY.pack(
        token_id
    )
    return _LEN.pack(len(payload)) + payload


def pack_response(
    xid: int, msg_type: int, status: int, remaining: int = 0, wait_ms: int = 0,
    token_id: int = 0,
) -> bytes:
    payload = _RESP.pack(xid, msg_type, status, remaining, wait_ms, token_id)
    return _LEN.pack(len(payload)) + payload


def pack_flow_batch_request(
    xid: int,
    rows: List[Tuple[int, int, bool]],
    reports: List[Tuple[int, int]] = (),
) -> bytes:
    """rows: [(flow_id, acquire, prioritized)]; reports: [(flow_id,
    consumed)] lease-consumption reconciliation rows."""
    parts = [
        _REQ_HDR.pack(xid, C.MSG_TYPE_FLOW_BATCH),
        struct.pack("<BH", BATCH_VERSION, len(rows)),
    ]
    for flow_id, acquire, prioritized in rows:
        parts.append(_BATCH_ROW.pack(flow_id, acquire, 1 if prioritized else 0))
    parts.append(_U16.pack(len(reports)))
    for flow_id, consumed in reports:
        parts.append(_REPORT_ROW.pack(flow_id, consumed))
    payload = b"".join(parts)
    return _LEN.pack(len(payload)) + payload


def pack_param_batch_request(
    xid: int,
    rows: List[Tuple[int, int, List[int]]],
    interns: List[Tuple[int, str]] = (),
) -> bytes:
    """rows: [(flow_id, acquire, [vid, ...])]; interns: [(vid, value)]
    — value strings this connection has not sent before."""
    parts = [
        _REQ_HDR.pack(xid, C.MSG_TYPE_PARAM_FLOW_BATCH),
        struct.pack("<B", BATCH_VERSION),
        _U16.pack(len(interns)),
    ]
    for vid, value in interns:
        raw = str(value).encode("utf-8")[:65535]
        parts.append(_INTERN_HDR.pack(vid, len(raw)))
        parts.append(raw)
    parts.append(_U16.pack(len(rows)))
    for flow_id, acquire, vids in rows:
        parts.append(_PBATCH_ROW.pack(flow_id, acquire, len(vids)))
        for vid in vids:
            parts.append(_VID.pack(vid))
    payload = b"".join(parts)
    return _LEN.pack(len(payload)) + payload


def pack_batch_response(
    xid: int,
    msg_type: int,
    rows: List[Tuple[int, int, int]],
    leases: List[Tuple[int, int, int]] = (),
) -> bytes:
    """rows: [(status, remaining, wait_ms)] positionally matching the
    request rows; leases: [(flow_id, tokens, valid_ms)]."""
    parts = [
        _REQ_HDR.pack(xid, msg_type),
        struct.pack("<BH", BATCH_VERSION, len(rows)),
    ]
    for status, remaining, wait_ms in rows:
        parts.append(_RESP_ROW.pack(status, remaining, wait_ms))
    parts.append(_U16.pack(len(leases)))
    for flow_id, tokens, valid_ms in leases:
        parts.append(_LEASE_ROW.pack(flow_id, tokens, valid_ms))
    payload = b"".join(parts)
    return _LEN.pack(len(payload)) + payload


# Sketch gossip frames (this framework's own). SKETCH_PUSH carries one
# engine's LOCAL sketch view; the SKETCH_MERGED answer carries the
# responder's LOCAL view back (never its merged view — a merged echo
# would double-count third parties on the next round). One round trip
# therefore exchanges both directions. Body:
#
#   [u32 xid][u8 type][u8 ver]
#   [u16 origin_len][origin bytes]          # stable engine identity
#   [i64 window_id][u8 depth][u32 width]
#   [u32 comp_len][zlib bytes]              # int32 LE [depth × width] CM
#   [u16 n_cands] n × (u16 key_len, key bytes, i64 count)
#
# The version byte rides the same policy as the batch frames: an
# unsupported version is answered with an EMPTY merged frame (0 depth/
# width, 0 candidates), never parsed.
GOSSIP_VERSION = 1
_GOSSIP_HDR = struct.Struct("<qBI")  # window_id, depth, width
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")


def pack_sketch_frame(
    xid: int,
    msg_type: int,
    origin: str,
    window_id: int,
    depth: int,
    width: int,
    cm_bytes: bytes,
    cands: List[Tuple[str, int]] = (),
) -> bytes:
    """``cm_bytes``: raw little-endian int32 [depth × width] array (the
    packer compresses); an empty array (depth=0) is the version-reject /
    nothing-to-share shape."""
    raw_origin = origin.encode("utf-8")[:65535]
    comp = zlib.compress(cm_bytes, 1) if cm_bytes else b""
    parts = [
        _REQ_HDR.pack(xid, msg_type),
        struct.pack("<B", GOSSIP_VERSION),
        _U16.pack(len(raw_origin)),
        raw_origin,
        _GOSSIP_HDR.pack(window_id, depth, width),
        _U32.pack(len(comp)),
        comp,
        _U16.pack(len(cands)),
    ]
    for key, count in cands:
        raw = key.encode("utf-8", "surrogatepass")[:65535]
        parts.append(_U16.pack(len(raw)))
        parts.append(raw)
        parts.append(_I64.pack(count))
    payload = b"".join(parts)
    return _LEN.pack(len(payload)) + payload


def unpack_sketch_frame(payload: bytes) -> tuple:
    """-> (xid, msg_type, origin, window_id, depth, width, cm_bytes,
    [(key, count)]). Raises UnsupportedBatchVersion on a foreign
    version byte (the caller answers an empty merged frame)."""
    xid, msg_type = _REQ_HDR.unpack_from(payload, 0)
    off = _REQ_HDR.size
    (ver,) = struct.unpack_from("<B", payload, off)
    off += 1
    if ver != GOSSIP_VERSION:
        raise UnsupportedBatchVersion(xid, msg_type, ver)
    (olen,) = _U16.unpack_from(payload, off)
    off += 2
    origin = payload[off : off + olen].decode("utf-8")
    off += olen
    window_id, depth, width = _GOSSIP_HDR.unpack_from(payload, off)
    off += _GOSSIP_HDR.size
    (clen,) = _U32.unpack_from(payload, off)
    off += 4
    if off + clen > len(payload):
        raise ValueError("truncated gossip sketch body")
    cm_bytes = zlib.decompress(payload[off : off + clen]) if clen else b""
    if len(cm_bytes) != depth * width * 4:
        raise ValueError("gossip sketch size mismatch")
    off += clen
    (n_cands,) = _U16.unpack_from(payload, off)
    off += 2
    cands = []
    for _ in range(n_cands):
        (klen,) = _U16.unpack_from(payload, off)
        off += 2
        if off + klen + 8 > len(payload):
            raise ValueError("truncated gossip candidate")
        key = payload[off : off + klen].decode("utf-8", "surrogatepass")
        off += klen
        (count,) = _I64.unpack_from(payload, off)
        off += 8
        cands.append((key, count))
    if off != len(payload):
        raise ValueError("trailing bytes after gossip frame")
    return xid, msg_type, origin, window_id, depth, width, cm_bytes, cands


def peek_msg_type(payload: bytes) -> int:
    """Message type of a request OR response payload without a full
    parse — both layouts start [u32 xid][u8 type]. -1 for a frame too
    short to carry a type (the caller's normal parse then raises the
    usual struct.error, same as before peeking existed)."""
    if len(payload) < 5:
        return -1
    return payload[4]


def unpack_batch_response(
    payload: bytes,
) -> Tuple[int, int, List[Tuple[int, int, int]], List[Tuple[int, int, int]]]:
    """-> (xid, msg_type, [(status, remaining, wait_ms)],
    [(flow_id, tokens, valid_ms)])."""
    xid, msg_type = _REQ_HDR.unpack_from(payload, 0)
    off = _REQ_HDR.size
    ver, n = struct.unpack_from("<BH", payload, off)
    off += 3
    if ver != BATCH_VERSION:
        raise ValueError(f"unsupported batch response version {ver}")
    rows = []
    for _ in range(n):
        rows.append(_RESP_ROW.unpack_from(payload, off))
        off += _RESP_ROW.size
    (n_leases,) = _U16.unpack_from(payload, off)
    off += 2
    leases = []
    for _ in range(n_leases):
        leases.append(_LEASE_ROW.unpack_from(payload, off))
        off += _LEASE_ROW.size
    if off != len(payload):
        raise ValueError("trailing bytes after batch response")
    return xid, msg_type, rows, leases


class UnknownMsgType(ValueError):
    """Unknown message type in a well-framed request — carries the xid
    so the server can answer BAD_REQUEST instead of dropping the
    connection (the reference responds through the same channel,
    TokenServerHandler.java:39-75)."""

    def __init__(self, xid: int, msg_type: int) -> None:
        super().__init__(f"unknown msg type {msg_type}")
        self.xid = xid
        self.msg_type = msg_type


_KNOWN_MSG_TYPES = frozenset(
    (
        C.MSG_TYPE_PING,
        C.MSG_TYPE_FLOW,
        C.MSG_TYPE_PARAM_FLOW,
        C.MSG_TYPE_CONCURRENT_FLOW_ACQUIRE,
        C.MSG_TYPE_CONCURRENT_FLOW_RELEASE,
        C.MSG_TYPE_FLOW_BATCH,
        C.MSG_TYPE_PARAM_FLOW_BATCH,
        C.MSG_TYPE_STATS,
    )
)


class UnsupportedBatchVersion(ValueError):
    """Known batch msg type with a version byte this build cannot parse
    — answered BAD_REQUEST (per-row, so the client's waiters resolve)
    instead of dropping the connection."""

    def __init__(self, xid: int, msg_type: int, version: int) -> None:
        super().__init__(f"unsupported batch version {version}")
        self.xid = xid
        self.msg_type = msg_type
        self.version = version


def _unpack_flow_batch(xid: int, payload: bytes, off: int) -> tuple:
    ver, n = struct.unpack_from("<BH", payload, off)
    off += 3
    if ver != BATCH_VERSION:
        raise UnsupportedBatchVersion(xid, C.MSG_TYPE_FLOW_BATCH, ver)
    rows = []
    for _ in range(n):
        flow_id, acquire, flags = _BATCH_ROW.unpack_from(payload, off)
        off += _BATCH_ROW.size
        rows.append((flow_id, acquire, bool(flags & 1)))
    (n_reports,) = _U16.unpack_from(payload, off)
    off += 2
    reports = []
    for _ in range(n_reports):
        reports.append(_REPORT_ROW.unpack_from(payload, off))
        off += _REPORT_ROW.size
    if off != len(payload):
        raise ValueError("trailing bytes after flow batch")
    return rows, reports


def _unpack_param_batch(xid: int, payload: bytes, off: int) -> tuple:
    (ver,) = struct.unpack_from("<B", payload, off)
    off += 1
    if ver != BATCH_VERSION:
        raise UnsupportedBatchVersion(xid, C.MSG_TYPE_PARAM_FLOW_BATCH, ver)
    (n_interns,) = _U16.unpack_from(payload, off)
    off += 2
    interns = []
    for _ in range(n_interns):
        vid, ln = _INTERN_HDR.unpack_from(payload, off)
        off += _INTERN_HDR.size
        if off + ln > len(payload):
            raise ValueError("truncated intern value")
        interns.append((vid, payload[off : off + ln].decode("utf-8")))
        off += ln
    (n,) = _U16.unpack_from(payload, off)
    off += 2
    rows = []
    for _ in range(n):
        flow_id, acquire, nvals = _PBATCH_ROW.unpack_from(payload, off)
        off += _PBATCH_ROW.size
        vids = []
        for _ in range(nvals):
            vids.append(_VID.unpack_from(payload, off)[0])
            off += _VID.size
        rows.append((flow_id, acquire, vids))
    if off != len(payload):
        raise ValueError("trailing bytes after param batch")
    return interns, rows


def unpack_request(payload: bytes) -> Tuple[int, int, tuple]:
    """-> (xid, msg_type, body_tuple). Raises :class:`UnknownMsgType`
    for an unrecognized type (checked BEFORE the body parse — a short
    body must not mask the type error as struct garbage), plain
    ValueError / struct.error for malformed bodies."""
    xid, msg_type = _REQ_HDR.unpack_from(payload, 0)
    if msg_type not in _KNOWN_MSG_TYPES:
        raise UnknownMsgType(xid, msg_type)
    off = _REQ_HDR.size
    if msg_type == C.MSG_TYPE_PING:
        if off == len(payload):
            return xid, msg_type, ("",)
        (ln,) = struct.unpack_from("<H", payload, off)
        off += 2
        if off + ln != len(payload):
            raise ValueError("bad ping namespace length")
        return xid, msg_type, (payload[off : off + ln].decode("utf-8"),)
    if msg_type == C.MSG_TYPE_CONCURRENT_FLOW_RELEASE:
        (token_id,) = _RELEASE_BODY.unpack_from(payload, off)
        return xid, msg_type, (token_id,)
    if msg_type == C.MSG_TYPE_FLOW_BATCH:
        return xid, msg_type, _unpack_flow_batch(xid, payload, off)
    if msg_type == C.MSG_TYPE_PARAM_FLOW_BATCH:
        return xid, msg_type, _unpack_param_batch(xid, payload, off)
    if msg_type == C.MSG_TYPE_STATS:
        if off != len(payload):
            raise ValueError("trailing bytes after stats request")
        return xid, msg_type, ()
    flow_id, acquire, prio = _FLOW_BODY.unpack_from(payload, off)
    off += _FLOW_BODY.size
    if msg_type == C.MSG_TYPE_FLOW:
        return xid, msg_type, (flow_id, acquire, bool(prio))
    if msg_type == C.MSG_TYPE_CONCURRENT_FLOW_ACQUIRE:
        return xid, msg_type, (flow_id, acquire)
    if msg_type == C.MSG_TYPE_PARAM_FLOW:
        (n,) = struct.unpack_from("<H", payload, off)
        off += 2
        params = []
        for _ in range(n):
            (ln,) = struct.unpack_from("<H", payload, off)
            off += 2
            if off + ln > len(payload):
                raise ValueError("truncated param value")
            params.append(payload[off : off + ln].decode("utf-8"))
            off += ln
        if off != len(payload):
            raise ValueError("trailing bytes after params")
        return xid, msg_type, (flow_id, acquire, params)
    raise AssertionError("unreachable: type checked against _KNOWN_MSG_TYPES")


def unpack_response(payload: bytes) -> Tuple[int, int, int, int, int, int]:
    """-> (xid, msg_type, status, remaining, wait_ms, token_id)."""
    return _RESP.unpack(payload)


def pack_stats_request(xid: int) -> bytes:
    payload = _REQ_HDR.pack(xid, C.MSG_TYPE_STATS)
    return _LEN.pack(len(payload)) + payload


def pack_stats_response(xid: int, snapshot: dict) -> bytes:
    """JSON body behind the standard header: the snapshot is
    introspective (shapes evolve per release), so a self-describing
    encoding beats a frozen struct here. A version byte guards the
    body format like the batch codecs."""
    import json as _json

    body = _json.dumps(snapshot, separators=(",", ":")).encode("utf-8")
    payload = (
        _REQ_HDR.pack(xid, C.MSG_TYPE_STATS)
        + struct.pack("<B", BATCH_VERSION)
        + body
    )
    return _LEN.pack(len(payload)) + payload


def unpack_stats_response(payload: bytes) -> Tuple[int, dict]:
    """-> (xid, snapshot dict). Raises UnsupportedBatchVersion for a
    version byte this build cannot parse."""
    import json as _json

    xid, msg_type = _REQ_HDR.unpack_from(payload, 0)
    off = _REQ_HDR.size
    (ver,) = struct.unpack_from("<B", payload, off)
    off += 1
    if ver != BATCH_VERSION:
        raise UnsupportedBatchVersion(xid, C.MSG_TYPE_STATS, ver)
    obj = _json.loads(payload[off:].decode("utf-8"))
    if not isinstance(obj, dict):
        raise ValueError("stats response body is not an object")
    return xid, obj


def read_frame(sock) -> Optional[bytes]:
    """Blocking read of one length-framed payload; None on EOF."""
    hdr = _read_exact(sock, _LEN.size)
    if hdr is None:
        return None
    (length,) = _LEN.unpack(hdr)
    if length > 1 << 20:
        raise ValueError("frame too large")
    return _read_exact(sock, length)


def _read_exact(sock, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf
