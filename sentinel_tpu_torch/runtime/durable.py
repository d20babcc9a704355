"""Durable checkpoint file format for engine warm hot-restart (port of
``sentinel_tpu/runtime/durable.py``, byte-compatible with it in both
directions: a file either package writes loads into the other).

The in-memory failover checkpoint lives in the engine process's memory — which is
exactly the thing a process crash loses. With
``sentinel.tpu.failover.checkpoint.path`` set, every stored checkpoint
also spills here so a RESTARTED engine process can
load the last good world instead of cold-starting: the Envoy
hot-restart stance (warm handoff, not cold start) applied to the
device-state plane.

File layout (everything little-endian)::

    8B   magic  b"STPUCKP1"
    u32  header length
    ...  header JSON (utf-8) — seq, wall/epoch anchors, window
         geometry, component leaf counts, per-index rule fingerprints,
         the node-registry key list (row-ordered) for the stats remap
    u32  crc32 of the payload
    ...  payload: numpy ``savez`` archive of the flattened state
         leaves, in component order (l0..lN)

Write is ATOMIC: serialize to a same-directory temp file, then
``os.replace`` — a reader can never observe a half-written file, and a
crash mid-write leaves the previous checkpoint intact. Loading is
paranoid by contract: any mismatch — magic, version, truncation, crc,
JSON, leaf count — raises :class:`DurableCheckpointError`, which the
caller (``FailoverManager.restore_durable``) converts into a COUNTED
cold start. A corrupt or stale checkpoint file must never take the
engine down; it only costs the warmth.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

MAGIC = b"STPUCKP1"
VERSION = 1

_U32 = struct.Struct("<I")


class DurableCheckpointError(ValueError):
    """The file is not a loadable durable checkpoint (corrupt,
    truncated, wrong version, failed crc) — degrade to a cold start."""


def rules_fingerprint(rules) -> int:
    """Order-sensitive fingerprint of a compiled index's rule list —
    dyn-state rows follow compile order, so the SAME rule list (same
    config, same order) is what makes a restored dyn state's rows mean
    the same thing in the new process. Rule beans are frozen
    dataclasses, so ``repr`` is stable across processes."""
    parts = []
    for cr in rules:
        parts.append(repr(getattr(cr, "rule", cr)))
    return zlib.crc32("\n".join(parts).encode("utf-8"))


def write_checkpoint(path: str, header: Dict, leaves: List[np.ndarray]) -> int:
    """Serialize + atomically replace ``path``; returns bytes written.
    Raises OSError on filesystem trouble (the writer thread counts it)."""
    buf = io.BytesIO()
    np.savez(buf, **{f"l{i}": np.asarray(a) for i, a in enumerate(leaves)})
    payload = buf.getvalue()
    hdr = dict(header)
    hdr["version"] = VERSION
    hdr["n_leaves"] = len(leaves)
    hdr_bytes = json.dumps(hdr, separators=(",", ":")).encode("utf-8")
    blob = b"".join(
        (
            MAGIC,
            _U32.pack(len(hdr_bytes)),
            hdr_bytes,
            _U32.pack(zlib.crc32(payload)),
            payload,
        )
    )
    d = os.path.dirname(os.path.abspath(path)) or "."
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    finally:
        try:
            if os.path.exists(tmp):
                os.unlink(tmp)
        except OSError:
            pass
    return len(blob)


def read_checkpoint(path: str) -> Tuple[Dict, List[np.ndarray]]:
    """Load + validate ``(header, leaves)``. Raises
    :class:`DurableCheckpointError` on ANY structural problem and
    OSError only when the file cannot be read at all."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < len(MAGIC) + 8 or blob[: len(MAGIC)] != MAGIC:
        raise DurableCheckpointError("bad magic / truncated header")
    off = len(MAGIC)
    (hlen,) = _U32.unpack_from(blob, off)
    off += 4
    if off + hlen + 4 > len(blob):
        raise DurableCheckpointError("truncated header")
    try:
        header = json.loads(blob[off : off + hlen].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise DurableCheckpointError(f"bad header JSON: {e}") from e
    off += hlen
    if not isinstance(header, dict) or header.get("version") != VERSION:
        raise DurableCheckpointError(
            f"unsupported version {header.get('version') if isinstance(header, dict) else '?'}"
        )
    (crc,) = _U32.unpack_from(blob, off)
    off += 4
    payload = blob[off:]
    if zlib.crc32(payload) != crc:
        raise DurableCheckpointError("payload crc mismatch")
    try:
        with np.load(io.BytesIO(payload)) as z:
            leaves = [z[f"l{i}"] for i in range(int(header.get("n_leaves", 0)))]
    except (KeyError, ValueError, OSError, zlib.error) as e:
        raise DurableCheckpointError(f"bad payload archive: {e}") from e
    return header, leaves
