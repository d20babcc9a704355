"""The capture journal: a bounded on-disk spill of the admission stream.

The port's twin of ``sentinel_tpu/runtime/capture.py``, byte for byte its
segment format. The metric log and the span planes record aggregates; the
journal records the columnar admission stream itself — every chunk the
engine dispatches (singles, batch-window groups, bulk groups, chunks the
IPC plane drained: they all meet in ``Engine._run_chunk``) and the
verdicts the card (or the degraded host fallback) gave it — in the
``ipc/frames.py`` codec, so the durable format is the wire format the
plane already uses.

Segment format (``seg-NNNNNN.cap``)::

    magic "STPUCAP1" | u32 header_len | header JSON | records...

The JSON header carries the deciding world: a config snapshot
(``config.runtime_snapshot``), the boot id, the engine-clock /
wall-clock anchor pair (with the span journal's wall-ms ruler offset once
it has seen a beat), the rule world at segment open and the capture row
cursor. Each record is::

    rkind u8 | flags u8 | reserved u16 | len u32 | flush_seq i64 |
    clock_ms i64 | wall_ms u64 | payload[len]

``RK_ENTRIES``/``RK_BULK``/``RK_EXITS``/``RK_BULK_EXITS``/``RK_VERDICT``
payloads are single frames; ``RK_FLUSH`` marks one dispatched chunk's
boundary (the virtual-clock ``now_ms`` the kernels read, and the engine's
``flush_seq``); ``RK_RULES``/``RK_HEALTH``/``RK_SKETCH``/``RK_SHARD``/
``RK_FREEZE``/``RK_CLOSE`` are the JSON timeline replay applies or
reports. String interning is scoped per segment: every segment decodes
on its own.

Freeze: a breaker opening, a shed streak, a DEGRADED transition, a manual
``freeze`` — or the engine's death (the next boot renames the dead
process's live segments ``frozen-death-*`` before it writes a byte) —
pins the last ``freeze.seconds`` of segments against rollover.

Off by default: ``engine.capture is None`` and every hot path pays one
attribute read. ``sentinel_tpu_torch/runtime/replay.py`` is the replay,
verify and explain side.
"""

from __future__ import annotations

import io
import json
import os
import re
import struct
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sentinel_tpu_torch.ipc import frames
from sentinel_tpu_torch.utils.config import config

MAGIC = b"STPUCAP1"

# Record header: rkind u8, flags u8, reserved u16, payload_len u32,
# flush_seq i64 (engine flush seq, -1 for degraded/no-seq chunks and
# timeline records), clock_ms i64 (engine clock), wall_ms u64.
_REC = struct.Struct("<BBHIqqQ")

RK_ENTRIES = 1      # one KIND_ENTRY frame: the chunk's single ops
RK_BULK = 2         # one KIND_BULK frame per columnar group
RK_EXITS = 3        # one KIND_EXIT frame: the chunk's single exits
RK_BULK_EXITS = 4   # one KIND_EXIT frame per columnar exit group
RK_VERDICT = 5      # one KIND_VERDICT frame: settled verdicts by cap seq
RK_FLUSH = 6        # chunk boundary: recorded now_ms + flush_seq
RK_RULES = 7        # rule timeline: a set_*_rules reload
RK_HEALTH = 8       # failover transitions / breaker openings
RK_SKETCH = 9       # sketch promotions/demotions (informational)
RK_SHARD = 10       # cluster shard-map version bump
RK_FREEZE = 11      # freeze marker
RK_CLOSE = 12       # orderly-close marker (planned handoff / drain)

_RECORD_NAMES = {
    RK_ENTRIES: "entries", RK_BULK: "bulk", RK_EXITS: "exits",
    RK_BULK_EXITS: "bulk_exits", RK_VERDICT: "verdict",
    RK_FLUSH: "flush", RK_RULES: "rules", RK_HEALTH: "health",
    RK_SKETCH: "sketch", RK_SHARD: "shard", RK_FREEZE: "freeze",
    RK_CLOSE: "close",
}

# Verdict-row flag bits beyond the frame pair (F_SPECULATIVE=1,
# F_DEGRADED=2): a row whose op had no settled verdict at record time.
F_VERDICT_MISSING = 128

# EntryRow.entry_type packing for captured ops: bit 0 = EntryType.IN,
# bit 6 = prioritized (occupy) entry.
_ET_IN = 1
_ET_PRIO = 0x40


def _wall_ms() -> float:
    from sentinel_tpu_torch.metrics.spans import wall_ms

    return wall_ms()


def maybe_build_capture(engine) -> Optional["CaptureJournal"]:
    """None unless ``sentinel.tpu.capture.enabled``: the disabled
    footprint is ``engine.capture is None``, one attribute read."""
    if not config.get_bool(config.CAPTURE_ENABLED, False):
        return None
    return CaptureJournal(engine)


class CaptureJournal:
    """Bounded rolling on-disk capture of one engine's admission stream.
    Every writer takes the journal's own lock, and holds no other lock
    of its own under it: the chunk spills run under the engine's flush
    lock, the verdict spills on the fill's thread, the freezes on the
    failover tier's, the valve's or a caller's."""

    def __init__(self, engine, directory: Optional[str] = None) -> None:
        self._engine = engine
        self.dir = directory or config.get(config.CAPTURE_DIR) or "sentinel-capture"
        self.segment_bytes = max(64 * 1024, config.get_int(config.CAPTURE_SEGMENT_BYTES, 4 * 1024 * 1024))
        self.segments_max = max(2, config.get_int(config.CAPTURE_SEGMENTS_MAX, 8))
        self.frozen_max = max(1, config.get_int(config.CAPTURE_FROZEN_MAX, 16))
        self.freeze_ms = 1000 * max(1, config.get_int(config.CAPTURE_FREEZE_SECONDS, 30))
        self.shed_streak = max(0, config.get_int(config.CAPTURE_SHED_STREAK, 64))
        self._lock = threading.Lock()
        self._boot_id = os.urandom(8).hex()
        self.counters: Dict[str, int] = {
            "chunks": 0, "frames": 0, "bytes": 0, "rollovers": 0,
            "freezes": 0, "args_dropped": 0,
        }
        self._tele_pub = dict(self.counters)
        os.makedirs(self.dir, exist_ok=True)
        # Engine death is the one freeze trigger that cannot run in the
        # dying process: the next boot pins its predecessor's leftover
        # live segments before it writes a byte of its own.
        self._preserve_death_segments()
        self._f: Optional[io.BufferedWriter] = None
        self._seg_index = 0
        self._seg_bytes = 0
        # Live (rollover-eligible) segments, oldest first:
        # [(index, path, last_wall_ms)].
        self._live: List[List[Any]] = []
        self._interns: Dict[str, int] = {}
        self._cap_seq = 0
        self._shed_run = 0
        self._open_segment_locked()

    # ------------------------------------------------------------------
    # segment lifecycle
    # ------------------------------------------------------------------
    def _preserve_death_segments(self) -> None:
        """The next boot's sweep of its predecessor's leftover live
        segments: a boot that died mid-stream is kept as
        ``frozen-death-*``; a boot that drained in an orderly handoff left
        a ``closed-<boot_id>.marker`` (:meth:`mark_orderly_close`) and its
        segments file as ``frozen-close-*``. The sweep deletes the
        markers it used."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        leftovers = sorted(fn for fn in names if fn.startswith("seg-") and fn.endswith(".cap"))
        markers = [fn for fn in names if _ORDERLY_RE.match(fn)]
        orderly = {_ORDERLY_RE.match(fn).group(1) for fn in markers}
        for fn in leftovers:
            path = os.path.join(self.dir, fn)
            kind = "close" if orderly and _segment_boot_id(path) in orderly else "death"
            dst = os.path.join(self.dir, f"frozen-{kind}-{fn}")
            i = 1
            while os.path.exists(dst):
                dst = os.path.join(self.dir, f"frozen-{kind}-{i}-{fn}")
                i += 1
            try:
                os.rename(path, dst)
            except OSError:
                pass
        for fn in markers:
            # One marker describes one dead boot; a stale one must not
            # file a later crash's segments as orderly.
            try:
                os.remove(os.path.join(self.dir, fn))
            except OSError:
                pass
        if leftovers:
            self._trim_frozen()

    def mark_orderly_close(self, reason: str = "handoff") -> None:
        """Declare this boot's leftover segments orderly: an RK_CLOSE
        record ends the current segment's stream and a
        ``closed-<boot_id>.marker`` tells the successor's sweep to file
        them ``frozen-close-*``, not ``frozen-death-*``. Idempotent."""
        safe = "".join(ch for ch in reason[:32] if ch.isalnum() or ch in "-_") or "close"
        with self._lock:
            if self._f is not None:
                self._json_locked(RK_CLOSE, {"reason": safe, "boot_id": self._boot_id})
                try:
                    self._f.flush()
                except OSError:
                    pass
            marker = os.path.join(self.dir, f"closed-{self._boot_id}.marker")
            try:
                with open(marker, "w", encoding="utf-8") as mf:
                    json.dump({"boot_id": self._boot_id, "reason": safe, "wall_ms": round(_wall_ms(), 3)}, mf)
            except OSError:
                pass

    def _segment_path(self, index: int) -> str:
        return os.path.join(self.dir, f"seg-{index:06d}.cap")

    def _open_segment_locked(self) -> None:
        eng = self._engine
        header: Dict[str, Any] = {
            "version": 1,
            "segment": self._seg_index,
            "boot_id": self._boot_id,
            "app": config.app_name,
            "wall_ms": round(_wall_ms(), 3),
            "clock_ms": int(eng.clock.now_ms()),
            "cap_seq": self._cap_seq,
            "config": config.runtime_snapshot("sentinel.tpu."),
            "rules": self._rules_snapshot(),
        }
        try:
            from sentinel_tpu_torch.metrics.spans import get_journal

            meta = get_journal("engine")._meta()
            if "ruler_off_ms" in meta:
                # The control header's wall-ms ruler (the IPC plane):
                # places this capture on the fleet's merged timeline.
                header["ruler_off_ms"] = meta["ruler_off_ms"]
        except Exception:
            pass
        blob = json.dumps(header, sort_keys=True).encode("utf-8")
        path = self._segment_path(self._seg_index)
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._f.write(struct.pack("<I", len(blob)))
        self._f.write(blob)
        self._seg_bytes = len(MAGIC) + 4 + len(blob)
        # The header reaches the disk at once: a process that dies before
        # its first chunk still leaves a parseable (empty) segment.
        self._f.flush()
        self._interns = {}
        self._group_ids: Dict[tuple, tuple] = {}  # the bulk groups' ids (_write_bulk_locked)
        self._live.append([self._seg_index, path, _wall_ms()])

    def _rules_snapshot(self) -> Dict[str, Any]:
        """The rule world at segment open, so that every segment replays
        on its own. The sketch tier's synthetic rules are left out: the
        replay arms its own tier under the captured config and derives
        them again."""
        eng = self._engine
        return {
            "flow": [r.to_dict() for r in eng.flow_index.user_rules()],
            "degrade": [r.to_dict() for r in eng.degrade_index.rules],
            "param": [
                r.to_dict()
                for pairs in eng.param_index.by_resource.values()
                for _gid, r in pairs
                if not getattr(r, "from_sketch", False)
            ],
            "authority": {res: r.to_dict() for res, r in eng.authority_rules.items()},
            "system": _system_to_dict(eng.system_config),
        }

    def _roll_locked(self) -> None:
        self._f.close()
        self._seg_index += 1
        self.counters["rollovers"] += 1
        self._open_segment_locked()
        while len(self._live) > self.segments_max:
            _idx, path, _w = self._live.pop(0)
            try:
                os.remove(path)
            except OSError:
                pass

    def _trim_frozen(self) -> None:
        try:
            frozen = sorted(
                (os.path.getmtime(os.path.join(self.dir, fn)), fn)
                for fn in os.listdir(self.dir)
                if fn.startswith("frozen-") and fn.endswith(".cap")
            )
        except OSError:
            return
        while len(frozen) > self.frozen_max:
            _t, fn = frozen.pop(0)
            try:
                os.remove(os.path.join(self.dir, fn))
            except OSError:
                pass

    # ------------------------------------------------------------------
    # record writing
    # ------------------------------------------------------------------
    def _write_locked(self, rkind: int, payload: bytes, flush_seq: int = -1) -> None:
        self._write_many_locked(rkind, (payload,), flush_seq)

    def _write_many_locked(self, rkind: int, payloads: Sequence[bytes], flush_seq: int) -> None:
        """Records of one kind, in one write, stamped with one engine-clock
        and one wall-clock reading. A closed journal drops a late spill."""
        if self._f is None or not payloads:
            return
        now_wall = _wall_ms()
        clk = int(self._engine.clock.now_ms())
        parts = []
        nbytes = 0
        for payload in payloads:
            parts.append(_REC.pack(rkind, 0, 0, len(payload), flush_seq, clk, int(now_wall)))
            parts.append(payload)
            nbytes += _REC.size + len(payload)
        self._f.write(b"".join(parts))
        self._seg_bytes += nbytes
        self._live[-1][2] = now_wall
        self.counters["frames"] += len(payloads)
        self.counters["bytes"] += nbytes

    def _json_locked(self, rkind: int, obj: Any, flush_seq: int = -1) -> None:
        self._write_locked(rkind, json.dumps(obj, sort_keys=True).encode("utf-8"), flush_seq)

    def _iid(self, name: Optional[str], fresh: List[Tuple[int, bytes]]) -> int:
        """Per-segment string interning; id 0 is reserved for None."""
        if name is None:
            return 0
        iid = self._interns.get(name)
        if iid is None:
            iid = len(self._interns) + 1
            self._interns[name] = iid
            fresh.append((iid, name.encode("utf-8", "surrogatepass")))
        return iid

    # ------------------------------------------------------------------
    # the engine's hooks (Engine._run_chunk and the fills)
    # ------------------------------------------------------------------
    def note_chunk(self, entries, exits, bulk, bulk_exits, now_ms: int, seq: int) -> List[Optional[int]]:
        """Spill one dispatched chunk's inputs before its kernels run (a
        dispatch fault must not lose the traffic that caused it). Returns
        the verdict token ``[cap_base]`` the fill hands back to
        :meth:`note_verdicts` exactly once. Runs under the engine's flush
        lock. The bulk groups' frames are built from the chunk's columns (a
        group's args encoded once a distinct value tuple), a bulk exit
        group's from its own: no frame row is a Python object."""
        with self._lock:
            base = self._cap_seq
            n_rows = len(entries) + sum(g.n for g in bulk)
            self._cap_seq += n_rows
            self._shed_run = 0
            self.counters["chunks"] += 1
            self._json_locked(
                RK_FLUSH,
                {
                    "cap_seq": base,
                    "now_ms": int(now_ms),
                    "rows": n_rows,
                    "n_entries": len(entries),
                    "n_bulk": [g.n for g in bulk],
                    "n_exits": len(exits),
                    "n_bulk_exits": [g.n for g in bulk_exits],
                },
                flush_seq=seq,
            )
            gen = self._seg_index
            if entries:
                fresh: List[Tuple[int, bytes]] = []
                rows = []
                for i, op in enumerate(entries):
                    et = (_ET_IN if op.rows[3] != -1 else 0) | (_ET_PRIO if op.prio else 0)
                    rows.append(frames.EntryRow(
                        seq=base + i,
                        resource_id=self._iid(op.resource, fresh),
                        context_id=self._iid(op.context_name, fresh),
                        origin_id=self._iid(op.origin, fresh),
                        entry_type=et,
                        acquire=int(op.acquire),
                        ts=int(op.ts),
                        trace=frames.EMPTY_TRACE,
                        args=frames.encode_args(op.args) if op.args else b"",
                    ))
                self._write_locked(RK_ENTRIES, frames.encode_entries(0, rows, fresh, gen, 0), flush_seq=seq)
            if bulk:
                self._write_bulk_locked(bulk, base + len(entries), gen, seq)
            if exits:
                fresh = []
                xrows = [
                    frames.ExitRow(
                        seq=_pack_exit_seq(op.rows[3], self._iid(op.resource, fresh)),
                        resource_id=int(op.rows[0]),
                        context_id=int(op.rows[1]),
                        origin_id=int(op.rows[2]),
                        entry_type=_clamp_i8(op.thr),
                        ts=int(op.ts),
                        rt=int(op.rt),
                        count=int(op.count),
                        err=int(op.err),
                        spec=0,
                    )
                    for op in exits
                ]
                extras = b""
                if any(op.p_rows for op in exits):
                    extras = frames.encode_args([tuple(int(r) for r in op.p_rows) for op in exits])
                self._write_locked(RK_EXITS, frames.encode_exits(0, xrows, fresh, gen, 0, extras=extras),
                                   flush_seq=seq)
            for gx in bulk_exits:
                fresh = []
                self._write_locked(
                    RK_BULK_EXITS,
                    frames.encode_exit_columns(
                        0, _pack_exit_seq(gx.rows[3], self._iid(gx.resource, fresh)), int(gx.rows[0]),
                        int(gx.rows[1]), int(gx.rows[2]), _clamp_i8(gx.thr), gx.ts, gx.rt, gx.count, gx.err,
                        fresh, gen,
                    ),
                    flush_seq=seq,
                )
            if self._f is not None:
                if self._seg_bytes >= self.segment_bytes:
                    self._roll_locked()
                self._f.flush()
            self._publish_tele_locked()
        return [base]

    def _write_bulk_locked(self, bulk, off: int, gen: int, seq: int) -> None:
        """One RK_BULK record a group, all in one write and from one
        ``frames.encode_entry_groups`` call over the chunk's columns (the
        chunk's distinct args tuples encoded once). A group's ids come from
        the segment's cache of (resource, context, origin, direction)."""
        groups = []
        memo: Dict[Any, bytes] = {}
        cache = self._group_ids
        for g in bulk:
            key = (g.resource, g.context_name, g.origin, g.rows[3] != -1)
            meta = cache.get(key)
            if meta is None:
                fresh: List[Tuple[int, bytes]] = []
                meta = (_ET_IN if key[3] else 0, self._iid(g.resource, fresh), self._iid(g.context_name, fresh),
                        self._iid(g.origin, fresh), fresh)
                cache[key] = meta[:4] + ([],)  # the names go out once a segment
            groups.append(meta + (None if g.args_column is None else self._bulk_args(g, memo),))
        payloads = frames.encode_entry_groups(0, off, [g.n for g in bulk], np.concatenate([g.ts for g in bulk]),
                                              np.concatenate([g.acquire for g in bulk]), groups, gen)
        self._write_many_locked(RK_BULK, payloads, seq)

    def _publish_tele_locked(self) -> None:
        tele = getattr(self._engine, "telemetry", None)
        if tele is None or not tele.enabled:
            return
        c, p = self.counters, self._tele_pub
        tele.note_capture(
            c["chunks"] - p["chunks"], c["frames"] - p["frames"],
            c["bytes"] - p["bytes"], c["rollovers"] - p["rollovers"],
            c["args_dropped"] - p["args_dropped"],
        )
        self._tele_pub = dict(c)

    def _bulk_args(self, g, memo: Dict[Any, bytes]) -> Optional[List[bytes]]:
        """A bulk group's args column as one ``encode_args`` payload a row
        (``b""`` for a row without args), or None for an argless group.
        Each distinct tuple is encoded once a ``memo``. A column that is not
        per-row tuples (a pre-split adapter column) is dropped and counted:
        such a capture does not replay bit-exact under param rules."""
        col = g.args_column
        if col is None:
            return None
        try:
            first = col[0]
        except Exception:
            first = None
        if not isinstance(first, (tuple, list)):
            self.counters["args_dropped"] += g.n
            return None
        out: List[bytes] = []
        for j in range(g.n):
            t = col[j]
            if not t:
                out.append(b"")
                continue
            # The values' types are in the key: (1,), (True,) and (1.0,)
            # are equal tuples but encode apart. Only flat tuples of plain
            # values are kept; a nested one is encoded each time.
            key = (t, *map(type, t))
            try:
                a = memo.get(key)
            except TypeError:  # a list or an unhashable value
                a = key = None
            if a is None:
                a = frames.encode_args(tuple(t))
                if key is not None and all(ty in _FLAT_ARGS for ty in key[1:]):
                    memo[key] = a
            out.append(a)
        return out

    def note_verdicts(self, token, entries, bulk, degraded: bool = False, bulk_cols=None) -> None:
        """Spill the settled verdicts of one captured chunk, exactly once
        a token (the sync or deferred fill, the degraded fill, a
        quarantine, or a failed fill, whose rows then read missing).
        ``bulk_cols`` is the bulk rows' (admitted, reason, wait_ms, flags)
        as the fill left them, the chunk's columns; without it each
        group's arrays are read."""
        if token is None:
            return
        base = token[0]
        if base is None:
            return
        token[0] = None
        n_e = len(entries)
        n = n_e + (len(bulk_cols[0]) if bulk_cols is not None else sum(g.n for g in bulk))
        if n == 0:
            return
        seqs = np.arange(base, base + n, dtype=np.uint64)
        admitted = np.zeros(n, np.uint8)
        reason = np.zeros(n, np.int16)
        wait = np.zeros(n, np.int32)
        flags = np.zeros(n, np.uint8)
        for i, op in enumerate(entries):
            v = op._verdict
            if v is None:
                flags[i] = F_VERDICT_MISSING
            else:
                admitted[i] = 1 if v.admitted else 0
                reason[i] = v.reason
                wait[i] = v.wait_ms
                flags[i] = (frames.F_SPECULATIVE if v.speculative else 0) | (frames.F_DEGRADED if v.degraded else 0)
        if bulk_cols is not None:
            admitted[n_e:], reason[n_e:], wait[n_e:], flags[n_e:] = bulk_cols
        else:
            i = n_e
            for g in bulk:
                sl = slice(i, i + g.n)
                if g._admitted is None:
                    flags[sl] = F_VERDICT_MISSING
                else:
                    admitted[sl] = g._admitted
                    reason[sl] = g._reason
                    wait[sl] = g._wait_ms
                    if degraded:
                        flags[sl] = frames.F_DEGRADED
                i += g.n
        payload = frames.encode_verdicts(0, seqs, admitted, reason, wait, flags)
        with self._lock:
            self._write_locked(RK_VERDICT, payload)
            if self._f is not None:
                self._f.flush()

    # ------------------------------------------------------------------
    # rule timeline / event hooks
    # ------------------------------------------------------------------
    def note_rules(self, kind: str, rules: Any, from_sketch: bool = False) -> None:
        with self._lock:
            self._json_locked(RK_RULES, {"kind": kind, "rules": rules, "from_sketch": from_sketch})
            if self._f is not None:
                self._f.flush()

    def note_health(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._json_locked(RK_HEALTH, event)
            if self._f is not None:
                self._f.flush()
        if event.get("to") == "DEGRADED":
            self.freeze("degraded")

    def note_breaker_open(self, resources: List[str]) -> None:
        self.note_health({"event": "breaker_open", "resources": resources})
        self.freeze("breaker")

    def note_sketch(self, info: Dict[str, Any]) -> None:
        with self._lock:
            self._json_locked(RK_SKETCH, info)

    def note_shard(self, version: int, mapping: str = "") -> None:
        with self._lock:
            self._json_locked(RK_SHARD, {"version": int(version), "map": mapping})

    def note_shed(self, n: int = 1) -> None:
        """The shed-streak trigger: ``n`` valve sheds in a row with no
        dispatched chunk between them (note_chunk resets the run) pin the
        traffic that saturated the engine."""
        if self.shed_streak <= 0:
            return
        with self._lock:
            self._shed_run += n
            fire = self._shed_run >= self.shed_streak
            if fire:
                self._shed_run = 0
        if fire:
            self.freeze("shed")

    # ------------------------------------------------------------------
    # freeze / snapshot / close
    # ------------------------------------------------------------------
    def freeze(self, reason: str) -> List[str]:
        """Pin the last ``freeze.seconds`` of segments against rollover:
        the current segment closes after an RK_FREEZE record, every recent
        live segment is renamed ``frozen-<reason>-*`` (out of the rollover
        set), and a fresh segment opens. Returns the frozen paths."""
        frozen: List[str] = []
        with self._lock:
            if self._f is None:
                return frozen
            self._json_locked(RK_FREEZE, {"reason": reason})
            self._f.close()
            cutoff = _wall_ms() - self.freeze_ms
            keep: List[List[Any]] = []
            for ent in self._live:
                _idx, path, last = ent
                if last >= cutoff:
                    dst = os.path.join(self.dir, f"frozen-{reason}-{os.path.basename(path)}")
                    i = 1
                    while os.path.exists(dst):
                        dst = os.path.join(self.dir, f"frozen-{reason}-{i}-{os.path.basename(path)}")
                        i += 1
                    try:
                        os.rename(path, dst)
                        frozen.append(dst)
                    except OSError:
                        keep.append(ent)
                else:
                    keep.append(ent)
            self._live = keep
            self.counters["freezes"] += 1
            self._seg_index += 1
            self._open_segment_locked()
        self._trim_frozen()
        tele = getattr(self._engine, "telemetry", None)
        if tele is not None and tele.enabled:
            tele.note_capture_freeze()
        return frozen

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            try:
                files = sorted(fn for fn in os.listdir(self.dir) if fn.endswith(".cap"))
            except OSError:
                files = []
            return {
                "dir": self.dir,
                "boot_id": self._boot_id,
                "segment": self._seg_index,
                "segment_bytes": self._seg_bytes,
                "cap_seq": self._cap_seq,
                "counters": dict(self.counters),
                "live": [os.path.basename(p) for _i, p, _w in self._live],
                "frozen": [f for f in files if f.startswith("frozen-")],
            }

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


# The value types whose args tuples the bulk spill encodes once a chunk.
_FLAT_ARGS = frozenset((str, int, float, bool, bytes, type(None)))


def _pack_exit_seq(thread_row: int, resource_iid: int) -> int:
    """Exit rows have no spare wide column for (thread_row, explicit
    resource): both pack into the u64 seq field — the low 32 bits the
    resource's intern id (0 = None), the high bits thread_row + 1."""
    return ((int(thread_row) + 1) << 32) | (resource_iid & 0xFFFFFFFF)


def _unpack_exit_seq(seq: int) -> Tuple[int, int]:
    return (int(seq) >> 32) - 1, int(seq) & 0xFFFFFFFF


def _clamp_i8(v: int) -> int:
    return max(-128, min(127, int(v)))


def _system_to_dict(cfg) -> Optional[Dict[str, Any]]:
    if cfg is None:
        return None
    return {f: getattr(cfg, f) for f in ("qps", "max_thread", "max_rt", "highest_system_load", "highest_cpu_usage")
            if hasattr(cfg, f)}


# ---------------------------------------------------------------------------
# reader side (runtime/replay.py, tests)
# ---------------------------------------------------------------------------
class Record:
    __slots__ = ("rkind", "flags", "flush_seq", "clock_ms", "wall_ms", "payload")

    def __init__(self, rkind, flags, flush_seq, clock_ms, wall_ms, payload):
        self.rkind = rkind
        self.flags = flags
        self.flush_seq = flush_seq
        self.clock_ms = clock_ms
        self.wall_ms = wall_ms
        self.payload = payload

    @property
    def name(self) -> str:
        return _RECORD_NAMES.get(self.rkind, f"rk{self.rkind}")

    def json(self) -> Any:
        return json.loads(self.payload.decode("utf-8"))


_ORDERLY_RE = re.compile(r"^closed-([0-9a-f]+)\.marker$")


def _segment_boot_id(path: str) -> Optional[str]:
    """The boot_id of a segment's JSON header, read alone. None on any
    structural surprise, a header over 4 MiB included: an unreadable
    header files as death."""
    try:
        return read_header(path, max_len=4 * 1024 * 1024).get("boot_id")
    except (OSError, ValueError):
        return None


def read_header(path: str, max_len: Optional[int] = None) -> Dict[str, Any]:
    """A segment's JSON header, read without its records. Raises
    ``ValueError`` where :func:`read_segment` would, and for a header
    longer than ``max_len`` bytes."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC) + 4)
        if head[: len(MAGIC)] != MAGIC:
            raise ValueError(f"{path}: not a capture segment (bad magic)")
        if len(head) < len(MAGIC) + 4:
            raise ValueError(f"{path}: truncated segment header length")
        (hlen,) = struct.unpack_from("<I", head, len(MAGIC))
        if max_len is not None and hlen > max_len:
            raise ValueError(f"{path}: a segment header of {hlen} bytes")
        blob = f.read(hlen)
    if len(blob) < hlen:
        raise ValueError(f"{path}: truncated segment header")
    return json.loads(blob.decode("utf-8"))


def read_segment(path: str) -> Tuple[Dict[str, Any], List[Record]]:
    """Parse one segment: (header, records). A torn tail (the process died
    mid-write) ends the record list cleanly: everything before the tear is
    returned, nothing raises."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[: len(MAGIC)] != MAGIC:
        raise ValueError(f"{path}: not a capture segment (bad magic)")
    off = len(MAGIC)
    if off + 4 > len(blob):
        raise ValueError(f"{path}: truncated segment header length")
    (hlen,) = struct.unpack_from("<I", blob, off)
    off += 4
    if off + hlen > len(blob):
        raise ValueError(f"{path}: truncated segment header")
    header = json.loads(blob[off: off + hlen].decode("utf-8"))
    off += hlen
    records: List[Record] = []
    while off + _REC.size <= len(blob):
        rkind, flags, _res, plen, fseq, clk, wall = _REC.unpack_from(blob, off)
        if rkind not in _RECORD_NAMES:
            break  # a tear or corruption: stop at the last good record
        body_off = off + _REC.size
        if body_off + plen > len(blob):
            break  # torn mid-payload
        records.append(Record(rkind, flags, fseq, clk, wall, blob[body_off: body_off + plen]))
        off = body_off + plen
    return header, records


def capture_paths(directory: str, frozen: bool = False) -> List[str]:
    """Segment paths of one capture directory in stream order. With
    ``frozen`` the frozen-* files are included (ordered by their header's
    wall ms and segment index)."""
    try:
        names = [fn for fn in os.listdir(directory) if fn.endswith(".cap")]
    except OSError:
        return []
    picked = [os.path.join(directory, fn) for fn in sorted(names)
              if fn.startswith("seg-") or (frozen and fn.startswith("frozen-"))]
    keyed = []
    for p in picked:
        try:
            header = read_header(p)
        except (OSError, ValueError):
            continue
        keyed.append(((header.get("wall_ms", 0), header.get("segment", 0)), p))
    return [p for _k, p in sorted(keyed)]


class CapturedChunk:
    """One dispatched chunk decoded back to submission-shaped data."""

    __slots__ = ("flush_seq", "now_ms", "cap_seq", "rows", "entries", "bulk", "exits", "bulk_exits", "verdicts")

    def __init__(self, flush_seq, now_ms, cap_seq, rows):
        self.flush_seq = flush_seq
        self.now_ms = now_ms
        self.cap_seq = cap_seq
        self.rows = rows
        self.entries: List[Dict[str, Any]] = []
        self.bulk: List[BulkRows] = []
        self.exits: List[Dict[str, Any]] = []
        self.bulk_exits: List[BulkExitRows] = []
        # (admitted u8, reason i16, wait i32, flags u8) aligned to
        # cap_seq..cap_seq+rows, or None when the capture ended before
        # the chunk's fill landed.
        self.verdicts: Optional[Tuple[np.ndarray, ...]] = None


class BulkRows:
    """One captured bulk group as columns: ``seq``, ``ts``, ``acquire`` and
    ``entry_type`` arrays, the group's resource, context and origin, and
    ``args`` (a tuple a row, or None when no row has args). Indexing and
    iteration give the JAX reader's row dicts."""

    __slots__ = ("seq", "ts", "acquire", "entry_type", "resource", "context", "origin", "args")

    def __init__(self, seq, ts, acquire, entry_type, resource, context, origin, args):
        self.seq, self.ts, self.acquire, self.entry_type = seq, ts, acquire, entry_type
        self.resource, self.context, self.origin, self.args = resource, context, origin, args

    def __len__(self) -> int:
        return len(self.seq)

    @property
    def inbound(self) -> bool:
        """The group's direction: a bulk group has one entry type."""
        return bool(self.entry_type[0] & _ET_IN)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        et = int(self.entry_type[i])
        return {
            "seq": int(self.seq[i]), "resource": self.resource, "context": self.context, "origin": self.origin,
            "in": bool(et & _ET_IN), "prio": bool(et & _ET_PRIO), "acquire": int(self.acquire[i]),
            "ts": int(self.ts[i]), "args": self.args[i] if self.args is not None else (),
        }

    def __iter__(self):
        return (self[i] for i in range(len(self)))


class BulkExitRows:
    """One captured bulk exit group as columns: ``ts``, ``rt``, ``count``
    and ``err`` arrays, the group's node ``rows``, ``thr`` and
    ``resource``."""

    __slots__ = ("rows", "thr", "resource", "ts", "rt", "count", "err")

    def __init__(self, rows, thr, resource, ts, rt, count, err):
        self.rows, self.thr, self.resource = rows, thr, resource
        self.ts, self.rt, self.count, self.err = ts, rt, count, err

    def __len__(self) -> int:
        return len(self.ts)


def _intern_names(df, names: Dict[int, Optional[str]]) -> None:
    for iid, raw in df.interns:
        names[iid] = raw.decode("utf-8", "surrogatepass")


def _decode_entry_frame(payload: bytes, names: Dict[int, Optional[str]]) -> List[Dict[str, Any]]:
    df = frames.decode_frame(payload)
    _intern_names(df, names)
    cols = df.columns
    out = []
    var = df.varbytes
    for i in range(df.n):
        et = int(cols["entry_type"][i])
        alen = int(cols["args_len"][i])
        aoff = int(cols["args_off"][i])
        out.append({
            "seq": int(cols["seq"][i]),
            "resource": names.get(int(cols["resource_id"][i])),
            "context": names.get(int(cols["context_id"][i])) or "",
            "origin": names.get(int(cols["origin_id"][i])) or "",
            "in": bool(et & _ET_IN),
            "prio": bool(et & _ET_PRIO),
            "acquire": int(cols["acquire"][i]),
            "ts": int(cols["ts"][i]),
            "args": frames.decode_args(var[aoff: aoff + alen]) if alen else (),
        })
    return out


def _decode_bulk_frame(payload: bytes, names: Dict[int, Optional[str]], memo: Dict[bytes, tuple]) -> BulkRows:
    """A bulk frame as :class:`BulkRows`, its args decoded once a distinct
    payload through ``memo`` (``decode_args`` returns tuples, shared
    safely). The journal writes a group as one resource, context and
    origin and at least one row; any other frame is refused."""
    u = frames.decode_uniform_entries(payload)
    if u is not None:
        for iid, raw in u.interns:
            names[iid] = raw.decode("utf-8", "surrogatepass")
        return BulkRows(u.seq, u.ts, u.acquire, u.entry_type, names.get(u.resource_id),
                        names.get(u.context_id) or "", names.get(u.origin_id) or "", None)
    df = frames.decode_frame(payload)
    _intern_names(df, names)
    cols = df.columns
    ids = [cols[k] for k in ("resource_id", "context_id", "origin_id")]
    if not df.n or any((c != c[0]).any() for c in ids):
        raise ValueError("capture: a bulk frame must hold one resource, context and origin, and a row")
    rid, cid, oid = (int(c[0]) for c in ids)
    args = None
    alen = cols["args_len"]
    if alen.any():
        var = df.varbytes
        args = []
        for o, n in zip(cols["args_off"].tolist(), alen.tolist()):
            raw = var[o: o + n]
            a = memo.get(raw)
            if a is None:
                a = memo[raw] = frames.decode_args(raw) if n else ()
            args.append(a)
    return BulkRows(np.array(cols["seq"]), np.array(cols["ts"]), np.array(cols["acquire"]),
                    np.array(cols["entry_type"]), names.get(rid), names.get(cid) or "", names.get(oid) or "", args)


def _decode_exit_frame(payload: bytes, names: Dict[int, Optional[str]]) -> List[Dict[str, Any]]:
    df = frames.decode_frame(payload)
    _intern_names(df, names)
    cols = df.columns
    p_rows: Sequence[Tuple[int, ...]] = ()
    if df.varbytes:
        p_rows = frames.decode_args(df.varbytes)
    out = []
    for i in range(df.n):
        trow, riid = _unpack_exit_seq(int(cols["seq"][i]))
        out.append({
            "rows": (int(cols["resource_id"][i]), int(cols["context_id"][i]), int(cols["origin_id"][i]), trow),
            "thr": int(cols["entry_type"][i]),
            "ts": int(cols["ts"][i]),
            "rt": int(cols["rt"][i]),
            "count": int(cols["count"][i]),
            "err": int(cols["err"][i]),
            "resource": names.get(riid) if riid else None,
            "p_rows": tuple(p_rows[i]) if i < len(p_rows) else (),
        })
    return out


def _decode_bulk_exit_frame(payload: bytes, names: Dict[int, Optional[str]]) -> BulkExitRows:
    """A bulk exit frame as :class:`BulkExitRows`. The journal writes a
    group as one node and resource, at least one row and no param-row
    sidecar; any other frame is refused."""
    df = frames.decode_frame(payload)
    _intern_names(df, names)
    cols = df.columns
    keys = ("seq", "resource_id", "context_id", "origin_id", "entry_type")
    if df.varbytes or not df.n or any((cols[k] != cols[k][0]).any() for k in keys):
        raise ValueError("capture: a bulk exit frame must hold one node and resource, a row and no sidecar")
    trow, riid = _unpack_exit_seq(int(cols["seq"][0]))
    rows = (int(cols["resource_id"][0]), int(cols["context_id"][0]), int(cols["origin_id"][0]), trow)
    return BulkExitRows(rows, int(cols["entry_type"][0]), names.get(riid) if riid else None, np.array(cols["ts"]),
                        np.array(cols["rt"]), np.array(cols["count"]), np.array(cols["err"]))


def decode_capture(paths: Sequence[str]) -> Dict[str, Any]:
    """Decode segments into the replay stream: ``header`` (the first
    segment's), ``stream`` — an ordered list of ("chunk", CapturedChunk)
    and ("rules"|"health"|"sketch"|"shard"|"freeze"|"close", dict) items —
    and ``chunks`` by cap_seq (a verdict frame attaches out of band: at
    pipeline depth K a chunk's RK_VERDICT lands up to K chunks later in the
    file). Singles and single exits decode as row dicts, as the JAX reader
    gives them; each bulk group as a :class:`BulkRows` and each bulk exit
    group as a :class:`BulkExitRows`."""
    stream: List[Tuple[str, Any]] = []
    chunks: Dict[int, CapturedChunk] = {}
    first_header: Optional[Dict[str, Any]] = None
    open_chunk: Optional[CapturedChunk] = None
    args_memo: Dict[bytes, tuple] = {}
    for path in paths:
        header, records = read_segment(path)
        if first_header is None:
            first_header = header
        names: Dict[int, Optional[str]] = {0: None}
        for rec in records:
            if rec.rkind == RK_FLUSH:
                meta = rec.json()
                open_chunk = CapturedChunk(rec.flush_seq, meta["now_ms"], meta["cap_seq"], meta["rows"])
                chunks[open_chunk.cap_seq] = open_chunk
                stream.append(("chunk", open_chunk))
            elif rec.rkind == RK_ENTRIES and open_chunk is not None:
                open_chunk.entries.extend(_decode_entry_frame(rec.payload, names))
            elif rec.rkind == RK_BULK and open_chunk is not None:
                open_chunk.bulk.append(_decode_bulk_frame(rec.payload, names, args_memo))
            elif rec.rkind == RK_EXITS and open_chunk is not None:
                open_chunk.exits.extend(_decode_exit_frame(rec.payload, names))
            elif rec.rkind == RK_BULK_EXITS and open_chunk is not None:
                open_chunk.bulk_exits.append(_decode_bulk_exit_frame(rec.payload, names))
            elif rec.rkind == RK_VERDICT:
                df = frames.decode_frame(rec.payload)
                if df.n == 0:
                    continue
                ck = chunks.get(int(df.columns["seq"][0]))
                if ck is not None:
                    ck.verdicts = (
                        np.array(df.columns["admitted"]),
                        np.array(df.columns["reason"]),
                        np.array(df.columns["wait_ms"]),
                        np.array(df.columns["flags"]),
                    )
            elif rec.rkind in (RK_RULES, RK_HEALTH, RK_SKETCH, RK_SHARD, RK_FREEZE, RK_CLOSE):
                stream.append((rec.name, rec.json()))
    return {"header": first_header or {}, "stream": stream, "chunks": chunks}
