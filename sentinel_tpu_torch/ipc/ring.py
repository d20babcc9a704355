"""Fixed-slot shared-memory rings + the plane control header.

Transport primitives of the multi-process ingest plane — no engine
imports, no pickle anywhere on the data path.

**Ring** (:class:`ShmRing`): a bounded ring of fixed-size slots over
one ``multiprocessing.shared_memory`` segment, with a seqlock-style
``seq`` word heading every slot (the Vyukov bounded-queue discipline):

* init: ``slot[i].seq = i``;
* producer: claim position ``pos``, wait for ``seq == pos`` (slot
  free), write payload length + bytes, then publish ``seq = pos + 1``;
* consumer: at position ``pos``, ``seq == pos + 1`` means a published
  payload — read it, then release with ``seq = pos + slots`` so the
  producer lapping the ring finds it free.

The ``seq`` publish/observe pair is the ordering fence: a consumer
never reads a payload before its producer finished writing it, and a
producer never overwrites one before its consumer finished reading.
``seq`` words are 8-byte-aligned and written with one ``memcpy`` — on
the platforms this targets (Linux x86-64 / aarch64) an aligned 8-byte
store is not torn, which is the same assumption every shared-memory
seqlock makes.

Python has no cross-process atomic fetch-add, so the **MPSC** request
ring serializes only the producer *claim* (advance the shared head
word, check capacity) under a ``multiprocessing.Lock``; payload writes
and the seq publish happen outside it, and the single consumer never
touches the lock at all. The **SPSC** response rings have one producer
by construction and skip the lock entirely.

A full ring never blocks a producer: ``try_push`` returns False and
the caller sheds locally (the worker's ``BLOCK_SHED`` with cause
``ipc_ring`` — backpressure is an admission verdict here, not a
stall).

**Control header** (:class:`ControlBlock`): one small segment holding
the engine health word + heartbeat epoch, the intern-table generation,
one heartbeat/pid slot per worker, and a seqlock-guarded
failover-policy snapshot blob (what workers serve from when the engine
dies). All fields are single 8-byte words except the policy blob,
which carries its own generation pair (read: gen, bytes, gen again —
retry on mismatch/odd).
"""

from __future__ import annotations

import json
import struct
import time
from multiprocessing import shared_memory
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# ring layout
# ---------------------------------------------------------------------------
# Ring header: head (u64, producer claim position), tail (u64, consumer
# publish — occupancy reads only), parked (u64, consumer park flag for
# the adaptive-wakeup doorbell), geometry (u32 slots + u32 slot_bytes,
# written at create so a hot-restart attach can VALIDATE instead of
# trusting its own config), then padding to one cache line.
_RING_HDR = 64
_PARKED_OFF = 16
_GEOM_OFF = 24
# Slot header: seq (u64), payload length (u32), pad (u32).
_SLOT_HDR = 16

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")


def _pow2(n: int) -> int:
    n = max(2, int(n))
    return 1 << (n - 1).bit_length()


class ShmRing:
    """One bounded fixed-slot ring over a shared-memory segment.

    ``create=True`` owns the segment (and unlinks it on ``destroy()``);
    attachers open by name. ``lock`` (a ``multiprocessing.Lock``) is
    required only on multi-producer rings — pass None for SPSC.

    ``doorbell`` (a ``multiprocessing.Semaphore``, optional) arms the
    **adaptive wakeup** protocol: the consumer parks on the semaphore
    after a bounded spin (``wait_readable``), advertising the park
    through the shared ``parked`` header word; a producer that
    publishes while the flag is up rings the doorbell. The flag
    re-check after parking closes the set-flag/publish race (no lost
    wakeup), and a release racing an un-parked consumer just leaves a
    token the next park consumes as a spurious-but-harmless early wake.
    Without a doorbell (the default) nothing here changes: the parked
    word stays 0 and ``try_push`` pays one attribute read.
    """

    def __init__(
        self,
        name: Optional[str],
        slots: int,
        slot_bytes: int,
        create: bool = False,
        lock=None,
        doorbell=None,
    ) -> None:
        self.slots = _pow2(slots)
        self.slot_bytes = int(slot_bytes)
        self._mask = self.slots - 1
        self._stride = _SLOT_HDR + self.slot_bytes
        self._lock = lock
        self._doorbell = doorbell
        size = _RING_HDR + self.slots * self._stride
        if create:
            self.shm = shared_memory.SharedMemory(
                name=name, create=True, size=size
            )
        else:
            self.shm = shared_memory.SharedMemory(name=name)
        self._buf = self.shm.buf
        self.name = self.shm.name
        self._owner = create
        if create:
            self._buf[:size] = b"\x00" * size
            _U32.pack_into(self._buf, _GEOM_OFF, self.slots)
            _U32.pack_into(self._buf, _GEOM_OFF + 4, self.slot_bytes)
            for i in range(self.slots):
                self._seq_write(i, i)
        else:
            # Geometry validation on attach (engine hot-restart: a new
            # process re-attaching with a DIFFERENT configured geometry
            # would mis-stride every slot — corrupt silently, so fail
            # loudly instead). Zero = pre-geometry segment; trust the
            # caller's geometry.
            g_slots = _U32.unpack_from(self._buf, _GEOM_OFF)[0]
            g_bytes = _U32.unpack_from(self._buf, _GEOM_OFF + 4)[0]
            if g_slots and (g_slots, g_bytes) != (self.slots, self.slot_bytes):
                name = self.name
                self._buf = None  # release the view before close()
                try:
                    self.shm.close()
                except (OSError, BufferError):
                    pass
                raise ValueError(
                    f"ring geometry mismatch: segment {name} has "
                    f"{g_slots}x{g_bytes}B slots, attach asked "
                    f"{self.slots}x{self.slot_bytes}B"
                )
        # Consumer-local read position (the consumer is the only reader
        # of its own ring, so this needs no shared state beyond `tail`).
        self._rpos = self._tail_read()
        # Claimed-but-never-published slot watch (a producer killed
        # between claim and publish would wedge the consumer forever):
        # (position, first-observed monotonic time).
        self._stall: Optional[Tuple[int, float]] = None

    # -- raw word access ------------------------------------------------
    def _seq_off(self, idx: int) -> int:
        return _RING_HDR + idx * self._stride

    def _seq_read(self, idx: int) -> int:
        off = self._seq_off(idx)
        return _U64.unpack_from(self._buf, off)[0]

    def _seq_write(self, idx: int, v: int) -> None:
        _U64.pack_into(self._buf, self._seq_off(idx), v & 0xFFFFFFFFFFFFFFFF)

    def _head_read(self) -> int:
        return _U64.unpack_from(self._buf, 0)[0]

    def _head_write(self, v: int) -> None:
        _U64.pack_into(self._buf, 0, v)

    def _tail_read(self) -> int:
        return _U64.unpack_from(self._buf, 8)[0]

    def _tail_write(self, v: int) -> None:
        _U64.pack_into(self._buf, 8, v)

    # -- producer -------------------------------------------------------
    def try_push(self, payload: bytes) -> bool:
        """Publish one payload; False when the ring is full (caller
        sheds) or the payload exceeds the slot size (caller must split
        — the frame codec enforces this earlier)."""
        n = len(payload)
        if n > self.slot_bytes:
            return False
        try:
            if self._lock is not None:
                with self._lock:
                    pos = self._claim()
            else:
                pos = self._claim()
        except (TypeError, ValueError):
            return False  # ring released by a concurrent close()
        if pos is None:
            return False
        idx = pos & self._mask
        off = self._seq_off(idx)
        _U32.pack_into(self._buf, off + 8, n)
        self._buf[off + _SLOT_HDR : off + _SLOT_HDR + n] = payload
        # The publish: consumers spin on seq == pos + 1.
        self._seq_write(idx, pos + 1)
        d = self._doorbell
        if d is not None:
            # Adaptive wakeup: ring only when the consumer advertised a
            # park — the common (unparked) case costs one 8-byte read.
            try:
                if _U64.unpack_from(self._buf, _PARKED_OFF)[0]:
                    d.release()
            except (TypeError, ValueError):
                pass  # ring released by a concurrent close()
        return True

    def _claim(self) -> Optional[int]:
        pos = self._head_read()
        # Full when the claimed slot has not been released by the
        # consumer yet (its seq still belongs to the previous lap).
        if self._seq_read(pos & self._mask) != pos:
            return None
        self._head_write(pos + 1)
        return pos

    # -- consumer -------------------------------------------------------
    def try_pop(self) -> Optional[bytes]:
        """One published payload (a bytes COPY — the slot recycles the
        moment this returns), or None when the ring is empty."""
        pos = self._rpos
        idx = pos & self._mask
        try:
            if self._seq_read(idx) != pos + 1:
                return None
        except (TypeError, ValueError):
            return None  # ring released by a concurrent close()
        off = self._seq_off(idx)
        n = _U32.unpack_from(self._buf, off + 8)[0]
        payload = bytes(self._buf[off + _SLOT_HDR : off + _SLOT_HDR + n])
        # Release for the producer's next lap, then publish tail for
        # occupancy readers.
        self._seq_write(idx, pos + self.slots)
        self._rpos = pos + 1
        self._tail_write(self._rpos)
        return payload

    def pop_all(self, limit: int = 0) -> list:
        out = []
        while True:
            p = self.try_pop()
            if p is None:
                return out
            out.append(p)
            if limit and len(out) >= limit:
                return out

    def maybe_skip_stalled(self, age_s: float) -> bool:
        """Consumer-side dead-producer recovery: when the head has
        advanced past the read position but the slot there was never
        published (claimed, then the producer died mid-write — e.g. a
        ``kill -9`` worker), release the slot and step over it once the
        stall has persisted for ``age_s``. A merely-slow producer
        finishes its ``memcpy`` in microseconds, so an ``age_s`` in the
        worker-death range can only ever skip a corpse's slot. Returns
        True when a slot was skipped (the frame it would have carried
        is lost — its caller's verdict wait times out into the
        engine-death path, which is the survivable outcome).

        Any value other than the published ``pos + 1`` counts as
        stalled — not just the untouched claim value ``pos``. The
        extra case is a producer suspended long enough to be skipped
        ONCE and then waking to publish its stale lap's ``seq``: that
        write would otherwise poison the slot for every future lap
        (no claim ever matches again and the ring reads full forever),
        so the aged skip here is also the recovery path for it."""
        pos = self._rpos
        idx = pos & self._mask
        if self._head_read() <= pos or self._seq_read(idx) == pos + 1:
            self._stall = None
            return False
        now = time.monotonic()
        if self._stall is None or self._stall[0] != pos:
            self._stall = (pos, now)
            return False
        if now - self._stall[1] < age_s:
            return False
        self._seq_write(idx, pos + self.slots)
        self._rpos = pos + 1
        self._tail_write(self._rpos)
        self._stall = None
        return True

    # -- adaptive wakeup (consumer side) --------------------------------
    def readable(self) -> bool:
        """True when a published payload is waiting at the read
        position — the consumer's spin predicate (one aligned 8-byte
        read; False once the ring is closed)."""
        pos = self._rpos
        try:
            return self._seq_read(pos & self._mask) == pos + 1
        except (TypeError, ValueError):
            return False

    def wait_readable(self, spin_s: float, park_s: float) -> bool:
        """Spin-then-park consumer wait: busy-check ``readable`` for up
        to ``spin_s`` (keeps the hot round trip off the scheduler),
        then park on the doorbell for up to ``park_s``. The parked flag
        is re-checked against a publish that raced the park, so a
        producer's doorbell ring is never lost; a ring without a
        doorbell just reports the spin outcome (the caller falls back
        to its sleep strategy). Returns ``readable()`` at exit."""
        deadline = time.monotonic() + spin_s
        while True:
            if self.readable():
                return True
            if time.monotonic() >= deadline:
                break
        d = self._doorbell
        if d is None:
            return False
        try:
            _U64.pack_into(self._buf, _PARKED_OFF, 1)
        except (TypeError, ValueError):
            return False
        try:
            # Close the park/publish race: a producer that published
            # BEFORE seeing the flag rings no doorbell — it must be
            # caught here, not slept past.
            if self.readable():
                return True
            d.acquire(timeout=park_s)
            return self.readable()
        finally:
            try:
                _U64.pack_into(self._buf, _PARKED_OFF, 0)
            except (TypeError, ValueError):
                pass

    def nudge(self) -> None:
        """Ring the consumer doorbell unconditionally (worker-side
        death-confirmation probe: wake a parked drainer so a merely
        idle engine beats before the declaration lands). At most one
        spurious consumer wake per call; no-op without a doorbell."""
        d = self._doorbell
        if d is None:
            return
        try:
            d.release()
        except (OSError, ValueError):
            pass

    # -- readers --------------------------------------------------------
    def occupancy(self) -> float:
        """Published head minus published tail over capacity (0..1) —
        an advisory read for metrics and capacity checks. Returns 0
        once the ring is closed: a Prometheus scrape racing
        ``close()``/``destroy()`` during shutdown must degrade, not
        fail the whole render."""
        try:
            used = self._head_read() - self._tail_read()
        except (TypeError, ValueError):
            return 0.0  # _buf already released by close()
        return min(1.0, max(0.0, used / float(self.slots)))

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        self._buf = None
        try:
            self.shm.close()
        except (OSError, BufferError):
            pass

    def destroy(self) -> None:
        self.close()
        if self._owner:
            try:
                self.shm.unlink()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# control header
# ---------------------------------------------------------------------------
# Layout (all offsets in bytes):
#   0   u32 magic, u32 version
#   8   u64 engine heartbeat epoch (monotonically bumped by the plane)
#   16  u64 engine health word (HEALTH_*)
#   24  u64 intern-table generation (bump invalidates every worker's
#       local string->id dict; workers re-intern on their next frame)
#   32  u64 engine wall-clock ms at the last heartbeat (staleness ruler
#       for workers — epoch deltas alone need a shared cadence)
#   40  u64 engine BOOT epoch: bumped once per plane attach/create —
#       the hot-restart generation word. A worker that sees it change
#       re-interns, re-asserts its live-admission ledger and replays
#       buffered completions (ipc/worker.py reconnect protocol).
#   48  u32 workers_max at create (attach validates geometry)
#   52  u32 engine pid (written at plane attach; the worker-side
#       liveness CONFIRMATION ruler — a stale wall clock plus a live
#       pid means "pegged, not dead", ipc/worker.py)
#   56  .. reserved to 64
#   64  worker slots: WORKERS_MAX x 32 bytes
#       [u64 heartbeat epoch, u64 wall ms, u32 pid, u32 shed count,
#        u64 reserved]
#   ..  policy blob: u64 generation, u32 length, pad, POLICY_CAP bytes
_MAGIC = 0x53544950  # "PITS" — sentinel-tpu ipc
_VERSION = 1
_CTRL_FIXED = 64
_WSLOT = 32
POLICY_CAP = 4096

HEALTH_HEALTHY = 0
HEALTH_DEGRADED = 1
HEALTH_CLOSED = 2
# Planned-handoff drain: the OLD engine is alive and settling in-flight
# work but accepts no NEW admissions — workers hold (bounded) for the
# successor's boot-epoch bump instead of falling to the policy path.
HEALTH_HANDOFF = 3

HEALTH_NAMES = {
    HEALTH_HEALTHY: "HEALTHY",
    HEALTH_DEGRADED: "DEGRADED",
    HEALTH_CLOSED: "CLOSED",
    HEALTH_HANDOFF: "HANDOFF",
}


def _wall_ms() -> int:
    return int(time.time() * 1000)


def resolve_spin_us(v: int) -> int:
    """The adaptive-wakeup spin bound: ``v`` >= 0 verbatim; -1 (the
    config default) auto-picks by core count — 0 on <=2-core hosts
    (spinning steals the core the other side of the pipe needs; pure
    doorbell park measured 2x faster there) and 50 µs where producer
    and consumer can genuinely run concurrently."""
    if v >= 0:
        return int(v)
    import os

    return 0 if (os.cpu_count() or 1) <= 2 else 50


class ControlBlock:
    """The plane's shared control header (see module doc for layout)."""

    def __init__(
        self, name: Optional[str], workers_max: int, create: bool = False
    ) -> None:
        self.workers_max = max(1, int(workers_max))
        self._policy_off = _CTRL_FIXED + self.workers_max * _WSLOT
        size = self._policy_off + 16 + POLICY_CAP
        if create:
            self.shm = shared_memory.SharedMemory(
                name=name, create=True, size=size
            )
            self.shm.buf[:size] = b"\x00" * size
            _U32.pack_into(self.shm.buf, 0, _MAGIC)
            _U32.pack_into(self.shm.buf, 4, _VERSION)
            _U32.pack_into(self.shm.buf, 48, self.workers_max)
        else:
            self.shm = shared_memory.SharedMemory(name=name)
            magic = _U32.unpack_from(self.shm.buf, 0)[0]
            ver = _U32.unpack_from(self.shm.buf, 4)[0]
            if magic != _MAGIC or ver != _VERSION:
                self.shm.close()
                raise ValueError(
                    f"not an ipc control segment (magic {magic:#x}, "
                    f"version {ver})"
                )
            wm = _U32.unpack_from(self.shm.buf, 48)[0]
            if wm and wm != self.workers_max:
                # Hot-restart attach with a different workers.max would
                # mis-place every worker slot and the policy blob.
                self.shm.close()
                raise ValueError(
                    f"control geometry mismatch: segment has "
                    f"workers_max={wm}, attach asked {self.workers_max}"
                )
        self._buf = self.shm.buf
        self.name = self.shm.name
        self._owner = create

    # -- engine side ----------------------------------------------------
    def beat_engine(self, health: int) -> None:
        epoch = _U64.unpack_from(self._buf, 8)[0] + 1
        _U64.pack_into(self._buf, 8, epoch)
        _U64.pack_into(self._buf, 16, health)
        _U64.pack_into(self._buf, 32, _wall_ms())

    def set_health(self, health: int) -> None:
        _U64.pack_into(self._buf, 16, health)

    def bump_intern_gen(self) -> int:
        gen = _U64.unpack_from(self._buf, 24)[0] + 1
        _U64.pack_into(self._buf, 24, gen)
        return gen

    def bump_engine_boot(self) -> int:
        """Advance the hot-restart generation word — called once per
        plane attach/create; workers react to the CHANGE (reconnect
        protocol), so the absolute value doubles as a restart count."""
        boot = _U64.unpack_from(self._buf, 40)[0] + 1
        _U64.pack_into(self._buf, 40, boot)
        return boot

    def engine_boot(self) -> int:
        """Current boot epoch; 0 once the header is released (a worker
        racing close() must not see a phantom restart)."""
        try:
            return _U64.unpack_from(self._buf, 40)[0]
        except (TypeError, ValueError):
            return 0

    def set_engine_pid(self, pid: int) -> None:
        """Publish the engine process id (written once per plane
        attach) — the death-confirmation probe target for workers."""
        _U32.pack_into(self._buf, 52, pid & 0xFFFFFFFF)

    def engine_pid(self) -> int:
        try:
            return _U32.unpack_from(self._buf, 52)[0]
        except (TypeError, ValueError):
            return 0

    def publish_policy(self, default: str, overrides: Dict[str, str]) -> bool:
        """Seqlock-write the failover-policy snapshot. Overrides that
        do not fit POLICY_CAP are dropped largest-name-last (the
        default still applies to them — a bounded header cannot carry
        unbounded per-resource state); returns False when truncated."""
        items = sorted(overrides.items(), key=lambda kv: len(kv[0]))
        complete = True
        while True:
            blob = json.dumps(
                {"default": default, "overrides": dict(items)},
                separators=(",", ":"),
            ).encode("utf-8")
            if len(blob) <= POLICY_CAP:
                break
            items = items[:-1]
            complete = False
        off = self._policy_off
        gen = _U64.unpack_from(self._buf, off)[0]
        _U64.pack_into(self._buf, off, gen + 1)  # odd: write in progress
        _U32.pack_into(self._buf, off + 8, len(blob))
        self._buf[off + 16 : off + 16 + len(blob)] = blob
        _U64.pack_into(self._buf, off, gen + 2)  # even: published
        return complete

    # -- worker side ----------------------------------------------------
    def _wslot(self, worker_id: int) -> int:
        if not (0 <= worker_id < self.workers_max):
            raise ValueError(f"worker_id {worker_id} out of range")
        return _CTRL_FIXED + worker_id * _WSLOT

    def beat_worker(self, worker_id: int, pid: int) -> None:
        off = self._wslot(worker_id)
        epoch = _U64.unpack_from(self._buf, off)[0] + 1
        _U64.pack_into(self._buf, off, epoch)
        _U64.pack_into(self._buf, off + 8, _wall_ms())
        _U32.pack_into(self._buf, off + 16, pid & 0xFFFFFFFF)

    def clear_worker(self, worker_id: int) -> None:
        off = self._wslot(worker_id)
        self._buf[off : off + _WSLOT] = b"\x00" * _WSLOT

    def note_worker_shed(self, worker_id: int, n: int) -> None:
        """Worker-local ring-full shed count (cumulative) — the plane
        folds the delta into the engine's IngestValve accounting."""
        off = self._wslot(worker_id) + 20
        cur = _U32.unpack_from(self._buf, off)[0]
        _U32.pack_into(self._buf, off, (cur + n) & 0xFFFFFFFF)

    # -- shared reads ---------------------------------------------------
    def engine_view(self) -> Tuple[int, int, int, int]:
        """(heartbeat epoch, health word, intern generation, wall ms).
        A closed/released header reads as CLOSED — a thread racing
        ``close()`` must see a dead engine, not a TypeError."""
        try:
            return (
                _U64.unpack_from(self._buf, 8)[0],
                _U64.unpack_from(self._buf, 16)[0],
                _U64.unpack_from(self._buf, 24)[0],
                _U64.unpack_from(self._buf, 32)[0],
            )
        except (TypeError, ValueError):
            return (0, HEALTH_CLOSED, 0, 0)

    def intern_gen(self) -> int:
        try:
            return _U64.unpack_from(self._buf, 24)[0]
        except (TypeError, ValueError):
            return 0  # header already released by close()

    def worker_view(self, worker_id: int) -> Tuple[int, int, int, int]:
        """(heartbeat epoch, wall ms, pid, cumulative shed count)."""
        off = self._wslot(worker_id)
        return (
            _U64.unpack_from(self._buf, off)[0],
            _U64.unpack_from(self._buf, off + 8)[0],
            _U32.unpack_from(self._buf, off + 16)[0],
            _U32.unpack_from(self._buf, off + 20)[0],
        )

    def read_policy(self) -> Tuple[str, Dict[str, str]]:
        """Seqlock-read the policy snapshot: (default, overrides).
        Never-published (all-zero) reads as fail-open, matching the
        failover default."""
        off = self._policy_off
        for _ in range(64):
            try:
                g0 = _U64.unpack_from(self._buf, off)[0]
            except (TypeError, ValueError):
                return "open", {}  # header released by close()
            if g0 == 0:
                return "open", {}
            if g0 & 1:
                continue  # write in progress
            n = _U32.unpack_from(self._buf, off + 8)[0]
            blob = bytes(self._buf[off + 16 : off + 16 + min(n, POLICY_CAP)])
            if _U64.unpack_from(self._buf, off)[0] == g0:
                try:
                    d = json.loads(blob.decode("utf-8"))
                    return d.get("default", "open"), d.get("overrides", {})
                except (ValueError, AttributeError):
                    return "open", {}
        return "open", {}

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        self._buf = None
        try:
            self.shm.close()
        except (OSError, BufferError):
            pass

    def destroy(self) -> None:
        self.close()
        if self._owner:
            try:
                self.shm.unlink()
            except OSError:
                pass
