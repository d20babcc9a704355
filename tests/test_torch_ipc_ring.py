"""The port's shared-memory ring and control header
(sentinel_tpu_torch/ipc/ring.py): the cases of tests/test_ipc_plane.py's
TestRing (wraparound, full, oversized, the stalled-claim skip, the policy
seqlock), the geometry checks on attach, and the byte layout against the
JAX package's ring: a JAX ``ShmRing``/``ControlBlock`` attached by name to
a port segment reads and writes it as the port does, and the reverse.
Tolerance: exact equality."""

from __future__ import annotations

import time

import pytest

from sentinel_tpu.ipc import ring as jring
from sentinel_tpu_torch.ipc import ring as tring
from sentinel_tpu_torch.ipc.ring import ControlBlock, ShmRing


def test_roundtrip_and_wraparound():
    ring = ShmRing(None, 4, 128, create=True)
    try:
        for lap in range(5):  # more laps than slots: the seq words recycle
            for i in range(3):
                assert ring.try_push(f"p{lap}-{i}".encode())
            assert [p.decode() for p in ring.pop_all()] == [f"p{lap}-{i}" for i in range(3)]
    finally:
        ring.destroy()


def test_full_returns_false_and_occupancy():
    ring = ShmRing(None, 4, 64, create=True)
    try:
        for _ in range(4):
            assert ring.try_push(b"x")
        assert not ring.try_push(b"overflow")
        assert ring.occupancy() == 1.0
        assert ring.pop_all()
        assert ring.try_push(b"again")
    finally:
        ring.destroy()


def test_oversized_payload_refused():
    ring = ShmRing(None, 2, 16, create=True)
    try:
        assert not ring.try_push(b"x" * 17)
        assert ring.try_push(b"x" * 16)
    finally:
        ring.destroy()


def test_skip_stalled_claims():
    """A claimed, never published slot (a producer killed mid-write) is
    stepped over after the stall age; published frames behind it live."""
    ring = ShmRing(None, 4, 64, create=True)
    try:
        assert ring._claim() is not None
        assert ring.try_push(b"alive")
        assert ring.try_pop() is None  # behind the corpse
        assert not ring.maybe_skip_stalled(0.05)  # first observation
        time.sleep(0.08)
        assert ring.maybe_skip_stalled(0.05)
        assert ring.try_pop() == b"alive"
    finally:
        ring.destroy()


def test_control_block_policy_seqlock():
    ctrl = ControlBlock(None, 4, create=True)
    try:
        assert ctrl.read_policy() == ("open", {})  # never published
        assert ctrl.publish_policy("closed", {"a": "open"})
        assert ctrl.read_policy() == ("closed", {"a": "open"})
        big = {f"r{'x' * i}": "closed" for i in range(200)}
        assert not ctrl.publish_policy("open", big)  # dropped largest-name-last
        default, overrides = ctrl.read_policy()
        assert default == "open" and len(overrides) < len(big)
    finally:
        ctrl.destroy()


def test_geometry_checks_on_attach():
    ring = ShmRing(None, 8, 256, create=True)
    ctrl = ControlBlock(None, 4, create=True)
    try:
        with pytest.raises(ValueError, match="geometry mismatch"):
            ShmRing(ring.name, 16, 256)
        with pytest.raises(ValueError, match="geometry mismatch"):
            ShmRing(ring.name, 8, 512)
        with pytest.raises(ValueError, match="control geometry mismatch"):
            ControlBlock(ctrl.name, 8)
        with pytest.raises(ValueError, match="not an ipc control segment"):
            ControlBlock(ring.name, 4)
        same = ShmRing(ring.name, 8, 256)
        assert same.slots == 8 and same.slot_bytes == 256
        same.close()
    finally:
        ring.destroy()
        ctrl.destroy()


def test_layout_constants_equal():
    for name in ("_RING_HDR", "_PARKED_OFF", "_GEOM_OFF", "_SLOT_HDR", "_MAGIC", "_VERSION", "_CTRL_FIXED",
                 "_WSLOT", "POLICY_CAP", "HEALTH_HEALTHY", "HEALTH_DEGRADED", "HEALTH_CLOSED", "HEALTH_HANDOFF"):
        assert getattr(tring, name) == getattr(jring, name), name
    for v in (-1, 0, 3, 50):
        assert tring.resolve_spin_us(v) == jring.resolve_spin_us(v)


@pytest.mark.parametrize("creator", ["port", "jax"])
def test_ring_cross_attach(creator):
    """One package creates the ring, the other attaches by name: payloads
    pushed on either side pop on the other, across wraparound and a full
    ring; the header words read alike; the created bytes are the same."""
    mk, at = (tring, jring) if creator == "port" else (jring, tring)
    owner = mk.ShmRing(None, 4, 96, create=True)
    peer = at.ShmRing(owner.name, 4, 96)
    twin = at.ShmRing(None, 4, 96, create=True)
    try:
        assert bytes(owner._buf[: 64 + 4 * (16 + 96)]) == bytes(twin._buf[: 64 + 4 * (16 + 96)])
        for lap in range(3):
            for i in range(4):
                assert peer.try_push(f"{lap}-{i}".encode())
            assert not peer.try_push(b"full") and owner.occupancy() == peer.occupancy() == 1.0
            assert [p.decode() for p in owner.pop_all()] == [f"{lap}-{i}" for i in range(4)]
        assert owner.try_push(b"back")
        assert owner._head_read() == peer._head_read()
        peer2 = at.ShmRing(owner.name, 4, 96)  # a consumer attaching reads from the published tail
        assert peer2.try_pop() == b"back" and peer2.try_pop() is None
        peer2.close()
    finally:
        peer.close()
        owner.destroy()
        twin.destroy()


@pytest.mark.parametrize("creator", ["port", "jax"])
def test_control_cross_attach(creator):
    """The control header across packages: engine beats, health, intern
    and boot epochs, the engine pid, worker slots with their shed counts,
    and the seqlock'd policy blob written by one side read by the other."""
    mk, at = (tring, jring) if creator == "port" else (jring, tring)
    owner = mk.ControlBlock(None, 4, create=True)
    peer = at.ControlBlock(owner.name, 4)
    twin = at.ControlBlock(None, 4, create=True)
    try:
        size = owner._policy_off + 16 + tring.POLICY_CAP
        assert owner._policy_off == peer._policy_off
        assert bytes(owner.shm.buf[:size]) == bytes(twin.shm.buf[:size])
        owner.beat_engine(tring.HEALTH_DEGRADED)
        owner.bump_intern_gen()
        owner.bump_engine_boot()
        owner.set_engine_pid(4242)
        epoch, health, gen, wall = peer.engine_view()
        assert (epoch, health, gen) == (1, jring.HEALTH_DEGRADED, 1) and wall > 0
        assert peer.engine_boot() == 1 and peer.engine_pid() == 4242
        peer.beat_worker(2, 777)
        peer.note_worker_shed(2, 5)
        assert owner.worker_view(2)[2:] == (777, 5) and owner.worker_view(2)[0] == 1
        owner.publish_policy("closed", {"a": "open", "bb": "closed"})
        assert peer.read_policy() == ("closed", {"a": "open", "bb": "closed"})
        peer.publish_policy("open", {"x": "closed"})
        assert owner.read_policy() == ("open", {"x": "closed"})
        peer.clear_worker(2)
        assert owner.worker_view(2) == (0, 0, 0, 0)
        owner.set_health(tring.HEALTH_CLOSED)
        assert peer.engine_view()[1] == jring.HEALTH_CLOSED
    finally:
        peer.close()
        owner.destroy()
        twin.destroy()


def test_closed_handles_read_as_dead():
    """A released ring or header degrades, never raises: a reader racing
    close() sees an empty, CLOSED plane."""
    ring = ShmRing(None, 4, 64, create=True)
    ctrl = ControlBlock(None, 2, create=True)
    ring.destroy()
    ctrl.destroy()
    assert ring.occupancy() == 0.0 and ring.try_pop() is None and not ring.try_push(b"x")
    assert ctrl.engine_view() == (0, tring.HEALTH_CLOSED, 0, 0)
    assert ctrl.intern_gen() == 0 and ctrl.engine_boot() == 0 and ctrl.read_policy() == ("open", {})
