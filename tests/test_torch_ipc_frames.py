"""The port's frame codec (sentinel_tpu_torch/ipc/frames.py) against the
JAX package's (sentinel_tpu/ipc/frames.py): for the same rows the two
encoders write the same bytes, for every frame kind, and each decoder
reads the other's frames to the same columns. Rows come from hypothesis
strategies, as tests/test_frames_fuzz.py draws them from a seeded rng; a
truncated or corrupted frame fails as one ValueError in both. Tolerance:
exact equality of bytes and columns."""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as hs

from sentinel_tpu.ipc import frames as jfr
from sentinel_tpu_torch.ipc import frames as tfr

SETTINGS = settings(max_examples=60, deadline=None, database=None, suppress_health_check=[HealthCheck.too_slow])

_scalar = hs.one_of(
    hs.none(), hs.booleans(), hs.integers(-(2 ** 63), 2 ** 63 - 1),
    hs.floats(allow_nan=False), hs.text(max_size=40), hs.binary(max_size=40),
)
_value = hs.recursive(_scalar, lambda inner: hs.tuples(inner, inner) | hs.lists(inner, max_size=3).map(tuple),
                      max_leaves=6)
_args = hs.lists(_value, max_size=5).map(tuple)
_i32 = hs.integers(-(2 ** 31), 2 ** 31 - 1)
_id = hs.integers(0, 2 ** 31 - 1)
_interns = hs.lists(hs.tuples(hs.integers(1, 2 ** 32 - 1), hs.binary(min_size=1, max_size=300)), max_size=4)


@hs.composite
def _entry_rows(draw, max_rows=12):
    n = draw(hs.integers(0, max_rows))
    rows = []
    for _ in range(n):
        traced = draw(hs.booleans())
        trace = (tfr.pack_trace(draw(hs.sampled_from(["ab" * 16, "0f" * 16])), "cd" * 8, draw(hs.booleans()))
                 if traced else tfr.EMPTY_TRACE)
        rows.append(dict(
            seq=draw(hs.integers(0, 2 ** 63)), resource_id=draw(_id), context_id=draw(_id), origin_id=draw(_id),
            entry_type=draw(hs.integers(-128, 127)), acquire=draw(_i32), ts=draw(hs.integers(-1, 2 ** 62)),
            trace=trace, args=tfr.encode_args(draw(_args)),
        ))
    return rows


@hs.composite
def _exit_rows(draw):
    return [
        dict(seq=draw(hs.integers(0, 2 ** 63)), resource_id=draw(_id), context_id=draw(_id), origin_id=draw(_id),
             entry_type=draw(hs.integers(-128, 127)), ts=draw(hs.integers(0, 2 ** 62)), rt=draw(_i32),
             count=draw(_i32), err=draw(_i32), spec=draw(hs.integers(0, 2)))
        for _ in range(draw(hs.integers(0, 12)))
    ]


@hs.composite
def _reassert_rows(draw):
    return [
        dict(resource_id=draw(_id), context_id=draw(_id), origin_id=draw(_id),
             entry_type=draw(hs.integers(0, 1)), spec=draw(hs.integers(0, 1)), acquire=draw(_i32), count=draw(_i32))
        for _ in range(draw(hs.integers(0, 12)))
    ]


def _same_decoded(a, b) -> None:
    assert (a.kind, a.worker_id, a.n, a.intern_gen, a.shed_count, a.flags) == (
        b.kind, b.worker_id, b.n, b.intern_gen, b.shed_count, b.flags)
    assert list(a.interns) == list(b.interns)
    assert a.traces == b.traces and a.varbytes == b.varbytes
    assert sorted(a.columns) == sorted(b.columns)
    for k in a.columns:
        assert a.columns[k].dtype == b.columns[k].dtype, k
        assert np.array_equal(a.columns[k], b.columns[k]), k


def _cross(jbytes: bytes, tbytes: bytes) -> None:
    """Equal bytes, and each decoder reads the other's frame alike."""
    assert tbytes == jbytes
    _same_decoded(tfr.decode_frame(jbytes), jfr.decode_frame(tbytes))
    _same_decoded(tfr.decode_frame(tbytes), jfr.decode_frame(jbytes))


def test_constants_and_layout_equal():
    for name in ("KIND_ENTRY", "KIND_EXIT", "KIND_BULK", "KIND_VERDICT", "KIND_REASSERT", "F_FRAME_RECONNECT",
                 "F_SPECULATIVE", "F_DEGRADED", "ENTRY_ROW_BYTES", "EXIT_ROW_BYTES", "REASSERT_ROW_BYTES",
                 "FRAME_RESERVE", "EMPTY_TRACE"):
        assert getattr(tfr, name) == getattr(jfr, name), name
    assert tfr._HDR.format == jfr._HDR.format and tfr._HDR.size == jfr._HDR.size == 32
    assert tfr._INTERN_HDR.format == jfr._INTERN_HDR.format
    for slot in (1024, 2048, 16384, 65536):
        for avg in (0, 17, 300):
            assert tfr.entry_frame_cap(slot, avg) == jfr.entry_frame_cap(slot, avg)


@SETTINGS
@given(args=_args)
def test_args_codec_bytes_equal(args):
    blob = tfr.encode_args(args)
    assert blob == jfr.encode_args(args)
    assert tfr.decode_args(blob) == jfr.decode_args(blob)


def test_args_codec_objects_and_truncation():
    class Obj:
        def __repr__(self):
            return "Obj<1>"

    for args in [(), (Obj(),), ({1, 2},), (frozenset(["a"]),), ("unicode-☃", b"\x00\xff", (None, 1.5))]:
        assert tfr.encode_args(args) == jfr.encode_args(args)
    blob = tfr.encode_args(("abc", 12, (1.0, "x")))
    for cut in range(1, len(blob)):
        errs = []
        for mod in (tfr, jfr):
            try:
                errs.append(("ok", mod.decode_args(blob[:cut])))
            except ValueError:
                errs.append(("ValueError",))
        assert errs[0] == errs[1], cut
    with pytest.raises(ValueError):
        tfr.decode_args(b"\x01\x00?")


@SETTINGS
@given(rows=_entry_rows(), interns=_interns, gen=hs.integers(0, 2 ** 32 - 1), shed=hs.integers(0, 2 ** 32 - 1),
       kind=hs.sampled_from([tfr.KIND_ENTRY, tfr.KIND_BULK]), meta=hs.binary(max_size=16))
def test_entry_and_bulk_frames_equal(rows, interns, gen, shed, kind, meta):
    meta = meta if kind == tfr.KIND_BULK else None
    tb = tfr.encode_entries(3, [tfr.EntryRow(**r) for r in rows], interns, gen, shed, kind=kind, group_meta=meta)
    jb = jfr.encode_entries(3, [jfr.EntryRow(**r) for r in rows], interns, gen, shed, kind=kind, group_meta=meta)
    _cross(jb, tb)


@SETTINGS
@given(n=hs.integers(0, 40), base=hs.integers(0, 2 ** 40), interns=_interns, gen=hs.integers(0, 2 ** 32 - 1),
       et=hs.integers(0, 1), ids=hs.tuples(_id, _id, _id), seed=hs.integers(0, 2 ** 32 - 1))
def test_columnar_encoder_equal(n, base, interns, gen, et, ids, seed):
    rng = np.random.default_rng(seed)
    ts = rng.integers(-1, 2 ** 40, n)
    acq = rng.integers(1, 1000, n)
    tb = tfr.encode_entries_columns(5, base, ts, acq, et, *ids, interns, gen)
    jb = jfr.encode_entries_columns(5, base, ts, acq, et, *ids, interns, gen)
    _cross(jb, tb)
    rows = [tfr.EntryRow(base + i, ids[0], ids[1], ids[2], et, int(acq[i]), int(ts[i]), tfr.EMPTY_TRACE, b"")
            for i in range(n)]
    assert tfr.encode_entries(5, rows, interns, gen, 0, kind=tfr.KIND_BULK) == tb


@SETTINGS
@given(rows=_exit_rows(), interns=_interns, gen=hs.integers(0, 2 ** 32 - 1), shed=hs.integers(0, 2 ** 32 - 1),
       extras=hs.binary(max_size=24))
def test_exit_frames_equal(rows, interns, gen, shed, extras):
    tb = tfr.encode_exits(7, [tfr.ExitRow(**r) for r in rows], interns, gen, shed, extras=extras)
    jb = jfr.encode_exits(7, [jfr.ExitRow(**r) for r in rows], interns, gen, shed, extras=extras)
    _cross(jb, tb)


@SETTINGS
@given(rows=_reassert_rows(), interns=_interns, gen=hs.integers(0, 2 ** 32 - 1), head=hs.booleans())
def test_reassert_frames_equal(rows, interns, gen, head):
    tb = tfr.encode_reasserts(2, [tfr.ReassertRow(**r) for r in rows], interns, gen, 9, head=head)
    jb = jfr.encode_reasserts(2, [jfr.ReassertRow(**r) for r in rows], interns, gen, 9, head=head)
    _cross(jb, tb)
    assert bool(tfr.decode_frame(tb).flags & tfr.F_FRAME_RECONNECT) == head


@SETTINGS
@given(n=hs.integers(0, 64), seed=hs.integers(0, 2 ** 32 - 1))
def test_verdict_frames_equal(n, seed):
    rng = np.random.default_rng(seed)
    cols = (rng.integers(0, 2 ** 63, n, dtype=np.uint64), rng.integers(0, 2, n).astype(np.uint8),
            rng.integers(-9, 10, n).astype(np.int16), rng.integers(0, 5000, n).astype(np.int32),
            rng.integers(0, 4, n).astype(np.uint8))
    _cross(jfr.encode_verdicts(1, *cols), tfr.encode_verdicts(1, *cols))


@SETTINGS
@given(tid=hs.binary(min_size=16, max_size=16), sid=hs.binary(min_size=8, max_size=8), sampled=hs.booleans())
def test_trace_pack_equal(tid, sid, sampled):
    packed = tfr.pack_trace(tid.hex(), sid.hex(), sampled)
    assert packed == jfr.pack_trace(tid.hex(), sid.hex(), sampled)
    assert tfr.unpack_trace(packed) == jfr.unpack_trace(packed) == (tid.hex(), sid.hex(), sampled)
    assert tfr.pack_trace("zz", "bad", True) == jfr.pack_trace("zz", "bad", True) == tfr.EMPTY_TRACE
    assert tfr.unpack_trace(tfr.EMPTY_TRACE) is None


@SETTINGS
@given(rows=_entry_rows(max_rows=4), cut_frac=hs.floats(0.0, 1.0), garbage=hs.binary(min_size=0, max_size=80))
def test_truncated_and_garbage_frames_fail_alike(rows, cut_frac, garbage):
    """A torn tail or random bytes: both decoders raise ValueError, or
    both decode to the same frame."""
    full = tfr.encode_entries(1, [tfr.EntryRow(**r) for r in rows], [(1, b"res")], 3, 0)
    for payload in (full[: int(len(full) * cut_frac)], garbage, full[:28] + garbage):
        out = []
        for mod in (tfr, jfr):
            try:
                out.append(mod.decode_frame(payload))
            except ValueError:
                out.append(None)
        if out[0] is None or out[1] is None:
            assert out[0] is None and out[1] is None
        else:
            _same_decoded(out[0], out[1])
