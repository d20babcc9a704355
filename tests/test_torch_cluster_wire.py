"""The cluster token plane over TCP (sentinel_tpu_torch/cluster/protocol.py,
connection.py, server.py, client.py and client mode in state.py and the
engine) against the JAX package's, bit for bit:

* the wire codec, both ways, for every message type: the same bytes from
  the same inputs, the same values (or the same error) from the same bytes,
  truncated, garbled, oversized, unknown-type and foreign-version frames
  included (tests/test_protocol_fuzz.py's cases, and hypothesis);
* the port's server under garbage, as tests/test_protocol_fuzz.py holds the
  JAX server;
* one request stream through the four pairings over loopback (JAX and port
  clients, JAX and port servers): the same statuses, ``remaining``,
  ``wait_ms``, token ids, lease grants and server counters;
* a JAX engine and a port engine in client mode on one stream
  (tests/test_cluster_batched.py::TestEngineDifferential): the same
  verdicts, reasons and ``wait_ms`` with leases off and on, with the client
  micro-window, and after their server is stopped, with and without
  fallback to the local check.

No verdict waits on a wall-clock deadline: a server's death is a ``stop()``
the test awaits, and request timeouts are long. Tolerance zero."""

import socket
import struct
import threading

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

from sentinel_tpu.cluster import protocol as jp
from sentinel_tpu.models import constants as JC
from sentinel_tpu_torch.cluster import protocol as tp
from sentinel_tpu_torch.models import constants as TC

from torch_cluster_env import both, fixed_token_ids, wait_for  # noqa: F401  (fixtures)

# --- the codec ----------------------------------------------------------------


def _frames(P, C):
    """Every message type packed by the protocol module ``P``:
    {name: (frame, unpacker)}."""
    cm = np.arange(12, dtype="<i4").reshape(3, 4)
    return {
        "flow": (P.pack_flow_request(7, 2**40 + 3, 5, True), "request"),
        "flow_negative": (P.pack_flow_request(2**32 - 1, -5, -1, False), "request"),
        "param": (P.pack_param_request(8, 11, 2, ["a", "", "ünï", "x" * 300]), "request"),
        "ping": (P.pack_ping(9), "request"),
        "ping_namespace": (P.pack_ping(10, "ns-é"), "request"),
        "concurrent_acquire": (P.pack_concurrent_acquire(11, 44, 3), "request"),
        "concurrent_release": (P.pack_concurrent_release(12, 2**62 + 1), "request"),
        "stats_request": (P.pack_stats_request(13), "request"),
        "flow_batch": (P.pack_flow_batch_request(14, [(1, 1, False), (-2, 3, True), (2**50, 0, True)], [(1, 4)]),
                       "request"),
        "flow_batch_empty": (P.pack_flow_batch_request(15, []), "request"),
        "param_batch": (P.pack_param_batch_request(16, [(5, 1, [1, 2]), (6, 2, []), (7, 1, [2, 2, 1])],
                                                   [(1, "x"), (2, "yé")]), "request"),
        "response": (P.pack_response(17, C.MSG_TYPE_FLOW, 0, 12, 40, 99), "response"),
        "response_negative": (P.pack_response(18, C.MSG_TYPE_CONCURRENT_FLOW_ACQUIRE, -2, -1, 0, -7), "response"),
        "batch_response": (P.pack_batch_response(19, C.MSG_TYPE_FLOW_BATCH, [(0, 3, 0), (1, 0, 0), (-1, 0, 5)],
                                                 [(1, 8, 100), (-3, 1, 1)]), "batch_response"),
        "batch_response_empty": (P.pack_batch_response(20, C.MSG_TYPE_PARAM_FLOW_BATCH, []), "batch_response"),
        "sketch": (P.pack_sketch_frame(21, C.MSG_TYPE_SKETCH_PUSH, "h:1:2", 99, 3, 4, cm.tobytes(),
                                       [("a", 7), ("k\x1fv", 2**40), ("", 1)]), "sketch"),
        "sketch_empty": (P.pack_sketch_frame(22, C.MSG_TYPE_SKETCH_MERGED, "o", 0, 0, 0, b""), "sketch"),
        "stats_response": (P.pack_stats_response(23, {"port": 1, "work": {"frames": 2, "busy_s": 0.5}}), "stats"),
    }


def _outcome(call):
    """The value ``call()`` returns, or what it raised: the class name, the
    typed error's fields and the message."""
    try:
        return ("ok", call())
    except Exception as exc:  # noqa: BLE001 - the outcome is what is compared
        fields = tuple(getattr(exc, a) for a in ("xid", "msg_type", "version") if hasattr(exc, a))
        return ("raise", type(exc).__name__, fields, str(exc))


def _unpack(P, kind, payload):
    fn = {"request": P.unpack_request, "response": P.unpack_response, "batch_response": P.unpack_batch_response,
          "sketch": P.unpack_sketch_frame, "stats": P.unpack_stats_response}[kind]
    return _outcome(lambda: fn(payload))


_NAMES = list(_frames(tp, TC))


@pytest.mark.parametrize("name", _NAMES)
def test_codec_same_bytes_and_values(name):
    """The same inputs pack to the same bytes in both packages; the bytes
    unpack to the same values in both; the length prefix frames them."""
    jframe, kind = _frames(jp, JC)[name]
    tframe, _ = _frames(tp, TC)[name]
    assert tframe == jframe
    (length,) = struct.unpack_from("<I", tframe, 0)
    assert length == len(tframe) - 4
    payload = tframe[4:]
    got, want = _unpack(tp, kind, payload), _unpack(jp, kind, payload)
    assert got == want and got[0] == "ok", (got, want)
    assert tp.peek_msg_type(payload) == jp.peek_msg_type(payload) == payload[4]


@pytest.mark.parametrize("name", _NAMES)
def test_codec_truncated_and_garbled_frames(name):
    """Every prefix of the payload, and the payload with each byte set to
    0xFF, unpack to the same value or the same error in both packages."""
    tframe, kind = _frames(tp, TC)[name]
    payload = tframe[4:]
    for cut in range(len(payload)):
        part = payload[:cut]
        assert _unpack(tp, kind, part) == _unpack(jp, kind, part), f"cut at {cut}"
        assert tp.peek_msg_type(part) == jp.peek_msg_type(part)
    for pos in range(len(payload)):
        bad = payload[:pos] + b"\xff" + payload[pos + 1:]
        assert _unpack(tp, kind, bad) == _unpack(jp, kind, bad), f"byte {pos}"
    extra = payload + b"\x00"
    assert _unpack(tp, kind, extra) == _unpack(jp, kind, extra)


def test_codec_typed_errors():
    """An unknown type carries its xid; a foreign batch, gossip or stats
    version raises UnsupportedBatchVersion with its fields; a batch response
    of a foreign version and trailing bytes are ValueErrors: alike in both."""
    cases = [
        ("request", struct.pack("<IB", 7, 99)),
        ("request", struct.pack("<IB", 7, 99) + b"\x00" * 40),
        ("request", struct.pack("<IBBH", 8, TC.MSG_TYPE_FLOW_BATCH, 2, 0) + b"\x00\x00"),
        ("request", struct.pack("<IBB", 9, TC.MSG_TYPE_PARAM_FLOW_BATCH, 9) + b"\x00" * 4),
        ("request", struct.pack("<IB", 10, TC.MSG_TYPE_STATS) + b"\x00"),
        ("request", struct.pack("<IB", 11, TC.MSG_TYPE_PING) + struct.pack("<H", 5) + b"ab"),
        ("batch_response", struct.pack("<IBBH", 12, TC.MSG_TYPE_FLOW_BATCH, 3, 0) + b"\x00\x00"),
        ("stats", struct.pack("<IBB", 13, TC.MSG_TYPE_STATS, 2) + b"{}"),
        ("stats", struct.pack("<IBB", 14, TC.MSG_TYPE_STATS, 1) + b"[1]"),
    ]
    sketch = bytearray(tp.pack_sketch_frame(15, TC.MSG_TYPE_SKETCH_PUSH, "o", 0, 0, 0, b"")[4:])
    sketch[5] = tp.GOSSIP_VERSION + 1
    cases.append(("sketch", bytes(sketch)))
    seen = set()
    for kind, payload in cases:
        got, want = _unpack(tp, kind, payload), _unpack(jp, kind, payload)
        assert got == want and got[0] == "raise", (kind, payload, got, want)
        seen.add(got[1])
    assert {"UnknownMsgType", "UnsupportedBatchVersion", "ValueError"} <= seen, seen
    assert _unpack(tp, "request", cases[0][1])[2] == (7, 99)


def _read_all(P, data: bytes):
    """What ``P.read_frame`` makes of ``data`` sent down a socket and
    closed: the payloads read, then None or the error."""
    a, b = socket.socketpair()
    with a, b:

        def send():
            a.sendall(data)
            a.shutdown(socket.SHUT_WR)

        sender = threading.Thread(target=send)
        sender.start()
        out = []
        while True:
            got = _outcome(lambda: P.read_frame(b))
            out.append(got)
            if got[0] != "ok" or got[1] is None:
                break
        b.shutdown(socket.SHUT_RD)  # an oversized frame's bytes stay unread: let the sender end
        sender.join()
        return out


@pytest.mark.parametrize(
    "data",
    [
        b"",
        b"\x01\x00",  # a length prefix cut short
        struct.pack("<I", 10) + b"abc",  # a payload cut short
        tp.pack_ping(1) + tp.pack_flow_request(2, 3, 4, False) + tp.pack_stats_request(5),
        struct.pack("<I", (1 << 20) + 1) + b"x" * 16,  # oversized: refused before reading it
        struct.pack("<I", 1 << 20) + b"y" * (1 << 20),  # the largest frame read
        struct.pack("<I", 0),
    ],
    ids=["eof", "short_header", "short_payload", "three_frames", "oversized", "largest", "empty_payload"],
)
def test_read_frame_same_in_both(data):
    assert _read_all(tp, data) == _read_all(jp, data)


_I64 = hst.integers(-(2**63), 2**63 - 1)
_I32 = hst.integers(-(2**31), 2**31 - 1)
_U32 = hst.integers(0, 2**32 - 1)
_TEXT = hst.text(max_size=12)


@settings(max_examples=60, deadline=None)
@given(xid=_U32, rows=hst.lists(hst.tuples(_I64, _I32, hst.booleans()), max_size=20),
       reports=hst.lists(hst.tuples(_I64, _I32), max_size=5),
       resp=hst.lists(hst.tuples(hst.integers(-128, 127), _I32, _I32), max_size=20),
       leases=hst.lists(hst.tuples(_I64, _I32, _I32), max_size=5))
def test_codec_flow_batches_hypothesis(xid, rows, reports, resp, leases):
    frame = tp.pack_flow_batch_request(xid, rows, reports)
    assert frame == jp.pack_flow_batch_request(xid, rows, reports)
    assert _unpack(tp, "request", frame[4:]) == _unpack(jp, "request", frame[4:]) == (
        "ok", (xid, TC.MSG_TYPE_FLOW_BATCH, (rows, reports)))
    frame = tp.pack_batch_response(xid, TC.MSG_TYPE_FLOW_BATCH, resp, leases)
    assert frame == jp.pack_batch_response(xid, JC.MSG_TYPE_FLOW_BATCH, resp, leases)
    assert _unpack(tp, "batch_response", frame[4:]) == _unpack(jp, "batch_response", frame[4:]) == (
        "ok", (xid, TC.MSG_TYPE_FLOW_BATCH, resp, leases))


@settings(max_examples=60, deadline=None)
@given(xid=_U32, interns=hst.lists(hst.tuples(_U32, _TEXT), max_size=6),
       rows=hst.lists(hst.tuples(_I64, _I32, hst.lists(_U32, max_size=4)), max_size=10),
       params=hst.lists(_TEXT, max_size=5), ns=_TEXT)
def test_codec_param_frames_hypothesis(xid, interns, rows, params, ns):
    for pack, args in ((lambda P: P.pack_param_batch_request(xid, rows, interns), ()),
                       (lambda P: P.pack_param_request(xid, 9, 2, params), ()),
                       (lambda P: P.pack_ping(xid, ns), ())):
        frame = pack(tp)
        assert frame == pack(jp)
        got = _unpack(tp, "request", frame[4:])
        assert got == _unpack(jp, "request", frame[4:]) and got[0] == "ok"


@settings(max_examples=40, deadline=None)
@given(xid=_U32, origin=_TEXT, wid=_I64, depth=hst.integers(0, 4), width=hst.integers(1, 16), seed=_U32,
       cands=hst.lists(hst.tuples(_TEXT, _I64), max_size=6))
def test_codec_sketch_frames_hypothesis(xid, origin, wid, depth, width, seed, cands):
    cm = np.random.default_rng(seed).integers(-(2**31), 2**31, (depth, width)).astype("<i4").tobytes()
    frame = tp.pack_sketch_frame(xid, TC.MSG_TYPE_SKETCH_PUSH, origin, wid, depth, width, cm, cands)
    assert frame == jp.pack_sketch_frame(xid, JC.MSG_TYPE_SKETCH_PUSH, origin, wid, depth, width, cm, cands)
    got = _unpack(tp, "sketch", frame[4:])
    assert got == _unpack(jp, "sketch", frame[4:])
    assert got == ("ok", (xid, TC.MSG_TYPE_SKETCH_PUSH, origin, wid, depth, width, cm, cands))


@settings(max_examples=150, deadline=None)
@given(head=hst.sampled_from([0, 1, 2, 3, 4, 16, 17, 20, 99]), body=hst.binary(max_size=48), xid=_U32)
def test_codec_garbage_bodies_hypothesis(head, body, xid):
    payload = struct.pack("<IB", xid, head) + body
    assert _unpack(tp, "request", payload) == _unpack(jp, "request", payload)


# --- the port's server under garbage (tests/test_protocol_fuzz.py) ------------


@pytest.fixture
def port_server(both):
    _, t = both
    srv = t.server(t.clock.ManualClock(0))
    yield srv
    srv.stop()


def _frame(payload: bytes) -> bytes:
    return struct.pack("<I", len(payload)) + payload


def _send_raw(port: int, data: bytes) -> None:
    """Send ``data`` and read until the server closes or goes quiet."""
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(data)
        s.shutdown(socket.SHUT_WR)
        s.settimeout(5)
        try:
            while s.recv(4096):
                pass
        except (socket.timeout, ConnectionError):
            pass


def _ask(s, frame: bytes) -> bytes:
    s.sendall(frame)
    payload = tp.read_frame(s)
    assert payload is not None
    return payload


def _ping_ok(port: int) -> bool:
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        xid, _, status, _, _, _ = tp.unpack_response(_ask(s, tp.pack_ping(1)))
        return xid == 1 and status == int(TC.TokenResultStatus.OK)


def test_port_server_survives_garbage(port_server, capfd):
    rng = np.random.default_rng(0)
    blobs = [
        b"",
        b"\x00",
        struct.pack("<I", 2**30),
        struct.pack("<I", 100),
        bytes(rng.integers(0, 256, 64, dtype=np.uint8)),
        bytes(rng.integers(0, 256, 4096, dtype=np.uint8)),
        _frame(b""),
        _frame(b"\x01"),
        _frame(bytes(rng.integers(0, 256, 32, dtype=np.uint8))),
        _frame(struct.pack("<IB", 5, TC.MSG_TYPE_PARAM_FLOW) + struct.pack("<qiB", 1, 1, 0) + struct.pack("<H", 1)
               + struct.pack("<H", 100) + b"abc"),
    ]
    for blob in blobs:
        _send_raw(port_server.port, blob)
        assert _ping_ok(port_server.port), f"server stopped answering after {blob[:16]!r}"
    err = capfd.readouterr().err
    assert "Traceback" not in err, err


def test_port_server_answers_bad_requests_and_keeps_the_connection(port_server, both):
    """An unknown type: BAD_REQUEST with its xid; a foreign batch version:
    an empty batch response; a param row naming a value id the connection
    never interned: BAD_REQUEST for that row; an empty batch: an empty
    answer. The connection serves on after each."""
    _, t = both
    t.cl.cluster_flow_rule_manager.load_rules("default", [t.rule("p", 5, 201, param=True)])
    with socket.create_connection(("127.0.0.1", port_server.port), timeout=5) as s:
        xid, mt, status, _, _, _ = tp.unpack_response(_ask(s, _frame(struct.pack("<IB", 7, 99))))
        assert (xid, mt, status) == (7, 99, int(TC.TokenResultStatus.BAD_REQUEST))
        foreign = bytearray(tp.pack_flow_batch_request(8, [(1, 1, False)]))
        foreign[4 + 5] = tp.BATCH_VERSION + 1
        assert tp.unpack_batch_response(_ask(s, bytes(foreign))) == (8, TC.MSG_TYPE_FLOW_BATCH, [], [])
        got = tp.unpack_batch_response(_ask(s, tp.pack_param_batch_request(9, [(201, 1, [1]), (201, 1, [2])],
                                                                            [(1, "a")])))
        assert got[2] == [(int(TC.TokenResultStatus.OK), 0, 0), (int(TC.TokenResultStatus.BAD_REQUEST), 0, 0)]
        assert tp.unpack_batch_response(_ask(s, tp.pack_flow_batch_request(10, []))) == (
            10, TC.MSG_TYPE_FLOW_BATCH, [], [])
        assert tp.unpack_response(_ask(s, tp.pack_ping(11)))[0] == 11
    # The param batch, the empty batch and the ping: the unknown type and the
    # foreign version are answered before the work is counted.
    assert port_server.work_stats()["frames"] == 3


def test_port_server_connection_gauge_not_leaked(port_server):
    before = port_server._conn_count
    for _ in range(5):
        _send_raw(port_server.port, struct.pack("<I", 2**30))
    wait_for(lambda: port_server._conn_count == before, "the connection gauge back to its start")
    assert port_server.connections.total() == 0


# --- one request stream through the four pairings -----------------------------


def _token_rows(results):
    return [(int(r.status), r.remaining, r.wait_in_ms, r.token_id) for r in results]


def _pairing_run(server_p, client_p, ids):
    """One token server's life from one client: per-call flow, param and
    held-token requests, batch frames, the window sliding, leases granted
    and spent, the stats command. Returns the observations."""
    ids.reset()
    for p in (server_p, client_p):
        p.stat_log.reset_counters()
        p.client_mod.client_stats.reset()
    clock = server_p.clock.ManualClock(0)
    server_p.cl.cluster_flow_rule_manager.load_rules("default", [
        server_p.rule("g", 5, 101), server_p.rule("avg", 2, 102, global_=False),
        server_p.rule("p", 3, 201, param=True), server_p.rule("c", 3, 301, grade=server_p.C.FLOW_GRADE_THREAD),
        server_p.rule("hot", 100, 401),
    ])
    server_p.set_config(CLUSTER_LEASE_ENABLED="false")
    srv = server_p.server(clock)
    cli = client_p.client(srv.port)
    try:
        out = [_token_rows([cli.request_token(101) for _ in range(7)]),
               _token_rows([cli.request_token(102, 1, True) for _ in range(4)]),
               _token_rows([cli.request_token(999)]),
               _token_rows(cli.request_tokens_batch([(101, 1, False), (999, 1, False), (102, 2, False)] * 3))]
        clock.set_ms(1101)  # the window slides
        out.append(_token_rows(cli.request_tokens_batch([(101, 2, False)] * 4)))
        out.append(_token_rows([cli.request_param_token(201, 1, [v]) for v in ("a", "a", "b", "a", "a")]))
        out.append(_token_rows(cli.request_param_tokens_batch(
            [(201, 1, ["c", "d"]), (201, 1, ["c"]), (999, 1, ["x"]), (201, 2, ["d", 7]), (201, 1, ["c"])])))
        toks = [cli.request_concurrent_token(301) for _ in range(4)]
        out.append(_token_rows(toks))
        out.append(_token_rows([cli.release_concurrent_token(toks[0].token_id),
                                cli.release_concurrent_token(toks[0].token_id)]))
        out.append(_token_rows([cli.request_concurrent_token(301, 2), cli.request_concurrent_token(301)]))
        server_p.set_config(CLUSTER_LEASE_ENABLED="true", CLUSTER_LEASE_TTL_MS=600000, CLUSTER_LEASE_MIN_BATCH=4,
                            CLUSTER_LEASE_FRAC=0.5, CLUSTER_LEASE_MAX=20)
        for step in range(5):
            clock.set_ms(1200 + 300 * step)
            out.append(_token_rows(cli.request_tokens_batch([(401, 1, False)] * 6 + [(101, 1, False)])))
            out.append(sorted((fid, lease[0]) for fid, lease in cli._leases.items()))
        snap = client_p.client_mod.fetch_server_stats("127.0.0.1", srv.port)
        work = {k: v for k, v in snap["work"].items() if k != "busy_s"}
        out.append((snap["connections"], work, snap["stat_log"]))
        out.append(client_p.client_mod.client_stats.snapshot()["lease_admits"])
        out.append(srv.service.flow_stats())
        return out
    finally:
        cli.stop()
        srv.stop()


def test_four_pairings_same_token_results(both, fixed_token_ids):
    """JAX client and server, port client and server, and the two mixed
    pairings give the same results on one stream; OK, BLOCKED,
    NO_RULE_EXISTS, held tokens and lease grants all occur."""
    j, t = both
    runs = {f"{c.name}->{s.name}": _pairing_run(s, c, fixed_token_ids) for s in (j, t) for c in (j, t)}
    want = runs.pop("sentinel_tpu->sentinel_tpu")
    for pairing, got in runs.items():
        assert got == want, pairing
    statuses = {row[0] for part in want[:10] for row in part}
    assert {0, 1, 3} <= statuses, statuses  # OK, BLOCKED, NO_RULE_EXISTS
    assert any(leases for leases in want[11:21:2]) and want[-2] > 0  # leases granted and spent
    assert want[-3][1]["lease_grants"] > 0


def test_leases_stored_before_the_caller_wakes(both):
    """A batch frame's lease grant is in the client's table when the call
    returns, so the next frame of the same thread is served from it (the
    JAX client wakes the caller first: ROADMAP Queue 3)."""
    _, t = both
    t.set_config(CLUSTER_LEASE_ENABLED="true", CLUSTER_LEASE_TTL_MS=600000, CLUSTER_LEASE_MIN_BATCH=4)
    t.cl.cluster_flow_rule_manager.load_rules("default", [t.rule(f"hot{i}", 1000, 500 + i) for i in range(40)])
    srv = t.server(t.clock.ManualClock(0))
    cli = t.client(srv.port)
    try:
        for i in range(40):
            assert all(int(r.status) == 0 for r in cli.request_tokens_batch([(500 + i, 1, False)] * 4))
            assert cli._leases[500 + i][0] > 0, i
            frames = t.client_mod.client_stats.snapshot()["batch_frames"]
            assert int(cli.request_tokens_batch([(500 + i, 1, False)])[0].status) == 0
            assert t.client_mod.client_stats.snapshot()["batch_frames"] == frames  # served by the lease
    finally:
        cli.stop()
        srv.stop()


# --- engines in client mode, in lockstep --------------------------------------


def _client_engine_run(p, lease: bool, window: bool, fallback: bool):
    """An engine in client mode against a server of its own package: bulk
    windows through submit_many (GLOBAL, AVG_LOCAL and param cluster rules
    beside local ones), per-op entries with held tokens and their exits,
    then the server stopped and the same traffic again. Returns
    (verdicts per step, client counters)."""
    p.set_config(CLUSTER_LEASE_ENABLED="true" if lease else "false", CLUSTER_LEASE_TTL_MS=600000,
                 CLUSTER_LEASE_MIN_BATCH=3, CLUSTER_CLIENT_WINDOW_MS=2 if window else 0)
    clock = p.clock.ManualClock(1000)
    rules = [p.rule("g", 40, 701, fallback=fallback), p.rule("avg", 5, 702, global_=False, fallback=fallback),
             p.rule("t", 3, 704, grade=p.C.FLOW_GRADE_THREAD, fallback=fallback)]
    prule = p.rule("p", 2, 703, param=True, fallback=fallback)
    p.cl.cluster_flow_rule_manager.load_rules("default", rules + [prule])
    srv = p.server(clock)
    cli = p.client(srv.port)
    p.cl.TokenClientProvider.register(cli)
    p.cl.ClusterStateManager.set_to_client()
    eng = p.engine(clock)
    eng.set_flow_rules(rules + [p.rules.FlowRule("plain", count=4), p.rules.FlowRule("g", count=30)])
    eng.set_param_rules({"p": [prule]})
    rng = np.random.default_rng(17)
    out = []

    def step(i):
        clock.set_ms(1000 + 250 * i)
        reqs = []
        for r in rng.integers(0, 4, 40):
            res = ("g", "avg", "p", "plain")[r]
            reqs.append({"resource": res, "ts": clock.now_ms(), **({"args": (f"v{int(rng.integers(0, 4))}",)}
                                                                  if res == "p" else {})})
        ops = eng.submit_many(reqs)
        ops += [eng.submit_entry("g"), eng.submit_entry("p", args=("v0",))]
        held = [eng.submit_entry("t") for _ in range(4)]
        eng.flush()
        eng.drain()
        out.append([(bool(o.verdict.admitted), int(o.verdict.reason), int(o.verdict.wait_ms)) for o in ops + held])
        for o in held:
            if o.verdict.admitted:
                eng.submit_exit(o.rows, rt=3, resource="t", cluster_tokens=o.cluster_tokens)
        eng.flush()

    try:
        for i in range(5):
            step(i)
        srv.stop()
        wait_for(lambda: not cli.connected, "the client saw its server close")
        for i in range(5, 8):
            step(i)
        snap = p.client_mod.client_stats.snapshot()
        return out, {k: snap[k] for k in ("requests", "batch_frames", "leases_granted", "lease_admits",
                                          "fallbacks")}
    finally:
        eng.close()
        cli.stop()
        srv.stop()


@pytest.mark.parametrize(
    "lease,window,fallback",
    [(False, False, True), (True, False, False), (False, True, True)],
    ids=["leases_off-fallback", "leases_on-no_fallback", "window-fallback"],
)
def test_client_mode_engines_lockstep(both, lease, window, fallback):
    j, t = both
    want, jstats = _client_engine_run(j, lease, window, fallback)
    got, tstats = _client_engine_run(t, lease, window, fallback)
    assert got == want
    assert tstats == jstats
    before, after = want[:5], want[5:]
    assert any(not v[0] for s in before for v in s) and any(v[0] for s in before for v in s)
    assert tstats["fallbacks"] > 0 and (tstats["lease_admits"] > 0) == lease
    if window:
        assert tstats["batch_frames"] > 5  # the per-op entries went out as one-row window frames
    if not fallback:
        # Without fallback a dead server passes every cluster check: only
        # the local "g" rule (count 30) and "plain" can block.
        assert all(v[0] or v[1] != 0 for s in after for v in s)
