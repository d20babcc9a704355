"""Standalone / embedded token server over TCP (port of
``sentinel_tpu/cluster/server.py``). Its :class:`DefaultTokenService` lives
on the card by default, and every frame's decision is one launch of K12
(``csrc/token_decide.cu``) under the service's lock, so handler threads
never share the kernel's scratch. A param batch is decided a row at a
time (one launch a row), and each lease grant is one more launch: its
debit goes through the same decision.

Reference: SentinelDefaultTokenServer + NettyTransportServer +
TokenServerHandler (sentinel-cluster-server-default/.../
SentinelDefaultTokenServer.java:37, NettyTransportServer.java:78-93,
handler/TokenServerHandler.java:39-75). A threaded TCP acceptor decodes
framed requests and dispatches to the in-process
:class:`DefaultTokenService`; connection counts feed the AVG_LOCAL
threshold like ConnectionManager's connectedCount.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from typing import Optional

from sentinel_tpu_torch.cluster import protocol
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService, TokenService
from sentinel_tpu_torch.metrics.spans import get_journal
from sentinel_tpu_torch.metrics.spans import wall_ms as _span_wall_ms
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.utils.config import SentinelConfig, config
from sentinel_tpu_torch.utils.record_log import record_log


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: "SentinelTokenServer" = self.server.token_server  # type: ignore[attr-defined]
        server._conn_changed(+1)
        client_addr = "%s:%d" % self.client_address[:2]
        server.connections.on_connect(client_addr)
        server._track_socket(self.request, add=True)
        # Per-connection param-value intern table (vid → value): batch
        # param rows reference values by id, each value string crosses
        # the wire once per connection lifetime.
        interned: dict = {}
        spj = server._spans
        try:
            while True:
                try:
                    payload = protocol.read_frame(self.request)
                except ValueError:
                    # Oversized length prefix: like the reference's
                    # LengthFieldBasedFrameDecoder rejecting the frame,
                    # drop the connection without a handler crash.
                    record_log.warn("[TokenServer] oversized frame, closing")
                    return
                if payload is None:
                    return
                # Span: decode→decide→reply, stamped before the body
                # parse so codec time is inside the serve span.
                t_serve = _span_wall_ms() if spj.enabled else 0.0
                try:
                    xid, msg_type, body = protocol.unpack_request(payload)
                except protocol.UnknownMsgType as e:
                    # Well-framed but unknown type: answer BAD_REQUEST
                    # through the channel, keep the connection.
                    self.request.sendall(
                        protocol.pack_response(
                            e.xid, e.msg_type, int(C.TokenResultStatus.BAD_REQUEST)
                        )
                    )
                    continue
                except protocol.UnsupportedBatchVersion as e:
                    # Known batch type, future version byte: answer an
                    # EMPTY batch response (0 rows ≠ requested rows →
                    # the client fails its waiters) and keep the
                    # connection for the per-call types.
                    self.request.sendall(
                        protocol.pack_batch_response(e.xid, e.msg_type, [])
                    )
                    continue
                except (ValueError, struct.error):
                    # Truncated/garbage body: not recoverable mid-stream.
                    record_log.warn("[TokenServer] bad frame dropped")
                    return
                t_work = time.perf_counter()
                n_decisions = 1
                if msg_type == C.MSG_TYPE_PING:
                    # Ping = namespace announcement: bind this
                    # connection to the client's namespace and answer
                    # with the group's connected count
                    # (TokenServerHandler.handlePingRequest).
                    (namespace,) = body
                    count = server.connections.bind(
                        client_addr, namespace or "default"
                    )
                    resp = protocol.pack_response(
                        xid, msg_type, int(C.TokenResultStatus.OK), remaining=count
                    )
                elif msg_type == C.MSG_TYPE_FLOW:
                    flow_id, acquire, prio = body
                    r = server.service.request_token(flow_id, acquire, prio)
                    resp = protocol.pack_response(
                        xid, msg_type, int(r.status), r.remaining, r.wait_in_ms
                    )
                elif msg_type == C.MSG_TYPE_PARAM_FLOW:
                    flow_id, acquire, params = body
                    r = server.service.request_param_token(flow_id, acquire, params)
                    resp = protocol.pack_response(
                        xid, msg_type, int(r.status), r.remaining, r.wait_in_ms
                    )
                elif msg_type == C.MSG_TYPE_FLOW_BATCH:
                    rows, reports = body
                    n_decisions = len(rows)
                    results = server.service.request_tokens(rows)
                    resp_rows = [
                        (int(r.status), r.remaining, r.wait_in_ms)
                        for r in results
                    ]
                    if reports:
                        server._note_lease_reports(reports)
                    leases = server._maybe_grant_leases(rows, results, reports)
                    resp = protocol.pack_batch_response(
                        xid, msg_type, resp_rows, leases
                    )
                elif msg_type == C.MSG_TYPE_PARAM_FLOW_BATCH:
                    new_interns, rows = body
                    n_decisions = len(rows)
                    for vid, value in new_interns:
                        interned[vid] = value
                    resp_rows = []
                    for flow_id, acquire, vids in rows:
                        missing = [v for v in vids if v not in interned]
                        if missing:
                            # A vid the connection never interned is a
                            # codec bug, not a quota verdict.
                            resp_rows.append(
                                (int(C.TokenResultStatus.BAD_REQUEST), 0, 0)
                            )
                            continue
                        r = server.service.request_param_token(
                            flow_id, acquire, [interned[v] for v in vids]
                        )
                        resp_rows.append((int(r.status), r.remaining, r.wait_in_ms))
                    resp = protocol.pack_batch_response(xid, msg_type, resp_rows)
                elif msg_type == C.MSG_TYPE_CONCURRENT_FLOW_ACQUIRE:
                    flow_id, acquire = body
                    r = server.service.request_concurrent_token(
                        flow_id, acquire, client_address=client_addr
                    )
                    resp = protocol.pack_response(
                        xid, msg_type, int(r.status), r.remaining, r.wait_in_ms,
                        token_id=r.token_id,
                    )
                elif msg_type == C.MSG_TYPE_CONCURRENT_FLOW_RELEASE:
                    (token_id,) = body
                    r = server.service.release_concurrent_token(token_id)
                    resp = protocol.pack_response(xid, msg_type, int(r.status))
                elif msg_type == C.MSG_TYPE_STATS:
                    # Introspection, not a token decision: the snapshot
                    # must not inflate the decisions/busy_s capacity
                    # accounting the bench reads.
                    n_decisions = 0
                    resp = protocol.pack_stats_response(
                        xid, server.stats_snapshot()
                    )
                else:
                    # Defensive: unpack raises UnknownMsgType before
                    # dispatch, but a type added to _KNOWN_MSG_TYPES
                    # without a branch here must answer BAD_REQUEST,
                    # not kill the handler thread.
                    resp = protocol.pack_response(
                        xid, msg_type, int(C.TokenResultStatus.BAD_REQUEST)
                    )
                server._note_work(n_decisions, time.perf_counter() - t_work)
                self.request.sendall(resp)
                if spj.enabled:
                    spj.record(
                        "serve", "shard", t_serve,
                        _span_wall_ms() - t_serve,
                        xid=xid, mt=msg_type, rows=n_decisions,
                        port=server.port,
                    )
        except (ConnectionError, OSError):
            pass
        finally:
            server._track_socket(self.request, add=False)
            server._conn_changed(-1)
            server.connections.on_disconnect(client_addr)
            # A vanished client cannot release its held concurrency
            # tokens — free them eagerly (the clientOfflineTime story).
            concurrent = getattr(server.service, "concurrent", None)
            if concurrent is not None:
                freed = concurrent.release_client(client_addr)
                if freed:
                    record_log.info(
                        "[TokenServer] released %d concurrency tokens of %s",
                        freed, client_addr,
                    )


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def process_request(self, request, client_address):
        # Stamp the accept-time epoch in the serve_forever thread,
        # BEFORE the handler thread exists: a handler that only starts
        # running after a stop()+start() cycle can then be recognized as
        # belonging to the previous server lifetime and self-close,
        # instead of registering into the new lifetime's socket set
        # (its client was promised an EOF by stop()). Socket objects
        # have __slots__, so the stamp lives in a server-side table.
        self.token_server._stamp_accept(request)  # type: ignore[attr-defined]
        super().process_request(request, client_address)


class SentinelTokenServer:
    """Standalone token server; also usable embedded (the service is
    directly callable in-process, DefaultEmbeddedTokenServer style)."""

    def __init__(self, port: int = 0, service: Optional[TokenService] = None) -> None:
        from sentinel_tpu_torch.cluster.connection import ConnectionManager

        self.service = service or DefaultTokenService()
        self.connections = ConnectionManager()
        # AVG_LOCAL thresholds read the rule namespace's group count.
        if hasattr(self.service, "connections"):
            self.service.connections = self.connections
        self._requested_port = port
        self._server: Optional[_TCPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._conn_count = 0
        self._lock = threading.Lock()
        self._active_socks: set = set()
        self._stopping = False
        self._epoch = 0
        self._accept_epochs: dict = {}  # id(sock) -> accept-time epoch
        # Per-server work accounting for the shard-capacity bench: how
        # many token decisions this server made and the handler seconds
        # spent making them (decode→dispatch→pack, excluding socket
        # waits). decisions/busy_s is the per-shard decision rate a
        # dedicated core could sustain — the honest aggregate-capacity
        # column on a box where shard threads timeshare one core.
        self._work_lock = threading.Lock()
        self.decisions = 0
        self.frames = 0
        self.busy_s = 0.0
        self.lease_grants = 0
        # Fleet span journal: serve spans (decode→decide→reply) keyed
        # by xid so fleetdump can pair them with the cluster client's
        # RPC spans.
        self._spans = get_journal("shard")

    def _note_work(self, n_decisions: int, dt_s: float) -> None:
        with self._work_lock:
            self.frames += 1
            self.decisions += n_decisions
            self.busy_s += dt_s

    def work_stats(self) -> dict:
        with self._work_lock:
            return {
                "frames": self.frames,
                "decisions": self.decisions,
                "busy_s": self.busy_s,
                "lease_grants": self.lease_grants,
            }

    def reset_work_stats(self) -> None:
        with self._work_lock:
            self.frames = 0
            self.decisions = 0
            self.busy_s = 0.0
            self.lease_grants = 0

    def stats_snapshot(self) -> dict:
        """The ``stats`` wire command's body: work clocks + stat-log
        counters + connection count — per-shard state readable by any
        client, not just the bench harness."""
        from sentinel_tpu_torch.cluster import stat_log

        with self._lock:
            conns = self._conn_count
        return {
            "port": self.port,
            "connections": conns,
            "work": self.work_stats(),
            "stat_log": stat_log.counters_snapshot(),
        }

    def _stamp_accept(self, sock) -> None:
        with self._lock:
            self._accept_epochs[id(sock)] = self._epoch

    def _track_socket(self, sock, add: bool) -> None:
        close_now = False
        with self._lock:
            if add:
                accept_epoch = self._accept_epochs.pop(id(sock), self._epoch)
                if self._stopping or accept_epoch != self._epoch:
                    # Raced stop() (possibly followed by a restart): the
                    # drain already happened in this socket's accept
                    # epoch, so registering would orphan it and leave
                    # its client a half-dead session — close it instead.
                    close_now = True
                else:
                    self._active_socks.add(sock)
            else:
                self._active_socks.discard(sock)
        if close_now:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    @property
    def port(self) -> int:
        if self._server is None:
            return self._requested_port
        return self._server.server_address[1]

    def _conn_changed(self, delta: int) -> None:
        with self._lock:
            self._conn_count = max(0, self._conn_count + delta)
            if hasattr(self.service, "set_connected_count"):
                self.service.set_connected_count(max(1, self._conn_count))

    # ------------------------------------------------------------------
    # local quota leases (sentinel.tpu.cluster.lease.*)
    def _maybe_grant_leases(self, rows, results, reports=()) -> list:
        """Attach local-quota leases to a batch response for flows that
        are hot: ≥ lease.min.batch admitted rows IN THIS FRAME, or a
        lease-consumption report of ≥ lease.min.batch tokens riding the
        frame (a flow that just burned through a lease is hot even if
        its post-exhaustion stragglers form small frames — without this
        the plane oscillates lease → trickle → lease instead of
        renewing in steady state). The grant is lease.frac of the
        flow's post-batch headroom (the last OK row's ``remaining``),
        capped at lease.max, and DEBITED from the server window up
        front through the same decision kernel the rows went through —
        a refused debit means no lease, and an unused remainder is
        forfeited at expiry, never credited back, so leases can
        under-admit but never over-admit globally."""
        if not config.get_bool(SentinelConfig.CLUSTER_LEASE_ENABLED):
            return []
        min_batch = max(1, config.get_int(SentinelConfig.CLUSTER_LEASE_MIN_BATCH, 4))
        frac = config.get_float(SentinelConfig.CLUSTER_LEASE_FRAC, 0.5)
        cap = max(1, config.get_int(SentinelConfig.CLUSTER_LEASE_MAX, 256))
        ttl_ms = max(1, config.get_int(SentinelConfig.CLUSTER_LEASE_TTL_MS, 100))
        reported = {
            flow_id for flow_id, consumed in reports if consumed >= min_batch
        }
        ok_count: dict = {}
        headroom: dict = {}
        for (flow_id, _acq, _prio), r in zip(rows, results):
            if r.status == C.TokenResultStatus.OK:
                ok_count[flow_id] = ok_count.get(flow_id, 0) + 1
                headroom[flow_id] = r.remaining
        leases = []
        for flow_id, n in ok_count.items():
            if n < min_batch and flow_id not in reported:
                continue
            grant = min(cap, int(headroom.get(flow_id, 0) * frac))
            if grant < 1:
                continue
            debit = self.service.request_token(flow_id, grant)
            if debit.status == C.TokenResultStatus.OK:
                leases.append((flow_id, grant, ttl_ms))
        if leases:
            with self._work_lock:
                self.lease_grants += len(leases)
        return leases

    def _note_lease_reports(self, reports) -> None:
        """Client-side lease consumption reconciled on the next frame:
        the tokens were debited at grant time, so this only feeds the
        server's per-flow stat log (dashboards stay honest about
        lease-served traffic)."""
        from sentinel_tpu_torch.cluster import stat_log

        items = [
            ("flow", "leasePass", flow_id, int(consumed))
            for flow_id, consumed in reports
            if consumed > 0
        ]
        if items:
            stat_log.log_many(items)

    def start(self) -> "SentinelTokenServer":
        if self._server is not None:
            return self
        with self._lock:
            self._stopping = False  # re-armable after a stop()
        self._server = _TCPServer(("0.0.0.0", self._requested_port), _Handler)
        self._server.token_server = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="sentinel-token-server", daemon=True
        )
        self._thread.start()
        record_log.info("[TokenServer] listening on %d", self.port)
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        # Close established connections too (NettyTransportServer.stop
        # closing its channel group): clients must observe EOF and enter
        # their reconnect loop, not keep a half-dead session. The
        # _stopping flag makes a handler that raced past accept close
        # its own socket instead of registering into the drained set.
        with self._lock:
            self._stopping = True
            self._epoch += 1
            socks, self._active_socks = list(self._active_socks), set()
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        if self._spans.enabled:
            # A shard's serve spans must outlive its process for
            # fleetdump to merge.
            try:
                self._spans.spill()
            except OSError:
                pass
