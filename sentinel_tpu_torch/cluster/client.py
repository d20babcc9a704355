"""Cluster token client (port of ``sentinel_tpu/cluster/client.py``).

Reference: DefaultClusterTokenClient + NettyTransportClient
(sentinel-cluster-client-default/.../DefaultClusterTokenClient.java:45,
NettyTransportClient.java:61-228): framed TCP, xid → pending-result
correlation, request timeout mapped to FAIL, scheduled reconnect on
connection loss. The caller (FlowRuleChecker.passClusterCheck analog in
the engine) maps FAIL/NO_RULE_EXISTS to fallback-to-local.
"""

from __future__ import annotations

import itertools
import socket
import struct
import threading
import time
from typing import Dict, List, Optional

from sentinel_tpu_torch.cluster import protocol
from sentinel_tpu_torch.cluster.token_service import TokenResult, TokenService
from sentinel_tpu_torch.datasource.backoff import Backoff
from sentinel_tpu_torch.metrics.histogram import LatencyHistogram
from sentinel_tpu_torch.metrics.spans import get_journal
from sentinel_tpu_torch.metrics.spans import wall_ms as _span_wall_ms
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.utils.config import SentinelConfig, config
from sentinel_tpu_torch.utils.record_log import record_log


class ClusterClientStats:
    """Process-wide cluster token client counters + RPC latency
    histogram. Module-level singleton (not per-client) so the
    Prometheus render works off a default engine — an engine has no
    client attached until a cluster rule arrives, but the metric
    families must exist from the first scrape."""

    def __init__(self, parent: "ClusterClientStats" = None) -> None:
        # Per-shard instances chain to the process-wide singleton: every
        # event counts once globally (dashboards keep their totals) and
        # once on the owning shard (the per-shard rows/fallback matrix).
        self._parent = parent
        self._lock = threading.Lock()
        self.requests = 0  # token decisions asked of the client
        self.batch_frames = 0  # batched frames sent
        self.leases_granted = 0  # leases received from the server
        self.lease_admits = 0  # admissions served from a local lease
        self.fallbacks = 0  # FAIL-family serves (caller falls back local)
        self.rpc_ms = LatencyHistogram()

    def incr(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)
        if self._parent is not None:
            self._parent.incr(field, n)

    def record_rpc_ms(self, ms: float) -> None:
        self.rpc_ms.record(ms)
        if self._parent is not None:
            self._parent.rpc_ms.record(ms)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "requests": self.requests,
                "batch_frames": self.batch_frames,
                "leases_granted": self.leases_granted,
                "lease_admits": self.lease_admits,
                "fallbacks": self.fallbacks,
            }
        out["rpc"] = self.rpc_ms.summary()
        return out

    def reset(self) -> None:
        with self._lock:
            self.requests = 0
            self.batch_frames = 0
            self.leases_granted = 0
            self.lease_admits = 0
            self.fallbacks = 0
        self.rpc_ms.reset()


client_stats = ClusterClientStats()


class ClusterTokenClient(TokenService):
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 18730,
        request_timeout_sec: float = 2.0,
        reconnect_interval_sec: float = 2.0,
        namespace: str = "default",
        stats: "ClusterClientStats" = None,
    ) -> None:
        self.host = host
        self.port = port
        # Counter sink: the process-wide singleton by default; a
        # sharded plane hands each shard client its own (parent-chained)
        # instance so per-shard rows stay attributable.
        self.stats = stats if stats is not None else client_stats
        # Announced to the server in the connect-time ping; the server
        # groups connections per namespace for AVG_LOCAL thresholds
        # (ClusterClientConfigManager's namespace registration +
        # TokenServerHandler.handlePingRequest).
        self.namespace = namespace
        self.timeout = request_timeout_sec
        self.reconnect_interval = reconnect_interval_sec
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._pending: Dict[int, "_Pending"] = {}
        self._pending_lock = threading.Lock()
        self._xid = itertools.count(1)
        self._reader: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        # Shared datasource backoff stance (datasource/backoff.py):
        # consecutive connect failures space retries out capped-
        # exponentially with subtractive jitter instead of hammering a
        # dying token server at the fixed cadence forever; one
        # successful connect resets the streak to the base interval.
        self._backoff = Backoff(
            base_s=reconnect_interval_sec,
            cap_s=max(30.0, reconnect_interval_sec),
        )
        # Guards the gate AND the Backoff (not thread-safe by design):
        # request threads race through _maybe_reconnect.
        self._reconnect_lock = threading.Lock()
        self._next_reconnect = 0.0
        # Client micro-window (sentinel.tpu.cluster.client.window.*):
        # concurrent per-op request_token callers coalesce into one
        # FLOW_REQUEST_BATCH frame. The leader flushes after window.ms
        # (or at window.max rows) and does NOT await the response —
        # frames pipeline, xid-multiplexed on the reader.
        self._win_lock = threading.Lock()
        self._win_rows: list = []  # (flow_id, acquire, prio, waiter)
        self._win_leader_active = False
        # Local quota leases: flow_id → [tokens_left, monotonic expiry].
        # Consumption accumulates in _lease_reports and rides the next
        # batch frame for server-side reconciliation.
        self._lease_lock = threading.Lock()
        self._leases: Dict[int, list] = {}
        self._lease_reports: Dict[int, int] = {}
        # Per-connection param-value intern table (value → vid); reset
        # on every (re)connect because the server's reverse table is
        # per connection.
        self._interned: Dict[str, int] = {}
        self._next_vid = 1
        # Fleet span journal: per-frame RPC spans keyed by xid, the
        # client half of the shard's serve spans. Role inherits from
        # whatever process hosts this client (engine, usually).
        self._spans = get_journal()

    # ------------------------------------------------------------------
    def start(self) -> "ClusterTokenClient":
        self._stopped.clear()
        self._connect()
        return self

    def stop(self) -> None:
        self._stopped.set()
        self._close()

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def _connect(self) -> bool:
        with self._send_lock:
            if self._sock is not None:
                return True
            try:
                s = socket.create_connection((self.host, self.port), timeout=self.timeout)
                s.settimeout(None)
                self._sock = s
            except OSError as e:
                record_log.warn("[TokenClient] connect failed: %s", e)
                return False
        self._reader = threading.Thread(
            target=self._read_loop, name="sentinel-token-client", daemon=True
        )
        self._reader.start()
        # Namespace announcement; the reply (group count) is consumed by
        # the reader and dropped — no pending entry is registered, so a
        # lost reply costs nothing.
        try:
            with self._send_lock:
                if self._sock is not None:
                    self._sock.sendall(
                        protocol.pack_ping(next(self._xid), self.namespace)
                    )
        except OSError:
            pass
        return True

    def _close(self) -> None:
        with self._send_lock:
            if self._sock is not None:
                try:
                    # shutdown() first: close() alone does not send FIN
                    # while the reader thread is blocked in recv on the
                    # same fd (the in-flight syscall pins the file
                    # description open), deadlocking both this reader
                    # and the server's handler.
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
            # The server's vid reverse-table died with the connection.
            self._interned.clear()
            self._next_vid = 1
        # Server death voids local quota — but ONLY this connection's:
        # leases live per client object, one connection each, so a
        # shard bounce clears exactly the dead shard's leases and
        # unreported consumption (the sharded plane relies on this
        # scoping; tests/test_torch_cluster_shards.py pins it). Never admit on a
        # lease the server can no longer account for.
        with self._lease_lock:
            self._leases.clear()
            self._lease_reports.clear()
        # Fail all pending waits.
        with self._pending_lock:
            for p in self._pending.values():
                p.set(TokenResult(C.TokenResultStatus.FAIL))
            self._pending.clear()

    def _maybe_reconnect(self) -> bool:
        # Close the gate for the whole attempt BEFORE dialing: _connect
        # can block for a full TCP timeout, and during it every other
        # request thread must fail fast (return False) rather than
        # queue up behind the dial or hammer the dying server with its
        # own. The successful dialer re-stamps the gate and resets the
        # failure streak the pre-charged next_delay() advanced.
        with self._reconnect_lock:
            now = time.monotonic()
            if now < self._next_reconnect:
                return False
            self._next_reconnect = now + self._backoff.next_delay()
        ok = self._connect()
        if ok:
            with self._reconnect_lock:
                self._backoff.reset()
                self._next_reconnect = (
                    time.monotonic() + self.reconnect_interval
                )
        return ok

    def _read_loop(self) -> None:
        sock = self._sock
        try:
            while not self._stopped.is_set() and sock is not None:
                payload = protocol.read_frame(sock)
                if payload is None:
                    break
                if protocol.peek_msg_type(payload) in (
                    C.MSG_TYPE_FLOW_BATCH, C.MSG_TYPE_PARAM_FLOW_BATCH
                ):
                    xid, _mt, rows, leases = protocol.unpack_batch_response(payload)
                    # The frame's leases are in the table before its callers
                    # wake: their next frame sees them, whichever thread runs
                    # first (the JAX client wakes them first).
                    if leases:
                        self._store_leases(leases)
                    with self._pending_lock:
                        p = self._pending.pop(xid, None)
                    if isinstance(p, _BatchPending):
                        p.set_batch(rows)
                    elif p is not None:
                        p.set(TokenResult(C.TokenResultStatus.FAIL))
                    continue
                xid, _mt, status, remaining, wait_ms, token_id = protocol.unpack_response(payload)
                with self._pending_lock:
                    p = self._pending.pop(xid, None)
                if p is not None:
                    p.set(TokenResult(
                        C.TokenResultStatus(status), remaining, wait_ms, token_id
                    ))
        except (OSError, ValueError, struct.error):
            # struct.error is NOT a ValueError: a version-skewed peer
            # sending a differently-sized response must take the silent
            # close/reconnect path, not kill the reader.
            pass
        finally:
            self._close()

    # ------------------------------------------------------------------
    def _send_request(self, frame: bytes, xid: int) -> TokenResult:
        pending = _Pending()
        with self._pending_lock:
            self._pending[xid] = pending
        t0 = time.monotonic()
        try:
            with self._send_lock:
                if self._sock is None:
                    raise OSError("not connected")
                self._sock.sendall(frame)
        except OSError:
            with self._pending_lock:
                self._pending.pop(xid, None)
            self._close()
            self._maybe_reconnect()
            self.stats.incr("fallbacks")
            return TokenResult(C.TokenResultStatus.FAIL)
        result = pending.wait(self.timeout)
        if result is None:
            with self._pending_lock:
                self._pending.pop(xid, None)
            self.stats.incr("fallbacks")
            return TokenResult(C.TokenResultStatus.FAIL)
        dt_ms = (time.monotonic() - t0) * 1e3
        self.stats.record_rpc_ms(dt_ms)
        if self._spans.enabled:
            t_v = _span_wall_ms()
            self._spans.record(
                "rpc", "client", t_v - dt_ms, dt_ms,
                xid=xid, port=self.port, rows=1,
            )
        if result.status == C.TokenResultStatus.FAIL:
            self.stats.incr("fallbacks")
        return result

    # ------------------------------------------------------------------
    # local quota leases
    def _store_leases(self, leases) -> None:
        now = time.monotonic()
        with self._lease_lock:
            for flow_id, tokens, valid_ms in leases:
                if tokens <= 0 or valid_ms <= 0:
                    continue
                self.stats.incr("leases_granted")
                self._leases[flow_id] = [tokens, now + valid_ms / 1000.0]

    def _lease_admit(self, flow_id: int, acquire: int) -> bool:
        """Zero-RPC admission from a live local lease. Consumption is
        recorded for the next frame's report rows; the last token
        drops the lease (back to the RPC stance, which may earn a
        fresh one)."""
        if not self._leases:
            return False
        now = time.monotonic()
        with self._lease_lock:
            lease = self._leases.get(flow_id)
            if lease is None:
                return False
            if now >= lease[1]:
                del self._leases[flow_id]
                return False
            if lease[0] < acquire:
                return False
            lease[0] -= acquire
            if lease[0] <= 0:
                del self._leases[flow_id]
            self._lease_reports[flow_id] = (
                self._lease_reports.get(flow_id, 0) + acquire
            )
        self.stats.incr("lease_admits")
        return True

    def _drain_lease_reports(self) -> list:
        if not self._lease_reports:
            return []
        with self._lease_lock:
            items = list(self._lease_reports.items())
            self._lease_reports.clear()
        return items

    def plane_snapshot(self) -> dict:
        """Live per-connection state for the ``cluster`` transport
        command (process-wide counters live in ``client_stats``)."""
        now = time.monotonic()
        with self._lease_lock:
            leases = {
                str(fid): {
                    "tokens_left": lease[0],
                    "valid_ms": max(0, int((lease[1] - now) * 1000)),
                }
                for fid, lease in self._leases.items()
            }
            unreported = sum(self._lease_reports.values())
        with self._send_lock:
            interned_values = len(self._interned)
        with self._pending_lock:
            inflight = len(self._pending)
        return {
            "connected": self._sock is not None,
            "server": f"{self.host}:{self.port}",
            "namespace": self.namespace,
            "inflight_frames": inflight,
            "interned_values": interned_values,
            "leases": leases,
            "lease_reports_pending": unreported,
            "window_ms": config.get_int(
                SentinelConfig.CLUSTER_CLIENT_WINDOW_MS, 0
            ),
            "window_max": config.get_int(
                SentinelConfig.CLUSTER_CLIENT_WINDOW_MAX, 128
            ),
        }

    # ------------------------------------------------------------------
    # batched path
    def _rpc_flow_batch(self, rows) -> List[TokenResult]:
        """One FLOW_REQUEST_BATCH round trip for N rows."""
        if self._sock is None and not self._maybe_reconnect():
            self.stats.incr("fallbacks", len(rows))
            return [TokenResult(C.TokenResultStatus.FAIL)] * len(rows)
        waiters = [_Pending() for _ in rows]
        xid = next(self._xid)
        frame = protocol.pack_flow_batch_request(
            xid, rows, self._drain_lease_reports()
        )
        spj = self._spans
        t_r = _span_wall_ms() if spj.enabled else 0.0
        if not self._send_batch_frame(frame, xid, waiters):
            return [TokenResult(C.TokenResultStatus.FAIL)] * len(rows)
        out = self._await_waiters(waiters)
        if spj.enabled:
            spj.record(
                "rpc", "client", t_r, _span_wall_ms() - t_r,
                xid=xid, port=self.port, rows=len(rows),
            )
        return out

    def _send_batch_frame(self, frame: bytes, xid: int, waiters) -> bool:
        pending = _BatchPending(waiters, self.stats)
        with self._pending_lock:
            self._pending[xid] = pending
        try:
            with self._send_lock:
                if self._sock is None:
                    raise OSError("not connected")
                self._sock.sendall(frame)
        except OSError:
            with self._pending_lock:
                self._pending.pop(xid, None)
            self.stats.incr("fallbacks", len(waiters))
            self._close()
            self._maybe_reconnect()
            return False
        self.stats.incr("batch_frames")
        return True

    def _await_waiters(self, waiters) -> List[TokenResult]:
        deadline = time.monotonic() + self.timeout
        out = []
        for w in waiters:
            r = w.wait(max(0.0, deadline - time.monotonic()))
            if r is None:
                self.stats.incr("fallbacks")
                r = TokenResult(C.TokenResultStatus.FAIL)
            out.append(r)
        return out

    def request_tokens_batch(self, rows) -> List[TokenResult]:
        """Batched entry point mirroring
        DefaultTokenService.request_tokens: [(flow_id, acquire,
        prioritized)] → one frame (leased rows are served locally and
        never cross the wire)."""
        if not rows:
            return []
        self.stats.incr("requests", len(rows))
        out: List[Optional[TokenResult]] = [None] * len(rows)
        rpc_rows = []
        rpc_idx = []
        for i, (flow_id, acquire, prio) in enumerate(rows):
            if self._lease_admit(flow_id, acquire):
                out[i] = TokenResult(C.TokenResultStatus.OK)
            else:
                rpc_rows.append((flow_id, acquire, prio))
                rpc_idx.append(i)
        if rpc_rows:
            for i, r in zip(rpc_idx, self._rpc_flow_batch(rpc_rows)):
                out[i] = r
        return out  # type: ignore[return-value]

    def request_param_tokens_batch(self, rows) -> List[TokenResult]:
        """[(flow_id, acquire, params)] → one PARAM_FLOW_BATCH frame.
        Values are interned per connection: interning and the send
        share the send lock so a frame can never reference a vid an
        earlier-ordered frame has not announced."""
        if not rows:
            return []
        self.stats.incr("requests", len(rows))
        if self._sock is None and not self._maybe_reconnect():
            self.stats.incr("fallbacks", len(rows))
            return [TokenResult(C.TokenResultStatus.FAIL)] * len(rows)
        waiters = [_Pending() for _ in rows]
        xid = next(self._xid)
        spj = self._spans
        t_r = _span_wall_ms() if spj.enabled else 0.0
        pending = _BatchPending(waiters, self.stats)
        with self._pending_lock:
            self._pending[xid] = pending
        try:
            with self._send_lock:
                if self._sock is None:
                    raise OSError("not connected")
                interns = []
                wire_rows = []
                for flow_id, acquire, params in rows:
                    vids = []
                    for p in params:
                        s = str(p)
                        vid = self._interned.get(s)
                        if vid is None:
                            vid = self._next_vid
                            self._next_vid += 1
                            self._interned[s] = vid
                            interns.append((vid, s))
                        vids.append(vid)
                    wire_rows.append((flow_id, acquire, vids))
                self._sock.sendall(
                    protocol.pack_param_batch_request(xid, wire_rows, interns)
                )
        except OSError:
            with self._pending_lock:
                self._pending.pop(xid, None)
            self.stats.incr("fallbacks", len(rows))
            self._close()
            self._maybe_reconnect()
            return [TokenResult(C.TokenResultStatus.FAIL)] * len(rows)
        self.stats.incr("batch_frames")
        out = self._await_waiters(waiters)
        if spj.enabled:
            spj.record(
                "rpc", "client", t_r, _span_wall_ms() - t_r,
                xid=xid, port=self.port, rows=len(rows),
            )
        return out

    # ------------------------------------------------------------------
    # client micro-window (per-op callers coalesce into one frame)
    def _window_request(
        self, flow_id: int, acquire: int, prioritized: bool, win_ms: int
    ) -> TokenResult:
        waiter = _Pending()
        with self._win_lock:
            self._win_rows.append((flow_id, acquire, prioritized, waiter))
            leader = not self._win_leader_active
            if leader:
                self._win_leader_active = True
        if leader:
            win_max = max(
                1, config.get_int(SentinelConfig.CLUSTER_CLIENT_WINDOW_MAX, 128)
            )
            deadline = time.monotonic() + win_ms / 1000.0
            while True:
                with self._win_lock:
                    full = len(self._win_rows) >= win_max
                remaining = deadline - time.monotonic()
                if full or remaining <= 0:
                    break
                time.sleep(min(remaining, 0.0005))
            with self._win_lock:
                batch, self._win_rows = self._win_rows, []
                self._win_leader_active = False
            self._flush_window(batch)
        result = waiter.wait(self.timeout + win_ms / 1000.0)
        if result is None:
            self.stats.incr("fallbacks")
            return TokenResult(C.TokenResultStatus.FAIL)
        return result

    def _flush_window(self, batch) -> None:
        if not batch:
            return
        if self._sock is None and not self._maybe_reconnect():
            self.stats.incr("fallbacks", len(batch))
            for _f, _a, _p, w in batch:
                w.set(TokenResult(C.TokenResultStatus.FAIL))
            return
        xid = next(self._xid)
        frame = protocol.pack_flow_batch_request(
            xid,
            [(f, a, p) for f, a, p, _w in batch],
            self._drain_lease_reports(),
        )
        waiters = [w for _f, _a, _p, w in batch]
        if not self._send_batch_frame(frame, xid, waiters):
            for w in waiters:
                w.set(TokenResult(C.TokenResultStatus.FAIL))
        # Pipelined: the response resolves the waiters via the reader;
        # the next window can form and ship before it lands.

    def request_token(
        self, flow_id: int, acquire_count: int = 1, prioritized: bool = False
    ) -> TokenResult:
        self.stats.incr("requests")
        if self._lease_admit(flow_id, acquire_count):
            return TokenResult(C.TokenResultStatus.OK)
        win_ms = config.get_int(SentinelConfig.CLUSTER_CLIENT_WINDOW_MS, 0)
        if win_ms > 0:
            return self._window_request(
                flow_id, acquire_count, prioritized, win_ms
            )
        if self._sock is None and not self._maybe_reconnect():
            self.stats.incr("fallbacks")
            return TokenResult(C.TokenResultStatus.FAIL)
        xid = next(self._xid)
        return self._send_request(
            protocol.pack_flow_request(xid, flow_id, acquire_count, prioritized), xid
        )

    def request_param_token(
        self, flow_id: int, acquire_count: int, params: List[object]
    ) -> TokenResult:
        self.stats.incr("requests")
        if self._sock is None and not self._maybe_reconnect():
            self.stats.incr("fallbacks")
            return TokenResult(C.TokenResultStatus.FAIL)
        xid = next(self._xid)
        return self._send_request(
            protocol.pack_param_request(xid, flow_id, acquire_count, [str(p) for p in params]),
            xid,
        )

    def request_concurrent_token(
        self, flow_id: int, acquire_count: int = 1, client_address: str = "local"
    ) -> TokenResult:
        """requestConcurrentToken over the wire; the server derives the
        client address from the connection (the argument is unused here,
        kept for TokenService interface parity)."""
        self.stats.incr("requests")
        if self._sock is None and not self._maybe_reconnect():
            self.stats.incr("fallbacks")
            return TokenResult(C.TokenResultStatus.FAIL)
        xid = next(self._xid)
        return self._send_request(
            protocol.pack_concurrent_acquire(xid, flow_id, acquire_count), xid
        )

    def release_concurrent_token(self, token_id: int) -> TokenResult:
        if self._sock is None and not self._maybe_reconnect():
            return TokenResult(C.TokenResultStatus.FAIL)
        xid = next(self._xid)
        return self._send_request(
            protocol.pack_concurrent_release(xid, token_id), xid
        )


class _Pending:
    def __init__(self) -> None:
        self._event = threading.Event()
        self._result: Optional[TokenResult] = None

    def set(self, result: TokenResult) -> None:
        self._result = result
        self._event.set()

    def wait(self, timeout: float) -> Optional[TokenResult]:
        if not self._event.wait(timeout):
            return None
        return self._result


class _BatchPending:
    """One in-flight batch frame: the response's positional rows fan
    out to the per-row waiters. Duck-types _Pending.set so _close's
    fail-all sweep needs no special case."""

    __slots__ = ("waiters", "_t0", "_stats")

    def __init__(self, waiters, stats: "ClusterClientStats" = None) -> None:
        self.waiters = waiters
        self._t0 = time.monotonic()
        self._stats = stats if stats is not None else client_stats

    def set(self, result: TokenResult) -> None:
        for w in self.waiters:
            w.set(result)

    def set_batch(self, rows) -> None:
        self._stats.record_rpc_ms((time.monotonic() - self._t0) * 1e3)
        if len(rows) != len(self.waiters):
            # Version-rejected (empty) or malformed response: fail every
            # waiter — callers map FAIL-family to fallback-to-local.
            self.set(TokenResult(C.TokenResultStatus.BAD_REQUEST))
            return
        for w, (status, remaining, wait_ms) in zip(self.waiters, rows):
            w.set(TokenResult(C.TokenResultStatus(status), remaining, wait_ms))


def fetch_server_stats(host: str, port: int, timeout_sec: float = 2.0) -> dict:
    """One-shot ``stats`` wire command against a token shard: its own
    short-lived socket so introspection never competes with (or, on a
    version-skewed peer, poisons) a live client's xid-multiplexed
    reader. Raises OSError/ValueError on connect or codec failure."""
    with socket.create_connection((host, port), timeout=timeout_sec) as s:
        s.settimeout(timeout_sec)
        s.sendall(protocol.pack_stats_request(1))
        payload = protocol.read_frame(s)
    if payload is None:
        raise OSError("stats: connection closed before response")
    mt = protocol.peek_msg_type(payload)
    if mt != C.MSG_TYPE_STATS:
        raise ValueError(f"stats: unexpected response type {mt}")
    _xid, snap = protocol.unpack_stats_response(payload)
    return snap
