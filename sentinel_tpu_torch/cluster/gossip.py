"""Sketch gossip plane (port of ``sentinel_tpu/cluster/gossip.py``): engines
exchange their host count-min twins +
candidate tables so heavy-hitter promotion sees FLEET traffic, not one
engine's shard of it (this framework's own — the reference has no
distributed sketch; protocol framing rides cluster/protocol.py).

One round trip carries both directions: the pusher sends SKETCH_PUSH
with its LOCAL view, the receiver folds it (SketchTier.merge_remote)
and answers SKETCH_MERGED with ITS local view, which the pusher folds
in turn. Frames always carry the local arrays — never the merged view —
so a triangle of peers can gossip forever without any engine's traffic
being counted twice (merge_remote snapshot-replaces per origin).

A peer running a foreign GOSSIP_VERSION answers an EMPTY merged frame
(depth=0) instead of dropping the connection, mirroring the batch
plane's UnsupportedBatchVersion stance: mixed-version fleets degrade to
per-engine promotion, never to a reconnect storm.
"""

from __future__ import annotations

import itertools
import os
import socket
import socketserver
import threading
from typing import List, Optional, Tuple

import numpy as np

from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.utils.config import config
from sentinel_tpu_torch.utils.record_log import record_log
from sentinel_tpu_torch.cluster import protocol


class GossipStats:
    """Process-wide gossip counters (the client_stats idiom: a module
    singleton the transport/metrics layers render from)."""

    _FIELDS = (
        "rounds",
        "frames_sent",
        "frames_received",
        "merges",
        "merge_rejects",
        "version_rejects",
        "bytes_sent",
        "bytes_received",
        "errors",
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()
        for f in self._FIELDS:
            setattr(self, f, 0)

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def snapshot(self) -> dict:
        with self._lock:
            return {f: getattr(self, f) for f in self._FIELDS}

    def reset(self) -> None:
        with self._lock:
            for f in self._FIELDS:
                setattr(self, f, 0)


gossip_stats = GossipStats()

_ORIGIN_SEQ = itertools.count(1)


def parse_peers(raw: str) -> List[Tuple[str, int]]:
    """``host:port,host:port`` CSV -> [(host, port)]; bad entries are
    skipped with a log line, not fatal (one typo must not disarm the
    whole gossip plane)."""
    peers: List[Tuple[str, int]] = []
    for ent in (raw or "").split(","):
        ent = ent.strip()
        if not ent:
            continue
        host, _, port_s = ent.rpartition(":")
        try:
            port = int(port_s)
            if not host or port <= 0:
                raise ValueError(ent)
        except ValueError:
            record_log.warn("[Gossip] bad peer entry %r skipped", ent)
            continue
        peers.append((host, port))
    return peers


class _GossipTCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class _GossipHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        agent: "GossipAgent" = self.server.agent  # type: ignore[attr-defined]
        sock = self.request
        sock.settimeout(agent.timeout_sec)
        try:
            while not agent._stop.is_set():
                payload = protocol.read_frame(sock)
                if payload is None:
                    return
                agent._serve_frame(sock, payload)
        except (socket.timeout, OSError, ValueError):
            return


class GossipAgent:
    """One engine's gossip endpoint: a listener that folds inbound
    SKETCH_PUSH frames into the tier and answers with the local view,
    plus an optional pusher loop (``sentinel.tpu.gossip.interval.ms``
    > 0) driving rounds against the configured peers. ``run_round()``
    is the synchronous one-shot the tests and a cron-style caller use
    directly — deterministic, no background timing."""

    def __init__(
        self,
        tier,
        origin: Optional[str] = None,
        port: Optional[int] = None,
        peers: Optional[List[Tuple[str, int]]] = None,
        interval_ms: Optional[int] = None,
        timeout_sec: float = 2.0,
    ) -> None:
        self.tier = tier
        self.requested_port = (
            config.get_int(config.GOSSIP_PORT, 0) if port is None else int(port)
        )
        self.peers: List[Tuple[str, int]] = (
            parse_peers(config.get(config.GOSSIP_PEERS, ""))
            if peers is None
            else list(peers)
        )
        self.interval_ms = (
            config.get_int(config.GOSSIP_INTERVAL_MS, 0)
            if interval_ms is None
            else int(interval_ms)
        )
        self.timeout_sec = float(timeout_sec)
        self.origin = origin or "%s:%d:%d" % (
            socket.gethostname(),
            os.getpid(),
            next(_ORIGIN_SEQ),
        )
        self._xid = itertools.count(1)
        self._stop = threading.Event()
        self._server: Optional[_GossipTCPServer] = None
        self._server_thread: Optional[threading.Thread] = None
        self._pusher: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    @property
    def port(self) -> int:
        if self._server is not None:
            return self._server.server_address[1]
        return self.requested_port

    def start(self) -> "GossipAgent":
        if self._server is not None:
            return self
        self._stop.clear()
        self._server = _GossipTCPServer(
            ("0.0.0.0", self.requested_port), _GossipHandler
        )
        self._server.agent = self  # type: ignore[attr-defined]
        self._server_thread = threading.Thread(
            target=self._server.serve_forever,
            name="sentinel-gossip",
            daemon=True,
        )
        self._server_thread.start()
        record_log.info(
            "[Gossip] %s listening on %d (%d peers, interval %dms)",
            self.origin, self.port, len(self.peers), self.interval_ms,
        )
        if self.interval_ms > 0 and self.peers:
            self._pusher = threading.Thread(
                target=self._push_loop, name="sentinel-gossip-push", daemon=True
            )
            self._pusher.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._pusher is not None:
            self._pusher.join(timeout=self.timeout_sec + 1.0)
            self._pusher = None
        if self._server_thread is not None:
            self._server_thread.join(timeout=2.0)
            self._server_thread = None

    def _push_loop(self) -> None:
        while not self._stop.wait(self.interval_ms / 1000.0):
            try:
                self.run_round()
            except Exception:
                gossip_stats.incr("errors")
                record_log.error("[Gossip] round failed", exc_info=True)

    # ------------------------------------------------------------------
    # push side
    # ------------------------------------------------------------------
    def run_round(self) -> int:
        """One synchronous gossip round: push the local view to every
        peer, fold each reply. Returns the number of peers whose view
        was merged (a dead peer counts 0 and costs one connect
        timeout, nothing else)."""
        wid, cm, cands = self.tier.gossip_snapshot()
        cm_bytes = cm.astype("<i4").tobytes()
        merged = 0
        for host, port in list(self.peers):
            try:
                merged += self._push_one(host, port, wid, cm, cm_bytes, cands)
            except (OSError, ValueError):
                gossip_stats.incr("errors")
        gossip_stats.incr("rounds")
        return merged

    def _push_one(
        self, host: str, port: int, wid: int, cm, cm_bytes: bytes, cands
    ) -> int:
        xid = next(self._xid) & 0x7FFFFFFF
        frame = protocol.pack_sketch_frame(
            xid, C.MSG_TYPE_SKETCH_PUSH, self.origin,
            wid, cm.shape[0], cm.shape[1], cm_bytes, cands,
        )
        with socket.create_connection(
            (host, port), timeout=self.timeout_sec
        ) as sock:
            sock.settimeout(self.timeout_sec)
            sock.sendall(frame)
            gossip_stats.incr("frames_sent")
            gossip_stats.incr("bytes_sent", len(frame))
            payload = protocol.read_frame(sock)
        if payload is None:
            return 0
        gossip_stats.incr("frames_received")
        gossip_stats.incr("bytes_received", len(payload) + 4)
        try:
            (_rxid, mt, origin, rwid, depth, width, rcm_bytes, rcands) = (
                protocol.unpack_sketch_frame(payload)
            )
        except protocol.UnsupportedBatchVersion:
            gossip_stats.incr("version_rejects")
            return 0
        if mt != C.MSG_TYPE_SKETCH_MERGED or depth <= 0:
            # Empty merged frame: the peer heard us but has nothing we
            # can fold (version reject on its side, or gossip unarmed).
            return 0
        rcm = np.frombuffer(rcm_bytes, dtype="<i4").reshape(depth, width)
        if self.tier.merge_remote(origin, rwid, rcm, rcands):
            gossip_stats.incr("merges")
            return 1
        gossip_stats.incr("merge_rejects")
        return 0

    # ------------------------------------------------------------------
    # serve side
    # ------------------------------------------------------------------
    def _serve_frame(self, sock, payload: bytes) -> None:
        gossip_stats.incr("frames_received")
        gossip_stats.incr("bytes_received", len(payload) + 4)
        if protocol.peek_msg_type(payload) != C.MSG_TYPE_SKETCH_PUSH:
            raise ValueError("non-gossip frame on gossip port")
        try:
            (xid, _mt, origin, wid, depth, width, cm_bytes, cands) = (
                protocol.unpack_sketch_frame(payload)
            )
        except protocol.UnsupportedBatchVersion as e:
            # Honest degrade: answer an EMPTY merged frame so the
            # foreign-version pusher resolves cleanly and falls back to
            # per-engine promotion.
            gossip_stats.incr("version_rejects")
            resp = protocol.pack_sketch_frame(
                e.xid, C.MSG_TYPE_SKETCH_MERGED, self.origin, 0, 0, 0, b""
            )
            sock.sendall(resp)
            gossip_stats.incr("frames_sent")
            gossip_stats.incr("bytes_sent", len(resp))
            return
        if depth > 0:
            cm = np.frombuffer(cm_bytes, dtype="<i4").reshape(depth, width)
            if self.tier.merge_remote(origin, wid, cm, cands):
                gossip_stats.incr("merges")
            else:
                gossip_stats.incr("merge_rejects")
        lwid, lcm, lcands = self.tier.gossip_snapshot()
        resp = protocol.pack_sketch_frame(
            xid, C.MSG_TYPE_SKETCH_MERGED, self.origin,
            lwid, lcm.shape[0], lcm.shape[1],
            lcm.astype("<i4").tobytes(), lcands,
        )
        sock.sendall(resp)
        gossip_stats.incr("frames_sent")
        gossip_stats.incr("bytes_sent", len(resp))

    def snapshot(self) -> dict:
        return {
            "origin": self.origin,
            "port": self.port,
            "peers": ["%s:%d" % p for p in self.peers],
            "interval_ms": self.interval_ms,
            "running": self._server is not None,
            "stats": gossip_stats.snapshot(),
        }


def maybe_build_gossip(tier) -> Optional[GossipAgent]:
    """The engine seam: a started GossipAgent when the config arms one
    (sketch enabled + gossip enabled), else None — the engine keeps a
    single attribute read on its close path either way."""
    if not getattr(tier, "gossip_armed", False):
        return None
    try:
        return GossipAgent(tier).start()
    except Exception:
        gossip_stats.incr("errors")
        record_log.error("[Gossip] agent start failed", exc_info=True)
        return None
