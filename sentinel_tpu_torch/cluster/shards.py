"""Sharded token plane: hash-partitioned token state across N servers
(port of ``sentinel_tpu/cluster/shards.py``).

The batched plane (client.py) made talking to ONE token server cheap (one batched
frame per micro-window, local quota leases); this module removes the
single server as the ceiling on global admission throughput and as the
fleet-wide single point of failure. Token state partitions by flow-id
hash — ``shard = crc32(flow_id) % shards`` — so each flow's window
lives on exactly one server and admission stays exact (no flow is ever
split across servers; sharding changes WHERE a window lives, never its
math). Related partitioned-sketch designs split by key hash per
pipeline stage for the same reason (HashPipe, 1611.04825).

:class:`ShardedTokenClient` owns M :class:`ClusterTokenClient`
instances, one per shard endpoint, and implements the same
:class:`TokenService` surface the engine's bulk seam already speaks —
the engine needs no routing knowledge. Because each shard client keeps
its OWN micro-window leader, lease table, intern table and reconnect
backoff:

* windows form per shard — one slow shard never stalls another
  shard's frames;
* a dead shard degrades only ITS flows to the local-quota fallback
  stance (its client answers FAIL fast behind the reconnect gate,
  with honest per-shard fallback counters) while every other shard
  keeps serving;
* a shard bounce clears exactly that shard's leases and unreported
  consumption — the connection-scoped clearing in
  ``ClusterTokenClient._close`` — so hot flows on healthy shards keep
  their zero-RPC admits.

The shard map is versioned config (``sentinel.tpu.cluster.shards``,
``.shards.map``, ``.shards.map.version``): clients compare the version
integer at each entry point and rebuild their connection set when the
operator moves it. ``shards=1`` (the default) is never routed through
this module at all — ``ClusterClientConfigManager.build_client``
returns a plain ``ClusterTokenClient``, byte-identical to the
single-server plane.
"""

from __future__ import annotations

import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from sentinel_tpu_torch.cluster.client import (
    ClusterClientStats,
    ClusterTokenClient,
    client_stats,
)
from sentinel_tpu_torch.cluster.token_service import TokenResult, TokenService
from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.utils.config import SentinelConfig, config
from sentinel_tpu_torch.utils.record_log import record_log

_FLOW_ID = struct.Struct("<q")


def shard_of(flow_id: int, n_shards: int) -> int:
    """Stable shard index of a flow: crc32 over the little-endian i64
    flow id, mod the shard count. CRC32 (not Python ``hash``) so the
    routing is identical across processes, runs and interpreter
    versions — every engine in the fleet MUST route a flow to the same
    shard or global admission splits."""
    if n_shards <= 1:
        return 0
    return zlib.crc32(_FLOW_ID.pack(flow_id)) % n_shards


class ShardMap:
    """One parsed, versioned view of the shard-map config."""

    __slots__ = ("version", "endpoints")

    def __init__(self, version: int, endpoints: List[Tuple[str, int]]) -> None:
        self.version = version
        self.endpoints = list(endpoints)

    @property
    def n_shards(self) -> int:
        return len(self.endpoints)

    @classmethod
    def from_config(
        cls, default_host: str = "", default_port: int = 0
    ) -> Optional["ShardMap"]:
        """The current config's shard map, or None when sharding is not
        configured (shards <= 1, or a map shorter than the shard
        count — an incomplete map must fall back to the single-server
        client, never route a flow to a nonexistent shard)."""
        n = config.get_int(SentinelConfig.CLUSTER_SHARDS, 1)
        if n <= 1:
            return None
        raw = config.get(SentinelConfig.CLUSTER_SHARDS_MAP, "") or ""
        endpoints: List[Tuple[str, int]] = []
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue
            host, _, port_s = part.rpartition(":")
            try:
                port = int(port_s)
            except ValueError:
                record_log.warn("[ShardMap] bad endpoint %r skipped", part)
                continue
            endpoints.append((host or default_host or "127.0.0.1", port))
        if len(endpoints) < n:
            record_log.warn(
                "[ShardMap] shards=%d but map has %d endpoints — "
                "falling back to the single-server client", n, len(endpoints)
            )
            return None
        version = config.get_int(SentinelConfig.CLUSTER_SHARDS_MAP_VERSION, 0)
        return cls(version, endpoints[:n])


class ShardedTokenClient(TokenService):
    """M per-shard pipelined clients behind one TokenService surface.

    Batched entry points split their rows by shard and issue the
    per-shard batched RPCs CONCURRENTLY (a persistent small pool; the
    first shard's RPC runs inline on the caller so a single-shard
    window pays zero handoff). SHOULD_WAIT folding across shards is the
    caller's existing contract — the engine folds every row's wait into
    one bounded pacing sleep regardless of which shard said wait."""

    def __init__(
        self,
        shard_map: ShardMap,
        request_timeout_sec: float = 2.0,
        reconnect_interval_sec: float = 2.0,
        namespace: str = "default",
    ) -> None:
        self.namespace = namespace
        self.timeout = request_timeout_sec
        self.reconnect_interval = reconnect_interval_sec
        self._lock = threading.RLock()
        self._started = False
        # Concurrent-token routing: token ids are shard-local, so a
        # release must go back to the granting shard.
        self._token_shards: Dict[int, int] = {}
        self._token_lock = threading.Lock()
        # Parallel-issue honesty counters (the bench's capacity gate
        # reads these): windows whose rows spanned >1 shard and were
        # issued concurrently vs windows that fit one shard.
        self._issue_lock = threading.Lock()
        self.parallel_batches = 0
        self.single_batches = 0
        self._pool: Optional[ThreadPoolExecutor] = None
        self._clients: List[ClusterTokenClient] = []
        self.shard_map = shard_map
        self._build_clients(shard_map)

    # ------------------------------------------------------------------
    def _build_clients(self, shard_map: ShardMap) -> None:
        self._clients = [
            ClusterTokenClient(
                host,
                port,
                request_timeout_sec=self.timeout,
                reconnect_interval_sec=self.reconnect_interval,
                namespace=self.namespace,
                stats=ClusterClientStats(parent=client_stats),
            )
            for host, port in shard_map.endpoints
        ]
        self._pool = (
            ThreadPoolExecutor(
                max_workers=max(1, len(self._clients) - 1),
                thread_name_prefix="sentinel-shard",
            )
            if len(self._clients) > 1
            else None
        )

    @property
    def n_shards(self) -> int:
        return len(self._clients)

    @property
    def clients(self) -> List[ClusterTokenClient]:
        return self._clients

    @property
    def connected(self) -> bool:
        return any(c.connected for c in self._clients)

    def start(self) -> "ShardedTokenClient":
        with self._lock:
            for c in self._clients:
                c.start()
            self._started = True
        return self

    def stop(self) -> None:
        with self._lock:
            self._started = False
            if self._pool is not None:
                self._pool.shutdown(wait=False)
                self._pool = None
            for c in self._clients:
                c.stop()

    # ------------------------------------------------------------------
    # versioned shard map
    def maybe_reload(self) -> bool:
        """Cheap per-entry version check: one config int read. A moved
        version reparses the map and swaps the connection set (old
        clients stop — their in-flight frames resolve FAIL and fall
        back local for one window, the documented reshard cost)."""
        v = config.get_int(SentinelConfig.CLUSTER_SHARDS_MAP_VERSION, 0)
        if v == self.shard_map.version:
            return False
        with self._lock:
            if v == self.shard_map.version:
                return False
            new_map = ShardMap.from_config()
            if new_map is None:
                record_log.warn(
                    "[ShardedTokenClient] shard map v%d unusable — "
                    "keeping v%d", v, self.shard_map.version
                )
                # Stamp the version anyway so a broken map is logged
                # once, not per request.
                self.shard_map = ShardMap(v, self.shard_map.endpoints)
                return False
            record_log.info(
                "[ShardedTokenClient] shard map v%d -> v%d (%d shards)",
                self.shard_map.version, new_map.version, new_map.n_shards,
            )
            old_clients, old_pool = self._clients, self._pool
            self.shard_map = new_map
            self._build_clients(new_map)
            if self._started:
                for c in self._clients:
                    c.start()
            if old_pool is not None:
                old_pool.shutdown(wait=False)
            for c in old_clients:
                c.stop()
            with self._token_lock:
                self._token_shards.clear()
            # Rule-timeline stream of the capture journal: a reshard
            # changes which server decides cluster flows, so replay's
            # explainer must be able to date it. Peek at the installed
            # engine only — never construct one from a token client.
            from sentinel_tpu_torch.core import api as _core_api

            eng = _core_api._engine
            cap = getattr(eng, "capture", None) if eng is not None else None
            if cap is not None:
                cap.note_shard(
                    new_map.version,
                    ",".join("%s:%d" % ep for ep in new_map.endpoints),
                )
            return True

    def _client_for(self, flow_id: int) -> ClusterTokenClient:
        cs = self._clients
        return cs[shard_of(flow_id, len(cs))]

    # ------------------------------------------------------------------
    # per-call surface: route, then let the shard client's own
    # micro-window / lease machinery do what client.py built.
    def request_token(
        self, flow_id: int, acquire_count: int = 1, prioritized: bool = False
    ) -> TokenResult:
        self.maybe_reload()
        return self._client_for(flow_id).request_token(
            flow_id, acquire_count, prioritized
        )

    def request_param_token(
        self, flow_id: int, acquire_count: int, params: List[object]
    ) -> TokenResult:
        self.maybe_reload()
        return self._client_for(flow_id).request_param_token(
            flow_id, acquire_count, params
        )

    def request_concurrent_token(
        self, flow_id: int, acquire_count: int = 1, client_address: str = "local"
    ) -> TokenResult:
        self.maybe_reload()
        cs = self._clients
        si = shard_of(flow_id, len(cs))
        r = cs[si].request_concurrent_token(
            flow_id, acquire_count, client_address
        )
        if r.status == C.TokenResultStatus.OK and r.token_id:
            with self._token_lock:
                self._token_shards[r.token_id] = si
        return r

    def release_concurrent_token(self, token_id: int) -> TokenResult:
        with self._token_lock:
            si = self._token_shards.pop(token_id, None)
        if si is not None and si < len(self._clients):
            return self._clients[si].release_concurrent_token(token_id)
        # Unknown token (map reshard, process restart): token ids are
        # shard-local, so ask every shard — the holder answers
        # RELEASE_OK, the others ALREADY_RELEASE.
        last = TokenResult(C.TokenResultStatus.FAIL)
        for c in self._clients:
            r = c.release_concurrent_token(token_id)
            if r.status in (
                C.TokenResultStatus.OK, C.TokenResultStatus.RELEASE_OK
            ):
                return r
            last = r
        return last

    # ------------------------------------------------------------------
    # batched surface: split one submit_many window's rows by shard,
    # issue the per-shard frames concurrently.
    def _split(self, rows, key=lambda row: row[0]):
        """rows -> [(shard, row_indices, shard_rows)] in shard order."""
        cs = self._clients
        n = len(cs)
        by_shard: Dict[int, Tuple[List[int], list]] = {}
        for i, row in enumerate(rows):
            si = shard_of(key(row), n)
            ent = by_shard.get(si)
            if ent is None:
                ent = by_shard[si] = ([], [])
            ent[0].append(i)
            ent[1].append(row)
        return [(si, *by_shard[si]) for si in sorted(by_shard)]

    def _fan_out(self, rows, call) -> List[TokenResult]:
        """Shared batched fan-out: ``call(client, shard_rows)`` per
        shard, leader shard inline, the rest on the pool — results
        scatter back positionally."""
        groups = self._split(rows)
        out: List[Optional[TokenResult]] = [None] * len(rows)
        if len(groups) == 1:
            si, idx, shard_rows = groups[0]
            with self._issue_lock:
                self.single_batches += 1
            for i, r in zip(idx, call(self._clients[si], shard_rows)):
                out[i] = r
            return out  # type: ignore[return-value]
        with self._issue_lock:
            self.parallel_batches += 1
        pool = self._pool
        futs = []
        for si, idx, shard_rows in groups[1:]:
            if pool is not None:
                futs.append(
                    (si, idx, shard_rows,
                     pool.submit(call, self._clients[si], shard_rows))
                )
            else:
                futs.append((si, idx, shard_rows, None))
        si0, idx0, rows0 = groups[0]
        for i, r in zip(idx0, call(self._clients[si0], rows0)):
            out[i] = r
        for si, idx, shard_rows, fut in futs:
            if fut is None:
                results = call(self._clients[si], shard_rows)
            else:
                try:
                    results = fut.result()
                except Exception:
                    record_log.error(
                        "[ShardedTokenClient] shard %d batch failed", si,
                        exc_info=True,
                    )
                    results = [
                        TokenResult(C.TokenResultStatus.FAIL)
                    ] * len(shard_rows)
            for i, r in zip(idx, results):
                out[i] = r
        return out  # type: ignore[return-value]

    def request_tokens_batch(self, rows) -> List[TokenResult]:
        """[(flow_id, acquire, prioritized)] — one batched frame PER
        SHARD, issued concurrently. Each shard client still runs its
        own lease filter first, so leased rows never cross any wire."""
        if not rows:
            return []
        self.maybe_reload()
        if len(self._clients) == 1:
            return self._clients[0].request_tokens_batch(rows)
        return self._fan_out(rows, ClusterTokenClient.request_tokens_batch)

    def request_param_tokens_batch(self, rows) -> List[TokenResult]:
        """[(flow_id, acquire, params)] — one PARAM_FLOW_BATCH per
        shard; each shard connection interns its own value table."""
        if not rows:
            return []
        self.maybe_reload()
        if len(self._clients) == 1:
            return self._clients[0].request_param_tokens_batch(rows)
        return self._fan_out(
            rows, ClusterTokenClient.request_param_tokens_batch
        )

    # ------------------------------------------------------------------
    # observability
    def shard_rows(self) -> List[dict]:
        """Per-shard observability rows (the ``cluster`` transport
        command and the ``sentinel_cluster_shard_*`` families)."""
        rows = []
        for i, c in enumerate(self._clients):
            st = c.stats.snapshot()
            with c._lease_lock:
                n_leases = len(c._leases)
                unreported = sum(c._lease_reports.values())
            rows.append({
                "shard": i,
                "server": f"{c.host}:{c.port}",
                "connected": c.connected,
                "leases": n_leases,
                "lease_reports_pending": unreported,
                "requests": st["requests"],
                "batch_frames": st["batch_frames"],
                "leases_granted": st["leases_granted"],
                "lease_admits": st["lease_admits"],
                "fallbacks": st["fallbacks"],
            })
        return rows

    def plane_snapshot(self) -> dict:
        with self._issue_lock:
            parallel = self.parallel_batches
            single = self.single_batches
        return {
            "sharded": True,
            "n_shards": len(self._clients),
            "map_version": self.shard_map.version,
            "connected": self.connected,
            "namespace": self.namespace,
            "parallel_batches": parallel,
            "single_batches": single,
            "window_ms": config.get_int(
                SentinelConfig.CLUSTER_CLIENT_WINDOW_MS, 0
            ),
            "window_max": config.get_int(
                SentinelConfig.CLUSTER_CLIENT_WINDOW_MAX, 128
            ),
            "shards": self.shard_rows(),
        }
