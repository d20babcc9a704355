"""Cluster mode state and providers (port of
``sentinel_tpu/cluster/state.py``).

Reference: ClusterStateManager (CLIENT=0 / SERVER=1 / NOT_STARTED=-1 mode
switching), TokenClientProvider and EmbeddedClusterTokenServerProvider
(SPI lookups in the reference; registries here), ClusterClientConfigManager
(the token server address a client dials).

Server mode: register a
:class:`~sentinel_tpu_torch.cluster.token_service.DefaultTokenService`
(or a :class:`~sentinel_tpu_torch.cluster.server.SentinelTokenServer`,
whose ``service`` the engine asks) with
:class:`EmbeddedClusterTokenServerProvider` and call
:meth:`ClusterStateManager.set_to_server`. Client mode: register a
:class:`~sentinel_tpu_torch.cluster.client.ClusterTokenClient` (or set the
address with :meth:`ClusterClientConfigManager.apply`) and call
:meth:`ClusterStateManager.set_to_client`.
"""

from __future__ import annotations

import threading
from typing import Optional

from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.utils.record_log import record_log


class ClusterStateManager:
    CLUSTER_CLIENT = C.CLUSTER_MODE_CLIENT
    CLUSTER_SERVER = C.CLUSTER_MODE_SERVER
    CLUSTER_NOT_STARTED = C.CLUSTER_MODE_NOT_STARTED

    _mode = C.CLUSTER_MODE_NOT_STARTED
    _lock = threading.RLock()

    @classmethod
    def get_mode(cls) -> int:
        return cls._mode

    @classmethod
    def is_client(cls) -> bool:
        return cls._mode == cls.CLUSTER_CLIENT

    @classmethod
    def is_server(cls) -> bool:
        return cls._mode == cls.CLUSTER_SERVER

    @classmethod
    def set_to_client(cls) -> bool:
        with cls._lock:
            if cls._mode == cls.CLUSTER_CLIENT:
                return True
            cls._mode = cls.CLUSTER_CLIENT
            client = TokenClientProvider.get_client()
            if client is None:
                # No registered client but maybe an assigned server address
                # (the dashboard's assign flow): build one, as the
                # reference's DefaultClusterTokenClient picks up
                # ClusterClientConfigManager on a mode switch.
                client = ClusterClientConfigManager.build_client()
                if client is not None:
                    TokenClientProvider.register(client)
            if client is not None and hasattr(client, "start"):
                try:
                    client.start()
                except Exception:
                    record_log.error("[ClusterStateManager] client start failed", exc_info=True)
            return True

    @classmethod
    def set_to_server(cls) -> bool:
        with cls._lock:
            if cls._mode == cls.CLUSTER_SERVER:
                return True
            cls._mode = cls.CLUSTER_SERVER
            server = EmbeddedClusterTokenServerProvider.get_server()
            if server is not None and hasattr(server, "start"):
                try:
                    server.start()
                except Exception:
                    record_log.error("[ClusterStateManager] server start failed", exc_info=True)
            return True

    @classmethod
    def stop(cls) -> None:
        with cls._lock:
            cls._mode = cls.CLUSTER_NOT_STARTED

    @classmethod
    def apply_state(cls, mode: int) -> bool:
        if mode == cls.CLUSTER_CLIENT:
            return cls.set_to_client()
        if mode == cls.CLUSTER_SERVER:
            return cls.set_to_server()
        cls.stop()
        return True


class ClusterClientConfigManager:
    """Client-side cluster config: the token server address this machine
    talks to (reference: ClusterClientConfigManager, serverHost/serverPort
    pushed by the dashboard's assign flow)."""

    server_host: str = ""
    server_port: int = 0
    request_timeout_ms: int = 200
    # The namespace this client announces on connect: the server's
    # per-namespace connection groups, which AVG_LOCAL thresholds read.
    namespace: str = "default"
    _lock = threading.Lock()

    @classmethod
    def apply(cls, host: str, port: int, timeout_ms: Optional[int] = None, namespace: Optional[str] = None) -> None:
        with cls._lock:
            cls.server_host = host
            cls.server_port = int(port)
            if timeout_ms is not None:
                cls.request_timeout_ms = int(timeout_ms)
            if namespace is not None:
                cls.namespace = namespace

    @classmethod
    def snapshot(cls) -> dict:
        with cls._lock:
            return {
                "serverHost": cls.server_host,
                "serverPort": cls.server_port,
                "requestTimeout": cls.request_timeout_ms,
                "namespace": cls.namespace,
            }

    @classmethod
    def build_client(cls):
        """The token client the current config calls for, its fields read
        under one lock (a concurrent apply() must not give a host of the new
        config with a port of the old). ``sentinel.tpu.cluster.shards`` > 1
        with a complete shards.map builds a
        :class:`~sentinel_tpu_torch.cluster.shards.ShardedTokenClient`; the
        default (1) the single-server
        :class:`~sentinel_tpu_torch.cluster.client.ClusterTokenClient`. None
        when neither a shard map nor a server address is configured."""
        from sentinel_tpu_torch.cluster.client import ClusterTokenClient
        from sentinel_tpu_torch.cluster.shards import ShardedTokenClient, ShardMap

        with cls._lock:
            host, port = cls.server_host, cls.server_port
            timeout_s = cls.request_timeout_ms / 1000.0
            namespace = cls.namespace
        shard_map = ShardMap.from_config(default_host=host)
        if shard_map is not None:
            return ShardedTokenClient(shard_map, request_timeout_sec=timeout_s, namespace=namespace)
        if not host or port <= 0:
            return None
        return ClusterTokenClient(host, port, request_timeout_sec=timeout_s, namespace=namespace)


class TokenClientProvider:
    _client = None
    _lock = threading.Lock()

    @classmethod
    def register(cls, client) -> None:
        with cls._lock:
            cls._client = client

    @classmethod
    def get_client(cls):
        return cls._client

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._client = None


class EmbeddedClusterTokenServerProvider:
    _server = None
    _lock = threading.Lock()

    @classmethod
    def register(cls, server) -> None:
        with cls._lock:
            cls._server = server

    @classmethod
    def get_server(cls):
        return cls._server

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._server = None
