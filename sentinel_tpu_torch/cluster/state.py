"""Cluster mode state and providers (port of
``sentinel_tpu/cluster/state.py``).

Reference: ClusterStateManager (CLIENT=0 / SERVER=1 / NOT_STARTED=-1 mode
switching), TokenClientProvider and EmbeddedClusterTokenServerProvider
(SPI lookups in the reference; registries here).

The port runs the embedded server: register a
:class:`~sentinel_tpu_torch.cluster.token_service.DefaultTokenService`
(or an object with a ``service`` attribute holding one) with
:class:`EmbeddedClusterTokenServerProvider` and call
:meth:`ClusterStateManager.set_to_server`. Client mode needs the TCP
client, connection and shards, which are not ported: ``set_to_client``
raises.
"""

from __future__ import annotations

import threading

from sentinel_tpu_torch.models import constants as C
from sentinel_tpu_torch.utils.record_log import record_log

_ROADMAP_CLIENT = (
    "ROADMAP Queue 1 item 9 (cluster token plane: protocol, server, client, connection, shards, "
    "gossip transport, envoy_rls)"
)


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
        raise NotImplementedError(f"sentinel_tpu_torch: cluster client mode is not ported yet ({_ROADMAP_CLIENT})")

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


class TokenClientProvider:
    """The registry of the token client (the client itself is not ported;
    nothing reads this registry while client mode cannot be entered)."""

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
