"""Cluster flow control: the distributed backend (port of
``sentinel_tpu/cluster/``).

Reference: ClusterFlowChecker.java:36-118, DefaultTokenService.java:36-84,
GlobalRequestLimiter, ClusterFlowRuleManager, ClusterServerConfigManager,
ConcurrentClusterFlowChecker; client side DefaultClusterTokenClient +
NettyTransportClient; wire constants ClusterConstants.java:24-41.

Two deployment shapes:

1. **Embedded token service** (:mod:`token_service`): the token decision
   runs in-process, its decision pass K12 written for the card
   (``csrc/token_decide.cu``); the engine asks it for cluster-mode rules
   when this node is the token server (:class:`ClusterStateManager`).
2. **TCP token server and client** (:mod:`protocol`, :mod:`server`,
   :mod:`client`, :mod:`connection`): a length-framed binary protocol with
   xid correlation, batch frames, local quota leases and a client
   micro-window, byte for byte the JAX package's; hash-partitioned over
   several servers by :mod:`shards`. :mod:`gossip` carries the sketch
   tier's count-min frames between engines over the same framing.

The Envoy RLS front end (``envoy_rls.py``) waits for the adapters
(ROADMAP Queue 1 item 11).
"""

from sentinel_tpu_torch.cluster.flow_rules import cluster_flow_rule_manager, cluster_server_config_manager
from sentinel_tpu_torch.cluster.shards import ShardedTokenClient, ShardMap, shard_of
from sentinel_tpu_torch.cluster.state import (
    ClusterStateManager,
    EmbeddedClusterTokenServerProvider,
    TokenClientProvider,
)
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService, TokenResult, TokenService

__all__ = [
    "ClusterStateManager",
    "TokenClientProvider",
    "EmbeddedClusterTokenServerProvider",
    "TokenResult",
    "TokenService",
    "DefaultTokenService",
    "ShardMap",
    "ShardedTokenClient",
    "shard_of",
    "cluster_flow_rule_manager",
    "cluster_server_config_manager",
]
