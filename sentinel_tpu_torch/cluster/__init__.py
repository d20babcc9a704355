"""Cluster flow control: the embedded token service (port of
``sentinel_tpu/cluster/``).

Reference: ClusterFlowChecker.java:36-118, DefaultTokenService.java:36-84,
GlobalRequestLimiter, ClusterFlowRuleManager, ClusterServerConfigManager,
ConcurrentClusterFlowChecker.

The port has the embedded deployment: the token decision runs in-process
(:mod:`token_service`, with the decision pass K12 written for the card),
and the engine asks it for cluster-mode rules when this node is the
token server (:class:`ClusterStateManager`). The TCP protocol, server and
client, the connection groups, the shards, the gossip transport and the
Envoy RLS front end are ROADMAP Queue 1 item 9's remaining work.
"""

from sentinel_tpu_torch.cluster.flow_rules import cluster_flow_rule_manager, cluster_server_config_manager
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
    "cluster_flow_rule_manager",
    "cluster_server_config_manager",
]
