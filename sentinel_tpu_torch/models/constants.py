"""Rule and framework constants.

Values mirror the reference exactly so serialized rules interoperate
(reference: sentinel-core/.../slots/block/RuleConstant.java:26-66,
Constants.java:36-66, EntryType.java).
"""

from __future__ import annotations

import enum

# --- flow rule grades (RuleConstant.java:27-28) ---
FLOW_GRADE_THREAD = 0
FLOW_GRADE_QPS = 1

# --- degrade grades (RuleConstant.java:30-37) ---
DEGRADE_GRADE_RT = 0
DEGRADE_GRADE_EXCEPTION_RATIO = 1
DEGRADE_GRADE_EXCEPTION_COUNT = 2

DEGRADE_DEFAULT_SLOW_REQUEST_AMOUNT = 5
DEGRADE_DEFAULT_MIN_REQUEST_AMOUNT = 5

# --- authority (RuleConstant.java:42-43) ---
AUTHORITY_WHITE = 0
AUTHORITY_BLACK = 1

# --- flow relation strategy (RuleConstant.java:45-47) ---
STRATEGY_DIRECT = 0
STRATEGY_RELATE = 1
STRATEGY_CHAIN = 2

# --- traffic shaping behavior (RuleConstant.java:49-52) ---
CONTROL_BEHAVIOR_DEFAULT = 0
CONTROL_BEHAVIOR_WARM_UP = 1
CONTROL_BEHAVIOR_RATE_LIMITER = 2
CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER = 3

# --- cluster acquire-refuse / resource-timeout strategies (RuleConstant.java:54-61) ---
DEFAULT_BLOCK_STRATEGY = 0
TRY_AGAIN_BLOCK_STRATEGY = 1
TRY_UNTIL_SUCCESS_BLOCK_STRATEGY = 2
DEFAULT_RESOURCE_TIMEOUT_STRATEGY = 0
RELEASE_RESOURCE_TIMEOUT_STRATEGY = 1
KEEP_RESOURCE_TIMEOUT_STRATEGY = 2

LIMIT_APP_DEFAULT = "default"
LIMIT_APP_OTHER = "other"

# --- statistic defaults (RuleConstant.java:65-66, StatisticNode.java:90-112) ---
DEFAULT_SAMPLE_COUNT = 2
DEFAULT_WINDOW_INTERVAL_MS = 1000
MINUTE_SAMPLE_COUNT = 60
MINUTE_INTERVAL_MS = 60_000

# --- scale caps (Constants.java:36-37) ---
MAX_CONTEXT_NAME_SIZE = 2000
MAX_SLOT_CHAIN_SIZE = 6000

# --- well-known names (Constants.java:41-66) ---
ROOT_ID = "machine-root"
CONTEXT_DEFAULT_NAME = "sentinel_default_context"
TOTAL_IN_RESOURCE_NAME = "__total_inbound_traffic__"
SYSTEM_LOAD_RESOURCE_NAME = "__system_load__"
CPU_USAGE_RESOURCE_NAME = "__cpu_usage__"

# Reference: Constants.java TIME_DROP_VALVE = 4900 (max recorded RT).
DEFAULT_STATISTIC_MAX_RT = 4900

# --- hot-param defaults (ParamFlowRule.java / ParameterMetric.java:37-38) ---
PARAM_FLOW_DEFAULT_CACHE_SIZE = 4000


class EntryType(enum.IntEnum):
    """Resource invocation direction (reference: EntryType.java).

    Only ``IN`` traffic is guarded by system rules
    (SystemSlot/SystemRuleManager.checkSystem).
    """

    IN = 0
    OUT = 1


class ResourceType(enum.IntEnum):
    """Classification of resources (reference: ResourceTypeConstants.java)."""

    COMMON = 0
    WEB = 1
    RPC = 2
    GATEWAY = 3
    DB_SQL = 4


# --- cluster constants (sentinel-cluster-common-default/.../ClusterConstants.java:24-41) ---
MSG_TYPE_PING = 0
MSG_TYPE_FLOW = 1
MSG_TYPE_PARAM_FLOW = 2
MSG_TYPE_CONCURRENT_FLOW_ACQUIRE = 3
MSG_TYPE_CONCURRENT_FLOW_RELEASE = 4
# This framework's batched extension (not in the reference codec): one
# frame carries a whole admission window's worth of token requests.
MSG_TYPE_FLOW_BATCH = 16
MSG_TYPE_PARAM_FLOW_BATCH = 17
# Sketch gossip (this framework's own): engines exchange count-min
# arrays + candidate tables so heavy hitters are detected fleet-wide.
MSG_TYPE_SKETCH_PUSH = 18
MSG_TYPE_SKETCH_MERGED = 19
# Shard introspection (this framework's own): one round trip returns
# the server's work clocks / stat-log counters as a JSON snapshot so
# per-shard state is readable outside the bench harness.
MSG_TYPE_STATS = 20

FLOW_THRESHOLD_AVG_LOCAL = 0
FLOW_THRESHOLD_GLOBAL = 1

CLUSTER_MODE_CLIENT = 0
CLUSTER_MODE_SERVER = 1
CLUSTER_MODE_NOT_STARTED = -1


class TokenResultStatus(enum.IntEnum):
    """Cluster token request outcome (reference: sentinel-core/.../cluster/
    TokenResultStatus.java)."""

    BAD_REQUEST = -4
    TOO_MANY_REQUEST = -2
    FAIL = -1
    OK = 0
    BLOCKED = 1
    SHOULD_WAIT = 2
    NO_RULE_EXISTS = 3
    NO_REF_RULE_EXISTS = 4
    NOT_AVAILABLE = 5
    RELEASE_OK = 6
    ALREADY_RELEASE = 7
