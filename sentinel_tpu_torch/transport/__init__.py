"""Transport plane: command center + heartbeat (port of
``sentinel_tpu/transport``).

Equivalent of sentinel-transport (reference: sentinel-transport-common
CommandHandler/@CommandMapping/CommandCenter SPI + ~18 built-in
handlers; sentinel-transport-simple-http's raw-socket HTTP server;
heartbeat/SimpleHttpHeartbeatSender.java:36-65). The command center
exposes rule CRUD, metric pull, node introspection and cluster-mode
switches over plain HTTP for the dashboard.
"""

from sentinel_tpu_torch.transport.command_center import (
    CommandCenter,
    command_mapping,
    CommandRequest,
    CommandResponse,
)
from sentinel_tpu_torch.transport.heartbeat import HeartbeatSender

__all__ = [
    "CommandCenter",
    "command_mapping",
    "CommandRequest",
    "CommandResponse",
    "HeartbeatSender",
]
