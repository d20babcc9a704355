"""metrics (port of ``sentinel_tpu/metrics``).

The package exports the flight recorder's names, as the JAX package's
does; the rest of its exports (the admission trace, the block log, the
provenance ledger, the metric extensions) belong to ROADMAP Queue 1 item 8.
"""

from sentinel_tpu_torch.metrics.histogram import LatencyHistogram
from sentinel_tpu_torch.metrics.telemetry import FlushSpan, SpaceSaving, TelemetryBus, spans_to_trace

__all__ = ["FlushSpan", "LatencyHistogram", "SpaceSaving", "TelemetryBus", "spans_to_trace"]
