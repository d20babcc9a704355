"""metrics (port of ``sentinel_tpu/metrics``): the statistics windows, the
flight recorder, and the metric plane (the admission trace, the block log,
the provenance ledger, the metric extensions, the metric log)."""

from sentinel_tpu_torch.metrics.admission_trace import (
    AdmissionRecord,
    AdmissionTracer,
    TraceContext,
    inject_trace_headers,
    parse_traceparent,
)
from sentinel_tpu_torch.metrics.block_log import BlockLogger
from sentinel_tpu_torch.metrics.events import NUM_EVENTS, MetricEvent
from sentinel_tpu_torch.metrics.extension import MetricExtension, MetricExtensionProvider
from sentinel_tpu_torch.metrics.histogram import LatencyHistogram
from sentinel_tpu_torch.metrics.metric_array import (
    MetricArrayConfig,
    MetricArrayState,
    bucket_windows,
    grow,
    make_state,
    update,
    window_min_rt,
    window_sums,
)
from sentinel_tpu_torch.metrics.provenance import OTHER_RESOURCE, ResourceProvenance
from sentinel_tpu_torch.metrics.telemetry import FlushSpan, SpaceSaving, TelemetryBus, spans_to_trace

__all__ = [
    "AdmissionRecord",
    "AdmissionTracer",
    "TraceContext",
    "inject_trace_headers",
    "parse_traceparent",
    "BlockLogger",
    "FlushSpan",
    "LatencyHistogram",
    "MetricExtension",
    "MetricExtensionProvider",
    "OTHER_RESOURCE",
    "ResourceProvenance",
    "SpaceSaving",
    "TelemetryBus",
    "spans_to_trace",
    "MetricEvent",
    "NUM_EVENTS",
    "MetricArrayConfig",
    "MetricArrayState",
    "make_state",
    "update",
    "window_sums",
    "window_min_rt",
    "bucket_windows",
    "grow",
]
