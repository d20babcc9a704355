"""Live second-window geometry properties (port of
``sentinel_tpu/metrics/window_properties.py``).

Reference: node/SampleCountProperty.java:26-52 and
node/IntervalProperty.java:26-50: two static SentinelProperty<Integer>
hooks; updating either rebuilds every StatisticNode's rolling second
counter to ``SAMPLE_COUNT`` buckets over ``INTERVAL`` ms and resets its
second-window statistics. Datasources can drive them like any other
property.

Both feed :meth:`Engine.retune_second_window`, which drains the pending
ops against the old geometry, swaps ``nodes.SECOND_CFG`` and rebuilds the
second window and the borrow slab. The kernels take the geometry at call
time, so the next flush runs at the new one.
"""

from __future__ import annotations

import threading
from typing import Optional

from sentinel_tpu_torch.core.property import DynamicSentinelProperty, FuncListener
from sentinel_tpu_torch.utils.record_log import record_log

# Initial value None: registration fires config_load with the current
# value, and a None is a no-op below, so importing this module builds no
# engine.
sample_count_property: DynamicSentinelProperty = DynamicSentinelProperty(None)
interval_property: DynamicSentinelProperty = DynamicSentinelProperty(None)

_lock = threading.Lock()


def _apply(sample_count: Optional[int], interval_ms: Optional[int]) -> None:
    """Combine the updated dimension with the live geometry (the other
    dimension reads whatever is in force, as the reference pairs
    SAMPLE_COUNT with IntervalProperty.INTERVAL)."""
    from sentinel_tpu_torch.core import api
    from sentinel_tpu_torch.metrics import nodes

    with _lock:
        sc = int(sample_count) if sample_count is not None else nodes.SECOND_CFG.sample_count
        iv = int(interval_ms) if interval_ms is not None else nodes.SECOND_CFG.interval_ms
        try:
            api.get_engine().retune_second_window(sc, iv)
            record_log.info("[WindowProperties] second window retuned to %d x %d ms", sc, iv // sc)
        except ValueError as e:
            # SampleCountProperty ignores invalid updates (java:42-49).
            record_log.warn("[WindowProperties] rejected geometry %dx%dms: %s", sc, iv, e)


sample_count_property.add_listener(FuncListener(lambda v: _apply(v, None) if v is not None else None))
interval_property.add_listener(FuncListener(lambda v: _apply(None, v) if v is not None else None))
