"""Metric event channels.

Order mirrors the reference's MetricEvent enum (reference:
sentinel-core/.../slots/statistic/MetricEvent.java:26-38) so an event id
is directly the last-axis index of the counter tensor.
"""

from __future__ import annotations

import enum


class MetricEvent(enum.IntEnum):
    PASS = 0
    BLOCK = 1
    EXCEPTION = 2
    SUCCESS = 3
    RT = 4
    OCCUPIED_PASS = 5


NUM_EVENTS = len(MetricEvent)
