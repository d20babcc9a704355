"""Cluster server stat log, ClusterServerStatLogUtil (port of
``sentinel_tpu/cluster/stat_log.py``).

The token server stat-logs every decision (e.g. ``concurrent|block|<flowId>``
with a count). Here each line is counted in memory, keyed by (category,
outcome), and handed to a sink when one is set with :func:`set_logger`
(an object with the JAX package's BlockLogger surface: ``stat``,
``log_batch``, ``flush``). The port has no file sink yet: the
per-second, size-rolled ``sentinel-cluster.log`` writer is the block
logger of ROADMAP Queue 1 item 8 (metrics and observability). Without a
sink the lines go nowhere, so the port writes no file of its own.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

_lock = threading.Lock()
_logger = None

_counts_lock = threading.Lock()
_counts: Dict[Tuple[str, str], int] = {}


def _count(category: str, outcome: str, n: int) -> None:
    key = (category, outcome)
    with _counts_lock:
        _counts[key] = _counts.get(key, 0) + n


def counters_snapshot() -> Dict[str, int]:
    """{"category.outcome": count} for every line logged since the last
    reset."""
    with _counts_lock:
        return {f"{c}.{o}": n for (c, o), n in _counts.items()}


def reset_counters() -> None:
    with _counts_lock:
        _counts.clear()


def set_logger(logger: Optional[object]) -> None:
    """Set (or clear, with None) the sink of the log lines."""
    global _logger
    with _lock:
        _logger = logger


def log(category: str, outcome: str, flow_id: int, count: int = 1) -> None:
    """``log("concurrent", "block", flowId, n)`` is
    ClusterServerStatLogUtil.log("concurrent|block|<id>", n)."""
    _count(category, outcome, count)
    logger = _logger
    if logger is not None:
        logger.stat(category, outcome, str(int(flow_id)), count=count)


def log_many(items) -> None:
    """Batched :func:`log`: items of (category, outcome, flow_id, count)."""
    items = list(items)
    for c, o, _f, n in items:
        _count(c, o, n)
    logger = _logger
    if logger is not None:
        logger.log_batch([(c, o, str(int(f)), n) for c, o, f, n in items])


def flush() -> None:
    logger = _logger
    if logger is not None:
        logger.flush()
