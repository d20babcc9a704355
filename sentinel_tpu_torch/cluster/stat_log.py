"""Cluster server stat log, ClusterServerStatLogUtil (port of
``sentinel_tpu/cluster/stat_log.py``).

The token server stat-logs every decision (e.g. ``concurrent|block|<flowId>``
with a count) into ``sentinel-cluster.log``: the per-second, size-rolled
writer of the block log (metrics/block_log.py), created on first use in
the log directory. :func:`set_logger` swaps the sink. Each line is also
counted in memory, keyed by (category, outcome).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from sentinel_tpu_torch.metrics.block_log import BlockLogger

FILE_NAME = "sentinel-cluster.log"

_lock = threading.Lock()
_logger: Optional[BlockLogger] = None

# In-memory (category, outcome) counters of every line fed to the logger,
# under a lock of their own: counting never waits on the logger's IO.
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


def _get_logger() -> BlockLogger:
    global _logger
    logger = _logger
    if logger is not None:
        return logger
    with _lock:
        if _logger is None:
            _logger = BlockLogger(file_name=FILE_NAME)
        return _logger


def set_logger(logger: Optional[BlockLogger]) -> None:
    """Swap the sink (None: back to ``sentinel-cluster.log`` in the log
    directory, created on the next line)."""
    global _logger
    with _lock:
        _logger = logger


def log(category: str, outcome: str, flow_id: int, count: int = 1) -> None:
    """``log("concurrent", "block", flowId, n)`` is
    ClusterServerStatLogUtil.log("concurrent|block|<id>", n)."""
    _count(category, outcome, count)
    _get_logger().stat(category, outcome, str(int(flow_id)), count=count)


def log_many(items) -> None:
    """Batched :func:`log`: items of (category, outcome, flow_id, count),
    under one lock acquisition of the logger."""
    items = list(items)
    for c, o, _f, n in items:
        _count(c, o, n)
    _get_logger().log_batch([(c, o, str(int(f)), n) for c, o, f, n in items])


def flush() -> None:
    _get_logger().flush()
