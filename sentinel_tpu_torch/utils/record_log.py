"""Internal record log (the RecordLog of the reference,
sentinel-core/.../log/RecordLog.java).

A stdlib ``logging`` logger named ``sentinel_tpu_torch.record``. It
writes nowhere by itself: an application that wants the record on disk
attaches its own handler, so importing or running the port never
creates files outside the caller's control.
"""

from __future__ import annotations

import logging

_logger = logging.getLogger("sentinel_tpu_torch.record")
_logger.addHandler(logging.NullHandler())


class _RecordLog:
    """API shape of RecordLog.info/warn/error(fmt, *args)."""

    def info(self, msg: str, *args: object) -> None:
        _logger.info(msg, *args)

    def warn(self, msg: str, *args: object) -> None:
        _logger.warning(msg, *args)

    def error(self, msg: str, *args: object, exc_info: bool = False) -> None:
        _logger.error(msg, *args, exc_info=exc_info)

    def debug(self, msg: str, *args: object) -> None:
        _logger.debug(msg, *args)


record_log = _RecordLog()


def log_dir() -> str:
    """The directory of the log files the metric plane writes (the block
    log, the metric log, the cluster stat log): ``csp.sentinel.log.dir``,
    else ``$SENTINEL_TPU_LOG_DIR``, else ``~/logs/csp``, as in the JAX
    package. The record log itself writes nowhere."""
    import os

    from sentinel_tpu_torch.utils.config import config

    d = config.get(config.LOG_DIR) or os.environ.get("SENTINEL_TPU_LOG_DIR")
    return d or os.path.join(os.path.expanduser("~"), "logs", "csp")
