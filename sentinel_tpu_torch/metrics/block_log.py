"""Block log: the LogSlot -> EagleEye StatLogger pipeline, batched (port
of ``sentinel_tpu/metrics/block_log.py``).

Reference: LogSlot catches the BlockException and stat-logs (resource,
exceptionName, ruleLimitApp, origin) with the blocked count
(slots/logger/LogSlot.java:31-40, EagleEyeLogUtil.java:20-40); the
EagleEye StatLogger aggregates per 1 s interval keyed by the tuple and
writes one line per key per interval to a size-rolled
``sentinel-block.log`` (line layout ``time|statType|key,key,...|value``).

The engine produces blocked verdicts a flush at a time, so the aggregation
is a dict update per flush; completed seconds are written when a later
second rolls in (or on :meth:`flush`). Rolling keeps ``max_backup_index``
shifted backups like EagleEyeRollingFileAppender. A flush's bulk groups
hand their items over as columns (:class:`BlockColumns`), which
:meth:`BlockLogger.log_parts` takes beside item tuples in one call.
"""

from __future__ import annotations

import os
import threading
from itertools import repeat
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from sentinel_tpu_torch.utils.clock import Clock, default_clock
from sentinel_tpu_torch.utils.record_log import log_dir, record_log

FILE_NAME = "sentinel-block.log"

# (resource, exception_name, rule_limit_app, origin)
BlockKey = Tuple[str, str, str, str]

class BlockColumns:
    """Block-log items as columns: item ``j`` is the key (resources[g],
    names[r], limit app, origins[g]) with g = ``group[j]`` and r =
    ``reason[j]``, and the count ``counts[j]``. The limit apps are a list,
    or None where every item's is "default". Key parts are strings."""

    __slots__ = ("resources", "origins", "names", "group", "reason", "limit_apps", "counts")

    def __init__(self, resources: Sequence[str], origins: Sequence[str], names: Sequence[str], group: np.ndarray,
                 reason: np.ndarray, limit_apps: Optional[List[str]], counts: np.ndarray) -> None:
        self.resources, self.origins, self.names = resources, origins, names
        self.group, self.reason, self.limit_apps, self.counts = group, reason, limit_apps, counts

    def __len__(self) -> int:
        return len(self.counts)

    def keys(self):
        """The items' keys, in order."""
        g = self.group.tolist()
        las = repeat("default") if self.limit_apps is None else self.limit_apps
        return zip(map(self.resources.__getitem__, g), map(self.names.__getitem__, self.reason.tolist()), las,
                   map(self.origins.__getitem__, g))


_live_loggers: "weakref.WeakSet[BlockLogger]" = None  # type: ignore[assignment]


def _init_atexit() -> None:
    global _live_loggers
    import atexit
    import weakref

    _live_loggers = weakref.WeakSet()

    def _flush_all() -> None:
        for logger in list(_live_loggers):
            try:
                logger.flush()
            except Exception:
                pass

    atexit.register(_flush_all)


_init_atexit()


class BlockLogger:
    """Per-second aggregated block log with size-rolled output."""

    STAT_TYPE = "count"

    def __init__(
        self,
        base_dir: Optional[str] = None,
        file_name: str = FILE_NAME,
        interval_ms: int = 1000,
        max_entry_count: int = 6000,
        max_file_size: int = 300 * 1024 * 1024,
        max_backup_index: int = 3,
        clock: Optional[Clock] = None,
    ) -> None:
        self.base_dir = base_dir or log_dir()
        self.path = os.path.join(self.base_dir, file_name)
        self.interval_ms = interval_ms
        self.max_entry_count = max_entry_count
        self.max_file_size = max_file_size
        self.max_backup_index = max_backup_index
        self.clock = clock or default_clock()
        self._lock = threading.Lock()
        self._cur_sec: Optional[int] = None  # wall-ms aligned interval start
        self._entries: Dict[BlockKey, int] = {}
        # The last partial interval must survive process exit — an
        # operator investigating an incident reads this file. One
        # process-level hook over a weak set: discarded loggers are
        # collectable, not pinned by the atexit registry.
        _live_loggers.add(self)

    # ------------------------------------------------------------------
    def log(
        self,
        resource: str,
        exception_name: str,
        rule_limit_app: str = "default",
        origin: str = "",
        count: int = 1,
        now_wall_ms: Optional[int] = None,
    ) -> None:
        self.log_batch(
            [(resource, exception_name, rule_limit_app, origin, count)], now_wall_ms
        )

    def log_blocked(
        self,
        resource: str,
        reason_code: int,
        rule_limit_app: str = "default",
        origin: str = "",
        count: int = 1,
        now_wall_ms: Optional[int] = None,
    ) -> None:
        """Log a blocked verdict by its REASON CODE — the name comes
        from the one shared mapping (core/errors.BLOCK_EXC_NAMES), so a
        caller holding a verdict tensor's reason never spells the
        exception name by hand (and a new BLOCK_* code can't silently
        log under a divergent name)."""
        from sentinel_tpu_torch.core.errors import exc_name_for_code

        self.log(
            resource, exc_name_for_code(reason_code), rule_limit_app,
            origin, count, now_wall_ms,
        )

    def log_batch(
        self,
        items: Iterable[Tuple],
        now_wall_ms: Optional[int] = None,
    ) -> None:
        """One lock acquisition for a whole flush's items. Each item is
        ``(*key_parts, count)`` — key arity is free (the block log uses
        4 parts; the cluster stat log uses whatever the tag needs,
        StatLogger.stat(...) style)."""
        self.log_parts([items], now_wall_ms)

    def log_parts(self, parts: Sequence[Union[Iterable[Tuple], BlockColumns]],
                  now_wall_ms: Optional[int] = None) -> None:
        """:meth:`log_batch` over several parts in order, in one interval
        and one lock acquisition: each part is an iterable of item tuples or
        a :class:`BlockColumns` (the engine's bulk groups)."""
        now = self.clock.wall_ms() if now_wall_ms is None else now_wall_ms
        aligned = now - now % self.interval_ms
        with self._lock:
            if self._cur_sec is not None and aligned > self._cur_sec:
                self._write_locked()
            if self._cur_sec is None or aligned > self._cur_sec:
                self._cur_sec = aligned
            entries = self._entries
            room = self.max_entry_count - len(entries)
            for part in parts:
                if isinstance(part, BlockColumns):
                    pairs = zip(part.keys(), part.counts.tolist())
                else:
                    pairs = ((tuple(map(str, item[:-1])), int(item[-1])) for item in part)
                for key, count in pairs:
                    if key in entries:
                        entries[key] += count
                    elif room > 0:  # maxEntryCount cap: drop new keys, keep hot ones
                        entries[key] = count
                        room -= 1

    def stat(self, *key_parts: str, count: int = 1,
             now_wall_ms: Optional[int] = None) -> None:
        """StatLogger.stat(keys...).count(n) shorthand."""
        self.log_batch([(*key_parts, count)], now_wall_ms)

    def flush(self) -> None:
        """Force-write the current interval (tests / shutdown)."""
        with self._lock:
            self._write_locked()

    def maybe_flush(self, now_wall_ms: Optional[int] = None) -> None:
        """Write the pending interval if it has completed — called by
        the engine after each flush so a burst followed by quiet still
        reaches disk without waiting for the next blocked request."""
        now = self.clock.wall_ms() if now_wall_ms is None else now_wall_ms
        with self._lock:
            if (
                self._entries
                and self._cur_sec is not None
                and now - now % self.interval_ms > self._cur_sec
            ):
                self._write_locked()

    # ------------------------------------------------------------------
    def _write_locked(self) -> None:
        if not self._entries or self._cur_sec is None:
            self._entries = {}
            return
        lines: List[str] = []
        for key_parts, count in self._entries.items():
            key = ",".join(key_parts)
            lines.append(f"{self._cur_sec}|{self.STAT_TYPE}|{key}|{count}\n")
        self._entries = {}
        try:
            self._roll_if_needed()
            os.makedirs(self.base_dir, exist_ok=True)
            with open(self.path, "a", encoding="utf-8") as f:
                f.writelines(lines)
        except OSError:
            record_log.error("[BlockLogger] write failed", exc_info=True)

    def _roll_if_needed(self) -> None:
        try:
            if os.path.getsize(self.path) < self.max_file_size:
                return
        except OSError:
            return
        # Shift backups: .2 -> .3, .1 -> .2, base -> .1 (rolling appender).
        for i in range(self.max_backup_index - 1, 0, -1):
            src, dst = f"{self.path}.{i}", f"{self.path}.{i + 1}"
            if os.path.exists(src):
                os.replace(src, dst)
        os.replace(self.path, f"{self.path}.1")

    # ------------------------------------------------------------------
    def read_entries(self) -> List[Tuple[int, BlockKey, int]]:
        """Parse the log back: [(interval_start_ms, key, count)] —
        test/introspection helper."""
        out: List[Tuple[int, BlockKey, int]] = []
        try:
            with open(self.path, encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split("|")
                    if len(parts) != 4:
                        continue
                    ts, _stat, key, count = parts
                    fields = key.split(",")
                    out.append((int(ts), tuple(fields), int(count)))  # type: ignore[arg-type]
        except OSError:
            pass
        return out
