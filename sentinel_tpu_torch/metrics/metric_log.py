"""Metric log pipeline: per-second aggregation, rolled files, search (port
of ``sentinel_tpu/metrics/metric_log.py``).

Reference: MetricTimerListener (node/metric/MetricTimerListener.java:34-70)
aggregates every ClusterNode and the global ENTRY_NODE once per second
into MetricNode lines; MetricWriter (MetricWriter.java:47-94) writes
size-rolled ``{app}-metrics.log.N`` files with ``.idx`` second->offset
index files; MetricSearcher reads them back by time range for the
dashboard's /metric pull (SendMetricCommandHandler.java:41-89).

Line format, MetricNode.toThinString's order::

    timestamp|yyyy-MM-dd HH:mm:ss|resource|passQps|blockQps|successQps|
    exceptionQps|rt|occupiedPassQps|concurrency|classification

**Versioning rule**: the format above is version 1 (11 fields, no tag).
Later versions append a numeric version tag as field 12 and that
version's columns, and never reorder or remove the first fields, so a v1
parser reads v2 files and this reader reads v1 files (a missing tail is
zeros). Version 2 appends the provenance columns
(metrics/provenance.py)::

    ...|classification|2|speculativeQps|degradedQps|shedQps|drift

``speculative``/``degraded``/``shed`` are acquire-weighted per-second
serves by verdict provenance (a speculative serve while DEGRADED counts in
both); ``drift`` is the signed net over-admit of the speculative tier.
Every column is attributed to each op's submit-ts second.

On the card, :meth:`MetricTimer.collect` reads the minute window through
K17 (``metric_array.bucket_read``, ``csrc/bucket_read.cu``): one launch,
no memset and one copy back a steady pull, for the asked rows' seconds
only.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from sentinel_tpu_torch.metrics.events import MetricEvent
from sentinel_tpu_torch.utils.config import config
from sentinel_tpu_torch.utils.record_log import log_dir, record_log


@dataclass
class MetricNodeLine:
    """One (second, resource) aggregate (reference: node/metric/MetricNode.java)."""

    timestamp: int  # wall ms, second-aligned
    resource: str
    pass_qps: int = 0
    block_qps: int = 0
    success_qps: int = 0
    exception_qps: int = 0
    rt: float = 0.0
    occupied_pass_qps: int = 0
    concurrency: int = 0
    classification: int = 0
    # v2 provenance columns (see module doc): acquire-weighted serves
    # by verdict provenance, plus signed net speculative over-admit.
    speculative_qps: int = 0
    degraded_qps: int = 0
    shed_qps: int = 0
    drift: int = 0

    SEPARATOR = "|"
    # Written format version; readers accept any ≤ this (missing tail
    # columns parse as zeros) per the versioning rule in the module doc.
    FORMAT_VERSION = 2

    def to_line(self) -> str:
        ts_str = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(self.timestamp / 1000))
        resource = self.resource.replace("|", "_")
        return self.SEPARATOR.join(
            str(x)
            for x in (
                self.timestamp,
                ts_str,
                resource,
                self.pass_qps,
                self.block_qps,
                self.success_qps,
                self.exception_qps,
                round(self.rt, 1),
                self.occupied_pass_qps,
                self.concurrency,
                self.classification,
                self.FORMAT_VERSION,
                self.speculative_qps,
                self.degraded_qps,
                self.shed_qps,
                self.drift,
            )
        )

    @classmethod
    def from_line(cls, line: str) -> Optional["MetricNodeLine"]:
        parts = line.rstrip("\n").split(cls.SEPARATOR)
        if len(parts) < 11:
            return None
        try:
            node = cls(
                timestamp=int(parts[0]),
                resource=parts[2],
                pass_qps=int(parts[3]),
                block_qps=int(parts[4]),
                success_qps=int(parts[5]),
                exception_qps=int(parts[6]),
                rt=float(parts[7]),
                occupied_pass_qps=int(parts[8]),
                concurrency=int(parts[9]),
                classification=int(parts[10]),
            )
        except ValueError:
            return None
        # Versioned extension tail: a malformed/unknown tail degrades to
        # the seed view of the line, never to a dropped line. All four
        # columns parse before any assigns — a mid-tail corruption must
        # not leave a half-applied hybrid of the two views.
        if len(parts) >= 16:
            try:
                if int(parts[11]) >= 2:
                    spec, degr, shed, drift = (
                        int(parts[12]), int(parts[13]), int(parts[14]),
                        int(parts[15]),
                    )
                    node.speculative_qps = spec
                    node.degraded_qps = degr
                    node.shed_qps = shed
                    node.drift = drift
            except ValueError:
                pass
        return node


class MetricWriter:
    """Size-rolled metric log files + second index."""

    def __init__(
        self,
        base_dir: Optional[str] = None,
        app_name: Optional[str] = None,
        single_file_size: Optional[int] = None,
        total_file_count: Optional[int] = None,
    ) -> None:
        self.base_dir = base_dir or log_dir()
        self.app_name = app_name or config.app_name
        self.single_file_size = single_file_size or config.get_int(
            config.SINGLE_METRIC_FILE_SIZE, 50 * 1024 * 1024
        )
        self.total_file_count = total_file_count or config.get_int(
            config.TOTAL_METRIC_FILE_COUNT, 6
        )
        self._lock = threading.Lock()
        self._cur_path: Optional[str] = None
        os.makedirs(self.base_dir, exist_ok=True)

    @property
    def base_name(self) -> str:
        return os.path.join(self.base_dir, f"{self.app_name}-metrics.log")

    def _list_files(self) -> List[str]:
        prefix = os.path.basename(self.base_name)
        try:
            names = sorted(
                n
                for n in os.listdir(self.base_dir)
                if n.startswith(prefix) and not n.endswith(".idx")
            )
        except OSError:
            return []
        return [os.path.join(self.base_dir, n) for n in names]

    def _next_file(self) -> str:
        files = self._list_files()
        idx = len(files) + 1
        while True:
            path = f"{self.base_name}.{idx}"
            if not os.path.exists(path):
                return path
            idx += 1

    def _roll_if_needed(self) -> str:
        if self._cur_path is None:
            files = self._list_files()
            self._cur_path = files[-1] if files else f"{self.base_name}.1"
        try:
            size = os.path.getsize(self._cur_path)
        except OSError:
            size = 0
        if size >= self.single_file_size:
            self._cur_path = self._next_file()
            # The new file is about to be created: prune to count-1 now
            # so the total stays within the cap after the first append.
            self._cleanup(self.total_file_count - 1)
        return self._cur_path

    def _cleanup(self, keep: Optional[int] = None) -> None:
        keep = self.total_file_count if keep is None else keep
        files = self._list_files()
        while len(files) > keep:
            victim = files.pop(0)
            for p in (victim, victim + ".idx"):
                try:
                    os.remove(p)
                except OSError:
                    pass

    def write(self, ts_ms: int, nodes: List[MetricNodeLine]) -> None:
        if not nodes:
            return
        with self._lock:
            path = self._roll_if_needed()
            try:
                with open(path, "a", encoding="utf-8") as f:
                    offset = f.tell()
                    for n in nodes:
                        f.write(n.to_line() + "\n")
                with open(path + ".idx", "a", encoding="utf-8") as f:
                    f.write(f"{ts_ms // 1000 * 1000} {offset}\n")
            except OSError:
                record_log.error("[MetricWriter] write failed", exc_info=True)


class MetricSearcher:
    """Read metric lines back by time range (MetricSearcher.java).

    Uses each file's ``.idx`` second→offset index to seek past batches
    that end before the requested range — the reference's
    MetricSearcher does the same offset binary search; without it a
    range query near "now" re-reads every rolled file from byte 0.
    Every line is still range-filtered after the seek, so a missing or
    stale index only costs speed, never correctness.
    """

    def __init__(self, base_dir: Optional[str] = None, app_name: Optional[str] = None) -> None:
        self.writer_view = MetricWriter(base_dir=base_dir, app_name=app_name)

    @staticmethod
    def _start_offset(path: str, begin_ms: int) -> int:
        """Byte offset to start scanning ``path`` from: the smallest
        offset of an index entry whose (second-aligned, last-in-batch)
        timestamp is >= the second of ``begin_ms`` — any line with
        ``ts >= begin_ms`` lives in such a batch, because a batch's
        recorded second is its newest line's second. When every indexed
        batch ends before the range, the LAST indexed batch's offset is
        returned rather than skipping the file: a data append whose
        paired ``.idx`` append failed (disk full, crash between the two
        writes) leaves un-indexed trailing lines, and those can only
        live past the last index entry — so the index still skips every
        earlier batch but never costs correctness. 0 when the index is
        absent/unusable (full scan)."""
        begin_sec = begin_ms // 1000 * 1000
        start = -1
        last = 0
        seen = False
        try:
            with open(path + ".idx", "r", encoding="utf-8") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) != 2:
                        return 0
                    sec, off = int(parts[0]), int(parts[1])
                    seen = True
                    last = max(last, off)
                    if sec >= begin_sec and (start < 0 or off < start):
                        start = off
        except (OSError, ValueError):
            return 0
        if not seen:
            return 0
        return start if start >= 0 else last

    def find(
        self,
        begin_ms: int,
        end_ms: int,
        resource: Optional[str] = None,
        max_lines: int = 12000,
    ) -> List[MetricNodeLine]:
        out: List[MetricNodeLine] = []
        for path in self.writer_view._list_files():
            start = self._start_offset(path, begin_ms)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    if start:
                        f.seek(start)
                    for line in f:
                        node = MetricNodeLine.from_line(line)
                        if node is None:
                            continue
                        if node.timestamp < begin_ms or node.timestamp > end_ms:
                            continue
                        if resource is not None and node.resource != resource:
                            continue
                        out.append(node)
                        if len(out) >= max_lines:
                            return out
            except OSError:
                continue
        return out


class MetricTimer:
    """The scheduled aggregator (MetricTimerListener): every second,
    read the past seconds' buckets from the engine's minute window for
    every resource (+ the global inbound node) and append them to the
    metric log. The read is :func:`metric_array.bucket_read` (K17 on the
    card, its buffers kept from pull to pull), never a copy of the whole
    window."""

    def __init__(self, engine, writer: Optional[MetricWriter] = None, interval_sec: float = 1.0):
        self.engine = engine
        self.writer = writer or MetricWriter()
        self.interval = interval_sec
        self._last_written_sec = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricTimer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="sentinel-metric-timer", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.run_once()
            except Exception:
                record_log.error("[MetricTimer] aggregation failed", exc_info=True)

    def run_once(self) -> List[MetricNodeLine]:
        """Aggregate complete seconds since the last run; returns what
        was written (also the unit-test surface)."""
        lines = self.collect()
        if lines:
            self.writer.write(lines[-1].timestamp, lines)
        return lines

    def collect(self) -> List[MetricNodeLine]:
        engine = self.engine
        engine.flush()
        # Settle every dispatched-but-unfetched flush before reading:
        # window updates land at each op's SUBMIT ts, so once the
        # pipeline is drained a completed second's buckets are final —
        # without this, depth-K pipelining leaves the newest second's
        # in-flight ops invisible to exactly one pull and their counts
        # are then lost behind _last_written_sec (QPS smeared/dropped
        # across seconds). One coalesced fetch per pull, off the hot
        # path.
        engine.drain()
        now_rel = engine.clock.now_ms()
        # Complete seconds only (the current second is still filling).
        upto = now_rel // 1000 * 1000
        begin = max(self._last_written_sec, upto - 60_000 + 1000)
        if begin >= upto:
            return []
        rows: List[Tuple[str, int]] = [("__total_inbound_traffic__", engine.nodes.entry_node_row)]
        rows += engine.nodes.resources()
        from sentinel_tpu_torch.metrics import metric_array as ma
        from sentinel_tpu_torch.metrics.nodes import MINUTE_CFG

        # Under the flush lock and on the engine's stream: the flushes
        # update the windows in place. On the card K17 reads the asked
        # rows' buckets of these seconds only; a failed build or launch
        # raises to the caller.
        with engine._flush_lock, engine._on_stream():
            idx = torch.tensor([r for _, r in rows], dtype=torch.int32, device=engine.device)
            recs = ma.bucket_read(MINUTE_CFG, engine.stats.minute, idx, begin, upto, now_rel).tolist()
        out: List[MetricNodeLine] = []
        for rec in recs:
            c = rec[2:]
            success = c[MetricEvent.SUCCESS]
            out.append(
                MetricNodeLine(
                    timestamp=engine.clock.to_wall(rec[1]),
                    resource=rows[rec[0]][0],
                    pass_qps=c[MetricEvent.PASS],
                    block_qps=c[MetricEvent.BLOCK],
                    success_qps=success,
                    exception_qps=c[MetricEvent.EXCEPTION],
                    rt=(c[MetricEvent.RT] / success) if success else 0.0,
                    occupied_pass_qps=c[MetricEvent.OCCUPIED_PASS],
                )
            )
        # Engine flight-recorder aggregates ride the same rolled files
        # under the reserved ``__engine__`` pseudo-resource:
        # pass=flushes, success=ops flushed, rt=mean host-blocking
        # flush ms for that second — the dashboard's pull protocol
        # carries the engine view with zero new machinery.
        tele = getattr(engine, "telemetry", None)
        if tele is not None and tele.enabled:
            for sec, flushes, n_ops, host_ms in tele.drain_second_aggregates(upto):
                if sec < begin - 1000:
                    continue  # older than this pull's window: drop
                out.append(
                    MetricNodeLine(
                        timestamp=engine.clock.to_wall(sec),
                        resource="__engine__",
                        pass_qps=flushes,
                        success_qps=n_ops,
                        rt=(host_ms / flushes) if flushes else 0.0,
                    )
                )
        # Two-tier provenance columns (metrics/provenance.py), keyed by
        # submit-ts second like the device buckets above: merge into
        # the matching (second, resource) line, or create a fresh line
        # for pairs the device never saw (shed ops are never encoded,
        # so a shed-only second would otherwise vanish entirely).
        prov = getattr(engine, "resource_metrics", None)
        if prov is not None and prov.enabled:
            by_key = {(ln.timestamp, ln.resource): ln for ln in out}
            for sec, res, spec, degr, shed, drift in prov.drain_seconds(upto):
                if sec < begin - 1000:
                    continue
                wall = engine.clock.to_wall(sec)
                ln = by_key.get((wall, res))
                if ln is None:
                    ln = MetricNodeLine(timestamp=wall, resource=res)
                    by_key[(wall, res)] = ln
                    out.append(ln)
                ln.speculative_qps = spec
                ln.degraded_qps = degr
                ln.shed_qps = shed
                ln.drift = drift
        out.sort(key=lambda n: (n.timestamp, n.resource))
        self._last_written_sec = upto
        return out
