"""System load / CPU sampler (port of ``sentinel_tpu/utils/system_status.py``,
a copy: the port imports nothing of the JAX package).

Equivalent of the reference's SystemStatusListener (reference:
slots/system/SystemStatusListener.java:31-60), which polls
OperatingSystemMXBean once a second for the 1-minute load average and
CPU usage (max of system and process CPU). Here: ``os.getloadavg`` and
/proc/stat deltas (plus process CPU via ``os.times``), sampled by a
daemon thread started lazily when system rules first need it.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Tuple


def _read_proc_stat() -> Optional[Tuple[int, int]]:
    """(busy, total) jiffies from /proc/stat, or None off-Linux."""
    try:
        with open("/proc/stat", "r") as f:
            line = f.readline()
        parts = [int(x) for x in line.split()[1:]]
        idle = parts[3] + (parts[4] if len(parts) > 4 else 0)
        total = sum(parts)
        return total - idle, total
    except (OSError, ValueError, IndexError):
        return None


class SystemStatusSampler:
    def __init__(self, interval_sec: float = 1.0) -> None:
        self.interval = interval_sec
        self._load = -1.0
        self._cpu = -1.0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._prev_stat: Optional[Tuple[int, int]] = None
        self._prev_proc: Optional[Tuple[float, float]] = None
        self._stop = threading.Event()
        self._forced = False

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._run, name="sentinel-system-status", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._sample()
            self._stop.wait(self.interval)

    def _sample(self) -> None:
        try:
            load = os.getloadavg()[0]
        except (OSError, AttributeError):
            load = -1.0
        sys_cpu = -1.0
        cur = _read_proc_stat()
        if cur is not None and self._prev_stat is not None:
            db = cur[0] - self._prev_stat[0]
            dt = cur[1] - self._prev_stat[1]
            if dt > 0:
                sys_cpu = db / dt
        self._prev_stat = cur
        # Process CPU (the reference takes max(process, system)).
        t = os.times()
        now = time.monotonic()
        proc_cpu = -1.0
        if self._prev_proc is not None:
            dcpu = (t.user + t.system) - self._prev_proc[0]
            dwall = now - self._prev_proc[1]
            ncpu = os.cpu_count() or 1
            if dwall > 0:
                proc_cpu = dcpu / dwall / ncpu
        self._prev_proc = (t.user + t.system, now)
        with self._lock:
            if self._forced:
                return
            self._load = load
            self._cpu = max(sys_cpu, proc_cpu)

    @property
    def load(self) -> float:
        with self._lock:
            return self._load

    @property
    def cpu(self) -> float:
        with self._lock:
            return self._cpu

    def read(self) -> Tuple[float, float]:
        """Atomic ``(load, cpu)`` pair under ONE lock acquisition —
        the kernel's SystemDevice build and the host system gate
        (runtime/failover.py) both consume the pair; two separate
        property reads could tear across a sample and gate the two
        planes on different instants."""
        with self._lock:
            return self._load, self._cpu

    # Test hook: force values (the reference's tests mock the MXBean).
    def force(self, load: float, cpu: float) -> None:
        with self._lock:
            self._forced = True
            self._load = load
            self._cpu = cpu
        self._stop.set()

    def unforce(self) -> None:
        with self._lock:
            self._forced = False


sampler = SystemStatusSampler()
