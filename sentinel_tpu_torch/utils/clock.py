"""Explicit clock abstraction.

The reference caches ``System.currentTimeMillis()`` on a daemon thread to
avoid syscall storms under high request concurrency (reference:
sentinel-core/.../util/TimeUtil.java:42-113). The batched engine is
batch-driven, so there is no syscall storm to dodge — but the clock still
has to be an *explicit input* to every kernel, because all sliding-window
semantics are functions of ``(counters, rule, now)``. Making time a value
rather than ambient state is also what made the reference's fake-clock
test fixture necessary (reference: sentinel-core/src/test/.../test/
AbstractTimeBasedTest.java:36-60, which PowerMock-mocks the static
clock); here the equivalent fixture is just ``ManualClock``.

Device timestamps are **int32 milliseconds relative to the clock's
epoch**, exactly as in the JAX package whose state tensors the port
shares (``stats_from_numpy``). int32 ms covers ~24.8 days from the epoch; long-running processes
re-base the epoch during idle flushes (see
:meth:`SystemClock.rebase_headroom_ms`).
"""

from __future__ import annotations

import threading
import time


class Clock:
    """Millisecond clock with an explicit epoch.

    ``now_ms()`` is the device-facing time: int milliseconds since
    ``epoch_wall_ms``. ``wall_ms()`` is wall time (Unix ms) for logs and
    the transport plane.
    """

    def now_ms(self) -> int:
        raise NotImplementedError

    def wall_ms(self) -> int:
        raise NotImplementedError

    def sleep_ms(self, ms: int) -> None:
        raise NotImplementedError

    @property
    def epoch_wall_ms(self) -> int:
        raise NotImplementedError

    def to_wall(self, rel_ms: int) -> int:
        return self.epoch_wall_ms + rel_ms

    def from_wall(self, wall_ms: int) -> int:
        return wall_ms - self.epoch_wall_ms


class SystemClock(Clock):
    """Real clock; epoch anchored at construction time."""

    INT32_MAX = 2**31 - 1

    def __init__(self) -> None:
        self._epoch_wall_ms = int(time.time() * 1000)
        self._mono_base_ns = time.monotonic_ns()

    @property
    def epoch_wall_ms(self) -> int:
        return self._epoch_wall_ms

    def now_ms(self) -> int:
        return (time.monotonic_ns() - self._mono_base_ns) // 1_000_000

    def wall_ms(self) -> int:
        return self._epoch_wall_ms + self.now_ms()

    def sleep_ms(self, ms: int) -> None:
        if ms > 0:
            time.sleep(ms / 1000.0)

    def rebase_headroom_ms(self) -> int:
        """How far from int32 overflow the relative clock is."""
        return self.INT32_MAX - self.now_ms()

    # Rebase offsets must preserve every window grid: bucket index is
    # (ts // window_len) % n, so a shift must be ≡ 0 modulo
    # lcm(second-window 500ms grid over 2 buckets, minute-window 1000ms
    # grid over 60 buckets, breaker 1000ms window) = 60_000 ms.
    # An unaligned shift silently remaps/resets every live bucket.
    # (Per-rule breaker windows may use any statIntervalMs; those are
    # floor-realigned to their own grid in Engine._apply_rebase.)
    REBASE_GRANULARITY_MS = 60_000

    def rebase(self) -> int:
        """Re-anchor the epoch (aligned down to REBASE_GRANULARITY_MS);
        returns the shift applied.

        Callers (the engine, during an idle flush) must shift any stored
        relative timestamps by the returned offset.
        """
        offset = self.now_ms()
        offset -= offset % self.REBASE_GRANULARITY_MS
        if offset <= 0:
            return 0
        self._epoch_wall_ms += offset
        self._mono_base_ns += offset * 1_000_000
        return offset


class ManualClock(Clock):
    """Deterministic clock for tests.

    Replaces the reference's PowerMock fixture
    (AbstractTimeBasedTest.setCurrentMillis / sleep): tests advance time
    explicitly and every windowed/QPS/breaker assertion becomes
    deterministic.
    """

    def __init__(self, start_ms: int = 0, epoch_wall_ms: int = 1_700_000_000_000) -> None:
        self._now = start_ms
        self._epoch = epoch_wall_ms
        self._lock = threading.Lock()

    @property
    def epoch_wall_ms(self) -> int:
        return self._epoch

    def now_ms(self) -> int:
        return self._now

    def wall_ms(self) -> int:
        return self._epoch + self._now

    def set_ms(self, ms: int) -> None:
        with self._lock:
            self._now = ms

    def advance(self, ms: int) -> None:
        with self._lock:
            self._now += ms

    # In tests "sleeping" is advancing the virtual clock.
    def sleep_ms(self, ms: int) -> None:
        self.advance(ms)


_default_clock: Clock = SystemClock()
_default_lock = threading.Lock()


def default_clock() -> Clock:
    return _default_clock


def set_default_clock(clock: Clock) -> Clock:
    """Swap the process-default clock (tests); returns the previous one."""
    global _default_clock
    with _default_lock:
        prev = _default_clock
        _default_clock = clock
        return prev
