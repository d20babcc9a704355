"""Sequential oracle: the reference's hot-path semantics, one request at
a time, in plain Python (port of ``sentinel_tpu/testing/oracle.py``).

This is a *re-derivation from the documented semantics* of LeapArray
(reference: slots/statistic/base/LeapArray.java:41-222), MetricBucket
(data/MetricBucket.java), StatisticNode (node/StatisticNode.java:90-112)
and the traffic controllers (controller/DefaultController.java:44-79,
RateLimiterController.java:28-90, WarmUpController.java:64-130) — used
only in tests, to check that the batched kernels make the same
pass/block decisions the reference would.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from sentinel_tpu_torch.metrics.events import MetricEvent, NUM_EVENTS


class OracleBucket:
    __slots__ = ("window_start", "counts", "min_rt")

    def __init__(self, window_start: int, max_rt: int) -> None:
        self.window_start = window_start
        self.counts = [0] * NUM_EVENTS
        self.min_rt = max_rt


class OracleLeapArray:
    """LeapArray semantics: idx = (t/windowLen)%n, ws = t - t%windowLen,
    lazy reset of deprecated buckets, reads skip deprecated buckets."""

    def __init__(self, sample_count: int, interval_ms: int, max_rt: int = 4900) -> None:
        self.sample_count = sample_count
        self.interval_ms = interval_ms
        self.window_len = interval_ms // sample_count
        self.max_rt = max_rt
        self.buckets: List[Optional[OracleBucket]] = [None] * sample_count

    def current_bucket(self, t: int) -> OracleBucket:
        idx = (t // self.window_len) % self.sample_count
        ws = t - t % self.window_len
        b = self.buckets[idx]
        if b is None or b.window_start < ws:
            b = OracleBucket(ws, self.max_rt)
            self.buckets[idx] = b
        # b.window_start > ws (clock drift backwards) keeps the newer
        # bucket, matching the reset-to-newer CAS loop outcome.
        return b

    def _deprecated(self, t: int, b: OracleBucket) -> bool:
        return t - b.window_start > self.interval_ms

    def values(self, t: int) -> List[int]:
        out = [0] * NUM_EVENTS
        for b in self.buckets:
            if b is None or self._deprecated(t, b):
                continue
            for e in range(NUM_EVENTS):
                out[e] += b.counts[e]
        return out

    def min_rt_value(self, t: int) -> int:
        out = self.max_rt
        for b in self.buckets:
            if b is None or self._deprecated(t, b):
                continue
            out = min(out, b.min_rt)
        return out

    def add(self, t: int, event: MetricEvent, count: int) -> None:
        self.current_bucket(t).counts[event] += count

    def add_rt(self, t: int, rt: int) -> None:
        b = self.current_bucket(t)
        b.counts[MetricEvent.RT] += rt
        if rt < b.min_rt:
            b.min_rt = rt


class OracleFutureArray(OracleLeapArray):
    """FutureBucketLeapArray: a LeapArray whose deprecation rule is
    inverted — only strictly-future windows count (reference:
    slots/statistic/metric/occupy/FutureBucketLeapArray.java:29-43,
    ``isWindowDeprecated: time >= windowStart``)."""

    def _deprecated(self, t: int, b: OracleBucket) -> bool:
        return t >= b.window_start

    def get_window_value(self, t: int) -> Optional[OracleBucket]:
        """LeapArray.getWindowValue: the bucket covering ``t`` iff its
        start matches (isTimeInWindow), else None."""
        idx = (t // self.window_len) % self.sample_count
        ws = t - t % self.window_len
        b = self.buckets[idx]
        if b is None or b.window_start != ws:
            return None
        return b


class OracleOccupiableArray(OracleLeapArray):
    """OccupiableBucketLeapArray: the main second window plus a borrow
    array; bucket create/reset folds the matured borrow pass in
    (reference: OccupiableBucketLeapArray.java:29-75)."""

    def __init__(self, sample_count: int, interval_ms: int, max_rt: int = 4900) -> None:
        super().__init__(sample_count, interval_ms, max_rt)
        self.borrow = OracleFutureArray(sample_count, interval_ms, max_rt)

    def current_bucket(self, t: int) -> OracleBucket:
        idx = (t // self.window_len) % self.sample_count
        ws = t - t % self.window_len
        b = self.buckets[idx]
        if b is None or b.window_start < ws:
            b = OracleBucket(ws, self.max_rt)
            bb = self.borrow.get_window_value(ws)
            if bb is not None:  # newEmptyBucket / resetWindowTo copy
                b.counts[MetricEvent.PASS] += bb.counts[MetricEvent.PASS]
                # Consume the slot: a later materialize(t) must not fold
                # the same borrow again (the reference's borrow array is
                # read per roll too — each window's tokens land once).
                for bi, cand in enumerate(self.borrow.buckets):
                    if cand is bb:
                        self.borrow.buckets[bi] = None
            self.buckets[idx] = b
        return b

    def materialize(self, t: int) -> None:
        """The engine's per-flush fold (metrics/nodes.materialize_matured):
        every matured borrow rolls-or-adds into its window's bucket and
        clears its slab slot. The reference does this lazily via
        currentWindow's newEmptyBucket/resetWindowTo on the next touch;
        the engine does it eagerly each flush — oracle models driving
        flush-per-op sequences must call this where the engine flushes,
        or a matured borrow that no write ever touched stays invisible
        to reads."""
        for bi, bb in enumerate(self.borrow.buckets):
            if bb is None:
                continue
            ws = bb.window_start
            age = t - ws
            if age < 0:
                continue
            if age <= self.interval_ms:
                idx = (ws // self.window_len) % self.sample_count
                b = self.buckets[idx]
                if b is None or b.window_start < ws:
                    nb = OracleBucket(ws, self.max_rt)
                    nb.counts[MetricEvent.PASS] = bb.counts[MetricEvent.PASS]
                    self.buckets[idx] = nb
                elif b.window_start == ws:
                    b.counts[MetricEvent.PASS] += bb.counts[MetricEvent.PASS]
            self.borrow.buckets[bi] = None

    def waiting(self, t: int) -> int:
        """currentWaiting: borrowed tokens for strictly-future windows."""
        return sum(
            b.counts[MetricEvent.PASS]
            for b in self.borrow.buckets
            if b is not None and not self.borrow._deprecated(t, b)
        )

    def add_waiting(self, future_time: int, acquire: int) -> None:
        self.borrow.add(future_time, MetricEvent.PASS, acquire)

    def get_window_pass(self, t: int) -> int:
        """ArrayMetric.getWindowPass: one bucket's pass by exact start."""
        idx = (t // self.window_len) % self.sample_count
        ws = t - t % self.window_len
        b = self.buckets[idx]
        if b is None or b.window_start != ws:
            return 0
        return b.counts[MetricEvent.PASS]


class OracleNode:
    """StatisticNode: 1 s occupiable window (2×500 ms), 60 s window
    (60×1 s), thread gauge, occupy API (StatisticNode.java:302-346)."""

    def __init__(self) -> None:
        self.second = OracleOccupiableArray(2, 1000)
        self.minute = OracleLeapArray(60, 60000)
        self.cur_thread_num = 0

    def waiting(self, t: int) -> int:
        return self.second.waiting(t)

    def materialize(self, t: int) -> None:
        """Mirror of the engine's per-flush borrow maturation — see
        OracleOccupiableArray.materialize."""
        self.second.materialize(t)

    def try_occupy_next(
        self, t: int, acquire: int, threshold: float, occupy_timeout_ms: int = 500
    ) -> int:
        """StatisticNode.tryOccupyNext (java:302-333): the wait in ms
        until a future window can absorb the borrow, or the timeout
        sentinel when no window qualifies. Note the *cumulative*
        ``current_pass -= window_pass`` — step i's check sees the pass
        count remaining after windows 0..i all expire."""
        max_count = threshold * self.second.interval_ms / 1000.0
        current_borrow = self.waiting(t)
        if current_borrow >= max_count:
            return occupy_timeout_ms
        wlen = self.second.window_len
        earliest = t - t % wlen + wlen - self.second.interval_ms
        idx = 0
        current_pass = self.second.values(t)[MetricEvent.PASS]
        while earliest < t:
            wait_ms = idx * wlen + wlen - t % wlen
            if wait_ms >= occupy_timeout_ms:
                break
            window_pass = self.second.get_window_pass(earliest)
            if current_pass + current_borrow + acquire - window_pass <= max_count:
                return wait_ms
            earliest += wlen
            current_pass -= window_pass
            idx += 1
        return occupy_timeout_ms

    def add_waiting_request(self, future_time: int, acquire: int) -> None:
        self.second.add_waiting(future_time, acquire)

    def add_occupied_pass(self, t: int, acquire: int) -> None:
        """addOccupiedPass: minute window only (java:343-346)."""
        self.minute.add(t, MetricEvent.OCCUPIED_PASS, acquire)
        self.minute.add(t, MetricEvent.PASS, acquire)

    def pass_qps(self, t: int) -> float:
        return self.second.values(t)[MetricEvent.PASS] / (self.second.interval_ms / 1000.0)

    def block_qps(self, t: int) -> float:
        return self.second.values(t)[MetricEvent.BLOCK] / (self.second.interval_ms / 1000.0)

    def success_qps(self, t: int) -> float:
        return self.second.values(t)[MetricEvent.SUCCESS] / (self.second.interval_ms / 1000.0)

    def add_pass(self, t: int, count: int) -> None:
        self.second.add(t, MetricEvent.PASS, count)
        self.minute.add(t, MetricEvent.PASS, count)

    def add_block(self, t: int, count: int) -> None:
        self.second.add(t, MetricEvent.BLOCK, count)
        self.minute.add(t, MetricEvent.BLOCK, count)

    def add_rt_and_success(self, t: int, rt: int, count: int) -> None:
        self.second.add(t, MetricEvent.SUCCESS, count)
        self.second.add_rt(t, rt)
        self.minute.add(t, MetricEvent.SUCCESS, count)
        self.minute.add_rt(t, rt)


class OracleDefaultController:
    """DefaultController.canPass (DefaultController.java:49-79)."""

    def __init__(self, count: float, grade: int, occupy_timeout_ms: int = 500) -> None:
        self.count = count
        self.grade = grade  # 0 thread, 1 qps
        self.occupy_timeout_ms = occupy_timeout_ms

    def can_pass(self, node: OracleNode, t: int, acquire: int = 1) -> bool:
        if self.grade == 1:
            cur = int(node.pass_qps(t))
        else:
            cur = node.cur_thread_num
        return cur + acquire <= self.count

    def can_pass_prio(
        self, node: OracleNode, t: int, acquire: int = 1
    ) -> Tuple[bool, int, bool]:
        """The prioritized branch (DefaultController.java:49-75).

        Returns (ok, wait_ms, occupied); ``occupied`` models the
        PriorityWaitException outcome — passes after waiting, with the
        borrow recorded via addWaitingRequest + addOccupiedPass.
        """
        if self.can_pass(node, t, acquire):
            return True, 0, False
        if self.grade != 1:  # occupy is QPS-grade only
            return False, 0, False
        wait = node.try_occupy_next(t, acquire, self.count, self.occupy_timeout_ms)
        if wait < self.occupy_timeout_ms:
            node.add_waiting_request(t + wait, acquire)
            node.add_occupied_pass(t, acquire)
            return True, wait, True
        return False, 0, False


def _leaky_bucket_check(pacer, t: int, acquire: int, rate: float, cost=None):
    """The shared pacer body (RateLimiterController.java:46-90,
    single-threaded — the CAS race branches collapse). ``pacer`` holds
    mutable ``latest`` and ``maxq``; ``rate`` is the admitted QPS the
    cost derives from (the stable count, or the warm-up warning QPS);
    a caller that must mirror the kernel's float32 cost math passes
    ``cost`` precomputed. Returns (ok, wait_ms)."""
    if acquire <= 0:
        return True, 0
    if rate <= 0:
        return False, 0
    if cost is None:
        cost = int(1.0 * acquire / rate * 1000 + 0.5)  # Math.round
    expected = cost + pacer.latest
    if expected <= t:
        pacer.latest = t
        return True, 0
    wait = cost + pacer.latest - t
    if wait > pacer.maxq:
        return False, 0
    pacer.latest += cost
    wait = pacer.latest - t
    if wait > pacer.maxq:  # single-threaded: cannot trigger, kept for shape
        pacer.latest -= cost
        return False, 0
    return True, max(wait, 0)


class OracleRateLimiter:
    """RateLimiterController — the shared pacer at the stable rate.
    ``latest`` starts effectively at -infinity to match wall-clock Java
    behavior under the engine's relative clock."""

    def __init__(self, count: float, max_queueing_time_ms: int) -> None:
        self.count = count
        self.maxq = max_queueing_time_ms
        self.latest = -(10**9)

    def can_pass(self, t: int, acquire: int = 1):
        """Returns (ok, wait_ms)."""
        return _leaky_bucket_check(self, t, acquire, self.count)


class OracleWarmUp:
    """WarmUpController (WarmUpController.java:84-175)."""

    def __init__(self, count: float, warmup_sec: int, cold_factor: int = 3) -> None:
        self.count = count
        self.cold_factor = cold_factor
        self.warning_token = int(warmup_sec * count) // (cold_factor - 1)
        self.max_token = self.warning_token + int(2 * warmup_sec * count / (1.0 + cold_factor))
        self.slope = (
            (cold_factor - 1.0) / count / (self.max_token - self.warning_token)
            if count > 0 and self.max_token > self.warning_token
            else 0.0
        )
        self.stored = 0
        self.last_filled = -(10**9)

    def sync_token(self, t: int, prev_qps: int) -> None:
        sec = t - t % 1000
        if sec <= self.last_filled:
            return
        old = self.stored
        new = old
        if old < self.warning_token:
            new = int(old + (sec - self.last_filled) * self.count / 1000)
        elif old > self.warning_token:
            if prev_qps < int(self.count) // self.cold_factor:
                new = int(old + (sec - self.last_filled) * self.count / 1000)
        self.stored = min(new, self.max_token)
        self.stored = max(self.stored - prev_qps, 0)
        self.last_filled = sec

    def warning_qps(self) -> float:
        above = self.stored - self.warning_token
        return math.nextafter(1.0 / (above * self.slope + 1.0 / self.count), math.inf)

    def can_pass(self, node: "OracleNode", t: int, acquire: int = 1) -> bool:
        pass_qps = int(node.pass_qps(t))
        # previousPassQps: the minute array's bucket covering t-1000.
        prev_qps = self._previous_pass(node, t)
        self.sync_token(t, prev_qps)
        if self.stored >= self.warning_token:
            return pass_qps + acquire <= self.warning_qps()
        return pass_qps + acquire <= self.count

    @staticmethod
    def _previous_pass(node: "OracleNode", t: int) -> int:
        arr = node.minute
        tprev = t - arr.window_len
        idx = (tprev // arr.window_len) % arr.sample_count
        ws = tprev - tprev % arr.window_len
        b = arr.buckets[idx]
        if b is None or b.window_start != ws:
            return 0
        return b.counts[MetricEvent.PASS]


class OracleWarmUpRateLimiter(OracleWarmUp):
    """WarmUpRateLimiterController (WarmUpRateLimiterController.java:
    25-90): the leaky-bucket pacer whose cost per request uses the
    warm-up warning QPS while the system is cold (storedTokens at or
    above the warning line), the stable rate otherwise."""

    def __init__(
        self, count: float, warmup_sec: int, max_queueing_time_ms: int,
        cold_factor: int = 3,
    ) -> None:
        super().__init__(count, warmup_sec, cold_factor)
        self.maxq = max_queueing_time_ms
        self.latest = -(10**9)

    def can_pass_pacer(self, node: "OracleNode", t: int, acquire: int = 1):
        """Returns (ok, wait_ms); syncs tokens first, like the kernel
        scan step (rules/shaping.py::_transition), then runs the shared
        pacer at the cold-adjusted rate.

        The COLD cost mirrors the kernel's float32 arithmetic digit for
        digit (f32 nextafter + f32 divide + floor(x + 0.5)): a float64
        re-derivation can round the cost 1 ms differently when
        acq/warningQps·1000 lands near a half-integer, which exact
        differential wait assertions would flag as a fake bug. The warm
        cost stays float64 — it matches the host-precomputed exact
        ``cost1_ms`` path the kernel uses for acquire==1."""
        import numpy as _np

        prev_qps = self._previous_pass(node, t)
        self.sync_token(t, prev_qps)
        if self.count <= 0:
            return False, 0
        if self.stored >= self.warning_token:
            above = _np.float32(max(self.stored - self.warning_token, 0))
            inv = above * _np.float32(self.slope) + _np.float32(1.0) / _np.float32(
                max(self.count, 1e-9)
            )
            wq = _np.nextafter(_np.float32(1.0) / inv, _np.float32(_np.inf))
            cost = int(
                _np.floor(_np.float32(acquire) / wq * _np.float32(1000.0) + _np.float32(0.5))
            )
            return _leaky_bucket_check(self, t, acquire, float(wq), cost=cost)
        return _leaky_bucket_check(self, t, acquire, self.count)


class OracleParamBucket:
    """passDefaultLocalCheck for ONE parameter value (reference:
    sentinel-parameter-flow-control/.../ParamFlowChecker.java:46-137):
    first-seen fills the bucket minus the acquire; within a window the
    balance decrements-if-enough; past the window the refill is
    ``passTime*tokenCount/durationMs`` integer division clamped at
    maxCount, and a rejection never touches state (the CAS-failure
    return path)."""

    def __init__(self, count: int, burst: int, duration_ms: int) -> None:
        self.tc = count
        self.burst = burst
        self.dur = max(duration_ms, 1)
        self.tokens = 0
        self.last = None  # None = value never seen

    def check(self, t: int, acquire: int = 1) -> bool:
        max_count = self.tc + self.burst
        if self.tc <= 0 or acquire > max_count:
            return False
        if self.last is None:
            self.tokens = max_count - acquire
            self.last = t
            return True
        pass_time = t - self.last
        if pass_time > self.dur:
            to_add = pass_time * self.tc // self.dur
            if to_add + self.tokens > max_count:
                new_qps = max_count - acquire
            else:
                new_qps = self.tokens + to_add - acquire
            if new_qps < 0:
                return False
            self.tokens = new_qps
            self.last = t
            return True
        if self.tokens - acquire >= 0:
            self.tokens -= acquire
            return True
        return False


class OracleParamThrottle:
    """passThrottleLocalCheck for ONE parameter value (reference:
    ParamFlowChecker.java:234-262): first-seen passes free; queueing
    accepts waits STRICTLY below maxQueueingTimeMs and records
    ``latest = expected``."""

    def __init__(self, count: int, duration_sec: int, maxq: int) -> None:
        self.tc = count
        self.dur_sec = duration_sec
        self.maxq = maxq
        self.latest = None  # None = value never seen

    def _cost(self, acquire: int) -> int:
        # Math.round(1.0*1000*acquireCount*durationSec/count) —
        # reference ParamFlowChecker.java:244; host f64 like
        # ParamIndex.slots_for (which precomputes the acquire==1 case).
        return int(1000.0 * acquire * self.dur_sec / self.tc + 0.5)

    def check(self, t: int, acquire: int = 1):
        """Returns (ok, wait_ms)."""
        if self.tc <= 0:
            return False, 0
        if self.latest is None:
            self.latest = t
            return True, 0
        expected = self.latest + self._cost(acquire)
        if expected <= t:
            self.latest = t
            return True, 0
        wait = expected - t
        if wait < self.maxq:  # STRICT <
            self.latest = expected
            return True, max(wait, 0)
        return False, 0


class OracleCircuitBreaker:
    """Sequential breaker semantics (AbstractCircuitBreaker.java:40-150 +
    ExceptionCircuitBreaker.java / ResponseTimeCircuitBreaker.java):
    1-bucket window of (bad, total), CLOSED/OPEN/HALF_OPEN transitions
    evaluated after every completion."""

    CLOSED, OPEN, HALF_OPEN = 0, 1, 2

    def __init__(
        self,
        grade: int,  # 0 RT, 1 exception-ratio, 2 exception-count
        count: float,
        time_window_sec: int,
        min_request: int = 5,
        slow_ratio: float = 1.0,
        stat_interval_ms: int = 1000,
    ) -> None:
        self.grade = grade
        self.count = count
        self.max_rt = int(count + 0.5)
        self.slow_ratio = slow_ratio
        self.min_request = min_request
        self.interval = stat_interval_ms
        self.retry_ms = time_window_sec * 1000
        self.state = self.CLOSED
        self.next_retry = 0
        self.bad = 0
        self.total = 0
        self.ws = -(10**9)

    def _roll(self, t: int) -> None:
        aligned = t - t % self.interval
        if aligned > self.ws:
            self.ws = aligned
            self.bad = 0
            self.total = 0

    def try_pass(self, t: int) -> bool:
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN and t >= self.next_retry:
            self.state = self.HALF_OPEN
            return True
        return False

    def revert_probe(self) -> None:
        """whenTerminate workaround: probe blocked downstream."""
        if self.state == self.HALF_OPEN:
            self.state = self.OPEN

    def on_complete(self, t: int, rt: int = 0, error: bool = False) -> None:
        self._roll(t)
        is_bad = (rt > self.max_rt) if self.grade == 0 else error
        if is_bad:
            self.bad += 1
        self.total += 1
        if self.state == self.OPEN:
            return
        if self.state == self.HALF_OPEN:
            if is_bad:
                self.state = self.OPEN
                self.next_retry = t + self.retry_ms
            else:
                self.state = self.CLOSED
                self.bad = 0
                self.total = 0
            return
        if self.total < self.min_request:
            return
        ratio = self.bad / self.total
        if self.grade == 0:
            trip = ratio > self.slow_ratio or (self.slow_ratio >= 1.0 and ratio >= 1.0)
        elif self.grade == 1:
            trip = ratio > self.count
        else:
            trip = self.bad > self.count
        if trip:
            self.state = self.OPEN
            self.next_retry = t + self.retry_ms


class OracleFlowEngine:
    """Single-resource sequential engine: rules with DIRECT/default only.

    Mirrors the StatisticSlot ordering: check first, then account
    pass/block on the cluster node.
    """

    def __init__(self) -> None:
        self.nodes: Dict[str, OracleNode] = {}
        self.rules: Dict[str, List[OracleDefaultController]] = {}

    def node(self, resource: str) -> OracleNode:
        return self.nodes.setdefault(resource, OracleNode())

    def set_qps_rule(self, resource: str, count: float) -> None:
        self.rules.setdefault(resource, []).append(OracleDefaultController(count, 1))

    def set_thread_rule(self, resource: str, count: float) -> None:
        self.rules.setdefault(resource, []).append(OracleDefaultController(count, 0))

    def entry(self, resource: str, t: int, acquire: int = 1) -> bool:
        ok, _ = self.entry_prio(resource, t, acquire, prio=False)
        return ok

    def entry_prio(
        self, resource: str, t: int, acquire: int = 1, prio: bool = False
    ) -> Tuple[bool, int]:
        """Returns (admitted, wait_ms). An occupied pass takes the
        StatisticSlot PriorityWaitException branch: thread acquire only
        (StatisticSlot.java:84-96); the minute pass was recorded by
        addOccupiedPass and the second-window pass matures with the
        borrowed window."""
        node = self.node(resource)
        for ctl in self.rules.get(resource, ()):
            if prio:
                ok, wait, occupied = ctl.can_pass_prio(node, t, acquire)
            else:
                ok, wait, occupied = ctl.can_pass(node, t, acquire), 0, False
            if not ok:
                node.add_block(t, acquire)
                return False, 0
            if occupied:
                node.cur_thread_num += 1
                return True, wait
        node.add_pass(t, acquire)
        node.cur_thread_num += 1
        return True, 0

    def exit(self, resource: str, t: int, rt: int, acquire: int = 1) -> None:
        node = self.node(resource)
        node.add_rt_and_success(t, rt, acquire)
        node.cur_thread_num -= 1
