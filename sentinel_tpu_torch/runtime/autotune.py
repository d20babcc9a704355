"""Self-tuning control plane: close the telemetry loop on pipeline
depth, the adapter batch window, and closed-form path selection (port of
``sentinel_tpu/runtime/autotune.py``).

The flight recorder measures the signals (pipeline occupancy, the
encode/dispatch/settle breakdown, drain-wait time, ingest-valve pressure,
window fill) that set ``sentinel.tpu.host.pipeline.depth``, the batch
window and the closed-form-vs-scan param path. This module is the
controller that closes that loop:

* **depth** — AIMD adjustment of ``Engine.pipeline_depth`` within
  ``[0, sentinel.tpu.autotune.depth.max]``: raise one step when the
  pipeline runs occupied AND there is unhidden device wait to overlap;
  step back down on drain stalls (device fell behind by more than
  ``stall.frac`` of the tick's host work); halve on ingest-valve shed
  pressure; decrement after ``idle.ticks`` consecutive underutilized
  ticks. Arena bounds follow the depth automatically
  (``Engine.set_depth`` -> ``_resize_arena``), and LOWERING the depth
  drains the excess in-flight flushes first so the FIFO settle and
  arena-pinning contracts hold (see :meth:`Engine.set_depth`).
* **batch window** — ``BatchWindow.window_ms`` / ``batch_max`` retuned
  from the observed window fill ratio and the dispatch->fan-out
  latency EWMA, bounded by ``sentinel.tpu.autotune.window.*``.
* **param path** — for closed-form-ELIGIBLE param batches (uniform
  QPS-grade, bounded ts segments — see ``Engine._param_rounds_for``),
  a shape-bucketed cost memo picks closed-form rank math vs the
  rounds/scan family from measured per-path flush timings: each
  (rows-bucket, segment-count) bucket is explored ``param.explore``
  times per path, then the cheaper EWMA wins, with a ``param.margin``
  switch hysteresis. Ineligible batches always scan — eligibility is
  correctness, the memo only arbitrates cost.

Every decision is a **pure function of a sampled stats snapshot**
(:func:`decide_depth`, :func:`decide_window`, :func:`pick_path` — what
tests/test_torch_autotune.py holds against the JAX package), applied by the
engine-scoped :class:`AutoTuner` once per drain tick, OFF the hot path:
disabled (the default) costs one attribute read per drain and behavior
is bit-identical to the static config. Oscillation is prevented
structurally — occupancy dead band, per-knob cooldown
(``cooldown.ms``), consecutive-tick requirements, and the memo margin —
and every applied decision lands in a bounded decision log (the
snapshot) and the ``autotune_decisions`` telemetry counter.

The controller reads its signals from the flight recorder, so
``sentinel.tpu.telemetry.enabled=false`` leaves the tuner inert (it
holds every knob and says so in its snapshot) — there is nothing to
steer by.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from sentinel_tpu_torch.utils.config import config

# Param-path identifiers on spans / memo stats.
PATH_CLOSED = 1
PATH_SCAN = 2


# ----------------------------------------------------------------------
# pure decision inputs
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class TuneLimits:
    """Config-derived bounds/thresholds — frozen so a decision is a
    function of (snapshot, limits, streak) and nothing else."""

    depth_max: int = 4
    min_flushes: int = 8
    occ_high: float = 0.85
    occ_low: float = 0.2
    idle_ticks: int = 3
    raise_frac: float = 0.1
    stall_frac: float = 2.0
    window_ms_max: float = 20.0
    window_ms_min: float = 0.25
    window_batch_cap: int = 4096

    @classmethod
    def from_config(cls, window_ms_base: float) -> "TuneLimits":
        return cls(
            depth_max=max(0, config.get_int(config.AUTOTUNE_DEPTH_MAX, 4)),
            min_flushes=max(1, config.get_int(config.AUTOTUNE_MIN_FLUSHES, 8)),
            occ_high=config.get_float(config.AUTOTUNE_OCC_HIGH, 0.85),
            occ_low=config.get_float(config.AUTOTUNE_OCC_LOW, 0.2),
            idle_ticks=max(1, config.get_int(config.AUTOTUNE_IDLE_TICKS, 3)),
            raise_frac=config.get_float(config.AUTOTUNE_RAISE_FRAC, 0.1),
            stall_frac=config.get_float(config.AUTOTUNE_STALL_FRAC, 2.0),
            window_ms_max=max(
                0.0, config.get_float(config.AUTOTUNE_WINDOW_MS_MAX, 20.0)
            ),
            # The window may shrink under latency pressure, but never
            # below a quarter of its configured base (and an absolute
            # floor that keeps it a window at all).
            window_ms_min=max(0.25, window_ms_base / 4.0),
            window_batch_cap=max(
                1, config.get_int(config.AUTOTUNE_WINDOW_BATCH_MAX, 4096)
            ),
        )


@dataclass(frozen=True)
class TuneSnapshot:
    """One tick's sampled signals — plain data, so decisions are
    unit-testable with synthetic values. All *_ms fields are sums over
    the spans settled since the previous tick."""

    now_ms: int = 0
    depth: int = 0
    flushes: int = 0  # settled flush spans this tick
    mean_inflight: float = 0.0  # pipeline_stats sample since last tick
    encode_ms: float = 0.0
    dispatch_ms: float = 0.0
    settle_ms: float = 0.0  # sync fetch + per-record fill time
    drain_ms: float = 0.0  # coalesced drain WAIT time this tick
    shed: int = 0  # ingest-valve sheds this tick
    window_armed: bool = False
    window_reqs: int = 0  # batch-window joins this tick
    window_flushes: int = 0  # windows flushed this tick
    window_ms: float = 0.0  # current window length
    window_batch_max: int = 0  # current early-flush bound
    window_fanout_ms: float = 0.0  # dispatch->fan-out latency EWMA

    @property
    def occupancy(self) -> float:
        """Mean in-flight depth relative to the configured depth."""
        return self.mean_inflight / self.depth if self.depth > 0 else 0.0

    @property
    def host_ms(self) -> float:
        return self.encode_ms + self.dispatch_ms

    @property
    def device_wait_ms(self) -> float:
        """Host-visible UNHIDDEN device wait: synchronous fetches plus
        coalesced drain waits. Perfect overlap drives this toward 0."""
        return self.settle_ms + self.drain_ms


# ----------------------------------------------------------------------
# pure decision functions
# ----------------------------------------------------------------------
def decide_depth(
    snap: TuneSnapshot, limits: TuneLimits, low_streak: int = 0
) -> Tuple[int, str, int]:
    """``(new_depth, reason, new_low_streak)``; ``new_depth ==
    snap.depth`` means hold. AIMD with an occupancy dead band:

    * shed pressure -> halve (multiplicative decrease: the valve says
      verdict latency already exceeds what callers tolerate);
    * drain stall (device wait > 1.5 x ``stall.frac`` x host work,
      depth > 1) -> −1: the device is the bottleneck, extra depth only
      queues latency in the drain. The 1.5x gap above the raise
      ceiling (dev <= ``stall.frac`` x host) is a dead band: a raise
      SHRINKS the unhidden wait, so a just-raised depth can never land
      in the stall region on the same workload — no K <-> K+1 flap;
    * underutilized (occupancy <= ``occ_low`` for ``idle_ticks``
      consecutive ticks) -> −1;
    * raise (+1) only when the pipeline is occupied (>= ``occ_high``;
      trivially true at depth 0) AND unhidden device wait exceeds
      ``raise.frac`` x host work — there is something to hide — and,
      at depth >= 1, the stall ceiling is not breached.

    Convergence under a steady workload is structural: every raise
    shrinks the unhidden device wait, so the raise condition
    extinguishes itself; the dead band between ``occ_low`` and
    ``occ_high`` (and the post-raise occupancy >= occ_high x K/(K+1))
    keeps the fixed point from flapping."""
    d = snap.depth
    if snap.flushes < limits.min_flushes:
        return d, "insufficient-samples", low_streak
    if snap.shed > 0 and d > 0:
        return d // 2, "ingest-pressure", 0
    host = max(snap.host_ms, 1e-9)
    dev = snap.device_wait_ms
    if d > 1 and dev > 1.5 * limits.stall_frac * host:
        return d - 1, "drain-stall", 0
    if d > 0 and snap.occupancy <= limits.occ_low:
        low_streak += 1
        if low_streak >= limits.idle_ticks:
            return d - 1, "underutilized", 0
        return d, "underutilized-wait", low_streak
    low_streak = 0
    if d >= limits.depth_max:
        return d, "at-max", low_streak
    if dev >= limits.raise_frac * host and (
        d == 0
        or (
            snap.occupancy >= limits.occ_high
            and dev <= limits.stall_frac * host
        )
    ):
        return d + 1, "hide-device-wait", low_streak
    return d, "steady", low_streak


def decide_window(
    snap: TuneSnapshot, limits: TuneLimits
) -> Tuple[float, int, str]:
    """``(new_window_ms, new_batch_max, reason)`` — equal values mean
    hold. Signals: fill ratio (joined requests per flushed window,
    relative to ``batch_max``) and the dispatch->fan-out latency EWMA.

    * windows capping out (fill >= 0.9) -> double ``batch_max`` toward
      the ``window.batch.max`` cap: there is more coalescing available
      than the bound allows;
    * fan-out latency pressure (EWMA > 4 x window length) -> halve
      ``window_ms`` toward the floor: the flush itself dominates the
      request's wait, a longer assembly only adds to it;
    * sparse windows (fill <= 0.5) with fan-out comfortably inside the
      window budget -> grow ``window_ms`` 1.5x toward ``window.ms.max``
      to coalesce more. The widen condition (fanout <= window) and the
      shrink condition (fanout > 4 x window) are separated by a 4x dead
      band, so the two can never alternate on the same signal."""
    ms, bmax = snap.window_ms, snap.window_batch_max
    if not snap.window_armed or snap.window_flushes <= 0 or bmax <= 0:
        return ms, bmax, "inactive"
    fill = snap.window_reqs / float(snap.window_flushes * bmax)
    if fill >= 0.9 and bmax < limits.window_batch_cap:
        return ms, min(bmax * 2, limits.window_batch_cap), "windows-capping"
    if snap.window_fanout_ms > 4.0 * ms and ms > limits.window_ms_min:
        return max(ms / 2.0, limits.window_ms_min), bmax, "fanout-latency"
    if (
        fill <= 0.5
        and snap.window_reqs > 0
        and 0.0 < snap.window_fanout_ms <= ms
        and ms < limits.window_ms_max
    ):
        return min(ms * 1.5, limits.window_ms_max), bmax, "coalesce-more"
    return ms, bmax, "steady"


@dataclass
class PathStats:
    """Per-(bucket, path) running cost: sample count + cost EWMA
    (ms per flush carrying that bucket's param batch)."""

    n: int = 0
    ewma_ms: float = 0.0

    def note(self, ms: float, alpha: float = 0.25) -> None:
        if self.n == 0:
            self.ewma_ms = ms
        else:
            self.ewma_ms += alpha * (ms - self.ewma_ms)
        self.n += 1


def pick_path(
    closed: PathStats,
    scan: PathStats,
    current: int,
    explore: int,
    margin: float,
) -> Tuple[int, str]:
    """Pure pick for one shape bucket: ``(PATH_*, reason)``. Explore
    each path ``explore`` times first (closed-form — today's static
    default — goes first), then commit to the cheaper EWMA; switch away
    from ``current`` only when the other path is better by more than
    ``margin`` (relative) — the flip hysteresis."""
    if closed.n < explore:
        return PATH_CLOSED, "explore-closed"
    if scan.n < explore:
        return PATH_SCAN, "explore-scan"
    if current == PATH_SCAN:
        cheaper, other = scan, closed
        cheaper_path, other_path = PATH_SCAN, PATH_CLOSED
    else:
        cheaper, other = closed, scan
        cheaper_path, other_path = PATH_CLOSED, PATH_SCAN
    if other.ewma_ms < cheaper.ewma_ms * (1.0 - margin):
        return other_path, "cost-switch"
    return cheaper_path, "cost-hold"


class ParamPathMemo:
    """Shape-bucketed closed-form-vs-scan cost memo. Buckets are
    ``(pow2 rows bucket, ts-segment count)`` — the shape axes the two
    paths' costs actually vary along (2511.16797/2504.16896-style
    width/depth sweep buckets). ``seed()`` lets a caller pre-load
    measured per-path timings so the explore phase can be skipped."""

    def __init__(self, explore: int = 3, margin: float = 0.15) -> None:
        self.explore = max(1, int(explore))
        self.margin = float(margin)
        self._lock = threading.Lock()
        # bucket -> {PATH_CLOSED: PathStats, PATH_SCAN: PathStats,
        #            "current": int}
        self._stats: Dict[tuple, dict] = {}

    @staticmethod
    def bucket_of(n_items: int, nseg: int) -> tuple:
        b = 1 << max(0, int(n_items) - 1).bit_length()
        return (b, int(nseg))

    def _entry(self, bucket: tuple) -> dict:
        e = self._stats.get(bucket)
        if e is None:
            e = self._stats[bucket] = {
                PATH_CLOSED: PathStats(),
                PATH_SCAN: PathStats(),
                "current": PATH_CLOSED,
            }
        return e

    def pick(self, bucket: tuple) -> Tuple[int, str]:
        with self._lock:
            e = self._entry(bucket)
            path, reason = pick_path(
                e[PATH_CLOSED], e[PATH_SCAN], e["current"],
                self.explore, self.margin,
            )
            e["current"] = path
            return path, reason

    def note(self, bucket: tuple, path: int, ms: float) -> None:
        with self._lock:
            e = self._entry(bucket)
            if path in e:
                e[path].note(ms)

    def seed(self, bucket: tuple, closed_ms: float, scan_ms: float) -> None:
        """Pre-load a bucket with measured per-path costs (each counts
        as a full exploration)."""
        with self._lock:
            e = self._entry(bucket)
            for _ in range(self.explore):
                e[PATH_CLOSED].note(closed_ms)
                e[PATH_SCAN].note(scan_ms)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [
                {
                    "rows_bucket": b[0],
                    "segments": b[1],
                    "current": (
                        "closed" if e["current"] == PATH_CLOSED else "scan"
                    ),
                    "closed_n": e[PATH_CLOSED].n,
                    "closed_ewma_ms": round(e[PATH_CLOSED].ewma_ms, 4),
                    "scan_n": e[PATH_SCAN].n,
                    "scan_ewma_ms": round(e[PATH_SCAN].ewma_ms, 4),
                }
                for b, e in sorted(self._stats.items())
            ]


# ----------------------------------------------------------------------
# the engine-scoped controller
# ----------------------------------------------------------------------
class AutoTuner:
    """One per :class:`Engine`. ``enabled`` False (the default) is the
    whole hot-path cost: one attribute read at the drain tick hook and
    one at the param-path pick site."""

    def __init__(self, engine) -> None:
        self._engine = engine
        self.enabled = config.get_bool(config.AUTOTUNE_ENABLED, False)
        # No telemetry = no signals: hold every knob rather than steer
        # blind (documented contract; surfaced in the snapshot).
        self.blind = self.enabled and not engine.telemetry.enabled
        self.interval_ms = max(
            1, config.get_int(config.AUTOTUNE_INTERVAL_MS, 250)
        )
        self.cooldown_ms = max(
            0, config.get_int(config.AUTOTUNE_COOLDOWN_MS, 1000)
        )
        self.limits = TuneLimits.from_config(
            window_ms_base=engine.ingest_window.window_ms
        )
        self.param_active = (
            self.enabled
            and not self.blind
            and config.get_bool(config.AUTOTUNE_PARAM_PATH, True)
        )
        self.memo = ParamPathMemo(
            explore=config.get_int(config.AUTOTUNE_PARAM_EXPLORE, 3),
            margin=config.get_float(config.AUTOTUNE_PARAM_MARGIN, 0.15),
        )
        # Measured per-shape closed-vs-scan timings
        # (sentinel.tpu.autotune.param.seed.file): the memo starts
        # COMMITTED to the measured winner per bucket instead of paying
        # the explore phase live. A missing/bad file is logged and
        # ignored — seeding is an optimization, never a correctness
        # dependency.
        self.seeded_buckets = 0
        seed_path = (
            config.get(config.AUTOTUNE_PARAM_SEED_FILE) or ""
        ).strip()
        if seed_path and self.param_active:
            self.seeded_buckets = self._load_seed(seed_path)
        self.decisions: "deque[dict]" = deque(
            maxlen=max(16, config.get_int(config.AUTOTUNE_LOG, 256))
        )
        self._lock = threading.Lock()
        self._ticking = False
        self._last_tick_ms = -(1 << 62)
        self._cooldown_until: Dict[str, int] = {}
        self._low_streak = 0
        # Signal baselines for per-tick deltas.
        self._folded_upto = -1  # last span flush_id folded into sums/memo
        self._drain_seen_ms = 0.0
        self._shed_seen = 0
        self._win_reqs_seen = 0
        self._win_flushes_seen = 0
        # Pipeline-stats baselines (dispatch count + inflight sum): the
        # tuner must NOT pipeline_stats(reset=True) — those accumulators
        # also feed the Prometheus export and the telemetry snapshot,
        # and a reset every tick would turn the exported counter into a
        # perpetually-resetting one.
        self._pipe_n_seen = 0.0
        self._pipe_sum_seen = 0.0
        # Pick made during _encode_param of the chunk currently being
        # dispatched (flushes serialize under the engine's flush lock);
        # _run_chunk consumes it onto the chunk's flight-recorder span
        # for settle-time cost attribution.
        self._pending_pick: Optional[Tuple[tuple, int]] = None
        self.counters: Dict[str, int] = {
            "ticks": 0,
            "decisions": 0,
            "depth_raises": 0,
            "depth_lowers": 0,
            "window_retunes": 0,
        }

    def _load_seed(self, path: str) -> int:
        """Load a seed file of measured per-path timings into the memo.
        Format: ``{"buckets": [{"rows_bucket", "segments", "closed_ms",
        "scan_ms"}, ...]}`` (a bare list of the same entries is also
        accepted). Returns the number of buckets seeded."""
        import json

        try:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError) as exc:
            from sentinel_tpu_torch.utils.record_log import record_log

            record_log.error(
                "[AutoTuner] param seed file %s unreadable: %s", path, exc
            )
            return 0
        entries = data.get("buckets", []) if isinstance(data, dict) else data
        if not isinstance(entries, list):
            # Valid JSON, wrong shape (a scalar / object root): the
            # "bad file is ignored" contract covers this too — a seed
            # file must never be able to fail engine construction.
            from sentinel_tpu_torch.utils.record_log import record_log

            record_log.error(
                "[AutoTuner] param seed file %s has no bucket list", path
            )
            return 0
        n = 0
        for e in entries:
            try:
                bucket = (int(e["rows_bucket"]), int(e["segments"]))
                closed = float(e["closed_ms"])
                scan = float(e["scan_ms"])
            except (TypeError, KeyError, ValueError, AttributeError):
                continue
            if closed < 0 or scan < 0:
                continue
            self.memo.seed(bucket, closed, scan)
            n += 1
        return n

    # ------------------------------------------------------------------
    # param-path pick (engine._encode_param; under the flush lock)
    # ------------------------------------------------------------------
    def pick_param_rounds(
        self,
        n_items: int,
        nseg: int,
        closed_rounds: int,
        scan_rounds: Callable[[], int],
    ) -> int:
        """Arbitrate one closed-form-ELIGIBLE param batch: return
        ``closed_rounds`` (negative, the rank path) or the
        lazily-computed scan-family rounds bound. The pick is recorded
        for the settling span's cost attribution."""
        bucket = ParamPathMemo.bucket_of(n_items, nseg)
        path, _reason = self.memo.pick(bucket)
        self._pending_pick = (bucket, path)
        if path == PATH_CLOSED:
            return closed_rounds
        return scan_rounds()

    def take_pending_pick(self) -> Optional[Tuple[tuple, int]]:
        pick, self._pending_pick = self._pending_pick, None
        return pick

    # ------------------------------------------------------------------
    # the tick (engine drain path; off the submit hot path)
    # ------------------------------------------------------------------
    def maybe_tick(self, now_ms: int) -> None:
        """Rate-limited, re-entrancy-guarded tick. Called at the end of
        every successful drain; the actual decision work runs at most
        once per ``interval.ms``."""
        if not self.enabled or self.blind:
            return
        with self._lock:
            if self._ticking or now_ms - self._last_tick_ms < self.interval_ms:
                return
            self._ticking = True
            self._last_tick_ms = now_ms
        try:
            self.tick(now_ms)
        except Exception:
            # A tick must never break the drain that hosted it: a
            # device error surfacing through set_depth's drain (or a
            # controller bug) is logged, not propagated — the affected
            # verdicts still raise at their own materialization.
            from sentinel_tpu_torch.utils.record_log import record_log

            record_log.error("[AutoTuner] tick failed", exc_info=True)
        finally:
            with self._lock:
                self._ticking = False

    def tick(self, now_ms: int) -> None:
        """Sample -> decide -> apply, once. Public (and unguarded by
        the interval) so tests and tools can force a decision point."""
        snap = self.sample(now_ms)
        self.counters["ticks"] += 1
        self._apply_depth(snap)
        self._apply_window(snap)

    def sample(self, now_ms: int) -> TuneSnapshot:
        """Build this tick's snapshot from the flight recorder + valve
        + window counters, folding newly settled spans' param-path
        timings into the cost memo on the way (FIFO settle order makes
        'consecutive settled spans past the high-water mark' exact)."""
        eng = self._engine
        tele = eng.telemetry
        enc = disp = setl = 0.0
        n = 0
        folded = self._folded_upto
        memo_active = self.param_active
        for s in tele.spans():
            if s.flush_id <= folded:
                continue
            if not s.settled:
                break
            enc += s.encode_ms
            disp += s.dispatch_ms
            setl += s.settle_ms
            n += 1
            folded = s.flush_id
            if memo_active and s.param_bucket is not None:
                self.memo.note(
                    s.param_bucket, s.param_path,
                    s.dispatch_ms + s.settle_ms,
                )
        self._folded_upto = folded
        # Per-tick mean in-flight depth from delta reads (no reset —
        # see the baseline comment in __init__). A reset by another
        # caller shows as a shrinking count: re-baseline.
        ps = eng.pipeline_stats()
        n1 = ps["dispatches"]
        sum1 = ps["mean_inflight"] * n1
        dn = n1 - self._pipe_n_seen
        mean_inflight = (
            (sum1 - self._pipe_sum_seen) / dn if dn > 0 else 0.0
        )
        self._pipe_n_seen, self._pipe_sum_seen = n1, sum1
        drain_total = tele.hist_drain.sum_ms
        drain = max(0.0, drain_total - self._drain_seen_ms)
        self._drain_seen_ms = drain_total
        valve = eng.ingest
        shed_total = (
            valve.counters["shed_entries"] + valve.counters["shed_rows"]
        )
        shed = max(0, shed_total - self._shed_seen)
        self._shed_seen = shed_total
        w = eng.ingest_window
        wr = w.counters["reqs"]
        wf = w.counters["flushes"]
        snap = TuneSnapshot(
            now_ms=now_ms,
            depth=eng.pipeline_depth,
            flushes=n,
            mean_inflight=mean_inflight,
            encode_ms=enc,
            dispatch_ms=disp,
            settle_ms=setl,
            drain_ms=drain,
            shed=shed,
            window_armed=w.armed,
            window_reqs=max(0, wr - self._win_reqs_seen),
            window_flushes=max(0, wf - self._win_flushes_seen),
            window_ms=w.window_ms,
            window_batch_max=w.batch_max,
            window_fanout_ms=w.fanout_ms,
        )
        self._win_reqs_seen = wr
        self._win_flushes_seen = wf
        return snap

    def _cooled(self, knob: str, now_ms: int) -> bool:
        return now_ms >= self._cooldown_until.get(knob, -(1 << 62))

    def _apply_depth(self, snap: TuneSnapshot) -> None:
        if not self._cooled("depth", snap.now_ms):
            return
        new_depth, reason, self._low_streak = decide_depth(
            snap, self.limits, self._low_streak
        )
        if new_depth == snap.depth:
            return
        self._engine.set_depth(new_depth, drain=True)
        key = "depth_raises" if new_depth > snap.depth else "depth_lowers"
        self.counters[key] += 1
        self._note_decision(
            snap.now_ms, "depth", snap.depth, new_depth, reason
        )

    def _apply_window(self, snap: TuneSnapshot) -> None:
        if not snap.window_armed or not self._cooled("window", snap.now_ms):
            return
        ms, bmax, reason = decide_window(snap, self.limits)
        if ms == snap.window_ms and bmax == snap.window_batch_max:
            return
        self._engine.ingest_window.retune(window_ms=ms, batch_max=bmax)
        self.counters["window_retunes"] += 1
        if ms != snap.window_ms:
            self._note_decision(
                snap.now_ms, "window_ms", snap.window_ms, ms, reason
            )
        if bmax != snap.window_batch_max:
            self._note_decision(
                snap.now_ms, "window_max", snap.window_batch_max, bmax,
                reason,
            )

    def _note_decision(self, now_ms, knob, frm, to, reason) -> None:
        # Appends under _lock: a concurrent snapshot() (HTTP scrape of
        # /autotune or /telemetry) iterates the deque, and CPython
        # raises on mutation-during-iteration.
        with self._lock:
            self._cooldown_until[
                "window" if knob.startswith("window") else knob
            ] = now_ms + self.cooldown_ms
            self.counters["decisions"] += 1
            self.decisions.append(
                {"now_ms": now_ms, "knob": knob, "from": frm, "to": to,
                 "reason": reason}
            )
        tele = self._engine.telemetry
        if tele.enabled:
            tele.note_autotune_decision()

    # ------------------------------------------------------------------
    # readers
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        eng = self._engine
        lim = self.limits
        with self._lock:
            # Copies under _lock: the tick thread appends to the
            # decisions deque (and bumps counters) concurrently.
            counters = dict(self.counters)
            decisions = list(self.decisions)
        return {
            "enabled": self.enabled,
            "blind": self.blind,
            "interval_ms": self.interval_ms,
            "cooldown_ms": self.cooldown_ms,
            "depth": eng.pipeline_depth,
            "depth_max": lim.depth_max,
            "window_armed": eng.ingest_window.armed,
            "window_ms": eng.ingest_window.window_ms,
            "window_batch_max": eng.ingest_window.batch_max,
            "param_path": self.param_active,
            "param_seed_buckets": self.seeded_buckets,
            "counters": counters,
            "decisions": decisions,
            "param_memo": self.memo.snapshot(),
        }
