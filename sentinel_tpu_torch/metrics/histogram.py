"""Fixed-bucket latency histograms with power-of-two bounds (port of
``sentinel_tpu/metrics/histogram.py``).

``last_flush_host_ms`` keeps one number per stage; the telemetry bus
records every flush, drain and end-to-end duration into these histograms,
so that tails are visible too.

Design constraints (why not a library):

* **Fixed pow2 buckets** — bucket ``i`` covers ``(base·2^(i-1),
  base·2^i]`` ms (bucket 0 is ``(0, base]``), so two histograms with the
  same geometry are mergeable by adding their count vectors — the
  property Prometheus ``_bucket`` series and cross-process aggregation
  both need. No dynamic rebucketing, ever.
* **O(1) record** — a ``bit_length`` on the scaled integer, no search.
* **numpy counts** — ``merge`` and the cumulative render are vector
  adds; the snapshot is a copy, safe to hold across later records.
"""

from __future__ import annotations

import math
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Default geometry: 1 µs .. ~33.5 s in 26 pow2 buckets (+1 overflow).
DEFAULT_BASE_MS = 0.001
DEFAULT_N_BUCKETS = 26


class LatencyHistogram:
    """Thread-safe fixed-bucket histogram of millisecond durations."""

    __slots__ = ("base_ms", "n_buckets", "bounds_ms", "_counts", "_sum_ms",
                 "_lock")

    def __init__(
        self,
        base_ms: float = DEFAULT_BASE_MS,
        n_buckets: int = DEFAULT_N_BUCKETS,
    ) -> None:
        if base_ms <= 0 or n_buckets < 1:
            raise ValueError("histogram geometry must be positive")
        self.base_ms = float(base_ms)
        self.n_buckets = int(n_buckets)
        # Upper bound of bucket i (inclusive): base * 2**i.
        self.bounds_ms = self.base_ms * np.exp2(
            np.arange(self.n_buckets, dtype=np.float64)
        )
        # counts[n_buckets] is the +Inf overflow bucket.
        self._counts = np.zeros(self.n_buckets + 1, dtype=np.int64)
        self._sum_ms = 0.0
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def _bucket_of(self, ms: float) -> int:
        v = ms / self.base_ms
        if v <= 1.0:
            return 0
        # ceil to the next integer so 2.5×base lands in the 4×base
        # bucket; bit_length is the exact pow2 exponent.
        b = (math.ceil(v) - 1).bit_length()
        return b if b < self.n_buckets else self.n_buckets

    def bucket_of(self, ms: float) -> int:
        """Public bucket index for ``ms`` (the exemplar keying used by
        the admission tracer — exemplars must land on the same
        ``_bucket`` series their latency was counted in)."""
        return self._bucket_of(max(ms, 0.0))

    def record(self, ms: float) -> None:
        if ms < 0.0:
            ms = 0.0
        b = self._bucket_of(ms)
        with self._lock:
            self._counts[b] += 1
            self._sum_ms += ms

    def record_each(self, ms_values: np.ndarray) -> np.ndarray:
        """:meth:`record` of each value in turn, under one lock: the same
        counts and the same float sum as a call a value. Returns each
        value's bucket."""
        a = np.maximum(np.asarray(ms_values, dtype=np.float64), 0.0)
        if a.size == 0:
            return np.zeros(0, dtype=np.int64)
        # _bucket_of a value at a time: frexp's exponent of ceil(v) - 1 is
        # its bit_length, exact below 2**53 (above it both give the top).
        v = a / self.base_ms
        _, exp = np.frexp(np.ceil(v) - 1)
        buckets = np.where(v <= 1.0, 0, np.minimum(exp, self.n_buckets)).astype(np.int64)
        add = np.bincount(buckets, minlength=self.n_buckets + 1).astype(np.int64)
        vals = a.tolist()
        with self._lock:
            self._counts += add
            total = self._sum_ms
            for v in vals:
                total += v
            self._sum_ms = total
        return buckets

    def record_many(self, ms_values: Sequence[float]) -> None:
        a = np.asarray(ms_values, dtype=np.float64)
        if a.size == 0:
            return
        a = np.maximum(a, 0.0)
        # side="left": bounds are inclusive upper edges.
        idx = np.searchsorted(self.bounds_ms, a, side="left")
        add = np.bincount(idx, minlength=self.n_buckets + 1).astype(np.int64)
        with self._lock:
            self._counts += add
            self._sum_ms += float(a.sum())

    # ------------------------------------------------------------------
    def merge(self, other: "LatencyHistogram") -> None:
        """Fold another histogram's counts in (same geometry required —
        mergeability is the whole point of fixed buckets)."""
        if (
            other.base_ms != self.base_ms
            or other.n_buckets != self.n_buckets
        ):
            raise ValueError("cannot merge histograms with different geometry")
        counts, total = other.snapshot_counts()
        with self._lock:
            self._counts += counts
            self._sum_ms += total

    def snapshot_counts(self) -> Tuple[np.ndarray, float]:
        with self._lock:
            return self._counts.copy(), self._sum_ms

    @property
    def count(self) -> int:
        with self._lock:
            return int(self._counts.sum())

    @property
    def sum_ms(self) -> float:
        with self._lock:
            return self._sum_ms

    def reset(self) -> None:
        with self._lock:
            self._counts[:] = 0
            self._sum_ms = 0.0

    # ------------------------------------------------------------------
    def percentile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile observation
        (0 < q <= 1). Conservative by construction: the true value is
        <= the returned bound. 0.0 on an empty histogram; the overflow
        bucket reports the largest finite bound."""
        counts, _ = self.snapshot_counts()
        total = int(counts.sum())
        if total == 0:
            return 0.0
        target = max(1, math.ceil(q * total))
        cum = np.cumsum(counts)
        b = int(np.searchsorted(cum, target, side="left"))
        return float(self.bounds_ms[min(b, self.n_buckets - 1)])

    def summary(self) -> dict:
        counts, total_ms = self.snapshot_counts()
        n = int(counts.sum())
        return {
            "count": n,
            "sum_ms": round(total_ms, 3),
            "mean_ms": round(total_ms / n, 4) if n else 0.0,
            "p50_ms": self.percentile(0.50),
            "p99_ms": self.percentile(0.99),
        }

    # ------------------------------------------------------------------
    def prometheus_lines(
        self,
        name: str,
        help_text: str,
        labels: str = "",
        exemplars: Optional[dict] = None,
    ) -> List[str]:
        """Render as a Prometheus histogram family: cumulative
        ``_bucket`` series with ``le`` upper bounds, then ``_sum`` and
        ``_count``. ``labels`` is a pre-rendered ``k="v"`` list (no
        braces) merged with the ``le`` label. ``exemplars`` maps a
        bucket index (``bucket_of``; ``n_buckets`` = the +Inf bucket)
        to ``(trace_id, value_ms)`` — rendered as an OpenMetrics
        exemplar (``# {trace_id="…"} value``) on that bucket line, the
        metrics→trace pivot Grafana/Prometheus follow natively."""
        counts, total_ms = self.snapshot_counts()
        cum = np.cumsum(counts)
        out = [f"# HELP {name} {help_text}", f"# TYPE {name} histogram"]
        sep = "," if labels else ""

        def lbl(le: str) -> str:
            return "{" + labels + sep + f'le="{le}"' + "}"

        def exm(i: int) -> str:
            ex = exemplars.get(i) if exemplars else None
            if ex is None:
                return ""
            tid, value = ex
            return f' # {{trace_id="{tid}"}} {round(float(value), 6)}'

        for i in range(self.n_buckets):
            out.append(
                f"{name}_bucket{lbl(repr(float(self.bounds_ms[i])))}"
                f" {int(cum[i])}{exm(i)}"
            )
        out.append(f"{name}_bucket{lbl('+Inf')} {int(cum[-1])}{exm(self.n_buckets)}")
        brace = ("{" + labels + "}") if labels else ""
        out.append(f"{name}_sum{brace} {total_ms}")
        out.append(f"{name}_count{brace} {int(cum[-1])}")
        return out
