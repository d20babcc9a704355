"""The per-resource admission-provenance ledger of the metric plane (port
of ``sentinel_tpu/metrics/provenance.py``).

The host-side (second, resource) ledger that the engine's two-tier
signals fold into:

* ``speculative``: ops whose caller-visible verdict came from the
  speculative host tier (admits and blocks, acquire-weighted like the
  device PASS/BLOCK columns);
* ``degraded``: ops served by the host fallback while the device was lost
  (not disjoint from ``speculative``: a speculative serve while DEGRADED
  carries both marks, as ``Verdict.speculative`` composes with
  ``Verdict.degraded``);
* ``shed``: ops the ingest valve refused at submit (BLOCK_SHED; they never
  reach the device);
* ``drift``: net over-admit (over minus under reconciliation mismatches,
  signed) per resource.

Every event is attributed to the op's submit-ts second, so a depth-K
settle never smears one arrival second over the seconds its drains land
in. The metric timer drains completed seconds into the v2 columns of
:class:`~sentinel_tpu_torch.metrics.metric_log.MetricNodeLine`. The
ledger folds resources past ``sentinel.tpu.metrics.resource.capacity``
into the ``__other__`` row.

Write cadence: the admission fast path never writes the ledger.
Speculative serves are noted per settled chunk
(``Engine._fill_results`` -> :meth:`ResourceProvenance.note_serves_batch`)
or, while the device is lost, in the degraded fill; bulk groups note once
per group (:meth:`note_col`); sheds and degraded fills note on their own
paths. Disabled (``sentinel.tpu.metrics.resource.enabled=false``) the
engine pays one bool read per call site.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import numpy as np

from sentinel_tpu_torch.utils.config import config

# The fold row for resources past the cardinality cap. Double
# underscores like the reference's __total_inbound_traffic__ pseudo
# resource, so no user resource name can collide with it.
OTHER_RESOURCE = "__other__"

# Column order of the internal per-(second, resource) cells.
_SPEC, _DEGRADED, _SHED, _OVER, _UNDER = range(5)


class ResourceProvenance:
    """Engine-scoped (one per Engine) submit-ts-second × resource
    provenance ledger; see module doc. All methods are thread-safe and
    the lock is a leaf (call sites may hold engine or tier locks)."""

    # Seconds retained before the oldest is evicted — the metric timer
    # drains every second; a stopped timer must not leak (same bound as
    # TelemetryBus._SEC_CAP).
    SEC_CAP = 600

    def __init__(self, enabled=None, capacity=None) -> None:
        self.enabled = (
            config.get_bool(config.RESOURCE_METRICS_ENABLED, True)
            if enabled is None
            else bool(enabled)
        )
        self.capacity = max(
            8,
            capacity
            if capacity is not None
            else config.get_int(config.RESOURCE_METRICS_CAP, 256),
        )
        self._lock = threading.Lock()
        # sec(rel ms, second-aligned) -> resource -> [spec, degraded,
        # shed, over, under]
        self._sec: Dict[int, Dict[str, List[int]]] = {}
        # Cumulative per-resource totals (Prometheus export), same cell
        # layout, folded to OTHER_RESOURCE past capacity.
        self._totals: Dict[str, List[int]] = {}

    # ------------------------------------------------------------------
    # writers (engine / speculative tier / failover call sites — each
    # gated on ``self.enabled`` by the caller)
    # ------------------------------------------------------------------
    def _cell(self, table: Dict[str, List[int]], resource: str) -> List[int]:
        cell = table.get(resource)
        if cell is None:
            # One slot is reserved for the fold row, so a table never
            # exceeds `capacity` entries including __other__.
            if resource != OTHER_RESOURCE and len(table) >= self.capacity - 1:
                return self._cell(table, OTHER_RESOURCE)
            cell = table[resource] = [0, 0, 0, 0, 0]
        return cell

    def _cells_locked(self, ts_rel_ms: int, resource: str):
        """(per-second cell, totals cell) for one event's key — fetched
        once per note; this is the speculative fast path's ledger cost."""
        sec = int(ts_rel_ms) // 1000 * 1000
        table = self._sec.get(sec)
        if table is None:
            if len(self._sec) >= self.SEC_CAP:
                self._sec.pop(min(self._sec), None)
            table = self._sec[sec] = {}
        return self._cell(table, resource), self._cell(self._totals, resource)

    def note(
        self,
        ts_rel_ms: int,
        resource: str,
        spec: int = 0,
        degraded: int = 0,
        shed: int = 0,
        over: int = 0,
        under: int = 0,
    ) -> None:
        """One op's provenance events at its submit ts (engine-clock
        relative ms). Weights follow the device PASS/BLOCK convention:
        acquire-weighted serves/sheds, per-op mismatch weights."""
        with self._lock:
            cell, tot = self._cells_locked(ts_rel_ms, resource)
            for col, n in (
                (_SPEC, spec), (_DEGRADED, degraded), (_SHED, shed),
                (_OVER, over), (_UNDER, under),
            ):
                if n:
                    cell[col] += n
                    tot[col] += n

    def note_serves_batch(self, acc: Dict[Tuple[int, str], list]) -> None:
        """One settled chunk's speculative serve notes in one locked
        pass: ``{(submit-sec rel ms, resource): [spec_n, degraded_n]}``
        — the singles fast path pays ZERO ledger cost at admission
        time; `Engine._fill_results` accumulates into a plain local
        dict per chunk and hands it over here (one call per chunk, so
        the per-op share is dict-add cheap)."""
        with self._lock:
            for (sec, resource), (n, d) in acc.items():
                cell, tot = self._cells_locked(sec, resource)
                cell[_SPEC] += n
                tot[_SPEC] += n
                if d:
                    cell[_DEGRADED] += d
                    tot[_DEGRADED] += d

    def note_col(
        self,
        resource: str,
        ts_col,
        weights=None,
        spec: bool = False,
        degraded: bool = False,
        shed: bool = False,
        over: bool = False,
        under: bool = False,
    ) -> None:
        """Columnar writer for bulk groups: ``ts_col`` (int ms, one per
        event row) is grouped by submit second host-side; ``weights``
        (same length; default all-1) is summed per second. The flag set
        selects which columns receive the per-second sums."""
        ts = np.asarray(ts_col)
        if ts.size == 0:
            return
        secs = (ts.astype(np.int64) // 1000) * 1000
        w = (
            np.ones(ts.shape[0], dtype=np.int64)
            if weights is None
            else np.asarray(weights, dtype=np.int64)
        )
        uniq, inv = np.unique(secs, return_inverse=True)
        sums = np.bincount(inv, weights=w.astype(np.float64)).astype(np.int64)
        cols = [
            c
            for c, on in (
                (_SPEC, spec), (_DEGRADED, degraded), (_SHED, shed),
                (_OVER, over), (_UNDER, under),
            )
            if on
        ]
        with self._lock:
            for s, n in zip(uniq.tolist(), sums.tolist()):
                if not n:
                    continue
                cell, tot = self._cells_locked(int(s), resource)
                for c in cols:
                    cell[c] += int(n)
                    tot[c] += int(n)

    # ------------------------------------------------------------------
    # readers
    # ------------------------------------------------------------------
    def drain_seconds(
        self, upto_rel_ms: int
    ) -> List[Tuple[int, str, int, int, int, int]]:
        """Completed engine-clock seconds strictly before
        ``upto_rel_ms`` (second-aligned), removed from the ledger:
        ``[(sec_rel_ms, resource, speculative, degraded, shed, drift)]``
        ascending by (second, resource) — the metric-log timer's pull.
        ``drift`` is signed net over-admit (over − under)."""
        out: List[Tuple[int, str, int, int, int, int]] = []
        with self._lock:
            for sec in sorted(self._sec):
                if sec >= upto_rel_ms:
                    break
                table = self._sec.pop(sec)
                for resource in sorted(table):
                    c = table[resource]
                    if not any(c):
                        continue
                    out.append(
                        (sec, resource, c[_SPEC], c[_DEGRADED], c[_SHED],
                         c[_OVER] - c[_UNDER])
                    )
        return out

    def totals(self) -> Dict[str, Tuple[int, int, int, int]]:
        """Cumulative ``resource -> (speculative, degraded, shed,
        drift)`` — the Prometheus exporter's read (drift signed)."""
        with self._lock:
            return {
                r: (c[_SPEC], c[_DEGRADED], c[_SHED], c[_OVER] - c[_UNDER])
                for r, c in self._totals.items()
            }

    def snapshot(self) -> dict:
        with self._lock:
            open_secs = len(self._sec)
            tracked = len(self._totals)
        return {
            "enabled": self.enabled,
            "capacity": self.capacity,
            "open_seconds": open_secs,
            "tracked_resources": tracked,
            "totals": self.totals(),
        }

    def reset(self) -> None:
        with self._lock:
            self._sec.clear()
            self._totals.clear()
