"""Prometheus text-format metric exporter (port of
``sentinel_tpu/transport/prometheus.py``).

Reference: sentinel-metric-exporter/.../jmx/JMXMetricExporter.java:31 —
the reference exports per-resource metric beans over JMX; the Python-
native analog is a ``/metrics`` endpoint on the command center in the
Prometheus exposition format (text/plain; version=0.0.4), scraping the
same per-resource statistics the dashboard pulls.

Beyond the reference's per-resource view, the scrape also exposes the
engine internals the flight recorder collects (metrics/telemetry.py):
``sentinel_engine_*`` counters, ``_bucket`` histogram series for
flush/drain/end-to-end admission latency, the flush-pipeline occupancy
gauge, the per-stage host breakdown of the most recent flush
(``Engine.last_flush_host_ms`` — previously reachable only from
bench.py), and the blocked-resource heavy-hitter sketch.
"""

from __future__ import annotations

import time as _time
from typing import Dict, List, Tuple

_GAUGES: List[Tuple[str, str, str]] = [
    # (prometheus metric suffix, engine stat key, help text)
    ("pass_qps", "pass_qps", "Passed requests per second (1s window)"),
    ("block_qps", "block_qps", "Blocked requests per second (1s window)"),
    ("success_qps", "success_qps", "Completed requests per second (1s window)"),
    ("exception_qps", "exception_qps", "Business exceptions per second (1s window)"),
    ("avg_rt_ms", "avg_rt", "Average response time, ms"),
    ("min_rt_ms", "min_rt", "Minimum response time in window, ms"),
    ("cur_thread_num", "cur_thread_num", "In-flight (concurrent) requests"),
    ("waiting_requests", "waiting", "Tokens borrowed for future windows (occupy)"),
    ("pass_total_minute", "total_pass_minute", "Passed requests, last 60s"),
    ("block_total_minute", "total_block_minute", "Blocked requests, last 60s"),
    ("success_total_minute", "total_success_minute", "Completed requests, last 60s"),
    ("exception_total_minute", "total_exception_minute", "Exceptions, last 60s"),
]

_PREFIX = "sentinel"


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)


def render_metrics(engine, openmetrics: bool = False) -> str:
    """All resources' stats in the Prometheus exposition format.

    ``openmetrics=True`` renders the OpenMetrics dialect: admission
    exemplars (``# {trace_id="…"} value``) on the e2e latency buckets
    and a trailing ``# EOF``. Exemplars are ONLY legal there — the
    classic ``text/plain; version=0.0.4`` parser rejects a mid-line
    ``#``, which would fail the entire scrape — so the default
    (classic) rendering omits them and the handler switches the
    content type along with the format."""
    engine.flush()
    resources = engine.nodes.resources()
    all_rows = [row for _, row in resources] + [engine.nodes.entry_node_row]
    by_row = engine.rows_stats(all_rows)  # one batched device read
    rows: Dict[str, Dict[str, float]] = {
        resource: by_row[row] for resource, row in resources
    }
    entry_stats = by_row[engine.nodes.entry_node_row]

    out: List[str] = []
    for suffix, key, help_text in _GAUGES:
        name = f"{_PREFIX}_{suffix}"
        out.append(f"# HELP {name} {help_text}")
        out.append(f"# TYPE {name} gauge")
        for resource, stats in sorted(rows.items()):
            v = stats.get(key, 0)
            out.append(f'{name}{{resource="{_escape_label(resource)}"}} {v}')
        out.append(f'{name}{{resource="__total_inbound_traffic__"}} {entry_stats.get(key, 0)}')
    # Engine gauges.
    out.append(f"# HELP {_PREFIX}_engine_enabled Global protection switch (1 on)")
    out.append(f"# TYPE {_PREFIX}_engine_enabled gauge")
    out.append(f"{_PREFIX}_engine_enabled {1 if engine.enabled else 0}")
    out.append(f"# HELP {_PREFIX}_resources Known protected resources")
    out.append(f"# TYPE {_PREFIX}_resources gauge")
    out.append(f"{_PREFIX}_resources {len(rows)}")
    out.extend(engine_telemetry_lines(engine, openmetrics=openmetrics))
    if openmetrics:
        out.append("# EOF")
    return "\n".join(out) + "\n"


def _counter(name: str, help_text: str, value, openmetrics: bool = False) -> List[str]:
    # OpenMetrics 1.0 names a counter FAMILY without the _total suffix
    # (the sample keeps it); the classic format metadata uses the full
    # sample name. Emitting the classic shape under the OM content
    # type makes strict OM parsers reject the whole scrape.
    family = name[:-len("_total")] if openmetrics and name.endswith("_total") else name
    return [
        f"# HELP {family} {help_text}",
        f"# TYPE {family} counter",
        f"{name} {value}",
    ]


def _gauge(name: str, help_text: str, value) -> List[str]:
    return [
        f"# HELP {name} {help_text}",
        f"# TYPE {name} gauge",
        f"{name} {value}",
    ]


def engine_telemetry_lines(engine, openmetrics: bool = False) -> List[str]:
    """The ``sentinel_engine_*`` family: flight-recorder counters,
    latency histogram series, pipeline occupancy, last-flush host
    breakdown, intern-cache counters and the blocked-resource sketch.
    Rendered even when telemetry is disabled (zeros) so dashboards keep
    their series. ``openmetrics`` gates the admission exemplars (legal
    only in that dialect — see :func:`render_metrics`)."""
    p = f"{_PREFIX}_engine"
    tele = engine.telemetry
    c = tele.counters_snapshot()
    out: List[str] = []

    def ctr(name: str, help_text: str, value) -> List[str]:
        return _counter(name, help_text, value, openmetrics)
    out += ctr(f"{p}_flushes_total", "Dispatched flush chunks", c["flushes"])
    out += ctr(f"{p}_ops_total", "Ops (entries+exits, incl. bulk rows) flushed", c["ops"])
    out += ctr(
        f"{p}_deferred_flushes_total",
        "Flush chunks dispatched without an inline fetch (pipelined/async)",
        c["deferred_flushes"],
    )
    out += ctr(
        f"{p}_coalesced_fallback_total",
        "Coalesced drain fetches that fell back to per-record fetches",
        c["coalesced_fallbacks"],
    )
    out += ctr(f"{p}_arena_hits_total", "Encode-arena staging pool hits", c["arena_hits"])
    out += ctr(f"{p}_arena_misses_total", "Encode-arena staging pool misses (fresh builds)", c["arena_misses"])

    # Histograms: host-blocking flush time, coalesced drain fetches,
    # end-to-end admission (dispatch start -> verdicts materialized).
    out += tele.hist_flush.prometheus_lines(
        f"{p}_flush_duration_ms", "Host-blocking flush duration, ms"
    )
    out += tele.hist_drain.prometheus_lines(
        f"{p}_drain_duration_ms", "Coalesced device->host drain fetch duration, ms"
    )
    out += tele.hist_e2e.prometheus_lines(
        f"{p}_e2e_duration_ms",
        "End-to-end admission: encode start to verdicts materialized, ms",
    )
    # Sampled per-ADMISSION latency (enqueue -> verdict), the tracer's
    # histogram: its buckets carry the OpenMetrics exemplars — counts
    # and exemplars measure the SAME quantity, so an exemplar never
    # lands on an empty bucket (per-flush e2e above is a different
    # quantity under deferred submission and stays exemplar-free).
    tracer = getattr(engine, "admission_trace", None)
    if tracer is not None:
        out += tracer.hist_latency.prometheus_lines(
            f"{p}_admission_latency_ms",
            "Sampled admission enqueue->verdict latency, ms",
            exemplars=tracer.exemplars() if openmetrics else None,
        )

    # Admission-tracer counters (metrics/admission_trace.py).
    if tracer is not None:
        tc = tracer.counters_snapshot()
        out += ctr(
            f"{p}_trace_records_total",
            "Admission trace records written to the ring",
            tc["recorded"],
        )
        out += ctr(
            f"{p}_trace_head_sampled_total",
            "Records selected by the head sampling decision",
            tc["head_sampled"],
        )
        out += ctr(
            f"{p}_trace_blocked_sampled_total",
            "Records selected by the always-sample-blocked mode only",
            tc["blocked_sampled"],
        )

    # Flush pipeline occupancy (Engine.pipeline_stats — previously a
    # bench.py dead end): mean in-flight depth per dispatching flush,
    # and the 0..1 occupancy against the configured depth.
    ps = engine.pipeline_stats()
    depth = engine.pipeline_depth
    occupancy = (ps["mean_inflight"] / depth) if depth > 0 else 0.0
    out += _gauge(f"{p}_pipeline_depth", "Configured flush pipeline depth", depth)
    out += ctr(
        f"{p}_pipeline_dispatches_total",
        "Dispatching deferred flushes since the last stats reset",
        int(ps["dispatches"]),
    )
    out += _gauge(
        f"{p}_pipeline_mean_inflight",
        "Mean in-flight queue depth sampled per dispatching flush",
        round(ps["mean_inflight"], 6),
    )
    out += _gauge(
        f"{p}_pipeline_occupancy",
        "Pipeline occupancy: mean in-flight depth / configured depth (0..1)",
        round(occupancy, 6),
    )

    # Per-stage host breakdown of the most recent flush
    # (Engine.last_flush_host_ms, wired off the bench-only path).
    lf = engine.last_flush_host_ms
    for stage in ("encode_ms", "dispatch_ms", "kernel_ms", "drain_ms"):
        out += _gauge(
            f"{p}_last_flush_{stage}",
            f"Most recent flush host breakdown: {stage}",
            round(lf.get(stage, 0.0), 6),
        )

    # ParamIndex intern-cache counters (host-ingest fast path).
    pindex = getattr(engine, "param_index", None)
    if pindex is not None and hasattr(pindex, "cache_stats"):
        cs = pindex.cache_stats()
        out += ctr(f"{p}_param_cache_hits_total", "Param resolved-value cache hits", cs["hits"])
        out += ctr(f"{p}_param_cache_misses_total", "Param resolved-value cache misses", cs["misses"])
        out += ctr(f"{p}_param_cache_evictions_total", "Param value-row LRU evictions", cs["evictions"])

    # Failure domain (runtime/failover.py): health state gauge plus
    # degraded-admission counters — the scrape-side view that tells
    # degraded admits from device admits.
    fo = getattr(engine, "failover", None)
    if fo is not None:
        from sentinel_tpu_torch.runtime.failover import HEALTH_GAUGE

        out += _gauge(
            f"{p}_health",
            "Engine health state (0 HEALTHY, 1 DEGRADED, 2 RECOVERING)",
            HEALTH_GAUGE.get(fo.state, 0),
        )
        out += _gauge(
            f"{p}_failover_enabled",
            "Device-failure domain armed (sentinel.tpu.failover.enabled)",
            1 if fo.armed else 0,
        )
        fc = dict(fo.counters)
        out += ctr(
            f"{p}_degraded_admits_total",
            "Admissions decided by the host fallback while DEGRADED",
            fc.get("degraded_admits", 0),
        )
        out += ctr(
            f"{p}_degraded_blocks_total",
            "Blocks decided by the host fallback while DEGRADED (incl. fail-closed sheds)",
            fc.get("degraded_blocks", 0),
        )
        out += ctr(
            f"{p}_quarantined_flushes_total",
            "In-flight flushes quarantined on a device fault",
            fc.get("quarantined_records", 0),
        )
        out += ctr(
            f"{p}_failover_trips_total",
            "HEALTHY->DEGRADED transitions (device faults/timeouts)",
            fc.get("trips", 0),
        )
        out += ctr(
            f"{p}_failover_checkpoints_total",
            "Host checkpoints captured (riding the coalesced fetch)",
            fc.get("checkpoints", 0),
        )
        out += ctr(
            f"{p}_failover_probe_flushes_total",
            "Recovery probe no-op flushes executed",
            fc.get("probe_flushes", 0),
        )

    # Speculative tier (runtime/speculative.py): fast-path verdict
    # counters, reconciliation drift by direction, the per-window drift
    # histogram the differential bound is stated over, and the valve
    # state.
    spec = getattr(engine, "speculative", None)
    if spec is not None:
        sc = dict(spec.counters)
        out += _gauge(
            f"{p}_speculative_enabled",
            "Speculative admission tier armed (sentinel.tpu.speculative.enabled)",
            1 if spec.enabled else 0,
        )
        out += ctr(
            f"{p}_speculative_admits_total",
            "Admissions served by the speculative host tier",
            sc.get("spec_admits", 0),
        )
        out += ctr(
            f"{p}_speculative_blocks_total",
            "Blocks served by the speculative host tier",
            sc.get("spec_blocks", 0),
        )
        out += ctr(
            f"{p}_speculative_declined_total",
            "Ops the speculative tier declined to the device path",
            sc.get("spec_declined", 0),
        )
        out += ctr(
            f"{p}_speculative_over_admits_total",
            "Speculative admits the device settlement blocked",
            sc.get("over_admits", 0),
        )
        out += ctr(
            f"{p}_speculative_under_admits_total",
            "Speculative blocks the device settlement admitted",
            sc.get("under_admits", 0),
        )
        out += ctr(
            f"{p}_speculative_suspensions_total",
            "Drift-valve suspensions (overadmit.max reached in a window)",
            sc.get("suspensions", 0),
        )
        out += _gauge(
            f"{p}_speculative_suspended",
            "Speculation currently suspended by the drift valve (0/1)",
            1 if spec.suspended else 0,
        )
        out += _gauge(
            f"{p}_speculative_max_over_admit_window",
            "Max over-admits observed in any single drift window",
            spec.max_over_admit_window,
        )
        out += tele.hist_spec_drift.prometheus_lines(
            f"{p}_speculative_drift_per_window",
            "Over-admits per closed drift window (speculative vs settled)",
        )
        out += ctr(
            f"{p}_speculative_shaped_total",
            "Shaped (pacer/warm-up) ops served by the host mirror",
            sc.get("spec_shaped", 0),
        )
        out += ctr(
            f"{p}_speculative_system_blocks_total",
            "Host system-gate blocks served by the speculative tier",
            sc.get("spec_system_blocks", 0),
        )

    # Ingest self-protection valve (runtime/ingest.py).
    valve = getattr(engine, "ingest", None)
    if valve is not None:
        ic = dict(valve.counters)
        out += _gauge(
            f"{p}_ingest_armed",
            "Ingest shed valve armed (any sentinel.tpu.ingest.* bound set)",
            1 if valve.armed else 0,
        )
        out += ctr(
            f"{p}_ingest_shed_total",
            "Ops shed at submit by the ingest valve (entries + bulk rows)",
            ic.get("shed_entries", 0) + ic.get("shed_rows", 0),
        )
        out += ctr(
            f"{p}_ingest_shed_queue_total",
            "Sheds caused by a pending-queue bound",
            ic.get("shed_queue", 0),
        )
        out += ctr(
            f"{p}_ingest_shed_deadline_total",
            "Sheds caused by the verdict-deadline estimate",
            ic.get("shed_deadline", 0),
        )
        if valve.armed:
            out += _gauge(
                f"{p}_ingest_estimate_ms",
                "Estimated verdict latency for an op queued now",
                round(valve.estimate_ms(), 3),
            )

    # Blocked-resource heavy-hitter summary (space-saving over the
    # kernel's per-flush top-K): weight = blocked acquire sum. Export
    # K comes from the ONE config-backed home (TelemetryBus.
    # export_topk_k) shared with the `telemetry` command and the
    # sketch tier's candidate listing.
    name = f"{p}_blocked_weight"
    out.append(f"# HELP {name} Blocked acquire weight per resource (space-saving summary)")
    out.append(f"# TYPE {name} gauge")
    for key, cnt, _err in tele.blocked_sketch.topk(tele.export_topk_k):
        out.append(f'{name}{{resource="{_escape_label(key)}"}} {cnt}')

    # Statistics sketch tier (runtime/sketch.py): occupancy, promotion
    # flow, and the estimated-vs-exact error gauge. Rendered even when
    # disarmed (zeros) so dashboards keep their series.
    tier = getattr(engine, "sketch", None)
    if tier is not None:
        out += _gauge(
            f"{p}_sketch_enabled",
            "Statistics sketch tier armed (sentinel.tpu.sketch.enabled)",
            1 if tier.armed else 0,
        )
        out += ctr(
            f"{p}_sketch_keys_total",
            "Distinct keys folded into the device sketch (per-chunk sum)",
            c.get("sketch_keys", 0),
        )
        out += ctr(
            f"{p}_sketch_promotions_total",
            "Heavy-hitter keys promoted to exact dense rows",
            c.get("sketch_promotions", 0),
        )
        out += ctr(
            f"{p}_sketch_demotions_total",
            "Promoted keys demoted back to sketch-only on decay",
            c.get("sketch_demotions", 0),
        )
        out += ctr(
            f"{p}_sketch_host_folds_total",
            "DEGRADED chunks folded into the host space-saving mirror",
            c.get("sketch_host_folds", 0),
        )
        out += _gauge(
            f"{p}_sketch_promoted",
            "Keys currently promoted (values + resources)",
            tier.promoted_count,
        )
        out += _gauge(
            f"{p}_sketch_occupancy",
            "Candidate-table slots in use / capacity (0..1)",
            round(tier.occupancy, 4),
        )
        out += _gauge(
            f"{p}_sketch_est_error_ratio",
            "Mean relative overestimate of candidate counts vs exact host counters",
            round(tier.est_error_ratio, 6),
        )
        out += ctr(
            f"{p}_sketch_cold_blocks_total",
            "Submits blocked by the cold-key admission ceiling "
            "(sentinel.tpu.sketch.cold.qps, count-min estimate)",
            c.get("sketch_cold_blocks", 0),
        )

    # Black-box flight recorder (runtime/capture.py). Rendered even
    # when capture is off (zeros) so dashboards keep their series.
    cap = getattr(engine, "capture", None)
    out += _gauge(
        f"{p}_capture_enabled",
        "Admission capture journal armed (sentinel.tpu.capture.enabled)",
        1 if cap is not None else 0,
    )
    out += ctr(
        f"{p}_capture_chunks_total",
        "Dispatched chunks spilled to the capture journal",
        c.get("capture_chunks", 0),
    )
    out += ctr(
        f"{p}_capture_records_total",
        "Frame/timeline records written to capture segments",
        c.get("capture_records", 0),
    )
    out += ctr(
        f"{p}_capture_bytes_total",
        "Bytes written to capture segments (headers + payloads)",
        c.get("capture_bytes", 0),
    )
    out += ctr(
        f"{p}_capture_rollovers_total",
        "Capture segment rollovers (oldest live segment deleted past the bound)",
        c.get("capture_rollovers", 0),
    )
    out += ctr(
        f"{p}_capture_freezes_total",
        "Postmortem freezes (breaker trip / shed streak / DEGRADED / on-demand)",
        c.get("capture_freezes", 0),
    )
    out += ctr(
        f"{p}_capture_args_dropped_total",
        "Bulk rows captured without their args column (non-serializable column)",
        c.get("capture_args_dropped", 0),
    )

    # Multi-process ingest plane (sentinel_tpu_torch/ipc): ring/worker/frame
    # counters plus the live ring-occupancy and worker gauges. Rendered
    # even when the plane is down (zeros) so dashboards keep their
    # series across restarts.
    plane = getattr(engine, "ipc_plane", None)
    out += _gauge(
        f"{p}_ipc_enabled",
        "Multi-process ingest plane running (sentinel.tpu.ipc.enabled)",
        1 if (plane is not None and not plane.closed) else 0,
    )
    out += _gauge(
        f"{p}_ipc_workers",
        "Worker processes currently attached to the ingest plane",
        plane.live_workers() if plane is not None else 0,
    )
    out += _gauge(
        f"{p}_ipc_ring_occupancy",
        "Request-ring slots in use / capacity (0..1)",
        round(plane.request.occupancy(), 4) if plane is not None else 0.0,
    )
    out += ctr(
        f"{p}_ipc_frames_total",
        "Request frames drained from the shared-memory ring",
        c.get("ipc_frames", 0),
    )
    out += ctr(
        f"{p}_ipc_requests_total",
        "Admission rows carried by drained request frames",
        c.get("ipc_requests", 0),
    )
    out += ctr(
        f"{p}_ipc_sheds_total",
        "Worker-side ring-full sheds folded into the valve accounting",
        c.get("ipc_sheds", 0),
    )
    out += ctr(
        f"{p}_ipc_worker_deaths_total",
        "Workers declared dead on a stale heartbeat (live admissions auto-exited)",
        c.get("ipc_worker_deaths", 0),
    )
    out += ctr(
        f"{p}_ipc_auto_exits_total",
        "Live admissions auto-exited for dead workers (gauges returned to 0)",
        c.get("ipc_auto_exits", 0),
    )
    # Engine supervision & warm hot-restart (ipc/supervise.py): the
    # boot-epoch word doubles as a restart count — epoch 1 is the first
    # engine on these rings, every re-attach bumps it.
    epoch = plane.engine_epoch if plane is not None else 1
    out += _gauge(
        f"{p}_epoch",
        "Engine boot epoch on the current ingest-plane rings "
        "(bumped once per plane attach; 1 = first boot)",
        epoch,
    )
    out += ctr(
        f"{p}_restarts_total",
        "Engine hot-restarts observed on these rings (boot epoch - 1)",
        max(0, epoch - 1),
    )
    out += ctr(
        f"{p}_ipc_worker_reconnects_total",
        "Workers that re-asserted their live-admission ledgers after an "
        "engine hot-restart",
        c.get("ipc_worker_reconnects", 0),
    )
    # Durable checkpoint spill (sentinel.tpu.failover.checkpoint.path):
    # write flow + freshness of the warm-restart file.
    fo = engine.failover
    out += ctr(
        f"{p}_checkpoint_durable_writes_total",
        "Durable checkpoint files written (atomic replace)",
        fo.counters.get("durable_writes", 0),
    )
    out += ctr(
        f"{p}_checkpoint_durable_errors_total",
        "Durable checkpoint spill failures (in-memory checkpoint unaffected)",
        fo.counters.get("durable_write_errors", 0),
    )
    out += ctr(
        f"{p}_checkpoint_durable_cold_loads_total",
        "Durable checkpoint loads that degraded to a cold start "
        "(missing components, corrupt, or stale file)",
        fo.counters.get("durable_load_cold", 0),
    )
    last = fo.last_durable
    out += _gauge(
        f"{p}_checkpoint_durable_age_ms",
        "Age of the last durable checkpoint write (-1 = never written)",
        (max(0, int(_time.time() * 1000) - last[0]) if last else -1),
    )
    out += _gauge(
        f"{p}_checkpoint_durable_write_ms",
        "Serialization + write cost of the last durable spill "
        "(-1 = never written)",
        (round(last[2], 3) if last else -1),
    )
    # Batched cluster token plane (cluster/client.py): the process-wide
    # client stats singleton — deliberately NOT per-engine, because an
    # engine has no cluster client attached until a cluster rule
    # arrives but the families must exist from the first scrape.
    from sentinel_tpu_torch.cluster.client import client_stats

    ccs = client_stats.snapshot()
    out += ctr(
        f"{_PREFIX}_cluster_requests_total",
        "Token decisions asked of the cluster client (all paths)",
        ccs["requests"],
    )
    out += ctr(
        f"{_PREFIX}_cluster_batch_frames_total",
        "Batched token frames sent (FLOW/PARAM_FLOW_REQUEST_BATCH)",
        ccs["batch_frames"],
    )
    out += ctr(
        f"{_PREFIX}_cluster_leases_granted_total",
        "Local quota leases received from the token server",
        ccs["leases_granted"],
    )
    out += ctr(
        f"{_PREFIX}_cluster_lease_admits_total",
        "Admissions served from a local lease (zero RPCs)",
        ccs["lease_admits"],
    )
    out += ctr(
        f"{_PREFIX}_cluster_fallbacks_total",
        "FAIL-family serves (send/timeout/short frame) — caller falls "
        "back to the local decision",
        ccs["fallbacks"],
    )
    out += client_stats.rpc_ms.prometheus_lines(
        f"{_PREFIX}_cluster_rpc_ms",
        "Cluster token RPC round-trip (frame send to verdict), ms",
    )
    # Bounded SHOULD_WAIT pacing actually slept by the engine
    # (sentinel.tpu.cluster.wait.cap.ms caps each op batch).
    out += ctr(
        f"{p}_cluster_wait_ms_total",
        "Milliseconds slept honoring cluster SHOULD_WAIT verdicts "
        "(capped per op batch by sentinel.tpu.cluster.wait.cap.ms)",
        c.get("cluster_wait_ms", 0),
    )

    # Sharded token plane (cluster/shards.py): per-shard labeled rows
    # off the live provider client, so a dead shard's fallbacks and a
    # bounced shard's cleared leases are attributable to THAT shard.
    # Family headers render even when the plane is unsharded (or no
    # client is attached) so dashboards keep their series.
    from sentinel_tpu_torch.cluster.state import TokenClientProvider

    sc = TokenClientProvider.get_client()
    s_rows = sc.shard_rows() if hasattr(sc, "shard_rows") else []
    out += _gauge(
        f"{_PREFIX}_cluster_shard_count",
        "Token shards behind the sharded client (0 = unsharded plane)",
        len(s_rows),
    )
    out += _gauge(
        f"{_PREFIX}_cluster_shard_map_version",
        "Version of the shard map the client currently routes by "
        "(sentinel.tpu.cluster.shards.map.version; -1 = unsharded)",
        sc.shard_map.version if hasattr(sc, "shard_map") else -1,
    )
    for fam, kind, help_text, col in (
        ("connected", "gauge",
         "Shard connection state (1 = TCP connected)", "connected"),
        ("leases", "gauge",
         "Live local-quota leases held against this shard", "leases"),
        ("requests_total", "counter",
         "Token decisions routed to this shard (all stances)",
         "requests"),
        ("batch_frames_total", "counter",
         "Batched token frames sent to this shard", "batch_frames"),
        ("lease_admits_total", "counter",
         "Admissions served from this shard's local leases (zero RPCs)",
         "lease_admits"),
        ("fallbacks_total", "counter",
         "FAIL-family serves on this shard — its flows fell back to "
         "the local decision", "fallbacks"),
    ):
        name = f"{_PREFIX}_cluster_shard_{fam}"
        out.append(f"# HELP {name} {help_text}")
        out.append(f"# TYPE {name} {kind}")
        for r in s_rows:
            v = int(r[col]) if col != "connected" else int(bool(r[col]))
            out.append(
                f'{name}{{shard="{r["shard"]}",'
                f'server="{_escape_label(r["server"])}"}} {v}'
            )

    # Sketch gossip plane (cluster/gossip.py + runtime/sketch.py): the
    # process-wide wire counters plus this engine's fold state — how
    # many peer views the tier currently holds and how many merges it
    # folded, the pair that says fleet-wide promotion is actually fed.
    from sentinel_tpu_torch.cluster.gossip import gossip_stats

    gs = gossip_stats.snapshot()
    gi = engine.sketch.gossip_info()
    out += _gauge(
        f"{p}_gossip_enabled",
        "Sketch gossip armed on this engine (sentinel.tpu.gossip.enabled "
        "with the sketch tier on)",
        1 if gi.get("armed") else 0,
    )
    out += _gauge(
        f"{p}_gossip_remote_origins",
        "Peer engines whose sketch views this tier currently holds",
        # gossip_info carries the origin NAMES (the cluster command
        # shows them); the gauge is their count.
        len(gi.get("remote_origins") or ()),
    )
    out += ctr(
        f"{p}_gossip_merges_total",
        "Remote sketch views folded into this tier (snapshot-replace "
        "per origin)",
        gi.get("merges", 0),
    )
    out += ctr(
        f"{p}_gossip_rounds_total",
        "Gossip push rounds driven by this process",
        gs["rounds"],
    )
    out += ctr(
        f"{p}_gossip_frames_sent_total",
        "SKETCH_PUSH/SKETCH_MERGED frames sent",
        gs["frames_sent"],
    )
    out += ctr(
        f"{p}_gossip_frames_received_total",
        "SKETCH_PUSH/SKETCH_MERGED frames received",
        gs["frames_received"],
    )
    out += ctr(
        f"{p}_gossip_version_rejects_total",
        "Foreign-GOSSIP_VERSION frames answered with an empty merged "
        "frame (mixed-version fleet degrades to per-engine promotion)",
        gs["version_rejects"],
    )
    out += ctr(
        f"{p}_gossip_errors_total",
        "Gossip round/peer failures (dead peer, timeout, bad frame)",
        gs["errors"],
    )

    # Param admission path selection (Engine._encode_param): batches
    # routed to the closed-form rank path vs the rounds/scan family —
    # the pick the self-tuning cost memo arbitrates when enabled.
    out += ctr(
        f"{p}_param_closed_form_total",
        "Param batches routed to the closed-form rank path",
        c.get("param_closed_form", 0),
    )
    out += ctr(
        f"{p}_param_scan_total",
        "Param batches routed to the rounds/scan family",
        c.get("param_scan", 0),
    )

    # Self-tuning control plane (runtime/autotune.py): whether the
    # loop is closed, what it currently holds the knobs at, and how
    # often it moves them. Rendered even when disabled (zeros/current
    # static values) so dashboards keep their series.
    at = getattr(engine, "autotune", None)
    if at is not None:
        out += _gauge(
            f"{p}_autotune_enabled",
            "Self-tuning control plane armed (sentinel.tpu.autotune.enabled)",
            1 if at.enabled else 0,
        )
        out += ctr(
            f"{p}_autotune_decisions_total",
            "Applied autotune knob changes (depth / window retunes)",
            c.get("autotune_decisions", 0),
        )
        out += _gauge(
            f"{p}_autotune_depth",
            "Pipeline depth currently in effect (autotune-chosen when armed)",
            engine.pipeline_depth,
        )
        w = getattr(engine, "ingest_window", None)
        if w is not None:
            out += _gauge(
                f"{p}_autotune_window_ms",
                "Batch-window length currently in effect, ms",
                round(w.window_ms, 3),
            )
            out += _gauge(
                f"{p}_autotune_window_batch_max",
                "Batch-window early-flush bound currently in effect",
                w.batch_max,
            )
    out += resource_provenance_lines(engine, openmetrics=openmetrics)
    return out


def _configured_resources(engine) -> set:
    """Resources an operator explicitly configured a rule for — these
    always deserve their own label row (the operator asked about them
    by name)."""
    out = set()
    for idx_attr in ("flow_index", "degrade_index", "param_index"):
        idx = getattr(engine, idx_attr, None)
        out.update(getattr(idx, "by_resource", {}) or {})
    out.update(getattr(engine, "authority_rules", {}) or {})
    return out


def resource_provenance_lines(engine, openmetrics: bool = False) -> List[str]:
    """The ``sentinel_resource_*`` family: per-resource two-tier
    admission provenance (metrics/provenance.py totals) with BOUNDED
    label cardinality — label rows are granted only to configured
    resources (rule-bearing) and the blocked-weight top-K sketch's
    current heavy hitters; every other resource folds into one
    ``resource="__other__"`` row — the same collision-proof fold label
    the metric-log plane uses, so the row has ONE identity across both
    exports and no user resource name can shadow it (PAPERS.md
    1902.06993: bound the export with the sketch, not one series per
    key). Empty when the ledger is disabled
    (``sentinel.tpu.metrics.resource.enabled=false``)."""
    rm = getattr(engine, "resource_metrics", None)
    if rm is None or not rm.enabled:
        return []
    from sentinel_tpu_torch.metrics.provenance import OTHER_RESOURCE

    tele = engine.telemetry
    allowed = _configured_resources(engine)
    allowed.update(
        k for k, _c, _e in tele.blocked_sketch.topk(tele.export_topk_k)
    )
    totals = rm.totals()
    folded: Dict[str, List[int]] = {}
    for res, cells in totals.items():
        key = (
            res if (res in allowed and res != OTHER_RESOURCE)
            else OTHER_RESOURCE
        )
        agg = folded.setdefault(key, [0, 0, 0, 0])
        for i, v in enumerate(cells):
            agg[i] += v
    out: List[str] = []
    fams = [
        ("speculative_total", 0, "counter",
         "Acquire-weighted verdicts served by the speculative host tier"),
        ("degraded_total", 1, "counter",
         "Acquire-weighted verdicts served by the host fallback while DEGRADED"),
        ("shed_total", 2, "counter",
         "Acquire-weighted ops shed at submit by the ingest valve"),
        ("drift", 3, "gauge",
         "Net speculative over-admit (over minus under reconciliation mismatches)"),
    ]
    for suffix, col, kind, help_text in fams:
        name = f"{_PREFIX}_resource_{suffix}"
        family = (
            name[: -len("_total")]
            if openmetrics and kind == "counter" and name.endswith("_total")
            else name
        )
        out.append(f"# HELP {family} {help_text}")
        out.append(f"# TYPE {family} {kind}")
        for res in sorted(folded):
            out.append(
                f'{name}{{resource="{_escape_label(res)}"}} {folded[res][col]}'
            )
    return out


def worker_metric_lines(client=None, openmetrics: bool = False) -> List[str]:
    """The ``sentinel_worker_*`` family: one worker process's
    IngestClient counters — admissions, frames-per-entry amortization,
    shed causes (ring sheds vs policy serves vs dropped completions)
    and reconnect state. ``client=None`` renders zero-valued families
    (the metrics-federation twin of the cluster singletons: the
    families must exist from the first scrape, and the config audit
    introspects this render without a live plane)."""
    p = f"{_PREFIX}_worker"
    snap = client.snapshot() if client is not None else {}
    c = snap.get("counters", {})
    out: List[str] = []

    def ctr(name: str, help_text: str, value) -> List[str]:
        return _counter(name, help_text, value, openmetrics)

    out += ctr(f"{p}_entries_total",
               "Per-call admissions pushed through the plane", c.get("entries", 0))
    out += ctr(f"{p}_bulk_rows_total",
               "Bulk admission rows pushed through the plane", c.get("bulk_rows", 0))
    out += ctr(f"{p}_exits_total",
               "Completions delivered to the engine", c.get("exits", 0))
    out += ctr(f"{p}_exits_dropped_total",
               "Completions dropped (engine provably gone)", c.get("exits_dropped", 0))
    out += ctr(f"{p}_sheds_total",
               "Local BLOCK_SHED verdicts (request ring full)", c.get("sheds", 0))
    out += ctr(f"{p}_policy_served_total",
               "Verdicts served from the failover policy snapshot "
               "(engine dead or verdict timeout)", c.get("policy_served", 0))
    out += ctr(f"{p}_frames_total",
               "Request frames pushed onto the shared-memory ring", c.get("frames", 0))
    out += ctr(f"{p}_window_flushes_total",
               "Client micro-window flushes", c.get("window_flushes", 0))
    out += ctr(f"{p}_reconnects_total",
               "Engine hot-restart reconnects (boot epoch bumps seen)",
               c.get("reconnects", 0))
    out += ctr(f"{p}_dead_suspicions_total",
               "Death-confirmation episodes opened (heartbeat stale past "
               "ipc.engine.dead.ms)", c.get("dead_suspicions", 0))
    out += ctr(f"{p}_dead_false_alarms_total",
               "Suspicion episodes cleared by a fresh heartbeat or live "
               "pid probe (engine was busy, not dead)",
               c.get("dead_false_alarms", 0))
    out += ctr(f"{p}_dead_declared_total",
               "Suspicion episodes that ended in a confirmed death "
               "declaration", c.get("dead_declared", 0))
    out += ctr(f"{p}_handoff_holds_total",
               "Admissions held through a planned-handoff window instead "
               "of failing to the policy path", c.get("handoff_holds", 0))
    ops = c.get("entries", 0) + c.get("bulk_rows", 0)
    out += _gauge(
        f"{p}_frames_per_entry",
        "Request frames per admission row (micro-window amortization; "
        "1.0 = per-call framing)",
        round(c.get("frames", 0) / ops, 4) if ops else 0.0,
    )
    out += _gauge(f"{p}_engine_alive",
                  "Engine heartbeat fresh from this worker's view (1 = alive)",
                  int(bool(snap.get("engine_alive", 0))))
    out += _gauge(f"{p}_live_admissions",
                  "Admissions this worker holds open (reconnect ledger)",
                  snap.get("live_admissions", 0))
    out += _gauge(f"{p}_pending_waits",
                  "Callers parked waiting for a verdict",
                  snap.get("pending_waits", 0))
    out += _gauge(f"{p}_buffered_exits",
                  "Completions buffered for post-restart replay",
                  snap.get("buffered_exits", 0))
    out += _gauge(f"{p}_id", "This process's worker slot id",
                  snap.get("worker_id", -1))
    return out


def render_worker_metrics(client=None, openmetrics: bool = False) -> str:
    """Full exposition for a worker-mode process (no engine to
    render — the worker families ARE its scrape)."""
    out = worker_metric_lines(client, openmetrics=openmetrics)
    if openmetrics:
        out.append("# EOF")
    return "\n".join(out) + "\n"


def cluster_server_metric_lines(server=None, openmetrics: bool = False) -> List[str]:
    """The ``sentinel_cluster_server_*`` family: a token shard's work
    clocks (decisions, frames, busy seconds), lease grants, connection
    count per namespace, and the per-(category,outcome) stat-log rows.
    ``server=None`` renders zero-valued families for the same
    first-scrape/audit reasons as the worker render."""
    p = f"{_PREFIX}_cluster_server"
    work = server.work_stats() if server is not None else {}
    out: List[str] = []

    def ctr(name: str, help_text: str, value) -> List[str]:
        return _counter(name, help_text, value, openmetrics)

    out += ctr(f"{p}_decisions_total",
               "Token decisions made by this shard", work.get("decisions", 0))
    out += ctr(f"{p}_frames_total",
               "Request frames handled (decode->decide->pack)",
               work.get("frames", 0))
    out += ctr(f"{p}_busy_seconds_total",
               "Handler seconds spent deciding (excluding socket waits)",
               round(work.get("busy_s", 0.0), 6))
    out += ctr(f"{p}_lease_grants_total",
               "Local-quota leases granted to clients", work.get("lease_grants", 0))
    name = f"{p}_connections"
    out.append(f"# HELP {name} Connected token clients per namespace")
    out.append(f"# TYPE {name} gauge")
    groups = server.connections.snapshot() if server is not None else {}
    for ns, n in sorted(groups.items()):
        out.append(f'{name}{{namespace="{_escape_label(ns)}"}} {n}')
    if not groups:
        out.append(f'{name}{{namespace="default"}} 0')
    from sentinel_tpu_torch.cluster import stat_log

    name = f"{p}_stat_total"
    fam = name[:-len("_total")] if openmetrics else name
    out.append(f"# HELP {fam} Stat-log lines per (category, outcome) "
               "— the wire twin of sentinel-cluster.log")
    out.append(f"# TYPE {fam} counter")
    counts = stat_log.counters_snapshot() if server is not None else {}
    for key, n in sorted(counts.items()):
        cat, _, outcome = key.partition(".")
        out.append(
            f'{name}{{category="{_escape_label(cat)}",'
            f'outcome="{_escape_label(outcome)}"}} {n}'
        )
    if not counts:
        out.append(f'{name}{{category="flow",outcome="pass"}} 0')
    return out


def render_cluster_server_metrics(server=None, openmetrics: bool = False) -> str:
    """Full exposition for a token shard process."""
    out = cluster_server_metric_lines(server, openmetrics=openmetrics)
    if openmetrics:
        out.append("# EOF")
    return "\n".join(out) + "\n"
