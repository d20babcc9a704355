"""Layered configuration (the port's own copy of ``sentinel_tpu/utils/config.py``).

Layers: runtime ``set()`` > environment ``SENTINEL_TPU_*`` (or the
reference-compatible ``CSP_SENTINEL_*``) > properties file > defaults.
Every key string and default is identical to the JAX package's, so an
existing properties file or environment drives both packages the same
way.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional


def _parse_properties(text: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or line.startswith("!"):
            continue
        for sep in ("=", ":"):
            if sep in line:
                k, _, v = line.partition(sep)
                out[k.strip()] = v.strip()
                break
    return out


class SentinelConfig:
    """Key registry + typed accessors (key names keep the reference's
    ``csp.sentinel.*`` spelling; ``sentinel.tpu.*`` keys are the batched
    engine's own)."""

    APP_NAME = "project.name"
    APP_TYPE = "csp.sentinel.app.type"
    CHARSET = "csp.sentinel.charset"
    SINGLE_METRIC_FILE_SIZE = "csp.sentinel.metric.file.single.size"
    TOTAL_METRIC_FILE_COUNT = "csp.sentinel.metric.file.total.count"
    COLD_FACTOR = "csp.sentinel.flow.cold.factor"
    STATISTIC_MAX_RT = "csp.sentinel.statistic.max.rt"
    SPI_CLASSLOADER = "csp.sentinel.spi.classloader"
    METRIC_FLUSH_INTERVAL = "csp.sentinel.metric.flush.interval"
    FLUSH_INTERVAL_MS = "sentinel.tpu.flush.interval.ms"
    FLUSH_MAX_BATCH = "sentinel.tpu.flush.max.batch"
    FLUSH_MAX_INFLIGHT = "sentinel.tpu.flush.max.inflight"
    OCCUPY_TIMEOUT_MS = "csp.sentinel.statistic.occupy.timeout"
    INITIAL_ROWS = "sentinel.tpu.rows.initial"
    HOST_FASTPATH = "sentinel.tpu.host.fastpath"
    PIPELINE_DEPTH = "sentinel.tpu.host.pipeline.depth"
    ARENA_MAX_KEYS = "sentinel.tpu.host.arena.max.keys"
    ARENA_PER_KEY = "sentinel.tpu.host.arena.per.key"
    TELEMETRY_ENABLED = "sentinel.tpu.telemetry.enabled"
    TELEMETRY_RING = "sentinel.tpu.telemetry.ring"
    TELEMETRY_BLOCKED_TOPK_K = "sentinel.tpu.telemetry.blocked.topk.k"
    TELEMETRY_SKETCH_K = "sentinel.tpu.telemetry.sketch.k"
    TELEMETRY_BLOCKED_TOPK_CAP = "sentinel.tpu.telemetry.blocked.topk.capacity"
    TELEMETRY_SKETCH_CAP = "sentinel.tpu.telemetry.sketch.capacity"
    TELEMETRY_TOPK_EXPORT = "sentinel.tpu.telemetry.topk.export"
    SKETCH_ENABLED = "sentinel.tpu.sketch.enabled"
    SKETCH_DEPTH = "sentinel.tpu.sketch.depth"
    SKETCH_WIDTH = "sentinel.tpu.sketch.width"
    SKETCH_CANDIDATES = "sentinel.tpu.sketch.candidates"
    SKETCH_WINDOW_MS = "sentinel.tpu.sketch.window.ms"
    SKETCH_PROMOTE_QPS = "sentinel.tpu.sketch.promote.qps"
    SKETCH_RESOURCE_QPS = "sentinel.tpu.sketch.resource.qps"
    SKETCH_PROMOTE_MAX = "sentinel.tpu.sketch.promote.max"
    SKETCH_DEMOTE_WINDOWS = "sentinel.tpu.sketch.demote.windows"
    SKETCH_NAMES_CAP = "sentinel.tpu.sketch.names.capacity"
    TRACE_ENABLED = "sentinel.tpu.trace.enabled"
    TRACE_RING = "sentinel.tpu.trace.ring"
    TRACE_SAMPLE_RATE = "sentinel.tpu.trace.sample.rate"
    TRACE_SAMPLE_BLOCKED = "sentinel.tpu.trace.sample.blocked"
    TRACE_BULK_CAP = "sentinel.tpu.trace.bulk.cap"
    FAILOVER_ENABLED = "sentinel.tpu.failover.enabled"
    FAILOVER_FETCH_TIMEOUT_MS = "sentinel.tpu.failover.fetch.timeout.ms"
    FAILOVER_POLICY = "sentinel.tpu.failover.policy"
    FAILOVER_CHECKPOINT_EVERY = "sentinel.tpu.failover.checkpoint.every"
    FAILOVER_PROBE_FLUSHES = "sentinel.tpu.failover.probe.flushes"
    FAILOVER_RETRY_MS = "sentinel.tpu.failover.retry.ms"
    FAILOVER_CKPT_PATH = "sentinel.tpu.failover.checkpoint.path"
    FAILOVER_CKPT_INTERVAL_MS = "sentinel.tpu.failover.checkpoint.interval.ms"
    FAILOVER_CKPT_STALE_MS = "sentinel.tpu.failover.checkpoint.stale.ms"
    SPECULATIVE_ENABLED = "sentinel.tpu.speculative.enabled"
    SPECULATIVE_FLUSH_BATCH = "sentinel.tpu.speculative.flush.batch"
    SPECULATIVE_OVERADMIT_MAX = "sentinel.tpu.speculative.overadmit.max"
    SPECULATIVE_WINDOW_MS = "sentinel.tpu.speculative.drift.window.ms"
    SPECULATIVE_SHAPING = "sentinel.tpu.speculative.shaping.enabled"
    INGEST_MAX_PENDING = "sentinel.tpu.ingest.max.pending"
    INGEST_MAX_PENDING_BULK = "sentinel.tpu.ingest.max.pending.bulk"
    INGEST_BATCH_WINDOW_MS = "sentinel.tpu.ingest.batch.window.ms"
    INGEST_BATCH_MAX = "sentinel.tpu.ingest.batch.max"
    INGEST_DEADLINE_MS = "sentinel.tpu.ingest.deadline.ms"
    AUTOTUNE_ENABLED = "sentinel.tpu.autotune.enabled"
    AUTOTUNE_INTERVAL_MS = "sentinel.tpu.autotune.interval.ms"
    AUTOTUNE_COOLDOWN_MS = "sentinel.tpu.autotune.cooldown.ms"
    AUTOTUNE_DEPTH_MAX = "sentinel.tpu.autotune.depth.max"
    AUTOTUNE_MIN_FLUSHES = "sentinel.tpu.autotune.min.flushes"
    AUTOTUNE_OCC_HIGH = "sentinel.tpu.autotune.occupancy.high"
    AUTOTUNE_OCC_LOW = "sentinel.tpu.autotune.occupancy.low"
    AUTOTUNE_IDLE_TICKS = "sentinel.tpu.autotune.idle.ticks"
    AUTOTUNE_RAISE_FRAC = "sentinel.tpu.autotune.raise.frac"
    AUTOTUNE_STALL_FRAC = "sentinel.tpu.autotune.stall.frac"
    AUTOTUNE_WINDOW_MS_MAX = "sentinel.tpu.autotune.window.ms.max"
    AUTOTUNE_WINDOW_BATCH_MAX = "sentinel.tpu.autotune.window.batch.max"
    AUTOTUNE_PARAM_PATH = "sentinel.tpu.autotune.param.path"
    AUTOTUNE_PARAM_EXPLORE = "sentinel.tpu.autotune.param.explore"
    AUTOTUNE_PARAM_MARGIN = "sentinel.tpu.autotune.param.margin"
    AUTOTUNE_LOG = "sentinel.tpu.autotune.log"
    AUTOTUNE_PARAM_SEED_FILE = "sentinel.tpu.autotune.param.seed.file"
    SKETCH_COLD_QPS = "sentinel.tpu.sketch.cold.qps"
    IPC_ENABLED = "sentinel.tpu.ipc.enabled"
    IPC_RING_SLOTS = "sentinel.tpu.ipc.ring.slots"
    IPC_SLOT_BYTES = "sentinel.tpu.ipc.slot.bytes"
    IPC_RESP_SLOTS = "sentinel.tpu.ipc.response.slots"
    IPC_WORKERS_MAX = "sentinel.tpu.ipc.workers.max"
    IPC_HEARTBEAT_MS = "sentinel.tpu.ipc.heartbeat.ms"
    IPC_WORKER_DEAD_MS = "sentinel.tpu.ipc.worker.dead.ms"
    IPC_ENGINE_DEAD_MS = "sentinel.tpu.ipc.engine.dead.ms"
    IPC_ENGINE_DEAD_CONFIRM_MS = "sentinel.tpu.ipc.engine.dead.confirm.ms"
    IPC_TIMEOUT_MS = "sentinel.tpu.ipc.timeout.ms"
    IPC_POLL_US = "sentinel.tpu.ipc.poll.us"
    IPC_CLIENT_WINDOW_MS = "sentinel.tpu.ipc.client.window.ms"
    IPC_CLIENT_WINDOW_MAX = "sentinel.tpu.ipc.client.window.max"
    IPC_WAKEUP = "sentinel.tpu.ipc.wakeup"
    IPC_WAKEUP_SPIN_US = "sentinel.tpu.ipc.wakeup.spin.us"
    IPC_WAKEUP_PARK_MS = "sentinel.tpu.ipc.wakeup.park.ms"
    IPC_WORKER_MODE = "sentinel.tpu.ipc.worker.mode"
    IPC_SHM_PREFIX = "sentinel.tpu.ipc.shm.prefix"
    IPC_RECONNECT = "sentinel.tpu.ipc.reconnect.enabled"
    IPC_RECONNECT_EXITS_MAX = "sentinel.tpu.ipc.reconnect.exits.max"
    IPC_HANDOFF_WAIT_MS = "sentinel.tpu.ipc.handoff.wait.ms"
    SUPERVISE_BACKOFF_MS = "sentinel.tpu.supervise.backoff.ms"
    SUPERVISE_BACKOFF_MAX_MS = "sentinel.tpu.supervise.backoff.max.ms"
    SUPERVISE_RESTARTS_MAX = "sentinel.tpu.supervise.restarts.max"
    SUPERVISE_STANDBY = "sentinel.tpu.supervise.standby.enabled"
    SUPERVISE_STANDBY_WARM_MS = "sentinel.tpu.supervise.standby.warm.interval.ms"
    RESOURCE_METRICS_ENABLED = "sentinel.tpu.metrics.resource.enabled"
    RESOURCE_METRICS_CAP = "sentinel.tpu.metrics.resource.capacity"
    CLUSTER_CLIENT_WINDOW_MS = "sentinel.tpu.cluster.client.window.ms"
    CLUSTER_CLIENT_WINDOW_MAX = "sentinel.tpu.cluster.client.window.max"
    CLUSTER_LEASE_ENABLED = "sentinel.tpu.cluster.lease.enabled"
    CLUSTER_LEASE_MIN_BATCH = "sentinel.tpu.cluster.lease.min.batch"
    CLUSTER_LEASE_FRAC = "sentinel.tpu.cluster.lease.frac"
    CLUSTER_LEASE_MAX = "sentinel.tpu.cluster.lease.max"
    CLUSTER_LEASE_TTL_MS = "sentinel.tpu.cluster.lease.ttl.ms"
    CLUSTER_WAIT_CAP_MS = "sentinel.tpu.cluster.wait.cap.ms"
    CLUSTER_SHARDS = "sentinel.tpu.cluster.shards"
    CLUSTER_SHARDS_MAP = "sentinel.tpu.cluster.shards.map"
    CLUSTER_SHARDS_MAP_VERSION = "sentinel.tpu.cluster.shards.map.version"
    GOSSIP_ENABLED = "sentinel.tpu.gossip.enabled"
    GOSSIP_PORT = "sentinel.tpu.gossip.port"
    GOSSIP_PEERS = "sentinel.tpu.gossip.peers"
    GOSSIP_INTERVAL_MS = "sentinel.tpu.gossip.interval.ms"
    GOSSIP_STALE_WINDOWS = "sentinel.tpu.gossip.stale.windows"
    SPANS_ENABLED = "sentinel.tpu.spans.enabled"
    SPANS_RING = "sentinel.tpu.spans.ring"
    SPANS_DIR = "sentinel.tpu.spans.dir"
    SPANS_SPILL_EVERY = "sentinel.tpu.spans.spill.every"
    CAPTURE_ENABLED = "sentinel.tpu.capture.enabled"
    CAPTURE_DIR = "sentinel.tpu.capture.dir"
    CAPTURE_SEGMENT_BYTES = "sentinel.tpu.capture.segment.bytes"
    CAPTURE_SEGMENTS_MAX = "sentinel.tpu.capture.segments.max"
    CAPTURE_FREEZE_SECONDS = "sentinel.tpu.capture.freeze.seconds"
    CAPTURE_FROZEN_MAX = "sentinel.tpu.capture.frozen.max"
    CAPTURE_SHED_STREAK = "sentinel.tpu.capture.freeze.shed.streak"
    LOG_DIR = "csp.sentinel.log.dir"

    DEFAULTS: Dict[str, str] = {
        APP_TYPE: "0",
        CHARSET: "utf-8",
        SINGLE_METRIC_FILE_SIZE: str(1024 * 1024 * 50),
        TOTAL_METRIC_FILE_COUNT: "6",
        COLD_FACTOR: "3",
        STATISTIC_MAX_RT: "4900",  # reference: SentinelConfig.java DEFAULT_STATISTIC_MAX_RT
        METRIC_FLUSH_INTERVAL: "1",
        FLUSH_INTERVAL_MS: "2",
        FLUSH_MAX_BATCH: "131072",
        FLUSH_MAX_INFLIGHT: "2",
        INITIAL_ROWS: "1024",
        OCCUPY_TIMEOUT_MS: "500",
        HOST_FASTPATH: "true",
        PIPELINE_DEPTH: "0",
        ARENA_MAX_KEYS: "8",
        ARENA_PER_KEY: "4",
        TELEMETRY_ENABLED: "true",
        TELEMETRY_RING: "4096",
        TELEMETRY_SKETCH_K: "8",
        TELEMETRY_SKETCH_CAP: "64",
        TELEMETRY_BLOCKED_TOPK_K: "-1",
        TELEMETRY_BLOCKED_TOPK_CAP: "-1",
        TELEMETRY_TOPK_EXPORT: "10",
        SKETCH_ENABLED: "false",
        SKETCH_DEPTH: "4",
        SKETCH_WIDTH: "2048",
        SKETCH_CANDIDATES: "64",
        SKETCH_WINDOW_MS: "1000",
        SKETCH_PROMOTE_QPS: "0",
        SKETCH_RESOURCE_QPS: "0",
        SKETCH_PROMOTE_MAX: "64",
        SKETCH_DEMOTE_WINDOWS: "3",
        SKETCH_NAMES_CAP: "65536",
        SKETCH_COLD_QPS: "0",
        TRACE_ENABLED: "true",
        TRACE_RING: "2048",
        TRACE_SAMPLE_RATE: "0.01",
        TRACE_SAMPLE_BLOCKED: "true",
        TRACE_BULK_CAP: "4",
        FAILOVER_ENABLED: "false",
        FAILOVER_FETCH_TIMEOUT_MS: "5000",
        FAILOVER_POLICY: "open",
        FAILOVER_CHECKPOINT_EVERY: "8",
        FAILOVER_PROBE_FLUSHES: "3",
        FAILOVER_RETRY_MS: "1000",
        FAILOVER_CKPT_PATH: "",
        FAILOVER_CKPT_INTERVAL_MS: "1000",
        FAILOVER_CKPT_STALE_MS: "0",
        SPECULATIVE_ENABLED: "false",
        SPECULATIVE_FLUSH_BATCH: "64",
        SPECULATIVE_OVERADMIT_MAX: "64",
        SPECULATIVE_WINDOW_MS: "1000",
        SPECULATIVE_SHAPING: "true",
        INGEST_MAX_PENDING: "0",
        INGEST_MAX_PENDING_BULK: "0",
        INGEST_DEADLINE_MS: "0",
        INGEST_BATCH_WINDOW_MS: "0",
        INGEST_BATCH_MAX: "256",
        RESOURCE_METRICS_ENABLED: "true",
        RESOURCE_METRICS_CAP: "256",
        AUTOTUNE_ENABLED: "false",
        AUTOTUNE_INTERVAL_MS: "250",
        AUTOTUNE_COOLDOWN_MS: "1000",
        AUTOTUNE_DEPTH_MAX: "4",
        AUTOTUNE_MIN_FLUSHES: "8",
        AUTOTUNE_OCC_HIGH: "0.85",
        AUTOTUNE_OCC_LOW: "0.2",
        AUTOTUNE_IDLE_TICKS: "3",
        AUTOTUNE_RAISE_FRAC: "0.1",
        AUTOTUNE_STALL_FRAC: "2.0",
        AUTOTUNE_WINDOW_MS_MAX: "20",
        AUTOTUNE_WINDOW_BATCH_MAX: "4096",
        AUTOTUNE_PARAM_PATH: "true",
        AUTOTUNE_PARAM_EXPLORE: "3",
        AUTOTUNE_PARAM_MARGIN: "0.15",
        AUTOTUNE_PARAM_SEED_FILE: "",
        AUTOTUNE_LOG: "256",
        IPC_ENABLED: "false",
        IPC_RING_SLOTS: "1024",
        IPC_SLOT_BYTES: "16384",
        IPC_RESP_SLOTS: "1024",
        IPC_WORKERS_MAX: "8",
        IPC_HEARTBEAT_MS: "100",
        IPC_WORKER_DEAD_MS: "1000",
        IPC_ENGINE_DEAD_MS: "1000",
        IPC_ENGINE_DEAD_CONFIRM_MS: "0",
        IPC_TIMEOUT_MS: "5000",
        IPC_POLL_US: "200",
        IPC_CLIENT_WINDOW_MS: "0",
        IPC_CLIENT_WINDOW_MAX: "256",
        IPC_WAKEUP: "sleep",
        IPC_WAKEUP_SPIN_US: "-1",
        IPC_WAKEUP_PARK_MS: "5",
        IPC_WORKER_MODE: "false",
        IPC_SHM_PREFIX: "",
        IPC_RECONNECT: "true",
        IPC_RECONNECT_EXITS_MAX: "4096",
        IPC_HANDOFF_WAIT_MS: "3000",
        SUPERVISE_BACKOFF_MS: "500",
        SUPERVISE_BACKOFF_MAX_MS: "10000",
        SUPERVISE_RESTARTS_MAX: "0",
        SUPERVISE_STANDBY: "false",
        SUPERVISE_STANDBY_WARM_MS: "2000",
        CLUSTER_CLIENT_WINDOW_MS: "0",
        CLUSTER_CLIENT_WINDOW_MAX: "128",
        CLUSTER_LEASE_ENABLED: "false",
        CLUSTER_LEASE_MIN_BATCH: "4",
        CLUSTER_LEASE_FRAC: "0.5",
        CLUSTER_LEASE_MAX: "256",
        CLUSTER_LEASE_TTL_MS: "100",
        CLUSTER_WAIT_CAP_MS: "1000",
        CLUSTER_SHARDS: "1",
        CLUSTER_SHARDS_MAP: "",
        CLUSTER_SHARDS_MAP_VERSION: "0",
        GOSSIP_ENABLED: "false",
        GOSSIP_PORT: "0",
        GOSSIP_PEERS: "",
        GOSSIP_INTERVAL_MS: "0",
        GOSSIP_STALE_WINDOWS: "4",
        SPANS_ENABLED: "false",
        SPANS_RING: "8192",
        SPANS_DIR: "",
        SPANS_SPILL_EVERY: "0",
        CAPTURE_ENABLED: "false",
        CAPTURE_DIR: "",
        CAPTURE_SEGMENT_BYTES: "4194304",
        CAPTURE_SEGMENTS_MAX: "8",
        CAPTURE_FREEZE_SECONDS: "30",
        CAPTURE_FROZEN_MAX: "16",
        CAPTURE_SHED_STREAK: "64",
    }

    def __init__(self, load_env: bool = True, config_file: Optional[str] = None) -> None:
        self._lock = threading.RLock()
        self._runtime: Dict[str, str] = {}
        self._file: Dict[str, str] = {}
        self._env: Dict[str, str] = {}
        if load_env:
            self._load_file(config_file)
            self._load_env()

    def _load_file(self, config_file: Optional[str]) -> None:
        path = (
            config_file
            or os.environ.get("SENTINEL_TPU_CONFIG_FILE")
            or os.environ.get("CSP_SENTINEL_CONFIG_FILE")
            or "sentinel.properties"
        )
        try:
            with open(path, "r", encoding="utf-8") as f:
                self._file = _parse_properties(f.read())
        except OSError:
            self._file = {}

    def _load_env(self) -> None:
        # Accept each key upper-cased with dots as underscores — both the
        # exact form (CSP_SENTINEL_FLOW_COLD_FACTOR, PROJECT_NAME) and a
        # SENTINEL_TPU_-prefixed form for keys not already namespaced.
        for key in list(self.DEFAULTS) + [self.APP_NAME, self.LOG_DIR]:
            env_key = key.replace(".", "_").upper()
            candidates = [env_key]
            if not env_key.startswith(("CSP_", "SENTINEL_TPU_")):
                candidates.append("SENTINEL_TPU_" + env_key)
            for cand in candidates:
                v = os.environ.get(cand)
                if v is not None:
                    self._env[key] = v
                    break

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        with self._lock:
            for layer in (self._runtime, self._env, self._file):
                if key in layer:
                    return layer[key]
        if key in self.DEFAULTS:
            return self.DEFAULTS[key]
        return default

    def set(self, key: str, value: str) -> None:
        with self._lock:
            self._runtime[key] = str(value)

    def set_if_absent(self, key: str, value: str) -> None:
        with self._lock:
            if self.get(key) is None:
                self._runtime[key] = str(value)

    def runtime_snapshot(self, prefix: str = "") -> Dict[str, str]:
        """Copy of the runtime-set keys (``config.set``) under a prefix
        — what a spawned worker process replays so it sees this
        process's runtime config (spawn children start from defaults +
        env, not from the parent's runtime layer)."""
        with self._lock:
            return {
                k: v for k, v in self._runtime.items()
                if k.startswith(prefix)
            }

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key)
        try:
            return int(v) if v is not None else default
        except ValueError:
            return default

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get(key)
        try:
            return float(v) if v is not None else default
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        if v is None:
            return default
        return v.strip().lower() in ("1", "true", "yes", "on")

    # --- commonly used typed views (reference: SentinelConfig.java) ---
    @property
    def app_name(self) -> str:
        return self.get(self.APP_NAME) or "sentinel-tpu-app"

    @property
    def cold_factor(self) -> int:
        # Reference clamps coldFactor <= 1 back to 3 (SentinelConfig#coldFactor).
        v = self.get_int(self.COLD_FACTOR, 3)
        return 3 if v <= 1 else v

    @property
    def statistic_max_rt(self) -> int:
        return self.get_int(self.STATISTIC_MAX_RT, 4900)

    @property
    def occupy_timeout_ms(self) -> int:
        # Clamped to the statistic interval like OccupyTimeoutProperty
        # (a wait beyond one interval can never be satisfied).
        from sentinel_tpu_torch.models import constants as C

        v = self.get_int(self.OCCUPY_TIMEOUT_MS, 500)
        return max(0, min(v, C.DEFAULT_WINDOW_INTERVAL_MS))

    def reset(self) -> None:
        with self._lock:
            self._runtime.clear()


config = SentinelConfig()
