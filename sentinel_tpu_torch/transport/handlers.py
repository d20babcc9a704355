"""Built-in command handlers (port of ``sentinel_tpu/transport/handlers.py``).

Reference: the ~18 handlers in sentinel-transport-common/.../command/
handler/ — ModifyRulesCommandHandler (setRules),
FetchActiveRuleCommandHandler (getRules), SendMetricCommandHandler
(metric by time range), fetch tree / clusterNode / systemStatus,
on/off switch, cluster-mode handlers — plus the param-flow handlers
from sentinel-parameter-flow-control.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List

from sentinel_tpu_torch.metrics.metric_log import MetricSearcher
from sentinel_tpu_torch.models.rules import (
    AuthorityRule,
    DegradeRule,
    FlowRule,
    ParamFlowRule,
    SystemRule,
    rules_from_json,
)
from sentinel_tpu_torch.transport.command_center import (
    CommandRequest,
    CommandResponse,
    all_commands,
    command_mapping,
)
from sentinel_tpu_torch.utils.config import config
from sentinel_tpu_torch.version import __version__


def _engine():
    from sentinel_tpu_torch.core.api import get_engine

    return get_engine()


def _managers():
    from sentinel_tpu_torch.rules.authority_manager import authority_rule_manager
    from sentinel_tpu_torch.rules.degrade_manager import degrade_rule_manager
    from sentinel_tpu_torch.rules.flow_manager import flow_rule_manager
    from sentinel_tpu_torch.rules.param_manager import param_flow_rule_manager
    from sentinel_tpu_torch.rules.system_manager import system_rule_manager

    return {
        "flow": (flow_rule_manager, FlowRule),
        "degrade": (degrade_rule_manager, DegradeRule),
        "system": (system_rule_manager, SystemRule),
        "authority": (authority_rule_manager, AuthorityRule),
        "paramFlow": (param_flow_rule_manager, ParamFlowRule),
    }


# Upper bound on ?spans= / ?n= style list params: a command response
# is one JSON blob — an absurd count must clamp, not OOM the center.
_MAX_LIST_PARAM = 65536


def _count_param(req: CommandRequest, name: str, default: int = 0):
    """Validated non-negative bounded int query param, shared by the
    ``telemetry`` (?spans=) and ``traces`` (?n=) commands: returns
    ``(value, None)`` or ``(None, failure_response)``. Negative values
    are rejected — ``int("-5")`` parses fine but would silently slice
    a ring from the wrong end."""
    raw = req.params.get(name)
    if raw is None:
        return default, None
    try:
        v = int(raw)
    except ValueError:
        return None, CommandResponse.of_failure(f"invalid {name} count")
    if v < 0:
        return None, CommandResponse.of_failure(f"invalid {name} count")
    return min(v, _MAX_LIST_PARAM), None


def _camel(obj: dict) -> dict:
    def cc(k: str) -> str:
        parts = k.split("_")
        return parts[0] + "".join(p.title() for p in parts[1:])

    return {cc(k): v for k, v in obj.items() if v is not None}


def _rules_json(rules: List) -> str:
    return json.dumps([_camel(dataclasses.asdict(r)) for r in rules])


@command_mapping("version", "get sentinel version")
def version_handler(req: CommandRequest) -> CommandResponse:
    return CommandResponse.of_success(__version__)


@command_mapping("api", "list available commands")
def api_handler(req: CommandRequest) -> CommandResponse:
    return CommandResponse.of_json(all_commands())


@command_mapping("basicInfo", "basic machine/app info")
def basic_info_handler(req: CommandRequest) -> CommandResponse:
    return CommandResponse.of_json(
        {
            "appName": config.app_name,
            "appType": config.get_int(config.APP_TYPE, 0),
            "version": __version__,
            "pid": os.getpid(),
            "currentTime": int(time.time() * 1000),
        }
    )


@command_mapping("getRules", "get rules by type: flow|degrade|system|authority|paramFlow")
def get_rules_handler(req: CommandRequest) -> CommandResponse:
    kind = req.params.get("type", "flow")
    entry = _managers().get(kind)
    if entry is None:
        return CommandResponse.of_failure(f"invalid type: {kind}")
    mgr, _cls = entry
    return CommandResponse.of_success(_rules_json(mgr.get_rules()), json_body=True)


@command_mapping("setRules", "set rules: type=...&data=<json list>")
def set_rules_handler(req: CommandRequest) -> CommandResponse:
    kind = req.params.get("type", "flow")
    data = req.params.get("data", "[]")
    entry = _managers().get(kind)
    if entry is None:
        return CommandResponse.of_failure(f"invalid type: {kind}")
    mgr, cls = entry
    try:
        rules = rules_from_json(json.loads(data), cls)
    except (ValueError, TypeError) as e:
        return CommandResponse.of_failure(f"bad rule payload: {e}")
    mgr.load_rules(rules)
    # Push-persistence when a writable datasource is registered
    # (WritableDataSourceRegistry / ModifyRulesCommandHandler).
    from sentinel_tpu_torch.datasource import WritableDataSourceRegistry

    WritableDataSourceRegistry.try_write(kind, rules)
    return CommandResponse.of_success("success")


@command_mapping("metric", "metric log by time range: startTime&endTime[&identity]")
def metric_handler(req: CommandRequest) -> CommandResponse:
    try:
        begin = int(req.params.get("startTime", 0))
        end = int(req.params.get("endTime", 2**62))
    except ValueError:
        return CommandResponse.of_failure("invalid time range")
    resource = req.params.get("identity")
    searcher = MetricSearcher()
    lines = searcher.find(begin, end, resource)
    return CommandResponse.of_success("\n".join(n.to_line() for n in lines))


@command_mapping("tree", "node tree with per-node statistics")
def tree_handler(req: CommandRequest) -> CommandResponse:
    engine = _engine()
    engine.flush()
    out = []
    pairs = [("machine-root", engine.nodes.entry_node_row)] + engine.nodes.resources()
    by_row = engine.rows_stats([row for _, row in pairs])
    for name, row in pairs:
        s = by_row[row]
        out.append(
            f"{name}: thread={s['cur_thread_num']} pass={s['pass_qps']:.0f} "
            f"block={s['block_qps']:.0f} success={s['success_qps']:.0f} "
            f"exception={s['exception_qps']:.0f} rt={s['avg_rt']:.1f}"
        )
    return CommandResponse.of_success("\n".join(out))


@command_mapping("clusterNode", "cluster node statistics as JSON")
def cluster_node_handler(req: CommandRequest) -> CommandResponse:
    engine = _engine()
    engine.flush()
    out = []
    pairs = engine.nodes.resources()
    by_row = engine.rows_stats([row for _, row in pairs])
    for name, row in pairs:
        s = by_row[row]
        out.append({"resourceName": name, **{k: float(v) for k, v in s.items()}})
    return CommandResponse.of_json(out)


@command_mapping("origin", "per-origin statistics for a resource: id=<resource>")
def origin_handler(req: CommandRequest) -> CommandResponse:
    engine = _engine()
    resource = req.params.get("id", "")
    crow = engine.nodes.lookup_cluster_row(resource)
    if crow is None:
        return CommandResponse.of_failure(f"unknown resource: {resource}")
    engine.flush()
    out = []
    origin_pairs = list(engine.nodes.origin_rows.get(crow, {}).items())
    by_row = engine.rows_stats([row for _, row in origin_pairs])
    for origin, row in origin_pairs:
        s = by_row[row]
        out.append({"origin": origin, **{k: float(v) for k, v in s.items()}})
    return CommandResponse.of_json(out)


@command_mapping("systemStatus", "system protection status")
def system_status_handler(req: CommandRequest) -> CommandResponse:
    from sentinel_tpu_torch.utils.system_status import sampler

    engine = _engine()
    g = engine.entry_node_stats()
    return CommandResponse.of_json(
        {
            "qps": g["pass_qps"],
            "thread": g["cur_thread_num"],
            "rt": g["avg_rt"],
            "load": sampler.load,
            "cpu": sampler.cpu,
        }
    )


@command_mapping("getSwitch", "get the global protection switch")
def get_switch_handler(req: CommandRequest) -> CommandResponse:
    return CommandResponse.of_success(str(_engine().enabled).lower())


@command_mapping("setSwitch", "set the global protection switch: value=true|false")
def set_switch_handler(req: CommandRequest) -> CommandResponse:
    value = req.params.get("value", "").lower()
    if value not in ("true", "false"):
        return CommandResponse.of_failure("invalid value")
    _engine().enabled = value == "true"
    return CommandResponse.of_success("success")


@command_mapping("getClusterMode", "cluster mode state")
def get_cluster_mode_handler(req: CommandRequest) -> CommandResponse:
    from sentinel_tpu_torch.cluster.state import ClusterStateManager

    return CommandResponse.of_json({"mode": ClusterStateManager.get_mode()})


@command_mapping("setClusterMode", "set cluster mode: mode=0(client)|1(server)|-1(off)")
def set_cluster_mode_handler(req: CommandRequest) -> CommandResponse:
    from sentinel_tpu_torch.cluster.state import ClusterStateManager

    try:
        mode = int(req.params.get("mode", "-1"))
    except ValueError:
        return CommandResponse.of_failure("invalid mode")
    ClusterStateManager.apply_state(mode)
    return CommandResponse.of_success("success")


@command_mapping("cluster/server/flowRules", "cluster server flow rules: namespace=")
def cluster_server_flow_rules_handler(req: CommandRequest) -> CommandResponse:
    from sentinel_tpu_torch.cluster.flow_rules import cluster_flow_rule_manager

    ns = req.params.get("namespace", "default")
    with cluster_flow_rule_manager._lock:
        rules = list(cluster_flow_rule_manager._rules.get(ns, {}).values())
    return CommandResponse.of_success(_rules_json(rules), json_body=True)


@command_mapping("cluster/server/modifyFlowRules", "set cluster flow rules: namespace=&data=")
def cluster_server_modify_flow_rules_handler(req: CommandRequest) -> CommandResponse:
    from sentinel_tpu_torch.cluster.flow_rules import cluster_flow_rule_manager

    ns = req.params.get("namespace", "default")
    try:
        rules = rules_from_json(json.loads(req.params.get("data", "[]")), FlowRule)
    except (ValueError, TypeError) as e:
        return CommandResponse.of_failure(f"bad payload: {e}")
    cluster_flow_rule_manager.load_rules(ns, rules)
    return CommandResponse.of_success("success")


@command_mapping("cluster/server/config", "cluster server config")
def cluster_server_config_handler(req: CommandRequest) -> CommandResponse:
    from sentinel_tpu_torch.cluster.flow_rules import cluster_server_config_manager

    cfg = cluster_server_config_manager.config
    return CommandResponse.of_json(
        {
            "port": cfg.port,
            "exceedCount": cfg.exceed_count,
            "maxAllowedQps": cfg.max_allowed_qps,
            "namespaces": sorted(cfg.namespaces),
        }
    )


@command_mapping("cluster/server/stats", "token-server per-flowId qps/concurrency")
def cluster_server_stats_handler(req: CommandRequest) -> CommandResponse:
    """The dashboard cluster screen's data: per-flowId granted QPS +
    held concurrency from the embedded token server (reference analog:
    ClusterServerStatLogUtil counters surfaced to the console)."""
    from sentinel_tpu_torch.cluster.state import (
        ClusterStateManager,
        EmbeddedClusterTokenServerProvider,
    )

    server = EmbeddedClusterTokenServerProvider.get_server()
    service = getattr(server, "service", None)
    flows = service.flow_stats() if hasattr(service, "flow_stats") else []
    held = 0
    concurrent = getattr(service, "concurrent", None)
    if concurrent is not None:
        held = concurrent.held_tokens()
    connections = getattr(service, "connections", None)
    by_namespace = connections.snapshot() if connections is not None else {}
    connected = (
        connections.total()
        if connections is not None
        else getattr(service, "connected_count", 0)
    )
    return CommandResponse.of_json(
        {
            "mode": ClusterStateManager.get_mode(),
            "port": getattr(server, "port", None) if server is not None else None,
            "connectedCount": connected,
            "connectionGroups": by_namespace,
            "heldTokens": held,
            "flows": flows,
        }
    )


@command_mapping("cluster/client/config", "cluster client config (server address)")
def cluster_client_config_handler(req: CommandRequest) -> CommandResponse:
    from sentinel_tpu_torch.cluster.state import ClusterClientConfigManager

    return CommandResponse.of_json(ClusterClientConfigManager.snapshot())


@command_mapping(
    "cluster/client/modifyConfig",
    "point this client at a token server: "
    "serverHost=&serverPort=[&requestTimeout=][&namespace=]",
)
def cluster_client_modify_config_handler(req: CommandRequest) -> CommandResponse:
    from sentinel_tpu_torch.cluster.state import (
        ClusterClientConfigManager,
        ClusterStateManager,
        TokenClientProvider,
    )

    host = req.params.get("serverHost", "")
    try:
        port = int(req.params.get("serverPort", "0"))
        timeout = req.params.get("requestTimeout")
        timeout_ms = int(timeout) if timeout is not None else None
    except ValueError:
        return CommandResponse.of_failure("invalid port/timeout")
    if not host or port <= 0:
        return CommandResponse.of_failure("serverHost and serverPort required")
    ClusterClientConfigManager.apply(
        host, port, timeout_ms, namespace=req.params.get("namespace")
    )
    # Re-point a live client: stop the old one so the next mode apply
    # (or the current client mode) reconnects at the new address.
    client = TokenClientProvider.get_client()
    if client is not None and (
        getattr(client, "host", None) != host
        or getattr(client, "port", None) != port
        or getattr(client, "namespace", None) != ClusterClientConfigManager.namespace
    ):
        try:
            if hasattr(client, "stop"):
                client.stop()
        finally:
            TokenClientProvider.clear()
        if ClusterStateManager.is_client():
            new_client = ClusterClientConfigManager.build_client()
            if new_client is not None:
                TokenClientProvider.register(new_client)
                new_client.start()
    return CommandResponse.of_success("success")


@command_mapping(
    "metrics",
    "Prometheus text-format metrics (JMX exporter analog);"
    " ?format=openmetrics adds admission-trace exemplars",
)
def prometheus_handler(req: CommandRequest) -> CommandResponse:
    from sentinel_tpu_torch.transport.prometheus import (
        OPENMETRICS_CONTENT_TYPE,
        render_metrics,
    )

    # Exemplars are only legal in the OpenMetrics dialect — the classic
    # 0.0.4 text parser rejects a mid-line '#', failing the whole
    # scrape — so the format (and content type) switch together.
    om = req.params.get("format", "").lower() == "openmetrics"
    content_type = (
        OPENMETRICS_CONTENT_TYPE
        if om
        else "text/plain; version=0.0.4; charset=utf-8"
    )
    # Metrics federation: a worker-mode process has NO engine — its
    # scrape is the sentinel_worker_* families (constructing an engine
    # here would defeat worker mode's whole point), while an engine
    # process renders the engine families plus, when a token shard is
    # embedded in-process, the shard's sentinel_cluster_server_* rows.
    from sentinel_tpu_torch.ipc import worker_mode

    wcli = worker_mode.current()
    if wcli is not None:
        from sentinel_tpu_torch.transport.prometheus import render_worker_metrics

        return CommandResponse(
            True, render_worker_metrics(wcli, openmetrics=om), content_type
        )
    text = render_metrics(_engine(), openmetrics=om)
    from sentinel_tpu_torch.cluster.state import EmbeddedClusterTokenServerProvider

    srv = EmbeddedClusterTokenServerProvider.get_server()
    if srv is not None:
        from sentinel_tpu_torch.transport.prometheus import (
            cluster_server_metric_lines,
        )

        extra = "\n".join(
            cluster_server_metric_lines(srv, openmetrics=om)
        ) + "\n"
        if om and text.endswith("# EOF\n"):
            # The OM terminator must stay last.
            text = text[: -len("# EOF\n")] + extra + "# EOF\n"
        else:
            text += extra
    return CommandResponse(True, text, content_type)


@command_mapping(
    "telemetry",
    "engine flight recorder snapshot: spans, histograms, blocked sketch"
    " [?spans=N for the last N ring spans]",
)
def telemetry_handler(req: CommandRequest) -> CommandResponse:
    """The engine-internals view the per-resource commands cannot give:
    flush/drain/e2e latency histograms, pipeline occupancy, arena and
    intern-cache hit rates, coalesced-fetch fallbacks, and the
    blocked-resource heavy-hitter sketch (metrics/telemetry.py)."""
    engine = _engine()
    tele = engine.telemetry
    n_spans, err = _count_param(req, "spans")
    if err is not None:
        return err
    out = tele.snapshot(engine)
    if n_spans > 0:
        out["spans"] = [s.as_dict() for s in tele.spans()[-n_spans:]]
    return CommandResponse.of_json(out)


@command_mapping(
    "health",
    "engine failure-domain state: health machine, degraded counters,"
    " checkpoint age, fallback policy",
)
def health_handler(req: CommandRequest) -> CommandResponse:
    """The failover view (runtime/failover.py): current health state
    (HEALTHY/DEGRADED/RECOVERING), the last fault, transition events,
    degraded-admission counters, checkpoint seq/age and the effective
    per-resource fail-open/fail-closed policy."""
    engine = _engine()
    out = engine.failover.snapshot()
    out["flush_seq"] = engine.flush_seq
    # Hot-restart provenance: which boot of the shared rings this
    # engine is (1 = first boot; see ipc/supervise.py).
    plane = getattr(engine, "ipc_plane", None)
    out["engine_epoch"] = plane.engine_epoch if plane is not None else 1
    return CommandResponse.of_json(out)


@command_mapping(
    "speculative",
    "speculative admission tier: fast-path counters, drift windows,"
    " valve state, mirror snapshot",
)
def speculative_handler(req: CommandRequest) -> CommandResponse:
    """The two-tier admission view (runtime/speculative.py): how many
    verdicts the host fast tier served, how far it drifted from device
    settlement per window (over/under-admits, bucket clamps, gauge
    compensations), whether the drift valve is currently suspending
    speculation, and the live mirror state."""
    engine = _engine()
    out = engine.speculative.snapshot()
    out["health"] = engine.failover.state
    out["flush_seq"] = engine.flush_seq
    return CommandResponse.of_json(out)


@command_mapping(
    "sketch",
    "statistics sketch tier: candidate heavy hitters, promoted keys,"
    " occupancy, estimate-error gauge",
)
def sketch_handler(req: CommandRequest) -> CommandResponse:
    """The unbounded-cardinality view (runtime/sketch.py): what the
    fixed-size on-device count-min/candidate tier currently believes
    the heavy hitters are, which keys hold promoted exact dense rows,
    how full the candidate table runs, and how far the estimates sit
    above the exact host counters — the long-tail complement of the
    per-resource commands, which can only describe keys that HAVE
    dense rows."""
    engine = _engine()
    out = engine.sketch.snapshot()
    out["flush_seq"] = engine.flush_seq
    return CommandResponse.of_json(out)


@command_mapping(
    "capture",
    "black-box flight recorder: segment/counter snapshot;"
    " freeze=<reason> pins the recent segments on demand",
)
def capture_handler(req: CommandRequest) -> CommandResponse:
    """The admission black box (runtime/capture.py): live/frozen
    segment inventory, spill counters and the capture row cursor. With
    ``?freeze=<reason>`` the recent segments are pinned against
    rollover first (an on-demand postmortem — same mechanics as the
    breaker/shed/DEGRADED triggers) and the frozen paths are
    returned."""
    engine = _engine()
    cap = getattr(engine, "capture", None)
    if cap is None:
        return CommandResponse.of_json(
            {"enabled": False, "flush_seq": engine.flush_seq}
        )
    reason = req.params.get("freeze")
    out = {"enabled": True}
    if reason:
        safe = "".join(
            ch for ch in reason[:32] if ch.isalnum() or ch in "-_"
        ) or "manual"
        out["frozen_now"] = [os.path.basename(p) for p in cap.freeze(safe)]
    out.update(cap.snapshot())
    out["flush_seq"] = engine.flush_seq
    return CommandResponse.of_json(out)


@command_mapping(
    "autotune",
    "self-tuning control plane: chosen depth/window, decision log,"
    " param-path cost memo",
)
def autotune_handler(req: CommandRequest) -> CommandResponse:
    """The closed-loop tuning view (runtime/autotune.py): what the
    controller currently holds the pipeline depth and batch window at,
    the bounded decision log (knob, from->to, reason — the convergence
    trajectory), and the shape-bucketed closed-form-vs-scan cost memo
    with per-path sample counts and cost EWMAs."""
    engine = _engine()
    out = engine.autotune.snapshot()
    out["flush_seq"] = engine.flush_seq
    return CommandResponse.of_json(out)


@command_mapping(
    "ipc",
    "multi-process ingest plane: ring occupancy, live workers, frame"
    " counters, intern generation",
)
def ipc_handler(req: CommandRequest) -> CommandResponse:
    """The scale-out front-end view (sentinel_tpu_torch/ipc): whether the
    shared-memory plane is serving, how full the request ring runs,
    which worker slots are attached (with their live-admission ledger
    sizes), and the frame/shed/death counters — the one place that
    tells 'the engine is slow' from 'a worker died and its gauges were
    auto-exited'."""
    engine = _engine()
    plane = getattr(engine, "ipc_plane", None)
    if plane is None:
        return CommandResponse.of_json(
            {"enabled": False, "flush_seq": engine.flush_seq}
        )
    out = plane.snapshot()
    out["flush_seq"] = engine.flush_seq
    return CommandResponse.of_json(out)


@command_mapping(
    "handoff",
    "request a planned engine handoff: drain, final durable spill,"
    " standby takeover (supervised engines only)",
)
def handoff_handler(req: CommandRequest) -> CommandResponse:
    """Operator trigger for the planned live handoff
    (ipc/supervise.py): sets the engine's ``handoff_requested`` event;
    the supervised serve loop drains in-flight flushes, spills a final
    durable checkpoint, publishes the HANDOFF control word and exits
    ``EXIT_HANDOFF`` so the warm standby attaches. On an unsupervised
    engine the event is set but nothing consumes it — the response
    says so instead of pretending a drain happened."""
    engine = _engine()
    evt = getattr(engine, "handoff_requested", None)
    if evt is None:
        return CommandResponse.of_failure("engine has no handoff support")
    supervised = getattr(engine, "ipc_plane", None) is not None
    evt.set()
    return CommandResponse.of_json(
        {"ok": True, "handoff": "requested", "ipc_plane": supervised}
    )


@command_mapping(
    "cluster",
    "batched cluster token plane: client counters, RPC latency,"
    " live leases, per-shard rows, gossip state, window config",
)
def cluster_handler(req: CommandRequest) -> CommandResponse:
    """The cluster token path view (cluster/client.py + shards.py):
    how many token decisions the client served and by which stance
    (batched frame, local lease, FAIL fallback), the RPC round-trip
    summary, and — when a client is live — its connection, intern
    table, lease table and micro-window configuration. A sharded
    client's ``plane_snapshot`` carries per-shard rows (connection,
    leases, honest fallback counters per shard). The ``gossip`` block
    is this engine's sketch-gossip endpoint: origin, peers, wire
    counters and how many remote views the tier holds. Counters are
    process-wide (the ``client_stats``/``gossip_stats`` singletons) so
    the command answers even before a cluster rule ever attached a
    client."""
    from sentinel_tpu_torch.cluster.client import client_stats
    from sentinel_tpu_torch.cluster.gossip import gossip_stats
    from sentinel_tpu_torch.cluster.state import (
        ClusterStateManager,
        TokenClientProvider,
    )

    engine = _engine()
    out = {"mode": ClusterStateManager.get_mode(), "stats": client_stats.snapshot()}
    client = TokenClientProvider.get_client()
    if client is not None and hasattr(client, "plane_snapshot"):
        out["client"] = client.plane_snapshot()
    agent = getattr(engine, "gossip", None)
    if agent is not None:
        out["gossip"] = agent.snapshot()
    else:
        out["gossip"] = {
            "running": False,
            "tier": engine.sketch.gossip_info(),
            "stats": gossip_stats.snapshot(),
        }
    out["flush_seq"] = engine.flush_seq
    return CommandResponse.of_json(out)


@command_mapping(
    "traces",
    "sampled admission trace records: [?n=N][&resource=][&reason=code|name]",
)
def traces_handler(req: CommandRequest) -> CommandResponse:
    """Per-request verdict provenance (metrics/admission_trace.py):
    who was blocked, by which rule family, decided in which flush span,
    carrying which W3C trace id — the request-level complement of the
    ``telemetry`` command's engine view. ``reason`` accepts the numeric
    code or the shared exception-name spelling
    (core/errors.BLOCK_EXC_NAMES, e.g. ``FlowException``)."""
    from sentinel_tpu_torch.core.errors import BLOCK_EXC_NAMES

    engine = _engine()
    tracer = engine.admission_trace
    n, err = _count_param(req, "n")
    if err is not None:
        return err
    resource = req.params.get("resource")
    reason_raw = req.params.get("reason")
    reason = None
    if reason_raw is not None:
        by_name = {v: k for k, v in BLOCK_EXC_NAMES.items()}
        if reason_raw in by_name:
            reason = by_name[reason_raw]
        else:
            try:
                reason = int(reason_raw)
            except ValueError:
                return CommandResponse.of_failure(
                    f"invalid reason: {reason_raw}"
                )
    out = tracer.snapshot()
    out["records"] = [
        r.as_dict()
        for r in tracer.records(n=n or None, resource=resource, reason=reason)
    ]
    return CommandResponse.of_json(out)


@command_mapping(
    "spans",
    "fleet span journal: per-process admission spans"
    " [?n=N last spans][&cat=worker|engine|client|shard][&spill=1]",
)
def spans_handler(req: CommandRequest) -> CommandResponse:
    """The per-process half of the fleet timeline (metrics/spans.py):
    journal state plus the last N buffered spans. ``spill=1`` forces a
    journal-file spill so ``tools/fleetdump.py`` can merge a LIVE
    process without waiting for its close — the command answers with
    the spill path."""
    from sentinel_tpu_torch.metrics.spans import get_journal

    j = get_journal()
    n, err = _count_param(req, "n")
    if err is not None:
        return err
    out = j.snapshot()
    cat = req.params.get("cat") or None
    if n > 0:
        out["spans"] = j.spans(cat=cat)[-n:]
    if req.params.get("spill") in ("1", "true"):
        try:
            out["spilled_to"] = j.spill()
        except OSError as e:
            return CommandResponse.of_failure(f"spill failed: {e}")
    return CommandResponse.of_json(out)
