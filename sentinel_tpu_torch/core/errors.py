"""Block exceptions.

Mirrors the reference's BlockException hierarchy (reference:
sentinel-core/.../slots/block/BlockException.java and subclasses
FlowException, DegradeException, SystemBlockException,
AuthorityException, ParamFlowException). ``BlockError`` is deliberately
cheap to raise: like the reference (BlockException disables stack-trace
fill), blocking is control flow, not a fault.
"""

from __future__ import annotations

from typing import Any, Optional


class BlockError(Exception):
    """A request was blocked by a rule. Base of all block errors."""

    # Block type tag used in metric/block logs (matches reference log tags).
    block_type = "Block"

    def __init__(
        self,
        resource: str = "",
        rule_limit_app: str = "default",
        message: str = "",
        rule: Optional[Any] = None,
    ) -> None:
        super().__init__(message or f"{self.block_type}ed by rule on resource [{resource}]")
        self.resource = resource
        self.rule_limit_app = rule_limit_app
        self.rule = rule

    # Match BlockException#isBlockException utility semantics.
    @staticmethod
    def is_block_error(t: BaseException) -> bool:
        seen: set = set()
        cur: Optional[BaseException] = t
        while cur is not None and id(cur) not in seen:
            if isinstance(cur, BlockError):
                return True
            seen.add(id(cur))
            cur = cur.__cause__ or cur.__context__
        return False


class FlowBlockError(BlockError):
    """Blocked by a flow rule (reference: FlowException.java)."""

    block_type = "Flow"


class DegradeBlockError(BlockError):
    """Blocked by an open circuit breaker (reference: DegradeException.java)."""

    block_type = "Degrade"


class SystemBlockError(BlockError):
    """Blocked by system protection (reference: SystemBlockException.java)."""

    block_type = "System"

    def __init__(self, resource: str = "", limit_type: str = "", message: str = "") -> None:
        super().__init__(resource, "default", message or f"SystemBlock [{limit_type}] on [{resource}]")
        self.limit_type = limit_type


class AuthorityBlockError(BlockError):
    """Blocked by origin authority rule (reference: AuthorityException.java)."""

    block_type = "Authority"


class ParamFlowBlockError(BlockError):
    """Blocked by a hot-parameter rule (reference: ParamFlowException.java)."""

    block_type = "ParamFlow"


# Block reason codes used on-device (verdict tensors). 0 = pass.
PASS = 0
BLOCK_FLOW = 1
BLOCK_DEGRADE = 2
BLOCK_SYSTEM = 3
BLOCK_AUTHORITY = 4
BLOCK_PARAM = 5
# Fail-closed admission while the engine is DEGRADED (device lost, the
# resource's failover policy says shed rather than pass) — see
# runtime/failover.py. Not a rule verdict: the distinct code keeps
# degraded blocks tellable from device blocks in logs and traces.
BLOCK_FAILOVER = 7
# Host-side custom slot veto (never appears in device tensors; the
# engine attributes it when a registered ProcessorSlot blocked the op).
BLOCK_CUSTOM = 6
# Engine ingest self-protection (runtime/ingest.py): the op was SHED at
# submit time — pending queues at their bound or the estimated verdict
# latency past the configured deadline. Never a rule verdict and never
# enqueued: the distinct code keeps load-shedding tellable from policy
# blocks in logs, traces and metrics.
BLOCK_SHED = 8
# Sketch-tier cold-key admission ceiling (runtime/sketch.py,
# sentinel.tpu.sketch.cold.qps): an UNPROMOTED sketch-tracked resource
# whose count-min estimated rate exceeds the configured ceiling. Never
# a dense-rule verdict and never enqueued — the estimate-based block is
# approximate by contract, so it must stay tellable from exact
# FlowException blocks in logs, traces and metrics.
BLOCK_SKETCH = 9


class CustomBlockError(BlockError):
    """A registered custom slot vetoed the entry (the analog of a
    user slot's BlockException subclass in an SPI-assembled chain)."""

    def __init__(self, resource: str, slot_name: str = "") -> None:
        super().__init__(resource)
        self.slot_name = slot_name

    def __str__(self) -> str:
        return f"CustomBlockError(resource={self.resource!r}, slot={self.slot_name!r})"


class FailoverBlockError(BlockError):
    """Fail-closed degraded admission: the device is lost and the
    resource's ``sentinel.tpu.failover.policy`` says shed load."""


class IngestShedError(BlockError):
    """The engine's ingest valve shed this op at submit time
    (``sentinel.tpu.ingest.*`` — queue bound hit or verdict deadline
    unmeetable). Retry-able by design: shedding is overload control,
    not a policy decision about the caller."""

    block_type = "IngestShed"


class SketchColdBlockError(BlockError):
    """Blocked by the sketch tier's cold-key admission ceiling: the
    resource has no dense rule (and no promotion), but its count-min
    estimated rate exceeds ``sentinel.tpu.sketch.cold.qps``."""

    block_type = "SketchCold"


_ERROR_BY_CODE = {
    BLOCK_FLOW: FlowBlockError,
    BLOCK_DEGRADE: DegradeBlockError,
    BLOCK_SYSTEM: SystemBlockError,
    BLOCK_AUTHORITY: AuthorityBlockError,
    BLOCK_PARAM: ParamFlowBlockError,
    BLOCK_CUSTOM: CustomBlockError,
    BLOCK_FAILOVER: FailoverBlockError,
    BLOCK_SHED: IngestShedError,
    BLOCK_SKETCH: SketchColdBlockError,
}

# The ONE home of the block-code → exception-name mapping (the
# reference logs e.getClass().getSimpleName() — LogSlot.java:24).
# Shared by the engine's block-log items, metrics/block_log.py's
# code-keyed logging, and the admission tracer's reason names, with a
# parity test pinning it against the BLOCK_* codes so a new code can't
# silently log as an unknown name.
BLOCK_EXC_NAMES = {
    BLOCK_FLOW: "FlowException",
    BLOCK_DEGRADE: "DegradeException",
    BLOCK_SYSTEM: "SystemBlockException",
    BLOCK_AUTHORITY: "AuthorityException",
    BLOCK_PARAM: "ParamFlowException",
    BLOCK_CUSTOM: "CustomBlockException",
    BLOCK_FAILOVER: "FailoverException",
    BLOCK_SHED: "IngestShedException",
    BLOCK_SKETCH: "SketchColdException",
}


def exc_name_for_code(code: int) -> str:
    """The logged exception name for a verdict reason code
    ("BlockException" for anything unmapped, like the reference's
    bare BlockException)."""
    return BLOCK_EXC_NAMES.get(int(code), "BlockException")


def error_for_code(code: int, resource: str) -> BlockError:
    cls = _ERROR_BY_CODE.get(int(code), BlockError)
    return cls(resource)


def error_for_verdict(
    reason: int,
    resource: str,
    *,
    limit_type: str = "",
    slot_name: str = "",
    rule=None,
) -> BlockError:
    """One verdict→BlockError construction shared by the public API's
    raise path and the engine's metric-extension callbacks — the typed
    subclass with its attribution, whatever the block reason."""
    if reason == BLOCK_SYSTEM:
        return SystemBlockError(resource, limit_type)
    if reason == BLOCK_CUSTOM:
        err: BlockError = CustomBlockError(resource, slot_name)
    else:
        err = error_for_code(reason, resource)
    err.rule = rule
    return err
