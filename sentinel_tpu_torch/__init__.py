"""sentinel_tpu_torch: the PyTorch/CUDA port of sentinel_tpu, for one
NVIDIA H100.

The JAX package ``sentinel_tpu`` beside it is the reference; this package
imports neither JAX nor anything of ``sentinel_tpu``. It covers the
slot chain so far: the public entry API, flow rules with every
controller (DEFAULT, with prioritized entries borrowing future windows;
the rate limiter, warm-up and warm-up rate limiter), hot-parameter
rules, circuit breakers, system protection and authority rules, the
batched engine with its host pipeline (flush_async, the depth-K flush,
the auto-flusher), the statistics sketch tier
(``sentinel.tpu.sketch.enabled``), the embedded cluster token service
(``sentinel_tpu_torch.cluster``, server mode), and the flush step whose
kernels (window update, window sums, matured-borrow sweep, flow admission
with occupy, borrow commit, system check, breakers, shaping and
hot-parameter recurrences, verdict tail, sketch fold; the token service's
decision pass beside them) are hand-written for Hopper in CUDA C++ and
Triton. Features not ported yet raise ``NotImplementedError`` naming
their ROADMAP item; so do the public names of the JAX package whose
modules are not ported (the trace-context helpers, the window
properties).

    import sentinel_tpu_torch as st

    st.flow_rule_manager.load_rules([st.FlowRule("res", count=20)])
    with st.entry("res"):            # raises BlockError when blocked
        ...
    if st.try_entry("res"):           # SphO-style variant
        ...

Entry points run on the card; ``st.core.api.reset(device="cpu")`` runs
the kernels' plain PyTorch versions on the CPU instead. Importing the
package touches no device.
"""

from sentinel_tpu_torch.version import __version__

from sentinel_tpu_torch.core.api import (
    entry,
    entry_async,
    get_engine,
    reset as reset_all,
    reset_tracer_filters,
    set_exception_predicate,
    set_exceptions_to_ignore,
    set_exceptions_to_trace,
    should_trace,
    trace,
    try_entry,
)
from sentinel_tpu_torch.core.context import Context, ContextUtil
from sentinel_tpu_torch.core.context import context_enter, context_exit
from sentinel_tpu_torch.core.errors import (
    AuthorityBlockError,
    BlockError,
    DegradeBlockError,
    FlowBlockError,
    ParamFlowBlockError,
    SystemBlockError,
)
from sentinel_tpu_torch.models import constants
from sentinel_tpu_torch.models.rules import (
    AuthorityRule,
    DegradeRule,
    FlowRule,
    ParamFlowItem,
    ParamFlowRule,
    SystemRule,
)
from sentinel_tpu_torch.rules.authority_manager import authority_rule_manager
from sentinel_tpu_torch.rules.degrade_manager import degrade_rule_manager
from sentinel_tpu_torch.rules.flow_manager import flow_rule_manager
from sentinel_tpu_torch.rules.param_manager import param_flow_rule_manager
from sentinel_tpu_torch.rules.system_manager import system_rule_manager
from sentinel_tpu_torch.runtime.engine import BulkOp
from sentinel_tpu_torch.utils.unported import ROADMAP_METRICS, UnportedName

# Public names of the JAX package whose modules are not ported yet: each
# raises NotImplementedError naming its ROADMAP item when used.
trace_context = UnportedName("trace_context", ROADMAP_METRICS)
TraceContext = UnportedName("TraceContext", ROADMAP_METRICS)
inject_trace_headers = UnportedName("inject_trace_headers", ROADMAP_METRICS)
parse_traceparent = UnportedName("parse_traceparent", ROADMAP_METRICS)
sample_count_property = UnportedName("sample_count_property", ROADMAP_METRICS)
interval_property = UnportedName("interval_property", ROADMAP_METRICS)

__all__ = [
    "__version__",
    "BlockError",
    "FlowBlockError",
    "DegradeBlockError",
    "SystemBlockError",
    "AuthorityBlockError",
    "ParamFlowBlockError",
    "Context",
    "ContextUtil",
    "context_enter",
    "context_exit",
    "entry",
    "try_entry",
    "entry_async",
    "reset_tracer_filters",
    "set_exception_predicate",
    "set_exceptions_to_ignore",
    "set_exceptions_to_trace",
    "should_trace",
    "trace",
    "trace_context",
    "get_engine",
    "reset_all",
    "FlowRule",
    "DegradeRule",
    "SystemRule",
    "AuthorityRule",
    "ParamFlowRule",
    "ParamFlowItem",
    "BulkOp",
    "TraceContext",
    "inject_trace_headers",
    "parse_traceparent",
    "constants",
    "flow_rule_manager",
    "degrade_rule_manager",
    "system_rule_manager",
    "authority_rule_manager",
    "param_flow_rule_manager",
    "sample_count_property",
    "interval_property",
]
