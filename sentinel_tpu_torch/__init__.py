"""sentinel_tpu_torch: the PyTorch/CUDA port of sentinel_tpu, for one
NVIDIA H100.

The JAX package ``sentinel_tpu`` beside it is the reference; this package
imports neither JAX nor anything of ``sentinel_tpu``. It covers the
slot chain so far: the public entry API, flow rules with every
controller (DEFAULT, with prioritized entries borrowing future windows;
the rate limiter, warm-up and warm-up rate limiter), hot-parameter
rules, circuit breakers, system protection and authority rules, the
batched engine at pipeline depth 0, the statistics sketch tier
(``sentinel.tpu.sketch.enabled``), the embedded cluster token service
(``sentinel_tpu_torch.cluster``, server mode), and the flush step whose
kernels (window update, window sums, matured-borrow sweep, flow admission
with occupy, borrow commit, system check, breakers, shaping and
hot-parameter recurrences, verdict tail, sketch fold; the token service's
decision pass beside them) are hand-written for Hopper in CUDA C++ and
Triton. Features not ported yet raise ``NotImplementedError``.

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

from sentinel_tpu_torch.core.api import entry, get_engine, trace, try_entry
from sentinel_tpu_torch.core.context import ContextUtil
from sentinel_tpu_torch.core.context import context_enter, context_exit
from sentinel_tpu_torch.core.errors import (
    AuthorityBlockError,
    BlockError,
    DegradeBlockError,
    FlowBlockError,
    ParamFlowBlockError,
    SystemBlockError,
)
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

__all__ = [
    "entry",
    "try_entry",
    "trace",
    "FlowRule",
    "DegradeRule",
    "SystemRule",
    "AuthorityRule",
    "ParamFlowRule",
    "ParamFlowItem",
    "flow_rule_manager",
    "param_flow_rule_manager",
    "degrade_rule_manager",
    "system_rule_manager",
    "authority_rule_manager",
    "BlockError",
    "FlowBlockError",
    "DegradeBlockError",
    "SystemBlockError",
    "AuthorityBlockError",
    "ParamFlowBlockError",
    "get_engine",
    "ContextUtil",
    "context_enter",
    "context_exit",
]
