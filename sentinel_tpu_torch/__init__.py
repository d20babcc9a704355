"""sentinel_tpu_torch: the PyTorch/CUDA port of sentinel_tpu, for one
NVIDIA H100.

The JAX package ``sentinel_tpu`` beside it is the reference; this package
imports neither JAX nor anything of ``sentinel_tpu``. It covers the
DEFAULT-flow admission path so far: the public entry API, flow rules with
the DEFAULT controller, the batched engine at pipeline depth 0, and the
flush step whose kernels (window update, window sums, matured-borrow
sweep, flow admission) are hand-written for Hopper in CUDA C++ and
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
from sentinel_tpu_torch.core.errors import BlockError, FlowBlockError
from sentinel_tpu_torch.models.rules import FlowRule
from sentinel_tpu_torch.rules.flow_manager import flow_rule_manager

__all__ = [
    "entry",
    "try_entry",
    "trace",
    "FlowRule",
    "flow_rule_manager",
    "FlowBlockError",
    "BlockError",
    "get_engine",
    "ContextUtil",
]
