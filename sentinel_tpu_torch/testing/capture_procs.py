"""Spawn target for the capture journal's kill test: an engine process that
records its admission stream until it is killed.

``multiprocessing`` spawn children import this by module name, so the
target is top-level and imports what it needs itself. It runs the port's
engine on the CPU (no CUDA in the child) with the journal armed, and
serves ``tests/test_torch_capture.py``'s SIGKILL case."""

from __future__ import annotations


def record_until_killed(cap_dir: str, ready_q, ready_after: int = 6) -> None:
    """Flush a stream of bulk groups, hot-parameter singles and exits on a
    ManualClock (100 ms a flush, synchronous fills) with the journal in
    ``cap_dir``; after ``ready_after`` flushes put ``"ready"`` on
    ``ready_q`` and keep flushing until the parent kills the process."""
    import numpy as np

    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.utils.clock import ManualClock
    from sentinel_tpu_torch.utils.config import config

    config.set(config.CAPTURE_ENABLED, "true")
    config.set(config.CAPTURE_DIR, cap_dir)
    clock = ManualClock(1000)
    eng = Engine(clock=clock, device="cpu")
    eng.set_flow_rules([st.FlowRule(f"k{i}", count=30) for i in range(8)])
    eng.set_param_rules({"kp": [st.ParamFlowRule("kp", param_idx=0, count=2)]})
    rng = np.random.default_rng(7)
    step = 0
    prev = []
    while True:
        now = clock.now_ms()
        groups = [eng.submit_bulk(f"k{i}", int(rng.integers(4, 40)), ts=now) for i in range(8)]
        singles = [eng.submit_entry("kp", args=(f"v{j % 3}",), ts=now) for j in range(6)]
        for g in prev:
            if g is not None and g.admitted_count:
                eng.submit_exit_bulk(g.rows, g.admitted_count, rt=5, ts=now, resource=g.resource)
        eng.flush()
        for op in singles:
            if op.verdict.admitted:
                eng.submit_exit(op.rows, rt=3, ts=now, param_rows=op.param_thread_rows)
        prev = groups
        step += 1
        if step == ready_after:
            ready_q.put("ready")
        clock.advance(100)
