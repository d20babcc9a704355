"""Lockstep harness for the failure-domain and speculative-tier parity
tests (tests/test_torch_failover.py, test_torch_speculative.py,
test_torch_durable.py): one scenario runs on the JAX package's Engine
and on the port's Engine on the CPU, each under its own ManualClock, its
own config and its own package's FaultInjector, and the observations each
run returns must agree exactly (float32 arrays compared by their bits)."""

from types import SimpleNamespace

import numpy as np


def _jax_lib():
    import jax

    import sentinel_tpu as st
    from sentinel_tpu.core import api
    from sentinel_tpu.core import errors as E
    from sentinel_tpu.models import constants as C
    from sentinel_tpu.runtime import durable
    from sentinel_tpu.runtime.engine import Engine
    from sentinel_tpu.testing.faults import FaultInjector
    from sentinel_tpu.utils import clock as clk
    from sentinel_tpu.utils.config import config

    def states(eng):
        sk = eng.sketch.dev_state if eng.sketch.armed else None
        return jax.device_get((eng.stats, eng.flow_dyn, eng.degrade_dyn, eng.param_dyn, sk))

    return SimpleNamespace(name="jax", st=st, api=api, E=E, C=C, Engine=Engine, FaultInjector=FaultInjector,
                           clk=clk, config=config, durable=durable, states=states, device_kw={})


def _port_lib():
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.core import api
    from sentinel_tpu_torch.core import errors as E
    from sentinel_tpu_torch.metrics.nodes import stats_to_numpy
    from sentinel_tpu_torch.models import constants as C
    from sentinel_tpu_torch.rules.degrade_table import degrade_state_to_numpy
    from sentinel_tpu_torch.rules.param_table import param_state_to_numpy
    from sentinel_tpu_torch.runtime import durable
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.runtime.sketch import sketch_state_to_numpy
    from sentinel_tpu_torch.testing.faults import FaultInjector
    from sentinel_tpu_torch.utils import clock as clk
    from sentinel_tpu_torch.utils.config import config

    def states(eng):
        # Copies: on the CPU these are views of tensors the engine updates
        # in place.
        fd = eng.flow_dyn
        sk = sketch_state_to_numpy(eng.sketch.dev_state) if eng.sketch.armed else None
        out = (stats_to_numpy(eng.stats), type(fd)(*(t.cpu().numpy() for t in fd)),
               degrade_state_to_numpy(eng.degrade_dyn), param_state_to_numpy(eng.param_dyn), sk)
        return _copy_tree(out)

    return SimpleNamespace(name="port", st=st, api=api, E=E, C=C, Engine=Engine, FaultInjector=FaultInjector,
                           clk=clk, config=config, durable=durable, states=states, device_kw={"device": "cpu"})


def _copy_tree(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        vals = [_copy_tree(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return np.array(x, copy=True)


def canon(x):
    """Observations in a form ``==`` compares exactly: arrays as (dtype
    kind, shape, bytes), NamedTuples and tuples as lists."""
    if isinstance(x, np.ndarray) or (hasattr(x, "shape") and hasattr(x, "dtype") and not isinstance(x, (int, float))):
        a = np.asarray(x)
        kind = "b" if a.dtype.kind == "b" else a.dtype.str
        return ("array", kind, a.shape, np.ascontiguousarray(a).tobytes())
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def verdict(v):
    """One verdict with its provenance and attribution."""
    if v is None:
        return None
    rule = None if v.blocked_rule is None else v.blocked_rule.to_dict()
    return (bool(v.admitted), int(v.reason), int(v.wait_ms), v.limit_type, bool(v.degraded), bool(v.speculative),
            rule)


def verdicts(ops):
    return [verdict(None if op is None else op.verdict) for op in ops]


def group(g):
    return None if g is None else (g.admitted, g.reason, g.wait_ms)


def health(eng):
    """The failover tier's state, counters and transitions."""
    snap = eng.failover.snapshot()
    return (snap["state"], snap["counters"], [(e["now_ms"], e["from"], e["to"], e["reason"]) for e in snap["events"]],
            snap["checkpoint"], snap["last_fault"])


def run_lockstep(scenario, *args):
    """``scenario(lib, *args)`` on both packages; returns the port's
    observations after requiring they equal the JAX package's."""
    out = {}
    for make in (_jax_lib, _port_lib):
        lib = make()
        with lib.config._lock:
            saved = dict(lib.config._runtime)
        clock = lib.clk.ManualClock(start_ms=0)
        prev = lib.clk.set_default_clock(clock)
        lib.clock = clock
        engines = []

        def mk(depth=0, **cfg):
            for key, value in cfg.items():
                lib.config.set(getattr(lib.config, key), str(value))
            eng = lib.Engine(clock=clock, **lib.device_kw)
            eng.pipeline_depth = depth
            engines.append(eng)
            return eng

        lib.mk = mk
        try:
            out[lib.name] = canon(scenario(lib, *args))
        finally:
            for eng in engines:
                if eng.faults is not None:
                    eng.faults.clear()
                eng.failover.close()
            with lib.config._lock:
                lib.config._runtime.clear()
                lib.config._runtime.update(saved)
            lib.clk.set_default_clock(prev)
    assert out["port"] == out["jax"], _first_diff(out["jax"], out["port"])
    return out["port"]


def _first_diff(a, b, path="obs"):
    """Where two canonical observations first differ (for the message)."""
    if type(a) is not type(b):
        return f"{path}: {a!r:.300} != {b!r:.300}"
    if isinstance(a, dict):
        for k in a:
            if k not in b or a[k] != b[k]:
                return _first_diff(a[k], b.get(k), f"{path}.{k}")
        return f"{path}: keys {sorted(a)} != {sorted(b)}"
    if isinstance(a, list):
        if len(a) != len(b):
            return f"{path}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return _first_diff(x, y, f"{path}[{i}]")
    return f"{path}: JAX {a!r:.300} != port {b!r:.300}"
