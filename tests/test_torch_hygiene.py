"""Hygiene of the PyTorch port: importing it loads neither JAX nor the
JAX package; no source of the port (nor chip_smoke.py, gpu_timing.py or
gpu_kernel_ab.py) imports them; with no CUDA and no explicit CPU request
it refuses to run; a CPU tensor takes a kernel's plain version; and every
public name of the JAX package resolves on the port."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "sentinel_tpu_torch"


def test_import_loads_no_jax():
    code = (
        "import sys, sentinel_tpu_torch, sentinel_tpu_torch.core.api, sentinel_tpu_torch.runtime.engine,"
        " sentinel_tpu_torch.runtime.sketch, sentinel_tpu_torch.cluster, sentinel_tpu_torch.parallel;"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sentinel_tpu' or m.startswith('sentinel_tpu.')];"
        "print(repr(bad))"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "gpu_timing.py", ROOT / "gpu_kernel_ab.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_sources_import_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "sentinel_tpu"), f"{path.name} imports {mod}"


def test_every_module_imports_on_cpu():
    """No module of the port imports triton or builds a kernel at import."""
    import importlib

    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        name = ".".join(rel.parts[:-1] if rel.name == "__init__" else rel.parts)
        importlib.import_module(name)


def test_resolve_device_refuses_silent_cpu(monkeypatch):
    from sentinel_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_engine_and_api_refuse_silent_cpu(monkeypatch):
    from sentinel_tpu_torch.core import api
    from sentinel_tpu_torch.runtime.engine import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Engine()
    prev = api.set_engine(None)
    try:
        with pytest.raises(RuntimeError):
            api.reset()
    finally:
        api.set_engine(prev)
    assert Engine(device="cpu").stats.threads.device.type == "cpu"


@pytest.mark.parametrize("ctor", ["flow_index", "param_state", "token_service", "sketch_state"])
def test_state_constructors_take_the_card_by_default(monkeypatch, ctor):
    """Every constructor of device state resolves a missing device as the
    engine does (the card, or an error without one), never a silent CPU."""
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.rules.flow_table import FlowIndex
    from sentinel_tpu_torch.rules.param_table import make_param_state
    from sentinel_tpu_torch.runtime.sketch import make_sketch_state

    make = {
        "flow_index": lambda **kw: FlowIndex([], **kw).make_dyn_state().latest_passed_time,
        "param_state": lambda **kw: make_param_state(8, **kw).tokens,
        "token_service": lambda **kw: DefaultTokenService(**kw).state.counts,
        "sketch_state": lambda **kw: make_sketch_state(2, 8, 4, **kw).cm,
    }[ctor]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    assert make(device="cpu").device.type == "cpu"


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors each wrapper runs its plain version and counts no
    launch; the kernel path is never entered."""
    from sentinel_tpu_torch.metrics import metric_array as ma
    from sentinel_tpu_torch.metrics import nodes
    from sentinel_tpu_torch.rules.flow_table import FlowIndex
    from sentinel_tpu_torch.models.rules import FlowRule
    from sentinel_tpu_torch.runtime import flush
    from sentinel_tpu_torch.utils import cuda_build

    def no_build(name):
        raise AssertionError(f"kernel {name} built for a CPU tensor")

    monkeypatch.setattr(cuda_build, "load", no_build)
    from sentinel_tpu_torch.cluster import token_service as tts
    from sentinel_tpu_torch.runtime import sketch as tsk

    wrappers = (ma.update, ma.window_reduce, nodes.materialize_matured, nodes.thread_gauge_add,
                nodes.rows_stats, flush.flow_admission, tsk.sketch_fold, tts.batch_decide)
    before = [w.launches for w in wrappers]
    cpu = torch.device("cpu")
    stats = nodes.make_stats(16, cpu)
    fi = FlowIndex([FlowRule("r", count=1)], device=cpu)
    n = 8
    i32 = torch.int32
    batch = flush.FlushBatch(
        now=100, e_valid=torch.ones(n, dtype=torch.bool), e_ts=torch.full((n,), 90, dtype=i32),
        e_acquire=torch.ones(n, dtype=i32), e_rows=torch.tensor([[1, 2, -1, 0]] * n, dtype=i32),
        e_rule_gid=torch.zeros((n, 1), dtype=i32), e_check_row=torch.full((n, 1), 2, dtype=i32),
        e_prio=torch.zeros(n, dtype=torch.bool), e_auth_ok=torch.ones(n, dtype=torch.bool),
        e_cluster_ok=torch.ones(n, dtype=torch.bool), e_dgid=torch.full((n, 1), -1, dtype=i32),
        x_valid=torch.zeros(n, dtype=torch.bool), x_ts=torch.zeros(n, dtype=i32),
        x_count=torch.zeros(n, dtype=i32), x_rows=torch.full((n, 4), -1, dtype=i32),
        x_rt=torch.zeros(n, dtype=i32), x_err=torch.zeros(n, dtype=i32), x_thr=torch.zeros(n, dtype=i32),
        x_dgid=torch.full((n, 1), -1, dtype=i32),
    )
    _, res = flush.flush_step(stats, fi.device, batch, with_exits=True, blk_topk=8)
    ma.window_min_rt(nodes.SECOND_CFG, stats.second, 100)
    rec = nodes.rows_stats(stats, torch.tensor([2, 0, 2], dtype=i32), 100)
    assert rec.shape == (3, nodes.RS_WIDTH) and int(rec[0, nodes.RS_SECOND][0]) == 1
    assert res.admitted.tolist() == [True] + [False] * (n - 1)
    sk = tsk.make_sketch_state(2, 8, 4, cpu)
    tsk.sketch_fold(sk, tsk.SketchBatch(torch.arange(8, dtype=i32), torch.ones(8, dtype=i32)), decay=True)
    assert int((sk.cand_ids >= 0).sum()) == 4
    svc = ma.make_state(8, tts.CLUSTER_CFG, cpu)
    ones = torch.ones(n, dtype=i32)
    adm, _, _ = tts.unpack_decision(tts.batch_decide(svc, ones, -ones, ones, torch.full((n,), 2.0), torch.zeros(n),
                                                     torch.ones(n, dtype=torch.bool), 100))
    assert adm.tolist() == [True] * 2 + [False] * (n - 2)
    assert [w.launches for w in wrappers] == before


def test_cpu_tensors_take_the_plain_versions_on_the_mesh(monkeypatch):
    """The sharded step on CPU tensors runs the plain versions of K13-K16
    and of K8 with its probe_allowed mask, and counts no launch."""
    from sentinel_tpu_torch.core import api
    from sentinel_tpu_torch.parallel import ici
    from sentinel_tpu_torch.rules import degrade_table as tdt
    from sentinel_tpu_torch.utils import cuda_build
    from sentinel_tpu_torch.utils.clock import ManualClock
    import sentinel_tpu_torch as st

    def no_build(name):
        raise AssertionError(f"kernel {name} built for a CPU tensor")

    monkeypatch.setattr(cuda_build, "load", no_build)
    monkeypatch.setattr(ici, "_triton_kernels", lambda: no_build("mesh_merge_stats"))
    counters = [(ici.merge_stats_across, "launches"), (ici.merge_breaker, "launches"),
                (ici.mesh_split_spend, "launches"), (ici.mesh_shaping_charge, "launches"),
                (tdt.breaker_try_pass, "mask_launches")]
    before = [getattr(w, a) for w, a in counters]
    clock = ManualClock(1000)
    api.reset(clock=clock, device="cpu")
    try:
        eng = api.get_engine()
        eng.enable_mesh(4)
        st.flow_rule_manager.load_rules([st.FlowRule("m", count=5),
                                         st.FlowRule("m", count=50, control_behavior=2, max_queueing_time_ms=500)])
        st.degrade_rule_manager.load_rules([st.DegradeRule("m", grade=2, count=1, time_window=1)])
        ops = eng.submit_many([{"resource": "m", "ts": 1000} for _ in range(16)])
        eng.flush()
        assert sum(o.verdict.admitted for o in ops) == 5
    finally:
        api.reset(device="cpu")
    assert [getattr(w, a) for w, a in counters] == before


def _jax_public_names():
    """The JAX package's ``__all__``, read from its source (no JAX import)."""
    tree = ast.parse((ROOT / "sentinel_tpu" / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    raise AssertionError("sentinel_tpu/__init__.py has no __all__")


# The JAX names whose modules are not ported yet, and their ROADMAP items.
_UNPORTED_NAMES = {"trace_context": 8, "TraceContext": 8, "inject_trace_headers": 8,
                   "parse_traceparent": 8, "sample_count_property": 8, "interval_property": 8}


@pytest.mark.parametrize("name", _jax_public_names())
def test_every_jax_public_name_resolves(name):
    """Each name of the JAX package's ``__all__`` is on the port and in its
    ``__all__``: the same object where the port has it, else a stand-in
    that raises NotImplementedError naming its ROADMAP item when called."""
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.utils.unported import UnportedName

    assert name in st.__all__
    obj = getattr(st, name)
    item = _UNPORTED_NAMES.get(name)
    if item is None:
        assert not isinstance(obj, UnportedName), f"{name} is ported: export the port's own object"
        return
    assert isinstance(obj, UnportedName)
    with pytest.raises(NotImplementedError, match=rf"ROADMAP Queue 1 item {item}\b"):
        obj()


def test_ported_public_names_are_the_ports_objects():
    """The names the re-export adds are the port's own objects."""
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.core import api, context
    from sentinel_tpu_torch.models import constants
    from sentinel_tpu_torch.runtime import engine

    assert st.reset_all is api.reset and st.Context is context.Context and st.BulkOp is engine.BulkOp
    jax_version = ast.parse((ROOT / "sentinel_tpu" / "version.py").read_text()).body[-1].value.value
    assert st.constants is constants and st.__version__ == jax_version
    try:
        assert st.set_exceptions_to_trace(KeyError) is None
        assert st.should_trace(KeyError()) and not st.should_trace(ValueError())
        st.set_exceptions_to_ignore(KeyError)
        assert not st.should_trace(KeyError())
        st.set_exception_predicate(lambda e: True)
        assert st.should_trace(ValueError())
    finally:
        st.reset_tracer_filters()
    assert st.should_trace(ValueError())
