"""Hygiene of the PyTorch port: importing it loads neither JAX nor the
JAX package; no source of the port (nor chip_smoke.py) imports them;
with no CUDA and no explicit CPU request it refuses to run; and a CPU
tensor takes a kernel's plain version."""

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
        "import sys, sentinel_tpu_torch, sentinel_tpu_torch.core.api, sentinel_tpu_torch.runtime.engine;"
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
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
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
    wrappers = (ma.update, ma.window_reduce, nodes.materialize_matured, nodes.thread_gauge_add,
                flush.flow_admission)
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
    assert res.admitted.tolist() == [True] + [False] * (n - 1)
    assert [w.launches for w in wrappers] == before
