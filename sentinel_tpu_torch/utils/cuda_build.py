"""Build and load the port's hand-written CUDA kernels.

Each ``sentinel_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``: no PyTorch headers, so a build takes seconds. Libraries go to
``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source and flags so an edited source never loads
a stale library. Nothing is built when the package is imported: the
first launch builds, or a caller builds every source at once with
:func:`build_all` (one ``nvcc`` per source, all started together).

Flags: ``-O3`` and IEEE float arithmetic. Never ``--use_fast_math``: the
admission compare needs round-to-nearest conversions and exact division
to agree bit for bit with the JAX reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for base in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if base:
            cand = Path(base) / "bin" / "nvcc"
            if cand.exists():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all running at once. Returns each
    source's compiler output (the ``-Xptxas -v`` register and shared
    memory report); raises if any build fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                _command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    reports: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        (BUILD_DIR / f"{name}.log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                build_all([name])
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
