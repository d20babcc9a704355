"""Build and load the port's hand-written CUDA kernels.

Each ``sentinel_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``: no PyTorch headers, so a build takes seconds. Libraries go to
``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source and flags so an edited source never loads
a stale library. Nothing is built when the package is imported: the
first launch builds, or a caller builds every source at once with
:func:`build_all` (one ``nvcc`` per source, all started together).

Scratch: a kernel's wrapper takes its scratch from :func:`scratch`, one
buffer per (device, stream) kept between calls and grown by doubling, and
a buffer that must be zero at the start of a call (the blocked-weight
top-K's of K4, the probe election's cells of K8, K7's breaker cells,
K11's id table, among others), which every kernel that writes it leaves
all zero. One lock covers every call that uses them.

Checks: a wrapper checks the tables it is given on every call, or through
:func:`check_once` for tables its callers pass call after call.

Flags: ``-O3`` and IEEE float arithmetic. Never ``--use_fast_math``: the
admission compare needs round-to-nearest conversions and exact division
to agree bit for bit with the JAX reference.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import weakref
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import torch

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
    # Shared headers (csrc/*.cuh) are part of every source's hash.
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
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


_checked: Dict[str, Tuple[weakref.ref, ...]] = {}  # key -> the tensors that passed its check last


def check_once(key: str, tensors: Tuple[torch.Tensor, ...], check: Callable[[], None]) -> None:
    """Run ``check`` unless ``tensors`` are the very tensors that passed it
    last under ``key`` (held by weak references, so a new tensor at a freed
    one's address never matches). Only for tensors that callers pass call
    after call and update in place, never replace or resize, such as a
    rule table; each kernel keeps its own key."""
    last = _checked.get(key, ())
    if len(last) == len(tensors) and all(ref() is t for ref, t in zip(last, tensors)):
        return
    check()
    _checked[key] = tuple(weakref.ref(t) for t in tensors)


_scratch_lock = threading.Lock()
_SCRATCH: Dict[Tuple[bool, torch.device, int], torch.Tensor] = {}  # (zeroed, device, stream) -> its bytes


def _grow(zero: bool, device: torch.device, stream: int, nbytes: int) -> torch.Tensor:
    key = (zero, device, stream)
    buf = _SCRATCH.get(key)
    have = 0 if buf is None else buf.numel()
    if have < nbytes:
        make = torch.zeros if zero else torch.empty
        buf = _SCRATCH[key] = make(max(nbytes, 2 * have), dtype=torch.uint8, device=device)
    return buf


@contextlib.contextmanager
def scratch(device: torch.device, stream: int, nbytes: int,
            zero_bytes: int = 0) -> Iterator[Tuple[Optional[int], int, Optional[int]]]:
    """Scratch for one kernel call on ``stream``: yields (pointer to at
    least ``nbytes``, its size, pointer to at least ``zero_bytes`` that are
    zero), a pointer None where no bytes were asked for. The buffers are
    kept per (device, stream) between calls and grown by doubling; the
    zeroed one is made with zeros and the kernel that writes it zeroes it
    again before it ends.

    Hold the block until the call that takes the pointers has returned.
    One lock covers it: host threads share the default stream, and ctypes
    lets go of the GIL during a call, so without it two calls' launches
    interleave on one stream over the same bytes, or a grow frees a buffer
    that a launch still to come points into. Work queued on the stream
    runs in order, so a call that starts after the block ends sees the
    bytes free."""
    with _scratch_lock:
        buf = _grow(False, device, stream, nbytes) if nbytes > 0 else None
        zero = _grow(True, device, stream, zero_bytes) if zero_bytes > 0 else None
        yield (None if buf is None else buf.data_ptr(), 0 if buf is None else buf.numel(),
               None if zero is None else zero.data_ptr())
