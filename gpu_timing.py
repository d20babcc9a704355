"""Timing helpers for the card, shared by chip_smoke.py, gpu_kernel_ab.py
and gpu_engine_ab.py: CUDA-event times, device launches counted with
torch.profiler, the token server's request batches and the card's name
and power limit. Imports torch and numpy, nothing of
sentinel_tpu_torch, so that one copy times any checkout of the package.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

TD_FLOWS, TD_NS, TD_B = 1 << 16, 16, 1 << 14  # token server: flows, namespaces, requests per batch


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms_fresh(setup, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` by CUDA events around each call alone,
    ``setup`` (say, restoring the state ``fn`` writes) run before each one
    and left out of the time."""
    total = 0.0
    for i in range(warmup + iters):
        setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            total += start.elapsed_time(end)
    return total / iters


def _device_events(fn, calls: int, tries: int) -> dict:
    """Device time (us) of every kernel or memset launch, by name, over
    ``calls`` calls of ``fn`` in one torch.profiler (CUPTI) session; copies
    are left out. A session that records no kernel is repeated, up to
    ``tries`` sessions; then RuntimeError, so that a count that was never
    read cannot stand for one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
        per_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not e.name.lower().startswith("memcpy"):
                per_name.setdefault(e.name, []).append(e.device_time_total)
        if any(not name.lower().startswith("memset") for name in per_name):
            return per_name
    raise RuntimeError(f"torch.profiler recorded no device kernel in {tries} sessions of {calls} calls")


def copies_per_call(fn, calls: int = 20, tries: int = 3) -> dict:
    """Device copies a call of ``fn`` by kind ("Memcpy DtoH", "Memcpy
    HtoD", ...), from torch.profiler over ``calls`` calls (each count
    rounded up). A session that records no device kernel is repeated, up to
    ``tries``; then RuntimeError."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if any(not n.lower().startswith(("memcpy", "memset")) for n in names):
            kinds = {}
            for n in names:
                if n.lower().startswith("memcpy"):
                    kind = " ".join(n.split()[:2])
                    kinds[kind] = kinds.get(kind, 0) + 1
            return {k: -(-v // calls) for k, v in kinds.items()}
    raise RuntimeError(f"torch.profiler recorded no device kernel in {tries} sessions of {calls} calls")


def device_profile(fn, calls: int = 20, tries: int = 3):
    """(kernels, memsets, device ms) of one call of ``fn``, from
    torch.profiler over ``calls`` calls: for each kernel or memset name,
    its count over ``calls`` rounded up (in a long process a session was
    seen to miss a few of its first events), and their mean device time."""
    per_name = _device_events(fn, calls, tries)
    per_call = {name: -(-len(us) // calls) for name, us in per_name.items()}
    memsets = sum(n for name, n in per_call.items() if name.lower().startswith("memset"))
    kernels = sum(per_call.values()) - memsets
    return kernels, memsets, sum(per_call[n] * sum(us) / len(us) for n, us in per_name.items()) / 1e3


def _short(name: str) -> str:
    """A kernel's name cut to its function ("fa_topk",
    "DeviceRadixSortOnesweepKernel", "Memset")."""
    bare = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return bare.split("(")[0].split("<")[0].split("::")[-1].strip() or name


def kernel_times(fn, calls: int = 20, tries: int = 3) -> dict:
    """Device us a call of ``fn`` by kernel, the name cut to its function,
    largest first."""
    out = {}
    for name, us in _device_events(fn, calls, tries).items():
        out[_short(name)] = out.get(_short(name), 0.0) + sum(us) / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def kernel_counts(fn, calls: int = 20, tries: int = 3) -> dict:
    """Launches of each kernel (the name cut to its function) over
    ``calls`` calls of ``fn``, from one torch.profiler session."""
    out = {}
    for name, us in _device_events(fn, calls, tries).items():
        out[_short(name)] = out.get(_short(name), 0) + len(us)
    return out


def token_batch(rng, counts: np.ndarray, device, b: int = TD_B, wrap: bool = False):
    """One batch of a token server's stream over ``TD_FLOWS`` flows in
    ``TD_NS`` namespaces (rows ``TD_FLOWS + ns``): Zipf(1.1) flow ids,
    acquire 1-3, the flow's count (``counts``) as its threshold, the
    reference's default namespace guard (30,000 QPS; scaled with the batch
    below 16,384). Namespace 0 holds the even flows (half the traffic, so
    its guard trips), the other 15 share the odd ones. ``wrap``: acquire
    near 2^31 / b, so the batch's int32 cumsum passes 2^31."""
    flow = np.minimum(rng.zipf(1.1, b), TD_FLOWS) - 1
    ns = np.where(flow % 2 == 0, 0, 1 + (flow // 2) % (TD_NS - 1))
    acq = rng.integers(1, 4, b).astype(np.int32)
    thr, nthr = counts[flow], np.full(b, 30000.0 * min(b, TD_B) / TD_B, np.float32)
    if wrap:
        acq = rng.integers(2**31 // b, 3 * (2**31 // b), b).astype(np.int32)
        thr, nthr = thr * np.float32(1e8), rng.choice([1e9, 1e10, 3e10], b).astype(np.float32)
    arrays = (flow.astype(np.int32), (TD_FLOWS + ns).astype(np.int32), acq, thr, nthr, np.ones(b, bool))
    return [torch.from_numpy(a).to(device) for a in arrays]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"
