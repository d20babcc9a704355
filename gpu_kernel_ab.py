"""Times the window update (K2) and the token decision (K12) of one
checkout of sentinel_tpu_torch on the card, so that two commits can be
compared on one card in alternating runs:

    python3 gpu_kernel_ab.py --root path/to/checkout [--tag name]

It builds that checkout's window_update and token_decide kernels, then
times, with CUDA events around back-to-back calls (gpu_timing.time_ms):

- K2: 524,288 entry updates (uniform rows, 90% masked in, the last 100 ms
  of clock) into the minute window [1,048,576, 60, 6];
- K12: batches of 16,384 and of 8 Zipf(1.1) requests over 65,536 flows in
  16 namespaces, on a token server's state after 20 batches.

Inputs are made here from fixed seeds, the same for every checkout; the
token batches are chip_smoke.py's (gpu_timing.token_batch). Each call's
device kernels, memsets and device time are read from torch.profiler over
20 calls; the script fails if the profiler reads no kernel. Prints one
JSON line that carries the card's name and power limit. Needs CUDA;
imports no JAX. The helpers come from the gpu_timing.py beside this
script, whichever checkout it times.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from gpu_timing import TD_B, TD_FLOWS, TD_NS, device_profile, time_ms, token_batch


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose sentinel_tpu_torch is timed")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gpu_kernel_ab: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from sentinel_tpu_torch.cluster import token_service as tts
    from sentinel_tpu_torch.metrics import metric_array as ma
    from sentinel_tpu_torch.metrics import nodes
    from sentinel_tpu_torch.metrics.events import NUM_EVENTS
    from sentinel_tpu_torch.utils import cuda_build

    cuda_build.build_all(["window_update", "token_decide"])
    dev = torch.device("cuda", 0)
    i32 = torch.int32
    out = {"tag": args.tag, "root": args.root, "card": card_line(), "torch": torch.__version__}

    # K2: 524,288 entry updates into the minute window of 1,048,576 rows.
    cfg, rows_n, n, now = nodes.MINUTE_CFG, 1 << 20, 1 << 19, 1_000_000
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    b, wlen = cfg.sample_count, cfg.window_len_ms
    age = torch.randint(-1, 2 * b + 2, (rows_n, b), generator=gen, device=dev, dtype=i32)
    ws = (now - now % wlen) - age * wlen
    state = ma.MetricArrayState(
        torch.randint(0, 40, (rows_n, b, NUM_EVENTS), generator=gen, device=dev, dtype=i32),
        torch.randint(1, cfg.max_rt + 1, (rows_n, b), generator=gen, device=dev, dtype=i32),
        torch.where((age < 0) | (ws < 0), torch.full_like(ws, cfg.empty_ws), ws).to(i32).contiguous(),
    )
    rng = np.random.default_rng(2)
    t = lambda a: torch.from_numpy(a).to(dev)
    rows = t(rng.integers(0, rows_n, n).astype(np.int32))
    ts = t((now - rng.integers(0, 100, n)).astype(np.int32))
    deltas = t(rng.integers(0, 3, (n, NUM_EVENTS)).astype(np.int32))
    mask = t(rng.random(n) < 0.9)
    k2 = lambda: ma.update(cfg, state, rows, ts, deltas, None, mask)
    out["k2_ms"] = time_ms(k2, iters=20)
    out["k2_launches_per_call"], out["k2_memsets_per_call"], out["k2_device_ms"] = device_profile(k2)
    del state
    torch.cuda.empty_cache()

    # K12: a token server's state, 65,536 flows in 16 namespaces.
    counts = rng.integers(50, 501, TD_FLOWS).astype(np.float32)
    st = ma.make_state(TD_FLOWS + TD_NS, tts.CLUSTER_CFG, dev)
    for step in range(20):
        tts.batch_decide(st, *token_batch(rng, counts, dev), 1000 + 50 * step)
    for name, bsz in (("k12", TD_B), ("k12_small", 8)):
        arrays = token_batch(rng, counts, dev, bsz)
        fn = lambda: tts.batch_decide(st, *arrays, 2000)
        out[f"{name}_ms"] = time_ms(fn)
        (out[f"{name}_launches_per_call"], out[f"{name}_memsets_per_call"],
         out[f"{name}_device_ms"]) = device_profile(fn)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
