"""Times the engine's host path of one checkout of sentinel_tpu_torch on the
card, so that two commits can be compared on one card in alternating runs:

    python3 gpu_engine_ab.py --root path/to/checkout [--tag name]

It builds that checkout's kernels, then drives its engine through names
that every checkout has had since the engine ran on the card (``api.reset``,
the rule managers, ``submit_bulk``, ``submit_exit_bulk``, ``flush``,
``st.entry``):

- chip_smoke.py phase 4's DEFAULT stream: 6,000 QPS rules of count 20, 40
  flushes of 32,768 Zipf(1.1) entries (one ``submit_bulk`` group per
  resource, ts over the last 100 ms) with exits of the last flush's first
  50 groups; the host ms of each flush call (a ``torch.cuda.synchronize()``
  before it, so that no earlier device work is in it), their median and
  quartiles over flushes 5-39, entries per second, the median host split
  (``Engine.last_flush_host_ms``) where the checkout has it, and a digest
  of the stream's verdicts (equal across checkouts);
- ``st.entry`` and exit on one thread against a QPS rule of 20 under a
  ManualClock that moves 7 ms a call, 2,000 calls after 100 of warm-up:
  the ms a call, median and p99.

One JSON line, with the card's name and power limit and the torch version.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from gpu_timing import card_line

N_RULES = 6000
FLUSH_N = 32768
STEPS = 40
ENTRIES = 2000


def engine_stream(st, api, tclock, out: dict) -> None:
    clock = tclock.ManualClock(0)
    api.reset(clock=clock)
    st.flow_rule_manager.load_rules([st.FlowRule(f"r{i}", count=20) for i in range(N_RULES)])
    eng = api.get_engine()
    rng = np.random.default_rng(4)
    ranks = np.arange(1, N_RULES + 1, dtype=np.float64) ** -1.1
    p = ranks / ranks.sum()
    digest = hashlib.sha256()
    call_ms, splits, prev = [], [], []
    for step in range(STEPS):
        now = 1000 + step * 100
        clock.set_ms(now)
        res = rng.choice(N_RULES, size=FLUSH_N, p=p)
        ts = (now - rng.integers(0, 100, FLUSH_N)).astype(np.int32)
        order = np.argsort(res, kind="stable")
        res, ts = res[order], ts[order]
        uniq, start = np.unique(res, return_index=True)
        bounds = list(start) + [FLUSH_N]
        groups = [eng.submit_bulk(f"r{r}", int(bounds[i + 1] - bounds[i]), ts=np.sort(ts[bounds[i]:bounds[i + 1]]))
                  for i, r in enumerate(uniq)]
        for g in prev[:50]:
            if g.admitted_count:
                eng.submit_exit_bulk(g.rows, g.admitted_count, rt=int(rng.integers(1, 300)), ts=now)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.flush()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        if hasattr(type(eng), "last_flush_host_ms"):
            try:
                splits.append(eng.last_flush_host_ms)
            except NotImplementedError:
                pass
        for g in groups:
            digest.update(np.ascontiguousarray(g.admitted).tobytes())
            digest.update(np.ascontiguousarray(g.reason, dtype=np.int32).tobytes())
        prev = groups
    steady = call_ms[5:]
    q1, med, q3 = (float(np.percentile(steady, q)) for q in (25, 50, 75))
    out.update(flush_call_ms=[q1, med, q3], flush_call_ms_all=call_ms, entries_per_s=FLUSH_N / (med / 1e3),
               verdict_digest=digest.hexdigest())
    if splits:
        out["host_split_ms"] = {k: float(np.median([s[k] for s in splits[5:]])) for k in splits[0]}


def entry_calls(st, api, tclock, out: dict) -> None:
    clock = tclock.ManualClock(0)
    api.reset(clock=clock)
    st.flow_rule_manager.load_rules([st.FlowRule("methodA", count=20)])
    lat = []
    passed = 0
    for i in range(100 + ENTRIES):
        clock.set_ms(1000 + 7 * i)
        t0 = time.perf_counter()
        try:
            e = st.entry("methodA")
            e.exit()
            passed += i >= 100
        except st.FlowBlockError:
            pass
        if i >= 100:
            lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    out.update(entry_ms_p50=lat[len(lat) // 2], entry_ms_p99=lat[int(0.99 * len(lat))], entry_passed=passed)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose sentinel_tpu_torch is timed")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gpu_engine_ab: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.core import api
    from sentinel_tpu_torch.utils import clock as tclock
    from sentinel_tpu_torch.utils import cuda_build

    cuda_build.build_all(p.stem for p in sorted(cuda_build.CSRC.glob("*.cu")))
    out = {"tag": args.tag, "root": args.root, "card": card_line(), "torch": torch.__version__}
    engine_stream(st, api, tclock, out)
    entry_calls(st, api, tclock, out)
    api.reset()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
