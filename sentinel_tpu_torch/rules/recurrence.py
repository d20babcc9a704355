"""The segmented recurrence shared by the shaping pacers and the hot-param
buckets (port of ``sentinel_tpu/rules/recurrence.py``), in its plain
PyTorch form.

Items arrive sorted by (key, ts, arrival); per-key state threads through
a key's items in order, and a per-item ``transition`` gives (ok, wait)
and the successor state. The JAX package runs this with three schedules
(unrolled rounds, a ``fori_loop`` of rounds, one ``lax.scan``); all three
compute the same per-item recurrence, so one schedule reproduces them:
round *r* resolves the *r*-th item of every segment, reading the state
its predecessor wrote in round *r - 1*. ``rounds > 0`` stops after that
many rounds, as the JAX rounds path does (an item past the bound keeps
ok = True, wait = 0 and the segment-start state); ``rounds <= 0`` runs
to the longest segment, as the scan does.

Each round works only on the items it resolves (the items are permuted
once so that each round's items are a contiguous slice), so the total
work is O(S) plus a few launches per round. The CUDA kernels of the
port (``csrc/shaping_scan.cu``, ``csrc/param_scan.cu``) walk each
segment in one thread instead.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def sort_order(key: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """The (key, ts, position) order of the items: one stable sort of the
    packed int64 ``(key << 32) | (ts ^ 2^31)``, as the kernels sort (key
    and ts are int32; the bias keeps a negative ts in order)."""
    packed = (key.to(torch.int64) << 32) | (ts.to(torch.int64) + 2**31)
    return torch.sort(packed, stable=True).indices


def run_segmented(
    new_grp: torch.Tensor,  # bool [S] segment starts in sorted order
    seg_states: Tuple[torch.Tensor, ...],  # per-item segment-START state
    items: Tuple[torch.Tensor, ...],  # per-item transition inputs [S]
    transition: Callable,  # (states, items) -> ((ok, wait), new_states)
    rounds: int,
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Returns (ok [S] bool, wait [S] int32, post-item states) in the
    sorted order of the inputs; a segment's final state sits at its last
    item's position (the caller's segment-end write-back)."""
    s = new_grp.shape[0]
    dev = new_grp.device
    ok = torch.ones(s, dtype=torch.bool, device=dev)
    wait = torch.zeros(s, dtype=torch.int32, device=dev)
    out_states = tuple(t.clone() for t in seg_states)
    if s == 0:
        return ok, wait, out_states
    idx = torch.arange(s, device=dev)
    seg_start = torch.cummax(torch.where(new_grp, idx, torch.zeros_like(idx)), 0).values
    seg_pos = idx - seg_start
    longest = int(seg_pos.max()) + 1
    n_rounds = min(rounds, longest) if rounds > 0 else longest
    # Items of round r are order[off[r]:off[r + 1]], ascending in position.
    order = torch.sort(seg_pos, stable=True).indices
    counts = torch.bincount(seg_pos, minlength=longest)[:n_rounds].tolist()
    items_o = tuple(t[order] for t in items)
    start_o = tuple(t[order] for t in seg_states)
    off = 0
    for r in range(n_rounds):
        c = counts[r]
        sel = order[off : off + c]
        if r == 0:
            ins = tuple(t[off : off + c] for t in start_o)
        else:
            ins = tuple(t[sel - 1] for t in out_states)
        (ok_r, wait_r), new = transition(ins, tuple(t[off : off + c] for t in items_o))
        ok[sel] = ok_r
        wait[sel] = wait_r.to(torch.int32)
        for o, v in zip(out_states, new):
            o[sel] = v.to(o.dtype)
        off += c
    return ok, wait, out_states
