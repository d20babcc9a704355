"""The sharded flush (port of ``sentinel_tpu/parallel``).

The JAX package scales the cluster unit over a device mesh: every chip runs
the flush on its shard of the traffic against replicated counters, and the
collectives inside the step rebuild the global state. The port runs the
same step over ``n`` shards of one device (:mod:`.ici`); NCCL between
cards is not ported yet (:func:`make_mesh` refuses a mesh over several
devices).
"""

from __future__ import annotations

from typing import Optional

import torch

from sentinel_tpu_torch.parallel.ici import (
    ShardCollectives,
    cluster_allocate,
    make_sharded_flush,
    merge_stats_across,
    merge_window_across,
    shard_batch,
)
from sentinel_tpu_torch.parallel.mesh import Mesh, make_mesh
from sentinel_tpu_torch.utils.device import DeviceLike, resolve_device


def mesh_unavailable_reason(n_shards: int = 2, device: DeviceLike = None) -> Optional[str]:
    """Why a mesh of ``n_shards`` shards cannot run on ``device`` (the card
    unless the caller names the CPU), or None when it can: the shards
    share one device, so any power of two fits one that exists."""
    if n_shards < 1 or n_shards & (n_shards - 1):
        return f"mesh size must be a power of two, got {n_shards}"
    try:
        dev = resolve_device(device)
    except RuntimeError as exc:
        return str(exc)
    if dev.type == "cuda" and dev.index is not None and dev.index >= torch.cuda.device_count():
        return f"{dev} does not exist ({torch.cuda.device_count()} CUDA devices)"
    return None


__all__ = [
    "Mesh",
    "ShardCollectives",
    "make_mesh",
    "merge_window_across",
    "merge_stats_across",
    "cluster_allocate",
    "make_sharded_flush",
    "shard_batch",
    "mesh_unavailable_reason",
]
