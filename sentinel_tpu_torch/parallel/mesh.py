"""The mesh descriptor (port of ``sentinel_tpu/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` over devices; its tests and
demos run it on a virtual 8-device CPU mesh. The port's counterpart is
``n`` shards on one device: the sharded step (``parallel/ici.py``) runs
each shard's stages in turn, in shard order, and combines them with
in-process collectives over the shard axis. Shards on more than one
device need NCCL between cards, which is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch

from sentinel_tpu_torch.utils.device import DeviceLike, resolve_device

ROADMAP_NCCL = "ROADMAP Queue 1 item 12 (NCCL across 2 or more cards)"


class Mesh(NamedTuple):
    """``n_shards`` data-parallel shards of the flush, all on ``device``."""

    n_shards: int
    device: torch.device


def make_mesh(n_shards: int, device: Union[DeviceLike, Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh of ``n_shards`` (a power of two) shards on ``device`` (the
    card unless the caller names the CPU, as every entry point of the
    port). A sequence of devices asks for shards on each of them: more
    than one distinct device raises ``NotImplementedError``."""
    if isinstance(device, (list, tuple)):
        devs = {resolve_device(d) for d in device}
        if len(devs) > 1:
            raise NotImplementedError(
                f"sentinel_tpu_torch: a mesh over {len(devs)} devices is not ported yet ({ROADMAP_NCCL})"
            )
        device = next(iter(devs)) if devs else None
    n = int(n_shards)
    if n < 1 or n & (n - 1):
        raise ValueError(f"mesh size must be a power of two, got {n}")
    return Mesh(n, resolve_device(device))
