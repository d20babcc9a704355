"""Device selection for the port.

Every entry point of the port runs on the card unless the caller names
the CPU: ``resolve_device()`` returns ``cuda:0`` when CUDA is present and
raises otherwise. It never falls back to the CPU quietly, because a
flush on the CPU runs the kernels' plain versions, and a deployment
that silently lost its card would keep running at a fraction of its
speed. Tests and CPU parity runs pass ``device="cpu"`` explicitly.

Importing this module (or the package) touches no device: the CUDA
probe happens on the first call.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device the engine's state lives on.

    ``None`` means "the card": ``cuda:0``, or ``RuntimeError`` when CUDA
    is absent. An explicit ``"cpu"`` (or any explicit device) is taken
    as given; an explicit CUDA device without CUDA raises too.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sentinel_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain (CPU) versions of the kernels"
            )
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"sentinel_tpu_torch: {dev} requested but CUDA is absent")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
