"""Small numeric helpers shared across the runtime."""

from __future__ import annotations


def pad_pow2(n: int, minimum: int = 8) -> int:
    """Smallest power of two >= max(n, minimum).

    Batch and table sizes are padded to powers of two so the jitted
    flush kernel sees a bounded set of shapes (each new shape is a
    compile).
    """
    p = max(1, minimum)
    while p < n:
        p <<= 1
    return p
