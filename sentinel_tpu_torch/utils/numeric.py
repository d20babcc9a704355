"""Small numeric helpers shared across the runtime."""

from __future__ import annotations

import torch


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


# ---------------------------------------------------------------------------
# float32 / int32 semantics of the JAX reference on the CPU, for the plain
# PyTorch versions of the kernels
# ---------------------------------------------------------------------------


def wrap_i32(x):
    """An int64 tensor wrapped to int32, as JAX int32 arithmetic wraps."""
    return x.to(torch.int64).to(torch.int32)


def add_i32(a, b):
    """Wrapping int32 addition (int32 or int64 operands)."""
    return wrap_i32(torch.as_tensor(a).to(torch.int64) + torch.as_tensor(b).to(torch.int64))


def sub_i32(a, b):
    """Wrapping int32 subtraction."""
    return wrap_i32(torch.as_tensor(a).to(torch.int64) - torch.as_tensor(b).to(torch.int64))


def mul_i32(a, b):
    """Wrapping int32 multiplication (the int64 product of two int32
    values is exact, so its low 32 bits are the int32 product)."""
    return wrap_i32(torch.as_tensor(a).to(torch.int64) * torch.as_tensor(b).to(torch.int64))


def f32_to_i32(x):
    """float32 -> int32 as XLA converts: toward zero, saturating at the
    int32 range, NaN to 0 (a C cast, and torch's ``.to``, are undefined
    outside the range). PTX ``cvt.rzi.s32.f32`` (``__float2int_rz``) does
    the same on the card."""
    big = torch.tensor(2.0**31, dtype=torch.float32, device=x.device)
    sat = torch.where(x >= big, torch.full_like(x, 2147483520.0), torch.clamp(x, min=-(2.0**31)))
    out = torch.where(torch.isnan(sat), torch.zeros_like(sat), sat).to(torch.int32)
    return torch.where(x >= big, torch.full_like(out, 2**31 - 1), out)


def fma_f32(a, b, c):
    """float32 fused multiply-add, a * b + c with one rounding: XLA's CPU
    backend contracts a multiply feeding an add into an FMA, so the JAX
    reference computes these expressions fused (``__fmaf_rn`` on the
    card). a * b is exact in float64; the float64 sum is rounded once
    more to float32, which differs from one rounding only when the sum
    sits exactly halfway between two float32 values and was itself
    inexact: that case is settled by the sign of the sum's error."""
    a64, b64, c64 = a.to(torch.float64), b.to(torch.float64), c.to(torch.float64)
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)  # TwoSum: p + c = s + err exactly
    r = s.to(torch.float32)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=r.device)
    lo = torch.where(r.to(torch.float64) > s, torch.nextafter(r, -inf), r)
    hi = torch.nextafter(lo, inf)
    tie = ((lo.to(torch.float64) + hi.to(torch.float64)) * 0.5 == s) & (err != 0) & torch.isfinite(s)
    return torch.where(tie, torch.where(err > 0, hi, lo), r)
