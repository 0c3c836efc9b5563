"""Scalar and bit utilities on tensors.

Counterparts of `bvh_tpu.core.utils` (reference: src/bvh/v2/utils.h).
All functions are elementwise and shape-polymorphic.
"""

from __future__ import annotations

import torch

# Width-matched signed integer views for bit-level float manipulation.
# torch's CPU build does not implement uint32 arithmetic, so the bit
# pattern is carried in the signed type of the same width; two's
# complement addition gives the same bits as the unsigned add.
_INT_FOR_FLOAT = {
    torch.float32: torch.int32,
    torch.float64: torch.int64,
    torch.float16: torch.int16,
    torch.bfloat16: torch.int16,
}


def robust_min(a, b):
    """NaN-swallowing minimum: returns `b` when `a` is NaN
    (reference: utils.h:40-41). Not torch.minimum, which propagates
    NaN from either side."""
    return torch.where(a < b, a, b)


def robust_max(a, b):
    """NaN-swallowing maximum: returns `b` when `a` is NaN
    (reference: utils.h:42-43)."""
    return torch.where(a > b, a, b)


def add_ulp_magnitude(x: torch.Tensor, ulps: int) -> torch.Tensor:
    """Add `ulps` units-in-the-last-place to the magnitude of `x`;
    non-finite values pass through (reference: utils.h:46-55)."""
    bits = x.view(_INT_FOR_FLOAT[x.dtype]) + ulps
    return torch.where(torch.isfinite(x), bits.view(x.dtype), x)


def signbit(x: torch.Tensor) -> torch.Tensor:
    """Sign bit of each element, ±0 and NaN included."""
    return torch.signbit(x)


def safe_inverse(x: torch.Tensor) -> torch.Tensor:
    """Inverse that never returns inf: |x| <= eps maps to ±max_float
    with the sign of x (reference: utils.h:58-63)."""
    finfo = torch.finfo(x.dtype)
    big = torch.full_like(x, finfo.max)
    return torch.where(x.abs() <= finfo.eps,
                       torch.where(torch.signbit(x), -big, big),
                       1.0 / x)
