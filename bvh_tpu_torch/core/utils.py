"""Scalar and bit utilities on tensors.

Counterparts of `bvh_tpu.core.utils` (reference: src/bvh/v2/utils.h).
All functions are elementwise and shape-polymorphic.
"""

from __future__ import annotations

import torch

from bvh_tpu_torch.core import trace

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
# The unsigned type of the same width (reference: utils.h:16-25
# `UnsignedIntType<Bits>`), for callers that name it.
_UINT_FOR_FLOAT = {
    torch.float32: torch.uint32,
    torch.float64: torch.uint64,
    torch.float16: torch.uint16,
    torch.bfloat16: torch.uint16,
}


def uint_type_for(dtype: torch.dtype) -> torch.dtype:
    """Unsigned integer type with the bit width of the float `dtype`."""
    return _UINT_FOR_FLOAT[dtype]


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


def fast_mul_add(a, b, c):
    """a * b + c, with the product and the sum each rounded (reference:
    utils.h:73-81). Every multiply-add of the build that XLA's CPU
    backend contracts into an FMA goes through here, so that a test can
    give the plain versions that rounding (ROADMAP C5); the CUDA
    kernels round the same way as this function (-fmad=false)."""
    return a * b + c


def split_bits(x: torch.Tensor, dim: int = 3, bits: int = 32) -> torch.Tensor:
    """Space the low bits of `x` with `dim - 1` zeros between them
    (reference: utils.h:103-114), as on a `bits`-wide unsigned integer.
    `x` is an int64 tensor holding the unsigned value (torch's CPU build
    has no uint32 shift)."""
    if dim == 1:
        return x
    out = torch.zeros_like(x)
    for i in range(bits // dim):
        out = out | (((x >> i) & 1) << (i * dim))
    return out & ((1 << bits) - 1)


def morton_encode(coords: torch.Tensor, dim: int | None = None,
                  bits: int = 32) -> torch.Tensor:
    """Morton code of integer grid coordinates [..., dim] (x in the
    lowest bit; reference: utils.h:117-120), as on a `bits`-wide
    unsigned integer, carried in int64."""
    if dim is None:
        dim = coords.shape[-1]
    out = torch.zeros(coords.shape[:-1], dtype=torch.int64,
                      device=coords.device)
    for axis in range(dim):
        out = out | (split_bits(coords[..., axis].to(torch.int64), dim, bits)
                     << axis)
    return out & ((1 << bits) - 1)


def scatter_max(target, indices, values) -> torch.Tensor:
    """`target` with `target[i] = max(target[i], v)` over all pairs (i, v)
    of `indices` and `values` along its first axis, as JAX's
    `target.at[indices].max(values, mode="drop")` (the reference's
    `atomic_max`, utils.h:124-129): a negative index counts from the end
    once, an index still out of range is dropped, and duplicates combine
    by their maximum. Returns a new tensor."""
    target = torch.as_tensor(target)
    n = target.shape[0]
    idx = torch.as_tensor(indices, device=target.device).to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    vals = torch.as_tensor(values, dtype=target.dtype,
                           device=target.device).broadcast_to(
                               idx.shape + target.shape[1:])
    keep = (idx >= 0) & (idx < n)
    idx, vals = idx[keep], vals[keep]
    idx = idx.view(-1, *([1] * (target.dim() - 1))).expand_as(vals)
    return target.clone().scatter_reduce_(0, idx, vals, "amax")


def round_up_log2(i: int) -> int:
    """ceil(log2(i)) of a Python int, 0 for i <= 1 (reference:
    utils.h:96-99)."""
    p = 0
    while (1 << p) < i:
        p += 1
    return p


def make_bitmask(bits: int) -> int:
    """The Python int with the low `bits` bits set (reference:
    utils.h:34-37)."""
    return (1 << bits) - 1


def run_stage(name: str, fn, *args, **kwargs):
    """Run one stage of a staged path, `fn(*args, **kwargs)`: the render
    driver (`wide_treelet._attempts`, whose stages `render_at_caps`
    hands to a profiler's runner), the mini-tree build
    (`minitree_fast.build_minitree_fast`) and a reinsertion iteration
    (`reinsertion._one_iteration`). A profiler passes its own runner in
    its place to time or record each stage by `name`
    (bvh_tpu_torch/tools/timing.py's `StageTimer`). While a torch
    profiler records (`core.trace.on()`), the stage runs inside the span
    "bvh.<name>"; otherwise it is the plain call."""
    if trace.on():
        with trace.span("bvh." + name):
            return fn(*args, **kwargs)
    return fn(*args, **kwargs)
