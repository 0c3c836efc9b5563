"""Axis-aligned bounding boxes as (min, max) tensor pairs.

Counterpart of `bvh_tpu.core.bbox` (reference: src/bvh/v2/bbox.h). A
bbox is any pair of tensors of shape [..., dim]; all ops are batched.
"""

from __future__ import annotations

import torch

from bvh_tpu_torch.core.utils import robust_max, robust_min


def make_empty(dim: int, dtype=torch.float32, batch_shape=(), device=None):
    """Empty bbox: min=+max_float, max=-max_float (bbox.h:40-44)."""
    big = torch.finfo(dtype).max
    mn = torch.full((*batch_shape, dim), big, dtype=dtype, device=device)
    mx = torch.full((*batch_shape, dim), -big, dtype=dtype, device=device)
    return mn, mx


def from_points(*points):
    """Bbox of one or more [..., dim] point tensors."""
    mn = points[0]
    mx = points[0]
    for p in points[1:]:
        mn = robust_min(mn, p)
        mx = robust_max(mx, p)
    return mn, mx


def extend(a_min, a_max, b_min, b_max):
    """Union with NaN-swallowing min/max (bbox.h:23-27)."""
    return robust_min(a_min, b_min), robust_max(a_max, b_max)


def extend_point(a_min, a_max, p):
    return robust_min(a_min, p), robust_max(a_max, p)


def get_diagonal(mn, mx):
    return mx - mn


def get_center(mn, mx):
    return (mx + mn) * 0.5


def get_half_area(mn, mx):
    """SAH half-area (bbox.h:32-38): (dx + dy) * dz + dx * dy in 3D."""
    d = get_diagonal(mn, mx)
    dim = d.shape[-1]
    if dim == 3:
        return (d[..., 0] + d[..., 1]) * d[..., 2] + d[..., 0] * d[..., 1]
    if dim == 2:
        return d[..., 0] + d[..., 1]
    if dim == 1:
        return d[..., 0]
    total = torch.zeros(d.shape[:-1], dtype=d.dtype, device=d.device)
    for i in range(dim):
        for j in range(i + 1, dim):
            total = total + d[..., i] * d[..., j]
    return total


def reduce_union(mn, mx, axis=0, where=None):
    """Union-reduce a batch of bboxes along `axis`; masked-out entries
    contribute the empty box."""
    if where is not None:
        big = torch.finfo(mn.dtype).max
        mn = torch.where(where[..., None], mn, big)
        mx = torch.where(where[..., None], mx, -big)
    return mn.amin(dim=axis), mx.amax(dim=axis)
