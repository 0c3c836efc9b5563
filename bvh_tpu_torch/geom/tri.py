"""Triangles and the Möller–Trumbore intersection, batched.

Counterpart of `bvh_tpu.geom.tri` (reference: src/bvh/v2/tri.h). Every
op is separately rounded (torch does not contract a*b+c into an FMA),
which is the rounding the wide-treelet tables are built with.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bvh_tpu_torch.core import bbox as bbox_ops
from bvh_tpu_torch.core.ray import Ray


def cross(a, b):
    """3D cross product over [..., 3] tensors (reference: vec.h:103-108)."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def dot(a, b):
    """Three-term dot product summed left to right, (x0 + x1) + x2."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


class Tri(NamedTuple):
    """Plain triangle: three [..., 3] vertex tensors (tri.h:14-26)."""

    p0: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor

    def get_bbox(self):
        return bbox_ops.from_points(self.p0, self.p1, self.p2)

    def get_center(self):
        # reference: tri.h:25 ((p0 + p1 + p2) * 1/3), 1/3 rounded to
        # the scalar type first
        third = torch.tensor(1.0 / 3.0, dtype=self.p0.dtype,
                             device=self.p0.device)
        return (self.p0 + self.p1 + self.p2) * third


class PrecomputedTri(NamedTuple):
    """p0, e1 = p0 - p1, e2 = p2 - p0, n = cross(e1, e2)
    (reference: tri.h:29-45)."""

    p0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n: torch.Tensor

    @classmethod
    def from_tri(cls, tri: Tri) -> "PrecomputedTri":
        e1 = tri.p0 - tri.p1
        e2 = tri.p2 - tri.p0
        return cls(tri.p0, e1, e2, cross(e1, e2))

    def convert_to_tri(self) -> Tri:
        return Tri(self.p0, self.p0 - self.e1, self.e2 + self.p0)

    def get_bbox(self):
        return self.convert_to_tri().get_bbox()

    def get_center(self):
        return self.convert_to_tri().get_center()

    def as_flat(self):
        """Pack into [..., 12] (p0|e1|e2|n), the layout the treelet
        tables are built from."""
        return torch.cat([self.p0, self.e1, self.e2, self.n], dim=-1)

    @classmethod
    def from_flat(cls, flat):
        return cls(flat[..., 0:3], flat[..., 3:6], flat[..., 6:9],
                   flat[..., 9:12])

    def intersect(self, ray: Ray, tolerance=None):
        """Möller–Trumbore (reference: tri.h:56-74). Returns
        (t, u, v, hit); NaNs yield a miss."""
        if tolerance is None:
            tolerance = -torch.finfo(self.p0.dtype).eps
        c = self.p0 - ray.org
        r = cross(ray.dir, c)
        inv_det = 1.0 / dot(self.n, ray.dir)
        u = dot(r, self.e2) * inv_det
        v = dot(r, self.e1) * inv_det
        w = 1.0 - u - v
        ok = (u >= tolerance) & (v >= tolerance) & (w >= tolerance)
        t = dot(self.n, c) * inv_det
        hit = ok & (t >= ray.tmin) & (t <= ray.tmax)
        return t, u, v, hit
