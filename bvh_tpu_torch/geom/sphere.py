"""Spheres and the quadratic ray intersection, batched, any dim.

Counterpart of `bvh_tpu.geom.sphere` (reference: src/bvh/v2/sphere.h).
Every op is separately rounded, as kernel B6 computes it. The products
that XLA's CPU backend contracts into FMAs inside B6's Pallas kernel
(ROADMAP C5) go through `core.utils.fast_mul_add`: each dot product as
fma(x2, y2, fma(x1, y1, x0*y0)), `c` as fma(-r, r, oc.oc) and the
discriminant as fma(b, b, -(4a*c)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bvh_tpu_torch.core import utils
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.core.utils import robust_max, robust_min


def dot_chain(x, y):
    """sum_i x_i*y_i over the last axis, accumulated left to right
    through `fast_mul_add`."""
    s = x[..., 0] * y[..., 0]
    for i in range(1, x.shape[-1]):
        s = utils.fast_mul_add(x[..., i], y[..., i], s)
    return s


class Sphere(NamedTuple):
    """center: [..., dim]; radius: [...] (sphere.h:14-27)."""

    center: torch.Tensor
    radius: torch.Tensor

    def get_center(self):
        return self.center

    def get_bbox(self):
        r = self.radius[..., None]
        return self.center - r, self.center + r  # sphere.h:25-27

    def intersect(self, ray: Ray, assume_normalized: bool = False):
        """Quadratic intersection clamped to the ray interval
        (sphere.h:31-49). Returns `(t0, t1, hit)`: the entry distance
        t0 is clamped up to tmin and the exit t1 down to tmax with the
        NaN-swallowing robust_max/robust_min; a hit has delta >= 0 and
        t0 <= t1."""
        oc = ray.org - self.center
        if assume_normalized:
            a = torch.ones_like(self.radius)
        else:
            a = dot_chain(ray.dir, ray.dir)
        b = 2.0 * dot_chain(ray.dir, oc)
        c = utils.fast_mul_add(-self.radius, self.radius, dot_chain(oc, oc))
        delta = utils.fast_mul_add(b, b, -(4.0 * a * c))
        inv = -0.5 / a
        sqrt_delta = torch.sqrt(torch.where(delta < 0, 0.0, delta))
        t0 = robust_max((b + sqrt_delta) * inv, ray.tmin)
        t1 = robust_min((b - sqrt_delta) * inv, ray.tmax)
        return t0, t1, (delta >= 0) & (t0 <= t1)
