"""Rays as structure-of-arrays tensors, with octant and inverse helpers.

Counterpart of `bvh_tpu.core.ray` (reference: src/bvh/v2/ray.h). One
`Ray` holds [..., dim] origins/directions and [...] tmin/tmax.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bvh_tpu_torch.core.utils import add_ulp_magnitude, safe_inverse


class Ray(NamedTuple):
    """org/dir: [..., dim]; tmin/tmax: [...] (reference: ray.h:15-27)."""

    org: torch.Tensor
    dir: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor

    @classmethod
    def make(cls, org, dir, tmin=None, tmax=None):  # noqa: A002 - matches reference
        """tmin defaults to 0 and tmax to the largest finite value
        (reference: ray.h:24-25)."""
        batch = org.shape[:-1]
        kw = dict(dtype=org.dtype, device=org.device)
        if tmin is None:
            tmin = torch.zeros(batch, **kw)
        if tmax is None:
            tmax = torch.full(batch, torch.finfo(org.dtype).max, **kw)
        tmin = torch.as_tensor(tmin, **kw).expand(batch)
        tmax = torch.as_tensor(tmax, **kw).expand(batch)
        return cls(org, dir, tmin, tmax)

    @property
    def dim(self) -> int:
        return self.org.shape[-1]

    def get_inv_dir(self, safe: bool = False):
        """1 / dir, or the finite `safe_inverse` (ray.h:29-34)."""
        return safe_inverse(self.dir) if safe else 1.0 / self.dir

    def get_octant(self):
        """Per-axis direction sign bits, [..., dim] int32 0/1
        (ray.h:36-43)."""
        return torch.signbit(self.dir).to(torch.int32)

    @staticmethod
    def pad_inv_dir(inv_dir):
        """Pad the inverse direction by 2 ulps (T. Ize's robust
        traversal, ray.h:45-48)."""
        return add_ulp_magnitude(inv_dir, 2)
