"""Pinhole camera ray generation matching the reference benchmark
(reference: test/benchmark.cpp:343-359). Counterpart of
`bvh_tpu.cli.camera`: the basis and directions are computed in float64
with numpy, then cast, so the rays are bit-identical to `bvh_tpu`'s."""

from __future__ import annotations

import numpy as np
import torch

from bvh_tpu_torch.core.ray import Ray


def camera_basis(dir, up):  # noqa: A002 - matches reference
    d = np.asarray(dir, np.float64)
    d = d / np.linalg.norm(d)
    r = np.cross(d, np.asarray(up, np.float64))
    r = r / np.linalg.norm(r)
    u = np.cross(r, d)
    return d, r, u


def primary_rays(eye, dir, up, width: int, height: int,  # noqa: A002
                 dtype=torch.float32, device="cuda") -> Ray:
    """Rays through pixel (x, y), row-major in y then x:
    dir + u*right + v*up' with u = 2x/W - 1, v = 2y/H - 1, on `device`
    (the card unless the caller names another)."""
    d, r, u = camera_basis(dir, up)
    x = np.arange(width, dtype=np.float64)
    y = np.arange(height, dtype=np.float64)
    uu = 2.0 * x / width - 1.0
    vv = 2.0 * y / height - 1.0
    gu, gv = np.meshgrid(uu, vv, indexing="xy")
    dirs = (d[None, :] + gu.reshape(-1, 1) * r[None, :]
            + gv.reshape(-1, 1) * u[None, :])
    org = np.broadcast_to(np.asarray(eye, np.float64), dirs.shape).copy()
    return Ray.make(torch.as_tensor(org, dtype=dtype, device=device),
                    torch.as_tensor(dirs, dtype=dtype, device=device))
