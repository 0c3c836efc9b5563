"""Procedural benchmark scenes.

The reference benchmarks against architectural scans (Sponza ~262K
tris, San Miguel ~10M; BASELINE.md). Those assets cannot be downloaded
in this environment, so these generators produce deterministic scenes
with comparable primitive counts and the spatial character that
stresses a BVH the same way: an architectural grid of boxes/columns
with highly non-uniform triangle density plus a detail layer of random
micro-triangles.
"""

from __future__ import annotations

import numpy as np

_CUBE_FACES = [
    # 12 triangles of a unit cube, CCW-ish
    (0, 1, 2), (0, 2, 3), (4, 6, 5), (4, 7, 6),
    (0, 4, 5), (0, 5, 1), (3, 2, 6), (3, 6, 7),
    (0, 3, 7), (0, 7, 4), (1, 5, 6), (1, 6, 2),
]
_CUBE_VERTS = np.asarray(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    np.float32,
)


def _boxes_to_tris(origins, sizes):
    """[k,3] origins/sizes -> [k*12, 3, 3] triangles."""
    v = _CUBE_VERTS[None, :, :] * sizes[:, None, :] + origins[:, None, :]
    faces = np.asarray(_CUBE_FACES, np.int64)
    tris = v[:, faces]  # [k, 12, 3, 3]
    return tris.reshape(-1, 3, 3).astype(np.float32)


def sponza_class(n_target: int = 262_144, seed: int = 0):
    """~n_target triangles: a colonnade grid of boxes (structured,
    axis-aligned, like architecture) + jittered detail triangles
    (foliage-like). Returns [n, 3, 3] float32 vertices."""
    rng = np.random.default_rng(seed)
    n_struct = n_target // 2
    k_boxes = n_struct // 12
    side = max(1, int(np.sqrt(k_boxes)))
    gx, gz = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    origins = np.stack(
        [gx.ravel().astype(np.float32) * 2.0,
         np.zeros(side * side, np.float32),
         gz.ravel().astype(np.float32) * 2.0], axis=1
    )
    k_boxes = len(origins)  # side*side may undershoot k_boxes
    heights = rng.uniform(0.5, 8.0, (k_boxes, 1)).astype(np.float32)
    sizes = np.concatenate(
        [rng.uniform(0.3, 1.2, (k_boxes, 1)).astype(np.float32),
         heights,
         rng.uniform(0.3, 1.2, (k_boxes, 1)).astype(np.float32)], axis=1
    )
    struct = _boxes_to_tris(origins, sizes)

    n_detail = n_target - len(struct)
    centers = rng.uniform(0, 2.0 * side, (n_detail, 3)).astype(np.float32)
    centers[:, 1] = rng.uniform(0, 9.0, n_detail).astype(np.float32)
    e1 = rng.normal(0, 0.05, (n_detail, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.05, (n_detail, 3)).astype(np.float32)
    detail = np.stack([centers, centers + e1, centers + e2], axis=1)

    return np.concatenate([struct, detail], axis=0)


def scene_camera(tris):
    """A camera looking down the scene diagonal, framing the bbox."""
    mn = tris.reshape(-1, 3).min(0)
    mx = tris.reshape(-1, 3).max(0)
    center = (mn + mx) / 2
    size = float(np.linalg.norm(mx - mn))
    eye = center + np.asarray([0.4, 0.3, 0.9]) * size * 0.8
    d = center - eye
    d = d / np.linalg.norm(d)
    return eye.astype(np.float64), d.astype(np.float64), np.asarray([0.0, 1.0, 0.0])
