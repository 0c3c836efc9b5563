"""Scenes made on the card from a seed.

A torch copy of the port's `io/scenes.py:sponza_class`, the procedural
box grid the port measures at Crytek Sponza's and San Miguel's triangle
counts (their geometry is not in the repository): a colonnade grid of
axis-aligned boxes (half the triangles) plus small random detail
triangles, in float32. The shapes, sizes and ranges are the original's;
the random numbers come from a `torch.Generator` on the scene's device,
drawn in three large calls, so a seed gives the same scene on every run
of the same card type.
"""

from __future__ import annotations

import math

import torch

# The 12 triangles of a unit cube over its 8 corners (io/scenes.py).
CUBE_FACES = ((0, 1, 2), (0, 2, 3), (4, 6, 5), (4, 7, 6),
              (0, 4, 5), (0, 5, 1), (3, 2, 6), (3, 6, 7),
              (0, 3, 7), (0, 7, 4), (1, 5, 6), (1, 6, 2))
CUBE_VERTS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
              (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
DETAIL_HEIGHT = 9.0   # detail triangles' centres lie in y in [0, 9)
BOX_HEIGHT = (0.5, 8.0)
BOX_WIDTH = (0.3, 1.2)
DETAIL_EDGE_SIGMA = 0.05
PITCH = 2.0           # box origins lie on a grid of this pitch in x and z


def grid_side(n_tris: int) -> int:
    """Boxes along each axis of the grid, as `sponza_class` picks it."""
    return max(1, math.isqrt(n_tris // 2 // 12))


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one stream of a seed's numbers (the
    scene, its variants, the poses, ...): seeds past 64 bits are folded,
    and distinct streams of one seed get distinct generator seeds."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(stream)) % (1 << 63))
    return g


def sponza_class(n_tris: int, seed: int, device, variant: int = 0):
    """[n_tris, 3, 3] float32 triangle vertices on `device`: the boxes
    of `grid_side(n_tris)`**2 columns, then detail triangles up to
    n_tris. `variant` draws another scene of the same sizes."""
    g = generator(seed, 1 + variant, device)
    side = grid_side(n_tris)
    k = side * side
    idx = torch.arange(side, device=device, dtype=torch.float32) * PITCH
    gx, gz = torch.meshgrid(idx, idx, indexing="ij")
    origins = torch.stack([gx.reshape(-1), torch.zeros_like(gx.reshape(-1)),
                           gz.reshape(-1)], dim=1)
    u = torch.rand((k, 3), generator=g, device=device)
    lo = torch.tensor([BOX_WIDTH[0], BOX_HEIGHT[0], BOX_WIDTH[0]],
                      device=device)
    hi = torch.tensor([BOX_WIDTH[1], BOX_HEIGHT[1], BOX_WIDTH[1]],
                      device=device)
    sizes = lo + u * (hi - lo)
    verts = torch.tensor(CUBE_VERTS, dtype=torch.float32, device=device)
    faces = torch.tensor(CUBE_FACES, dtype=torch.int64, device=device)
    corners = verts[None] * sizes[:, None] + origins[:, None]   # [k, 8, 3]
    struct = corners[:, faces].reshape(-1, 3, 3)

    n_detail = n_tris - struct.shape[0]
    c = torch.rand((n_detail, 3), generator=g, device=device)
    c = c * torch.tensor([PITCH * side, DETAIL_HEIGHT, PITCH * side],
                         device=device)
    e = torch.randn((2, n_detail, 3), generator=g,
                    device=device) * DETAIL_EDGE_SIGMA
    detail = torch.stack([c, c + e[0], c + e[1]], dim=1)
    return torch.cat([struct, detail]).contiguous()
