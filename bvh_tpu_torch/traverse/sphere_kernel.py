"""Single-launch binary traversal with sphere leaves (kernel B6): tables,
plain version, dispatcher and the reference's public names.

The CUDA counterpart of `bvh_tpu.traverse.pallas_sphere`: the binary
walk that kernel B5 runs (csrc/binary_traverse.cu,
`binary_traverse_kernel`, one step a lane an iteration, in 2D and 3D in
persistent warps that refill idle lanes) with the quadratic sphere test
of `geom/sphere.py` at the leaves, for float32 trees of dim 2, 3 and 4.
A hit reports t = u = the entry distance t0 (clamped to tmin) and v =
the exit distance t1, as `wavefront.traverse` with `make_sphere_leaf_fn`
does.
Float64 trees and other dims take that wavefront, as in `bvh_tpu`.

Tables, one aligned row a step: node pairs as rows, pair k
= children (2k+1, 2k+2), `pairs` [P, 4*(dim+1)] f32 = left box, right
box, the two children's index words as their int32 bits (integers,
where the TPU carried f32), zero padding to 16-byte rows; and the
spheres by prim position, `spheres` [n, 4] (dim 2, 3) or [n, 8] (dim 4)
f32 = centre, radius, zero padding. Kernel and plain version read the
same rows.

`sphere_traverse` runs the kernel for tensors on a CUDA device and
`sphere_traverse_ref`, the plain PyTorch version (`binary_kernel.walk_rows`
over the same tables), for tensors on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bvh_tpu_torch import kernels
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.core.types import Bvh
from bvh_tpu_torch.core.utils import morton_encode
from bvh_tpu_torch.geom.sphere import Sphere
from bvh_tpu_torch.traverse.binary_kernel import (
    PALLAS_MAX_NODES,
    PALLAS_MAX_PRIMS,
    check_walk_inputs,
    pair_rows,
    pair_tables,
    walk_counter,
    walk_rows,
)
from bvh_tpu_torch.traverse.stack import required_stack_depth
from bvh_tpu_torch.traverse.wavefront import Hit, hit_from
from bvh_tpu_torch.traverse.wide_treelet import pack_rays

DIMS = (2, 3, 4)


class SphereTables(NamedTuple):
    pairs: torch.Tensor    # [P, 4*(dim+1)] f32 child-pair rows
    spheres: torch.Tensor  # [n, SPHERE_WIDTH[dim]] f32 by prim position
    root_word: int

    @property
    def dim(self) -> int:
        return self.pairs.shape[1] // 4 - 1


# floats a sphere row takes: centre and radius, padded to 16 bytes
SPHERE_WIDTH = {2: 4, 3: 4, 4: 8}


def make_tables(bvh: Bvh, centers, radii,
                permuted: bool = False) -> SphereTables:
    """The kernel's tables of `bvh` on the tree's device; `centers`
    [m, dim] and `radii` [m] by prim id, or by position when
    `permuted`."""
    if bvh.dim not in DIMS:
        raise ValueError(f"kernel B6 takes dims {DIMS}, not {bvh.dim}")
    node_b, node_w, root_word = pair_tables(bvh)
    dev = node_b.device
    sph = torch.cat([torch.as_tensor(centers, device=dev),
                     torch.as_tensor(radii, device=dev)[:, None]], 1)
    sph = sph.to(torch.float32)
    if not permuted:
        sph = sph[bvh.prim_ids.clamp(0, sph.shape[0] - 1)]
    spheres = torch.zeros((sph.shape[0], SPHERE_WIDTH[bvh.dim]),
                          dtype=torch.float32, device=dev)
    spheres[:, :bvh.dim + 1] = sph
    return SphereTables(pair_rows(node_b, node_w), spheres, root_word)


def sphere_traverse_ref(tables: SphereTables, rays, *, any_hit: bool,
                        robust: bool, stack_depth: int):
    """Plain PyTorch version of kernel B6: `walk_rows` over the kernel's
    tables with the sphere test at the leaves.

    rays: [2*dim+2, R] f32 (org, dir, tmin, tmax).
    Returns out_f [3, R] f32 (t, u, v; t = +inf on a miss) and out_i
    [4, R] int32 (position or -1, nstat, lstat, stack overflow)."""
    dim = tables.dim

    def leaf_fn(pos, rays_now):
        row = tables.spheres[pos]
        t0, t1, hit = Sphere(row[:, :dim], row[:, dim]).intersect(rays_now)
        return hit, t0, t0, t1

    return walk_rows(tables.pairs, dim, leaf_fn, rays, tables.root_word,
                     any_hit=any_hit, robust=robust, stack_depth=stack_depth)


def sphere_traverse(tables: SphereTables, rays, *, any_hit: bool,
                    robust: bool, stack_depth: int, steps=None):
    """Kernel B6 for CUDA tensors, the plain version for CPU tensors.
    Same inputs and outputs as `sphere_traverse_ref`. `steps`, a [2]
    int64 tensor on the card (closest hit, fast slab only), receives the
    kernel's SIMT counts: its lanes' steps and its warps' steps (an inner
    step or a sphere test each), whose ratio over 32 is the launch's
    SIMT efficiency; the plain version has none."""
    if rays.device.type == "cpu" and steps is None:
        return sphere_traverse_ref(tables, rays, any_hit=any_hit,
                                   robust=robust, stack_depth=stack_depth)
    if rays.device.type != "cuda":
        raise ValueError(f"sphere_traverse: kernel B6 runs on a CUDA device, "
                         f"not {rays.device}")
    dim, R = tables.dim, rays.shape[1]
    if dim not in DIMS:
        raise ValueError(f"sphere_traverse: kernel B6 takes dims {DIMS}")
    check_walk_inputs("sphere_traverse", tables.pairs, tables.spheres,
                      SPHERE_WIDTH[dim], dim, rays, stack_depth, steps)
    if steps is not None and (any_hit or robust):
        raise ValueError("sphere_traverse: SIMT counts are taken for closest "
                         "hit with the fast slab only")
    out_f = torch.empty((3, R), dtype=torch.float32, device=rays.device)
    out_i = torch.empty((4, R), dtype=torch.int32, device=rays.device)
    kernels.SPHERE_TRAVERSE.launch(
        dim, tables.pairs.data_ptr(), tables.spheres.data_ptr(),
        rays.data_ptr(), R, tables.root_word, int(any_hit), int(robust),
        stack_depth, out_f.data_ptr(), out_i.data_ptr(),
        walk_counter(rays.device),
        None if steps is None else steps.data_ptr())
    return out_f, out_i


def coherence_order(org, dir):  # noqa: A002 - matches the reference
    """The rays' launch order (pallas_sphere.py:330-350): a stable sort
    by direction octant, then the Morton code of the origin quantised
    to 64 steps per axis over the rays' bounds, so that a warp's rays
    take similar paths. Returns the permutation."""
    R, dim = org.shape
    neg = (dir < 0).to(torch.int64)
    octk = torch.zeros(R, dtype=torch.int64, device=org.device)
    for d in range(dim):
        octk = octk | (neg[:, d] << d)
    lo = org.amin(0, keepdim=True)
    span = torch.clamp(org.amax(0, keepdim=True) - lo, min=1e-30)
    q = torch.clamp((org - lo) / span * 63.0, 0.0, 63.0).to(torch.int64)
    key = (octk << (6 * dim)) | morton_encode(q, dim)
    return torch.sort(key, stable=True).indices


def pallas_fits_spheres(bvh: Bvh, centers) -> bool:
    """Whether the reference would route this scene to its sphere
    kernel: dim 2, 3 or 4, float32, at most 2,048 node slots and prims
    (pallas_sphere.py:262-269). The CUDA kernel itself takes any size."""
    return (bvh.dim in DIMS and bvh.bounds.dtype == torch.float32
            and bvh.index.shape[0] <= PALLAS_MAX_NODES
            and centers.shape[0] <= PALLAS_MAX_PRIMS
            and bvh.prim_ids.shape[0] <= PALLAS_MAX_PRIMS)


def pallas_intersect_spheres(bvh: Bvh, centers, radii, rays: Ray, *,
                             any_hit: bool = False, robust: bool = False,
                             stack_depth: int | None = None,
                             permuted: bool = False,
                             sort_rays: bool = True) -> Hit:
    """Closest- or any-hit sphere intersection through kernel B6 on the
    rays' device (its plain version on the CPU); the contract of
    `traverse(bvh, rays, make_sphere_leaf_fn(...))`. `stack_depth=None`
    sizes the stack exactly for this tree; a ray that overflows it
    raises. `sort_rays` launches the rays in `coherence_order` and
    scatters the results back, which changes no output."""
    if bvh.bounds.dtype != torch.float32:
        raise ValueError("kernel B6 takes float32 trees; float64 takes "
                         "wavefront.traverse with make_sphere_leaf_fn")
    if stack_depth is None:
        stack_depth = max(16, required_stack_depth(bvh))
    tables = make_tables(bvh, centers, radii, permuted)
    packed = pack_rays(rays)
    order = None
    if sort_rays and packed.shape[1] > 1:
        order = coherence_order(rays.org, rays.dir)
        packed = packed[:, order].contiguous()
    out_f, out_i = sphere_traverse(tables, packed, any_hit=any_hit,
                                   robust=robust, stack_depth=stack_depth)
    if bool(out_i[3].any()):
        raise ValueError(f"kernel B6: traversal stack overflow "
                         f"(stack_depth={stack_depth})")
    if order is not None:
        out_f = torch.empty_like(out_f).index_copy_(1, order, out_f)
        out_i = torch.empty_like(out_i).index_copy_(1, order, out_i)
    i64 = out_i.to(torch.int64)
    return hit_from(bvh, out_f[0], out_f[1], out_f[2], i64[0], i64[1], i64[2])
