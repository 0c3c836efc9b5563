"""Single-launch binary traversal with sphere leaves (kernel B6): tables,
plain version, dispatcher and the reference's public names.

The CUDA counterpart of `bvh_tpu.traverse.pallas_sphere`: the binary
walk of kernel B5 (csrc/binary_traverse.cu, templated on the dimension
and the leaf test) with the quadratic sphere test of `geom/sphere.py` at
the leaves, for float32 trees of dim 2, 3 and 4. A hit reports
t = u = the entry distance t0 (clamped to tmin) and v = the exit
distance t1, as `wavefront.traverse` with `make_sphere_leaf_fn` does.
Float64 trees and other dims take that wavefront, as in `bvh_tpu`.

Tables: node pairs as rows, pair k = children (2k+1, 2k+2): `node_b`
[P, 4*dim] f32, `node_w` [P, 2] int32 (index words as integers, where
the TPU carried f32), and the spheres by prim position, `sph`
[n, dim+1] f32 (centre, radius).

`sphere_traverse` runs the kernel for tensors on a CUDA device and
`sphere_traverse_ref`, the plain PyTorch version (`wavefront.walk` over
the same tables), for tensors on the CPU.
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
    pair_tables,
)
from bvh_tpu_torch.traverse.stack import required_stack_depth
from bvh_tpu_torch.traverse.wavefront import Hit, hit_from, walk
from bvh_tpu_torch.traverse.wide_treelet import pack_rays

DIMS = (2, 3, 4)


class SphereTables(NamedTuple):
    node_b: torch.Tensor  # [P, 4*dim] f32 child-pair boxes
    node_w: torch.Tensor  # [P, 2] int32 child-pair index words
    sph: torch.Tensor     # [n, dim+1] f32 spheres by prim position
    root_word: int

    @property
    def dim(self) -> int:
        return self.sph.shape[1] - 1


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
    return SphereTables(node_b, node_w, sph.contiguous(), root_word)


def sphere_traverse_ref(tables: SphereTables, rays, *, any_hit: bool,
                        robust: bool, stack_depth: int):
    """Plain PyTorch version of kernel B6: `wavefront.walk` over the
    kernel's tables, rays with tmin > tmax inactive from the start, as
    the kernel (pallas_sphere.py:150).

    rays: [2*dim+2, R] f32 (org, dir, tmin, tmax).
    Returns out_f [3, R] f32 (t, u, v; t = +inf on a miss) and out_i
    [4, R] int32 (position or -1, nstat, lstat, stack overflow)."""
    dim = tables.dim
    node_b = tables.node_b
    node_w = tables.node_w.to(torch.int64)

    def fetch(fid):
        k = fid >> 1
        return (node_b[k, :2 * dim], node_b[k, 2 * dim:], node_w[k, 0],
                node_w[k, 1])

    def leaf_fn(pos, rays_now):
        row = tables.sph[pos]
        t0, t1, hit = Sphere(row[:, :dim], row[:, dim]).intersect(rays_now)
        return hit, t0, t0, t1

    r = Ray(rays[:dim].T, rays[dim:2 * dim].T, rays[2 * dim],
            rays[2 * dim + 1])
    t, u, v, pos, nodes, leaves, ovf = walk(
        fetch, leaf_fn, r, tables.root_word, r.tmin <= r.tmax,
        any_hit=any_hit, robust=robust, stack_depth=stack_depth)
    out_i = torch.stack([pos, nodes, leaves, ovf.to(torch.int64)])
    return torch.stack([t, u, v]), out_i.to(torch.int32)


def sphere_traverse(tables: SphereTables, rays, *, any_hit: bool,
                    robust: bool, stack_depth: int):
    """Kernel B6 for CUDA tensors, the plain version for CPU tensors.
    Same inputs and outputs as `sphere_traverse_ref`."""
    if rays.device.type == "cpu":
        return sphere_traverse_ref(tables, rays, any_hit=any_hit,
                                   robust=robust, stack_depth=stack_depth)
    if rays.device.type != "cuda":
        raise ValueError(f"sphere_traverse: unsupported device {rays.device}")
    if not 1 <= stack_depth <= kernels.BINARY_STACK_MAX:
        raise ValueError(f"sphere_traverse: stack depth {stack_depth} "
                         f"exceeds the kernel's {kernels.BINARY_STACK_MAX}")
    dim, R, P = tables.dim, rays.shape[1], tables.node_b.shape[0]
    if dim not in DIMS:
        raise ValueError(f"sphere_traverse: kernel B6 takes dims {DIMS}")
    for name, t, shape, dtype in (
            ("node_b", tables.node_b, (P, 4 * dim), torch.float32),
            ("node_w", tables.node_w, (P, 2), torch.int32),
            ("sph", tables.sph, (tables.sph.shape[0], dim + 1),
             torch.float32),
            ("rays", rays, (2 * dim + 2, R), torch.float32)):
        if (t.device != rays.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"sphere_traverse: {name} must be a contiguous "
                             f"{list(shape)} {dtype} tensor on {rays.device}")
    out_f = torch.empty((3, R), dtype=torch.float32, device=rays.device)
    out_i = torch.empty((4, R), dtype=torch.int32, device=rays.device)
    kernels.SPHERE_TRAVERSE.launch(
        dim, tables.node_b.data_ptr(), tables.node_w.data_ptr(),
        tables.sph.data_ptr(), rays.data_ptr(), R, tables.root_word,
        int(any_hit), int(robust), stack_depth, out_f.data_ptr(),
        out_i.data_ptr())
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
