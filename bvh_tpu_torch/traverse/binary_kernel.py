"""Single-launch binary traversal (kernel B5): tables, plain version and
dispatcher.

The CUDA counterpart of `bvh_tpu.traverse.pallas_kernel`. One thread per
ray walks the whole binary tree in one launch (csrc/binary_traverse.cu):
closest or any hit, fast or robust slab test, with per-ray counts of
inner steps and leaves entered. The TPU kernel kept its tables in VMEM
and so took scenes of at most 2,048 nodes and prims; the CUDA kernel
takes a tree of any size, and `pallas_fits` keeps the reference's caps
only so that the CLI selects its paths by the reference's rule.

Tables: node pairs as rows, pair k = children (2k+1, 2k+2):
`node_b` [P, 12] f32 (left box, right box), `node_w` [P, 2] int32 (the
children's index words, integers where the TPU carried f32), and the
triangles by position, `tris` [n, 12] f32 (p0|e1|e2|n).

`binary_traverse` runs the kernel for tensors on a CUDA device and
`binary_traverse_ref`, the plain PyTorch version (the wavefront's state
machine over the same tables), for tensors on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bvh_tpu_torch import kernels
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.core.types import Bvh
from bvh_tpu_torch.geom.tri import PrecomputedTri
from bvh_tpu_torch.traverse.stack import required_stack_depth
from bvh_tpu_torch.traverse.wavefront import Hit, hit_from, walk
from bvh_tpu_torch.traverse.wide_treelet import pack_rays

PALLAS_MAX_NODES = 2048  # the TPU kernel's VMEM caps (pallas_kernel.py:47-48)
PALLAS_MAX_PRIMS = 2048


class BinaryTables(NamedTuple):
    node_b: torch.Tensor  # [P, 12] f32 child-pair boxes
    node_w: torch.Tensor  # [P, 2] int32 child-pair index words
    tris: torch.Tensor    # [n, 12] f32 triangles by prim position
    root_word: int


def pair_tables(bvh: Bvh):
    """The child-pair rows of `bvh` on the tree's device, pair k =
    children (2k+1, 2k+2): node_b [P, 4*dim] f32 (left box, right box)
    and node_w [P, 2] int32 (their index words), and the root word."""
    cap = bvh.index.shape[0]
    dev = bvh.bounds.device
    if int(bvh.index[:bvh.node_count].max()) >= 2 ** 31:
        raise ValueError("index words past 2^31 do not fit the kernel's "
                         "int32 word table")
    pairs = max(1, cap // 2)
    k = torch.arange(pairs, device=dev)
    lc = (2 * k + 1).clamp(0, cap - 1)
    rc = (2 * k + 2).clamp(0, cap - 1)
    node_b = torch.cat([bvh.bounds[lc], bvh.bounds[rc]], 1).to(
        torch.float32).contiguous()
    node_w = torch.stack([bvh.index[lc], bvh.index[rc]], 1).to(
        torch.int32).contiguous()
    return node_b, node_w, int(bvh.index[0])


def make_tables(bvh: Bvh, tri_flat, permuted: bool = False) -> BinaryTables:
    """The kernel's tables of `bvh` on the tree's device; `tri_flat`
    [m, 12] rows by prim id, or by position when `permuted`."""
    if bvh.dim != 3:
        raise ValueError("kernel B5 takes 3D trees; sphere leaves of other "
                         "dims take kernel B6 (sphere_kernel.py)")
    node_b, node_w, root_word = pair_tables(bvh)
    flat = torch.as_tensor(tri_flat, device=node_b.device).to(torch.float32)
    if not permuted:
        flat = flat[bvh.prim_ids.clamp(0, flat.shape[0] - 1)]
    return BinaryTables(node_b, node_w, flat.contiguous(), root_word)


def binary_traverse_ref(tables: BinaryTables, rays, *, any_hit: bool,
                        robust: bool, stack_depth: int):
    """Plain PyTorch version of kernel B5: `wavefront.walk` over the
    kernel's tables, rays with tmin > tmax inactive from the start, as
    the kernel (pallas_kernel.py:171).

    rays: [8, R] f32 (org 0-2, dir 3-5, tmin 6, tmax 7).
    Returns out_f [3, R] f32 (t, u, v; t = +inf on a miss) and out_i
    [4, R] int32 (position or -1, nstat, lstat, stack overflow)."""
    node_b = tables.node_b
    node_w = tables.node_w.to(torch.int64)

    def fetch(fid):
        k = fid >> 1
        return node_b[k, :6], node_b[k, 6:], node_w[k, 0], node_w[k, 1]

    def leaf_fn(pos, rays_now):
        t, u, v, hit = PrecomputedTri.from_flat(tables.tris[pos]).intersect(
            rays_now)
        return hit, t, u, v

    r = Ray(rays[0:3].T, rays[3:6].T, rays[6], rays[7])
    t, u, v, pos, nodes, leaves, ovf = walk(
        fetch, leaf_fn, r, tables.root_word, r.tmin <= r.tmax,
        any_hit=any_hit, robust=robust, stack_depth=stack_depth)
    out_i = torch.stack([pos, nodes, leaves, ovf.to(torch.int64)])
    return torch.stack([t, u, v]), out_i.to(torch.int32)


def binary_traverse(tables: BinaryTables, rays, *, any_hit: bool,
                    robust: bool, stack_depth: int):
    """Kernel B5 for CUDA tensors, the plain version for CPU tensors.
    Same inputs and outputs as `binary_traverse_ref`."""
    if rays.device.type == "cpu":
        return binary_traverse_ref(tables, rays, any_hit=any_hit,
                                   robust=robust, stack_depth=stack_depth)
    if rays.device.type != "cuda":
        raise ValueError(f"binary_traverse: unsupported device {rays.device}")
    if not 1 <= stack_depth <= kernels.BINARY_STACK_MAX:
        raise ValueError(f"binary_traverse: stack depth {stack_depth} "
                         f"exceeds the kernel's {kernels.BINARY_STACK_MAX}")
    R = rays.shape[1]
    for name, t, shape, dtype in (
            ("node_b", tables.node_b, (tables.node_b.shape[0], 12),
             torch.float32),
            ("node_w", tables.node_w, (tables.node_b.shape[0], 2),
             torch.int32),
            ("tris", tables.tris, (tables.tris.shape[0], 12), torch.float32),
            ("rays", rays, (8, R), torch.float32)):
        if (t.device != rays.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"binary_traverse: {name} must be a contiguous "
                             f"{list(shape)} {dtype} tensor on {rays.device}")
    out_f = torch.empty((3, R), dtype=torch.float32, device=rays.device)
    out_i = torch.empty((4, R), dtype=torch.int32, device=rays.device)
    kernels.BINARY_TRAVERSE.launch(
        tables.node_b.data_ptr(), tables.node_w.data_ptr(),
        tables.tris.data_ptr(), rays.data_ptr(), R, tables.root_word,
        int(any_hit), int(robust), stack_depth, out_f.data_ptr(),
        out_i.data_ptr())
    return out_f, out_i


def pallas_fits(bvh: Bvh, tri_flat) -> bool:
    """Whether the reference would route this scene to its
    single-launch kernel: 3D float32 with at most 2,048 node slots and
    2,048 prims (pallas_kernel.py:303-315). The CUDA kernel itself takes
    any size; the CLI keeps the reference's rule."""
    return (bvh.dim == 3 and bvh.bounds.dtype == torch.float32
            and bvh.index.shape[0] <= PALLAS_MAX_NODES
            and tri_flat.shape[0] <= PALLAS_MAX_PRIMS
            and bvh.prim_ids.shape[0] <= PALLAS_MAX_PRIMS)


def pallas_intersect_tris(bvh: Bvh, tri_flat, rays: Ray, *,
                          any_hit: bool = False, robust: bool = False,
                          stack_depth: int | None = None,
                          permuted: bool = False,
                          traverse=binary_traverse) -> Hit:
    """Closest- or any-hit triangle intersection through kernel B5 on
    the rays' device (its plain version on the CPU). `stack_depth=None`
    sizes the stack exactly for this tree; a ray that overflows it
    raises. `traverse` may be `binary_traverse_ref` to run the same
    path through the plain version on any device."""
    if stack_depth is None:
        stack_depth = max(16, required_stack_depth(bvh))
    tables = make_tables(bvh, tri_flat, permuted)
    out_f, out_i = traverse(tables, pack_rays(rays), any_hit=any_hit,
                            robust=robust, stack_depth=stack_depth)
    if bool(out_i[3].any()):
        raise ValueError(f"kernel B5: traversal stack overflow "
                         f"(stack_depth={stack_depth})")
    i64 = out_i.to(torch.int64)
    return hit_from(bvh, out_f[0], out_f[1], out_f[2], i64[0], i64[1], i64[2])
