"""Single-launch binary traversal (kernel B5): tables, plain version and
dispatcher; and the pair rows, plain walk and input checks that kernel
B6 (`sphere_kernel.py`) shares with it.

The CUDA counterpart of `bvh_tpu.traverse.pallas_kernel`. The walk of
csrc/binary_traverse.cu, `binary_traverse_kernel` with a triangle leaf,
takes one step a lane an iteration in persistent warps that refill idle
lanes: closest or any hit, fast or robust slab test, with per-ray counts
of inner steps and leaves entered. The TPU kernel kept its tables in
VMEM and so took scenes of at most 2,048 nodes and prims; the CUDA
kernel takes a tree of any size, and `pallas_fits` keeps the reference's
caps only so that the CLI selects its paths by the reference's rule.

Tables, one 16-byte aligned row a step: node pairs as rows, pair k =
children (2k+1, 2k+2), `pairs` [P, 16] f32 = left box, right box, the
two children's index words as their int32 bits (integers, where the TPU
carried f32), zero padding; and the triangles by position, `tris`
[n, 12] f32 (p0|e1|e2|n). Kernel and plain version read the same rows.

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
    pairs: torch.Tensor  # [P, 16] f32 child-pair rows
    tris: torch.Tensor   # [n, 12] f32 triangles by prim position
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


def pair_rows(node_b, node_w):
    """One row a child pair: `pair_tables`' boxes node_b [P, 4*dim] and
    words node_w [P, 2] int32 (their bits), zero-padded to 4*(dim+1)
    floats."""
    P, width = node_b.shape
    rows = torch.zeros((P, width + 4), dtype=torch.int32,
                       device=node_b.device)
    rows[:, :width] = node_b.contiguous().view(torch.int32)
    rows[:, width:width + 2] = node_w
    return rows.view(torch.float32)


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
    return BinaryTables(pair_rows(node_b, node_w), flat.contiguous(),
                        root_word)


def walk_rows(pairs, dim: int, leaf_fn, rays, root_word: int, *,
              any_hit: bool, robust: bool, stack_depth: int):
    """The plain version of the walk of kernels B5 and B6:
    `wavefront.walk` over the pair rows [P, 4*(dim+1)], rays with
    tmin > tmax inactive from the start, as the kernels
    (pallas_kernel.py:171, pallas_sphere.py:150). `leaf_fn(pos, rays)`
    tests the primitives at `pos` and returns (hit, t, u, v).

    rays: [2*dim+2, R] f32 (org, dir, tmin, tmax).
    Returns out_f [3, R] f32 (t, u, v; t = +inf on a miss) and out_i
    [4, R] int32 (position or -1, nstat, lstat, stack overflow)."""
    words = pairs[:, 4 * dim:4 * dim + 2].view(torch.int32).to(torch.int64)

    def fetch(fid):
        k = fid >> 1
        row = pairs[k]
        return (row[:, :2 * dim], row[:, 2 * dim:4 * dim], words[k, 0],
                words[k, 1])

    r = Ray(rays[:dim].T, rays[dim:2 * dim].T, rays[2 * dim],
            rays[2 * dim + 1])
    t, u, v, pos, nodes, leaves, ovf = walk(
        fetch, leaf_fn, r, root_word, r.tmin <= r.tmax, any_hit=any_hit,
        robust=robust, stack_depth=stack_depth)
    out_i = torch.stack([pos, nodes, leaves, ovf.to(torch.int64)])
    return torch.stack([t, u, v]), out_i.to(torch.int32)


def check_walk_inputs(name: str, pairs, leaves, leaf_width: int, dim: int,
                      rays, stack_depth: int, steps=None) -> None:
    """Raise ValueError unless these are what the walk's kernel takes:
    contiguous, 16-byte aligned f32 pair rows [P, 4*(dim+1)] and leaf
    rows [n, leaf_width], [2*dim+2, R] f32 rays and, where given, [2]
    int64 SIMT counts, all on the rays' device; and a stack within the
    compiled capacity."""
    if not 1 <= stack_depth <= kernels.BINARY_STACK_MAX:
        raise ValueError(f"{name}: stack depth {stack_depth} exceeds the "
                         f"kernel's {kernels.BINARY_STACK_MAX}")
    R = rays.shape[1]
    checks = [("pairs", pairs, (pairs.shape[0], 4 * dim + 4),
               torch.float32, 16),
              ("leaves", leaves, (leaves.shape[0], leaf_width),
               torch.float32, 16),
              ("rays", rays, (2 * dim + 2, R), torch.float32, 4)]
    if steps is not None:
        checks.append(("steps", steps, (2,), torch.int64, 8))
    for what, t, shape, dtype, align in checks:
        if (t.device != rays.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % align):
            raise ValueError(f"{name}: {what} must be a contiguous, "
                             f"{align}-byte aligned {list(shape)} {dtype} "
                             f"tensor on {rays.device}")


# work counters a ring holds: one zeroing a ring-full of launches
WALK_RING = 1024
# the rings, by (device, stream): [counters, the next unused slot]
_RINGS: dict = {}


def walk_counter(device) -> int:
    """The address of the work counter of a launch of B5 or B6 on the
    current stream of `device`: an int32 that is zero, the next unused
    slot of this stream's ring of WALK_RING counters. A used ring is
    zeroed again on the same stream, after the launches that used it, so
    that a launch needs no memset of its own."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    ring = _RINGS.get(key)
    if ring is None:
        ring = _RINGS[key] = [torch.zeros(WALK_RING, dtype=torch.int32,
                                          device=device), 0]
    elif ring[1] == ring[0].numel():
        ring[0].zero_()
        ring[1] = 0
    ring[1] += 1
    return ring[0].data_ptr() + 4 * (ring[1] - 1)


def binary_traverse_ref(tables: BinaryTables, rays, *, any_hit: bool,
                        robust: bool, stack_depth: int):
    """Plain PyTorch version of kernel B5: `walk_rows` over the kernel's
    tables with the Möller–Trumbore test at the leaves.

    rays: [8, R] f32 (org 0-2, dir 3-5, tmin 6, tmax 7).
    Returns out_f [3, R] f32 (t, u, v; t = +inf on a miss) and out_i
    [4, R] int32 (position or -1, nstat, lstat, stack overflow)."""
    def leaf_fn(pos, rays_now):
        t, u, v, hit = PrecomputedTri.from_flat(tables.tris[pos]).intersect(
            rays_now)
        return hit, t, u, v

    return walk_rows(tables.pairs, 3, leaf_fn, rays, tables.root_word,
                     any_hit=any_hit, robust=robust, stack_depth=stack_depth)


def binary_traverse(tables: BinaryTables, rays, *, any_hit: bool,
                    robust: bool, stack_depth: int, steps=None):
    """Kernel B5 for CUDA tensors, the plain version for CPU tensors.
    Same inputs and outputs as `binary_traverse_ref`. `steps`, a [2]
    int64 tensor on the card (closest hit, fast slab only), receives the
    kernel's SIMT counts: its lanes' steps and its warps' steps (an inner
    step or a triangle test each), whose ratio over 32 is the launch's
    SIMT efficiency; the plain version has none."""
    if rays.device.type == "cpu" and steps is None:
        return binary_traverse_ref(tables, rays, any_hit=any_hit,
                                   robust=robust, stack_depth=stack_depth)
    if rays.device.type != "cuda":
        raise ValueError(f"binary_traverse: kernel B5 runs on a CUDA "
                         f"device, not {rays.device}")
    check_walk_inputs("binary_traverse", tables.pairs, tables.tris, 12, 3,
                      rays, stack_depth, steps)
    if steps is not None and (any_hit or robust):
        raise ValueError("binary_traverse: SIMT counts are taken for closest "
                         "hit with the fast slab only")
    R = rays.shape[1]
    out_f = torch.empty((3, R), dtype=torch.float32, device=rays.device)
    out_i = torch.empty((4, R), dtype=torch.int32, device=rays.device)
    kernels.BINARY_TRAVERSE.launch(
        tables.pairs.data_ptr(), tables.tris.data_ptr(), rays.data_ptr(), R,
        tables.root_word, int(any_hit), int(robust), stack_depth,
        out_f.data_ptr(), out_i.data_ptr(),
        walk_counter(rays.device),
        None if steps is None else steps.data_ptr())
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
