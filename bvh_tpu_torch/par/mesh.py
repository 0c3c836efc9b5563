"""Multi-device scaling over a torch.distributed process group.

Counterpart of `bvh_tpu.par.mesh`. Where `bvh_tpu` shards arrays over a
`jax.sharding.Mesh` inside one program, the port runs one process per
rank, each with its own device, in a process group that the caller
starts (`torch.distributed.init_process_group`, with its backend, its
address, the world size and the rank):

- traversal scales data-parallel: every rank holds the tree and the
  triangles, traces its contiguous share of the rays, and the hits are
  all-gathered in rank order; no collective runs inside the traversal;
- the mini-tree build scales over the Morton groups
  (`par/minitree_sharded.py`).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.core.types import Bvh
from bvh_tpu_torch.par.executor import tree_map
from bvh_tpu_torch.traverse.wavefront import intersect_tris


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over a process group: this process's rank, the world
    size, the axis name and this rank's device. `group` None is the
    default group."""

    rank: int
    size: int
    axis: str
    device: torch.device
    group: object = None

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's `x` (one shape on all ranks) concatenated along
        dim 0 in rank order (a 0-d `x` gives [size]), on x's device.
        Both backends take device tensors: NCCL gathers on the devices,
        gloo copies them through the host itself."""
        src = x.reshape(1) if x.dim() == 0 else x.contiguous()
        out = torch.empty((self.size * src.shape[0], *src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather(list(out.chunk(self.size)), src, group=self.group)
        return out

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's integer `x`, on x's device. Integers
        only: a float sum's bits would depend on the backend's order."""
        t = x.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t


def make_mesh(n_devices: int | None = None, axis: str = "rays", *,
              device=None) -> Mesh:
    """The mesh over the default process group. `device` defaults to
    `cuda:<LOCAL_RANK>` (the rank where LOCAL_RANK is unset). Raises
    when no group is initialised, or when its world size is not
    `n_devices`."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "make_mesh: no process group; start one in every rank with "
            "torch.distributed.init_process_group(backend, init_method, "
            "world_size=..., rank=...)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and size != n_devices:
        raise ValueError(f"make_mesh: need {n_devices} ranks, the process "
                         f"group has {size}")
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         rank)))
    return Mesh(rank=rank, size=size, axis=axis, device=torch.device(device))


def shard_rays(rays: Ray, mesh: Mesh) -> Ray:
    """Pad the ray batch to a multiple of the world size and return this
    rank's contiguous share on its device. A padded ray has dir 0, tmin
    1 and tmax 0, so it misses everything."""
    r = rays.tmin.shape[0]
    pad = (-r) % mesh.size
    if pad:
        def pad0(x, fill=0.0):
            return torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)])

        rays = Ray(pad0(rays.org), pad0(rays.dir), pad0(rays.tmin, 1.0),
                   pad0(rays.tmax, 0.0))
    share = (r + pad) // mesh.size
    lo = mesh.rank * share
    return Ray(*(x[lo:lo + share].to(mesh.device) for x in rays))


def intersect_tris_sharded(bvh: Bvh, tri_flat, rays: Ray, mesh: Mesh, **kw):
    """Data-parallel traversal: each rank traces its share of the rays
    through `traverse.wavefront.intersect_tris` against its own copy of
    the tree and the triangles; every `Hit` field is all-gathered in
    rank order and cut back to the batch."""
    n_rays = rays.tmin.shape[0]
    dev = mesh.device
    local = Bvh(bounds=bvh.bounds.to(dev), index=bvh.index.to(dev),
                prim_ids=bvh.prim_ids.to(dev), node_count=bvh.node_count,
                prim_count=bvh.prim_count)
    hit = intersect_tris(local, tri_flat.to(dev), shard_rays(rays, mesh),
                         **kw)
    return tree_map(lambda x: mesh.all_gather(x)[:n_rays], hit)
