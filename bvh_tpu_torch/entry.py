"""Driver entry points, the counterpart of the repo root's
`__graft_entry__.py`.

`entry(device=None)`: a closest-hit wavefront render step over a binned
build of the golden triangles (tests/golden/tris.bin), as
`__graft_entry__.entry` (its lines 36-47), returned as a function and
its arguments.

`dryrun_multichip(n, device=None)`: the build and the trace of that
scene over n ranks, as `__graft_entry__.dryrun_multichip` (its lines
74-186). Where the JAX package jits one program over an n-device mesh,
the port starts n processes (`torch.multiprocessing.spawn`), each a
rank of a gloo process group joined through a `file://` store in a
temporary directory: the rank-sharded mini-tree build
(`par.build_minitree_sharded`), which must equal `build_minitree` bit
for bit, and the ray-sharded wavefront trace (`par.intersect_tris_sharded`),
which must equal the single trace. The ranks share one card (gloo takes
the device tensors of the mesh's collectives), or run on the CPU with
`device="cpu"`.

Both default to the card. Importing this module does no work.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_TRIS = os.path.join(_ROOT, "tests", "golden", "tris.bin")


def _device(device):
    return torch.device("cuda" if device is None else device)


def tiny_scene(n_rays: int = 256, device="cuda"):
    """The golden triangles' boxes, centres and precomputed rows, and
    sqrt(n_rays)^2 primary rays from (0, 1, 2) down -z, on `device`."""
    from bvh_tpu_torch.cli.camera import primary_rays
    from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri

    data = torch.from_numpy(
        np.fromfile(GOLDEN_TRIS, np.float32).reshape(-1, 3, 3)).to(device)
    tri = Tri(data[:, 0], data[:, 1], data[:, 2])
    bb_min, bb_max = tri.get_bbox()
    flat = PrecomputedTri.from_tri(tri).as_flat()
    side = int(np.sqrt(n_rays))
    rays = primary_rays([0, 1, 2], [0, 0, -1], [0, 1, 0], side, side,
                        device=device)
    return bb_min, bb_max, tri.get_center(), flat, rays


def entry(device=None):
    """(forward, (bvh, flat, rays)): `forward` traces `rays` through the
    binned-SAH tree `bvh` of the golden triangles `flat` (closest hit,
    the wavefront) and returns (t, prim_id)."""
    from bvh_tpu_torch.build.binned import build_binned
    from bvh_tpu_torch.traverse.wavefront import intersect_tris

    bb_min, bb_max, centers, flat, rays = tiny_scene(device=_device(device))
    bvh = build_binned(bb_min, bb_max, centers)

    def forward(bvh, flat, rays):
        hit = intersect_tris(bvh, flat, rays, permuted=False)
        return hit.t, hit.prim_id

    return forward, (bvh, flat, rays)


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """`x` with its last row repeated up to a multiple of n rows."""
    pad = (-x.shape[0]) % n
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if pad else x


def _rank(rank: int, world: int, work: str, device: str) -> None:
    """One rank of `dryrun_multichip`; rank 0 writes work/result.json."""
    import torch.distributed as dist

    from bvh_tpu_torch.build.minitree import MiniTreeConfig, build_minitree
    from bvh_tpu_torch.core.ray import Ray
    from bvh_tpu_torch.par import (build_minitree_sharded,
                                   intersect_tris_sharded, make_mesh)
    from bvh_tpu_torch.traverse.wavefront import intersect_tris

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "store"),
        rank=rank, world_size=world)
    try:
        mesh = make_mesh(world, axis="data", device=device)
        bb_min, bb_max, centers, flat, rays = tiny_scene(64 * world, device)
        n_rays = rays.tmin.shape[0] // world * world
        rays = Ray(*(x[:n_rays] for x in rays))
        bb_min, bb_max, centers, flat = (_pad_to(x, world) for x in (
            bb_min, bb_max, centers, flat))
        cfg = MiniTreeConfig(parallel_threshold=8, log2_grid_dim=2)
        single = build_minitree(bb_min, bb_max, centers, cfg)
        sharded = build_minitree_sharded(bb_min, bb_max, centers, mesh, cfg)
        ns = single.node_count
        if not (ns == sharded.node_count and torch.equal(
                single.index[:ns], sharded.index[:ns]) and torch.equal(
                single.bounds[:ns].view(torch.int32),
                sharded.bounds[:ns].view(torch.int32)) and torch.equal(
                single.prim_ids, sharded.prim_ids)):
            raise AssertionError(f"rank {rank}: the sharded build differs "
                                 "from build_minitree")
        hit = intersect_tris_sharded(sharded, flat, rays, mesh,
                                     permuted=False)
        ref = intersect_tris(single, flat, rays, permuted=False)
        if not (torch.equal(hit.t.view(torch.int32),
                            ref.t.view(torch.int32))
                and torch.equal(hit.prim_id, ref.prim_id)):
            raise AssertionError(f"rank {rank}: the sharded trace differs "
                                 "from the single one")
        if rank == 0:
            with open(os.path.join(work, "result.json"), "w") as f:
                json.dump(dict(ranks=world, device=str(mesh.device),
                               nodes=ns, prims=single.prim_count,
                               rays=n_rays,
                               hits=int(torch.isfinite(hit.t).sum())), f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The sharded build and trace on `n_devices` gloo ranks of
    `device` (the card by default, shared by the ranks). Raises unless
    the sharded build equals `build_minitree` bit for bit and the
    sharded trace the single one. Returns rank 0's counts."""
    import torch.multiprocessing as mp

    dev = str(_device(device))
    with tempfile.TemporaryDirectory() as work:
        mp.spawn(_rank, args=(n_devices, work, dev), nprocs=n_devices,
                 join=True)
        with open(os.path.join(work, "result.json")) as f:
            res = json.load(f)
    print(f"dryrun_multichip ok: {n_devices} ranks on {res['device']}, "
          f"{res['nodes']} nodes (sharded build bit-identical to "
          f"build_minitree), {res['rays']} rays, {res['hits']} hits",
          flush=True)
    return res


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", [tuple(x.shape) for x in out])
    dryrun_multichip(2)
