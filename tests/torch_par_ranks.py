"""Rank workers of tests/test_torch_par.py.

`torch.multiprocessing.spawn` imports this module anew in every rank, so
it imports neither jax nor a test module: only torch, numpy and the
port. Each rank joins a gloo group through a `file://` store in its
work directory (no TCP port for concurrent test workers to fight over),
reads the inputs the test wrote there, runs the named checks on its
device (the CPU, or a card that ranks may share) and writes its outputs
to `rank<r>.npz` beside them.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from bvh_tpu_torch.build.minitree import MiniTreeConfig
from bvh_tpu_torch.core import utils
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.core.types import bvh_from_numpy
from bvh_tpu_torch.par import (
    build_minitree_sharded,
    intersect_tris_sharded,
    make_mesh,
)
from bvh_tpu_torch.par.executor import ParallelExecutor
from bvh_tpu_torch.par.mesh import Mesh

# name -> MiniTreeConfig keywords of the sharded-build cases
BUILD_CONFIGS = {
    "unpruned": dict(enable_pruning=False, parallel_threshold=256,
                     log2_grid_dim=2),
    "pruned": dict(enable_pruning=True, parallel_threshold=256,
                   log2_grid_dim=2),
}
RAY_COUNTS = (4096, 1003)  # every Cornell ray, and a count 8 does not divide
REDUCE_SIZES = (5, 129, 1000, 4097)
ORIGINAL_FMA = utils.fast_mul_add


def xla_fma(a, b, c):
    """a * b + c with one rounding, as XLA's CPU backend computes it
    (the `xla_rounding` fixture of tests/test_torch_build.py)."""
    return (a.double() * b.double() + c.double()).float()


def _traversal(inputs, mesh):
    bvh = bvh_from_numpy(inputs["bounds"], inputs["index"],
                         inputs["prim_ids"], int(inputs["node_count"]),
                         int(inputs["prim_count"]), "cpu")
    rays = Ray(*(torch.from_numpy(inputs[k])
                 for k in ("org", "dir", "tmin", "tmax")))
    flat = torch.from_numpy(inputs["flat"])
    out = {}
    for r in RAY_COUNTS:
        hit = intersect_tris_sharded(bvh, flat, Ray(*(x[:r] for x in rays)),
                                     mesh, permuted=False)
        for k in ("t", "u", "v", "prim_pos", "prim_id"):
            out[f"hit{r}_{k}"] = getattr(hit, k).numpy()
    return out


def _build(inputs, mesh, prefix=""):
    mn, mx, cc = (torch.from_numpy(inputs[k]) for k in ("mn", "mx", "cc"))
    out = {}
    for name, kw in BUILD_CONFIGS.items():
        b = build_minitree_sharded(mn, mx, cc, mesh, MiniTreeConfig(**kw))
        nc = b.node_count
        key = prefix + name
        out[f"{key}_bounds"] = b.bounds[:nc].cpu().numpy()
        out[f"{key}_index"] = b.index[:nc].cpu().numpy()
        out[f"{key}_prim_ids"] = b.prim_ids.cpu().numpy()
        out[f"{key}_prim_count"] = np.int64(b.prim_count)
    return out


def _build_two(inputs, mesh):
    """The build cases on a group of ranks 0 and 1 only, with the port's
    own rounding (outputs `two_<case>_*`): a second world size without a
    second spawn."""
    group = dist.new_group([0, 1])
    if mesh.rank >= 2:
        return {}
    patched, utils.fast_mul_add = utils.fast_mul_add, ORIGINAL_FMA
    try:
        return _build(inputs, Mesh(mesh.rank, 2, mesh.axis, mesh.device,
                                   group), prefix="two_")
    finally:
        utils.fast_mul_add = patched


def _executor(inputs, mesh):
    ex = ParallelExecutor(mesh)
    out = {}
    for n in REDUCE_SIZES:
        vals = torch.from_numpy(inputs["reduce_vals"][:n])
        out[f"sum{n}"] = ex.reduce(vals, torch.add,
                                   torch.tensor(0.0)).numpy()
    c = torch.from_numpy(inputs["mn"])
    big = torch.finfo(c.dtype).max
    mn, mx = ex.reduce(
        (c, c), lambda a, b: (torch.minimum(a[0], b[0]),
                              torch.maximum(a[1], b[1])),
        (torch.full((3,), big), torch.full((3,), -big)))
    out["bbox_min"], out["bbox_max"] = mn.numpy(), mx.numpy()
    out["squares"] = ex.for_each(13, lambda i: i * i).numpy()
    return out


CHECKS = {"traversal": _traversal, "build": _build, "build_two": _build_two,
          "executor": _executor}


def run(rank: int, world: int, workdir: str, checks, xla: bool,
        device: str = "cpu") -> None:
    """One rank: the `checks` (names of CHECKS) on the inputs in
    `workdir`, on `device`, with XLA's FMA rounding when `xla`."""
    torch.set_num_threads(1)
    if xla:
        utils.fast_mul_add = xla_fma
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=world)
    try:
        inputs = np.load(os.path.join(workdir, "inputs.npz"))
        mesh = make_mesh(world, device=device)
        out = {}
        for name in checks:
            out.update(CHECKS[name](inputs, mesh))
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
