"""The port's `par/` against bvh_tpu's on the CPU, in gloo process groups.

One spawn of 8 ranks (tests/torch_par_ranks.py holds the ranks' code;
each rank runs on the CPU and joins through a `file://` store under the
test's tmp directory):

- on all 8, with XLA's FMA rounding (`xla_rounding`, see
  tests/test_torch_build.py): `intersect_tris_sharded` on the Cornell
  box, every ray and a count 8 does not divide, against bvh_tpu's on
  `make_mesh(8)` (the conftest's 8 virtual CPU devices); the sharded
  mini-tree build without and with pruning against the port's
  `build_minitree`, and with pruning against bvh_tpu's; and
  `ParallelExecutor(mesh)` against bvh_tpu's executor;
- on a group of ranks 0 and 1, with the port's own rounding: the
  sharded build against the port's `build_minitree`.

The build cases are tests/test_par.py:80-100's 6,000-primitive scene;
every rank must return the same tree, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_par_ranks as ranks
from bvh_tpu.build.binned import build_binned as j_build_binned
from bvh_tpu.build.minitree import MiniTreeConfig as JConfig
from bvh_tpu.build.minitree import build_minitree as j_build_minitree
from bvh_tpu.par.executor import ParallelExecutor as JParallel
from bvh_tpu.par.mesh import intersect_tris_sharded as j_sharded
from bvh_tpu.par.mesh import make_mesh as j_make_mesh
from bvh_tpu_torch.build.minitree import MiniTreeConfig, build_minitree
from bvh_tpu_torch.core import utils
from bvh_tpu_torch.par import make_mesh
from bvh_tpu_torch.par.mesh import Mesh
from bvh_tpu_torch.par.minitree_sharded import build_minitree_sharded
from helpers import scene_arrays
from test_torch_build import xla_fma
from test_traverse import primary_rays


def build_scene():
    """tests/test_par.py:87-93's scene: 6,000 thin triangles, a count 8
    does not divide, over several Morton groups."""
    rng = np.random.default_rng(11)
    n = 6000
    base = rng.random((n, 1, 3)).astype(np.float32)
    edge = (rng.random((n, 2, 3)).astype(np.float32) - 0.5) * 0.05
    tris = np.concatenate([base, base + edge], axis=1)
    return tuple(np.asarray(x) for x in scene_arrays(tris)[:3])


def spawn(world, workdir, inputs, checks, xla, device="cpu"):
    """Run `checks` on `world` gloo ranks on `device`; each rank's
    outputs."""
    np.savez(workdir / "inputs.npz", **inputs)
    mp.spawn(ranks.run, args=(world, str(workdir), checks, xla, device),
             nprocs=world, join=True)
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(world)]


def port_single(arrays, kw, xla):
    """The port's single-device build, under the rounding the ranks
    used."""
    with pytest.MonkeyPatch.context() as mpatch:
        if xla:
            mpatch.setattr(utils, "fast_mul_add", xla_fma)
        b = build_minitree(*(torch.from_numpy(np.array(a)) for a in arrays),
                           MiniTreeConfig(**kw))
    nc = b.node_count
    return dict(bounds=b.bounds[:nc].numpy(), index=b.index[:nc].numpy(),
                prim_ids=b.prim_ids.numpy(), prim_count=b.prim_count)


def tree_of(out, name):
    return {k: out[f"{name}_{k}"]
            for k in ("bounds", "index", "prim_ids", "prim_count")}


def same_tree(a, b):
    """Node count, bounds (bits), index words, prim ids and count."""
    return (a["bounds"].shape == b["bounds"].shape
            and a["bounds"].tobytes() == b["bounds"].tobytes()
            and np.array_equal(a["index"], b["index"])
            and np.array_equal(a["prim_ids"], b["prim_ids"])
            and int(a["prim_count"]) == int(b["prim_count"]))


@pytest.fixture(scope="module")
def scene():
    return build_scene()


@pytest.fixture(scope="module")
def cornell(cornell_tris):
    mn, mx, centers, flat = scene_arrays(cornell_tris)
    return j_build_binned(mn, mx, centers), flat, primary_rays()


@pytest.fixture(scope="module")
def eight(tmp_path_factory, scene, cornell):
    jbvh, flat, rays = cornell
    rng = np.random.default_rng(7)
    inputs = dict(
        bounds=np.asarray(jbvh.bounds), index=np.asarray(jbvh.index),
        prim_ids=np.asarray(jbvh.prim_ids), node_count=int(jbvh.node_count),
        prim_count=int(jbvh.prim_count), flat=np.asarray(flat),
        org=np.asarray(rays.org), dir=np.asarray(rays.dir),
        tmin=np.asarray(rays.tmin), tmax=np.asarray(rays.tmax),
        mn=scene[0], mx=scene[1], cc=scene[2],
        # magnitudes over 8 decades, so that a left fold and the halving
        # schedule round differently
        reduce_vals=(rng.standard_normal(max(ranks.REDUCE_SIZES))
                     * 10.0 ** rng.uniform(-4, 4, max(ranks.REDUCE_SIZES))
                     ).astype(np.float32))
    return inputs, spawn(8, tmp_path_factory.mktemp("par8"), inputs,
                         ["traversal", "build", "build_two", "executor"],
                         xla=True)


@pytest.mark.parametrize("n_rays", ranks.RAY_COUNTS)
def test_sharded_traversal_matches_bvh_tpu(eight, cornell, n_rays):
    jbvh, flat, rays = cornell
    rays = type(rays)(*(x[:n_rays] for x in rays))
    want = j_sharded(jbvh, flat, rays, j_make_mesh(8), permuted=False)
    for out in eight[1]:
        np.testing.assert_array_equal(
            out[f"hit{n_rays}_prim_pos"],
            np.asarray(want.prim_pos).astype(np.int64))
        assert out[f"hit{n_rays}_t"].tobytes() == np.asarray(
            want.t).tobytes()


@pytest.mark.parametrize("world,name", [(2, "unpruned"), (2, "pruned"),
                                        (8, "unpruned"), (8, "pruned")])
def test_sharded_build_bit_identical(eight, scene, world, name):
    """Every rank's tree equals the port's single-device build."""
    xla = world == 8
    single = port_single(scene, ranks.BUILD_CONFIGS[name], xla)
    for out in eight[1][:world]:
        assert same_tree(tree_of(out, name if xla else f"two_{name}"),
                         single)


def test_sharded_build_matches_bvh_tpu(eight):
    """With pruning, at 8 ranks, bvh_tpu's single-device tree; its
    threshold sums the groups' root areas in the port's order (ROADMAP
    C16)."""
    inputs = eight[0]
    kw = ranks.BUILD_CONFIGS["pruned"]
    jb = j_build_minitree(*(jnp.asarray(inputs[k]) for k in ("mn", "mx",
                                                              "cc")),
                          JConfig(**kw))
    nc = int(jb.node_count)
    want = dict(bounds=np.asarray(jb.bounds)[:nc],
                index=np.asarray(jb.index)[:nc].astype(np.int64),
                prim_ids=np.asarray(jb.prim_ids).astype(np.int64),
                prim_count=int(jb.prim_count))
    assert same_tree(tree_of(eight[1][0], "pruned"), want)


def test_parallel_reduce_mesh(eight):
    """`ParallelExecutor(mesh).reduce` at 8 ranks: bvh_tpu's bits for
    float sums, whose left fold differs; the exact bbox; for_each."""
    inputs, outs = eight
    vals = inputs["reduce_vals"]
    jex = JParallel()
    for n in ranks.REDUCE_SIZES:
        want = np.asarray(jex.reduce(jnp.asarray(vals[:n]), jnp.add,
                                     jnp.asarray(0.0, jnp.float32)))
        for out in outs:
            assert out[f"sum{n}"].tobytes() == want.tobytes(), n
    fold = np.float32(0)
    for v in vals[:1000]:
        fold = np.float32(fold + v)
    assert fold.tobytes() != outs[0]["sum1000"].tobytes()
    for out in outs:
        np.testing.assert_array_equal(out["bbox_min"], inputs["mn"].min(0))
        np.testing.assert_array_equal(out["bbox_max"], inputs["mn"].max(0))
        np.testing.assert_array_equal(out["squares"], np.arange(13) ** 2)


def test_prim_cap_error(scene):
    """A share over `prim_cap` raises in the pre-pass, before any
    collective (tests/test_par.py's bvh_tpu check, minitree_sharded.py
    :109-115)."""
    mesh = Mesh(rank=0, size=8, axis="rays", device=torch.device("cpu"))
    with pytest.raises(ValueError, match="exceeds prim_cap 100"):
        build_minitree_sharded(*(torch.from_numpy(np.array(a)) for a in scene),
                               mesh,
                               MiniTreeConfig(**ranks.BUILD_CONFIGS["pruned"]),
                               prim_cap=100)


def test_make_mesh_needs_a_group():
    with pytest.raises(ValueError, match="no process group"):
        make_mesh(8)
