"""The port's scenes, camera rays and v2 serializer against bvh_tpu's:
byte for byte and bit for bit."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.api.flat import BuildConfig, bvh3f
from bvh_tpu.build.default import Quality
from bvh_tpu.cli.camera import primary_rays as j_primary_rays
from bvh_tpu.geom.tri import Tri as JTri
from bvh_tpu.io import scenes as jscenes
from bvh_tpu.io.serialize import save_bvh as j_save_bvh
from bvh_tpu.io.serialize import serialize_to_bytes as j_to_bytes
from bvh_tpu_torch.cli.camera import primary_rays as t_primary_rays
from bvh_tpu_torch.core.types import bvh_from_numpy
from bvh_tpu_torch.io import scenes as tscenes
from bvh_tpu_torch.io.serialize import (
    bvh_equal,
    deserialize_from_bytes,
    load_bvh,
    save_bvh,
    serialize_to_bytes,
)


@pytest.mark.parametrize("n, seed", [(3000, 3), (262_144, 0)])
def test_sponza_class_byte_equal(n, seed):
    a = tscenes.sponza_class(n, seed=seed)
    b = jscenes.sponza_class(n, seed=seed)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    ca, cb = tscenes.scene_camera(a), jscenes.scene_camera(b)
    for x, y in zip(ca, cb):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


@pytest.mark.parametrize("side", [32, 1024])
def test_primary_rays_bit_equal(side):
    tris = jscenes.sponza_class(3000 if side == 32 else 262_144,
                                seed=3 if side == 32 else 0)
    eye, d, up = jscenes.scene_camera(tris)
    jr = j_primary_rays(eye, d, up, side, side)
    tr = t_primary_rays(eye, d, up, side, side)
    for f in ("org", "dir", "tmin", "tmax"):
        want = np.asarray(getattr(jr, f))
        got = getattr(tr, f).numpy()
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), f


@pytest.mark.parametrize("name, dim, dtype, nodes", [
    ("cornell_sweep.bvh", 3, np.float32, 37),
    ("cornell_sweep_d.bvh", 3, np.float64, 37),
    ("cornell_sweep_2d.bvh", 2, np.float32, 21),
])
def test_golden_roundtrip_byte_exact(golden_dir, tmp_path, name, dim, dtype,
                                     nodes):
    path = os.path.join(golden_dir, name)
    raw = open(path, "rb").read()
    bvh = load_bvh(path, dim=dim, scalar_dtype=dtype)
    assert bvh.node_count == nodes
    assert bvh.index.dtype == torch.int64
    assert serialize_to_bytes(bvh) == raw
    out = str(tmp_path / name)
    save_bvh(bvh, out)
    assert open(out, "rb").read() == raw
    assert bvh_equal(bvh, deserialize_from_bytes(raw, dim, dtype))


@pytest.fixture(scope="module")
def jax_tree():
    tris = jscenes.sponza_class(3000, seed=3)
    tri = JTri(*(jnp.asarray(tris[:, i]) for i in range(3)))
    mn, mx = tri.get_bbox()
    return bvh3f.build(mn, mx, tri.get_center(),
                       BuildConfig(quality=Quality.MEDIUM))


def test_tree_saved_by_bvh_tpu_loads_equal(jax_tree, tmp_path):
    path = str(tmp_path / "jax.bvh")
    j_save_bvh(jax_tree, path)
    bvh = load_bvh(path)
    nc, pc = int(jax_tree.node_count), int(jax_tree.prim_count)
    assert (bvh.node_count, bvh.prim_count) == (nc, pc)
    assert bvh.bounds.numpy().tobytes() == \
        np.asarray(jax_tree.bounds[:nc]).tobytes()
    assert np.array_equal(bvh.index.numpy(),
                          np.asarray(jax_tree.index[:nc]).astype(np.int64))
    assert np.array_equal(bvh.prim_ids.numpy(),
                          np.asarray(jax_tree.prim_ids[:pc]).astype(np.int64))
    assert serialize_to_bytes(bvh) == open(path, "rb").read()


def test_bvh_from_numpy_equals_v2_path(jax_tree):
    nc, pc = int(jax_tree.node_count), int(jax_tree.prim_count)
    direct = bvh_from_numpy(np.asarray(jax_tree.bounds)[:nc],
                            np.asarray(jax_tree.index)[:nc],
                            np.asarray(jax_tree.prim_ids)[:pc], nc, pc, "cpu")
    via_bytes = deserialize_from_bytes(j_to_bytes(jax_tree))
    assert bvh_equal(direct, via_bytes)
    assert serialize_to_bytes(direct) == j_to_bytes(jax_tree)
