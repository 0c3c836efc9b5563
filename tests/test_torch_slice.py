"""The port's slice end to end at 3000 triangles, against bvh_tpu on the
same tree bytes, and the package's boundaries (no JAX, no fallback).

The tree comes from the native library as the card check builds it
(quality high, thread pool), through its v2 bytes; the same bytes load
into bvh_tpu, whose interpret-mode render is the reference.
"""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.core.ray import Ray as JRay
from bvh_tpu.geom.tri import PrecomputedTri as JPre
from bvh_tpu.geom.tri import Tri as JTri
from bvh_tpu.io.serialize import deserialize_from_bytes as j_from_bytes
from bvh_tpu.traverse import wide_treelet as jwt
from bvh_tpu_torch import kernels
from bvh_tpu_torch.api.native import NativeBvh3f
from bvh_tpu_torch.cli.camera import primary_rays
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
from bvh_tpu_torch.io.scenes import scene_camera, sponza_class
from bvh_tpu_torch.io.serialize import deserialize_from_bytes, serialize_to_bytes
from bvh_tpu_torch.traverse import collect as tcol
from bvh_tpu_torch.traverse import wide_treelet as twt


@pytest.fixture(scope="module")
def slice_run():
    tris = sponza_class(3000, seed=3)
    native = NativeBvh3f()
    h = native.build(tris.min(axis=1), tris.max(axis=1), tris.mean(axis=1),
                     quality=2, threads=2)
    data = native.to_bytes(h)
    native.destroy(h)
    bvh = deserialize_from_bytes(data)
    tt = torch.from_numpy(tris)
    flat = PrecomputedTri.from_tri(Tri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
    tl = twt.build_wide_treelets(bvh, flat, max_prims=256)
    eye, d, up = scene_camera(tris)
    rays = primary_rays(eye, d, up, 32, 32)
    hit = twt.wide_treelet_intersect_tris(tl, rays, bvh.prim_ids)
    # shadow rays from the hit points toward a point light, built as
    # bench.py builds them; bench's light (above the eye) has no occluder
    # at this scene size, so this one sits at a far corner of the scene
    mn, mx = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    light = torch.tensor([mn[0], 0.5 * mx[1], mn[2]], dtype=torch.float32)
    hitp = rays.org + rays.dir * torch.where(torch.isfinite(hit.t), hit.t,
                                             0.0)[:, None]
    srays = Ray.make(hitp, light[None, :] - hitp, tmin=1e-4,
                     tmax=torch.ones_like(hit.t))
    shit = twt.wide_treelet_intersect_tris(tl, srays, bvh.prim_ids,
                                           any_hit=True)

    jbvh = j_from_bytes(data)
    jtri = JTri(*(jnp.asarray(tris[:, i]) for i in range(3)))
    jtl = jwt.build_wide_treelets(jbvh, JPre.from_tri(jtri).as_flat(),
                                  max_prims=256)
    return dict(data=data, bvh=bvh, tl=tl, jbvh=jbvh, jtl=jtl, rays=rays,
                hit=hit, srays=srays, shit=shit)


def _jray(r):
    return JRay.make(jnp.asarray(r.org.numpy()), jnp.asarray(r.dir.numpy()),
                     tmin=jnp.asarray(r.tmin.numpy()),
                     tmax=jnp.asarray(r.tmax.numpy()))


def test_slice_tree_and_tables(slice_run):
    assert serialize_to_bytes(slice_run["bvh"]) == slice_run["data"]
    assert slice_run["tl"].table.shape[0] >= 2
    for f in ("top_node_t", "table"):
        want = np.asarray(getattr(slice_run["jtl"], f))
        assert getattr(slice_run["tl"], f).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("kind", ["primary", "shadow"])
def test_slice_render_matches_reference(slice_run, kind):
    any_hit = kind == "shadow"
    rays = slice_run["srays" if any_hit else "rays"]
    ours = slice_run["shit" if any_hit else "hit"]
    ref = jwt.wide_treelet_intersect_tris(
        slice_run["jtl"], _jray(rays), prim_ids=slice_run["jbvh"].prim_ids,
        any_hit=any_hit, block=256, top_block=512, interpret=True)
    ot, rt = ours.t.numpy(), np.asarray(ref.t)
    oh, rh = np.isfinite(ot), np.isfinite(rt)
    assert np.array_equal(oh, rh), f"hit masks differ on {(oh != rh).sum()}"
    if any_hit:
        assert oh.sum() > 50 and (~oh).sum() > 50
        return
    assert oh.sum() > 50
    assert np.allclose(ot[oh], rt[rh], rtol=1e-6, atol=1e-6)
    mism = int((ours.prim_id.numpy()
                != np.asarray(ref.prim_id).astype(np.int64)).sum())
    assert mism <= max(1, int(0.002 * len(ot)))


def test_package_imports_no_jax():
    """Every module of the port (and the card check) imports without
    pulling in jax or bvh_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import bvh_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(bvh_tpu_torch.__path__, "
        "'bvh_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'bvh_tpu' or m.startswith('bvh_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('bvh_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=pathlib.Path(__file__).parents[1])
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


def test_kernels_raise_without_cuda_or_nvcc(monkeypatch):
    """No stand-in: without CUDA, or without nvcc, building the kernels
    raises, and no launch is counted."""
    kernels.library.cache_clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernels.library()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.library()
    assert all(k.launches == 0 for k in kernels.KERNELS)


def test_dispatchers_refuse_other_devices():
    """A tensor neither on the CPU nor on a CUDA device is refused, not
    moved: the dispatchers never copy data to the CPU."""
    meta = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tcol.collect_portals(torch.empty((16, 128), device="meta"), meta, 16,
                             robust=False, stack_depth=4, max_portals=8)
    with pytest.raises(ValueError, match="unsupported device"):
        twt.traverse_pairs(torch.empty((1, 64, 128), device="meta"),
                           torch.empty(4, dtype=torch.int32, device="meta"),
                           meta, any_hit=False, robust=False, stack_depth=8)
