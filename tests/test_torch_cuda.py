"""The port's CUDA kernels against their plain PyTorch versions, on a
CUDA device, in every mode (closest/any-hit x fast/robust). They skip
where there is no device. The repository's conftest imports jax, which
the GPU machine does not have, so they run there without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Both sides round every operation separately (the kernels are built
with -fmad=false and use the _rn intrinsics), so outputs must be equal
bit for bit.
"""

import numpy as np
import pytest
import torch

from bvh_tpu_torch import kernels
from bvh_tpu_torch.api.native import NativeBvh3f
from bvh_tpu_torch.cli.camera import primary_rays
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
from bvh_tpu_torch.io.scenes import scene_camera, sponza_class
from bvh_tpu_torch.io.serialize import deserialize_from_bytes
from bvh_tpu_torch.traverse import collect as col
from bvh_tpu_torch.traverse import wide_treelet as wt

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tris = sponza_class(20_000, seed=1)
    native = NativeBvh3f()
    h = native.build(tris.min(axis=1), tris.max(axis=1), tris.mean(axis=1),
                     quality=2, threads=4)
    bvh = deserialize_from_bytes(native.to_bytes(h))
    native.destroy(h)
    tt = torch.from_numpy(tris)
    flat = PrecomputedTri.from_tri(Tri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
    tl = wt.build_wide_treelets(bvh, flat, max_prims=256, device="cuda")
    eye, d, up = scene_camera(tris)
    rays = primary_rays(eye, d, up, 128, 128, device="cuda")
    # zero direction components (+0 x on every 8th ray, -0 z on every
    # 16th) exercise the fast form's clamped inverse and the robust
    # form's inf/NaN slab arithmetic
    rays.dir[::8, 0] = 0.0
    rays.dir[::16, 2] = -0.0
    return tl, rays, bvh.prim_ids.cuda()


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("robust", [False, True])
def test_collect_kernel_equals_plain(scene, robust):
    tl, rays, _ = scene
    packed = wt.pack_rays(rays)
    kw = dict(robust=robust, stack_depth=tl.top_depth + 1, max_portals=64)
    before = kernels.COLLECT.launches
    got = col.collect_portals(tl.top_node_t, packed, tl.top_root, **kw)
    assert kernels.COLLECT.launches == before + 1
    want = col.collect_portals_ref(tl.top_node_t, packed, tl.top_root, **kw)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    assert int(got[2][0].max()) > 1


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("robust", [False, True])
def test_traverse_kernel_equals_plain(scene, any_hit, robust):
    tl, rays, _ = scene
    portals = wt.collect_and_sort(tl, wt.pack_rays(rays), robust=robust,
                                  top_stack=tl.top_depth + 1, max_portals=64)
    kk, rr = torch.nonzero(portals.tid >= 0, as_tuple=True)
    tid = portals.tid[kk, rr].to(torch.int32)
    prays = wt.pack_rays(rays)[:, portals.sel[rr]].contiguous()
    kw = dict(any_hit=any_hit, robust=robust,
              stack_depth=7 * tl.wide_depth + 8)
    before = kernels.WIDE_TREELET.launches
    gf, gi = wt.traverse_pairs(tl.table, tid, prays, **kw)
    assert kernels.WIDE_TREELET.launches == before + 1
    pf, pi = wt.traverse_pairs_ref(tl.table, tid, prays, **kw)
    assert torch.equal(_bits(gf), _bits(pf))
    assert torch.equal(gi, pi)
    assert int(torch.isfinite(gf[0]).sum()) > 100


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("robust", [False, True])
def test_render_kernels_equal_plain_render(scene, any_hit, robust):
    tl, rays, prim_ids = scene
    kw = dict(any_hit=any_hit, robust=robust)
    got = wt.wide_treelet_intersect_tris(tl, rays, prim_ids, **kw)
    want = wt._intersect(tl, rays, prim_ids, col.collect_portals_ref,
                         wt.traverse_pairs_ref, **kw)
    for f in ("t", "u", "v", "prim_pos", "prim_id"):
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f
    hits = int(torch.isfinite(got.t).sum())
    assert 0 < hits < rays.tmin.numel()
    if not any_hit:
        light = torch.tensor([0.0, 50.0, 0.0], device="cuda")
        hitp = rays.org + rays.dir * torch.where(torch.isfinite(got.t),
                                                 got.t, 0.0)[:, None]
        s = Ray.make(hitp, light - hitp, tmin=1e-4,
                     tmax=torch.ones_like(got.t))
        a = wt.wide_treelet_intersect_tris(tl, s, prim_ids, any_hit=True)
        b = wt._intersect(tl, s, prim_ids, col.collect_portals_ref,
                          wt.traverse_pairs_ref, any_hit=True)
        assert np.array_equal(torch.isfinite(a.t).cpu().numpy(),
                              torch.isfinite(b.t).cpu().numpy())
