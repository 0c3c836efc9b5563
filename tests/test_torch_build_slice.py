"""The device-build slice end to end at 3000 triangles, on the CPU:
sponza_class(3000, 3) -> the port's quality-high build
(`build_minitree_fast` + `optimize_reinsertion`) -> treelet tables ->
primary and shadow renders, against bvh_tpu's build (interpret mode) and
render of the same scene.

Prim boxes and centres are computed on the host in numpy float32, as
bench.py:88-90 does. The port builds with its own rounding here, which
differs from XLA's fused multiply-adds (ROADMAP C5), so the two trees
differ; the renders must still agree ray for ray: hit masks equal, t
within 1e-6, prim ids differing only where both hits have the same t
(an exact tie), on at most 0.2% of rays. With XLA's rounding the trees
themselves are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.build.minitree_fast import build_minitree_fast as j_build
from bvh_tpu.build.reinsertion import optimize_reinsertion as j_optimize
from bvh_tpu.core.ray import Ray as JRay
from bvh_tpu.geom.tri import PrecomputedTri as JPre
from bvh_tpu.geom.tri import Tri as JTri
from bvh_tpu.traverse import wide_treelet as jwt
from bvh_tpu_torch.build.minitree_fast import build_minitree_fast
from bvh_tpu_torch.build.reinsertion import optimize_reinsertion
from bvh_tpu_torch.cli.camera import primary_rays
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
from bvh_tpu_torch.io.scenes import scene_camera, sponza_class
from bvh_tpu_torch.traverse import wide_treelet as twt
from helpers import check_bvh_invariants
from test_torch_build import same_tree, xla_rounding  # noqa: F401 - fixture


def _boxes(tris):
    return tris.min(axis=1), tris.max(axis=1), tris.mean(axis=1)


def _port_tree(tris):
    return optimize_reinsertion(build_minitree_fast(
        *(torch.from_numpy(a) for a in _boxes(tris))))


@pytest.fixture(scope="module")
def slice_run():
    tris = sponza_class(3000, seed=3)
    jbvh = j_optimize(j_build(*_boxes(tris), interpret=True))
    tbvh = _port_tree(tris)
    tt = torch.from_numpy(tris)
    flat = PrecomputedTri.from_tri(Tri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
    tl = twt.build_wide_treelets(tbvh, flat, max_prims=256)
    eye, d, up = scene_camera(tris)
    rays = primary_rays(eye, d, up, 32, 32, device="cpu")
    hit = twt.wide_treelet_intersect_tris(tl, rays, tbvh.prim_ids)
    mn, mx = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    light = torch.tensor([mn[0], 0.5 * mx[1], mn[2]], dtype=torch.float32)
    hitp = rays.org + rays.dir * torch.where(torch.isfinite(hit.t), hit.t,
                                             0.0)[:, None]
    srays = Ray.make(hitp, light[None, :] - hitp, tmin=1e-4,
                     tmax=torch.ones_like(hit.t))
    shit = twt.wide_treelet_intersect_tris(tl, srays, tbvh.prim_ids,
                                           any_hit=True)
    jtri = JTri(*(jnp.asarray(tris[:, i]) for i in range(3)))
    jtl = jwt.build_wide_treelets(jbvh, JPre.from_tri(jtri).as_flat(),
                                  max_prims=256)
    return dict(tris=tris, jbvh=jbvh, tbvh=tbvh, jtl=jtl, rays=rays, hit=hit,
                srays=srays, shit=shit)


def test_slice_tree(slice_run):
    """A valid tree over every prim, whose inner boxes are the exact
    merge of their children, with a node count within 5% of bvh_tpu's
    tree."""
    tbvh = slice_run["tbvh"]
    check_bvh_invariants(tbvh, 3000)
    nc = tbvh.node_count
    index = tbvh.index[:nc]
    bounds = tbvh.bounds[:nc]
    inner = torch.nonzero((index & 15) == 0).squeeze(1)
    l, r = index[inner] >> 4, (index[inner] >> 4) + 1
    merged = torch.stack([torch.minimum(bounds[l, 0::2], bounds[r, 0::2]),
                          torch.maximum(bounds[l, 1::2], bounds[r, 1::2])],
                         -1).reshape(-1, 6)
    assert torch.equal(bounds[inner], merged)
    assert abs(nc - int(slice_run["jbvh"].node_count)) < 0.05 * nc


def test_slice_tree_matches_with_fma_rounding(slice_run, xla_rounding):
    assert same_tree(slice_run["jbvh"], _port_tree(slice_run["tris"]))


@pytest.mark.parametrize("kind", ["primary", "shadow"])
def test_slice_render_matches_reference(slice_run, kind):
    any_hit = kind == "shadow"
    r = slice_run["srays" if any_hit else "rays"]
    ours = slice_run["shit" if any_hit else "hit"]
    ref = jwt.wide_treelet_intersect_tris(
        slice_run["jtl"],
        JRay.make(jnp.asarray(r.org.numpy()), jnp.asarray(r.dir.numpy()),
                  tmin=jnp.asarray(r.tmin.numpy()),
                  tmax=jnp.asarray(r.tmax.numpy())),
        prim_ids=slice_run["jbvh"].prim_ids, any_hit=any_hit, block=256,
        top_block=512, interpret=True)
    ot, rt = ours.t.numpy(), np.asarray(ref.t)
    oh, rh = np.isfinite(ot), np.isfinite(rt)
    assert np.array_equal(oh, rh), f"hit masks differ on {(oh != rh).sum()}"
    assert oh.sum() > 50
    if any_hit:
        assert (~oh).sum() > 50
        return
    assert np.allclose(ot[oh], rt[rh], rtol=1e-6, atol=1e-6)
    diff = ours.prim_id.numpy() != np.asarray(ref.prim_id).astype(np.int64)
    assert diff.sum() <= max(1, int(0.002 * len(ot)))
    assert ot[diff].tobytes() == rt[diff].tobytes(), "a prim mismatch off a tie"
