"""The port's wide-treelet render against bvh_tpu's, on the fixture of
tests/test_wide_treelet.py (sponza_class(3000, 3), MEDIUM tree, 32x32
primary rays, max_prims=256).

- treelet tables: bit-identical;
- the whole render against `wide_treelet_intersect_tris(interpret=True)`
  under the rule of tests/test_wide_treelet.py:40-56;
- capacity overflow handling and the two-level guard.

The two kernels' plain versions are held against bvh_tpu's kernels in
tests/test_torch_wide_kernels.py, on the same fixture.

Why some comparisons carry a tolerance: XLA's CPU backend contracts
a*b+c into fused multiply-adds inside compiled code (ROADMAP C5), where
the port, the CUDA kernels (-fmad=false) and the TPU's Mosaic round
every operation separately. That moves the reference's fast-form slab
distances and its Möller–Trumbore cross products by a few ulps. The
state machines agree exactly once the plain version is given the same
FMA rounding (test_collect_fast_matches_pallas_with_fma_rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.api.flat import BuildConfig, bvh3f
from bvh_tpu.build.default import Quality
from bvh_tpu.cli.camera import primary_rays as j_primary_rays
from bvh_tpu.geom.tri import PrecomputedTri as JPre
from bvh_tpu.geom.tri import Tri as JTri
from bvh_tpu.io.scenes import scene_camera, sponza_class
from bvh_tpu.traverse import wide_treelet as jwt
from bvh_tpu_torch.cli.camera import primary_rays as t_primary_rays
from bvh_tpu_torch.core.types import bvh_from_numpy
from bvh_tpu_torch.geom.tri import PrecomputedTri as TPre
from bvh_tpu_torch.geom.tri import Tri as TTri
from bvh_tpu_torch.traverse import wide_treelet as twt


@pytest.fixture(scope="module")
def scene():
    tris = sponza_class(3000, seed=3)
    tri = JTri(*(jnp.asarray(tris[:, i]) for i in range(3)))
    mn, mx = tri.get_bbox()
    jbvh = bvh3f.build(mn, mx, tri.get_center(),
                       BuildConfig(quality=Quality.MEDIUM))
    jflat = JPre.from_tri(tri).as_flat()
    eye, d, up = scene_camera(tris)
    jrays = j_primary_rays(eye, d, up, 32, 32)
    jtl = jwt.build_wide_treelets(jbvh, jflat, max_prims=256)

    nc, pc = int(jbvh.node_count), int(jbvh.prim_count)
    tbvh = bvh_from_numpy(np.asarray(jbvh.bounds)[:nc],
                          np.asarray(jbvh.index)[:nc],
                          np.asarray(jbvh.prim_ids)[:pc], nc, pc, "cpu")
    tt = torch.from_numpy(tris)
    tflat = TPre.from_tri(TTri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
    ttl = twt.build_wide_treelets(tbvh, tflat, max_prims=256)
    trays = t_primary_rays(eye, d, up, 32, 32)
    return dict(jbvh=jbvh, jflat=jflat, jtl=jtl, jrays=jrays, tbvh=tbvh,
                ttl=ttl, trays=trays, packed=twt.pack_rays(trays))


@pytest.mark.parametrize("max_prims, super_prims", [(256, None), (128, 512)])
def test_tables_bit_identical(scene, max_prims, super_prims):
    """Including a two-level cut (a super level above the treelets),
    whose tables the port builds although its render does not take
    them yet."""
    if max_prims == 256:
        jtl, ttl = scene["jtl"], scene["ttl"]
    else:
        jbvh = scene["jbvh"]
        jflat = np.array(scene["jflat"])
        jtl = jwt.build_wide_treelets(jbvh, jnp.asarray(jflat),
                                      max_prims=max_prims,
                                      super_prims=super_prims)
        ttl = twt.build_wide_treelets(scene["tbvh"], torch.from_numpy(jflat),
                                      max_prims=max_prims,
                                      super_prims=super_prims)
        assert ttl.sup_table.shape[0] > 0
    for f in ("top_node_t", "table", "sup_table"):
        want = np.asarray(getattr(jtl, f))
        got = getattr(ttl, f).numpy()
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), f
    for f in ("top_root", "n_prims", "top_depth", "wide_depth", "sup_depth"):
        assert getattr(ttl, f) == getattr(jtl, f), f
    assert np.array_equal(ttl.n_wide, jtl.n_wide)
    assert ttl.table.shape[0] >= 2


def _hits_match(a_t, a_pid, b_t, b_pid, tie_budget=0.002):
    """tests/test_wide_treelet.py:40-56."""
    ah, bh = np.isfinite(a_t), np.isfinite(b_t)
    assert np.array_equal(ah, bh), f"hit masks differ: {(ah != bh).sum()}"
    assert np.allclose(a_t[ah], b_t[bh], rtol=1e-6, atol=1e-6)
    mism = int((a_pid != b_pid).sum())
    assert mism <= max(1, int(tie_budget * len(a_t))), f"{mism} mismatches"


@pytest.mark.parametrize("any_hit, robust", [(False, False), (True, False),
                                             (False, True)])
def test_render_matches_reference(scene, any_hit, robust):
    jhit = jwt.wide_treelet_intersect_tris(
        scene["jtl"], scene["jrays"], prim_ids=scene["jbvh"].prim_ids,
        any_hit=any_hit, robust=robust, block=256, top_block=512,
        interpret=True)
    thit = twt.wide_treelet_intersect_tris(
        scene["ttl"], scene["trays"], prim_ids=scene["tbvh"].prim_ids,
        any_hit=any_hit, robust=robust)
    jt = np.asarray(jhit.t)
    tt = thit.t.numpy()
    assert np.isfinite(tt).sum() > 50
    if any_hit:
        assert np.array_equal(np.isfinite(jt), np.isfinite(tt))
    else:
        _hits_match(tt, thit.prim_id.numpy(), jt,
                    np.asarray(jhit.prim_id).astype(np.int64))
        assert np.array_equal(thit.stats.visited_nodes.numpy(),
                              np.asarray(jhit.stats.visited_nodes))


def test_capacities_auto_raise(scene):
    """Caps below the need overflow exactly; auto_caps re-runs with the
    named cap raised and returns the same hits, otherwise it raises."""
    kw = dict(prim_ids=scene["tbvh"].prim_ids)
    base = twt.wide_treelet_intersect_tris(scene["ttl"], scene["trays"], **kw)
    small = dict(max_portals=1, stack_depth=1, top_stack=1, max_rounds=1)
    hit, diag = twt.wide_treelet_intersect_tris(
        scene["ttl"], scene["trays"], return_diag=True, **small, **kw)
    assert torch.equal(hit.t, base.t) and torch.equal(hit.prim_id,
                                                      base.prim_id)
    for cap, value in small.items():
        assert diag["caps"][cap] > value, cap
    with pytest.raises(ValueError, match="capacity overflow"):
        twt.wide_treelet_intersect_tris(scene["ttl"], scene["trays"],
                                        auto_caps=False, max_portals=1, **kw)


def test_two_level_scene_raises(scene):
    tl = scene["ttl"]._replace(sup_table=torch.zeros((1, 16, 128)))
    with pytest.raises(NotImplementedError, match="B4"):
        twt.wide_treelet_intersect_tris(tl, scene["trays"])


def test_wide_treelets_from_numpy(scene):
    tl = twt.wide_treelets_from_numpy(scene["jtl"], "cpu")
    for f in ("top_node_t", "table", "sup_table"):
        assert torch.equal(getattr(tl, f), getattr(scene["ttl"], f)), f
    assert tl._replace(top_node_t=None, table=None, sup_table=None,
                       n_wide=None) == scene["ttl"]._replace(
        top_node_t=None, table=None, sup_table=None, n_wide=None)
