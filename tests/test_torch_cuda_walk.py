"""The portal walk kernel (`wide_treelet.walk_portals`, csrc/wide_treelet.cu)
on the card, against the render driver's pair rounds over kernel B1, on
the benchmark's box-grid scenes (the `card_scenes` fixture of
tests/test_torch_rerun.py) and its ray sets:

- at k = 1, bit for bit equal to `_pair_rounds(..., k=1)` over B1 in
  t, u, v, pos, the columns past B1's stack and the stack high-water
  mark, on a 262K interior set, a 262K shadow set (any-hit), a 10M
  interior set after phase A2, the first diffuse set at the 4,096 cut
  and a robust interior set; at the scene's k, equal to the rounds at
  that k in the hits, and closest hit also in the pairs and the
  high-water mark (any-hit: in those the rounds' at k = 1);
- at a forced small stack the same columns are flagged, and the entry
  point's re-run gives the hits of one attempt at the raised cap;
- the entry point's hits equal `render_at_caps` at the default k,
  closest hit and any-hit.

They skip without a card. The repository's conftest imports jax, which
the card's machine does not have, so they run there without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_walk.py
"""

import pytest
import torch

from bvh_tpu_torch import kernels
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.traverse import wide_treelet as wt
from raybench import rays
from test_torch_rerun import assert_same, card_scenes, one_attempt  # noqa: F401

pytestmark = pytest.mark.cuda

# (configuration, traffic, robust)
SETS = {"262k_interior": ("boxgrid_262k", "interior", False),
        "262k_shadow": ("boxgrid_262k", "shadow", False),
        "10m_interior": ("boxgrid_10m", "interior", False),
        "10m_cut4096_diffuse": ("boxgrid_10m_cut4096", "diffuse", False),
        "262k_interior_robust": ("boxgrid_262k", "interior", True)}


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def first_set(card_scenes, name, traffic):  # noqa: F811
    from raybench import harness
    _, tris, bvh, tl = card_scenes(name)
    spec = harness.load_json(f"{harness.HERE}/traffic/{traffic}.json")
    return tl, bvh, Ray(*rays.ray_sets(spec["rays"], tris, 0)[0]), bool(
        spec["any_hit"])


def lists(tl, ray, caps, robust):
    """`_prepare`'s lists of every ray at `caps`, which must fit."""
    portals, rays_c, late, diag = wt._prepare(
        tl, wt.pack_rays(ray), robust=robust, top_stack=caps["top_stack"],
        max_portals=caps["max_portals"], mps=caps["mps"],
        max_new=caps["max_new"], sup_stack=caps["sup_stack"],
        collect=wt.collect_portals, collect_super=wt.collect_super_pairs,
        stage=wt.run_stage)
    assert late is None and diag["overflow"] is None
    return portals, rays_c


def both(tl, portals, rays_c, any_hit, robust, stack_depth, k=1):
    """((best, late, diag) of the walk at k, the same of the rounds at k
    over B1)."""
    out = []
    for walk in (True, False):
        diag = dict(rounds=0, pairs=0, stack_hwm=0, stack_ovf=False,
                    pending=False)
        kw = dict(any_hit=any_hit, robust=robust, stack_depth=stack_depth)
        if walk:
            before = kernels.WALK.launches
            best, late = wt.walk_portals(tl, portals, rays_c, None, diag,
                                         k=k, **kw)
            assert kernels.WALK.launches == before + 1
        else:
            best, late = wt._pair_rounds(
                tl, portals, rays_c, None, diag, max_rounds=1 << 20, k=k,
                traverse=wt.traverse_pairs, stage=wt.run_stage, **kw)
        out.append((best, late, diag))
    return out


@pytest.mark.parametrize("case", sorted(SETS))
def test_walk_equals_rounds_at_one_over_b1(card_scenes, case):  # noqa: F811
    name, traffic, robust = SETS[case]
    tl, bvh, ray, any_hit = first_set(card_scenes, name, traffic)
    caps = wt.wide_treelet_intersect_tris(tl, ray, any_hit=any_hit,
                                          robust=robust,
                                          return_diag=True)[1]["caps"]
    portals, rays_c = lists(tl, ray, caps, robust)
    (got, glate, gd), (want, wlate, wd) = both(
        tl, portals, rays_c, any_hit, robust, caps["stack_depth"])
    for name_, a, b in zip(("t", "u", "v", "pos"), got, want):
        assert torch.equal(_bits(a), _bits(b)), name_
    assert glate is None and wlate is None
    assert gd["stack_hwm"] == wd["stack_hwm"] > 0
    assert gd["pairs"] == wd["pairs"] and gd["rounds"] == 1
    assert int(torch.isfinite(got[0]).sum()) > 0
    # at the scene's k, the entry point's
    k = wt.portals_per_round(tl)
    (got_k, _, gdk), (want_k, _, wdk) = both(tl, portals, rays_c, any_hit,
                                             robust, caps["stack_depth"], k)
    for name_, a, b in zip(("t", "u", "v", "pos"), got_k, want_k):
        assert torch.equal(_bits(a), _bits(b)), name_
    like = wd if any_hit else wdk
    assert (gdk["pairs"], gdk["stack_hwm"]) == (like["pairs"],
                                                like["stack_hwm"])


@pytest.mark.parametrize("any_hit", [False, True])
def test_small_stack_flags_the_same_columns(card_scenes, any_hit):  # noqa: F811
    tl, bvh, ray, _ = first_set(card_scenes, "boxgrid_262k", "interior")
    caps = wt.wide_treelet_intersect_tris(tl, ray, return_diag=True)[1]
    portals, rays_c = lists(tl, ray, caps["caps"], False)
    (got, glate, gd), (want, wlate, wd) = both(tl, portals, rays_c, any_hit,
                                               False, 2)
    assert gd["stack_ovf"] and wd["stack_ovf"]
    assert gd["stack_hwm"] == wd["stack_hwm"] == 2
    assert torch.equal(glate, wlate) and bool(glate.any())
    for name_, a, b in zip(("t", "u", "v", "pos"), got, want):
        assert torch.equal(_bits(a), _bits(b)), name_
    # the entry point re-runs the flagged rays at a raised stack and
    # gives the hits of one attempt at the cap it ends at
    hit, diag = wt.wide_treelet_intersect_tris(
        tl, ray, prim_ids=bvh.prim_ids, any_hit=any_hit, stack_depth=2,
        return_diag=True)
    assert diag["attempts"] >= 2 and diag["rerun_rays"] > 0
    final = diag["caps"]["stack_depth"]
    once, d1 = wt.wide_treelet_intersect_tris(
        tl, ray, prim_ids=bvh.prim_ids, any_hit=any_hit, stack_depth=final,
        return_diag=True)
    assert d1["attempts"] == 1
    for f in ("t", "u", "v", "prim_pos"):
        assert torch.equal(_bits(getattr(hit, f)), _bits(getattr(once, f))), f
    assert_same(hit, one_attempt(tl, ray, dict(diag["caps"], stack_depth=256),
                                 any_hit))


@pytest.mark.parametrize("traffic", ["interior", "shadow"])
def test_entry_point_equals_render_at_caps(card_scenes, traffic):  # noqa: F811
    tl, bvh, ray, any_hit = first_set(card_scenes, "boxgrid_262k", traffic)
    before = (kernels.WALK.launches, kernels.WIDE_TREELET.launches)
    hit, diag = wt.wide_treelet_intersect_tris(
        tl, ray, prim_ids=bvh.prim_ids, any_hit=any_hit, return_diag=True)
    # one walk a round loop (a re-run past phase A joins the first's)
    assert 1 <= diag["rounds"] <= diag["attempts"]
    assert kernels.WALK.launches == before[0] + diag["rounds"]
    assert kernels.WIDE_TREELET.launches == before[1]
    assert_same(hit, one_attempt(tl, ray, diag["caps"], any_hit))
