"""Phase A2 in one launch, the super walk (`wide_treelet.walk_supers`,
csrc/super_walk.cu), on the card, against the rounds it replaces there
(`expand_supers` over kernels B4 and the portal merge) and against its
plain version (`walk_supers_plain`, on the same CUDA tensors):

- bit for bit in the lists, their lengths, the overflow bits, `over`'s
  "cols", "max_sup", "max_rec" and "max_len" and the diag's a2_pairs
  and sup_ovf, at caps that overflow nothing, mps, max_new, max_portals
  and B4's stack, with phase-A-late columns, and at max_new 64 and 512,
  where a warp walks 16 and 2 supers at a time and a ray's rounds are
  merged in several parts; on the small two-level scene of
  tests/test_torch_portal_sort.py (its camera's rays and rays from
  inside the grid) and on the benchmark's 10M box grid at both cuts
  (the `card_scenes` fixture of tests/test_torch_rerun.py: the first
  interior set, many rounds a ray, and the first diffuse set);
- the entry point's hits equal `render_at_caps`' (the rounds) on the
  two-level scenes, with one super walk an attempt and no launch of B4
  or of the portal merge.

They skip without a card. The repository's conftest imports jax, which
the card's machine does not have, so they run there without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_expand.py
"""

import pytest
import torch

from bvh_tpu_torch import kernels
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.traverse import wide_treelet as wt
from raybench import rays
from test_torch_rerun import assert_same, card_scenes, one_attempt  # noqa: F401

pytestmark = pytest.mark.cuda


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.fixture(scope="module")
def small():
    """sponza_class(3000, 3), a MEDIUM tree, cut at max_prims 128 under
    supers of 512, on the card: (tl, {"camera": 32x32 primary rays,
    "inside": 1,024 rays from inside the grid}, prim_ids)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bvh_tpu_torch.build.default import (
        DefaultConfig,
        Quality,
        build_default,
    )
    from bvh_tpu_torch.cli.camera import primary_rays
    from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
    from bvh_tpu_torch.io.scenes import scene_camera, sponza_class
    from test_torch_expand import inside_rays

    tris = sponza_class(3000, seed=3)
    tt = torch.from_numpy(tris)
    bvh = build_default(tt.min(1).values, tt.max(1).values, tt.mean(1),
                        DefaultConfig(quality=Quality.MEDIUM))
    flat = PrecomputedTri.from_tri(Tri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
    eye, d, up = scene_camera(tris)
    tl = wt.build_wide_treelets(bvh, flat, max_prims=128, super_prims=512,
                                device="cuda")
    assert tl.sup_cols.shape[0] > 1
    inside = Ray(*(x.cuda() for x in inside_rays(tt)))
    return tl, {"camera": primary_rays(eye, d, up, 32, 32, device="cuda"),
                "inside": inside}, bvh.prim_ids.cuda()


def scene_rays(small, card_scenes, scene):  # noqa: F811
    """(tl, Ray, prim_ids, any_hit) of a scene name of SCENES."""
    if scene.startswith("small"):
        tl, sets, prim_ids = small
        return tl, sets[scene.split("_")[1]], prim_ids, False
    from raybench import harness
    name, traffic = SCENES[scene]
    _, tris, bvh, tl = card_scenes(name)
    spec = harness.load_json(f"{harness.HERE}/traffic/{traffic}.json")
    return (tl, Ray(*rays.ray_sets(spec["rays"], tris, 0)[0]), bvh.prim_ids,
            bool(spec["any_hit"]))


SCENES = {"small_camera": None, "small_inside": None,
          "10m_interior": ("boxgrid_10m", "interior"),
          "10m_cut4096_diffuse": ("boxgrid_10m_cut4096", "diffuse")}
# caps changed from the render's, and whether every third column is late
CAPS = {"render": ({}, False), "mps": (dict(mps=1), False),
        "max_new": (dict(max_new=1), False),
        "max_portals": (dict(max_portals=8), False),
        "stack": (dict(sup_stack=2), False), "late": ({}, True),
        "max_new_64": (dict(max_new=64), False),
        "max_new_512": (dict(max_new=512), True)}


def expanded(fn, tl, packed, caps, late, robust=False):
    """fn's A2 at `caps` on fresh lists: (tid, tent, tlen, bits, diag,
    over)."""
    portals = wt.collect_and_sort(tl, packed, robust=robust,
                                  top_stack=tl.top_depth + 1,
                                  max_portals=caps["max_portals"],
                                  mps=caps["mps"])
    gone = None
    if late:
        gone = torch.zeros(portals.sel.numel(), dtype=torch.bool,
                           device=packed.device)
        gone[::3] = True
    over = dict(cols=gone)
    tid, tent, bits, diag = fn(
        tl, portals, packed[:, portals.sel], robust=robust,
        sup_stack=caps["sup_stack"], mps=caps["mps"],
        max_new=caps["max_new"], max_portals=caps["max_portals"], over=over)
    torch.cuda.synchronize()
    return tid, tent, portals.sup.tlen, bits, diag, over


def assert_same_a2(got, want):
    tid, tent, tlen, bits, diag, over = got
    w_tid, w_tent, w_tlen, w_bits, w_diag, w_over = want
    assert torch.equal(tid, w_tid)
    assert torch.equal(_bits(tent), _bits(w_tent))
    assert torch.equal(tlen, w_tlen)
    assert bits == w_bits
    assert (diag["a2_pairs"], diag["sup_ovf"]) == \
        (w_diag["a2_pairs"], w_diag["sup_ovf"])
    for key in ("max_sup", "max_rec", "max_len"):
        assert over[key] == w_over[key], key
    if w_over["cols"] is None:
        assert over["cols"] is None
    else:
        assert torch.equal(over["cols"], w_over["cols"])


@pytest.mark.parametrize("caps", sorted(CAPS))
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_super_walk_kernel_equals_the_rounds(small, card_scenes, scene,  # noqa: F811
                                             caps):
    tl, ray, _, _ = scene_rays(small, card_scenes, scene)
    change, late = CAPS[caps]
    c = dict(wt.wide_treelet_caps(tl, wt.portals_per_round(tl)),
             sup_stack=tl.sup_depth + 1)
    c.update(change)
    packed = wt.pack_rays(ray)
    want = expanded(wt.expand_supers, tl, packed, c, late)
    before = {k.name: k.launches for k in (
        kernels.SUPER_WALK, kernels.COLLECT_SUPER, kernels.PORTAL_MERGE)}
    got = expanded(wt.walk_supers, tl, packed, c, late)
    after = {k.name: k.launches - before[k.name] for k in (
        kernels.SUPER_WALK, kernels.COLLECT_SUPER, kernels.PORTAL_MERGE)}
    assert after == {kernels.SUPER_WALK.name: 1,
                     kernels.COLLECT_SUPER.name: 0,
                     kernels.PORTAL_MERGE.name: 0}
    assert_same_a2(got, want)
    assert_same_a2(expanded(wt.walk_supers_plain, tl, packed, c, late), want)
    assert got[4]["a2_rounds"] == 1 and want[4]["a2_pairs"] > 0
    if caps == "render" and scene.startswith("10m"):
        assert want[4]["a2_rounds"] >= 4   # rays of several rounds
    if caps in ("mps", "max_new", "max_portals"):
        assert want[3] & {"mps": 1, "max_new": 2, "max_portals": 4}[caps]


@pytest.mark.parametrize("scene", ["small_camera", "10m_interior"])
def test_super_walk_kernel_robust(small, card_scenes, scene):  # noqa: F811
    tl, ray, _, _ = scene_rays(small, card_scenes, scene)
    c = dict(wt.wide_treelet_caps(tl, wt.portals_per_round(tl)),
             sup_stack=tl.sup_depth + 1)
    packed = wt.pack_rays(ray)
    assert_same_a2(expanded(wt.walk_supers, tl, packed, c, False, True),
                   expanded(wt.expand_supers, tl, packed, c, False, True))


@pytest.mark.parametrize("scene", ["small_camera", "10m_interior",
                                   "10m_cut4096_diffuse"])
def test_entry_point_equals_render_at_caps(small, card_scenes, scene):  # noqa: F811
    """The entry point's hits (the super walk and the portal walk) equal
    one `render_at_caps` (the rounds) at the caps it ended at; it
    launched the super walk once an attempt, and neither B4 nor the
    portal merge."""
    tl, ray, prim_ids, any_hit = scene_rays(small, card_scenes, scene)
    kinds = (kernels.SUPER_WALK, kernels.COLLECT_SUPER, kernels.PORTAL_MERGE)
    before = [k.launches for k in kinds]
    hit, diag = wt.wide_treelet_intersect_tris(
        tl, ray, prim_ids=prim_ids, any_hit=any_hit, return_diag=True)
    launched = [k.launches - b for k, b in zip(kinds, before)]
    assert launched == [diag["attempts"], 0, 0]
    assert diag["a2_rounds"] == diag["attempts"] and diag["a2_pairs"] > 0
    assert_same(hit, one_attempt(tl, ray, diag["caps"], any_hit))
    assert int(torch.isfinite(hit.t).sum()) > 0
