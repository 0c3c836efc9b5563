"""Scenes and ray sets: sizes, repeatability by seed, the camera
arithmetic against the port's own, and the diffuse bounce's
distribution."""

import hashlib

import numpy as np
import pytest
import torch

from raybench import rays, scenes
from raybench.tests.conftest import tiny, tiny_cell


def test_grid_sizes_match_io_scenes():
    from bvh_tpu_torch.io import scenes as port_scenes

    for n in (3000, 262_144):
        ref = port_scenes.sponza_class(n, 0)
        ours = scenes.sponza_class(n, 0, "cpu")
        assert ours.shape == ref.shape == (n, 3, 3)
        side = scenes.grid_side(n)
        # the boxes' triangles come first: 12 a box, on the 2-unit grid
        struct = ours[: side * side * 12]
        assert torch.equal(struct[0::12, 0, 0] % scenes.PITCH,
                           torch.zeros(side * side))
    assert scenes.grid_side(262_144) == 104
    assert scenes.grid_side(10_000_000) == 645


def test_scene_repeats_by_seed_and_variant():
    a = scenes.sponza_class(3000, 2**31 + 5, "cpu")
    b = scenes.sponza_class(3000, 2**31 + 5, "cpu")
    c = scenes.sponza_class(3000, 2**31 + 5, "cpu", variant=1)
    d = scenes.sponza_class(3000, 7, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert a.dtype == torch.float32


def test_ray_sets_same_work_every_seed():
    tris = scenes.sponza_class(3000, 0, "cpu")
    for spec in (tiny("boxgrid_262k.interior")[3]["rays"],
                 tiny("boxgrid_262k.shadow")[3]["rays"],
                 tiny_cell("boxgrid_262k", "diffuse")[3]["rays"]):
        a = rays.ray_sets(spec, tris, 11)
        b = rays.ray_sets(spec, tris, 11)
        c = rays.ray_sets(spec, tris, 2**31 + 12)
        assert all(torch.equal(x, y) for s, t in zip(a, b)
                   for x, y in zip(s, t))

        def key(s):
            return float(s[1].double().sum())

        assert sorted(map(key, a)) == sorted(map(key, c))
        assert [key(s) for s in a] != [key(s) for s in c]


def test_pinhole_matches_cli_camera():
    from bvh_tpu_torch.cli.camera import primary_rays

    eye = torch.tensor([3.6, 2.5, 7.1], dtype=torch.float64)
    d = torch.tensor([0.3, -0.1, 0.9], dtype=torch.float64)
    org, dirs, tmin, tmax = rays.pinhole(eye, d, 40, 24)
    ref = primary_rays(eye.numpy(), d.numpy(), [0, 1, 0], 40, 24,
                       device="cpu")
    assert torch.equal(dirs, ref.dir) and torch.equal(org, ref.org)
    assert torch.equal(tmin, ref.tmin) and torch.equal(tmax, ref.tmax)


def test_interior_poses_stand_in_corridors():
    spec = dict(tiny("boxgrid_262k.interior")[3]["rays"], poses=16)
    eye, d = rays.interior_poses(spec, 262_144, "cpu")
    x = eye[:, [0, 2]] % scenes.PITCH
    assert bool(((x > scenes.BOX_WIDTH[1]) & (x < scenes.PITCH)).all())
    assert bool(((eye[:, 1] >= 1) & (eye[:, 1] <= 6)).all())
    pitch = torch.rad2deg(torch.asin(d[:, 1]))
    assert bool((pitch.abs() <= 15).all())
    np.testing.assert_allclose(d.norm(dim=1).numpy(), 1.0, rtol=1e-12)


def test_shadow_rays_start_on_triangles():
    tris = scenes.sponza_class(3000, 0, "cpu")
    spec = tiny("boxgrid_262k.shadow")[3]["rays"]
    org, dirs, tmin, tmax = rays.ray_sets(spec, tris, 3)[0]
    assert bool((tmin == spec["tmin"]).all()) and bool((tmax == 1).all())
    light = org + dirs                    # tmax 1 reaches the light
    lo, hi = spec["light_height"]
    assert bool(((light[:, 1] >= lo - 1e-3) & (light[:, 1] <= hi + 1e-3))
                .all())
    assert len(torch.unique(light.round(decimals=2), dim=0)) <= spec["lights"]


def digest(ray_set) -> str:
    h = hashlib.sha256()
    for x in ray_set:
        h.update(x.contiguous().numpy().tobytes())
    return h.hexdigest()


# sha256 of the first set (org, dir, tmin, tmax) of seed 11 over
# sponza_class(3000, 0, "cpu") at `tiny`'s sizes, as the generators gave
# them before the diffuse generator was added to rays.py (torch 2.13 on
# the CPU): the existing traffic must not move
PINNED = {
    "boxgrid_262k.interior":
        "339afffa41cf5e0d9d7a138a5b2d977187db8f8b46c51d87856659a6692b2d49",
    "boxgrid_262k.shadow":
        "40fcaad75e92a0946f3e1263001f38e8557c3c303c51c87b84b92130efd18df7",
}


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_existing_ray_sets_unchanged(workload):
    tris = scenes.sponza_class(3000, 0, "cpu")
    spec = tiny(workload)[3]["rays"]
    assert digest(rays.ray_sets(spec, tris, 11)[0]) == PINNED[workload]


def detail_scaled(tris, factor):
    """The scene with each detail triangle scaled about its first corner,
    so that the detail's share of the area is far from nought."""
    boxes = 12 * scenes.grid_side(tris.shape[0]) ** 2
    out = tris.clone()
    d = out[boxes:]
    out[boxes:] = d[:, :1] + factor * (d - d[:, :1])
    return out


def diffuse_draw(tris, count, spec):
    """The first set `diffuse_sets` draws, with its triangle ids and
    side normals."""
    g = scenes.generator(spec["ray_seed"], rays.DIFFUSE_STREAM, tris.device)
    cdf, normals = rays.area_cdf(tris)
    return rays.diffuse_draw(tris, cdf, normals, count, g)


def test_box_triangles_face_into_their_box():
    tris = scenes.sponza_class(3000, 0, "cpu").double()
    boxes = 12 * scenes.grid_side(3000) ** 2
    box = tris[:boxes].reshape(-1, 12 * 3, 3)
    centre = (box.amin(1) + box.amax(1)) / 2               # [k, 3]
    _, n = rays.area_cdf(tris[:boxes])
    inward = (n.reshape(-1, 12, 3)
              * (centre[:, None] - tris[:boxes].mean(1).reshape(-1, 12, 3))
              ).sum(-1)
    assert bool((inward > 0).all())


def test_diffuse_rays_leave_their_triangle():
    tris = scenes.sponza_class(3000, 0, "cpu")
    spec = tiny_cell("boxgrid_262k", "diffuse")[3]["rays"]
    R = spec["count"]
    org, d, tri, nrm = diffuse_draw(tris, R, spec)
    sets = rays.ray_sets(spec, tris, 5)
    first = [s for s in sets if torch.equal(s[0], org.float())]
    assert len(first) == 1
    org32, d32, tmin, tmax = first[0]
    assert torch.equal(d32, d.float())
    assert bool((tmin == spec["tmin"]).all())
    assert bool((tmax == torch.finfo(torch.float32).max).all())
    # the float64 point lies in its triangle; the float32 origin is its
    # rounding, within a few float32 roundings of the triangle's plane
    p = tris[tri].double()
    v0, v1, w = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], org - p[:, 0]
    d00, d01, d11 = (v0 * v0).sum(1), (v0 * v1).sum(1), (v1 * v1).sum(1)
    d20, d21 = (w * v0).sum(1), (w * v1).sum(1)
    den = d00 * d11 - d01 * d01
    b1 = (d11 * d20 - d01 * d21) / den
    b2 = (d00 * d21 - d01 * d20) / den
    assert bool(((b1 >= -1e-9) & (b2 >= -1e-9) & (b1 + b2 <= 1 + 1e-9))
                .all())
    n = torch.linalg.cross(v0, v1)
    n = n / n.norm(dim=1, keepdim=True)
    off = ((org32.double() - p[:, 0]) * n).sum(1).abs()
    ulp = 2.0 ** -23 * org32.double().abs().amax(1)
    assert bool((off <= 2 * ulp + 1e-12).all())
    # unit directions on the side the ray leaves: out of a box, either
    # side of a detail sliver
    np.testing.assert_allclose(d32.double().norm(dim=1).numpy(), 1.0,
                               atol=1e-6)
    assert bool(((d * nrm).sum(1) > 0).all())
    boxes = tri < 12 * scenes.grid_side(3000) ** 2
    assert torch.allclose(nrm[boxes], -n[boxes], rtol=0, atol=1e-12)
    side = (nrm[~boxes] * n[~boxes]).sum(1)
    assert bool((side.abs() > 1 - 1e-12).all())


def test_diffuse_cosine_law_and_area_weights():
    """Over 2^20 rays: the cosine to the side's normal averages 2/3, as
    the cosine law gives; each triangle is drawn as often as its share
    of the area, here the boxes' against the detail's; a detail ray
    takes either side as often."""
    tris = detail_scaled(scenes.sponza_class(3000, 0, "cpu"), 20.0)
    spec = tiny_cell("boxgrid_262k", "diffuse")[3]["rays"]
    org, d, tri, nrm = diffuse_draw(tris, 1 << 20, spec)
    cos = (d * nrm).sum(1)
    assert float(cos.mean()) == pytest.approx(2 / 3, abs=0.01)
    cdf, n = rays.area_cdf(tris)
    boxes = 12 * scenes.grid_side(3000) ** 2
    area_share = float(cdf[boxes - 1] / cdf[-1])
    assert 0.2 < area_share < 0.8
    assert float((tri < boxes).double().mean()) == pytest.approx(
        area_share, abs=0.01)
    detail = tri >= boxes
    front = (nrm[detail] * n[tri[detail]]).sum(1) > 0
    assert float(front.double().mean()) == pytest.approx(0.5, abs=0.01)


def test_diffuse_tmin_clears_the_own_triangle_at_the_far_corner():
    """Moved to the 10M grid's far corner (float32 spacing 1.2e-4), no
    ray of 2^16 hits the triangle it leaves past the traffic's tmin in
    the port's float32 test; past one float32 spacing some do."""
    from bvh_tpu_torch.core.ray import Ray
    from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri

    tris = scenes.sponza_class(3000, 0, "cpu")
    far = scenes.PITCH * (scenes.grid_side(10_000_000)
                          - 2 * scenes.grid_side(3000))
    tris = tris + torch.tensor([far, 0.0, far])
    spec = tiny_cell("boxgrid_262k", "diffuse")[3]["rays"]
    org, d, tri, _ = diffuse_draw(tris, 1 << 16, spec)
    assert float(org.abs().amax()) > 1024     # float32 spacing 1.2e-4
    p = tris[tri]
    own = PrecomputedTri.from_tri(Tri(p[:, 0], p[:, 1], p[:, 2]))

    def own_hits(tmin):
        lo = torch.full((tri.shape[0],), tmin)
        hi = torch.full_like(lo, torch.finfo(torch.float32).max)
        return int(own.intersect(Ray(org.float(), d.float(), lo, hi))[3]
                   .sum())

    assert own_hits(spec["tmin"]) == 0
    assert own_hits(2.0 ** -13) > 0
