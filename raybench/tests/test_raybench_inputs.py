"""Scenes and ray sets: sizes, repeatability by seed, and the camera
arithmetic against the port's own."""

import numpy as np
import torch

from raybench import rays, scenes
from raybench.tests.conftest import tiny


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
    for workload in ("boxgrid_262k.interior", "boxgrid_262k.shadow"):
        spec = tiny(workload)[3]["rays"]
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
