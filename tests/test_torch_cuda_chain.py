"""The one-program render on a CUDA device: `_render_fixed` through
kernels B2 and B1 with no host sync, B1's valid-pair count against its
plain version, and the render chain captured as one CUDA graph against
the eager entry point, element by element. They skip where there is no
device, and run without the repository's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_chain.py
"""

import pytest
import torch

from bvh_tpu_torch import kernels
from bvh_tpu_torch.api.native import NativeBvh3f
from bvh_tpu_torch.cli.camera import primary_rays
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
from bvh_tpu_torch.io.scenes import scene_camera, sponza_class
from bvh_tpu_torch.io.serialize import deserialize_from_bytes
from bvh_tpu_torch.traverse import wide_treelet as wt

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def scene():
    """A 20K-triangle quality-high tree cut at 256 prims, 128x128
    primary rays (some with zero direction components) and shadow rays
    toward a point light, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tris = sponza_class(20_000, seed=1)
    native = NativeBvh3f()
    h = native.build(tris.min(axis=1), tris.max(axis=1), tris.mean(axis=1),
                     quality=2, threads=4)
    bvh = deserialize_from_bytes(native.to_bytes(h), device="cpu")
    native.destroy(h)
    tt = torch.from_numpy(tris)
    flat = PrecomputedTri.from_tri(Tri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
    tl = wt.build_wide_treelets(bvh, flat, max_prims=256, device="cuda")
    eye, d, up = scene_camera(tris)
    rays = primary_rays(eye, d, up, 128, 128, device="cuda")
    rays.dir[::8, 0] = 0.0
    rays.dir[::16, 2] = -0.0
    hit = wt.wide_treelet_intersect_tris(tl, rays)
    light = torch.tensor([0.0, 50.0, 0.0], device="cuda")
    hitp = rays.org + rays.dir * torch.where(torch.isfinite(hit.t), hit.t,
                                             0.0)[:, None]
    srays = Ray.make(hitp, light - hitp, tmin=1e-4,
                     tmax=torch.ones_like(hit.t))
    return tl, {False: rays, True: srays}


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("any_hit", [False, True])
def test_fixed_render_makes_no_sync(scene, any_hit):
    """`_render_fixed` under sync debug "error" (any host sync raises),
    equal to the eager render at the same caps bit for bit."""
    tl, rays = scene
    rays = rays[any_hit]
    _, diag = wt.wide_treelet_intersect_tris(tl, rays, any_hit=any_hit,
                                             return_diag=True)
    caps = diag["caps"]
    packed = wt.pack_rays(rays)
    kw = dict(any_hit=any_hit, robust=False, k=4, sel_cap=packed.shape[1],
              tail_cap=1024, rounds=diag["rounds"] + diag["pairs"] // 1024)
    wt._render_fixed(tl, packed, caps, **kw)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = wt._render_fixed(tl, packed, caps, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.COLLECT.launches == 1
    assert kernels.WIDE_TREELET.launches == kw["rounds"]
    want = wt.render_at_caps(tl, packed, caps, any_hit=any_hit, robust=False,
                             k=4)
    assert _same(out[:5], want[:5])
    stats = dict(zip(wt.FIXED_STATS, out[-1].tolist()))
    assert not (stats["pending"] or stats["stack_ovf"])
    assert stats["rounds_used"] >= diag["rounds"]


@pytest.mark.parametrize("count", [0, 1, 777, None])
def test_traverse_count_equals_plain(scene, count):
    """B1 told a valid-pair count on the device traverses exactly the
    first `count` pairs, bit for bit as its plain version does."""
    tl, rays = scene
    rays = rays[False]
    portals = wt.collect_and_sort(tl, wt.pack_rays(rays), robust=False,
                                  top_stack=tl.top_depth + 1, max_portals=64)
    kk, rr = torch.nonzero(portals.tid >= 0, as_tuple=True)
    tid = portals.tid[kk, rr].to(torch.int32)
    prays = wt.pack_rays(rays)[:, portals.sel[rr]].contiguous()
    n = tid.shape[0] if count is None else count
    c = torch.tensor([n], dtype=torch.int32, device="cuda")
    kw = dict(any_hit=False, robust=False, stack_depth=7 * tl.wide_depth + 8)
    gf, gi = wt.traverse_pairs(tl.table_cols, tid, prays, count=c, **kw)
    pf, pi = wt.traverse_pairs_plain(tl.table_cols, tid, prays, count=c, **kw)
    assert _same((gf[:, :n], gi[:, :n]), (pf[:, :n], pi[:, :n]))
    assert n < 2 or torch.isfinite(gf[0, :n]).any()


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("any_hit", [False, True])
def test_chain_equals_entry_point(scene, k, any_hit):
    """The captured chain's t row equals the eager entry point's element
    by element; B2 and B1 launch during its capture, once and `rounds`
    times, and the graph holds their kernel nodes."""
    tl, rays = scene
    rays = rays[any_hit]
    want = wt.wide_treelet_intersect_tris(tl, rays, any_hit=any_hit)
    chain = wt.wide_treelet_render_chain(tl, rays, k, any_hit=any_hit)
    got = chain()
    R = rays.tmin.shape[0]
    assert got.shape == (chain.packed.shape[1],)
    assert torch.equal(_bits(got[:R]), _bits(want.t))
    assert torch.isinf(got[R:]).all()
    assert chain.capture_launches == {kernels.COLLECT.name: 1,
                                      kernels.WIDE_TREELET.name: chain.rounds}
    assert chain.graph_nodes["kernel"] > chain.rounds
    assert torch.equal(_bits(chain()[:R]), _bits(want.t))


@pytest.mark.parametrize("cap", ["rounds", "sel_cap"])
def test_chain_flags_raise(scene, cap):
    """Without auto_caps, too few rounds or a sel_cap below the rays with
    portals raise; with it the chain raises the cap and is exact."""
    tl, rays = scene
    rays = rays[False]
    want = wt.wide_treelet_intersect_tris(tl, rays)
    full = wt.wide_treelet_render_chain(tl, rays, 1)
    full()
    short = (dict(rounds=full.rounds - 1) if cap == "rounds"
             else dict(sel_cap=full.stats["nready"] // 2, block=128))
    short.update(full.caps)  # the verified caps: only `cap` overflows
    with pytest.raises(ValueError, match="render chain overflowed"):
        wt.wide_treelet_render_chain(tl, rays, 2, auto_caps=False, **short)
    chain = wt.wide_treelet_render_chain(tl, rays, 2, **short)
    assert getattr(chain, cap) > short[cap] and chain.caps == full.caps
    assert torch.equal(_bits(chain()[:rays.tmin.shape[0]]), _bits(want.t))
