"""The port's CUDA kernels against their plain PyTorch versions, on a
CUDA device: the render kernels (B1 on the column tables, B2), the
binary traversal (B5) and the sphere traversal at dims 2, 3 and 4 (B6)
in every mode (closest/any-hit x fast/robust), B6's work counter at
ray counts around a warp and past what the card holds at once, with
inverted rays mixed in, and its SIMT counts, phase A2 (B4) and the
two-level render, the group build (B3) on groups that reach each of its
branches on its warp path and its CTA path, and the profiling tools' kernels (T6 column fetch, T5 wide
step probe, T1 B1's ablation variants). They skip where there is no device. The repository's conftest imports jax, which
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
from bvh_tpu_torch.build import group_kernel as gk
from bvh_tpu_torch.api.native import NativeBvh3f
from bvh_tpu_torch.cli.camera import primary_rays
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
from bvh_tpu_torch.io.scenes import scene_camera, sponza_class
from bvh_tpu_torch.io.serialize import deserialize_from_bytes
from bvh_tpu_torch.traverse import binary_kernel as bk
from bvh_tpu_torch.traverse import collect as col
from bvh_tpu_torch.traverse import wide_treelet as wt
from bvh_tpu_torch.traverse.stack import required_stack_depth

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def tree():
    """A 20K-triangle quality-high tree (native build, on the CPU), its
    triangles and 128x128 primary rays on the card."""
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
    eye, d, up = scene_camera(tris)
    rays = primary_rays(eye, d, up, 128, 128, device="cuda")
    # zero direction components (+0 x on every 8th ray, -0 z on every
    # 16th) exercise the fast form's clamped inverse and the robust
    # form's inf/NaN slab arithmetic
    rays.dir[::8, 0] = 0.0
    rays.dir[::16, 2] = -0.0
    return bvh, flat, rays


@pytest.fixture(scope="module")
def scene(tree):
    bvh, flat, rays = tree
    tl = wt.build_wide_treelets(bvh, flat, max_prims=256, device="cuda")
    return tl, rays, bvh.prim_ids.cuda()


@pytest.fixture(scope="module")
def two_level(tree):
    """The same tree cut into treelets of <= 128 prims with a super level
    of <= 2,048-prim supers."""
    bvh, flat, rays = tree
    tl = wt.build_wide_treelets(bvh, flat, max_prims=128, super_prims=2048,
                                device="cuda")
    assert tl.sup_table.shape[0] > 1
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
    gf, gi = wt.traverse_pairs(tl.table_cols, tid, prays, **kw)
    assert kernels.WIDE_TREELET.launches == before + 1
    pf, pi = wt.traverse_pairs_ref(tl.table, tid, prays, **kw)
    assert torch.equal(_bits(gf), _bits(pf))
    assert torch.equal(gi, pi)
    assert int(torch.isfinite(gf[0]).sum()) > 100


def _round_pairs(tl, rays):
    portals = wt.collect_and_sort(tl, wt.pack_rays(rays), robust=False,
                                  top_stack=tl.top_depth + 1, max_portals=64)
    kk, rr = torch.nonzero(portals.tid >= 0, as_tuple=True)
    tid = portals.tid[kk, rr].to(torch.int32)
    return tid, wt.pack_rays(rays)[:, portals.sel[rr]].contiguous()


@pytest.mark.parametrize("stack_depth", [1, 2])
def test_traverse_kernel_stack_overflow(scene, stack_depth):
    """A stack of 1 or 2 entries overflows: kernel and plain version drop
    the same bottom entries, and give the same sticky flags and
    high-water marks, which never pass the stack."""
    tl, rays, _ = scene
    tid, prays = _round_pairs(tl, rays)
    kw = dict(any_hit=False, robust=False, stack_depth=stack_depth)
    gf, gi = wt.traverse_pairs(tl.table_cols, tid, prays, **kw)
    pf, pi = wt.traverse_pairs_ref(tl.table, tid, prays, **kw)
    assert torch.equal(_bits(gf), _bits(pf)) and torch.equal(gi, pi)
    assert gi[3].any() and not gi[3][gi[2] < stack_depth].any()
    assert int(gi[2].max()) == stack_depth


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("robust", [False, True])
def test_render_kernels_equal_plain_render(scene, any_hit, robust):
    tl, rays, prim_ids = scene
    kw = dict(any_hit=any_hit, robust=robust)
    got = wt.wide_treelet_intersect_tris(tl, rays, prim_ids, **kw)
    want = wt._intersect(tl, rays, prim_ids, col.collect_portals_ref,
                         wt.traverse_pairs_plain, **kw)
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
                          wt.traverse_pairs_plain, any_hit=True)
        assert np.array_equal(torch.isfinite(a.t).cpu().numpy(),
                              torch.isfinite(b.t).cpu().numpy())


def group_build_case(sizes, P, seed=0, coincident=(), points=(), flat=()):
    """A packed [16, G*P] group block and its sizes, made with numpy:
    random boxes (centres in [0, 100), half-extents in [0.01, 2)), with
    group g's centres all equal if g is in `coincident`, its boxes equal
    points if in `points`, and its boxes flat on z at z = 5 if in `flat`.
    Centres are the boxes' midpoints, as the build computes them."""
    rng = np.random.default_rng(seed)
    pf = np.zeros((16, len(sizes) * P), np.float32)
    for g, n in enumerate(sizes):
        c = rng.uniform(0, 100, (n, 3))
        h = rng.uniform(0.01, 2.0, (n, 3))
        if g in coincident:
            c[:] = c[0]
        if g in points:
            c[:] = c[0]
            h[:] = 0.0
        if g in flat:
            c[:, 2] = 5.0
            h[:, 2] = 0.0
        mn = (c - h).astype(np.float32)
        mx = (c + h).astype(np.float32)
        cc = ((mn + mx) * 0.5).astype(np.float32)
        cols = slice(g * P, g * P + n)
        pf[0:3, cols] = cc.T
        pf[3:6, cols] = mn.T
        pf[6:9, cols] = mx.T
    return pf, np.asarray(sizes, np.int32)


# every branch of the kernel: empty groups, a group of 1 prim and a
# min_leaf-sized root (no node to split), a pair, a node just above
# max_leaf, coincident centres (SAH finds no split: median fallback, all
# ties), point boxes (flat bscale on every axis: every lane in bin 0),
# boxes flat on one axis, and full groups. Roots of at most 128 lanes
# start on the warp path; larger nodes take the CTA path, and with
# min_leaf 128 every node that is split does.
# (P, sizes, case keywords, build keywords)
GROUP_CASES = {
    "p128_branches": (128, [1, 2, 9, 40, 128, 100, 77, 128],
                      dict(coincident=(5,), points=(6,), flat=(7,)), {}),
    "p128_min_leaf2": (128, [2, 3, 1, 128], dict(coincident=(3,)),
                       dict(min_leaf=2, max_leaf=4)),
    "p1024_full": (1024, [1024, 600, 1000], dict(flat=(1,)), {}),
    "p128_sizes_0_1_2": (128, [0, 1, 2, 0, 2, 1], {}, {}),
    "p128_warp_fallback": (128, [128, 97, 128, 64, 33],
                           dict(coincident=(0, 3), points=(1,), flat=(2, 4)),
                           {}),
    "p1024_fallback_both_paths": (1024, [1024, 1000, 700, 129],
                                  dict(coincident=(0, 3), points=(1,),
                                       flat=(2,)), {}),
    "p1024_cta_only": (1024, [1024, 900, 513], dict(flat=(2,)),
                       dict(min_leaf=128, max_leaf=256)),
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_group_build_kernel_equals_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    P, sizes, kw, build_kw = GROUP_CASES[case]
    pf, sz = group_build_case(sizes, P, seed=len(sizes), **kw)
    pf_d = torch.from_numpy(pf).cuda()
    sz_d = torch.from_numpy(sz).cuda()
    before = kernels.GROUP_BUILD.launches
    got = gk.group_forest_build(pf_d, sz_d, dim=3, P=P, **build_kw)
    assert kernels.GROUP_BUILD.launches == before + 1
    want = gk.group_forest_build_ref(pf_d, sz_d, dim=3, P=P, NCAP=2 * P,
                                     **build_kw)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    assert got[3].tolist() == want[3].tolist()
    assert int(got[3].max()) > 1 or max(sizes) <= 2


def test_group_build_at_max_p():
    """P at the largest multiple of 128 within `group_build_max_p()`, one
    full group and one of P - 3 prims: equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    P = kernels.group_build_max_p() // 128 * 128
    pf, sz = group_build_case([P, P - 3], P, seed=7, flat=(1,))
    pf_d, sz_d = torch.from_numpy(pf).cuda(), torch.from_numpy(sz).cuda()
    got = gk.group_forest_build(pf_d, sz_d, dim=3, P=P)
    want = gk.group_forest_build_ref(pf_d, sz_d, dim=3, P=P)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


def test_group_build_main_path_staging_one_wave():
    """The 262K build's staging (sponza_class(262144, 0), as chip_smoke.py
    stages it): B3 equal to its plain version on every group, and the
    card holds all G groups at once (CTAs per SM x SMs >= G)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bvh_tpu_torch.build import minitree_fast as mtf

    tris = sponza_class(262_144, seed=0)
    mn, mx, cc = (torch.from_numpy(a).cuda() for a in (
        tris.min(axis=1), tris.max(axis=1), tris.mean(axis=1)))
    plan = mtf.staging_plan(cc)
    pf, _ = mtf.pack_groups(mn, mx, cc, plan)
    cfg = plan.config
    kw = dict(dim=3, P=plan.P, NCAP=plan.NCAP, min_leaf=cfg.min_leaf_size,
              max_leaf=cfg.max_leaf_size,
              log_cluster=cfg.sah.log_cluster_size,
              cost_ratio=cfg.sah.cost_ratio)
    got = gk.group_forest_build(pf, plan.counts, **kw)
    want = gk.group_forest_build_ref(pf, plan.counts, **kw)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert kernels.group_build_occupancy(plan.P) * sms >= plan.G


def test_group_build_raises_beyond_shared_memory():
    """A P whose 44 bytes per lane exceed a block's shared memory is
    refused with the numbers, never handed to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    P = (kernels.group_build_max_p() // 128 + 1) * 128
    pf = torch.zeros((16, P), device="cuda")
    sz = torch.ones(1, dtype=torch.int32, device="cuda")
    before = kernels.GROUP_BUILD.launches
    with pytest.raises(ValueError, match=f"P={P}"):
        gk.group_forest_build(pf, sz, dim=3, P=P)
    assert kernels.GROUP_BUILD.launches == before


def _b5_tables(bvh, flat):
    return bk.make_tables(bvh._replace(bounds=bvh.bounds.cuda(),
                                       index=bvh.index.cuda(),
                                       prim_ids=bvh.prim_ids.cuda()),
                          flat.cuda())


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("robust", [False, True])
def test_binary_kernel_equals_plain(tree, any_hit, robust):
    """B5 with the stack sized exactly (the tree's height + 1)."""
    bvh, flat, rays = tree
    tables = _b5_tables(bvh, flat)
    packed = wt.pack_rays(rays)
    kw = dict(any_hit=any_hit, robust=robust,
              stack_depth=required_stack_depth(bvh))
    before = kernels.BINARY_TRAVERSE.launches
    gf, gi = bk.binary_traverse(tables, packed, **kw)
    assert kernels.BINARY_TRAVERSE.launches == before + 1
    pf, pi = bk.binary_traverse_ref(tables, packed, **kw)
    assert torch.equal(_bits(gf), _bits(pf))
    assert torch.equal(gi, pi)
    assert int(torch.isfinite(gf[0]).sum()) > 100 and not gi[3].any()


def test_binary_kernel_stack_overflow_flag(tree):
    """A stack shorter than the tree's height overflows on some rays:
    kernel and plain version drop the same bottom entries and flag the
    same rays, and the wrapper raises."""
    bvh, flat, rays = tree
    tables = _b5_tables(bvh, flat)
    kw = dict(any_hit=False, robust=False, stack_depth=4)
    gf, gi = bk.binary_traverse(tables, wt.pack_rays(rays), **kw)
    pf, pi = bk.binary_traverse_ref(tables, wt.pack_rays(rays), **kw)
    assert torch.equal(_bits(gf), _bits(pf)) and torch.equal(gi, pi)
    assert gi[3].any()
    with pytest.raises(ValueError, match="overflow"):
        bk.pallas_intersect_tris(bvh._replace(
            bounds=bvh.bounds.cuda(), index=bvh.index.cuda(),
            prim_ids=bvh.prim_ids.cuda()), flat.cuda(), rays, stack_depth=4)


@pytest.mark.parametrize("any_hit", [False, True])
def test_binary_kernel_leaf_root(any_hit):
    """A one-leaf tree: the root word is a leaf of 3 triangles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bvh_tpu_torch.core.types import Bvh

    tris = torch.tensor([[[-1, -1, 2], [1, -1, 2], [0, 1, 2]],
                         [[-1, -1, 3], [1, -1, 3], [0, 1, 3]],
                         [[5, 5, 5], [6, 5, 5], [5, 6, 5]]],
                        dtype=torch.float32)
    flat = PrecomputedTri.from_tri(Tri(tris[:, 0], tris[:, 1],
                                       tris[:, 2])).as_flat()
    bvh = Bvh(bounds=torch.tensor([[-1, 6, -1, 6, 2, 5]],
                                  dtype=torch.float32),
              index=torch.tensor([3]), prim_ids=torch.tensor([2, 0, 1]),
              node_count=1, prim_count=3)
    tables = _b5_tables(bvh, flat)
    assert tables.root_word == 3
    rays = primary_rays([0, 0, 0], [0, 0, 1], [0, 1, 0], 32, 32,
                        device="cuda")
    kw = dict(any_hit=any_hit, robust=False, stack_depth=1)
    gf, gi = bk.binary_traverse(tables, wt.pack_rays(rays), **kw)
    pf, pi = bk.binary_traverse_ref(tables, wt.pack_rays(rays), **kw)
    assert torch.equal(_bits(gf), _bits(pf)) and torch.equal(gi, pi)
    hit = torch.isfinite(gf[0])
    assert 0 < int(hit.sum()) < rays.tmin.numel()
    assert bool((gi[2] == 1).all()) and bool((gi[1] == 0).all())
    if not any_hit:  # the nearer plane, z = 2
        assert torch.allclose(gf[0][hit] * rays.dir[hit, 2],
                              torch.tensor(2.0, device="cuda"))


@pytest.mark.parametrize("robust", [False, True])
def test_collect_super_kernel_equals_plain(two_level, robust):
    """B4 on every (ray, super) pair of phase A, with max_new below the
    need so the exact count runs past the cap."""
    tl, rays, _ = two_level
    T = tl.table.shape[0]
    portals = wt.collect_and_sort(tl, wt.pack_rays(rays), robust=robust,
                                  top_stack=tl.top_depth + 1, max_portals=64)
    kk, rr = torch.nonzero(portals.tid >= T, as_tuple=True)
    sid = (portals.tid[kk, rr] - T).to(torch.int32)
    prays = wt.pack_rays(rays)[:, portals.sel[rr]].contiguous()
    kw = dict(robust=robust, stack_depth=tl.sup_depth + 1, max_new=4)
    before = kernels.COLLECT_SUPER.launches
    got = col.collect_super_pairs(tl.sup_table, sid, prays, **kw)
    assert kernels.COLLECT_SUPER.launches == before + 1
    want = col.collect_super_pairs_ref(tl.sup_table, sid, prays, **kw)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    assert sid.numel() > 100 and bool((got[2][0] > 4).any())
    assert not got[2][2].any()


@pytest.mark.parametrize("any_hit, robust", [(False, False), (True, False),
                                             (False, True)])
def test_two_level_render_equals_plain_render(two_level, any_hit, robust):
    tl, rays, prim_ids = two_level
    kw = dict(any_hit=any_hit, robust=robust)
    before = kernels.COLLECT_SUPER.launches
    got, diag = wt.wide_treelet_intersect_tris(tl, rays, prim_ids,
                                               return_diag=True, **kw)
    assert kernels.COLLECT_SUPER.launches > before and diag["a2_rounds"] > 0
    want = wt._intersect(tl, rays, prim_ids, col.collect_portals_ref,
                         wt.traverse_pairs_plain,
                         collect_super=col.collect_super_pairs_ref, **kw)
    for f in ("t", "u", "v", "prim_pos", "prim_id"):
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f
    assert 0 < int(torch.isfinite(got.t).sum()) < rays.tmin.numel()


@pytest.fixture(scope="module", params=[2, 3, 4], ids=lambda d: f"dim{d}")
def spheres(request):
    """4,096 spheres of dim 2, 3 or 4 (a tree past bvh_tpu's 2,048-prim
    limit), `build_binned` on the card, and 8,192 rays, some with zero
    direction components."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bvh_tpu_torch.build.binned import build_binned

    dim = request.param
    rng = np.random.default_rng(dim)
    c = torch.from_numpy(rng.uniform(-1, 1, (4096, dim)).astype(np.float32))
    r = torch.from_numpy(rng.uniform(0.01, 0.05, 4096).astype(np.float32))
    c, r = c.cuda(), r.cuda()
    bvh = build_binned(c - r[:, None], c + r[:, None], c)
    org = torch.from_numpy(rng.uniform(-3, 3, (8192, dim)).astype(np.float32))
    tgt = torch.from_numpy(rng.uniform(-1, 1, (8192, dim)).astype(np.float32))
    d = tgt - org
    d[::8, 0] = 0.0
    d[::16, dim - 1] = -0.0
    rays = Ray.make(org.cuda(), d.cuda())
    assert bvh.prim_ids.shape[0] > 2048
    return bvh, c, r, rays


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("robust", [False, True])
def test_sphere_kernel_equals_plain(spheres, any_hit, robust):
    """B6 against its plain version, bit for bit in every output."""
    from bvh_tpu_torch.traverse import sphere_kernel as sk

    bvh, c, r, rays = spheres
    tables = sk.make_tables(bvh, c, r)
    packed = wt.pack_rays(rays)
    kw = dict(any_hit=any_hit, robust=robust,
              stack_depth=required_stack_depth(bvh))
    before = kernels.SPHERE_TRAVERSE.launches
    gf, gi = sk.sphere_traverse(tables, packed, **kw)
    assert kernels.SPHERE_TRAVERSE.launches == before + 1
    pf, pi = sk.sphere_traverse_ref(tables, packed, **kw)
    assert torch.equal(_bits(gf), _bits(pf))
    assert torch.equal(gi, pi)
    assert int(torch.isfinite(gf[0]).sum()) > 100 and not gi[3].any()
    hit = sk.pallas_intersect_spheres(bvh, c, r, rays, any_hit=any_hit,
                                      robust=robust)
    assert int(hit.hit.sum()) == int(torch.isfinite(gf[0]).sum())


def test_sphere_kernel_stack_one_short(spheres):
    """With the stack one entry shorter than the rays need, kernel and
    plain version drop the same bottom entries and flag the same rays,
    and the wrapper raises."""
    from bvh_tpu_torch.traverse import sphere_kernel as sk

    bvh, c, r, rays = spheres
    tables = sk.make_tables(bvh, c, r)
    packed = wt.pack_rays(rays)
    need = required_stack_depth(bvh)
    while need > 1 and not sk.sphere_traverse(
            tables, packed, any_hit=False, robust=False,
            stack_depth=need - 1)[1][3].any():
        need -= 1
    kw = dict(any_hit=False, robust=False, stack_depth=need - 1)
    gf, gi = sk.sphere_traverse(tables, packed, **kw)
    pf, pi = sk.sphere_traverse_ref(tables, packed, **kw)
    assert torch.equal(_bits(gf), _bits(pf)) and torch.equal(gi, pi)
    assert gi[3].any()
    with pytest.raises(ValueError, match="overflow"):
        sk.pallas_intersect_spheres(bvh, c, r, rays, stack_depth=need - 1)


def _ragged_rays(rays, R, inverted_every=0):
    """R rays from `rays`, repeated as needed; every `inverted_every`th
    with tmin > tmax (a ray that starts inactive)."""
    reps = -(-R // rays.tmin.numel())
    org = rays.org.repeat(reps, 1)[:R]
    d = rays.dir.repeat(reps, 1)[:R]
    tmin = rays.tmin.repeat(reps)[:R].clone()
    tmax = rays.tmax.repeat(reps)[:R].clone()
    if inverted_every:
        tmin[::inverted_every] = 2.0
        tmax[::inverted_every] = 1.0
    return Ray(org.contiguous(), d.contiguous(), tmin, tmax)


# ray counts for the refill: one lane, part of a warp, a warp and one,
# and more than an H100 holds at once (132 SMs x 2,048 threads =
# 270,336), not a multiple of a warp or of any grid of 128-thread CTAs
REFILL_R = [1, 31, 33, 270_336 + 77]


@pytest.mark.parametrize("R", REFILL_R)
@pytest.mark.parametrize("any_hit", [False, True])
def test_sphere_kernel_refill(spheres, R, any_hit):
    """B6's warps take rays from the work counter (in 2D and 3D again as
    their lanes go idle) and write each result at its ray's index: every
    output bit-equal to the plain version, with every 7th ray inverted
    (tmin > tmax, a miss with no steps) and, for any hit, rays that stop
    at their first hit."""
    from bvh_tpu_torch.traverse import sphere_kernel as sk

    bvh, c, r, rays = spheres
    tables = sk.make_tables(bvh, c, r)
    packed = wt.pack_rays(_ragged_rays(rays, R, inverted_every=7))
    kw = dict(any_hit=any_hit, robust=False,
              stack_depth=required_stack_depth(bvh))
    gf, gi = sk.sphere_traverse(tables, packed, **kw)
    pf, pi = sk.sphere_traverse_ref(tables, packed, **kw)
    assert torch.equal(_bits(gf), _bits(pf)) and torch.equal(gi, pi)
    assert not gi[1, ::7].any() and bool(torch.isinf(gf[0, ::7]).all())
    if R > 1000:
        assert int(torch.isfinite(gf[0]).sum()) > 100


def test_sphere_kernel_simt_counts(spheres):
    """The kernel's SIMT counts: its lanes' steps cover the rays' inner
    steps and leaves (a leaf is at least one test), and no more than 32
    a warp step; the outputs are those of the launch without counts."""
    from bvh_tpu_torch.traverse import sphere_kernel as sk

    bvh, c, r, rays = spheres
    tables = sk.make_tables(bvh, c, r)
    packed = wt.pack_rays(rays)
    kw = dict(any_hit=False, robust=False,
              stack_depth=required_stack_depth(bvh))
    steps = torch.zeros(2, dtype=torch.int64, device="cuda")
    gf, gi = sk.sphere_traverse(tables, packed, steps=steps, **kw)
    pf, pi = sk.sphere_traverse(tables, packed, **kw)
    assert torch.equal(_bits(gf), _bits(pf)) and torch.equal(gi, pi)
    lane, warp = (int(x) for x in steps)
    assert int(gi[1].sum() + gi[2].sum()) <= lane <= 32 * warp
    with pytest.raises(ValueError, match="closest"):
        sk.sphere_traverse(tables, packed, steps=steps,
                           **dict(kw, any_hit=True))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_column_fetch_kernel_equals_plain(dtype):
    """T6 at the tool's shapes (ROWS 156/216, P 1,280, B 512), 200 fetches,
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bvh_tpu_torch.tools import probe_int8_fetch as tf

    tab_bf, tab_i8, idx = tf.make_inputs(device="cuda")
    table = tab_bf if dtype == "bf16" else tab_i8
    cols = tf.column_copy(table)
    before = kernels.COLUMN_FETCH.launches
    got = tf.column_fetch(cols, idx, tf.ITERS, table.shape[0])
    assert kernels.COLUMN_FETCH.launches == before + 1
    want = tf.column_fetch_ref(table, idx, tf.ITERS)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("rows, iters", [(13, 1), (21, 150), (3, 7),
                                         (40, 64)])
def test_column_fetch_kernel_edges(dtype, rows, iters):
    """T6 where rows are not a multiple of the run (8 bf16, 16 int8), an
    idx at P - 1 (the first fetch wraps), idx past P and below 0 (taken
    mod P), 1 fetch, and more fetches than columns (P = 64): bit for bit
    with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bvh_tpu_torch.tools import probe_int8_fetch as tf

    tab_bf, tab_i8, idx = tf.make_inputs(rows, rows, 64, 37, seed=rows,
                                         device="cuda")
    table = tab_bf if dtype == "bf16" else tab_i8
    idx[:4] = torch.tensor([63, 0, 64 + 5, -3], dtype=torch.int32)
    got = tf.column_fetch(tf.column_copy(table), idx, iters, rows)
    want = tf.column_fetch_ref(table, idx, iters)
    assert got.shape == (rows, 37)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("B, C, sort8, chains", [(2048, 128, True, 1),
                                                 (1024, 512, False, 4)])
@pytest.mark.parametrize("inputs", ["tool", "hitting"])
def test_wide_step_probe_kernel_equals_plain(B, C, sort8, chains, inputs):
    """T5 at 64 iterations, bit for bit, on the tool's inputs and on
    inputs where about half the slab tests hit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bvh_tpu_torch.tools import probe_tpu as tp

    table, rays = (tp.tool_inputs(B, C, np.random.default_rng(0))
                   if inputs == "tool" else tp.hitting_inputs(B, C))
    before = kernels.WIDE_STEP_PROBE.launches
    res = tp.check_config(table.cuda(), rays.cuda(), sort8, chains, iters=64)
    assert kernels.WIDE_STEP_PROBE.launches == before + 1
    assert not res["out"][chains:].any()
    if inputs == "hitting":
        assert 0.2 <= res["hit_share"] <= 0.8


@pytest.mark.parametrize("depth", [4, 40])
def test_ablation_variants_on_chain_table(depth):
    """T1: on the chain table every variant equals the full kernel, and
    the full kernel its plain version, with `depth` steps on every lane;
    on the render's pairs each variant equals the plain version with the
    same code left out."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bvh_tpu_torch.tools import ablate_kernel as ak

    table = ak.chain_cols(depth, 128, "cuda")
    tid, rays = ak.chain_pairs(1024, "cuda")
    before = kernels.WIDE_TREELET_ABLATE.launches
    ak.check_chain(table, tid, rays, depth)
    assert kernels.WIDE_TREELET_ABLATE.launches == before + len(ak.VARIANTS)


@pytest.mark.parametrize("variant", [1, 2, 4])
def test_ablation_variant_equals_ablated_plain(scene, variant):
    """Off the chain table a variant computes something else than B1; the
    plain version with the same code left out follows it bit for bit."""
    from bvh_tpu_torch.tools import ablate_kernel as ak

    tl, rays, _ = scene
    tid, prays = _round_pairs(tl, rays)
    sd = 7 * tl.wide_depth + 8
    got = ak.traverse_pairs_ablate(tl.table_cols, tid, prays, variant=variant,
                                   stack_depth=sd)
    want = wt.traverse_pairs_ref(tl.table, tid, prays, any_hit=False,
                                 robust=False, stack_depth=sd,
                                 ablate=variant)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1])
