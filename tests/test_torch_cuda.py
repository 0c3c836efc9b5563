"""The port's CUDA kernels against their plain PyTorch versions, on a
CUDA device: the render kernels (B1 on the column tables, B2), the
binary traversal (B5) and the sphere traversal at dims 2, 3 and 4 (B6)
in every mode (closest/any-hit x fast/robust), their work counter at
ray counts around a warp and past what the card holds at once, with
inverted rays mixed in, their stacks overflowing and their SIMT
counts, phase A2 (B4, on the super rows `sup_cols`: no pairs, one pair,
a single-pair super, every super of a ray, stacks of 1 and 2, a
`max_new` of 1) and the two-level render, the group build (B3) on groups that reach each of its
branches on its warp path and its CTA path (both variants, "bfs" with its
queue row), and the profiling tools' kernels (T6 column fetch, T5 wide
step probe, T1 B1's ablation variants), the portal ordering (sort,
two-level split and A2 merge, on the records of box-grid scenes at the
benchmark's sizes and on crafted ones, and the renders with it against
the plain ordering), and the sharded mini-tree build on two gloo ranks that share the card. They skip where there is no device. The repository's conftest imports jax, which
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
    assert tl.sup_cols.shape[0] > 1
    return tl, rays, bvh.prim_ids.cuda()


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


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


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_group_build_bfs_equals_plain(case):
    """variant="bfs": one B3 launch, and all four outputs, the BFS queue
    row 3 included, equal to the plain BFS version (the plain build on
    the CPU, its queue row written there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    P, sizes, kw, build_kw = GROUP_CASES[case]
    pf, sz = group_build_case(sizes, P, seed=len(sizes), **kw)
    before = kernels.GROUP_BUILD.launches
    got = gk.group_forest_build(torch.from_numpy(pf).cuda(),
                                torch.from_numpy(sz).cuda(), dim=3, P=P,
                                variant="bfs", **build_kw)
    assert kernels.GROUP_BUILD.launches == before + 1
    want = gk.group_forest_build(torch.from_numpy(pf), torch.from_numpy(sz),
                                 dim=3, P=P, variant="bfs", **build_kw)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g).cpu(), _bits(w))
    assert int((got[1][3] != 0).sum()) > 0 or max(sizes) <= 2


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


@pytest.mark.parametrize("R", REFILL_R)
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("robust", [False, True])
def test_binary_kernel_refill(tree, R, any_hit, robust):
    """B5's warps take rays from the work counter, again as their lanes
    go idle, and write each result at its ray's index: every output
    bit-equal to the plain version, with every 7th ray inverted (past
    1,000 rays, the plain version runs on every 13th ray)."""
    bvh, flat, rays = tree
    tables = _b5_tables(bvh, flat)
    packed = wt.pack_rays(_ragged_rays(rays, R, inverted_every=7))
    kw = dict(any_hit=any_hit, robust=robust,
              stack_depth=required_stack_depth(bvh))
    gf, gi = bk.binary_traverse(tables, packed, **kw)
    sub = slice(None, None, 13 if R > 1000 else 1)
    pf, pi = bk.binary_traverse_ref(tables, packed[:, sub].contiguous(), **kw)
    assert torch.equal(_bits(gf[:, sub]), _bits(pf))
    assert torch.equal(gi[:, sub], pi)
    assert not gi[1, ::7].any() and bool(torch.isinf(gf[0, ::7]).all())
    if R > 1000:
        assert int(torch.isfinite(gf[0]).sum()) > 100


def test_walk_counter_ring(tree, monkeypatch):
    """B5's and B6's launches need no memset: each takes an unused slot
    of its stream's ring of zeroed work counters, and a used ring is
    zeroed again on that stream. Launches of every size, refilling (B5)
    or not (B6 in 4D), queued in turn past a ring of 3 on two streams,
    give the outputs of the same launch made alone."""
    from bvh_tpu_torch.build.binned import build_binned
    from bvh_tpu_torch.traverse import sphere_kernel as sk

    bvh, flat, rays = tree
    tables = _b5_tables(bvh, flat)
    kw = dict(any_hit=False, robust=False,
              stack_depth=required_stack_depth(bvh))
    # 4D spheres: B6's warps there take their rays once, without refill
    rng = np.random.default_rng(7)
    c = torch.from_numpy(rng.uniform(-1, 1, (500, 4)).astype(np.float32))
    r = torch.from_numpy(rng.uniform(0.1, 0.3, 500).astype(np.float32))
    c, r = c.cuda(), r.cuda()
    sbvh = build_binned(c - r[:, None], c + r[:, None], c)
    stables = sk.make_tables(sbvh, c, r)
    sray = wt.pack_rays(Ray.make(
        torch.zeros((300, 4), device="cuda"),
        torch.from_numpy(rng.normal(size=(300, 4)).astype(np.float32)).cuda()))
    skw = dict(any_hit=False, robust=False,
               stack_depth=max(16, required_stack_depth(sbvh)))
    packed = {R: wt.pack_rays(_ragged_rays(rays, R, inverted_every=7))
              for R in REFILL_R}
    alone = {R: bk.binary_traverse(tables, packed[R], **kw) for R in REFILL_R}
    sphere_alone = sk.sphere_traverse(stables, sray, **skw)
    torch.cuda.synchronize()
    monkeypatch.setattr(bk, "WALK_RING", 3)
    for stream in (torch.cuda.Stream(), torch.cuda.Stream()):
        got = []
        with torch.cuda.stream(stream):
            for R in REFILL_R[::-1] + REFILL_R:
                got.append((bk.binary_traverse(tables, packed[R], **kw),
                            alone[R]))
                got.append((sk.sphere_traverse(stables, sray, **skw),
                            sphere_alone))
        stream.synchronize()
        for g, w in got:
            assert all(torch.equal(_bits(a), _bits(b))
                       for a, b in zip(g, w, strict=True))


@pytest.mark.parametrize("stack_depth", [1, 2])
def test_binary_kernel_tiny_stack(tree, stack_depth):
    """Stacks of 1 and 2 entries: the same dropped entries and flags."""
    bvh, flat, rays = tree
    tables = _b5_tables(bvh, flat)
    kw = dict(any_hit=False, robust=False, stack_depth=stack_depth)
    gf, gi = bk.binary_traverse(tables, wt.pack_rays(rays), **kw)
    pf, pi = bk.binary_traverse_ref(tables, wt.pack_rays(rays), **kw)
    assert torch.equal(_bits(gf), _bits(pf)) and torch.equal(gi, pi)
    assert gi[3].any()


def test_binary_kernel_simt_counts(tree):
    """B5's SIMT counts: its lanes' steps cover the inner steps and
    leaves, and no more than 32 a warp step; the outputs are those of
    the launch without counts."""
    bvh, flat, rays = tree
    tables = _b5_tables(bvh, flat)
    packed = wt.pack_rays(rays)
    kw = dict(any_hit=False, robust=False,
              stack_depth=required_stack_depth(bvh))
    steps = torch.zeros(2, dtype=torch.int64, device="cuda")
    gf, gi = bk.binary_traverse(tables, packed, steps=steps, **kw)
    pf, pi = bk.binary_traverse(tables, packed, **kw)
    assert torch.equal(_bits(gf), _bits(pf)) and torch.equal(gi, pi)
    lane, warp = (int(x) for x in steps)
    assert int(gi[1].sum() + gi[2].sum()) <= lane <= 32 * warp
    assert kernels.binary_traverse_occupancy() >= 8
    with pytest.raises(ValueError, match="closest"):
        bk.binary_traverse(tables, packed, steps=steps,
                           **dict(kw, robust=True))


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
    got = col.collect_super_pairs(tl.sup_cols, sid, prays, **kw)
    assert kernels.COLLECT_SUPER.launches == before + 1
    want = col.collect_super_pairs_ref(tl.sup_table, sid, prays, **kw)
    _same_outputs(got, want)
    assert sid.numel() > 100 and bool((got[2][0] > 4).any())
    assert not got[2][2].any()


def _same_outputs(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and torch.equal(_bits(g), _bits(w))


def _every_super_pairs(tl, rays):
    """Every 8th ray from the 4th, of which every 7th inverted, paired
    with every super, sorted by super as `expand_supers` hands pairs
    over."""
    S = tl.sup_cols.shape[0]
    some = Ray(*(x[3::8].contiguous() for x in rays))
    packed = wt.pack_rays(_ragged_rays(some, some.tmin.numel(),
                                       inverted_every=7))
    sid = torch.arange(S, device="cuda").repeat_interleave(packed.shape[1])
    prays = packed.repeat(1, S).contiguous()
    return sid.to(torch.int32), prays


@pytest.mark.parametrize("case", ["no_pairs", "one_pair", "every_super",
                                  "max_new_1"])
@pytest.mark.parametrize("robust", [False, True])
def test_collect_super_kernel_cases(two_level, case, robust):
    """B4, a lane a pair, at work sizes of 0 and 1 pairs and of every
    super a ray, with rays that start inactive, and a `max_new` of 1
    whose counts run past the cap: every output bit-equal."""
    tl, rays, _ = two_level
    sid, prays = _every_super_pairs(tl, rays)
    kw = dict(robust=robust, stack_depth=tl.sup_depth + 1, max_new=8)
    if case == "no_pairs":
        sid, prays = sid[:0], prays[:, :0].contiguous()
    elif case == "one_pair":
        sid, prays = sid[5:6], prays[:, 5:6].contiguous()
    elif case == "max_new_1":
        kw["max_new"] = 1
    got = col.collect_super_pairs(tl.sup_cols, sid, prays, **kw)
    want = col.collect_super_pairs_ref(tl.sup_table, sid, prays, **kw)
    _same_outputs(got, want)
    if case == "every_super":
        assert not got[2][0][prays[6] > prays[7]].any()
        assert bool((got[2][0] > 0).any()) and not got[2][2].any()
    if case == "max_new_1":
        assert bool((got[2][0] > 1).any())


@pytest.mark.parametrize("stack_depth", [1, 2])
def test_collect_super_kernel_stack_overflow(two_level, stack_depth):
    """Stacks of 1 and 2 entries, where the pairs need more than 1: kernel
    and plain version drop the same bottom entries and give the same
    flags and high-water marks, which overflow where the full stack's
    mark passes theirs."""
    tl, rays, _ = two_level
    sid, prays = _every_super_pairs(tl, rays)
    kw = dict(robust=False, stack_depth=stack_depth, max_new=16)
    got = col.collect_super_pairs(tl.sup_cols, sid, prays, **kw)
    want = col.collect_super_pairs_ref(tl.sup_table, sid, prays, **kw)
    _same_outputs(got, want)
    need = col.collect_super_pairs(tl.sup_cols, sid, prays, **dict(
        kw, stack_depth=tl.sup_depth + 1))[2][1]
    assert int(need.max()) > 1 and int(got[2][1].max()) <= stack_depth
    assert torch.equal(got[2][2] != 0, need > stack_depth)


@pytest.mark.parametrize("robust", [False, True])
def test_collect_super_kernel_single_pair_super(robust):
    """A super of one pair row, both children portals (treelets 3 and
    7), among supers of zeros: rays through the left box, the right box,
    both and neither."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    S, Ps = 3, 128
    cols = torch.zeros((S, Ps, 16))
    cols[1, 0, :6] = torch.tensor([-1.0, 0.0, -1, 1, -1, 1])
    cols[1, 0, 6:12] = torch.tensor([0.0, 1.0, -1, 1, -1, 1])
    cols[1, 0, 12] = float(3 << 4 | 1)
    cols[1, 0, 13] = float(7 << 4 | 1)
    y = torch.linspace(-2, 2, 64)
    org = torch.stack([torch.full_like(y, -0.5), y, torch.zeros_like(y)], 1)
    org = torch.cat([org, torch.tensor([[-5.0, 0.0, 0.0]])])
    d = torch.zeros_like(org)
    d[:64, 2] = 1.0
    d[64, 0] = 1.0
    org[:64, 2] = -5.0
    packed = wt.pack_rays(Ray.make(org, d)).cuda()
    sid = torch.full((65,), 1, dtype=torch.int32, device="cuda")
    kw = dict(robust=robust, stack_depth=2, max_new=4)
    cols = cols.cuda()
    got = col.collect_super_pairs(cols, sid, packed, **kw)
    want = col.collect_super_pairs_ref(cols.transpose(1, 2), sid, packed,
                                       **kw)
    _same_outputs(got, want)
    assert set(got[0][0].tolist()) == {-1, 3}
    assert got[0][:2, 64].tolist() == [3, 7]


@pytest.mark.parametrize("any_hit, robust", [(False, False), (True, False),
                                             (False, True)])
def test_two_level_render_equals_plain_render(two_level, any_hit, robust):
    tl, rays, prim_ids = two_level
    kw = dict(any_hit=any_hit, robust=robust)
    before = kernels.SUPER_WALK.launches
    got, diag = wt.wide_treelet_intersect_tris(tl, rays, prim_ids,
                                               return_diag=True, **kw)
    assert kernels.SUPER_WALK.launches > before and diag["a2_rounds"] > 0
    want = wt._intersect(tl, rays, prim_ids, col.collect_portals_ref,
                         wt.traverse_pairs_plain,
                         collect_super=col.collect_super_pairs_plain, **kw)
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


@pytest.mark.parametrize("B, C, sort8, chains, stack_depth", [
    (2048, 128, True, 1, 24), (1024, 512, False, 4, 24),
    # B not a multiple of a block's 16 rays: the last group runs past B
    (1000, 128, True, 2, 24),
    # C = 512 (136 KB of staged table: dynamic shared memory), and C
    # not a power of two (the general floor modulo)
    (1000, 512, True, 1, 32), (333, 100, True, 4, 24),
    (2048, 128, True, 1, 1), (1000, 128, False, 2, 32)])
@pytest.mark.parametrize("inputs", ["tool", "hitting", "ties"])
def test_wide_step_probe_kernel_equals_plain(B, C, sort8, chains,
                                            stack_depth, inputs):
    """T5 at 64 iterations, bit for bit, on the tool's inputs, on inputs
    where about half the slab tests hit, and on inputs whose children
    share boxes (equal keys reach the sorting network); one launch
    counted each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bvh_tpu_torch.tools import probe_tpu as tp

    table, rays = (tp.tool_inputs(B, C, np.random.default_rng(0))
                   if inputs == "tool" else tp.hitting_inputs(B, C)
                   if inputs == "hitting" else tp.tie_inputs(B, C))
    before = kernels.WIDE_STEP_PROBE.launches
    res = tp.check_config(table.cuda(), rays.cuda(), sort8, chains, iters=64,
                          stack_depth=stack_depth)
    assert kernels.WIDE_STEP_PROBE.launches == before + 1
    assert not res["out"][chains:].any()
    if inputs != "tool":
        assert 0.2 <= res["hit_share"] <= 0.8


def test_wide_step_probe_launch_shape():
    """T5's launch: 128-thread blocks at the tool's widths, one block an
    SM at most as many as the rays need; larger blocks once the rays
    fill the card; the staged table and the stacks in the dynamic
    shared memory; a table too wide for a block refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bvh_tpu_torch.tools import probe_tpu as tp

    small = kernels.wide_step_probe_launch(128, 2048, True, 1, 24)
    assert small["block"] == 128 and small["grid"] == 2048 // 16
    assert small["smem"] == 128 * 272 + 16 * 24 * 4
    wide = kernels.wide_step_probe_launch(512, 262_144, True, 4, 32)
    assert wide["smem"] == 512 * 272 + wide["block"] // 8 * 4 * 32 * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert wide["grid"] == sms * wide["per_sm"]
    table, rays = tp.hitting_inputs(64, 4096)
    with pytest.raises(RuntimeError, match="wide_step_probe"):
        tp.wide_step_probe(table.cuda(), rays.cuda(), sort8=True, chains=1,
                           stack_depth=24, iters=4)


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


@pytest.mark.parametrize("variant", [0, 1, 2, 3, 4])
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


def test_sharded_build_two_gloo_ranks_on_one_card(tmp_path):
    """`build_minitree_sharded` on two gloo ranks that share cuda:0
    (NCCL refuses two ranks on one card; gloo takes device tensors),
    without and with pruning: every rank's tree equals the single
    build on the CPU bit for bit. The ranks' code is
    tests/torch_par_ranks.py, as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.multiprocessing as mp

    import torch_par_ranks as ranks
    from bvh_tpu_torch.build.minitree import MiniTreeConfig, build_minitree

    tris = sponza_class(20_000, seed=1)
    arrays = dict(mn=tris.min(axis=1), mx=tris.max(axis=1),
                  cc=tris.mean(axis=1))
    np.savez(tmp_path / "inputs.npz", **arrays)
    mp.spawn(ranks.run, args=(2, str(tmp_path), ["build"], False, "cuda:0"),
             nprocs=2, join=True)
    outs = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for name, kw in ranks.BUILD_CONFIGS.items():
        b = build_minitree(*(torch.from_numpy(arrays[k])
                             for k in ("mn", "mx", "cc")),
                           MiniTreeConfig(**kw))
        nc = b.node_count
        for out in outs:
            assert out[f"{name}_bounds"].tobytes() == \
                b.bounds[:nc].numpy().tobytes()
            assert np.array_equal(out[f"{name}_index"], b.index[:nc].numpy())
            assert np.array_equal(out[f"{name}_prim_ids"],
                                  b.prim_ids.numpy())
            assert int(out[f"{name}_prim_count"]) == b.prim_count


def _cpu(x):
    """Tensors, and the tuples, NamedTuples, lists and dicts holding
    them, moved to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_cpu(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_cpu(v) for v in x)
    return x


def _tool_case(name, device):
    """Tool `name`'s run at a small size on `device`, reduced to its
    non-timing results."""
    from bvh_tpu_torch.tools import (ablate_kernel2, bench_build, bench_dims,
                                     bench_sanmiguel, bench_wide,
                                     check_mtf_parity, check_super_quick,
                                     check_wide_quick, profile_build,
                                     profile_mtf, profile_reinsertion)
    from bvh_tpu_torch.tools.profile_r3 import bench_scene

    small = dict(n=3000, side=32)
    if name == "bench_build":
        res = bench_build.run(3000, device, reps=1)
        return tuple(r["tree"] for r in res.values())
    if name == "profile_mtf":
        return profile_mtf.run(3000, device, reps=1)["tree"]
    if name == "profile_reinsertion":
        return tuple(profile_reinsertion.run(3000, i, device, 1)["out"]
                     for i in profile_reinsertion.INPUTS)
    if name == "profile_build":
        res = profile_build.run(4096, device, reps=1)
        return tuple(b[2] for b in res["builds"].values())
    if name == "check_mtf_parity":
        res = check_mtf_parity.run(3000, device)
        return res["equal"], res["fast"]
    if name == "bench_wide":
        res = bench_wide.run(**small, max_prims=(128, 256), device=device,
                             reps=1)
        return tuple(r["fields"] for r in res.values())
    if name == "check_wide_quick":
        res = check_wide_quick.run(**small, device=device)
        return res["ok"], res["fields"], res["shadow_hits"]
    if name == "check_super_quick":
        res = check_super_quick.run(**small, device=device, reps=1,
                                    max_prims=128, super_prims=512)
        return res["ok"], res["two_level"]["fields"], res["flat"]["fields"]
    if name == "bench_sanmiguel":
        res = bench_sanmiguel.run(**small, max_prims=128, super_prims=512,
                                  reps=1, device=device)
        return res["ok"], res["render"]["fields"], res["max_new_overflow"]
    if name == "ablate_kernel2":
        tl, rays, _ = bench_scene(3000, 32, device)
        res = ablate_kernel2.run(tl, rays, device, reps=1)
        return tuple(v["out"] for v in res.values())
    res = bench_dims.run(m=64, rays=1024, f64_rays=1024, reps=1,
                         device=device)
    return tuple(res[d]["fields"] for d in bench_dims.DIMS), \
        res["f64"]["hits"]


@pytest.mark.parametrize("name", [
    "bench_build", "profile_mtf", "profile_reinsertion", "profile_build",
    "check_mtf_parity", "bench_wide", "check_wide_quick",
    "check_super_quick", "bench_sanmiguel", "ablate_kernel2", "bench_dims"])
def test_tool_on_card_equals_cpu(name):
    """Each tool of bvh_tpu_torch/tools/ that drives the build, the
    render or the dims: its run on the card, through the
    kernels, equals its run on the CPU, through the plain versions, in
    every result that is not a time (trees, hits, outputs, checks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bvh_tpu_torch.tools.timing import same

    assert same(_cpu(_tool_case(name, "cuda")), _tool_case(name, "cpu"))



# ------------------------------------------------------ the portal ordering
@pytest.fixture(scope="module")
def boxgrid():
    """Box-grid scenes at the benchmark's sizes, built on the card at
    first use and kept: n_tris -> (tris [n, 3, 3] on the card, tree,
    treelet scene). `sponza_class(n, seed=0)`, `build_default` at
    quality HIGH, then `build_wide_treelets` at max_prims 1024; the 10M
    scene takes the two-level cut."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bvh_tpu_torch.build.default import (
        DefaultConfig,
        Quality,
        build_default,
    )
    built = {}

    def get(n):
        if n not in built:
            tris = torch.from_numpy(sponza_class(n, seed=0)).cuda()
            tri = Tri(tris[:, 0], tris[:, 1], tris[:, 2])
            bb_min, bb_max = tri.get_bbox()
            bvh = build_default(bb_min, bb_max, tri.get_center(),
                                DefaultConfig(quality=Quality.HIGH))
            flat = PrecomputedTri.from_tri(tri).as_flat()
            built[n] = (tris, bvh, wt.build_wide_treelets(bvh, flat,
                                                          max_prims=1024))
        return built[n]
    return get


def _interior_rays(tris, side=1024):
    """1024 x 1024 pinhole rays (cli/camera.py) from inside the box grid:
    the eye 3 units up where the corridors cross beside the grid's middle
    column (columns every 2 units, at most 1.2 wide), looking along a yaw
    of 0.6 rad and 10 degrees down, past many treelets."""
    k = max(1, int(np.sqrt(tris.shape[0] // 2 // 12)))
    mid = 2.0 * (k // 2) + 1.6
    yaw, pitch = 0.6, -np.radians(10.0)
    d = np.array([np.cos(pitch) * np.cos(yaw), np.sin(pitch),
                  np.cos(pitch) * np.sin(yaw)])
    return primary_rays(np.array([mid, 3.0, mid]), d,
                        np.array([0.0, 1.0, 0.0]), side, side,
                        device="cuda")


def _shadow_rays(tris, count=1 << 20, lights=16, seed=0):
    """`count` shadow rays of a path tracer: origins uniform on uniformly
    drawn triangles, each toward one of `lights` point lights 10 to 14
    units above the grid, direction light - origin, tmin 1e-4, tmax 1."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    lo = tris.reshape(-1, 3).amin(0)
    hi = tris.reshape(-1, 3).amax(0)
    u = torch.rand((lights, 3), generator=g, device="cuda")
    light = lo + u * (hi - lo)
    light[:, 1] = 10.0 + 4.0 * u[:, 1]
    tri = torch.randint(tris.shape[0], (count,), generator=g, device="cuda")
    which = torch.randint(lights, (count,), generator=g, device="cuda")
    a, b = torch.rand((2, count, 1), generator=g, device="cuda")
    a = torch.sqrt(a)
    p = tris[tri]
    org = (1 - a) * p[:, 0] + a * (1 - b) * p[:, 1] + a * b * p[:, 2]
    return Ray(org.contiguous(), (light[which] - org).contiguous(),
               torch.full((count,), 1e-4, device="cuda"),
               torch.ones(count, device="cuda"))


RAYS = {"interior": _interior_rays, "shadow": _shadow_rays}


def _plain_ordering(monkeypatch):
    """Make the render driver order portals with the plain versions."""
    from bvh_tpu_torch.traverse import portal_sort as ps
    for name in ("sort_columns", "split_columns", "merge_columns"):
        monkeypatch.setattr(wt, name, getattr(ps, f"{name}_plain"))


def _same_ordering(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


# records like the benchmark's render cells': (triangles, rays, MP or None
# for the render's own cap)
BOXGRID_CASES = {"262k_interior": (262_144, "interior", None),
                 "262k_shadow": (262_144, "shadow", None),
                 "10m_interior_mp256": (10_000_000, "interior", 256),
                 "10m_interior_mp512": (10_000_000, "interior", 512)}


@pytest.mark.parametrize("case", sorted(BOXGRID_CASES))
def test_portal_sort_kernel_on_phase_a_records(boxgrid, case):
    """The ordering kernel on B2's real records of box-grid scenes at the
    benchmark's sizes, from inside the grid and for shadow rays, equals
    torch's stable sort of the padded columns on the card, bit for bit:
    the sort, and at 10M the two-level split."""
    from bvh_tpu_torch.traverse import portal_sort as ps
    n, kind, MP = BOXGRID_CASES[case]
    tris, _, tl = boxgrid(n)
    packed = wt.pack_rays(RAYS[kind](tris))
    caps = wt.wide_treelet_caps(tl, wt.portals_per_round(tl))
    MP = MP or caps["max_portals"]
    ptid, ptent, stats = col.collect_portals(
        tl.top_node_t, packed, tl.top_root, robust=False,
        stack_depth=tl.top_depth + 1, max_portals=MP)
    cnt = stats[0]
    sel = torch.nonzero(cnt > 0).squeeze(1)
    assert sel.numel() > packed.shape[1] // 4
    before = kernels.PORTAL_SORT.launches
    _same_ordering(ps.sort_columns(ptid, ptent, cnt, sel),
                   ps.sort_columns_plain(ptid, ptent, cnt, sel))
    assert kernels.PORTAL_SORT.launches == before + 1
    T = tl.table.shape[0]
    if tl.sup_cols.shape[0]:
        kw = dict(T=T, mps=caps["mps"])
        _same_ordering(ps.split_columns(ptid, ptent, cnt, sel, **kw),
                       ps.split_columns_plain(ptid, ptent, cnt, sel, **kw))
        assert kernels.PORTAL_SORT.launches == before + 2


def _crafted_records(MP, R, T, seed, long_every=0, long_n=500):
    """Phase-A-shaped records [MP, R] on the card: counts 0, a few,
    exactly MP and past MP (and `long_n` every `long_every`th ray),
    entry t drawn from a few values, so that keys tie, with -0.0, +0.0,
    +-inf and +-NaN mixed in; ids below T are treelets, from T supers."""
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, 9, R)
    cnt[::7] = 0
    cnt[3::11] = MP
    cnt[5::13] = MP + 3
    if long_every:
        cnt[1::long_every] = long_n
    ptid = np.full((MP, R), -1, np.int32)
    ptent = np.full((MP, R), np.inf, np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, 2.0],
                       np.float32)
    special_bits = special.view(np.uint32).copy()
    special_bits[4] = 0xffc00000                      # -NaN
    special = np.concatenate([special, np.array([np.nan], np.float32),
                              special_bits[4:5].view(np.float32)])
    for c in range(R):
        k = min(int(cnt[c]), MP)
        ptid[:k, c] = rng.integers(0, T + 8, k)
        t = rng.integers(0, 5, k).astype(np.float32)
        pick = rng.random(k) < 0.15
        t[pick] = special[rng.integers(0, len(special), int(pick.sum()))]
        ptent[:k, c] = t
    dev = "cuda"
    return (torch.from_numpy(ptid).to(dev), torch.from_numpy(ptent).to(dev),
            torch.from_numpy(cnt.astype(np.int32)).to(dev))


@pytest.mark.parametrize("MP, long_every", [(16, 0), (64, 0), (600, 37)])
@pytest.mark.parametrize("split", [False, True])
def test_portal_sort_kernel_crafted(MP, long_every, split):
    """Equal keys, -0.0 beside +0.0, valid +-inf and +-NaN records, counts
    of 0, exactly MP and past MP, and (at MP 600) 500-record rays among
    short ones: the kernel equals torch's stable sort on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bvh_tpu_torch.traverse import portal_sort as ps
    T = 40
    ptid, ptent, cnt = _crafted_records(MP, 3000, T, seed=MP,
                                        long_every=long_every)
    sel = torch.nonzero(cnt >= 0).squeeze(1)[1:]   # a count of 0 kept too
    if split:
        for mps in (1, 4, 64):
            _same_ordering(
                ps.split_columns(ptid, ptent, cnt, sel, T=T, mps=mps),
                ps.split_columns_plain(ptid, ptent, cnt, sel, T=T, mps=mps))
    else:
        _same_ordering(ps.sort_columns(ptid, ptent, cnt, sel),
                       ps.sort_columns_plain(ptid, ptent, cnt, sel))


@pytest.mark.parametrize("max_new, special", [(4, False), (4, True),
                                              (40, True)])
def test_portal_merge_kernel_crafted(max_new, special):
    """Three A2 rounds of merges into split lists at MP 48, on a few
    thousand rays, each round's window slots filled or not, counts past
    max_new; new keys tie with each other and with the lists' (and, with
    `special`, -0.0, +-inf and +-NaN; with max_new 40 some rays take
    more than a thread sorts alone): the kernel's lists, lengths and
    finite counts equal the plain merge's on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bvh_tpu_torch.traverse import portal_sort as ps
    T, MP, dev = 40, 48, "cuda"
    ptid, ptent, cnt = _crafted_records(MP, 4000, T, seed=max_new)
    if not special:
        ptent = torch.where(torch.isfinite(ptent) | (ptid < 0), ptent, 1.5)
        ptent = torch.where(ptent == 0, 0.5, ptent)
    sel = torch.nonzero(cnt > 0).squeeze(1)
    lists = ps.split_columns_plain(ptid, ptent, cnt, sel, T=T, mps=8)
    got = [x.clone() for x in (lists[0], lists[1], lists[4])]
    want = [x.clone() for x in got]
    rng = np.random.default_rng(max_new)
    Rc = sel.numel()
    for _ in range(3):
        rsel = torch.from_numpy(np.sort(rng.choice(Rc, Rc // 2,
                                                   replace=False))).to(dev)
        Rr = rsel.numel()
        slots = rng.random((wt.K2, Rr)) < 0.8
        jj, rr = (torch.from_numpy(x).to(dev) for x in np.nonzero(slots))
        perm = torch.from_numpy(rng.permutation(jj.numel())).to(dev)
        jj, rr = jj[perm], rr[perm]
        L = jj.numel()
        ncnt = rng.integers(0, max_new + 3, L)
        ntid = np.full((max_new, L), -1, np.int32)
        nt = np.full((max_new, L), np.inf, np.float32)
        for i in range(L):
            k = min(int(ncnt[i]), max_new)
            ntid[:k, i] = rng.integers(0, T, k)
            nt[:k, i] = rng.integers(0, 5, k)
            if special:
                pick = rng.random(k) < 0.1
                nt[:k, i][pick] = np.array(
                    [-0.0, np.inf, -np.inf, np.nan], np.float32)[
                    rng.integers(0, 4, int(pick.sum()))]
        ntid, nt = torch.from_numpy(ntid).to(dev), torch.from_numpy(nt).to(dev)
        ncnt = torch.from_numpy(ncnt.astype(np.int32)).to(dev)
        before = kernels.PORTAL_MERGE.launches
        f_got = ps.merge_columns(*got, rsel, jj, rr, ntid, nt, ncnt, k2=wt.K2,
                                 max_new=max_new)
        assert kernels.PORTAL_MERGE.launches == before + 1
        f_want = ps.merge_columns_plain(*want, rsel, jj, rr, ntid, nt, ncnt,
                                        k2=wt.K2, max_new=max_new)
        _same_ordering(got + [f_got], want + [f_want])


@pytest.fixture(scope="module")
def small_two_level():
    """sponza_class(3000, 3), a MEDIUM tree, cut at max_prims 128 under
    supers of 512 (the two-level scene of the CPU tests), 32x32 primary
    rays, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bvh_tpu_torch.build.default import (
        DefaultConfig,
        Quality,
        build_default,
    )
    tris = sponza_class(3000, seed=3)
    tt = torch.from_numpy(tris)
    bvh = build_default(tt.min(1).values, tt.max(1).values, tt.mean(1),
                        DefaultConfig(quality=Quality.MEDIUM))
    flat = PrecomputedTri.from_tri(Tri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
    eye, d, up = scene_camera(tris)
    rays = primary_rays(eye, d, up, 32, 32, device="cuda")
    tl = wt.build_wide_treelets(bvh, flat, max_prims=128, super_prims=512,
                                device="cuda")
    assert tl.sup_cols.shape[0] > 1
    return tl, rays, bvh.prim_ids.cuda()


@pytest.mark.parametrize("caps", ["render", "mps", "max_new", "max_portals"])
def test_expand_supers_kernel_equals_plain(small_two_level, monkeypatch,
                                           caps):
    """Phase A2 with the ordering kernel (split and merges) against the
    same with the plain ordering: treelet lists, overflow bits 1, 2, 4
    and diag equal."""
    tl, rays, _ = small_two_level
    packed = wt.pack_rays(rays)
    c = dict(wt.wide_treelet_caps(tl, wt.portals_per_round(tl)),
             **{"render": {}, "mps": dict(mps=1), "max_new": dict(max_new=1),
                "max_portals": dict(max_portals=8)}[caps])
    kw = dict(robust=False, top_stack=tl.top_depth + 1,
              max_portals=c["max_portals"], mps=c["mps"])
    a2 = dict(robust=False, sup_stack=tl.sup_depth + 1, mps=c["mps"],
              max_new=c["max_new"], max_portals=c["max_portals"])

    def run():
        portals = wt.collect_and_sort(tl, packed, **kw)
        return wt.expand_supers(tl, portals, packed[:, portals.sel], **a2)

    before = kernels.PORTAL_MERGE.launches
    got = run()
    assert kernels.PORTAL_MERGE.launches - before == got[3]["a2_rounds"] > 0
    _plain_ordering(monkeypatch)
    want = run()
    _same_ordering(got[:2], want[:2])
    assert got[2:] == want[2:]
    assert (got[2] != 0) == (caps != "render")


RENDER_CASES = {"262k_interior": (262_144, "interior", False),
                "262k_shadow": (262_144, "shadow", True),
                "10m_interior": (10_000_000, "interior", False),
                "small_two_level": (None, None, False)}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_with_portal_kernel_equals_plain_ordering(
        boxgrid, small_two_level, monkeypatch, case):
    """The entry point's render with the ordering kernel against the same
    render with the plain ordering, hit for hit and bit for bit, on the
    box-grid scenes at the benchmark's sizes and the small two-level
    one."""
    n, kind, any_hit = RENDER_CASES[case]
    if n is None:
        tl, rays, prim_ids = small_two_level
    else:
        tris, bvh, tl = boxgrid(n)
        rays, prim_ids = RAYS[kind](tris), bvh.prim_ids
    before = kernels.PORTAL_SORT.launches
    got, diag = wt.wide_treelet_intersect_tris(
        tl, rays, prim_ids, any_hit=any_hit, return_diag=True)
    assert kernels.PORTAL_SORT.launches > before
    _plain_ordering(monkeypatch)
    want, want_diag = wt.wide_treelet_intersect_tris(
        tl, rays, prim_ids, any_hit=any_hit, return_diag=True)
    for f in ("t", "u", "v", "prim_pos", "prim_id"):
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f
    assert diag == want_diag
    assert int(torch.isfinite(got.t).sum()) > 0
