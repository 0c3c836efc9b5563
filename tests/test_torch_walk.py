"""The portal walk (`wide_treelet.walk_portals`) on the CPU, where it runs
its plain version, against the render driver's pair rounds
(`_pair_rounds`), on one torch thread:

- on raybench's box grid of 3,000 triangles (the scene and rays of
  tests/test_torch_rerun.py), one-level and two-level, the walk at k =
  4 and 16 equals the rounds at the same k bit for bit: closest hit in
  its hits, pairs and stack high-water mark, any-hit in its hits, and
  in its pairs and high-water mark the rounds' at k = 1; it counts one
  round;
- on a strip of unit squares cut into treelets of 8 triangles, rays
  that hit an edge shared by two treelets find the same t in both, and
  the earlier portal of the list wins, in the walk and the rounds at
  k = 1, 4 and 16;
- the dispatcher refuses inputs its kernel does not take, as
  `check_pair_inputs` does for B1;
- the entry point on CPU tensors still traces the lists in
  `_pair_rounds`' rounds and never calls the walk.
"""

import pytest
import torch

from bvh_tpu_torch.build.default import DefaultConfig, Quality, build_default
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
from bvh_tpu_torch.traverse import wide_treelet as wt
from test_torch_rerun import GENEROUS, world  # noqa: F401  (a fixture)

CAPS = {k: v for k, v in GENEROUS.items() if k != "max_rounds"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """At these sizes torch's intra-op threads gain nothing and contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def prepared(tl, ray):
    """(portals, rays_c, late) of every ray of `ray` at caps that fit."""
    portals, rays_c, late, diag = wt._prepare(
        tl, wt.pack_rays(ray), robust=False, top_stack=CAPS["top_stack"],
        max_portals=CAPS["max_portals"], mps=CAPS["mps"],
        max_new=CAPS["max_new"], sup_stack=CAPS["sup_stack"],
        collect=wt.collect_portals, collect_super=wt.collect_super_pairs,
        stage=wt.run_stage)
    assert late is None and diag["overflow"] is None
    return portals, rays_c


def fresh_diag():
    return dict(rounds=0, pairs=0, stack_hwm=0, stack_ovf=False,
                pending=False)


def rounds_at(tl, portals, rays_c, k, any_hit):
    diag = fresh_diag()
    best, late = wt._pair_rounds(
        tl, portals, rays_c, None, diag, any_hit=any_hit, robust=False,
        stack_depth=CAPS["stack_depth"], max_rounds=4096, k=k,
        traverse=wt.traverse_pairs_plain, stage=wt.run_stage)
    assert late is None and not diag["pending"]
    return best, diag


def walked(tl, portals, rays_c, any_hit, k):
    diag = fresh_diag()
    best, late = wt.walk_portals(tl, portals, rays_c, None, diag,
                                 any_hit=any_hit, robust=False,
                                 stack_depth=CAPS["stack_depth"], k=k)
    assert late is None and not diag["pending"]
    return best, diag


def assert_same(got, want):
    for name, a, b in zip(("t", "u", "v", "pos"), got, want):
        assert torch.equal(_bits(a), _bits(b)), name


@pytest.mark.parametrize("level", ["one", "two"])
@pytest.mark.parametrize("kind", ["diffuse", "shadow"])
@pytest.mark.parametrize("k", [4, 16])
def test_walk_equals_rounds(world, level, kind, k):  # noqa: F811
    tl, ray = world["cuts"][level], world["rays"][kind]
    any_hit = kind == "shadow"
    portals, rays_c = prepared(tl, ray)
    got, diag = walked(tl, portals, rays_c, any_hit, k)
    want, loop = rounds_at(tl, portals, rays_c, k, any_hit)
    assert_same(got, want)
    assert int(torch.isfinite(got[0]).sum()) > 0
    # one walk, with the pairs of the rounds at k (any-hit: at k = 1,
    # since a ray stops at its first hit and not at its window's end)
    same_pairs = rounds_at(tl, portals, rays_c, 1, any_hit)[1] if any_hit \
        else loop
    assert diag["rounds"] == 1
    assert diag["pairs"] == same_pairs["pairs"] <= loop["pairs"]
    assert diag["stack_hwm"] == same_pairs["stack_hwm"] > 0
    assert not diag["stack_ovf"]


@pytest.fixture(scope="module")
def strip():
    """Two rows of 32 unit squares in the plane y = 0, two triangles a
    square, cut into treelets of at most 8 triangles, and rays from
    above that hit the plane on the edges x = 1 .. 31 between squares:
    each normal is (0, +-1, 0), so both triangles of an edge give the
    same t bit for bit."""
    quads = []
    for z in range(2):
        for x in range(32):
            a, b = [x, 0.0, z], [x + 1, 0.0, z]
            c, d = [x + 1, 0.0, z + 1], [x, 0.0, z + 1]
            quads += [[a, b, c], [a, c, d]]
    tris = torch.tensor(quads, dtype=torch.float32)
    tri = Tri(tris[:, 0], tris[:, 1], tris[:, 2])
    bb_min, bb_max = tri.get_bbox()
    bvh = build_default(bb_min, bb_max, tri.get_center(),
                        DefaultConfig(quality=Quality.MEDIUM))
    flat = PrecomputedTri.from_tri(tri).as_flat()
    tl = wt.build_wide_treelets(bvh, flat, max_prims=8)
    xs = torch.arange(1, 32, dtype=torch.float32)
    zs = torch.tensor([0.25, 0.5, 0.75, 1.25, 1.75])
    hx, hz = torch.meshgrid(xs, zs, indexing="ij")
    hit = torch.stack([hx.reshape(-1), torch.zeros(hx.numel()),
                       hz.reshape(-1)], 1)
    d = torch.tensor([0.5, -1.0, 0.25]).expand_as(hit).contiguous()
    n = hit.shape[0]
    ray = Ray(hit - d, d, torch.zeros(n), torch.full((n,), float("inf")))
    return tl, ray


@pytest.mark.parametrize("k", [1, 4, 16])
def test_tie_across_treelets_goes_to_the_earlier_portal(strip, k):
    tl, ray = strip
    assert tl.table.shape[0] >= 8
    portals, rays_c = prepared(tl, ray)
    best = walked(tl, portals, rays_c, False, k)[0]
    assert_same(best, rounds_at(tl, portals, rays_c, k, False)[0])
    assert torch.equal(best[0], torch.ones_like(best[0]))    # t = 1 each
    # each portal's own result at the ray's full tmax: the first portal
    # in list order whose treelet hits at t = 1 must give the ray's hit
    MP, Rc = portals.tid.shape
    valid = portals.tid >= 0
    kk, rr = torch.nonzero(valid, as_tuple=True)
    out_f, out_i = wt.traverse_pairs_plain(
        tl.table_cols, portals.tid[kk, rr].to(torch.int32),
        rays_c[:, rr].contiguous(), any_hit=False, robust=False,
        stack_depth=CAPS["stack_depth"])
    at_one = torch.zeros((MP, Rc), dtype=torch.bool)
    at_one[kk, rr] = out_f[0] == 1.0
    pos = torch.full((MP, Rc), -1, dtype=torch.int64)
    pos[kk, rr] = out_i[0].to(torch.int64)
    first = at_one.to(torch.int8).argmax(0)
    assert torch.equal(best[3], pos[first, torch.arange(Rc)])
    ties = at_one.sum(0) >= 2          # rays with t = 1 in two treelets
    assert int(ties.sum()) >= 8
    # and the later portal's prim differs, so the order decides
    second = (at_one & (torch.arange(MP)[:, None] > first)).to(
        torch.int8).argmax(0)
    assert bool((pos[second, torch.arange(Rc)] != best[3])[ties].all())


def test_dispatcher_refuses_what_its_kernel_does_not_take(world):  # noqa: F811
    tl = world["cuts"]["one"]
    portals, rays_c = prepared(tl, world["rays"]["diffuse"])
    tid, tent = portals.tid, portals.tent
    Rc = rays_c.shape[1]
    late = torch.zeros(Rc, dtype=torch.bool)
    wt.check_walk_inputs("t", tl.table_cols, tid, tent, rays_c, late, 8)
    wt.check_walk_inputs("t", tl.table_cols, tid, tent, rays_c, None, 8)
    bad = {
        "column layout": dict(table_cols=tl.table),
        "stack depth": dict(stack_depth=0),
        "tid must": dict(tid=tid.to(torch.int32)),
        "tent must": dict(tent=tent[:-1]),
        "late must": dict(late=late.to(torch.int32)),
        "rays must": dict(rays_c=rays_c[:, :-1]),
    }
    args = dict(table_cols=tl.table_cols, tid=tid, tent=tent, rays_c=rays_c,
                late=late, stack_depth=8)
    for msg, change in bad.items():
        with pytest.raises(ValueError, match=msg):
            wt.check_walk_inputs("t", **dict(args, **change))
    with pytest.raises(ValueError, match="stack depth"):
        wt.check_walk_inputs("t", tl.table_cols, tid, tent, rays_c, None,
                             wt.kernels.WIDE_STACK_MAX + 1)
    meta = portals._replace(tid=tid.to("meta"), tent=tent.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        wt.walk_portals(tl, meta, rays_c.to("meta"), None, fresh_diag(),
                        any_hit=False, robust=False, stack_depth=8, k=4)
    with pytest.raises(ValueError, match="k must be"):
        wt.walk_portals(tl, portals, rays_c, None, fresh_diag(),
                        any_hit=False, robust=False, stack_depth=8, k=0)


def test_entry_point_on_cpu_keeps_the_rounds(world, monkeypatch):  # noqa: F811
    tl, ray = world["cuts"]["one"], world["rays"]["diffuse"]
    calls = []
    rounds = wt._pair_rounds

    def spy(*a, **kw):
        calls.append(kw["k"])
        return rounds(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the walk ran on CPU tensors")

    monkeypatch.setattr(wt, "_pair_rounds", spy)
    monkeypatch.setattr(wt, "walk_portals", refuse)
    hit, diag = wt.wide_treelet_intersect_tris(tl, ray, return_diag=True)
    assert calls == [wt.portals_per_round(tl)]
    assert diag["rounds"] > 1
