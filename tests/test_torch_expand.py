"""Phase A2 in one launch (`wide_treelet.walk_supers`) on the CPU, where it
runs its plain version (`walk_supers_plain`: every (ray, super) walk
first, then the rounds' merges and retirement rule over them), against
the rounds it replaces on the card (`expand_supers` with `over`, as the
render driver calls it), on one torch thread:

- on the two-level cut of the scene of tests/test_torch_portal_sort.py
  (sponza_class(3000, 3), a MEDIUM tree built by the port, max_prims
  128 under supers of 512) and on a deeper cut of it (max_prims 32 under
  supers of 1,024, whose super walks push 4 deep), with 32x32 primary
  rays and with rays from inside the grid: at caps that overflow
  nothing, mps, max_new, max_portals, B4's stack, with phase-A-late
  columns, fast and robust, the lists, lengths, bits, `over` ("cols",
  "max_sup", "max_rec", "max_len") and the diag's a2_pairs and sup_ovf
  are equal bit for bit, and no kernel is launched;
- rays from inside the grid enter treelets of different supers at equal
  entry t, so the rounds' tie rule (record order, then slot, after the
  list's equal keys) is exercised;
- the dispatcher refuses inputs its kernel does not take;
- the render driver with the super walk (`_intersect(..., walk=True)` on
  CPU tensors, the plain versions) makes the same attempts at the same
  raised caps and returns the same hits as with the rounds, and the
  entry point on CPU tensors keeps the rounds.
"""

import collections

import pytest
import torch

from bvh_tpu_torch import kernels
from bvh_tpu_torch.build.default import DefaultConfig, Quality, build_default
from bvh_tpu_torch.cli.camera import primary_rays
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
from bvh_tpu_torch.io.scenes import scene_camera, sponza_class
from bvh_tpu_torch.traverse import wide_treelet as wt


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """At these sizes torch's intra-op threads gain nothing and contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    """{"cut": {"two_level", "deep"} -> WideTreelets; "rays": {"camera",
    "inside"} -> [8, R] packed rays; "tris", "flat", "bvh"}."""
    tris = sponza_class(3000, seed=3)
    tt = torch.from_numpy(tris)
    bvh = build_default(tt.min(1).values, tt.max(1).values, tt.mean(1),
                        DefaultConfig(quality=Quality.MEDIUM))
    flat = PrecomputedTri.from_tri(Tri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
    eye, d, up = scene_camera(tris)
    camera = primary_rays(eye, d, up, 32, 32, device="cpu")
    cuts = {"two_level": wt.build_wide_treelets(bvh, flat, max_prims=128,
                                                super_prims=512),
            "deep": wt.build_wide_treelets(bvh, flat, max_prims=32,
                                           super_prims=1024)}
    assert all(tl.sup_cols.shape[0] > 1 for tl in cuts.values())
    return dict(cut=cuts, rays={"camera": wt.pack_rays(camera),
                                "inside": wt.pack_rays(inside_rays(tt))},
                tris=tt, flat=flat, bvh=bvh)


def inside_rays(tt, n=1024, seed=0):
    """n rays from points drawn inside the grid's bounds, in directions
    drawn from a normal distribution, tmin 0, tmax +inf: an origin inside
    treelet boxes of several supers enters them all at t = 0."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = tt.reshape(-1, 3).amin(0), tt.reshape(-1, 3).amax(0)
    org = lo + torch.rand((n, 3), generator=g) * (hi - lo)
    return Ray(org, torch.randn((n, 3), generator=g), torch.zeros(n),
               torch.full((n,), float("inf")))


@pytest.fixture
def no_launch(monkeypatch):
    """Make any launch of the A2 kernels fail the test."""
    def refuse(*args):
        raise AssertionError("a CPU tensor launched a kernel")

    for k in (kernels.SUPER_WALK, kernels.COLLECT_SUPER,
              kernels.PORTAL_MERGE):
        monkeypatch.setattr(k, "launch", refuse)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


# (cut, rays, caps changed from the render's, late): `late` marks every
# third column as past a phase-A cap
CASES = {
    "render": ("two_level", "camera", {}, False),
    "mps": ("two_level", "camera", dict(mps=1), False),
    "max_new": ("two_level", "camera", dict(max_new=1), False),
    "max_portals": ("two_level", "camera", dict(max_portals=8), False),
    "late": ("two_level", "camera", {}, True),
    "inside": ("two_level", "inside", {}, False),
    "inside_caps": ("two_level", "inside", dict(max_new=2, max_portals=16),
                    True),
    "stack": ("deep", "inside", dict(sup_stack=2), False),
    "deep_render": ("deep", "inside", dict(mps=64, max_portals=64), False),
}


def a2_inputs(scenes, case, robust):
    """The case's scene, packed rays, split-sort kwargs, A2 kwargs and
    phase-A-late mask (None or bool [Rc])."""
    cut, rays, change, late = CASES[case]
    tl, packed = scenes["cut"][cut], scenes["rays"][rays]
    caps = dict(wt.wide_treelet_caps(tl, wt.portals_per_round(tl)),
                sup_stack=tl.sup_depth + 1)
    caps.update(change)
    sort_kw = dict(robust=robust, top_stack=tl.top_depth + 1,
                   max_portals=caps["max_portals"], mps=caps["mps"])
    a2 = dict(robust=robust, sup_stack=caps["sup_stack"], mps=caps["mps"],
              max_new=caps["max_new"], max_portals=caps["max_portals"])
    return tl, packed, sort_kw, a2, late


def expanded(fn, tl, packed, sort_kw, a2, late):
    """fn's A2 on fresh lists: (tid, tent, tlen, bits, diag, over)."""
    portals = wt.collect_and_sort(tl, packed, **sort_kw)
    gone = None
    if late:
        gone = torch.zeros(portals.sel.numel(), dtype=torch.bool)
        gone[::3] = True
    over = dict(cols=gone)
    tid, tent, bits, diag = fn(tl, portals, packed[:, portals.sel], over=over,
                               **a2)
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


# the overflow bits and columns each case must show
EXPECT = {"render": (0, False), "mps": (1, True), "max_new": (2, True),
          "max_portals": (4, True), "late": (0, True), "inside": (0, False),
          "inside_caps": (None, True), "stack": (0, True),
          "deep_render": (0, False)}


@pytest.mark.parametrize("robust", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_super_walk_equals_the_rounds(scenes, no_launch, case, robust):
    """`walk_supers` (its plain version here) against `expand_supers`
    with `over`, bit for bit, with no launch."""
    args = a2_inputs(scenes, case, robust)
    want = expanded(wt.expand_supers, *args)
    got = expanded(wt.walk_supers, *args)
    assert_same_a2(got, want)
    assert got[4]["a2_rounds"] == 1
    assert want[4]["a2_rounds"] > 0 and want[4]["a2_pairs"] > 0
    bits, marked = EXPECT[case]
    assert bits is None or want[3] == bits
    assert (want[5]["cols"] is not None) == marked
    if case == "stack":
        assert want[4]["sup_ovf"]
    if case == "deep_render":
        assert want[4]["a2_rounds"] >= 2   # a column of several rounds


def test_equal_entry_t_across_supers(scenes):
    """Rays from inside the grid enter treelets of different supers at
    the same t, so that the merges' tie rule decides their order; and
    the super walk still equals the rounds there (the "inside" cases)."""
    tl, packed, sort_kw, a2, _ = a2_inputs(scenes, "inside", False)
    portals = wt.collect_and_sort(tl, packed, **sort_kw)
    sup = portals.sup
    ss, cc = torch.nonzero(sup.sid >= 0, as_tuple=True)
    _, nt, stats = wt.collect_super_pairs(
        tl.sup_cols, sup.sid[ss, cc].contiguous(),
        packed[:, portals.sel][:, cc].contiguous(), robust=False,
        stack_depth=a2["sup_stack"], max_new=a2["max_new"])
    made = torch.arange(nt.shape[0])[:, None] < stats[0][None]
    supers = collections.defaultdict(set)
    for c, s, t in zip(cc.expand_as(nt)[made].tolist(),
                       ss.expand_as(nt)[made].tolist(), nt[made].tolist()):
        supers[(c, t)].add(s)
    assert any(len(s) > 1 for s in supers.values())


def test_dispatcher_refuses_what_its_kernel_does_not_take(scenes):
    tl, packed, sort_kw, a2, _ = a2_inputs(scenes, "render", False)
    portals = wt.collect_and_sort(tl, packed, **sort_kw)
    rays_c = packed[:, portals.sel]
    Rc = rays_c.shape[1]
    sup = portals.sup
    bad = {
        "tid": portals._replace(tid=portals.tid.to(torch.int32)),
        "tent": portals._replace(tent=portals.tent[:-1]),
        "super lists": portals._replace(sup=sup._replace(
            sid=sup.sid.to(torch.int64))),
        "super counts": portals._replace(sup=sup._replace(
            count=sup.count[:-1])),
        "tlen": portals._replace(sup=sup._replace(
            tlen=sup.tlen.to(torch.int64))),
    }
    for what, p in bad.items():
        with pytest.raises(ValueError, match=f"walk_supers: .*{what}"):
            wt.walk_supers(tl, p, rays_c, **a2)
    with pytest.raises(ValueError, match="walk_supers: rays"):
        wt.walk_supers(tl, portals, rays_c[:7].contiguous(), **a2)
    with pytest.raises(ValueError, match="walk_supers: gone"):
        wt.walk_supers(tl, portals, rays_c, over=dict(
            cols=torch.zeros(Rc, dtype=torch.int32)), **a2)
    with pytest.raises(ValueError, match="walk_supers: .*split"):
        wt.walk_supers(tl, portals, rays_c, **dict(a2, mps=a2["mps"] + 1))
    with pytest.raises(ValueError, match="stack depth"):
        wt.walk_supers(tl, portals, rays_c, **dict(a2, sup_stack=0))
    with pytest.raises(ValueError, match="super tables"):
        wt.walk_supers(tl._replace(sup_cols=tl.sup_cols.transpose(1, 2)),
                       portals, rays_c, **a2)


@pytest.mark.parametrize("caps", [{}, dict(mps=1, max_new=1, max_portals=8)])
def test_driver_with_the_super_walk_keeps_the_attempts(scenes, caps):
    """The render driver with the super walk on CPU tensors (`_intersect`
    with `walk`, plain versions) against the rounds: the same hits, and
    the same attempts, re-run rays, raised caps and the counts they come
    from, forced overflows included."""
    tl, tt = scenes["cut"]["two_level"], scenes["tris"]
    eye, d, up = scene_camera(tt.numpy())
    rays = primary_rays(eye, d, up, 32, 32, device="cpu")
    runs = [wt._intersect(tl, rays, None, wt.collect_portals,
                          wt.traverse_pairs, return_diag=True, walk=walk,
                          **caps) for walk in (False, True)]
    (want, w_diag), (got, diag) = runs
    for f in ("t", "u", "v", "prim_pos"):
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f)))
    for key in ("attempts", "rerun_rays", "caps", "a2_pairs", "a2_bits",
                "max_sup", "max_rec", "max_len", "sup_ovf", "max_cnt"):
        assert diag[key] == w_diag[key], key
    assert diag["a2_rounds"] == diag["attempts"] < w_diag["a2_rounds"]
    assert (diag["attempts"] > 1) == bool(caps)


def test_entry_point_on_cpu_keeps_the_rounds(scenes, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU entry point took the super walk")

    monkeypatch.setattr(wt, "walk_supers", refuse)
    tl, tt = scenes["cut"]["two_level"], scenes["tris"]
    eye, d, up = scene_camera(tt.numpy())
    rays = primary_rays(eye, d, up, 16, 16, device="cpu")
    _, diag = wt.wide_treelet_intersect_tris(tl, rays, return_diag=True)
    assert diag["a2_rounds"] > diag["attempts"] == 1
