"""The comparison that decides `correct`: the float64 reference's
brackets hold the port's float32 answers, the judge passes them and
fails altered ones, the tree check, the bfloat16 control, and whole
runs with the timed path broken underneath (the harness's look for a
card skipped), which must come out not correct."""

import pytest
import torch

from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.core.types import INVALID_PRIM_ID
from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
from raybench import control, harness, judge, rays, scenes
from raybench.reference import intersect, tree
from raybench.tests.conftest import tiny, tiny_cell

CELLS = {w["name"] for w in harness.cell("boxgrid_262k.interior")[0][
    "workloads"]}


def tiny_any(workload):
    """`tiny` of a cell of BENCHMARK.json, else `tiny_cell` by its name."""
    return tiny(workload) if workload in CELLS else tiny_cell(
        *workload.split("."))


def scene_and_rays(workload="boxgrid_262k.interior", n=64):
    tris = scenes.sponza_class(3000, 0, "cpu")
    ray = rays.ray_sets(tiny_any(workload)[3]["rays"], tris, 5)[0]
    g = torch.Generator().manual_seed(1)
    idx = torch.randperm(ray[0].shape[0], generator=g)[:n]
    return tris, tuple(x[idx] for x in ray)


def port_brute_force(tris, ray, any_hit=False):
    """The port's own float32 test over every pair, nearest hit."""
    pt = PrecomputedTri.from_tri(Tri(*(tris[None, :, i] for i in range(3))))
    org, dirs, tmin, tmax = ray
    t, _, _, hit = pt.intersect(Ray(org[:, None], dirs[:, None],
                                    tmin[:, None], tmax[:, None]))
    t = torch.where(hit, t, float("inf"))
    best, prim = t.min(1)
    prim = torch.where(torch.isfinite(best), prim, INVALID_PRIM_ID)
    return best, prim


@pytest.mark.parametrize("workload", ["boxgrid_262k.interior",
                                      "boxgrid_262k.shadow",
                                      "boxgrid_262k.diffuse"])
def test_brackets_hold_the_float32_answer(workload):
    tris, ray = scene_and_rays(workload)
    best, prim = port_brute_force(tris, ray)
    t_sure, t_poss = intersect.brackets(tris, *ray)
    b = best.double()
    assert bool((t_poss <= b).all()) and bool((b <= t_sure).all())
    assert int(torch.isfinite(t_sure).sum()) > 10


def test_judge_passes_sound_answers_and_fails_altered_ones():
    tris, ray = scene_and_rays()
    best, prim = port_brute_force(tris, ray)
    ok = judge.judge(tris, ray, best, prim, any_hit=False)
    assert ok["wrong_hits"] == 0 and ok["late_hits"] == 0
    assert ok["t_gap"] < 1.0
    hit = torch.isfinite(best)
    far = judge.judge(tris, ray, torch.where(hit, best * 1.001, best), prim,
                      any_hit=False)
    assert far["t_gap"] > 100
    other = judge.judge(tris, ray, best, torch.where(hit, (prim + 1) % 3000,
                                                     prim), any_hit=False)
    assert other["wrong_hits"] > 0
    none = judge.judge(tris, ray, torch.full_like(best, float("inf")),
                       torch.full_like(prim, INVALID_PRIM_ID), any_hit=False)
    assert none["late_hits"] == int(hit.sum())
    near = judge.judge(tris, ray, best * 0.5, prim, any_hit=False)
    assert near["wrong_hits"] > 0


def test_any_hit_judge():
    tris, ray = scene_and_rays("boxgrid_262k.shadow")
    best, prim = port_brute_force(tris, ray)
    assert judge.verdict(judge.judge(tris, ray, best, prim, any_hit=True),
                         {"wrong_hits": 0, "late_hits": 0, "t_gap": 1.0})
    hit = torch.isfinite(best)
    assert 0 < int(hit.sum()) < hit.numel()
    miss = judge.judge(tris, ray, torch.full_like(best, float("inf")),
                       torch.full_like(prim, INVALID_PRIM_ID), any_hit=True)
    assert miss["late_hits"] > 0


def test_tree_check(one_thread):
    from bvh_tpu_torch.build import default

    tris = scenes.sponza_class(3000, 0, "cpu")
    tri = Tri(*(tris[:, i] for i in range(3)))
    bb_min, bb_max = tri.get_bbox()
    bvh = default.build_default(bb_min, bb_max, tri.get_center(),
                                default.DefaultConfig())
    args = (bvh.bounds, bvh.index, bvh.prim_ids, int(bvh.node_count), tris)
    assert tree.check_tree(*args) == {"tree_bad_prims": 0,
                                      "tree_bad_boxes": 0}
    ids = bvh.prim_ids.clone()
    ids[0] = ids[1]
    assert tree.check_tree(bvh.bounds, bvh.index, ids, *args[3:])[
        "tree_bad_prims"] == 2
    shrunk = bvh.bounds.clone()
    shrunk[0, 1] -= 1.0
    assert tree.check_tree(shrunk, *args[1:])["tree_bad_boxes"] >= 1


def test_control_fails():
    """The plain reference in the program's place, in bfloat16."""
    data = tiny("boxgrid_262k.interior")
    nums = control.control_numbers("boxgrid_262k.interior", 7, "cpu", data)
    assert not judge.verdict(nums, data[3]["check"]["limits"])
    assert nums["wrong_hits"] > 0 and nums["t_gap"] > 100


def run_tiny(workload, seed=3, trace=False):
    return harness.run_cell(workload, seed, 0.5, trace, "cpu",
                            cell_data=tiny(workload))


def test_sound_run_is_correct(one_thread):
    out = run_tiny("boxgrid_262k.interior", trace=True)
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == set()      # no device metric on the CPU
    assert list(out)[-1] == "check"


def test_diffuse_run_is_correct(one_thread):
    """The diffuse traffic through the render loop, in a cell that
    BENCHMARK.json does not hold yet."""
    out = harness.run_cell("boxgrid_262k.diffuse", 3, 0.5, False, "cpu",
                           cell_data=tiny_any("boxgrid_262k.diffuse"))
    assert out["correct"], out["check"]
    assert out["check"]["late_hits"]["limit"] == 3


def with_quality(workload, quality):
    data = tiny(workload)
    data[2]["build_quality"] = quality
    return data


def test_unknown_build_quality_is_refused_before_any_build(monkeypatch):
    def no_build(*a, **kw):
        raise AssertionError("a build ran")

    monkeypatch.setattr(harness, "scene_build", no_build)
    monkeypatch.setattr(scenes, "sponza_class", no_build)
    for quality in ("ultra", None, "HIGH"):
        with pytest.raises(ValueError, match=f"build_quality {quality!r}"):
            harness.run_cell("boxgrid_262k.build_high", 3, 0.5, False, "cpu",
                             cell_data=with_quality(
                                 "boxgrid_262k.build_high", quality))


def test_build_quality_reaches_build_default(monkeypatch, one_thread):
    from bvh_tpu_torch.build import default

    real = default.build_default
    seen = []

    def wrapper(bb_min, bb_max, centers, config=None):
        seen.append(config.quality)
        return real(bb_min, bb_max, centers, config)

    monkeypatch.setattr(default, "build_default", wrapper)
    for quality in harness.QUALITIES:
        seen.clear()
        out = harness.run_cell("boxgrid_262k.build_high", 3, 0.5, False,
                               "cpu", cell_data=with_quality(
                                   "boxgrid_262k.build_high", quality))
        assert out["correct"], (quality, out["check"])
        assert set(seen) == {default.Quality(quality)}


def broken_render(monkeypatch, fault):
    from bvh_tpu_torch.traverse import wide_treelet as wt

    real = wt.wide_treelet_intersect_tris
    state = {}

    def wrapper(tl, ray, *a, **kw):
        if fault == "half":
            R = ray.org.shape[0]
            part = real(tl, Ray(*(x[: R // 2] for x in ray)), *a, **kw)
            pad = R - R // 2
            return part._replace(
                t=torch.cat([part.t, torch.full((pad,), float("inf"))]),
                prim_id=torch.cat([part.prim_id,
                                   torch.full((pad,), INVALID_PRIM_ID)]))
        hit = real(tl, ray, *a, **kw)
        if fault == "stale":                  # the previous frame's hits
            hit, state["last"] = state.get("last", hit), hit
        elif fault == "altered":              # every 3rd answer moved
            hit = hit._replace(t=hit.t.clone())
            hit.t[::3] *= 1.01
        return hit

    monkeypatch.setattr(wt, "wide_treelet_intersect_tris", wrapper)


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_broken_render_is_not_correct(monkeypatch, one_thread, fault):
    broken_render(monkeypatch, fault)
    out = run_tiny("boxgrid_262k.interior")
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_broken_build_is_not_correct(monkeypatch, one_thread, fault):
    from bvh_tpu_torch.build import default

    real = default.build_default
    state = {}

    def wrapper(bb_min, bb_max, centers, config=None):
        if fault == "half":
            n = centers.shape[0] // 2
            return real(bb_min[:n], bb_max[:n], centers[:n], config)
        bvh = real(bb_min, bb_max, centers, config)
        if fault == "stale":                  # the previous scene's tree
            bvh, state["last"] = state.get("last", bvh), bvh
        elif fault == "altered":              # the root box cut short
            bounds = bvh.bounds.clone()
            bounds[0, 1] -= 0.5
            bvh = bvh._replace(bounds=bounds)
        return bvh

    monkeypatch.setattr(default, "build_default", wrapper)
    out = run_tiny("boxgrid_262k.build_high")
    assert not out["correct"], out["check"]


@pytest.mark.cuda
def test_cells_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for workload in ("boxgrid_262k.interior", "boxgrid_262k.build_high",
                     "boxgrid_262k.shadow", "boxgrid_262k.diffuse",
                     "boxgrid_262k_low.rebuild"):
        out = harness.run_cell(workload, 3, 0.5, True, "cuda",
                               cell_data=tiny_any(workload))
        assert out["correct"], (workload, out["check"])
        assert out["device"]["busy_s"] > 0
        # a cell that BENCHMARK.json does not hold has no per-layer metric
        assert out["metrics"] or workload not in CELLS
