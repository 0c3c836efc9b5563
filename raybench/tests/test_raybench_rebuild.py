"""The rebuild loop and its cell boxgrid_262k_low.rebuild: a tiny cell is
correct, each frame builds the next variant and renders through it,
every run seed builds the same variants, the check judges each frame
against its own variant, broken builds and renders are not correct, the
control fails, and what the loop cannot run is refused before any
build."""

import statistics
import time

import pytest
import torch

from raybench import control, harness, judge, rays, scenes, tracing
from raybench.tests.conftest import tiny
from raybench.tests.test_raybench_check import broken_render
from raybench.tracing import Op, Trace

CELL = "boxgrid_262k_low.rebuild"


def run_tiny(seed=3, trace=False, data=None):
    return harness.run_cell(CELL, seed, 0.5, trace, "cpu",
                            cell_data=data or tiny(CELL))


def test_files_found_by_name():
    _, wl, config, traffic = harness.cell(CELL)
    assert wl["config"] == config["name"] == "boxgrid_262k_low"
    assert traffic["kind"] == "rebuild" and not traffic["any_hit"]
    assert config["build_quality"] == "low" and not config["two_level"]
    assert traffic["variants"] == traffic["rays"]["poses"] == 16
    base = harness.cell("boxgrid_262k.interior")
    # boxgrid_262k's scene and cut, and the interior traffic's camera
    for key in ("geometry", "scene_seed", "n_tris", "precision",
                "max_prims"):
        assert config[key] == base[2][key], key
    assert set(config["reduced"]) == set(base[2]["reduced"])
    assert traffic["rays"] == base[3]["rays"]
    assert traffic["check"]["limits"] == harness.cell(
        "boxgrid_262k.build_high")[3]["check"]["limits"]


def test_tiny_rebuild_cell_is_correct(one_thread):
    out = run_tiny(trace=True)
    assert out["correct"], out["check"]
    assert out["attempted"] == 2 and out["failed"] == 0
    assert set(out["check"]) == {"tree_bad_prims", "tree_bad_boxes",
                                 "wrong_hits", "late_hits", "t_gap"}
    assert out["check"]["wrong_hits"]["value"] == 0
    # host-clock readings of the untraced frames; no device metric
    assert set(out["metrics"]) == {"rebuild.tree_ms", "rebuild.cut_ms",
                                   "rebuild.render_ms"}
    plain = run_tiny(seed=2**31 + 17)
    assert plain["correct"], plain["check"]
    assert set(plain["metrics"]) == {"setup_s", "rebuild_frame_ms",
                                     "rebuild_frame_ms_p95"}


def test_each_frame_builds_the_next_variant(monkeypatch, one_thread):
    _, _, config, traffic = tiny(CELL)
    traffic["trace"].update(steps=3, plain_steps=2)
    built, rendered = [], []
    real_build, real_render = harness.scene_build, harness.render

    def build(tris, config, spans=None):
        built.append(tris)
        return real_build(tris, config, spans)

    def render(tl, bvh, ray, any_hit):
        rendered.append(ray[1])
        return real_render(tl, bvh, ray, any_hit)

    monkeypatch.setattr(harness, "scene_build", build)
    monkeypatch.setattr(harness, "render", render)
    ctx = {"t0": time.perf_counter(), "spans": {}, "kind": "rebuild"}
    numbers = harness.run_rebuild(config, traffic, 5, 0.0, True, "cpu", ctx)
    assert judge.verdict(numbers, traffic["check"]["limits"]), numbers
    variants, ray_sets, order = harness.rebuild_inputs(config, traffic, 5,
                                                       "cpu")
    # the warm-up frame, then the plain frames, then the traced ones
    frames = [len(ray_sets) - 1] + [0, 1] + [0, 1, 0]
    assert len(built) == len(rendered) == len(frames)
    for tris, d, j in zip(built, rendered, frames):
        assert torch.equal(tris, variants[order[j]])
        assert torch.equal(d, ray_sets[j][1])
    # one tree span, one cut span and one render a frame
    for span in (tracing.SPAN_TREE, tracing.SPAN_CUT, tracing.SPAN_FRAME):
        assert len(ctx["spans"][span]) == 2, span
        assert len(ctx["trace"].spans[span]) == 3, span
    assert len(ctx["trace"].spans[tracing.SPAN_REBUILD]) == 3
    assert len(ctx["durations"]) == 3


def test_every_seed_builds_the_same_variants():
    _, _, config, traffic = tiny(CELL)
    traffic.update(variants=4)
    traffic["rays"].update(poses=4)

    def pairs(seed):
        variants, ray_sets, order = harness.rebuild_inputs(
            config, traffic, seed, "cpu")
        return variants, [(order[j], float(ray_sets[j][1].double().sum()))
                          for j in range(len(ray_sets))]

    va, a = pairs(11)
    vb, b = pairs(2**31 + 12)
    assert all(torch.equal(x, y) for x, y in zip(va, vb))
    assert not torch.equal(va[0], va[1])
    # the same (variant, ray set) pairs, in another order
    assert sorted(a) == sorted(b) and a != b
    assert sorted(v for v, _ in a) == list(range(4))


def test_a_frame_judged_against_another_variant_fails(one_thread):
    _, _, config, traffic = tiny(CELL)
    variants, ray_sets, order = harness.rebuild_inputs(config, traffic, 3,
                                                       "cpu")
    bvh, tl = harness.scene_build(variants[order[0]], config)
    hit = harness.render(tl, bvh, ray_sets[0], False)
    limits = traffic["check"]["limits"]
    own = harness.check_rebuild([(order[0], 0, hit.t, hit.prim_id)],
                                ray_sets, variants, traffic, 3, False)
    assert judge.verdict(own, limits), own
    other = harness.check_rebuild([(order[1], 0, hit.t, hit.prim_id)],
                                  ray_sets, variants, traffic, 3, False)
    assert not judge.verdict(other, limits), other
    assert other["wrong_hits"] > 0


def test_check_shares_its_rays_over_the_kept_frames(monkeypatch):
    """Frames of different variants are judged apart, and together they
    take the check's rays once, as frames of one scene would."""
    _, _, config, traffic = tiny(CELL)
    variants, ray_sets, order = harness.rebuild_inputs(config, traffic, 3,
                                                       "cpu")
    seen = []

    def fake_judge(tris, rays, t, prim, *, any_hit):
        seen.append((tris, rays[0].shape[0]))
        return {"wrong_hits": 0, "late_hits": 0, "t_gap": 0.0}

    monkeypatch.setattr(judge, "judge", fake_judge)
    traffic["check"].update(min_rays=64, max_rays=64)
    kept = [(order[j], j, None, None) for j in range(2)]
    harness.check_rebuild(kept, ray_sets, variants, traffic, 3, False,
                          answer=lambda tris, sub: (None, None))
    assert [n for _, n in seen] == [32, 32]
    assert sorted(id(t) for t, _ in seen) == sorted(
        id(variants[v]) for v in order)


def build_fault(monkeypatch, fault):
    from bvh_tpu_torch.build import default

    real = default.build_default
    state = {}

    def wrapper(bb_min, bb_max, centers, config=None):
        if fault == "half":
            n = centers.shape[0] // 2
            return real(bb_min[:n], bb_max[:n], centers[:n], config)
        bvh = real(bb_min, bb_max, centers, config)
        if fault == "stale":                  # the previous frame's tree
            bvh, state["last"] = state.get("last", bvh), bvh
        elif fault == "altered":              # the root box cut short
            bounds = bvh.bounds.clone()
            bounds[0, 1] -= 0.5
            bvh = bvh._replace(bounds=bounds)
        return bvh

    monkeypatch.setattr(default, "build_default", wrapper)


@pytest.mark.parametrize("where", ["build", "render"])
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_broken_frame_is_not_correct(monkeypatch, one_thread, where, fault):
    (build_fault if where == "build" else broken_render)(monkeypatch, fault)
    out = run_tiny()
    assert not out["correct"], out["check"]


def test_control_fails():
    """The plain reference in the program's place, in bfloat16, on the
    frames a run of the seed would check, each against its variant."""
    data = tiny(CELL)
    nums = control.control_numbers(CELL, 7, "cpu", data)
    assert not judge.verdict(nums, data[3]["check"]["limits"])
    assert nums["wrong_hits"] > 0 and nums["t_gap"] > 100


def no_build(monkeypatch, scene=True):
    def refuse(*a, **kw):
        raise AssertionError("a build ran")

    monkeypatch.setattr(harness, "scene_build", refuse)
    if scene:
        monkeypatch.setattr(scenes, "sponza_class", refuse)


def test_unknown_loop_kind_is_refused_before_any_build(monkeypatch):
    no_build(monkeypatch)
    for kind in ("rebuilt", None, "Render"):
        data = tiny(CELL)
        data[3]["kind"] = kind
        with pytest.raises(ValueError, match=f"kind {kind!r}"):
            run_tiny(data=data)


def test_variants_without_a_ray_set_each_are_refused(monkeypatch):
    data = tiny(CELL)
    data[3]["variants"] = 3
    no_build(monkeypatch, scene=False)      # the scenes are made first
    with pytest.raises(ValueError, match="3 variants and 2 ray sets"):
        run_tiny(data=data)


def test_rebuild_readers():
    durations = [0.5] * 19 + [0.9]
    ctx = dict(kind="rebuild", window_s=10.4, setup_s=3.0,
               durations=durations, done=[1024] * 20, trace=None,
               spans={tracing.SPAN_TREE: [0.3, 0.2],
                      tracing.SPAN_CUT: [0.1, 0.2],
                      tracing.SPAN_FRAME: [0.004, 0.006]})
    assert harness.reader("rebuild_frame_ms")(ctx) == pytest.approx(520.0)
    assert harness.reader("rebuild_frame_ms_p95")(ctx) == pytest.approx(
        1e3 * statistics.quantiles(
            durations, n=100, method="inclusive")[94])
    # the span readers read a trace run's untraced frames only
    for name in ("rebuild.tree_ms", "rebuild.cut_ms", "rebuild.render_ms"):
        assert harness.reader(name)(ctx) is None
    spans = {tracing.SPAN_REBUILD: [Op(tracing.SPAN_REBUILD, 0, 10),
                                    Op(tracing.SPAN_REBUILD, 20, 40)]}
    traced = dict(ctx, trace=Trace(spans, [Op("k", 2, 7), Op("k", 25, 30)],
                                   []))
    assert harness.reader("rebuild.tree_ms")(traced) == pytest.approx(250.0)
    assert harness.reader("rebuild.cut_ms")(traced) == pytest.approx(150.0)
    assert harness.reader("rebuild.render_ms")(traced) == pytest.approx(5.0)
    assert harness.reader("device.idle_share.rebuild")(traced) == \
        pytest.approx(100 * (1 - 10 / 40))
    # the other loops' readers find nothing in a rebuild, and the
    # rebuild's nothing in the others
    for name in ("mrays_s", "frame_ms_p95", "scene_build_ms",
                 "build.tree_ms", "wide_treelet.cut_ms",
                 "device.idle_share.build", "device.idle_share.render"):
        assert harness.reader(name)(traced) is None, name
    for kind in ("render", "build"):
        other = dict(traced, kind=kind)
        for name in ("rebuild_frame_ms", "rebuild_frame_ms_p95",
                     "rebuild.tree_ms", "rebuild.cut_ms",
                     "rebuild.render_ms", "device.idle_share.rebuild"):
            assert harness.reader(name)(other) is None, (kind, name)


def test_pinhole_poses_are_the_same_over_every_variant():
    """The rebuild draws its rays over variant 0: pinhole sets depend on
    the grid side alone, so they are every variant's."""
    _, _, config, traffic = tiny(CELL)
    a = rays.ray_sets(traffic["rays"], scenes.sponza_class(3000, 0, "cpu"),
                      4)
    b = rays.ray_sets(traffic["rays"],
                      scenes.sponza_class(3000, 0, "cpu", 1), 4)
    assert all(torch.equal(x, y) for s, t in zip(a, b) for x, y in zip(s, t))
