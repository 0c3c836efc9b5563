"""The program's spans and counters (`bvh_tpu_torch.core.trace`) in the
render and build paths, on the scene of tests/test_torch_wide_treelet.py
(sponza_class(3000, 3), a MEDIUM tree, 32x32 primary rays,
max_prims=256), built here by the port on the CPU.

- off (no profiler): no span is opened, no counter moves, and the hits
  are bit-equal to the same render under a profiler;
- on: the stage spans nest under bvh.render.attempt under bvh.render,
  and the counters equal what `return_diag` reports, also across a
  forced re-run and in a two-level cut;
- the builders' spans nest under bvh.build_default and
  bvh.build_wide_treelets;
- on the card: the spans stay off the device's track and add no device
  operation (`cuda` marker; it skips without a card).
"""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bvh_tpu_torch.build import reinsertion
from bvh_tpu_torch.build.default import DefaultConfig, Quality, build_default
from bvh_tpu_torch.cli.camera import primary_rays
from bvh_tpu_torch.core import trace
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
from bvh_tpu_torch.io.scenes import scene_camera, sponza_class
from bvh_tpu_torch.traverse import wide_treelet as wt

RENDER_STAGES = ("bvh.phase_a", "bvh.portal_sort", "bvh.ready",
                 "bvh.round_pairs", "bvh.b1", "bvh.merge_round")
CUT_SPANS = ("bvh.cut.readback", "bvh.cut.frontier", "bvh.cut.collapse",
             "bvh.cut.pack", "bvh.cut.top", "bvh.cut.upload")
REINSERTION_STAGES = ("bvh.parents", "bvh.candidates", "bvh.search",
                      "bvh.gain_sort", "bvh.accept", "bvh.apply",
                      "bvh.seeds", "bvh.refit")
MINITREE_STAGES = ("bvh.staging", "bvh.counts_readback", "bvh.pack_groups",
                   "bvh.b3", "bvh.assemble", "bvh.top_tree")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """At these sizes torch's intra-op threads gain nothing and contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    tris = sponza_class(3000, seed=3)
    tt = torch.from_numpy(tris)
    boxes = (tt.min(1).values, tt.max(1).values, tt.mean(1))
    bvh = build_default(*boxes, DefaultConfig(quality=Quality.MEDIUM))
    flat = PrecomputedTri.from_tri(Tri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
    eye, d, up = scene_camera(tris)
    return SimpleNamespace(
        boxes=boxes, bvh=bvh, flat=flat,
        tl=wt.build_wide_treelets(bvh, flat, max_prims=256),
        rays=primary_rays(eye, d, up, 32, 32, device="cpu"))


def traced(fn):
    """(fn(), the bvh.* spans as (name, start, end) by start, the
    counters' change) under a CPU profiler."""
    before = trace.counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    after = trace.counts()
    spans = sorted(((e.name(), e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("bvh.")), key=lambda s: s[1])
    delta = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0) or k.startswith("wide_treelet.")}
    return out, spans, delta


def named(spans, *names):
    return [s for s in spans if s[0] in names]


def inside(span, outer) -> bool:
    """Whether `span` lies within one of the spans `outer`."""
    return any(o[1] <= span[1] and span[2] <= o[2] for o in outer)


def render(scene, tl=None, **kw):
    return wt.wide_treelet_intersect_tris(
        scene.tl if tl is None else tl, scene.rays,
        prim_ids=scene.bvh.prim_ids, return_diag=True, **kw)


def bits(hit):
    return [x.view(torch.int32) if x.dtype == torch.float32 else x
            for x in (hit.t, hit.u, hit.v, hit.prim_id)]


def test_switch_follows_the_profiler():
    assert not trace.on()
    assert trace.span("bvh.a") is trace.span("bvh.b")    # one null context
    before = trace.counts()
    trace.count("test.switch", 5)
    assert trace.counts() == before
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.on()
        trace.count("test.switch", 5)
        trace.count("test.switch", 2)
    assert not trace.on()
    got = trace.counts()
    assert got["test.switch"] - before.get("test.switch", 0) == 7
    got["test.switch"] = -1                    # a copy: the counter holds
    assert trace.counts()["test.switch"] != -1


@pytest.mark.parametrize("any_hit", [False, True])
def test_off_opens_no_span_and_counts_nothing(scene, monkeypatch, any_hit):
    (want, _), spans, _ = traced(lambda: render(scene, any_hit=any_hit))
    assert spans

    def refuse(name):
        raise AssertionError(f"span {name} opened with tracing off")

    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    before = trace.counts()
    got, diag = render(scene, any_hit=any_hit)
    assert trace.counts() == before
    assert diag["rounds"] > 0
    for a, b in zip(bits(got), bits(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("any_hit", [False, True])
def test_on_spans_nest_and_counters_equal_the_diag(scene, any_hit):
    (_, diag), spans, delta = traced(lambda: render(scene, any_hit=any_hit))
    rounds = diag["rounds"]
    assert rounds > 0
    assert len(named(spans, "bvh.b1")) == rounds
    assert len(named(spans, "bvh.ready")) == rounds + 1   # the last finds none
    assert delta == {"wide_treelet.calls": 1, "wide_treelet.attempts": 1,
                     "wide_treelet.rounds": rounds,
                     "wide_treelet.pairs": diag["pairs"],
                     "wide_treelet.a2_rounds": 0,
                     "wide_treelet.a2_pairs": 0,
                     "wide_treelet.rays": scene.rays.tmin.shape[0],
                     "wide_treelet.rerun_rays": 0}
    outer = named(spans, "bvh.render")
    attempts = named(spans, "bvh.render.attempt")
    assert len(outer) == 1 and len(attempts) == 1
    assert inside(attempts[0], outer)
    stages = named(spans, *RENDER_STAGES)
    assert {s[0] for s in stages} == set(RENDER_STAGES)
    assert all(inside(s, attempts) for s in stages)


def test_forced_rerun_counts_every_attempt(scene, monkeypatch):
    want, _ = render(scene)
    rays, rounds = [], []
    prepare, pair_rounds = wt._prepare, wt._pair_rounds

    def counted_prepare(tl, packed, **kwargs):
        rays.append(packed.shape[1])
        return prepare(tl, packed, **kwargs)

    def counted_rounds(*args, **kwargs):
        diag = args[4]
        before = diag["rounds"]
        out = pair_rounds(*args, **kwargs)
        rounds.append(diag["rounds"] - before)
        return out

    monkeypatch.setattr(wt, "_prepare", counted_prepare)
    monkeypatch.setattr(wt, "_pair_rounds", counted_rounds)
    (got, diag), spans, delta = traced(
        lambda: render(scene, max_portals=1, auto_caps=True))
    assert len(rays) >= 2 and diag["caps"]["max_portals"] > 1
    assert delta["wide_treelet.calls"] == 1
    assert delta["wide_treelet.attempts"] - delta["wide_treelet.calls"] == \
        len(rays) - 1
    assert delta["wide_treelet.rounds"] == sum(rounds) == diag["rounds"]
    assert delta["wide_treelet.rerun_rays"] == sum(rays[1:])
    assert len(named(spans, "bvh.render.attempt")) == len(rays)
    for a, b in zip(bits(got), bits(want)):
        assert torch.equal(a, b)


def test_two_level_a2_round_spans(scene):
    tl = wt.build_wide_treelets(scene.bvh, scene.flat, max_prims=128,
                                super_prims=512)
    assert tl.sup_cols.shape[0] > 0
    (_, diag), spans, delta = traced(lambda: render(scene, tl))
    assert delta["wide_treelet.attempts"] == 1
    assert diag["a2_rounds"] > 0
    rounds = named(spans, "bvh.a2_round")
    assert len(rounds) == diag["a2_rounds"] == \
        delta["wide_treelet.a2_rounds"]
    phase = named(spans, "bvh.phase_a2")
    assert len(phase) == 1 and all(inside(r, phase) for r in rounds)
    assert inside(phase[0], named(spans, "bvh.render.attempt"))


def test_build_spans_nest(scene):
    config = DefaultConfig(quality=Quality.HIGH)
    want = build_default(*scene.boxes, config)
    got, spans, _ = traced(lambda: build_default(*scene.boxes, config))
    assert torch.equal(got.bounds, want.bounds)
    assert torch.equal(got.index, want.index)
    top = named(spans, "bvh.build_default")
    mini = named(spans, "bvh.minitree")
    reins = named(spans, "bvh.reinsertion")
    assert len(top) == len(mini) == len(reins) == 1
    assert inside(mini[0], top) and inside(reins[0], top)
    iters = named(spans, "bvh.reinsertion.iteration")
    n = reinsertion.ReinsertionConfig().max_iter_count
    assert len(iters) == n and all(inside(s, reins) for s in iters)
    for name in REINSERTION_STAGES:
        stage = named(spans, name)
        assert len(stage) == n and all(inside(s, iters) for s in stage)
    for name in MINITREE_STAGES:
        stage = named(spans, name)
        assert len(stage) == 1 and inside(stage[0], mini)


def test_cut_spans_in_order(scene):
    kw = dict(max_prims=128, super_prims=512)
    want = wt.build_wide_treelets(scene.bvh, scene.flat, **kw)
    got, spans, _ = traced(
        lambda: wt.build_wide_treelets(scene.bvh, scene.flat, **kw))
    for a, b in zip(got, want):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    whole = named(spans, "bvh.build_wide_treelets")
    parts = named(spans, *CUT_SPANS)
    assert len(whole) == 1
    assert [s[0] for s in parts] == list(CUT_SPANS)
    assert all(inside(s, whole) for s in parts)


@pytest.mark.cuda
def test_spans_add_no_device_operation(scene, monkeypatch):
    """Under CPU and CUDA activity no device-track event is a bvh.*
    span, and the device operations that the benchmark's trace reader
    finds in a frame are those of the same frame traced without the
    program's spans: the render's kernels, copies and sets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType

    from raybench import tracing

    tl = wt.build_wide_treelets(scene.bvh, scene.flat, max_prims=256,
                                device="cuda")
    rays = Ray(*(x.cuda() for x in scene.rays))
    prim_ids = scene.bvh.prim_ids.cuda()

    def frame():
        with record_function(tracing.SPAN_FRAME):
            wt.wide_treelet_intersect_tris(tl, rays, prim_ids=prim_ids)
            torch.cuda.synchronize()

    def traced_frame():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            frame()
        raw = [e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        return tracing.from_profiler(prof), raw

    frame()                                    # builds the kernels
    with_spans, raw = traced_frame()
    assert not [n for n in raw if n.startswith("bvh.")]
    assert {"bvh.render", "bvh.walk"} <= {o.name for o in with_spans.host}
    monkeypatch.setattr(trace, "on", lambda: False)
    without, _ = traced_frame()
    assert not [o for o in without.host if o.name.startswith("bvh.")]
    n = len(with_spans.device_in(tracing.SPAN_FRAME))
    assert n == len(without.device_in(tracing.SPAN_FRAME)) > 0


@pytest.mark.parametrize("levels", ["one", "two"])
def test_portal_sorts_count_every_ordering(scene, levels):
    """The portal orderings are counted by the attempts and the A2 rounds:
    one sort an attempt, forced re-runs included, and in a two-level cut
    one merge an A2 round; wide_treelet.attempts and .a2_rounds equal
    what the diag reports."""
    if levels == "one":
        (_, diag), _, delta = traced(
            lambda: render(scene, max_portals=1, auto_caps=True))
        assert delta["wide_treelet.attempts"] >= 2
        assert delta["wide_treelet.a2_rounds"] == 0
    else:
        tl = wt.build_wide_treelets(scene.bvh, scene.flat, max_prims=128,
                                    super_prims=512)
        (_, diag), _, delta = traced(lambda: render(scene, tl))
        assert delta["wide_treelet.a2_rounds"] > 0
    assert delta["wide_treelet.attempts"] == diag["attempts"]
    assert delta["wide_treelet.a2_rounds"] == diag.get("a2_rounds", 0)
    assert delta["wide_treelet.a2_pairs"] == diag.get("a2_pairs", 0)
