"""The render driver's re-runs: only the rays past a cap are rendered
again, at caps raised for them, and every hit equals, bit for bit, that
of one attempt at caps that nothing overflows.

On the CPU, with the kernels' plain versions: raybench's box grid of
3,000 triangles (seed 3), a MEDIUM tree cut one-level at max_prims 128
and two-level at max_prims 128 under supers of 512, and 512 diffuse
(closest hit) and 512 shadow (any hit) rays from raybench's generators.
Each case starts from one cap small enough that its overflow fires on
some rays: phase A's max_portals and stack, A2's mps (bit 1), max_new
(bit 2) and merged max_portals (bit 4), B1's stack, max_rounds.

- the hits (t, u, v, position) equal one attempt at generous caps bit
  for bit; each later attempt renders exactly the rays the one before
  left past a cap, at caps never lowered, so no ray within its caps is
  rendered twice, and one round loop traces every list that fits;
- against the float64 brute force of `raybench/reference`, the hits are
  within the benchmark cells' limits (`raybench/judge.py`);
- the counter wide_treelet.rerun_rays equals the overflowed rays summed
  over the attempts;
- one `render_at_caps` at the first attempt's caps reports under
  "overflow" exactly the rays that the second attempt renders, and
  every other ray's hit equals the generous attempt's;
- `auto_caps=False` raises on the first overflow, and no ninth attempt
  is made;
- a render that overflows nothing makes one attempt, with the stage
  calls of the whole-frame driver, and opens no bvh.render.rerun span.

On the card (`cuda` marker; they skip without one): the same equality
on the benchmark's box-grid scenes at 262K and 10M triangles, at both
10M cuts, and the 262K interior cell's launches and host syncs a frame.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bvh_tpu_torch.build.default import DefaultConfig, Quality, build_default
from bvh_tpu_torch.core import trace
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.core.types import INVALID_PRIM_ID
from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
from bvh_tpu_torch.traverse import wide_treelet as wt
from raybench import judge, rays, scenes

# The benchmark cells' limits (raybench/traffic/*.json): a hit that
# cannot be one is a fault, so `wrong_hits` is exact; a float32 test may
# miss a hit that lies on an edge or a bound, so a few `late_hits` are
# rounding; `t_gap` counts the float32 error bounds between a t and its
# float64 t, and a correct float32 test stays well inside 100 of them.
LIMITS = {"wrong_hits": 0, "late_hits": 3, "t_gap": 100.0}
R = 512
SPECS = {
    "diffuse": dict(kind="diffuse", count=R, sets=1, tmin=0.01, ray_seed=0),
    "shadow": dict(kind="shadow", count=R, sets=1, lights=16,
                   light_height=[10.0, 14.0], tmin=1e-4, ray_seed=0),
}
ANY_HIT = {"diffuse": False, "shadow": True}
# caps that no ray of these scenes comes near
GENEROUS = dict(top_stack=64, stack_depth=256, max_portals=1024,
                max_rounds=4096, mps=256, max_new=256, sup_stack=64)
# the one small cap of each case (None: set from the scene, below)
CASES = {"max_portals": dict(max_portals=2), "top_stack": dict(top_stack=1),
         "stack_depth": dict(stack_depth=1), "max_rounds": dict(max_rounds=1),
         "mps": dict(mps=1), "max_new": dict(max_new=1),
         "a2_max_portals": None}
TWO_LEVEL_ONLY = ("mps", "max_new", "a2_max_portals")
# the first attempt's flag that each case sets
FLAG = {"max_portals": lambda d: d["max_cnt"] > d["caps"]["max_portals"],
        "top_stack": lambda d: d["top_ovf"],
        "stack_depth": lambda d: d["stack_ovf"],
        "max_rounds": lambda d: d["pending"],
        "mps": lambda d: d["a2_bits"] & 1,
        "max_new": lambda d: d["a2_bits"] & 2,
        "a2_max_portals": lambda d: d["a2_bits"] & 4}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """At these sizes torch's intra-op threads gain nothing and contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """The scene, its two cuts and the ray sets, on the CPU."""
    tris = scenes.sponza_class(3000, 3, "cpu")
    tri = Tri(tris[:, 0], tris[:, 1], tris[:, 2])
    bb_min, bb_max = tri.get_bbox()
    bvh = build_default(bb_min, bb_max, tri.get_center(),
                        DefaultConfig(quality=Quality.MEDIUM))
    flat = PrecomputedTri.from_tri(tri).as_flat()
    cuts = {"one": wt.build_wide_treelets(bvh, flat, max_prims=128),
            "two": wt.build_wide_treelets(bvh, flat, max_prims=128,
                                          super_prims=512)}
    assert cuts["one"].sup_cols.shape[0] == 0
    assert cuts["two"].sup_cols.shape[0] > 1
    ray_sets = {k: Ray(*rays.ray_sets(spec, tris, 0)[0])
                for k, spec in SPECS.items()}
    return dict(tris=tris, bvh=bvh, cuts=cuts, rays=ray_sets)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def one_attempt(tl, ray, caps, any_hit):
    """(t, u, v, prim_pos) of one `render_at_caps` at `caps`, which must
    fit every ray."""
    t, u, v, pos, _, diag = wt.render_at_caps(tl, wt.pack_rays(ray), caps,
                                              any_hit=any_hit, robust=False)
    assert diag["overflow"] is None
    return t, u, v, torch.where(pos < 0, INVALID_PRIM_ID, pos)


def first_caps(tl, caps):
    """The caps of the entry point's first attempt: its defaults, with the
    case's `caps` in their place."""
    auto = wt.wide_treelet_caps(tl, wt.portals_per_round(tl))
    return {"top_stack": tl.top_depth + 1,
            "stack_depth": 7 * tl.wide_depth + 8,
            "sup_stack": tl.sup_depth + 1,
            **{k: auto[k] for k in ("max_portals", "max_rounds", "mps",
                                    "max_new")}, **caps}


def assert_same(hit, want):
    for name, a, b in zip(("t", "u", "v", "prim_pos"),
                          (hit.t, hit.u, hit.v, hit.prim_pos), want):
        assert torch.equal(_bits(a), _bits(b)), name


@pytest.fixture
def attempts(monkeypatch):
    """What the driver does, in order: ("prepare", the attempt's packed
    rays, its caps, its diag, the mask of its rays past a phase-A or A2
    cap or None) for each attempt's phase A and A2, and ("rounds", the
    global indices of the rays past B1's stack or max_rounds or None)
    for each round loop. A prepare's diag gets the rounds' flags too."""
    seen = []
    prepare, rounds = wt._prepare, wt._pair_rounds

    def spy_prepare(tl, packed, **kw):
        out = prepare(tl, packed, **kw)
        portals, _, late, diag = out
        over = diag["overflow"]
        if late is not None:
            over = wt._spread(None if over is None else over.clone(),
                              packed.shape[1], portals.sel, late)
        seen.append(("prepare", packed, kw, diag, over))
        return out

    def spy_rounds(tl, portals, rays_c, dead, *a, **kw):
        best, late = rounds(tl, portals, rays_c, dead, *a, **kw)
        if late is not None and dead is not None:
            late = late & ~dead            # columns joined dead stay so
        seen.append(("rounds", None if late is None or not late.any()
                     else portals.sel[late]))
        return best, late if dead is None else late | dead

    monkeypatch.setattr(wt, "_prepare", spy_prepare)
    monkeypatch.setattr(wt, "_pair_rounds", spy_rounds)
    return seen


def prepared(seen):
    return [e for e in seen if e[0] == "prepare"]


def counted(fn):
    """(fn(), the change of the wide_treelet.* counters) under a CPU
    profiler."""
    before = trace.counts()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    after = trace.counts()
    return out, {k: v - before.get(k, 0) for k, v in after.items()}


def case_caps(world, level, kind, case):
    if CASES[case] is not None:
        return CASES[case]
    # phase A fits exactly, so only the merged lists can pass the cap
    tl = world["cuts"][level]
    _, diag = wt.wide_treelet_intersect_tris(
        tl, world["rays"][kind], any_hit=ANY_HIT[kind], return_diag=True,
        **{k: v for k, v in GENEROUS.items() if k != "sup_stack"})
    return dict(max_portals=diag["max_cnt"])


PARAMS = [(level, kind, case) for level in ("one", "two")
          for kind in SPECS for case in CASES
          if level == "two" or case not in TWO_LEVEL_ONLY]


@pytest.mark.parametrize("level, kind, case", PARAMS)
def test_rerun_equals_one_generous_attempt(world, attempts, level, kind,
                                           case):
    tl, ray, any_hit = world["cuts"][level], world["rays"][kind], ANY_HIT[kind]
    caps = case_caps(world, level, kind, case)
    caps_kw = ("top_stack", "max_portals", "mps", "max_new", "sup_stack")
    want = one_attempt(tl, ray, GENEROUS, any_hit)
    *at_caps, _, at_diag = wt.render_at_caps(
        tl, wt.pack_rays(ray), first_caps(tl, caps), any_hit=any_hit,
        robust=False)
    attempts.clear()
    (hit, diag), delta = counted(lambda: wt.wide_treelet_intersect_tris(
        tl, ray, prim_ids=world["bvh"].prim_ids, any_hit=any_hit,
        return_diag=True, **caps))
    assert_same(hit, want)

    preps = prepared(attempts)
    first = dict(preps[0][3], caps=dict(caps, **preps[0][2]))
    assert FLAG[case](first), "the case's cap did not overflow"
    assert 2 <= len(preps) <= 8 and diag["attempts"] == len(preps)
    assert attempts[-1][0] == "rounds" and attempts[-1][1] is None
    # each attempt after the first renders exactly the rays that the one
    # before left past a cap, at caps never lowered; no other ray again
    packed = wt.pack_rays(ray)
    idx = torch.arange(R)
    reruns = 0
    second = None           # the rays of the second attempt
    for event, nxt in zip(attempts, attempts[1:]):
        if nxt[0] == "rounds":
            assert event[0] == "prepare" and event[4] is None
            continue
        if event[0] == "prepare":
            assert event[4] is not None
            idx = idx[event[4]]
        else:
            idx = event[1]
        assert torch.equal(nxt[1], packed[:, idx])
        reruns += idx.numel()
        if second is None:
            second = idx
    for a, b in zip(preps, preps[1:]):
        for name, v in b[2].items():
            if name in caps_kw:
                assert v >= a[2][name], name
    assert delta["wide_treelet.rerun_rays"] == reruns == diag["rerun_rays"]
    assert delta["wide_treelet.rays"] == R
    assert delta["wide_treelet.attempts"] == len(preps)
    # one render_at_caps at the first attempt's caps reports exactly the
    # rays of the second attempt past a cap, and every other ray's hit
    over = torch.zeros(R, dtype=torch.bool)
    over[second] = True
    assert torch.equal(at_diag["overflow"], over)
    at_caps[3] = torch.where(at_caps[3] < 0, INVALID_PRIM_ID, at_caps[3])
    for name, a, b in zip(("t", "u", "v", "prim_pos"), at_caps, want):
        assert torch.equal(_bits(a)[~over], _bits(b)[~over]), name

    numbers = judge.judge(world["tris"], tuple(ray), hit.t, hit.prim_id,
                          any_hit=any_hit)
    assert judge.verdict(numbers, LIMITS), numbers
    assert int(torch.isfinite(hit.t).sum()) > R // 10


@pytest.mark.parametrize("case", sorted(CASES))
def test_fixed_caps_raise_on_the_first_overflow(world, attempts, case):
    caps = case_caps(world, "two", "diffuse", case)
    attempts.clear()
    with pytest.raises(ValueError, match="capacity overflow"):
        wt.wide_treelet_intersect_tris(world["cuts"]["two"],
                                       world["rays"]["diffuse"],
                                       auto_caps=False, **caps)
    assert len(prepared(attempts)) == 1


def test_never_a_ninth_attempt(world, monkeypatch):
    """An attempt that always reports every ray past phase A's stack: the
    driver stops at its eighth attempt and raises."""
    calls = []
    real = wt._prepare

    def stuck(tl, packed, **kw):
        out = real(tl, packed, **kw)
        calls.append(kw["top_stack"])
        out[3].update(top_ovf=True, overflow=torch.ones(
            packed.shape[1], dtype=torch.bool))
        return out

    monkeypatch.setattr(wt, "_prepare", stuck)
    with pytest.raises(ValueError, match="capacity overflow"):
        wt.wide_treelet_intersect_tris(world["cuts"]["one"],
                                       world["rays"]["diffuse"])
    assert len(calls) == 8
    assert calls == [calls[0] << i for i in range(8)]


@pytest.mark.parametrize("level", ["one", "two"])
@pytest.mark.parametrize("kind", sorted(SPECS))
def test_no_overflow_is_one_whole_attempt(world, monkeypatch, level, kind):
    """The stage calls of a render that overflows nothing: phase_a,
    portal_sort, phase_a2 (two-level), a round's ready, round_pairs, b1
    and merge_round, and the last ready, in one attempt over every ray,
    as the whole-frame driver made them; no re-run span, no re-run
    ray."""
    tl, ray = world["cuts"][level], world["rays"][kind]
    names = []

    def stage(name, fn, *a, **k):
        names.append(name)
        return fn(*a, **k)

    monkeypatch.setattr(wt, "run_stage", stage)
    spans = []
    before = trace.counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        hit, diag = wt.wide_treelet_intersect_tris(
            tl, ray, any_hit=ANY_HIT[kind], return_diag=True)
    after = trace.counts()
    spans = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("bvh.render")]
    head = ["phase_a", "portal_sort"] + (["phase_a2"] if level == "two"
                                         else [])
    rounds = diag["rounds"]
    assert rounds > 0
    assert names == head + ["ready", "round_pairs", "b1",
                            "merge_round"] * rounds + ["ready"]
    assert sorted(spans) == ["bvh.render", "bvh.render.attempt"]
    assert after["wide_treelet.rerun_rays"] == before.get(
        "wide_treelet.rerun_rays", 0)
    assert diag["attempts"] == 1 and diag["rerun_rays"] == 0
    assert_same(hit, one_attempt(tl, ray, diag["caps"], ANY_HIT[kind]))


# ------------------------------------------------------------ on the card
# (cell name, ray sets checked): every set of the 10M interior and the
# 262K shadow cells, the first 4 of the 10M diffuse cell at the library's
# cut, and one diffuse and one shadow set on each tree
CARD_CASES = {"262k_shadow": ("boxgrid_262k", "shadow", 16),
              "262k_diffuse": ("boxgrid_262k", "diffuse", 1),
              "10m_interior": ("boxgrid_10m", "interior", 16),
              "10m_shadow": ("boxgrid_10m", "shadow", 1),
              "10m_cut4096_diffuse": ("boxgrid_10m_cut4096", "diffuse", 4)}


@pytest.fixture(scope="module")
def card_scenes():
    """The benchmark's scenes built on the card as its harness builds
    them, at first use and kept: configuration name -> (configuration,
    triangles, tree, treelet scene)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from raybench import harness
    configs = {c["name"]: c for c in harness.load_json(
        f"{harness.ROOT}/BENCHMARK.json")["configs"]}
    built = {}

    def get(name):
        if name not in built:
            config = harness.load_json(f"{harness.ROOT}/"
                                       f"{configs[name]['file']}")
            tris = scenes.sponza_class(config["n_tris"],
                                       config["scene_seed"], "cuda")
            built[name] = (config, tris) + harness.scene_build(tris, config)
        return built[name]

    return get


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_rerun_equals_one_attempt_on_card(card_scenes, case):
    """The driver's hits on the benchmark's ray sets against one attempt
    at the caps its call ended at, which fit every ray."""
    from raybench import harness
    name, traffic, n_sets = CARD_CASES[case]
    _, tris, bvh, tl = card_scenes(name)
    spec = harness.load_json(f"{harness.HERE}/traffic/{traffic}.json")
    any_hit = bool(spec["any_hit"])
    for ray in rays.ray_sets(spec["rays"], tris, 0)[:n_sets]:
        ray = Ray(*ray)
        hit, diag = wt.wide_treelet_intersect_tris(
            tl, ray, prim_ids=bvh.prim_ids, any_hit=any_hit,
            return_diag=True)
        assert_same(hit, one_attempt(tl, ray, diag["caps"], any_hit))
        assert int(torch.isfinite(hit.t).sum()) > 0


@pytest.mark.cuda
def test_262k_interior_frame_launches_and_syncs(card_scenes):
    """The 262K interior cell's 16 ray sets as 16 traced frames, read by
    the benchmark's own metrics: 41 device operations and 5 host syncs a
    frame since the portal walk took over the pair rounds on the card
    (673 and 24.75 with the rounds; ledger, PRs 17, 18 and 20), since no
    frame of the cell overflows a cap."""
    from raybench import harness, tracing
    _, tris, bvh, tl = card_scenes("boxgrid_262k")
    spec = harness.load_json(f"{harness.HERE}/traffic/interior.json")
    sets = rays.ray_sets(spec["rays"], tris, 0)
    for ray in sets:
        harness.render(tl, bvh, ray, False)
    before = trace.counts()
    _, tr = harness.profiled(lambda: [harness.render(tl, bvh, ray, False)
                                      for ray in sets])
    after = trace.counts()
    ctx = {"kind": "render", "trace": tr}
    assert len(tr.spans[tracing.SPAN_FRAME]) == 16
    assert harness.reader("wide_treelet.launches_per_frame")(ctx) == 41.0
    assert harness.reader("wide_treelet.syncs_per_frame")(ctx) == 5.0
    assert after["wide_treelet.rerun_rays"] == before.get(
        "wide_treelet.rerun_rays", 0)
