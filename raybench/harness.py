"""One run of one cell of `BENCHMARK.json`: set-up, the measured
window, the check against the reference, and the result line.

Everything a cell needs is found by name: the cell in `BENCHMARK.json`
names its configuration (`configs/<config>.json`, through the
configuration's `file`) and its traffic (`traffic/<traffic>.json`), and
each metric is read by `metrics/<metric name>.py`. The traffic's `kind`
picks the loop:

- "render": one scene build, then frames in a closed loop, one in
  flight: a frame is one call of the port's
  `wide_treelet_intersect_tris` on the next ray set, then
  `torch.cuda.synchronize()`;
- "build": scene variants made in set-up, then scene builds in a
  closed loop, each on the next variant: the port's `build_default`,
  then `build_wide_treelets`, synchronised;
- "rebuild": a dynamic scene's frames in a closed loop, one in flight:
  each frame builds and cuts the next scene variant, as "build" does,
  then renders its ray set through the new tree, as "render" does, and
  drops the tree before the next frame builds.

The program is called through its public entries only, with no tuning
key but the configuration's `build_quality` (`build_default`'s quality:
low, medium or high) and the cut's `max_prims`.
"""

from __future__ import annotations

import importlib.util
import json
import os
import random
import sys
import time
import traceback
from collections import defaultdict

import torch

from raybench import counts, judge, rays, scenes, tracing
from raybench.reference import tree as tree_check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
CHECK_STREAM = 300
FORBIDDEN = ("jax", "jaxlib", "flax", "bvh_tpu")
QUALITIES = ("low", "medium", "high")   # build_default's Quality values


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell(workload: str):
    """(manifest, workload entry, configuration, traffic) of a cell."""
    manifest = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    wl = {w["name"]: w for w in manifest["workloads"]}[workload]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[wl["config"]]
    config = load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     wl["traffic"] + ".json"))
    return manifest, wl, config, traffic


def metrics_of(manifest: dict, workload: str, trace: bool) -> list:
    """The metric entries the cell reports: with `trace` its per-layer
    metrics, else its end-to-end ones (those without a `workloads` key
    are every cell's)."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The `read(ctx)` of `metrics/<name>.py`."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "raybench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the run must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def stage(ctx, name: str) -> None:
    """Log the host-clock seconds since the last stage of set-up."""
    now = time.perf_counter()
    log(f"setup {name} {now - ctx.get('mark', ctx['t0']):.3f} s")
    ctx["mark"] = now


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_memory(device) -> int:
    """The process's peak of allocated device memory so far."""
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


def release(device) -> None:
    """Give the program's freed blocks back before the reference runs."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def build_quality(config: dict) -> str:
    """The configuration's `build_quality`; a ValueError that names it
    if it is not one of `QUALITIES`."""
    quality = config.get("build_quality")
    if quality not in QUALITIES:
        raise ValueError(f"configuration {config.get('name')!r}: "
                         f"build_quality {quality!r} is not one of "
                         f"{', '.join(QUALITIES)}")
    return quality


# ------------------------------------------------------- the program
def scene_build(tris, config: dict, spans=None):
    """Triangles on the card -> (tree, treelet scene), through the
    port's public entries: `build_default` at the configuration's
    `build_quality`, then `build_wide_treelets` at its `max_prims`,
    each in a span and synchronised. `spans`, if given, gets each
    stage's host-clock seconds under its span name."""
    from torch.profiler import record_function

    from bvh_tpu_torch.build import default
    from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
    from bvh_tpu_torch.traverse import wide_treelet as wt

    t0 = time.perf_counter()
    with record_function(tracing.SPAN_SCENE):
        tri = Tri(*(tris[:, i] for i in range(3)))
        with record_function(tracing.SPAN_TREE):
            bb_min, bb_max = tri.get_bbox()
            bvh = default.build_default(
                bb_min, bb_max, tri.get_center(),
                default.DefaultConfig(
                    quality=default.Quality(build_quality(config))))
            sync(tris.device)
        t1 = time.perf_counter()
        with record_function(tracing.SPAN_CUT):
            flat = PrecomputedTri.from_tri(tri).as_flat()
            tl = wt.build_wide_treelets(bvh, flat,
                                        max_prims=config["max_prims"])
            sync(tris.device)
    if spans is not None:
        spans[tracing.SPAN_TREE].append(t1 - t0)
        spans[tracing.SPAN_CUT].append(time.perf_counter() - t1)
    return bvh, tl


def render(tl, bvh, ray, any_hit: bool):
    """One frame: the port's render entry on a ray set, synchronised."""
    from torch.profiler import record_function

    from bvh_tpu_torch.core.ray import Ray
    from bvh_tpu_torch.traverse import wide_treelet as wt

    with record_function(tracing.SPAN_FRAME):
        with record_function(tracing.SPAN_RENDER):
            hit = wt.wide_treelet_intersect_tris(
                tl, Ray(*ray), prim_ids=bvh.prim_ids, any_hit=any_hit)
        sync(ray[0].device)
    return hit


def cut_levels(tl, config: dict) -> None:
    """A RuntimeError where the cut's levels are not the configuration's
    `two_level`."""
    supers = int(tl.sup_cols.shape[0])
    if supers == 0 and config.get("two_level"):
        raise RuntimeError("the configuration states a two-level cut, and "
                           "the cut has no supers")
    if supers and not config.get("two_level"):
        raise RuntimeError(f"the configuration states a one-level cut, and "
                           f"the cut has {supers} supers")


def table_bytes(tl) -> int:
    return sum(x.numel() * x.element_size()
               for x in (tl.top_node_t, tl.table_cols, tl.sup_cols))


# ----------------------------------------------------------- the loops
class Window:
    """Host-clock times of a closed loop, the host-clock spans its steps
    record, and a seeded reservoir of `keep` of its results."""

    def __init__(self, keep: int, seed: int):
        self.durations, self.work, self.kept = [], [], []
        self.spans = defaultdict(list)
        self.failed = 0
        self.keep = keep
        self.rng = random.Random(seed)

    def offer(self, item) -> None:
        i = len(self.durations) - 1
        if len(self.kept) < self.keep:
            self.kept.append(item)
        else:
            j = self.rng.randrange(i + 1)
            if j < self.keep:
                self.kept[j] = item


def loop(step, count_or_seconds, win: Window, trace: bool):
    """Run `step(i, win.spans)` -> (work, item) in a closed loop for a
    number of steps (trace) or seconds; returns the window's seconds."""
    t_open = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        try:
            work, item = step(i, win.spans)
        except Exception:  # noqa: BLE001 - a failed step is counted
            win.failed += 1
            work, item = 0, None
            log(traceback.format_exc())
        t1 = time.perf_counter()
        win.durations.append(t1 - t0)
        win.work.append(work)
        if item is not None:
            win.offer(item)
        i += 1
        if (i >= count_or_seconds) if trace else (
                t1 - t_open >= count_or_seconds):
            return t1 - t_open


def measure(step, win: Window, traffic, seconds, trace, ctx) -> None:
    """The window: `seconds` of steps, or with `trace` the traffic's
    trace steps under the profiler. Where the traffic names
    `plain_steps`, that many untraced steps run first: their host-clock
    spans, and no span taken under the profiler, are `ctx["spans"]`."""
    if not trace:
        ctx["window_s"] = loop(step, seconds, win, False)
        return
    plain = traffic["trace"].get("plain_steps", 0)
    if plain:
        pre = Window(0, 0)
        loop(step, plain, pre, True)
        win.failed += pre.failed
        ctx["spans"] = pre.spans
    ctx["window_s"], ctx["trace"] = profiled(
        lambda: loop(step, traffic["trace"]["steps"], win, True))


def profiled(fn):
    """(result of fn(), `tracing.Trace`) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
    return out, tracing.from_profiler(prof)


def check_rays(traffic: dict, n_tris: int) -> int:
    c = traffic["check"]
    return int(max(c["min_rays"], min(c["max_rays"], c["pairs"] // n_tris)))


def check_frames(kept, ray_sets, tris, traffic, seed, any_hit,
                 answer=None, frames=None):
    """The judge's numbers over a seeded sample of rays of each kept
    frame (set index, t, triangle id). `answer(rays)`, if given, stands
    in for the program: it answers the sampled rays itself. The check's
    rays are shared by `frames` frames (by default the kept ones)."""
    g = scenes.generator(seed, CHECK_STREAM, tris.device)
    per = max(1, check_rays(traffic, tris.shape[0])
              // max(1, frames or len(kept)))
    parts = []
    for k, t, prim in kept:
        ray = ray_sets[k]
        R = ray[0].shape[0]
        idx = torch.randperm(R, generator=g, device=tris.device)[:per]
        sub = tuple(x[idx] for x in ray)
        t_s, p_s = answer(sub) if answer else (t[idx], prim[idx])
        parts.append(judge.judge(tris, sub, t_s, p_s, any_hit=any_hit))
    return judge.merge(parts)


def run_render(config, traffic, seed, seconds, trace, device, ctx):
    # the configuration's one fixed scene; the seed makes the rays
    tris = scenes.sponza_class(config["n_tris"], config["scene_seed"], device)
    stage(ctx, "scene")
    bvh, tl = scene_build(tris, config)
    stage(ctx, "build")
    supers = int(tl.sup_cols.shape[0])
    if supers == 0 and config.get("two_level"):
        raise RuntimeError("the configuration states a two-level cut, and "
                           "the cut has no supers")
    if supers and not config.get("two_level"):
        raise RuntimeError(f"the configuration states a one-level cut, and "
                           f"the cut has {supers} supers")
    ray_sets = rays.ray_sets(traffic["rays"], tris, seed)
    any_hit = bool(traffic["any_hit"])
    stage(ctx, "rays")
    for ray in ray_sets:                       # warm up every ray set
        render(tl, bvh, ray, any_hit)
    stage(ctx, "warm-up")
    ctx["setup_s"] = time.perf_counter() - ctx["t0"]

    def step(i, spans):
        k = i % len(ray_sets)
        hit = render(tl, bvh, ray_sets[k], any_hit)
        return ray_sets[k][0].shape[0], (k, hit.t, hit.prim_id)

    win = Window(traffic["check"]["frames"], seed)
    measure(step, win, traffic, seconds, trace, ctx)
    ctx["memory_peak_bytes"] = peak_memory(device)
    ctx["work"] = counts.render_work(ray_sets[0][0].shape[0], tris.shape[0],
                                     table_bytes(tl))
    ctx.update(durations=win.durations, done=win.work, failed=win.failed)
    del tl, bvh
    release(device)
    return check_frames(win.kept, ray_sets, tris, traffic, seed, any_hit)


def run_build(config, traffic, seed, seconds, trace, device, ctx):
    variants = [scenes.sponza_class(config["n_tris"], seed, device, v)
                for v in range(traffic["variants"])]
    stage(ctx, "scenes")
    scene_build(variants[-1], config)      # warm up
    stage(ctx, "warm-up")
    ctx["setup_s"] = time.perf_counter() - ctx["t0"]
    last = {}

    def step(i, spans):
        k = i % len(variants)
        bvh, tl = scene_build(variants[k], config, spans)
        last.update(k=k, bvh=bvh, tl=tl)
        return 1, None

    win = Window(0, seed)
    measure(step, win, traffic, seconds, trace, ctx)
    ctx["memory_peak_bytes"] = peak_memory(device)
    ctx.update(durations=win.durations, done=win.work, failed=win.failed)
    # the last tree, and one frame traced through it by the render entry
    tris = variants[last["k"]]
    bvh, tl = last["bvh"], last["tl"]
    numbers = tree_check.check_tree(bvh.bounds, bvh.index, bvh.prim_ids,
                                    int(bvh.node_count), tris)
    ray_sets = rays.ray_sets(traffic["check"]["rays"], tris, seed)
    hit = render(tl, bvh, ray_sets[0], False)
    kept = [(0, hit.t, hit.prim_id)]
    del tl, bvh, hit, last["bvh"], last["tl"]
    release(device)
    numbers.update(check_frames(kept, ray_sets, tris, traffic, seed, False))
    return numbers


def rebuild_inputs(config, traffic, seed, device):
    """(variants, ray_sets, order) of a rebuild cell: the configuration's
    `variants` scenes, drawn from its `scene_seed` so that every run
    builds the same ones; the traffic's ray sets in the order the seed's
    frames visit them; and `order[j]`, the variant that ray set j is
    traced through. The k-th variant goes with the k-th ray set, and the
    seed orders the pairs. The sets are drawn over variant 0's scene:
    pinhole poses depend only on the grid side, which every variant
    shares."""
    count = int(traffic["variants"])
    variants = [scenes.sponza_class(config["n_tris"], config["scene_seed"],
                                    device, v) for v in range(count)]
    ray_sets = rays.ray_sets(traffic["rays"], variants[0], seed)
    if len(ray_sets) != count:
        raise ValueError(f"traffic {traffic.get('name')!r}: {count} "
                         f"variants and {len(ray_sets)} ray sets; a "
                         f"rebuild pairs each variant with one set")
    return variants, ray_sets, rays.in_order(list(range(count)), seed)


def check_rebuild(kept, ray_sets, variants, traffic, seed, any_hit,
                  answer=None):
    """`check_frames` over the kept frames (variant, set index, t,
    triangle id), each judged against its own variant's triangles, one
    variant at a time, merged. `answer(tris, rays)`, if given, stands in
    for the program."""
    parts = []
    for v in sorted({item[0] for item in kept}):
        tris = variants[v]
        mine = [item[1:] for item in kept if item[0] == v]
        own = None if answer is None else (
            lambda sub, tris=tris: answer(tris, sub))
        parts.append(check_frames(mine, ray_sets, tris, traffic, seed,
                                  any_hit, answer=own, frames=len(kept)))
    return judge.merge(parts)


def run_rebuild(config, traffic, seed, seconds, trace, device, ctx):
    from torch.profiler import record_function

    variants, ray_sets, order = rebuild_inputs(config, traffic, seed,
                                               device)
    any_hit = bool(traffic["any_hit"])
    stage(ctx, "scenes and rays")
    last = {}

    def frame(j, spans=None):
        last.clear()           # the previous frame's tree goes first
        with record_function(tracing.SPAN_REBUILD):
            bvh, tl = scene_build(variants[order[j]], config, spans)
            cut_levels(tl, config)
            t0 = time.perf_counter()
            hit = render(tl, bvh, ray_sets[j], any_hit)
        if spans is not None:
            spans[tracing.SPAN_FRAME].append(time.perf_counter() - t0)
        last.update(v=order[j], bvh=bvh)
        return hit

    frame(len(ray_sets) - 1)                   # warm up: one whole frame
    stage(ctx, "warm-up")
    ctx["setup_s"] = time.perf_counter() - ctx["t0"]

    def step(i, spans):
        j = i % len(ray_sets)
        hit = frame(j, spans)
        return ray_sets[j][0].shape[0], (order[j], j, hit.t, hit.prim_id)

    win = Window(traffic["check"]["frames"], seed)
    measure(step, win, traffic, seconds, trace, ctx)
    ctx["memory_peak_bytes"] = peak_memory(device)
    ctx.update(durations=win.durations, done=win.work, failed=win.failed)
    numbers = {"tree_bad_prims": 0, "tree_bad_boxes": 0}
    if last:                                   # the last frame's tree
        bvh = last.pop("bvh")
        numbers = tree_check.check_tree(bvh.bounds, bvh.index, bvh.prim_ids,
                                        int(bvh.node_count),
                                        variants[last["v"]])
        del bvh
    release(device)
    numbers.update(check_rebuild(win.kept, ray_sets, variants, traffic,
                                 seed, any_hit))
    return numbers


LOOPS = {"render": run_render, "build": run_build, "rebuild": run_rebuild}
# the span whose window a trace run's busy seconds and breakdown cover
BUSY_SPAN = {"render": tracing.SPAN_FRAME, "build": tracing.SPAN_SCENE,
             "rebuild": tracing.SPAN_REBUILD}


def loop_of(traffic: dict):
    """The loop of the traffic's `kind`; a ValueError that names it if
    there is none."""
    kind = traffic.get("kind")
    if kind not in LOOPS:
        raise ValueError(f"traffic {traffic.get('name')!r}: kind {kind!r} "
                         f"is not one of {', '.join(LOOPS)}")
    return LOOPS[kind]


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float | None = None,
             cell_data=None) -> dict:
    """One run of a cell; returns the result object. `cell_data` stands
    in for (manifest, workload entry, configuration, traffic) as
    `cell` reads them."""
    ctx = {"t0": time.perf_counter() if t0 is None else t0,
           "spans": {}}
    manifest, wl, config, traffic = cell_data or cell(workload)
    build_quality(config)                      # refused before any build
    run = loop_of(traffic)
    ctx.update(kind=traffic["kind"], config=config, traffic=traffic)
    stage(ctx, "start")
    import bvh_tpu_torch.build.default  # noqa: F401 - the program's import
    import bvh_tpu_torch.traverse.wide_treelet  # noqa: F401
    stage(ctx, "program import")
    numbers = run(config, traffic, seed, seconds, trace, device, ctx)
    limits = traffic["check"]["limits"]
    correct = judge.verdict(numbers, limits) and ctx["failed"] == 0
    cuda = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    ctx["peak"] = counts.peaks(kind)
    metrics = {}
    for m in metrics_of(manifest, workload, trace):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": wl["chips"], "memory_peak_bytes": ctx["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": len(ctx["durations"]),
           "failed": ctx["failed"], "metrics": metrics, "device": dev}
    if trace:
        span = BUSY_SPAN[traffic["kind"]]
        bw = tracing.busy_window(ctx["trace"], span)
        dev["busy_s"], dev["window_s"] = bw if bw else (0.0, 0.0)
        out["breakdown"] = tracing.breakdown(ctx["trace"], span)
    out["check"] = {k: {"value": v, "limit": limits[k]}
                    for k, v in numbers.items()}
    return out


def main(argv=None, t0: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="raybench/run.py",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    data = cell(args.workload)
    chips = data[1]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"raybench: the cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " found")
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", t0=t0, cell_data=data)
    bad = forbidden_modules()
    if bad:
        log(f"raybench: the run loaded {', '.join(bad)}")
        return 3
    for k, v in out["check"].items():
        log(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(out), flush=True)
    return 0
