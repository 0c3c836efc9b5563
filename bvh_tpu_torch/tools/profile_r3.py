"""Per-stage profile of the wide-treelet render (T2), the counterpart of
tools/profile_r3.py.

The JAX tool mirrored `_render_jit`'s stages one by one at the bench
configuration and timed each, chained inside one jit. Here the render's
own driver is timed: `wide_treelet.render_at_caps` runs every stage
through a runner, and `StageTimer` brackets each call with CUDA events,
so the stages are the driver's functions on their real inputs and
compose to the render's hits bit for bit:

- phase_a (kernel B2), portal_sort (compaction and the portal sort),
  phase_a2 (two-level scenes, kernel B4);
- per round: ready, round_pairs, b1 (kernel B1), merge_round.

It prints each stage's sum over a render (median of `reps` renders)
beside one whole render, and from one `torch.profiler` trace of a
render the device busy share, the device-op count and the host syncs.
The JAX tool's candidates (scatter-unsort, scatter-back, the 3-op sort
plus gather) are how the port's driver works already; the one that
still applies is timed as torch ops: the driver's stable pair sort plus
a gather of the pair rays, against one sort of a unique key that
carries the pair index.

    python -m bvh_tpu_torch.tools.profile_r3 [--n 262144] [--side 1024]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from bvh_tpu_torch.tools.timing import StageTimer, guard, log, same, sync, \
    timed
from bvh_tpu_torch.traverse import wide_treelet as wt

N_TRIS, SIDE = 262_144, 1024
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def bench_scene(n: int = N_TRIS, side: int = SIDE, device="cuda",
                seed: int = 0):
    """bench.py's configuration built by the port: sponza_class(n, seed),
    the quality-high tree (`build_minitree_fast`, `optimize_reinsertion`;
    prim boxes and centres in numpy on the host, as bench.py:88-90),
    its treelet tables and side x side primary rays from
    `scene_camera`. Returns (tl, rays, tree)."""
    from bvh_tpu_torch.build.minitree_fast import build_minitree_fast
    from bvh_tpu_torch.build.reinsertion import optimize_reinsertion
    from bvh_tpu_torch.cli.camera import primary_rays
    from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
    from bvh_tpu_torch.io.scenes import scene_camera, sponza_class

    tris = sponza_class(n, seed=seed)
    boxes = (tris.min(axis=1), tris.max(axis=1), tris.mean(axis=1))
    mn, mx, cc = (torch.from_numpy(a).to(device) for a in boxes)
    tree = optimize_reinsertion(build_minitree_fast(mn, mx, cc))
    tt = torch.from_numpy(tris)
    flat = PrecomputedTri.from_tri(Tri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
    tl = wt.build_wide_treelets(tree, flat, device=device)
    eye, d, up = scene_camera(tris)
    return tl, primary_rays(eye, d, up, side, side, device=device), tree


class Recorder:
    """A stage runner that keeps the arguments and output of each
    stage's first call (arguments as passed: the render may change
    some of them in place later) and the pair count of every B1 call."""

    def __init__(self):
        self.first: dict[str, tuple] = {}
        self.pairs: list[int] = []

    def __call__(self, name, fn, *args, **kwargs):
        out = fn(*args, **kwargs)
        self.first.setdefault(name, (args, kwargs, out))
        if name == "b1":
            self.pairs.append(int(args[1].numel()))
        return out


def hits_of(raw):
    """`render_at_caps`' raw output as the Hit's t, u, v and prim_pos."""
    from bvh_tpu_torch.core.types import INVALID_PRIM_ID

    bt, bu, bv, pos = raw[:4]
    missed = pos < 0
    return (torch.where(missed, float("inf"), bt), bu, bv,
            torch.where(missed, INVALID_PRIM_ID, pos))


def render_caps(tl, rays, *, any_hit=False, robust=False):
    """One render through the user's entry point: (its Hit, the caps it
    settled on, packed rays)."""
    hit, diag = wt.wide_treelet_intersect_tris(tl, rays, any_hit=any_hit,
                                               robust=robust,
                                               return_diag=True)
    return hit, diag["caps"], wt.pack_rays(rays)


def stage_profile(tl, rays, device, *, any_hit=False, robust=False,
                  reps: int = 3) -> dict:
    """Each stage's time summed over a render (median of `reps` renders,
    each through `StageTimer`), the stage sum, and one whole render
    (`render_at_caps` and `wide_treelet_intersect_tris`, median of
    `reps`). Raises unless the staged render equals the whole render bit
    for bit."""
    hit, caps, packed = render_caps(tl, rays, any_hit=any_hit, robust=robust)
    kw = dict(any_hit=any_hit, robust=robust)
    ref = wt.render_at_caps(tl, packed, caps, **kw)
    hit_fields = (hit.t, hit.u, hit.v, hit.prim_pos)
    if not same(hits_of(ref), hit_fields):
        raise AssertionError("render_at_caps differs from the render")
    timer = StageTimer(device)
    runs = []
    for _ in range(reps):
        out = wt.render_at_caps(tl, packed, caps, stage=timer, **kw)
        guard("staged render", hits_of(out), hit_fields)
        runs.append(timer.totals())
    stages = {name: statistics.median(r[name][0] for r in runs)
              for name in runs[0]}
    calls = {name: runs[0][name][1] for name in runs[0]}
    whole_ms = timed("render_at_caps", lambda: hits_of(wt.render_at_caps(
        tl, packed, caps, **kw)), hit_fields, device, reps)

    def entry():
        h = wt.wide_treelet_intersect_tris(tl, rays, **kw)
        return h.t, h.u, h.v, h.prim_pos

    entry_ms = timed("wide_treelet_intersect_tris", entry, hit_fields,
                     device, reps)
    auto = wt.wide_treelet_caps(tl, wt.portals_per_round(tl))
    raised = {k: (v, caps[k]) for k, v in auto.items() if caps[k] != v}
    res = dict(stages=stages, calls=calls, stage_sum=sum(stages.values()),
               whole_ms=whole_ms, entry_ms=entry_ms, caps=caps,
               raised_caps=raised, rounds=ref[5]["rounds"],
               pairs=ref[5]["pairs"], hits=int(torch.isfinite(hit.t).sum()))
    mode = "any-hit" if any_hit else "closest"
    log(f"# T2 stages of the {mode} render ({rays.tmin.numel()} rays, "
        f"{res['rounds']} rounds, {res['pairs']} pairs), ms summed over the "
        f"render, median of {reps}: "
        + ", ".join(f"{k} {v:.4f} ({calls[k]} calls)"
                    for k, v in stages.items())
        + f"; stage sum {res['stage_sum']:.4f}; whole render_at_caps "
        f"{whole_ms:.4f}, wide_treelet_intersect_tris {entry_ms:.4f}; "
        "staged hits == render's bit for bit; caps the entry point raised "
        f"past the scene's defaults after an overflow (default, used): "
        f"{raised or 'none'}")
    return res


def summarize_events(events) -> dict:
    """Counts of a profiler trace: device ops (kernels, copies, sets),
    the device's busy time (the union of their intervals) over the
    trace's span, device-to-host copies and host synchronizations."""
    from torch.autograd import DeviceType

    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    if not events:
        return dict(device_ops=0, busy_ms=0.0, span_ms=0.0, busy_share=None,
                    host_syncs=0, dtoh_copies=0)
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    busy, last = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if e > last:
            busy += e - max(s, last)
            last = e
    return dict(device_ops=len(dev), busy_ms=busy / 1e3, span_ms=span / 1e3,
                busy_share=busy / span if dev and span > 0 else None,
                host_syncs=sum(e.name in SYNC_CALLS for e in events
                               if e.device_type == DeviceType.CPU),
                dtoh_copies=sum("DtoH" in e.name for e in dev))


def trace_render(fn, device) -> dict:
    """`summarize_events` of one call of `fn` (after one warm-up) under
    torch.profiler, CPU and, on a CUDA device, CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    fn()
    sync(device)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        sync(device)
    res = summarize_events(prof.events())
    res["wall_ms"] = (time.perf_counter() - t0) * 1e3
    share = ("not measured (the trace holds no device op)"
             if res["busy_share"] is None else f"{res['busy_share']:.4f}")
    log(f"# T2 trace of one render: {res['device_ops']} device ops, busy "
        f"{res['busy_ms']:.4f} ms of a {res['span_ms']:.4f} ms trace span "
        f"(busy share {share}); {res['host_syncs']} host synchronizations, "
        f"{res['dtoh_copies']} device-to-host copies; {res['wall_ms']:.1f} "
        "ms wall under the profiler")
    return res


def sort_gather(key, pay, device, n: int = 5) -> dict:
    """The glue's pair sort at one width: a stable sort of `key` plus a
    gather of the [rows, L] payload `pay` (the driver's way), against one
    sort of the unique key (key << 32 | column), whose low bits carry
    the order; and the stable sort alone. Both orders must agree.
    Returns ms of each and the sorted payload."""
    iota = torch.arange(key.numel(), device=key.device)

    def stable():
        return pay[:, torch.sort(key, stable=True).indices]

    def unique_key():
        return pay[:, torch.sort((key << 32) | iota).values & 0xFFFFFFFF]

    ref = stable()
    return dict(out=ref,
                stable_sort_gather_ms=timed("stable sort + gather", stable,
                                            ref, device, n),
                unique_key_sort_gather_ms=timed("unique-key sort + gather",
                                                unique_key, ref, device, n),
                stable_sort_ms=timed("stable sort", lambda: torch.sort(
                    key, stable=True), torch.sort(key, stable=True), device,
                    n))


def pair_sort_candidates(rec: Recorder, device, n: int = 5) -> dict:
    """`sort_gather` on round 1's pairs: round_pairs' own keys
    (treelet * 8 + octant), put back in their order before the sort
    (pairs in (k, ray) order), and its [8, L] pair rays; the sorted rays
    must be the driver's."""
    args, _, out = rec.first["round_pairs"]
    octant, rsel = args[5], args[6]
    _, pk, pr, ptid, prays = out
    key_sorted = ptid.to(torch.int64) * wt.WIDTH + octant[rsel][pr]
    pre = torch.argsort(pk * rsel.numel() + pr)
    res = sort_gather(key_sorted[pre], prays[:, pre], device, n)
    guard("round-1 pair sort", res.pop("out"), prays)
    res["pairs"] = ptid.numel()
    log(f"# T2 round-1 pair sort, {res['pairs']} pairs: stable sort + "
        f"gather of the pair rays {res['stable_sort_gather_ms']:.4f} ms "
        f"(the sort alone {res['stable_sort_ms']:.4f}), one sort of a "
        f"unique key + gather {res['unique_key_sort_gather_ms']:.4f} ms")
    return res


def run(tl, rays, device, reps: int = 3) -> dict:
    """The stage profile of the closest-hit render, its trace, and the
    pair-sort candidates on round 1."""
    res = stage_profile(tl, rays, device, reps=reps)
    packed = wt.pack_rays(rays)
    res["trace"] = trace_render(lambda: wt.render_at_caps(
        tl, packed, res["caps"], any_hit=False, robust=False), device)
    if res["trace"]["busy_share"] is not None:
        log(f"# T2 device busy time over the render's time without the "
            f"profiler: {res['trace']['busy_ms'] / res['whole_ms']:.4f}")
    rec = Recorder()
    wt.render_at_caps(tl, packed, dict(res["caps"], max_rounds=1),
                      any_hit=False, robust=False, stage=rec)
    res["pair_sort"] = pair_sort_candidates(rec, device, reps)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N_TRIS)
    ap.add_argument("--side", type=int, default=SIDE)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    t0 = time.perf_counter()
    tl, rays, _ = bench_scene(args.n, args.side, args.device)
    log(f"# scene: sponza_class({args.n}), T={tl.table.shape[0]} "
        f"P={tl.table.shape[2]}, {args.side}x{args.side} rays "
        f"({time.perf_counter() - t0:.1f} s to build)")
    run(tl, rays, args.device, args.reps)


if __name__ == "__main__":
    main()
