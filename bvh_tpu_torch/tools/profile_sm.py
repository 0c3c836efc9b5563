"""San-Miguel-class stage attribution (T4), the counterpart of
tools/profile_sm.py.

At ten million triangles the render is a two-level scene (thousands of
treelets, a super level, phase A2) and the question is where its time
goes. This tool measures, on the port's driver and kernels:

- the render stage by stage (`profile_r3.stage_profile`), phase A2
  included;
- phase A (kernel B2) alone at the scene's top-table width;
- kernel B1 launched on all-inactive pairs (every tid = -1) at the
  round-1 and the last round's pair counts: the card's fixed cost of a
  launch, the counterpart of the TPU's padded-block overhead;
- the glue at those widths: the pair sort (`profile_r3.sort_gather`),
  the compaction and portal sort of phase A's records, and the gathers
  of a round's rays and portal rows;
- the whole render capped at one round and uncapped: the intercept
  (phase A, A2 and round 1) and the slope per further round.

    python -m bvh_tpu_torch.tools.profile_sm [--tables PATH.npz]
        [--n 10000000] [--rays 1024] [--device cpu]

`--tables` reads the `.npz` that tools/bench_sanmiguel.py writes
(top_node_t, top_root, table, n_prims, n_wide, top_depth, wide_depth,
sup_table, sup_depth); without it the scene is built here.
"""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import numpy as np
import torch

from bvh_tpu_torch import kernels
from bvh_tpu_torch.tools.profile_r3 import Recorder, bench_scene, hits_of, \
    render_caps, sort_gather, stage_profile
from bvh_tpu_torch.tools.timing import guard, log, timed
from bvh_tpu_torch.traverse import wide_treelet as wt
from bvh_tpu_torch.traverse.collect import collect_portals

N_BIG = 10_000_000


def load_tables(path: str, device) -> wt.WideTreelets:
    """A treelet scene from the `.npz` that tools/bench_sanmiguel.py
    writes, on `device`."""
    with np.load(path) as z:
        return wt.wide_treelets_from_numpy(
            SimpleNamespace(**{k: z[k] for k in z.files}), device)


def run(tl, rays, device, reps: int = 3) -> dict:
    """Every measurement of the module docstring on the scene `tl` and
    `rays`. Raises if a staged or timed render differs from the
    render's hits."""
    before = {k.name: k.launches for k in kernels.KERNELS}
    res = dict(stage=stage_profile(tl, rays, device, reps=reps))
    hit, caps, packed = render_caps(tl, rays)
    hit_fields = (hit.t, hit.u, hit.v, hit.prim_pos)
    rec = Recorder()
    raw = wt.render_at_caps(tl, packed, caps, any_hit=False, robust=False,
                            stage=rec)
    guard("recorded render", hits_of(raw), hit_fields)
    L1, Lt = rec.pairs[0], rec.pairs[-1]
    rounds = len(rec.pairs)
    T, _, P = tl.table.shape
    R = packed.shape[1]

    a_args, a_kw, a_out = rec.first["phase_a"]
    res["phase_a_ms"] = timed("phase A", lambda: collect_portals(
        *a_args, **a_kw), a_out, device, reps)
    res["phase_a_args"] = (a_args, a_kw, a_out)
    # phase A2 merges into the recorded lists in place: time against a
    # fresh ordering of the same records
    s_args, s_kw, _ = rec.first["portal_sort"]
    portals = wt.sort_portals(*s_args, **s_kw)
    res["portal_sort_ms"] = timed("compaction + portal sort", lambda:
                                  wt.sort_portals(*s_args, **s_kw), portals,
                                  device, reps)
    log(f"# T4 scene: T={T} P={P} S={tl.sup_table.shape[0]} top width "
        f"{tl.top_node_t.shape[1]}; {R} rays, {rounds} rounds, pairs a "
        f"round {rec.pairs}; phase A (B2) alone {res['phase_a_ms']:.4f} ms, "
        f"compaction + portal sort of its records "
        f"{res['portal_sort_ms']:.4f} ms")

    rng = np.random.default_rng(0)
    rays_c = packed[:, portals.sel]
    for tag, L in (("round1", L1), ("tail", Lt)):
        tid = torch.full((L,), -1, dtype=torch.int32, device=packed.device)
        prays = torch.zeros((8, L), dtype=torch.float32, device=packed.device)

        def idle(tid=tid, prays=prays):
            return wt.traverse_pairs(tl.table_cols, tid, prays, any_hit=False,
                                     robust=False,
                                     stack_depth=caps["stack_depth"])

        res[f"idle_b1_{tag}_ms"] = timed(f"idle B1 {tag}", idle, idle(),
                                         device, reps)
        key = torch.from_numpy(rng.integers(0, T * wt.WIDTH, L)).to(
            packed.device)
        pay = torch.from_numpy(rng.random((8, L), np.float32)).to(
            packed.device)
        sg = sort_gather(key, pay, device, reps)
        sg.pop("out")
        res[f"sort_{tag}"] = sg
        cols = torch.from_numpy(rng.integers(0, rays_c.shape[1], L)).to(
            packed.device)
        res[f"gather_{tag}_ms"] = timed(
            f"gathers {tag}", lambda cols=cols: (rays_c[:, cols],
                                                 portals.tid[:, cols]),
            (rays_c[:, cols], portals.tid[:, cols]), device, reps)
        log(f"# T4 {tag}, {L} pairs: B1 on all-inactive pairs "
            f"{res[f'idle_b1_{tag}_ms']:.4f} ms a launch; stable sort + "
            f"gather {sg['stable_sort_gather_ms']:.4f} ms, unique-key sort "
            f"+ gather {sg['unique_key_sort_gather_ms']:.4f} ms; gathers "
            f"of {L} rays' rows and portal rows "
            f"{res[f'gather_{tag}_ms']:.4f} ms")

    def render(max_rounds):
        return hits_of(wt.render_at_caps(
            tl, packed, dict(caps, max_rounds=max_rounds), any_hit=False,
            robust=False))

    one = render(1)
    res["render_1_ms"] = timed("render, 1 round", lambda: render(1), one,
                               device, reps)
    res["render_ms"] = timed("render", lambda: render(caps["max_rounds"]),
                             hit_fields, device, reps)
    slope = ((res["render_ms"] - res["render_1_ms"]) / (rounds - 1)
             if rounds > 1 else 0.0)
    res.update(rounds=rounds, pairs=rec.pairs, slope_ms=slope,
               intercept_ms=res["render_1_ms"] - slope)
    res["launches"] = {k.name: k.launches - before[k.name]
                       for k in kernels.KERNELS
                       if k.launches != before[k.name]}
    log(f"# T4 render capped at 1 round {res['render_1_ms']:.4f} ms, "
        f"uncapped ({rounds} rounds) {res['render_ms']:.4f} ms: intercept "
        f"{res['intercept_ms']:.4f} ms, slope {slope:.4f} ms a round; "
        f"launches in this tool {res['launches']}")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tables", help="tools/bench_sanmiguel.py's .npz")
    ap.add_argument("--n", type=int, default=N_BIG)
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    t0 = time.perf_counter()
    if args.tables:
        from bvh_tpu_torch.cli.camera import primary_rays
        from bvh_tpu_torch.io.scenes import scene_camera, sponza_class

        eye, d, up = scene_camera(sponza_class(args.n, seed=0))
        rays = primary_rays(eye, d, up, args.rays, args.rays,
                            device=args.device)
        tl = load_tables(args.tables, args.device)
    else:
        tl, rays, _ = bench_scene(args.n, args.rays, args.device)
    log(f"# scene ready in {time.perf_counter() - t0:.1f} s")
    run(tl, rays, args.device, args.reps)


if __name__ == "__main__":
    main()
