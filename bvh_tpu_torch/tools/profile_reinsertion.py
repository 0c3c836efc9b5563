"""Stage-level timing of the reinsertion optimizer, the counterpart of
tools/profile_reinsertion.py.

The JAX tool re-jitted copies of the stages. Here one `_one_iteration`
of the port runs its own stages through `StageTimer` (CUDA events around
each), so the stages are the production code on their real inputs:

- parents (`parents_of`); candidates (the stable sort by half-area);
- search: the branch-and-bound `_find_reinsertion_batch`, with its
  lockstep steps;
- gain_sort (the moves by gain, their conflict sets); accept
  (`_greedy_accept`); apply; seeds (the new parents, the refit's seeds);
  refit (`_refit_dirty`).

It prints each stage's median over `--reps` staged iterations, its share
of their sum and its host syncs (`SyncCounter`), beside the unstaged
iteration, and `optimize_reinsertion` end to end with its iteration
count. Every staged iteration must equal the unstaged one bit for bit.
Beside them it times the JAX tool's alternatives: `torch.topk` for the
candidates (timed only: its order among equal areas is not stable, so
it does not replace the sort) and the full refit loop
(`traverse.refit.refit` of the moved tree) in place of the dirty refit.

The input tree is `--input lbvh` (`build_lbvh`, the JAX tool's input) or
`--input high` (`build_minitree_fast`, the tree the quality-high build
hands to reinsertion), on sponza_class(n, 0).

    python -m bvh_tpu_torch.tools.profile_reinsertion [--n 262144]
        [--input lbvh|high] [--reps 3] [--device cpu]

On the CPU use small sizes (`--n 3000`).
"""

from __future__ import annotations

import argparse
import statistics

import torch

from bvh_tpu_torch.build import reinsertion as rein
from bvh_tpu_torch.tools.bench_build import scene_boxes
from bvh_tpu_torch.tools.profile_r3 import Recorder
from bvh_tpu_torch.tools.timing import StageTimer, SyncCounter, \
    first_then_median, guard, log, time_calls
from bvh_tpu_torch.traverse.refit import refit

INPUTS = ("lbvh", "high")
STAGES = ("parents", "candidates", "search", "gain_sort", "accept", "apply",
          "seeds", "refit")


def input_tree(name: str, boxes):
    """The tree reinsertion starts from: `build_lbvh` ("lbvh") or
    `build_minitree_fast` ("high")."""
    from bvh_tpu_torch.build.lbvh import build_lbvh
    from bvh_tpu_torch.build.minitree_fast import build_minitree_fast

    return {"lbvh": build_lbvh, "high": build_minitree_fast}[name](*boxes)


def run(n: int = 262_144, input_name: str = "lbvh", device="cuda",
        reps: int = 3, boxes=None, tree=None) -> dict:
    """Every measurement of the module docstring on `tree`, or on the
    `input_name` tree of `boxes` (default sponza_class(n, 0)). Returns
    the times, shares, syncs, steps and moves, the unstaged iteration's
    output ("out") and each stage's first call as (args, kwargs, output)
    ("record"). Raises if a staged iteration differs from the unstaged
    one."""
    if tree is None:
        if boxes is None:
            boxes = scene_boxes(n, device)
        tree = input_tree(input_name, boxes)
    config = rein.ReinsertionConfig()
    args = rein.iteration_args(tree, config)
    first_ms, whole_ms, out = first_then_median(
        "one iteration", lambda: rein._one_iteration(*args), device, reps)
    rec = Recorder()
    guard("recorded iteration", rein._one_iteration(*args, stage=rec), out)
    timer = StageTimer(device)
    runs = []
    for _ in range(reps):
        guard("staged iteration",
              rein._one_iteration(*args, stage=timer), out)
        runs.append(timer.totals())
    stages = {k: statistics.median(r[k][0] for r in runs) for k in STAGES}
    total = sum(stages.values())
    syncs = SyncCounter(device)
    guard("counted iteration", rein._one_iteration(*args, stage=syncs), out)

    bounds, index, node_count, batch_cap = args[:4]
    scores = rein._scores(bounds, index, node_count)
    topk_ms, _ = time_calls(lambda: torch.topk(scores, batch_cap), device,
                            reps)
    moved = tree._replace(bounds=rec.first["apply"][2][0],
                          index=rec.first["apply"][2][1])
    full_refit_ms, full = time_calls(lambda: refit(moved), device, reps)

    stats = {}

    def optimize():
        stats.clear()
        return rein.optimize_reinsertion(tree, config, stats=stats)

    opt_first_ms, opt_ms, _ = first_then_median("optimize_reinsertion",
                                                optimize, device, reps)
    res = dict(
        n_nodes=node_count, batch_cap=batch_cap, stages=stages,
        shares={k: v / total for k, v in stages.items()}, stage_sum=total,
        syncs=dict(syncs.counts) if syncs.cuda else None,
        steps=int(out[2]), accepted=int(out[3].sum()), whole_ms=whole_ms,
        first_ms=first_ms, topk_ms=topk_ms, full_refit_ms=full_refit_ms,
        full_refit_equal=bool(torch.equal(full.bounds, out[0])),
        optimize_ms=opt_ms, optimize_first_ms=opt_first_ms,
        iterations=config.max_iter_count, optimize_steps=stats["steps"],
        optimize_accepted=stats["accepted"], out=out, record=rec.first)
    log(f"# profile_reinsertion, input {input_name}: {node_count} nodes, "
        f"batch {batch_cap}; one iteration {whole_ms:.3f} ms (first "
        f"{first_ms:.3f}), {res['steps']} search steps, {res['accepted']} "
        f"moves; stages (ms, share, host syncs; medians of {reps}): "
        + ", ".join(f"{k} {v:.3f} {res['shares'][k]:.3f} "
                    f"{syncs.counts.get(k, 'n/a')}"
                    for k, v in stages.items())
        + f"; stage sum {total:.3f}; staged == unstaged bit for bit")
    log(f"# profile_reinsertion, input {input_name}: candidates by "
        f"torch.topk {topk_ms:.3f} ms (timed only) against the sort "
        f"{stages['candidates']:.3f}; the full refit loop "
        f"{full_refit_ms:.3f} ms against the dirty refit "
        f"{stages['refit']:.3f} (same bounds: {res['full_refit_equal']}); "
        f"optimize_reinsertion {opt_ms:.3f} ms (first {opt_first_ms:.3f}), "
        f"{res['iterations']} iterations, steps {res['optimize_steps']}, "
        f"moves {res['optimize_accepted']}")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--input", choices=INPUTS, default="lbvh")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.n, args.input, args.device, args.reps)


if __name__ == "__main__":
    main()
