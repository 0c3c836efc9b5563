"""Stage-level timing of `build_minitree_fast`, the counterpart of
tools/profile_mtf.py.

The JAX tool re-jitted copies of the build's stages. Here the build's
own code is timed: `build_minitree_fast(..., stage=)` runs each stage
through `StageTimer`, which brackets it with CUDA events, so the stages
are the production functions on their real inputs:

- staging: the Morton groups, the sort and the counts (`group_sort`);
- counts_readback: the counts' one copy to the host, which sizes the
  launch (`read_plan`);
- pack_groups, then b3 (kernel B3, the per-group builds);
- assemble (pruning and the splice), and within it top_tree,
  `build_sweep`'s top tree over the splice roots on its own.

It prints each stage's median over `--reps` staged builds beside the
unstaged build, and G and P. Every staged build must equal the unstaged
one bit for bit.

    python -m bvh_tpu_torch.tools.profile_mtf [--n 262144] [--reps 3]
        [--device cpu]

On the CPU use small sizes (`--n 3000`).
"""

from __future__ import annotations

import argparse
import statistics

from bvh_tpu_torch.build import minitree_fast as mtf
from bvh_tpu_torch.tools.bench_build import scene_boxes
from bvh_tpu_torch.tools.profile_r3 import Recorder
from bvh_tpu_torch.tools.timing import StageTimer, first_then_median, guard, \
    log

STAGES = ("staging", "counts_readback", "pack_groups", "b3", "assemble",
          "top_tree")


def run(n: int = 262_144, device="cuda", reps: int = 3,
        boxes=None) -> dict:
    """Stage times (ms, medians of `reps` staged builds), the unstaged
    build's, the plan's G and P and the tree, on sponza_class(n, 0) or
    `boxes`. Raises if a staged build differs from the unstaged one."""
    if boxes is None:
        boxes = scene_boxes(n, device)
    first_ms, whole_ms, tree = first_then_median(
        "build_minitree_fast", lambda: mtf.build_minitree_fast(*boxes),
        device, reps)
    rec = Recorder()
    guard("recorded build", mtf.build_minitree_fast(*boxes, stage=rec), tree)
    plan = rec.first["counts_readback"][2]
    timer = StageTimer(device)
    runs = []
    for _ in range(reps):
        guard("staged build", mtf.build_minitree_fast(*boxes, stage=timer),
              tree)
        runs.append(timer.totals())
    stages = {k: statistics.median(r[k][0] for r in runs) for k in STAGES}
    res = dict(tree=tree, stages=stages, whole_ms=whole_ms,
               first_ms=first_ms, G=plan.G, P=plan.P,
               stage_sum=sum(v for k, v in stages.items() if k != "top_tree"))
    log(f"# profile_mtf n={boxes[2].shape[0]} G={plan.G} P={plan.P}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f" ms (top_tree within assemble; medians of {reps}); stage sum "
        f"{res['stage_sum']:.3f}, unstaged build {whole_ms:.3f} (first "
        f"{first_ms:.3f}); staged tree == unstaged bit for bit")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.n, args.device, args.reps)


if __name__ == "__main__":
    main()
