"""The readings that the check's limits are set from, for one cell:

- the program's: whole runs of the cell (`harness.run_cell`, a short
  window each) on a dozen seeds or more, the judge's numbers of each;
- the control's: the plain reference put in the program's place and
  computed in bfloat16, the precision below the configuration's
  float32, on the same sampled rays of the same frames as a run of the
  seed would check, judged alike.

    python3 -m raybench.control --workload boxgrid_262k.interior \\
        --seeds 1,2,3,... --control-seeds 7,8,9 [--seconds 2]

on the card. Prints one JSON line a seed and the readings: for each
number the largest the program gave and the smallest the control gave.
"""

from __future__ import annotations

import argparse
import json
import random
import sys

import torch

from raybench import harness, rays, scenes
from raybench.reference import intersect


def control_numbers(workload: str, seed: int, device="cuda",
                    cell_data=None) -> dict:
    """The judge's numbers of the bfloat16 control on the sample that a
    run of `seed` would check."""
    _, _, config, traffic = cell_data or harness.cell(workload)
    check = traffic["check"]
    any_hit = bool(traffic.get("any_hit", False))
    if traffic["kind"] == "rebuild":     # each frame against its variant
        variants, ray_sets, order = harness.rebuild_inputs(
            config, traffic, seed, device)
        pick = random.Random(seed).sample(range(len(ray_sets)),
                                          min(check["frames"], len(ray_sets)))
        return harness.check_rebuild(
            [(order[j], j, None, None) for j in pick], ray_sets, variants,
            traffic, seed, any_hit,
            answer=lambda tris, sub: intersect.lower_precision(tris, *sub))
    if traffic["kind"] == "build":       # the last variant's scene
        tris = scenes.sponza_class(config["n_tris"], seed, device,
                                   traffic["variants"] - 1)
    else:
        tris = scenes.sponza_class(config["n_tris"], config["scene_seed"],
                                   device)
    spec = check.get("rays", traffic.get("rays"))
    ray_sets = rays.ray_sets(spec, tris, seed)
    pick = random.Random(seed).sample(range(len(ray_sets)),
                                      min(check["frames"], len(ray_sets)))
    kept = [(k, None, None) for k in pick]

    def answer(sub):
        return intersect.lower_precision(tris, *sub)

    return harness.check_frames(kept, ray_sets, tris, traffic, seed, any_hit,
                                answer=answer)


def readings(program: list, control: list) -> dict:
    """{number: {"lower": largest program reading, "upper": smallest
    control reading}}."""
    keys = program[0].keys() if program else control[0].keys()
    return {k: {"lower": max((p[k] for p in program), default=None),
                "upper": min((c[k] for c in control if k in c),
                             default=None)} for k in keys}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    data = harness.cell(args.workload)
    program, control = [], []
    for s in filter(None, args.seeds.split(",")):
        out = harness.run_cell(args.workload, int(s), args.seconds, False,
                               cell_data=data)
        nums = {k: v["value"] for k, v in out["check"].items()}
        program.append(nums)
        print(json.dumps({"seed": int(s), "side": "program",
                          "correct": out["correct"], "numbers": nums,
                          "metrics": out["metrics"]}), flush=True)
        torch.cuda.empty_cache()
    for s in filter(None, args.control_seeds.split(",")):
        nums = control_numbers(args.workload, int(s), cell_data=data)
        control.append(nums)
        print(json.dumps({"seed": int(s), "side": "control",
                          "numbers": nums}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload,
                      "readings": readings(program, control)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
