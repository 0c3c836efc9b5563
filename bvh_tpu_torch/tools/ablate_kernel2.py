"""Kernel B1's per-step cost split on the real round-1 workload, the
counterpart of tools/ablate_kernel2.py.

The pairs are round 1 of the 262K primary render, recorded in this
process by T3's round-1 recorder (`profile_occupancy.round_one`; the
JAX tool read them from /tmp/occ_round1.npz). Each variant of B1 with
code left out (`traverse_pairs_ablate`, csrc/wide_treelet.cu's
`kAblate`) runs on them: base (nothing left out), leaf
(`ABLATE_NO_QUAD`, no Möller–Trumbore tests), nosort8 (`ABLATE_NO_SORT`,
children in slot order), nopush (`ABLATE_NO_PUSH`) and leaf+nosort8.
The variants' results are wrong on purpose and change their control
flow, so each variant's time (CUDA events, the median of `--reps` after
one) is normalised by its own active steps: ns a step. The base variant
must equal B1 (`traverse_pairs`) on the pairs bit for bit, and every
timed launch its variant's first.

The JAX tool's "fetch1" and "fetch2" variants time the TPU's bf16 splits
of the table fetch, which the port leaves out on purpose (B1 reads the
f32 column tables with loads; ROADMAP): they have no counterpart.

    python -m bvh_tpu_torch.tools.ablate_kernel2 [--n 262144]
        [--side 1024] [--reps 5] [--device cpu]

On the CPU use small sizes (`--n 3000 --side 32`).
"""

from __future__ import annotations

import argparse

from bvh_tpu_torch.tools.ablate_kernel import traverse_pairs_ablate
from bvh_tpu_torch.tools.profile_occupancy import round_one
from bvh_tpu_torch.tools.profile_r3 import bench_scene
from bvh_tpu_torch.tools.timing import log, same, timed
from bvh_tpu_torch.traverse import wide_treelet as wt

VARIANTS = {"base": 0, "leaf": wt.ABLATE_NO_QUAD,
            "nosort8": wt.ABLATE_NO_SORT, "nopush": wt.ABLATE_NO_PUSH,
            "leaf+nosort8": wt.ABLATE_NO_QUAD | wt.ABLATE_NO_SORT}


def run(tl, rays, device, reps: int = 5, round1=None) -> dict:
    """{variant: {"ms", "steps", "ns_per_step", "out"}} on round 1 of the
    render of `rays` over `tl` (or `round1`, `round_one`'s record).
    Raises if the base variant differs from B1."""
    r = round1 if round1 is not None else round_one(tl, rays, device)
    (table_cols, tid, prays), kw, b1_out = r["b1"]
    sd = kw["stack_depth"]
    out = {}
    for name, v in VARIANTS.items():
        def launch(v=v):
            return traverse_pairs_ablate(table_cols, tid, prays, variant=v,
                                         stack_depth=sd)
        first = launch()
        if name == "base" and not same(first, b1_out):
            raise AssertionError("the base variant differs from B1 on the "
                                 "round-1 pairs")
        ms = timed(f"variant {name}", launch, first, device, reps)
        steps = int(first[1][1].sum())
        out[name] = dict(ms=ms, steps=steps, out=first,
                         ns_per_step=ms * 1e6 / max(steps, 1))
    base = out["base"]["ns_per_step"]
    log(f"# ablate_kernel2, round 1: {tid.numel()} pairs; base == B1 bit for "
        f"bit; per variant ms a launch, active steps, ns a step (medians of "
        f"{reps}): " + "; ".join(
            f"{k} {v['ms']:.4f} {v['steps']} {v['ns_per_step']:.4f} (saves "
            f"{base - v['ns_per_step']:.4f} ns, "
            f"{100 * (base - v['ns_per_step']) / base:.1f}%)"
            for k, v in out.items()))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    tl, rays, _ = bench_scene(args.n, args.side, args.device)
    run(tl, rays, args.device, args.reps)


if __name__ == "__main__":
    main()
