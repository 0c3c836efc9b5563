"""Quick check of the two-level (super) render, the counterpart of
tools/check_super_quick.py: sponza_class(n, 0) with side x side primary
rays on the port's quality-high tree, cut at max_prims=1024 with the
super level forced at super_prims=32,768. The two-level render (phase
A2, kernel B4) must give the flat render's hit count, and the C++
oracle's 81,790 at 262,144 triangles and 1024x1024; both renders are
timed (CUDA events, the median of `--reps` after the first). Exits 1
when the check fails.

    python -m bvh_tpu_torch.tools.check_super_quick [--n 262144]
        [--side 1024] [--super-prims 32768] [--reps 5] [--device cpu]

On the CPU use small sizes (`--n 3000 --side 32 --max-prims 128
--super-prims 512`).
"""

from __future__ import annotations

import argparse
import sys

from bvh_tpu_torch.tools.bench_wide import render, wide_scene
from bvh_tpu_torch.tools.check_wide_quick import MAX_PRIMS, oracle
from bvh_tpu_torch.tools.timing import log
from bvh_tpu_torch.traverse import wide_treelet as wt

SUPER_PRIMS = 32_768


def run(n: int = 262_144, side: int = 1024, device="cuda", reps: int = 5,
        max_prims: int = MAX_PRIMS, super_prims: int = SUPER_PRIMS,
        scene=None, flat_tl=None) -> dict:
    """{"two_level", "flat": `bench_wide.render`'s dicts, "S", "Ps",
    "ok"}, the hits held to the oracle's count for (n, side). `scene`,
    `flat_tl`: the scene (`bench_wide.wide_scene(n, side)`) and its flat
    cut at `max_prims`, if already made."""
    sc = scene if scene is not None else wide_scene(n, side, "port", device)
    expect = oracle(n, side)
    tl = wt.build_wide_treelets(sc.tree, sc.flat, max_prims=max_prims,
                                super_prims=super_prims, device=device)
    S, Ps = tl.sup_cols.shape[:2]
    if S == 0:
        raise ValueError(f"super_prims={super_prims} cuts no super level")
    if flat_tl is None:
        flat_tl = wt.build_wide_treelets(sc.tree, sc.flat,
                                         max_prims=max_prims, device=device)
    two = render(tl, sc, device, reps, name="two-level render")
    flat = render(flat_tl, sc, device, reps, name="flat render")
    ok = two["hits"] == flat["hits"] and expect in (None, two["hits"])
    log(f"# check_super_quick: T={tl.table_cols.shape[0]} S={S} Ps={Ps} "
        f"top width {tl.top_node_t.shape[1]}; two-level {two['hits']} hits "
        f"in {two['rounds']} rounds, {two['ms']:.3f} ms (first "
        f"{two['first_ms']:.3f}), caps {two['caps']} (raised "
        f"{two['raised']}); flat {flat['hits']} hits, {flat['ms']:.3f} ms; "
        f"oracle {expect}: " + ("ok" if ok else "FAILED"))
    return dict(two_level=two, flat=flat, S=S, Ps=Ps, expect=expect, ok=ok)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--max-prims", type=int, default=MAX_PRIMS)
    ap.add_argument("--super-prims", type=int, default=SUPER_PRIMS)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = run(args.n, args.side, args.device, args.reps, args.max_prims,
              args.super_prims)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
