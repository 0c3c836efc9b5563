"""Quick correctness check of the wide-treelet render, the counterpart of
tools/check_wide_quick.py: sponza_class(n, 0) with side x side primary
rays, cut at max_prims=1024. On the port's quality-high tree the hit
count must be the C++ oracle's, 81,790 at 262,144 triangles and
1024x1024 (bench.py:28-42); on the native library's quality-high tree
(`--tree native`) it must be within bench.py's edge budget of 4 rays a
million. It also renders any-hit shadow rays toward a light above the
eye and prints their count. Exits 1 when the check fails.

    python -m bvh_tpu_torch.tools.check_wide_quick [--tree port|native]
        [--n 262144] [--side 1024] [--device cpu]

At other sizes there is no oracle count and only the render is shown
(on the CPU: `--n 3000 --side 32`).
"""

from __future__ import annotations

import argparse
import sys

import torch

from bvh_tpu_torch.tools.bench_wide import TREES, WideScene, render, \
    wide_scene
from bvh_tpu_torch.tools.timing import log
from bvh_tpu_torch.traverse import wide_treelet as wt

MAX_PRIMS = 1024
# the C++ oracle's primary hits on sponza_class(n, 0), side x side rays
ORACLE_HITS = {(262_144, 1024): 81_790}
EDGE_PER_MILLION = 4  # bench.py:34-37


def oracle(n: int, side: int) -> int | None:
    return ORACLE_HITS.get((n, side))


def shadow_rays(sc: WideScene, t):
    """Rays from each primary hit (the ray's origin on a miss) toward a
    light 1 above the eye, tmin 1e-4, tmax 1."""
    from bvh_tpu_torch.core.ray import Ray

    rays = sc.rays
    eye = rays.org[0]
    light = eye + torch.tensor([0.0, 1.0, 0.0], device=eye.device)
    hitp = rays.org + rays.dir * torch.where(torch.isfinite(t), t,
                                             0.0)[:, None]
    return Ray.make(hitp, light[None, :] - hitp, tmin=1e-4,
                    tmax=torch.ones_like(t))


def run(n: int = 262_144, side: int = 1024, tree: str = "port",
        device="cuda", scene=None, tl=None) -> dict:
    """The render's hits against the oracle's count for (n, side):
    equal on the port's tree, within the edge budget on the native tree.
    `scene`, `tl`: the scene (`bench_wide.wide_scene(n, side, tree)`)
    and its cut at max_prims=1024, if already made. Returns
    `bench_wide.render`'s dict with "expect", "ok" and the shadow
    render's "shadow_hits"."""
    sc = scene if scene is not None else wide_scene(n, side, tree, device)
    expect = oracle(n, side)
    if tl is None:
        tl = wt.build_wide_treelets(sc.tree, sc.flat, max_prims=MAX_PRIMS,
                                    device=device)
    res = render(tl, sc, device, 1)
    shadow = wt.wide_treelet_intersect_tris(tl, shadow_rays(
        sc, res["fields"][0]), sc.tree.prim_ids, any_hit=True)
    res["shadow_hits"] = int(torch.isfinite(shadow.t).sum())
    R = sc.rays.tmin.numel()
    budget = 0 if tree == "port" else EDGE_PER_MILLION * R // 1_000_000
    res.update(expect=expect, budget=budget,
               ok=expect is None or abs(res["hits"] - expect) <= budget)
    log(f"# check_wide_quick, {tree} tree: {res['hits']} hits of {R} rays "
        f"(oracle {expect}, budget {budget}): "
        + ("no oracle count at this size" if expect is None
           else "ok" if res["ok"] else "FAILED")
        + f"; {res['rounds']} rounds, caps {res['caps']}; render "
        f"{res['ms']:.3f} ms (first {res['first_ms']:.3f}); shadow rays "
        f"occluded {res['shadow_hits']}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--tree", choices=TREES, default="port")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    return 0 if run(args.n, args.side, args.tree, args.device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
