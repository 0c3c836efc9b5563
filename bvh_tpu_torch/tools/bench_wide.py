"""The wide-treelet render across treelet sizes, the counterpart of
tools/bench_wide.py.

The scene is sponza_class(n, 0) with side x side primary rays from
`scene_camera` (closest hit, or any-hit with `--any-hit`). The tree is
the port's quality-high device build (`build_minitree_fast`, then
`optimize_reinsertion`), or with `--tree native` the native library's
quality-high build on the host (api/native.py; the JAX tool's fallback,
tools/bench_wide.py:52-62). For each `--max-prims` it prints the cut's
time (`build_wide_treelets`, host), T and P, the render's ms (CUDA
events, the median of `--reps` after the first, which is printed apart)
and Mrays/s, the hits, the rounds and the caps the render settled on.
Every timed render must equal the first bit for bit.

The JAX tool's TPU knobs (`--block`, `--top-block`, `--rc-div`,
`sel_cap`, `--k`) have no counterpart: the port's render driver has no
blocks, tiers or selection caps (traverse/wide_treelet.py, "the TPU's
chunking ... only schedule work and are left out"), and its portals a
round follow the scene (`portals_per_round`).

    python -m bvh_tpu_torch.tools.bench_wide [--n 262144] [--side 1024]
        [--max-prims 512 1024 2048] [--tree port|native] [--any-hit]
        [--reps 5] [--device cpu]

On the CPU use small sizes (`--n 3000 --side 32 --max-prims 128 256`).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from bvh_tpu_torch.tools.timing import first_then_median, guard, log
from bvh_tpu_torch.traverse import wide_treelet as wt

TREES = ("port", "native")


class WideScene(NamedTuple):
    """A triangle scene ready to cut and render: its triangles [n, 3, 3]
    (numpy), the tree, the precomputed triangles [n, 12] by prim id and
    the primary rays, on one device."""

    tris: np.ndarray
    tree: object
    flat: torch.Tensor
    rays: object


def build_tree(tris: np.ndarray, kind: str, device):
    """The tree of `tris` on `device`: "port", the port's quality-high
    device build (`build_minitree_fast`, `optimize_reinsertion`);
    "native", the native library's quality-high pooled build on the
    host; "mtf" and "lbvh", `build_minitree_fast` or `build_lbvh`
    alone. Prim boxes and centres are computed in numpy on the host
    (bench.py:88-90)."""
    boxes = (tris.min(axis=1), tris.max(axis=1), tris.mean(axis=1))
    if kind == "native":
        from bvh_tpu_torch.api.native import NativeBvh3f
        from bvh_tpu_torch.io.serialize import deserialize_from_bytes

        native = NativeBvh3f()
        handle = native.build(*boxes, quality=2, threads=os.cpu_count() or 1)
        try:
            return deserialize_from_bytes(native.to_bytes(handle),
                                          device=device)
        finally:
            native.destroy(handle)
    from bvh_tpu_torch.build.lbvh import build_lbvh
    from bvh_tpu_torch.build.minitree_fast import build_minitree_fast
    from bvh_tpu_torch.build.reinsertion import optimize_reinsertion

    mn, mx, cc = (torch.from_numpy(a).to(device) for a in boxes)
    if kind == "lbvh":
        return build_lbvh(mn, mx, cc)
    tree = build_minitree_fast(mn, mx, cc)
    return tree if kind == "mtf" else optimize_reinsertion(tree)


def wide_scene(n: int, side: int, tree: str = "port", device="cuda",
               seed: int = 0, tris=None) -> WideScene:
    """sponza_class(n, seed) (or `tris`), its `tree` kind's tree, its
    precomputed triangles and side x side primary rays from
    `scene_camera`."""
    from bvh_tpu_torch.cli.camera import primary_rays
    from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
    from bvh_tpu_torch.io.scenes import scene_camera, sponza_class

    if tris is None:
        tris = sponza_class(n, seed=seed)
    tt = torch.from_numpy(tris).to(device)
    flat = PrecomputedTri.from_tri(Tri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
    eye, d, up = scene_camera(tris)
    return WideScene(tris, build_tree(tris, tree, device), flat,
                     primary_rays(eye, d, up, side, side, device=device))


def hit_fields(hit) -> tuple:
    return hit.t, hit.u, hit.v, hit.prim_id


def render(tl, sc: WideScene, device, reps: int, *, any_hit: bool = False,
           name: str = "render") -> dict:
    """The render of `sc.rays` over `tl`: its first and median ms, its
    hit fields (t, u, v, prim_id), hits, rounds and caps, and the caps
    it raised over `wide_treelet_caps`' starting values."""
    kw = dict(any_hit=any_hit)
    first_ms, ms, fields = first_then_median(
        name, lambda: hit_fields(wt.wide_treelet_intersect_tris(
            tl, sc.rays, sc.tree.prim_ids, **kw)), device, reps)
    hit, diag = wt.wide_treelet_intersect_tris(tl, sc.rays, sc.tree.prim_ids,
                                               return_diag=True, **kw)
    guard(f"{name} with its diag", hit_fields(hit), fields)
    auto = wt.wide_treelet_caps(tl, wt.portals_per_round(tl))
    R = sc.rays.tmin.numel()
    return dict(first_ms=first_ms, ms=ms, mrays_s=R / ms / 1e3,
                fields=fields, hits=int(torch.isfinite(hit.t).sum()),
                rounds=diag["rounds"], pairs=diag["pairs"], caps=diag["caps"],
                raised={k: (v, diag["caps"][k]) for k, v in auto.items()
                        if diag["caps"][k] != v})


def run(n: int = 262_144, side: int = 1024, max_prims=(512, 1024, 2048),
        tree: str = "port", any_hit: bool = False, device="cuda",
        reps: int = 5, scene: WideScene | None = None) -> dict:
    """{max_prims: the cut ("tl"), its seconds, T, P and `render`'s
    dict} on `scene` or `wide_scene(n, side, tree, device)`."""
    sc = scene if scene is not None else wide_scene(n, side, tree, device)
    out = {}
    for mp in max_prims:
        t0 = time.perf_counter()
        tl = wt.build_wide_treelets(sc.tree, sc.flat, max_prims=mp,
                                    device=device)
        cut_s = time.perf_counter() - t0
        T, P = tl.table_cols.shape[:2]
        r = render(tl, sc, device, reps, any_hit=any_hit,
                   name=f"render max_prims={mp}")
        out[mp] = dict(r, cut_s=cut_s, T=T, P=P, tl=tl)
        log(f"# bench_wide max_prims={mp}: cut {cut_s:.3f} s, T={T} P={P}; "
            f"{'any-hit' if any_hit else 'closest'} render {r['ms']:.3f} ms "
            f"= {r['mrays_s']:.3f} Mrays/s (median of {reps}; first "
            f"{r['first_ms']:.3f} ms), {r['hits']} hits, {r['rounds']} "
            f"rounds, {r['pairs']} pairs, caps {r['caps']} (raised "
            f"{r['raised']})")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--max-prims", type=int, nargs="+",
                    default=[512, 1024, 2048])
    ap.add_argument("--tree", choices=TREES, default="port")
    ap.add_argument("--any-hit", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.n, args.side, args.max_prims, args.tree, args.any_hit,
        args.device, args.reps)


if __name__ == "__main__":
    main()
