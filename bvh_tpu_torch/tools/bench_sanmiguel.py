"""The San-Miguel-class (10M triangles) two-level render and the
serialize round trip of its tree, the counterpart of
tools/bench_sanmiguel.py.

The scene is sponza_class(n, 0) with side x side primary rays; the tree
is `--builder lbvh` (`build_lbvh`, the JAX tool's default) or `mtf`
(`build_minitree_fast`), cut into treelets of `--max-prims` (default
`wide_treelet_max_prims(n)`, 4,096 at this size) with the super level
at `--super-prims` (default: auto). It prints:

- the tree's build time, the cut's time and its shapes: T, S, P, Ps,
  the top width, the top, wide and super depths and the tables' bytes
  (tools/bench_sanmiguel.py:131-137);
- the render's rounds, its caps, and whether the first attempt
  overflowed `max_new` (the render raised it and ran again);
- the render's ms (CUDA events, the median of `--reps` after the first,
  which is printed apart), its hits against the C++ oracle's 77,420 at
  10M and 1024x1024 within bench.py's edge budget of 4 a million;
- the round trip of the tree through the v2 format (ROADMAP A13(c)):
  `save_bvh` and `load_bvh` (the file's bytes, the ms of each), the
  loaded tree `bvh_equal` to the built one, tables cut from the loaded
  tree bit-equal to the built tree's, and the loaded tree's render
  equal to the built tree's, bit for bit.

`--tables-out PATH` writes the built tree's tables to an `.npz` with
the JAX tool's keys (:127-133), which `profile_sm --tables` reads. The
tree's file goes to `--cache-dir`, by default a temporary directory
removed at exit: no file of an earlier run is read. The JAX tool's
`steady_rate` chain (:178-197) is not run: the port's render chain
(`wide_treelet_render_chain`) takes single-level scenes only, and
phase A2 inside it is ROADMAP R2's next slice. Exits 1 when a check
fails.

    python -m bvh_tpu_torch.tools.bench_sanmiguel [--n 10000000]
        [--side 1024] [--builder lbvh|mtf] [--max-prims N]
        [--super-prims N] [--reps 3] [--cache-dir DIR]
        [--tables-out PATH] [--device cpu]

On the CPU use small sizes (`--n 3000 --side 32 --max-prims 128
--super-prims 512`).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from bvh_tpu_torch.io.serialize import bvh_equal, load_bvh, save_bvh
from bvh_tpu_torch.tools.bench_wide import WideScene, hit_fields, render, \
    wide_scene
from bvh_tpu_torch.tools.check_wide_quick import EDGE_PER_MILLION
from bvh_tpu_torch.tools.timing import log, same, sync
from bvh_tpu_torch.traverse import wide_treelet as wt

N_BIG = 10_000_000
BUILDERS = ("lbvh", "mtf")
# the C++ oracle's primary hits on sponza_class(n, 0), side x side rays
ORACLE_HITS = {(N_BIG, 1024): 77_420}
INT_FIELDS = ("top_root", "n_prims", "top_depth", "wide_depth", "sup_depth")


def save_tables(tl: wt.WideTreelets, path: str) -> None:
    """`tl` as an `.npz` with tools/bench_sanmiguel.py's keys (:127-133):
    the tables in the reference's row layouts."""
    np.savez(path, top_node_t=tl.top_node_t.cpu().numpy(),
             table=tl.table.cpu().numpy(),
             sup_table=tl.sup_table.cpu().numpy(), n_wide=tl.n_wide,
             **{k: getattr(tl, k) for k in INT_FIELDS})


def same_tables(a: wt.WideTreelets, b: wt.WideTreelets) -> bool:
    """Every table bit for bit, and every shape field equal."""
    return (same((a.top_node_t, a.table_cols, a.sup_cols),
                 (b.top_node_t, b.table_cols, b.sup_cols))
            and np.array_equal(a.n_wide, b.n_wide)
            and all(getattr(a, k) == getattr(b, k) for k in INT_FIELDS))


def round_trip(sc: WideScene, tl, hit, cut_kw: dict, path: str,
               device) -> dict:
    """ROADMAP A13(c) on the scene's tree: save and load it, `bvh_equal`,
    tables cut from the loaded tree against `tl`, and the loaded tree's
    render against `hit` (the built tree's hit fields)."""
    t0 = time.perf_counter()
    save_bvh(sc.tree, path)
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    loaded = load_bvh(path, device=device)
    sync(device)
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tl2 = wt.build_wide_treelets(loaded, sc.flat, device=device, **cut_kw)
    recut_s = time.perf_counter() - t0
    hit2 = hit_fields(wt.wide_treelet_intersect_tris(tl2, sc.rays,
                                                     loaded.prim_ids))
    res = dict(bytes=os.path.getsize(path), save_ms=save_ms, load_ms=load_ms,
               recut_s=recut_s, bvh_equal=bvh_equal(sc.tree, loaded),
               tables_equal=same_tables(tl, tl2), hits_equal=same(hit2, hit),
               loaded=loaded, loaded_tl=tl2)
    res["ok"] = res["bvh_equal"] and res["tables_equal"] and res["hits_equal"]
    return res


def run(n: int = N_BIG, side: int = 1024, builder: str = "lbvh",
        max_prims: int | None = None, super_prims: int | None = None,
        reps: int = 3, device="cuda", cache_dir: str | None = None,
        tables_out: str | None = None, scene: WideScene | None = None,
        tl=None) -> dict:
    """Every measurement and check of the module docstring on `scene`
    (default: `wide_scene(n, side, builder, device)`) and `tl` (default:
    its cut at `max_prims`, `super_prims`; a given `tl` must be that
    cut), the hits held to the oracle's count for (n, side) where there
    is one. Returns the numbers, "ok", and the round trip's dict under
    "a13c"."""
    t0 = time.perf_counter()
    if scene is None:
        sc = wide_scene(n, side, builder, device)
        source = f"{builder} tree, built with the scene in " \
            f"{time.perf_counter() - t0:.1f} s"
    else:
        sc, builder, source = scene, "given", "the caller's tree"
    expect = ORACLE_HITS.get((n, side))
    if max_prims is None:
        max_prims = wt.wide_treelet_max_prims(n)
    cut_kw = dict(max_prims=max_prims, super_prims=super_prims)
    cut = "the caller's cut"
    if tl is None:
        t0 = time.perf_counter()
        tl = wt.build_wide_treelets(sc.tree, sc.flat, device=device, **cut_kw)
        cut = f"cut in {time.perf_counter() - t0:.1f} s"
    T, P = tl.table_cols.shape[:2]
    S, Ps = tl.sup_cols.shape[:2]
    table_bytes = sum(x.nbytes for x in (tl.top_node_t, tl.table_cols,
                                         tl.sup_cols))
    log(f"# bench_sanmiguel n={n}: {sc.tree.node_count} nodes ({source}); "
        f"{cut} at max_prims={max_prims} super_prims={super_prims}: T={T} "
        f"S={S} P={P} Ps={Ps} top={tl.top_node_t.shape[1]} "
        f"top_depth={tl.top_depth} wide_depth={tl.wide_depth} "
        f"sup_depth={tl.sup_depth}; tables {table_bytes} bytes")
    if tables_out:
        save_tables(tl, tables_out)
    r = render(tl, sc, device, reps)
    R = sc.rays.tmin.numel()
    budget = EDGE_PER_MILLION * R // 1_000_000
    hits_ok = expect is None or abs(r["hits"] - expect) <= budget
    log(f"# bench_sanmiguel render: {r['hits']} hits of {R} (oracle "
        f"{expect}, budget {budget}: {'ok' if hits_ok else 'FAILED'}); "
        f"{r['rounds']} rounds, {r['pairs']} pairs; caps {r['caps']}; the "
        f"first attempt overflowed max_new: {'max_new' in r['raised']} "
        f"(raised {r['raised']}); {r['ms']:.3f} ms = {r['mrays_s']:.3f} "
        f"Mrays/s (median of {reps}; first {r['first_ms']:.3f} ms)")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(cache_dir or tmp, f"bench_{builder}_{n}.bvh")
        a13 = round_trip(sc, tl, r["fields"], cut_kw, path, device)
    log(f"# bench_sanmiguel round trip (A13c): {a13['bytes']} bytes, save "
        f"{a13['save_ms']:.1f} ms, load {a13['load_ms']:.1f} ms; bvh_equal "
        f"{a13['bvh_equal']}; tables cut from the loaded tree "
        f"({a13['recut_s']:.1f} s) equal the built tree's: "
        f"{a13['tables_equal']}; its render's hits equal: "
        f"{a13['hits_equal']}")
    return dict(source=source, cut=cut, T=T, S=S, P=P, Ps=Ps,
                top=tl.top_node_t.shape[1], top_depth=tl.top_depth,
                wide_depth=tl.wide_depth, sup_depth=tl.sup_depth,
                table_bytes=table_bytes, render=r, expect=expect,
                max_new_overflow="max_new" in r["raised"], a13c=a13,
                ok=hits_ok and a13["ok"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N_BIG)
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--builder", choices=BUILDERS, default="lbvh")
    ap.add_argument("--max-prims", type=int)
    ap.add_argument("--super-prims", type=int)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cache-dir")
    ap.add_argument("--tables-out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = run(args.n, args.side, args.builder, args.max_prims,
              args.super_prims, args.reps, args.device, args.cache_dir,
              args.tables_out)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
