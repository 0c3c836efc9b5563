"""Per-ray oracle check of the wide-treelet render, the counterpart of
tools/check_oracle.py.

The scene is sponza_class(n, seed) with side x side primary rays from
`scene_camera`, and the tree the native library's quality-2 build of it
(api/native.py). The same tree is traced twice:

- by the oracle, `oracle_trace.cpp` beside this file: the repo's own
  native/bvh_c.cpp (an original, self-contained implementation of the
  reference C API, not madmann91/bvh's code) walks the tree through
  `bvh3f_intersect_ray` or `bvh3f_intersect_ray_robust`, and a C leaf
  callback tests each leaf's triangles with the reference's precomputed
  Moller-Trumbore, in the tree's prim_ids order. It is built at first
  use with `kernels.build_shared_library` (g++ -ffp-contract=off, with
  native/bvh_c.cpp linked in, so the tree it builds is the handle it
  traces) and called through ctypes, on the host's threads. The JAX
  tool's tracer builds against the reference's sources, which this repo
  does not hold;
- by the port: the v2 bytes of that tree loaded onto the device, cut
  by `build_wide_treelets` (max_prims 1024; 8192 above 4M triangles)
  and rendered by `wide_treelet_intersect_tris`, fast and robust.

`compare` is the JAX tool's rule (tools/check_oracle.py:28-74): a ray
matches on the same hit position; a hit of another position at the
same t (rtol 1e-4) is a tie; on the fast path a mismatch where the port
found a strictly closer hit is the oracle's fast-slab miss and is not
held against the port ("ours closer"); under the robust variant every
other mismatch counts. At most BOUNDARY_PPM rays a million (at least 1)
may fail. Exits 1 when a check fails. The tree stays in memory: nothing
is written to a fixed path.

    python -m bvh_tpu_torch.tools.check_oracle [--n 262144] [--rays 1024]
        [--quality 2] [--no-robust] [--threads N] [--device cpu]

On the CPU use small sizes (`--n 3000 --rays 32`).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
import time

import numpy as np
import torch

from bvh_tpu_torch.tools.timing import device_line, first_then_median, log

BOUNDARY_PPM = 4  # allowed boundary-epsilon disagreements per million rays
RENDER_REPS = 3  # timed renders after the first, per variant
INVALID = 0xFFFFFFFF
_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(_HERE, "..", "..", "native")
_SOURCES = [os.path.join(_HERE, "oracle_trace.cpp"),
            os.path.join(_NATIVE_DIR, "bvh_c.cpp")]


def compare(name, our_pos, our_t, ref_pos, ref_t, rtol=1e-4,
            strict=False) -> dict:
    """The port's hits (`our_pos`: prim position, -1 on a miss; `our_t`)
    against the oracle's (`ref_pos`: 0xFFFFFFFF on a miss; `ref_t`), by
    the JAX tool's rule. Prints its line and returns the counts with
    "ok"."""
    our_pos = np.asarray(our_pos).astype(np.int64)
    our_t = np.asarray(our_t)
    ref_pos = np.asarray(ref_pos).astype(np.int64)
    ref_t = np.asarray(ref_t)
    ref_pos = np.where(ref_pos == INVALID, -1, ref_pos)
    our_hit = our_pos >= 0
    ref_hit = ref_pos >= 0
    nh_our, nh_ref = int(our_hit.sum()), int(ref_hit.sum())
    same_hitset = our_hit == ref_hit
    pos_match = (our_pos == ref_pos) & same_hitset
    both = our_hit & ref_hit
    t_close = np.zeros_like(both)
    t_close[both] = np.abs(our_t[both] - ref_t[both]) <= (
        rtol * np.maximum(1.0, np.abs(ref_t[both])))
    tie = both & t_close & ~pos_match
    real_mismatch = ~(pos_match | tie)
    # a strictly closer hit of ours is the oracle's fast-slab cull of the
    # node holding it; the robust slab is watertight on both sides, so
    # `strict` counts every mismatch
    ours_closer = real_mismatch & our_hit & (
        ~ref_hit | (our_t < ref_t - 1e-6 * np.maximum(1.0, np.abs(ref_t))))
    ours_worse = real_mismatch if strict else (real_mismatch & ~ours_closer)
    n_worse = int(ours_worse.sum())
    budget = max(1, (BOUNDARY_PPM * len(our_pos)) // 1_000_000)
    ok = n_worse <= budget
    print(f"{name}: hits {nh_our} vs oracle {nh_ref}; "
          f"exact prim match {int(pos_match.sum())}, ties {int(tie.sum())}, "
          f"ref-fast misses (ours closer) {int(ours_closer.sum())}, "
          f"our misses {n_worse}  ->  hits_match: {str(ok).lower()}",
          flush=True)
    bad = np.nonzero(real_mismatch)[0][:5]
    for i in bad:
        print(f"    ray {i}: ours (pos={our_pos[i]}, t={our_t[i]:.6f}) "
              f"oracle (pos={ref_pos[i]}, t={ref_t[i]:.6f})", flush=True)
    return dict(ok=ok, hits=nh_our, oracle_hits=nh_ref,
                exact=int(pos_match.sum()), ties=int(tie.sum()),
                ours_closer=int(ours_closer.sum()), our_misses=n_worse,
                mismatches=int(real_mismatch.sum()), budget=budget,
                first_mismatches=[int(i) for i in bad])


def oracle_library():
    """The tracer's library (oracle_trace.cpp with native/bvh_c.cpp),
    built on first use, with the native calls' and the tracer's ctypes
    signatures."""
    from bvh_tpu_torch.api.native import load_library
    from bvh_tpu_torch.kernels import build_shared_library

    path = build_shared_library(
        ["g++", "-std=c++20", "-O2", "-fPIC", "-shared", "-ffp-contract=off",
         "-pthread", f"-I{_NATIVE_DIR}"],
        _SOURCES, _SOURCES + [os.path.join(_NATIVE_DIR, "bvh_c.h")],
        "liboracle_trace")
    lib = load_library(path)
    lib.bvh_oracle_trace3f.restype = ctypes.c_int
    lib.bvh_oracle_trace3f.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_void_p]
    return lib


def trace(lib, handle, tris: np.ndarray, rays: np.ndarray, robust: bool,
          threads: int | None = None):
    """The oracle's closest hits of `rays` [R, 8] f32 (org dir tmin tmax)
    through the tree `handle` of `lib` over `tris` [n, 3, 3] by prim id:
    (prim position [R] uint32, 0xFFFFFFFF on a miss; t, u, v [R] f32)."""
    tris = np.ascontiguousarray(tris, np.float32).reshape(-1, 9)
    rays = np.ascontiguousarray(rays, np.float32)
    R = rays.shape[0]
    pos = np.empty(R, np.uint32)
    tuv = np.empty((R, 3), np.float32)
    rc = lib.bvh_oracle_trace3f(
        handle, tris.ctypes.data, len(tris), rays.ctypes.data, R,
        int(robust), threads or os.cpu_count() or 1, pos.ctypes.data,
        tuv.ctypes.data)
    if rc:
        raise ValueError("oracle trace: the tree names a prim id past the "
                         f"{len(tris)} triangles")
    return pos, tuv[:, 0], tuv[:, 1], tuv[:, 2]


def run(n: int = 262_144, side: int = 1024, quality: int = 2,
        robust: bool = True, device="cuda", seed: int = 0,
        threads: int | None = None) -> dict:
    """Both traces and `compare` per variant ("fast", and "robust" unless
    `robust` is False). Returns {"variants": {name: compare's counts with
    the oracle's seconds, the render's ms (the median of RENDER_REPS
    renders after the first) and the four hit arrays}, "ok",
    "scene" (the `bench_wide.WideScene` of the native tree), "device"}."""
    from bvh_tpu_torch.api.native import NativeBvh3f
    from bvh_tpu_torch.cli.camera import primary_rays
    from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
    from bvh_tpu_torch.io.scenes import scene_camera, sponza_class
    from bvh_tpu_torch.io.serialize import deserialize_from_bytes
    from bvh_tpu_torch.tools.bench_wide import WideScene
    from bvh_tpu_torch.traverse import wide_treelet as wt

    lib = oracle_library()
    native = NativeBvh3f(lib)
    tris = sponza_class(n, seed=seed)
    handle = native.build(tris.min(axis=1), tris.max(axis=1),
                          tris.mean(axis=1), quality=quality,
                          threads=os.cpu_count() or 1)
    try:
        tree = deserialize_from_bytes(native.to_bytes(handle), device=device)
        tt = torch.from_numpy(tris).to(device)
        flat = PrecomputedTri.from_tri(
            Tri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
        eye, d, up = scene_camera(tris)
        rays = primary_rays(eye, d, up, side, side, device=device)
        tl = wt.build_wide_treelets(
            tree, flat, max_prims=8192 if n > 4_000_000 else 1024,
            device=device)
        host_rays = wt.pack_rays(rays).T.cpu().numpy()
        variants = {}
        for name, rob in [("fast", False)] + [("robust", True)] * robust:
            t0 = time.perf_counter()
            ref_pos, ref_t, _, _ = trace(lib, handle, tris, host_rays, rob,
                                         threads)
            oracle_s = time.perf_counter() - t0

            def render(rob=rob):
                h = wt.wide_treelet_intersect_tris(tl, rays, tree.prim_ids,
                                                   robust=rob)
                return h.t, h.prim_pos

            first_ms, ms, (t, pos) = first_then_median(
                f"render {name}", render, device, RENDER_REPS)
            our_t = t.cpu().numpy()
            our_pos = np.where(np.isfinite(our_t),
                               pos.cpu().numpy().astype(np.int64), -1)
            res = compare(f"wide_treelet/{name}", our_pos, our_t, ref_pos,
                          ref_t, strict=rob)
            variants[name] = dict(res, oracle_s=oracle_s, render_ms=ms,
                                  render_first_ms=first_ms, our_pos=our_pos,
                                  our_t=our_t, ref_pos=ref_pos, ref_t=ref_t)
    finally:
        native.destroy(handle)
    line = device_line(device)
    log(f"# check_oracle on {line}: sponza_class({n}, {seed}), {side}x{side} "
        f"rays, the native quality-{quality} tree ({tree.node_count} nodes, "
        f"T={tl.table_cols.shape[0]}); " + "; ".join(
            f"{k}: oracle {v['oracle_s']:.3f} s on the host, render "
            f"{v['render_ms']:.3f} ms (median of {RENDER_REPS}; first "
            f"{v['render_first_ms']:.3f}), "
            f"exact {v['exact']}, ties {v['ties']}, ours closer "
            f"{v['ours_closer']}, misses {v['our_misses']} of budget "
            f"{v['budget']}: {'ok' if v['ok'] else 'FAILED'}"
            for k, v in variants.items()))
    return dict(variants=variants, device=line,
                scene=WideScene(tris, tree, flat, rays),
                ok=all(v["ok"] for v in variants.values()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--quality", type=int, default=2)
    ap.add_argument("--no-robust", dest="robust", action="store_false",
                    help="check the fast path only")
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = run(args.n, args.rays, args.quality, args.robust, args.device,
              threads=args.threads)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
