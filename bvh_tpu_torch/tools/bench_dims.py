"""Configurations other than 3D float32 triangles, the counterpart of
tools/bench_dims.py:

- 2D, 3D and 4D float32 spheres (m spheres, centres U(-1, 1), radii
  U(0.02, 0.1), a `default_rng(dim)` each) built by `build_binned` and
  traced through kernel B6 (`pallas_intersect_spheres`) with `--rays`
  rays from U(-3, 3) towards U(-1, 1); then the JAX tool's parity gate
  (:80-97): on the first 16,384 rays the wavefront (`traverse` with
  `make_sphere_leaf_fn`) must give the same hit set and prim ids, and t
  within rtol 2e-5;
- 3D float64 triangles (m of them, `default_rng(7)`) built by
  `build_binned` and traced through the wavefront's `intersect_tris`
  with `--f64-rays` rays (the card has no float64 kernel here, as the
  TPU had none).

Times are CUDA events, the median of `--reps` after the first (printed
apart), each timed output guarded against the first.

    python -m bvh_tpu_torch.tools.bench_dims [--m 1024] [--rays 262144]
        [--f64-rays 16384] [--reps 5] [--device cpu]

On the CPU use small sizes (`--m 64 --rays 1024 --f64-rays 1024`).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from bvh_tpu_torch.build.binned import build_binned
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.tools.timing import first_then_median, log
from bvh_tpu_torch.traverse.sphere_kernel import pallas_intersect_spheres
from bvh_tpu_torch.traverse.wavefront import intersect_tris, \
    make_sphere_leaf_fn, traverse

DIMS = (2, 3, 4)
PARITY_RAYS = 16_384
RTOL = 2e-5


def sphere_scene(dim: int, m: int, R: int, device):
    """The JAX tool's spheres and rays at `dim` (:63-72): (centers,
    radii, bvh, rays)."""
    rng = np.random.default_rng(dim)
    c = torch.from_numpy(rng.uniform(-1, 1, (m, dim)).astype(np.float32))
    r = torch.from_numpy(rng.uniform(0.02, 0.1, m).astype(np.float32))
    org = rng.uniform(-3, 3, (R, dim)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (R, dim)).astype(np.float32)
    c, r = c.to(device), r.to(device)
    rays = Ray.make(torch.from_numpy(org).to(device),
                    torch.from_numpy(tgt - org).to(device))
    return c, r, build_binned(c - r[:, None], c + r[:, None], c), rays


def parity(t, prim_id, want) -> dict:
    """The JAX tool's gate on the rays of `want`, the wavefront's Hit:
    equal hit sets, equal prim ids on the hits, t within rtol 2e-5.
    `t`, `prim_id`: B6's, over at least those rays. Returns the
    mismatch counts and "ok"."""
    Rs = want.t.numel()
    t, prim_id = t[:Rs], prim_id[:Rs]
    got_hit, want_hit = torch.isfinite(t), want.hit
    both = got_hit & want_hit
    res = dict(rays=Rs, mask=int((got_hit != want_hit).sum()),
               prim=int((prim_id[both] != want.prim_id[both]).sum()),
               t_ok=bool(torch.allclose(t[both], want.t[both], rtol=RTOL,
                                        atol=0)))
    res["ok"] = res["mask"] == 0 and res["prim"] == 0 and res["t_ok"]
    return res


def f64_scene(m: int, R: int, device):
    """The JAX tool's float64 triangles and rays (:100-115): (bvh, flat,
    rays)."""
    from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri

    rng = np.random.default_rng(7)
    pts = rng.uniform(-1, 1, (m, 3))
    e1 = rng.uniform(-0.08, 0.08, (m, 3))
    e2 = rng.uniform(-0.08, 0.08, (m, 3))
    tris = torch.from_numpy(np.stack([pts, pts + e1, pts + e2], 1)).to(device)
    tri = Tri(tris[:, 0], tris[:, 1], tris[:, 2])
    mn, mx = tri.get_bbox()
    bvh = build_binned(mn, mx, tri.get_center())
    org = rng.uniform(-3, 3, (R, 3))
    tgt = rng.uniform(-1, 1, (R, 3))
    rays = Ray.make(torch.from_numpy(org).to(device),
                    torch.from_numpy(tgt - org).to(device))
    return bvh, PrecomputedTri.from_tri(tri).as_flat(), rays


def run(m: int = 1024, rays: int = 262_144, f64_rays: int = 16_384,
        reps: int = 5, device="cuda") -> dict:
    """{dim: {"ms", "first_ms", "mrays_s", "hits", "parity", "fields"
    (B6's t, u, v, prim_pos, prim_id), "want" (the wavefront's Hit on
    the gate's rays)}, "f64": {...}}. Raises AssertionError if a dim
    fails the parity gate."""
    out = {}
    for dim in DIMS:
        c, r, bvh, ry = sphere_scene(dim, m, rays, device)
        first_ms, ms, fields = first_then_median(
            f"{dim}D spheres", lambda: tuple(pallas_intersect_spheres(
                bvh, c, r, ry)[:5]), device, reps)
        sub = Ray(*(x[:PARITY_RAYS] for x in ry))
        want = traverse(bvh, sub, make_sphere_leaf_fn(bvh, c, r))
        gate = parity(fields[0], fields[4], want)
        out[dim] = dict(first_ms=first_ms, ms=ms, mrays_s=rays / ms / 1e3,
                        hits=int(torch.isfinite(fields[0]).sum()),
                        parity=gate, fields=fields, want=want)
        log(f"# bench_dims {dim}D f32 spheres (B6), m={m}: {rays} rays in "
            f"{ms:.3f} ms = {rays / ms / 1e3:.3f} Mrays/s (median of {reps}; "
            f"first {first_ms:.3f} ms), {out[dim]['hits']} hits; parity vs "
            f"the wavefront: {gate}")
        if not gate["ok"]:
            raise AssertionError(f"{dim}D: B6 fails the parity gate against "
                                 f"the wavefront: {gate}")
    bvh, flat, ry = f64_scene(m, f64_rays, device)
    first_ms, ms, fields = first_then_median(
        "f64 triangles", lambda: tuple(intersect_tris(bvh, flat, ry)[:5]),
        device, reps)
    out["f64"] = dict(first_ms=first_ms, ms=ms, mrays_s=f64_rays / ms / 1e3,
                      hits=int(torch.isfinite(fields[0]).sum()))
    log(f"# bench_dims 3D f64 triangles (wavefront), m={m}: {f64_rays} rays "
        f"in {ms:.3f} ms = {f64_rays / ms / 1e3:.3f} Mrays/s (first "
        f"{first_ms:.3f} ms), {out['f64']['hits']} hits")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--rays", type=int, default=262_144)
    ap.add_argument("--f64-rays", type=int, default=16_384)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.m, args.rays, args.f64_rays, args.reps, args.device)


if __name__ == "__main__":
    main()
