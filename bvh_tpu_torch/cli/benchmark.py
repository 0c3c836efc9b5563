"""Benchmark / renderer CLI, flag-compatible with the reference
benchmark tool (reference: test/benchmark.cpp:36-58 for the options,
340-436 for the pipeline): loads an OBJ, builds a BVH at the requested
quality, renders WxH primary rays (eyelight shading, or a traversal
heat map in debug mode), reports build/render times and intersection
counts, and writes a PPM (rows bottom-up like the reference's
Image::save, benchmark.cpp:250-255). Counterpart of
`bvh_tpu.cli.benchmark`.

It runs on the card unless `--device cpu` is given. Render paths, by
the reference's rule (`bvh_tpu` cli/benchmark.py:114-167), on a CUDA
device: a scene within the single-launch kernel's caps takes the binary
traversal (kernel B5); any other 3D float32 scene the wide-treelet
render at max_prims=1024 (kernels B2, B1 and, for scenes with a super
level, B4); on the CPU the wavefront. Shading and the heat map are
numpy on the host.

Usage: python -m bvh_tpu_torch.cli.benchmark [options] file.obj
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple

import numpy as np
import torch


def profile(fn, iters: int = 1, device="cpu"):
    """Median-of-N timing (reference: benchmark.cpp:60-71): CUDA events
    around each call on a CUDA device, the host clock otherwise.
    Returns (result, seconds)."""
    cuda = torch.device(device).type == "cuda"
    times = []
    result = None
    for _ in range(max(1, iters)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            result = fn()
            times.append(time.perf_counter() - t0)
    times.sort()
    return result, times[len(times) // 2]


def intensity_to_color(t):
    """Heat-map ramp for debug mode (the ramp of `bvh_tpu`'s CLI)."""
    t = np.clip(t, 0.0, 1.0)
    r = np.clip(1.5 * t, 0, 1)
    g = np.clip(1.5 * (t - 0.33), 0, 1)
    b = np.clip(1.5 * (t - 0.66), 0, 1)
    return np.stack([r, g, b], axis=-1)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="benchmark", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input_model")
    p.add_argument("-q", "--quality", choices=["low", "med", "medium", "high"],
                   default="high")
    p.add_argument("-p", "--permute-primitives", action="store_true",
                   dest="permute_prims")
    p.add_argument("-i", "--build-iterations", type=int, default=1)
    p.add_argument("--robust-traversal", action="store_true")
    p.add_argument("-e", "--eye", nargs=3, type=float, default=[0, 0, 0])
    p.add_argument("-d", "--dir", nargs=3, type=float, default=[0, 0, 1])
    p.add_argument("-u", "--up", nargs=3, type=float, default=[0, 1, 0])
    p.add_argument("--fov", type=float, default=None,
                   help="accepted for reference flag parity; unused, as in "
                        "the reference")
    p.add_argument("-w", "--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("-m", "--render-mode", choices=["eyelight", "debug"],
                   default="eyelight")
    p.add_argument("-o", "--output", default="render.ppm")
    p.add_argument("--debug-threshold", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to build and render on (default: "
                        "the card)")
    return p


class RunResult(NamedTuple):
    """What `run` computed, for callers that check it."""

    bvh: object
    flat: torch.Tensor
    rays: object
    hit: object
    path: str              # "binary", "wide_treelet" or "wavefront"
    tl: object             # the treelet scene on the wide path, else None
    build_s: float
    treelets_s: float      # build_wide_treelets, 0 off the wide path
    render_s: float
    image: np.ndarray      # the PPM's pixels, rows bottom-up


def image_for(hit, flat, rays, args) -> np.ndarray:
    """The PPM's pixels [H, W, 3] uint8, rows bottom-up
    (benchmark.cpp:252-254), in numpy on the host: eyelight shading
    |dot(normalize(n), ray.dir)| (benchmark.cpp:363-366), or in debug
    mode the heat map of inner steps plus leaves entered (printing their
    totals)."""
    W, H = args.width, args.height
    hit_mask = hit.hit.cpu().numpy()
    if args.render_mode == "eyelight":
        prim = (hit.prim_pos if args.permute_prims else hit.prim_id)
        tri_idx = np.where(hit_mask, prim.cpu().numpy(), 0).astype(np.int64)
        n_vec = flat.cpu().numpy()[tri_idx, 9:12]
        n_vec = n_vec / np.maximum(
            np.linalg.norm(n_vec, axis=-1, keepdims=True), 1e-30)
        d = rays.dir.cpu().numpy()
        intensity = np.abs(np.sum(n_vec * d, axis=-1))
        intensity = np.where(hit_mask, intensity, 0.0)
        pix = np.clip((intensity * 256).astype(np.int32), 0,
                      255).astype(np.uint8)
        img = np.repeat(pix.reshape(H, W, 1), 3, axis=2)
    else:
        nodes = hit.stats.visited_nodes.cpu().numpy()
        leaves = hit.stats.visited_leaves.cpu().numpy()
        steps = nodes + leaves
        print(f"Traversal visited {int(nodes.sum())} nodes and "
              f"{int(leaves.sum())} leaves")
        thr = args.debug_threshold or max(1, int(steps.max()))
        img = (intensity_to_color(steps.reshape(H, W) / thr)
               * 255).astype(np.uint8)
    return img[::-1]


def render_path(bvh, flat, device) -> str:
    """The render path by the reference's rule (`bvh_tpu`
    cli/benchmark.py:114-129), with "on an accelerator" read as "on a
    CUDA device": "binary" (kernel B5) for a scene within the
    single-launch kernel's caps, "wide_treelet" for any other 3D float32
    scene, else "wavefront"."""
    from bvh_tpu_torch.traverse.binary_kernel import pallas_fits

    if torch.device(device).type != "cuda":
        return "wavefront"
    if pallas_fits(bvh, flat):
        return "binary"
    if bvh.dim == 3 and bvh.bounds.dtype == torch.float32:
        return "wide_treelet"
    return "wavefront"


def run(p0, p1, p2, args) -> RunResult:
    """Everything after the OBJ load: build, refit, render, shade and
    write the PPM, printing the reference's lines. p0, p1, p2 are
    [n, 3] vertex arrays; `args` as `parser()` parses them."""
    from bvh_tpu_torch.api.flat import BuildConfig, bvh3f
    from bvh_tpu_torch.build.default import Quality
    from bvh_tpu_torch.cli.camera import primary_rays
    from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
    from bvh_tpu_torch.io.ppm import save_ppm
    from bvh_tpu_torch.traverse.binary_kernel import pallas_intersect_tris
    from bvh_tpu_torch.traverse.wavefront import intersect_tris
    from bvh_tpu_torch.traverse.wide_treelet import (
        build_wide_treelets,
        wide_treelet_intersect_tris,
    )

    dev = torch.device(args.device)
    tri = Tri(*(torch.as_tensor(np.asarray(p, np.float32), device=dev)
                for p in (p0, p1, p2)))
    bb_min, bb_max = tri.get_bbox()
    centers = tri.get_center()
    quality = {"low": Quality.LOW, "med": Quality.MEDIUM,
               "medium": Quality.MEDIUM, "high": Quality.HIGH}[args.quality]
    config = BuildConfig(quality=quality)

    bvh, build_s = profile(
        lambda: bvh3f.build(bb_min, bb_max, centers, config, device=dev),
        args.build_iterations, dev)
    print(f"Built BVH with {int(bvh.node_count)} node(s) in "
          f"{build_s * 1e3:.0f}ms")

    # Not needed, just for testing (reference: benchmark.cpp:420).
    bvh = bvh3f.refit(bvh, bb_min, bb_max)

    flat = PrecomputedTri.from_tri(tri).as_flat()
    if args.permute_prims:
        flat = flat[bvh.prim_ids]

    rays = primary_rays(args.eye, args.dir, args.up, args.width, args.height,
                        device=dev)

    tl, treelets_s = None, 0.0
    path = render_path(bvh, flat, dev)
    if path == "binary":
        def do_render():
            return pallas_intersect_tris(bvh, flat, rays,
                                         robust=args.robust_traversal,
                                         permuted=args.permute_prims)
    elif path == "wide_treelet":
        tl, treelets_s = profile(
            lambda: build_wide_treelets(bvh, flat,
                                        permuted=args.permute_prims,
                                        max_prims=1024), 1, dev)
        wide_prim_ids = None if args.permute_prims else bvh.prim_ids

        def do_render():
            return wide_treelet_intersect_tris(
                tl, rays, robust=args.robust_traversal,
                prim_ids=wide_prim_ids)
    else:
        def do_render():
            return intersect_tris(bvh, flat, rays,
                                  robust=args.robust_traversal,
                                  permuted=args.permute_prims)

    hit, render_s = profile(do_render, 1, dev)
    print(f"{int(hit.hit.sum())} intersection(s) found in "
          f"{render_s * 1e3:.0f}ms")

    image = image_for(hit, flat, rays, args)
    save_ppm(args.output, image)
    print(f"Image saved as '{args.output}'")
    return RunResult(bvh, flat, rays, hit, path, tl, build_s, treelets_s,
                     render_s, image)


def main(argv=None) -> int:
    from bvh_tpu_torch.io.obj import load_obj

    args = parser().parse_args(argv)
    try:
        p0, p1, p2 = load_obj(args.input_model)
    except OSError:
        # The reference's loader returns an empty triangle list for
        # unreadable files (load_obj.cpp:99-104): same message, exit 1.
        p0 = p1 = p2 = []
    if len(p0) == 0:
        print("No triangle was found in input OBJ file", file=sys.stderr)
        return 1
    print(f"Loaded file with {len(p0)} triangle(s)")
    run(p0, p1, p2, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
