"""Canonical end-to-end usage, mirroring the reference's simple_example
(reference: test/simple_example.cpp) through the port: build a BVH over
two triangles with the default (high-quality) builder, permute the
primitive data, trace one closest-hit ray, print the hit, and exit 1 if
it is missed. Runs on the card unless `--device` names another device:

    python bvh_tpu_torch/examples/simple_example.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch  # noqa: E402

from bvh_tpu_torch.api.flat import BuildConfig, bvh3f  # noqa: E402
from bvh_tpu_torch.core.ray import Ray  # noqa: E402
from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri  # noqa: E402
from bvh_tpu_torch.traverse.wavefront import make_tri_leaf_fn  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    dev = parser.parse_args(argv).device

    def vec(rows):
        return torch.tensor(rows, dtype=torch.float32, device=dev)

    tri = Tri(vec([[1.0, -1.0, 1.0], [1.0, -1.0, 1.0]]),
              vec([[1.0, 1.0, 1.0], [-1.0, -1.0, 1.0]]),
              vec([[-1.0, 1.0, 1.0], [-1.0, 1.0, 1.0]]))
    bb_min, bb_max = tri.get_bbox()
    bvh = bvh3f.build(bb_min, bb_max, tri.get_center(), BuildConfig(),
                      device=dev)

    # Permuting the primitive data removes the traversal indirection
    # (reference: simple_example.cpp:54-64).
    flat = PrecomputedTri.from_tri(tri).as_flat()[bvh.prim_ids]
    leaf_fn = make_tri_leaf_fn(bvh, flat, permuted=True)

    rays = Ray.make(vec([[0.0, 0.0, 0.0]]), vec([[0.0, 0.0, 1.0]]),
                    tmin=0.0, tmax=100.0)
    hit = bvh3f.intersect_ray_robust(bvh, rays, leaf_fn)
    if not bool(hit.hit[0]):
        print("No intersection found")
        return 1
    print(
        f"Hit primitive {int(hit.prim_id[0])} at distance {float(hit.t[0]):.6f} "
        f"(u={float(hit.u[0]):.4f}, v={float(hit.v[0]):.4f})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
