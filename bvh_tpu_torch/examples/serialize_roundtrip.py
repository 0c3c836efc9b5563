"""Serialization round-trip, mirroring the reference's serialize test
(reference: test/serialize.cpp) through the port: build a BVH serially
over two triangles, save it, load it back, and deep-compare; exit 1 on
a mismatch. The bytes are the C++ v2 format, which `bvh_tpu`, the
reference library and the native libbvh_c runtime read too. Runs on the
card unless `--device` names another device:

    python bvh_tpu_torch/examples/serialize_roundtrip.py [--device cpu]
"""

import argparse
import io
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch  # noqa: E402

from bvh_tpu_torch.api.flat import BuildConfig, bvh3f  # noqa: E402
from bvh_tpu_torch.build.default import Quality  # noqa: E402
from bvh_tpu_torch.geom.tri import Tri  # noqa: E402
from bvh_tpu_torch.io.serialize import bvh_equal  # noqa: E402


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
    bvh = bvh3f.build(bb_min, bb_max, tri.get_center(),
                      BuildConfig(quality=Quality.MEDIUM), parallel=False,
                      device=dev)
    stream = io.BytesIO()
    bvh3f.save(bvh, stream)
    stream.seek(0)
    again = bvh3f.load(stream, device=dev)
    if not bvh_equal(bvh, again):
        print("Roundtrip mismatch")
        return 1
    print(f"Roundtrip OK: {bvh3f.get_node_count(bvh)} nodes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
