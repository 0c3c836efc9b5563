"""The port's two mini-tree builds agree: on float32 3D the
level-synchronous `build_minitree` equals `build_minitree_fast` (kernel
B3's plain version) on sponza_class(3000, 5), as bvh_tpu documents its
two builds (build/default.py:63-67). Both with the port's own rounding,
pruning off (LOW) and at MEDIUM's ratio 0.1.
"""

import pytest
import torch

from bvh_tpu_torch.build.minitree import MiniTreeConfig, build_minitree
from bvh_tpu_torch.build.minitree_fast import build_minitree_fast
from bvh_tpu_torch.geom.tri import Tri
from bvh_tpu_torch.io.scenes import sponza_class


@pytest.mark.parametrize("quality", ["low", "medium"])
def test_build_minitree_equals_minitree_fast(quality):
    tris = torch.from_numpy(sponza_class(3000, seed=5))
    tri = Tri(tris[:, 0], tris[:, 1], tris[:, 2])
    mn, mx = tri.get_bbox()
    cfg = MiniTreeConfig(enable_pruning=quality != "low",
                         pruning_area_ratio=0.1)
    a = build_minitree(mn, mx, tri.get_center(), cfg)
    b = build_minitree_fast(mn, mx, tri.get_center(), cfg)
    nc = a.node_count
    assert nc == b.node_count
    assert torch.equal(a.bounds[:nc], b.bounds[:nc])
    assert torch.equal(a.index[:nc], b.index[:nc])
    assert torch.equal(a.prim_ids, b.prim_ids)
