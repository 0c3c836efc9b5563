"""Multi-device scaling over torch.distributed (counterpart of
`bvh_tpu.par`): the ray-sharded traversal and the rank-sharded
mini-tree build, with the executors in `par.executor`."""

from bvh_tpu_torch.par.mesh import (
    intersect_tris_sharded,
    make_mesh,
    shard_rays,
)
from bvh_tpu_torch.par.minitree_sharded import build_minitree_sharded

__all__ = [
    "make_mesh",
    "shard_rays",
    "intersect_tris_sharded",
    "build_minitree_sharded",
]
