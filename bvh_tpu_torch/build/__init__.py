"""BVH builders of the port: the device build of a quality-high tree.

`minitree_fast.build_minitree_fast` (Morton-grid groups, one binned-SAH
subtree per group through kernel B3, pruning, a sweep top tree, the
splice) followed by `reinsertion.optimize_reinsertion` is the
reference's High pipeline (default_builder.h:33-46), as `bvh_tpu` runs
it on its device. The other builders of `bvh_tpu.build` (binned, lbvh,
the level-synchronous mini-tree, `build_default`) are not ported yet.
"""

from bvh_tpu_torch.build.canonicalize import canonicalize, extract_bvh
from bvh_tpu_torch.build.minitree import MiniTreeConfig
from bvh_tpu_torch.build.minitree_fast import build_minitree_fast
from bvh_tpu_torch.build.reinsertion import ReinsertionConfig, optimize_reinsertion
from bvh_tpu_torch.build.sah import SplitHeuristic, TopDownConfig
from bvh_tpu_torch.build.sweep import build_sweep

__all__ = [
    "MiniTreeConfig",
    "ReinsertionConfig",
    "SplitHeuristic",
    "TopDownConfig",
    "build_minitree_fast",
    "build_sweep",
    "canonicalize",
    "extract_bvh",
    "optimize_reinsertion",
]
