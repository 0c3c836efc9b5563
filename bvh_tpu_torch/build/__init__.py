"""BVH builders of the port.

`default.build_default` selects the pipeline by quality, as the
reference's DefaultBuilder (default_builder.h): the parallel path is
`minitree_fast.build_minitree_fast` for float32 3D (Morton-grid groups,
one binned-SAH subtree per group through kernel B3, pruning, a sweep top
tree, the splice) and the level-synchronous `minitree.build_minitree`
for any other dim and float type, plus
`reinsertion.optimize_reinsertion` for HIGH; the serial path is
`binned.build_binned` for LOW and `sweep.build_sweep` for MEDIUM and
HIGH. `lbvh.build_lbvh` is the Karras linear BVH, outside the facade.
"""

from bvh_tpu_torch.build.binned import build_binned
from bvh_tpu_torch.build.canonicalize import canonicalize, extract_bvh
from bvh_tpu_torch.build.default import DefaultConfig, Quality, build_default
from bvh_tpu_torch.build.lbvh import LbvhConfig, build_lbvh
from bvh_tpu_torch.build.minitree import MiniTreeConfig, build_minitree
from bvh_tpu_torch.build.minitree_fast import build_minitree_fast
from bvh_tpu_torch.build.reinsertion import ReinsertionConfig, optimize_reinsertion
from bvh_tpu_torch.build.sah import SplitHeuristic, TopDownConfig
from bvh_tpu_torch.build.sweep import build_sweep

__all__ = [
    "DefaultConfig",
    "LbvhConfig",
    "MiniTreeConfig",
    "Quality",
    "ReinsertionConfig",
    "SplitHeuristic",
    "TopDownConfig",
    "build_binned",
    "build_default",
    "build_lbvh",
    "build_minitree",
    "build_minitree_fast",
    "build_sweep",
    "canonicalize",
    "extract_bvh",
    "optimize_reinsertion",
]
