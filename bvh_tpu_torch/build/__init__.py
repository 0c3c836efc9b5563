"""BVH builders of the port.

`default.build_default` selects the pipeline by quality, as the
reference's DefaultBuilder (default_builder.h): the parallel path is
`minitree_fast.build_minitree_fast` (Morton-grid groups, one binned-SAH
subtree per group through kernel B3, pruning, a sweep top tree, the
splice), plus `reinsertion.optimize_reinsertion` for HIGH; the serial
path is `binned.build_binned` for LOW and `sweep.build_sweep` for MEDIUM
and HIGH. The level-synchronous `build_minitree` and `lbvh` of
`bvh_tpu.build` are not ported yet (ROADMAP A9).
"""

from bvh_tpu_torch.build.binned import build_binned
from bvh_tpu_torch.build.canonicalize import canonicalize, extract_bvh
from bvh_tpu_torch.build.default import DefaultConfig, Quality, build_default
from bvh_tpu_torch.build.minitree import MiniTreeConfig
from bvh_tpu_torch.build.minitree_fast import build_minitree_fast
from bvh_tpu_torch.build.reinsertion import ReinsertionConfig, optimize_reinsertion
from bvh_tpu_torch.build.sah import SplitHeuristic, TopDownConfig
from bvh_tpu_torch.build.sweep import build_sweep

__all__ = [
    "DefaultConfig",
    "MiniTreeConfig",
    "Quality",
    "ReinsertionConfig",
    "SplitHeuristic",
    "TopDownConfig",
    "build_binned",
    "build_default",
    "build_minitree_fast",
    "build_sweep",
    "canonicalize",
    "extract_bvh",
    "optimize_reinsertion",
]
