from bvh_tpu_torch.traverse.wavefront import Hit, TraversalStats
from bvh_tpu_torch.traverse.wide_treelet import (
    WideTreelets,
    build_wide_treelets,
    wide_treelet_intersect_tris,
    wide_treelets_from_numpy,
)

__all__ = [
    "Hit",
    "TraversalStats",
    "WideTreelets",
    "build_wide_treelets",
    "wide_treelet_intersect_tris",
    "wide_treelets_from_numpy",
]
