from bvh_tpu_torch.traverse.binary_kernel import pallas_fits, pallas_intersect_tris
from bvh_tpu_torch.traverse.refit import compute_parents, leaf_of_position, refit
from bvh_tpu_torch.traverse.sphere_kernel import (
    pallas_fits_spheres,
    pallas_intersect_spheres,
)
from bvh_tpu_torch.traverse.stack import max_depth, required_stack_depth
from bvh_tpu_torch.traverse.wavefront import (
    Hit,
    TraversalStats,
    intersect_tris,
    make_sphere_leaf_fn,
    make_tri_leaf_fn,
    traverse,
)
from bvh_tpu_torch.traverse.wide import (
    WideBvh,
    intersect_tris_wide,
    traverse_wide,
    widen,
)
from bvh_tpu_torch.traverse.wide_treelet import (
    WideTreelets,
    build_wide_treelets,
    wide_treelet_intersect_tris,
    wide_treelets_from_numpy,
)

__all__ = [
    "Hit",
    "TraversalStats",
    "WideBvh",
    "WideTreelets",
    "build_wide_treelets",
    "compute_parents",
    "intersect_tris",
    "intersect_tris_wide",
    "leaf_of_position",
    "make_sphere_leaf_fn",
    "make_tri_leaf_fn",
    "max_depth",
    "pallas_fits",
    "pallas_fits_spheres",
    "pallas_intersect_spheres",
    "pallas_intersect_tris",
    "refit",
    "required_stack_depth",
    "traverse",
    "traverse_wide",
    "wide_treelet_intersect_tris",
    "wide_treelets_from_numpy",
    "widen",
]
