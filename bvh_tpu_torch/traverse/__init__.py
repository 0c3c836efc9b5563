from bvh_tpu_torch.traverse.binary_kernel import pallas_fits, pallas_intersect_tris
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
    "intersect_tris",
    "make_sphere_leaf_fn",
    "make_tri_leaf_fn",
    "max_depth",
    "pallas_fits",
    "pallas_fits_spheres",
    "pallas_intersect_spheres",
    "pallas_intersect_tris",
    "required_stack_depth",
    "traverse",
    "wide_treelet_intersect_tris",
    "wide_treelets_from_numpy",
]
