from bvh_tpu_torch.geom.sphere import Sphere
from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri

__all__ = ["PrecomputedTri", "Sphere", "Tri"]
