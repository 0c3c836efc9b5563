from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.core.types import Bvh, Index

__all__ = ["Bvh", "Index", "Ray"]
