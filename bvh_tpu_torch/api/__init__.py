from bvh_tpu_torch.api.flat import FlatApi, bvh2d, bvh2f, bvh3d, bvh3f

__all__ = ["FlatApi", "bvh2f", "bvh3f", "bvh2d", "bvh3d"]
