from bvh_tpu_torch.io.serialize import deserialize, load_bvh, save_bvh, serialize

__all__ = ["serialize", "deserialize", "save_bvh", "load_bvh"]
