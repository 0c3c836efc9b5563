from bvh_tpu_torch.io.obj import load_obj
from bvh_tpu_torch.io.ppm import save_ppm
from bvh_tpu_torch.io.serialize import deserialize, load_bvh, save_bvh, serialize

__all__ = ["load_obj", "save_ppm", "serialize", "deserialize", "save_bvh",
           "load_bvh"]
