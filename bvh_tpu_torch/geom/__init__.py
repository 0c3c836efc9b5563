from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri

__all__ = ["Tri", "PrecomputedTri"]
