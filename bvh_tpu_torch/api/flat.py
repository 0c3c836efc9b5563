"""Flat, C-API-shaped functional surface.

Counterpart of `bvh_tpu.api.flat` (reference: src/bvh/v2/c_api/bvh.h):
one namespace per (scalar, dimension) pair, `bvh2f`, `bvh3f`, `bvh2d`
and `bvh3d`, each with build / save / load, the accessors, append and
remove node, refit, optimize and the four intersect variants
(closest/any x fast/robust, c_api/bvh.h:277-295).

As in `bvh_tpu`: there are no thread-pool handles (`build`'s `parallel`
flag selects the mini-tree path as a non-NULL pool does,
c_api/bvh.h:95-99); intersections are batched, over arrays of rays and a
vectorized leaf intersector; mutators return the new tree.

`build` and `load` put the tree on the card unless the caller names
another device; the intersections run on the rays' device, through the
wavefront, which takes any dim and float type. Every namespace builds
through `build_default`: `bvh3f`'s parallel path is the fast mini-tree
build (kernel B3), the other namespaces' is the level-synchronous
`build_minitree`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from bvh_tpu_torch.build.default import DefaultConfig, Quality, build_default
from bvh_tpu_torch.build.reinsertion import ReinsertionConfig, optimize_reinsertion
from bvh_tpu_torch.build.sah import SplitHeuristic
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.core.types import Bvh, Index, make_node_bounds_row
from bvh_tpu_torch.io.serialize import deserialize, load_bvh, save_bvh, serialize
from bvh_tpu_torch.traverse.refit import refit as _refit
from bvh_tpu_torch.traverse.wavefront import traverse

# reference: c_api/bvh.h:32-33.
BVH_ROOT_INDEX = 0
BVH_INVALID_PRIM_ID = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """reference: c_api/bvh.h:47-58 (bvh_build_config)."""

    quality: Quality = Quality.HIGH
    min_leaf_size: int = 1
    max_leaf_size: int = 8
    parallel_threshold: int = 1024


class FlatApi:
    """The functional surface for one (scalar, dim) pair."""

    def __init__(self, scalar_dtype: torch.dtype, dim: int):
        self.scalar_dtype = scalar_dtype
        self.dim = dim

    def _tensor(self, x, device):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=self.scalar_dtype, device=device)

    # --- construction (reference: c_api/bvh.h:99-125) ------------------
    def build(self, bboxes_min, bboxes_max, centers,
              config: BuildConfig | None = None, parallel: bool = True,
              device="cuda") -> Bvh:
        config = config or BuildConfig()
        mn, mx, c = (self._tensor(x, device)
                     for x in (bboxes_min, bboxes_max, centers))
        if c.dim() != 2 or c.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}] inputs, got "
                             f"{list(c.shape)}")
        dc = DefaultConfig(sah=SplitHeuristic(),
                           min_leaf_size=config.min_leaf_size,
                           max_leaf_size=config.max_leaf_size,
                           quality=config.quality,
                           parallel_threshold=config.parallel_threshold)
        return build_default(mn, mx, c, dc, parallel=parallel)

    # --- persistence (reference: c_api/bvh.h:136-144) ------------------
    def save(self, bvh: Bvh, path_or_stream) -> None:
        if hasattr(path_or_stream, "write"):
            serialize(bvh, path_or_stream)
        else:
            save_bvh(bvh, path_or_stream)

    def load(self, path_or_stream, device="cuda") -> Bvh:
        np_dtype = torch.empty((), dtype=self.scalar_dtype).numpy().dtype
        if hasattr(path_or_stream, "read"):
            return deserialize(path_or_stream, self.dim, np_dtype, device)
        return load_bvh(path_or_stream, self.dim, np_dtype, device)

    # --- accessors (reference: c_api/bvh.h:148-203) --------------------
    def get_node_count(self, bvh: Bvh) -> int:
        return int(bvh.node_count)

    def get_prim_count(self, bvh: Bvh) -> int:
        return int(bvh.prim_count)

    def get_prim_id(self, bvh: Bvh, i) -> int:
        return int(bvh.prim_ids[i])

    def get_node(self, bvh: Bvh, i):
        """((min, max), first_id, prim_count) of node i."""
        mn, mx = bvh.get_node_bbox(i)
        word = bvh.index[i]
        return ((mn.cpu().numpy(), mx.cpu().numpy()),
                int(Index.first_id(word)), int(Index.prim_count(word)))

    def set_node_bbox(self, bvh: Bvh, i, mn, mx) -> Bvh:
        dev = bvh.bounds.device
        bounds = bvh.bounds.clone()
        bounds[i] = make_node_bounds_row(self._tensor(mn, dev),
                                         self._tensor(mx, dev))
        return bvh._replace(bounds=bounds)

    # --- node surgery (reference: c_api/bvh.h:211-219) -----------------
    def append_node(self, bvh: Bvh, mn, mx, first_id: int,
                    prim_count: int) -> Bvh:
        """Append a node, growing the capacity by one when it is full."""
        dev = bvh.bounds.device
        nc = int(bvh.node_count)
        bounds, index = bvh.bounds.clone(), bvh.index.clone()
        if nc >= bounds.shape[0]:
            bounds = torch.cat([bounds, torch.zeros_like(bounds[:1])])
            index = torch.cat([index, torch.zeros_like(index[:1])])
        bounds[nc] = make_node_bounds_row(self._tensor(mn, dev),
                                          self._tensor(mx, dev))
        index[nc] = (Index.make_leaf(first_id, prim_count) if prim_count
                     else Index.make_inner(first_id))
        return bvh._replace(bounds=bounds, index=index, node_count=nc + 1)

    def remove_last_node(self, bvh: Bvh) -> Bvh:
        return bvh._replace(node_count=max(int(bvh.node_count) - 1, 1))

    # --- refit / optimize (reference: c_api/bvh.h:221-229) -------------
    def refit(self, bvh: Bvh, prim_bb_min=None, prim_bb_max=None) -> Bvh:
        dev = bvh.bounds.device
        if prim_bb_min is not None:
            prim_bb_min = self._tensor(prim_bb_min, dev)
            prim_bb_max = self._tensor(prim_bb_max, dev)
        return _refit(bvh, prim_bb_min, prim_bb_max)

    def optimize(self, bvh: Bvh,
                 config: ReinsertionConfig | None = None) -> Bvh:
        return optimize_reinsertion(bvh, config)

    # --- intersections (reference: c_api/bvh.h:277-295) ----------------
    def intersect_ray(self, bvh: Bvh, rays: Ray, leaf_fn: Callable, **kw):
        return traverse(bvh, rays, leaf_fn, any_hit=False, robust=False, **kw)

    def intersect_ray_robust(self, bvh: Bvh, rays: Ray, leaf_fn: Callable,
                             **kw):
        return traverse(bvh, rays, leaf_fn, any_hit=False, robust=True, **kw)

    def intersect_ray_any(self, bvh: Bvh, rays: Ray, leaf_fn: Callable, **kw):
        return traverse(bvh, rays, leaf_fn, any_hit=True, robust=False, **kw)

    def intersect_ray_any_robust(self, bvh: Bvh, rays: Ray,
                                 leaf_fn: Callable, **kw):
        return traverse(bvh, rays, leaf_fn, any_hit=True, robust=True, **kw)


# One namespace per (scalar, dim), as the C API's name mangling
# (reference: c_api/bvh_impl.h:252-353).
bvh2f = FlatApi(torch.float32, 2)
bvh3f = FlatApi(torch.float32, 3)
bvh2d = FlatApi(torch.float64, 2)
bvh3d = FlatApi(torch.float64, 3)
