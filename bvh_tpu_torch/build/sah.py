"""SAH cost model and the shared top-down builder configuration.

Counterpart of `bvh_tpu.build.sah` (reference: split_heuristic.h,
top_down_sah_builder.h:27-40). Names and defaults match the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from bvh_tpu_torch.core import bbox as bbox_ops
from bvh_tpu_torch.core.types import MAX_PRIM_COUNT


@dataclasses.dataclass(frozen=True)
class SplitHeuristic:
    """SAH evaluator (reference: split_heuristic.h:11-44):
    `log_cluster_size` is log2 of the primitive cluster size,
    `cost_ratio` the cost of a node test over a primitive test."""

    log_cluster_size: int = 0
    cost_ratio: float = 1.0

    @property
    def prim_offset(self) -> int:
        return (1 << self.log_cluster_size) - 1

    def get_prim_count(self, size):
        """(size + offset) >> log_cluster_size (split_heuristic.h:26-28)."""
        return (size + self.prim_offset) >> self.log_cluster_size

    def get_leaf_cost(self, size, half_area):
        """half_area * rounded prim count (split_heuristic.h:31-33)."""
        return half_area * self.get_prim_count(size).to(half_area.dtype)

    def get_non_split_cost(self, size, half_area):
        """half_area * (rounded prim count - cost_ratio)
        (split_heuristic.h:36-38)."""
        counts = self.get_prim_count(size).to(half_area.dtype)
        return half_area * (counts - torch.tensor(self.cost_ratio,
                                                  dtype=half_area.dtype))


@dataclasses.dataclass(frozen=True)
class TopDownConfig:
    """Shared top-down builder config (top_down_sah_builder.h:27-40):
    min_leaf_size=1, max_leaf_size=8."""

    sah: SplitHeuristic = dataclasses.field(default_factory=SplitHeuristic)
    min_leaf_size: int = 1
    max_leaf_size: int = 8

    def __post_init__(self):
        if self.min_leaf_size > self.max_leaf_size:
            raise ValueError("min_leaf_size must not exceed max_leaf_size")
        if self.max_leaf_size > MAX_PRIM_COUNT:
            raise ValueError(f"max_leaf_size must fit the packed index "
                             f"(<= {MAX_PRIM_COUNT}, index.h:38)")


def node_half_area(bounds_row):
    """Half-area of interleaved [..., 2*dim] node bounds rows."""
    return bbox_ops.get_half_area(bounds_row[..., 0::2], bounds_row[..., 1::2])
