"""Per-ray traversal results.

Counterpart of the result types of `bvh_tpu.traverse.wavefront`; the
generic wavefront traversal itself is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bvh_tpu_torch.core.types import INVALID_PRIM_ID


class TraversalStats(NamedTuple):
    visited_nodes: torch.Tensor  # [R] int
    visited_leaves: torch.Tensor  # [R] int


class Hit(NamedTuple):
    """Per-ray result. `prim_pos` indexes the tree's `prim_ids`;
    `prim_id` is the original primitive id. Both are INVALID_PRIM_ID
    (0xFFFFFFFF, as int64) on a miss, and `t` is +inf."""

    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    prim_pos: torch.Tensor
    prim_id: torch.Tensor
    stats: TraversalStats

    @property
    def hit(self):
        return self.prim_pos != INVALID_PRIM_ID
