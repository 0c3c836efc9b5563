"""Traversal stack sizing.

Counterpart of `bvh_tpu.traverse.stack` (reference: stack.h:10-46).
The port's traversals take a fixed per-ray stack capacity; this module
computes one that suffices for a given tree. A binary traversal pushes
at most one entry per level of its descent, so the height bounds its
stack; a wide traversal pushes at most WIDTH - 1 entries per wide level.
"""

from __future__ import annotations

import torch

from bvh_tpu_torch.core.types import Bvh
from bvh_tpu_torch.traverse.refit import node_depths

DEFAULT_STACK_DEPTH = 64  # the reference's universal choice


def max_depth(bvh: Bvh) -> int:
    """Height of the tree (root depth = 0)."""
    cap = bvh.index.shape[0]
    valid = torch.arange(cap, device=bvh.index.device) < bvh.node_count
    return int(torch.where(valid, node_depths(bvh), 0).max())


def required_stack_depth(bvh: Bvh, wide: bool = False) -> int:
    """A per-ray stack capacity that suffices for `bvh`: height + 1 for
    the binary traversal, (height // 3 + 1) * 7 for the wide one; at
    least 8."""
    h = max_depth(bvh)
    if wide:
        return max(8, (h // 3 + 1) * 7)
    return max(8, h + 1)
