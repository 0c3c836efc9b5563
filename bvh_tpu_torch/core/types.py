"""Core BVH data structures as flat tensors.

Counterpart of `bvh_tpu.core.types` (reference: src/bvh/v2/index.h,
node.h:18-57, bvh.h:16-31). The layout contracts are the same:

- a node's bounds are `2 * dim` scalars, interleaved
  `[min_x, max_x, min_y, max_y, ...]` (node.h:31-34);
- a node's index word packs `(first_id << 4) | prim_count`
  (index.h:74-78); `prim_count == 0` marks an inner node whose children
  are `first_id, first_id + 1`, and a leaf's primitives are
  `prim_ids[first_id : first_id + prim_count]`.

Index words and prim ids are carried as int64: torch's CPU build has
no uint32 shift, add or max. They are cast to the v2 format's unsigned
width only where bytes are written (io/serialize.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PRIM_COUNT_BITS = 4  # reference: node.h:22
MAX_PRIM_COUNT = (1 << PRIM_COUNT_BITS) - 1

# The C API's BVH_INVALID_PRIM_ID (c_api/bvh.h:33) as an int64 value.
INVALID_PRIM_ID = 0xFFFFFFFF


class Index:
    """Packed-index codec over int64 tensors (reference: index.h:32-82)."""

    @staticmethod
    def first_id(value):
        return value >> PRIM_COUNT_BITS

    @staticmethod
    def prim_count(value):
        return value & MAX_PRIM_COUNT

    @staticmethod
    def is_leaf(value):
        return Index.prim_count(value) != 0

    @staticmethod
    def is_inner(value):
        return Index.prim_count(value) == 0

    @staticmethod
    def make_leaf(first_prim, prim_count):
        return (torch.as_tensor(first_prim, dtype=torch.int64)
                << PRIM_COUNT_BITS) | torch.as_tensor(prim_count,
                                                      dtype=torch.int64)

    @staticmethod
    def make_inner(first_child):
        return torch.as_tensor(first_child, dtype=torch.int64) << PRIM_COUNT_BITS

    @staticmethod
    def set_first_id(value, first_id):
        return (torch.as_tensor(first_id, dtype=torch.int64)
                << PRIM_COUNT_BITS) | Index.prim_count(value)


class Bvh(NamedTuple):
    """A BVH as flat tensors (reference: bvh.h:16-31).

    bounds:     [node_capacity, 2*dim] float, interleaved min/max.
    index:      [node_capacity] int64 packed index words.
    prim_ids:   [prim_capacity] int64 primitive permutation.
    node_count: number of valid nodes.
    prim_count: number of valid prim ids.
    """

    bounds: torch.Tensor
    index: torch.Tensor
    prim_ids: torch.Tensor
    node_count: int
    prim_count: int

    @property
    def dim(self) -> int:
        return self.bounds.shape[-1] // 2

    @property
    def node_capacity(self) -> int:
        return self.bounds.shape[0]

    @property
    def scalar_dtype(self):
        return self.bounds.dtype

    # sibling-index helpers (reference: bvh.h:33-51): children are
    # allocated in pairs with the left child at an odd index.
    @staticmethod
    def is_left_sibling(node_id):
        return node_id % 2 == 1

    @staticmethod
    def get_sibling_id(node_id):
        return torch.where(Bvh.is_left_sibling(node_id), node_id + 1, node_id - 1)

    @staticmethod
    def get_left_sibling_id(node_id):
        return torch.where(Bvh.is_left_sibling(node_id), node_id, node_id - 1)

    @staticmethod
    def get_right_sibling_id(node_id):
        return torch.where(Bvh.is_left_sibling(node_id), node_id + 1, node_id)

    def get_node_bbox(self, node_id):
        """(min, max) vectors of a node (reference: node.h:46-50)."""
        row = self.bounds[node_id]
        return row[..., 0::2], row[..., 1::2]

    def root_bbox(self):
        return self.get_node_bbox(0)


def bvh_from_numpy(bounds, index, prim_ids, node_count, prim_count,
                   device) -> Bvh:
    """Carry a tree's arrays (numpy, e.g. a `bvh_tpu` Bvh's leaves after
    np.asarray) across into a port `Bvh` on `device`. Index words and
    prim ids widen to int64 without changing their values."""
    return Bvh(
        bounds=torch.as_tensor(np.array(bounds), device=device),
        index=torch.as_tensor(np.asarray(index).astype(np.int64),
                              device=device),
        prim_ids=torch.as_tensor(np.asarray(prim_ids).astype(np.int64),
                                 device=device),
        node_count=int(node_count),
        prim_count=int(prim_count),
    )


def node_capacity_for(prim_count: int, min_leaf_size: int = 1) -> int:
    """Node-array capacity of a binary BVH over `prim_count` primitives
    (2n - 1 bounds it)."""
    n = max(1, (prim_count + min_leaf_size - 1) // min_leaf_size)
    return max(1, 2 * n - 1)


def make_node_bounds_row(bbox_min, bbox_max):
    """Interleave (min, max) vectors into a `2*dim` bounds row
    (reference: node.h:52-57)."""
    return torch.stack([bbox_min, bbox_max], dim=-1).reshape(
        *bbox_min.shape[:-1], -1)
