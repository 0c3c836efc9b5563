"""Parents, node depths, prim-position ownership and bottom-up refit.

Counterpart of `bvh_tpu.traverse.refit` (reference: bvh.h:184-218). The
refit is a wavefront up the tree: each pass recomputes every inner node
whose two children are done, so it converges in tree-height passes.
"""

from __future__ import annotations

import torch

from bvh_tpu_torch.core.types import Bvh, Index, make_node_bounds_row

_I64 = torch.int64


def compute_parents(bvh: Bvh) -> torch.Tensor:
    """parents[child] = parent for every node; parents[0] = 0
    (reference: reinsertion_optimizer.h:71-86)."""
    return parents_of(bvh.index, bvh.node_count)


def parents_of(index, node_count: int) -> torch.Tensor:
    """`compute_parents` from the index words and the node count; the
    parents of the root and of unused slots are 0."""
    cap = index.shape[0]
    ids = torch.arange(cap, dtype=_I64, device=index.device)
    inner = (ids < node_count) & Index.is_inner(index)
    first = Index.first_id(index)
    parents = torch.zeros(cap, dtype=_I64, device=index.device)
    parents[first[inner]] = ids[inner]
    parents[first[inner] + 1] = ids[inner]
    return parents


def leaf_of_position(bvh: Bvh) -> torch.Tensor:
    """For each position of `prim_ids`, the id of the leaf that owns it
    (leaves tile the positions; each leaf is marked at its first
    position and the marks are carried forward)."""
    cap = bvh.index.shape[0]
    n = bvh.prim_ids.shape[0]
    dev = bvh.index.device
    ids = torch.arange(cap, dtype=_I64, device=dev)
    leaf = Index.is_leaf(bvh.index) & (ids < bvh.node_count)
    starts = torch.full((n,), -1, dtype=_I64, device=dev)
    starts.scatter_reduce_(0, Index.first_id(bvh.index)[leaf], ids[leaf],
                           "amax")
    marked = torch.where(starts >= 0, torch.arange(n, device=dev), -1)
    last = torch.cummax(marked, 0).values
    return torch.where(last >= 0, starts[last.clamp(min=0)], -1)


def refit(bvh: Bvh, prim_bb_min=None, prim_bb_max=None) -> Bvh:
    """Recompute all node bounds bottom-up (reference: bvh.h:210-218).
    With prim boxes (indexed by original prim id) leaf bounds are
    recomputed from them first; otherwise only inner bounds change."""
    cap = bvh.index.shape[0]
    dev = bvh.index.device
    ids = torch.arange(cap, dtype=_I64, device=dev)
    valid = ids < bvh.node_count
    is_leaf = Index.is_leaf(bvh.index) & valid
    first = Index.first_id(bvh.index)
    bounds = bvh.bounds

    if prim_bb_min is not None:
        dim = prim_bb_min.shape[1]
        owner = leaf_of_position(bvh)
        prim = bvh.prim_ids
        big = torch.finfo(prim_bb_min.dtype).max
        ok = owner >= 0
        idx = owner[ok][:, None].expand(-1, dim)
        leaf_mn = torch.full((cap, dim), big, dtype=prim_bb_min.dtype,
                             device=dev).scatter_reduce(
            0, idx, prim_bb_min[prim[ok]], "amin")
        leaf_mx = torch.full((cap, dim), -big, dtype=prim_bb_max.dtype,
                             device=dev).scatter_reduce(
            0, idx, prim_bb_max[prim[ok]], "amax")
        bounds = torch.where(is_leaf[:, None],
                             make_node_bounds_row(leaf_mn, leaf_mx), bounds)

    left = first.clamp(0, cap - 1)
    right = (first + 1).clamp(0, cap - 1)
    done = is_leaf | ~valid
    while bool((valid & ~done).any()):
        can = valid & ~done & ~is_leaf & done[left] & done[right]
        lrow, rrow = bounds[left], bounds[right]
        merged = make_node_bounds_row(
            torch.minimum(lrow[:, 0::2], rrow[:, 0::2]),
            torch.maximum(lrow[:, 1::2], rrow[:, 1::2]))
        bounds = torch.where(can[:, None], merged, bounds)
        done = done | can
    return bvh._replace(bounds=bounds)


def node_depths(bvh: Bvh) -> torch.Tensor:
    """Depth of each node from the root (root = 0), one hop up the
    parents array per pass. Unused slots read as depth 1."""
    cap = bvh.index.shape[0]
    dev = bvh.index.device
    parents = compute_parents(bvh)
    depth = (torch.arange(cap, device=dev) != 0).to(_I64)
    hop = parents
    while bool((hop != 0).any()):
        depth = depth + (hop != 0).to(_I64)
        hop = parents[hop]
    return depth
