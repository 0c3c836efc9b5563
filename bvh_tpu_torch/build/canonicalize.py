"""Tree surgery: drop leaves, contract single-child chains, re-emit.

Counterpart of `bvh_tpu.build.canonicalize`, the generalization of
`Bvh::extract_bvh` (reference: bvh.h:91-122): given a keep-mask over
leaves (and optionally a new root) it removes the dropped leaves,
contracts inner nodes left with one child, and re-emits a compact BVH
with children again in adjacent pairs, left child at an odd index
(bvh.h:33-39). Nodes are emitted in BFS rounds, as in `bvh_tpu`.
"""

from __future__ import annotations

import torch

from bvh_tpu_torch.core.types import Bvh, Index
from bvh_tpu_torch.traverse.refit import leaf_of_position

_I64 = torch.int64


def canonicalize(bvh: Bvh, keep_leaf, new_root: int = 0) -> Bvh:
    """Rebuild `bvh` keeping only the leaves with `keep_leaf[node_id]`,
    re-rooted at old node `new_root` (which must keep at least one
    leaf). Array capacities are unchanged; prim positions are renumbered
    compactly in BFS leaf order."""
    cap = bvh.index.shape[0]
    n = bvh.prim_ids.shape[0]
    dev = bvh.index.device
    ids = torch.arange(cap, dtype=_I64, device=dev)
    valid = ids < bvh.node_count
    is_leaf = Index.is_leaf(bvh.index) & valid
    is_inner = ~is_leaf & valid
    first = Index.first_id(bvh.index)
    count = Index.prim_count(bvh.index)
    l = first.clamp(0, cap - 1)
    r = (first + 1).clamp(0, cap - 1)

    # alive propagation, bottom-up wavefront
    alive = is_leaf & keep_leaf
    done = is_leaf | ~valid
    while bool((valid & ~done).any()):
        can = is_inner & ~done & done[l] & done[r]
        alive = torch.where(can, alive[l] | alive[r], alive)
        done = done | can

    # forwarding: an inner node with one alive child contracts into it
    both = is_inner & alive[l] & alive[r]
    one_l = is_inner & alive[l] & ~alive[r]
    one_r = is_inner & ~alive[l] & alive[r]
    fwd = torch.where(one_l, l, torch.where(one_r, r, ids))
    rep = fwd
    while bool((fwd[rep] != rep).any()):
        rep = fwd[rep]

    kept = alive & (both | (is_leaf & keep_leaf))
    eff_l = rep[l]
    eff_r = rep[r]

    # BFS re-emission: allocate child pairs level by level
    root_old = rep[new_root]
    new_of_old = torch.full((cap,), -1, dtype=_I64, device=dev)
    new_of_old[root_old] = 0
    frontier = torch.zeros(cap, dtype=torch.bool, device=dev)
    frontier[root_old] = True
    counter = 1
    while bool(frontier.any()):
        par = frontier & both & kept
        par_i = par.to(_I64)
        base = counter + 2 * (torch.cumsum(par_i, 0) - par_i)
        new_of_old[eff_l[par]] = base[par]
        new_of_old[eff_r[par]] = base[par] + 1
        frontier = torch.zeros(cap, dtype=torch.bool, device=dev)
        frontier[eff_l[par]] = True
        frontier[eff_r[par]] = True
        counter += 2 * int(par_i.sum())
    new_count = counter

    # gather node payloads into the new order
    assigned = new_of_old >= 0
    old_of_new = torch.full((cap,), cap, dtype=_I64, device=dev)
    old_of_new[new_of_old[assigned]] = ids[assigned]
    src = old_of_new.clamp(0, cap - 1)
    new_valid = ids < new_count
    new_bounds = torch.where(new_valid[:, None], bvh.bounds[src], 0)

    # renumber prim positions compactly in the new leaf order
    new_is_leaf = is_leaf[src] & new_valid
    counts_new = torch.where(new_is_leaf, count[src], 0)
    new_first_prim = torch.cumsum(counts_new, 0) - counts_new
    new_prim_count = int(counts_new.sum())
    inner_word = Index.make_inner(
        new_of_old[eff_l[src].clamp(0, cap - 1)].clamp(min=0))
    leaf_word = Index.make_leaf(new_first_prim.clamp(min=0),
                                counts_new.clamp(min=1))
    new_index = torch.where(new_valid,
                            torch.where(new_is_leaf, leaf_word, inner_word), 0)

    # move each prim owned by a kept leaf to the leaf's new offset
    owner = leaf_of_position(bvh)
    owner_c = owner.clamp(0, cap - 1)
    new_leaf_id = new_of_old[owner_c]
    moved = kept[owner_c] & (owner >= 0) & (new_leaf_id >= 0)
    pos = torch.arange(n, dtype=_I64, device=dev)
    dest = new_first_prim[new_leaf_id.clamp(0, cap - 1)] + pos - first[owner_c]
    new_prims = torch.zeros_like(bvh.prim_ids)
    new_prims[dest[moved]] = bvh.prim_ids[moved]

    return Bvh(bounds=new_bounds, index=new_index, prim_ids=new_prims,
               node_count=new_count, prim_count=new_prim_count)


def extract_bvh(bvh: Bvh, root_id: int) -> Bvh:
    """The subtree rooted at `root_id` as a standalone BVH
    (reference: bvh.h:91-122), in BFS node order."""
    keep_all = torch.ones(bvh.index.shape[0], dtype=torch.bool,
                          device=bvh.index.device)
    return canonicalize(bvh, keep_all, new_root=root_id)
