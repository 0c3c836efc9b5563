"""Level-synchronous frontier machinery for the top-down builders.

Counterpart of `bvh_tpu.build.frontier` (reference:
top_down_sah_builder.h:74-131): the state of the sweep and binned
builders, and the forest of the mini-tree build. One round splits every
open node at once over a single flat primitive ordering: a stable
segmented partition, child allocation in pairs (left child at an odd
index, bvh.h:33-39), SATO order (the larger-area child goes left,
top_down_sah_builder.h:100-108) and leaf finalization.

Where `bvh_tpu` writes a scatter-free form for the TPU (key sorts,
associative scans, boundary gathers), the port uses the scatter it
stands for: each is exact (a permutation, a min/max, or an integer sum),
so the results are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bvh_tpu_torch.core import bbox as bbox_ops
from bvh_tpu_torch.core.types import (
    Bvh,
    Index,
    make_node_bounds_row,
    node_capacity_for,
)

_I64 = torch.int64


class FrontierState(NamedTuple):
    """Builder loop state: `n` primitives, `cap = 2n - 1` node slots.

    order:  [n] int64 primitive ids, contiguous per node segment.
    seg:    [n] int64 node slot owning each position.
    bounds: [cap, 2*dim] node bounds, interleaved min/max.
    index:  [cap] int64 packed index words (0 until finalized).
    begin/end: [cap] int64 primitive range of each node.
    open_:  [cap] bool nodes still to be processed.
    node_count: 0-d int64 tensor.
    """

    order: torch.Tensor
    seg: torch.Tensor
    bounds: torch.Tensor
    index: torch.Tensor
    begin: torch.Tensor
    end: torch.Tensor
    open_: torch.Tensor
    node_count: torch.Tensor


def init_state(bboxes_min, bboxes_max, min_leaf_size: int) -> FrontierState:
    """The root node over all primitives
    (reference: top_down_sah_builder.h:77-83)."""
    n, dim = bboxes_min.shape
    if n < 1:
        raise ValueError("cannot build a BVH over zero primitives")
    dev = bboxes_min.device
    cap = node_capacity_for(n)
    bounds = torch.zeros((cap, 2 * dim), dtype=bboxes_min.dtype, device=dev)
    bounds[0] = make_node_bounds_row(bboxes_min.amin(0), bboxes_max.amax(0))
    index = torch.zeros(cap, dtype=_I64, device=dev)
    root_is_leaf = n <= min_leaf_size
    if root_is_leaf:
        index[0] = Index.make_leaf(0, n)
    end = torch.zeros(cap, dtype=_I64, device=dev)
    end[0] = n
    open_ = torch.zeros(cap, dtype=torch.bool, device=dev)
    open_[0] = not root_is_leaf
    return FrontierState(
        order=torch.arange(n, dtype=_I64, device=dev),
        seg=torch.zeros(n, dtype=_I64, device=dev),
        bounds=bounds,
        index=index,
        begin=torch.zeros(cap, dtype=_I64, device=dev),
        end=end,
        open_=open_,
        node_count=torch.ones((), dtype=_I64, device=dev),
    )


def init_forest(bboxes_min, bboxes_max, order, group_begin, group_end,
                min_leaf_size: int, node_capacity: int,
                force_closed=None) -> FrontierState:
    """A forest of root segments (bvh_tpu frontier.py:93-161): root g owns
    positions [group_begin[g], group_end[g]) of `order`, so that all
    mini-trees of the mini-tree build (mini_tree_builder.h:105-139) grow
    in one level-synchronous loop. Roots of 1..min_leaf_size prims are
    leaves; empty groups (begin == end) are closed roots of empty boxes
    that nothing references. Roots marked in `force_closed` [g_cap]
    never open (the padding group of a rank's share,
    par/minitree_sharded.py)."""
    n, dim = bboxes_min.shape
    dev = bboxes_min.device
    g_cap = group_begin.shape[0]
    cap = node_capacity
    begin_g = group_begin.to(_I64)
    end_g = group_end.to(_I64)
    # the root of each position: the largest group whose begin is at or
    # before it (empty groups share their begin with the next group)
    gids = torch.arange(g_cap, dtype=_I64, device=dev)
    at = begin_g < n
    gid = torch.zeros(n, dtype=_I64, device=dev).scatter_reduce_(
        0, begin_g[at], gids[at], "amax")
    gid = torch.cummax(gid, 0).values
    big = torch.finfo(bboxes_min.dtype).max
    idx = gid[:, None].expand(-1, dim)
    root_mn = torch.full((cap, dim), big, dtype=bboxes_min.dtype,
                         device=dev).scatter_reduce_(
        0, idx, bboxes_min[order], "amin")
    root_mx = torch.full((cap, dim), -big, dtype=bboxes_min.dtype,
                         device=dev).scatter_reduce_(
        0, idx, bboxes_max[order], "amax")
    bounds = torch.zeros((cap, 2 * dim), dtype=bboxes_min.dtype, device=dev)
    bounds[:g_cap] = make_node_bounds_row(root_mn[:g_cap], root_mx[:g_cap])

    begin = torch.zeros(cap, dtype=_I64, device=dev)
    end = torch.zeros(cap, dtype=_I64, device=dev)
    begin[:g_cap] = begin_g
    end[:g_cap] = end_g
    sizes = end - begin
    is_root = torch.arange(cap, device=dev) < g_cap
    leaf_now = is_root & (sizes > 0) & (sizes <= min_leaf_size)
    index = torch.where(leaf_now, Index.make_leaf(begin.clamp(min=0),
                                                  sizes.clamp(min=1)), 0)
    open_ = is_root & (sizes > min_leaf_size)
    if force_closed is not None:
        open_[:g_cap] &= ~force_closed
    return FrontierState(order=order.to(_I64), seg=gid, bounds=bounds,
                         index=index, begin=begin, end=end, open_=open_,
                         node_count=torch.tensor(g_cap, dtype=_I64,
                                                 device=dev))


def segment_heads(state: FrontierState) -> torch.Tensor:
    """True at the first position of each node segment."""
    pos = torch.arange(state.order.shape[0], device=state.order.device)
    return pos == state.begin[state.seg]


def segmented_minmax(heads, vmin, vmax):
    """Inclusive segmented running (min, max) of [n, K] values over the
    contiguous segments that `heads` starts; row `end - 1` of a segment
    holds its full reduction. Exact in any order."""
    def comb(a, b):
        return torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1])

    return segmented_scan((vmin, vmax), heads, comb)


def segment_sums_at(values, begin, end):
    """Sums of [n] or [n, K] integer `values` over the position ranges
    [begin_i, end_i): one inclusive cumsum and two boundary reads."""
    n = values.shape[0]
    cs = torch.cumsum(values.to(_I64), 0)

    def at(idx):
        v = cs[idx.clamp(0, n - 1)]
        ok = idx >= 0
        return torch.where(ok.view(-1, *([1] * (v.dim() - 1))), v, 0)

    return at(end - 1) - at(begin - 1)


def compact_frontier(open_):
    """Dense frontier positions of the open nodes: `(fpos, f2n)` with
    `fpos[node]` in [0, F) for open nodes (garbage elsewhere) and
    `f2n[fpos] = node`; unused slots of f2n hold the sentinel `cap`. F = (cap + 1) // 4 bounds the open nodes, each of
    which holds at least 2 primitives."""
    cap = open_.shape[0]
    f_cap = max(1, (cap + 1) // 4)
    fpos = torch.cumsum(open_.to(_I64), 0) - 1
    ids = torch.nonzero(open_).squeeze(1)
    f2n = torch.full((f_cap,), cap, dtype=_I64, device=open_.device)
    f2n[:ids.numel()] = ids[:f_cap]
    return fpos, f2n


def segment_ranks_by_value(sort_key, values, sizes_by_key, key_cap: int):
    """Rank of each position among the positions that share its
    `sort_key`, in ascending `values` (stable: ties keep position
    order). Positions with `sort_key == key_cap` get garbage ranks.
    `sizes_by_key[k]` is the number of positions with key k. Used for
    median fallback splits (binned_sah_builder.h:118-126)."""
    n = values.shape[0]
    pos = torch.arange(n, dtype=_I64, device=values.device)
    by_value = torch.sort(values, stable=True).indices
    order = by_value[torch.sort(sort_key[by_value], stable=True).indices]
    offsets = torch.cumsum(sizes_by_key.to(_I64), 0) - sizes_by_key
    offsets = torch.cat([offsets, offsets.new_zeros(1)])
    ranks_sorted = pos - offsets[sort_key[order].clamp(max=key_cap)]
    ranks = torch.empty_like(ranks_sorted)
    ranks[order] = ranks_sorted
    return ranks


def segmented_scan(values, flags, combine):
    """Inclusive segmented scan along dim 0, restarting where `flags`
    is set: a log-step (Hillis–Steele) scan of the operator
    (fa, a) . (fb, b) = (fa | fb, b if fb else combine(a, b)).
    `values` is a tuple of [n, ...] tensors combined together."""
    n = flags.shape[0]
    xs = tuple(values)
    f = flags
    k = 1
    while k < n:
        fb = f[k:]
        keep = fb.view(-1, *([1] * (xs[0].dim() - 1)))
        comb = combine(tuple(x[:-k] for x in xs), tuple(x[k:] for x in xs))
        xs = tuple(torch.cat([x[:k], torch.where(keep, x[k:], c)])
                   for x, c in zip(xs, comb))
        f = torch.cat([f[:k], f[:-k] | fb])
        k *= 2
    return xs


def inverse_permute(new_pos, payloads):
    """out[new_pos[p]] = payload[p] for each payload (`new_pos` is a
    permutation of [0, n))."""
    outs = []
    for x in payloads:
        out = torch.empty_like(x)
        out[new_pos] = x
        outs.append(out)
    return tuple(outs)


def segmented_left_rank(goes_left, begin_p):
    """Exclusive count of left-going positions before each position
    inside its segment (`begin_p[p]` is p's segment start): the stable
    partition rank (sweep_sah_builder.h:132-136)."""
    gl = goes_left.to(_I64)
    ecs = torch.cumsum(gl, 0) - gl
    return ecs - ecs[begin_p]


def apply_splits(state: FrontierState, bboxes_min, bboxes_max, do_split,
                 goes_left, min_leaf_size: int, extra_orders=(),
                 extra_goes_left=()):
    """Split every node with `do_split[node]` and close the other open
    nodes as leaves; `goes_left[p]` routes position p of a splitting
    segment. `extra_orders`/`extra_goes_left` are further per-axis
    orderings over the same segments (the sweep builder's sorted id
    lists), partitioned with their own routing. Returns
    `(state, new_extra_orders)`."""
    n = state.order.shape[0]
    cap = state.open_.shape[0]
    dim = bboxes_min.shape[1]
    dev = state.order.device
    pos = torch.arange(n, dtype=_I64, device=dev)

    nid = state.seg
    act = do_split[nid]
    begin_p = state.begin[nid]
    gl = goes_left & act

    count_left = torch.zeros(cap, dtype=_I64, device=dev).index_add_(
        0, nid, gl.to(_I64))
    count_left = torch.where(do_split, count_left, 0)

    def partition_pos(g):
        lr = segmented_left_rank(g, begin_p)
        rr = (pos - begin_p) - lr
        return torch.where(act, torch.where(g, begin_p + lr,
                                            begin_p + count_left[nid] + rr),
                           pos)

    new_pos = partition_pos(gl)
    new_extras = tuple(
        inverse_permute(partition_pos(xgl & act), (xorder,))[0]
        for xorder, xgl in zip(extra_orders, extra_goes_left))

    mid = state.begin + count_left
    split_i = do_split.to(_I64)
    rank = torch.cumsum(split_i, 0) - split_i
    child_base = state.node_count + 2 * rank
    num_splits = split_i.sum()

    # per-side boxes of every splitting node (top_down_sah_builder.h:
    # 133-139): min/max over its left and right positions
    pb_min = bboxes_min[state.order]
    pb_max = bboxes_max[state.order]
    big = torch.finfo(pb_min.dtype).max
    side = 2 * nid + (~gl).to(_I64)
    side_min = torch.full((2 * cap, dim), big, dtype=pb_min.dtype,
                          device=dev)
    side_max = torch.full((2 * cap, dim), -big, dtype=pb_min.dtype,
                          device=dev)
    a = act.nonzero().squeeze(1)
    idx = side[a][:, None].expand(-1, dim)
    side_min.scatter_reduce_(0, idx, pb_min[a], "amin")
    side_max.scatter_reduce_(0, idx, pb_max[a], "amax")
    side_min = side_min.view(cap, 2, dim)
    side_max = side_max.view(cap, 2, dim)

    area_a = bbox_ops.get_half_area(side_min[:, 0], side_max[:, 0])
    area_b = bbox_ops.get_half_area(side_min[:, 1], side_max[:, 1])
    swap = area_a < area_b  # SATO: the larger child goes left

    a_first = ~swap
    c0_min = torch.where(a_first[:, None], side_min[:, 0], side_min[:, 1])
    c0_max = torch.where(a_first[:, None], side_max[:, 0], side_max[:, 1])
    c1_min = torch.where(a_first[:, None], side_min[:, 1], side_min[:, 0])
    c1_max = torch.where(a_first[:, None], side_max[:, 1], side_max[:, 0])
    c0_begin = torch.where(a_first, state.begin, mid)
    c0_end = torch.where(a_first, mid, state.end)
    c1_begin = torch.where(a_first, mid, state.begin)
    c1_end = torch.where(a_first, state.end, mid)
    c0_open = (c0_end - c0_begin) > min_leaf_size
    c1_open = (c1_end - c1_begin) > min_leaf_size

    # parent becomes inner (top_down_sah_builder.h:92); open nodes that
    # did not split close as leaves (:125)
    index = torch.where(do_split, Index.make_inner(child_base), state.index)
    close_leaf = state.open_ & ~do_split
    index = torch.where(close_leaf, Index.make_leaf(
        state.begin.clamp(min=0), (state.end - state.begin).clamp(min=1)),
        index)

    # children land in pairs at [node_count, node_count + 2*num_splits)
    sp = do_split.nonzero().squeeze(1)
    slot0 = child_base[sp]
    bounds = state.bounds.clone()
    begin = state.begin.clone()
    end = state.end.clone()
    open_ = torch.zeros_like(state.open_)
    for slot, cmn, cmx, cb, ce, co in (
            (slot0, c0_min, c0_max, c0_begin, c0_end, c0_open),
            (slot0 + 1, c1_min, c1_max, c1_begin, c1_end, c1_open)):
        bounds[slot] = make_node_bounds_row(cmn[sp], cmx[sp])
        begin[slot] = cb[sp]
        end[slot] = ce[sp]
        open_[slot] = co[sp]
        # min-leaf children become leaves now (:125)
        index[slot] = torch.where(
            co[sp], index[slot],
            Index.make_leaf(cb[sp].clamp(min=0), (ce[sp] - cb[sp]).clamp(min=1)))

    child_of_a = torch.where(swap, child_base + 1, child_base)
    child_of_b = torch.where(swap, child_base, child_base + 1)
    new_seg_val = torch.where(gl, child_of_a[nid], child_of_b[nid])
    new_order, seg = inverse_permute(
        new_pos, (state.order, torch.where(act, new_seg_val, state.seg)))

    return FrontierState(order=new_order, seg=seg, bounds=bounds, index=index,
                         begin=begin, end=end, open_=open_,
                         node_count=state.node_count + 2 * num_splits), new_extras


def finalize(state: FrontierState) -> Bvh:
    """The frontier state as a `Bvh` (top_down_sah_builder.h:128-130);
    slots past node_count are zero."""
    n = state.order.shape[0]
    cap = state.open_.shape[0]
    nc = int(state.node_count)
    valid = torch.arange(cap, device=state.order.device) < nc
    return Bvh(bounds=torch.where(valid[:, None], state.bounds, 0),
               index=torch.where(valid, state.index, 0),
               prim_ids=state.order, node_count=nc, prim_count=n)
