"""Sweep SAH builder, level-synchronous.

Counterpart of `bvh_tpu.build.sweep` (reference: sweep_sah_builder.h).
Primitives are sorted once per axis (stable); each round evaluates the
exact SAH at every split position of every open node with a segmented
bbox-union scan per axis and direction, then stable-partitions every
axis ordering by one mark array (sweep_sah_builder.h:103-136). Costs
tie-break to the first (axis-major, position-ascending) minimum and must
beat the non-split cost strictly (try_split, 108-124); a node above
max_leaf_size that SAH declines splits at the median of its largest
axis (116-123).

The mini-tree build uses it for its top tree over at most g2_cap
(<= 16,384) splice roots.
"""

from __future__ import annotations

import torch

from bvh_tpu_torch.build import frontier
from bvh_tpu_torch.build.sah import TopDownConfig
from bvh_tpu_torch.core import bbox as bbox_ops
from bvh_tpu_torch.core import utils
from bvh_tpu_torch.core.types import Bvh

_I64 = torch.int64


def _union(a, b):
    return torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1])


def _segmented_union_scan(mn, mx, seg_start, reverse: bool):
    """Inclusive segmented bbox union along dim 0; for a reverse scan
    `seg_start` marks segment ends."""
    if reverse:
        mn, mx, seg_start = mn.flip(0), mx.flip(0), seg_start.flip(0)
    out_mn, out_mx = frontier.segmented_scan((mn, mx), seg_start, _union)
    if reverse:
        out_mn, out_mx = out_mn.flip(0), out_mx.flip(0)
    return out_mn, out_mx


def _round(state, extras, bb_min, bb_max, centers, config: TopDownConfig):
    n, dim = centers.shape
    cap = state.open_.shape[0]
    dev = centers.device
    dtype = centers.dtype
    inf = float("inf")
    sah = config.sah
    pos = torch.arange(n, dtype=_I64, device=dev)
    orders = (state.order,) + tuple(extras)

    nid = state.seg
    act = state.open_[nid]
    begin_p = state.begin[nid]
    end_p = state.end[nid]
    seg_start = (pos == begin_p) | ~act
    seg_end = (pos == end_p - 1) | ~act
    has_right = pos + 1 < end_p

    # exact SAH at every split position, per axis (find_best_split,
    # 68-101, without the serial early exit)
    best = []
    for axis in range(dim):
        pid = orders[axis]
        pmn, pmx = bb_min[pid], bb_max[pid]
        lmn, lmx = _segmented_union_scan(pmn, pmx, seg_start, reverse=False)
        rmn, rmx = _segmented_union_scan(pmn, pmx, seg_end, reverse=True)
        left_ha = bbox_ops.get_half_area(lmn, lmx)
        right_cost = sah.get_leaf_cost(end_p - pos,
                                       bbox_ops.get_half_area(rmn, rmx))
        right_next = torch.where(has_right, torch.roll(right_cost, -1), inf)
        # left_cost + right_next; XLA contracts the left product into it
        cost = utils.fast_mul_add(
            left_ha, sah.get_prim_count(pos + 1 - begin_p).to(dtype),
            right_next)
        cost = torch.where(act & has_right, cost, inf)
        cost = torch.where(torch.isnan(cost), inf, cost)
        # per node: the smallest cost, the first split position among
        # its ties (the reference's strict-< scan order)
        bc = torch.full((cap,), inf, dtype=dtype, device=dev).scatter_reduce(
            0, nid, cost, "amin")
        cand = torch.where(cost == bc[nid], pos + 1, n + 1)
        bp = torch.full((cap,), n + 1, dtype=_I64, device=dev).scatter_reduce(
            0, nid, cand, "amin")
        best.append((bc, bp))

    best_cost, best_pos = best[0]
    best_axis = torch.zeros(cap, dtype=_I64, device=dev)
    for axis in range(1, dim):
        bc, bp = best[axis]
        better = bc < best_cost
        best_cost = torch.where(better, bc, best_cost)
        best_pos = torch.where(better, bp, best_pos)
        best_axis = torch.where(better, axis, best_axis)

    # split / leaf / fallback decision (try_split, 108-124)
    size_all = state.end - state.begin
    row = state.bounds
    node_ha = bbox_ops.get_half_area(row[:, 0::2], row[:, 1::2])
    non_split = sah.get_non_split_cost(size_all, node_ha)
    sah_ok = state.open_ & (best_cost < non_split)
    do_split = state.open_ & (sah_ok | (size_all > config.max_leaf_size))
    use_fb = do_split & ~sah_ok
    largest = torch.argmax(row[:, 1::2] - row[:, 0::2], dim=1)
    split_axis = torch.where(use_fb, largest, best_axis)
    split_pos = torch.where(use_fb, (state.begin + state.end + 1) // 2,
                            best_pos)

    # mark primitives on the split axis (103-106): each prim reads its
    # position in its node's split-axis ordering
    invs = frontier.inverse_permute(orders[0], (pos, nid))
    inv_pos = [invs[0]] + [frontier.inverse_permute(orders[a], (pos,))[0]
                           for a in range(1, dim)]
    nid_by_prim = invs[1]
    ax_q = split_axis[nid_by_prim]
    pos_q = inv_pos[0]
    for axis in range(1, dim):
        pos_q = torch.where(ax_q == axis, inv_pos[axis], pos_q)
    marks = pos_q < split_pos[nid_by_prim]

    goes_left = [marks[orders[axis]] for axis in range(dim)]
    return frontier.apply_splits(
        state, bb_min, bb_max, do_split, goes_left[0], config.min_leaf_size,
        extra_orders=tuple(extras), extra_goes_left=tuple(goes_left[1:]))


def build_sweep(bb_min, bb_max, centers,
                config: TopDownConfig | None = None) -> Bvh:
    """Build a BVH with the exact sweep SAH builder
    (reference: sweep_sah_builder.h:30-36)."""
    if config is None:
        config = TopDownConfig()
    n, dim = centers.shape
    state = frontier.init_state(bb_min, bb_max, config.min_leaf_size)
    # per-axis stable sort by center (ctor, 56-63)
    orders = tuple(torch.sort(centers[:, axis], stable=True).indices
                   for axis in range(dim))
    state = state._replace(order=orders[0])
    extras = orders[1:]
    while bool(state.open_.any()):
        state, extras = _round(state, extras, bb_min, bb_max, centers, config)
    return frontier.finalize(state)
