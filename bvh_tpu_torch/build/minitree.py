"""Mini-tree builder (Ganestam et al.), level-synchronous and spliced.

Counterpart of `bvh_tpu.build.minitree` (reference:
mini_tree_builder.h): the config, the Morton-grid groups that the fast
build (`minitree_fast.py`, kernel B3) shares, and `build_minitree`, the
build of any dim and float type:

1. Morton-grid bin per primitive and the greedy merge of adjacent small
   bins (84-91, 160-193);
2. every mini-tree grows at once as one binned-SAH forest
   (`frontier.init_forest`, `binned._round`; 105-139, 196-202);
3. pruning: a splice root is a forest node whose half-area drops below
   `pruning_area_ratio` times the mean mini-tree root area, or a leaf,
   under ancestors that all stayed above it (207-247);
4. a sweep top tree over the splice roots, in (mini-tree, forest slot)
   order, with phantom point boxes for the absent ones, erased by
   `canonicalize` and refit; then the splice of the forest pairs below
   the splice roots after the top tree (249-310).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bvh_tpu_torch.build import frontier
from bvh_tpu_torch.build.binned import _round as binned_round
from bvh_tpu_torch.build.canonicalize import canonicalize
from bvh_tpu_torch.build.sah import TopDownConfig
from bvh_tpu_torch.build.sweep import build_sweep
from bvh_tpu_torch.core import bbox as bbox_ops
from bvh_tpu_torch.core import utils
from bvh_tpu_torch.core.types import Bvh, Index
from bvh_tpu_torch.traverse.refit import refit

_I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class MiniTreeConfig(TopDownConfig):
    """Names and defaults of mini_tree_builder.h:30-43."""

    enable_pruning: bool = True
    pruning_area_ratio: float = 0.01
    parallel_threshold: int = 1024
    log2_grid_dim: int = 4


def merge_small_bins(bin_sizes: np.ndarray, threshold: int) -> np.ndarray:
    """Greedy grouping of adjacent bins (merge_small_bins, 84-91): a bin
    joins the current group while the group's size stays within
    `threshold`. Returns the group id of every bin."""
    group = np.empty(len(bin_sizes), np.int64)
    acc, gid = 0, 0
    for i, size in enumerate(bin_sizes.tolist()):
        if acc > 0 and acc + size > threshold:
            gid += 1
            acc = size
        else:
            acc += size
        group[i] = gid
    return group


def _grid_groups(centers: torch.Tensor, config: MiniTreeConfig):
    """Group id of every primitive (dense, in Morton order) and the bin
    count. The bounds of the centres are a plain min/max, which is
    exact in any order (the reference reduces them on its executor,
    161-167); the 4096-entry greedy merge runs on the host."""
    n, dim = centers.shape
    grid_dim = 1 << config.log2_grid_dim
    bin_count = 1 << (config.log2_grid_dim * dim)
    cmin = centers.amin(0)
    cmax = centers.amax(0)
    # grid_scale = grid_dim * safe_inverse(diagonal) (172)
    scale = grid_dim * utils.safe_inverse(cmax - cmin)
    offset = -cmin * scale
    p = utils.fast_mul_add(centers, scale, offset)
    p = torch.where(p > 0, p, 0.0)  # robust_max(.., 0) (180)
    coord = torch.clamp(p, max=float(grid_dim - 1)).to(torch.int64)
    bins = utils.morton_encode(coord, dim) & (bin_count - 1)
    if config.enable_pruning:
        sizes = torch.bincount(bins, minlength=bin_count).cpu().numpy()
        group_of_bin = torch.from_numpy(
            merge_small_bins(sizes, config.parallel_threshold)).to(
            centers.device)
    else:
        # without pruning every bin is its own group (192-193)
        group_of_bin = torch.arange(bin_count, device=centers.device)
    return group_of_bin[bins], bin_count


def sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """x[0] + x[1] + ... rounded after every add in x's dtype: XLA's
    order for the few mini-tree root areas (probed equal for up to 13
    groups; XLA vectorises longer sums in an order of its own)."""
    vals = x.detach().cpu().numpy()
    total = vals.dtype.type(0)
    for v in vals:
        total = total + v
    return torch.tensor(total, device=x.device)


def _propagate(parents, valid, start_done, init, step):
    """Top-down pass over a forest: a node not yet done whose parent is
    done takes `step(values, parents)` at the parent, level by level."""
    done, vals = start_done, init
    while bool((valid & ~done).any()):
        can = valid & ~done & done[parents]
        vals = torch.where(can, step(vals, parents), vals)
        done = done | can
    return vals


def build_minitree(bb_min, bb_max, centers,
                   config: MiniTreeConfig | None = None) -> Bvh:
    """Build a BVH with the mini-tree pipeline over [n, dim] primitive
    boxes and centres of any dim and float type, on their device."""
    if config is None:
        config = MiniTreeConfig()
    n, dim = centers.shape
    dtype, dev = centers.dtype, centers.device
    g_cap = min(1 << (config.log2_grid_dim * dim), n)

    group = torch.clamp(_grid_groups(centers, config)[0], max=g_cap - 1)
    # (group, prim id) order: prim ids ascend, so one stable sort
    order = torch.sort(group, stable=True).indices
    counts = torch.bincount(group, minlength=g_cap)
    begins = torch.cumsum(counts, 0) - counts

    # ---- the forest of all mini-trees ---------------------------------
    forest_cap = 2 * n + g_cap
    forest = frontier.init_forest(bb_min, bb_max, order, begins,
                                  begins + counts, config.min_leaf_size,
                                  forest_cap)
    tdc = TopDownConfig(sah=config.sah, min_leaf_size=config.min_leaf_size,
                        max_leaf_size=config.max_leaf_size)
    while bool(forest.open_.any()):
        forest = binned_round(forest, bb_min, bb_max, centers, tdc)
    nc_f = int(forest.node_count)

    ids_f = torch.arange(forest_cap, device=dev)
    valid_f = ids_f < nc_f
    is_root_slot = ids_f < g_cap
    real_root = is_root_slot.clone()
    real_root[:g_cap] = counts > 0
    area_f = bbox_ops.get_half_area(forest.bounds[:, 0::2],
                                    forest.bounds[:, 1::2])
    leaf_f = Index.is_leaf(forest.index) & valid_f
    inner_f = ~leaf_f & valid_f
    first_f = Index.first_id(forest.index)
    parents = torch.zeros(forest_cap, dtype=_I64, device=dev)
    inner = torch.nonzero(inner_f).squeeze(1)
    parents[first_f[inner]] = inner
    parents[first_f[inner] + 1] = inner
    root_done = ~valid_f | is_root_slot

    # ---- pruning: the splice roots (207-247) --------------------------
    g2_cap = max(g_cap, min(4 * g_cap, n))
    if config.enable_pruning:
        num_real = max(int(real_root.sum()), 1)
        avg_area = sum_in_order(area_f[real_root]) / torch.tensor(
            num_real, dtype=dtype, device=dev)
        thr = avg_area * torch.tensor(config.pruning_area_ratio, dtype=dtype,
                                      device=dev)
        ok = area_f >= thr
        anc_ok = _propagate(parents, valid_f, root_done, real_root,
                            lambda v, p: v[p] & ok[p])
        pruned_root = torch.where(is_root_slot, real_root & (~ok | leaf_f),
                                  anc_ok & (~ok | leaf_f) & valid_f)
        if int(pruned_root.sum()) > g2_cap:
            pruned_root = real_root
    else:
        pruned_root = real_root

    # ---- (mini-tree, slot) order: each node's mini-tree id ------------
    tid_f = _propagate(parents, valid_f, root_done,
                       torch.where(is_root_slot, ids_f, 0),
                       lambda v, p: v[p])

    # ---- the sweep top tree over the splice roots (249-260) -----------
    pr_key = torch.where(pruned_root, tid_f, forest_cap)
    pr_sorted_slot = torch.sort(pr_key, stable=True).indices
    num_pr = int(pruned_root.sum())
    proot_of = torch.where(torch.arange(g2_cap, device=dev) < num_pr,
                           pr_sorted_slot[:g2_cap], -1)
    real2 = proot_of >= 0
    pr_rows = forest.bounds[proot_of.clamp(0, forest_cap - 1)]
    pr_mn, pr_mx = pr_rows[:, 0::2], pr_rows[:, 1::2]
    scene_mx = torch.where(real2[:, None], pr_mx, float("-inf")).amax(0)
    top_mn = torch.where(real2[:, None], pr_mn, scene_mx)
    top_mx = torch.where(real2[:, None], pr_mx, scene_mx)
    top_raw = build_sweep(top_mn, top_mx, bbox_ops.get_center(top_mn, top_mx),
                          TopDownConfig(sah=config.sah, min_leaf_size=1,
                                        max_leaf_size=1))
    top_cap = top_raw.index.shape[0]
    leaf_slot = top_raw.prim_ids[
        Index.first_id(top_raw.index).clamp(0, g2_cap - 1)]
    top = refit(canonicalize(top_raw, real2[leaf_slot.clamp(0, g2_cap - 1)]))
    tc = top.node_count

    # ---- the splice (262-308): forest pairs strictly below a splice
    # root follow the top tree in (mini-tree, slot) order ---------------
    strict_below = _propagate(parents, valid_f, root_done,
                              torch.zeros_like(valid_f),
                              lambda v, p: pruned_root[p] | v[p])
    n_pairs = (forest_cap - g_cap) // 2
    pair_base = g_cap + 2 * torch.arange(n_pairs, device=dev)
    pair_live = strict_below[pair_base] & (pair_base < nc_f)
    live_pairs = int(pair_live.sum())
    pair_key = torch.where(pair_live, tid_f[pair_base], forest_cap)
    pair_sorted = torch.sort(pair_key, stable=True).indices
    pair_rank = torch.empty_like(pair_sorted)
    pair_rank[pair_sorted] = torch.arange(n_pairs, device=dev)

    def remap(words):
        """Inner words move to their pair's new place; leaves keep their
        prim positions."""
        first = Index.first_id(words)
        k = ((first - g_cap) >> 1).clamp(0, n_pairs - 1)
        new_first = (tc + 2 * pair_rank[k]).clamp(min=0)
        return torch.where(Index.is_leaf(words), words,
                           Index.make_inner(new_first))

    bounds = torch.zeros((top_cap + forest_cap, 2 * dim), dtype=dtype,
                         device=dev)
    index = torch.zeros(top_cap + forest_cap, dtype=_I64, device=dev)
    # top-tree rows: leaves take their splice root's content
    top_is_leaf = Index.is_leaf(top.index[:tc])
    tl_slot = top.prim_ids[Index.first_id(top.index[:tc]).clamp(0, g2_cap - 1)]
    tl_root = proot_of[tl_slot.clamp(0, g2_cap - 1)].clamp(0, forest_cap - 1)
    bounds[:tc] = torch.where(top_is_leaf[:, None], forest.bounds[tl_root],
                              top.bounds[:tc])
    index[:tc] = torch.where(top_is_leaf, remap(forest.index[tl_root]),
                             top.index[:tc])
    node_live = torch.nonzero((ids_f >= g_cap) & valid_f
                              & strict_below).squeeze(1)
    dest = tc + 2 * pair_rank[(node_live - g_cap) >> 1] + (
        (node_live - g_cap) & 1)
    bounds[dest] = forest.bounds[node_live]
    index[dest] = remap(forest.index[node_live])
    return Bvh(bounds=bounds, index=index, prim_ids=forest.order,
               node_count=tc + 2 * live_pairs, prim_count=n)
