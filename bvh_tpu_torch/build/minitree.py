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
from typing import NamedTuple

import numpy as np
import torch

from bvh_tpu_torch.build import frontier
from bvh_tpu_torch.build.binned import _round as binned_round
from bvh_tpu_torch.build.canonicalize import canonicalize
from bvh_tpu_torch.build.sah import TopDownConfig
from bvh_tpu_torch.build.sweep import build_sweep
from bvh_tpu_torch.core import bbox as bbox_ops
from bvh_tpu_torch.core import utils
from bvh_tpu_torch.core.types import PRIM_COUNT_BITS, Bvh, Index
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


def _grid_groups(centers: torch.Tensor, config: MiniTreeConfig,
                 executor=None):
    """Group id of every primitive (dense, in Morton order) and the bin
    count. The bounds of the centres reduce on `executor` (default
    `ParallelExecutor()`), as the reference's do (161-167); a min/max
    join is exact in any order, so every executor gives the same
    groups. The 4096-entry greedy merge runs on the host."""
    n, dim = centers.shape
    grid_dim = 1 << config.log2_grid_dim
    bin_count = 1 << (config.log2_grid_dim * dim)
    if executor is None:
        from bvh_tpu_torch.par.executor import ParallelExecutor

        executor = ParallelExecutor()
    big = torch.finfo(centers.dtype).max
    cmin, cmax = executor.reduce(
        (centers, centers),
        lambda a, b: (torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1])),
        (centers.new_full((dim,), big), centers.new_full((dim,), -big)))
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


class ForestLinks(NamedTuple):
    """A grown forest's nodes (slots < `n_roots` are the roots): valid
    slots, root slots, leaves, each node's parent, the roots' `done`
    start of `_propagate`, each node's mini-tree id (its root's slot)
    and half-area."""

    valid: torch.Tensor
    is_root_slot: torch.Tensor
    leaf: torch.Tensor
    parents: torch.Tensor
    root_done: torch.Tensor
    tid: torch.Tensor
    area: torch.Tensor


def forest_links(forest: frontier.FrontierState, n_roots: int) -> ForestLinks:
    """`forest`'s links, its first `n_roots` slots its roots."""
    cap = forest.open_.shape[0]
    ids = torch.arange(cap, device=forest.index.device)
    valid = ids < int(forest.node_count)
    is_root_slot = ids < n_roots
    leaf = Index.is_leaf(forest.index) & valid
    inner = torch.nonzero(~leaf & valid).squeeze(1)
    first = Index.first_id(forest.index)
    parents = torch.zeros(cap, dtype=_I64, device=ids.device)
    parents[first[inner]] = inner
    parents[first[inner] + 1] = inner
    root_done = ~valid | is_root_slot
    tid = _propagate(parents, valid, root_done,
                     torch.where(is_root_slot, ids, 0), lambda v, p: v[p])
    area = bbox_ops.get_half_area(forest.bounds[:, 0::2],
                                  forest.bounds[:, 1::2])
    return ForestLinks(valid, is_root_slot, leaf, parents, root_done, tid,
                       area)


def pruning_threshold(root_areas: torch.Tensor, config: MiniTreeConfig):
    """`pruning_area_ratio` times the mean half-area of the real
    mini-tree roots, `root_areas` in group order (216-219)."""
    dtype, dev = root_areas.dtype, root_areas.device
    avg = sum_in_order(root_areas) / torch.tensor(
        max(root_areas.shape[0], 1), dtype=dtype, device=dev)
    return avg * torch.tensor(config.pruning_area_ratio, dtype=dtype,
                              device=dev)


def splice_roots(f: ForestLinks, real_root, thr) -> torch.Tensor:
    """Pruning (207-247): a splice root is a forest node whose half-area
    drops below `thr`, or a leaf, under ancestors in its mini-tree that
    all stayed at or above it."""
    ok = f.area >= thr
    anc_ok = _propagate(f.parents, f.valid, f.root_done, real_root,
                        lambda v, p: v[p] & ok[p])
    return torch.where(f.is_root_slot, real_root & (~ok | f.leaf),
                       anc_ok & (~ok | f.leaf) & f.valid)


def splice_order(f: ForestLinks, pruned_root):
    """The splice roots' forest slots in (mini-tree, slot) order (the
    rest after them) and their count."""
    key = torch.where(pruned_root, f.tid, f.tid.shape[0])
    return torch.sort(key, stable=True).indices, int(pruned_root.sum())


def pair_ranks(f: ForestLinks, pruned_root, n_roots: int):
    """The forest's child pairs strictly below a splice root, ranked in
    (mini-tree, slot) order: `(pair_sorted, pair_rank, live_pairs)`,
    pair k holding slots n_roots + 2k and n_roots + 2k + 1."""
    strict_below = _propagate(f.parents, f.valid, f.root_done,
                              torch.zeros_like(f.valid),
                              lambda v, p: pruned_root[p] | v[p])
    cap = f.valid.shape[0]
    n_pairs = (cap - n_roots) // 2
    pair_base = n_roots + 2 * torch.arange(n_pairs, device=f.valid.device)
    pair_live = strict_below[pair_base] & f.valid[pair_base]
    pair_key = torch.where(pair_live, f.tid[pair_base], cap)
    pair_sorted = torch.sort(pair_key, stable=True).indices
    pair_rank = torch.empty_like(pair_sorted)
    pair_rank[pair_sorted] = torch.arange(n_pairs, device=f.valid.device)
    return pair_sorted, pair_rank, int(pair_live.sum())


def remap_words(words, pair_rank, n_roots: int, inner_base, leaf_shift=0):
    """Index words in the spliced numbering: an inner word's children
    move to their pair's place, `inner_base + 2 * rank`; a leaf's first
    prim position shifts by `leaf_shift`."""
    first = Index.first_id(words)
    k = ((first - n_roots) >> 1).clamp(0, pair_rank.shape[0] - 1)
    return torch.where(Index.is_leaf(words),
                       words + (leaf_shift << PRIM_COUNT_BITS),
                       Index.make_inner((inner_base + 2 * pair_rank[k])
                                        .clamp(min=0)))


def top_tree(pr_rows, real2, config: MiniTreeConfig):
    """The sweep top tree over the splice roots' boxes `pr_rows`
    [g2_cap, 2*dim] in (mini-tree, slot) order (249-260): absent entries
    (`real2` False) stand in as point boxes at the scene's max corner,
    which `canonicalize` erases before the refit. Returns the tree, its
    capacity, which of its first node_count nodes are leaves, and each
    such node's entry of `pr_rows`."""
    g2_cap = pr_rows.shape[0]
    pr_mn, pr_mx = pr_rows[:, 0::2], pr_rows[:, 1::2]
    scene_mx = torch.where(real2[:, None], pr_mx, float("-inf")).amax(0)
    top_mn = torch.where(real2[:, None], pr_mn, scene_mx)
    top_mx = torch.where(real2[:, None], pr_mx, scene_mx)
    top_raw = build_sweep(top_mn, top_mx, bbox_ops.get_center(top_mn, top_mx),
                          TopDownConfig(sah=config.sah, min_leaf_size=1,
                                        max_leaf_size=1))
    leaf_slot = top_raw.prim_ids[
        Index.first_id(top_raw.index).clamp(0, g2_cap - 1)]
    top = refit(canonicalize(top_raw, real2[leaf_slot.clamp(0, g2_cap - 1)]))
    tc = top.node_count
    top_is_leaf = Index.is_leaf(top.index[:tc])
    entry = top.prim_ids[Index.first_id(top.index[:tc]).clamp(0, g2_cap - 1)]
    return top, top_raw.index.shape[0], top_is_leaf, entry.clamp(0, g2_cap - 1)


def build_minitree(bb_min, bb_max, centers,
                   config: MiniTreeConfig | None = None,
                   executor=None) -> Bvh:
    """Build a BVH with the mini-tree pipeline over [n, dim] primitive
    boxes and centres of any dim and float type, on their device.
    `executor` reduces the scene bounds (`_grid_groups`), as
    MiniTreeBuilder::build takes the thread pool (47-58)."""
    if config is None:
        config = MiniTreeConfig()
    n, dim = centers.shape
    dtype, dev = centers.dtype, centers.device
    g_cap = min(1 << (config.log2_grid_dim * dim), n)

    group = torch.clamp(_grid_groups(centers, config, executor)[0],
                        max=g_cap - 1)
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
    f = forest_links(forest, g_cap)
    real_root = f.is_root_slot.clone()
    real_root[:g_cap] = counts > 0

    # ---- pruning: the splice roots (207-247) --------------------------
    g2_cap = max(g_cap, min(4 * g_cap, n))
    pruned_root = real_root
    if config.enable_pruning:
        pruned = splice_roots(f, real_root, pruning_threshold(
            f.area[real_root], config))
        if int(pruned.sum()) <= g2_cap:
            pruned_root = pruned

    # ---- the sweep top tree over the splice roots (249-260) -----------
    pr_sorted_slot, num_pr = splice_order(f, pruned_root)
    proot_of = torch.where(torch.arange(g2_cap, device=dev) < num_pr,
                           pr_sorted_slot[:g2_cap], -1)
    top, top_cap, top_is_leaf, tl_slot = top_tree(
        forest.bounds[proot_of.clamp(0, forest_cap - 1)], proot_of >= 0,
        config)
    tc = top.node_count

    # ---- the splice (262-308): forest pairs strictly below a splice
    # root follow the top tree in (mini-tree, slot) order ---------------
    pair_sorted, pair_rank, live_pairs = pair_ranks(f, pruned_root, g_cap)
    bounds = torch.zeros((top_cap + forest_cap, 2 * dim), dtype=dtype,
                         device=dev)
    index = torch.zeros(top_cap + forest_cap, dtype=_I64, device=dev)
    # top-tree rows: leaves take their splice root's content
    tl_root = proot_of[tl_slot].clamp(0, forest_cap - 1)
    bounds[:tc] = torch.where(top_is_leaf[:, None], forest.bounds[tl_root],
                              top.bounds[:tc])
    index[:tc] = torch.where(
        top_is_leaf, remap_words(forest.index[tl_root], pair_rank, g_cap, tc),
        top.index[:tc])
    src = g_cap + 2 * pair_sorted[:live_pairs]
    src = torch.stack([src, src + 1], 1).reshape(-1)
    bounds[tc:tc + 2 * live_pairs] = forest.bounds[src]
    index[tc:tc + 2 * live_pairs] = remap_words(forest.index[src], pair_rank,
                                                g_cap, tc)
    return Bvh(bounds=bounds, index=index, prim_ids=forest.order,
               node_count=tc + 2 * live_pairs, prim_count=n)
