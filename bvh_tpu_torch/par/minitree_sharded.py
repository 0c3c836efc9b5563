"""Sharded mini-tree build: each rank grows the forests of its Morton
groups, and the tree equals the single-device `build_minitree` bit for
bit.

Counterpart of `bvh_tpu.par.minitree_sharded` (reference:
src/bvh/v2/mini_tree_builder.h; thread-pool tasks become ranks, shared
memory becomes collectives). Every rank holds the primitive arrays on
its device and runs:

1. the pre-pass, the same on every rank (`_prepass`): the Morton groups,
   the (group, id) order and the counts of the single-device build,
   then contiguous group ranges dealt to the ranks by balanced prim
   count (`_device_ranges`);
2. phase A (`_phase_a`): the level-synchronous binned forest of its own
   groups only (the reference's per-task `BuildTask::run`, 122-139); no
   collective;
3. phase B (`_phase_b`): the pruning threshold from the real groups'
   root half-areas, all-gathered and summed in group order with
   `minitree.sum_in_order`, so that it has the single build's bits
   (ROADMAP C16: `bvh_tpu` sums per-device partials with a psum); the
   splice roots and strict-below marks; the (tid, slot)-major pair
   compaction, the pair offsets from an all-gather of the live counts;
4. the glue, the same on every rank (`_glue`): the rank blocks,
   all-gathered, give the splice-root table, the sweep top tree with its
   phantoms erased and refit, and the assembled tree.

Bit-identity holds because the allocation order inside one tree of a
level-synchronous forest does not depend on the other trees, every
order here is (tid, slot)-major, and every float decision runs the same
code on the same per-group operands. The data-dependent loops run on the
host, as `build_minitree`'s do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from bvh_tpu_torch.build import frontier
from bvh_tpu_torch.build import minitree as mt
from bvh_tpu_torch.build.binned import _round as binned_round
from bvh_tpu_torch.build.sah import TopDownConfig
from bvh_tpu_torch.core.types import PRIM_COUNT_BITS, Bvh, Index

_I64 = torch.int64


def _device_ranges(begins_np, counts_np, n, n_dev):
    """Assign contiguous group ranges to devices by balanced prim
    count: device of group g = floor(begin[g] * D / n) (monotone in g,
    so ranges are contiguous). Returns (dev_of_group, dstart, dlen)."""
    if n == 0:
        raise ValueError("cannot build over zero primitives")
    dev_of_group = np.minimum((begins_np.astype(np.int64) * n_dev) // n,
                              n_dev - 1).astype(np.int32)
    dstart = np.zeros(n_dev, np.int64)
    dlen = np.zeros(n_dev, np.int64)
    for d in range(n_dev):
        sel = dev_of_group == d
        if sel.any():
            dstart[d] = begins_np[sel][0]
            dlen[d] = counts_np[sel].sum()
    # empty devices: start where the previous ended
    for d in range(1, n_dev):
        if dlen[d] == 0:
            dstart[d] = dstart[d - 1] + dlen[d - 1]
    return dev_of_group, dstart, dlen


class ShardPlan(NamedTuple):
    """The pre-pass's result on one rank: the sizes every rank shares,
    the group ranges, and this rank's share (sorted-order indexed, on
    its device). Local root slot g < g_cap is global group g (closed
    where another rank owns it); slot g_cap is the padding group
    [dlen, prim_cap), always closed."""

    n: int
    g_cap: int
    g2_cap: int
    prim_cap: int
    cap_local: int
    dev_of_group: torch.Tensor  # [g_cap] rank of each group
    real: torch.Tensor  # [g_cap] the non-empty groups
    dstart: np.ndarray  # [D] first global position of each rank
    dlen: np.ndarray  # [D] prims of each rank
    order: torch.Tensor  # [prim_cap] global prim ids of this rank's share
    bb_min: torch.Tensor  # [prim_cap, dim]
    bb_max: torch.Tensor
    centers: torch.Tensor
    begin: torch.Tensor  # [g_cap + 1] local root ranges
    end: torch.Tensor
    closed: torch.Tensor  # [g_cap + 1]


def _prepass(bb_min, bb_max, centers, mesh, config: mt.MiniTreeConfig,
             prim_cap: int | None) -> ShardPlan:
    n, dim = centers.shape
    dev = mesh.device
    bb_min, bb_max, centers = (x.to(dev) for x in (bb_min, bb_max, centers))
    g_cap = min(1 << (config.log2_grid_dim * dim), n)
    group = torch.clamp(mt._grid_groups(centers, config)[0], max=g_cap - 1)
    order = torch.sort(group, stable=True).indices
    counts = torch.bincount(group, minlength=g_cap)
    counts_np = counts.cpu().numpy().astype(np.int64)
    begins_np = np.cumsum(counts_np) - counts_np
    dev_of_group, dstart, dlen = _device_ranges(begins_np, counts_np, n,
                                                mesh.size)
    if prim_cap is None:
        prim_cap = max(2 * math.ceil(n / mesh.size), 512)
    if dlen.max() > prim_cap:
        raise ValueError(
            f"sharded mini-tree: rank share {int(dlen.max())} exceeds "
            f"prim_cap {prim_cap}; raise prim_cap or rebalance")

    d = mesh.rank
    s, ln = int(dstart[d]), int(dlen[d])
    lorder = torch.zeros(prim_cap, dtype=_I64, device=dev)
    lorder[:ln] = order[s:s + ln]
    own = torch.from_numpy(dev_of_group == d).to(dev)
    begins = torch.from_numpy(begins_np).to(dev)
    pad = torch.tensor([ln], device=dev)
    begin = torch.cat([torch.where(own, begins - s, ln), pad])
    end = torch.cat([torch.where(own, begins + counts - s, ln),
                     torch.tensor([prim_cap], device=dev)])
    closed = torch.cat([~own, torch.ones(1, dtype=torch.bool, device=dev)])
    return ShardPlan(
        n=n, g_cap=g_cap, g2_cap=max(g_cap, min(4 * g_cap, n)),
        prim_cap=prim_cap, cap_local=2 * prim_cap + g_cap + 2,
        dev_of_group=torch.from_numpy(dev_of_group).to(dev, _I64),
        real=counts > 0, dstart=dstart, dlen=dlen, order=lorder,
        bb_min=bb_min[lorder], bb_max=bb_max[lorder],
        centers=centers[lorder], begin=begin, end=end, closed=closed)


def _phase_a(plan: ShardPlan, config: mt.MiniTreeConfig):
    """This rank's forest: its groups grown in binned rounds until none
    is open."""
    forest = frontier.init_forest(
        plan.bb_min, plan.bb_max,
        torch.arange(plan.prim_cap, device=plan.order.device), plan.begin,
        plan.end, config.min_leaf_size, plan.cap_local,
        force_closed=plan.closed)
    tdc = TopDownConfig(sah=config.sah, min_leaf_size=config.min_leaf_size,
                        max_leaf_size=config.max_leaf_size)
    while bool(forest.open_.any()):
        forest = binned_round(forest, plan.bb_min, plan.bb_max, plan.centers,
                              tdc)
    return forest


def _phase_b(forest, plan: ShardPlan, mesh, config: mt.MiniTreeConfig):
    """This rank's splice roots and pair block, numbered globally except
    for the top tree's node count, which the glue adds to inner words:
    (blk_bounds [2*prim_cap, 2*dim], blk_index [2*prim_cap], live_pairs,
    pr_tid [g2l], pr_bounds [g2l, 2*dim], pr_words [g2l], num_pr,
    out_order [prim_cap]) with g2l = min(g2_cap, cap_local)."""
    g_cap, gloc, cap = plan.g_cap, plan.g_cap + 1, plan.cap_local
    dev = forest.bounds.device
    f = mt.forest_links(forest, gloc)
    real_root = torch.zeros(cap, dtype=torch.bool, device=dev)
    real_root[:gloc] = ~plan.closed & (plan.end > plan.begin)

    pruned_root = real_root
    if config.enable_pruning:
        # every group's root area from its rank, then the real ones in
        # group order: the single build's operands in its order
        mine = torch.where(real_root[:g_cap], f.area[:g_cap], 0)
        areas = mesh.all_gather(mine).reshape(mesh.size, g_cap)[
            plan.dev_of_group, torch.arange(g_cap, device=dev)]
        pruned = mt.splice_roots(f, real_root, mt.pruning_threshold(
            areas[plan.real], config))
        if int(mesh.all_sum(pruned.sum())) <= plan.g2_cap:
            pruned_root = pruned

    pair_sorted, pair_rank, live_pairs = mt.pair_ranks(f, pruned_root, gloc)
    offset = int(mesh.all_gather(torch.tensor(
        live_pairs, device=dev))[:mesh.rank].sum())

    def remap(words):
        return mt.remap_words(words, pair_rank, gloc, 2 * offset,
                              int(plan.dstart[mesh.rank]))

    src = gloc + 2 * pair_sorted
    src = torch.stack([src, src + 1], 1).reshape(-1)
    g2l = min(plan.g2_cap, cap)
    pr_slot, num_pr = mt.splice_order(f, pruned_root)
    pr_slot = pr_slot[:g2l]
    pr_valid = torch.arange(g2l, device=dev) < num_pr
    return (forest.bounds[src], remap(forest.index[src]),
            torch.tensor(live_pairs, device=dev),
            torch.where(pr_valid, f.tid[pr_slot], g_cap + 1),
            torch.where(pr_valid[:, None], forest.bounds[pr_slot], 0),
            torch.where(pr_valid, remap(forest.index[pr_slot]), 0),
            torch.tensor(num_pr, device=dev),
            plan.order[forest.order])


def _gather(block, mesh):
    """Every rank's phase-B block, all-gathered: each part [D, ...]."""
    return tuple(mesh.all_gather(x).reshape(mesh.size, *x.shape)
                 for x in block)


def _glue(gathered, plan: ShardPlan, config: mt.MiniTreeConfig) -> Bvh:
    """The splice-root table, the top tree and the assembled tree, from
    the gathered blocks (the same on every rank)."""
    (blk_bounds, blk_index, live_pairs, pr_tid, pr_bounds, pr_words, num_pr,
     out_order) = gathered
    n_dev, g2_cap, dev = pr_tid.shape[0], plan.g2_cap, pr_tid.device
    two_dim = pr_bounds.shape[-1]
    # the per-rank lists are tid-major over ascending tid ranges, so a
    # stable sort that moves the absent entries last is the global order
    take = torch.sort(pr_tid.reshape(-1), stable=True).indices[:g2_cap]
    tbl_bounds = torch.zeros((g2_cap, two_dim), dtype=pr_bounds.dtype,
                             device=dev)
    tbl_words = torch.zeros(g2_cap, dtype=_I64, device=dev)
    tbl_bounds[:take.shape[0]] = pr_bounds.reshape(-1, two_dim)[take]
    tbl_words[:take.shape[0]] = pr_words.reshape(-1)[take]
    real2 = torch.arange(g2_cap, device=dev) < int(num_pr.sum())
    top, top_cap, top_is_leaf, tl_slot = mt.top_tree(tbl_bounds, real2,
                                                     config)
    tc = top.node_count

    def add_tc(words):
        """The top tree's node count, deferred by phase B, into every
        inner word's first child."""
        return torch.where(Index.is_inner(words),
                           words + (tc << PRIM_COUNT_BITS), words)

    live = live_pairs.tolist()
    rows = 2 * sum(live)
    cap = top_cap + n_dev * blk_bounds.shape[1]
    bounds = torch.zeros((cap, two_dim), dtype=pr_bounds.dtype, device=dev)
    index = torch.zeros(cap, dtype=_I64, device=dev)
    bounds[:tc] = torch.where(top_is_leaf[:, None], tbl_bounds[tl_slot],
                              top.bounds[:tc])
    index[:tc] = torch.where(top_is_leaf, add_tc(tbl_words[tl_slot]),
                             top.index[:tc])
    bounds[tc:tc + rows] = torch.cat(
        [blk_bounds[d, :2 * k] for d, k in enumerate(live)])
    index[tc:tc + rows] = add_tc(torch.cat(
        [blk_index[d, :2 * k] for d, k in enumerate(live)]))
    prim_ids = torch.cat([out_order[d, :int(k)]
                          for d, k in enumerate(plan.dlen)])
    return Bvh(bounds=bounds, index=index, prim_ids=prim_ids,
               node_count=tc + rows, prim_count=plan.n)


def build_minitree_sharded(bb_min, bb_max, centers, mesh,
                           config: mt.MiniTreeConfig | None = None,
                           prim_cap: int | None = None) -> Bvh:
    """The mini-tree build over `mesh`'s ranks, called by every rank with
    the same [n, dim] primitive boxes and centres. Every rank returns
    the same tree, equal to `build_minitree(bb_min, bb_max, centers,
    config)` on the valid prefix, on its device. `prim_cap` bounds one
    rank's share (default: twice the balanced share, at least 512); a
    skewed scene that exceeds it raises."""
    if config is None:
        config = mt.MiniTreeConfig()
    plan = _prepass(bb_min, bb_max, centers, mesh, config, prim_cap)
    forest = _phase_a(plan, config)
    block = _phase_b(forest, plan, mesh, config)
    return _glue(_gather(block, mesh), plan, config)
