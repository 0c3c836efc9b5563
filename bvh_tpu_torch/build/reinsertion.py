"""Parallel reinsertion optimizer (Meister & Bittner).

Counterpart of `bvh_tpu.build.reinsertion` (reference:
reinsertion_optimizer.h). Per iteration (max_iter_count, default 3):

1. candidates: the `batch_size_ratio * node_count` nodes of largest
   half-area, the root excluded (find_candidates, 88-105), by one
   stable sort;
2. for every candidate at once, the best reinsertion target by a
   branch-and-bound walk up from the node and down into the siblings'
   subtrees (find_reinsertion, 107-188): a lockstep loop over per-lane
   paired stacks [batch, depth];
3. moves sorted by gain, greatest first, and applied greedily, skipping
   any whose 5-node conflict set meets an applied one (227-234,
   254-265), computed as the fixpoint `_greedy_accept`, which equals
   the serial loop's accepted set;
4. a refit of the dirty paths only (refit_from, 215-225).

There is no CUDA kernel here: `bvh_tpu` has no Pallas kernel for this
stage either, so it is torch ops.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from bvh_tpu_torch.core import bbox as bbox_ops
from bvh_tpu_torch.core import trace
from bvh_tpu_torch.core.types import Bvh, Index, make_node_bounds_row
from bvh_tpu_torch.core.utils import run_stage
from bvh_tpu_torch.traverse.refit import parents_of

_I64 = torch.int64
# lockstep search steps between two host tests for live lanes
_CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class ReinsertionConfig:
    """Names and defaults of reinsertion_optimizer.h:19-25, and the
    search's stack depth and batch cap of `bvh_tpu`."""

    batch_size_ratio: float = 0.05
    max_iter_count: int = 3
    search_stack_depth: int = 64
    max_batch: int | None = None


def _half_area_rows(rows):
    return bbox_ops.get_half_area(rows[..., 0::2], rows[..., 1::2])


def _find_reinsertion_batch(bounds, index, parents, node_ids, valid,
                            stack_depth: int):
    """Branch-and-bound search of every candidate at once (107-188).

    Each lane walks its pivots up to the root; at each pivot it explores
    the sibling subtree with its own stack and keeps the best area
    decrease. A stack entry `(bound, first << 1 | 1)` stands for a child
    pair, both pushed with the same bound (166-170); a pivot's seed is
    the single `(area_diff, sibling << 1)`. Each step pushes the seed
    where one is due, pops one entry and evaluates its one or two nodes,
    pushing each inner one's pair, in `bvh_tpu`'s order (which decides
    the target on ties). A push past `stack_depth` is dropped, as there.

    The loop tests for live lanes on the host every `_CHECK_EVERY` steps;
    steps on finished lanes change nothing. Returns (to, area_diff,
    steps), `steps` a 0-d tensor: the lockstep steps until the last
    lane finished."""
    cap = index.shape[0]
    B = node_ids.shape[0]
    D = stack_depth
    dev = bounds.device
    rows = bounds[node_ids]
    node_area = _half_area_rows(rows)
    node_mn, node_mx = rows[:, 0::2], rows[:, 1::2]
    parent0 = parents[node_ids]
    sib0 = Bvh.get_sibling_id(node_ids)
    sib_rows = bounds[sib0.clamp(0, cap - 1)]

    best_to = torch.zeros(B, dtype=_I64, device=dev)
    best_diff = torch.zeros(B, dtype=bounds.dtype, device=dev)
    area_diff = _half_area_rows(bounds[parent0])
    pivot = parent0
    sibling = sib0
    pivot_mn, pivot_mx = sib_rows[:, 0::2], sib_rows[:, 1::2]
    stack_val = torch.zeros((B, D), dtype=bounds.dtype, device=dev)
    stack_id = torch.zeros((B, D), dtype=_I64, device=dev)
    sp = torch.zeros(B, dtype=_I64, device=dev)
    seeded = torch.zeros(B, dtype=torch.bool, device=dev)
    alive = valid & (node_ids != 0)
    steps = torch.zeros((), dtype=_I64, device=dev)

    def push(mask, val, enc):
        m = (mask & (sp < D))[:, None]
        at = sp.clamp(max=D - 1)[:, None]
        stack_val.scatter_(1, at, torch.where(m, val[:, None],
                                              stack_val.gather(1, at)))
        stack_id.scatter_(1, at, torch.where(m, enc[:, None],
                                             stack_id.gather(1, at)))

    while True:
        for _ in range(_CHECK_EVERY):
            steps += alive.any()
            # seed the stack when starting a pivot level (151)
            need_seed = alive & ~seeded
            push(need_seed, area_diff, sibling << 1)
            sp = sp + need_seed
            seeded = seeded | need_seed

            # pop one entry (a pair, or the seed) and evaluate (152-170)
            has_work = alive & (sp > 0)
            at = (sp - 1).clamp(0, D - 1)[:, None]
            top_val = stack_val.gather(1, at).squeeze(1)
            top_enc = stack_id.gather(1, at).squeeze(1)
            sp = torch.where(has_work, sp - 1, sp)
            base = top_enc >> 1
            eval0 = has_work & ~((top_val - node_area) <= best_diff)  # (155)
            eval1 = eval0 & ((top_enc & 1) == 1)
            for cid, ev in ((base, eval0), (base + 1, eval1)):
                cidc = cid.clamp(0, cap - 1)
                dst_row = bounds[cidc]
                reinsert_area = top_val - bbox_ops.get_half_area(
                    torch.minimum(dst_row[:, 0::2], node_mn),
                    torch.maximum(dst_row[:, 1::2], node_mx))
                better = ev & (reinsert_area > best_diff)
                best_to = torch.where(better, cid, best_to)
                best_diff = torch.where(better, reinsert_area, best_diff)
                dst_idx = index[cidc]
                push_m = ev & Index.is_inner(dst_idx)
                push(push_m, reinsert_area + _half_area_rows(dst_row),
                     (Index.first_id(dst_idx) << 1) | 1)
                sp = sp + push_m

            # a pivot's subtree exhausted: climb one level, or stop when
            # the climb would reach the root (173-182)
            exhausted = alive & seeded & (sp == 0)
            pc = pivot.clamp(0, cap - 1)
            next_pivot = parents[pc]
            finish = exhausted & (next_pivot == 0)
            climb = exhausted & (next_pivot != 0)
            srow = bounds[sibling.clamp(0, cap - 1)]
            ext_mn = torch.minimum(pivot_mn, srow[:, 0::2])
            ext_mx = torch.maximum(pivot_mx, srow[:, 1::2])
            new_area_diff = (area_diff + _half_area_rows(bounds[pc])
                             - bbox_ops.get_half_area(ext_mn, ext_mx))
            # the pivot box takes the current sibling only from the
            # second climb on
            first_climb = pivot == parent0
            area_diff = torch.where(climb & ~first_climb, new_area_diff,
                                    area_diff)
            cnf = (climb & ~first_climb)[:, None]
            pivot_mn = torch.where(cnf, ext_mn, pivot_mn)
            pivot_mx = torch.where(cnf, ext_mx, pivot_mx)
            sibling = torch.where(climb, Bvh.get_sibling_id(pivot), sibling)
            pivot = torch.where(climb, next_pivot, pivot)
            seeded = seeded & ~climb
            alive = alive & ~finish
        if not bool(alive.any()):
            break

    # reject degenerate targets (184-187)
    degenerate = (best_to == sib0) | (best_to == parent0)
    ok = valid & (node_ids != 0) & ~degenerate & (best_diff > 0)
    return torch.where(ok, best_to, 0), torch.where(ok, best_diff, 0.0), steps


def _greedy_accept(conflicts, ok, cap: int):
    """The serial conflict loop's accepted set (254-265), computed as a
    fixpoint. Rows arrive gain-sorted (row = priority, 0 first); row i
    is accepted iff no accepted j < i shares a conflict node with it.
    Each round, the priorities of live (accepted or undecided) rows and
    of accepted rows are min-scattered onto their conflict nodes; an
    undecided row is accepted when no live row beats it on any of its
    nodes, and rejected when an accepted one does.

    conflicts: [5, B] node ids; ok: [B] bool. Returns accepted [B]."""
    B = ok.shape[0]
    dev = ok.device
    pri = torch.arange(B, device=dev)
    confc = conflicts.clamp(0, cap - 1)
    flat = confc.reshape(-1)
    und = ok.clone()
    acc = torch.zeros_like(ok)

    def claims(mask):
        m = torch.full((cap,), B, dtype=_I64, device=dev).scatter_reduce(
            0, flat, torch.where(mask, pri, B).expand(5, B).reshape(-1),
            "amin")
        return m[confc].amin(0)

    for _ in range(B + 1):
        g_live = claims(und | acc)
        g_acc = claims(acc)
        newly_acc = und & (g_live >= pri)
        newly_rej = und & (g_acc < pri)
        und = und & ~newly_acc & ~newly_rej
        acc = acc | newly_acc
        if not bool(und.any()):
            break
    return acc


def _refit_dirty(bounds, index, parents, seeds):
    """Climb every dirty path to the root, recomputing inner bounds from
    the children level by level (215-225). seeds: node ids (-1 inert,
    duplicates allowed). A node crossed by several climbs is recomputed
    at each crossing; the deepest climb arrives last, with both
    children final, so the last write is exact. The host tests for live
    climbs every 4 levels; steps past the root are inert."""
    cap = index.shape[0]
    inner = Index.is_inner(index)
    first = Index.first_id(index)
    bounds = bounds.clone()
    cur = seeds
    while bool((cur >= 0).any()):
        for _ in range(4):
            c = cur.clamp(0, cap - 1)
            do = (cur >= 0) & inner[c]
            l = torch.where(do, first[c], 0).clamp(0, cap - 1)
            lrow = bounds[l]
            rrow = bounds[(l + 1).clamp(0, cap - 1)]
            merged = make_node_bounds_row(
                torch.minimum(lrow[:, 0::2], rrow[:, 0::2]),
                torch.maximum(lrow[:, 1::2], rrow[:, 1::2]))
            bounds[c[do]] = merged[do]
            cur = torch.where(cur > 0, parents[c], -1)
    return bounds


def _scores(bounds, index, node_count: int):
    """Each node's half-area; -inf at the root and past node_count."""
    ids = torch.arange(index.shape[0], device=bounds.device)
    return torch.where((ids > 0) & (ids < node_count),
                       _half_area_rows(bounds), float("-inf"))


def _candidates(bounds, index, node_count: int, batch_cap: int,
                ratio: float):
    """The largest half-areas first, root excluded, by one stable sort;
    the batch is ratio * node_count, in float32 as in `bvh_tpu`.
    Returns (cand [batch_cap], valid [batch_cap])."""
    neg_sorted, ids_sorted = torch.sort(-_scores(bounds, index, node_count),
                                        stable=True)
    batch_size = max(1, int(np.float32(node_count) * np.float32(ratio)))
    valid = ((torch.arange(batch_cap, device=bounds.device) < batch_size)
             & torch.isfinite(-neg_sorted[:batch_cap]))
    return ids_sorted[:batch_cap], valid


class Moves(NamedTuple):
    """The search's moves, greatest gain first (256): targets, moved
    nodes, their siblings and parents, the 5-node conflict sets [5, B]
    and which moves gain."""

    to_s: torch.Tensor
    from_s: torch.Tensor
    sib_s: torch.Tensor
    pfrom_s: torch.Tensor
    conflicts: torch.Tensor
    ok: torch.Tensor


def _gain_order(to, diff, cand, parents) -> Moves:
    cap = parents.shape[0]
    order = torch.sort(-diff, stable=True).indices
    to_s = to[order]
    from_s = cand[order]
    sib_s = Bvh.get_sibling_id(from_s)
    pto_s = parents[to_s.clamp(0, cap - 1)]
    pfrom_s = parents[from_s.clamp(0, cap - 1)]
    return Moves(to_s, from_s, sib_s, pfrom_s,
                 torch.stack([to_s, from_s, sib_s, pto_s, pfrom_s]),
                 diff[order] > 0)


def _apply(bounds, index, mv: Moves, accepted):
    """Apply every accepted move (reinsert_node, 190-213); their conflict
    sets are disjoint, so the writes touch disjoint slots."""
    cap = index.shape[0]
    a = accepted
    sib_c = mv.sib_s.clamp(0, cap - 1)
    to_c = mv.to_s.clamp(0, cap - 1)
    sib_rows, sib_idx = bounds[sib_c], index[sib_c]
    dst_rows, dst_idx = bounds[to_c], index[to_c]
    bounds = bounds.clone()
    index = index.clone()
    index[mv.to_s[a]] = Index.make_inner(Bvh.get_left_sibling_id(mv.from_s[a]))
    bounds[mv.sib_s[a]] = dst_rows[a]
    index[mv.sib_s[a]] = dst_idx[a]
    bounds[mv.pfrom_s[a]] = sib_rows[a]
    index[mv.pfrom_s[a]] = sib_idx[a]
    return bounds, index


def _refit_seeds(index, node_count: int, mv: Moves, accepted):
    """The new tree's parents, and the refit's seeds: {to, parent(from)}
    of each applied move, the only nodes whose boxes changed, sorted
    descending with duplicates made inert (-1)."""
    parents = parents_of(index, node_count)
    seeds = torch.where(accepted[None, :], torch.stack([mv.to_s, mv.pfrom_s]),
                        -1).reshape(-1)
    s_sorted = torch.sort(seeds, descending=True).values
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=seeds.device),
                     s_sorted[1:] == s_sorted[:-1]])
    return parents, torch.where(dup, -1, s_sorted)


def _one_iteration(bounds, index, node_count: int, batch_cap: int,
                   stack_depth: int, ratio: float, stage=run_stage):
    """One round of candidates, search, greedy accept, apply and dirty
    refit. Each stage runs through `stage` (`core.utils.run_stage`):
    parents, candidates, search, gain_sort, accept, apply, seeds,
    refit. Returns (bounds, index, the search's lockstep steps, the
    accepted moves)."""
    cap = index.shape[0]
    parents = stage("parents", parents_of, index, node_count)
    cand, valid = stage("candidates", _candidates, bounds, index, node_count,
                        batch_cap, ratio)
    to, diff, steps = stage("search", _find_reinsertion_batch, bounds, index,
                            parents, cand, valid, stack_depth)
    mv = stage("gain_sort", _gain_order, to, diff, cand, parents)
    accepted = stage("accept", _greedy_accept, mv.conflicts, mv.ok, cap)
    bounds, index = stage("apply", _apply, bounds, index, mv, accepted)
    parents, seeds = stage("seeds", _refit_seeds, index, node_count, mv,
                           accepted)
    bounds = stage("refit", _refit_dirty, bounds, index, parents, seeds)
    return bounds, index, steps, accepted


def iteration_args(bvh: Bvh, config: ReinsertionConfig) -> tuple:
    """`_one_iteration`'s arguments for `bvh`: bounds, index, node count,
    the batch capacity (a multiple of 128 within the node capacity),
    the search's stack depth and the batch ratio."""
    cap = bvh.index.shape[0]
    batch_cap = config.max_batch or max(1, int(cap * config.batch_size_ratio) + 1)
    batch_cap = min(-(-batch_cap // 128) * 128, cap)
    return (bvh.bounds, bvh.index, int(bvh.node_count), batch_cap,
            config.search_stack_depth, config.batch_size_ratio)


@trace.spanned("bvh.reinsertion")
def optimize_reinsertion(bvh: Bvh, config: ReinsertionConfig | None = None,
                         stats: dict | None = None) -> Bvh:
    """Optimize `bvh` by parallel reinsertion (reference: optimize,
    236-267). If `stats` is a dict it receives, per iteration, the
    search's lockstep steps ("steps") and the moves applied
    ("accepted")."""
    if config is None:
        config = ReinsertionConfig()
    bounds, index, *rest = iteration_args(bvh, config)
    for _ in range(config.max_iter_count):
        with trace.span("bvh.reinsertion.iteration"):
            bounds, index, steps, accepted = _one_iteration(bounds, index,
                                                            *rest)
        if stats is not None:
            stats.setdefault("steps", []).append(int(steps))
            stats.setdefault("accepted", []).append(int(accepted.sum()))
    return bvh._replace(bounds=bounds, index=index)
