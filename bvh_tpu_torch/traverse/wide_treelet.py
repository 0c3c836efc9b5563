"""Wide (8-ary) treelet traversal — the large-scene render path.

Counterpart of `bvh_tpu.traverse.wide_treelet`. The binary tree is cut
into treelets of at most `max_prims` primitives; the top region above
them becomes a binary pair table, and each treelet is collapsed into
8-wide nodes with quad leaves of 4 triangles, all in one [64, P] f32
table per treelet (`build_wide_treelets`, host numpy copied from the
reference, tensor outputs), plus a column-contiguous copy [P, 64] of
each that kernel B1 reads. A render then runs in two phases:

- phase A (kernel B2, traverse/collect.py) walks the top region per
  ray and records every portal (treelet entry) with its entry distance;
- phase A2, in two-level scenes only (a super level cut between the top
  region and the treelets, for scenes whose top region passes 4,096
  nodes): rounds of K2 supers per ray expand each ray's super portals,
  in entry order, into treelet portals through kernel B4
  (`collect_super_pairs`, per (ray, super) pair over that super's pair
  table), merged stably after the ray's other portals by entry t
  (`expand_supers`);
- pair rounds: each ray's portals are sorted by entry distance, and
  each round expands the next K portals of every ray that is still
  ready into (ray, treelet) pairs, which kernel B1
  (`traverse_pairs`, csrc/wide_treelet.cu) traverses 8-wide. Results
  merge into each ray's best hit by first-j strict-min, which keeps the
  reference's near-to-far rule (bvh.h:137-149). On the card the entry
  point hands the rounds to one kernel launch instead, the portal walk
  (`walk_portals`): each ray walks its own sorted list with B1's steps,
  in the rounds' windows of k portals, so its hits are the rounds'.

The render driver (`_attempts`, under the entry point and
`render_at_caps`) ports what the reference's `_render_jit` computes,
not its TPU schedule: rays are independent, so the TPU's chunking, run
padding and DMA windows only schedule work and are left out. Its rounds
read the ready rays' count on the host every round. `_render_fixed`
ports `_render_jit`'s fixed-capacity schedule (one compaction, round 1,
tail rounds at a fixed width) with every shape fixed up front, so that
`wide_treelet_render_chain` captures the whole render as one CUDA graph;
its hits equal the rounds' bit for bit.

Closest-hit results are exact; among exactly tied primitives the winner
may differ from another implementation's, because the 8-way sorting
network is not stable.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from bvh_tpu_torch import kernels
from bvh_tpu_torch.core import trace
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.core.types import INVALID_PRIM_ID, Bvh
from bvh_tpu_torch.core.utils import run_stage
from bvh_tpu_torch.traverse.collect import (
    collect_portals,
    collect_super_pairs,
    slab_inverse,
    slab_planes,
)
from bvh_tpu_torch.traverse.portal_sort import (
    merge_columns,
    sort_columns,
    split_columns,
)
from bvh_tpu_torch.traverse.wavefront import Hit, TraversalStats

WIDTH = 8
QUAD = 4  # prims per leaf column
ROWS = 64  # table rows: 8*6 bounds + 8 words | 4 * (12 tri values + gpos)
# portals expanded per ready ray and round: the reference's
# portals_per_round for scenes of fewer than 2048 treelets
# (wide_treelet_perf, wide_treelet.py:2064)
PORTALS_PER_ROUND = 4
K2 = 2  # supers expanded per ready ray and A2 round (the reference's k2)
# kernel B1's ablation mask (csrc/wide_treelet.cu, tools/ablate_kernel.py):
# code a variant leaves out
ABLATE_NO_QUAD, ABLATE_NO_SORT, ABLATE_NO_PUSH = 1, 2, 4


class WideTreelets(NamedTuple):
    """Preprocessed two-level wide scene (tensors on one device).

    top_node_t: [16, Pt]     binary pair table of the top region
                             (phase-A format); leaves are portal words
                             (tid << 4 | 1); tid >= T names a super.
    top_root:   int          top root word.
    table_cols: [T, P, 64]   per-treelet tables, one column's 64 floats
                             in 256 contiguous bytes (the layout kernel
                             B1 reads): columns [0, Wn) are wide nodes
                             (rows 0-47 child bounds, 48-55 child words
                             as f32), columns [Wn, Wn+Q) quad leaves
                             (rows q*13..q*13+11 triangle p0|e1|e2|n,
                             q*13+12 global prim position, -1 padding).
    table:      [T, 64, P]   (property) the same tables as the
                             reference's row layout: a transposed view
                             of `table_cols`, no second copy.
    n_prims:    int          total primitive positions.
    n_wide:     np.ndarray   [T] wide-node column count per treelet.
    top_depth:  int          top-region depth + 1 (phase-A stack bound).
    wide_depth: int          wide levels of the deepest treelet.
    sup_cols:   [S, Ps, 16]  per-super pair tables, one pair's 14 floats
                             (rows 0-13 of `sup_table`) and 2 of
                             padding in 64 contiguous bytes (the layout
                             kernel B4 reads); S == 0 when the scene
                             has no super level.
    sup_table:  [S, 16, Ps]  (property) the same tables as the
                             reference's row layout: a transposed view
                             of `sup_cols`, no second copy.
    sup_depth:  int          pair-tree depth inside any super + 1.
    """

    top_node_t: torch.Tensor
    top_root: int
    table_cols: torch.Tensor
    n_prims: int
    n_wide: np.ndarray
    top_depth: int
    wide_depth: int
    sup_cols: torch.Tensor
    sup_depth: int

    @property
    def table(self) -> torch.Tensor:
        return self.table_cols.transpose(1, 2)

    @property
    def sup_table(self) -> torch.Tensor:
        return self.sup_cols.transpose(1, 2)


def column_tables(table: torch.Tensor) -> torch.Tensor:
    """The column-contiguous copy [T, P, rows] of tables [T, rows, P]
    (the treelet tables, or the super tables), made on the tables'
    device."""
    return table.transpose(1, 2).contiguous()


def wide_treelets_from_numpy(tl, device) -> WideTreelets:
    """Carry a treelet scene whose fields convert with np.asarray (for
    example a `bvh_tpu` WideTreelets) across onto `device`, with the
    treelet and super tables put in their column layouts there."""
    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return WideTreelets(
        top_node_t=t(tl.top_node_t), top_root=int(tl.top_root),
        table_cols=column_tables(t(tl.table)), n_prims=int(tl.n_prims),
        n_wide=np.asarray(tl.n_wide, np.int64),
        top_depth=int(tl.top_depth), wide_depth=int(tl.wide_depth),
        sup_cols=column_tables(t(tl.sup_table)),
        sup_depth=int(tl.sup_depth))


# ------------------------------------------------------- preprocessing
def _round_up(x, m):
    return -(-x // m) * m


def _cumcount_by(keys: np.ndarray) -> np.ndarray:
    """Rank of each element among equal keys, preserving order."""
    if len(keys) == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    starts = np.r_[0, np.nonzero(sk[1:] != sk[:-1])[0] + 1]
    group_start = np.repeat(starts, np.diff(np.r_[starts, len(sk)]))
    ranks = np.arange(len(sk)) - group_start
    out = np.empty(len(keys), np.int64)
    out[order] = ranks
    return out


def _half_area_rows(rows: np.ndarray) -> np.ndarray:
    """SAH half-area of interleaved bounds rows [k, 6]."""
    d = rows[:, 1::2] - rows[:, 0::2]
    return (d[:, 0] + d[:, 1]) * d[:, 2] + d[:, 0] * d[:, 1]


def _collapse_wide(bounds, first, count, roots, tids, terminal):
    """Collapse binary subtrees into 8-wide nodes, level-synchronously
    over all subtrees at once: each wide node starts from one binary
    node and repeatedly expands its largest-area non-terminal slot
    (as `widen()` does). `terminal` marks slots where expansion stops
    (binary leaves and small subtrees that become quad leaves).

    Returns (wide_tid, wide_local, slot_node [W, 8], child_local [W, 8],
    n_wide_per_group, n_levels); slot_node holds binary node ids (-1 =
    empty slot), child_local the wide-local id of slots that became
    child wide nodes (-1 otherwise)."""
    nc = len(first)
    areas_all = _half_area_rows(bounds)

    all_tid: list[np.ndarray] = []
    all_local: list[np.ndarray] = []
    all_slots: list[np.ndarray] = []
    all_child_local: list[np.ndarray] = []
    n_wide = np.zeros(int(tids.max()) + 1 if len(tids) else 1, np.int64)

    froot = np.asarray(roots, np.int64)
    ftid = np.asarray(tids, np.int64)
    flocal = _cumcount_by(ftid)  # roots are the first wide nodes per group
    n_wide_acc = np.bincount(ftid, minlength=len(n_wide)).astype(np.int64)

    n_levels = 0
    while len(froot):
        n_levels += 1
        F = len(froot)
        slots = np.full((F, WIDTH), -1, np.int64)
        slots[:, 0] = froot
        nslot = np.ones(F, np.int64)
        for _ in range(WIDTH - 1):
            valid = slots >= 0
            sl = np.clip(slots, 0, nc - 1)
            expandable = valid & ~terminal[sl]
            a = np.where(expandable, areas_all[sl], -np.inf)
            pick = np.argmax(a, axis=1)
            can = (a[np.arange(F), pick] > -np.inf) & (nslot < WIDTH)
            rows_i = np.nonzero(can)[0]
            if len(rows_i) == 0:
                break
            pk = pick[rows_i]
            b = slots[rows_i, pk]
            slots[rows_i, pk] = first[b]
            slots[rows_i, nslot[rows_i]] = first[b] + 1
            nslot[rows_i] += 1

        valid = slots >= 0
        sl = np.clip(slots, 0, nc - 1)
        is_child = valid & ~terminal[sl]

        # next frontier in row-major order; local ids per group
        rows_i, cols_i = np.nonzero(is_child)
        kids = slots[rows_i, cols_i]
        ktid = ftid[rows_i]
        klocal = n_wide_acc[ktid] + _cumcount_by(ktid)
        n_wide_acc += np.bincount(ktid, minlength=len(n_wide)).astype(np.int64)

        child_local = np.full((F, WIDTH), -1, np.int64)
        child_local[rows_i, cols_i] = klocal

        all_tid.append(ftid)
        all_local.append(flocal)
        all_slots.append(slots)
        all_child_local.append(child_local)

        froot, ftid, flocal = kids, ktid, klocal

    if all_tid:
        wide_tid = np.concatenate(all_tid)
        wide_local = np.concatenate(all_local)
        slot_node = np.concatenate(all_slots, axis=0)
        child_local = np.concatenate(all_child_local, axis=0)
    else:
        wide_tid = np.zeros(0, np.int64)
        wide_local = np.zeros(0, np.int64)
        slot_node = np.zeros((0, WIDTH), np.int64)
        child_local = np.zeros((0, WIDTH), np.int64)
    return wide_tid, wide_local, slot_node, child_local, n_wide_acc, n_levels


def wide_treelet_max_prims(n_prims: int) -> int:
    """Scene-size default treelet size (max_prims), as the reference
    picks it."""
    return 4096 if n_prims >= 2_000_000 else 1024


@trace.spanned("bvh.build_wide_treelets")
def build_wide_treelets(bvh: Bvh, tri_flat, permuted: bool = False,
                        max_prims: int | None = None,
                        leaf_prims: int = 16,
                        super_prims: int | None = None,
                        device=None) -> WideTreelets:
    """Cut `bvh` into treelets of <= max_prims primitives and pack the
    wide tables (host numpy, once per tree), on `device` (default: the
    tree's device).

    `tri_flat`: [n, 12] precomputed triangles (p0|e1|e2|n), indexed by
    prim id (or by prim position when `permuted`).
    `leaf_prims`: subtrees with at most this many primitives collapse
    into dense quad leaves (<= 60, so the quad count fits the word's
    4-bit count field).
    `super_prims`: additionally cut the top region at subtrees of
    <= super_prims primitives; None = auto (when the top region exceeds
    4096 nodes).
    While a torch profiler records, the call is the span
    bvh.build_wide_treelets and its host stages the spans bvh.cut.*."""
    if device is None:
        device = bvh.bounds.device
    if not 1 <= leaf_prims <= 60:
        raise ValueError(f"leaf_prims must be in [1, 60], got {leaf_prims}")
    if bvh.dim != 3:
        raise ValueError("the wide-treelet path is specialised for 3D")

    with trace.span("bvh.cut.readback"):
        tri_np = np.asarray(torch.as_tensor(tri_flat).cpu().numpy(),
                            np.float32)
        nc = int(bvh.node_count)
        bounds = np.asarray(bvh.bounds[:nc].cpu().numpy(), np.float32)
        index = bvh.index[:nc].cpu().numpy().astype(np.uint64)
        prim_ids = bvh.prim_ids.cpu().numpy().astype(np.int64)
    if max_prims is None:
        max_prims = wide_treelet_max_prims(int(tri_np.shape[0]))

    with trace.span("bvh.cut.frontier"):
        first = (index >> 4).astype(np.int64)
        count = (index & 15).astype(np.int64)
        inner = count == 0

        # ---- subtree prim counts via level-synchronous BFS -----------
        levels = [np.asarray([0], np.int64)]
        frontier = levels[0]
        while True:
            fi = frontier[inner[frontier]]
            if len(fi) == 0:
                break
            kids = np.concatenate([first[fi], first[fi] + 1])
            levels.append(kids)
            frontier = kids

        nprims = np.where(inner, 0, count)
        for lev in reversed(levels):
            li = lev[inner[lev]]
            if len(li):
                nprims[li] = nprims[first[li]] + nprims[first[li] + 1]

        # ---- treelet roots + top region ------------------------------
        parent = np.full(nc, -1, np.int64)
        ii = np.nonzero(inner)[0]
        parent[first[ii]] = ii
        parent[first[ii] + 1] = ii
        is_top = nprims > max_prims  # the top region (always inner nodes)
        troot = (~is_top) & ((parent < 0) | is_top[np.clip(parent, 0, nc - 1)])
        troot[0] = not is_top[0]
        troots = np.nonzero(troot)[0]
        T = len(troots)
        tid_of_root = np.full(nc, -1, np.int64)
        tid_of_root[troots] = np.arange(T)

    with trace.span("bvh.cut.collapse"):
        # ---- collapse every treelet into wide nodes ------------------
        terminal = (~inner) | (nprims <= leaf_prims)
        wide_tid, wide_local, slot_node, child_local, n_wide, wide_depth = (
            _collapse_wide(bounds, first, count, troots, np.arange(T),
                           terminal)
        )
        W = len(wide_tid)

        # ---- quad leaf assignment ------------------------------------
        valid = slot_node >= 0
        sl = np.clip(slot_node, 0, nc - 1)
        is_leaf_slot = valid & terminal[sl]
        lr, lc = np.nonzero(is_leaf_slot)
        leaf_node = slot_node[lr, lc]
        # quad columns are assigned per treelet in (wide local id, slot) order
        order = np.lexsort((lc, wide_local[lr], wide_tid[lr]))
        lr, lc = lr[order], lc[order]
        leaf_node = leaf_node[order]
        leaf_tid = wide_tid[lr]
        leaf_np = nprims[leaf_node]
        leaf_nq = -(-leaf_np // QUAD)
        # exclusive cumsum of nq within each treelet
        cs = np.cumsum(leaf_nq) - leaf_nq
        if len(leaf_tid):
            starts = np.r_[0, np.nonzero(leaf_tid[1:] != leaf_tid[:-1])[0] + 1]
            base_of_group = cs[starts]
            leaf_qoff = cs - np.repeat(
                base_of_group, np.diff(np.r_[starts, len(leaf_tid)]))
        else:
            leaf_qoff = cs
        n_quads = np.bincount(leaf_tid, weights=leaf_nq, minlength=T).astype(np.int64)

        # every leaf slot's subtree prim positions in in-order sequence:
        # contiguous output ranges, offsets propagated down level by level
        out_base = np.cumsum(leaf_np) - leaf_np
        total_out = int(leaf_np.sum())
        offset = np.full(nc, -1, np.int64)
        offset[leaf_node] = out_base  # leaf slots are disjoint subtrees
        frontier = leaf_node[inner[leaf_node]]
        while len(frontier):
            left = first[frontier]
            right = left + 1
            offset[left] = offset[frontier]
            offset[right] = offset[frontier] + nprims[left]
            nxt = np.concatenate([left, right])
            frontier = nxt[inner[nxt]]
        ln = np.nonzero((offset >= 0) & ~inner)[0]
        c = count[ln]
        tot = int(c.sum())
        within = np.arange(tot) - np.repeat(np.cumsum(c) - c, c)
        out = np.empty(total_out, np.int64)
        out[np.repeat(offset[ln], c) + within] = (np.repeat(first[ln], c)
                                                  + within)
        assert tot == total_out

        P = int(_round_up(max(1, int((n_wide[:T] + n_quads).max())), 128))

    with trace.span("bvh.cut.pack"):
        # ---- pack per-treelet combined tables -------------------------
        table = np.zeros((max(T, 1), ROWS, P), np.float32)
        big = np.float32(np.finfo(np.float32).max)
        col_of_wide = wide_local  # node columns come first
        vr, vc = np.nonzero(valid)
        vslot = slot_node[vr, vc]
        trow = wide_tid[vr]
        ccol = col_of_wide[vr]
        b6 = bounds[vslot]  # [k, 6]
        d6 = np.arange(6)
        table[trow[:, None], vc[:, None] * 6 + d6[None, :], ccol[:, None]] = b6
        # empty child slots: empty box (never hit), word 0
        er, ec = np.nonzero(~valid)
        if len(er):
            etrow = wide_tid[er]
            ecol = col_of_wide[er]
            empty6 = np.tile(np.asarray([big, -big, big, -big, big, -big],
                                        np.float32), (len(er), 1))
            table[etrow[:, None], ec[:, None] * 6 + d6[None, :],
                  ecol[:, None]] = empty6

        # slot words: inner child -> (child column << 4); leaf -> quad word
        words = np.zeros((W, WIDTH), np.int64)
        icr, icc = np.nonzero(child_local >= 0)
        words[icr, icc] = child_local[icr, icc] << 4
        quad_col_base = n_wide[np.clip(leaf_tid, 0, T - 1)] if T else leaf_tid
        assert leaf_nq.max(initial=0) <= 15
        leaf_word = ((quad_col_base + leaf_qoff) << 4) | leaf_nq
        words[lr, lc] = leaf_word
        wr = np.repeat(np.arange(W), WIDTH).reshape(W, WIDTH)
        table[wide_tid[wr.ravel()], 48 + np.tile(np.arange(WIDTH), W),
              col_of_wide[wr.ravel()]] = words.ravel().astype(np.float32)

        # quad columns: gpos rows default to -1 (padding prims never hit),
        # then real quads overwrite
        col_idx = np.arange(P)[None, :]
        in_quad_region = col_idx >= n_wide[:T, None]  # [T, P]
        gpos_rows = table[:, 12:13 * QUAD:13, :]  # view of rows 12,25,38,51
        gpos_rows[...] = np.where(in_quad_region[:, None, :], -1.0, gpos_rows)
        if len(leaf_tid):
            qrep = np.repeat(np.arange(len(leaf_tid)), leaf_nq)
            qk = _cumcount_by(qrep)  # quad index within its leaf
            qtid = leaf_tid[qrep]
            oidx = (out_base[qrep][:, None] + qk[:, None] * QUAD
                    + np.arange(QUAD)[None, :])
            pvalid = oidx < (out_base[qrep] + leaf_np[qrep])[:, None]
            ppos = out[np.clip(oidx, 0, total_out - 1)]
            ppos_c = np.clip(ppos, 0, len(prim_ids) - 1)
            tri_idx = ppos_c if permuted else prim_ids[ppos_c]
            # invalid slots read a zero sentinel row inside the gather
            tri_pad = np.concatenate(
                [tri_np, np.zeros((1, tri_np.shape[1]), np.float32)])
            tri_idx = np.where(pvalid, np.clip(tri_idx, 0, len(tri_np) - 1),
                               len(tri_np))
            geo = tri_pad[tri_idx]                                 # [q, 4, 12]
            gpos = np.where(pvalid, ppos, -1).astype(np.float32)
            # quad columns of a treelet are contiguous and qtid is sorted:
            # one strided slice write per treelet
            rows_g = (np.arange(QUAD)[:, None] * 13
                      + np.arange(12)[None, :]).ravel()            # [48]
            rows_p = np.arange(QUAD) * 13 + 12                     # [4]
            geo_f = geo.reshape(-1, 48)
            tstart = np.r_[0, np.cumsum(np.bincount(
                qtid, minlength=T).astype(np.int64))]
            for t in range(T):
                a, b = tstart[t], tstart[t + 1]
                if a == b:
                    continue
                c0 = int(n_wide[t])
                table[t, rows_g, c0:c0 + (b - a)] = geo_f[a:b].T
                table[t, rows_p, c0:c0 + (b - a)] = gpos[a:b].T

    with trace.span("bvh.cut.top"):
        # ---- super level: cut the top region --------------------------
        top_all = np.nonzero(is_top)[0]
        if super_prims is None and len(top_all) > 4096:
            super_prims = int(max_prims * max(8, round(np.sqrt(len(top_all)))))
        use_super = (super_prims is not None and super_prims > max_prims
                     and bool((nprims > super_prims).any()))
        sup_cols = np.zeros((0, 128, 16), np.float32)
        sup_depth = 1
        sid_node = np.full(nc, -1, np.int64)
        if use_super:
            is_stop = is_top & (nprims > super_prims)
            is_mid = is_top & ~is_stop
            sroot = is_mid & ((parent < 0)
                              | is_stop[np.clip(parent, 0, nc - 1)])
            sroots = np.nonzero(sroot)[0]
            S = len(sroots)
            sid_node[sroots] = np.arange(S)
            order_nodes = [sroots]
            frontier = sroots
            sup_depth = 1
            while True:
                kids = np.concatenate([first[frontier], first[frontier] + 1])
                par_sid = np.tile(sid_node[frontier], 2)
                keep = is_mid[kids]
                kids, par_sid = kids[keep], par_sid[keep]
                if len(kids) == 0:
                    break
                sid_node[kids] = par_sid
                order_nodes.append(kids)
                frontier = kids
                sup_depth += 1
            mid_seq = np.concatenate(order_nodes)
            mid_sid = sid_node[mid_seq]
            local = _cumcount_by(mid_sid)  # stable: BFS order, roots first
            local_of = np.full(nc, -1, np.int64)
            local_of[mid_seq] = local
            Ps = int(_round_up(int(np.bincount(mid_sid).max()), 128))

            def word_sup(nids):
                return np.where(
                    tid_of_root[nids] >= 0,
                    (tid_of_root[nids] << 4) | 1,
                    (2 * local_of[nids] + 1) << 4,
                ).astype(np.float32)

            left = first[mid_seq]
            sup_rows = np.zeros((len(mid_seq), 14), np.float32)
            sup_rows[:, 0:6] = bounds[left]
            sup_rows[:, 6:12] = bounds[left + 1]
            sup_rows[:, 12] = word_sup(left)
            sup_rows[:, 13] = word_sup(left + 1)
            sup_cols = np.zeros((S, Ps, 16), np.float32)
            sup_cols[mid_sid, local, :14] = sup_rows
            top_nodes = np.nonzero(is_stop)[0]
        else:
            top_nodes = top_all

        # ---- top-region binary pair table (phase-A format) -----------
        if len(top_nodes) == 0:
            top_rows = np.zeros((1, 14), np.float32)
            top_rows[0, 0:6] = bounds[0]
            top_rows[0, 6:12:2] = big
            top_rows[0, 7:12:2] = -big
            top_rows[0, 12] = float(1)  # (0 << 4) | 1: portal to treelet 0
            top_rows[0, 13] = float(1)
            top_root = 1 << 4
            Pt = 128
            top_node_t = np.zeros((16, Pt), np.float32)
            top_node_t[:14, :1] = top_rows.T
        else:
            top_pair = np.full(nc, -1, np.int64)
            top_pair[top_nodes] = np.arange(len(top_nodes))

            def top_word(nids):
                # treelet portal | super portal (T + sid) | inner pair
                w = np.where(
                    tid_of_root[nids] >= 0,
                    (tid_of_root[nids] << 4) | 1,
                    np.where(
                        top_pair[nids] >= 0,
                        (2 * top_pair[nids] + 1) << 4,
                        ((T + sid_node[nids]) << 4) | 1,
                    ),
                )
                return w.astype(np.float32)

            left = first[top_nodes]
            top_rows = np.zeros((len(top_nodes), 14), np.float32)
            top_rows[:, 0:6] = bounds[left]
            top_rows[:, 6:12] = bounds[left + 1]
            top_rows[:, 12] = top_word(left)
            top_rows[:, 13] = top_word(left + 1)
            top_root = int(top_word(np.asarray([0]))[0])
            Pt = int(_round_up(len(top_nodes), 128))
            top_node_t = np.zeros((16, Pt), np.float32)
            top_node_t[:14, : len(top_nodes)] = top_rows.T

        # exact top-region depth (the phase-A stack bound): deepest BFS
        # level that still contains a pair-table node, +1 root margin
        in_region = np.zeros(nc, bool)
        in_region[top_nodes] = True
        top_depth = 1
        for li, lev in enumerate(levels):
            if in_region[lev].any():
                top_depth = li + 2

    with trace.span("bvh.cut.upload"):
        return WideTreelets(
            top_node_t=torch.as_tensor(top_node_t, device=device),
            top_root=top_root,
            table_cols=column_tables(torch.as_tensor(table, device=device)),
            n_prims=len(prim_ids),
            n_wide=np.asarray(n_wide[:T], np.int64),
            top_depth=top_depth,
            wide_depth=max(1, int(wide_depth)),
            sup_cols=torch.as_tensor(sup_cols, device=device),
            sup_depth=int(sup_depth) + 1,
        )


# ----------------------------------------------------- kernel B1, plain
_SORT8_PAIRS = [(0, 1), (2, 3), (4, 5), (6, 7),
                (0, 2), (1, 3), (4, 6), (5, 7),
                (1, 2), (5, 6),
                (0, 4), (1, 5), (2, 6), (3, 7),
                (2, 4), (3, 5),
                (1, 2), (3, 4), (5, 6)]


def _sort8(keys, words):
    """Batcher odd-even merge sort of 8 rows by key, the reference's
    fixed 19-comparator network with a strict `>` swap
    (wide_treelet.py:713-731). Not stable; keeping the network keeps
    the tie order identical. keys/words: lists of 8 [B] tensors."""
    kt, wt = list(keys), list(words)
    for a, b in _SORT8_PAIRS:
        swap = kt[a] > kt[b]
        kt[a], kt[b] = (torch.where(swap, kt[b], kt[a]),
                        torch.where(swap, kt[a], kt[b]))
        wt[a], wt[b] = (torch.where(swap, wt[b], wt[a]),
                        torch.where(swap, wt[a], wt[b]))
    return kt, wt


def _dot3(a, b):
    """Sum of three products, left to right: (x0 + x1) + x2."""
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def traverse_pairs_ref(table, tid, rays, *, any_hit: bool, robust: bool,
                       stack_depth: int, ablate: int = 0):
    """Plain PyTorch version of the wide traversal kernel: the state
    machine of the reference's `_traverse_core` (wide_treelet.py:741),
    vectorised over [rows, L] tensors, one step per iteration: leaf
    phase (4 Möller–Trumbore tests of one quad column), then inner
    phase (8 slab tests, `_sort8`, far-to-near pushes), then pop.

    table: [T, 64, P] f32. tid: [L] int32, the treelet of each pair
    (-1 = no pair). rays: [8, L] f32 (org, dir, tmin, tmax).
    Results are fresh per pair (best t starts at +inf).
    Returns out_f [3, L] f32 (t, u, v; t = +inf on a miss) and
    out_i [4, L] int32 (prim position or -1, active steps, stack
    high-water mark, sticky overflow flag).
    `ablate`: the kernel's ablation mask (`ABLATE_*`, the plain version
    of `traverse_pairs_ablate`); 0 in the render."""
    L = tid.shape[0]
    dev = rays.device
    i64, f32 = torch.int64, torch.float32
    P = table.shape[2]
    org, dir_, tmin = rays[0:3], rays[3:6], rays[6]
    tmax = rays[7].clone()
    inv, inv_org, inv_pad, neg = slab_inverse(org, dir_, robust)
    eps = torch.finfo(f32).eps
    flat = table.reshape(-1)
    base = tid.to(i64).clamp(min=0) * (ROWS * P)
    gather_off = base[None, :] + torch.arange(ROWS, device=dev)[:, None] * P

    def zeros(dtype=i64):
        return torch.zeros(L, dtype=dtype, device=dev)

    stack = torch.zeros((stack_depth, L), dtype=i64, device=dev)
    sp, top, leaf_cur, leaf_rem = zeros(), zeros(), zeros(), zeros()
    active = (tid >= 0) & (tmin <= tmax)
    best_t = torch.full((L,), float("inf"), dtype=f32, device=dev)
    best_u, best_v = zeros(f32), zeros(f32)
    best_pos = torch.full((L,), -1, dtype=i64, device=dev)
    asteps, hwm = zeros(), zeros()
    ovf = zeros(torch.bool)
    slot_key = [torch.full((L,), float(c), dtype=f32, device=dev)
                for c in range(WIDTH)]
    inf_row = torch.full((L,), float("inf"), dtype=f32, device=dev)

    def step():
        nonlocal stack, sp, top, leaf_cur, leaf_rem, active, tmax
        nonlocal best_t, best_u, best_v, best_pos, asteps, hwm, ovf
        asteps = asteps + active.to(i64)
        in_leaf = active & (leaf_rem > 0)
        fid = top >> 4
        col = torch.where(in_leaf, leaf_cur, fid)
        row = flat[gather_off + col[None, :]]                  # [64, L]

        # ---- quad leaf step: 4 sequential Möller–Trumbore tests ------
        done = zeros(torch.bool)
        for j in () if ablate & ABLATE_NO_QUAD else range(QUAD):
            q = row[j * 13: j * 13 + 13]
            p0, e1, e2, nrm = q[0:3], q[3:6], q[6:9], q[9:12]
            gpos = q[12].to(i64)
            c = p0 - org
            r = torch.stack([dir_[1] * c[2] - dir_[2] * c[1],
                             dir_[2] * c[0] - dir_[0] * c[2],
                             dir_[0] * c[1] - dir_[1] * c[0]])
            inv_det = 1.0 / _dot3(nrm, dir_)
            uu = _dot3(r, e2) * inv_det
            vv = _dot3(r, e1) * inv_det
            ww = 1.0 - uu - vv
            tt = _dot3(nrm, c) * inv_det
            hit = ((uu >= -eps) & (vv >= -eps) & (ww >= -eps)
                   & (tt >= tmin) & (tt <= tmax) & in_leaf
                   & (gpos >= 0) & ~done)
            best_t = torch.where(hit, tt, best_t)
            if any_hit:
                done = done | hit
            else:
                tmax = torch.where(hit, tt, tmax)
            best_u = torch.where(hit, uu, best_u)
            best_v = torch.where(hit, vv, best_v)
            best_pos = torch.where(hit, gpos, best_pos)
        leaf_cur = leaf_cur + in_leaf.to(i64)
        leaf_rem = leaf_rem - in_leaf.to(i64)
        leaf_exhausted = in_leaf & (leaf_rem == 0) & ~done

        # ---- wide inner step: 8 slab tests, sorted multi-push --------
        in_inner = active & ~in_leaf
        top_is_leaf = (top & 15) != 0
        enter_leaf = in_inner & top_is_leaf
        do_node = in_inner & ~top_is_leaf
        keys, hits = [], []
        for c in range(WIDTH):
            t0, t1 = tmin, tmax
            for d in range(3):
                tn, tf = slab_planes(row[c * 6 + 2 * d], row[c * 6 + 2 * d + 1],
                                     d, org, inv, inv_org, inv_pad, neg,
                                     robust)
                # NaN-propagating, as jnp.maximum/minimum (ROADMAP C6)
                t0 = torch.maximum(tn, t0)
                t1 = torch.minimum(tf, t1)
            hit = t0 <= t1
            hits.append(hit)
            keys.append(torch.where(hit, slot_key[c] if any_hit else t0,
                                    inf_row))
        words = [row[48 + c].to(i64) for c in range(WIDTH)]
        wt = words if ablate & ABLATE_NO_SORT else _sort8(keys, words)[1]
        n_hits = torch.stack(hits).sum(0)
        descend = do_node & (n_hits > 0)
        for j in () if ablate & ABLATE_NO_PUSH else range(WIDTH - 1, 0, -1):
            push = do_node & (n_hits > j)
            stack = torch.where(push, torch.cat([wt[j][None], stack[:-1]]),
                                stack)
            ovf = ovf | (push & (sp >= stack_depth))
            sp = torch.where(push, (sp + 1).clamp(max=stack_depth), sp)

        leaf_cur = torch.where(enter_leaf, fid, leaf_cur)
        leaf_rem = torch.where(enter_leaf, top & 15, leaf_rem)
        need_pop = (do_node & ~descend) | leaf_exhausted
        can_pop = need_pop & (sp > 0)
        sp = sp - can_pop.to(i64)
        popped = stack[0]
        stack = torch.where(can_pop, torch.cat([stack[1:], stack[:1] * 0]),
                            stack)
        top = torch.where(descend, wt[0], torch.where(can_pop, popped, top))
        active = active & ~done & ~(need_pop & ~can_pop)
        hwm = torch.maximum(hwm, sp)

    while bool(active.any()):
        for _ in range(4):  # a step is a no-op once inactive: sync less
            step()
    out_f = torch.stack([best_t, best_u, best_v])
    out_i = torch.stack([best_pos, asteps, hwm, ovf.to(i64)]).to(torch.int32)
    return out_f, out_i


def traverse_pairs_plain(table_cols, tid, rays, *, any_hit: bool,
                         robust: bool, stack_depth: int, ablate: int = 0,
                         count=None):
    """`traverse_pairs_ref` on the column tables [T, P, 64],
    on any device: the plain version in the layout that `traverse_pairs`
    and the render's `traverse` argument take. With `count`, as
    `traverse_pairs` takes it, the pairs from count on are no pairs."""
    if count is not None:
        lane = torch.arange(tid.shape[0], device=tid.device)
        tid = torch.where(lane < count, tid, -1)
    return traverse_pairs_ref(table_cols.transpose(1, 2), tid, rays,
                              any_hit=any_hit, robust=robust,
                              stack_depth=stack_depth, ablate=ablate)


def check_pair_inputs(name, table_cols, tid, rays, stack_depth: int) -> None:
    """Raise ValueError unless B1's inputs are what its kernel takes: a
    contiguous, 16-byte aligned [T, P, 64] f32 column table
    (`WideTreelets.table_cols`, not the [T, 64, P] `table`), [L] int32
    tid and [8, L] f32 rays on one device, and a stack within the
    compiled capacity."""
    _check_table(name, table_cols, rays.device, stack_depth)
    L = tid.shape[0]
    if (tid.dtype != torch.int32 or tid.dim() != 1 or not tid.is_contiguous()
            or tid.device != rays.device):
        raise ValueError(f"{name}: tid must be a contiguous [L] "
                         f"int32 tensor on {rays.device}")
    _check_rays(name, rays, L)


def _check_table(name, table_cols, device, stack_depth: int) -> None:
    if not 1 <= stack_depth <= kernels.WIDE_STACK_MAX:
        raise ValueError(f"{name}: stack depth {stack_depth} "
                         f"exceeds the kernel's {kernels.WIDE_STACK_MAX}")
    if (table_cols.dtype != torch.float32 or table_cols.dim() != 3
            or table_cols.shape[2] != ROWS or not table_cols.is_contiguous()
            or table_cols.data_ptr() % 16 or table_cols.device != device):
        raise ValueError(f"{name}: the table must be the column layout, a "
                         f"contiguous 16-byte aligned [T, P, {ROWS}] float32 "
                         f"tensor on {device} (WideTreelets.table_cols)")


def _check_rays(name, rays, L: int) -> None:
    if (rays.dtype != torch.float32 or tuple(rays.shape) != (8, L)
            or not rays.is_contiguous()):
        raise ValueError(f"{name}: rays must be a contiguous [8, L] "
                         "float32 tensor")


def traverse_pairs(table_cols, tid, rays, *, any_hit: bool, robust: bool,
                   stack_depth: int, count=None):
    """Wide treelet traversal of (ray, treelet) pairs over the column
    tables [T, P, 64] (`WideTreelets.table_cols`): the CUDA kernel for
    CUDA tensors, the plain version (`traverse_pairs_plain`) for CPU
    tensors. Outputs as `traverse_pairs_ref`.
    `count`: None, or a [1] int32 tensor on the rays' device holding the
    number of pairs to traverse, read by the kernel on the device: the
    pairs from count on are skipped and their outputs left unwritten
    (the plain version gives them a miss)."""
    if rays.device.type == "cpu":
        return traverse_pairs_plain(table_cols, tid, rays, any_hit=any_hit,
                                    robust=robust, stack_depth=stack_depth,
                                    count=count)
    if rays.device.type != "cuda":
        raise ValueError(f"traverse_pairs: unsupported device {rays.device}")
    check_pair_inputs("traverse_pairs", table_cols, tid, rays, stack_depth)
    if count is not None and (count.dtype != torch.int32
                              or count.numel() != 1
                              or count.device != rays.device):
        raise ValueError("traverse_pairs: count must be a [1] int32 tensor "
                         f"on {rays.device}")
    L = tid.shape[0]
    out_f = torch.empty((3, L), dtype=torch.float32, device=rays.device)
    out_i = torch.empty((4, L), dtype=torch.int32, device=rays.device)
    work = torch.empty(1, dtype=torch.int32, device=rays.device)
    kernels.WIDE_TREELET.launch(
        table_cols.data_ptr(), table_cols.shape[0], table_cols.shape[1],
        tid.data_ptr(), rays.data_ptr(), L, int(any_hit), int(robust),
        stack_depth, out_f.data_ptr(), out_i.data_ptr(), work.data_ptr(),
        None if count is None else count.data_ptr())
    return out_f, out_i


# ------------------------------------------------------------ the render
def _up_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def wide_treelet_caps(tl: WideTreelets, portals_per_round: int = 4) -> dict:
    """Scene-derived starting values of the capacity knobs, as the
    reference derives them (wide_treelet.py:2016-2044): a ray crossing
    a scene cut into T similar treelets enters O(T^(1/3)) of them. The
    render checks the exact overflow flags and raises the named cap."""
    T = int(tl.table.shape[0])
    S = int(tl.sup_cols.shape[0])
    max_portals = max(32, min(512, _up_pow2(5 * round(T ** (1.0 / 3.0)))))
    if S > 0:
        mps = max(16, min(256, _up_pow2(max(S // 4,
                                            6 * round(S ** (1.0 / 3.0))))))
        per_super = max(1, T // S)
        max_new = max(16, min(256, _up_pow2(per_super // 4)))
    else:
        mps, max_new = 16, 16
    max_rounds = max(64, 32 * max_portals // max(1, portals_per_round))
    return dict(max_portals=max_portals, max_rounds=max_rounds,
                mps=mps, max_new=max_new)


def wide_treelet_perf(tl: WideTreelets) -> dict:
    """The render's throughput knobs, as the reference picks them by
    scene size (wide_treelet.py:2047-2065): portals a ready ray and
    round; `tail_div`, which sets a tail round's default width
    `tail_cap = sel_cap // tail_div`; and `block`, `tail_block`, the
    widths `sel_cap` and `tail_cap` round up to. A wrong pick is slow,
    never wrong."""
    if tl.table.shape[0] >= 2048:
        return dict(portals_per_round=16, tail_div=4, block=256,
                    tail_block=128)
    return dict(portals_per_round=PORTALS_PER_ROUND, tail_div=8, block=512,
                tail_block=128)


def portals_per_round(tl: WideTreelets) -> int:
    """Portals expanded per ready ray and round (`wide_treelet_perf`):
    16 for scenes of 2,048 treelets or more, else 4. It sets the work
    per round and, for closest hit, how soon tmax falls; since the fast
    slab test culls a box whose rounded entry lies just past tmax, a
    rare ray's hit can depend on it (one ray of 16 sets at 10M
    interior). Any-hit results do not depend on it."""
    return wide_treelet_perf(tl)["portals_per_round"]


def octants(rays8) -> torch.Tensor:
    """Direction octant (sign bits x + 2y + 4z) of [8, R] packed rays."""
    neg = torch.signbit(rays8[3:6]).to(torch.int64)
    return neg[0] + 2 * neg[1] + 4 * neg[2]


def pack_rays(rays: Ray) -> torch.Tensor:
    """[8, R] f32 rows: org (0-2), dir (3-5), tmin (6), tmax (7)."""
    return torch.cat([rays.org.T, rays.dir.T, rays.tmin[None],
                      rays.tmax[None]]).to(torch.float32).contiguous()


class SuperLists(NamedTuple):
    """A two-level scene's phase-A supers, split off each ray's list."""

    sid: torch.Tensor      # [mps, Rc] int32 supers (tid - T), entry order
    count: torch.Tensor    # [Rc] int32 supers a ray recorded (past mps)
    tlen: torch.Tensor     # [Rc] int32 treelet list's length


class Portals(NamedTuple):
    """Phase-A result over the rays that entered any treelet box."""

    sel: torch.Tensor      # [Rc] ray indices with at least one portal
    tid: torch.Tensor      # [MP, Rc] int64 portals, ascending entry t
    tent: torch.Tensor     # [MP, Rc] f32 entry t (+inf unused)
    cnt: torch.Tensor      # [R] int32 portal count (past the cap)
    top_hwm: int           # phase-A stack high-water mark
    top_ovf: bool          # phase-A stack overflow
    max_cnt: int           # the largest portal count
    # two-level scenes sorted with `split`: the supers; tid, tent then
    # hold the treelet list, each super replaced by -1 / +inf
    sup: SuperLists | None = None


def collect_and_sort(tl: WideTreelets, packed, *, robust: bool,
                     top_stack: int, max_portals: int,
                     collect=collect_portals, mps: int | None = None
                     ) -> Portals:
    """Phase A, then `sort_portals`; with `mps`, the supers split off
    as the render's phase A2 takes them."""
    split = None if mps is None else (tl.table.shape[0], mps)
    return sort_portals(*collect(tl.top_node_t, packed, tl.top_root,
                                 robust=robust, stack_depth=top_stack,
                                 max_portals=max_portals), split=split)


def sort_portals(ptid, ptent, stats, *, split=None) -> Portals:
    """Phase A's records compacted to the rays that recorded any portal
    (:1536), each ray's portals sorted ascending by entry t (:1892),
    stably (`portal_sort.sort_columns`; the reference's sort is not
    declared stable, so only ties may differ). `split`: None, or
    (T, mps) in a two-level scene, whose lists are then split in the
    same pass (`portal_sort.split_columns`). Phase A's stack and count
    readings are read on the host before the ordering is queued, so the
    host does not wait for it."""
    cnt = stats[0]
    sel = torch.nonzero(cnt > 0).squeeze(1)
    top_hwm = int(stats[1].max()) if stats.numel() else 0
    top_ovf = bool(stats[2].any())
    max_cnt = int(cnt.max()) if cnt.numel() else 0
    if split is None:
        tid, tent = sort_columns(ptid, ptent, cnt, sel)
        sup = None
    else:
        T, mps = split
        tid, tent, sid, nsup, tlen = split_columns(ptid, ptent, cnt, sel,
                                                   T=T, mps=mps)
        sup = SuperLists(sid, nsup, tlen)
    return Portals(sel, tid, tent, cnt, top_hwm, top_ovf, max_cnt, sup)


def expand_supers(tl: WideTreelets, portals: Portals, rays_c, *,
                  robust: bool, sup_stack: int, mps: int, max_new: int,
                  max_portals: int, collect_super=collect_super_pairs,
                  over: dict | None = None):
    """Phase A2 (wide_treelet.py:1740-1873): replace each ray's super
    portals (tid >= T) by the treelet portals inside those supers.

    `portals` comes from `sort_portals(..., split=(T, mps))`: each
    ray's supers in entry order, at most `mps` of them, and its treelet
    list. The supers are expanded K2 per ready ray and round: one B4
    walk per (ray, super) pair, with the ray's own tmax, records up to
    `max_new` treelet portals; the new portals (record-major, then
    super) are merged stably after the ray's treelet portals by entry t
    and cut to the render's `max_portals` (`portal_sort.merge_columns`),
    in place: portals.tid, .tent and .sup.tlen are consumed. Rounds go
    on until no ray has a super left (the reference stops at 64, C11).

    Returns (tid, tent, bits, diag): the merged lists [MP, Rc] (int64,
    f32; portals.tid and .tent themselves), the reference's overflow
    mask (1: more than mps supers, 2: a pair recorded more than
    max_new, 4: a merged list longer than max_portals), and the A2
    rounds, pairs and B4's stack overflow.

    `over`: None, or a dict that the render driver passes to learn which
    rays went past a cap. Its "cols", if set, is a bool [Rc] mask of
    columns that take no round. It then gets under "cols" None or the
    bool [Rc] mask of those columns and the ones past mps, max_new,
    max_portals or B4's stack (each such column takes no further round,
    its list left as it stands), and the counts behind the caps, read
    where the host reads the flags: "max_sup" (the most supers a ray
    recorded), "max_rec" (the most records a pair made) and "max_len"
    (the longest merged list before its cut). The masks cost no host
    read. Without `over` the result is the same for every column."""
    if portals.sup is None or portals.sup.sid.shape[0] != mps:
        raise ValueError("expand_supers: the portals must be split at mps "
                         "(sort_portals(..., split=(T, mps)))")
    dev = rays_c.device
    i64 = torch.int64
    tid, tent = portals.tid, portals.tent
    sup_id, tlen = portals.sup.sid, portals.sup.tlen
    Rc = tid.shape[1]
    bits = 0
    max_sup = int(portals.sup.count.max()) if Rc else 0
    diag = dict(a2_rounds=0, a2_pairs=0, sup_ovf=False)
    scur = torch.zeros(Rc, dtype=i64, device=dev)
    lanes = torch.arange(Rc, device=dev)
    steps = torch.arange(K2, device=dev)[:, None]
    if over is not None:
        gone = over.get("cols")
        over.update(cols=None, max_sup=max_sup, max_rec=0, max_len=0)

    def mark(cols):
        """The columns of the bool [Rc] mask `cols` are past a cap:
        recorded in `over`, and retired."""
        if over is None:
            return
        if over["cols"] is None:
            over["cols"] = torch.zeros(Rc, dtype=torch.bool, device=dev)
        over["cols"].logical_or_(cols)
        scur.masked_fill_(cols, mps)

    def pairs_past(flag):
        """[Rc] bool: the columns of the pairs where `flag` [L] holds."""
        return torch.zeros(Rc, dtype=torch.int32, device=dev).index_add_(
            0, rsel[rr], flag.to(torch.int32)) > 0

    if over is not None and gone is not None:
        mark(gone)
    if max_sup > mps:
        bits |= 1
        mark(portals.sup.count > mps)
    while True:
        cur = torch.where(scur < mps, sup_id.gather(
            0, scur.clamp(max=mps - 1)[None])[0], -1)
        rsel = lanes[cur >= 0]
        if rsel.numel() == 0:
            break
        with trace.span("bvh.a2_round"):
            idx = scur[rsel][None, :] + steps                     # [K2, Rr]
            wsid = torch.where(idx < mps, sup_id[:, rsel].gather(
                0, idx.clamp(max=mps - 1)), -1)
            jj, rr = torch.nonzero(wsid >= 0, as_tuple=True)
            perm = torch.sort(wsid[jj, rr], stable=True).indices  # by super
            jj, rr = jj[perm], rr[perm]
            ntid, nt, stats = collect_super(
                tl.sup_cols, wsid[jj, rr].contiguous(),
                rays_c[:, rsel[rr]].contiguous(), robust=robust,
                stack_depth=sup_stack, max_new=max_new)
            diag["a2_rounds"] += 1
            diag["a2_pairs"] += rr.numel()
            if rr.numel():
                rec = int(stats[0].max())
                if rec > max_new:
                    bits |= 2
                    mark(pairs_past(stats[0] > max_new))
                if bool(stats[2].any()):
                    diag["sup_ovf"] = True
                    mark(pairs_past(stats[2] != 0))
                if over is not None:
                    over["max_rec"] = max(over["max_rec"], rec)
            fcnt = merge_columns(tid, tent, tlen, rsel, jj, rr, ntid, nt,
                                 stats[0], k2=K2, max_new=max_new)
            flen = int(fcnt.max())
            if flen > max_portals:
                bits |= 4
                mark(_spread(None, Rc, rsel, fcnt > max_portals))
            if over is not None:
                over["max_len"] = max(over["max_len"], flen)
            scur[rsel] += K2
    return tid, tent, bits, diag


def ready_rays(portals: Portals, cur, tmax, bpos, *, any_hit: bool):
    """The rays that take part in the next round: those whose portal at
    the cursor is live (:1551-1561). Entries ascend and tmax only
    shrinks, so a ray whose next portal starts past its tmax is done;
    an any-hit ray is done at its first hit.
    Returns (live [Rc] bool, rsel: indices of the ready rays)."""
    live, ready = ready_mask(portals.tid, portals.tent, cur, tmax, bpos,
                             any_hit=any_hit)
    return live, torch.nonzero(ready).squeeze(1)


def ready_mask(tid, tent, cur, tmax, bpos, *, any_hit: bool):
    """`ready_rays` as masks over the columns of the sorted portals
    tid, tent [MP, Rc]: (live, ready), both [Rc] bool."""
    mp = tid.shape[0]
    live = bpos < 0 if any_hit else torch.ones_like(cur, dtype=torch.bool)
    curc = cur.clamp(max=mp - 1)[None, :]
    p_tid = torch.where(cur < mp, tid.gather(0, curc)[0], -1)
    p_t = tent.gather(0, curc)[0]
    return live, live & (p_tid >= 0) & (p_t <= tmax)


def round_pairs(portals: Portals, cur, tmax, live, rays_c, octant, rsel,
                k: int):
    """The (ray, treelet) pairs of one round: portals cur..cur+k-1 of
    each ready ray `rsel` that are still live (:1726-1738), ordered by
    treelet id * 8 + octant (:1599) for coherence only.
    Returns (validk [k, Rr], pk, pr, tid [L] int32, rays [8, L])."""
    mp = portals.tid.shape[0]
    idx = cur[rsel][None, :] + torch.arange(k, device=cur.device)[:, None]
    inb = idx < mp
    idxc = idx.clamp(max=mp - 1)
    wtid = torch.where(inb, portals.tid[:, rsel].gather(0, idxc), -1)
    wtt = torch.where(inb, portals.tent[:, rsel].gather(0, idxc),
                      float("inf"))
    validk = (wtid >= 0) & (wtt <= tmax[rsel][None, :]) & live[rsel][None, :]
    kk, rr = torch.nonzero(validk, as_tuple=True)
    key = wtid[kk, rr] * WIDTH + octant[rsel][rr]
    perm = torch.sort(key, stable=True).indices
    pk, pr = kk[perm], rr[perm]
    ray = rsel[pr]
    prays = rays_c[:, ray]
    prays[7] = tmax[ray]  # pairs carry the ray's current tmax
    return validk, pk, pr, wtid[pk, pr].to(torch.int32), prays.contiguous()


def merge_round(best, tmax, cur, rsel, validk, pk, pr, out_f, out_i, *,
                k: int, any_hit: bool) -> None:
    """Merge one round's pair results into the best hits of the ready
    rays `rsel`, first-j strict-min for closest hit and first-j hit for
    any-hit (:1702-1724), and write them back: `best` = (bt, bu, bv,
    bpos), `tmax` (closest hit) and the portal cursors `cur` are updated
    in place. validk, pk, pr: `round_pairs`' outputs; out_f, out_i:
    kernel B1's on those pairs."""
    bt, bu, bv, bpos = best
    res_t, res_u, res_v, res_pos = _no_hits((k, rsel.numel()), bt.device)
    res_t[pk, pr] = out_f[0]
    res_u[pk, pr] = out_f[1]
    res_v[pk, pr] = out_f[2]
    res_pos[pk, pr] = out_i[0].to(torch.int64)
    n_bt, n_bu, n_bv, n_pos = merge_first_j(
        (bt[rsel], bu[rsel], bv[rsel], bpos[rsel]), validk,
        (res_t, res_u, res_v, res_pos), any_hit=any_hit)
    if not any_hit:
        tmax[rsel] = torch.minimum(tmax[rsel], n_bt)
    bt[rsel], bu[rsel], bv[rsel], bpos[rsel] = n_bt, n_bu, n_bv, n_pos
    cur[rsel] += k


def merge_first_j(best, validk, res, *, any_hit: bool):
    """Fold the results res = (t, u, v, pos), each [k, W], of a window
    of k portals into the best hits best = (t, u, v, pos), each [W]:
    the first j that is better (closest hit: a strictly smaller t) or
    that hits (any-hit, while the ray has no hit) wins, where
    validk [k, W] (:1702-1724). Returns the new (t, u, v, pos)."""
    n_bt, n_bu, n_bv, n_pos = best
    res_t, res_u, res_v, res_pos = res
    for j in range(validk.shape[0]):
        if any_hit:
            upd = validk[j] & (res_pos[j] >= 0) & (n_pos < 0)
        else:
            upd = validk[j] & (res_t[j] < n_bt)
        n_bt = torch.where(upd, res_t[j], n_bt)
        n_bu = torch.where(upd, res_u[j], n_bu)
        n_bv = torch.where(upd, res_v[j], n_bv)
        n_pos = torch.where(upd, res_pos[j], n_pos)
    return n_bt, n_bu, n_bv, n_pos


def _prepare(tl: WideTreelets, packed, *, robust, top_stack, max_portals,
             mps, max_new, sup_stack, collect, collect_super, stage):
    """Each ray's portal list: phase A, its ordering and, in two-level
    scenes, phase A2, of [8, R] packed rays. Returns (portals, rays_c,
    late, diag): the lists of the rays that entered a treelet box
    (`portals.sel` their indices), their packed rays [8, Rc], None or
    the bool [Rc] mask of the lists past a cap (phase A's max_portals or
    stack, A2's mps, max_new, max_portals or stack), which are not
    worked further, and the diag, whose "overflow" is None or the bool
    [R] mask of the rays past phase A's caps, and whose counts say how
    far past: max_cnt (phase A's largest portal count) and, in two-level
    scenes, max_sup, max_rec and max_len (`expand_supers`' `over`). The
    masks are made, without a host read, only once a flag the host
    reads anyway is up, so lists that fit every cap cost no launch and
    no host read more."""
    two_level = tl.sup_cols.shape[0] > 0
    records = stage("phase_a", collect, tl.top_node_t, packed, tl.top_root,
                    robust=robust, stack_depth=top_stack,
                    max_portals=max_portals)
    portals = stage("portal_sort", sort_portals, *records,
                    split=(tl.table.shape[0], mps) if two_level else None)
    diag = dict(max_cnt=portals.max_cnt,
                top_hwm=portals.top_hwm, top_ovf=portals.top_ovf,
                stack_hwm=0, stack_ovf=False, rounds=0, pairs=0,
                pending=False, a2_bits=0, max_sup=0, max_rec=0, max_len=0,
                overflow=None)
    late = None
    if diag["max_cnt"] > max_portals or diag["top_ovf"]:
        # phase A's lists of these rays are cut: they go no further
        diag["overflow"] = (portals.cnt > max_portals) | (records[2][2] != 0)
        late = diag["overflow"][portals.sel]
    del records
    rays_c = packed[:, portals.sel]
    if two_level:
        over = dict(cols=late)
        tid, tent, bits, a2 = stage(
            "phase_a2", expand_supers, tl, portals, rays_c, robust=robust,
            sup_stack=sup_stack, mps=mps, max_new=max_new,
            max_portals=max_portals, collect_super=collect_super, over=over)
        late = over.pop("cols")
        diag.update(a2, a2_bits=bits, **over)
        portals = portals._replace(tid=tid, tent=tent)
    return portals, rays_c, late, diag


def _pair_rounds(tl: WideTreelets, portals: Portals, rays_c, late, diag, *,
                 any_hit, robust, stack_depth, max_rounds, k, traverse,
                 stage):
    """The pair rounds over the sorted lists portals.tid, .tent
    [MP, Rc] of the packed rays rays_c [8, Rc]; the columns set in
    `late` (None or a bool [Rc] mask) take no round. Returns the best
    hits (t, u, v, pos), each [Rc], and a copy of `late` with the
    columns past B1's stack or max_rounds set too; diag's rounds,
    pairs, stack_hwm, stack_ovf and pending are updated in place."""
    dev = rays_c.device
    Rc = rays_c.shape[1]
    mp = portals.tid.shape[0]
    octant = octants(rays_c)
    tmax = rays_c[7].clone()
    bt, bu, bv, bpos = _no_hits((Rc,), dev)
    cur = torch.zeros(Rc, dtype=torch.int64, device=dev)
    if late is not None:
        cur.masked_fill_(late, mp)             # past its list: never ready
    while True:
        live, rsel = stage("ready", ready_rays, portals, cur, tmax, bpos,
                           any_hit=any_hit)
        if rsel.numel() == 0:
            break
        if diag["rounds"] == max_rounds:
            diag["pending"] = True
            late = _spread(None if late is None else late.clone(), Rc,
                           rsel, True)
            break
        validk, pk, pr, ptid, prays = stage(
            "round_pairs", round_pairs, portals, cur, tmax, live, rays_c,
            octant, rsel, k)
        out_f, out_i = stage("b1", traverse, tl.table_cols, ptid, prays,
                             any_hit=any_hit, robust=robust,
                             stack_depth=stack_depth)
        diag["rounds"] += 1
        diag["pairs"] += ptid.numel()
        deep = None
        if ptid.numel():
            diag["stack_hwm"] = max(diag["stack_hwm"], int(out_i[2].max()))
            if bool(out_i[3].any()):
                diag["stack_ovf"] = True
                deep = torch.zeros(Rc, dtype=torch.int32, device=dev)
                deep = deep.index_add_(0, rsel[pr],
                                       (out_i[3] != 0).to(torch.int32)) > 0
        stage("merge_round", merge_round, (bt, bu, bv, bpos), tmax, cur,
              rsel, validk, pk, pr, out_f, out_i, k=k, any_hit=any_hit)
        if deep is not None:
            late = deep if late is None else late | deep
            cur.masked_fill_(deep, mp)
    return (bt, bu, bv, bpos), late


def walk_portals_plain(tl: WideTreelets, portals: Portals, rays_c, late,
                       diag, *, any_hit, robust, stack_depth, k: int):
    """The portal walk's plain version: `_pair_rounds` over
    `traverse_pairs_plain` at k (any-hit: at k = 1, since the walk stops
    a ray at its first hit); diag as `walk_portals` updates it (one
    walk, its (ray, treelet) pairs, stack high-water mark and
    overflow)."""
    rounds = dict(rounds=0, pairs=0, stack_hwm=0, stack_ovf=False,
                  pending=False)
    best, late = _pair_rounds(
        tl, portals, rays_c, late, rounds, any_hit=any_hit, robust=robust,
        stack_depth=stack_depth, max_rounds=portals.tid.shape[0] + 1,
        k=1 if any_hit else k, traverse=traverse_pairs_plain,
        stage=run_stage)
    _count_walk(diag, rounds["pairs"], rounds["stack_hwm"],
                rounds["stack_ovf"])
    return best, late


def _count_walk(diag, walks: int, hwm: int, ovf: bool) -> None:
    diag["rounds"] += 1
    diag["pairs"] += walks
    diag["stack_hwm"] = max(diag["stack_hwm"], hwm)
    diag["stack_ovf"] = diag["stack_ovf"] or ovf


def check_walk_inputs(name, table_cols, tid, tent, rays_c, late,
                      stack_depth: int) -> None:
    """Raise ValueError unless the portal walk's inputs are what its
    kernel takes: B1's column table and stack (`check_pair_inputs`),
    contiguous [MP, Rc] int64 tid and float32 tent, [8, Rc] rays and
    None or a contiguous [Rc] bool `late`, on one device."""
    _check_table(name, table_cols, rays_c.device, stack_depth)
    if (tid.dtype != torch.int64 or tid.dim() != 2 or not tid.is_contiguous()
            or tid.device != rays_c.device):
        raise ValueError(f"{name}: tid must be a contiguous [MP, Rc] int64 "
                         f"tensor on {rays_c.device}")
    if (tent.dtype != torch.float32 or tent.shape != tid.shape
            or not tent.is_contiguous() or tent.device != rays_c.device):
        raise ValueError(f"{name}: tent must be a contiguous [MP, Rc] "
                         f"float32 tensor on {rays_c.device}")
    if late is not None and (late.dtype != torch.bool
                             or tuple(late.shape) != (tid.shape[1],)
                             or not late.is_contiguous()
                             or late.device != rays_c.device):
        raise ValueError(f"{name}: late must be None or a contiguous [Rc] "
                         f"bool tensor on {rays_c.device}")
    _check_rays(name, rays_c, tid.shape[1])


def walk_portals(tl: WideTreelets, portals: Portals, rays_c, late, diag, *,
                 any_hit, robust, stack_depth, k: int):
    """`_pair_rounds`' rounds of k portals as one walk of every ray's
    list: each ray walks its sorted portals portals.tid, .tent [MP, Rc]
    in entry order, in windows of k portals, each treelet at the
    window's tmax, which falls to the ray's best t after each window,
    until the ray is no longer ready (any-hit: also at its first hit).
    On CUDA tensors one launch of the portal walk kernel
    (csrc/wide_treelet.cu) and one host read of its stats row; on CPU
    tensors its plain version (`walk_portals_plain`). For other inputs
    it raises.

    Takes and returns what `_pair_rounds` does: the best hits (t, u, v,
    pos), each [Rc], and a copy of `late` with the columns past B1's
    stack set too (None if none was and none is). Closest hit: equal
    bit for bit to `_pair_rounds` at the same k, where no column
    overflows B1's stack (one that does is walked no further). Any-hit:
    equal to `_pair_rounds` at k = 1, and its hits to the rounds' at any
    k. diag gets one round (the walk), its (ray, treelet) pairs, the
    stack high-water mark over them and the stack overflow. A ray walks
    at most MP portals, so no round cap binds the walk and it never
    sets diag's "pending"."""
    if k < 1:
        raise ValueError(f"walk_portals: k must be at least 1, got {k}")
    if rays_c.device.type == "cpu":
        return walk_portals_plain(tl, portals, rays_c, late, diag,
                                  any_hit=any_hit, robust=robust,
                                  stack_depth=stack_depth, k=k)
    if rays_c.device.type != "cuda":
        raise ValueError(f"walk_portals: unsupported device {rays_c.device}")
    tid, tent, cols = portals.tid, portals.tent, tl.table_cols
    check_walk_inputs("walk_portals", cols, tid, tent, rays_c, late,
                      stack_depth)
    MP, Rc = tid.shape
    dev = rays_c.device
    out_f = torch.empty((3, Rc), dtype=torch.float32, device=dev)
    pos = torch.empty(Rc, dtype=torch.int64, device=dev)
    deep = torch.empty(Rc, dtype=torch.bool, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    kernels.WALK.launch(
        cols.data_ptr(), cols.shape[0], cols.shape[1], tid.data_ptr(),
        tent.data_ptr(), MP, rays_c.data_ptr(), Rc,
        None if late is None else late.data_ptr(), k, int(any_hit),
        int(robust), stack_depth, out_f.data_ptr(), pos.data_ptr(),
        deep.data_ptr(), stats.data_ptr())
    _, hwm, ovf, walks = stats.tolist()
    _count_walk(diag, walks, hwm, bool(ovf))
    if ovf:
        late = deep if late is None else late | deep
    return (out_f[0], out_f[1], out_f[2], pos), late


def _spread(mask, n: int, idx, values):
    """`mask` (a bool [n] tensor, or None for none) with `values` (bool,
    one per index, or one for all) or-ed in at the distinct indices
    `idx`, without a host read."""
    if mask is None:
        mask = torch.zeros(n, dtype=torch.bool, device=idx.device)
    mask[idx] = mask[idx] | values
    return mask


def _joined(groups: list):
    """(portals, rays_c, dead) of several `_prepare` results (portals,
    rays_c, late) as one: the columns of each in turn, each list in the
    first rows of one [MP, C] pair, MP the longest, padded with -1 /
    +inf; `dead` [C] bool marks each result's `late` columns, whose rays
    a later result holds. One copy of each list, no host read."""
    mp = max(p.tid.shape[0] for p, _, _ in groups)
    C = sum(p.tid.shape[1] for p, _, _ in groups)
    dev = groups[0][1].device
    tid = torch.empty((mp, C), dtype=torch.int64, device=dev)
    tent = torch.empty((mp, C), dtype=torch.float32, device=dev)
    dead = []
    off = 0
    for p, _, late in groups:
        m, n = p.tid.shape
        tid[:m, off:off + n] = p.tid
        tent[:m, off:off + n] = p.tent
        tid[m:, off:off + n] = -1
        tent[m:, off:off + n] = float("inf")
        dead.append(torch.zeros(n, dtype=torch.bool, device=dev)
                    if late is None else late)
        off += n
    portals = groups[0][0]._replace(
        sel=torch.cat([p.sel for p, _, _ in groups]), tid=tid, tent=tent,
        sup=None)
    return (portals, torch.cat([r for _, r, _ in groups], 1),
            torch.cat(dead))


class _Reruns:
    """The render driver's re-run bookkeeping (`_attempts`) over [8, R]
    packed rays: each attempt's rays, the lists waiting for the tracer,
    and every ray's t, u, v, pos and phase-A count (`out`, [R] each).
    What only a re-run does runs in the span bvh.render.rerun, so a
    render that overflows nothing opens none."""

    def __init__(self, packed):
        self.every = self.packed = packed   # every ray; this attempt's
        self.todo = None        # the indices of this attempt's (None: all)
        self.groups = []        # lists that fit their caps, waiting
        self.out = _no_hits((packed.shape[1],), packed.device) + [None]

    @staticmethod
    def _span(rerun: bool):
        return (trace.span("bvh.render.rerun") if rerun
                else contextlib.nullcontext())

    def lists(self, portals: Portals, rays_c, late, over, last: bool):
        """Take an attempt's `_prepare` results. Its lists wait with the
        lists before while a ray is past a phase-A or A2 cap (`over`, a
        mask over its rays; `late` over its lists) and another attempt
        may follow: None. Else every waiting list as one, (portals,
        rays_c, dead), `dead` None or the mask of the columns to skip."""
        rerun = self.todo is not None
        with self._span(rerun):
            if late is not None:     # past a cap: left to a re-run
                over = _spread(over, self.packed.shape[1], portals.sel, late)
            if rerun:
                self.out[4][self.todo] = portals.cnt
                portals = portals._replace(sel=self.todo[portals.sel])
            else:
                self.out[4] = portals.cnt
            self.over, self.late = over, None
            self.groups.append((portals, rays_c, late))
            if over is not None and not last:
                return None
            groups, self.groups = self.groups, []
            self.joined = len(groups) > 1
            return _joined(groups) if self.joined else groups[0]

    def scatter(self, sel, best, late, dead) -> None:
        """Write the traced best hits (t, u, v, pos) back by ray index
        `sel`, of joined lists each ray's live column only. `late`: the
        tracer's None or bool [C] mask of the columns past a cap."""
        self.sel = sel
        with self._span(self.joined):
            if self.joined:
                live = torch.nonzero(~late).squeeze(1)
                sel, best = sel[live], [b[live] for b in best]
                late = late & ~dead
            for o, b in zip(self.out, best):
                o[sel] = b
        self.late = late

    def _left(self):
        """The indices of the rays that the attempt left past a cap."""
        left = []
        if self.over is not None:
            local = torch.nonzero(self.over).squeeze(1)
            left.append(local if self.todo is None else self.todo[local])
        if self.late is not None:
            left.append(self.sel[self.late])
        return left[0] if len(left) == 1 else torch.cat(left)

    def rerun(self) -> int:
        """Give the next attempt the rays left past a cap; their count."""
        with self._span(True):
            self.todo = self._left()
            self.packed = self.every[:, self.todo]
        return self.todo.numel()

    def overflow(self):
        """The bool [R] mask of the rays left past a cap."""
        return _spread(None, self.every.shape[1], self._left(), True)


def _attempts(tl: WideTreelets, packed, caps: dict, tries: int, *,
              walk: bool, any_hit, robust, k, collect, traverse,
              collect_super, stage):
    """The render driver: at most `tries` attempts at [8, R] packed rays,
    the first over every ray at `caps`, each later one over the rays the
    one before left past a cap, at caps raised for them (`_raised_caps`,
    into `caps`). An attempt runs `_prepare`. While another attempt may
    follow, lists past a phase-A or A2 cap are left to it and the lists
    that fit wait (`_Reruns`); once none is past such a cap, or on the
    last attempt, the lists that fit are traced: by `walk_portals` (the
    stage "walk") where `walk`, else by `_pair_rounds` over `traverse`,
    each stage run through `stage`. Rays past B1's stack or the round cap
    are left to the next attempt.
    Returns (t, u, v, pos, cnt, diag, total, bumps): each ray's best hit
    and phase-A count, [R] each; the last attempt's diag, whose
    "overflow" is None or the bool [R] mask of the rays it left past a
    cap, whose outputs are not hits; the diags tallied (`_tally`); and
    the caps the last attempt asks to raise ({} once every ray fits)."""
    runs = _Reruns(packed)
    total = {}
    for attempt in range(tries):
        last = attempt == tries - 1
        with trace.span("bvh.render.attempt"):
            portals, rays_c, late, diag = _prepare(
                tl, runs.packed, robust=robust, top_stack=caps["top_stack"],
                max_portals=caps["max_portals"], mps=caps["mps"],
                max_new=caps["max_new"], sup_stack=caps["sup_stack"],
                collect=collect, collect_super=collect_super, stage=stage)
            lists = runs.lists(portals, rays_c, late, diag.pop("overflow"),
                               last)
            if lists is not None:
                portals, rays_c, dead = lists
                if walk:
                    best, late = stage(
                        "walk", walk_portals, tl, portals, rays_c, dead,
                        diag, any_hit=any_hit, robust=robust,
                        stack_depth=caps["stack_depth"], k=k)
                else:
                    best, late = _pair_rounds(
                        tl, portals, rays_c, dead, diag, any_hit=any_hit,
                        robust=robust, stack_depth=caps["stack_depth"],
                        max_rounds=caps["max_rounds"], k=k,
                        traverse=traverse, stage=stage)
                runs.scatter(portals.sel, best, late, dead)
        _tally(total, diag)
        bumps = _raised_caps(diag, caps)
        if not bumps or last:
            break
        caps.update(bumps)
        total["rerun_rays"] += runs.rerun()
    diag["overflow"] = runs.overflow() if bumps else None
    return (*runs.out, diag, total, bumps)


def render_at_caps(tl: WideTreelets, packed, caps: dict, *, any_hit: bool,
                   robust: bool, collect=collect_portals,
                   traverse=traverse_pairs,
                   collect_super=collect_super_pairs, stage=run_stage,
                   k: int | None = None):
    """One attempt of the render driver (`_attempts`) over [8, R] packed
    rays at the capacities `caps` (as `wide_treelet_intersect_tris(...,
    return_diag=True)` reports them), traced by `_pair_rounds`' rounds
    of `k` portals (default `portals_per_round(tl)`, at which its hits
    equal the entry point's), each stage run through `stage`: the
    profilers time those stages, which the entry point's walk on the
    card runs as one launch. Returns (t, u, v, pos, cnt, diag): each
    ray's best hit and phase-A count, [R] each, and the attempt's diag,
    whose "overflow" is None or the bool [R] mask of the rays past a
    cap, whose outputs are not hits. An overflow is not raised."""
    return _attempts(
        tl, packed, caps, 1, walk=False, any_hit=any_hit, robust=robust,
        k=portals_per_round(tl) if k is None else k, collect=collect,
        traverse=traverse, collect_super=collect_super, stage=stage)[:6]


def wide_treelet_intersect_tris(
    tl: WideTreelets,
    rays: Ray,
    prim_ids=None,
    *,
    any_hit: bool = False,
    robust: bool = False,
    top_stack: int | None = None,
    stack_depth: int | None = None,
    max_portals: int | None = None,
    max_rounds: int | None = None,
    mps: int | None = None,
    max_new: int | None = None,
    auto_caps: bool = True,
    return_diag: bool = False,
) -> Hit:
    """Closest/any-hit over a wide-treelet scene (see module docstring),
    on the device of `rays`.

    `prim_ids`: the tree's permutation, to translate hit positions to
    primitive ids (None when primitives were pre-permuted).
    Capacities default to the reference's: top_stack = top_depth + 1,
    stack_depth = 7 * wide_depth + 8, max_portals, max_rounds and, in
    two-level scenes, mps (supers per ray) and max_new (treelet portals
    per (ray, super) pair) from `wide_treelet_caps`; phase A2's stack is
    sup_depth + 1. Every capacity has an exact overflow flag;
    with `auto_caps` the rays past a cap, and only those, are rendered
    again, packed apart, at caps raised for them (`_raised_caps`), at
    most 8 attempts in all: rays past a phase-A or A2 cap get their
    lists anew, and one round loop (on the card one portal walk,
    `walk_portals`) then traces every ray's list; rays past B1's stack
    or the round cap are rendered once more. Without
    `auto_caps` an overflow raises. Results of a ray past a cap are
    never returned, and every hit equals, bit for bit, that of one
    attempt at caps nothing overflows.
    `return_diag`: also return a dict of rounds, pairs, stack
    high-water marks (over every attempt), the attempts, the re-run
    rays and the last attempt's caps, at which one attempt fits every
    ray."""
    # The one choice of tracer: on the card the entry point walks each
    # ray's list in one launch (`walk_portals`). Every other caller of the
    # driver keeps `_pair_rounds`' rounds: `render_at_caps`, whose stages
    # the profilers time; the chain's eager render, which reads their
    # rounds and pairs to size its fixed schedule; the plain versions,
    # which hold the kernels to them; and the CPU.
    return _intersect(tl, rays, prim_ids, collect_portals, traverse_pairs,
                      any_hit=any_hit, robust=robust, top_stack=top_stack,
                      stack_depth=stack_depth, max_portals=max_portals,
                      max_rounds=max_rounds, mps=mps, max_new=max_new,
                      auto_caps=auto_caps, return_diag=return_diag,
                      walk=rays.org.device.type == "cuda")


@trace.spanned("bvh.render")
def _intersect(tl, rays, prim_ids, collect, traverse, *, any_hit=False,
               robust=False, top_stack=None, stack_depth=None,
               max_portals=None, max_rounds=None, mps=None, max_new=None,
               auto_caps=True, return_diag=False,
               collect_super=collect_super_pairs, k=None, walk=False):
    """`wide_treelet_intersect_tris` with phase A, the pair traversal and
    phase A2 given as `collect`, `traverse` and `collect_super`: the
    kernels' dispatchers, or their plain versions (`collect_portals_ref`,
    `traverse_pairs_plain`, `collect_super_pairs_plain`) to run the
    render without the kernels on any device. `traverse` is given the
    column tables `tl.table_cols`, `collect_super` the super rows
    `tl.sup_cols`. `k`: portals a ready ray and round (default
    `portals_per_round(tl)`).

    The render driver `_attempts` makes at most 8 attempts (one without
    `auto_caps`), each stage run through `run_stage`. With `walk` it
    traces by `walk_portals` at k, one launch of the portal walk kernel,
    else by `_pair_rounds`' rounds over `traverse`; the hits are the
    same. A walk is one round, whose pairs are the (ray, treelet) walks
    it made, so `Hit.stats`' round field then counts one a call plus one
    for each re-run after B1's stack overflowed.

    While a torch profiler records, the call is the span bvh.render and
    adds to the `core.trace` counters wide_treelet.calls (1), .rays,
    .attempts, .rounds, .pairs, .a2_rounds and .rerun_rays (the rays of
    every attempt after the first), also when it raises: an overflowed
    attempt is work done too."""
    if k is None:
        k = portals_per_round(tl)
    auto = dict(wide_treelet_caps(tl, k), top_stack=tl.top_depth + 1,
                stack_depth=7 * tl.wide_depth + 8, sup_stack=tl.sup_depth + 1)
    given = dict(top_stack=top_stack, stack_depth=stack_depth,
                 max_portals=max_portals, max_rounds=max_rounds, mps=mps,
                 max_new=max_new, sup_stack=None)
    caps = {n: auto[n] if v is None else v for n, v in given.items()}
    packed = pack_rays(rays)
    bt, bu, bv, pos, cnt, _, diag, bumps = _attempts(
        tl, packed, caps, 8 if auto_caps else 1, walk=walk, any_hit=any_hit,
        robust=robust, k=k, collect=collect, traverse=traverse,
        collect_super=collect_super, stage=run_stage)
    trace.count("wide_treelet.calls", 1)
    trace.count("wide_treelet.rays", packed.shape[1])
    for name in ("attempts", "rounds", "pairs", "a2_rounds", "rerun_rays"):
        trace.count("wide_treelet." + name, diag.get(name, 0))
    if bumps:
        raise ValueError(f"wide-treelet capacity overflow: {bumps} "
                         f"needed with caps {caps}")

    missed = pos < 0
    prim_pos = torch.where(missed, INVALID_PRIM_ID, pos)
    if prim_ids is not None:
        ids = torch.as_tensor(prim_ids, device=pos.device).to(torch.int64)
        prim_id = torch.where(missed, INVALID_PRIM_ID,
                              ids[pos.clamp(0, ids.shape[0] - 1)])
    else:
        prim_id = prim_pos
    hit = Hit(t=torch.where(missed, float("inf"), bt), u=bu, v=bv,
              prim_pos=prim_pos, prim_id=prim_id,
              stats=TraversalStats(cnt.to(torch.int64),
                                   torch.full_like(pos, diag["rounds"])))
    if return_diag:
        return hit, dict(diag, caps=caps)
    return hit


def _no_hits(shape: tuple, device) -> list:
    """[t, u, v, pos], each of `shape`, of rays that hit nothing."""
    return [torch.full(shape, float("inf"), dtype=torch.float32,
                       device=device),
            torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device),
            torch.full(shape, -1, dtype=torch.int64, device=device)]


# an attempt's diag entries that add up over a call's attempts, and those
# that keep their largest value; the flags are the last attempt's
_SUMMED = ("rounds", "pairs", "a2_rounds", "a2_pairs")
_PEAKS = ("max_cnt", "top_hwm", "stack_hwm", "max_sup", "max_rec", "max_len")


def _tally(total: dict, diag: dict) -> None:
    """Fold one attempt's diag into the call's `total`, in place."""
    if not total:
        total.update(diag, attempts=0, rerun_rays=0)
    else:
        for name, v in diag.items():
            total[name] = (total[name] + v if name in _SUMMED else
                           max(total[name], v) if name in _PEAKS else v)
    total["attempts"] += 1


def _raised_caps(diag: dict, caps: dict) -> dict:
    """The caps an attempt's overflow asks to raise, each only upward:
    to the need that phase A (its portal count) and B4 (a pair's record
    count) and the split (a ray's super count) report exactly, rounded
    up to a power of two, else doubled (a merged list counts only up to
    its round, so max_portals takes the larger of both). {} where
    nothing overflowed."""
    bumps = {}
    if diag["max_cnt"] > caps["max_portals"]:
        bumps["max_portals"] = _up_pow2(diag["max_cnt"])
    if diag["top_ovf"]:
        bumps["top_stack"] = 2 * caps["top_stack"]
    if diag["stack_ovf"]:
        bumps["stack_depth"] = 2 * caps["stack_depth"]
    if diag["pending"]:
        bumps["max_rounds"] = 2 * caps["max_rounds"]
    if diag["a2_bits"] & 1:
        bumps["mps"] = _up_pow2(diag["max_sup"])
    if diag["a2_bits"] & 2:
        bumps["max_new"] = _up_pow2(diag["max_rec"])
    if diag["a2_bits"] & 4:
        bumps["max_portals"] = max(bumps.get("max_portals", 0),
                                   2 * caps["max_portals"],
                                   _up_pow2(diag["max_len"]))
    if diag.get("sup_ovf"):
        bumps["sup_stack"] = 2 * caps["sup_stack"]
    return bumps


# ------------------------------------------- the render as one program
# `_render_fixed`'s observations, in the order of its stats row: phase
# A's largest portal count and its stack overflow, B1's stack overflow,
# the rays that recorded a portal, a ray still ready after the last
# round, and the rounds in which any ray was ready
FIXED_STATS = ("max_cnt", "top_ovf", "stack_ovf", "nready", "pending",
               "rounds_used")
_STATE = ("bt", "bu", "bv", "bpos", "tmax", "cur")


def _fixed_round(tl: WideTreelets, rays_c, octant, tid, tent, state, ready,
                 sel, *, k, any_hit, robust, stack_depth, traverse):
    """One pair round of `_render_fixed` over the compact rays `sel` [W]:
    the window of k portals from each ready ray's cursor (:1726-1738), at
    the fixed width [k, W]. The pairs sort by treelet * 8 + octant, the
    windows' dead slots (key T * 8) last; B1 takes the whole list and
    stops at the valid pairs' count; the results merge as `merge_round`
    merges them (`merge_first_j`). `state` (bt, bu, bv, bpos, tmax,
    cur: [Rc] each) is updated at `sel` in place. Returns B1's stack
    overflow over the valid pairs (a 0-d bool tensor)."""
    dev = tid.device
    mp, Rc = tid.shape
    W = sel.shape[0]
    L = k * W
    bt, bu, bv, bpos, tmax, cur = (state[n][sel] for n in _STATE)
    rdy = ready[sel]
    idx = cur[None, :] + torch.arange(k, device=dev)[:, None]     # [k, W]
    inb = idx < mp
    flat = idx.clamp(max=mp - 1) * Rc + sel[None, :]
    wtid = torch.where(inb, tid.reshape(-1)[flat], -1)
    wtt = torch.where(inb, tent.reshape(-1)[flat], float("inf"))
    validk = (wtid >= 0) & (wtt <= tmax[None, :]) & rdy[None, :]
    dead = tl.table_cols.shape[0] * WIDTH
    key, perm = torch.sort(torch.where(
        validk, wtid * WIDTH + octant[sel][None, :], dead).reshape(-1))
    nvalid = validk.sum().to(torch.int32).reshape(1)
    col = perm % W
    ptid = torch.where(key < dead, key // WIDTH, -1).to(torch.int32)
    prays = rays_c[:, sel[col]]
    prays[7] = tmax[col]  # pairs carry the ray's current tmax
    out_f, out_i = traverse(tl.table_cols, ptid, prays, any_hit=any_hit,
                            robust=robust, stack_depth=stack_depth,
                            count=nvalid)
    # back to window order; the slots past the valid pairs hold what B1
    # left there, and validk masks them
    res_f = torch.empty_like(out_f).scatter_(1, perm[None].expand(3, L), out_f)
    res_pos = torch.empty_like(out_i[0]).scatter_(0, perm, out_i[0])
    n_bt, n_bu, n_bv, n_pos = merge_first_j(
        (bt, bu, bv, bpos), validk,
        (*res_f.view(3, k, W), res_pos.view(k, W).to(torch.int64)),
        any_hit=any_hit)
    if not any_hit:
        tmax = torch.where(rdy, torch.minimum(tmax, n_bt), tmax)
    for name, v in zip(_STATE, (n_bt, n_bu, n_bv, n_pos, tmax,
                                cur + k * rdy)):
        state[name].index_copy_(0, sel, v)
    valid = torch.arange(L, device=dev) < nvalid
    return ((out_i[3] != 0) & valid).any()


def _render_fixed(tl: WideTreelets, packed, caps: dict, *, any_hit: bool,
                  robust: bool, k: int, sel_cap: int, tail_cap: int,
                  rounds: int, collect=collect_portals,
                  traverse=traverse_pairs):
    """The render of [8, R] packed rays at fixed capacities, the
    counterpart of the reference's one-program render `_render_jit`
    (wide_treelet.py:1444): every shape follows from R, `caps` (as
    `render_at_caps` takes them), `sel_cap`, `tail_cap`, `k` and
    `rounds`, and no device value is read on the host, so the whole
    render can be captured as one CUDA graph.

    - Phase A (B2) over all R rays; then one compaction: the rays sorted
      by (no portal, ray), the first `sel_cap` kept (:1536-1539).
    - Round 1 over that compact set; then `rounds - 1` tail rounds, each
      over the first `tail_cap` of the compact rays sorted by (not
      ready, ray) (:1923-1927). A ready ray past the cap waits a round.
    - A round's pairs are a fixed [k, width] window (`_fixed_round`),
      B1 told their count on the device.

    Every ray goes through the windows of the eager rounds
    (`render_at_caps`) at the same k, in the same order and with the
    same tmax; only the round in which a window runs may differ. So t, u, v and pos equal the eager
    render's bit for bit whenever no overflow is flagged. A round with
    no ready ray does no useful work.

    Returns (t, u, v, pos [R], cnt [R], stats): stats is the [6] int64
    row `FIXED_STATS`, each overflow a flag for the caller to read once
    after the program; a flagged run's hits are not to be used
    (`fixed_overflow`). Two-level scenes raise NotImplementedError."""
    if tl.sup_cols.shape[0] > 0:
        raise NotImplementedError(
            "the one-program render takes single-level scenes; phase A2 "
            "(kernel B4) inside it is the next slice, ROADMAP A18 (R2)")
    R = packed.shape[1]
    dev = packed.device
    i64 = torch.int64
    ptid, ptent, stats = collect(
        tl.top_node_t, packed, tl.top_root, robust=robust,
        stack_depth=caps["top_stack"], max_portals=caps["max_portals"])
    cnt = stats[0]
    lanes = torch.arange(R, device=dev)
    has = cnt > 0
    Rc = min(sel_cap, R)
    sel = torch.sort(torch.where(has, lanes, lanes + R)).indices[:Rc]
    tid, tent = sort_columns(ptid, ptent, cnt, sel)
    rays_c = packed[:, sel]
    octant = octants(rays_c)
    state = dict(zip(_STATE, _no_hits((Rc,), dev) + [
        rays_c[7].clone(), torch.zeros(Rc, dtype=i64, device=dev)]))
    every = torch.arange(Rc, device=dev)
    AC = min(tail_cap, Rc)
    stack_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    used = torch.zeros((), dtype=i64, device=dev)
    for r in range(rounds):
        _, ready = ready_mask(tid, tent, state["cur"], state["tmax"],
                              state["bpos"], any_hit=any_hit)
        used += ready.any()
        rsel = every if r == 0 else torch.sort(
            torch.where(ready, every, every + Rc)).indices[:AC]
        stack_ovf |= _fixed_round(
            tl, rays_c, octant, tid, tent, state, ready, rsel, k=k,
            any_hit=any_hit, robust=robust,
            stack_depth=caps["stack_depth"], traverse=traverse)
    _, ready = ready_mask(tid, tent, state["cur"], state["tmax"],
                          state["bpos"], any_hit=any_hit)
    out = _no_hits((R,), dev)
    for o, name in zip(out, _STATE):
        o.index_copy_(0, sel, state[name])
    flags = torch.stack([x.to(i64) for x in (
        cnt.max(), stats[2].any(), stack_ovf, has.sum(), ready.any(),
        used)])
    return (*out, cnt, flags)


def fixed_overflow(stats, caps: dict, sel_cap: int, rounds: int) -> dict:
    """The capacities a `_render_fixed` run overflowed, from its stats
    row read on the host (`FIXED_STATS`), each with the value to re-run
    at, as `_intersect` raises them: max_portals to the reported need,
    the stacks doubled, sel_cap to the rays that recorded a portal,
    rounds doubled. A phase-A overflow alone is reported when there is
    one: the rounds after it ran on cut portal lists."""
    s = dict(zip(FIXED_STATS, (int(x) for x in stats)))
    bumps = {}
    if s["max_cnt"] > caps["max_portals"]:
        bumps["max_portals"] = _up_pow2(s["max_cnt"])
    if s["top_ovf"]:
        bumps["top_stack"] = 2 * caps["top_stack"]
    if bumps:
        return bumps
    if s["stack_ovf"]:
        bumps["stack_depth"] = 2 * caps["stack_depth"]
    if s["nready"] > sel_cap:
        bumps["sel_cap"] = s["nready"]
    if s["pending"]:
        bumps["rounds"] = 2 * rounds
    return bumps


def padded_rays(rays: Ray, Rp: int) -> torch.Tensor:
    """`pack_rays`, padded to Rp rays with inactive ones (tmin 1 > tmax
    0, direction +x), as the reference pads its ray buffer."""
    packed = pack_rays(rays)
    R = packed.shape[1]
    if Rp == R:
        return packed
    out = torch.zeros((8, Rp), dtype=torch.float32, device=packed.device)
    out[:, :R] = packed
    out[6, R:] = 1.0
    out[3, R:] = 1.0
    return out


# the reference chain's keywords that tile the TPU: they raise here
_TPU_KEYS = ("top_block", "interpret", "packed_table", "max_runs", "tail_k",
             "k2", "a2_cap")
_CHAIN_KEYS = ("portals_per_round", "block", "tail_block", "top_stack",
               "stack_depth", "max_portals", "max_rounds", "mps", "max_new",
               "sup_stack", "sel_cap", "tail_cap", "rounds", "any_hit",
               "robust", "auto_caps")


class RenderChain:
    """k renders of one ray buffer in a row, run by calling the chain
    (see `wide_treelet_render_chain`). Its fields: `k`; the verified
    `caps`, `sel_cap`, `tail_cap` and `rounds` of its `_render_fixed`;
    `eager` (the verified eager render's rounds and pairs); `packed`,
    the [8, Rp] ray buffer the renders feed forward; `stats`, the last
    call's `FIXED_STATS` (their maximum over its renders); on a CUDA device
    `graph`, the captured render, `capture_launches`, the kernels'
    launches during its capture, and `graph_nodes`, its nodes by type
    (None on the CPU)."""

    def __init__(self, tl, packed, k, caps, fixed_kw, eager):
        self.k, self.caps, self.eager, self.packed = k, caps, eager, packed
        self.sel_cap = fixed_kw["sel_cap"]
        self.tail_cap = fixed_kw["tail_cap"]
        self.rounds = fixed_kw["rounds"]
        self._fixed = lambda: _render_fixed(tl, packed, caps, **fixed_kw)
        self._acc = torch.zeros(len(FIXED_STATS), dtype=torch.int64,
                                device=packed.device)
        self.graph = self.capture_launches = self.graph_nodes = None
        self.stats = None
        if packed.device.type == "cuda":
            self._capture()

    def _step(self):
        """One render, the feed-forward and the stats' running maximum.
        The feed subtracts +0.0, which leaves every ray bit for bit as
        it was (-0.0 directions too, where adding would flip them), but
        depends on the render's output (:2379-2396)."""
        out = self._fixed()
        self.packed.sub_(torch.nan_to_num(out[0].min() * 0.0))
        torch.maximum(self._acc, out[-1], out=self._acc)
        return out[0]

    def _capture(self):
        before = {kn.name: kn.launches for kn in kernels.KERNELS}
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph):
            self._t = self._step()
        self.graph.instantiate()
        self.capture_launches = {kn.name: kn.launches - before[kn.name]
                                 for kn in kernels.KERNELS
                                 if kn.launches > before[kn.name]}
        self.graph_nodes = kernels.graph_node_counts(
            self.graph.raw_cuda_graph())

    def __call__(self) -> torch.Tensor:
        """Run the k renders (on a CUDA device k replays of the captured
        render), read the stats once, raise ValueError if any render
        overflowed, and return the last render's t row [Rp]."""
        self._acc.zero_()
        for _ in range(self.k):
            if self.graph is not None:
                self.graph.replay()
            else:
                self._t = self._step()
        acc = self._acc.tolist()
        self.stats = dict(zip(FIXED_STATS, acc))
        bumps = fixed_overflow(acc, self.caps, self.sel_cap, self.rounds)
        if bumps:
            raise ValueError(f"wide-treelet render chain overflowed: {bumps} "
                             f"needed with caps {self.caps}, sel_cap "
                             f"{self.sel_cap}, rounds {self.rounds}")
        return self._t.clone()


def wide_treelet_render_chain(tl: WideTreelets, rays: Ray, k: int,
                              **kw) -> RenderChain:
    """A steady-state probe: a zero-argument callable that runs the whole
    render k times in a row on one ray buffer and returns the last
    render's t row [Rp] (the reference's chain, wide_treelet.py:2291).

    On a CUDA device one `_render_fixed` and the feed-forward are
    captured as one CUDA graph with static buffers, which each call
    replays k times: no host sync until the stats are read once at the
    end. On the CPU the same `_render_fixed` runs eagerly k times, with
    the kernels' plain versions. Each render feeds the buffer forward
    (`RenderChain._step`), so every render is the same real render.

    Keywords, as the reference's (None takes the default): the caps of
    `wide_treelet_intersect_tris` (top_stack, stack_depth, max_portals,
    max_rounds, mps, max_new, sup_stack; pass a verified call's
    diag["caps"]),
    `portals_per_round`, `block`, `tail_block`, `sel_cap` (default Rp/4
    in blocks; Rp is R in blocks), `tail_cap` (default sel_cap //
    tail_div in tail blocks), `any_hit`, `robust`, `auto_caps`, and
    `rounds`, the fixed round count. The chain first runs the verified
    eager render at those caps. Without `rounds` it bounds the fixed
    schedule's rounds by the eager render's rounds plus its pairs over
    tail_cap (a tail round either takes tail_cap ready rays or every
    ready ray), runs `_render_fixed` once so, and keeps the rounds in
    which a ray was ready. That run's stats are read: an overflowed cap
    is raised and the run repeated, at most 8 times, as
    `wide_treelet_intersect_tris` does (with `auto_caps` off it
    raises). The TPU's tiling keys (top_block, interpret, ...) raise
    ValueError; scenes with supers raise NotImplementedError."""
    tpu = sorted(set(kw) & set(_TPU_KEYS))
    if tpu:
        raise ValueError(f"wide_treelet_render_chain: {', '.join(tpu)} tile "
                         "the TPU's kernels and have no meaning here")
    unknown = sorted(set(kw) - set(_CHAIN_KEYS))
    if unknown:
        raise ValueError(f"wide_treelet_render_chain: unknown keys {unknown}")
    if tl.sup_cols.shape[0] > 0:
        raise NotImplementedError(
            "wide_treelet_render_chain takes single-level scenes; phase A2 "
            "(kernel B4) inside the one-program render is the next slice, "
            "ROADMAP A18 (R2)")
    R = rays.tmin.shape[0]
    if k < 1 or R == 0:
        raise ValueError("wide_treelet_render_chain: needs k >= 1 and rays")

    def _kw(name, default):
        v = kw.get(name)
        return default if v is None else v

    perf = wide_treelet_perf(tl)
    ppr = _kw("portals_per_round", perf["portals_per_round"])
    block = _kw("block", perf["block"])
    tail_block = _kw("tail_block", perf["tail_block"])
    any_hit, robust = bool(kw.get("any_hit")), bool(kw.get("robust"))
    auto_caps = _kw("auto_caps", True)
    Rp = _round_up(R, block)
    _, diag = _intersect(
        tl, rays, None, collect_portals, traverse_pairs, any_hit=any_hit,
        robust=robust, **{c: kw.get(c) for c in (
            "top_stack", "stack_depth", "max_portals", "max_rounds", "mps",
            "max_new")}, auto_caps=auto_caps, return_diag=True, k=ppr)
    caps = dict(diag["caps"])
    if kw.get("sup_stack") is not None:
        caps["sup_stack"] = kw["sup_stack"]
    eager = dict(rounds=diag["rounds"], pairs=diag["pairs"])
    packed = padded_rays(rays, Rp)
    sel_cap = _kw("sel_cap", max(block, _round_up(Rp // 4, block)))
    rounds = kw.get("rounds")
    for attempt in range(8):
        sel_cap = min(_round_up(sel_cap, block), Rp)
        tail_cap = min(_round_up(_kw("tail_cap", max(
            tail_block, sel_cap // perf["tail_div"])), tail_block), sel_cap)
        n_rounds = (rounds if rounds is not None
                    else eager["rounds"] + eager["pairs"] // tail_cap)
        fixed_kw = dict(any_hit=any_hit, robust=robust, k=ppr,
                        sel_cap=sel_cap, tail_cap=tail_cap, rounds=n_rounds)
        stats = _render_fixed(tl, packed, caps, **fixed_kw)[-1].tolist()
        bumps = fixed_overflow(stats, caps, sel_cap, n_rounds)
        if not bumps:
            break
        if not auto_caps or attempt == 7:
            raise ValueError(f"wide-treelet render chain overflowed: {bumps} "
                             f"needed with caps {caps}, sel_cap {sel_cap}, "
                             f"rounds {n_rounds}")
        sel_cap = bumps.pop("sel_cap", sel_cap)
        rounds = bumps.pop("rounds", rounds)
        caps.update(bumps)
    if rounds is None:
        fixed_kw["rounds"] = max(1, stats[FIXED_STATS.index("rounds_used")])
    return RenderChain(tl, packed, k, caps, fixed_kw, eager)
