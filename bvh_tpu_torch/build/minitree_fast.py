"""Fast mini-tree build: the per-group kernel B3 plus an array splice.

Counterpart of `bvh_tpu.build.minitree_fast` (reference:
mini_tree_builder.h:47-310): Morton-grid grouping, one binned-SAH
subtree per group (kernel B3, `build/group_kernel.py`), area pruning,
a sweep top tree over the splice roots, and the splice, which works on
the kernel's [G, NCAP] block layout with gathers.

Staging: the group capacity P (the largest group, rounded up to 128
lanes) depends on the data, so the group counts come to the host once
to size the kernel's launch; the primitive data stays on the device.
"""

from __future__ import annotations

import dataclasses

import torch

from bvh_tpu_torch.build.canonicalize import canonicalize
from bvh_tpu_torch.build.group_kernel import group_forest_build
from bvh_tpu_torch.build.minitree import MiniTreeConfig, _grid_groups
from bvh_tpu_torch.build.sah import TopDownConfig
from bvh_tpu_torch.build.sweep import build_sweep
from bvh_tpu_torch.core import bbox as bbox_ops
from bvh_tpu_torch.core import trace
from bvh_tpu_torch.core.types import Bvh, Index
from bvh_tpu_torch.core.utils import run_stage
from bvh_tpu_torch.traverse.refit import refit

_I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class StagingPlan:
    """What the device program needs from the host staging."""

    order: torch.Tensor   # [n] prim ids sorted by group (stable)
    counts: torch.Tensor  # [G] int32 group sizes, on the device
    n: int
    dim: int
    G: int
    P: int
    NCAP: int
    g_cap: int
    config: MiniTreeConfig


def auto_grid_config(config: MiniTreeConfig, n: int,
                     dim: int) -> MiniTreeConfig:
    """Raise log2_grid_dim until the mean bin holds at most 512 prims
    (`bvh_tpu` minitree_fast.py:159-178); below ~2M prims the default
    is returned unchanged."""
    ld = config.log2_grid_dim
    while n > (1 << (ld * dim)) * 512 and ld * dim < 30:
        ld += 1
    if ld != config.log2_grid_dim:
        config = dataclasses.replace(config, log2_grid_dim=ld)
    return config


def group_sort(centers: torch.Tensor, config: MiniTreeConfig | None = None):
    """The staging's device work: group every primitive, sort the
    primitives by group (one stable sort: prim ids are already
    ascending, so this is the reference's (group, id) order,
    mini_tree_builder.h:122) and count each group. Returns (order [n],
    counts [g_cap] on the device, dim, the config with its grid,
    g_cap)."""
    if config is None:
        config = MiniTreeConfig()
    n, dim = centers.shape
    config = auto_grid_config(config, n, dim)
    g_cap = min(1 << (config.log2_grid_dim * dim), n)
    group = torch.clamp(_grid_groups(centers, config)[0], max=g_cap - 1)
    order = torch.sort(group, stable=True).indices
    return order, torch.bincount(group, minlength=g_cap), dim, config, g_cap


def read_plan(order, counts_all, dim: int, config: MiniTreeConfig,
              g_cap: int) -> StagingPlan:
    """The counts' one readback, which sizes the launch."""
    counts_all = counts_all.cpu()
    counts = counts_all[counts_all > 0]
    G = len(counts)
    P = max(128, -(-int(counts.max()) // 128) * 128)
    return StagingPlan(order=order,
                       counts=counts.to(torch.int32).to(order.device),
                       n=order.shape[0], dim=dim, G=G, P=P, NCAP=2 * P,
                       g_cap=g_cap, config=config)


def staging_plan(centers: torch.Tensor,
                 config: MiniTreeConfig | None = None) -> StagingPlan:
    """Group and sort the primitives (`group_sort`), then size the
    launch (`read_plan`)."""
    return read_plan(*group_sort(centers, config))


def pack_groups(bb_min, bb_max, centers, plan: StagingPlan):
    """The kernel's input block [16, G*P] on the device: slot (g, l)
    holds prim order[base[g] + l] (zeros past the group's size).
    Returns (pf, base [G])."""
    G, P, n, dim = plan.G, plan.P, plan.n, plan.dim
    dev = centers.device
    counts = plan.counts.to(_I64)
    base = torch.cumsum(counts, 0) - counts
    s = torch.arange(G * P, device=dev)
    g_s = s // P
    l_s = s % P
    ok = (l_s < counts[g_s])[None, :]
    src_prim = plan.order[torch.clamp(base[g_s] + l_s, 0, n - 1)]
    pf = torch.zeros((16, G * P), dtype=torch.float32, device=dev)
    for r, x in ((0, centers), (dim, bb_min), (2 * dim, bb_max)):
        pf[r:r + dim] = torch.where(ok, x[src_prim].T, 0.0)
    return pf, base


def build_minitree_fast(bb_min, bb_max, centers,
                        config: MiniTreeConfig | None = None,
                        stage=run_stage) -> Bvh:
    """Mini-tree build through kernel B3 on the inputs' device (the
    plain version on the CPU). Inputs are [n, dim] float32 tensors.
    Each stage runs through `stage` (`core.utils.run_stage`): staging
    (`group_sort`), counts_readback (`read_plan`), pack_groups, b3,
    assemble, and top_tree within assemble."""
    return _build(bb_min, bb_max, centers, config, group_forest_build, stage)


@trace.spanned("bvh.minitree")
def _build(bb_min, bb_max, centers, config, group_build,
           stage=run_stage) -> Bvh:
    """`build_minitree_fast` with the per-group build passed in, so that
    a check can run the same path through the plain version."""
    plan = stage("counts_readback", read_plan,
                 *stage("staging", group_sort, centers, config))
    pf, base = stage("pack_groups", pack_groups, bb_min, bb_max, centers,
                     plan)
    cfg = plan.config
    nbf, nbi, src, cnt = stage(
        "b3", group_build, pf, plan.counts, dim=plan.dim, P=plan.P,
        NCAP=plan.NCAP, min_leaf=cfg.min_leaf_size,
        max_leaf=cfg.max_leaf_size, log_cluster=cfg.sah.log_cluster_size,
        cost_ratio=cfg.sah.cost_ratio)
    return stage("assemble", assemble, nbf, nbi, src, cnt, base, plan,
                 stage=stage)


def assemble(nbf, nbi, src, cnt, base, plan: StagingPlan,
             stage=run_stage) -> Bvh:
    """Pruning, the sweep top tree (run through `stage` as top_tree) and
    the gather splice over the kernel's layout
    (mini_tree_builder.h:207-310; `bvh_tpu` minitree_fast.py:204-367)."""
    n, dim, G, P, NCAP, g_cap = (plan.n, plan.dim, plan.G, plan.P, plan.NCAP,
                                 plan.g_cap)
    config = plan.config
    dev = nbf.device
    f32 = torch.float32
    nbi = nbi.to(_I64)
    cnt = cnt.to(_I64)
    F = G * NCAP
    ids = torch.arange(F, device=dev)
    l_of = ids % NCAP
    valid = l_of < cnt[ids // NCAP]
    is_root = (l_of == 0) & valid
    area = nbf[6]
    anc_min = nbf[7]
    leaf = (nbi[2] < 0) & valid

    # ---- step 5: pruning (207-247) ------------------------------------
    g2_cap = max(g_cap, min(4 * g_cap, n))
    if config.enable_pruning:
        avg_area = area[torch.arange(G, device=dev) * NCAP].sum() / \
            torch.tensor(max(G, 1), dtype=f32, device=dev)
        thr = avg_area * torch.tensor(config.pruning_area_ratio, dtype=f32,
                                      device=dev)
        anc_ok = anc_min >= thr  # +BIG at roots: always true there
        pruned_root = valid & anc_ok & (~(area >= thr) | leaf)
        if int(pruned_root.sum()) > g2_cap:
            pruned_root = is_root
            strict_below = valid & (l_of > 0)
        else:
            strict_below = valid & (anc_min < thr)
    else:
        pruned_root = is_root
        strict_below = valid & (l_of > 0)

    # ---- step 6: sweep top tree over the splice roots, in (group,
    # local slot) order; absent roots are point boxes at the scene's
    # max corner, erased by canonicalize -------------------------------
    proot = torch.nonzero(pruned_root).squeeze(1)
    proot_c = torch.zeros(g2_cap, dtype=_I64, device=dev)
    proot_c[:proot.numel()] = proot
    real2 = torch.arange(g2_cap, device=dev) < proot.numel()
    pr_mn = torch.stack([nbf[2 * d][proot_c] for d in range(dim)], 1)
    pr_mx = torch.stack([nbf[2 * d + 1][proot_c] for d in range(dim)], 1)
    scene_mx = torch.where(real2[:, None], pr_mx, float("-inf")).amax(0)
    top_mn = torch.where(real2[:, None], pr_mn, scene_mx)
    top_mx = torch.where(real2[:, None], pr_mx, scene_mx)
    top_raw = stage("top_tree", build_sweep, top_mn, top_mx,
                    bbox_ops.get_center(top_mn, top_mx),
                    TopDownConfig(sah=config.sah, min_leaf_size=1,
                                  max_leaf_size=1))
    top_cap = top_raw.index.shape[0]
    leaf_slot = top_raw.prim_ids[
        Index.first_id(top_raw.index).clamp(0, g2_cap - 1)]
    top = refit(canonicalize(top_raw, real2[leaf_slot.clamp(0, g2_cap - 1)]))
    tc = top.node_count

    # ---- splice (262-308): forest nodes strictly below a splice root
    # follow the top tree in sibling pairs, in (group, local pair) order
    NP = (NCAP - 1) // 2
    n_pairs = G * NP
    pair_ids = torch.arange(n_pairs, device=dev)
    pflat = (pair_ids // NP) * NCAP + 1 + 2 * (pair_ids % NP)
    pair_live = strict_below[pflat]
    pair_rank = torch.cumsum(pair_live.to(_I64), 0) - 1
    live = torch.nonzero(pair_live).squeeze(1)
    live_pairs = live.numel()

    def remap_index(flat_ids):
        """Kernel node (flat id) -> final packed index word."""
        f = flat_ids.clamp(0, F - 1)
        gg = f // NCAP
        ch = nbi[2][f]
        leaf_word = Index.make_leaf(base[gg] + nbi[0][f], nbi[1][f] - nbi[0][f])
        kp = torch.clamp(gg * NP + (ch - 1) // 2, 0, n_pairs - 1)
        inner_word = Index.make_inner(tc + 2 * pair_rank[kp])
        return torch.where(ch < 0, leaf_word, inner_word)

    def bounds_of(flat_ids):
        f = flat_ids.clamp(0, F - 1)
        return torch.stack([nbf[r][f] for r in range(2 * dim)], 1)

    # top-tree rows: leaves take their splice root's content
    top_is_leaf = Index.is_leaf(top.index[:tc])
    tl_slot = top.prim_ids[Index.first_id(top.index[:tc]).clamp(0, g2_cap - 1)]
    tl_root = proot_c[tl_slot.clamp(0, g2_cap - 1)]
    bounds = torch.zeros((top_cap + 2 * n_pairs, 2 * dim), dtype=f32,
                         device=dev)
    index = torch.zeros(top_cap + 2 * n_pairs, dtype=_I64, device=dev)
    bounds[:tc] = torch.where(top_is_leaf[:, None], bounds_of(tl_root),
                              top.bounds[:tc])
    index[:tc] = torch.where(top_is_leaf, remap_index(tl_root),
                             top.index[:tc])
    # spliced row j after the top tree: member j & 1 of live pair j // 2
    src_pair = live.repeat_interleave(2)
    member = torch.arange(2, device=dev).repeat(live_pairs)
    src_flat = (src_pair // NP) * NCAP + 1 + 2 * (src_pair % NP) + member
    bounds[tc:tc + 2 * live_pairs] = bounds_of(src_flat)
    index[tc:tc + 2 * live_pairs] = remap_index(src_flat)

    # prim permutation: final position q = base[g] + l holds
    # order[base[g] + src[g*P + l]]
    q = torch.arange(n, device=dev)
    base_e = torch.cumsum(plan.counts.to(_I64), 0)
    gq = torch.clamp(torch.searchsorted(base_e, q, right=True), 0, G - 1)
    off_q = base[gq]
    prim_ids = plan.order[torch.clamp(
        off_q + src.to(_I64)[gq * P + q - off_q], 0, n - 1)]
    return Bvh(bounds=bounds, index=index, prim_ids=prim_ids,
               node_count=tc + 2 * live_pairs, prim_count=n)

