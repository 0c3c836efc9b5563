"""Binned SAH builder, level-synchronous.

Counterpart of `bvh_tpu.build.binned` (reference:
src/bvh/v2/binned_sah_builder.h). One round bins every primitive of
every open node into `BIN_COUNT` bins per axis (fill_bins, 82-99),
evaluates the SAH sweep over the bins (find_best_split, 101-116),
partitions with a stable segmented rank, and falls back to a median
split exactly where the reference does (try_split, 128-156).

Decision parity with `bvh_tpu`: cost ties select the first (axis-major,
bin-ascending) minimum; a split with an empty side costs +inf; the
partition is stable. Every multiply-add that XLA's CPU backend contracts
into an FMA goes through `core.utils.fast_mul_add` (ROADMAP C5).
"""

from __future__ import annotations

import torch

from bvh_tpu_torch.build import frontier
from bvh_tpu_torch.build.sah import TopDownConfig
from bvh_tpu_torch.core import bbox as bbox_ops
from bvh_tpu_torch.core import utils
from bvh_tpu_torch.core.types import Bvh

BIN_COUNT = 8  # reference: binned_sah_builder.h:18
_I64 = torch.int64


def _round(state: frontier.FrontierState, bb_min, bb_max, centers,
           config: TopDownConfig):
    n, dim = centers.shape
    cap = state.open_.shape[0]
    dtype = centers.dtype
    dev = centers.device
    B = BIN_COUNT
    inf = float("inf")
    big = torch.finfo(dtype).max
    sah = config.sah

    fpos, f2n = frontier.compact_frontier(state.open_)
    f_cap = f2n.shape[0]

    # ---- per-position binning (fill_bins, 82-99) ----------------------
    nid = state.seg
    act = state.open_[nid]
    prim = state.order
    c = centers[prim]
    node_row = state.bounds[nid]
    nmn, nmx = node_row[:, 0::2], node_row[:, 1::2]
    bin_scale = torch.tensor(B, dtype=dtype, device=dev) / (nmx - nmn)
    bin_offset = -nmn * bin_scale
    posf = utils.fast_mul_add(c, bin_scale, bin_offset)
    # robust_max(pos, 0), then min(B - 1, trunc) (94-95): NaN -> 0
    posf = torch.where(posf > 0, posf, 0.0)
    posf = torch.where(posf < B - 1, posf, float(B - 1))
    bins_of = posf.to(_I64)

    # bin counts and bin boxes per (frontier node, axis, bin), read at
    # each open node's segment
    onehot = bins_of[:, :, None] == torch.arange(B, device=dev)
    node_f_c = f2n.clamp(max=cap - 1)
    begin_f = state.begin[node_f_c]
    end_f = state.end[node_f_c]
    cnt_cols = (onehot & act[:, None, None]).reshape(n, dim * B)
    cnt = frontier.segment_sums_at(cnt_cols, begin_f, end_f).reshape(
        f_cap, dim, B)
    mask4 = onehot[:, :, :, None]
    pbmn, pbmx = bb_min[prim], bb_max[prim]
    vals_mn = torch.where(mask4, pbmn[:, None, None, :], big).reshape(
        n, dim * B * dim)
    vals_mx = torch.where(mask4, pbmx[:, None, None, :], -big).reshape(
        n, dim * B * dim)
    smn, smx = frontier.segmented_minmax(frontier.segment_heads(state),
                                         vals_mn, vals_mx)
    last_f = (end_f - 1).clamp(0, n - 1)
    bmn = smn[last_f].reshape(f_cap, dim, B, dim)
    bmx = smx[last_f].reshape(f_cap, dim, B, dim)
    live_f = (f2n < cap)[:, None, None]
    cnt = torch.where(live_f, cnt, 0)
    bmn = torch.where(live_f[..., None], bmn, big)
    bmx = torch.where(live_f[..., None], bmx, -big)

    # ---- SAH sweep over the bins (find_best_split, 101-116) -----------
    right_cost = torch.full((f_cap, dim, B), inf, dtype=dtype, device=dev)
    racc_mn = torch.full((f_cap, dim, dim), big, dtype=dtype, device=dev)
    racc_mx = torch.full((f_cap, dim, dim), -big, dtype=dtype, device=dev)
    rcnt = torch.zeros((f_cap, dim), dtype=_I64, device=dev)
    for i in range(B - 1, 0, -1):
        racc_mn = torch.minimum(racc_mn, bmn[:, :, i])
        racc_mx = torch.maximum(racc_mx, bmx[:, :, i])
        rcnt = rcnt + cnt[:, :, i]
        cost = sah.get_leaf_cost(rcnt, bbox_ops.get_half_area(racc_mn, racc_mx))
        right_cost[:, :, i] = torch.where(rcnt > 0, cost, inf)

    costs = torch.full((f_cap, dim, B - 1), inf, dtype=dtype, device=dev)
    lacc_mn = torch.full((f_cap, dim, dim), big, dtype=dtype, device=dev)
    lacc_mx = torch.full((f_cap, dim, dim), -big, dtype=dtype, device=dev)
    lcnt = torch.zeros((f_cap, dim), dtype=_I64, device=dev)
    for i in range(B - 1):
        lacc_mn = torch.minimum(lacc_mn, bmn[:, :, i])
        lacc_mx = torch.maximum(lacc_mx, bmx[:, :, i])
        lcnt = lcnt + cnt[:, :, i]
        # left leaf cost + right cost; XLA contracts the product into it
        total = utils.fast_mul_add(bbox_ops.get_half_area(lacc_mn, lacc_mx),
                                   sah.get_prim_count(lcnt).to(dtype),
                                   right_cost[:, :, i + 1])
        costs[:, :, i] = torch.where(lcnt > 0, total, inf)

    flat = costs.reshape(f_cap, dim * (B - 1))
    flat = torch.where(torch.isnan(flat), inf, flat)
    # first minimum = the reference's scan order
    best_cost = flat.amin(1)
    best_flat = torch.argmax((flat == best_cost[:, None]).to(torch.int8), 1)
    best_axis_f = best_flat // (B - 1)
    best_bin_f = best_flat % (B - 1) + 1

    # ---- per-node decisions (try_split, 128-156) ----------------------
    size_f = end_f - begin_f
    row_f = state.bounds[node_f_c]
    fmn, fmx = row_f[:, 0::2], row_f[:, 1::2]
    diag_f = fmx - fmn
    non_split = sah.get_non_split_cost(size_f, bbox_ops.get_half_area(fmn, fmx))
    sah_ok_f = best_cost < non_split
    # first maximum (vec.h:33)
    largest_f = torch.argmax(
        (diag_f == diag_f.amax(1, keepdim=True)).to(torch.int8), 1)
    diag_best = diag_f.gather(1, best_axis_f[:, None])[:, 0]
    min_best = fmn.gather(1, best_axis_f[:, None])[:, 0]
    split_val_f = utils.fast_mul_add(
        diag_best / torch.tensor(B, dtype=dtype, device=dev),
        best_bin_f.to(dtype), min_best)

    fpos_c = fpos.clamp(0, f_cap - 1)
    node_axis = torch.where(state.open_, best_axis_f[fpos_c], 0)
    node_split_val = torch.where(state.open_, split_val_f[fpos_c], 0.0)
    node_sah_ok = state.open_ & sah_ok_f[fpos_c]
    node_largest = torch.where(state.open_, largest_f[fpos_c], 0)

    # ---- SAH partition test per position ------------------------------
    center_on_axis = c.gather(1, node_axis[nid][:, None])[:, 0]
    gl_sah = center_on_axis < node_split_val[nid]
    count_left = frontier.segment_sums_at(gl_sah & act, state.begin,
                                          state.end)
    count_left = torch.where(state.open_, count_left, 0)
    size_all = state.end - state.begin
    degenerate = node_sah_ok & ((count_left == 0) | (count_left == size_all))
    do_split = state.open_ & (node_sah_ok | (size_all > config.max_leaf_size))
    use_fb = do_split & (~node_sah_ok | degenerate)

    # ---- median fallback (fallback_split, 118-126) --------------------
    if bool(use_fb.any()):
        key = torch.where(act & use_fb[nid], fpos[nid], f_cap)
        vals = c.gather(1, node_largest[nid][:, None])[:, 0]
        sizes_by_key = torch.where(use_fb[node_f_c] & (f2n < cap), size_f, 0)
        ranks = frontier.segment_ranks_by_value(key, vals, sizes_by_key,
                                                f_cap)
    else:
        ranks = torch.zeros(n, dtype=_I64, device=dev)
    # left count of a median split: (size + 1) // 2 (mid = (b + e + 1) / 2)
    gl_fb = ranks < (size_all[nid] + 1) // 2

    goes_left = torch.where(use_fb[nid], gl_fb, gl_sah)
    new_state, _ = frontier.apply_splits(state, bb_min, bb_max, do_split,
                                         goes_left, config.min_leaf_size)
    return new_state


def build_binned(bb_min, bb_max, centers,
                 config: TopDownConfig | None = None) -> Bvh:
    """Build a BVH with the binned SAH builder over [n, dim] primitive
    boxes and centres (reference: binned_sah_builder.h)."""
    if config is None:
        config = TopDownConfig()
    state = frontier.init_state(bb_min, bb_max, config.min_leaf_size)
    while bool(state.open_.any()):
        state = _round(state, bb_min, bb_max, centers, config)
    return frontier.finalize(state)
