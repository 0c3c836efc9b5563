"""LBVH builder: the Karras linear BVH, with no sequential rounds.

Counterpart of `bvh_tpu.build.lbvh` (the reference's v2 library has no
LBVH; its lineage does, README.md:15-22). Every step is a fixed number
of whole-array operations, whatever the data:

1. Morton codes of the primitive centres on a 2^bits grid per axis, one
   stable sort, ties broken by primitive index (Karras 2012, sec. 3);
2. each internal node's range and split by binary searches over
   common-prefix lengths, a fixed ceil(log2 n) + 1 steps each;
3. node bounds as range unions over the sorted positions, answered
   from a doubling sparse table (two gathers a node);
4. SATO order, the larger-area child left (top_down_sah_builder.h:
   100-108), by swapping pair contents.

The tree has the reference's layout: sibling pairs with the left child
at an odd index (bvh.h:33-51), one primitive per leaf.
"""

from __future__ import annotations

import dataclasses

import torch

from bvh_tpu_torch.core import bbox as bbox_ops
from bvh_tpu_torch.core import utils
from bvh_tpu_torch.core.types import (
    Bvh,
    Index,
    make_node_bounds_row,
    node_capacity_for,
)

_I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class LbvhConfig:
    """Grid resolution per axis; by default the most that fits `dim`
    axes in a 32-bit Morton code (10 bits in 3D)."""

    log2_grid_dim: int | None = None


def _grid_bits(dim: int, config: LbvhConfig) -> int:
    if config.log2_grid_dim is not None:
        return config.log2_grid_dim
    return max(1, 30 // dim if dim != 2 else 15)


def _morton_codes(centers, bits: int):
    """32-bit Morton codes (in int64) of the centres on the grid over
    their bounds; the grid transform through `fast_mul_add`, which
    XLA contracts (ROADMAP C5)."""
    grid_dim = 1 << bits
    cmin = centers.amin(0)
    cmax = centers.amax(0)
    scale = torch.tensor(grid_dim, dtype=centers.dtype,
                         device=centers.device) * utils.safe_inverse(cmax - cmin)
    p = utils.fast_mul_add(centers, scale, -cmin * scale)
    p = torch.where(p > 0, p, 0)
    coord = torch.clamp(p, max=grid_dim - 1).to(_I64)
    return utils.morton_encode(coord, centers.shape[1])


def clz32(x):
    """Leading zeros of each value as a 32-bit word (x in [0, 2^32),
    int64); 32 for 0. Exact, by halving steps."""
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        low = x < (1 << (32 - shift))
        n = torch.where(low, n + shift, n)
        x = torch.where(low, x << shift, x)
    return torch.where(x == 0, n + 1, n)


def _sparse_table_union(pmn, pmx, lo, hi):
    """Union of the boxes at positions [lo, hi] (inclusive) for each
    query, from a doubling sparse table: log2(n) build steps, two
    gathers a query."""
    n, d = pmn.shape
    levels = max(1, n.bit_length())
    big = torch.finfo(pmn.dtype).max
    tmn, tmx = [pmn], [pmx]
    for k in range(levels - 1):
        off = 1 << k
        prev_mn, prev_mx = tmn[-1], tmx[-1]
        sh_mn = torch.cat([prev_mn[off:], prev_mn.new_full((off, d), big)])
        sh_mx = torch.cat([prev_mx[off:], prev_mx.new_full((off, d), -big)])
        tmn.append(torch.minimum(prev_mn, sh_mn))
        tmx.append(torch.maximum(prev_mx, sh_mx))
    big_mn, big_mx = torch.stack(tmn), torch.stack(tmx)  # [levels, n, d]
    length = hi - lo + 1
    k = torch.clamp(31 - clz32(torch.clamp(length, min=1)), min=0)
    right = torch.clamp(hi - (1 << k) + 1, 0, n - 1)
    lo_c = torch.clamp(lo, 0, n - 1)
    return (torch.minimum(big_mn[k, lo_c], big_mn[k, right]),
            torch.maximum(big_mx[k, lo_c], big_mx[k, right]))


def build_lbvh(bb_min, bb_max, centers,
               config: LbvhConfig | None = None) -> Bvh:
    """Build a BVH with the Karras LBVH algorithm over [n, dim]
    primitive boxes and centres on their device; leaves hold one
    primitive."""
    if config is None:
        config = LbvhConfig()
    n, dim = centers.shape
    dtype, dev = centers.dtype, centers.device
    cap = node_capacity_for(n)

    if n == 1:
        bounds = torch.zeros((cap, 2 * dim), dtype=dtype, device=dev)
        bounds[0] = make_node_bounds_row(bb_min[0], bb_max[0])
        index = Index.make_leaf(torch.zeros(cap, dtype=_I64, device=dev), 1)
        return Bvh(bounds=bounds, index=index,
                   prim_ids=torch.zeros(1, dtype=_I64, device=dev),
                   node_count=1, prim_count=1)

    codes = _morton_codes(centers, _grid_bits(dim, config))
    mc, order = torch.sort(codes, stable=True)

    def delta(i, j):
        """Common-prefix length of sorted codes i and j; equal codes
        fall back to the index bits (Karras sec. 4); -1 outside [0, n)."""
        ok = (j >= 0) & (j < n)
        jc = torch.clamp(j, 0, n - 1)
        x = (mc[i] ^ mc[jc]) & 0xFFFFFFFF
        d = torch.where(x == 0, 32 + clz32(i ^ jc), clz32(x))
        return torch.where(ok, d, -1)

    ii = torch.arange(n - 1, dtype=_I64, device=dev)  # internal nodes
    d_dir = torch.sign(delta(ii, ii + 1) - delta(ii, ii - 1))
    d_dir = torch.where(d_dir == 0, 1, d_dir)
    delta_min = delta(ii, ii - d_dir)
    kmax = max(1, (n - 1).bit_length()) + 1

    # the range length: one monotone binary search (bvh_tpu lbvh.py:155-168)
    length = torch.zeros(n - 1, dtype=_I64, device=dev)
    for k in range(kmax):
        t = 1 << (kmax - 1 - k)
        take = delta(ii, ii + (length + t) * d_dir) > delta_min
        length = torch.where(take, length + t, length)
    jj = ii + length * d_dir

    # the split: the largest s with delta(i, i + s*d) > delta(i, j)
    delta_node = delta(ii, jj)
    s = torch.zeros(n - 1, dtype=_I64, device=dev)
    for k in range(kmax):
        t_k = torch.clamp(-((-length) >> (k + 1)), min=1)  # ceil(l / 2^(k+1))
        take = ((delta(ii, ii + (s + t_k) * d_dir) > delta_node)
                & (s + t_k < length))
        s = torch.where(take, s + t_k, s)
    gamma = ii + s * d_dir + torch.clamp(d_dir, max=0)

    lo = torch.minimum(ii, jj)
    hi = torch.maximum(ii, jj)
    left_is_leaf = lo == gamma
    right_is_leaf = hi == gamma + 1

    # internal k's children sit at slots (2k+1, 2k+2); the root at 0
    slot_of_internal = torch.zeros(n - 1, dtype=_I64, device=dev)
    slot_of_leaf = torch.zeros(n, dtype=_I64, device=dev)
    for child, is_leaf, slot in ((gamma, left_is_leaf, 2 * ii + 1),
                                 (gamma + 1, right_is_leaf, 2 * ii + 2)):
        slot_of_internal[child[~is_leaf]] = slot[~is_leaf]
        slot_of_leaf[child[is_leaf]] = slot[is_leaf]

    pmn, pmx = bb_min[order], bb_max[order]
    int_mn, int_mx = _sparse_table_union(pmn, pmx, lo, hi)

    int_src = torch.zeros(cap, dtype=_I64, device=dev)
    int_src[slot_of_internal] = ii
    leaf_src = torch.full((cap,), n, dtype=_I64, device=dev)
    leaf_src[slot_of_leaf] = torch.arange(n, device=dev)
    is_leaf_slot = leaf_src < n
    leaf_c = torch.clamp(leaf_src, max=n - 1)
    bounds = torch.where(is_leaf_slot[:, None],
                         make_node_bounds_row(pmn, pmx)[leaf_c],
                         make_node_bounds_row(int_mn, int_mx)[int_src])
    index = torch.where(is_leaf_slot, Index.make_leaf(leaf_c, 1),
                        Index.make_inner(2 * int_src + 1))

    # SATO: swap a pair's contents when its right child is the larger
    slots = torch.arange(cap, device=dev)
    pair_l = torch.clamp(2 * torch.arange((cap - 1) // 2, device=dev) + 1,
                         max=cap - 2)
    row_l, row_r = bounds[pair_l], bounds[pair_l + 1]
    swap = (bbox_ops.get_half_area(row_l[:, 0::2], row_l[:, 1::2])
            < bbox_ops.get_half_area(row_r[:, 0::2], row_r[:, 1::2]))
    swap_of_slot = swap[torch.clamp((slots - 1) >> 1, 0, swap.shape[0] - 1)] \
        & (slots >= 1)
    partner = torch.where((slots & 1) == 1, torch.clamp(slots + 1, max=cap - 1),
                          torch.clamp(slots - 1, min=0))
    bounds = torch.where(swap_of_slot[:, None], bounds[partner], bounds)
    index = torch.where(swap_of_slot, index[partner], index)
    return Bvh(bounds=bounds, index=index, prim_ids=order, node_count=2 * n - 1,
               prim_count=n)
