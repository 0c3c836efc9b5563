"""Wide (8-ary) BVH traversal layout.

Counterpart of `bvh_tpu.traverse.wide`: a traversal-time re-layout of
the binary BVH in which binary subtrees collapse into nodes of up to
WIDTH children, so that a ray takes about log_8 steps instead of log_2
and each step reads one row of all the child boxes and index words.
`widen` is a pure function of a built `Bvh` (host numpy, once per
tree); `traverse_wide` must find the binary traversal's hits (same
primitive ranges, same order within a leaf).

Child entries reuse the packed index words (index.h): leaf words point
at prim_ids positions, inner words hold the WIDE node id of the child.
Empty child slots carry an empty box (never hit) and word 0.

`traverse_wide` is plain PyTorch, like `wavefront.walk`: each step works
on the rays still active. A push past `stack_depth` raises, where
`bvh_tpu` writes it nowhere and still moves the stack pointer, so that a
later pop reads the root word (ROADMAP C13).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, NamedTuple

import numpy as np
import torch

from bvh_tpu_torch.core import utils
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.core.types import Index
from bvh_tpu_torch.core.utils import robust_max, robust_min
from bvh_tpu_torch.traverse.wavefront import (
    DEFAULT_BLOCK,
    Hit,
    hit_from,
    make_tri_leaf_fn,
)

WIDTH = 8


class WideBvh(NamedTuple):
    """child_bounds: [m, WIDTH, 2*dim]; child_index: [m, WIDTH] int64
    packed words (inner words name wide node ids); prim_ids as the
    binary tree's."""

    child_bounds: torch.Tensor
    child_index: torch.Tensor
    prim_ids: torch.Tensor
    node_count: int

    @property
    def dim(self) -> int:
        return self.child_bounds.shape[-1] // 2


def widen(bvh) -> WideBvh:
    """Collapse a binary BVH into the 8-ary layout, on the host in numpy
    (bvh_tpu wide.py:52-119), onto the tree's device. Each wide node
    expands the inner slot of the largest half-area, in the tree's
    float type, until it holds WIDTH slots or only leaves."""
    nc = int(bvh.node_count)
    dim = bvh.dim
    bounds = bvh.bounds[:nc].cpu().numpy()
    index = bvh.index[:nc].cpu().numpy()
    first = index >> 4
    count = index & 15

    big = np.finfo(np.float32).max
    empty_row = np.empty((2 * dim,), bounds.dtype)
    empty_row[0::2] = +big
    empty_row[1::2] = -big

    def half_area(row):
        d = row[1::2] - row[0::2]
        if dim == 3:
            return (d[0] + d[1]) * d[2] + d[0] * d[1]
        return float(np.sum([d[i] * d[j] for i in range(dim)
                             for j in range(i + 1, dim)]))

    wide_of_binary = {0: 0}  # binary inner node id -> wide node id
    wide_slots: list[list[int]] = []
    queue = deque([0])
    while queue:
        b = queue.popleft()
        slots = [b]
        while len(slots) < WIDTH:
            cand = [s for s in slots if count[s] == 0]
            if not cand:
                break
            pick = cand[int(np.argmax([half_area(bounds[s]) for s in cand]))]
            slots.remove(pick)
            slots.extend([int(first[pick]), int(first[pick]) + 1])
        wide_slots.append(slots)
        for s in slots:
            if count[s] == 0:
                wide_of_binary[s] = len(wide_slots) + len(queue)
                queue.append(s)

    m = len(wide_slots)
    child_bounds = np.tile(empty_row, (m, WIDTH, 1))
    child_index = np.zeros((m, WIDTH), np.int64)
    for w, slots in enumerate(wide_slots):
        for j, s in enumerate(slots):
            child_bounds[w, j] = bounds[s]
            child_index[w, j] = (index[s] if count[s] != 0
                                 else wide_of_binary[s] << 4)
    dev = bvh.bounds.device
    return WideBvh(child_bounds=torch.from_numpy(child_bounds).to(dev),
                   child_index=torch.from_numpy(child_index).to(dev),
                   prim_ids=bvh.prim_ids, node_count=m)


def _slab8(rows, org, inv_dir, inv_org, inv_pad, neg, tmin, tmax,
           robust: bool):
    """Entry and exit distances of the WIDTH child boxes of each ray,
    rows [L, WIDTH, 2*dim]."""
    t0 = tmin[:, None].expand(-1, WIDTH)
    t1 = tmax[:, None].expand(-1, WIDTH)
    for i in range(org.shape[1]):
        lo, hi = rows[..., 2 * i], rows[..., 2 * i + 1]
        ng = neg[:, i, None]
        near_b = torch.where(ng, hi, lo)
        far_b = torch.where(ng, lo, hi)
        if robust:
            tn = (near_b - org[:, i, None]) * inv_dir[:, i, None]
            tf = (far_b - org[:, i, None]) * inv_pad[:, i, None]
        else:
            tn = utils.fast_mul_add(near_b, inv_dir[:, i, None],
                                    inv_org[:, i, None])
            tf = utils.fast_mul_add(far_b, inv_dir[:, i, None],
                                    inv_org[:, i, None])
        t0 = robust_max(tn, t0)
        t1 = robust_min(tf, t1)
    return t0, t1


def _walk_wide(wbvh: WideBvh, rays: Ray, leaf_fn: Callable, *,
               any_hit: bool, robust: bool, stack_depth: int):
    """The wide state machine over a block of rays (bvh_tpu
    wide.py:188-317); returns (t, u, v, pos, nodes, leaves), pos -1 on
    a miss."""
    R = rays.tmin.shape[0]
    dev, dtype = rays.org.device, rays.org.dtype
    i64 = torch.int64
    m = wbvh.child_bounds.shape[0]
    inv_dir = rays.get_inv_dir(safe=not robust)
    inv_org = -inv_dir * rays.org
    inv_pad = Ray.pad_inv_dir(inv_dir)
    neg = torch.signbit(rays.dir)
    slot_keys = torch.arange(WIDTH, dtype=dtype, device=dev)

    stack = torch.zeros((R, stack_depth), dtype=i64, device=dev)
    sp = torch.zeros(R, dtype=i64, device=dev)
    top = torch.zeros(R, dtype=i64, device=dev)  # wide root 0, inner word
    leaf_cur = torch.zeros(R, dtype=i64, device=dev)
    leaf_rem = torch.zeros(R, dtype=i64, device=dev)
    tmax = rays.tmax.clone()
    best_t = torch.full((R,), float("inf"), dtype=dtype, device=dev)
    best_u = torch.zeros(R, dtype=dtype, device=dev)
    best_v = torch.zeros(R, dtype=dtype, device=dev)
    best_pos = torch.full((R,), -1, dtype=i64, device=dev)
    nodes = torch.zeros(R, dtype=i64, device=dev)
    leaves = torch.zeros(R, dtype=i64, device=dev)
    live = torch.arange(R, device=dev)

    while live.numel():
        L = live.numel()
        s_top, s_sp = top[live], sp[live]
        s_cur, s_rem = leaf_cur[live], leaf_rem[live]
        in_leaf = s_rem > 0

        # ---- leaf step: one primitive, `t <= tmax` for closest hit ----
        lpos = s_cur[in_leaf]
        li = live[in_leaf]
        hit, t, u, v = leaf_fn(lpos, Ray(rays.org[li], rays.dir[li],
                                         rays.tmin[li], tmax[li]))
        if not any_hit:
            hit = hit & (t <= tmax[li])
        hl = li[hit]
        best_t[hl], best_u[hl], best_v[hl] = t[hit], u[hit], v[hit]
        best_pos[hl] = lpos[hit]
        if not any_hit:
            tmax[hl] = t[hit]
        done = torch.zeros(L, dtype=torch.bool, device=dev)
        if any_hit:
            done[torch.nonzero(in_leaf).squeeze(1)[hit]] = True
        s_cur = torch.where(in_leaf, s_cur + 1, s_cur)
        s_rem = torch.where(in_leaf, s_rem - 1, s_rem)
        leaf_exhausted = in_leaf & (s_rem == 0) & ~done

        # ---- inner step: all WIDTH children at once --------------------
        top_is_leaf = Index.is_leaf(s_top)
        enter_leaf = ~in_leaf & top_is_leaf
        do_node = ~in_leaf & ~top_is_leaf
        n_hits = torch.zeros(L, dtype=i64, device=dev)
        new_top = s_top.clone()
        ni = torch.nonzero(do_node).squeeze(1)
        s_stack = stack[live]
        if ni.numel():
            g = live[ni]
            wid = Index.first_id(s_top[ni]).clamp(0, m - 1)
            t0, t1 = _slab8(wbvh.child_bounds[wid], rays.org[g], inv_dir[g],
                            inv_org[g], inv_pad[g], neg[g], rays.tmin[g],
                            tmax[g], robust)
            hits8 = t0 <= t1
            keys = torch.where(hits8, slot_keys if any_hit else t0,
                               float("inf"))
            order = torch.sort(keys, dim=1, stable=True).indices
            ord_words = wbvh.child_index[wid].gather(1, order)
            nh = hits8.sum(1)
            n_hits[ni] = nh
            new_top[ni] = torch.where(nh > 0, ord_words[:, 0], new_top[ni])
            # push the hit children but the nearest, far to near
            ni_sp = s_sp[ni]
            if bool((ni_sp + torch.clamp(nh - 1, min=0) > stack_depth).any()):
                raise ValueError(f"wide traversal stack overflow "
                                 f"(stack_depth={stack_depth})")
            for j in range(WIDTH - 1, 0, -1):
                pj = torch.nonzero(nh > j).squeeze(1)
                s_stack[ni[pj], ni_sp[pj]] = ord_words[pj, j]
                ni_sp[pj] += 1
            s_sp[ni] = ni_sp
        descend = do_node & (n_hits > 0)

        s_cur = torch.where(enter_leaf, Index.first_id(s_top), s_cur)
        s_rem = torch.where(enter_leaf, Index.prim_count(s_top), s_rem)
        need_pop = (do_node & (n_hits == 0)) | leaf_exhausted
        can_pop = need_pop & (s_sp > 0)
        s_sp = s_sp - can_pop.to(i64)
        popped = s_stack.gather(1, s_sp.clamp(max=stack_depth - 1)[:, None])[:, 0]
        s_top = torch.where(descend, new_top,
                            torch.where(can_pop, popped, s_top))
        nodes[live] += do_node.to(i64)
        leaves[live] += enter_leaf.to(i64)
        stack[live] = s_stack
        sp[live], top[live] = s_sp, s_top
        leaf_cur[live], leaf_rem[live] = s_cur, s_rem
        live = live[~done & ~(need_pop & ~can_pop)]

    return best_t, best_u, best_v, best_pos, nodes, leaves


def traverse_wide(wbvh: WideBvh, rays: Ray, leaf_fn: Callable, *,
                  any_hit: bool = False, robust: bool = False,
                  stack_depth: int = 48, block_size: int | None = None) -> Hit:
    """Trace rays through the wide layout on the rays' device; the `Hit`
    of the binary `traverse`. Children are visited near to far by entry
    distance for closest hit (bvh.h:177-180, over 8 children) and in
    slot order for any hit, through a stable sort of the 8 keys."""
    R = rays.tmin.shape[0]
    block = block_size or DEFAULT_BLOCK
    parts = [_walk_wide(wbvh, Ray(*(x[a:a + block] for x in rays)), leaf_fn,
                        any_hit=any_hit, robust=robust,
                        stack_depth=stack_depth)
             for a in range(0, max(R, 1), block)]
    return hit_from(wbvh, *(torch.cat(x) for x in zip(*parts)))


def intersect_tris_wide(wbvh: WideBvh, tri_flat, rays: Ray, *,
                        any_hit: bool = False, robust: bool = False,
                        stack_depth: int = 48, permuted: bool = False,
                        block_size: int | None = None) -> Hit:
    """Closest- or any-hit triangle intersection over the wide layout;
    `tri_flat` [m, 12] rows by prim id, or by position when
    `permuted`."""
    return traverse_wide(wbvh, rays, make_tri_leaf_fn(wbvh, tri_flat,
                                                      permuted=permuted),
                         any_hit=any_hit, robust=robust,
                         stack_depth=stack_depth, block_size=block_size)
