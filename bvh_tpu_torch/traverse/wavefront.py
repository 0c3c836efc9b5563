"""Wavefront BVH traversal: every ray of a batch steps in lockstep.

Counterpart of `bvh_tpu.traverse.wavefront` (reference: bvh.h:124-182).
Each step advances every active ray by one state-machine step:

- inner step: slab-test both children of the current node, descend
  into the near child and push the far one (near/far by entry distance
  for closest hit, bvh.h:177-180; left first for any hit);
- leaf step: intersect one primitive of the current leaf (index.h:15-22);
- pop: the next subtree from the per-ray stack (stack.h:10-29).

Both slab tests are supported: the fast one, fma(bounds, inv_dir,
-inv_dir*org) (node.h:79-88), and T. Ize's robust one with the
2-ulp-padded inverse on the exit planes (node.h:68-77), folded with the
NaN-swallowing robust_max/robust_min (node.h:105-117).

This is plain PyTorch, as `bvh_tpu` runs it outside any Pallas kernel:
the CLI's path on the CPU and the traversal behind the flat API's
`intersect_ray*`. Nodes and primitives are read by index (`bvh_tpu`'s
one-hot matrix-product gathers and their `node_gather`/`gather` options
are a TPU workaround, ROADMAP A14). Each step works on the rays still
active only. A push onto a full stack raises, where
`bvh_tpu` silently loses the entry (ROADMAP C8).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from bvh_tpu_torch.core import utils
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.core.types import INVALID_PRIM_ID, Bvh, Index
from bvh_tpu_torch.core.utils import robust_max, robust_min

DEFAULT_BLOCK = 1 << 20  # rays per block of state


class TraversalStats(NamedTuple):
    visited_nodes: torch.Tensor  # [R] int: inner steps (child-pair visits)
    visited_leaves: torch.Tensor  # [R] int: leaves entered


class Hit(NamedTuple):
    """Per-ray result. `prim_pos` indexes the tree's `prim_ids`;
    `prim_id` is the original primitive id. Both are INVALID_PRIM_ID
    (0xFFFFFFFF, as int64) on a miss, and `t` is +inf."""

    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    prim_pos: torch.Tensor
    prim_id: torch.Tensor
    stats: TraversalStats

    @property
    def hit(self):
        return self.prim_pos != INVALID_PRIM_ID


def _slab_test(row, org, inv_dir, inv_org, inv_pad, neg, tmin, tmax,
               robust: bool):
    """Entry and exit distances of [B, 2*dim] interleaved boxes."""
    t0, t1 = tmin, tmax
    for i in range(org.shape[1]):
        lo, hi = row[:, 2 * i], row[:, 2 * i + 1]
        near_b = torch.where(neg[:, i], hi, lo)
        far_b = torch.where(neg[:, i], lo, hi)
        if robust:
            tn = (near_b - org[:, i]) * inv_dir[:, i]
            tf = (far_b - org[:, i]) * inv_pad[:, i]
        else:
            tn = utils.fast_mul_add(near_b, inv_dir[:, i], inv_org[:, i])
            tf = utils.fast_mul_add(far_b, inv_dir[:, i], inv_org[:, i])
        t0 = robust_max(tn, t0)
        t1 = robust_min(tf, t1)
    return t0, t1


def walk(pair_fetch: Callable, leaf_fn: Callable, rays: Ray, start, active,
         *, any_hit: bool, robust: bool, stack_depth: int):
    """The traversal state machine over the rays `active` at the start.

    `pair_fetch(fid) -> (row_l, row_r, word_l, word_r)` reads the child
    pair at (fid, fid + 1); `leaf_fn(prim_pos, rays_now) -> (hit, t, u,
    v)` tests one primitive position. `start` is the first index word.
    A push onto a full stack drops the bottom entry and sets the ray's
    overflow flag. Returns (t, u, v, pos, nodes, leaves, overflow), [R]
    each; pos is -1 and t +inf on a miss."""
    R = rays.tmin.shape[0]
    dev = rays.org.device
    i64 = torch.int64
    inv_dir = rays.get_inv_dir(safe=not robust)
    inv_org = -inv_dir * rays.org
    inv_pad = Ray.pad_inv_dir(inv_dir)
    neg = torch.signbit(rays.dir)

    stack = torch.zeros((R, stack_depth), dtype=i64, device=dev)
    sp = torch.zeros(R, dtype=i64, device=dev)
    top = torch.full((R,), int(start), dtype=i64, device=dev)
    leaf_cur = torch.zeros(R, dtype=i64, device=dev)
    leaf_rem = torch.zeros(R, dtype=i64, device=dev)
    tmax = rays.tmax.clone()
    best_t = torch.full((R,), float("inf"), dtype=rays.org.dtype, device=dev)
    best_u = torch.zeros(R, dtype=rays.org.dtype, device=dev)
    best_v = torch.zeros(R, dtype=rays.org.dtype, device=dev)
    best_pos = torch.full((R,), -1, dtype=i64, device=dev)
    nodes = torch.zeros(R, dtype=i64, device=dev)
    leaves = torch.zeros(R, dtype=i64, device=dev)
    ovf = torch.zeros(R, dtype=torch.bool, device=dev)
    live = torch.nonzero(active).squeeze(1)

    while live.numel():
        L = live.numel()
        s_top, s_sp = top[live], sp[live]
        s_cur, s_rem = leaf_cur[live], leaf_rem[live]
        in_leaf = s_rem > 0

        # ---- leaf step: one primitive ---------------------------------
        lpos = s_cur[in_leaf]
        li = live[in_leaf]
        hit, t, u, v = leaf_fn(lpos, Ray(rays.org[li], rays.dir[li],
                                         rays.tmin[li], tmax[li]))
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

        # ---- inner step -----------------------------------------------
        top_is_leaf = Index.is_leaf(s_top)
        enter_leaf = ~in_leaf & top_is_leaf
        do_node = ~in_leaf & ~top_is_leaf
        ni = torch.nonzero(do_node).squeeze(1)
        new_top = s_top.clone()
        descend = torch.zeros(L, dtype=torch.bool, device=dev)
        push = torch.zeros(L, dtype=torch.bool, device=dev)
        far = torch.zeros(L, dtype=i64, device=dev)
        if ni.numel():
            g = live[ni]
            row_l, row_r, idx_l, idx_r = pair_fetch(Index.first_id(s_top[ni]))
            args = (rays.org[g], inv_dir[g], inv_org[g], inv_pad[g], neg[g],
                    rays.tmin[g], tmax[g], robust)
            tl0, tl1 = _slab_test(row_l, *args)
            tr0, tr1 = _slab_test(row_r, *args)
            hit_l, hit_r = tl0 <= tl1, tr0 <= tr1
            swap = (tl0 > tr0) if not any_hit else torch.zeros_like(hit_l)
            near = torch.where(swap, idx_r, idx_l)
            both = hit_l & hit_r
            new_top[ni] = torch.where(both, near,
                                      torch.where(hit_l, idx_l, idx_r))
            descend[ni] = hit_l | hit_r
            push[ni] = both
            far[ni] = torch.where(swap, idx_l, idx_r)

        # top-at-the-end stack: a push onto a full stack drops the bottom
        s_stack = stack[live]
        full = push & (s_sp >= stack_depth)
        if bool(full.any()):
            s_stack[full] = torch.roll(s_stack[full], -1, dims=1)
            s_sp = torch.where(full, s_sp - 1, s_sp)
            ovf[live[full]] = True
        pi = torch.nonzero(push).squeeze(1)
        s_stack[pi, s_sp[pi]] = far[pi]
        s_sp = s_sp + push.to(i64)

        s_cur = torch.where(enter_leaf, Index.first_id(s_top), s_cur)
        s_rem = torch.where(enter_leaf, Index.prim_count(s_top), s_rem)
        need_pop = (do_node & ~descend) | leaf_exhausted
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

    return best_t, best_u, best_v, best_pos, nodes, leaves, ovf


def _pair_fetch(bvh: Bvh):
    cap = bvh.index.shape[0]

    def fetch(fid):
        f0 = fid.clamp(0, cap - 1)
        f1 = (fid + 1).clamp(0, cap - 1)
        return bvh.bounds[f0], bvh.bounds[f1], bvh.index[f0], bvh.index[f1]

    return fetch


def hit_from(bvh: Bvh, t, u, v, pos, nodes, leaves) -> Hit:
    """A `Hit` from per-ray results with pos -1 on a miss."""
    missed = pos < 0
    n = bvh.prim_ids.shape[0]
    prim_id = torch.where(missed, INVALID_PRIM_ID,
                          bvh.prim_ids.to(pos.device)[pos.clamp(0, n - 1)])
    return Hit(t=torch.where(missed, float("inf"), t), u=u, v=v,
               prim_pos=torch.where(missed, INVALID_PRIM_ID, pos),
               prim_id=prim_id, stats=TraversalStats(nodes, leaves))


def traverse(bvh: Bvh, rays: Ray, leaf_fn: Callable, *, any_hit: bool = False,
             robust: bool = False, stack_depth: int = 64, start=None,
             block_size: int | None = None) -> Hit:
    """Trace a batch of rays through `bvh` on the rays' device.

    `leaf_fn(prim_pos, rays_now) -> (hit, t, u, v)` intersects one
    primitive position per ray with the current (shortened) intervals.
    `start`: the index word to start from; defaults to the root's (the
    root box is never tested, test/simple_example.cpp:81-92).
    `block_size`: rays per block of traversal state.
    Raises ValueError if a ray overflows `stack_depth`."""
    R = rays.tmin.shape[0]
    if start is None:
        start = int(bvh.index[0])
    block = block_size or DEFAULT_BLOCK
    fetch = _pair_fetch(bvh)
    parts = []
    for a in range(0, max(R, 1), block):
        sub = Ray(*(x[a:a + block] for x in rays))
        parts.append(walk(fetch, leaf_fn, sub, start,
                          torch.ones_like(sub.tmin, dtype=torch.bool),
                          any_hit=any_hit, robust=robust,
                          stack_depth=stack_depth))
    out = [torch.cat(x) for x in zip(*parts)]
    if bool(out[6].any()):
        raise ValueError(f"traversal stack overflow (stack_depth="
                         f"{stack_depth}); size it with "
                         f"traverse.stack.required_stack_depth")
    return hit_from(bvh, *out[:6])


def make_tri_leaf_fn(bvh: Bvh, tri_flat, permuted: bool = False) -> Callable:
    """Leaf intersector over precomputed triangles: `tri_flat` [m, 12]
    (p0|e1|e2|n) rows by prim id, or by prim position when `permuted`
    (index.h:23-25)."""
    from bvh_tpu_torch.geom.tri import PrecomputedTri

    m = tri_flat.shape[0]
    n_pos = bvh.prim_ids.shape[0]
    prim_ids = bvh.prim_ids.to(tri_flat.device)

    def leaf_fn(prim_pos, rays_now):
        pos = prim_pos.clamp(0, n_pos - 1)
        idx = pos if permuted else prim_ids[pos].clamp(0, m - 1)
        tri = PrecomputedTri.from_flat(tri_flat[idx])
        t, u, v, hit = tri.intersect(rays_now)
        return hit, t, u, v

    return leaf_fn


def make_sphere_leaf_fn(bvh: Bvh, centers, radii,
                        permuted: bool = False) -> Callable:
    """Leaf intersector over spheres, `centers` [m, dim] and `radii` [m]
    by prim id, or by prim position when `permuted` (sphere.h:31-49
    through the leaf callback). The hit t is the entry distance t0
    (clamped to tmin); u carries t0 and v the exit distance t1."""
    from bvh_tpu_torch.geom.sphere import Sphere

    m = centers.shape[0]
    n_pos = bvh.prim_ids.shape[0]
    prim_ids = bvh.prim_ids.to(centers.device)

    def leaf_fn(prim_pos, rays_now):
        pos = prim_pos.clamp(0, n_pos - 1)
        idx = pos if permuted else prim_ids[pos].clamp(0, m - 1)
        t0, t1, hit = Sphere(centers[idx], radii[idx]).intersect(rays_now)
        return hit, t0, t0, t1

    return leaf_fn


def intersect_tris(bvh: Bvh, tri_flat, rays: Ray, *, any_hit: bool = False,
                   robust: bool = False, stack_depth: int = 64,
                   permuted: bool = False,
                   block_size: int | None = None) -> Hit:
    """Closest- or any-hit ray/triangle-mesh intersection
    (test/simple_example.cpp:66-92)."""
    leaf_fn = make_tri_leaf_fn(bvh, tri_flat, permuted=permuted)
    return traverse(bvh, rays, leaf_fn, any_hit=any_hit, robust=robust,
                    stack_depth=stack_depth, block_size=block_size)
