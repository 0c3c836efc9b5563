"""Executors: the iteration and reduction strategies of a build.

Counterpart of `bvh_tpu.par.executor` (reference:
src/bvh/v2/executor.h). `SequentialExecutor` folds in index order on
the host; `ParallelExecutor` vectorises over the indices on one device,
or shares the work out over the ranks of a `par.mesh.Mesh`.

`build_minitree` routes its scene-bounds reduction through an executor
where the reference's build does (mini_tree_builder.h:161-167). min/max
joins are exact in any order, so both executors give the same bounds.
`ParallelExecutor.reduce` keeps `bvh_tpu`'s halving schedule, so a
float sum through it has `bvh_tpu`'s bits too, with or without a mesh.
"""

from __future__ import annotations

import torch


def tree_map(fn, tree):
    """`fn` applied to every tensor of a tensor, or of nested tuples,
    named tuples and lists of tensors (the pytrees the executors take)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, (tuple, list)):
        tree = tree[0]
    return tree


class SequentialExecutor:
    """Ordered execution (reference: executor.h:27-39): both calls fold
    left to right on the host, bit for bit deterministic."""

    def for_each(self, n: int, fn, init):
        """fn(carry, i) -> carry, applied for i in [0, n) in order."""
        carry = init
        for i in range(n):
            carry = fn(carry, i)
        return carry

    def reduce(self, values, reduce_fn, init):
        """Left fold of `reduce_fn` over the leading axis of `values`."""
        carry = init
        for i in range(_first_leaf(values).shape[0]):
            carry = reduce_fn(carry, tree_map(lambda v: v[i], values))
        return carry


class ParallelExecutor:
    """Data-parallel execution (reference: executor.h:42-85): `for_each`
    vmaps `fn` over the indices; `reduce` is a tree reduction. With a
    mesh, every rank takes its share of the work and the shares are
    all-gathered, so each rank returns the whole result."""

    def __init__(self, mesh=None, axis: str | None = None, *,
                 device=None):
        self.mesh = mesh
        self.axis = axis or (mesh.axis if mesh is not None else None)
        self.device = torch.device(
            device if device is not None
            else mesh.device if mesh is not None else "cuda")

    def for_each(self, n: int, fn):
        """fn(i) -> value over i in [0, n); returns the stacked values
        (order-independent bodies, as the reference requires of parallel
        loops). With a mesh a rank maps a contiguous share of the
        indices (the last share padded with n - 1, cut afterwards)."""
        if self.mesh is None:
            return torch.func.vmap(fn)(torch.arange(n, device=self.device))
        share = -(-n // self.mesh.size)
        mine = torch.arange(self.mesh.rank * share,
                            (self.mesh.rank + 1) * share,
                            device=self.device).clamp(max=n - 1)
        return tree_map(lambda v: self.mesh.all_gather(v)[:n],
                        torch.func.vmap(fn)(mine))

    def reduce(self, values, reduce_fn, init):
        """Tree reduction over the leading axis (the analogue of
        per-thread partials and a serial join, executor.h:63-84), in
        `bvh_tpu`'s schedule: while n > 1, an odd last element folds
        into the accumulator, then `values[:n//2]` joins
        `values[n//2 : 2*(n//2)]`; the accumulator joins the last value.
        `values` may be a pytree of tensors sharing a leading axis;
        `reduce_fn(a, b)` joins two pytrees.

        With a mesh, the schedule is cut at the last level k of at
        least one element a rank: each rank computes its contiguous
        share of level k's elements from their leaves, the levels below
        k fold their odd elements into the accumulator on every rank,
        and the gathered level k runs the rest of the schedule. Every
        join is the one the schedule makes, so the result has the same
        bits as without a mesh."""
        n = _first_leaf(values).shape[0]
        sizes = [n]
        while sizes[-1] > 1:
            sizes.append(sizes[-1] // 2)
        acc = init
        mesh = self.mesh
        if mesh is not None and mesh.size > 1 and n >= mesh.size:
            k = max(j for j, s in enumerate(sizes) if s >= mesh.size)
            dev = _first_leaf(values).device
            for j in range(k):
                if sizes[j] % 2:
                    tail = _level(values, sizes, j, torch.tensor(
                        [sizes[j] - 1], device=dev), reduce_fn)
                    acc = reduce_fn(acc, tree_map(lambda v: v[0], tail))
            share = -(-sizes[k] // mesh.size)
            mine = torch.arange(mesh.rank * share, (mesh.rank + 1) * share,
                                device=dev).clamp(max=sizes[k] - 1)
            values = tree_map(lambda v: mesh.all_gather(v)[:sizes[k]],
                              _level(values, sizes, k, mine, reduce_fn))
            n = sizes[k]
        while n > 1:
            if n % 2:
                acc = reduce_fn(acc, tree_map(lambda v: v[n - 1], values))
            half = n // 2
            values = reduce_fn(tree_map(lambda v: v[:half], values),
                               tree_map(lambda v: v[half:2 * half], values))
            n = half
        return reduce_fn(acc, tree_map(lambda v: v[0], values))


def _level(values, sizes, k, idx, reduce_fn):
    """Elements `idx` of level k of the halving schedule, from the
    leaves: element i of level j joins elements i and i + sizes[j] of
    level j - 1, so its leaves, in the order the joins pair them, are
    built from the top level down, and the joins run from level 1 up
    on adjacent pairs."""
    leaves = idx[:, None]
    for j in range(k, 0, -1):
        leaves = torch.stack([leaves, leaves + sizes[j]], -1).reshape(
            idx.shape[0], -1)
    vals = tree_map(lambda v: v[leaves.reshape(-1)], values)
    for _ in range(k):
        vals = reduce_fn(tree_map(lambda v: v[0::2], vals),
                         tree_map(lambda v: v[1::2], vals))
    return vals
