"""Per-step cost of kernel B1 and its ablation variants (T1), the
counterpart of tools/ablate_kernel.py.

A synthetic treelet table is a chain of wide nodes: each node's slot 0
is a huge box whose child is the next node, the other slots are empty,
and the last node has no child that the ray enters. Every pair then
runs exactly `depth` steps and pops dry. The difference between the
times at two depths, over the difference of the depths, is the cost of
one step; variants of the kernel with parts left out (`ABLATE_*`,
csrc/wide_treelet.cu) split it. On the chain table the left-out code
never changes a result (no quad column exists, only slot 0 hits, nothing
is pushed), so every variant must give the full kernel's outputs.

The JAX tool's variant (e), a default-precision one-hot dot, has no
counterpart: B1 fetches a column with loads, and there is no dot.

    python -m bvh_tpu_torch.tools.ablate_kernel [--block 1024] [--p 384]
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from bvh_tpu_torch import kernels
from bvh_tpu_torch.tools.timing import log, same, time_calls, timed
from bvh_tpu_torch.traverse import wide_treelet as wt

VARIANTS = {"no quad MT": wt.ABLATE_NO_QUAD, "no sort8": wt.ABLATE_NO_SORT,
            "no stack pushes": wt.ABLATE_NO_PUSH}
# the masks csrc/wide_treelet.cu instantiates: nothing left out, each
# part alone, and the quad tests with the sort (tools/ablate_kernel2.py)
MASKS = (0, *VARIANTS.values(), wt.ABLATE_NO_QUAD | wt.ABLATE_NO_SORT)
NO_DOT = ("default-precision dot: n/a on this card (B1 fetches a column "
          "with loads; there is no dot to make less precise)")


def make_chain_table(depth: int, P: int) -> np.ndarray:
    """[1, 64, P] f32 table (tools/ablate_kernel.py:32-57): columns
    0..depth-2 are wide nodes whose slot 0 is a huge box with child
    word (c + 1) << 4; every other slot, and every slot of the other
    columns, is an empty box."""
    t = np.zeros((1, 64, P), np.float32)
    big = np.float32(np.finfo(np.float32).max)
    t[0, 0:48:2] = big     # lo of every slot and axis
    t[0, 1:48:2] = -big    # hi
    c = np.arange(depth - 1)
    t[0, 0:6:2, :depth - 1] = -1e30
    t[0, 1:6:2, :depth - 1] = 1e30
    t[0, 48, c] = ((c + 1) << 4).astype(np.float32)
    return t


def chain_cols(depth: int, P: int, device) -> torch.Tensor:
    """`make_chain_table` in the column layout [1, P, 64] that kernel B1
    reads, on `device`."""
    return wt.column_tables(torch.from_numpy(make_chain_table(depth, P)).to(
        device))


def chain_pairs(B: int, device):
    """All B pairs on treelet 0; rays from the origin along +x, tmin 0,
    tmax 1e30 (:70-80). Returns (tid [B] int32, rays [8, B] f32)."""
    rays = torch.zeros((8, B), dtype=torch.float32, device=device)
    rays[3] = 1.0
    rays[7] = 1e30
    return torch.zeros(B, dtype=torch.int32, device=device), rays


def traverse_pairs_ablate(table_cols, tid, rays, *, variant: int,
                          stack_depth: int):
    """Kernel B1's closest-hit, fast-form traversal with the code of
    `variant` (one of `MASKS`; 0 leaves nothing out) left out: the CUDA
    kernel for CUDA tensors,
    `traverse_pairs_plain(..., ablate=variant)` for CPU tensors. Inputs
    (the column tables [T, P, 64]) and outputs as `traverse_pairs`."""
    if variant not in MASKS:
        raise ValueError(f"traverse_pairs_ablate: unknown variant {variant}")
    if rays.device.type == "cpu":
        return wt.traverse_pairs_plain(table_cols, tid, rays, any_hit=False,
                                       robust=False, stack_depth=stack_depth,
                                       ablate=variant)
    if rays.device.type != "cuda":
        raise ValueError(f"traverse_pairs_ablate: unsupported device "
                         f"{rays.device}")
    wt.check_pair_inputs("traverse_pairs_ablate", table_cols, tid, rays,
                         stack_depth)
    L = tid.shape[0]
    out_f = torch.empty((3, L), dtype=torch.float32, device=rays.device)
    out_i = torch.empty((4, L), dtype=torch.int32, device=rays.device)
    work = torch.empty(1, dtype=torch.int32, device=rays.device)
    kernels.WIDE_TREELET_ABLATE.launch(
        table_cols.data_ptr(), table_cols.shape[0], table_cols.shape[1],
        tid.data_ptr(), rays.data_ptr(), L, variant, stack_depth,
        out_f.data_ptr(), out_i.data_ptr(), work.data_ptr())
    return out_f, out_i


def _full(table_cols, tid, rays, sd):
    return wt.traverse_pairs(table_cols, tid, rays, any_hit=False,
                             robust=False, stack_depth=sd)


def check_chain(table_cols, tid, rays, depth: int,
                stack_depth: int = 24) -> dict:
    """On the chain table in the column layout (`chain_cols`): the full
    kernel against its plain version, and every variant against the
    full kernel, bit for bit on every lane; every lane's active steps
    must be `depth`. Raises otherwise. Returns the full kernel's
    output."""
    full = _full(table_cols, tid, rays, stack_depth)
    plain = wt.traverse_pairs_plain(table_cols, tid, rays, any_hit=False,
                                    robust=False, stack_depth=stack_depth)
    if not same(full, plain):
        raise AssertionError("B1 on the chain table differs from its plain "
                             "version")
    if not bool((full[1][1] == depth).all()):
        raise AssertionError(f"chain table: active steps are not {depth}")
    for name, v in VARIANTS.items():
        got = traverse_pairs_ablate(table_cols, tid, rays, variant=v,
                                    stack_depth=stack_depth)
        if not same(got, full):
            raise AssertionError(f"variant '{name}' differs from the full "
                                 "kernel on the chain table")
    return dict(out=full, plain=plain)


def measure(name, launch, P, B, device, n=5) -> dict:
    """us per step of `launch(table, tid, rays)`: times at depth 16 and
    P - 16 (:120-126), each launch's output guarded against the full
    kernel's on that table."""
    tid, rays = chain_pairs(B, device)
    ms = {}
    for depth in (16, P - 16):
        table = chain_cols(depth, P, device)
        ref = _full(table, tid, rays, 24)
        ms[depth] = timed(f"{name} depth {depth}", lambda: launch(
            table, tid, rays), ref, device, n)
    us = (ms[P - 16] - ms[16]) / (P - 32) * 1e3
    log(f"# T1 {name:26s}: {us:8.4f} us/step (depth 16 {ms[16]:.4f} ms, "
        f"depth {P - 16} {ms[P - 16]:.4f} ms a launch of {B} pairs)")
    return dict(us=us, ms_lo=ms[16], ms_hi=ms[P - 16])


def run(B=1024, P=384, device="cuda", n=5) -> dict:
    """The chain check at two depths, then each variant's cost per
    step. Returns {name: measure(...)}, the checked outputs and the
    plain version's time at depth P - 16."""
    tid, rays = chain_pairs(B, device)
    checks = {}
    for depth in (16, P - 16):
        checks[depth] = check_chain(chain_cols(depth, P, device), tid, rays,
                                    depth)
    log(f"# T1 chain table, B={B} P={P}: B1, its plain version and every "
        f"variant equal on every lane; active steps = depth (16, {P - 16})")
    table = chain_cols(P - 16, P, device)
    plain_ms, _ = time_calls(lambda: wt.traverse_pairs_plain(
        table, tid, rays, any_hit=False, robust=False, stack_depth=24),
        device, 1)
    out = dict(checks=checks, plain_ms=plain_ms, table=table, tid=tid,
               rays=rays)
    for sd in (24, 8):
        out[f"full sd={sd}"] = measure(
            f"full kernel sd={sd}",
            lambda t, i, r, sd=sd: _full(t, i, r, sd), P, B, device, n)
    for name, v in VARIANTS.items():
        out[name] = measure(name, lambda t, i, r, v=v: traverse_pairs_ablate(
            t, i, r, variant=v, stack_depth=24), P, B, device, n)
    out["full P=128"] = measure("full kernel P=128", lambda t, i, r: _full(
        t, i, r, 24), 128, B, device, n)
    log(f"# T1 {NO_DOT}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--block", type=int, default=1024)
    ap.add_argument("--p", type=int, default=384)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.block, args.p, args.device)


if __name__ == "__main__":
    main()
