"""Wide-step probe (T5), the counterpart of tools/probe_tpu.py.

The JAX tool measured the constants that sized the TPU's wide-treelet
kernel: the cost of one synthetic wide-node step per iteration as a
function of lane count B and table width C, the cost of the 8-way
sorting network, and whether interleaving independent chains hides
latency (`make_kernel`, :61-140). Kernel `wide_step_probe`
(csrc/probes.cu) runs the same step, one thread per lane: fetch column
`top` of a [64, C] table, 8 slab tests, words from rows 48-55, keys by
entry t, optionally `_sort8`, one push and one pop, then
top = (popped + words[1] + it) floor-mod C and acc += keys[0].

The cost per iteration is (t(8192 iterations) - t(512)) / 7680, per
config and per chain (:193-199). `probe_library` times the sorts and
gathers of the render's glue at 1M rows (`probe_xla`, :207-238), as
library calls.

    python -m bvh_tpu_torch.tools.probe_tpu [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from bvh_tpu_torch import kernels
from bvh_tpu_torch.core import utils
from bvh_tpu_torch.tools.timing import guard, log, time_calls, timed
from bvh_tpu_torch.traverse.wide_treelet import _sort8

ROWS = 64
STACK_DEPTH = 24
MISS = 1e30
LO, HI = 512, 8192  # iteration counts whose difference gives the cost
# (B, C, sort8, chains), :166-180
CONFIGS = [(512, 128, False, 1), (2048, 128, False, 1),
           (8192, 128, False, 1), (2048, 512, False, 1),
           (8192, 512, False, 1), (2048, 128, True, 1), (8192, 128, True, 1),
           (2048, 128, False, 2), (8192, 128, False, 2),
           (2048, 128, False, 4), (8192, 512, True, 1), (8192, 128, True, 2)]
# one more row at a lane count that fills the card (8,192 lanes fill 64
# blocks of 128 on 132 SMs): the same kernel, measured where it is not
# bounded by idle SMs
FULL_CARD = (262_144, 128, True, 1)


def tool_inputs(B: int, C: int, rng):
    """The tool's inputs (:183-185): |N(0, 1)| table, N(2, 1) rays. On
    them few slab tests hit (under 1% at B = C = 128), so most keys are
    the miss key and the sort, keys and stack see little."""
    table = np.abs(rng.normal(0, 1, (ROWS, C))).astype(np.float32)
    rays = (rng.normal(0, 1, (8, B)).astype(np.float32) + 2.0)
    return torch.from_numpy(table), torch.from_numpy(rays)


def hitting_inputs(B: int, C: int, seed: int = 0):
    """Inputs on which the probe's step does its whole work: origins in
    [-1, 1]^3, directions with every component in [0.5, 1.5], and boxes
    lo < hi around the origins, so that about half of the slab tests hit
    (the rest miss behind or beside the ray); words in [-C, C) with a
    fraction, so the truncation and the floor modulo see negative
    values."""
    rng = np.random.default_rng(seed)
    table = np.zeros((ROWS, C), np.float32)
    lo = rng.uniform(-2.0, 1.0, (8, 3, C))
    hi = lo + rng.uniform(1.0, 4.0, (8, 3, C))
    table[0:48:2] = lo.reshape(24, C)
    table[1:48:2] = hi.reshape(24, C)
    table[48:56] = rng.integers(-C, C, (8, C)) + rng.uniform(0, 0.9, (8, C))
    rays = np.zeros((8, B), np.float32)
    rays[0:3] = rng.uniform(-1, 1, (3, B))
    rays[3:6] = rng.uniform(0.5, 1.5, (3, B))
    return torch.from_numpy(table), torch.from_numpy(rays)


def wide_step_probe_ref(table, rays, *, sort8: bool, chains: int,
                        stack_depth: int, iters: int,
                        hit_share: list | None = None):
    """Plain version of kernel `wide_step_probe`: the tool's
    `chain_step` over [B] lanes, chain by chain. tn = lo * inv + inv_org
    goes through `core.utils.fast_mul_add`, so that a test can give it
    XLA's contraction (ROADMAP C5). Returns out [8, B] f32, rows
    0..chains-1 each chain's sum of keys[0]. `hit_share`, if given,
    receives the share of slab tests that hit."""
    dev = rays.device
    C, B = table.shape[1], rays.shape[1]
    f32, i32 = torch.float32, torch.int32
    inv = 1.0 / rays[3:6]
    inv_org = -inv * rays[0:3]
    lanes = torch.arange(stack_depth, device=dev)[:, None]
    miss = torch.full((8, B), MISS, dtype=f32, device=dev)
    out = torch.zeros((8, B), dtype=f32, device=dev)
    hits = tests = 0
    for c in range(chains):
        top = torch.zeros(B, dtype=torch.int64, device=dev)
        sp = torch.zeros(B, dtype=i32, device=dev)
        stack = torch.zeros((stack_depth, B), dtype=i32, device=dev)
        acc = torch.zeros(B, dtype=f32, device=dev)
        for it in range(iters):
            row = table[:, top]                                  # [64, B]
            lo = row[0:48:2].reshape(8, 3, B)
            hi = row[1:48:2].reshape(8, 3, B)
            tn = utils.fast_mul_add(lo, inv[None], inv_org[None])
            tf = utils.fast_mul_add(hi, inv[None], inv_org[None])
            t0 = torch.zeros((8, B), dtype=f32, device=dev)
            t1 = miss
            for d in range(3):
                t0 = torch.maximum(t0, torch.minimum(tn[:, d], tf[:, d]))
                t1 = torch.minimum(t1, torch.maximum(tn[:, d], tf[:, d]))
            hit = t0 <= t1
            if hit_share is not None:
                hits += int(hit.sum())
                tests += hit.numel()
            keys = list(torch.where(hit, t0, miss))
            words = list(row[48:56].to(i32))
            if sort8:
                keys, words = _sort8(keys, words)
            stack = torch.where(lanes == sp, words[0], stack)
            sp = (sp + hit.any(0).to(i32) - 1).clamp(min=0)
            popped = torch.where(lanes == sp, stack, 0).amax(0)
            top = torch.remainder(popped + words[1] + it, C).to(torch.int64)
            acc = acc + keys[0]
        out[c] = acc
    if hit_share is not None:
        hit_share.append(hits / max(tests, 1))
    return out


def wide_step_probe(table, rays, *, sort8: bool, chains: int,
                    stack_depth: int, iters: int):
    """Kernel `wide_step_probe` for CUDA tensors, the plain version for
    CPU tensors. table [64, C] f32; rays [8, B] f32 (origin rows 0-2,
    direction rows 3-5). Returns [8, B] f32."""
    if rays.device.type == "cpu":
        return wide_step_probe_ref(table, rays, sort8=sort8, chains=chains,
                                   stack_depth=stack_depth, iters=iters)
    if rays.device.type != "cuda":
        raise ValueError(f"wide_step_probe: unsupported device {rays.device}")
    if chains not in (1, 2, 4) or not (
            1 <= stack_depth <= kernels.PROBE_STACK_MAX):
        raise ValueError(f"wide_step_probe: chains must be 1, 2 or 4 and "
                         f"stack_depth in [1, {kernels.PROBE_STACK_MAX}]")
    if (table.dtype != torch.float32 or table.dim() != 2
            or table.shape[0] != ROWS or not table.is_contiguous()
            or table.device != rays.device):
        raise ValueError(f"wide_step_probe: table must be a contiguous "
                         f"[{ROWS}, C] float32 tensor on {rays.device}")
    if (rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 8
            or not rays.is_contiguous()):
        raise ValueError("wide_step_probe: rays must be a contiguous [8, B] "
                         "float32 tensor")
    B = rays.shape[1]
    out = torch.empty((8, B), dtype=torch.float32, device=rays.device)
    kernels.WIDE_STEP_PROBE.launch(
        table.data_ptr(), table.shape[1], rays.data_ptr(), B, int(sort8),
        chains, stack_depth, iters, out.data_ptr())
    return out


def check_config(table, rays, sort8: bool, chains: int, iters: int = LO,
                 stack_depth: int = STACK_DEPTH) -> dict:
    """Kernel against its plain version on the same inputs, bit for bit.
    Raises if they differ; returns the kernel's output and hit share."""
    kw = dict(sort8=sort8, chains=chains, stack_depth=stack_depth,
              iters=iters)
    out = wide_step_probe(table, rays, **kw)
    share = []
    ref = wide_step_probe_ref(table, rays, hit_share=share, **kw)
    if not bool(torch.equal(out.view(torch.int32), ref.view(torch.int32))):
        raise AssertionError(f"wide_step_probe {kw} differs from its plain "
                             "version")
    return dict(out=out, hit_share=share[0])


def us_per_iter(table, rays, sort8, chains, device, n=5) -> tuple:
    """(us per iteration, ms of the LO-iteration launch): the difference
    of the HI- and LO-iteration launches over HI - LO."""
    kw = dict(sort8=sort8, chains=chains, stack_depth=STACK_DEPTH)
    ms = {}
    for iters in (LO, HI):
        first = wide_step_probe(table, rays, iters=iters, **kw)
        t, last = time_calls(lambda: wide_step_probe(
            table, rays, iters=iters, **kw), device, n)
        guard(f"wide_step_probe {kw} x{iters}", last, first)
        ms[iters] = t
    return (ms[HI] - ms[LO]) / (HI - LO) * 1e3, ms[LO]


def probe_kernels(device="cuda", n=5, configs=CONFIGS + [FULL_CARD]) -> list:
    """Every config's cost per iteration on the tool's inputs. Returns
    [(B, C, sort8, chains, us per iteration)]."""
    rng = np.random.default_rng(0)
    results = []
    for B, C, sort8, chains in configs:
        table, rays = (x.to(device) for x in tool_inputs(B, C, rng))
        us, ms_lo = us_per_iter(table, rays, sort8, chains, device, n)
        log(f"# T5 B={B:6d} C={C:4d} sort8={int(sort8)} chains={chains}: "
            f"{us:8.4f} us/iter ({us / chains:8.4f} us/iter/chain) "
            f"[launch + {LO} iterations: {ms_lo:.3f} ms]")
        results.append((B, C, sort8, chains, us))
    return results


def probe_library(device="cuda", n=5, rows=1 << 20) -> dict:
    """The glue's sorts and gathers as library calls (:207-238): a stable
    argsort of 1M keys in [0, 256) and a gather of [rows, 8] payload by
    it; the same order from one sort of a unique key (key << 32 | row),
    which carries the row index; a gather of 1M rows by a permutation;
    the first at 128K rows."""
    rng = np.random.default_rng(1)
    out = {}

    def cases(r, kmax):
        keys = torch.from_numpy(rng.integers(0, kmax, r).astype(np.int32)
                                ).to(device)
        pay = torch.from_numpy(rng.normal(0, 1, (r, 8)).astype(np.float32)
                               ).to(device)
        return keys, pay

    def argsort_take(k, p):
        order = torch.argsort(k, stable=True)
        return order, p.index_select(0, order)

    def one_key_sort(k, p):
        iota = torch.arange(k.numel(), device=k.device)
        order = (torch.sort((k.to(torch.int64) << 32) | iota).values
                 & 0xFFFFFFFF)
        return order, p.index_select(0, order)

    keys, pay = cases(rows, 256)
    ref = argsort_take(keys, pay)
    out["argsort_take_ms"] = timed("argsort+take", lambda: argsort_take(
        keys, pay), ref, device, n)
    out["one_key_sort_ms"] = timed("one-key sort", lambda: one_key_sort(
        keys, pay), ref, device, n)
    perm = torch.from_numpy(rng.permutation(rows)).to(device)
    ref_g = pay.index_select(0, perm)
    out["gather_ms"] = timed("gather", lambda: pay.index_select(0, perm),
                             ref_g, device, n)
    k2, p2 = cases(1 << 17, 64)
    ref2 = argsort_take(k2, p2)
    out["argsort_take_128k_ms"] = timed("argsort+take 128K", lambda:
                                        argsort_take(k2, p2), ref2, device, n)
    log(f"# T5 glue at {rows} rows x [8] f32: stable argsort + take "
        f"{out['argsort_take_ms']:.4f} ms, one-key sort carrying the row "
        f"{out['one_key_sort_ms']:.4f} ms, take by a permutation "
        f"{out['gather_ms']:.4f} ms; argsort + take at 131,072 rows "
        f"{out['argsort_take_128k_ms']:.4f} ms")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cpu":
        # the plain version at 8,192 iterations takes minutes: on the CPU
        # check the smallest config and time the glue at 64K rows
        table, rays = tool_inputs(512, 128, np.random.default_rng(0))
        check_config(table, rays, False, 1, iters=16)
        log("# T5 on the CPU: the plain version only; per-iteration "
            "costs are the card's")
        probe_library("cpu", n=3, rows=1 << 16)
        return
    probe_kernels(args.device)
    probe_library(args.device)


if __name__ == "__main__":
    main()
