"""Card check of the PyTorch/CUDA port: builds the sponza-262K tree on one
CUDA device through the port's build and renders it through the port's
kernels, as bench.py runs the JAX reference; runs the renderer CLI on
the Cornell box and on a San-Miguel-class scene; and verifies every step.

    python3 chip_smoke.py

Phases (each prints its result; any failed check raises, so the script
exits non-zero):

1. device: the card's name and power limit (nvidia-smi), then the
   builds of the CUDA kernels (one nvcc per source, in parallel) and of
   the native tree library;
2. scene: sponza_class(262144, 0), prim boxes and centres in numpy on
   the host (bench.py:88-90), and the native quality-high build on the
   host (mini-tree + reinsertion, thread pool) for comparison;
3. staging: the Morton-grid groups and the launch shape (G, P, NCAP),
   and the CTAs of kernel B3 one SM holds at that P (CUDA's occupancy
   calculator) times the SMs: all G groups in one wave or not;
4. kernel B3 (per-group binned SAH) against its plain version on the
   full staging: nbf, nbi, source lanes and node counts equal bit for
   bit; the tree's levels and open nodes, which B3's bound counts; then
   its "bfs" variant (`group_forest_build(..., variant="bfs")`, B3 plus
   the BFS queue in nbi row 3): one B3 launch, and all four outputs
   equal to the plain version with the queue replayed on the host as
   bvh_tpu's BFS kernel writes it, its entries the open nodes;
5. the build path: `build_minitree_fast` + `optimize_reinsertion` on the
   card with launch counts reset before and read after; the same build
   through B3's plain version, also on the card; both trees equal bit
   for bit; the tree's invariants (every prim once, leaves tile [0, n),
   inner boxes the exact merge of their children, total half-area not
   grown by reinsertion);
6. treelet tables of the port's tree (and their column copy, which B1
   reads); kernel B2 (phase-A collect) and kernel B1 (wide treelet
   traversal) against their plain versions on all 1024 x 1024 primary
   rays and their first-round pairs, bit for bit;
7. the render path on the port's tree: the primary render (closest hit)
   and the shadow render (any-hit toward a point light) through the
   kernels, with launch counts reset before and read after;
8. B2 and B1 as in 6 on the shadow rays; every 16th ray of both renders
   through the render driver with the plain versions, on the card: t,
   u, v, prim_pos and prim_id equal bit for bit;
9. the primary render once more on the native tree: at most 4 rays of
   1,048,576 (bench.py:34-37's edge budget) may differ, by a hit-mask
   flip or a hit at another t; on every other ray t is equal bit for
   bit, so prim ids differ only on exact-t ties. Each differing ray must
   be a fast-slab cull: under the robust slab test both trees give it
   the same t bit for bit, the port's fast-form t is that t or a miss,
   the native tree's is that t or later, and one of the two trees finds
   that t;
10. timing with CUDA events, kernel beside plain version, and the
   device build stage by stage; the last output of every timed loop is
   compared with the verified run;
11. (a) the CLI (`cli.benchmark`'s argument parsing, OBJ load and `run`)
   on tests/golden/cornell.obj at 1024x1024 from the reference's test
   camera, -p --robust-traversal, at -q low, med and high: each run
   launches kernel B5 and neither B1 nor B2; every ray's t, u, v,
   position and counts equal B5's plain version bit for bit; the PPM
   equals, byte for byte, the PPM drawn from the plain version's hits;
   the intersection count is the C++ reference's 1,027,152; B5's time
   (the device's own, queued, median of 21, and the host loop through
   its wrapper) and its bound from the rows its steps visit;
12. (b) B5 on the 262K tree with all 1,048,576 primary rays, fast and
   robust, through `pallas_intersect_tris` (launches counted) and
   directly: every 16th ray (65,536) of both forms, and every ray of
   the fast one, equal to the plain version bit for bit; the hits agree with the wide-treelet render of the same tree
   (at most 4 rays differ, by a mask flip or a hit at another t; prim
   ids differ elsewhere only on exact-t ties); B5's time both ways and
   its plain version's on every ray, its
   bound from the pair and triangle rows its steps visit (marked in a
   run of the plain version), ns a step, SIMT efficiency (the kernel's
   own counts, and one ray a lane from the counts), warps an SM and
   ptxas' registers, frame and spills;
13. (c) the CLI's `run` on sponza_class(10,000,000, 0), the
   San-Miguel-class scene, at 1024x1024 and -q high from
   `scene_camera`: the build launches B3, the treelet cut has a super
   level (S > 0), the render launches B2, B4 and B1; B4 equals its
   plain version bit for bit on every (ray, super) pair of the first
   A2 round; every 16th ray's t and position equal the plain-version
   driver's; the hit count is the C++ oracle's 77,420 within 4 per
   million; B4's time both ways and its bound from the super rows its
   pairs visit; the build stage by stage, the treelet cut and the
   render timed with CUDA events;
14. dims, for dim 2, 3 and 4: (a) tools/bench_dims.py's configuration
   (1,024 spheres, `build_binned` on the card, 262,144 rays) through
   `pallas_intersect_spheres`, which launches kernel B6: B6 equal to its
   plain version bit for bit on every ray (closest fast, any-hit
   robust), the wrapper's coherence-sorted result equal to an unsorted
   launch, and every 16th ray equal to the wavefront with
   `make_sphere_leaf_fn` in hit mask and prim id, t bit for bit or
   within rtol 2e-5; (b) 262,144 spheres, radii scaled so that coverage
   equals (a), built by `build_default(MEDIUM)` (`build_minitree` in 2D
   and 4D, kernel B3 in 3D; the tree's invariants), 1,048,576 rays
   through B6, every ray equal to the plain version bit for bit; B6,
   its plain version (on every ray) and the build timed with CUDA
   events, B6 in
   coherence order and unsorted; per dim B6's ns a step (its time over
   inner steps plus leaves), its SIMT efficiency (its own lanes' steps
   over 32 x its warps' steps, and one ray a lane from the counts in
   launch order), its warps an SM and ptxas' registers, frame and
   spills;
15. float64: bench_dims' 1,024 float64 triangles (16,384 rays), then
   262,144 (edges scaled by (1024/262144)^(1/3), `build_default(MEDIUM)`
   = `build_minitree` in float64; 65,536 rays), through the wavefront on
   the card: every 256th ray's closest t equal to the brute-force
   Möller–Trumbore minimum over all triangles (a differing ray must be
   a fast-slab cull);
16. `build_lbvh` on the 262K scene (invariants, ms and Mprims/s), its
   B5 render of all primary rays within 4 rays of the high tree's
   (phase 12), each difference a fast-slab cull; `widen` of the high
   tree (host) and every 16th primary ray through `intersect_tris_wide`
   on the card against B5 on the same tree, under the same rule;
17. the profiling tools' kernels (`bvh_tpu_torch/tools/`): T6 column
   fetch in bf16 and int8 at tools/probe_int8_fetch.py's shapes on the
   table's column copy, bit for bit against its plain version, then its
   and the library's times (µs per fetch; the device's time, medians of
   21) and the column copy's time; T5 wide-step probe bit for bit
   against its plain version at 512 iterations on four of
   tools/probe_tpu.py's configs (and one
   on inputs where about half the slab tests hit), at 64 iterations on
   those inputs and on inputs whose children share boxes (ties in the
   sorting network) at C 128 and 512, chains 1, 2 and 4 and stack
   depths 1, 24 and 32; its time (the device's own and the host loop),
   the SM clock under it and its cycles a step, its ptxas figures and
   launch shape, then the cost per iteration of all 12 configs and one
   that fills the card, and the glue's sorts and gathers at 1M rows;
   T1: on the chain table B1, its plain version and each ablation
   variant equal on every lane with active steps = depth, then each
   variant's cost per step;
18. `par/` on two gloo ranks spawned on the one card (NCCL refuses two
   ranks on one card; gloo takes device tensors, copying them through
   the host itself): `ParallelExecutor(mesh).reduce` of the
   centres equals amin/amax; `build_minitree_sharded` at
   `MiniTreeConfig()` on the 262K scene, stage by stage (pre-pass,
   phase A, phase B, gather, glue; CUDA events, the collectives' count,
   bytes and host time), equal bit for bit to `build_minitree` on the
   card (rank 0), the same digest on both ranks, the tree's invariants;
   `intersect_tris_sharded` of all 1,048,576 primary rays and of
   1,048,573 equal to `intersect_tris` in t, u, v and prim id (every
   4th ray if the single traversal takes over 60 s); then the two port
   examples as subprocesses on the card and with `--device cpu` (rc 0,
   the same line), and the native bindings on tests/golden's tree
   (every 16th golden ray's closest hit). Its results print on a JSON
   line `{"par": ...}` before the kernels line;
19. the tools for building, rendering and dims (`bvh_tpu_torch/tools/`),
   each through its `run` at full width with the launch counts reset
   before and read after it: `bench_build` at 262,144 (lbvh,
   level-synchronous mini-tree, binned, mtf, high; its high tree equal
   to phase 5's), `profile_mtf` and `profile_reinsertion` (inputs lbvh
   and mtf), whose staged build and iteration must equal the unstaged
   ones bit for bit, `profile_build`, `check_mtf_parity` (the two
   mini-tree builds bit-equal), `bench_wide` (max_prims 512, 1024,
   2048 on phase 5's tree, 81,790 hits each), `check_wide_quick` on
   that tree (81,790) and on phase 2's native tree (within the edge
   budget), `check_super_quick` (the forced super level gives the flat
   render's 81,790), `ablate_kernel2` on T3's round-1 pairs (the base
   variant equal to B1), `bench_sanmiguel` on phase 13's tree and
   tables (77,420 hits; the v2 round trip `bvh_equal`, the tables cut
   from the loaded tree and its render equal to the built tree's) and
   `bench_dims` (its parity gate). B1, B2, B3, B4, B6 and T1 must each
   launch; the results go to chiprun_out/phase19.json and a `{"tools":
   ...}` line before the kernels line;
20. the last five tools, each through its `run` at full width with the
   launch counts reset before and read after it: `profile_floor` (n
   2,097,152, eager loops against their CUDA-graph replays; first, so
   that its launch floor reads the process as the earlier phases left
   it), `check_oracle` (the native quality-2 tree's render, fast and
   robust, on all 1,048,576 primary rays against the native tracer
   within 4 rays a million, the robust path under the strict rule),
   `profile_floor2`
   (n 262,144, each op checked by value, H5's two cumsum forms),
   `profile_pure` (render x1 and x4 on phase 5's tree, 81,790 hits,
   kernel time from a trace against event time) and `sweep_chain`
   (k 4 and 16 and max_prims 2048 beside the default and the entry
   point, every config's hits bit-equal to the default's); then `entry()` on the card (equal
   to its CPU run) and `dryrun_multichip(2)` on gloo ranks that share
   the card. B1 and B2 must launch in the three render tools; the
   results go to chiprun_out/phase20.json and a `{"tools20": ...}`
   line before the kernels line;
21. the one-program render on phase 7's 262K tree, primary and shadow
   rays, with the launch counts reset before and read after each step:
   a verified eager call and its caps; the render chain
   (`wide_treelet_render_chain` at k 1: its own verified eager render
   and `_render_fixed`, then one render captured as a CUDA graph), its
   t row equal to the entry point's on all 1,048,576 rays (81,790
   primary hits), B2 and B1 launched during the capture, the graph's
   nodes by type; `_render_fixed` at the chain's settings under sync
   debug "error", equal to the eager render bit for bit, with B2 and B1
   held against their plain versions on the inputs it gave them;
   `steady_rate` at 16 and 64 renders (the k-64 chain's row equal to
   the entry point's) beside the entry point's ms; one call of the k-1
   chain and one of the entry point under torch.profiler (device ops,
   busy share, host syncs, the kernels' ms, B1's and B2's); then the
   chain raises NotImplementedError on phase 13's two-level tables. The
   results go to chiprun_out/phase21.json and a `{"one_program": ...}`
   line; the kernels line's B1 and B2 entries carry its launches
   under "one_program".

22. the portal ordering kernel (csrc/portal_sort.cu) at the main
   path's shapes: the sort of phase A's records of the 262K primary
   rays, the two-level split of the San-Miguel-class scene's and that
   render's first A2 merge, each equal to its plain version (the torch
   sorts over padded columns) bit for bit, timed beside it and beside
   torch.sort of the same columns alone (`library_ms`), with the bound
   of its bytes, and the kernels' launches in the entry point's render
   of each scene (one sort an attempt, one merge an A2 round); results
   in chiprun_out/phase22.json, a `{"portal_sort": ...}` line and the
   kernels line's portal_sort and portal_merge entries.

The render profilers run inside phases 10 and 13: after phase 10, T2
(`profile_r3`: the primary render stage by stage, whose stages give the
render's hits bit for bit, a torch.profiler trace of one render, the
pair-sort candidates) and T3 (`profile_occupancy`: round 1's per-pair
steps, on the pairs phase 6 checked, and the SIMT efficiency of pair
orderings); in phase 13, T4 (`profile_sm`) on the San-Miguel-class
scene that phase built, with kernel B2 there held against its plain
version.

The second-to-last lines are a JSON object naming each kernel with its
launches, error, times and bound (B4's and B5's "ms" the device's own
time, B5's at the 262K shape with the Cornell shape beside it), and the
card's name and power limit;
the last line is {"ok": true, "device": {...}}. Without a CUDA device
the script exits 1 and prints no result. PPMs go to chiprun_out/.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

N_TRIS = 262_144
SIDE = 1024
SUBSET = 16  # every 16th ray goes through the plain-version render
# Closest-hit count of the C++ oracle on bvh_tpu's own device-built tree
# for this scene and camera (BENCH_r05.json); printed for information.
ORACLE_HITS_REFERENCE_TREE = 81_790
# Primary rays whose hit mask may differ between two trees of the same
# scene (bench.py:34-37: 4 per million, edge hits under other rounding).
EDGE_BUDGET = 4
BUILD_REPS = 3  # timed device builds
# Hit count of the C++ reference's benchmark tool on its cornell_box.obj
# (= tests/golden/cornell.obj) at 1024x1024 from the test camera.
CORNELL_HITS = 1_027_152
N_BIG = 10_000_000  # the San-Miguel-class scene (tools/bench_sanmiguel.py)
# Closest-hit count of the C++ oracle on that scene and camera
# (BENCHMARKS_r4.txt:59).
BIG_ORACLE_HITS = 77_420
# H100 SXM peaks (NVIDIA's data sheet): device memory rate and float32
# rate outside the tensor cores, for each kernel's bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# Float operations per step, counted as lower bounds: a slab test of one
# box (3 axes of two planes, a multiply and an add each, then a max and a
# min per axis) 18; a Möller–Trumbore test 40; a B1 step at least 8
# slab tests (144); a recorded portal came from a node step of 2 boxes
# that records at most 2 portals (18).
OPS_BOX, OPS_TRI, OPS_WIDE_STEP, OPS_PORTAL = 18, 40, 144, 18
# Kernel B3, counted over the open nodes of every level the plain version
# runs: a lane's binning (3 axes of a multiply, an add and two clamps, and
# 18 min/max) 30, its partition compare 1 (only in a node that splits);
# a node's SAH sweep, 3 axes x 14
# prefixes x (6 min/max, a half-area of 3 differences, 2 sums and 2
# products, and a cost of a product and a sum) 630.
OPS_BIN_LANE, OPS_PART_LANE, OPS_SWEEP_NODE = 30, 1, 630
# Kernel B6, as lower bounds too: one box axis (two planes, a multiply
# and an add each, a max and a min) 6; a sphere test 20 beyond its
# per-axis work (oc, three products and sums: 6 an axis): 2b, r*r, c,
# b*b, 4a, 4ac, delta, -0.5/a, the root, two sums, two products, a max,
# a min and two compares.
OPS_BOX_DIM, OPS_SPHERE = 6, 20
# Phase 14: tools/bench_dims.py's configuration, then the scale case
DIMS_M, DIMS_RAYS = 1024, 262_144
SCALE_M, SCALE_RAYS = 262_144, 1 << 20
# Phase 15: bench_dims' float64 triangles, then the scale case
F64_M, F64_RAYS = 1024, 16_384
F64_BIG, F64_BIG_RAYS = 262_144, 65_536
F64_CHECK = 256  # every 256th ray against the brute-force minimum
# Phase 17: tools/ablate_kernel.py's lanes and table width, and the
# launches whose median each T1 time is (a launch is 0.05-0.4 ms, so
# the tool's 5 leave its per-step difference noisy)
T1_B, T1_P, T1_REPS = 1024, 384, 21
# T5's checks beyond the tool's configs (phase 17): (inputs, B, C,
# sort8, chains, stack_depth), each bit for bit at T5_CHECK_ITERS
T5_CHECK_ITERS = 64
T5_CHECKS = (("hitting", 2048, 512, True, 4, 32),
             ("hitting", 1000, 128, True, 2, 1),
             ("ties", 2048, 128, True, 1, 24),
             ("ties", 2048, 512, True, 2, 32),
             ("ties", 1000, 128, False, 4, 1),
             ("ties", 2048, 128, True, 1, 1))
# Phase 18: par/ on gloo ranks that share the card (NCCL refuses two
# ranks on one card), a ray count they do not divide, and the plain
# wavefront's time past which the traversal check takes every 4th ray
PAR_RANKS = 2
PAR_ODD_RAYS = SIDE * SIDE - 3
PAR_WAVEFRONT_BUDGET_S = 60.0
HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
DEV = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    from bvh_tpu_torch.tools.timing import device_line

    return device_line("cuda")


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def same(a, b) -> bool:
    """Bitwise equality of two tensors or tuples of tensors (so -0 and
    NaN payloads count too)."""
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and bool(torch.equal(bits(a), bits(b)))
    return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))


def same_tree(a, b) -> bool:
    return (a.node_count == b.node_count and a.prim_count == b.prim_count
            and same((a.bounds, a.index, a.prim_ids),
                     (b.bounds, b.index, b.prim_ids)))


def time_ms(fn, n: int) -> tuple[float, object]:
    """Mean ms per call of `fn` over n calls after one warm-up, timed
    with CUDA events; returns the last call's output too."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, out


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take (ms): the larger of the bytes
    over the memory rate and the operations over the float32 rate."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = ops / PEAK_F32_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def b3_work(nbi, cnt, NCAP: int, min_leaf: int) -> dict:
    """From B3's node table: the levels of the deepest group (the
    iterations of the level-synchronous plain version), the open nodes
    (more than min_leaf lanes: binned and swept) and their lanes, the
    lanes of the nodes that split (partitioned), over all groups, and the
    float operations they take (`OPS_*` above)."""
    G = cnt.numel()
    rows = nbi.view(8, G, NCAP).long()
    size, child = rows[1] - rows[0], rows[2]
    slot = torch.arange(NCAP, device=nbi.device)[None, :]
    live = slot < cnt.long()[:, None]
    opn = live & (size > min_leaf)
    level = torch.full((G, NCAP), -1, dtype=torch.long, device=nbi.device)
    level[:, 0] = 0
    depth = 0
    while True:
        g, s_ = torch.nonzero((level == depth) & live & (child >= 0),
                              as_tuple=True)
        if g.numel() == 0:
            break
        level[g, child[g, s_]] = depth + 1
        level[g, child[g, s_] + 1] = depth + 1
        depth += 1
    nodes, lanes = int(opn.sum()), int(size[opn].sum())
    split_lanes = int(size[live & (child >= 0)].sum())
    return dict(levels=depth + 1, open_nodes=nodes, lanes=lanes,
                split_lanes=split_lanes,
                ops=lanes * OPS_BIN_LANE + split_lanes * OPS_PART_LANE
                + nodes * OPS_SWEEP_NODE)


def bfs_plain(pf, plan, b3_kw: dict):
    """The plain version of B3's bfs variant on the card: the plain
    build, then the queue row (`group_kernel.bfs_queue_row`)."""
    from bvh_tpu_torch.build import group_kernel as gk

    out = gk.group_forest_build_ref(pf, plan.counts, **b3_kw)
    gk.bfs_queue_row(out[1], plan.G, plan.NCAP, b3_kw["min_leaf"])
    return out


def bfs_queue_plain(nbi, G: int, NCAP: int, min_leaf: int):
    """(`nbi` with row 3 replayed as the BFS kernel writes it, the
    queue entries over all groups) (bvh_tpu/build/group_kernel.py:
    133-134, 141-148, 360-368), group by group on the host: the root is
    queued if it holds more than min_leaf prims; each popped slot that
    split (row 2 >= 0) queues those of its two children that do; the
    rest of the row is zero."""
    rows = nbi.view(8, G, NCAP).cpu().numpy().copy()
    total = 0
    for g in range(G):
        b, e, child = rows[0, g], rows[1, g], rows[2, g]
        queue = [0] if e[0] - b[0] > min_leaf else []
        head = 0
        while head < len(queue):
            c = child[queue[head]]
            head += 1
            if c >= 0:
                queue += [s for s in (c, c + 1) if e[s] - b[s] > min_leaf]
        rows[3, g] = 0
        rows[3, g, :len(queue)] = queue
        total += len(queue)
    return torch.from_numpy(rows.reshape(8, G * NCAP)).to(nbi.device), total


class ColumnMarks:
    """Stands in for the [T, 64, P] table given to B1's plain version
    (`traverse_pairs_ref`), which reads only `shape` and
    `reshape(-1)[offsets]` with [64, L] offsets, row 0's first: marks the
    (treelet, column) that row 0's offsets name at each step."""

    def __init__(self, table):
        self.shape, self.flat = table.shape, table.reshape(-1)
        self.seen = torch.zeros(self.flat.numel(), dtype=torch.bool,
                                device=table.device)

    def reshape(self, *_):
        return self

    def __getitem__(self, off):
        self.seen[off[0]] = True
        return self.flat[off]


def visited_bytes(table_cols, tid, rays, out, **kw) -> int:
    """The bytes of the table columns that B1's traversal of these pairs
    visits, each counted once: the plain version, run on the pairs that
    are active at their first step (a finished pair re-reads a column it
    visited), marks them. `out` is B1's output on all the pairs, which
    the marked run must reproduce on its pairs."""
    from bvh_tpu_torch.traverse import wide_treelet as wt

    act = (tid >= 0) & (rays[6] <= rays[7])
    marks = ColumnMarks(table_cols.transpose(1, 2))
    got = wt.traverse_pairs_ref(marks, tid[act], rays[:, act].contiguous(),
                                **kw)
    if not same(got, tuple(o[:, act] for o in out)):
        raise AssertionError("the column-marking run diverged from B1")
    return int(marks.seen.sum()) * wt.ROWS * table_cols.element_size()


class RowMarks:
    """Stands in for a table that a plain version reads by a tensor index
    (`t[k]`; `t[s, :, col]` for B4's [S, 16, Ps] super tables): marks
    the rows that each read names, `row_of(index)`, and counts the rows
    read; an index for which `row_of` gives None passes unmarked."""

    def __init__(self, table, n_rows: int, row_of):
        self.table, self.shape, self.row_of = table, table.shape, row_of
        self.seen = torch.zeros(n_rows, dtype=torch.bool,
                                device=table.device)
        self.reads = 0

    def __getitem__(self, index):
        rows = self.row_of(index)
        if rows is not None:
            self.seen[rows] = True
            self.reads += rows.numel()
        return self.table[index]


def by_tensor(index):
    return index if isinstance(index, torch.Tensor) else None


def b5_work(tables, packed, out, **kw) -> dict:
    """B5's work on these rays, from a run of its plain version on the
    rays that start active (an inactive ray reads nothing) with the
    tables' reads marked, which must reproduce the kernel's output
    `out` on them: the distinct pair rows and triangle rows the steps
    visit, the inner steps and the triangle tests."""
    from bvh_tpu_torch.traverse import binary_kernel as bk

    act = packed[6] <= packed[7]
    pm = RowMarks(tables.pairs, tables.pairs.shape[0], by_tensor)
    tm = RowMarks(tables.tris, tables.tris.shape[0], by_tensor)
    got = bk.binary_traverse_ref(bk.BinaryTables(pm, tm, tables.root_word),
                                 packed[:, act].contiguous(), **kw)
    if not same(got, tuple(o[:, act] for o in out)):
        raise AssertionError("the row-marking run diverged from B5")
    return dict(pair_rows=int(pm.seen.sum()), tri_rows=int(tm.seen.sum()),
                inner=int(out[1][1].sum()), leaves=int(out[1][2].sum()),
                tests=tm.reads)


def b5_bound(packed, out, work) -> tuple[float, str]:
    """B5's bound: the rays and outputs once, the pair rows (boxes and
    words, 56 bytes; not their padding) and triangle rows (48 bytes)
    that the steps visit once each; a slab test of two boxes an inner
    step and a Möller–Trumbore test a triangle test."""
    return bound(nbytes(packed, *out) + 56 * work["pair_rows"]
                 + 48 * work["tri_rows"],
                 2 * OPS_BOX * work["inner"] + OPS_TRI * work["tests"])


def b4_bound(sup_cols, sid, rays, out, **kw) -> tuple[float, str, dict]:
    """B4's bound: its pairs' rays, sids and outputs once, and the
    distinct (super, col) rows (14 floats, 56 bytes; not their padding)
    that the pairs visit, marked in a run of the plain version on the
    pairs that start active (a finished pair re-reads a row it visited,
    an inactive one the root's), which must reproduce the kernel's
    output `out` on them; OPS_PORTAL a recorded portal. Also returns the
    rows visited, the steps of the longest walk and the active pairs."""
    from bvh_tpu_torch.traverse import collect as col

    S, Ps, _ = sup_cols.shape
    act = rays[6] <= rays[7]
    marks = RowMarks(sup_cols.transpose(1, 2), S * Ps,
                     lambda index: index[0] * Ps + index[2])
    got = col.collect_super_pairs_ref(marks, sid[act].contiguous(),
                                      rays[:, act].contiguous(), **kw)
    if not same(got, tuple(o[:, act] for o in out)):
        raise AssertionError("the row-marking run diverged from B4")
    rows = int(marks.seen.sum())
    ms, by = bound(nbytes(sid, rays, *out) + 56 * rows,
                   OPS_PORTAL * int(out[2][0].sum()))
    # the plain version reads a row for every pair each step, so its
    # steps, the longest walk's, are its reads over its pairs
    return ms, by, dict(rows=rows, longest_walk=marks.reads // max(
        1, int(act.sum())), active_pairs=int(act.sum()))


def device_ms(fn, ref) -> float:
    """The device's own time of `fn`: the median of 21 calls, each queued
    behind a head start (`timing.time_calls(..., queued=True)`), the
    last call's output guarded against `ref`."""
    from bvh_tpu_torch.tools import timing

    return timing.timed("device time", fn, ref, "cuda", n=21, queued=True)


def tree_checks(bvh, n: int) -> dict:
    """The tree's invariants, computed on the card."""
    from bvh_tpu_torch.build.sah import node_half_area

    nc = bvh.node_count
    index, bounds = bvh.index[:nc], bvh.bounds[:nc]
    dev = index.device
    leaf = (index & 15) != 0
    first, count = index[leaf] >> 4, index[leaf] & 15
    order = torch.argsort(first)
    f, e = first[order], (first + count)[order]
    inner = torch.nonzero(~leaf).squeeze(1)
    l = index[inner] >> 4
    merged = torch.stack([torch.minimum(bounds[l, 0::2], bounds[l + 1, 0::2]),
                          torch.maximum(bounds[l, 1::2], bounds[l + 1, 1::2])],
                         -1).reshape(-1, bounds.shape[1])
    return dict(
        nodes=nc,
        prims_once=bool(torch.equal(torch.sort(bvh.prim_ids[:n]).values,
                                    torch.arange(n, device=dev))),
        leaves_tile=bool(int(f[0]) == 0 and torch.equal(f[1:], e[:-1])
                         and int(e[-1]) == n),
        pairs_ok=bool(((l % 2) == 1).all() and (l + 1 < nc).all()),
        inner_exact=bool(torch.equal(bounds[inner], merged)),
        half_area=float(node_half_area(bounds[1:]).double().sum()),
    )


def cli_args(argv, **overrides):
    """The CLI's parsed arguments, with fields set past the parser (a
    camera given as floats)."""
    from bvh_tpu_torch.cli import benchmark as cli

    args = cli.parser().parse_args(argv)
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def cornell_cli_phase() -> dict:
    """Phase 11 (a): the CLI on the golden Cornell box through B5."""
    from bvh_tpu_torch import kernels
    from bvh_tpu_torch.cli import benchmark as cli
    from bvh_tpu_torch.io.obj import load_obj
    from bvh_tpu_torch.io.ppm import save_ppm
    from bvh_tpu_torch.traverse import binary_kernel as bk
    from bvh_tpu_torch.traverse import wide_treelet as wt
    from bvh_tpu_torch.traverse.stack import required_stack_depth

    obj = os.path.join(HERE, "tests", "golden", "cornell.obj")
    out = dict(launches=0, err=0.0)
    for q in ("low", "med", "high"):
        ppm = os.path.join(OUT_DIR, f"cornell_{q}.ppm")
        args = cli_args([obj, "--eye", "0", "1", "2", "--dir", "0", "0",
                         "-1", "--up", "0", "1", "0", "-p",
                         "--robust-traversal", "-q", q, "-w", str(SIDE),
                         "--height", str(SIDE), "-o", ppm])
        p0, p1, p2 = load_obj(args.input_model)
        log(f"# CLI, Cornell box, -q {q}: Loaded file with {len(p0)} "
            f"triangle(s)")
        kernels.reset_launch_counts()
        res = cli.run(p0, p1, p2, args)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels.KERNELS}
        log(f"# CLI -q {q}: path {res.path}, launches {launches}, build "
            f"{res.build_s * 1e3:.3f} ms, render {res.render_s * 1e3:.3f} "
            f"ms (CUDA events)")
        if (res.path != "binary" or launches["binary_traverse"] == 0
                or launches["collect_portals"] or launches["traverse_pairs"]):
            raise AssertionError(f"the CLI on the Cornell box must run B5 "
                                 f"alone: {res.path}, {launches}")
        out["launches"] += launches["binary_traverse"]

        # B5 against its plain version on every ray, the CLI's hits too
        tables = bk.make_tables(res.bvh, res.flat, permuted=True)
        packed = wt.pack_rays(res.rays)
        kw = dict(any_hit=False, robust=True,
                  stack_depth=max(16, required_stack_depth(res.bvh)))
        kf, ki = bk.binary_traverse(tables, packed, **kw)
        pf, pi = bk.binary_traverse_ref(tables, packed, **kw)
        fin = torch.isfinite(pf[0])
        if fin.any():
            out["err"] = max(out["err"], float(
                (kf[0][fin] - pf[0][fin]).abs().max()))
        ray_diff = ((bits(kf) != bits(pf)).any(0)
                    | (ki != pi).any(0)).sum()
        hit_t = torch.where(res.hit.hit, res.hit.t, float("inf"))
        log(f"# B5 vs plain, Cornell -q {q}, {packed.shape[1]} rays: "
            f"{int(ray_diff)} rays differ; steps {int(ki[1].sum())} inner, "
            f"{int(ki[2].sum())} leaves; CLI hits == kernel: "
            f"{same(hit_t, kf[0])}")
        if not (same(kf, pf) and same(ki, pi) and same(hit_t, kf[0])):
            raise AssertionError(f"B5 and its plain version differ ({q})")
        plain_hit = bk.pallas_intersect_tris(
            res.bvh, res.flat, res.rays, robust=True, permuted=True,
            traverse=bk.binary_traverse_ref)
        plain_ppm = os.path.join(OUT_DIR, f"cornell_{q}_plain.ppm")
        save_ppm(plain_ppm, cli.image_for(plain_hit, res.flat, res.rays,
                                          args))
        with open(ppm, "rb") as a, open(plain_ppm, "rb") as b:
            ppm_same = a.read() == b.read()
        n_hits = int(res.hit.hit.sum())
        log(f"# Cornell -q {q}: {n_hits} intersection(s) (C++ reference "
            f"{CORNELL_HITS}); PPM equal to the plain version's: {ppm_same}")
        if not ppm_same or n_hits != CORNELL_HITS:
            raise AssertionError(f"Cornell -q {q}: PPM or hit count wrong")

    # B5's times at the CLI's shapes (the -q high run): the device's own
    # time, and the host loop through the wrapper
    def b5():
        return bk.binary_traverse(tables, packed, **kw)

    out["ms"] = device_ms(b5, (kf, ki))
    out["host_loop_ms"], last = time_ms(b5, 20)
    out["plain_ms"], plast = time_ms(lambda: bk.binary_traverse_ref(
        tables, packed, **kw), 2)
    if not (same(last, (kf, ki)) and same(plast, (kf, ki))):
        raise AssertionError("timed B5 output diverged")
    out["work"] = b5_work(tables, packed, (kf, ki), **kw)
    out["bound_ms"], out["bound_by"] = b5_bound(packed, (kf, ki),
                                                out["work"])
    log(f"# B5, Cornell, {packed.shape[1]} rays: kernel {out['ms']:.4f} ms "
        f"(the device's own time; host loop {out['host_loop_ms']:.4f} ms), "
        f"plain {out['plain_ms']:.3f} ms, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}); work {out['work']}")
    return out


def b5_full_phase(tree, flat, rays, whit, tl) -> dict:
    """Phase 12 (b): B5 on the 262K tree with every primary ray, fast and
    robust, through its entry point and against its plain version and
    the wide-treelet render; its times, bound and diagnostics."""
    from bvh_tpu_torch import kernels
    from bvh_tpu_torch.traverse import binary_kernel as bk
    from bvh_tpu_torch.traverse import wide_treelet as wt
    from bvh_tpu_torch.traverse.stack import required_stack_depth
    from bvh_tpu_torch.traverse.wavefront import hit_from

    tables = bk.make_tables(tree, flat)
    packed = wt.pack_rays(rays)
    psub = packed[:, ::SUBSET].contiguous()
    sd = required_stack_depth(tree)
    out = dict(launches=0)
    for robust in (False, True):
        kw = dict(any_hit=False, robust=robust, stack_depth=sd)
        kernels.reset_launch_counts()
        eh = bk.pallas_intersect_tris(tree, flat, rays, robust=robust,
                                      stack_depth=sd)
        sync()
        out["launches"] += kernels.BINARY_TRAVERSE.launches
        kf, ki = bk.binary_traverse(tables, packed, **kw)
        pf, pi = bk.binary_traverse_ref(tables, psub, **kw)
        sub_same = same(kf[:, ::SUBSET].contiguous(), pf) and same(
            ki[:, ::SUBSET].contiguous(), pi)
        i64 = ki.to(torch.int64)
        bh = hit_from(tree, kf[0], kf[1], kf[2], i64[0], i64[1], i64[2])
        entry_same = all(same(getattr(eh, f), getattr(bh, f)) for f in (
            "t", "u", "v", "prim_pos", "prim_id"))
        wh = whit if not robust else wt.wide_treelet_intersect_tris(
            tl, rays, tree.prim_ids, robust=True)
        hb, hw = torch.isfinite(bh.t), torch.isfinite(wh.t)
        both = hb & hw
        t_diff = both & (bits(bh.t) != bits(wh.t))
        res = dict(hits=int(hb.sum()), wide_hits=int(hw.sum()),
                   mask_flips=int((hb != hw).sum()), t_differs=int(t_diff.sum()),
                   prim_id_ties=int((both & ~t_diff
                                     & (bh.prim_id != wh.prim_id)).sum()),
                   subset_bitwise=sub_same, entry_point_equal=entry_same,
                   overflow=bool(ki[3].any()), stack_depth=sd)
        form = "robust" if robust else "fast"
        log(f"# B5 on the 262K tree, {form}, {packed.shape[1]} rays: {res}")
        if (not sub_same or not entry_same or res["overflow"]
                or res["mask_flips"] + res["t_differs"] > EDGE_BUDGET):
            raise AssertionError(f"B5 on the 262K tree ({form}) disagrees")
        if robust:
            continue
        out["hit"] = bh

        def b5():
            return bk.binary_traverse(tables, packed, **kw)

        out["ms"] = device_ms(b5, (kf, ki))
        out["host_loop_ms"], last = time_ms(b5, 10)
        out["plain_ms"], plast = time_ms(lambda: bk.binary_traverse_ref(
            tables, packed, **kw), 1)
        if not (same(last, (kf, ki)) and same(plast, (kf, ki))):
            raise AssertionError("timed B5 output diverged")
        work = b5_work(tables, packed, (kf, ki), **kw)
        out["bound_ms"], out["bound_by"] = b5_bound(packed, (kf, ki), work)
        # diagnostics, as phase 14's for B6
        steps = torch.zeros(2, dtype=torch.int64, device=DEV)
        if not same(bk.binary_traverse(tables, packed, steps=steps, **kw),
                    (kf, ki)):
            raise AssertionError("B5 with SIMT counts diverged")
        out["diag"] = dict(
            work, ns_per_step=out["ms"] * 1e6 / (work["inner"]
                                                 + work["leaves"]),
            simt_kernel=int(steps[0]) / (32 * int(steps[1])),
            lane_steps=int(steps[0]), warp_steps=int(steps[1]),
            simt_one_ray_a_lane=simt_by_groups(ki),
            warps_per_sm=kernels.binary_traverse_occupancy(),
            ptxas=walk_ptxas("TriLeaf"))
        log(f"# B5 on the 262K tree, fast: {out['ms']:.4f} ms per 1,048,576 "
            f"rays (the device's own time; host loop "
            f"{out['host_loop_ms']:.4f} ms), plain {out['plain_ms']:.3f} ms "
            f"(every ray, equal to the kernel's); bound "
            f"{out['bound_ms']:.4f} ms ({out['bound_by']}); diagnostics "
            f"{out['diag']}")
    log(f"# B5 launches through pallas_intersect_tris on the 262K tree: "
        f"{out['launches']}")
    if out["launches"] != 2:
        raise AssertionError("the entry point did not launch B5 once a form")
    return out


def first_a2_round(tl, packed):
    """The (ray, super) pairs of the render's first A2 round, as
    `expand_supers` hands them to B4 (phase A with the render's caps,
    closest hit, fast slab): {"sid", "rays", "kw"}, and phase A's
    portals."""
    from bvh_tpu_torch.traverse import collect as col
    from bvh_tpu_torch.traverse import wide_treelet as wt

    caps = wt.wide_treelet_caps(tl, wt.portals_per_round(tl))
    portals = wt.collect_and_sort(tl, packed, robust=False,
                                  top_stack=tl.top_depth + 1,
                                  max_portals=caps["max_portals"],
                                  mps=caps["mps"])
    first = {}

    def recorder(sup_cols, sid, prays, **kw):
        if not first:
            first.update(sid=sid, rays=prays, kw=kw)
        return col.collect_super_pairs(sup_cols, sid, prays, **kw)

    wt.expand_supers(tl, portals, packed[:, portals.sel], robust=False,
                     sup_stack=tl.sup_depth + 1, mps=caps["mps"],
                     max_new=caps["max_new"], max_portals=caps["max_portals"],
                     collect_super=recorder)
    return first, portals


def two_level_phase() -> dict:
    """Phase 13 (c): the CLI's run on the San-Miguel-class scene; the
    two-level render through B4."""
    from bvh_tpu_torch import kernels
    from bvh_tpu_torch.build import group_kernel as gk
    from bvh_tpu_torch.build import minitree_fast as mtf
    from bvh_tpu_torch.build.default import (
        DefaultConfig,
        Quality,
        _mini_tree_config,
    )
    from bvh_tpu_torch.build.reinsertion import optimize_reinsertion
    from bvh_tpu_torch.cli import benchmark as cli
    from bvh_tpu_torch.core.ray import Ray
    from bvh_tpu_torch.geom.tri import Tri
    from bvh_tpu_torch.io.scenes import scene_camera, sponza_class
    from bvh_tpu_torch.traverse import collect as col
    from bvh_tpu_torch.traverse import wide_treelet as wt

    t0 = time.perf_counter()
    tris = sponza_class(N_BIG, seed=0)
    eye, d, up = scene_camera(tris)
    log(f"# San-Miguel-class scene: {len(tris)} triangles made in "
        f"{time.perf_counter() - t0:.1f} s")
    args = cli_args(["sponza_class.obj", "-q", "high", "-w", str(SIDE),
                     "--height", str(SIDE), "-o",
                     os.path.join(OUT_DIR, "sanmiguel_class.ppm")],
                    eye=[float(x) for x in eye], dir=[float(x) for x in d],
                    up=[float(x) for x in up])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = cli.run(tris[:, 0], tris[:, 1], tris[:, 2], args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    tl = res.tl
    T, _, P = tl.table.shape
    S, Ps, _ = tl.sup_cols.shape
    log(f"# CLI run, San-Miguel class: path {res.path}, {res.bvh.node_count} "
        f"nodes; T={T} S={S} P={P} Ps={Ps} sup_depth={tl.sup_depth} "
        f"top_depth={tl.top_depth} wide_depth={tl.wide_depth}; launches "
        f"{launches}; build {res.build_s * 1e3:.3f} ms, build_wide_treelets "
        f"{res.treelets_s * 1e3:.3f} ms, render {res.render_s * 1e3:.3f} ms "
        f"(CUDA events); {wall:.1f} s in all")
    if res.path != "wide_treelet" or S == 0:
        raise AssertionError("the San-Miguel-class scene must take the "
                             "two-level wide-treelet render")
    for k in ("group_build", "collect_portals", "collect_super_pairs",
              "traverse_pairs"):
        if launches[k] == 0:
            raise AssertionError(f"phase c never launched {k}")
    R = SIDE * SIDE
    n_hits = int(res.hit.hit.sum())
    log(f"# San-Miguel class: {n_hits} hits of {R} rays (C++ oracle "
        f"{BIG_ORACLE_HITS})")
    if abs(n_hits - BIG_ORACLE_HITS) > 4 * R // 1_000_000:
        raise AssertionError("the two-level render's hit count is off")

    # B4 against its plain version on every pair of the first A2 round
    first, portals = first_a2_round(tl, wt.pack_rays(res.rays))
    args4 = (tl.sup_cols, first["sid"], first["rays"])
    k_out = col.collect_super_pairs(*args4, **first["kw"])
    p_out = col.collect_super_pairs_ref(tl.sup_table, first["sid"],
                                        first["rays"], **first["kw"])
    L = first["sid"].numel()
    fin = torch.isfinite(p_out[1])
    err = float((k_out[1][fin] - p_out[1][fin]).abs().max()) if fin.any() \
        else 0.0
    log(f"# B4 collect_super_pairs vs plain, first A2 round, {L} pairs of "
        f"{portals.sel.numel()} rays: equal bit for bit {same(k_out, p_out)}; "
        f"treelet portals per pair up to {int(k_out[2][0].max())} (max_new "
        f"{first['kw']['max_new']}), stack hwm {int(k_out[2][1].max())} "
        f"(sup_stack {first['kw']['stack_depth']})")
    if not same(k_out, p_out):
        raise AssertionError("B4 and its plain version differ")

    # the render against the plain-version driver on every 16th ray
    sub = slice(None, None, SUBSET)
    r = res.rays
    ph = wt._intersect(tl, Ray(r.org[sub], r.dir[sub], r.tmin[sub],
                               r.tmax[sub]), res.bvh.prim_ids,
                       col.collect_portals_ref, wt.traverse_pairs_plain,
                       collect_super=col.collect_super_pairs_plain)
    d_ = {f: int((bits(getattr(res.hit, f)[sub]) != bits(getattr(ph, f)))
                 .sum()) for f in ("t", "prim_pos")}
    log(f"# San-Miguel class render vs plain render on every {SUBSET}th ray "
        f"({ph.t.numel()} rays): differing rays per field {d_}")
    if any(d_.values()):
        raise AssertionError("two-level render: kernels and plain versions "
                             "disagree")

    # times: B4 at the first round's shapes (the device's own time, and
    # the host loop through the wrapper), the build stage by stage
    out = dict(launches=launches, err=err, pairs=L)

    def b4():
        return col.collect_super_pairs(*args4, **first["kw"])

    out["ms"] = device_ms(b4, k_out)
    out["host_loop_ms"], last = time_ms(b4, 20)
    out["plain_ms"], plast = time_ms(lambda: col.collect_super_pairs_ref(
        tl.sup_table, first["sid"], first["rays"], **first["kw"]), 2)
    if not (same(last, k_out) and same(plast, k_out)):
        raise AssertionError("timed B4 output diverged")
    out["bound_ms"], out["bound_by"], work = b4_bound(*args4, k_out,
                                                      **first["kw"])
    out["work"] = dict(work, recorded=int(k_out[2][0].sum()))
    log(f"# B4, {L} pairs: kernel {out['ms']:.4f} ms (the device's own "
        f"time; host loop {out['host_loop_ms']:.4f} ms), plain "
        f"{out['plain_ms']:.3f} ms, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}); {work['rows']} of the {S} x {Ps} super rows "
        f"visited, {out['work']['recorded']} portals recorded, the longest "
        f"walk {work['longest_walk']} steps; B4 ptxas "
        f"{kernels.ptxas_figures('collect_pairs_kernel')}")
    dev = res.bvh.bounds.device
    tri = Tri(*(torch.as_tensor(tris[:, i], device=dev) for i in range(3)))
    mn, mx = tri.get_bbox()
    cc = tri.get_center()
    mtc = _mini_tree_config(DefaultConfig(quality=Quality.HIGH))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    plan = mtf.staging_plan(cc, mtc)
    pf, base = mtf.pack_groups(mn, mx, cc, plan)
    ev[1].record()
    cfg = plan.config
    b3 = gk.group_forest_build(pf, plan.counts, dim=3, P=plan.P,
                               NCAP=plan.NCAP, min_leaf=cfg.min_leaf_size,
                               max_leaf=cfg.max_leaf_size,
                               log_cluster=cfg.sah.log_cluster_size,
                               cost_ratio=cfg.sah.cost_ratio)
    ev[2].record()
    pre = mtf.assemble(*b3, base, plan)
    ev[3].record()
    tree = optimize_reinsertion(pre)
    ev[4].record()
    torch.cuda.synchronize()
    stages = {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(
        ("staging", "b3", "assemble", "reinsertion"))}
    stages["total"] = ev[0].elapsed_time(ev[4])
    same_build = (tree.node_count == res.bvh.node_count
                  and same(tree.index, res.bvh.index)
                  and same(tree.prim_ids, res.bvh.prim_ids))
    resident = kernels.group_build_occupancy(plan.P) * \
        torch.cuda.get_device_properties(0).multi_processor_count
    log(f"# San-Miguel class build stage by stage, ms (CUDA events; G="
        f"{plan.G} P={plan.P}, B3 in {-(-plan.G // resident)} waves of "
        f"{resident} groups): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; tree == the CLI's: {same_build}")
    if not same_build:
        raise AssertionError("the staged build differs from the CLI's")

    # T4, the San-Miguel-class profiler, on this scene; B2 at its width
    # against its plain version
    from bvh_tpu_torch.tools import profile_sm

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    t4 = profile_sm.run(tl, res.rays, DEV)
    t4["launches"] = launch_counts()
    a_args, a_kw, a_out = t4["phase_a_args"]
    p_out = col.collect_portals_ref(*a_args, **a_kw)
    fin = torch.isfinite(p_out[1])
    t4["err"] = float((a_out[1][fin] - p_out[1][fin]).abs().max()) \
        if fin.any() else 0.0
    log(f"# T4: B2 at the San-Miguel-class top width equal to its plain "
        f"version: {same(a_out, p_out)}; T4 in "
        f"{time.perf_counter() - t0:.1f} s, launches {t4['launches']}")
    if not same(a_out, p_out):
        raise AssertionError("B2 at the San-Miguel-class width differs from "
                             "its plain version")
    t4["plain_ms"], plast = time_ms(lambda: col.collect_portals_ref(
        *a_args, **a_kw), 1)
    if not same(plast, a_out):
        raise AssertionError("timed B2 plain output diverged")
    pcnt = int(a_out[2][0].sum())
    t4["bound"] = bound(nbytes(a_args[1], *a_out)
                        + min(nbytes(a_args[0]), 56 * pcnt // 2),
                        OPS_PORTAL * pcnt)
    out["t4"] = t4
    # the scene, its tree and tables for phase 19's bench_sanmiguel
    from bvh_tpu_torch.tools.bench_wide import WideScene

    out["scene"] = WideScene(tris, res.bvh, res.flat, res.rays)
    out["tl"] = tl
    return out


def last_tools_phase(sc) -> dict:
    """Phase 20: the last five tools of bvh_tpu_torch/tools/, each through
    its `run` at full width with the launch counts reset before and read
    after, then the driver entry (`bvh_tpu_torch/entry.py`). `sc`: the
    262K scene with phase 5's tree (`bench_wide.WideScene`)."""
    from bvh_tpu_torch import kernels
    from bvh_tpu_torch.entry import dryrun_multichip, entry
    from bvh_tpu_torch.tools import (check_oracle, profile_floor,
                                     profile_floor2, profile_pure,
                                     sweep_chain)

    t_phase = time.perf_counter()
    out, launches, secs = {}, {}, {}

    def tool(name, fn):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        sync()
        secs[name] = time.perf_counter() - t0
        launches[name] = launch_counts()
        out[name] = plain(res)
        log(f"# phase 20, {name}: {secs[name]:.1f} s, launches "
            f"{launches[name]}")
        return res

    tool("profile_floor", lambda: profile_floor.run(device=DEV))
    oracle = tool("check_oracle", lambda: check_oracle.run(
        N_TRIS, SIDE, device=DEV))
    if not oracle["ok"]:
        raise AssertionError("check_oracle: the render differs from the "
                             "native tracer past the budget")
    del oracle
    tool("profile_floor2", lambda: profile_floor2.run(device=DEV))
    pure = tool("profile_pure", lambda: profile_pure.run(
        N_TRIS, SIDE, device=DEV, scene=sc))
    if not (pure["ok"] and pure["hits"] == ORACLE_HITS_REFERENCE_TREE):
        raise AssertionError("profile_pure's hits are not the oracle's")
    del pure
    sweep = tool("sweep_chain", lambda: sweep_chain.run(
        N_TRIS, SIDE, configs="k=4;k=16;max_prims=2048", device=DEV, reps=3,
        scene=sc))
    if not (sweep["ok"]
            and sweep["default"]["hits"] == ORACLE_HITS_REFERENCE_TREE):
        raise AssertionError("sweep_chain: a config's hits differ from the "
                             "default's, or the default's from the oracle")

    def entry_on_card():
        fn, args = entry(device=DEV)
        t, pid = fn(*args)
        fn_c, args_c = entry(device="cpu")
        t_c, pid_c = fn_c(*args_c)
        return dict(rays=t.numel(), hits=int(torch.isfinite(t).sum()),
                    equal_to_cpu=same((t.cpu(), pid.cpu()), (t_c, pid_c)))

    ent = tool("entry", entry_on_card)
    if not ent["equal_to_cpu"]:
        raise AssertionError("entry(): the card's hits differ from the CPU's")
    tool("dryrun_multichip", lambda: dryrun_multichip(PAR_RANKS, DEV))
    total = {}
    for per_tool in launches.values():
        for k, v in per_tool.items():
            total[k] = total.get(k, 0) + v
    for name in ("check_oracle", "profile_pure", "sweep_chain"):
        for k in (kernels.WIDE_TREELET, kernels.COLLECT):
            if not launches[name].get(k.name):
                raise AssertionError(f"phase 20: {name} never launched "
                                     f"{k.name}")
    res = dict(seconds=time.perf_counter() - t_phase, tool_seconds=secs,
               launches=launches, launches_total=total, results=out,
               card=card_line())
    with open(os.path.join(OUT_DIR, "phase20.json"), "w") as f:
        json.dump(res, f, indent=1)
    log(f"# phase 20 on {res['card']} in {res['seconds']:.1f} s; launches "
        f"{total}; results in chiprun_out/phase20.json")
    return res


def sync() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def launch_counts() -> dict:
    """The kernels launched since the counts were last reset."""
    from bvh_tpu_torch import kernels

    return {k.name: k.launches for k in kernels.KERNELS if k.launches}


def events_ms(fn):
    """fn() between two CUDA events; returns (ms, fn's output)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def sphere_rays(rng, n: int, dim: int):
    """tools/bench_dims.py's rays: origins U(-3, 3), towards U(-1, 1)."""
    from bvh_tpu_torch.core.ray import Ray

    org = rng.uniform(-3, 3, (n, dim)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    return Ray.make(torch.from_numpy(org).to(DEV),
                    torch.from_numpy(tgt - org).to(DEV))


def sphere_bound(tables, packed, kf, ki) -> tuple[float, str]:
    """B6's bound from its own step counts: the pair rows' boxes and
    words of its inner steps and one sphere (centre, radius) per leaf
    entered, the rows' padding not counted (lower bounds)."""
    dim = tables.dim
    inner, leaves = int(ki[1].sum()), int(ki[2].sum())
    row, sph = 16 * dim + 8, 4 * (dim + 1)
    fetched = row * inner + sph * leaves
    whole = row * tables.pairs.shape[0] + sph * tables.spheres.shape[0]
    return bound(nbytes(packed, kf, ki) + min(whole, fetched),
                 2 * OPS_BOX_DIM * dim * inner
                 + (OPS_SPHERE + OPS_BOX_DIM * dim) * leaves)


def simt_by_groups(ki) -> float:
    """SIMT efficiency of one ray a lane, from the counts in launch
    order: each group of 32 rays' steps (inner steps + leaves entered)
    over 32 x its largest."""
    steps = (ki[1] + ki[2]).to(torch.int64)
    g = torch.nn.functional.pad(steps, (0, -steps.numel() % 32)).view(-1, 32)
    return float(g.sum()) / float(32 * g.amax(1).sum())


def walk_ptxas(leaf: str) -> dict:
    """ptxas' registers, frame and spills of the walk's instantiations
    whose leaf's mangled name holds `leaf` (B5: "TriLeaf"; B6 at dim d:
    "SphereLeafILi<d>E"), keyed closest/any, fast/robust, with SIMT
    counts or not."""
    from bvh_tpu_torch import kernels

    out = {}
    for name, fig in kernels.ptxas_figures("binary_traverse_kernel").items():
        if leaf not in name:
            continue
        any_hit, robust, counts = re.findall(r"Lb(\d)E", name)[:3]
        key = (("any" if any_hit == "1" else "closest") + "_"
               + ("robust" if robust == "1" else "fast")
               + ("_counts" if counts == "1" else ""))
        out[key] = fig
    return out


def hit_matches_launch(hit, kf, ki) -> bool:
    """The wrapper's Hit (rays launched in coherence order and scattered
    back) against one launch in the caller's order."""
    from bvh_tpu_torch.core.types import INVALID_PRIM_ID

    pos = ki[0].to(torch.int64)
    return same((hit.t, hit.u, hit.v), (kf[0], kf[1], kf[2])) and bool(
        torch.equal(hit.prim_pos, torch.where(pos < 0, INVALID_PRIM_ID, pos)))


def check_b6(name, tables, packed, kw, sub=1):
    """B6 against its plain version on every `sub`th ray, bit for bit in
    t, u, v, position, both counts and the overflow flag."""
    from bvh_tpu_torch.traverse import sphere_kernel as sk

    kf, ki = sk.sphere_traverse(tables, packed, **kw)
    psub = packed[:, ::sub].contiguous()
    pf, pi = sk.sphere_traverse_ref(tables, psub, **kw)
    kfs, kis = kf[:, ::sub].contiguous(), ki[:, ::sub].contiguous()
    fin = torch.isfinite(pf[0])
    err = float((kfs[0][fin] - pf[0][fin]).abs().max()) if fin.any() else 0.0
    diff = int(((bits(kfs) != bits(pf)).any(0) | (kis != pi).any(0)).sum())
    log(f"# B6 vs plain, {name}, {kw}: {psub.shape[1]} rays compared, "
        f"{diff} differ; {int(fin.sum())} hits, {int(ki[1].sum())} inner "
        f"steps, {int(ki[2].sum())} leaves over {packed.shape[1]} rays")
    if diff or not (same(kfs, pf) and same(kis, pi)) or bool(ki[3].any()):
        raise AssertionError(f"B6 and its plain version differ ({name})")
    return kf, ki, err


def dims_phase() -> dict:
    """Phase 14: kernel B6 at dims 2, 3 and 4, at tools/bench_dims.py's
    size and at scale."""
    from bvh_tpu_torch import kernels
    from bvh_tpu_torch.build.binned import build_binned
    from bvh_tpu_torch.build.default import DefaultConfig, Quality, build_default
    from bvh_tpu_torch.core.ray import Ray
    from bvh_tpu_torch.traverse import sphere_kernel as sk
    from bvh_tpu_torch.traverse import wide_treelet as wt
    from bvh_tpu_torch.traverse.stack import required_stack_depth
    from bvh_tpu_torch.traverse.wavefront import make_sphere_leaf_fn, traverse

    out = dict(launches=0, err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
               per_dim={})
    t_phase = time.perf_counter()
    for dim in (2, 3, 4):
        t_dim = time.perf_counter()
        # (a) bench_dims' configuration
        rng = np.random.default_rng(dim)
        c = torch.from_numpy(rng.uniform(-1, 1, (DIMS_M, dim))
                             .astype(np.float32)).to(DEV)
        r = torch.from_numpy(rng.uniform(0.02, 0.1, DIMS_M)
                             .astype(np.float32)).to(DEV)
        bvh = build_binned(c - r[:, None], c + r[:, None], c)
        rays = sphere_rays(rng, DIMS_RAYS, dim)
        kernels.reset_launch_counts()
        hit = sk.pallas_intersect_spheres(bvh, c, r, rays)
        sync()
        n_launch = kernels.SPHERE_TRAVERSE.launches
        out["launches"] += n_launch
        tables = sk.make_tables(bvh, c, r)
        packed = wt.pack_rays(rays)
        sd = max(16, required_stack_depth(bvh))
        kw = dict(any_hit=False, robust=False, stack_depth=sd)
        kf, ki, err = check_b6(f"{dim}D, {DIMS_M} spheres", tables, packed, kw)
        check_b6(f"{dim}D, {DIMS_M} spheres", tables, packed,
                 dict(kw, any_hit=True, robust=True))
        out["err"] = max(out["err"], err)
        ms_a, last = time_ms(lambda: sk.sphere_traverse(tables, packed, **kw),
                             10)
        if not same(last, (kf, ki)):
            raise AssertionError("timed B6 output diverged")
        sub = slice(None, None, SUBSET)
        wf = traverse(bvh, Ray(*(x[sub] for x in rays)),
                      make_sphere_leaf_fn(bvh, c, r), stack_depth=sd)
        t_bits = int((bits(hit.t[sub]) != bits(wf.t)).sum())
        res = dict(launches=n_launch, hits=int(hit.hit.sum()),
                   sorted_equals_unsorted=hit_matches_launch(hit, kf, ki),
                   wavefront_rays=int(wf.t.numel()),
                   mask_equal=bool(torch.equal(hit.hit[sub], wf.hit)),
                   prim_equal=bool(torch.equal(hit.prim_id[sub], wf.prim_id)),
                   t_bits_differ=t_bits)
        log(f"# {dim}D spheres, bench_dims configuration ({DIMS_M} spheres, "
            f"{bvh.node_count} nodes, {DIMS_RAYS} rays): {res}; B6 {ms_a:.3f} "
            f"ms a launch in the caller's order")
        if not (n_launch and res["sorted_equals_unsorted"]
                and res["mask_equal"] and res["prim_equal"]):
            raise AssertionError(f"{dim}D spheres: B6 disagrees")
        if t_bits:
            ok = hit.hit[sub]
            torch.testing.assert_close(hit.t[sub][ok], wf.t[ok], rtol=2e-5,
                                       atol=0)

        # (b) at scale: coverage as in (a)
        scale = (DIMS_M / SCALE_M) ** (1.0 / dim)
        rng = np.random.default_rng(100 + dim)
        cb = torch.from_numpy(rng.uniform(-1, 1, (SCALE_M, dim))
                              .astype(np.float32)).to(DEV)
        rb = torch.from_numpy((rng.uniform(0.02, 0.1, SCALE_M) * scale)
                              .astype(np.float32)).to(DEV)
        kernels.reset_launch_counts()
        build_ms, tb = events_ms(lambda: build_default(
            cb - rb[:, None], cb + rb[:, None], cb,
            DefaultConfig(quality=Quality.MEDIUM)))
        b3 = kernels.GROUP_BUILD.launches
        inv = tree_checks(tb, SCALE_M)
        log(f"# {dim}D, {SCALE_M} spheres: build_default(MEDIUM) {build_ms:.3f}"
            f" ms (CUDA events, first use), B3 launches {b3}; {inv}")
        if not (inv["prims_once"] and inv["leaves_tile"] and inv["pairs_ok"]
                and inv["inner_exact"]) or (b3 > 0) != (dim == 3):
            raise AssertionError(f"{dim}D scale tree breaks an invariant")
        rays = sphere_rays(rng, SCALE_RAYS, dim)
        kernels.reset_launch_counts()
        hit = sk.pallas_intersect_spheres(tb, cb, rb, rays)
        sync()
        n_launch = kernels.SPHERE_TRAVERSE.launches
        out["launches"] += n_launch
        tables = sk.make_tables(tb, cb, rb)
        packed = wt.pack_rays(rays)
        kw = dict(any_hit=False, robust=False,
                  stack_depth=max(16, required_stack_depth(tb)))
        kf, ki, err = check_b6(f"{dim}D, {SCALE_M} spheres", tables, packed,
                               kw, sub=SUBSET)
        out["err"] = max(out["err"], err)
        if not (n_launch and hit_matches_launch(hit, kf, ki)):
            raise AssertionError(f"{dim}D scale: the main path disagrees")
        order = sk.coherence_order(rays.org, rays.dir)
        spacked = packed[:, order].contiguous()
        ms, last = time_ms(lambda: sk.sphere_traverse(tables, spacked, **kw),
                           10)
        ms_unsorted, last_u = time_ms(lambda: sk.sphere_traverse(
            tables, packed, **kw), 10)
        plain_ms, plast = time_ms(lambda: sk.sphere_traverse_ref(
            tables, packed, **kw), 1)
        if not (same(last, (kf[:, order], ki[:, order]))
                and same(last_u, (kf, ki)) and same(plast, (kf, ki))):
            raise AssertionError("timed B6 output diverged")
        b_ms, b_by = sphere_bound(tables, packed, kf, ki)
        out["ms"] += ms
        out["plain_ms"] += plain_ms
        out["bound_ms"] += b_ms
        out["bound_by"] = b_by
        # diagnostics: ns a step, SIMT efficiency (one ray a lane in
        # launch order, from the counts; and the kernel's own lanes' and
        # warps' steps in the same launch), occupancy and ptxas
        steps = torch.zeros(2, dtype=torch.int64, device=DEV)
        if not same(sk.sphere_traverse(tables, spacked, steps=steps, **kw),
                    last):
            raise AssertionError("B6 with SIMT counts diverged")
        inner, leaves = int(ki[1].sum()), int(ki[2].sum())
        diag = dict(
            ms=ms, ms_unsorted=ms_unsorted, bound_ms=b_ms,
            inner_steps=inner, leaves=leaves,
            ns_per_step=ms * 1e6 / (inner + leaves),
            simt_one_ray_a_lane=simt_by_groups(ki[:, order]),
            simt_one_ray_a_lane_unsorted=simt_by_groups(ki),
            simt_kernel=int(steps[0]) / (32 * int(steps[1])),
            lane_steps=int(steps[0]), warp_steps=int(steps[1]),
            warps_per_sm=kernels.sphere_traverse_occupancy(dim),
            ptxas=walk_ptxas(f"SphereLeafILi{dim}E"))
        out["per_dim"][dim] = diag
        log(f"# B6, {dim}D, {SCALE_M} spheres, {SCALE_RAYS} rays: kernel "
            f"{ms:.3f} ms in coherence order ({ms_unsorted:.3f} ms unsorted), "
            f"{SCALE_RAYS / ms / 1e3:.3f} Mrays/s; plain {plain_ms:.3f} ms "
            f"(every ray, equal to the kernel's); "
            f"bound {b_ms:.4f} ms ({b_by}); {int(hit.hit.sum())} hits; "
            f"launches {n_launch}; phase {time.perf_counter() - t_dim:.1f} s")
        log(f"# B6, {dim}D diagnostics: {inner} inner steps + {leaves} leaves"
            f", {diag['ns_per_step']:.4f} ns a step; SIMT efficiency "
            f"{diag['simt_kernel']:.4f} (the kernel's lanes' over its warps'"
            f" steps, {diag['lane_steps']} / 32 x {diag['warp_steps']}), "
            f"{diag['simt_one_ray_a_lane']:.4f} for one ray a lane in launch "
            f"order ({diag['simt_one_ray_a_lane_unsorted']:.4f} unsorted; "
            f"inner steps + leaves, groups of 32); {diag['warps_per_sm']} "
            f"warps an SM; ptxas {diag['ptxas']}")
    log(f"# phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return out


def brute_min_t(flat, rays, chunk: int = 8):
    """Each ray's closest t over every triangle, by the leaf test
    (Möller–Trumbore) on all of them."""
    from bvh_tpu_torch.core.ray import Ray
    from bvh_tpu_torch.geom.tri import PrecomputedTri

    tri = PrecomputedTri.from_flat(flat[None])
    one = torch.ones((1, 1), dtype=flat.dtype, device=flat.device)
    best = []
    for a in range(0, rays.org.shape[0], chunk):
        ray = Ray(rays.org[a:a + chunk, None], rays.dir[a:a + chunk, None],
                  rays.tmin[a:a + chunk, None] * one,
                  rays.tmax[a:a + chunk, None] * one)
        t, _, _, hit = tri.intersect(ray)
        best.append(torch.where(hit, t, float("inf")).amin(1))
    return torch.cat(best)


def check_closest(name, bvh, flat, rays, t) -> dict:
    """The closest t of every F64_CHECK-th ray against the brute-force
    minimum; a differing ray must be a fast-slab cull (the robust
    traversal finds the minimum, the fast one a later hit or none)."""
    from bvh_tpu_torch.core.ray import Ray
    from bvh_tpu_torch.traverse.wavefront import intersect_tris

    sub = slice(None, None, F64_CHECK)
    rs = Ray(*(x[sub] for x in rays))
    want = brute_min_t(flat, rs)
    got = t[sub]
    off = torch.nonzero(got != want).squeeze(1)
    res = dict(rays=int(want.numel()), hits=int(torch.isfinite(want).sum()),
               differ=int(off.numel()))
    if off.numel():
        rob = intersect_tris(bvh, flat, Ray(*(x[off] for x in rs)),
                             robust=True).t
        res["culls"] = bool(torch.equal(rob, want[off])
                            and (got[off] > want[off]).all())
    log(f"# {name}: closest t of every {F64_CHECK}th ray vs the brute-force "
        f"minimum over all {flat.shape[0]} triangles: {res}")
    if off.numel() > EDGE_BUDGET or not res.get("culls", True):
        raise AssertionError(f"{name}: closest hits wrong")
    return res


def f64_tris(rng, m: int, edge: float):
    from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri

    pts = rng.uniform(-1, 1, (m, 3))
    e1 = rng.uniform(-edge, edge, (m, 3))
    e2 = rng.uniform(-edge, edge, (m, 3))
    t = torch.from_numpy(np.stack([pts, pts + e1, pts + e2], 1)).to(DEV)
    tri = Tri(t[:, 0], t[:, 1], t[:, 2])
    mn, mx = tri.get_bbox()
    return mn, mx, tri.get_center(), PrecomputedTri.from_tri(tri).as_flat()


def f64_rays(rng, n: int):
    from bvh_tpu_torch.core.ray import Ray

    org = torch.from_numpy(rng.uniform(-3, 3, (n, 3))).to(DEV)
    tgt = torch.from_numpy(rng.uniform(-1, 1, (n, 3))).to(DEV)
    return Ray.make(org, tgt - org)


def f64_phase() -> None:
    """Phase 15: float64 triangles through the wavefront, at
    tools/bench_dims.py's size and at scale through build_minitree."""
    from bvh_tpu_torch.build.binned import build_binned
    from bvh_tpu_torch.build.default import DefaultConfig, Quality, build_default
    from bvh_tpu_torch.traverse.wavefront import intersect_tris

    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    mn, mx, cc, flat = f64_tris(rng, F64_M, 0.08)
    bvh = build_binned(mn, mx, cc)
    rays = f64_rays(rng, F64_RAYS)
    ms, hit = events_ms(lambda: intersect_tris(bvh, flat, rays))
    log(f"# f64, bench_dims' {F64_M} triangles, {F64_RAYS} rays: wavefront "
        f"{ms:.3f} ms (CUDA events), {int(hit.hit.sum())} hits, t "
        f"{hit.t.dtype}, tree {bvh.bounds.dtype}")
    if hit.t.dtype != torch.float64 or bvh.bounds.dtype != torch.float64:
        raise AssertionError("the f64 path lost its precision")
    check_closest("f64 bench_dims", bvh, flat, rays, hit.t)

    rng = np.random.default_rng(8)
    edge = 0.08 * (F64_M / F64_BIG) ** (1.0 / 3.0)
    mn, mx, cc, flat = f64_tris(rng, F64_BIG, edge)
    build_ms, tb = events_ms(lambda: build_default(
        mn, mx, cc, DefaultConfig(quality=Quality.MEDIUM)))
    inv = tree_checks(tb, F64_BIG)
    log(f"# f64, {F64_BIG} triangles: build_default(MEDIUM) = build_minitree "
        f"in float64 {build_ms:.3f} ms (CUDA events, first use); index words "
        f"{tb.index.dtype}; {inv}")
    if not (inv["prims_once"] and inv["leaves_tile"] and inv["pairs_ok"]
            and inv["inner_exact"]) or tb.bounds.dtype != torch.float64:
        raise AssertionError("the f64 scale tree breaks an invariant")
    rays = f64_rays(rng, F64_BIG_RAYS)
    ms, hit = events_ms(lambda: intersect_tris(tb, flat, rays))
    log(f"# f64, {F64_BIG} triangles, {F64_BIG_RAYS} rays: wavefront "
        f"{ms:.3f} ms (CUDA events), {int(hit.hit.sum())} hits")
    check_closest("f64 scale", tb, flat, rays, hit.t)
    log(f"# phase 15 in {time.perf_counter() - t0:.1f} s")


def cull_pair(a_fast, b_fast, a_rob, b_rob) -> bool:
    """Rays whose fast-form hits differ between two trees are fast-slab
    culls: both trees' robust t equal, each fast t that t or later (a
    miss included), and one of them that t."""
    return bool(same(a_rob, b_rob) and (a_fast >= a_rob).all()
                and (b_fast >= a_rob).all()
                and ((bits(a_fast) == bits(a_rob))
                     | (bits(b_fast) == bits(a_rob))).all())


def lbvh_wide_phase(tree, flat, rays, high_hit, mn, mx, cc) -> None:
    """Phase 16: build_lbvh on the 262K scene, its B5 render against the
    high tree's (phase 12), and the 8-wide layout of the high tree."""
    from bvh_tpu_torch import kernels
    from bvh_tpu_torch.build.lbvh import build_lbvh
    from bvh_tpu_torch.core.ray import Ray
    from bvh_tpu_torch.traverse import binary_kernel as bk
    from bvh_tpu_torch.traverse import wide
    from bvh_tpu_torch.traverse.stack import max_depth

    t0 = time.perf_counter()
    lb = build_lbvh(mn, mx, cc)
    sync()
    inv = tree_checks(lb, N_TRIS)
    ms, last = time_ms(lambda: build_lbvh(mn, mx, cc), 5)
    if not same_tree(last, lb):
        raise AssertionError("timed lbvh build diverged")
    log(f"# build_lbvh, sponza_class({N_TRIS}): {ms:.3f} ms, "
        f"{N_TRIS / ms / 1e3:.3f} Mprims/s (CUDA events, 5 builds after one); "
        f"{inv}")
    if not (inv["prims_once"] and inv["leaves_tile"] and inv["pairs_ok"]
            and inv["inner_exact"] and lb.node_count == 2 * N_TRIS - 1):
        raise AssertionError("the lbvh tree breaks an invariant")

    dflat = flat.to(DEV)
    kernels.reset_launch_counts()
    lh = bk.pallas_intersect_tris(lb, dflat, rays)
    sync()
    launches = kernels.BINARY_TRAVERSE.launches
    hl, hh = torch.isfinite(lh.t), torch.isfinite(high_hit.t)
    t_diff = hl & hh & (bits(lh.t) != bits(high_hit.t))
    off = torch.nonzero((hl != hh) | t_diff).squeeze(1)
    res = dict(launches=launches, hits=int(hl.sum()), high_hits=int(hh.sum()),
               inner_steps=int(lh.stats.visited_nodes.sum()),
               high_inner_steps=int(high_hit.stats.visited_nodes.sum()),
               mask_flips=int((hl != hh).sum()), t_differs=int(t_diff.sum()),
               prim_id_ties=int((hl & hh & ~t_diff
                                 & (lh.prim_id != high_hit.prim_id)).sum()))
    if off.numel():
        ro = Ray(*(x[off] for x in rays))
        res["culls"] = cull_pair(
            lh.t[off], high_hit.t[off],
            bk.pallas_intersect_tris(lb, dflat, ro, robust=True).t,
            bk.pallas_intersect_tris(tree, dflat, ro, robust=True).t)
    log(f"# B5 render of the lbvh tree vs the high tree's, {lh.t.numel()} "
        f"rays: {res}")
    if (not launches or off.numel() > EDGE_BUDGET
            or not res.get("culls", True)):
        raise AssertionError("the lbvh tree's render disagrees")

    t1 = time.perf_counter()
    w = wide.widen(tree)
    widen_s = time.perf_counter() - t1
    sub = slice(None, None, SUBSET)
    rs = Ray(*(x[sub] for x in rays))
    sd = 7 * max_depth(tree) + 1
    wms, wh = events_ms(lambda: wide.intersect_tris_wide(w, dflat, rs,
                                                         stack_depth=sd))
    hs = high_hit.t[sub]
    hw, hb = torch.isfinite(wh.t), torch.isfinite(hs)
    t_diff = hw & hb & (bits(wh.t) != bits(hs))
    off = torch.nonzero((hw != hb) | t_diff).squeeze(1)
    res = dict(wide_nodes=w.node_count, widen_s=round(widen_s, 3),
               rays=int(hs.numel()), hits=int(hw.sum()),
               mask_flips=int((hw != hb).sum()), t_differs=int(t_diff.sum()),
               prim_id_ties=int((hw & hb & ~t_diff
                                 & (wh.prim_id != high_hit.prim_id[sub]))
                                .sum()))
    if off.numel():
        ro = Ray(*(x[off] for x in rs))
        res["culls"] = cull_pair(
            wh.t[off], hs[off],
            wide.intersect_tris_wide(w, dflat, ro, robust=True,
                                     stack_depth=sd).t,
            bk.pallas_intersect_tris(tree, dflat, ro, robust=True).t)
    log(f"# widen of the high tree (host): {widen_s * 1e3:.1f} ms; "
        f"intersect_tris_wide on every {SUBSET}th primary ray: {wms:.3f} ms "
        f"(CUDA events, plain torch); vs B5 on the same tree: {res}")
    if off.numel() > EDGE_BUDGET or not res.get("culls", True):
        raise AssertionError("the wide traversal disagrees with B5")
    log(f"# phase 16 in {time.perf_counter() - t0:.1f} s")


def tool_kernels_phase() -> dict:
    """Phase 17: the profiling tools' own kernels T6, T5 and T1, each
    against its plain version, then their measurements."""
    from bvh_tpu_torch import kernels
    from bvh_tpu_torch.tools import ablate_kernel as t1
    from bvh_tpu_torch.tools import probe_int8_fetch as t6
    from bvh_tpu_torch.tools import probe_tpu as t5
    from bvh_tpu_torch.tools.timing import sm_clock_mhz

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    out = {}
    # T6: both dtypes at the tool's shapes
    r6 = t6.run(DEV)
    tab_bf, tab_i8, idx = t6.make_inputs(device=DEV)
    nb = ops = 0
    for tab, r in ((tab_bf, r6["bf16"]), (tab_i8, r6["int8"])):
        nb += nbytes(t6.column_copy(tab), idx, r["out"])
        ops += r["out"].numel() * t6.ITERS
    out["t6"] = dict(
        ms=r6["bf16"]["ms"] + r6["int8"]["ms"],
        ms_host=r6["bf16"]["ms_host"] + r6["int8"]["ms_host"],
        copy_ms=r6["bf16"]["copy_ms"] + r6["int8"]["copy_ms"],
        plain_ms=r6["bf16"]["plain_ms"] + r6["int8"]["plain_ms"],
        library_ms=r6["bf16"]["window_ms"] + r6["int8"]["window_ms"],
        bound=bound(nb, ops), us_per_fetch={
            f"{k}_{d}": r6[d][f"{k}_ms"] * 1e3 / (
                t6.ITERS if k == "window" else 1)
            for d in ("bf16", "int8")
            for k in ("index_select", "one_hot", "window")},
        kernel_us_per_fetch={d: r6[d]["ms"] * 1e3 / t6.ITERS
                             for d in ("bf16", "int8")},
        per_dtype={d: dict(ms=r6[d]["ms"], ms_host=r6[d]["ms_host"],
                           library_ms=r6[d]["window_ms"])
                   for d in ("bf16", "int8")},
        floor_ms=r6["floor_ms"])
    # T5: bit for bit at 512 iterations on four of the tool's configs,
    # then at T5_CHECK_ITERS on inputs that hit and on inputs whose
    # children share boxes, across C, chains and stack depths
    rng = np.random.default_rng(0)
    for B, C, sort8, chains in ((2048, 128, False, 1), (2048, 128, True, 1),
                                (2048, 128, False, 2), (8192, 128, True, 2)):
        table, prays = (x.to(DEV) for x in t5.tool_inputs(B, C, rng))
        r = t5.check_config(table, prays, sort8, chains, iters=t5.LO)
        log(f"# T5 B={B} C={C} sort8={int(sort8)} chains={chains}, "
            f"{t5.LO} iterations, the tool's inputs: kernel equal to its "
            f"plain version on every lane; slab hit share "
            f"{r['hit_share']:.4f}")
    for kind, B, C, sort8, chains, depth in T5_CHECKS:
        make = t5.hitting_inputs if kind == "hitting" else t5.tie_inputs
        table, prays = (x.to(DEV) for x in make(B, C))
        r = t5.check_config(table, prays, sort8, chains, iters=T5_CHECK_ITERS,
                            stack_depth=depth)
        log(f"# T5 B={B} C={C} sort8={int(sort8)} chains={chains} "
            f"stack_depth={depth}, {T5_CHECK_ITERS} iterations, {kind} "
            f"inputs: kernel equal to its plain version on every lane; "
            f"slab hit share {r['hit_share']:.4f}")
    table, prays = (x.to(DEV) for x in t5.hitting_inputs(2048, 128))
    r = t5.check_config(table, prays, True, 1, iters=t5.LO)
    log(f"# T5 B=2048 C=128 sort8=1 chains=1, {t5.LO} iterations, inputs "
        f"that hit: kernel equal to its plain version; slab hit share "
        f"{r['hit_share']:.4f}")
    kw = dict(sort8=True, chains=1, stack_depth=t5.STACK_DEPTH, iters=t5.LO)

    def call5():
        return t5.wide_step_probe(table, prays, **kw)

    host5, last = time_ms(call5, 10)
    ms5 = device_ms(call5, r["out"])
    plain5, plast = time_ms(lambda: t5.wide_step_probe_ref(
        table, prays, **kw), 1)
    if not (same(last, r["out"]) and same(plast, r["out"])):
        raise AssertionError("timed T5 output diverged")
    # the clock under the same kernel, read during HI-iteration calls
    # (fewer launches than as many LO-iteration ones)
    mhz = sm_clock_mhz(lambda: t5.wide_step_probe(
        table, prays, **{**kw, "iters": t5.HI}), ms5 * t5.HI / t5.LO)
    B5_, C5_ = prays.shape[1], table.shape[1]
    launch5 = {f"B={b_} C={c_} sort8=1 chains=1":
               kernels.wide_step_probe_launch(c_, b_, True, 1, t5.STACK_DEPTH)
               for b_, c_ in ((B5_, C5_), (2048, 512), t5.FULL_CARD[:2])}
    ptx5 = kernels.ptxas_figures("wide_step_probe")
    for name, fig in sorted(ptx5.items()):
        log(f"# T5 ptxas {name}: {fig}")
    log(f"# T5 launches (block, grid, dynamic smem bytes, blocks an SM): "
        f"{launch5}")
    per_iter = t5.probe_kernels(DEV, mhz=mhz)
    out["t5"] = dict(
        ms=ms5, host_loop_ms=host5, plain_ms=plain5, bound=bound(
            nbytes(table, prays, r["out"]), OPS_WIDE_STEP * B5_ * t5.LO),
        sm_clock_mhz=mhz, cycles_per_step=ms5 * 1e3 * mhz / t5.LO,
        per_iter=per_iter, cycles_per_iter={
            f"{b_},{c_},{int(s_)},{k_}": us * mhz
            for b_, c_, s_, k_, us in per_iter},
        launch=launch5, ptxas=ptx5, library=t5.probe_library(DEV))
    log(f"# T5 at B={B5_} C={C5_} sort8=1 chains=1, {t5.LO} iterations, "
        f"inputs that hit: kernel {ms5:.4f} ms (the device's own time, "
        f"median of 21; host loop {host5:.4f} ms), plain {plain5:.3f} ms, "
        f"bound {out['t5']['bound'][0]:.5f} ms ({out['t5']['bound'][1]}); "
        f"SM clock {mhz:.0f} MHz under it: "
        f"{out['t5']['cycles_per_step']:.1f} cycles a step")
    # T1: the chain check, then each variant's cost per step
    r1 = t1.run(T1_B, T1_P, DEV, n=T1_REPS)
    full = r1["checks"][T1_P - 16]["out"]
    asteps = int(full[1][1].sum())
    out["t1"] = dict(
        ms=r1["no quad MT"]["ms_hi"], plain_ms=r1["plain_ms"],
        bound=bound(nbytes(r1["tid"], r1["rays"], *full)
                    + visited_bytes(r1["table"], r1["tid"], r1["rays"], full,
                                    any_hit=False, robust=False,
                                    stack_depth=24),
                    OPS_WIDE_STEP * asteps),
        us_per_step={k: v["us"] for k, v in r1.items()
                     if isinstance(v, dict) and "us" in v})
    out["launches"] = launch_counts()
    log(f"# phase 17 in {time.perf_counter() - t_phase:.1f} s; launches "
        f"{out['launches']}")
    for k in ("column_fetch", "wide_step_probe", "traverse_pairs_ablate"):
        if not out["launches"].get(k):
            raise AssertionError(f"phase 17 never launched {k}")
    return out


def digest(*ts) -> str:
    """sha256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def par_rank(rank: int, world: int, work: str, n_tris: int,
             side: int) -> None:
    """One rank of phase 18 on cuda:0: the executor's bounds, the sharded
    build stage by stage against the single build, and the sharded
    traversal against the single one; results to work/rank<r>.json.
    Rank 0 runs the single-device references while the others wait."""
    import torch.distributed as dist

    from bvh_tpu_torch.build.minitree import MiniTreeConfig, build_minitree
    from bvh_tpu_torch.cli.camera import primary_rays
    from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
    from bvh_tpu_torch.io.scenes import scene_camera, sponza_class
    from bvh_tpu_torch.par import intersect_tris_sharded, make_mesh
    from bvh_tpu_torch.par import minitree_sharded as ms
    from bvh_tpu_torch.par.executor import ParallelExecutor
    from bvh_tpu_torch.par.mesh import Mesh
    from bvh_tpu_torch.traverse.stack import required_stack_depth
    from bvh_tpu_torch.traverse.wavefront import intersect_tris

    comm = {"calls": 0, "bytes": 0, "ms": 0.0}

    class TimedMesh(Mesh):
        """The mesh, with each collective's host time (synchronised
        before and after) and the bytes it delivers to this rank."""

        def _timed(self, fn, x):
            sync()
            t0 = time.perf_counter()
            out = fn(x)
            sync()
            comm["calls"] += 1
            comm["bytes"] += out.numel() * out.element_size()
            comm["ms"] += (time.perf_counter() - t0) * 1e3
            return out

        def all_gather(self, x):
            return self._timed(super().all_gather, x)

        def all_sum(self, x):
            return self._timed(super().all_sum, x)

    def staged(fn):
        """fn()'s CUDA-event ms, and its collectives' count, bytes and
        host ms."""
        before = dict(comm)
        ms_, out = events_ms(fn)
        return out, dict(ms=ms_, calls=comm["calls"] - before["calls"],
                         bytes=comm["bytes"] - before["bytes"],
                         comm_ms=comm["ms"] - before["ms"])

    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "store"),
        rank=rank, world_size=world)
    try:
        base = make_mesh(world, device=torch.device(DEV, 0))
        mesh = TimedMesh(base.rank, base.size, base.axis, base.device)
        dev = mesh.device
        res = {"rank": rank, "device": str(dev)}

        tris = sponza_class(n_tris, seed=0)
        mn, mx, cc = (torch.from_numpy(a).to(dev) for a in (
            tris.min(axis=1), tris.max(axis=1), tris.mean(axis=1)))
        big = torch.finfo(cc.dtype).max
        ex_ms, (emn, emx) = events_ms(lambda: ParallelExecutor(mesh).reduce(
            (cc, cc), lambda a, b: (torch.minimum(a[0], b[0]),
                                    torch.maximum(a[1], b[1])),
            (cc.new_full((3,), big), cc.new_full((3,), -big))))
        res["executor_bounds_exact"] = bool(
            torch.equal(emn, cc.amin(0)) and torch.equal(emx, cc.amax(0)))
        res["executor_ms"] = ex_ms

        cfg = MiniTreeConfig()
        ms.build_minitree_sharded(mn, mx, cc, mesh, cfg)  # first use
        stages = {}
        plan, stages["prepass"] = staged(
            lambda: ms._prepass(mn, mx, cc, mesh, cfg, None))
        forest, stages["phase_a"] = staged(lambda: ms._phase_a(plan, cfg))
        block, stages["phase_b"] = staged(
            lambda: ms._phase_b(forest, plan, mesh, cfg))
        gathered, stages["gather"] = staged(lambda: ms._gather(block, mesh))
        tree, stages["glue"] = staged(lambda: ms._glue(gathered, plan, cfg))
        stages["total_ms"] = sum(v["ms"] for v in stages.values())
        res.update(stages=stages, share=int(plan.dlen[rank]),
                   nodes=tree.node_count, tree_checks=tree_checks(
                       tree, n_tris),
                   digest=digest(tree.bounds[:tree.node_count],
                                 tree.index[:tree.node_count],
                                 tree.prim_ids))

        tt = torch.from_numpy(tris).to(dev)
        flat = PrecomputedTri.from_tri(Tri(tt[:, 0], tt[:, 1],
                                           tt[:, 2])).as_flat()
        eye, d, up = scene_camera(tris)
        rays = primary_rays(eye, d, up, side, side, device=dev)
        kw = dict(stack_depth=required_stack_depth(tree))
        stride = torch.ones(1, dtype=torch.int64)
        if rank == 0:
            single_ms, single = events_ms(
                lambda: build_minitree(mn, mx, cc, cfg))
            nc = single.node_count
            res["single_build_ms"] = single_ms
            res["equal_to_single_build"] = bool(
                nc == tree.node_count
                and same((single.bounds[:nc], single.index[:nc],
                          single.prim_ids),
                         (tree.bounds[:nc], tree.index[:nc], tree.prim_ids))
                and single.prim_count == tree.prim_count)
            trace_ms, hit = events_ms(lambda: intersect_tris(single, flat,
                                                             rays, **kw))
            res["single_traversal_ms"] = trace_ms
            if trace_ms > PAR_WAVEFRONT_BUDGET_S * 1e3:
                stride[0] = 4
        dist.broadcast(stride, 0)
        step = int(stride[0])
        res["ray_stride"] = step
        sub = type(rays)(*(x[::step] for x in rays))
        res["traversal"] = {}
        for n in (sub.tmin.shape[0], (PAR_ODD_RAYS + step - 1) // step):
            part = type(rays)(*(x[:n] for x in sub))
            got, st = staged(lambda: intersect_tris_sharded(
                tree, flat, part, mesh, **kw))
            entry = dict(rays=n, stage=st, hits=int(got.hit.sum()))
            if rank == 0:
                entry["equal_to_single"] = all(
                    same(getattr(got, k), getattr(hit, k)[::step][:n])
                    for k in ("t", "u", "v", "prim_id"))
            res["traversal"][str(n)] = entry
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def par_phase() -> dict:
    """Phase 18: par/ on PAR_RANKS gloo ranks that share the card
    (`par_rank`), the two port examples as subprocesses on the card and
    on the CPU, and the port's native bindings on the golden tree."""
    import shutil

    import torch.multiprocessing as mp

    from bvh_tpu_torch.api.native import NativeBvh3f

    t0 = time.perf_counter()
    work = os.path.join(OUT_DIR, "par")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    mp.spawn(par_rank, args=(PAR_RANKS, work, N_TRIS, SIDE),
             nprocs=PAR_RANKS, join=True)
    outs = []
    for r in range(PAR_RANKS):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    card = card_line()
    r0 = outs[0]
    log(f"# phase 18, {PAR_RANKS} gloo ranks on one card ({card}), the "
        f"collectives on device tensors")
    log(f"#   single build_minitree {r0['single_build_ms']:.3f} ms (CUDA "
        f"events, {N_TRIS} prims); sharded build equal: "
        f"{r0['equal_to_single_build']}; digests "
        f"{sorted({o['digest'][:16] for o in outs})}")
    for o in outs:
        log(f"#   rank {o['rank']}: share {o['share']} prims, "
            f"{o['nodes']} nodes, executor bounds exact "
            f"{o['executor_bounds_exact']} ({o['executor_ms']:.3f} ms); "
            f"stages (CUDA-event ms; collectives, their bytes and host "
            f"ms): " + ", ".join(
                f"{k} {v['ms']:.3f} ({v['calls']}, {v['bytes']}, "
                f"{v['comm_ms']:.3f})"
                for k, v in o["stages"].items() if k != "total_ms")
            + f"; sum {o['stages']['total_ms']:.3f}")
        for n, e in o["traversal"].items():
            log(f"#   rank {o['rank']}: intersect_tris_sharded of {n} rays "
                + (f"(every {o['ray_stride']}th) " if o["ray_stride"] > 1
                   else "") + f"{e['stage']['ms']:.3f} ms, "
                f"with its {e['stage']['calls']} gathers "
                f"({e['stage']['bytes']} bytes, {e['stage']['comm_ms']:.3f} "
                f"ms); hits {e['hits']}"
                + (f"; equal to single: {e['equal_to_single']}"
                   if "equal_to_single" in e else ""))
    log(f"#   single intersect_tris of all {SIDE * SIDE} rays "
        f"{r0['single_traversal_ms']:.3f} ms (CUDA events)"
        + (f"; past {PAR_WAVEFRONT_BUDGET_S:.0f} s, so the sharded check "
           f"took every {r0['ray_stride']}th ray" if r0["ray_stride"] > 1
           else ""))
    inv = r0["tree_checks"]
    ok = (r0["equal_to_single_build"]
          and len({o["digest"] for o in outs}) == 1
          and all(o["executor_bounds_exact"] for o in outs)
          and all(e["equal_to_single"] for e in r0["traversal"].values())
          and inv["prims_once"] and inv["leaves_tile"] and inv["pairs_ok"]
          and inv["inner_exact"])
    if not ok:
        raise AssertionError("phase 18: the sharded paths differ from the "
                             "single-device ones")

    examples = {}
    for name in ("simple_example", "serialize_roundtrip"):
        path = os.path.join(HERE, "bvh_tpu_torch", "examples", f"{name}.py")
        runs = [subprocess.run([sys.executable, path, *extra],
                               capture_output=True, text=True, timeout=300)
                for extra in ((), ("--device", "cpu"))]
        examples[name] = runs[0].stdout.strip()
        log(f"# example {name}: card rc {runs[0].returncode} "
            f"{runs[0].stdout.strip()!r}; cpu rc {runs[1].returncode} "
            f"{runs[1].stdout.strip()!r}")
        if any(r.returncode for r in runs) or runs[0].stdout != runs[1].stdout:
            raise AssertionError(f"example {name} failed or differs from "
                                 f"its CPU run: {runs[0].stderr[-400:]}")

    native = NativeBvh3f()
    golden = os.path.join(HERE, "tests", "golden")
    cornell = np.fromfile(os.path.join(golden, "tris.bin"),
                          np.float32).reshape(-1, 3, 3)
    hits = np.fromfile(os.path.join(golden, "cornell_hits.bin"), np.dtype(
        [("prim_id", np.uint32), ("t", np.float32), ("u", np.float32),
         ("v", np.float32)]))
    h = native.load(os.path.join(golden, "cornell_sweep.bvh"))
    nodes = native.node_count(h)
    eye = np.asarray([0.0, 1.0, 2.0], np.float32)
    d = np.asarray([0.0, 0.0, -1.0], np.float32)
    right = np.cross(d, np.asarray([0.0, 1.0, 0.0], np.float32))
    right /= np.linalg.norm(right)
    up = np.cross(right, d)
    bad = 0
    for idx in range(0, 64 * 64, 16):
        u = 2.0 * (idx % 64) / 64 - 1.0
        v = 2.0 * (idx // 64) / 64 - 1.0
        prim, t = native.intersect_closest(h, eye, d + u * right + v * up,
                                           cornell)
        want = hits["prim_id"][idx]
        bad += int((prim != -1) != (want != 0xFFFFFFFF) or (
            prim != -1 and abs(t - hits["t"][idx]) > 1e-5 * hits["t"][idx]))
    native.destroy(h)
    log(f"# native golden tree: {nodes} nodes; closest hits of 256 golden "
        f"rays, {bad} differ from the goldens")
    if bad or nodes != 37:
        raise AssertionError("the native closest hits differ from the goldens")
    log(f"# phase 18 in {time.perf_counter() - t0:.1f} s")
    return dict(card=card, ranks=outs, examples=examples, native_bad=bad)


def plain(x):
    """`x` without its tensors, trees and tables: the numbers, strings
    and flags that JSON holds (None where nothing is left)."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    if isinstance(x, dict):
        out = {str(k): plain(v) for k, v in x.items()}
        return {k: v for k, v in out.items() if v is not None}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        vals = [plain(v) for v in x]
        return None if any(v is None for v in vals) else vals
    return None


def tools_phase(boxes, sc, native_bvh, round1, big_sc, big_tl) -> dict:
    """Phase 19: the tools of bvh_tpu_torch/tools/ that drive the build,
    the render and the dims, each through its `run` at full width, with
    the launch counts reset before and read after each. `boxes`: the
    262K scene's prim boxes and centres on the card; `sc`: the 262K
    scene with phase 5's tree (`bench_wide.WideScene`); `native_bvh`:
    phase 2's native tree; `round1`: T3's round-1 record (phase 10);
    `big_sc`, `big_tl`: phase 13's San-Miguel-class scene and tables.
    Fewer repetitions than the tools' defaults; every size theirs."""
    from bvh_tpu_torch import kernels
    from bvh_tpu_torch.tools import (ablate_kernel2, bench_build, bench_dims,
                                     bench_sanmiguel, bench_wide,
                                     check_mtf_parity, check_super_quick,
                                     check_wide_quick, profile_build,
                                     profile_mtf, profile_reinsertion)

    t_phase = time.perf_counter()
    out, launches, secs = {}, {}, {}

    def tool(name, fn):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        sync()
        secs[name] = time.perf_counter() - t0
        launches[name] = launch_counts()
        out[name] = plain(res)
        log(f"# phase 19, {name}: {secs[name]:.1f} s, launches "
            f"{launches[name]}")
        return res

    # items 1-5: the builds
    bb = tool("bench_build", lambda: bench_build.run(
        N_TRIS, DEV, reps=1, boxes=boxes))
    if not same_tree(bb["high"]["tree"], sc.tree):
        raise AssertionError("bench_build's high tree is not phase 5's")
    mtf = tool("profile_mtf", lambda: profile_mtf.run(device=DEV, reps=1,
                                                      boxes=boxes))
    if not same_tree(mtf["tree"], bb["mtf"]["tree"]):
        raise AssertionError("profile_mtf's tree is not bench_build's mtf")
    for inp, src in (("lbvh", "lbvh"), ("high", "mtf")):
        tool(f"profile_reinsertion_{inp}", lambda inp=inp, src=src:
             profile_reinsertion.run(input_name=inp, device=DEV, reps=3,
                                     tree=bb[src]["tree"]))
    del bb, mtf
    tool("profile_build", lambda: profile_build.run(N_TRIS, DEV, reps=1))
    par = tool("check_mtf_parity", lambda: check_mtf_parity.run(N_TRIS, DEV))
    if not par["equal"]:
        raise AssertionError("build_minitree and build_minitree_fast differ "
                             "at 262K")
    del par

    # items 6-8, 10: the 262K render on phase 5's tree
    wide = tool("bench_wide", lambda: bench_wide.run(
        N_TRIS, SIDE, device=DEV, reps=2, scene=sc))
    tl = wide[1024]["tl"]
    if {r["hits"] for r in wide.values()} != {ORACLE_HITS_REFERENCE_TREE}:
        raise AssertionError("bench_wide's hits are not the oracle's at "
                             "every max_prims")
    del wide
    quick = tool("check_wide_quick", lambda: check_wide_quick.run(
        N_TRIS, SIDE, device=DEV, scene=sc, tl=tl))
    native_sc = sc._replace(tree=native_bvh._replace(
        bounds=native_bvh.bounds.to(DEV), index=native_bvh.index.to(DEV),
        prim_ids=native_bvh.prim_ids.to(DEV)))
    quick_native = tool("check_wide_quick_native", lambda:
                        check_wide_quick.run(N_TRIS, SIDE, "native", DEV,
                                             scene=native_sc))
    sup = tool("check_super_quick", lambda: check_super_quick.run(
        N_TRIS, SIDE, DEV, reps=2, scene=sc, flat_tl=tl))
    if not (quick["ok"] and quick["hits"] == ORACLE_HITS_REFERENCE_TREE
            and quick_native["ok"] and sup["ok"]
            and sup["two_level"]["hits"] == ORACLE_HITS_REFERENCE_TREE):
        raise AssertionError("a quick check failed")
    del quick, quick_native, sup, native_sc
    tool("ablate_kernel2", lambda: ablate_kernel2.run(tl, sc.rays, DEV,
                                                      round1=round1))

    # item 9: the San-Miguel-class tables and the round trip (A13c)
    big = tool("bench_sanmiguel", lambda: bench_sanmiguel.run(
        N_BIG, SIDE, max_prims=1024, reps=2, device=DEV, scene=big_sc,
        tl=big_tl))
    a13 = big["a13c"]
    if not (big["ok"] and big["render"]["hits"] == BIG_ORACLE_HITS
            and a13["bvh_equal"] and a13["tables_equal"]
            and a13["hits_equal"]):
        raise AssertionError("bench_sanmiguel: the round trip or the hits "
                             "failed")
    del big, a13

    # item 11: dims
    tool("bench_dims", lambda: bench_dims.run(DIMS_M, DIMS_RAYS, reps=2,
                                              device=DEV))

    total = {}
    for per_tool in launches.values():
        for k, v in per_tool.items():
            total[k] = total.get(k, 0) + v
    for k in (kernels.WIDE_TREELET, kernels.COLLECT, kernels.GROUP_BUILD,
              kernels.COLLECT_SUPER, kernels.SPHERE_TRAVERSE,
              kernels.WIDE_TREELET_ABLATE):
        if not total.get(k.name):
            raise AssertionError(f"phase 19 never launched {k.name}")
    res = dict(seconds=time.perf_counter() - t_phase, tool_seconds=secs,
               launches=launches, launches_total=total, results=out,
               card=card_line())
    with open(os.path.join(OUT_DIR, "phase19.json"), "w") as f:
        json.dump(res, f, indent=1)
    log(f"# phase 19 in {res['seconds']:.1f} s; launches {total}; results in "
        f"chiprun_out/phase19.json")
    return res


def device_trace(fn) -> dict:
    """One call of `fn` under torch.profiler (CPU and CUDA activity):
    T2's counts (device ops, busy ms and share of the span, host syncs),
    the kernels' summed ms, and B1's and B2's own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bvh_tpu_torch.tools.profile_pure import kernel_ms
    from bvh_tpu_torch.tools.profile_r3 import summarize_events

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    res = summarize_events(events)
    res["kernel_ms"] = kernel_ms(events) if res["device_ops"] else None
    for key, fragment in (("b1_ms", "wide_treelet_kernel"),
                          ("b2_ms", "collect_kernel")):
        res[key] = sum(e.time_range.elapsed_us() for e in events
                       if e.device_type == DeviceType.CUDA
                       and fragment in e.name) / 1e3
    return res


def portal_sort_phase(tree, flat, tris, big_tl, big_rays) -> dict:
    """Phase 22: the portal ordering kernel (csrc/portal_sort.cu) on
    phase A's records at the main path's shapes: the 262K tree's
    1,048,576 primary rays (the sort, at the render's max_portals) and
    phase 13's San-Miguel-class scene (the two-level split at its caps,
    then the first A2 round's merge). Each output is held to the plain
    version (the torch sorts over the padded columns it replaced) on the
    same CUDA tensors bit for bit; the kernel and the plain version are
    timed as the device's own time (median of 21), beside torch.sort of
    the same gathered columns alone (`library_ms`), with the bound of the
    bytes the kernel must move (records read once, outputs written
    once). `launches`: the ordering kernels' launches in the entry
    point's render of the same rays, counted from a reset just before
    it, beside that render's attempts and A2 rounds. No benchmark cell
    runs this phase."""
    from bvh_tpu_torch.cli.camera import primary_rays
    from bvh_tpu_torch.io.scenes import scene_camera
    from bvh_tpu_torch.traverse import collect as col
    from bvh_tpu_torch.traverse import portal_sort as ps
    from bvh_tpu_torch.traverse import wide_treelet as wt

    t_phase = time.perf_counter()
    tl = wt.build_wide_treelets(tree, flat, device=DEV)
    eye, d, up = scene_camera(tris)
    res = {}
    for name, scene, rays in (
            ("262k", tl, primary_rays(eye, d, up, SIDE, SIDE, device=DEV)),
            ("10m", big_tl, big_rays)):
        caps = wt.wide_treelet_caps(scene, wt.portals_per_round(scene))
        MP = caps["max_portals"]
        packed = wt.pack_rays(rays)
        ptid, ptent, stats = col.collect_portals(
            scene.top_node_t, packed, scene.top_root, robust=False,
            stack_depth=scene.top_depth + 1, max_portals=MP)
        cnt = stats[0]
        sel = torch.nonzero(cnt > 0).squeeze(1)
        Rc = sel.numel()
        n_rec = int(cnt[sel].clamp(max=MP).sum())
        T = scene.table.shape[0]
        two_level = scene.sup_cols.shape[0] > 0
        kw = dict(T=T, mps=caps["mps"]) if two_level else {}

        def kern():
            if two_level:
                return ps.split_columns(ptid, ptent, cnt, sel, **kw)
            return ps.sort_columns(ptid, ptent, cnt, sel)

        def plain_fn():
            if two_level:
                return ps.split_columns_plain(ptid, ptent, cnt, sel, **kw)
            return ps.sort_columns_plain(ptid, ptent, cnt, sel)

        out_bytes = Rc * (MP * 12 + (caps["mps"] * 4 + 8 if two_level
                                     else 0))
        want = plain_fn()
        got = kern()
        equal = same(got, want)
        cols = ptent[:, sel]
        ms = device_ms(kern, want)
        plain_ms = device_ms(plain_fn, want)
        library_ms = device_ms(lambda: torch.sort(cols, dim=0,
                                                  stable=True).values,
                               torch.sort(cols, dim=0, stable=True).values)
        # sel (8 bytes) and cnt (4) a ray, each record (id, t) once
        b = bound(Rc * 12 + n_rec * 8 + out_bytes, 0)
        res[name] = dict(rays=packed.shape[1], rays_with_portals=Rc,
                         max_portals=MP, records=n_rec, equal=equal, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=b[0], bound_by=b[1],
                         launches=main_path_launches(scene, rays))
        if two_level:
            res[name]["merge"] = first_merge(scene, packed, caps)
        log(f"# phase 22, {name}: {res[name]}")
        if not (equal and res[name].get("merge", {}).get("equal", True)):
            raise AssertionError(f"phase 22, {name}: the portal ordering "
                                 "kernel differs from its plain version")
    res.update(seconds=time.perf_counter() - t_phase, card=card_line())
    with open(os.path.join(OUT_DIR, "phase22.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def main_path_launches(tl, rays) -> dict:
    """The entry point's render of `rays` (closest hit, default caps),
    with the launch counts reset just before it: the ordering kernels'
    launches, and the attempts and A2 rounds that the render's trace
    counters give (a host-only profiler records them). Raises unless
    the render sorted once an attempt and merged once an A2 round."""
    from torch.profiler import ProfilerActivity, profile

    from bvh_tpu_torch import kernels
    from bvh_tpu_torch.core import trace
    from bvh_tpu_torch.traverse import wide_treelet as wt

    keys = ("wide_treelet.attempts", "wide_treelet.a2_rounds")
    before = trace.counts()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        wt.wide_treelet_intersect_tris(tl, rays)
        torch.cuda.synchronize()
    after = trace.counts()
    attempts, a2_rounds = (after.get(k, 0) - before.get(k, 0) for k in keys)
    out = dict(portal_sort=kernels.PORTAL_SORT.launches,
               portal_merge=kernels.PORTAL_MERGE.launches,
               attempts=attempts, a2_rounds=a2_rounds)
    if (out["portal_sort"], out["portal_merge"]) != (attempts, a2_rounds):
        raise AssertionError(f"phase 22: the render's ordering launches "
                             f"{out} are not one sort an attempt and one "
                             f"merge an A2 round")
    return out


def first_merge(tl, packed, caps) -> dict:
    """The first A2 round's merge of the render at `caps` (closest hit,
    fast slab): its inputs recorded, then the kernel and the plain merge
    on fresh copies of the lists, equal bit for bit, each timed with
    CUDA events around the call (median of 21, the copies made before),
    beside torch.sort of the columns the plain merge sorts
    (`library_ms`). The bound counts the bytes the kernel must move:
    the merged rays' keys read (4 bytes a slot up to the list's
    length), the slots that change written (12 bytes), B4's records
    read once (8 bytes a record, 4 a pair's count) and each ray's
    length and finite count written."""
    from bvh_tpu_torch.traverse import portal_sort as ps
    from bvh_tpu_torch.traverse import wide_treelet as wt

    rec = {}
    real = wt.merge_columns

    def recorder(tid, tent, tlen, *args, **kw):
        if not rec:
            rec.update(lists=(tid.clone(), tent.clone(), tlen.clone()),
                       args=args, kw=kw)
        return real(tid, tent, tlen, *args, **kw)

    wt.merge_columns = recorder
    try:
        portals = wt.collect_and_sort(
            tl, packed, robust=False, top_stack=tl.top_depth + 1,
            max_portals=caps["max_portals"], mps=caps["mps"])
        wt.expand_supers(tl, portals, packed[:, portals.sel], robust=False,
                         sup_stack=tl.sup_depth + 1, mps=caps["mps"],
                         max_new=caps["max_new"],
                         max_portals=caps["max_portals"])
    finally:
        wt.merge_columns = real
    args, kw = rec["args"], rec["kw"]   # rsel, jj, rr, ntid, nt, ncnt
    rsel, jj, rr, ntid, nt, ncnt = args

    def timed_merge(fn):
        times, out = [], None
        for _ in range(21):
            lists = tuple(x.clone() for x in rec["lists"])
            ms, f = events_ms(lambda: fn(lists))
            times.append(ms)
            out = (*lists, f)
        return float(np.median(times)), out

    ms, got = timed_merge(lambda lists: ps.merge_columns(*lists, *args, **kw))
    plain_ms, want = timed_merge(lambda lists: ps.merge_columns_plain(
        *lists, *args, **kw))
    # the columns the plain merge sorts: the lists, then the new records
    # laid out (record, window slot)
    tid0, tent0, tlen0 = rec["lists"]
    Rr = rsel.numel()
    new_t = torch.full((kw["max_new"], kw["k2"], Rr), float("inf"),
                       device=tent0.device)
    new_t[:, jj, rr] = nt
    cols = torch.cat([tent0[:, rsel], new_t.reshape(-1, Rr)])
    ref = torch.sort(cols, dim=0, stable=True).values
    library_ms = device_ms(lambda: torch.sort(cols, dim=0,
                                              stable=True).values, ref)
    changed = int(((got[0][:, rsel] != tid0[:, rsel])
                   | (bits(got[1][:, rsel]) != bits(tent0[:, rsel]))).sum())
    n_new = int(ncnt.clamp(max=kw["max_new"]).sum())
    b = bound(4 * int(tlen0[rsel].sum()) + 12 * changed + 8 * n_new
              + 4 * ncnt.numel() + 8 * Rr, 0)
    return dict(rays=int(Rr), pairs=int(jj.numel()), records=n_new,
                slots_changed=changed, equal=same(got, want), ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=b[0],
                bound_by=b[1])


def one_program_phase(tree, flat, tris, big_tl) -> dict:
    """Phase 21: the one-program render on phase 7's 262K tree, for the
    primary and the shadow rays: the caps of a verified eager call; the
    render chain (`wide_treelet_render_chain`, k = 1: its verified
    `_render_fixed`, then one render captured as a CUDA graph), its t row
    equal to the entry point's element by element, with the launches of
    B2 and B1 during the capture and the graph's nodes; `_render_fixed`
    at the chain's settings under sync debug "error", equal to the eager
    `_render` at those caps bit for bit, with B2 and B1 held against
    their plain versions on the inputs it gave them (B1 on its first
    round's pairs, up to their count); `steady_rate` over chains of 16
    and 64 renders beside the entry point's ms (host clock, median of
    7); one call of the k-1 chain and one of the entry point under
    torch.profiler (`device_trace`); then the chain refuses phase 13's
    two-level tables."""
    from bvh_tpu_torch import kernels
    from bvh_tpu_torch.cli.camera import primary_rays
    from bvh_tpu_torch.cli.steady import steady_rate
    from bvh_tpu_torch.core.ray import Ray
    from bvh_tpu_torch.io.scenes import scene_camera
    from bvh_tpu_torch.traverse import collect as col
    from bvh_tpu_torch.traverse import wide_treelet as wt

    t_phase = time.perf_counter()
    tl = wt.build_wide_treelets(tree, flat, device=DEV)
    prim_ids = tree.prim_ids
    eye, d, up = scene_camera(tris)
    rays = primary_rays(eye, d, up, SIDE, SIDE, device=DEV)
    hit = wt.wide_treelet_intersect_tris(tl, rays, prim_ids)
    light = torch.as_tensor(eye, dtype=torch.float32, device=DEV) + \
        torch.tensor([0.0, 1.0, 0.0], device=DEV)
    hitp = rays.org + rays.dir * torch.where(torch.isfinite(hit.t), hit.t,
                                             0.0)[:, None]
    srays = Ray.make(hitp, light[None, :] - hitp, tmin=1e-4,
                     tmax=torch.ones_like(hit.t))
    res = {"card": card_line()}
    for name, r, any_hit in (("primary", rays, False),
                             ("shadow", srays, True)):
        R = r.tmin.shape[0]
        kernels.reset_launch_counts()
        ehit, diag = wt.wide_treelet_intersect_tris(
            tl, r, prim_ids, any_hit=any_hit, return_diag=True)
        sync()
        eager_launches = launch_counts()
        caps = diag["caps"]

        kernels.reset_launch_counts()
        chain = wt.wide_treelet_render_chain(tl, r, 1, any_hit=any_hit,
                                             **caps)
        t_row = chain()
        sync()
        chain_launches = launch_counts()
        hits = int(torch.isfinite(t_row[:R]).sum())
        equal = same(t_row[:R], ehit.t)

        seen = {}

        def collect(*a, **kw):
            seen["b2"] = a, kw
            return col.collect_portals(*a, **kw)

        def traverse(*a, **kw):
            seen.setdefault("b1", (a, kw))
            return wt.traverse_pairs(*a, **kw)

        fixed_kw = dict(any_hit=any_hit, robust=False,
                        k=wt.portals_per_round(tl), sel_cap=chain.sel_cap,
                        tail_cap=chain.tail_cap, rounds=chain.rounds)
        packed = chain.packed.clone()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fixed = wt._render_fixed(tl, packed, chain.caps, collect=collect,
                                     traverse=traverse, **fixed_kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        stats = dict(zip(wt.FIXED_STATS, fixed[-1].tolist()))
        eager = wt.render_at_caps(tl, packed, chain.caps, any_hit=any_hit,
                                  robust=False)
        fixed_equal = same(tuple(fixed[:5]), tuple(eager[:5]))
        a, kw = seen["b2"]
        b2_equal = same(col.collect_portals(*a, **kw),
                        col.collect_portals_ref(*a, **kw))
        a, kw = seen["b1"]
        n = int(kw["count"])
        kf, ki = wt.traverse_pairs(*a, **kw)
        pf, pi = wt.traverse_pairs_plain(*a, **kw)
        b1_equal = same((kf[:, :n], ki[:, :n]), (pf[:, :n], pi[:, :n]))

        chains = {}

        def make_chain(k):
            chains[k] = wt.wide_treelet_render_chain(tl, r, k,
                                                     any_hit=any_hit, **caps)
            return chains[k]

        r_s, c_s, t16, t64 = steady_rate(make_chain, 16, 64, reps=3)
        steady_equal = same(chains[64]()[:R], ehit.t)
        eager_s = []
        for _ in range(7):
            t0 = time.perf_counter()
            wt.wide_treelet_intersect_tris(tl, r, prim_ids, any_hit=any_hit)
            sync()
            eager_s.append(time.perf_counter() - t0)
        eager_s.sort()
        traces = {"chain_k1": device_trace(chain),
                  "entry_point": device_trace(
                      lambda: wt.wide_treelet_intersect_tris(
                          tl, r, prim_ids, any_hit=any_hit))}
        res[name] = dict(
            rays=R, hits=hits, chain_equals_entry_point=equal,
            fixed_equals_eager=fixed_equal, b2_equals_plain=b2_equal,
            b1_equals_plain=b1_equal, b1_pairs=[n, int(a[1].shape[0])],
            steady_chain_equals_entry_point=steady_equal,
            caps=chain.caps, sel_cap=chain.sel_cap, tail_cap=chain.tail_cap,
            rounds=chain.rounds, eager=chain.eager, stats=stats,
            eager_launches=eager_launches, chain_launches=chain_launches,
            capture_launches=chain.capture_launches,
            graph_nodes=chain.graph_nodes, steady_ms=r_s * 1e3,
            fixed_cost_ms=c_s * 1e3, chain16_ms=t16 * 1e3,
            chain64_ms=t64 * 1e3, entry_point_ms=eager_s[3] * 1e3,
            entry_point_ms_all=[x * 1e3 for x in eager_s], traces=traces)
        log(f"# phase 21, {name}: {res[name]}")
        ok = (equal and fixed_equal and b2_equal and b1_equal and steady_equal
              and not any(stats[f] for f in ("top_ovf", "stack_ovf",
                                             "pending"))
              and all(chain.capture_launches.get(k.name) for k in (
                  kernels.COLLECT, kernels.WIDE_TREELET))
              and (any_hit or hits == ORACLE_HITS_REFERENCE_TREE))
        if not ok:
            raise AssertionError(f"phase 21, {name}: the one-program render "
                                 "differs from the entry point or its "
                                 "kernels from their plain versions")
    try:
        wt.wide_treelet_render_chain(big_tl, rays, 1)
    except NotImplementedError as e:
        res["two_level_refused"] = str(e)
    else:
        raise AssertionError("phase 21: the chain took a two-level scene")
    res["seconds"] = time.perf_counter() - t_phase
    with open(os.path.join(OUT_DIR, "phase21.json"), "w") as f:
        json.dump(res, f, indent=1)
    log(f"# phase 21 on {res['card']} in {res['seconds']:.1f} s; results in "
        "chiprun_out/phase21.json")
    return res


def run() -> dict:
    from bvh_tpu_torch import kernels
    from bvh_tpu_torch.api.native import NativeBvh3f
    from bvh_tpu_torch.build import group_kernel as gk
    from bvh_tpu_torch.build import minitree_fast as mtf
    from bvh_tpu_torch.build.reinsertion import optimize_reinsertion
    from bvh_tpu_torch.cli.camera import primary_rays
    from bvh_tpu_torch.core.ray import Ray
    from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
    from bvh_tpu_torch.io.scenes import scene_camera, sponza_class
    from bvh_tpu_torch.io.serialize import deserialize_from_bytes
    from bvh_tpu_torch.traverse import collect as col
    from bvh_tpu_torch.traverse import wide_treelet as wt

    dev = "cuda"
    err = {"b2": 0.0, "b1": 0.0, "b3": 0.0}
    timings = {}

    # ---- 1. device and builds -----------------------------------------
    log(f"# card: {card_line()}")
    log(f"# torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.library()
    log(f"# kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"#   ptxas: {line.strip()}")
    t0 = time.perf_counter()
    native = NativeBvh3f()
    log(f"# native library ready in {time.perf_counter() - t0:.1f} s")

    # ---- 2. scene, host boxes, the native build for comparison --------
    tris = sponza_class(N_TRIS, seed=0)
    boxes = (tris.min(axis=1), tris.max(axis=1), tris.mean(axis=1))
    t0 = time.perf_counter()
    handle = native.build(*boxes, quality=2, threads=os.cpu_count() or 1)
    native_s = time.perf_counter() - t0
    data = native.to_bytes(handle)
    native.destroy(handle)
    native_bvh = deserialize_from_bytes(data, device="cpu")
    log(f"# native quality-high build on the host ({os.cpu_count()} "
        f"threads): {native_bvh.node_count} nodes, {native_s:.3f} s")
    mn, mx, cc = (torch.from_numpy(a).to(dev) for a in boxes)

    # ---- 3. staging ---------------------------------------------------
    plan = mtf.staging_plan(cc)
    pf, base = mtf.pack_groups(mn, mx, cc, plan)
    cfg = plan.config
    b3_kw = dict(dim=plan.dim, P=plan.P, NCAP=plan.NCAP,
                 min_leaf=cfg.min_leaf_size, max_leaf=cfg.max_leaf_size,
                 log_cluster=cfg.sah.log_cluster_size,
                 cost_ratio=cfg.sah.cost_ratio)
    log(f"# staging: G={plan.G} P={plan.P} NCAP={plan.NCAP} (groups of "
        f"{int(plan.counts.min())}..{int(plan.counts.max())} prims; the "
        f"kernel takes P <= {kernels.group_build_max_p()} on this card)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b3_occ = kernels.group_build_occupancy(plan.P)
    log(f"# B3 occupancy at P={plan.P}: {b3_occ} resident CTAs an SM x "
        f"{sms} SMs = {b3_occ * sms} for G={plan.G} groups: "
        + ("one wave" if b3_occ * sms >= plan.G else
           f"{-(-plan.G // (b3_occ * sms))} waves"))

    # ---- 4. B3 against its plain version on the full staging ----------
    b3_out = gk.group_forest_build(pf, plan.counts, **b3_kw)
    b3_ref = gk.group_forest_build_ref(pf, plan.counts, **b3_kw)
    diff = {k: int((bits(a) != bits(b)).sum()) for k, a, b in
            zip(("nbf", "nbi", "src", "cnt"), b3_out, b3_ref)}
    fin = torch.isfinite(b3_ref[0])
    err["b3"] = float((b3_out[0][fin] - b3_ref[0][fin]).abs().max())
    log(f"# B3 group_build vs plain, {plan.G} groups: differing elements "
        f"{diff}; nodes per group {int(b3_out[3].min())}.."
        f"{int(b3_out[3].max())} (NCAP {plan.NCAP})")
    if not same(b3_out, b3_ref):
        raise AssertionError("B3 kernel and plain version differ")
    b3w = b3_work(b3_out[1], b3_out[3], plan.NCAP, cfg.min_leaf_size)
    log(f"# B3 work at G={plan.G}: {b3w['levels']} levels, "
        f"{b3w['open_nodes']} open nodes, {b3w['lanes']} lanes binned, "
        f"{b3w['split_lanes']} partitioned, {b3w['ops']} float operations")
    # the "bfs" variant: one B3 launch and the queue row, against the
    # plain version with the queue replayed on the host
    kernels.reset_launch_counts()
    bfs_out = gk.group_forest_build(pf, plan.counts, variant="bfs", **b3_kw)
    sync()
    bfs_launches = launch_counts()
    row3, queued = bfs_queue_plain(b3_ref[1], plan.G, plan.NCAP,
                                   cfg.min_leaf_size)
    bfs_ref = (b3_ref[0], row3, *b3_ref[2:])
    err["b3bfs"] = float((bfs_out[0][fin] - bfs_ref[0][fin]).abs().max())
    diff = {k: int((bits(a) != bits(b)).sum()) for k, a, b in
            zip(("nbf", "nbi", "src", "cnt"), bfs_out, bfs_ref)}
    log(f"# B3 variant bfs vs plain (queue replayed on the host): differing "
        f"elements {diff}; launches {bfs_launches}; {queued} queued slots "
        f"(open nodes "
        f"{b3w['open_nodes']}); rows 0-2 equal the ls variant's: "
        f"{same(bfs_out[1][:3], b3_out[1][:3])}")
    if not (same(bfs_out, bfs_ref)
            and bfs_launches == {kernels.GROUP_BUILD.name: 1}
            and queued == b3w["open_nodes"]):
        raise AssertionError("B3's bfs variant and its plain version differ, "
                             "or it did not launch B3 once")

    # ---- 5. the build path, through B3 and through its plain version --
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pre = mtf.build_minitree_fast(mn, mx, cc)
    stats = {}
    tree = optimize_reinsertion(pre, stats=stats)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = {k.name: k.launches for k in kernels.KERNELS}
    log(f"# device build (build_minitree_fast + optimize_reinsertion): "
        f"{tree.node_count} nodes, {build_s:.3f} s with first-use costs; "
        f"reinsertion steps {stats['steps']}, moves {stats['accepted']}; "
        f"launches {build_launches}")
    if build_launches[kernels.GROUP_BUILD.name] == 0:
        raise AssertionError("the build path never launched kernel B3")
    tree_p = optimize_reinsertion(mtf._build(mn, mx, cc, None,
                                             gk.group_forest_build_ref))
    log(f"# build through B3's plain version: {tree_p.node_count} nodes; "
        f"equal bit for bit: {same_tree(tree, tree_p)}")
    if not same_tree(tree, tree_p):
        raise AssertionError("the kernel-built and plain-built trees differ")
    inv_pre, inv = tree_checks(pre, N_TRIS), tree_checks(tree, N_TRIS)
    log(f"# tree invariants: {inv}; half-area before reinsertion "
        f"{inv_pre['half_area']:.6e}; native tree {native_bvh.node_count} "
        f"nodes")
    if not (inv["prims_once"] and inv["leaves_tile"] and inv["pairs_ok"]
            and inv["inner_exact"]
            and inv["half_area"] <= inv_pre["half_area"]):
        raise AssertionError("the port's tree breaks an invariant")

    # ---- 6. tables of the port's tree; B2 and B1 on the primary rays --
    bvh = tree
    tt = torch.from_numpy(tris)
    flat = PrecomputedTri.from_tri(Tri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
    t0 = time.perf_counter()
    tl = wt.build_wide_treelets(bvh, flat, device=dev)
    T, _, P = tl.table.shape
    log(f"# treelets: T={T} P={P} "
        f"top nodes={int((tl.top_node_t[12] != 0).sum())} "
        f"top_depth={tl.top_depth} wide_depth={tl.wide_depth} "
        f"supers={tl.sup_cols.shape[0]} ({time.perf_counter() - t0:.2f} s)")
    if tl.sup_cols.shape[0] != 0:
        raise AssertionError("the scene must have no super level")
    eye, d, up = scene_camera(tris)
    rays = primary_rays(eye, d, up, SIDE, SIDE, device=dev)
    R = SIDE * SIDE
    prim_ids = bvh.prim_ids
    caps = wt.wide_treelet_caps(tl)
    b2_kw = dict(robust=False, stack_depth=tl.top_depth + 1,
                 max_portals=caps["max_portals"])
    sd = 7 * tl.wide_depth + 8

    def check_b2(name, packed):
        """B2 against its plain version on every ray, bit for bit."""
        k_out = col.collect_portals(tl.top_node_t, packed, tl.top_root, **b2_kw)
        p_out = col.collect_portals_ref(tl.top_node_t, packed, tl.top_root,
                                        **b2_kw)
        ray_diff = torch.zeros(packed.shape[1], dtype=torch.bool, device=dev)
        for a, b in zip(k_out, p_out):
            ray_diff |= (bits(a) != bits(b)).any(0)
        fin = torch.isfinite(p_out[1])
        if fin.any():
            err["b2"] = max(err["b2"], float(
                (k_out[1][fin] - p_out[1][fin]).abs().max()))
        log(f"# B2 collect_portals vs plain, {name}, {packed.shape[1]} rays: "
            f"{int(ray_diff.sum())} rays differ; max portals "
            f"{int(k_out[2][0].max())} (cap {caps['max_portals']}), top "
            f"stack hwm {int(k_out[2][1].max())}")
        if ray_diff.any() or not same(k_out, p_out):
            raise AssertionError(f"B2 kernel and plain version differ ({name})")
        return k_out

    def check_b1(name, packed):
        """B1 against its plain version on the first round's pairs of
        `packed`, closest and any-hit, bit for bit in every output."""
        portals = wt.collect_and_sort(tl, packed, robust=False,
                                      top_stack=tl.top_depth + 1,
                                      max_portals=caps["max_portals"])
        Rc = portals.sel.numel()
        rays_c = packed[:, portals.sel]
        _, _, _, ptid, prays = wt.round_pairs(
            portals, torch.zeros(Rc, dtype=torch.int64, device=dev),
            rays_c[7].clone(), torch.ones(Rc, dtype=torch.bool, device=dev),
            rays_c, wt.octants(rays_c), torch.arange(Rc, device=dev),
            wt.PORTALS_PER_ROUND)
        outs = {}
        for any_hit in (False, True):
            kw = dict(any_hit=any_hit, robust=False, stack_depth=sd)
            kf, ki = wt.traverse_pairs(tl.table_cols, ptid, prays, **kw)
            pf_, pi = wt.traverse_pairs_ref(tl.table, ptid, prays, **kw)
            hk, hp = torch.isfinite(kf[0]), torch.isfinite(pf_[0])
            both = hk & hp
            dt = float((kf[0][both] - pf_[0][both]).abs().max()) \
                if both.any() else 0.0
            err["b1"] = max(err["b1"], dt)
            res = dict(pairs=ptid.numel(), hits=int(hk.sum()),
                       mask_flips=int((hk != hp).sum()),
                       prim_mismatches=int((ki[0] != pi[0]).sum()),
                       max_abs_dt=dt, t_u_v_bitwise=same(kf, pf_),
                       pos_steps_hwm_ovf_equal=same(ki, pi),
                       stack_hwm=int(ki[2].max()), stack_depth=sd)
            mode = "any-hit" if any_hit else "closest"
            log(f"# B1 traverse_pairs vs plain, {name} round-1 pairs, "
                f"{mode}: {res}")
            if not (res["t_u_v_bitwise"] and res["pos_steps_hwm_ovf_equal"]):
                raise AssertionError(f"B1 kernel and plain version differ "
                                     f"({name}, {mode})")
            outs[any_hit] = (kf, ki)
        return ptid, prays, outs[False]

    packed = wt.pack_rays(rays)
    k_out = check_b2("primary", packed)
    ptid, prays, b1_ref = check_b1("primary", packed)

    # ---- 7. the render path through the kernels -----------------------
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hit, diag = wt.wide_treelet_intersect_tris(tl, rays, prim_ids,
                                               return_diag=True)
    light = torch.as_tensor(eye, dtype=torch.float32, device=dev) + \
        torch.tensor([0.0, 1.0, 0.0], device=dev)
    hitp = rays.org + rays.dir * torch.where(torch.isfinite(hit.t), hit.t,
                                             0.0)[:, None]
    srays = Ray.make(hitp, light[None, :] - hitp, tmin=1e-4,
                     tmax=torch.ones_like(hit.t))
    shit, sdiag = wt.wide_treelet_intersect_tris(tl, srays, prim_ids,
                                                 any_hit=True,
                                                 return_diag=True)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    render_kernels = (kernels.COLLECT, kernels.WIDE_TREELET)
    launches = {k.name: k.launches for k in render_kernels}
    n_hits = int(torch.isfinite(hit.t).sum())
    n_shadow = int(torch.isfinite(shit.t).sum())
    log(f"# primary render on the port's tree: {n_hits} hits of {R} rays "
        f"(C++ oracle on bvh_tpu's own tree: {ORACLE_HITS_REFERENCE_TREE}); "
        f"rounds {diag['rounds']}, pairs {diag['pairs']}, caps {diag['caps']}")
    log(f"# shadow render: {n_shadow} occluded of {R}; rounds "
        f"{sdiag['rounds']}, pairs {sdiag['pairs']}")
    log(f"# render path launches: {launches} ({main_s:.2f} s)")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the render path never launched: "
                             f"{launches}")
    launches[kernels.GROUP_BUILD.name] = build_launches[kernels.GROUP_BUILD.name]
    t_ok = torch.isfinite(hit.t)
    if not (n_hits > 0 and hit.t.shape == (R,) and bool((hit.t[t_ok] > 0).all())
            and bool((hit.prim_id[t_ok] >= 0).all())
            and bool((hit.prim_id[t_ok] < N_TRIS).all())):
        raise AssertionError("primary render output is malformed")
    if not (shit.t.shape == (R,) and 0 < n_shadow < R):
        raise AssertionError("shadow render output is malformed")

    # ---- 8. the kernels at the shadow render's shapes, and the
    # ---- plain-version render on a subset of both renders -------------
    spacked = wt.pack_rays(srays)
    check_b2("shadow", spacked)
    check_b1("shadow", spacked)
    sub = slice(None, None, SUBSET)
    for name, r, h, any_hit in (("primary", rays, hit, False),
                                ("shadow", srays, shit, True)):
        rsub = Ray(r.org[sub], r.dir[sub], r.tmin[sub], r.tmax[sub])
        ph = wt._intersect(tl, rsub, prim_ids, col.collect_portals_ref,
                           wt.traverse_pairs_plain, any_hit=any_hit)
        fields = ("t", "u", "v", "prim_pos", "prim_id")
        d_ = {f: int((bits(getattr(h, f)[sub]) != bits(getattr(ph, f))).sum())
              for f in fields}
        log(f"# {name} render vs plain render on every {SUBSET}th ray "
            f"({ph.t.numel()} rays): differing rays per field {d_}")
        if any(d_.values()):
            raise AssertionError(f"{name} render: kernels and plain "
                                 "versions disagree")

    # ---- 9. the primary render on the native tree ---------------------
    ntl = wt.build_wide_treelets(native_bvh, flat, device=dev)
    nhit = wt.wide_treelet_intersect_tris(ntl, rays,
                                          native_bvh.prim_ids.to(dev))
    ph_, nh_ = torch.isfinite(hit.t), torch.isfinite(nhit.t)
    both = ph_ & nh_
    flips = ph_ != nh_
    t_diff = both & (bits(hit.t) != bits(nhit.t))
    off = torch.nonzero(flips | t_diff).squeeze(1)
    cross = dict(native_hits=int(nh_.sum()), port_hits=n_hits,
                 mask_flips=int(flips.sum()), t_differs=int(t_diff.sum()),
                 prim_id_ties=int((both & ~t_diff
                                   & (hit.prim_id != nhit.prim_id)).sum()))
    log(f"# primary render, port's tree vs native tree: {cross}")
    if off.numel() > EDGE_BUDGET:
        raise AssertionError("renders of the port's and the native tree "
                             "disagree beyond the edge budget")
    if off.numel():
        # each differing ray once more with the robust slab test on both
        # trees: the fast form can cull a box that a grazing ray enters,
        # so it may only miss the closest hit, and the robust form must
        # give both trees the same closest hit. The port's fast t is that
        # hit or a miss; the native tree's is that hit or a later one
        roff = Ray(rays.org[off], rays.dir[off], rays.tmin[off],
                   rays.tmax[off])
        a = wt.wide_treelet_intersect_tris(tl, roff, prim_ids, robust=True)
        b = wt.wide_treelet_intersect_tris(ntl, roff,
                                           native_bvh.prim_ids.to(dev),
                                           robust=True)
        pt, nt = hit.t[off], nhit.t[off]
        exact_p, exact_n = bits(pt) == bits(a.t), bits(nt) == bits(a.t)
        culled = dict(
            robust_t_equal=same(a.t, b.t),
            port_exact_or_miss=bool((exact_p | torch.isinf(pt)).all()),
            native_not_before_robust=bool((nt >= a.t).all()),
            one_tree_exact=bool((exact_p | exact_n).all()))
        log(f"#   differing rays {off.tolist()}: port t {pt.tolist()} "
            f"prim {hit.prim_id[off].tolist()}; native t {nt.tolist()} "
            f"prim {nhit.prim_id[off].tolist()}; robust form: port t "
            f"{a.t.tolist()}, native t {b.t.tolist()}; {culled}")
        if not all(culled.values()):
            raise AssertionError("a ray differs between the two trees' "
                                 "renders by more than a fast-slab cull")

    # ---- 10. timing -----------------------------------------------------
    def render():
        return wt.wide_treelet_intersect_tris(tl, rays, prim_ids)

    def shadow():
        return wt.wide_treelet_intersect_tris(tl, srays, prim_ids,
                                              any_hit=True)

    for name, fn, ref in (("primary", render, hit), ("shadow", shadow, shit)):
        ms, last = time_ms(fn, 10)
        if not same(tuple(last[:5]), tuple(ref[:5])):
            raise AssertionError(f"timed {name} renders diverged from "
                                 "the verified run")
        timings[f"{name}_ms"] = ms
        log(f"# {name} render: {ms:.3f} ms/render, "
            f"{R / ms / 1e3:.3f} Mrays/s (last output == verified run)")

    b1_kw = dict(any_hit=False, robust=False, stack_depth=sd)
    for name, fn, n, ref in (
            ("b2_kernel", lambda: col.collect_portals(
                tl.top_node_t, packed, tl.top_root, **b2_kw), 20, k_out),
            ("b2_plain", lambda: col.collect_portals_ref(
                tl.top_node_t, packed, tl.top_root, **b2_kw), 2, k_out),
            ("b1_kernel", lambda: wt.traverse_pairs(
                tl.table_cols, ptid, prays, **b1_kw), 20, b1_ref),
            ("b1_plain", lambda: wt.traverse_pairs_ref(
                tl.table, ptid, prays, **b1_kw), 2, b1_ref),
            ("b3_kernel", lambda: gk.group_forest_build(
                pf, plan.counts, **b3_kw), 10, b3_out),
            ("b3_plain", lambda: gk.group_forest_build_ref(
                pf, plan.counts, **b3_kw), 2, b3_out),
            ("b3bfs_kernel", lambda: gk.group_forest_build(
                pf, plan.counts, variant="bfs", **b3_kw), 10, bfs_out),
            ("b3bfs_plain", lambda: bfs_plain(pf, plan, b3_kw), 2, bfs_out)):
        ms, last = time_ms(fn, n)
        if not same(last, ref):
            raise AssertionError(f"timed {name} output diverged")
        timings[f"{name}_ms"] = ms
        log(f"# {name}: {ms:.3f} ms/call (last output == verified run)")
    log(f"# B3 at G={plan.G} P={plan.P}: {timings['b3_kernel_ms']:.4f} ms "
        f"({b3_occ} CTAs an SM); B1 round 1, {ptid.numel()} pairs: "
        f"{timings['b1_kernel_ms']:.4f} ms")

    # the device build stage by stage, CUDA events between the stages
    stage_names = ("staging", "b3", "assemble", "reinsertion")
    stage_ms = {k: [] for k in stage_names + ("total",)}
    for _ in range(BUILD_REPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        p_ = mtf.staging_plan(cc)
        pf_, base_ = mtf.pack_groups(mn, mx, cc, p_)
        ev[1].record()
        out_ = gk.group_forest_build(pf_, p_.counts, **b3_kw)
        ev[2].record()
        pre_ = mtf.assemble(*out_, base_, p_)
        ev[3].record()
        st = {}
        tree_ = optimize_reinsertion(pre_, stats=st)
        ev[4].record()
        torch.cuda.synchronize()
        for i, k in enumerate(stage_names):
            stage_ms[k].append(ev[i].elapsed_time(ev[i + 1]))
        stage_ms["total"].append(ev[0].elapsed_time(ev[4]))
        if not same_tree(tree_, tree):
            raise AssertionError("a timed build diverged from the verified one")
    log(f"# device build per stage, ms over {BUILD_REPS} builds (last tree == "
        f"verified): " + ", ".join(
            f"{k} {', '.join(f'{v:.3f}' for v in vs)}"
            for k, vs in stage_ms.items())
        + f"; reinsertion steps {st['steps']}; native host build "
        f"{native_s * 1e3:.3f} ms")

    # the bounds of B1-B3 at the shapes timed above, from the kernels'
    # own counts: B2's recorded portals; B1's active steps per pair and
    # the table columns its pairs visit; B3's 3*dim float rows of the
    # groups' lanes (not the staging's padding rows and lanes)
    pcnt = int(k_out[2][0].sum())
    bounds = {"b2": bound(nbytes(packed, *k_out)
                          + min(nbytes(tl.top_node_t), 56 * pcnt // 2),
                          OPS_PORTAL * pcnt)}
    asteps = int(b1_ref[1][1].sum())
    b1_cols = visited_bytes(tl.table_cols, ptid, prays, b1_ref, **b1_kw)
    bounds["b1"] = bound(nbytes(ptid, prays, *b1_ref) + b1_cols,
                         OPS_WIDE_STEP * asteps)
    b3_in = 3 * plan.dim * int(plan.counts.sum()) * pf.element_size()
    bounds["b3"] = bound(b3_in + nbytes(plan.counts, *b3_out), b3w["ops"])
    bounds["b3bfs"] = bounds["b3"]  # the same outputs; row 3 is in nbi
    log(f"# B1 round 1 visits {b1_cols // 256} of {tl.table_cols.shape[0]} x "
        f"{tl.table_cols.shape[1]} table columns; B3 reads {b3_in} bytes of "
        f"{nbytes(pf)} staged")
    for k, (ms, by) in bounds.items():
        log(f"# bound of {k} at the timed shapes: {ms:.4f} ms ({by})")

    # ---- 10 (T2, T3). the render profilers on the primary render ------
    from bvh_tpu_torch.tools import profile_occupancy, profile_r3

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    t2 = profile_r3.run(tl, rays, dev)
    t2["launches"] = launch_counts()
    kernels.reset_launch_counts()
    t3 = profile_occupancy.run(tl, rays, dev)
    t3["launches"] = launch_counts()
    b1_args = t3["round_one"]["b1"][0]
    if not (same(b1_args[1], ptid) and same(b1_args[2], prays)):
        raise AssertionError("T3's round-1 pairs are not phase 6's")
    log(f"# T2 and T3 in {time.perf_counter() - t0:.1f} s; launches: T2 "
        f"{t2['launches']}, T3 {t3['launches']}")

    # ---- 11-13. the CLI: Cornell through B5, B5 on the 262K tree, the
    # ---- San-Miguel-class two-level render through B4 ----------------
    os.makedirs(OUT_DIR, exist_ok=True)
    b5 = cornell_cli_phase()
    b5_262k = b5_full_phase(tree, flat, rays, hit, tl)
    high_hit = b5_262k["hit"]
    del tl, ntl, nhit, shit, srays, spacked
    torch.cuda.empty_cache()
    b4 = two_level_phase()
    big_sc, big_tl = b4.pop("scene"), b4.pop("tl")
    torch.cuda.empty_cache()

    # ---- 14-16. dims through B6, float64, lbvh and the wide layout ----
    b6 = dims_phase()
    f64_phase()
    lbvh_wide_phase(tree, flat, rays, high_hit, mn, mx, cc)

    # ---- 17. the profiling tools' kernels T6, T5, T1 --------------------
    t17 = tool_kernels_phase()

    # ---- 18. par/ on two gloo ranks, the examples, the native bindings --
    torch.cuda.empty_cache()
    par = par_phase()
    print(json.dumps({"par": {
        "card": par["card"], "examples": par["examples"],
        "native_golden_rays_differing": par["native_bad"],
        "ranks": [{k: o[k] for k in (
            "rank", "device", "share", "nodes", "stages", "traversal",
            "executor_ms")} | {
            k: o[k] for k in ("single_build_ms", "single_traversal_ms",
                              "ray_stride", "equal_to_single_build")
            if k in o} for o in par["ranks"]]}}), flush=True)

    # ---- 19. the tools for building, rendering and dims -----------------
    from bvh_tpu_torch.tools.bench_wide import WideScene

    t19 = tools_phase((mn, mx, cc), WideScene(tris, tree, flat, rays),
                      native_bvh, t3["round_one"], big_sc, big_tl)
    big_rays = big_sc.rays
    del big_sc
    print(json.dumps({"tools": {k: t19[k] for k in (
        "seconds", "tool_seconds", "launches_total", "card")}}), flush=True)

    # ---- 20. the last five tools and the driver entry ---------------
    t20 = last_tools_phase(WideScene(tris, tree, flat, rays))
    print(json.dumps({"tools20": {k: t20[k] for k in (
        "seconds", "tool_seconds", "launches", "card")}}), flush=True)

    # ---- 21. the one-program render: the chain as one CUDA graph ------
    t21 = one_program_phase(tree, flat, tris, big_tl)

    # ---- 22. the portal ordering kernel against the plain ordering ----
    t22 = portal_sort_phase(tree, flat, tris, big_tl, big_rays)
    del big_tl, big_rays
    print(json.dumps({"portal_sort": t22}), flush=True)
    one_program = {name: {k: t21[name][k] for k in (
        "hits", "rounds", "sel_cap", "tail_cap", "eager", "eager_launches",
        "capture_launches", "graph_nodes", "steady_ms", "fixed_cost_ms",
        "entry_point_ms", "traces")} for name in ("primary", "shadow")}
    print(json.dumps({"one_program": dict(
        one_program, seconds=t21["seconds"], card=t21["card"])}), flush=True)
    log(f"# card: {card_line()}")

    def entry(k, source, replaces, key, n, **extra):
        return {"name": k.name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": err[key],
                "ms": timings[f"{key}_kernel_ms"],
                "plain_ms": timings[f"{key}_plain_ms"],
                "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                "library_ms": None, **extra}

    def tool_entry(name, source, replaces, launches, max_err, m,
                   library_ms=None, **extra):
        """A tool's row: its kernel's launches within the tool (by
        kernel), the error against the plain version, and the times and
        bound in `m` (ms, plain_ms, bound)."""
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(launches.values()),
                "max_abs_err": max_err, "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound"][0],
                "bound_by": m["bound"][1], "library_ms": library_ms,
                "launches_by_kernel": launches, **extra}

    def chain_launches(k):
        """Phase 21's launches of kernel k: in one verified eager render,
        in the chain's run (the verified eager render, the verified
        `_render_fixed`, the capture), and during the capture alone."""
        return {name: {"eager_render": t21[name]["eager_launches"].get(
            k.name, 0), "chain": t21[name]["chain_launches"].get(k.name, 0),
            "capture": t21[name]["capture_launches"].get(k.name, 0)}
            for name in ("primary", "shadow")}

    def ordering_entry(k, m, launches, **extra):
        """Phase 22's row of a portal ordering kernel: times and bound
        in `m`, launches in the entry point's render (`launches`)."""
        return {"name": k.name, "route": "cuda",
                "source": "bvh_tpu_torch/csrc/portal_sort.cu",
                "replaces": "none: bvh_tpu orders portals with jax.lax.sort "
                "(bvh_tpu/traverse/wide_treelet.py:1892, A2's merge "
                ":1840-1873)", "launches": launches[k.name],
                "max_abs_err": 0.0, "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": m["library_ms"], **extra}

    err["b5"], err["b4"], err["b6"] = b5["err"], b4["err"], b6["err"]
    for key, d_ in (("b5", b5_262k), ("b4", b4), ("b6", b6)):
        timings[f"{key}_kernel_ms"] = d_["ms"]
        timings[f"{key}_plain_ms"] = d_["plain_ms"]
        bounds[key] = (d_["bound_ms"], d_["bound_by"])
    device_timing = ("ms: the device's own time, queued behind a head "
                     "start, median of 21; host_loop_ms: the mean of a "
                     "loop of calls through the wrapper")
    return {"kernels": [
        entry(kernels.COLLECT, "bvh_tpu_torch/csrc/collect.cu",
              "bvh_tpu/traverse/collect.py:25", "b2",
              launches[kernels.COLLECT.name],
              one_program=chain_launches(kernels.COLLECT)),
        entry(kernels.WIDE_TREELET, "bvh_tpu_torch/csrc/wide_treelet.cu",
              "bvh_tpu/traverse/wide_treelet.py:741", "b1",
              launches[kernels.WIDE_TREELET.name],
              one_program=chain_launches(kernels.WIDE_TREELET)),
        entry(kernels.GROUP_BUILD, "bvh_tpu_torch/csrc/group_build.cu",
              "bvh_tpu/build/group_kernel.py:383", "b3",
              launches[kernels.GROUP_BUILD.name]),
        entry(kernels.GROUP_BUILD, "bvh_tpu_torch/csrc/group_build.cu",
              "bvh_tpu/build/group_kernel.py:77", "b3bfs",
              bfs_launches[kernels.GROUP_BUILD.name],
              name=f"{kernels.GROUP_BUILD.name} (variant bfs)",
              row3="bvh_tpu_torch/build/group_kernel.py bfs_queue_row",
              shape="phase 4's full 262K staging; ms: B3 and the queue row"),
        entry(kernels.COLLECT_SUPER, "bvh_tpu_torch/csrc/collect.cu",
              "bvh_tpu/traverse/wide_treelet.py:1158", "b4",
              b4["launches"][kernels.COLLECT_SUPER.name],
              host_loop_ms=b4["host_loop_ms"], pairs=b4["pairs"],
              work=b4["work"], timing=device_timing),
        entry(kernels.BINARY_TRAVERSE,
              "bvh_tpu_torch/csrc/binary_traverse.cu",
              "bvh_tpu/traverse/pallas_kernel.py:93", "b5",
              b5_262k["launches"], host_loop_ms=b5_262k["host_loop_ms"],
              shape="the 262K tree, 1,048,576 primary rays, fast slab "
              "(phase 12); launches through pallas_intersect_tris",
              diag=b5_262k["diag"], timing=device_timing,
              cornell={k: b5[k] for k in (
                  "launches", "ms", "host_loop_ms", "plain_ms", "bound_ms",
                  "bound_by", "work")}),
        entry(kernels.SPHERE_TRAVERSE,
              "bvh_tpu_torch/csrc/binary_traverse.cu",
              "bvh_tpu/traverse/pallas_sphere.py:88", "b6", b6["launches"],
              per_dim=b6["per_dim"]),
        ordering_entry(
            kernels.PORTAL_SORT, t22["262k"], t22["262k"]["launches"],
            shape="the 262K tree, 1,048,576 primary rays (phase 22); "
            "launches in the entry point's render of them",
            launches_two_level=t22["10m"]["launches"],
            split={k: t22["10m"][k] for k in (
                "rays_with_portals", "max_portals", "records", "ms",
                "plain_ms", "library_ms", "bound_ms", "bound_by")},
            timing=device_timing),
        ordering_entry(
            kernels.PORTAL_MERGE, t22["10m"]["merge"], t22["10m"]["launches"],
            shape="the first A2 round of phase 13's San-Miguel-class "
            "render; launches in the entry point's render (one an A2 "
            "round)", timing="ms, plain_ms: CUDA events around the call, "
            "median of 21; library_ms: the device's own time, median of 21"),
        tool_entry("T1 traverse_pairs_ablate (B1's variants)",
                   "bvh_tpu_torch/csrc/wide_treelet.cu",
                   "tools/ablate_kernel.py:97",
                   {kernels.WIDE_TREELET_ABLATE.name:
                    t17["launches"][kernels.WIDE_TREELET_ABLATE.name]},
                   0.0, t17["t1"], us_per_step=t17["t1"]["us_per_step"]),
        tool_entry("T2 profile_r3 (collect_portals timed in the render)",
                   "bvh_tpu_torch/csrc/collect.cu",
                   "tools/profile_r3.py:119", t2["launches"], err["b2"],
                   dict(ms=t2["stages"]["phase_a"],
                        plain_ms=timings["b2_plain_ms"], bound=bounds["b2"]),
                   stage_ms=t2["stages"], stage_sum_ms=t2["stage_sum"],
                   render_ms=t2["whole_ms"], trace=t2["trace"]),
        tool_entry("T3 profile_occupancy (traverse_pairs on round 1)",
                   "bvh_tpu_torch/csrc/wide_treelet.cu",
                   "tools/profile_occupancy.py:83", t3["launches"],
                   err["b1"], dict(ms=t3["round_one"]["b1_ms"],
                                   plain_ms=timings["b1_plain_ms"],
                                   bound=bounds["b1"]),
                   simt_efficiency=t3["simt"]),
        tool_entry("T4 profile_sm (collect_portals at San-Miguel class)",
                   "bvh_tpu_torch/csrc/collect.cu",
                   "tools/profile_sm.py:169", b4["t4"]["launches"],
                   b4["t4"]["err"], dict(ms=b4["t4"]["phase_a_ms"],
                                         plain_ms=b4["t4"]["plain_ms"],
                                         bound=b4["t4"]["bound"]),
                   render_ms=b4["t4"]["render_ms"],
                   intercept_ms=b4["t4"]["intercept_ms"],
                   slope_ms=b4["t4"]["slope_ms"]),
        tool_entry("T5 wide_step_probe", "bvh_tpu_torch/csrc/probes.cu",
                   "tools/probe_tpu.py:147",
                   {kernels.WIDE_STEP_PROBE.name:
                    t17["launches"][kernels.WIDE_STEP_PROBE.name]},
                   0.0, t17["t5"], us_per_iter=t17["t5"]["per_iter"],
                   timing=("ms: the device's own time, queued behind a "
                           "head start, median of 21; host_loop_ms: the "
                           "mean of 10 calls through the wrapper"),
                   host_loop_ms=t17["t5"]["host_loop_ms"],
                   sm_clock_mhz=t17["t5"]["sm_clock_mhz"],
                   cycles_per_step=t17["t5"]["cycles_per_step"],
                   cycles_per_iter=t17["t5"]["cycles_per_iter"],
                   launch=t17["t5"]["launch"]),
        tool_entry("T6 column_fetch", "bvh_tpu_torch/csrc/probes.cu",
                   "tools/probe_int8_fetch.py:65",
                   {kernels.COLUMN_FETCH.name:
                    t17["launches"][kernels.COLUMN_FETCH.name]},
                   0.0, t17["t6"], library_ms=t17["t6"]["library_ms"],
                   us_per_fetch=t17["t6"]["us_per_fetch"],
                   kernel_us_per_fetch=t17["t6"]["kernel_us_per_fetch"],
                   per_dtype=t17["t6"]["per_dtype"], timing=(
                       "ms, library_ms: the device's own time, queued "
                       "behind a head start, medians of 21; "
                       "kernel_ms_with_host: with the wrapper's host time"),
                   kernel_ms_with_host=t17["t6"]["ms_host"],
                   column_copy_ms=t17["t6"]["copy_ms"],
                   launch_floor_ms=t17["t6"]["floor_ms"]),
    ]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    print(json.dumps(run()))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
