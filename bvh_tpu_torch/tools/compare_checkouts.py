"""Kernels B6 and T6 of several checkouts of this repo, timed on one card
in one call, each checkout in a process of its own, in the order given
(name one twice to bracket another: A B B A):

    python -m bvh_tpu_torch.tools.compare_checkouts DIR [DIR ...]

A checkout is a directory that holds `bvh_tpu_torch/` and
`chip_smoke.py`, such as an earlier commit unpacked with `git archive`
into a directory that git ignores. Each process imports that checkout's
package, builds its kernels, and times:
- B6 on `chip_smoke.py`'s phase 14 scale case (262,144 spheres built by
  `build_default(MEDIUM)`, 1,048,576 rays, closest hit, fast slab) per
  dim, in coherence order and unsorted, as phase 14 times it
  (`chip_smoke.time_ms`: the mean of 10 calls after one), three times;
- T6 at its tool's shapes in both dtypes, and the window product beside
  it: the device's own time, the median of 21 calls, each queued behind
  a head start (as `timing.time_calls(..., queued=True)`). A checkout
  whose T6 reads the [rows, P] table (one without `column_copy`) has its
  kernel launched without its wrapper, whose idx range check waits for
  the device.
Each process checks T6 against its plain version and prints a digest of
B6's outputs, so that outputs equal across checkouts show equal
digests, and ends with one JSON line of its times.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys

HEAD_START_CYCLES = 2_000_000  # as tools/timing.py
REPS = 21


def queued_ms(fn, n: int = REPS):
    """Median device ms of n calls of `fn`, each queued behind a head
    start; and the last call's output."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        torch.cuda._sleep(HEAD_START_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.median(ts), out


def digest(*ts) -> str:
    h = hashlib.sha1()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_b6(smoke) -> dict:
    """B6 per dim on phase 14's scale case of this checkout."""
    import numpy as np
    import torch

    from bvh_tpu_torch.build.default import DefaultConfig, Quality, build_default
    from bvh_tpu_torch.traverse import sphere_kernel as sk
    from bvh_tpu_torch.traverse import wide_treelet as wt
    from bvh_tpu_torch.traverse.stack import required_stack_depth

    res = {}
    for dim in (2, 3, 4):
        scale = (smoke.DIMS_M / smoke.SCALE_M) ** (1.0 / dim)
        rng = np.random.default_rng(100 + dim)
        cb = torch.from_numpy(rng.uniform(-1, 1, (smoke.SCALE_M, dim))
                              .astype(np.float32)).cuda()
        rb = torch.from_numpy((rng.uniform(0.02, 0.1, smoke.SCALE_M) * scale)
                              .astype(np.float32)).cuda()
        tb = build_default(cb - rb[:, None], cb + rb[:, None], cb,
                           DefaultConfig(quality=Quality.MEDIUM))
        rays = smoke.sphere_rays(rng, smoke.SCALE_RAYS, dim)
        tables = sk.make_tables(tb, cb, rb)
        packed = wt.pack_rays(rays)
        kw = dict(any_hit=False, robust=False,
                  stack_depth=max(16, required_stack_depth(tb)))
        order = sk.coherence_order(rays.org, rays.dir)
        spacked = packed[:, order].contiguous()
        runs, unsorted = [], []
        for _ in range(3):
            ms, (kf, ki) = smoke.time_ms(
                lambda: sk.sphere_traverse(tables, spacked, **kw), 10)
            runs.append(ms)
            unsorted.append(smoke.time_ms(
                lambda: sk.sphere_traverse(tables, packed, **kw), 10)[0])
        res[dim] = dict(ms=statistics.median(runs), runs=runs,
                        unsorted_ms=statistics.median(unsorted),
                        digest=digest(kf, ki))
        print(f"# B6 {dim}D: {statistics.median(runs):.4f} ms sorted "
              f"({', '.join(f'{x:.4f}' for x in runs)}), "
              f"{res[dim]['unsorted_ms']:.4f} unsorted; outputs "
              f"{res[dim]['digest']}", flush=True)
    return res


def time_t6() -> dict:
    """T6 and the window product at the tool's shapes, both dtypes."""
    import torch

    from bvh_tpu_torch import kernels
    from bvh_tpu_torch.tools import probe_int8_fetch as t6

    res = {}
    tab_bf, tab_i8, idx = t6.make_inputs(device="cuda")
    for name, tab in (("bf16", tab_bf), ("int8", tab_i8)):
        rows, p = tab.shape
        ref = t6.column_fetch_ref(tab, idx, t6.ITERS)
        if hasattr(t6, "column_copy"):
            cols = t6.column_copy(tab)

            def fn():
                return t6.column_fetch(cols, idx, t6.ITERS, rows)
        else:
            out = torch.empty_like(ref)

            def fn():
                kernels.COLUMN_FETCH.launch(
                    tab.data_ptr(), int(tab.dtype == torch.int8), rows, p,
                    idx.data_ptr(), idx.numel(), t6.ITERS, out.data_ptr())
                return out
        ms, last = queued_ms(fn)
        if not torch.equal(last, ref):
            raise AssertionError(f"T6 ({name}) differs from its plain version")
        win = t6.window_matrix(idx, p, t6.ITERS, tab.dtype)
        win_ms = queued_ms(lambda: t6._product(tab, win))[0]
        res[name] = dict(ms=ms, window_ms=win_ms)
        print(f"# T6 {name}: {ms * 1e3:.2f} us a call, equal to plain; "
              f"window product {win_ms * 1e3:.2f} us (device time, medians "
              f"of {REPS})", flush=True)
    return res


def one(tree: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import bvh_tpu_torch
    import chip_smoke

    if not bvh_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {bvh_tpu_torch.__file__}, not {tree}")
    out = dict(tree=tree, b6=time_b6(chip_smoke), t6=time_t6())
    print(json.dumps(out), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2])
        return 0
    if len(sys.argv) < 2 or sys.argv[1].startswith("-"):
        print(__doc__)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        end="", flush=True)
    rc = 0
    for tree in map(os.path.abspath, sys.argv[1:]):
        print(f"== {tree}", flush=True)
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree], cwd=tree).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
