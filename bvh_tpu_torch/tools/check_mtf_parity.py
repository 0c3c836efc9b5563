"""Parity of the two mini-tree builds at scale, the counterpart of
tools/check_mtf_parity.py: `build_minitree` (level-synchronous) and
`build_minitree_fast` (kernel B3) on sponza_class(n, 0) (boxes
`(min + max) / 2` centred, as the JAX tool builds them) at
`MiniTreeConfig()` must give the same tree bit for bit: node count,
prim ids, bounds and index words. It prints the mismatches and exits 1
if any.

    python -m bvh_tpu_torch.tools.check_mtf_parity [--n 262144]
        [--device cpu]

On the CPU use small sizes (`--n 3000`).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from bvh_tpu_torch.build.minitree import MiniTreeConfig, build_minitree
from bvh_tpu_torch.build.minitree_fast import build_minitree_fast
from bvh_tpu_torch.tools.timing import log, sync


def parity_boxes(n: int, device, seed: int = 0):
    """sponza_class(n, seed)'s boxes with centres (min + max) / 2 in
    float32, as tools/check_mtf_parity.py:21-23."""
    from bvh_tpu_torch.io.scenes import sponza_class

    tris = sponza_class(n, seed=seed)
    mn = torch.from_numpy(np.ascontiguousarray(tris.min(axis=1))).to(device)
    mx = torch.from_numpy(np.ascontiguousarray(tris.max(axis=1))).to(device)
    return mn, mx, (mn + mx) * 0.5


def run(n: int = 262_144, device="cuda", boxes=None) -> dict:
    """Both builds and their mismatch counts; "equal" is True when the
    trees agree bit for bit."""
    if boxes is None:
        boxes = parity_boxes(n, device)
    cfg = MiniTreeConfig()
    trees, secs = {}, {}
    for name, fn in (("fast", build_minitree_fast), ("exact", build_minitree)):
        sync(device)
        t0 = time.perf_counter()
        trees[name] = fn(*boxes, cfg)
        sync(device)
        secs[name] = time.perf_counter() - t0
    fast, ref = trees["fast"], trees["exact"]
    nc = min(fast.node_count, ref.node_count)
    res = dict(
        nodes=(fast.node_count, ref.node_count), seconds=secs,
        prim_mismatches=int((fast.prim_ids != ref.prim_ids).sum()),
        bounds_rows=int((fast.bounds[:nc].view(torch.int32)
                         != ref.bounds[:nc].view(torch.int32)).any(1).sum()),
        index_rows=int((fast.index[:nc] != ref.index[:nc]).sum()),
        fast=fast, exact=ref)
    res["equal"] = (fast.node_count == ref.node_count
                    and res["prim_mismatches"] == 0
                    and res["bounds_rows"] == 0 and res["index_rows"] == 0)
    log(f"# check_mtf_parity n={boxes[2].shape[0]}: build_minitree_fast "
        f"{secs['fast']:.2f} s, build_minitree {secs['exact']:.2f} s; nodes "
        f"{res['nodes']}; prim mismatches {res['prim_mismatches']}, bounds "
        f"rows {res['bounds_rows']}, index rows {res['index_rows']}: "
        + ("equal bit for bit" if res["equal"] else "DIFFER"))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    return 0 if run(args.n, args.device)["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
