"""Kernels B4, B5, B6, T5 and T6 of several checkouts of this repo, timed
on one card in one call, each checkout in a process of its own, in the
order given (name one twice to bracket another: A B B A):

    python -m bvh_tpu_torch.tools.compare_checkouts
        [--kernels b4,b5,b6,t5,t6] DIR [DIR ...]

A checkout is a directory that holds `bvh_tpu_torch/` and
`chip_smoke.py`, such as an earlier commit unpacked with `git archive`
into a directory that git ignores. Each process imports that checkout's
package, builds its kernels, and times:
- B4 on the first A2 round of `chip_smoke.py`'s phase 13 (the
  San-Miguel-class scene, 118,456 (ray, super) pairs) and B5 on phase
  11's Cornell box (-q high, robust; and its first 32 rays, a launch's
  fixed cost) and phase 12's 262K tree (fast):
  the inputs are made once, by this file's own checkout, and saved
  to `_archive/b45_inputs.npz` (git ignores `_archive/`), so the 10M
  build runs once; each checkout makes its own tables from them. Each
  kernel is timed both ways: `chip_smoke.time_ms`' host loop (the mean
  of 20 calls after one, wrapper included) and the device's own time
  (the median of 21 calls, each queued behind a head start, as
  `timing.time_calls(..., queued=True)`);
- B6 on `chip_smoke.py`'s phase 14 scale case (262,144 spheres built by
  `build_default(MEDIUM)`, 1,048,576 rays, closest hit, fast slab) per
  dim, in coherence order and unsorted, as phase 14 times it
  (`chip_smoke.time_ms`: the mean of 10 calls after one), three times;
- T5 on `hitting_inputs` with sort8, one chain and 512 iterations, at
  `chip_smoke.py`'s timed B = 2,048, C = 128 (checked against its plain
  version) and at `FULL_CARD`'s 262,144 lanes: the device's own time,
  as above;
- T6 at its tool's shapes in both dtypes, and the window product beside
  it: the device's own time, as above. A checkout whose T6 reads the
  [rows, P] table (one without `column_copy`) has its kernel launched
  without its wrapper, whose idx range check waits for the device.
Each process checks T5 and T6 against their plain versions and prints
a digest of B4's, B5's, B6's and T5's outputs, so that outputs equal
across checkouts show equal digests, and ends with one JSON line of its
times.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys

# the checkout that holds this file, which makes B4's and B5's inputs
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HEAD_START_CYCLES = 2_000_000  # as tools/timing.py
REPS = 21
KERNELS = ("b4", "b5", "b6", "t5", "t6")
INPUTS = os.path.join("_archive", "b45_inputs.npz")


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


def time_t5() -> dict:
    """T5 at the timed config and at FULL_CARD's lanes, sort8, one chain,
    512 iterations, on inputs that hit."""
    import torch

    from bvh_tpu_torch.tools import probe_tpu as t5

    res = {}
    kw = dict(sort8=True, chains=1, stack_depth=t5.STACK_DEPTH, iters=t5.LO)
    for name, B, C in (("timed", 2048, 128),
                       ("full_card", *t5.FULL_CARD[:2])):
        table, rays = (x.cuda() for x in t5.hitting_inputs(B, C))

        def fn():
            return t5.wide_step_probe(table, rays, **kw)

        ms, last = queued_ms(fn)
        if name == "timed":
            ref = t5.wide_step_probe_ref(table, rays, **kw)
            if not torch.equal(last.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError("T5 differs from its plain version")
        res[name] = dict(ms=ms, digest=digest(last))
        print(f"# T5 {name} (B={B}, C={C}): {ms:.4f} ms device time "
              f"(median of {REPS}, queued); outputs {res[name]['digest']}",
              flush=True)
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


def _tree_arrays(out: dict, key: str, bvh, flat, packed, **kw) -> None:
    out.update({f"{key}_bounds": bvh.bounds, f"{key}_index": bvh.index,
                f"{key}_prim_ids": bvh.prim_ids, f"{key}_flat": flat,
                f"{key}_rays": packed})
    out[f"{key}_meta"] = json.dumps(dict(
        node_count=int(bvh.node_count), prim_count=int(bvh.prim_count), **kw))


def prepare(path: str) -> None:
    """B4's and B5's inputs, made with this checkout's code on the card
    and saved to `path` in layouts that every checkout reads: the
    Cornell box through the CLI at -q high (phase 11), the 262K tree of
    the port's quality-high build with its 1024x1024 primary rays
    (phases 5 and 12), and the first A2 round of the San-Miguel-class
    scene through the CLI (phase 13), with the super tables as
    [S, 16, Ps]."""
    import numpy as np
    import torch

    import chip_smoke as smoke
    from bvh_tpu_torch.build.minitree_fast import build_minitree_fast
    from bvh_tpu_torch.build.reinsertion import optimize_reinsertion
    from bvh_tpu_torch.cli import benchmark as cli
    from bvh_tpu_torch.cli.camera import primary_rays
    from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
    from bvh_tpu_torch.io.obj import load_obj
    from bvh_tpu_torch.io.scenes import scene_camera, sponza_class
    from bvh_tpu_torch.traverse import wide_treelet as wt
    from bvh_tpu_torch.traverse.stack import required_stack_depth

    out: dict = {}
    obj = os.path.join(smoke.HERE, "tests", "golden", "cornell.obj")
    args = smoke.cli_args([obj, "--eye", "0", "1", "2", "--dir", "0", "0",
                           "-1", "--up", "0", "1", "0", "-p",
                           "--robust-traversal", "-q", "high", "-w",
                           str(smoke.SIDE), "--height", str(smoke.SIDE),
                           "-o", os.devnull])
    res = cli.run(*load_obj(obj), args)
    _tree_arrays(out, "cornell", res.bvh, res.flat, wt.pack_rays(res.rays),
                 permuted=True, robust=True,
                 stack_depth=max(16, required_stack_depth(res.bvh)))

    tris = sponza_class(smoke.N_TRIS, seed=0)
    mn, mx, cc = (torch.from_numpy(a).cuda() for a in (
        tris.min(axis=1), tris.max(axis=1), tris.mean(axis=1)))
    tree = optimize_reinsertion(build_minitree_fast(mn, mx, cc))
    tt = torch.from_numpy(tris)
    flat = PrecomputedTri.from_tri(Tri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
    rays = primary_rays(*scene_camera(tris), smoke.SIDE, smoke.SIDE,
                        device="cuda")
    _tree_arrays(out, "sponza", tree, flat, wt.pack_rays(rays),
                 permuted=False, robust=False,
                 stack_depth=required_stack_depth(tree))

    tris = sponza_class(smoke.N_BIG, seed=0)
    eye, d, up = scene_camera(tris)
    args = smoke.cli_args(["sponza_class.obj", "-q", "high", "-w",
                           str(smoke.SIDE), "--height", str(smoke.SIDE),
                           "-o", os.devnull],
                          eye=[float(x) for x in eye],
                          dir=[float(x) for x in d], up=[float(x) for x in up])
    res = cli.run(tris[:, 0], tris[:, 1], tris[:, 2], args)
    first, _ = smoke.first_a2_round(res.tl, wt.pack_rays(res.rays))
    out.update(b4_sup_table=res.tl.sup_table,
               b4_sid=first["sid"], b4_rays=first["rays"],
               b4_meta=json.dumps(first["kw"]))
    np.savez(path, **{k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                      else v for k, v in out.items()})
    print(f"# inputs saved to {path}: B4 {first['sid'].numel()} pairs, "
          f"{first['kw']}", flush=True)


def _both_ways(smoke, name: str, fn) -> dict:
    """`fn` timed as the host loop (`smoke.time_ms`, 20 calls) and as the
    device's own time (`queued_ms`), with its outputs' digest; raises if
    a timed call's output differs from the first call's."""
    first = fn()
    host_ms, last_h = smoke.time_ms(fn, 20)
    dev_ms, last_d = queued_ms(fn)
    if not (smoke.same(last_h, first) and smoke.same(last_d, first)):
        raise AssertionError(f"{name}: a timed output differs")
    out = dict(ms=dev_ms, host_ms=host_ms, digest=digest(*first))
    print(f"# {name}: {dev_ms:.4f} ms device time (median of {REPS}, "
          f"queued), {host_ms:.4f} ms host loop; outputs {out['digest']}",
          flush=True)
    return out


def time_b5(smoke, z) -> dict:
    """B5 on the Cornell box and on the 262K tree, with this checkout's
    tables."""
    import torch

    from bvh_tpu_torch.core.types import Bvh
    from bvh_tpu_torch.traverse import binary_kernel as bk

    res = {}
    for key in ("cornell", "sponza"):
        meta = json.loads(str(z[f"{key}_meta"]))

        def t(name):
            return torch.from_numpy(z[f"{key}_{name}"]).cuda()

        bvh = Bvh(t("bounds"), t("index"), t("prim_ids"), meta["node_count"],
                  meta["prim_count"])
        tables = bk.make_tables(bvh, t("flat"), permuted=meta["permuted"])
        packed = t("rays")
        kw = dict(any_hit=False, robust=meta["robust"],
                  stack_depth=meta["stack_depth"])
        res[key] = _both_ways(smoke, f"B5 {key} ({packed.shape[1]} rays)",
                              lambda: bk.binary_traverse(tables, packed, **kw))
        if key == "cornell":
            # a launch's fixed cost: one warp's rays
            few = packed[:, :32].contiguous()
            res["launch"] = _both_ways(
                smoke, "B5 cornell, its first 32 rays",
                lambda: bk.binary_traverse(tables, few, **kw))
    return res


def time_b4(smoke, z) -> dict:
    """B4 on the first A2 round, on this checkout's super-table layout
    (`WideTreelets.sup_cols` [S, Ps, 16] where it exists, else the
    [S, 16, Ps] `sup_table`)."""
    import torch

    from bvh_tpu_torch.traverse import collect as col
    from bvh_tpu_torch.traverse import wide_treelet as wt

    table = torch.from_numpy(z["b4_sup_table"]).cuda()
    if "sup_cols" in wt.WideTreelets._fields:
        table = table.transpose(1, 2).contiguous()
    sid = torch.from_numpy(z["b4_sid"]).cuda()
    rays = torch.from_numpy(z["b4_rays"]).cuda()
    kw = json.loads(str(z["b4_meta"]))
    return _both_ways(smoke, f"B4 ({sid.numel()} pairs)",
                      lambda: col.collect_super_pairs(table, sid, rays, **kw))


def one(tree: str, kernels: list[str], inputs: str) -> None:
    import numpy as np

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import bvh_tpu_torch
    import chip_smoke

    if not bvh_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {bvh_tpu_torch.__file__}, not {tree}")
    out: dict = dict(tree=tree)
    if "b4" in kernels or "b5" in kernels:
        with np.load(inputs) as z:
            if "b4" in kernels:
                out["b4"] = time_b4(chip_smoke, z)
            if "b5" in kernels:
                out["b5"] = time_b5(chip_smoke, z)
    if "b6" in kernels:
        out["b6"] = time_b6(chip_smoke)
    if "t5" in kernels:
        out["t5"] = time_t5()
    if "t6" in kernels:
        out["t6"] = time_t6()
    print(json.dumps(out), flush=True)


def main() -> int:
    argv = sys.argv[1:]
    if argv[:1] == ["--prepare"]:
        sys.path.insert(0, ROOT)
        prepare(argv[1])
        return 0
    if argv[:1] == ["--one"]:
        one(argv[1], argv[2].split(","), argv[3])
        return 0
    kernels = list(KERNELS)
    if argv[:1] == ["--kernels"]:
        kernels = argv[1].split(",")
        argv = argv[2:]
    if not argv or argv[0].startswith("-") or set(kernels) - set(KERNELS):
        print(__doc__)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        end="", flush=True)
    inputs = os.path.join(ROOT, INPUTS)
    if ({"b4", "b5"} & set(kernels)) and not os.path.exists(inputs):
        os.makedirs(os.path.dirname(inputs), exist_ok=True)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--prepare", inputs], cwd=ROOT).returncode
        if rc:
            return rc
    rc = 0
    for tree in map(os.path.abspath, argv):
        print(f"== {tree}", flush=True)
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree, ",".join(kernels), inputs],
                             cwd=tree).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
