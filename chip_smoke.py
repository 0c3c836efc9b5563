"""Card check of the PyTorch/CUDA port: drives the sponza-262K render
through the port's kernels on one CUDA device and verifies it.

    python3 chip_smoke.py

Phases (each prints its result; any failed check raises, so the script
exits non-zero):

1. device: the card's name and power limit (nvidia-smi), then the
   build of the CUDA kernels and of the native tree library;
2. scene: sponza_class(262144, 0), a quality-high tree from the native
   library (mini-tree + reinsertion, thread pool), its v2 bytes, the
   port's Bvh and the treelet tables on the card;
3. kernel B2 (phase-A collect) against its plain version on all
   1024 x 1024 primary rays: every output equal bit for bit;
4. kernel B1 (wide treelet traversal) against its plain version on the
   primary rays' first-round pairs, closest and any-hit: t, u, v, hit
   position, active steps and stack marks equal bit for bit;
5. the main path: the primary render (closest hit) and the shadow render
   (any-hit toward a point light) through the kernels, with launch
   counts reset before and read after;
6. B2 and B1 as in 3 and 4 on the shadow rays; then every 16th ray of
   both renders through the render driver with the plain versions, on
   the card: t, u, v, prim_pos and prim_id equal bit for bit;
7. timing with CUDA events, kernel beside plain version; the last
   output of every timed loop is compared with the verified run.

The second-to-last lines are a JSON object naming each kernel with its
launches, error and times, and the card's name and power limit; the
last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_TRIS = 262_144
SIDE = 1024
SUBSET = 16  # every 16th ray goes through the plain-version render
# Closest-hit count of the C++ oracle on bvh_tpu's own device-built tree
# for this scene and camera (BENCH_r05.json); the native tree differs,
# so this is printed for information only.
ORACLE_HITS_REFERENCE_TREE = 81_790


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def same(a, b) -> bool:
    """Bitwise equality of two tensors or tuples of tensors (so -0 and
    NaN payloads count too)."""
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and bool(torch.equal(bits(a), bits(b)))
    return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))


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


def run() -> dict:
    from bvh_tpu_torch import kernels
    from bvh_tpu_torch.api.native import NativeBvh3f
    from bvh_tpu_torch.cli.camera import primary_rays
    from bvh_tpu_torch.core.ray import Ray
    from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
    from bvh_tpu_torch.io.scenes import scene_camera, sponza_class
    from bvh_tpu_torch.io.serialize import deserialize_from_bytes
    from bvh_tpu_torch.traverse import collect as col
    from bvh_tpu_torch.traverse import wide_treelet as wt

    dev = "cuda"

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

    # ---- 2. scene, tree, tables ---------------------------------------
    tris = sponza_class(N_TRIS, seed=0)
    t0 = time.perf_counter()
    handle = native.build(tris.min(axis=1), tris.max(axis=1),
                          tris.mean(axis=1), quality=2,
                          threads=os.cpu_count() or 1)
    data = native.to_bytes(handle)
    native.destroy(handle)
    bvh = deserialize_from_bytes(data)
    log(f"# native quality-high build: {bvh.node_count} nodes, "
        f"{len(data)} v2 bytes, {time.perf_counter() - t0:.2f} s")
    tt = torch.from_numpy(tris)
    flat = PrecomputedTri.from_tri(Tri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
    t0 = time.perf_counter()
    tl = wt.build_wide_treelets(bvh, flat, device=dev)
    T, _, P = tl.table.shape
    log(f"# treelets: T={T} P={P} "
        f"top nodes={int((tl.top_node_t[12] != 0).sum())} "
        f"top_depth={tl.top_depth} wide_depth={tl.wide_depth} "
        f"supers={tl.sup_table.shape[0]} ({time.perf_counter() - t0:.2f} s)")
    if tl.sup_table.shape[0] != 0:
        raise AssertionError("the scene must have no super level")
    eye, d, up = scene_camera(tris)
    rays = primary_rays(eye, d, up, SIDE, SIDE, device=dev)
    R = SIDE * SIDE
    prim_ids = bvh.prim_ids.to(dev)
    caps = wt.wide_treelet_caps(tl)
    b2_kw = dict(robust=False, stack_depth=tl.top_depth + 1,
                 max_portals=caps["max_portals"])
    sd = 7 * tl.wide_depth + 8
    err = {"b2": 0.0, "b1": 0.0}

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
            kf, ki = wt.traverse_pairs(tl.table, ptid, prays, **kw)
            pf, pi = wt.traverse_pairs_ref(tl.table, ptid, prays, **kw)
            hk, hp = torch.isfinite(kf[0]), torch.isfinite(pf[0])
            both = hk & hp
            dt = float((kf[0][both] - pf[0][both]).abs().max()) \
                if both.any() else 0.0
            err["b1"] = max(err["b1"], dt)
            res = dict(pairs=ptid.numel(), hits=int(hk.sum()),
                       mask_flips=int((hk != hp).sum()),
                       prim_mismatches=int((ki[0] != pi[0]).sum()),
                       max_abs_dt=dt, t_u_v_bitwise=same(kf, pf),
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

    # ---- 3. B2 against its plain version on all primary rays ----------
    packed = wt.pack_rays(rays)
    k_out = check_b2("primary", packed)

    # ---- 4. B1 against its plain version on the first round's pairs ---
    ptid, prays, b1_ref = check_b1("primary", packed)

    # ---- 5. the main path through the kernels -------------------------
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
    launches = {k.name: k.launches for k in kernels.KERNELS}
    n_hits = int(torch.isfinite(hit.t).sum())
    n_shadow = int(torch.isfinite(shit.t).sum())
    log(f"# primary render: {n_hits} hits of {R} rays "
        f"(C++ oracle on bvh_tpu's own tree: {ORACLE_HITS_REFERENCE_TREE}); "
        f"rounds {diag['rounds']}, pairs {diag['pairs']}, caps {diag['caps']}")
    log(f"# shadow render: {n_shadow} occluded of {R}; rounds "
        f"{sdiag['rounds']}, pairs {sdiag['pairs']}")
    log(f"# main path launches: {launches} ({main_s:.2f} s)")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    t_ok = torch.isfinite(hit.t)
    if not (n_hits > 0 and hit.t.shape == (R,) and bool((hit.t[t_ok] > 0).all())
            and bool((hit.prim_id[t_ok] >= 0).all())
            and bool((hit.prim_id[t_ok] < N_TRIS).all())):
        raise AssertionError("primary render output is malformed")
    if not (shit.t.shape == (R,) and 0 < n_shadow < R):
        raise AssertionError("shadow render output is malformed")

    # ---- 6. the kernels at the shadow render's shapes, and the
    # ---- plain-version render on a subset of both renders -------------
    spacked = wt.pack_rays(srays)
    check_b2("shadow", spacked)
    check_b1("shadow", spacked)
    sub = slice(None, None, SUBSET)
    for name, r, h, any_hit in (("primary", rays, hit, False),
                                ("shadow", srays, shit, True)):
        rsub = Ray(r.org[sub], r.dir[sub], r.tmin[sub], r.tmax[sub])
        ph = wt._intersect(tl, rsub, prim_ids, col.collect_portals_ref,
                           wt.traverse_pairs_ref, any_hit=any_hit)
        fields = ("t", "u", "v", "prim_pos", "prim_id")
        diff = {f: int((bits(getattr(h, f)[sub]) != bits(getattr(ph, f))).sum())
                for f in fields}
        log(f"# {name} render vs plain render on every {SUBSET}th ray "
            f"({ph.t.numel()} rays): differing rays per field {diff}")
        if any(diff.values()):
            raise AssertionError(f"{name} render: kernels and plain "
                                 "versions disagree")

    # ---- 7. timing -----------------------------------------------------
    timings = {}

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

    def collect_k():
        return col.collect_portals(tl.top_node_t, packed, tl.top_root, **b2_kw)

    def collect_p():
        return col.collect_portals_ref(tl.top_node_t, packed, tl.top_root,
                                       **b2_kw)

    def trav_k():
        return wt.traverse_pairs(tl.table, ptid, prays, **b1_kw)

    def trav_p():
        return wt.traverse_pairs_ref(tl.table, ptid, prays, **b1_kw)

    for name, fn, n, ref in (("b2_kernel", collect_k, 20, k_out),
                             ("b2_plain", collect_p, 2, k_out),
                             ("b1_kernel", trav_k, 20, b1_ref),
                             ("b1_plain", trav_p, 2, b1_ref)):
        ms, last = time_ms(fn, n)
        if not same(last, ref):
            raise AssertionError(f"timed {name} output diverged")
        timings[f"{name}_ms"] = ms
        log(f"# {name}: {ms:.3f} ms/call (last output == verified run)")
    log(f"# card: {card_line()}")

    def entry(k, source, replaces, key):
        return {"name": k.name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[k.name],
                "max_abs_err": err[key],
                "ms": timings[f"{key}_kernel_ms"],
                "plain_ms": timings[f"{key}_plain_ms"]}

    return {"kernels": [
        entry(kernels.COLLECT, "bvh_tpu_torch/csrc/collect.cu",
              "bvh_tpu/traverse/collect.py:25", "b2"),
        entry(kernels.WIDE_TREELET, "bvh_tpu_torch/csrc/wide_treelet.cu",
              "bvh_tpu/traverse/wide_treelet.py:741", "b1"),
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
