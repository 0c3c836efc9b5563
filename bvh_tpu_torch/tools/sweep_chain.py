"""A config sweep of the wide-treelet render, the counterpart of
tools/sweep_chain.py.

The scene is sponza_class(n, 0) with side x side primary rays and the
port's quality-high device tree (`bench_wide.wide_scene(...,
tree="port")`), built in the run: the JAX tool loaded whatever device
tree an earlier bench.py run had left under a fixed file name
(tools/sweep_chain.py:60-63; ROADMAP C17). Each config names a treelet
size and the portals a ray expands a round, in the JAX tool's syntax
(`--configs "max_prims=1024,k=4;max_prims=512,k=16"`, ";" between
configs, tools/sweep_chain.py:23-35):

- `max_prims`: the cut (`build_wide_treelets`), `--max-prims` unless
  given;
- `k`: portals a ready ray and round (`render_at_caps(..., k=)`),
  `portals_per_round` of the cut unless given; the round cap follows
  it (`wide_treelet_caps`).

The default config is `--max-prims` with its default k. Each config
renders at the capacities the entry point settles on for its cut
(`wide_treelet_intersect_tris(..., return_diag=True)`), timed with
CUDA events (the median of `--reps` after the first, printed apart),
and its hits must equal the default config's bit for bit (t, u, v and
the prim position). The entry point itself,
`wide_treelet_intersect_tris` on the default cut, is timed the same
way in the same run, right after the default config, and must give
the same hits, so that each config reads against the render a user
calls. The JAX tool's TPU tiling keys (`block`, `tail_block`,
`top_block`, `rc_div`) have no counterpart and are refused by name.
Each config is timed through the eager render, not as a render chain
(`wide_treelet_render_chain` with `cli/steady.py`'s `steady_rate`, the
port's counterparts of its chained renders). Its `--any-hit` is left
out on purpose: an any-hit render keeps the hit
it finds first, and which one that is can change with k, so its
configs cannot be held to the default's hits bit for bit.

    python -m bvh_tpu_torch.tools.sweep_chain [--n 262144] [--rays 1024]
        [--max-prims 1024] [--configs "k=4;k=16;max_prims=2048"]
        [--reps 5] [--device cpu]

On the CPU use small sizes (`--n 3000 --rays 32 --max-prims 128
--configs "k=1;k=4;max_prims=256"`).
"""

from __future__ import annotations

import argparse
import time

import torch

from bvh_tpu_torch.tools.bench_wide import wide_scene
from bvh_tpu_torch.tools.profile_r3 import hits_of
from bvh_tpu_torch.tools.timing import device_line, first_then_median, log, \
    same
from bvh_tpu_torch.traverse import wide_treelet as wt

KEYS = ("max_prims", "k")
TPU_KEYS = ("block", "tail_block", "top_block", "rc_div")
DEFAULT_CONFIGS = "k=4;k=16;max_prims=2048"


def parse_configs(s: str) -> list[dict]:
    """The JAX tool's config syntax: "key=int,key=int;..." (an empty part
    is the default config). Raises on the TPU tiling keys and on any key
    but max_prims and k."""
    out = []
    for part in s.split(";"):
        cfg = {}
        for kv in part.split(","):
            if not kv.strip():
                continue
            k, v = kv.split("=")
            cfg[k.strip()] = int(v)
        tpu = sorted(set(cfg) & set(TPU_KEYS))
        if tpu:
            raise ValueError(f"sweep_chain: {', '.join(tpu)} tile the TPU "
                             "kernels and have no counterpart in the port")
        unknown = sorted(set(cfg) - set(KEYS))
        if unknown:
            raise ValueError(f"sweep_chain: unknown keys {unknown}; the "
                             f"port sweeps {KEYS}")
        out.append(cfg)
    return out


def render_k(tl, packed, caps: dict, k: int):
    """`render_at_caps` with k portals a round at `caps` (the round cap
    raised to `wide_treelet_caps`' for k): (the hits' t, u, v, position;
    rounds, pairs). Raises on a capacity overflow."""
    caps = dict(caps, max_rounds=max(caps["max_rounds"], wt.wide_treelet_caps(
        tl, k)["max_rounds"]))
    out = wt.render_at_caps(tl, packed, caps, any_hit=False, robust=False,
                            k=k)
    diag = out[5]
    if (diag["max_cnt"] > caps["max_portals"] or diag["top_ovf"]
            or diag["stack_ovf"] or diag["pending"] or diag["a2_bits"]
            or diag.get("sup_ovf")):
        raise ValueError(f"sweep_chain: k={k} overflows the caps {caps}")
    return hits_of(out), diag["rounds"], diag["pairs"]


def run(n: int = 262_144, side: int = 1024, max_prims: int = 1024,
        configs: str = DEFAULT_CONFIGS, device="cuda", reps: int = 5,
        scene=None) -> dict:
    """{"default": the default config's row, "configs": [rows], "entry":
    the entry point's first and median ms and "equal", "ok", "device"};
    a row has the config, T, P, k, caps, first and median ms, Mrays/s,
    rounds, pairs, hits, "equal" and its hit fields."""
    todo = parse_configs(configs)
    sc = scene if scene is not None else wide_scene(n, side, "port", device)
    packed = wt.pack_rays(sc.rays)
    R = sc.rays.tmin.numel()
    cuts = {}

    def cut(mp):
        if mp not in cuts:
            t0 = time.perf_counter()
            tl = wt.build_wide_treelets(sc.tree, sc.flat, max_prims=mp,
                                        device=device)
            _, diag = wt.wide_treelet_intersect_tris(
                tl, sc.rays, sc.tree.prim_ids, return_diag=True)
            cuts[mp] = (tl, diag["caps"], time.perf_counter() - t0)
        return cuts[mp]

    def one(cfg):
        mp = cfg.get("max_prims", max_prims)
        tl, caps, cut_s = cut(mp)
        k = cfg.get("k", wt.portals_per_round(tl))
        label = f"max_prims={mp} k={k}"
        first_ms, ms, (fields, rounds, pairs) = first_then_median(
            label, lambda: render_k(tl, packed, caps, k), device, reps)
        return dict(label=label, max_prims=mp, k=k, T=tl.table_cols.shape[0],
                    P=tl.table_cols.shape[1], caps=caps, cut_s=cut_s,
                    first_ms=first_ms, ms=ms, mrays_s=R / ms / 1e3,
                    rounds=rounds, pairs=pairs, fields=fields,
                    hits=int(torch.isfinite(fields[0]).sum()))

    def entry_fields():
        hit = wt.wide_treelet_intersect_tris(cuts[max_prims][0], sc.rays)
        return hit.t, hit.u, hit.v, hit.prim_pos

    line = device_line(device)
    default = one({})
    e_first, e_ms, e_fields = first_then_median(
        "wide_treelet_intersect_tris", entry_fields, device, reps)
    entry = dict(first_ms=e_first, ms=e_ms,
                 equal=same(e_fields, default["fields"]))
    rows = []
    for cfg in todo:
        row = one(cfg)
        row["equal"] = same(row["fields"], default["fields"])
        rows.append(row)
    log(f"# sweep_chain on {line}: {R} closest-hit rays, ms, medians of "
        f"{reps} renders after the first")
    for row in [dict(default, equal=True)] + rows:
        log(f"  {row['label']:24s} T={row['T']} P={row['P']}: "
            f"{row['ms']:9.4f} ms = {row['mrays_s']:.3f} Mrays/s (first "
            f"{row['first_ms']:.4f}), {row['rounds']} rounds, {row['pairs']} "
            f"pairs, {row['hits']} hits, equal to the default: "
            f"{row['equal']}")
    log(f"  {'the entry point':24s} {entry['ms']:9.4f} ms (first "
        f"{entry['first_ms']:.4f}), the default's hits: {entry['equal']}; "
        f"the default config takes {default['ms'] / entry['ms']:.3f} times "
        "its time")
    return dict(default=default, configs=rows, entry=entry, device=line,
                ok=entry["equal"] and all(r["equal"] for r in rows))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--max-prims", type=int, default=1024)
    ap.add_argument("--configs", default=DEFAULT_CONFIGS)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = run(args.n, args.rays, args.max_prims, args.configs, args.device,
              args.reps)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
