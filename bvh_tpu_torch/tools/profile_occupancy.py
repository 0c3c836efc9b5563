"""Round-1 occupancy analysis (T3), the counterpart of
tools/profile_occupancy.py.

One render stopped after round 1 (`max_rounds` = 1) is recorded stage
by stage; kernel B1's per-pair active steps of that round (`out_i[1]`)
then drive a simulation on the host. A pair's steps depend only on its
(ray, treelet) traversal, not on where it runs, so any ordering of the
pairs can be scored without running it again.

On this card a block's iterations are no longer what counts: a warp's
32 threads step together, so its cost is 32 x its slowest pair. The
score of an ordering is its SIMT efficiency, the sum of steps over
(group size x the largest step count of each group), for warps (32)
and blocks (128), over:

- the driver's order (treelet * 8 + octant, stable, `round_pairs`);
- entry t within a treelet;
- steps descending within a treelet (the oracle);
- chord length within a treelet (the ray's segment inside the treelet's
  root box, which phase A could record for free), longest first;
- chord octave, then octant, within a treelet.

It also prints the share of round-1 pairs (and steps) that perfect
pruning would drop (entry t past the ray's best round-1 hit), the
budget-split simulation (every pair runs at most `budget` steps a
phase; the survivors are compacted and run on), and the step and
run-length distributions.

    python -m bvh_tpu_torch.tools.profile_occupancy [--save PATH]
        [--n 262144] [--side 1024] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from bvh_tpu_torch.tools.profile_r3 import Recorder, bench_scene, \
    render_caps
from bvh_tpu_torch.tools.timing import log, timed
from bvh_tpu_torch.traverse import wide_treelet as wt

GROUPS = (32, 128)   # a warp, and the kernel's block
BUDGETS = (16, 24, 32)


def simt_efficiency(steps: np.ndarray, group: int) -> float:
    """Sum of steps over group x (the largest steps of each run of
    `group` consecutive pairs), the last run padded with idle lanes."""
    s = np.asarray(steps, np.float64)
    if s.size == 0:
        return 1.0
    padded = np.zeros(-(-s.size // group) * group)
    padded[:s.size] = s
    cost = padded.reshape(-1, group).max(1).sum() * group
    return float(s.sum() / cost) if cost else 1.0


def budget_split(steps: np.ndarray, group: int, budget: int,
                 phases: int) -> tuple[float, float]:
    """Each phase runs every remaining pair, in order, for at most
    `budget` steps (the last phase to its end); the pairs not done are
    compacted, order kept, and carry their stacks into the next phase.
    Returns (the sum over phases and groups of each group's largest
    steps, the SIMT efficiency over all phases)."""
    s = np.asarray(steps, np.float64)
    total_steps = s.sum()
    cost = 0.0
    for ph in range(phases):
        if s.size == 0:
            break
        run = s if ph == phases - 1 else np.minimum(s, budget)
        padded = np.zeros(-(-s.size // group) * group)
        padded[:s.size] = run
        cost += padded.reshape(-1, group).max(1).sum()
        s = s[s > budget] - budget
    return cost, float(total_steps / (cost * group)) if cost else 1.0


def chord_lengths(table: np.ndarray, tid: np.ndarray,
                  rays: np.ndarray) -> np.ndarray:
    """Each pair's ray segment inside its treelet's root box (the union of
    the root node's 8 slot boxes, :225-255), clipped to [tmin, tmax]."""
    c0 = table[:, :48, 0].reshape(table.shape[0], 8, 6)
    valid = c0[:, :, 0] <= c0[:, :, 1]
    big = np.float32(np.finfo(np.float32).max)
    root = np.empty((table.shape[0], 6), np.float32)
    for d in range(3):
        root[:, 2 * d] = np.where(valid, c0[:, :, 2 * d], big).min(1)
        root[:, 2 * d + 1] = np.where(valid, c0[:, :, 2 * d + 1], -big).max(1)
    box = root[tid]
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / rays[3:6]
        t0 = np.full(tid.size, -np.inf)
        t1 = np.full(tid.size, np.inf)
        for d in range(3):
            lo = (box[:, 2 * d] - rays[d]) * inv[d]
            hi = (box[:, 2 * d + 1] - rays[d]) * inv[d]
            t0 = np.maximum(t0, np.minimum(lo, hi))
            t1 = np.maximum(np.minimum(t1, np.maximum(lo, hi)), t0)
    return np.maximum(np.minimum(t1, rays[7]) - np.maximum(t0, rays[6]), 0)


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Rank correlation (ties ranked by position)."""
    ra = np.argsort(np.argsort(a, kind="stable")).astype(np.float64)
    rb = np.argsort(np.argsort(b, kind="stable")).astype(np.float64)
    return float(np.corrcoef(ra, rb)[0, 1])


def round_one(tl, rays, device) -> dict:
    """Round 1 of the closest-hit render, recorded: per pair (in the
    driver's order) its treelet, ray (index among the rays with
    portals), octant, entry t, active steps and best t, plus B1's
    arguments and output and its time alone."""
    _, caps, packed = render_caps(tl, rays)
    rec = Recorder()
    wt.render_at_caps(tl, packed, dict(caps, max_rounds=1), any_hit=False,
                      robust=False, stage=rec)
    portals = rec.first["portal_sort"][2]
    (_, _, _, _, rays_c, octant, rsel, _), _, out = rec.first["round_pairs"]
    _, pk, pr, ptid, prays = out
    b1_args, b1_kw, (out_f, out_i) = rec.first["b1"]
    b1_ms = timed("B1 round 1", lambda: wt.traverse_pairs(*b1_args, **b1_kw),
                  (out_f, out_i), device)

    def np_(x):
        return x.cpu().numpy()

    ray = np_(rsel[pr])
    return dict(
        tid=np_(ptid).astype(np.int64), ray=ray,
        octant=np_(octant)[ray], entry=np_(portals.tent[:, rsel][pk, pr]),
        steps=np_(out_i[1]).astype(np.int64), best_t=np_(out_f[0]),
        prays=np_(prays), b1=(b1_args, b1_kw, (out_f, out_i)), b1_ms=b1_ms,
        launches=len(rec.pairs), rays_with_portals=int(rays_c.shape[1]))


def orderings(r: dict, chord: np.ndarray) -> dict:
    """Each ordering's permutation of the driver's pair order."""
    tid, steps = r["tid"], r["steps"]
    octave = np.floor(np.log2(np.maximum(chord, 1e-30)))
    return {
        "driver (tid*8 + octant)": np.arange(tid.size),
        "entry t in treelet": np.lexsort((r["entry"], tid)),
        "steps desc in treelet (oracle)": np.lexsort((-steps, tid)),
        "chord desc in treelet": np.lexsort((-chord, tid)),
        "chord octave + octant in treelet": np.lexsort(
            (r["octant"], -octave, tid)),
        "steps desc, all pairs": np.argsort(-steps, kind="stable"),
    }


def analyse(r: dict, table: np.ndarray) -> dict:
    """SIMT efficiency per ordering and group size, the oracle-pruning
    share, the budget split and the distributions; prints them."""
    steps, tid = r["steps"], r["tid"]
    chord = chord_lengths(table, tid, r["prays"])
    out = {"simt": {}}
    for name, order in orderings(r, chord).items():
        eff = {g: simt_efficiency(steps[order], g) for g in GROUPS}
        out["simt"][name] = eff
        log(f"# T3 SIMT efficiency, {name:34s}: "
            + ", ".join(f"group {g} {e:.4f}" for g, e in eff.items()))
    out["chord_spearman"] = spearman(chord, steps)
    best = np.full(int(r["ray"].max()) + 1 if r["ray"].size else 0, np.inf)
    np.minimum.at(best, r["ray"], r["best_t"])
    culled = r["entry"] > best[r["ray"]]
    out["pruned_pairs"] = float(culled.mean()) if culled.size else 0.0
    out["pruned_steps"] = (float(steps[culled].sum() / steps.sum())
                           if steps.sum() else 0.0)
    log(f"# T3 chord vs steps, rank correlation {out['chord_spearman']:.3f}; "
        f"oracle pruning: {int(culled.sum())} of {culled.size} round-1 pairs "
        f"({100 * out['pruned_pairs']:.1f}%) enter past their ray's best "
        f"round-1 hit, {100 * out['pruned_steps']:.1f}% of the steps")
    out["budget"] = {}
    for g in GROUPS:
        for b in BUDGETS:
            cost, eff = budget_split(steps, g, b, 4)
            out["budget"][(g, b)] = eff
            log(f"# T3 budget split, group {g}, budget {b}, 4 phases: "
                f"{cost:.0f} group-steps, SIMT efficiency {eff:.4f} "
                f"(the driver's order in one phase: "
                f"{out['simt']['driver (tid*8 + octant)'][g]:.4f})")
    if steps.size:
        out["steps"] = dict(mean=float(steps.mean()),
                            p50=float(np.median(steps)),
                            p90=float(np.percentile(steps, 90)),
                            p99=float(np.percentile(steps, 99)),
                            max=int(steps.max()))
        runs = np.unique(tid, return_counts=True)[1]
        out["runs"] = dict(n=int(runs.size), mean=float(runs.mean()),
                           p50=float(np.median(runs)),
                           p90=float(np.percentile(runs, 90)),
                           max=int(runs.max()))
        log(f"# T3 steps a pair: {out['steps']}; pairs a treelet: "
            f"{out['runs']}")
    return out


def run(tl, rays, device, save: str | None = None) -> dict:
    r = round_one(tl, rays, device)
    log(f"# T3 round 1: {r['tid'].size} pairs of {r['rays_with_portals']} "
        f"rays with portals, {int(r['steps'].sum())} active steps; B1 "
        f"{r['b1_ms']:.4f} ms alone")
    if save:
        np.savez(save, **{k: r[k] for k in ("tid", "ray", "octant", "entry",
                                            "steps", "best_t", "prays")})
    res = analyse(r, tl.table.cpu().numpy())
    res.update(round_one=r)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--save", help="write round 1's pairs to this .npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    tl, rays, _ = bench_scene(args.n, args.side, args.device)
    run(tl, rays, args.device, args.save)


if __name__ == "__main__":
    main()
