"""What the port's builders pay for their primitive operations, the
counterpart of tools/profile_build.py.

At n primitives (default 262,144) it times, with CUDA events (medians
of `--reps` after one warm-up), the operations the builders call, each
as they call it:

- bincount of group keys (`minitree._grid_groups`' bins, the staging's
  group counts); scatter-add (`index_add_`, `frontier.apply_splits`'
  left counts) and scatter-min/max (`scatter_reduce`, its child boxes);
- cumsum of [n, 24] int64 (`frontier.segment_sums_at`, the binned
  round's bin counts);
- `frontier.segmented_scan` of [n, 72] float32 (`segmented_minmax`, the
  binned round's bin boxes);
- the stable sort of int64 keys and the gather of [n, 3] payloads by
  its order (`build_lbvh`, `staging_plan`); the two sorts of
  `frontier.segment_ranks_by_value` (the median fallback);
- gathers of [n, 3] rows by a permutation, and the inverse scatter
  (`frontier.inverse_permute`);

then one binned round (`binned._round`) on the state of rounds 1-4 and
15 of `build_binned` on random triangles, and the full `build_binned`
and `build_minitree` (first call apart, then the median). The JAX
tool's bf16 matmul (a check that its timer did not lie), its
scatter-set with unique indices and its 144-column scan have no
counterpart here: no builder of the port calls them.

    python -m bvh_tpu_torch.tools.profile_build [--n 262144] [--reps 5]
        [--device cpu]

On the CPU use small sizes (`--n 4096`).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from bvh_tpu_torch.build import frontier
from bvh_tpu_torch.build.binned import _round, build_binned
from bvh_tpu_torch.build.minitree import MiniTreeConfig, build_minitree
from bvh_tpu_torch.build.sah import TopDownConfig
from bvh_tpu_torch.tools.timing import first_then_median, log, timed

DIM, BINS = 3, 8
ROUNDS = (1, 2, 3, 4, 15)


def primitive_ops(n: int, device, rng) -> dict:
    """{name: (fn, inputs' description)} of the builders' operations on
    random inputs of n rows."""
    f_cap = n // 2
    i64 = torch.int64

    def t(x):
        return torch.from_numpy(x).to(device)

    f = t(rng.integers(0, f_cap, n))
    onehot = t(rng.integers(0, 2, (n, DIM * BINS)))
    vals = t(rng.random((n, DIM * BINS * DIM), np.float32))
    heads = t(rng.random(n) < 0.01)
    heads[0] = True
    keys = t(rng.integers(0, 1 << 30, n))
    pb = t(rng.random((n, DIM), np.float32))
    perm = t(rng.permutation(n))
    seg = t(np.sort(rng.integers(0, f_cap, n)))
    sizes = torch.bincount(seg, minlength=f_cap)

    def sort_gather():
        order = torch.sort(keys, stable=True).indices
        return order, pb[order]

    return {
        "bincount [n] -> [n/2]": lambda: torch.bincount(f, minlength=f_cap),
        "scatter-add index_add_ [n] -> [n/2]": lambda: torch.zeros(
            f_cap, dtype=i64, device=device).index_add_(0, f, onehot[:, 0]),
        "scatter-min/max [n, 3] -> [n/2, 3]": lambda: (
            torch.full((f_cap, DIM), 1e30, device=device).scatter_reduce(
                0, f[:, None].expand(-1, DIM), pb, "amin"),
            torch.full((f_cap, DIM), -1e30, device=device).scatter_reduce(
                0, f[:, None].expand(-1, DIM), pb, "amax")),
        "cumsum [n, 24] int64": lambda: torch.cumsum(onehot, 0),
        "segmented_scan min/max [n, 72] f32": lambda:
            frontier.segmented_minmax(heads, vals, vals),
        "stable sort int64 + gather [n, 3]": sort_gather,
        "segment_ranks_by_value (2 sorts)": lambda:
            frontier.segment_ranks_by_value(seg, pb[:, 0], sizes, f_cap),
        "gather [n, 3] by a permutation": lambda: pb[perm],
        "inverse scatter [n, 3] (inverse_permute)": lambda:
            frontier.inverse_permute(perm, (pb,)),
    }


def round_states(boxes, config: TopDownConfig, rounds=ROUNDS) -> dict:
    """{r: the state `_round` starts round r from}, stepping
    `build_binned`'s loop (fewer if the build closes first)."""
    state = frontier.init_state(boxes[0], boxes[1], config.min_leaf_size)
    out = {}
    for r in range(1, max(rounds) + 1):
        if not bool(state.open_.any()):
            break
        if r in rounds:
            out[r] = state
        state = _round(state, *boxes, config)
    return out


def run(n: int = 262_144, device="cuda", reps: int = 5) -> dict:
    """Every time of the module docstring. Returns {"ops": {name: ms},
    "rounds": {r: ms}, "builds": {name: (first ms, ms, tree)}}; the
    timed loops' last outputs are guarded against their first."""
    rng = np.random.default_rng(0)
    res = {"ops": {}, "rounds": {}, "builds": {}}
    log(f"# profile_build: primitive ops at n={n} (ms, medians of {reps})")
    for name, fn in primitive_ops(n, device, rng).items():
        res["ops"][name] = timed(name, fn, fn(), device, reps)
        log(f"  {name:44s} {res['ops'][name]:9.4f} ms")

    tris = rng.random((n, 3, 3), np.float32)
    boxes = tuple(torch.from_numpy(a).to(device) for a in (
        tris.min(axis=1), tris.max(axis=1), tris.mean(axis=1)))
    config = TopDownConfig()
    states = round_states(boxes, config)
    for r, state in states.items():
        fn = lambda state=state: _round(state, *boxes, config)  # noqa: E731
        res["rounds"][r] = timed(f"round {r}", fn, fn(), device, reps)
        log(f"  binned round {r:2d} ({int(state.open_.sum())} open nodes) "
            f"{res['rounds'][r]:9.4f} ms")
    for name, fn in (("build_binned", lambda: build_binned(*boxes)),
                     ("build_minitree", lambda: build_minitree(
                         *boxes, MiniTreeConfig()))):
        first_ms, ms, tree = first_then_median(name, fn, device, reps)
        res["builds"][name] = (first_ms, ms, tree)
        log(f"  {name}: {ms:.3f} ms = {n / ms / 1e3:.3f} Mprims/s (first "
            f"{first_ms:.3f} ms; {tree.node_count} nodes)")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.n, args.device, args.reps)


if __name__ == "__main__":
    main()
