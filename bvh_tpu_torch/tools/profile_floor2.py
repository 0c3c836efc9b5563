"""What the builders' and the render's glue ops cost at 262K, the
counterpart of tools/profile_floor2.py.

At n = 262,144 (cap = 2n, f_cap = n/2, the JAX tool's widths) it times,
with CUDA events (medians of `--reps` after one warm-up):

- a no-op (`x[0] + 1`, the sync overhead);
- five gathers: [n] <- [n] of width 1, [n] <- [cap] w6 (bounds[nid]),
  [f_cap] <- [n] w144 (smn[last]), [cap] <- [n] w24 (boundary) and
  [n] <- [n] w24;
- the head-row scatter [f_cap] -> [n] w8;
- the forward fill of [n, 8] and [n, 25] and the backward fill of
  [n, 8] from heads (2% of rows), and the flagged min scans of [n, 144]
  and [n, 72]: `frontier.segmented_scan`, the builders' log-step scan,
  with the JAX tool's operators (`ffill`, `bfill`, `flagged_min`);
- a sort of a permutation key with 18 and with 4 float payloads (the
  payloads stacked [P, n] and gathered by the sort's order);
- the JAX tool's cumsum of [n, 24] int32 along dim 0, and ROADMAP H5's
  two forms of the binned round's bin-count sum: the [n, 24] int64
  cumsum along dim 0, as `frontier.segment_sums_at` runs it for
  `binned._round`, and the transposed [24, n] along its last dim (and
  with the two transposes around it); and `frontier.segmented_minmax`
  of [n, 72] (the round's bin boxes).

Every op's output is checked by value against numpy on the host (the
transposed cumsum against the dim-0 one) before it is timed, and each
timed loop's last output against that checked one. The JAX tool prints
FAILED and carries on; here a failure raises.

    python -m bvh_tpu_torch.tools.profile_floor2 [--n 262144] [--reps 5]
        [--device cpu]

On the CPU use small sizes (`--n 4096`).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from bvh_tpu_torch.build import frontier
from bvh_tpu_torch.tools.timing import device_line, log, timed


def ffill(heads, v):
    """Forward fill along dim 0: each row takes the value of the last
    head at or before it (row 0 its own), the JAX tool's `ffill`."""
    return frontier.segmented_scan((v,), heads, lambda a, b: a)[0]


def bfill(heads, v):
    """Backward fill: the forward fill of the reversed rows, reversed."""
    return ffill(heads.flip(0), v.flip(0)).flip(0)


def flagged_min(heads, v):
    """Running minimum along dim 0 that restarts at each head."""
    return frontier.segmented_scan(
        (v,), heads, lambda a, b: (torch.minimum(a[0], b[0]),))[0]


def _segments(heads: np.ndarray):
    """(start, end) of the runs that heads start (row 0 starts one)."""
    starts = np.flatnonzero(heads)
    starts = np.unique(np.concatenate([[0], starts]))
    return zip(starts, np.append(starts[1:], len(heads)))


def np_ffill(heads, v):
    src = np.maximum.accumulate(np.where(heads, np.arange(len(heads)), 0))
    return v[src]


def np_bfill(heads, v):
    return np_ffill(heads[::-1], v[::-1])[::-1]


def np_flagged_min(heads, v):
    out = np.empty_like(v)
    for a, b in _segments(heads):
        out[a:b] = np.minimum.accumulate(v[a:b], axis=0)
    return out


def np_flagged_minmax(heads, vmin, vmax):
    mx = np.empty_like(vmax)
    for a, b in _segments(heads):
        mx[a:b] = np.maximum.accumulate(vmax[a:b], axis=0)
    return np_flagged_min(heads, vmin), mx


def ops(n: int, device) -> dict:
    """{name: (fn, numpy check of fn's output)} at n rows, on the JAX
    tool's inputs (numpy, seed 0)."""
    cap, f_cap = 2 * n, n // 2
    rng = np.random.default_rng(0)
    h = {
        "x1": rng.random(n).astype(np.float32),
        "idx_n": rng.integers(0, n, n),
        "idx_cap_from_n": rng.integers(0, n, cap),
        "idx_f_from_n": rng.integers(0, n, f_cap),
        "idx_n_from_cap": rng.integers(0, cap, n),
        "w6_cap": rng.random((cap, 6)).astype(np.float32),
        "w144_n": rng.random((n, 144)).astype(np.float32),
        "w24_n": rng.random((n, 24)).astype(np.float32),
        "heads": rng.random(n) < 0.02,
        "rows8_f": rng.random((f_cap, 8)).astype(np.float32),
        "hpos": np.sort(rng.choice(n, f_cap, replace=False)),
        "v8": rng.random((n, 8)).astype(np.float32),
        "v25": rng.random((n, 25)).astype(np.float32),
        "key": rng.permutation(n),
        "pay": rng.random((18, n)).astype(np.float32),
        "counts": rng.integers(0, 2, (n, 24)),
    }
    d = {k: torch.from_numpy(v).to(device) for k, v in h.items()}
    counts_t = d["counts"].T.contiguous()
    w72 = h["w144_n"][:, :72]
    order = np.argsort(h["key"])
    cs = np.cumsum(h["counts"], 0)

    def scatter():
        return torch.zeros((n, 8), dtype=torch.float32,
                           device=device).index_put_((d["hpos"],),
                                                     d["rows8_f"])

    def np_scatter():
        out = np.zeros((n, 8), np.float32)
        out[h["hpos"]] = h["rows8_f"]
        return out

    def sort(p):
        o = torch.sort(d["key"]).indices
        return d["key"][o], d["pay"][:p, o]

    def gather(i, v):
        return (lambda: d[v][d[i]], lambda: h[v][h[i]])

    return {
        "noop (x[0] + 1)": (lambda: d["x1"][0] + 1, lambda: h["x1"][0] + 1),
        "gather [n]<-[n] w1": gather("idx_n", "x1"),
        "gather [n]<-[cap] w6 (bounds[nid])":
            gather("idx_n_from_cap", "w6_cap"),
        "gather [f_cap]<-[n] w144 (smn[last])":
            gather("idx_f_from_n", "w144_n"),
        "gather [cap]<-[n] w24 (boundary)": gather("idx_cap_from_n", "w24_n"),
        "gather [n]<-[n] w24": gather("idx_n", "w24_n"),
        "scatter-set [f_cap]->[n] w8 (head rows)": (scatter, np_scatter),
        "fwd-fill scan [n,8]": (lambda: ffill(d["heads"], d["v8"]),
                                lambda: np_ffill(h["heads"], h["v8"])),
        "fwd-fill scan [n,25]": (lambda: ffill(d["heads"], d["v25"]),
                                 lambda: np_ffill(h["heads"], h["v25"])),
        "bwd-fill scan [n,8]": (lambda: bfill(d["heads"], d["v8"]),
                                lambda: np_bfill(h["heads"], h["v8"])),
        "sort [n] 18 payloads": (lambda: sort(18), lambda: (
            h["key"][order], h["pay"][:, order])),
        "sort [n] 4 payloads": (lambda: sort(4), lambda: (
            h["key"][order], h["pay"][:4, order])),
        "cumsum [n,24] i32 dim 0": (
            lambda: torch.cumsum(d["counts"].to(torch.int32), 0,
                                 dtype=torch.int32),
            lambda: cs.astype(np.int32)),
        "cumsum [n,24] int64 dim 0 (H5: segment_sums_at)": (
            lambda: torch.cumsum(d["counts"], 0), lambda: cs),
        "cumsum [24,n] int64 dim 1 (H5 transposed)": (
            lambda: torch.cumsum(counts_t, 1), lambda: cs.T),
        "cumsum [24,n] int64 dim 1 with both transposes": (
            lambda: torch.cumsum(d["counts"].T.contiguous(), 1).T, lambda: cs),
        "segmented_scan min/max [n,72] (segmented_minmax)": (
            lambda: frontier.segmented_minmax(
                d["heads"], d["w144_n"][:, :72], d["w144_n"][:, :72]),
            lambda: np_flagged_minmax(h["heads"], w72, w72)),
        "flagged min scan [n,144]": (
            lambda: flagged_min(d["heads"], d["w144_n"]),
            lambda: np_flagged_min(h["heads"], h["w144_n"])),
        "flagged min scan [n,72]": (
            lambda: flagged_min(d["heads"], d["w144_n"][:, :72]),
            lambda: np_flagged_min(h["heads"], w72)),
    }


def _host(x):
    if isinstance(x, (tuple, list)):
        return tuple(_host(y) for y in x)
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a.shape == np.shape(b) and np.array_equal(a, b)


def run(n: int = 262_144, device="cuda", reps: int = 5) -> dict:
    """{"ops": {name: ms}, "device"}: every op of the module docstring,
    checked by value, then timed. Raises on a wrong value."""
    line = device_line(device)
    res = {"device": line, "ops": {}}
    log(f"# profile_floor2 on {line}: n={n}, medians of {reps}, ms")
    for name, (fn, check) in ops(n, device).items():
        ref = fn()
        if not _equal(_host(ref), check()):
            raise AssertionError(f"profile_floor2: {name} gives a wrong "
                                 "value")
        res["ops"][name] = timed(name, fn, ref, device, reps)
        log(f"  {name:50s} {res['ops'][name]:9.4f}")
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
