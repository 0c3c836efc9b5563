"""The card's launch floor, the counterpart of tools/profile_floor.py.

At n = 2,097,152 float32 (the JAX tool's size) it times K = 200 cheap
elementwise steps (x * 1.0001 + 1, two torch ops a step) and K/4 random
gathers (x[idx] + 1, the lbvh access pattern), each as an eager loop
of torch ops: one launch per op, every launch paid by the host. It then
captures the same loops in a `torch.cuda.CUDAGraph` and times a replay,
which issues the same kernels without the host: the gap between the two
is the launch floor. Beside them it prints the least time the bytes
take (each op reads its inputs and writes its output once, at
3.35 TB/s).

The JAX tool's `fori_loop` and `unroll=8` rows have no torch
counterpart: eager torch has no loop that runs on the device, and a
graph replay is the one way to issue a loop's launches without the
host. Each timed loop's last output is compared bit for bit with the
eager loop's first. On the CPU only the eager rows run; on the card a
failed capture raises.

    python -m bvh_tpu_torch.tools.profile_floor [--n 2097152] [--k 200]
        [--reps 5] [--device cpu]

On the CPU use small sizes (`--n 65536 --k 16`).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from bvh_tpu_torch.tools.timing import device_line, log, timed

PEAK_BYTES_PER_S = 3.35e12  # the H100's memory rate


def cheap_loop(x, k: int):
    for _ in range(k):
        x = x * 1.0001 + 1.0
    return x


def gather_loop(x, idx, k: int):
    for _ in range(k):
        x = x[idx] + 1.0
    return x


def loops(n: int, k: int, device) -> dict:
    """{name: (fn, launches, bytes)} of the two loops on the JAX tool's
    inputs (numpy, seed 0): x uniform [n] f32, idx uniform [n] int64."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random(n).astype(np.float32)).to(device)
    idx = torch.from_numpy(rng.integers(0, n, n)).to(device)
    f, i = 4 * n, 8 * n
    return {
        f"{k} cheap ops (x * 1.0001 + 1)": (
            lambda: cheap_loop(x, k), 2 * k, k * 2 * (2 * f)),
        f"{k // 4} random gathers (x[idx] + 1)": (
            lambda: gather_loop(x, idx, k // 4), 2 * (k // 4),
            (k // 4) * ((f + i + f) + 2 * f)),
    }


def graph_of(fn):
    """(replay, out): `fn` captured in a CUDA graph after a warm-up on a
    side stream; `replay()` reruns it and returns its output tensor."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()

    def replay():
        graph.replay()
        return out

    return replay, out


def run(n: int = 2_097_152, k: int = 200, device="cuda",
        reps: int = 5) -> dict:
    """{loop: {"launches", "bytes", "bound_ms", "eager_ms" and, on the
    card, "graph_ms", "per_launch_us"}} and "device"."""
    cuda = torch.device(device).type == "cuda"
    line = device_line(device)
    res = {"device": line, "loops": {}}
    log(f"# profile_floor on {line}: n={n}, medians of {reps}, ms")
    for name, (fn, launches, nbytes) in loops(n, k, device).items():
        ref = fn()
        row = dict(launches=launches, bytes=nbytes,
                   bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                   eager_ms=timed(f"{name}, eager", fn, ref, device, reps))
        if cuda:
            replay, _ = graph_of(fn)
            row["graph_ms"] = timed(f"{name}, graph replay", replay, ref,
                                    device, reps)
            row["per_launch_us"] = ((row["eager_ms"] - row["graph_ms"])
                                    / launches * 1e3)
        res["loops"][name] = row
        log(f"  {name:36s} eager {row['eager_ms']:9.4f}"
            + (f", graph replay {row['graph_ms']:9.4f}, launch floor "
               f"{row['per_launch_us']:.3f} us a launch, the card's bytes "
               f"bound {row['bound_ms']:.4f}" if cuda else "")
            + f" ({launches} launches)")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2_097_152)
    ap.add_argument("--k", type=int, default=200)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.n, args.k, args.device, args.reps)


if __name__ == "__main__":
    main()
