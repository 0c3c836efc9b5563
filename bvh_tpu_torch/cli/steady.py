"""Two-point steady-state timing of render chains.

A call of a k-render chain (`wide_treelet_render_chain`) costs a fixed
part C, paid once a call whatever k is (on the card: launching the one
set of k graph replays, zeroing and reading back the overflow stats,
the final copy and the host's wait on the device), and k times the
device time r of one render. Timing one chain and dividing by k
reports r + C/k, so `steady_rate` times chains of two lengths k1 < k2
and returns the marginal time a render,

    r = (t(k2) - t(k1)) / (k2 - k1),

and the fixed cost C = t(k1) - k1 * r, so that callers report both.
The arithmetic is the reference's (bvh_tpu/cli/steady.py:34-48).
"""

from __future__ import annotations

import time


def _median_time(run, reps: int) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def steady_rate(make_chain, k1: int = 16, k2: int = 64, reps: int = 3):
    """make_chain(k) -> a zero-argument callable that runs a k-chain and
    returns once its result is on the host (a `RenderChain` reads its
    stats back, so calling it blocks).

    Each chain is called once to warm up, then `reps` times; the median
    of each is taken. Returns (seconds_per_render, fixed_seconds, t_k1,
    t_k2)."""
    if not k2 > k1 >= 1:
        raise ValueError(f"steady_rate: needs k2 > k1 >= 1, got {k1}, {k2}")
    c1 = make_chain(k1)
    c2 = make_chain(k2)
    c1()
    c2()
    t1 = _median_time(c1, reps)
    t2 = _median_time(c2, reps)
    r = (t2 - t1) / (k2 - k1)
    return r, t1 - k1 * r, t1, t2
