"""The port's profile_floor and profile_floor2 (bvh_tpu_torch/tools/) on
the CPU at small size: profile_floor2's fills and scans (the builders'
`frontier.segmented_scan` with the JAX tool's operators) equal
`jax.lax.associative_scan` with the same operator bit for bit, and
both tools run through their checks, where only profile_floor's eager
rows exist (its graph replay needs the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu_torch.tools import profile_floor, profile_floor2


def _comb_fill(a, b):
    fa, va = a
    fb, vb = b
    return fa | fb, jnp.where(fb[:, None], vb, va)


def _comb_min(a, b):
    fa, va = a
    fb, vb = b
    return fa | fb, jnp.where(fb[:, None], vb, jnp.minimum(va, vb))


_SCANS = {comb: jax.jit(lambda h, v, comb=comb: jax.lax.associative_scan(
    comb, (h, v), axis=0)[1]) for comb in (_comb_fill, _comb_min)}


def _jax(comb, heads, v, reverse=False):
    """tools/profile_floor2.py's ffill, bfill and minmax_scan."""
    if reverse:
        heads, v = heads[::-1], v[::-1]
    out = np.asarray(_SCANS[comb](jnp.asarray(heads), jnp.asarray(v)))
    return out[::-1] if reverse else out


@pytest.mark.parametrize("n, width", [(1, 8), (517, 25), (1000, 72)])
def test_fills_and_scans_equal_associative_scan(n, width):
    rng = np.random.default_rng(n)
    heads = rng.random(n) < 0.05
    v = rng.random((n, width)).astype(np.float32)
    th, tv = torch.from_numpy(heads), torch.from_numpy(v)
    for fn, comb, rev in ((profile_floor2.ffill, _comb_fill, False),
                          (profile_floor2.bfill, _comb_fill, True),
                          (profile_floor2.flagged_min, _comb_min, False)):
        got = fn(th, tv).numpy()
        assert np.array_equal(got, _jax(comb, heads, v, rev)), fn.__name__
    np_refs = (profile_floor2.np_ffill(heads, v),
               profile_floor2.np_bfill(heads, v),
               profile_floor2.np_flagged_min(heads, v))
    for ref, comb, rev in zip(np_refs, (_comb_fill, _comb_fill, _comb_min),
                              (False, True, False)):
        assert np.array_equal(ref, _jax(comb, heads, v, rev))


def test_profile_floor2_checks_every_op():
    res = profile_floor2.run(n=2048, device="cpu", reps=1)
    assert res["device"] == "cpu" and len(res["ops"]) == 19
    assert all(ms >= 0 for ms in res["ops"].values())


def test_profile_floor_eager_rows():
    res = profile_floor.run(n=4096, k=8, device="cpu", reps=1)
    rows = list(res["loops"].values())
    assert [r["launches"] for r in rows] == [16, 4]
    assert all("graph_ms" not in r and r["eager_ms"] > 0 for r in rows)
    x = torch.arange(6, dtype=torch.float32)
    assert torch.equal(profile_floor.cheap_loop(x, 2),
                       (x * 1.0001 + 1.0) * 1.0001 + 1.0)
