"""The plain versions of the port's two kernels against bvh_tpu's
Pallas kernels, on the fixture of tests/test_torch_wide_treelet.py
(sponza_class(3000, 3), MEDIUM tree, 32x32 primary rays,
max_prims=256):

- phase A (B2): `collect_portals` against bvh_tpu's `collect_kernel`
  run through pl.pallas_call(interpret=True) as `_render_jit` launches
  it (wide_treelet.py:1505-1532);
- the wide traversal (B1): `traverse_pairs` against `_traverse_core`
  called directly on the same pairs, closest/any-hit x fast/robust.

Why some comparisons carry a tolerance: XLA's CPU backend contracts
a*b+c into fused multiply-adds inside compiled code (ROADMAP C5), where
the port, the CUDA kernels (-fmad=false) and the TPU's Mosaic round
every operation separately. That moves the reference's fast-form slab
distances and its Möller–Trumbore cross products by a few ulps. The
state machines agree exactly once the plain version is given the same
FMA rounding (test_collect_fast_matches_pallas_with_fma_rounding).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bvh_tpu.traverse import wide_treelet as jwt
from bvh_tpu.traverse.collect import collect_kernel
from bvh_tpu_torch.traverse import collect as tcol
from bvh_tpu_torch.traverse import wide_treelet as twt
from test_torch_wide_treelet import scene  # noqa: F401 - shared fixture

MP = 32


def _pallas_collect(jtl, packed, robust):
    """bvh_tpu's phase-A kernel, launched as _render_jit launches it
    (wide_treelet.py:1505-1532), in interpret mode."""
    R, top_block = packed.shape[1], 512
    grid_spec = pl.GridSpec(
        grid=(R // top_block,),
        in_specs=[
            pl.BlockSpec(jtl.top_node_t.shape, lambda i: (0, 0)),
            pl.BlockSpec((8, top_block), lambda i: (0, i)),
            pl.BlockSpec((8, 128), lambda i: (0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((MP, top_block), lambda i: (0, i)),
            pl.BlockSpec((MP, top_block), lambda i: (0, i)),
            pl.BlockSpec((8, top_block), lambda i: (0, i)),
        ],
    )
    kernel = partial(collect_kernel, dim=3, robust=robust,
                     stack_depth=jtl.top_depth + 1, max_portals=MP)
    out = pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=[jax.ShapeDtypeStruct((MP, R), jnp.int32),
                   jax.ShapeDtypeStruct((MP, R), jnp.float32),
                   jax.ShapeDtypeStruct((8, R), jnp.int32)],
        interpret=True,
    )(jnp.asarray(jtl.top_node_t, jnp.float32), jnp.asarray(packed.numpy()),
      jnp.full((8, 128), jtl.top_root, jnp.int32))
    return [np.asarray(x) for x in out]


def _port_collect(scene, robust):
    ttl = scene["ttl"]
    out = tcol.collect_portals(ttl.top_node_t, scene["packed"], ttl.top_root,
                               robust=robust, stack_depth=ttl.top_depth + 1,
                               max_portals=MP)
    return [x.numpy() for x in out]


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("robust", [False, True])
def test_collect_matches_pallas(scene, robust):
    want = _pallas_collect(scene["jtl"], scene["packed"], robust)
    ptid, ptent, stats = _port_collect(scene, robust)
    assert np.array_equal(ptid, want[0])
    assert np.array_equal(stats[0], want[2][0])   # portal count
    assert np.array_equal(stats[1], want[2][1])   # stack high-water mark
    assert not stats[2].any()                      # no overflow
    assert stats[0].max() > 1, "rays must enter several treelets"
    assert np.array_equal(np.isinf(ptent), np.isinf(want[1]))
    fin = np.isfinite(ptent)
    if robust:
        # (nb - org) * inv has no multiply-add to contract: bit-equal
        assert ptent.tobytes() == want[1].tobytes()
    else:
        # XLA CPU computes nb*inv + inv_org as one FMA (C5)
        assert _ulps(ptent[fin], want[1][fin]).max() <= 8


def test_collect_fast_matches_pallas_with_fma_rounding(scene, monkeypatch):
    """With the fast slab form rounded as one FMA, as XLA's CPU backend
    compiles it, the plain version reproduces the Pallas kernel bit for
    bit: the state machines are the same."""
    def fma_planes(lo, hi, d, org, inv, inv_org, inv_pad, neg, robust):
        nb = torch.where(neg[d], hi, lo)
        fb = torch.where(neg[d], lo, hi)

        def fma(x):
            return (x.double() * inv[d].double()
                    + inv_org[d].double()).float()
        return fma(nb), fma(fb)

    monkeypatch.setattr(tcol, "slab_planes", fma_planes)
    want = _pallas_collect(scene["jtl"], scene["packed"], False)
    got = _port_collect(scene, False)
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1].tobytes() == want[1].tobytes()
    assert np.array_equal(got[2][:2], want[2][:2])


@pytest.fixture(scope="module")
def pairs(scene):
    """Every (ray, portal) pair of phase A, carrying the ray's tmax."""
    ttl = scene["ttl"]
    portals = twt.collect_and_sort(ttl, scene["packed"], robust=False,
                                   top_stack=ttl.top_depth + 1,
                                   max_portals=MP)
    kk, rr = torch.nonzero(portals.tid >= 0, as_tuple=True)
    tid = portals.tid[kk, rr].to(torch.int32)
    rays = scene["packed"][:, portals.sel[rr]].contiguous()
    return tid, rays


def _traverse_core_by_treelet(jtl, tid, rays, any_hit, robust, stack_depth):
    """bvh_tpu's `_traverse_core` over each treelet's pairs (it walks
    one [64, P] table), vmapped over treelets with lanes padded to 128."""
    tid = tid.numpy()
    rays = rays.numpy()
    groups = [np.nonzero(tid == t)[0] for t in np.unique(tid)]
    B = -(-max(len(g) for g in groups) // 128) * 128
    n = len(groups)
    org = np.zeros((n, 3, B), np.float32)
    dr = np.ones((n, 3, B), np.float32)
    tmn = np.zeros((n, 1, B), np.float32)
    tmx = np.zeros((n, 1, B), np.float32)
    act = np.zeros((n, 1, B), bool)
    for i, g in enumerate(groups):
        org[i, :, :len(g)] = rays[0:3, g]
        dr[i, :, :len(g)] = rays[3:6, g]
        tmn[i, 0, :len(g)] = rays[6, g]
        tmx[i, 0, :len(g)] = rays[7, g]
        act[i, 0, :len(g)] = True
    tabs = np.asarray(jtl.table)[[tid[g[0]] for g in groups]]
    core = jax.jit(jax.vmap(partial(jwt._traverse_core, any_hit=any_hit,
                                    robust=robust, stack_depth=stack_depth)))
    out = core(*(jnp.asarray(x) for x in (tabs, org, dr, tmn, tmx, act)))
    out = [np.asarray(x)[:, 0, :] for x in out]
    res = np.zeros((7, len(tid)), np.float32)
    for i, g in enumerate(groups):
        for r in range(7):
            res[r, g] = out[r][i, :len(g)]
    return res


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("robust", [False, True])
def test_traverse_pairs_matches_traverse_core(scene, pairs, any_hit, robust):
    tid, rays = pairs
    sd = 7 * scene["ttl"].wide_depth + 8
    want = _traverse_core_by_treelet(scene["jtl"], tid, rays, any_hit,
                                     robust, sd)
    out_f, out_i = twt.traverse_pairs(scene["ttl"].table_cols, tid, rays,
                                      any_hit=any_hit, robust=robust,
                                      stack_depth=sd)
    t, u, v = out_f.numpy()
    pos, asteps, hwm, ovf = out_i.numpy()
    hit = np.isfinite(t)
    assert hit.sum() > 50 and (~hit).sum() > 50
    assert np.array_equal(hit, np.isfinite(want[0]))
    assert np.allclose(t[hit], want[0][hit], rtol=1e-6, atol=1e-6)
    # u, v go through r = cross(dir, p0 - org), whose terms cancel;
    # XLA contracts them into FMAs (C5), which moves u, v by up to ~1e-6
    assert np.allclose(u[hit], want[1][hit], atol=1e-5)
    assert np.allclose(v[hit], want[2][hit], atol=1e-5)
    mism = int((pos != want[3].astype(np.int64)).sum())
    assert mism <= max(1, int(0.002 * len(pos))), f"{mism} prim mismatches"
    assert np.array_equal(asteps, want[6].astype(np.int64))
    enc = want[5].astype(np.int64)            # hwm + 1000 * overflow (C1)
    assert np.array_equal(hwm, enc % 1000)
    assert np.array_equal(ovf, enc // 1000)
    assert not ovf.any()
