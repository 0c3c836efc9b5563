"""Two-level wide-treelet scenes (a super level between the top region
and the treelets) in the port against bvh_tpu, on the fixture of
tests/test_torch_wide_treelet.py (sponza_class(3000, 3), MEDIUM tree,
32x32 primary rays) cut at max_prims=128, super_prims=512:

- phase A2 (kernel B4): `collect_super_pairs`' plain version, on the
  [S, 16, Ps] view `sup_table` of the stored rows `sup_cols`, against
  bvh_tpu's `_phase_a2(interpret=True)` on the same (ray, super) pairs;
- the whole two-level render of the port's plain versions against
  bvh_tpu's `wide_treelet_intersect_tris(interpret=True)`, closest,
  any-hit and robust, under the rule of tests/test_wide_treelet.py:40-56;
- the two-level render equal to the flat scheme's on the same tree
  (tests/test_wide_treelet.py:156-180), and the A2 caps' overflow bits.

Why some comparisons carry a tolerance: XLA's CPU backend contracts
a*b+c into fused multiply-adds inside compiled code (ROADMAP C5); with
the fast slab form rounded as one FMA the plain version of B4 equals
the Pallas kernel bit for bit (test_a2_fast_matches_with_fma_rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.traverse import wide_treelet as jwt
from bvh_tpu_torch.traverse import collect as tcol
from bvh_tpu_torch.traverse import wide_treelet as twt
from test_torch_wide_kernels import _ulps
from test_torch_wide_treelet import _hits_match, scene  # noqa: F401 - fixture

MAX_PRIMS, SUPER_PRIMS = 128, 512


@pytest.fixture(scope="module")
def two_level(scene):
    jflat = jnp.asarray(np.array(scene["jflat"]))
    jtl = jwt.build_wide_treelets(scene["jbvh"], jflat, max_prims=MAX_PRIMS,
                                  super_prims=SUPER_PRIMS)
    ttl = twt.build_wide_treelets(scene["tbvh"], torch.from_numpy(
        np.array(jflat)), max_prims=MAX_PRIMS, super_prims=SUPER_PRIMS)
    flat_tl = twt.build_wide_treelets(scene["tbvh"], torch.from_numpy(
        np.array(jflat)), max_prims=MAX_PRIMS)
    assert ttl.sup_table.shape[0] > 1 and jtl.sup_table.shape[0] > 1
    return dict(jtl=jtl, ttl=ttl, flat_tl=flat_tl)


def _a2_pairs(scene, two_level, robust):
    """Every (ray, super) pair that phase A records, as the A2 rounds
    hand them to the kernel: the super ids and the rays' packed rows."""
    ttl = two_level["ttl"]
    T = ttl.table.shape[0]
    portals = twt.collect_and_sort(ttl, scene["packed"], robust=robust,
                                   top_stack=ttl.top_depth + 1,
                                   max_portals=64)
    kk, rr = torch.nonzero(portals.tid >= T, as_tuple=True)
    sid = (portals.tid[kk, rr] - T).to(torch.int32)
    rays = scene["packed"][:, portals.sel[rr]].contiguous()
    return sid, rays


def _pallas_a2(jtl, sid, rays, robust, max_new, block=128):
    """bvh_tpu's `_phase_a2(interpret=True)` over the pairs: one block
    per pair run of one super, as `expand_supers` lays them out
    (wide_treelet.py:1797-1829). Returns ntid, nt, count per pair."""
    sid_np, rays_np = sid.numpy(), rays.numpy()
    L = len(sid_np)
    order = np.argsort(sid_np, kind="stable")
    starts, blocks = [], []
    i = 0
    while i < L:
        s = sid_np[order[i]]
        j = i
        while j < L and sid_np[order[j]] == s and j - i < block:
            j += 1
        starts.append(i)
        blocks.append((s, j - i))
        i = j
    data = np.zeros((16, L + block + 128), np.float32)
    data[8, :] = L
    data[0:8, :L] = rays_np[:, order]
    data[8, :L] = order
    data[9, :L] = 1.0
    out = np.asarray(jwt._phase_a2(
        jnp.asarray([b[0] for b in blocks], jnp.int32),
        jnp.asarray(starts, jnp.int32),
        jnp.asarray([b[1] for b in blocks], jnp.int32),
        jnp.asarray(np.asarray(jtl.sup_table)), jnp.asarray(data),
        block=block, robust=robust, stack_depth=jtl.sup_depth + 1,
        max_new=max_new, interpret=True))
    ntid = np.full((max_new, L), -1, np.int64)
    nt = np.full((max_new, L), np.inf, np.float32)
    cnt = np.zeros(L, np.int64)
    for b, (start, (_, n)) in enumerate(zip(starts, blocks)):
        cols = b * block + np.arange(n)
        pid = order[start:start + n]
        assert np.array_equal(out[2 * max_new, cols], pid)
        ntid[:, pid] = out[:max_new, cols]
        nt[:, pid] = out[max_new:2 * max_new, cols]
        cnt[pid] = out[2 * max_new + 1, cols]
    return ntid, nt, cnt


@pytest.mark.parametrize("robust", [False, True])
def test_a2_matches_pallas(scene, two_level, robust):
    """B4's plain version against the Pallas kernel on every pair; the
    count includes portals past the cap (max_new=4 makes some)."""
    sid, rays = _a2_pairs(scene, two_level, robust)
    assert sid.numel() > 100
    max_new = 4
    want = _pallas_a2(two_level["jtl"], sid, rays, robust, max_new)
    ntid, nt, stats = tcol.collect_super_pairs_ref(
        two_level["ttl"].sup_table, sid, rays, robust=robust,
        stack_depth=two_level["ttl"].sup_depth + 1, max_new=max_new)
    assert np.array_equal(ntid.numpy(), want[0])
    assert np.array_equal(stats[0].numpy(), want[2])
    assert (stats[0] > max_new).any() and (stats[0] > 0).any()
    assert not stats[2].any()
    assert stats[1].max() <= two_level["ttl"].sup_depth
    nt = nt.numpy()
    assert np.array_equal(np.isinf(nt), np.isinf(want[1]))
    fin = np.isfinite(nt)
    if robust:
        assert nt.tobytes() == want[1].tobytes()
    else:
        # XLA CPU computes nb*inv + inv_org as one FMA (C5)
        assert _ulps(nt[fin], want[1][fin]).max() <= 8


def test_a2_fast_matches_with_fma_rounding(scene, two_level, monkeypatch):
    """With the fast slab form rounded as one FMA, as XLA compiles it,
    the plain version of B4 equals the Pallas kernel bit for bit."""
    def fma_planes(lo, hi, d, org, inv, inv_org, inv_pad, neg, robust):
        nb = torch.where(neg[d], hi, lo)
        fb = torch.where(neg[d], lo, hi)

        def fma(x):
            return (x.double() * inv[d].double()
                    + inv_org[d].double()).float()
        return fma(nb), fma(fb)

    sid, rays = _a2_pairs(scene, two_level, False)
    want = _pallas_a2(two_level["jtl"], sid, rays, False, 16)
    monkeypatch.setattr(tcol, "slab_planes", fma_planes)
    ntid, nt, stats = tcol.collect_super_pairs(
        two_level["ttl"].sup_cols, sid, rays, robust=False,
        stack_depth=two_level["ttl"].sup_depth + 1, max_new=16)
    assert np.array_equal(ntid.numpy(), want[0])
    assert nt.numpy().tobytes() == want[1].tobytes()
    assert np.array_equal(stats[0].numpy(), want[2])


@pytest.mark.parametrize("any_hit, robust", [(False, False), (True, False),
                                             (False, True)])
def test_two_level_render_matches_reference(scene, two_level, any_hit,
                                            robust):
    jhit = jwt.wide_treelet_intersect_tris(
        two_level["jtl"], scene["jrays"], prim_ids=scene["jbvh"].prim_ids,
        any_hit=any_hit, robust=robust, block=256, top_block=512,
        max_portals=64, interpret=True)
    thit, diag = twt.wide_treelet_intersect_tris(
        two_level["ttl"], scene["trays"], prim_ids=scene["tbvh"].prim_ids,
        any_hit=any_hit, robust=robust, max_portals=64, return_diag=True)
    assert diag["a2_rounds"] > 0 and diag["a2_pairs"] > 100
    jt, tt = np.asarray(jhit.t), thit.t.numpy()
    assert np.isfinite(tt).sum() > 50
    if any_hit:
        assert np.array_equal(np.isfinite(jt), np.isfinite(tt))
    else:
        _hits_match(tt, thit.prim_id.numpy(), jt,
                    np.asarray(jhit.prim_id).astype(np.int64))
        # phase-A portal counts, supers included
        assert np.array_equal(thit.stats.visited_nodes.numpy(),
                              np.asarray(jhit.stats.visited_nodes))


@pytest.mark.parametrize("any_hit", [False, True])
def test_two_level_matches_flat(scene, two_level, any_hit):
    """The super cut changes how treelet portals are found, never which
    treelets a ray enters: the flat scheme's hits on the same tree."""
    assert (two_level["ttl"].table.shape[0]
            == two_level["flat_tl"].table.shape[0])
    kw = dict(prim_ids=scene["tbvh"].prim_ids, any_hit=any_hit,
              max_portals=64)
    a = twt.wide_treelet_intersect_tris(two_level["flat_tl"],
                                        scene["trays"], **kw)
    b = twt.wide_treelet_intersect_tris(two_level["ttl"], scene["trays"],
                                        **kw)
    if any_hit:
        assert torch.equal(torch.isfinite(a.t), torch.isfinite(b.t))
    else:
        assert torch.equal(a.t, b.t)
        _hits_match(a.t.numpy(), a.prim_id.numpy(), b.t.numpy(),
                    b.prim_id.numpy())


def test_a2_caps_auto_raise(scene, two_level):
    """mps and max_new below the need set their overflow bits; auto_caps
    re-runs with them raised and returns the same hits."""
    kw = dict(prim_ids=scene["tbvh"].prim_ids, max_portals=64)
    base = twt.wide_treelet_intersect_tris(two_level["ttl"], scene["trays"],
                                           **kw)
    hit, diag = twt.wide_treelet_intersect_tris(
        two_level["ttl"], scene["trays"], mps=1, max_new=1,
        return_diag=True, **kw)
    assert torch.equal(hit.t, base.t)
    assert torch.equal(hit.prim_id, base.prim_id)
    assert diag["caps"]["mps"] > 1 and diag["caps"]["max_new"] > 1
    with pytest.raises(ValueError, match="capacity overflow"):
        twt.wide_treelet_intersect_tris(two_level["ttl"], scene["trays"],
                                        mps=1, auto_caps=False, **kw)
