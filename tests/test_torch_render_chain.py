"""The one-program render (`_render_fixed`), the render chain and
`steady_rate` of bvh_tpu_torch against the port's eager render and
bvh_tpu's chain, on the CPU with the kernels' plain versions.

The scene is tests/test_wide_treelet.py's (sponza_class(3000, 3),
max_prims=256, 32x32 primary rays). Its MEDIUM tree is built once, by
the port, and handed to both packages, so both render the same treelet
tables and the file stays within its time: bvh_tpu's own MEDIUM build
compiles for about 40 s here. bvh_tpu's chain runs once, in interpret
mode with block=256, top_block=512, and its row is reused.

- `_render_fixed` equals the eager `_render` bit for bit (t, u, v,
  pos) at the same caps and k, with a tail width that makes rays wait;
- the chain (k = 3) matches bvh_tpu's chain hit for hit under the rule
  of tests/test_wide_treelet.py:40-56, and the port's entry point bit
  for bit; with ray 0 missing (tests/test_wide_treelet.py:196-228); and
  it leaves -0.0 directions as they were;
- too few rounds, and a sel_cap below the rays with portals, set their
  flags, and the chain raises;
- the render's glue reads nothing on the host (run on the meta device);
- `steady_rate` and `wide_treelet_perf` equal bvh_tpu's.
"""

import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.cli import steady as jsteady
from bvh_tpu.cli.camera import primary_rays as j_primary_rays
from bvh_tpu.core.types import Bvh as JBvh
from bvh_tpu.geom.tri import PrecomputedTri as JPre
from bvh_tpu.geom.tri import Tri as JTri
from bvh_tpu.io.scenes import scene_camera, sponza_class
from bvh_tpu.traverse import wide_treelet as jwt
from bvh_tpu_torch.build.default import DefaultConfig, Quality, build_default
from bvh_tpu_torch.cli import steady
from bvh_tpu_torch.cli.camera import primary_rays as t_primary_rays
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.geom.tri import PrecomputedTri, Tri
from bvh_tpu_torch.traverse import wide_treelet as wt

CHAIN_K = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """At these sizes torch's intra-op threads gain nothing and contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    tris = sponza_class(3000, seed=3)
    tt = torch.from_numpy(tris)
    bvh = build_default(tt.min(1).values, tt.max(1).values, tt.mean(1),
                        DefaultConfig(quality=Quality.MEDIUM))
    flat = PrecomputedTri.from_tri(Tri(tt[:, 0], tt[:, 1], tt[:, 2])).as_flat()
    tl = wt.build_wide_treelets(bvh, flat, max_prims=256)
    nc, pc = int(bvh.node_count), int(bvh.prim_count)
    jbvh = JBvh(jnp.asarray(bvh.bounds.numpy()),
                jnp.asarray(bvh.index.numpy().astype(np.uint32)),
                jnp.asarray(bvh.prim_ids.numpy().astype(np.uint32)),
                jnp.asarray(nc, jnp.int32), jnp.asarray(pc, jnp.int32))
    jflat = JPre.from_tri(JTri(*(jnp.asarray(tris[:, i])
                                 for i in range(3)))).as_flat()
    jtl = jwt.build_wide_treelets(jbvh, jflat, max_prims=256)
    eye, d, up = scene_camera(tris)
    jrays = j_primary_rays(eye, d, up, 32, 32)
    rays = t_primary_rays(eye, d, up, 32, 32, device="cpu")
    jchain = jwt.wide_treelet_render_chain(jtl, jrays, CHAIN_K, block=256,
                                           top_block=512, interpret=True)
    return dict(tl=tl, bvh=bvh, flat=flat, rays=rays,
                jtable=np.asarray(jtl.table), jchain_t=np.asarray(jchain()))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _stats(out):
    return dict(zip(wt.FIXED_STATS, out[-1].tolist()))


@pytest.fixture(scope="module")
def verified(scene):
    """The eager entry point's caps and hits, closest and any-hit."""
    out = {}
    for any_hit in (False, True):
        hit, diag = wt.wide_treelet_intersect_tris(
            scene["tl"], scene["rays"], any_hit=any_hit, return_diag=True)
        out[any_hit] = hit, diag
    return out


def test_both_packages_render_the_same_tables(scene):
    assert scene["tl"].table.numpy().tobytes() == scene["jtable"].tobytes()


@pytest.mark.parametrize("k", [4, 1])
@pytest.mark.parametrize("any_hit", [False, True])
def test_fixed_equals_eager_render(scene, verified, any_hit, k):
    """At a tail_cap of 8 more rays are ready after round 1 than a tail
    round takes, so rays wait and the fixed schedule needs more rounds
    than the eager one. (The chain's tests below run it at its default
    tail_cap, where none waits.)"""
    tl, packed = scene["tl"], wt.pack_rays(scene["rays"])
    caps = verified[any_hit][1]["caps"]
    want = wt.render_at_caps(tl, packed, caps, any_hit=any_hit,
                             robust=False, k=k)
    out = wt._render_fixed(tl, packed, caps, any_hit=any_hit, robust=False,
                           k=k, sel_cap=1024, tail_cap=8, rounds=40)
    st = _stats(out)
    assert _same(out[:5], want[:5])
    assert not (st["pending"] or st["stack_ovf"] or st["top_ovf"])
    assert st["nready"] == int((want[4] > 0).sum())
    assert st["max_cnt"] == want[5]["max_cnt"]
    assert int(torch.isfinite(out[0]).sum()) > 50
    assert st["rounds_used"] > want[5]["rounds"]


def test_chain_matches_reference_chain(scene, verified):
    """The port's chain at k = 3 against bvh_tpu's: hit for hit, t to
    within XLA's FMA rounding (ROADMAP C5); and bit for bit against the
    port's entry point."""
    chain = wt.wide_treelet_render_chain(scene["tl"], scene["rays"], CHAIN_K,
                                         block=256)
    R = scene["rays"].tmin.shape[0]
    got = chain()
    assert got.shape == (1024,) and chain.graph is None
    jt = scene["jchain_t"][:R]
    gt = got[:R].numpy()
    hit = np.isfinite(gt)
    assert np.array_equal(hit, np.isfinite(jt)) and hit.sum() > 50
    assert np.allclose(gt[hit], jt[hit], rtol=1e-6, atol=1e-6)
    assert torch.equal(_bits(got[:R]), _bits(verified[False][0].t))


def test_chain_survives_missing_ray0(scene):
    """tests/test_wide_treelet.py:196-228: with ray 0 a miss, the
    feed-forward leaves the other renders whole."""
    r = scene["rays"]
    org, d = r.org.clone(), r.dir.clone()
    org[0] = torch.tensor([1e6, 1e6, 1e6])
    d[0] = torch.tensor([0.0, 0.0, 1.0])
    rays = Ray.make(org, d, tmin=r.tmin, tmax=r.tmax)
    direct = wt.wide_treelet_intersect_tris(scene["tl"], rays)
    assert not torch.isfinite(direct.t[0])
    got = wt.wide_treelet_render_chain(scene["tl"], rays, CHAIN_K)()
    assert torch.equal(_bits(got[:1024]), _bits(direct.t))


def test_chain_keeps_negative_zero_directions(scene):
    """Rays with -0.0 direction components come out of k renders bit for
    bit as they went in (adding the +0.0 feed would make them +0.0)."""
    r = scene["rays"]
    d = r.dir.clone()
    d[::5, 0] = -0.0
    d[::7, 2] = -0.0
    rays = Ray(r.org, d, r.tmin, r.tmax)
    packed = wt.pack_rays(rays)
    assert not torch.equal(_bits(packed + 0.0), _bits(packed))
    chain = wt.wide_treelet_render_chain(scene["tl"], rays, CHAIN_K)
    got = chain()
    assert torch.equal(_bits(chain.packed), _bits(packed))
    direct = wt.wide_treelet_intersect_tris(scene["tl"], rays)
    assert torch.equal(_bits(got[:1024]), _bits(direct.t))


@pytest.mark.parametrize("cap", ["rounds", "sel_cap"])
def test_overflow_flags_raise(scene, verified, cap):
    """`rounds` one short leaves a ray ready; a `sel_cap` below the rays
    that recorded a portal leaves rays out. Each sets its flag, the
    chain without auto_caps raises instead of returning, and with
    auto_caps it re-runs with the cap raised and gives the eager hits."""
    tl, rays = scene["tl"], scene["rays"]
    caps = verified[False][1]["caps"]
    kw = dict(any_hit=False, robust=False, k=4, tail_cap=8)
    full = _stats(wt._render_fixed(tl, wt.pack_rays(rays), caps,
                                   sel_cap=1024, rounds=40, **kw))
    short = dict(rounds=full["rounds_used"] - 1) if cap == "rounds" else \
        dict(sel_cap=full["nready"] // 2)
    args = dict(dict(sel_cap=1024, rounds=40), **short)
    out = wt._render_fixed(tl, wt.pack_rays(rays), caps, **args, **kw)
    bumps = wt.fixed_overflow(out[-1].tolist(), caps, args["sel_cap"],
                              args["rounds"])
    if cap == "rounds":
        assert _stats(out)["pending"] == 1
        assert bumps == {"rounds": 2 * short["rounds"]}
    else:
        assert bumps == {"sel_cap": full["nready"]}
    chain_kw = dict(short, tail_cap=8, tail_block=8, block=8)
    with pytest.raises(ValueError, match="render chain overflowed"):
        wt.wide_treelet_render_chain(tl, rays, 2, auto_caps=False,
                                     **chain_kw)
    chain = wt.wide_treelet_render_chain(tl, rays, 2, **chain_kw)
    assert getattr(chain, cap) > short[cap]
    assert torch.equal(_bits(chain()[:1024]), _bits(verified[False][0].t))


def test_chain_refuses_supers_and_tpu_keys(scene):
    tl2 = wt.build_wide_treelets(scene["bvh"], scene["flat"], max_prims=128,
                                 super_prims=512)
    assert tl2.sup_cols.shape[0] > 0
    with pytest.raises(NotImplementedError, match="R2"):
        wt.wide_treelet_render_chain(tl2, scene["rays"], 2)
    with pytest.raises(NotImplementedError, match="R2"):
        wt._render_fixed(tl2, wt.pack_rays(scene["rays"]), {}, any_hit=False,
                         robust=False, k=4, sel_cap=8, tail_cap=8, rounds=1)
    for key in ("top_block", "interpret", "tail_k"):
        with pytest.raises(ValueError, match="TPU"):
            wt.wide_treelet_render_chain(scene["tl"], scene["rays"], 2,
                                         **{key: 1})
    with pytest.raises(ValueError, match="unknown"):
        wt.wide_treelet_render_chain(scene["tl"], scene["rays"], 2, blok=8)


def test_traverse_count_plain(scene):
    """B1's `count`: the pairs from count on are misses in the plain
    version (the kernel leaves them unwritten); the others are as
    without it."""
    tl, packed = scene["tl"], wt.pack_rays(scene["rays"])
    portals = wt.collect_and_sort(tl, packed, robust=False,
                                  top_stack=tl.top_depth + 1, max_portals=32)
    kk, rr = torch.nonzero(portals.tid >= 0, as_tuple=True)
    tid = portals.tid[kk, rr].to(torch.int32)
    prays = packed[:, portals.sel[rr]].contiguous()
    kw = dict(any_hit=False, robust=False, stack_depth=7 * tl.wide_depth + 8)
    f, i = wt.traverse_pairs(tl.table_cols, tid, prays, **kw)
    n = tid.shape[0] // 2
    cf, ci = wt.traverse_pairs(tl.table_cols, tid, prays, **kw,
                               count=torch.tensor([n], dtype=torch.int32))
    assert _same((cf[:, :n], ci[:, :n]), (f[:, :n], i[:, :n]))
    assert torch.isinf(cf[0, n:]).all() and (ci[0, n:] == -1).all()
    assert torch.isfinite(f[0, n:]).any()


def _meta_scene(T=5, P=128, Pt=128):
    meta = torch.device("meta")
    return wt.WideTreelets(
        top_node_t=torch.empty(16, Pt, device=meta), top_root=1 << 4,
        table_cols=torch.empty(T, P, 64, device=meta), n_prims=100,
        n_wide=np.zeros(T, np.int64), top_depth=4, wide_depth=2,
        sup_cols=torch.empty(0, 128, 16, device=meta), sup_depth=1)


@pytest.mark.parametrize("any_hit", [False, True])
def test_render_makes_no_host_read(monkeypatch, any_hit):
    """The glue of `_render_fixed` on meta tensors, the kernels stubbed
    to meta outputs of their shapes, with every host read patched to
    raise: a render that read a device value on the host, or took a
    shape from one, fails here."""
    meta = torch.device("meta")

    def collect(top, rays, root, *, robust, stack_depth, max_portals):
        R = rays.shape[1]
        return (torch.empty(max_portals, R, dtype=torch.int32, device=meta),
                torch.empty(max_portals, R, device=meta),
                torch.empty(3, R, dtype=torch.int32, device=meta))

    launches = []

    def traverse(cols, tid, rays, *, any_hit, robust, stack_depth, count):
        L = tid.shape[0]
        assert tid.dtype == torch.int32 and tuple(rays.shape) == (8, L)
        assert count.dtype == torch.int32 and count.shape == (1,)
        launches.append(L)
        return (torch.empty(3, L, device=meta),
                torch.empty(4, L, dtype=torch.int32, device=meta))

    def host_read(*_args, **_kw):
        raise AssertionError("the render read a device value on the host")

    for name in ("item", "__bool__", "__int__", "__float__", "tolist",
                 "nonzero", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    monkeypatch.setattr(torch, "nonzero", host_read)
    caps = dict(top_stack=5, stack_depth=22, max_portals=32)
    out = wt._render_fixed(_meta_scene(), torch.empty(8, 1000, device=meta),
                           caps, any_hit=any_hit, robust=False, k=4,
                           sel_cap=256, tail_cap=64, rounds=5,
                           collect=collect, traverse=traverse)
    assert [tuple(o.shape) for o in out] == [(1000,)] * 5 + [(6,)]
    assert launches == [4 * 256] + [4 * 64] * 4


def test_steady_rate_equals_reference(monkeypatch):
    """The two-point arithmetic, each package under a fresh copy of one
    fake clock: a chain of k renders takes C + k * r, plus noise a
    call, so the medians matter."""

    def fake_chains():
        now = [0.0]
        noise = iter(np.random.default_rng(5).uniform(0, 1e-4, 64).tolist())
        monkeypatch.setattr(time, "perf_counter", lambda: now[0])

        def make_chain(k):
            def run():
                now[0] += 0.004 + k * 0.0021 + next(noise)
            return run
        return make_chain

    got = steady.steady_rate(fake_chains(), 4, 12, reps=3)
    want = jsteady.steady_rate(fake_chains(), 4, 12, reps=3)
    assert got == want
    assert got[0] == pytest.approx(0.0021, abs=2e-5)
    assert got[1] == pytest.approx(0.004, abs=2e-4)


@pytest.mark.parametrize("T", [1, 17, 2047, 2048, 13363])
def test_perf_equals_reference(T):
    tl = types.SimpleNamespace(table=np.zeros((T, 0, 0), np.float32))
    assert wt.wide_treelet_perf(tl) == jwt.wide_treelet_perf(tl)
    assert wt.portals_per_round(tl) == jwt.wide_treelet_perf(
        tl)["portals_per_round"]
