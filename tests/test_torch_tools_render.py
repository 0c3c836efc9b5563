"""The port's render tools (bvh_tpu_torch/tools/: bench_wide,
check_wide_quick, check_super_quick, bench_sanmiguel, ablate_kernel2,
bench_dims) on the CPU at small sizes, where the plain versions stand in
for the kernels, against bvh_tpu:

- the renders of bench_wide (two treelet sizes), check_wide_quick and
  check_super_quick (a forced super level) give the hits of bvh_tpu's
  render (its wavefront `intersect_tris`) of the fixture scene of
  tests/test_torch_wide_treelet.py (sponza_class(3000, 3), MEDIUM tree,
  32x32 rays) under the rule of tests/test_wide_treelet.py
  (`_hits_match`); a check held to a wrong count fails;
- bench_sanmiguel on that scene cut at max_prims=128, super_prims=512:
  the serialize round trip holds `bvh_equal`, the loaded tree's tables
  equal bvh_tpu's tables for that cut bit for bit, its hits bvh_tpu's,
  and profile_sm's loader reads the tables file it writes;
- ablate_kernel2's base variant equals `traverse_pairs_ref` on the
  recorded round-1 pairs;
- bench_dims at m = 64 and 1,024 rays: the spheres' hits equal bvh_tpu's
  wavefront `traverse` with `make_sphere_leaf_fn` on the same trees: hit
  set and prim ids equal, t within rtol 5e-5. Why the rounding and the
  tolerance (ROADMAP C5, tests/test_torch_sphere.py): XLA contracts
  a*b+c into FMAs, and without that rounding one grazing 2D ray of the
  1,024 misses its closest sphere in bvh_tpu and hits the next; so the
  float32 operands get XLA's rounding (`xla_rounding`; the tool's
  float64 triangles keep the port's), which is B6's Pallas kernel's. The
  wavefront contracts differently from that kernel, and the cancellation
  in b*b - 4ac magnifies the one-ulp differences: 3.7e-5 on one ray here,
  within tests/test_torch_sphere.py's 5e-5 for the port against bvh_tpu
  without a shared rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.core.ray import Ray as JRay
from bvh_tpu.core.types import Bvh as JBvh
from bvh_tpu.io.scenes import sponza_class
from bvh_tpu.traverse import wide_treelet as jwt
from bvh_tpu.traverse.wavefront import intersect_tris as j_intersect_tris
from bvh_tpu.traverse.wavefront import make_sphere_leaf_fn as j_leaf_fn
from bvh_tpu.traverse.wavefront import traverse as j_traverse
from bvh_tpu_torch.tools import ablate_kernel2, bench_dims, bench_sanmiguel, \
    bench_wide, check_super_quick, check_wide_quick, profile_sm
from bvh_tpu_torch.tools.timing import same
from bvh_tpu_torch.traverse import wide_treelet as twt
from bvh_tpu_torch.core import utils
from test_torch_build import xla_fma
from test_torch_sphere import RTOL_OWN
from test_torch_wide_treelet import _hits_match, scene  # noqa: F401 - fixture

MAX_PRIMS, SUPER_PRIMS = 128, 512
SIZE = dict(n=3000, side=32)  # the fixture scene's


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """At these sizes torch's intra-op threads gain nothing and contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ws(scene):
    """The fixture scene as the tools take it."""
    return bench_wide.WideScene(sponza_class(3000, seed=3), scene["tbvh"],
                                torch.from_numpy(np.array(scene["jflat"])),
                                scene["trays"])


@pytest.fixture(scope="module")
def jhit(scene):
    """bvh_tpu's closest-hit render of the scene, (t, prim_id), by its
    wavefront: the hits of its wide-treelet render in interpret mode
    (tests/test_torch_wide_treelet.py) in a twentieth of the time."""
    h = j_intersect_tris(scene["jbvh"], scene["jflat"], scene["jrays"])
    return np.asarray(h.t), np.asarray(h.prim_id).astype(np.int64)


def _match(fields, jhit):
    _hits_match(fields[0].numpy(), fields[3].numpy(), *jhit)


@pytest.fixture
def oracle(jhit, monkeypatch):
    """The checks' oracle counts at the fixture scene's size set to
    bvh_tpu's hits; returns a setter for another count."""
    def set_count(hits):
        for table in (check_wide_quick.ORACLE_HITS,
                      bench_sanmiguel.ORACLE_HITS):
            monkeypatch.setitem(table, (SIZE["n"], SIZE["side"]), hits)

    set_count(int(np.isfinite(jhit[0]).sum()))
    return set_count


def test_bench_wide_hits_match_bvh_tpu(ws, jhit):
    res = bench_wide.run(max_prims=(MAX_PRIMS, 256), device="cpu", reps=1,
                         scene=ws)
    for mp, r in res.items():
        _match(r["fields"], jhit)
        assert r["hits"] == np.isfinite(jhit[0]).sum() and r["rounds"] >= 1
        assert r["T"] >= 2 and r["P"] % 128 == 0 and r["raised"] == {}
    assert res[MAX_PRIMS]["T"] > res[256]["T"]


def test_check_wide_quick(ws, jhit, oracle):
    res = check_wide_quick.run(**SIZE, device="cpu", scene=ws)
    assert res["ok"] and res["budget"] == 0
    assert res["expect"] == res["hits"]
    _match(res["fields"], jhit)
    oracle(res["hits"] + 1)
    assert not check_wide_quick.run(**SIZE, device="cpu", scene=ws)["ok"]


def test_check_super_quick(ws, jhit, oracle):
    res = check_super_quick.run(**SIZE, device="cpu", reps=1,
                                max_prims=MAX_PRIMS, super_prims=SUPER_PRIMS,
                                scene=ws)
    assert res["ok"] and res["S"] > 1 and res["expect"] is not None
    _match(res["two_level"]["fields"], jhit)
    _match(res["flat"]["fields"], jhit)
    with pytest.raises(ValueError, match="no super level"):
        check_super_quick.run(device="cpu", scene=ws, super_prims=1 << 30)


def test_bench_sanmiguel_round_trip(scene, ws, jhit, oracle, tmp_path):
    npz = str(tmp_path / "tables.npz")
    res = bench_sanmiguel.run(**SIZE, max_prims=MAX_PRIMS,
                              super_prims=SUPER_PRIMS, reps=1, device="cpu",
                              cache_dir=str(tmp_path), tables_out=npz,
                              scene=ws)
    a13 = res["a13c"]
    assert res["ok"] and res["expect"] == res["render"]["hits"]
    assert a13["bvh_equal"] and a13["tables_equal"]
    assert a13["hits_equal"] and res["S"] > 1 and a13["bytes"] > 0
    assert (tmp_path / "bench_given_3000.bvh").stat().st_size == a13["bytes"]
    # the loaded tree's tables are bvh_tpu's for this cut
    jtl = jwt.build_wide_treelets(scene["jbvh"], scene["jflat"],
                                  max_prims=MAX_PRIMS,
                                  super_prims=SUPER_PRIMS)
    tl = a13["loaded_tl"]
    for f in ("top_node_t", "table", "sup_table"):
        assert getattr(tl, f).numpy().tobytes() == \
            np.asarray(getattr(jtl, f)).tobytes(), f
    for f in bench_sanmiguel.INT_FIELDS:
        assert getattr(tl, f) == getattr(jtl, f), f
    assert np.array_equal(tl.n_wide, jtl.n_wide)
    _match(res["render"]["fields"], jhit)
    # profile_sm reads the tables file
    assert bench_sanmiguel.same_tables(profile_sm.load_tables(npz, "cpu"),
                                       tl)


def test_ablate_kernel2_base_equals_plain(scene):
    round1 = ablate_kernel2.round_one(scene["ttl"], scene["trays"], "cpu")
    res = ablate_kernel2.run(scene["ttl"], scene["trays"], "cpu", reps=1,
                             round1=round1)
    r = res["base"]
    assert set(res) == set(ablate_kernel2.VARIANTS)
    assert all(v["steps"] > 0 for v in res.values())
    tid, prays = round1["b1"][0][1:]
    want = twt.traverse_pairs_ref(scene["ttl"].table, tid, prays,
                                  any_hit=False, robust=False,
                                  stack_depth=7 * scene["ttl"].wide_depth + 8)
    assert same(r["out"], want)
    assert not same(res["leaf"]["out"], want)


def _to_jax(tb):
    return JBvh(bounds=jnp.asarray(tb.bounds.numpy()),
                index=jnp.asarray(tb.index.numpy().astype(np.uint32)),
                prim_ids=jnp.asarray(tb.prim_ids.numpy().astype(np.uint32)),
                node_count=jnp.int32(tb.node_count),
                prim_count=jnp.int32(tb.prim_count))


@pytest.fixture
def xla_rounding_f32(monkeypatch):
    plain = utils.fast_mul_add
    monkeypatch.setattr(utils, "fast_mul_add", lambda a, b, c: (
        xla_fma(a, b, c) if a.dtype == torch.float32 else plain(a, b, c)))


def test_bench_dims_spheres_match_bvh_tpu(xla_rounding_f32):
    m, R = 64, 1024
    res = bench_dims.run(m=m, rays=R, f64_rays=R, reps=1, device="cpu")
    for dim in bench_dims.DIMS:
        c, r, bvh, rays = bench_dims.sphere_scene(dim, m, R, "cpu")
        jb = _to_jax(bvh)
        jc, jr = jnp.asarray(c.numpy()), jnp.asarray(r.numpy())
        want = j_traverse(jb, JRay.make(jnp.asarray(rays.org.numpy()),
                                        jnp.asarray(rays.dir.numpy())),
                          j_leaf_fn(jb, jc, jr))
        fields = res[dim]["fields"]
        t, pid = fields[0].numpy(), fields[4].numpy()
        hit = np.isfinite(t)
        assert np.array_equal(hit, np.asarray(want.hit)) and hit.any()
        assert np.array_equal(pid[hit],
                              np.asarray(want.prim_id).astype(np.int64)[hit])
        np.testing.assert_allclose(t[hit], np.asarray(want.t)[hit],
                                   rtol=RTOL_OWN)
        assert res[dim]["parity"]["ok"]
    assert res["f64"]["hits"] > 0
