"""The port's spheres against bvh_tpu on the CPU: `Sphere` on the cases
of tests/test_geom.py and on random rays in 2D, 3D and 4D, float32 and
float64; the wavefront with `make_sphere_leaf_fn`; and kernel B6's
plain version (`sphere_traverse_ref`, reached through
`pallas_intersect_spheres` on the CPU) against bvh_tpu's
`pallas_intersect_spheres(interpret=True)` on the cases of
tests/test_dims_dtypes.py:109-173 (96 spheres and 256 rays at dim 2, 3
and 4; 80 spheres and 128 rays robust), closest and any-hit, fast and
robust.

Rounding (ROADMAP C5). Inside B6's Pallas kernel XLA's CPU backend
contracts each dot product as fma(x2, y2, fma(x1, y1, x0*y0)), c as
fma(-r, r, oc.oc) and the discriminant as fma(b, b, -(4a*c)) (probed);
`geom/sphere.py` routes exactly those through `fast_mul_add`, and with
XLA's rounding (`xla_rounding`) B6's plain version equals bvh_tpu's
kernel bit for bit in t, u, v, positions and both counts. Without it
hit masks, positions and counts are equal and t, v agree within
rtol 5e-5 (2.6e-5 found on these cases: the cancellation in b*b - 4ac
magnifies the one-ulp differences; bvh_tpu allows 2e-5 between its own
kernel and wavefront, tests/test_dims_dtypes.py:143-151). bvh_tpu's
wavefront and standalone
`Sphere.intersect` lay the rays out as [n, dim], where XLA sums oc.oc
without FMAs (probed), so against them the port holds hit masks and
positions equal and t0, t1 within the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.build.binned import build_binned as j_build_binned
from bvh_tpu.core.ray import Ray as JRay
from bvh_tpu.geom.sphere import Sphere as JSphere
from bvh_tpu.traverse.pallas_sphere import pallas_fits_spheres as j_fits
from bvh_tpu.traverse.pallas_sphere import pallas_intersect_spheres as j_pallas
from bvh_tpu.traverse.wavefront import make_sphere_leaf_fn as j_leaf_fn
from bvh_tpu.traverse.wavefront import traverse as j_traverse
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.core.types import bvh_from_numpy
from bvh_tpu_torch.geom import Sphere
from bvh_tpu_torch.traverse import sphere_kernel as sk
from bvh_tpu_torch.traverse.wavefront import make_sphere_leaf_fn, traverse
from test_torch_build import xla_rounding  # noqa: F401 - fixture

RTOL = 2e-5      # against bvh_tpu's wavefront and Sphere.intersect
RTOL_OWN = 5e-5  # against bvh_tpu's kernel, without XLA's rounding
MODES = [(False, False), (False, True), (True, False), (True, True)]
# (dim, spheres, sphere seed, rays, ray seed) of test_dims_dtypes.py
CASES = {"d2": (2, 96, 12, 256, 1), "d3": (3, 96, 13, 256, 1),
         "d4": (4, 96, 14, 256, 1), "robust3": (3, 80, 21, 128, 2)}


def _spheres(m, dim, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (m, dim)).astype(np.float32)
    radii = rng.uniform(0.02, 0.12, m).astype(np.float32)
    return centers, radii


def _rays(n, dim, seed):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-3, 3, (n, dim)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    return org, tgt - org


@pytest.fixture(scope="module")
def scenes():
    """bvh_tpu's binned tree of every case, in both packages."""
    out = {}
    for name, (dim, m, seed, n, rseed) in CASES.items():
        centers, radii = _spheres(m, dim, seed)
        jb = j_build_binned(jnp.asarray(centers - radii[:, None]),
                            jnp.asarray(centers + radii[:, None]),
                            jnp.asarray(centers))
        org, d = _rays(n, dim, rseed)
        out[name] = dict(
            jbvh=jb, centers=centers, radii=radii,
            tbvh=bvh_from_numpy(jb.bounds, jb.index, jb.prim_ids,
                                jb.node_count, jb.prim_count, "cpu"),
            jrays=JRay.make(jnp.asarray(org), jnp.asarray(d)),
            trays=Ray.make(torch.from_numpy(org), torch.from_numpy(d)))
    return out


@pytest.fixture(scope="module")
def reference(scenes):
    """bvh_tpu's Pallas kernel (interpret), computed on first use."""
    cache = {}

    def get(name, any_hit, robust):
        if (name, any_hit, robust) not in cache:
            s = scenes[name]
            n = s["jrays"].tmin.shape[0]
            cache[name, any_hit, robust] = j_pallas(
                s["jbvh"], jnp.asarray(s["centers"]), jnp.asarray(s["radii"]),
                s["jrays"], any_hit=any_hit, robust=robust, block=n,
                interpret=True)
        return cache[name, any_hit, robust]

    return get


def _b6(s, **kw):
    return sk.pallas_intersect_spheres(
        s["tbvh"], torch.from_numpy(s["centers"]),
        torch.from_numpy(s["radii"]), s["trays"], **kw)


def _bits(x):
    return np.asarray(x).astype(np.float32).view(np.int32)


def _compare(j, t, exact: bool, fields=("t", "u", "v"), rtol=RTOL):
    jpos = np.asarray(j.prim_pos).astype(np.int64)
    assert np.array_equal(jpos, t.prim_pos.numpy())
    assert np.array_equal(np.asarray(j.prim_id).astype(np.int64),
                          t.prim_id.numpy())
    hit = t.hit.numpy()
    for f in fields:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        if exact:
            assert np.array_equal(_bits(a), _bits(b)), f
        else:
            np.testing.assert_allclose(b[hit], a[hit], rtol=rtol, err_msg=f)
    for f in ("visited_nodes", "visited_leaves"):
        assert np.array_equal(np.asarray(getattr(j.stats, f)),
                              getattr(t.stats, f).numpy()), f


def test_sphere_geom_cases():
    """tests/test_geom.py:70-95."""
    sph = Sphere(torch.tensor([[0.0, 0.0, 5.0]]), torch.tensor([1.0]))
    hit_ray = Ray.make(torch.zeros((1, 3)), torch.tensor([[0.0, 0.0, 1.0]]))
    t0, t1, hit = sph.intersect(hit_ray)
    assert bool(hit[0]) and float(t0[0]) == 4.0 and float(t1[0]) == 6.0
    miss = Ray.make(torch.zeros((1, 3)), torch.tensor([[0.0, 1.0, 0.0]]))
    assert not bool(sph.intersect(miss)[2][0])
    mn, mx = Sphere(torch.tensor([[1.0, 2.0, 3.0]]),
                    torch.tensor([0.5])).get_bbox()
    assert mn[0].tolist() == [0.5, 1.5, 2.5]
    assert mx[0].tolist() == [1.5, 2.5, 3.5]
    assert torch.equal(sph.get_center(), sph.center)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim", [2, 3, 4])
def test_sphere_intersect_random(dim, dtype):
    rng = np.random.default_rng(dim)
    n = 512
    c = rng.uniform(-1, 1, (n, dim)).astype(dtype)
    r = rng.uniform(0.05, 0.5, n).astype(dtype)
    org = rng.uniform(-3, 3, (n, dim)).astype(dtype)
    d = (c + rng.uniform(-0.4, 0.4, (n, dim)) - org).astype(dtype)
    tmin = np.where(np.arange(n) % 5 == 0, 2.0, 0.0).astype(dtype)
    tmax = np.full(n, np.finfo(dtype).max, dtype)
    jt0, jt1, jhit = jax.jit(lambda *a: JSphere(a[0], a[1]).intersect(
        JRay(a[2], a[3], a[4], a[5])))(*map(jnp.asarray,
                                            (c, r, org, d, tmin, tmax)))
    t = [torch.from_numpy(x) for x in (c, r, org, d, tmin, tmax)]
    t0, t1, hit = Sphere(t[0], t[1]).intersect(Ray(*t[2:]))
    jhit = np.asarray(jhit)
    assert np.array_equal(hit.numpy(), jhit) and 0 < jhit.sum() < n
    rtol = RTOL if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(t0.numpy()[jhit], np.asarray(jt0)[jhit],
                               rtol=rtol)
    np.testing.assert_allclose(t1.numpy()[jhit], np.asarray(jt1)[jhit],
                               rtol=rtol)
    bmn, bmx = Sphere(t[0], t[1]).get_bbox()
    jmn, jmx = JSphere(jnp.asarray(c), jnp.asarray(r)).get_bbox()
    assert np.array_equal(bmn.numpy(), np.asarray(jmn))
    assert np.array_equal(bmx.numpy(), np.asarray(jmx))


@pytest.mark.parametrize("name, any_hit", [("d2", False), ("d3", False),
                                           ("d4", False), ("d3", True)])
def test_sphere_wavefront_matches_bvh_tpu(scenes, name, any_hit):
    s = scenes[name]
    want = j_traverse(s["jbvh"], s["jrays"], j_leaf_fn(
        s["jbvh"], jnp.asarray(s["centers"]), jnp.asarray(s["radii"])),
        any_hit=any_hit)
    got = traverse(s["tbvh"], s["trays"], make_sphere_leaf_fn(
        s["tbvh"], torch.from_numpy(s["centers"]),
        torch.from_numpy(s["radii"])), any_hit=any_hit)
    _compare(want, got, exact=False)
    assert int(got.hit.sum()) > 0


def test_sphere_wavefront_float64():
    """A float64 3D tree takes the wavefront (B6 is float32 only)."""
    centers, radii = (x.astype(np.float64) for x in _spheres(64, 3, 3))
    jb = j_build_binned(jnp.asarray(centers - radii[:, None]),
                        jnp.asarray(centers + radii[:, None]),
                        jnp.asarray(centers))
    tb = bvh_from_numpy(jb.bounds, jb.index, jb.prim_ids, jb.node_count,
                        jb.prim_count, "cpu")
    org = np.stack([centers[:, 0], centers[:, 1], np.full(64, -10.0)], 1)
    d = np.tile([[0.0, 0.0, 1.0]], (64, 1))
    want = j_traverse(jb, JRay.make(jnp.asarray(org), jnp.asarray(d)),
                      j_leaf_fn(jb, jnp.asarray(centers), jnp.asarray(radii)),
                      robust=True)
    got = traverse(tb, Ray.make(torch.from_numpy(org), torch.from_numpy(d)),
                   make_sphere_leaf_fn(tb, torch.from_numpy(centers),
                                       torch.from_numpy(radii)), robust=True)
    assert got.t.dtype == torch.float64 and bool(got.hit.all())
    assert np.array_equal(np.asarray(want.prim_id).astype(np.int64),
                          got.prim_id.numpy())
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-12)
    with pytest.raises(ValueError, match="float32"):
        sk.pallas_intersect_spheres(tb, torch.from_numpy(centers),
                                    torch.from_numpy(radii),
                                    Ray.make(torch.from_numpy(org),
                                             torch.from_numpy(d)))


@pytest.mark.parametrize("any_hit, robust", MODES)
@pytest.mark.parametrize("name", ["d2", "d3", "d4"])
def test_b6_plain_matches_pallas(scenes, reference, name, any_hit, robust,
                                 xla_rounding):
    got = _b6(scenes[name], any_hit=any_hit, robust=robust)
    _compare(reference(name, any_hit, robust), got, exact=True)


def test_b6_plain_matches_pallas_robust_case(scenes, reference,
                                             xla_rounding):
    """tests/test_dims_dtypes.py:158-173."""
    got = _b6(scenes["robust3"], robust=True)
    _compare(reference("robust3", False, True), got, exact=True)
    assert int(got.hit.sum()) > 0


@pytest.mark.parametrize("name", ["d2", "d3", "d4", "robust3"])
def test_b6_plain_without_fma_rounding(scenes, reference, name):
    robust = name == "robust3"
    got = _b6(scenes[name], robust=robust)
    _compare(reference(name, False, robust), got, exact=False,
             fields=("t", "v"), rtol=RTOL_OWN)


@pytest.mark.parametrize("name", ["d2", "d3", "d4"])
def test_b6_sort_rays_on_and_off(scenes, name):
    s = scenes[name]
    a = _b6(s, sort_rays=True)
    b = _b6(s, sort_rays=False)
    for f in ("t", "u", "v", "prim_pos", "prim_id"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.stats.visited_nodes, b.stats.visited_nodes)
    order = sk.coherence_order(s["trays"].org, s["trays"].dir)
    assert torch.equal(torch.sort(order).values,
                       torch.arange(order.numel()))
    assert not torch.equal(order, torch.arange(order.numel()))


@pytest.mark.parametrize("name", ["d2", "d3", "d4"])
def test_b6_packed_rows(scenes, name):
    """B6's rows: a pair row is `pair_tables`' left and right boxes, then
    the two index words' int32 bits, then zeros to (dim + 1) x 16 bytes;
    a sphere row the centre and radius by prim position, then zeros to
    16 (2D, 3D) or 32 (4D) bytes."""
    s = scenes[name]
    dim = s["tbvh"].dim
    c, r = torch.from_numpy(s["centers"]), torch.from_numpy(s["radii"])
    tables = sk.make_tables(s["tbvh"], c, r)
    node_b, node_w, root = sk.pair_tables(s["tbvh"])
    bits = tables.pairs.view(torch.int32)
    assert tables.pairs.shape == (node_b.shape[0], 4 * dim + 4)
    assert tables.pairs.is_contiguous() and tables.root_word == root
    assert torch.equal(bits[:, :4 * dim], node_b.view(torch.int32))
    assert torch.equal(bits[:, 4 * dim:4 * dim + 2], node_w)
    assert not bits[:, 4 * dim + 2:].any()
    width = sk.SPHERE_WIDTH[dim]
    assert tables.spheres.shape == (s["tbvh"].prim_ids.shape[0], width)
    assert width * 4 % 16 == 0 and width >= dim + 1
    pos = s["tbvh"].prim_ids
    assert torch.equal(tables.spheres[:, :dim], c[pos])
    assert torch.equal(tables.spheres[:, dim], r[pos])
    assert not tables.spheres[:, dim + 1:].any()
    # by position as given: the same rows
    perm = sk.make_tables(s["tbvh"], c[pos], r[pos], permuted=True)
    assert torch.equal(perm.spheres, tables.spheres)


def test_b6_tables_fits_and_overflow(scenes):
    s = scenes["d4"]
    c, r = torch.from_numpy(s["centers"]), torch.from_numpy(s["radii"])
    tables = sk.make_tables(s["tbvh"], c, r)
    assert tables.pairs.shape[1] == 20 and tables.spheres.shape[1] == 8
    assert tables.pairs.dtype == torch.float32 and tables.dim == 4
    pos = s["tbvh"].prim_ids
    assert torch.equal(tables.spheres[:, :4], c[pos])
    assert sk.pallas_fits_spheres(s["tbvh"], c) == bool(
        j_fits(s["jbvh"], jnp.asarray(s["centers"])))
    assert not sk.pallas_fits_spheres(s["tbvh"]._replace(
        index=torch.zeros(4096, dtype=torch.int64)), c)
    # a stack of one entry overflows on this tree: the plain version
    # drops the bottom entry and flags the ray, and the wrapper raises
    packed = sk.pack_rays(s["trays"])
    _, out_i = sk.sphere_traverse_ref(tables, packed, any_hit=False,
                                      robust=False, stack_depth=1)
    assert out_i[3].any()
    with pytest.raises(ValueError, match="overflow"):
        _b6(s, stack_depth=1)
