"""The port's flat API (`bvh2f`, `bvh3f`, `bvh2d`, `bvh3d`) against
bvh_tpu's, on the CPU: builds at every quality, save and load in the v2
byte format, the accessors, node surgery, refit and optimize, and the
four intersections. Trees are compared bit for bit with XLA's FMA
rounding (`xla_rounding`, see tests/test_torch_build.py); the
intersections run the wavefront (tests/test_torch_wavefront.py holds it
to bvh_tpu mode by mode).
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.api import flat as jflat
from bvh_tpu.build.default import Quality as JQuality
from bvh_tpu.traverse.wavefront import make_tri_leaf_fn as j_leaf_fn
from bvh_tpu.core.ray import Ray as JRay
from bvh_tpu_torch.api import flat as tflat
from bvh_tpu_torch.build.default import Quality
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.traverse.wavefront import make_tri_leaf_fn
from bvh_tpu_torch.core import utils
from test_torch_build import same_tree, xla_fma, xla_rounding  # noqa: F401
from test_torch_default import same_nodes

from helpers import scene_arrays


def fma_any(a, b, c):
    """a * b + c with one rounding in float32 (`xla_fma`) and float64:
    Dekker's exact product error and a two-sum, folded in last, which
    is the correctly rounded result except in rare double-rounding
    cases; non-finite values take the plain expression."""
    if a.dtype != torch.float64:
        return xla_fma(a, b, c)
    p = a * b

    def split(x):
        t = x * 134217729.0
        hi = t - (t - x)
        return hi, x - hi

    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    r = s + (((p - (s - bb)) + (c - bb)) + e)
    return torch.where(torch.isfinite(r), r, a * b + c)


def _boxes(n, dim, dtype, seed):
    """tests/test_dims_dtypes.py's random boxes, in numpy."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (n, dim)).astype(dtype)
    h = rng.uniform(0.01, 0.5, (n, dim)).astype(dtype)
    return c - h, c + h, c


@pytest.fixture(scope="module")
def cornell(cornell_tris):
    arrays = tuple(np.asarray(x) for x in scene_arrays(cornell_tris))
    return arrays


@pytest.mark.parametrize("quality", ["low", "medium", "high"])
def test_bvh3f_build_matches(cornell, quality, xla_rounding):
    mn, mx, c, _ = cornell
    j = jflat.bvh3f.build(jnp.asarray(mn), jnp.asarray(mx), jnp.asarray(c),
                          jflat.BuildConfig(quality=JQuality(quality)))
    t = tflat.bvh3f.build(mn, mx, c, tflat.BuildConfig(
        quality=Quality(quality)), device="cpu")
    assert same_tree(j, t)


@pytest.mark.parametrize("name, dim, dtype", [
    ("bvh2f", 2, np.float32), ("bvh2d", 2, np.float64),
    ("bvh3d", 3, np.float64)])
def test_other_namespaces_serial_build(name, dim, dtype, monkeypatch):
    """Below parallel_threshold every namespace builds through the
    binned and sweep builders, which take any dim and float type; above
    it through the parallel path, the level-synchronous build_minitree
    (at LOW, so without reinsertion). Every tree is bvh_tpu's; both
    dtypes get XLA's FMA rounding."""
    monkeypatch.setattr(utils, "fast_mul_add", fma_any)
    mn, mx, c = _boxes(300, dim, dtype, seed=dim)
    japi, tapi = getattr(jflat, name), getattr(tflat, name)
    for q in ("low", "high"):
        j = japi.build(jnp.asarray(mn), jnp.asarray(mx), jnp.asarray(c),
                       jflat.BuildConfig(quality=JQuality(q)))
        t = tapi.build(mn, mx, c, tflat.BuildConfig(quality=Quality(q)),
                       device="cpu")
        assert t.bounds.dtype == (torch.float64 if dtype == np.float64
                                  else torch.float32)
        assert same_tree(j, t), q
    big = _boxes(1100, dim, dtype, seed=1)
    low = dict(quality=Quality.LOW)
    j = japi.build(*(jnp.asarray(a) for a in big),
                   jflat.BuildConfig(quality=JQuality.LOW))
    t = tapi.build(*big, tflat.BuildConfig(**low), device="cpu")
    assert same_nodes(j, t) and t.node_count > 1100
    assert tapi.build(*big, tflat.BuildConfig(**low), parallel=False,
                      device="cpu").prim_count == 1100


def test_save_load_and_accessors(cornell, tmp_path):
    mn, mx, c, _ = cornell
    cfg = jflat.BuildConfig(quality=JQuality.MEDIUM)
    j = jflat.bvh3f.build(jnp.asarray(mn), jnp.asarray(mx), jnp.asarray(c),
                          cfg, parallel=False)
    t = tflat.bvh3f.build(mn, mx, c, tflat.BuildConfig(
        quality=Quality.MEDIUM), parallel=False, device="cpu")
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    jflat.bvh3f.save(j, jbuf)
    tflat.bvh3f.save(t, tbuf)
    tbuf.seek(0)
    again = tflat.bvh3f.load(tbuf, device="cpu")
    path = str(tmp_path / "a.bvh")
    tflat.bvh3f.save(again, path)
    with open(path, "rb") as f:
        assert f.read() == tbuf.getvalue()
    jloaded = jflat.bvh3f.load(io.BytesIO(tbuf.getvalue()))
    assert same_nodes(jloaded, tflat.bvh3f.load(path, device="cpu"))
    api_j, api_t = jflat.bvh3f, tflat.bvh3f
    assert api_t.get_node_count(again) == api_j.get_node_count(jloaded)
    assert api_t.get_prim_count(again) == api_j.get_prim_count(jloaded)
    for i in (0, 1, 5):
        assert api_t.get_prim_id(again, i) == api_j.get_prim_id(jloaded, i)
        (a_mn, a_mx), a_first, a_cnt = api_t.get_node(again, i)
        (b_mn, b_mx), b_first, b_cnt = api_j.get_node(jloaded, i)
        assert (a_first, a_cnt) == (b_first, b_cnt)
        assert np.array_equal(a_mn, b_mn) and np.array_equal(a_mx, b_mx)


def test_node_surgery_refit_optimize(cornell, xla_rounding):
    mn, mx, c, _ = cornell
    jb = jflat.bvh3f.build(jnp.asarray(mn), jnp.asarray(mx), jnp.asarray(c),
                           jflat.BuildConfig(quality=JQuality.LOW),
                           parallel=False)
    tb = tflat.bvh3f.build(mn, mx, c, tflat.BuildConfig(quality=Quality.LOW),
                           parallel=False, device="cpu")
    nc = tflat.bvh3f.get_node_count(tb)
    ja = jflat.bvh3f.append_node(jb, [0, 0, 0], [1, 1, 1], first_id=0,
                                 prim_count=1)
    ta = tflat.bvh3f.append_node(tb, [0, 0, 0], [1, 1, 1], first_id=0,
                                 prim_count=1)
    assert same_tree(ja, ta) and ta.node_count == nc + 1
    assert tflat.bvh3f.remove_last_node(ta).node_count == nc
    js = jflat.bvh3f.set_node_bbox(jb, 3, [-9, -9, -9], [9, 9, 9])
    ts = tflat.bvh3f.set_node_bbox(tb, 3, [-9, -9, -9], [9, 9, 9])
    assert same_tree(js, ts)
    assert same_tree(jflat.bvh3f.refit(js, jnp.asarray(mn), jnp.asarray(mx)),
                     tflat.bvh3f.refit(ts, mn, mx))
    assert same_tree(jflat.bvh3f.optimize(jb), tflat.bvh3f.optimize(tb))


def test_intersect_variants(cornell, xla_rounding):
    mn, mx, c, flat = cornell
    jb = jflat.bvh3f.build(jnp.asarray(mn), jnp.asarray(mx), jnp.asarray(c))
    tb = tflat.bvh3f.build(mn, mx, c, device="cpu")
    jl = j_leaf_fn(jb, jnp.asarray(flat))
    tl = make_tri_leaf_fn(tb, torch.from_numpy(np.array(flat)))
    rng = np.random.default_rng(7)
    org = np.tile(np.float32([0.0, 1.0, 2.0]), (256, 1))
    d = (np.float32([0, 0, -1]) + rng.uniform(-0.6, 0.6, (256, 3))).astype(
        np.float32)
    jr = JRay.make(jnp.asarray(org), jnp.asarray(d))
    tr = Ray.make(torch.from_numpy(org), torch.from_numpy(d))
    for name in ("intersect_ray", "intersect_ray_robust", "intersect_ray_any",
                 "intersect_ray_any_robust"):
        a = getattr(jflat.bvh3f, name)(jb, jr, jl)
        b = getattr(tflat.bvh3f, name)(tb, tr, tl)
        assert np.array_equal(np.asarray(a.prim_id).astype(np.int64),
                              b.prim_id.numpy()), name
        assert np.asarray(a.t).tobytes() == b.t.numpy().tobytes(), name
        assert int(b.hit.sum()) > 100, name
