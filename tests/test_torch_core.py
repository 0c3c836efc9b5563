"""The port's core and geom modules against bvh_tpu's, bit for bit.

Inputs are made from a seed with numpy, include NaN, ±0, ±inf and
values at or below float32 eps, and go through both packages as
explicit float32 arrays (the test suite runs JAX with x64 on).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.core import bbox as jbbox
from bvh_tpu.core import utils as jutils
from bvh_tpu.core.ray import Ray as JRay
from bvh_tpu.core.types import Bvh as JBvh
from bvh_tpu.core.types import Index as JIndex
from bvh_tpu.core.types import make_node_bounds_row as j_bounds_row
from bvh_tpu.geom.tri import PrecomputedTri as JPre
from bvh_tpu.geom.tri import Tri as JTri
from bvh_tpu_torch.core import bbox as tbbox
from bvh_tpu_torch.core import utils as tutils
from bvh_tpu_torch.core.ray import Ray as TRay
from bvh_tpu_torch.core.types import Bvh as TBvh
from bvh_tpu_torch.core.types import Index as TIndex
from bvh_tpu_torch.core.types import make_node_bounds_row as t_bounds_row
from bvh_tpu_torch.geom.tri import PrecomputedTri as TPre
from bvh_tpu_torch.geom.tri import Tri as TTri

EPS = np.finfo(np.float32).eps
SPECIALS = np.asarray(
    [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, EPS, -EPS, EPS / 2,
     -EPS / 4, 1e-30, -1e-38, np.finfo(np.float32).max,
     -np.finfo(np.float32).max, 1.0, -1.0], np.float32)


def _values(n=4096, seed=0):
    """Seeded float32 values with the specials mixed in."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, n))
    x = x.astype(np.float32)
    x[: len(SPECIALS)] = SPECIALS
    return rng.permutation(x)


def _no_subnormal_reciprocal(x):
    """Replace values whose reciprocal involves a float32 subnormal
    (|x| < 2^-126 or |x| > 2^126) by 1.0. XLA's CPU backend flushes
    subnormals to zero, as the TPU does; the port keeps IEEE
    subnormals (ROADMAP C7), so 1/x differs exactly there."""
    x = x.copy()
    ax = np.abs(x)
    tiny = np.finfo(np.float32).tiny
    x[(ax != 0) & ((ax < tiny) | (ax > 1.0 / tiny)) & np.isfinite(x)] = 1.0
    return x


def _bits_equal(a, b):
    """Bitwise equality, with any NaN matching any NaN."""
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    if a.dtype.kind == "f":
        na, nb = np.isnan(a), np.isnan(b)
        assert np.array_equal(na, nb), "NaN positions differ"
        ia = a.view(np.int32 if a.dtype == np.float32 else np.int64)
        ib = b.view(ia.dtype)
        bad = (ia != ib) & ~na
        assert not bad.any(), (
            f"{int(bad.sum())} values differ, e.g. {a[bad][:4]} vs {b[bad][:4]}")
    else:
        assert np.array_equal(a, b)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", ["robust_min", "robust_max"])
def test_robust_min_max(name):
    a, b = _values(seed=1), _values(seed=2)
    _bits_equal(getattr(tutils, name)(_t(a), _t(b)).numpy(),
                getattr(jutils, name)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("ulps", [1, 2])
def test_add_ulp_magnitude(ulps):
    x = _values(seed=3)
    _bits_equal(tutils.add_ulp_magnitude(_t(x), ulps).numpy(),
                jutils.add_ulp_magnitude(jnp.asarray(x), ulps))


@pytest.mark.parametrize("name", ["safe_inverse", "signbit"])
def test_inverse_and_sign(name):
    x = _values(seed=4)
    if name == "safe_inverse":
        x = _no_subnormal_reciprocal(x)
    _bits_equal(getattr(tutils, name)(_t(x)).numpy(),
                getattr(jutils, name)(jnp.asarray(x)))


def test_index_codec():
    rng = np.random.default_rng(5)
    first = rng.integers(0, 1 << 27, 1000)
    cnt = rng.integers(0, 16, 1000)
    jw = np.asarray(JIndex.make_leaf(first, cnt)).astype(np.int64)
    tw = TIndex.make_leaf(_t(first), _t(cnt))
    assert np.array_equal(tw.numpy(), jw)
    for fn in ("first_id", "prim_count", "is_leaf", "is_inner"):
        got = getattr(TIndex, fn)(tw).numpy()
        want = np.asarray(getattr(JIndex, fn)(jnp.asarray(jw, jnp.uint32)))
        assert np.array_equal(got, want.astype(got.dtype)), fn
    jin = np.asarray(JIndex.make_inner(first)).astype(np.int64)
    assert np.array_equal(TIndex.make_inner(_t(first)).numpy(), jin)
    jset = np.asarray(JIndex.set_first_id(jnp.asarray(jw, jnp.uint32),
                                          first[::-1].copy()))
    assert np.array_equal(TIndex.set_first_id(tw, _t(first[::-1])).numpy(),
                          jset.astype(np.int64))


def test_sibling_helpers_and_bounds_row():
    ids = np.arange(1, 200)
    for fn in ("get_sibling_id", "get_left_sibling_id",
               "get_right_sibling_id"):
        assert np.array_equal(getattr(TBvh, fn)(_t(ids)).numpy(),
                              np.asarray(getattr(JBvh, fn)(ids))), fn
    rng = np.random.default_rng(6)
    mn = rng.standard_normal((50, 3)).astype(np.float32)
    mx = mn + 1
    _bits_equal(t_bounds_row(_t(mn), _t(mx)).numpy(),
                j_bounds_row(jnp.asarray(mn), jnp.asarray(mx)))


def _points(seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((3, 2000, 3)).astype(np.float32) * 5
    p.reshape(-1)[:len(SPECIALS)] = SPECIALS
    return p


@pytest.mark.parametrize("op", ["from_points", "extend", "extend_point",
                                "center_half_area", "make_empty",
                                "reduce_union"])
def test_bbox(op):
    a, b, c = _points(7)
    ja, jb, jc = map(jnp.asarray, (a, b, c))
    ta, tb, tc = map(_t, (a, b, c))
    if op == "from_points":
        got, want = tbbox.from_points(ta, tb, tc), jbbox.from_points(ja, jb, jc)
    elif op == "extend":
        got, want = tbbox.extend(ta, tb, tc, ta), jbbox.extend(ja, jb, jc, ja)
    elif op == "extend_point":
        got, want = tbbox.extend_point(ta, tb, tc), jbbox.extend_point(ja, jb, jc)
    elif op == "center_half_area":
        got = (tbbox.get_center(ta, tb), tbbox.get_half_area(ta, tb),
               tbbox.get_diagonal(ta, tb))
        want = (jbbox.get_center(ja, jb), jbbox.get_half_area(ja, jb),
                jbbox.get_diagonal(ja, jb))
    elif op == "make_empty":
        got = tbbox.make_empty(3, batch_shape=(4,))
        want = jbbox.make_empty(3, jnp.float32, (4,))
    else:
        a, b = np.nan_to_num(a), np.nan_to_num(b)
        mask = np.random.default_rng(8).random(a.shape[0]) < 0.5
        got = tbbox.reduce_union(_t(a), _t(b), where=_t(mask))
        want = jbbox.reduce_union(jnp.asarray(a), jnp.asarray(b),
                                  where=jnp.asarray(mask))
    for g, w in zip(got, want):
        _bits_equal(g.numpy(), w)


def test_ray():
    rng = np.random.default_rng(9)
    org = rng.standard_normal((500, 3)).astype(np.float32)
    d = _no_subnormal_reciprocal(_values(1500, seed=10)).reshape(500, 3)
    jr = JRay.make(jnp.asarray(org), jnp.asarray(d))
    tr = TRay.make(_t(org), _t(d))
    for f in ("org", "dir", "tmin", "tmax"):
        _bits_equal(getattr(tr, f).numpy(), getattr(jr, f))
    for safe in (False, True):
        _bits_equal(tr.get_inv_dir(safe).numpy(), jr.get_inv_dir(safe))
    _bits_equal(tr.get_octant().numpy(), jr.get_octant())
    inv = jr.get_inv_dir()
    _bits_equal(TRay.pad_inv_dir(_t(np.asarray(inv))).numpy(),
                JRay.pad_inv_dir(inv))
    tr2 = TRay.make(_t(org), _t(d), tmin=1e-4, tmax=torch.ones(500))
    jr2 = JRay.make(jnp.asarray(org), jnp.asarray(d), tmin=1e-4,
                    tmax=jnp.ones(500, jnp.float32))
    _bits_equal(tr2.tmin.numpy(), jr2.tmin)
    _bits_equal(tr2.tmax.numpy(), jr2.tmax)


def test_tri_precompute_and_intersect():
    rng = np.random.default_rng(11)
    p = rng.standard_normal((3, 3000, 3)).astype(np.float32)
    jt = JTri(*map(jnp.asarray, p))
    tt = TTri(*map(_t, p))
    for g, w in zip(tt.get_bbox(), jt.get_bbox()):
        _bits_equal(g.numpy(), w)
    _bits_equal(tt.get_center().numpy(), jt.get_center())
    jp, tp = JPre.from_tri(jt), TPre.from_tri(tt)
    _bits_equal(tp.as_flat().numpy(), jp.as_flat())
    for g, w in zip(TPre.from_flat(tp.as_flat()), JPre.from_flat(jp.as_flat())):
        _bits_equal(g.numpy(), w)
    for g, w in zip(tp.convert_to_tri(), jp.convert_to_tri()):
        _bits_equal(g.numpy(), w)
    org = (rng.standard_normal((3000, 3)) * 0.2).astype(np.float32)
    d = rng.standard_normal((3000, 3)).astype(np.float32)
    jhit = jp.intersect(JRay.make(jnp.asarray(org), jnp.asarray(d)))
    thit = tp.intersect(TRay.make(_t(org), _t(d)))
    for g, w in zip(thit, jhit):
        _bits_equal(g.numpy(), w)
    assert thit[3].any() and not thit[3].all()
