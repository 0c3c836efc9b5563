"""The port's native bindings (bvh_tpu_torch/api/native.py) on
tests/test_native.py's cases, against bvh_tpu.api.native on the same
library and inputs: the golden tree's load and prim ids, the closest
hits of the serial and the thread-pooled builds against the goldens,
and optimize, which keeps the node count and does not grow the
tree's half-area. The library is the port's build of
native/bvh_c.cpp; bvh_tpu's wrapper loads the same file with its own
signatures (its `Callback3f` is a ctypes type of its own).
"""

import os

import numpy as np
import pytest

from bvh_tpu.api import native as jnative
from bvh_tpu_torch.api.native import NativeBvh3f, library_path, load_library
from bvh_tpu_torch.build.sah import node_half_area
from bvh_tpu_torch.io.scenes import sponza_class
from bvh_tpu_torch.io.serialize import deserialize_from_bytes
from helpers import check_bvh_invariants


@pytest.fixture(scope="module")
def natives():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATHS", [library_path()])
        return NativeBvh3f(load_library()), jnative.NativeBvh3f()


def boxes(tris):
    return (tris.min(axis=1).astype(np.float32),
            tris.max(axis=1).astype(np.float32),
            tris.mean(axis=1).astype(np.float32))


def golden_rays():
    """tests/test_native.py's 64 sampled rays of the 64x64 test camera:
    (index in the grid, origin, direction)."""
    eye = np.asarray([0.0, 1.0, 2.0], np.float32)
    d = np.asarray([0.0, 0.0, -1.0], np.float32)
    right = np.cross(d, np.asarray([0.0, 1.0, 0.0], np.float32))
    right /= np.linalg.norm(right)
    up = np.cross(right, d)
    rng = np.random.default_rng(0)
    for idx in rng.choice(64 * 64, 64, replace=False):
        u = 2.0 * (idx % 64) / 64 - 1.0
        v = 2.0 * (idx // 64) / 64 - 1.0
        yield idx, eye, d + u * right + v * up


def test_native_load_of_reference_golden(natives, golden_dir, cornell_tris):
    port, ref = natives
    path = os.path.join(golden_dir, "cornell_sweep.bvh")
    h, hj = port.load(path), ref.load(path)
    assert port.node_count(h) == 37
    ids = port.prim_ids(h)
    assert sorted(ids.tolist()) == list(range(len(cornell_tris)))
    np.testing.assert_array_equal(ids, ref.prim_ids(hj))
    with pytest.raises(OSError, match="cannot open"):
        port.load(os.path.join(golden_dir, "missing.bvh"))
    port.destroy(h)
    ref.destroy(hj)


def test_native_intersect_matches_golden(natives, golden_dir, cornell_tris,
                                         golden_hits):
    """Serial traversal of the reference's own tree gives the oracle's
    hits, and bvh_tpu's wrapper's (prim, t) exactly."""
    port, ref = natives
    h = port.load(os.path.join(golden_dir, "cornell_sweep.bvh"))
    for idx, eye, ray_dir in golden_rays():
        prim, t = port.intersect_closest(h, eye, ray_dir, cornell_tris)
        assert (prim, t) == ref.intersect_closest(h, eye, ray_dir,
                                                  cornell_tris)
        want = golden_hits["prim_id"][idx]
        if want == 0xFFFFFFFF:
            assert prim == -1
        else:
            assert prim != -1
            np.testing.assert_allclose(t, golden_hits["t"][idx], rtol=1e-5)
    port.destroy(h)


def test_native_optimize_reduces_area(natives, cornell_tris):
    port, ref = natives
    h = port.build(*boxes(cornell_tris), quality=1)
    hj = ref.build(*boxes(cornell_tris), quality=1)
    before = deserialize_from_bytes(port.to_bytes(h), device="cpu")
    port.lib.bvh3f_optimize(None, h)
    ref.lib.bvh3f_optimize(None, hj)
    after = deserialize_from_bytes(port.to_bytes(h), device="cpu")
    assert after.node_count == before.node_count
    assert (float(node_half_area(after.bounds[1:after.node_count]).sum())
            <= float(node_half_area(before.bounds[1:before.node_count]).sum()))
    check_bvh_invariants(after, len(cornell_tris))
    assert np.array_equal(port.prim_ids(h), ref.prim_ids(hj))
    port.destroy(h)
    ref.destroy(hj)


def test_native_pool_minitree_build(natives):
    """A pool selects the parallel mini-tree pipeline
    (c_api/bvh_impl.h:105-114): deterministic across thread counts, a
    valid tree, and the serial build's closest hits on 32 rays."""
    port, ref = natives
    tris = sponza_class(4096, seed=3)
    h_par = port.build(*boxes(tris), quality=1, threads=2)
    h_par2 = port.build(*boxes(tris), quality=1, threads=3)
    h_ser = port.build(*boxes(tris), quality=1)
    assert port.node_count(h_par) == port.node_count(h_par2)
    assert np.array_equal(port.prim_ids(h_par), port.prim_ids(h_par2))
    check_bvh_invariants(deserialize_from_bytes(port.to_bytes(h_par),
                                                device="cpu"), len(tris))
    eye = tris.mean(axis=(0, 1)).astype(np.float32) + np.asarray(
        [0.0, 0.0, 3.0], np.float32)
    rng = np.random.default_rng(0)
    for _ in range(32):
        ray_dir = rng.standard_normal(3).astype(np.float32)
        p1, t1 = port.intersect_closest(h_par, eye, ray_dir, tris)
        p0, t0 = port.intersect_closest(h_ser, eye, ray_dir, tris)
        assert (p1, t1) == ref.intersect_closest(h_par, eye, ray_dir, tris)
        assert (p1 == -1) == (p0 == -1)
        if p0 != -1:
            np.testing.assert_allclose(t1, t0, rtol=1e-5)
    for h in (h_par, h_par2, h_ser):
        port.destroy(h)
