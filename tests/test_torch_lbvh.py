"""The port's `build_lbvh` against bvh_tpu's on the CPU, on the cases of
tests/test_lbvh.py (random triangles of 2, 3, 7 and 1,000 prims, one
prim, 64 equal centres, the closest-hit parity with the binned tree)
and on 2D, 4D and float64 boxes. Node, index and prim arrays equal bit
for bit: in float32 3D with the port's own rounding (the grid transform
`centers*scale + (-cmin*scale)` rounds the same with and without XLA's
FMA on these cases), elsewhere with XLA's FMA rounding (`fma_any`, see
tests/test_torch_flat.py), which the transform goes through.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.build.lbvh import build_lbvh as j_build
from bvh_tpu_torch.build.binned import build_binned
from bvh_tpu_torch.build.lbvh import LbvhConfig, build_lbvh, clz32
from bvh_tpu_torch.cli.camera import primary_rays
from bvh_tpu_torch.core import utils
from bvh_tpu_torch.traverse.wavefront import intersect_tris
from test_torch_default import same_nodes
from test_torch_flat import fma_any
from test_torch_minitree_dims import boxes

from helpers import check_bvh_invariants, scene_arrays


def random_tris(n, seed=0, spread=0.1):
    """tests/test_lbvh.py's random triangles."""
    rng = np.random.default_rng(seed)
    base = rng.random((n, 1, 3)).astype(np.float32)
    edge = (rng.random((n, 2, 3)).astype(np.float32) - 0.5) * spread
    return np.concatenate([base, base + edge], axis=1)


def _dup(n):
    tris = random_tris(n)
    tris[:] = tris[:1]
    return tris


TRI_CASES = {"n2": random_tris(2), "n3": random_tris(3), "n7": random_tris(7),
             "n1000": random_tris(1000), "dup64": _dup(64),
             "parity600": random_tris(600, seed=3, spread=0.6)}
BOX_CASES = {"2d": (2, np.float32, 700, 2), "4d": (4, np.float32, 700, 4),
             "f64": (3, np.float64, 700, 9)}


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, tris in TRI_CASES.items():
        arrays = tuple(np.asarray(x) for x in scene_arrays(tris))
        out[name] = (arrays, j_build(*(jnp.asarray(a) for a in arrays[:3])))
    for name, case in BOX_CASES.items():
        arrays = boxes(*case)
        out[name] = (arrays, j_build(*(jnp.asarray(a) for a in arrays)))
    return out


def _port(arrays):
    return build_lbvh(*(torch.from_numpy(np.array(a)) for a in arrays[:3]))


@pytest.mark.parametrize("name", list(TRI_CASES))
def test_lbvh_matches_bvh_tpu(trees, name):
    arrays, jbvh = trees[name]
    tbvh = _port(arrays)
    n = len(arrays[0])
    assert tbvh.node_count == 2 * n - 1
    assert same_nodes(jbvh, tbvh)
    check_bvh_invariants(tbvh, n)


@pytest.mark.parametrize("name", list(BOX_CASES))
def test_lbvh_dims_dtypes_match_bvh_tpu(trees, name, monkeypatch):
    monkeypatch.setattr(utils, "fast_mul_add", fma_any)
    arrays, jbvh = trees[name]
    tbvh = _port(arrays)
    assert tbvh.bounds.dtype == torch.from_numpy(arrays[0]).dtype
    assert same_nodes(jbvh, tbvh)
    check_bvh_invariants(tbvh, len(arrays[0]))


def test_lbvh_single_prim():
    mn = torch.zeros((1, 3))
    mx = torch.ones((1, 3))
    bvh = build_lbvh(mn, mx, (mn + mx) / 2)
    assert bvh.node_count == 1 and int(bvh.index[0]) == 1
    check_bvh_invariants(bvh, 1)


def test_lbvh_closest_hit_parity(trees):
    """tests/test_lbvh.py:51-71 through the port: the lbvh and the binned
    tree of one scene give the same closest hits."""
    arrays, _ = trees["parity600"]
    mn, mx, c, flat = (torch.from_numpy(np.array(a)) for a in arrays)
    rays = primary_rays([0.5, 0.5, -1.5], [0, 0, 1], [0, 1, 0], 32, 32,
                        device="cpu")
    h1 = intersect_tris(build_lbvh(mn, mx, c), flat, rays)
    h2 = intersect_tris(build_binned(mn, mx, c), flat, rays)
    assert int(h1.hit.sum()) > 50
    assert torch.equal(h1.hit, h2.hit)
    np.testing.assert_allclose(h1.t[h1.hit].numpy(), h2.t[h2.hit].numpy(),
                               rtol=1e-6)


def test_clz32_and_grid_config():
    x = torch.tensor([0, 1, 2, 3, 255, 2 ** 16 - 1, 2 ** 16, 2 ** 31 - 1,
                      2 ** 31, 2 ** 32 - 1])
    assert clz32(x).tolist() == [32 - int(v).bit_length() for v in x]
    mn, mx, c = boxes(3, np.float32, 300, 1)
    a = build_lbvh(*(torch.from_numpy(x) for x in (mn, mx, c)),
                   LbvhConfig(log2_grid_dim=4))
    check_bvh_invariants(a, 300)
