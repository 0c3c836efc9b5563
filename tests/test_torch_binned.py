"""The port's binned SAH builder against bvh_tpu's, on the cases of
tests/test_build_binned.py: two triangles, the Cornell box (with
max_leaf_size 8 and 4), a single primitive, 40 primitives at one point
(the median fallback) and random boxes of 2 to 257 primitives.

With XLA's FMA rounding of the binning, the cost sums and the split
plane (`xla_rounding`, see tests/test_torch_build.py) the node, index
and prim arrays are equal bit for bit. Without it the random scenes of
33 or more primitives may take another split on a near-tie cost (ROADMAP
C5); the tree stays valid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.build.binned import build_binned as j_build_binned
from bvh_tpu.build.sah import TopDownConfig as JTopDownConfig
from bvh_tpu_torch.build.binned import build_binned
from bvh_tpu_torch.build.sah import TopDownConfig
from test_torch_build import _sweep_scene, same_tree, xla_rounding  # noqa: F401

from helpers import check_bvh_invariants, scene_arrays

TWO_TRIS = np.asarray([[[1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                       [[1, -1, 1], [-1, -1, 1], [-1, 1, 1]]], np.float32)
SCENES = ["two", "cornell", "single", "identical", "2", "3", "7", "33",
          "100", "257"]


def _scene(name, cornell_tris):
    if name == "two":
        return tuple(np.asarray(x) for x in scene_arrays(TWO_TRIS)[:3])
    if name == "single":
        return (np.zeros((1, 3), np.float32), np.ones((1, 3), np.float32),
                np.full((1, 3), 0.5, np.float32))
    if name in ("cornell", "identical"):
        return _sweep_scene(name, cornell_tris)
    n = int(name)
    rng = np.random.default_rng(n)  # tests/test_build_binned.py:50-53
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    ext = rng.uniform(0.01, 0.1, (n, 3)).astype(np.float32)
    return pts - ext, pts + ext, pts


CASES = [(name, 8) for name in SCENES] + [("cornell", 4), ("identical", 4)]


@pytest.fixture(scope="module")
def reference(cornell_tris):
    """bvh_tpu's binned tree of every case."""
    out = {}
    for name, max_leaf in CASES:
        arrays = _scene(name, cornell_tris)
        out[name, max_leaf] = (arrays, j_build_binned(
            *(jnp.asarray(a) for a in arrays),
            JTopDownConfig(max_leaf_size=max_leaf)))
    return out


def _port(arrays, max_leaf):
    return build_binned(*(torch.from_numpy(np.array(a)) for a in arrays),
                        TopDownConfig(max_leaf_size=max_leaf))


@pytest.mark.parametrize("name, max_leaf", CASES)
def test_binned_matches_bvh_tpu(reference, name, max_leaf, xla_rounding):
    arrays, jbvh = reference[name, max_leaf]
    tbvh = _port(arrays, max_leaf)
    assert same_tree(jbvh, tbvh)
    check_bvh_invariants(tbvh, len(arrays[0]))
    counts = (tbvh.index[:tbvh.node_count] & 15).numpy()
    assert counts.max() <= max_leaf


@pytest.mark.parametrize("name", ["cornell", "identical", "257"])
def test_binned_without_fma_rounding(reference, name):
    """With its own rounding the port builds a valid tree of the same
    size; on the Cornell box and the one-point scene, the same tree."""
    arrays, jbvh = reference[name, 8]
    tbvh = _port(arrays, 8)
    check_bvh_invariants(tbvh, len(arrays[0]))
    if name != "257":
        assert same_tree(jbvh, tbvh)
