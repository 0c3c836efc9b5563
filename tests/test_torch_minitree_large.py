"""The port's `build_minitree` against bvh_tpu's on the CPU, on the
larger 3D cases of tests/test_build_minitree.py without pruning: random
scenes of 500 and 3,000 prims. Arrays equal bit for bit with XLA's FMA
rounding (`xla_rounding`); see tests/test_torch_minitree.py.
"""

import jax.numpy as jnp
import pytest

from bvh_tpu.build.minitree import MiniTreeConfig as JConfig
from bvh_tpu.build.minitree import build_minitree as j_build
from helpers import check_bvh_invariants
from test_torch_build import xla_rounding  # noqa: F401 - fixture
from test_torch_default import same_nodes
from test_torch_minitree import _port, random_scene

CASES = {
    "n500": (500, 500, dict(enable_pruning=False)),
    "n3000": (3000, 3000, dict(enable_pruning=False)),
}


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, (n, seed, kw) in CASES.items():
        arrays = random_scene(n, seed)
        out[name] = (arrays, kw, j_build(*(jnp.asarray(a) for a in arrays),
                                         JConfig(**kw)))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_build_minitree_matches_bvh_tpu(trees, name, xla_rounding):
    arrays, kw, jbvh = trees[name]
    tbvh = _port(arrays, kw)
    assert same_nodes(jbvh, tbvh)
    check_bvh_invariants(tbvh, len(arrays[0]))


def test_build_minitree_without_fma_rounding(trees):
    """The port's own rounding: a valid tree of every prim."""
    for arrays, kw, _ in trees.values():
        check_bvh_invariants(_port(arrays, kw), len(arrays[0]))
