"""The port's `build_minitree` against bvh_tpu's on the pruning case of
tests/test_build_minitree.py: 2,000 prims with the small-bin merge at
threshold 256 and the aggressive pruning ratio 0.5, which cuts
mini-trees below their roots. Arrays equal bit for bit with XLA's FMA
rounding (`xla_rounding`); see tests/test_torch_minitree.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.build.minitree import MiniTreeConfig as JConfig
from bvh_tpu.build.minitree import build_minitree as j_build
from helpers import check_bvh_invariants
from test_torch_build import xla_rounding  # noqa: F401 - fixture
from test_torch_default import same_nodes
from test_torch_minitree import _port, random_scene

CASES = {
    "pruned2000": (2000, 21, dict(pruning_area_ratio=0.5,
                                  parallel_threshold=256)),
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


def test_pruning_cuts_subtrees(trees, xla_rounding):
    """tests/test_build_minitree.py:149-168: the aggressive ratio changes
    the topology against the unpruned build."""
    arrays, kw, _ = trees["pruned2000"]
    a = _port(arrays, kw)
    b = _port(arrays, dict(enable_pruning=False, parallel_threshold=256))
    ia, ib = a.index[:a.node_count], b.index[:b.node_count]
    assert ia.numel() != ib.numel() or not torch.equal(ia, ib)
    check_bvh_invariants(b, 2000)


def test_build_minitree_without_fma_rounding(trees):
    """The port's own rounding: a valid tree of every prim."""
    for arrays, kw, _ in trees.values():
        check_bvh_invariants(_port(arrays, kw), len(arrays[0]))
