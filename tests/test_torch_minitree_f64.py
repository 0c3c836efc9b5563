"""The port's `build_minitree` against bvh_tpu's on float64 3D random
boxes of 1,100 prims, with and without pruning: node, index and prim
arrays equal bit for bit with XLA's FMA rounding in float64 (`fma_any`,
see tests/test_torch_flat.py). bvh_tpu carries the index words as
uint64, the port as int64 with the same values; see
tests/test_torch_minitree_dims.py for the other dims.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.build.minitree import MiniTreeConfig as JConfig
from bvh_tpu.build.minitree import build_minitree as j_build
from bvh_tpu_torch.build.minitree import MiniTreeConfig, build_minitree
from helpers import check_bvh_invariants
from test_torch_default import same_nodes
from test_torch_minitree_dims import boxes, fma_rounding  # noqa: F401

ARRAYS = boxes(3, np.float64, 1100, 9)


@pytest.fixture(scope="module")
def jbvh():
    return j_build(*(jnp.asarray(a) for a in ARRAYS), JConfig())


def test_build_minitree_f64_matches_bvh_tpu(jbvh, fma_rounding):
    tbvh = build_minitree(*(torch.from_numpy(a) for a in ARRAYS))
    assert np.asarray(jbvh.index).dtype == np.uint64
    assert tbvh.bounds.dtype == torch.float64
    assert same_nodes(jbvh, tbvh)
    check_bvh_invariants(tbvh, 1100)


def test_build_minitree_f64_without_fma_rounding(jbvh):
    tbvh = build_minitree(*(torch.from_numpy(a) for a in ARRAYS),
                          MiniTreeConfig(enable_pruning=False))
    check_bvh_invariants(tbvh, 1100)
    assert tbvh.index.dtype == torch.int64
