"""The port's `build_minitree` against bvh_tpu's on the CPU in the
other dims: 2D and 4D float32 random boxes of more than
`parallel_threshold` (1,024) prims, the inputs that `build_default`'s
parallel path now sends there (float64 is in
tests/test_torch_minitree_f64.py). Node, index and prim arrays equal
bit for bit with XLA's FMA rounding (`fma_any`, see
tests/test_torch_flat.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.build.minitree import MiniTreeConfig as JConfig
from bvh_tpu.build.minitree import build_minitree as j_build
from bvh_tpu_torch.build.minitree import build_minitree
from bvh_tpu_torch.core import utils
from helpers import check_bvh_invariants
from test_torch_default import same_nodes
from test_torch_flat import fma_any

# name -> (dim, dtype, prims, seed)
CASES = {"2d": (2, np.float32, 1100, 2), "4d": (4, np.float32, 1100, 4)}


def boxes(dim, dtype, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, dim)).astype(dtype)
    ext = rng.uniform(0.005, 0.05, (n, dim)).astype(dtype)
    return pts - ext, pts + ext, pts


@pytest.fixture
def fma_rounding(monkeypatch):
    monkeypatch.setattr(utils, "fast_mul_add", fma_any)


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, case in CASES.items():
        arrays = boxes(*case)
        out[name] = (arrays, j_build(*(jnp.asarray(a) for a in arrays),
                                     JConfig()))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_build_minitree_dims_match_bvh_tpu(trees, name, fma_rounding):
    arrays, jbvh = trees[name]
    tbvh = build_minitree(*(torch.from_numpy(a) for a in arrays))
    assert same_nodes(jbvh, tbvh)
    assert tbvh.bounds.dtype == torch.from_numpy(arrays[0]).dtype
    assert tbvh.dim == CASES[name][0]
    check_bvh_invariants(tbvh, len(arrays[0]))


@pytest.mark.parametrize("name", list(CASES))
def test_build_minitree_dims_without_fma_rounding(trees, name):
    arrays, _ = trees[name]
    tbvh = build_minitree(*(torch.from_numpy(a) for a in arrays))
    check_bvh_invariants(tbvh, len(arrays[0]))
