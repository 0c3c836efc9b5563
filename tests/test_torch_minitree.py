"""The port's level-synchronous `build_minitree` (and `init_forest`)
against bvh_tpu's on the CPU, on the 3D cases of
tests/test_build_minitree.py without pruning: the Cornell box and a
random scene of 50 prims. Node, index and prim arrays equal bit for bit
with XLA's FMA rounding (`xla_rounding`, see tests/test_torch_build.py).
bvh_tpu runs eagerly, as its own tests run it (a jit of the whole build
fuses, and so rounds, differently); each of its trees is built once,
some 20 s of compiling each, so the cases are spread over files of two
trees or fewer: 500 and 3,000 prims in tests/test_torch_minitree_large.py,
pruning in tests/test_torch_minitree_pruning.py, 2D and 4D in
tests/test_torch_minitree_dims.py, float64 in
tests/test_torch_minitree_f64.py, and the port's two mini-tree builds
against each other in tests/test_torch_minitree_vs_fast.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.build.frontier import init_forest as j_init_forest
from bvh_tpu.build.minitree import MiniTreeConfig as JConfig
from bvh_tpu.build.minitree import build_minitree as j_build
from bvh_tpu_torch.build import frontier
from bvh_tpu_torch.build.minitree import MiniTreeConfig, build_minitree
from helpers import check_bvh_invariants, scene_arrays
from test_torch_build import xla_rounding  # noqa: F401 - fixture
from test_torch_default import same_nodes


def random_scene(n, seed):
    """tests/test_build_minitree.py's random boxes, in numpy."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    ext = rng.uniform(0.005, 0.05, (n, 3)).astype(np.float32)
    return pts - ext, pts + ext, pts


# name -> (prims, seed, config keywords); seed None is the Cornell box
CASES = {
    "cornell": (36, None, dict(enable_pruning=False)),
    "n50": (50, 50, dict(enable_pruning=False)),
}


@pytest.fixture(scope="module")
def trees(cornell_tris):
    out = {}
    for name, (n, seed, kw) in CASES.items():
        if seed is None:
            arrays = tuple(np.asarray(x) for x in scene_arrays(cornell_tris)[:3])
        else:
            arrays = random_scene(n, seed)
        out[name] = (arrays, kw, j_build(*(jnp.asarray(a) for a in arrays),
                                         JConfig(**kw)))
    return out


def _port(arrays, kw):
    return build_minitree(*(torch.from_numpy(np.array(a)) for a in arrays),
                          MiniTreeConfig(**kw))


@pytest.mark.parametrize("name", list(CASES))
def test_build_minitree_matches_bvh_tpu(trees, name, xla_rounding):
    arrays, kw, jbvh = trees[name]
    tbvh = _port(arrays, kw)
    assert same_nodes(jbvh, tbvh)
    check_bvh_invariants(tbvh, len(arrays[0]))


def test_build_minitree_without_fma_rounding(trees):
    """The port's own rounding gives a valid tree of every prim; on the
    Cornell box, bvh_tpu's tree."""
    for name, (arrays, kw, jbvh) in trees.items():
        tbvh = _port(arrays, kw)
        check_bvh_invariants(tbvh, len(arrays[0]))
        if name == "cornell":
            assert same_nodes(jbvh, tbvh)


def test_init_forest_matches_bvh_tpu():
    """Roots over group ranges, empty groups among them: root boxes,
    leaf words, open flags and the root of every position."""
    mn, mx, _ = random_scene(40, 3)
    order = np.random.default_rng(4).permutation(40)
    begin = np.array([0, 5, 5, 6, 20, 40, 40], np.int32)
    end = np.array([5, 5, 6, 20, 40, 40, 40], np.int32)
    want = j_init_forest(jnp.asarray(mn), jnp.asarray(mx),
                         jnp.asarray(order, jnp.int32), jnp.asarray(begin),
                         jnp.asarray(end), 1, 87)
    got = frontier.init_forest(torch.from_numpy(mn), torch.from_numpy(mx),
                               torch.from_numpy(order), torch.from_numpy(begin),
                               torch.from_numpy(end), 1, 87)
    for f in ("order", "seg", "bounds", "index", "begin", "end", "open_"):
        a = np.asarray(getattr(want, f))
        b = getattr(got, f).numpy()
        assert np.array_equal(a.astype(b.dtype), b), f
    assert int(got.node_count) == int(want.node_count) == 7
