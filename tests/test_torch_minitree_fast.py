"""The port's fast mini-tree build (staging, kernel B3's plain version,
pruning, sweep top tree, splice) against bvh_tpu's
`build_minitree_fast(interpret=True)` on the scenes of
tests/test_group_kernel.py:18-31, arrays bit for bit with XLA's FMA
rounding (`xla_rounding`, see tests/test_torch_build.py).
"""

import pytest
import torch

from bvh_tpu.build.minitree_fast import build_minitree_fast as j_build
from bvh_tpu_torch.build import minitree_fast as mtf
from helpers import check_bvh_invariants
from test_group_kernel import random_scene
from test_torch_build import same_tree, xla_rounding  # noqa: F401 - fixture

SCENES = {"n40": (40, 7, False), "n200_clustered": (200, 0, True)}


def _port_build(name):
    return mtf.build_minitree_fast(
        *(torch.from_numpy(a) for a in random_scene(*SCENES[name])))


@pytest.fixture(scope="module")
def jax_trees():
    """bvh_tpu's fast mini-tree build of each scene (interpret mode)."""
    return {k: j_build(*random_scene(*v), interpret=True)
            for k, v in SCENES.items()}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_minitree_fast_matches(jax_trees, name, xla_rounding):
    assert same_tree(jax_trees[name], _port_build(name))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_minitree_fast_without_fma_rounding(jax_trees, name):
    """The port's own rounding: bvh_tpu's tree on the 40-prim scene (its
    half-areas differ by 1 ulp, which moves no decision); on the
    clustered scene the groups' trees differ
    (tests/test_torch_group_build.py) and the build is a valid tree over
    every prim, with fewer nodes."""
    tree = _port_build(name)
    check_bvh_invariants(tree, SCENES[name][0])
    assert same_tree(jax_trees[name], tree) == (name == "n40")


def test_staging_plan():
    """The launch's shape: groups in Morton order with their sizes, P the
    largest group rounded up to 128 lanes, NCAP = 2P."""
    mn, mx, cc = (torch.from_numpy(a) for a in random_scene(5000, 3))
    plan = mtf.staging_plan(cc)
    assert plan.G >= 2 and int(plan.counts.sum()) == 5000
    assert plan.P % 128 == 0 and plan.P - 128 < int(plan.counts.max()) <= plan.P
    assert plan.NCAP == 2 * plan.P and plan.g_cap == 4096
    assert torch.equal(torch.sort(plan.order).values, torch.arange(5000))
    pf, base = mtf.pack_groups(mn, mx, cc, plan)
    g0 = plan.order[:int(plan.counts[0])]
    assert torch.equal(pf[0:3, :g0.numel()], cc[g0].T)
    assert torch.equal(pf[6:9, :g0.numel()], mx[g0].T)
    assert int(base[1]) == int(plan.counts[0])
