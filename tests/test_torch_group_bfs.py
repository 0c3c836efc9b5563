"""Kernel B3's "bfs" variant (`group_forest_build(..., variant="bfs")`)
against bvh_tpu's BFS kernel `_group_build_kernel`, run as its own tests
run it here (pl.pallas_call(interpret=True)), on the two scenes of
tests/test_torch_group_build.py with XLA's FMA rounding (`xla_rounding`):
all four outputs bit for bit, `nbi` row 3 (the BFS queue) included. The
variant's rows other than 3 equal the "ls" variant's, whose row 3 is
zero, and an unknown variant raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.build.group_kernel import group_forest_build as j_group_build
from bvh_tpu_torch.build import group_kernel as gk
from bvh_tpu_torch.build import minitree_fast as mtf
from bvh_tpu_torch.core import utils
from test_group_kernel import random_scene
from test_torch_build import xla_fma, xla_rounding  # noqa: F401 - fixture
from test_torch_group_build import SCENES, _same_outputs


@pytest.fixture(scope="module")
def staged():
    """Each scene's packed groups (staged with XLA's rounding, so that
    its groups are bvh_tpu's) and bvh_tpu's BFS kernel output on them."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(utils, "fast_mul_add", xla_fma)
        for name, args in SCENES.items():
            mn, mx, cc = (torch.from_numpy(a) for a in random_scene(*args))
            plan = mtf.staging_plan(cc)
            pf, _ = mtf.pack_groups(mn, mx, cc, plan)
            want = j_group_build(jnp.asarray(pf.numpy()),
                                 jnp.asarray(plan.counts.numpy()), dim=3,
                                 P=plan.P, interpret=True, variant="bfs")
            out[name] = (pf, plan, [np.asarray(x) for x in want])
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bfs_variant_matches_pallas_bfs(staged, name, xla_rounding):
    pf, plan, want = staged[name]
    got = gk.group_forest_build(pf, plan.counts, dim=3, P=plan.P,
                                variant="bfs")
    assert _same_outputs(got, want)
    queue = got[1][3]
    assert int((queue != 0).sum()) > 0
    ls = gk.group_forest_build(pf, plan.counts, dim=3, P=plan.P)
    assert int((ls[1][3] != 0).sum()) == 0
    rows = [r for r in range(8) if r != 3]
    assert torch.equal(got[1][rows], ls[1][rows])
    for g, w in zip((got[0], got[2], got[3]), (ls[0], ls[2], ls[3])):
        assert torch.equal(g, w)


def test_unknown_variant_raises(staged):
    pf, plan, _ = staged["n40"]
    with pytest.raises(ValueError, match="unknown variant 'dfs'"):
        gk.group_forest_build(pf, plan.counts, dim=3, P=plan.P,
                              variant="dfs")
