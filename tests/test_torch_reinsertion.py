"""The port's reinsertion optimizer against bvh_tpu's on the CPU: the
greedy conflict fixpoint against the serial replay, and whole
optimizations bit for bit with XLA's FMA rounding of the half-areas
(`xla_rounding`, see tests/test_torch_build.py), on the scene of
tests/test_reinsertion.py:85-103 (bvh_tpu's binned tree, which the
search leaves unchanged) and on an LBVH tree of sponza_class(1000, 1),
where it moves many subtrees.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.build.binned import build_binned
from bvh_tpu.build.lbvh import build_lbvh
from bvh_tpu.build.reinsertion import optimize_reinsertion as j_optimize
from bvh_tpu.io.scenes import sponza_class
from bvh_tpu_torch.build import reinsertion as trein
from bvh_tpu_torch.build.sah import node_half_area
from helpers import check_bvh_invariants
from test_torch_build import same_tree, to_port, xla_rounding  # noqa: F401


def test_greedy_accept_matches_serial_replay():
    """The fixpoint equals the reference's serial greedy loop
    (reinsertion_optimizer.h:254-265) exactly (tests/test_reinsertion.py:
    59-82)."""
    rng = np.random.default_rng(3)
    for trial in range(20):
        B = int(rng.integers(5, 400))
        cap = int(rng.integers(8, 64))
        conflicts = rng.integers(0, cap, (5, B))
        ok = rng.random(B) > 0.2
        got = trein._greedy_accept(torch.from_numpy(conflicts),
                                   torch.from_numpy(ok), cap).numpy()
        touched = np.zeros(cap, bool)
        want = np.zeros(B, bool)
        for i in range(B):
            if ok[i] and not touched[conflicts[:, i]].any():
                want[i] = True
                touched[conflicts[:, i]] = True
        assert np.array_equal(got, want), (trial, B, cap)


def _scene(name):
    if name == "binned_700":
        rng = np.random.default_rng(5)
        pts = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
        ext = rng.uniform(0.005, 0.05, (700, 3)).astype(np.float32)
        return build_binned, (pts - ext, pts + ext, pts)
    tris = sponza_class(1000, 1)
    return build_lbvh, (tris.min(axis=1), tris.max(axis=1), tris.mean(axis=1))


SCENES = ["binned_700", "lbvh_sponza1000"]


@pytest.fixture(scope="module")
def trees():
    """bvh_tpu's input tree and its reinsertion, per scene."""
    out = {}
    for name in SCENES:
        build, arrays = _scene(name)
        jbvh = build(*(jnp.asarray(a) for a in arrays))
        out[name] = (jbvh, j_optimize(jbvh))
    return out


def _exact_refit(bvh):
    nc = int(bvh.node_count)
    index = bvh.index[:nc].numpy()
    bounds = bvh.bounds[:nc].numpy()
    ii = np.nonzero((index & 15) == 0)[0]
    l, r = index[ii] >> 4, (index[ii] >> 4) + 1
    merged = np.empty((len(ii), bounds.shape[1]), bounds.dtype)
    merged[:, 0::2] = np.minimum(bounds[l][:, 0::2], bounds[r][:, 0::2])
    merged[:, 1::2] = np.maximum(bounds[l][:, 1::2], bounds[r][:, 1::2])
    return np.array_equal(bounds[ii], merged)


def _total_area(bvh):
    return float(node_half_area(bvh.bounds[1:bvh.node_count]).double().sum())


def _leaves(bvh):
    idx = bvh.index[:bvh.node_count].numpy()
    return sorted(idx[(idx & 15) > 0].tolist())


@pytest.mark.parametrize("name", SCENES)
def test_optimize_reinsertion_matches(trees, name, xla_rounding):
    """Bit for bit; every inner box is then the exact merge of its
    children; the LBVH tree gets dozens of moves."""
    jbvh, jopt = trees[name]
    stats = {}
    topt = trein.optimize_reinsertion(to_port(jbvh), stats=stats)
    assert same_tree(jopt, topt)
    assert _exact_refit(topt)
    assert len(stats["steps"]) == 3 and min(stats["steps"]) > 0
    assert (sum(stats["accepted"]) > 20) == (name == "lbvh_sponza1000")


@pytest.mark.parametrize("name", SCENES)
def test_optimize_reinsertion_without_fma_rounding(trees, name):
    """With the port's own rounding: the leaf set is kept, the refit is
    exact, and the total half-area does not grow
    (tests/test_reinsertion.py)."""
    before = to_port(trees[name][0])
    topt = trein.optimize_reinsertion(before)
    check_bvh_invariants(topt, before.prim_count)
    assert _exact_refit(topt)
    assert _leaves(topt) == _leaves(before)
    assert _total_area(topt) <= _total_area(before) + 1e-4
