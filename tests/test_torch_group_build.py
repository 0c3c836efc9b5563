"""Kernel B3's plain version and the Morton-grid groups against bvh_tpu
on the CPU, on the scenes of tests/test_group_kernel.py:18-31 and on
groups that reach every branch of the kernel (the cases the card tests
hold the CUDA kernel to, tests/test_torch_cuda.py).

bvh_tpu's kernel runs as its own tests run it here, through
pl.pallas_call(interpret=True). With XLA's FMA rounding
(`xla_rounding`, see tests/test_torch_build.py) the port is equal bit
for bit; with its own rounding, what holds is stated per test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.build.group_kernel import group_forest_build as j_group_build
from bvh_tpu.build.minitree import MiniTreeConfig as JMiniTreeConfig
from bvh_tpu.build.minitree import _grid_groups as j_grid_groups
from bvh_tpu_torch.build import group_kernel as gk
from bvh_tpu_torch.build import minitree_fast as mtf
from bvh_tpu_torch.build.minitree import MiniTreeConfig, _grid_groups
from bvh_tpu_torch.core import utils
from test_group_kernel import random_scene
from test_torch_build import xla_fma, xla_rounding  # noqa: F401 - fixture
from test_torch_cuda import GROUP_CASES, group_build_case

SCENES = {"n40": (40, 7, False), "n200_clustered": (200, 0, True)}


def _tensors(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _pallas(pf, sizes, P, **kw):
    out = j_group_build(jnp.asarray(pf), jnp.asarray(sizes), dim=3, P=P,
                        interpret=True, **kw)
    return [np.asarray(x) for x in out]


def _same_outputs(got, want) -> bool:
    """nbf bits, nbi, source lanes and node counts all equal."""
    return (got[0].numpy().tobytes() == want[0].tobytes()
            and all(np.array_equal(g.numpy(), w.astype(np.int32))
                    for g, w in zip(got[1:], want[1:])))


@pytest.fixture(scope="module")
def staged():
    """Each scene's packed groups (staged with XLA's rounding, so that
    its groups are bvh_tpu's) and bvh_tpu's kernel output on them."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(utils, "fast_mul_add", xla_fma)
        for name, args in SCENES.items():
            mn, mx, cc = _tensors(random_scene(*args))
            plan = mtf.staging_plan(cc)
            pf, _ = mtf.pack_groups(mn, mx, cc, plan)
            out[name] = (pf, plan, _pallas(pf.numpy(), plan.counts.numpy(),
                                           plan.P))
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_group_build_ref_matches_pallas(staged, name, xla_rounding):
    pf, plan, want = staged[name]
    got = gk.group_forest_build_ref(pf, plan.counts, dim=3, P=plan.P)
    assert _same_outputs(got, want)


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_group_build_ref_branches_match_pallas(case, xla_rounding):
    """Single prims, min_leaf roots, median fallbacks on coincident
    centres, flat boxes (infinite bin scale), full groups."""
    P, sizes, kw, build_kw = GROUP_CASES[case]
    pf, sz = group_build_case(sizes, P, seed=len(sizes), **kw)
    got = gk.group_forest_build_ref(torch.from_numpy(pf), torch.from_numpy(sz),
                                    dim=3, P=P, **build_kw)
    assert _same_outputs(got, _pallas(pf, sz, P, **build_kw))


def test_group_build_ref_without_fma_rounding(staged):
    """With its own rounding the plain version (and the CUDA kernel,
    which rounds alike) builds bvh_tpu's trees on the 40-prim scene:
    equal structure and bounds, half-areas (rows 6-7) within 1 ulp. On
    the clustered 200-prim scene a bin edge or a near-tie cost falls the
    other way and the trees differ (255 nodes against 263)."""
    pf, plan, want = staged["n40"]
    got = [x.numpy() for x in
           gk.group_forest_build_ref(pf, plan.counts, dim=3, P=plan.P)]
    assert got[0][:6].tobytes() == want[0][:6].tobytes()
    ulps = np.abs(got[0][6:].view(np.int32).astype(np.int64)
                  - want[0][6:].view(np.int32))
    assert 0 < ulps.max() <= 1
    assert all(np.array_equal(g, w) for g, w in zip(got[1:], want[1:]))
    pf, plan, want = staged["n200_clustered"]
    got = gk.group_forest_build_ref(pf, plan.counts, dim=3, P=plan.P)
    assert got[3].tolist() == [255] and want[3].tolist() == [263]


def test_grid_groups_match(xla_rounding):
    """Morton-grid groups of 5000 random prims (16^3 bins, greedy merge
    on the host) equal bvh_tpu's."""
    rng = np.random.default_rng(11)
    c = rng.uniform(-20, 70, (5000, 3)).astype(np.float32)
    want, want_bins = j_grid_groups(jnp.asarray(c), JMiniTreeConfig())
    got, bins = _grid_groups(torch.from_numpy(c), MiniTreeConfig())
    assert bins == want_bins and int(got.max()) > 2
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_group_build_dispatch():
    """CPU tensors take the plain version; other devices and P off the
    128-lane grid are refused, with no launch counted."""
    pf, sz = group_build_case([5, 3], 128, seed=1)
    pf, sz = torch.from_numpy(pf), torch.from_numpy(sz)
    got = gk.group_forest_build(pf, sz, dim=3, P=128)
    assert _same_outputs(got, [x.numpy() for x in
                               gk.group_forest_build_ref(pf, sz, dim=3, P=128)])
    with pytest.raises(ValueError, match="multiple of 128"):
        gk.group_forest_build(pf, sz, dim=3, P=100)
    with pytest.raises(ValueError, match="unsupported device"):
        gk.group_forest_build(torch.empty((16, 256), device="meta"),
                              torch.empty(2, dtype=torch.int32, device="meta"),
                              dim=3, P=128)
    assert gk.kernels.GROUP_BUILD.launches == 0
