"""The port's build modules against bvh_tpu on the CPU: Morton codes,
the sweep builder, canonicalize and refit (the reinsertion optimizer is
in tests/test_torch_reinsertion.py).
Inputs are made with numpy from a seed and fed to both packages.

Why the FMA patch: XLA's CPU backend contracts a*b + c into a fused
multiply-add inside compiled code (ROADMAP C5), where the port and the
CUDA kernels (-fmad=false) round the product and the sum separately.
The port routes every such expression of the build through
`core.utils.fast_mul_add`; the `xla_rounding` fixture gives it one
rounding (the float32 product is exact in float64), and then the port
is held to bvh_tpu bit for bit. Without the patch the tests state what
holds instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.build.canonicalize import canonicalize as j_canonicalize
from bvh_tpu.build.canonicalize import extract_bvh as j_extract_bvh
from bvh_tpu.build.sweep import build_sweep as j_build_sweep
from bvh_tpu.core import utils as jutils
from bvh_tpu.traverse.refit import compute_parents as j_compute_parents
from bvh_tpu.traverse.refit import leaf_of_position as j_leaf_of_position
from bvh_tpu.traverse.refit import refit as j_refit
from bvh_tpu_torch.build.canonicalize import canonicalize, extract_bvh
from bvh_tpu_torch.build.sweep import build_sweep
from bvh_tpu_torch.core import utils
from bvh_tpu_torch.core.types import bvh_from_numpy
from bvh_tpu_torch.traverse.refit import compute_parents, leaf_of_position, refit

from helpers import check_bvh_invariants, scene_arrays


def xla_fma(a, b, c):
    """a * b + c with one rounding, as XLA's CPU backend computes it:
    the float32 product is exact in float64; the float64 sum rounds
    twice, which differs from a true FMA only in rare halfway cases."""
    return (a.double() * b.double() + c.double()).float()


@pytest.fixture
def xla_rounding(monkeypatch):
    monkeypatch.setattr(utils, "fast_mul_add", xla_fma)


def to_port(jbvh):
    """A bvh_tpu tree (full capacity arrays) as a port Bvh on the CPU."""
    return bvh_from_numpy(np.asarray(jbvh.bounds), np.asarray(jbvh.index),
                          np.asarray(jbvh.prim_ids), int(jbvh.node_count),
                          int(jbvh.prim_count), "cpu")


def same_tree(jbvh, tbvh) -> bool:
    """Node count, bounds (bits), index words and prim ids equal, over
    the whole capacity."""
    return (int(jbvh.node_count) == tbvh.node_count
            and int(jbvh.prim_count) == tbvh.prim_count
            and np.asarray(jbvh.bounds).tobytes() == tbvh.bounds.numpy().tobytes()
            and np.array_equal(np.asarray(jbvh.index).astype(np.int64),
                               tbvh.index.numpy())
            and np.array_equal(np.asarray(jbvh.prim_ids).astype(np.int64),
                               tbvh.prim_ids.numpy()))


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_split_bits_and_morton_encode_match(dim):
    """Exact integers: equal on the full uint32 range."""
    rng = np.random.default_rng(dim)
    x = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jutils.split_bits(jnp.asarray(x), dim))
    got = utils.split_bits(torch.from_numpy(x.astype(np.int64)), dim)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    coords = rng.integers(0, 1 << (32 // dim), (4096, dim),
                          dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jutils.morton_encode(jnp.asarray(coords), dim))
    got = utils.morton_encode(torch.from_numpy(coords.astype(np.int64)), dim)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def _sweep_scene(name, cornell_tris):
    """The scenes of tests/test_build_sweep.py."""
    if name == "cornell":
        return tuple(np.asarray(x) for x in scene_arrays(cornell_tris)[:3])
    if name == "identical":
        n = 40
        return (np.zeros((n, 3), np.float32), np.ones((n, 3), np.float32),
                np.full((n, 3), 0.5, np.float32))
    n = int(name)
    rng = np.random.default_rng(1000 + n)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    ext = rng.uniform(0.01, 0.1, (n, 3)).astype(np.float32)
    return pts - ext, pts + ext, pts


SWEEP_SCENES = ["cornell", "2", "5", "33", "128", "identical"]


@pytest.fixture(scope="module")
def sweeps(cornell_tris):
    """bvh_tpu's sweep tree of every scene."""
    out = {}
    for name in SWEEP_SCENES:
        arrays = _sweep_scene(name, cornell_tris)
        out[name] = (arrays, j_build_sweep(*(jnp.asarray(a) for a in arrays)))
    return out


def _port_sweep(arrays):
    return build_sweep(*(torch.from_numpy(np.array(a)) for a in arrays))


@pytest.mark.parametrize("name", SWEEP_SCENES)
def test_sweep_matches_bvh_tpu(sweeps, name, xla_rounding):
    """Bit for bit with XLA's rounding of the sweep's costs."""
    arrays, jbvh = sweeps[name]
    assert same_tree(jbvh, _port_sweep(arrays))


@pytest.mark.parametrize("name", SWEEP_SCENES)
def test_sweep_without_fma_rounding(sweeps, name):
    """With its own rounding the port builds the same tree on every scene
    but the 128-prim one, where a near-tie cost falls the other way: a
    valid tree with the same node count."""
    arrays, jbvh = sweeps[name]
    tbvh = _port_sweep(arrays)
    check_bvh_invariants(tbvh, len(arrays[0]))
    assert tbvh.node_count == int(jbvh.node_count)
    assert same_tree(jbvh, tbvh) == (name != "128")


def test_canonicalize_and_refit_match(sweeps):
    """Pruning a tree (every third leaf dropped), re-rooting it, and the
    refits: integer work and exact min/max, so equal bit for bit."""
    arrays, jbvh = sweeps["128"]
    tbvh = to_port(jbvh)
    cap = tbvh.index.shape[0]
    keep = np.arange(cap) % 3 != 0
    jc = j_canonicalize(jbvh, jnp.asarray(keep))
    tc = canonicalize(tbvh, torch.from_numpy(keep))
    assert same_tree(jc, tc) and tc.node_count < tbvh.node_count
    assert same_tree(j_extract_bvh(jbvh, 5), extract_bvh(tbvh, 5))
    # refit of the pruned tree, inner bounds only and from prim boxes
    assert same_tree(j_refit(jc), refit(tc))
    mn, mx = arrays[0], arrays[1]
    assert same_tree(
        j_refit(jc, jnp.asarray(mn), jnp.asarray(mx)),
        refit(tc, torch.from_numpy(mn), torch.from_numpy(mx)))
    assert np.array_equal(compute_parents(tc).numpy(),
                          np.asarray(j_compute_parents(jc)))
    assert np.array_equal(leaf_of_position(tc).numpy(),
                          np.asarray(j_leaf_of_position(jc)))
