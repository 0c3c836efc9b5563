"""The port's wavefront traversal and its kernel B5's plain version
against bvh_tpu on the golden Cornell tree (tests/golden/cornell_sweep.bvh,
the C++ oracle's sweep tree) and the reference's 64x64 test camera:

- `intersect_tris`, closest and any-hit, fast and robust, with the
  triangles permuted by the tree and not: against the C++ oracle's
  goldens (cornell_hits.bin, cornell_anyhit.bin) under the rule of
  tests/test_traverse.py, and against bvh_tpu's `intersect_tris`;
- kernel B5's plain version (`binary_traverse_ref`, reached through
  `pallas_intersect_tris` on the CPU) against bvh_tpu's
  `pallas_intersect_tris(interpret=True)`, as tests/test_pallas.py runs
  it: t, u, v, positions and the per-ray node and leaf counts.

With XLA's FMA rounding of the fast slab and the Möller–Trumbore
products (`xla_rounding`, see tests/test_torch_build.py) every output
is equal bit for bit. Without it (ROADMAP C5) hits, positions and
any-hit results are equal, t agrees to 1e-6 and u, v to 1e-5, and the
per-ray counts of a few rays differ (fast closest hit: 6 rays' node
counts and 10 rays' leaf counts of 4,096; fast any-hit: 1 ray's leaf
count).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.io.serialize import load_bvh as j_load_bvh
from bvh_tpu.traverse.pallas_kernel import pallas_intersect_tris as j_pallas
from bvh_tpu.traverse.wavefront import intersect_tris as j_intersect_tris
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.io.serialize import load_bvh
from bvh_tpu_torch.traverse import binary_kernel as bk
from bvh_tpu_torch.traverse.stack import max_depth, required_stack_depth
from bvh_tpu_torch.traverse.wavefront import intersect_tris
from test_torch_build import xla_rounding  # noqa: F401 - fixture
from test_traverse import INVALID, assert_hits_match, primary_rays

from helpers import scene_arrays

MODES = [(False, False), (False, True), (True, False), (True, True)]


@pytest.fixture(scope="module")
def cornell(golden_dir, cornell_tris):
    path = os.path.join(golden_dir, "cornell_sweep.bvh")
    jbvh = j_load_bvh(path)
    tbvh = load_bvh(path, device="cpu")
    jflat = np.asarray(scene_arrays(cornell_tris)[3])
    jrays = primary_rays()
    trays = Ray(*(torch.from_numpy(np.array(x)) for x in jrays))
    return dict(jbvh=jbvh, tbvh=tbvh, flat=jflat, jrays=jrays, trays=trays,
                perm=np.asarray(jbvh.prim_ids).astype(np.int64))


def _flat(cornell, permuted):
    flat = cornell["flat"][cornell["perm"]] if permuted else cornell["flat"]
    return jnp.asarray(flat), torch.from_numpy(np.array(flat))


@pytest.fixture(scope="module")
def reference(cornell):
    """bvh_tpu's wavefront and Pallas kernel (interpret) in every mode."""
    out = {}
    for any_hit, robust in MODES:
        for permuted in (False, True):
            jflat, _ = _flat(cornell, permuted)
            out["wf", any_hit, robust, permuted] = j_intersect_tris(
                cornell["jbvh"], jflat, cornell["jrays"], any_hit=any_hit,
                robust=robust, permuted=permuted)
        jflat, _ = _flat(cornell, True)
        out["b5", any_hit, robust] = j_pallas(
            cornell["jbvh"], jflat, cornell["jrays"], any_hit=any_hit,
            robust=robust, permuted=True, block=1024, stack_depth=16,
            interpret=True)
    return out


def _bits(x):
    return np.asarray(x).astype(np.float32).view(np.int32)


def _equal_hits(j, t, exact: bool):
    """Every field of two Hits; bit for bit, or under the C5 tolerance."""
    jpos = np.asarray(j.prim_pos).astype(np.int64)
    assert np.array_equal(jpos, t.prim_pos.numpy())
    assert np.array_equal(np.asarray(j.prim_id).astype(np.int64),
                          t.prim_id.numpy())
    hit = jpos != INVALID
    for f, tol in (("t", 1e-6), ("u", 1e-5), ("v", 1e-5)):
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        if exact:
            assert np.array_equal(_bits(a), _bits(b)), f
        else:
            assert np.allclose(a[hit], b[hit], rtol=tol, atol=tol), f
    for f in ("visited_nodes", "visited_leaves"):
        a = np.asarray(getattr(j.stats, f))
        b = getattr(t.stats, f).numpy()
        if exact:
            assert np.array_equal(a, b), f
        else:
            assert (a != b).sum() <= 10, f


@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("any_hit, robust", MODES)
def test_wavefront_matches_bvh_tpu(cornell, reference, any_hit, robust,
                                   permuted, xla_rounding):
    _, tflat = _flat(cornell, permuted)
    hit = intersect_tris(cornell["tbvh"], tflat, cornell["trays"],
                         any_hit=any_hit, robust=robust, permuted=permuted)
    _equal_hits(reference["wf", any_hit, robust, permuted], hit, exact=True)


@pytest.mark.parametrize("any_hit, robust", MODES)
def test_wavefront_matches_goldens(cornell, reference, golden_hits,
                                   golden_anyhit, any_hit, robust):
    """With the port's own rounding: the C++ oracle's hits, and bvh_tpu's
    within the C5 tolerance."""
    _, tflat = _flat(cornell, True)
    hit = intersect_tris(cornell["tbvh"], tflat, cornell["trays"],
                         any_hit=any_hit, robust=robust, permuted=True)
    if any_hit:
        assert np.array_equal(hit.hit.numpy().astype(np.uint8),
                              golden_anyhit)
    else:
        assert_hits_match(hit.prim_pos.numpy().astype(np.uint32),
                          hit.t.numpy(), golden_hits["prim_id"],
                          golden_hits["t"])
    _equal_hits(reference["wf", any_hit, robust, True], hit, exact=False)


@pytest.mark.parametrize("any_hit, robust", MODES)
def test_b5_plain_matches_pallas(cornell, reference, any_hit, robust,
                                 xla_rounding):
    _, tflat = _flat(cornell, True)
    hit = bk.pallas_intersect_tris(cornell["tbvh"], tflat, cornell["trays"],
                                   any_hit=any_hit, robust=robust,
                                   permuted=True, stack_depth=16)
    _equal_hits(reference["b5", any_hit, robust], hit, exact=True)
    assert int(hit.hit.sum()) == 4032


@pytest.mark.parametrize("any_hit, robust", MODES)
def test_b5_plain_without_fma_rounding(cornell, reference, any_hit, robust):
    _, tflat = _flat(cornell, False)
    hit = bk.pallas_intersect_tris(cornell["tbvh"], tflat, cornell["trays"],
                                   any_hit=any_hit, robust=robust)
    _equal_hits(reference["b5", any_hit, robust], hit, exact=False)


def test_b5_tables_and_caps(cornell):
    """The tables hold one 64-byte row a pair, its words as integer
    bits; the golden tree fits the reference's caps and its stack is
    sized by its height."""
    tbvh = cornell["tbvh"]
    _, tflat = _flat(cornell, False)
    tables = bk.make_tables(tbvh, tflat)
    P = tables.pairs.shape[0]
    assert tables.pairs.shape == (P, 16) and tables.pairs.is_contiguous()
    assert tables.root_word == int(tbvh.index[0])
    words = tables.pairs[:, 12:14].view(torch.int32).long()
    assert torch.equal(words[:, 0], tbvh.index[1:2 * P:2])
    assert torch.equal(tables.pairs[:, 14:].view(torch.int32),
                       torch.zeros((P, 2), dtype=torch.int32))
    assert torch.equal(tables.pairs[:, :6], tbvh.bounds[1:2 * P:2])
    assert bk.pallas_fits(tbvh, tflat)
    assert required_stack_depth(tbvh) == max(8, max_depth(tbvh) + 1)
    assert not bk.pallas_fits(tbvh._replace(
        index=torch.zeros(4096, dtype=torch.int64)), tflat)


def test_b5_check_refuses_old_layouts(cornell):
    """B5's kernel takes the [P, 16] pair rows and 16-byte aligned
    [n, 12] triangles: the earlier [P, 12] box table, a strided or misaligned
    row table and 3D rays of the wrong width are refused."""
    tbvh = cornell["tbvh"]
    _, tflat = _flat(cornell, False)
    tables = bk.make_tables(tbvh, tflat)
    rays = torch.zeros((8, 5))
    kw = dict(leaf_width=12, dim=3, stack_depth=16)
    bk.check_walk_inputs("t", tables.pairs, tables.tris, rays=rays, **kw)
    node_b, node_w, _ = bk.pair_tables(tbvh)
    misaligned = torch.zeros(tables.tris.numel() + 1)[1:].view(
        tables.tris.shape)
    for pairs, tris, r in ((node_b, tables.tris, rays),
                           (tables.pairs[::2], tables.tris, rays),
                           (tables.pairs, misaligned, rays),
                           (tables.pairs, tables.tris[:, :9], rays),
                           (tables.pairs, tables.tris, rays[:7])):
        with pytest.raises(ValueError, match="must be a contiguous"):
            bk.check_walk_inputs("t", pairs, tris, rays=r, **kw)
    with pytest.raises(ValueError, match="stack depth"):
        bk.check_walk_inputs("t", tables.pairs, tables.tris, rays=rays,
                             **dict(kw, stack_depth=129))


def test_wavefront_stack_overflow_raises(cornell):
    _, tflat = _flat(cornell, True)
    with pytest.raises(ValueError, match="stack overflow"):
        intersect_tris(cornell["tbvh"], tflat, cornell["trays"],
                       permuted=True, stack_depth=1)
