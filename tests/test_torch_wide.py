"""The port's 8-wide layout (`traverse/wide.py`) against bvh_tpu's on the
CPU, on the cases of tests/test_wide.py:17-56 over the golden Cornell
tree: `widen` gives the same wide nodes bit for bit, and
`intersect_tris_wide` the same hits as bvh_tpu's in every mode, bit for
bit with XLA's FMA rounding (`xla_rounding`, see
tests/test_torch_build.py), and the C++ oracle's hits with the port's
own rounding. A push past the stack raises (ROADMAP C13).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.io.serialize import load_bvh as j_load_bvh
from bvh_tpu.traverse.wide import intersect_tris_wide as j_wide
from bvh_tpu.traverse.wide import widen as j_widen
from bvh_tpu_torch.core.ray import Ray
from bvh_tpu_torch.io.serialize import load_bvh
from bvh_tpu_torch.traverse import wide
from bvh_tpu_torch.traverse.wavefront import intersect_tris
from test_torch_build import xla_rounding  # noqa: F401 - fixture
from test_torch_wavefront import MODES, _equal_hits
from test_traverse import assert_hits_match, primary_rays

from helpers import scene_arrays


@pytest.fixture(scope="module")
def cornell(golden_dir, cornell_tris):
    path = os.path.join(golden_dir, "cornell_sweep.bvh")
    jbvh = j_load_bvh(path)
    tbvh = load_bvh(path, device="cpu")
    perm = np.asarray(jbvh.prim_ids).astype(np.int64)
    flat = np.asarray(scene_arrays(cornell_tris)[3])[perm]
    jrays = primary_rays()
    return dict(jbvh=jbvh, tbvh=tbvh, jw=j_widen(jbvh), tw=wide.widen(tbvh),
                jflat=jnp.asarray(flat), tflat=torch.from_numpy(flat),
                jrays=jrays,
                trays=Ray(*(torch.from_numpy(np.array(x)) for x in jrays)))


def test_widen_matches_bvh_tpu(cornell):
    jw, tw = cornell["jw"], cornell["tw"]
    m = tw.node_count
    assert m == int(jw.node_count) and m < cornell["tbvh"].node_count
    assert np.asarray(jw.child_bounds).tobytes() \
        == tw.child_bounds.numpy().tobytes()
    assert np.array_equal(np.asarray(jw.child_index).astype(np.int64),
                          tw.child_index.numpy())
    assert torch.equal(tw.prim_ids, cornell["tbvh"].prim_ids)
    assert tw.dim == 3 and tw.child_index.shape == (m, wide.WIDTH)


def test_widen_structure(cornell):
    """tests/test_wide.py:17-32: every leaf range of the binary tree once,
    inner child words naming wide nodes."""
    tw, tb = cornell["tw"], cornell["tbvh"]
    words = tw.child_index.numpy()
    counts, first = words & 15, words >> 4
    binary = tb.index[:tb.node_count].numpy()
    assert sorted(binary[(binary & 15) > 0].tolist()) \
        == sorted(words[counts > 0].tolist())
    inner = (counts == 0) & (tw.child_bounds[:, :, 0].numpy() < 1e37)
    assert np.all(first[inner] < tw.node_count)


@pytest.mark.parametrize("any_hit, robust", MODES)
def test_wide_hits_match_bvh_tpu(cornell, any_hit, robust, xla_rounding):
    want = j_wide(cornell["jw"], cornell["jflat"], cornell["jrays"],
                  any_hit=any_hit, robust=robust, permuted=True)
    got = wide.intersect_tris_wide(cornell["tw"], cornell["tflat"],
                                   cornell["trays"], any_hit=any_hit,
                                   robust=robust, permuted=True)
    _equal_hits(want, got, exact=True)
    assert int(got.hit.sum()) > 1000


def test_wide_hits_match_goldens(cornell, golden_hits, golden_anyhit):
    """tests/test_wide.py:35-56, with the port's own rounding; the
    closest hits also equal the binary wavefront's apart from exact-t
    ties."""
    tw, flat, rays = cornell["tw"], cornell["tflat"], cornell["trays"]
    hit = wide.intersect_tris_wide(tw, flat, rays, robust=True, permuted=True)
    assert_hits_match(hit.prim_pos.numpy().astype(np.uint32), hit.t.numpy(),
                      golden_hits["prim_id"], golden_hits["t"],
                      max_tie_frac=0.01)
    binary = intersect_tris(cornell["tbvh"], flat, rays, robust=True,
                            permuted=True)
    assert torch.equal(binary.t, hit.t)
    anyh = wide.intersect_tris_wide(tw, flat, rays, any_hit=True, robust=True,
                                    permuted=True)
    assert np.array_equal(anyh.hit.numpy().astype(np.uint8), golden_anyhit)


def test_wide_stack_overflow_raises(cornell):
    """bvh_tpu moves the stack pointer past a full stack and later pops
    the root word (C13); the port raises."""
    with pytest.raises(ValueError, match="overflow"):
        wide.intersect_tris_wide(cornell["tw"], cornell["tflat"],
                                 cornell["trays"], stack_depth=1,
                                 permuted=True)
