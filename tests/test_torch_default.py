"""The port's `build_default` against bvh_tpu's on the CPU, at every
quality, on the Cornell box (36 triangles: the serial path, binned for
LOW and sweep for MEDIUM and HIGH, plus reinsertion for HIGH) and on
sponza_class(3000, 5) (the parallel path: the mini-tree build, plus
reinsertion for HIGH). On the CPU bvh_tpu takes its level-synchronous
`build_minitree` and the port `build_minitree_fast` through kernel B3's
plain version; bvh_tpu documents the two as bit-identical
(build/default.py:63-67), and the port's build equals bvh_tpu's bit for
bit with XLA's FMA rounding (`xla_rounding`, see
tests/test_torch_build.py). 2D boxes take the port's `build_minitree`
on the parallel path, as in bvh_tpu.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.build.default import DefaultConfig as JDefaultConfig
from bvh_tpu.build.default import Quality as JQuality
from bvh_tpu.build.default import build_default as j_build_default
from bvh_tpu.io.scenes import sponza_class
from bvh_tpu_torch.build.default import DefaultConfig, Quality, build_default
from test_torch_build import xla_rounding  # noqa: F401 - fixture

from helpers import check_bvh_invariants, scene_arrays

QUALITIES = ["low", "medium", "high"]


def same_nodes(jbvh, tbvh) -> bool:
    """Counts, node bounds (bits) and index words over the used nodes,
    and every prim id. The mini-tree builds allocate different
    capacities past node_count."""
    nc = tbvh.node_count
    return (int(jbvh.node_count) == nc
            and int(jbvh.prim_count) == tbvh.prim_count
            and np.asarray(jbvh.bounds)[:nc].tobytes()
            == tbvh.bounds[:nc].numpy().tobytes()
            and np.array_equal(np.asarray(jbvh.index)[:nc].astype(np.int64),
                               tbvh.index[:nc].numpy())
            and np.array_equal(np.asarray(jbvh.prim_ids).astype(np.int64),
                               tbvh.prim_ids.numpy()))


@pytest.fixture(scope="module")
def reference(cornell_tris):
    """bvh_tpu's build_default of both scenes at every quality."""
    out = {}
    for scene, tris in (("cornell", cornell_tris),
                        ("sponza3000", sponza_class(3000, seed=5))):
        arrays = tuple(np.asarray(x) for x in scene_arrays(tris)[:3])
        for q in QUALITIES:
            out[scene, q] = (arrays, j_build_default(
                *(jnp.asarray(a) for a in arrays),
                JDefaultConfig(quality=JQuality(q))))
    return out


@pytest.mark.parametrize("scene", ["cornell", "sponza3000"])
@pytest.mark.parametrize("quality", QUALITIES)
def test_build_default_matches_bvh_tpu(reference, scene, quality,
                                       xla_rounding):
    arrays, jbvh = reference[scene, quality]
    tbvh = build_default(*(torch.from_numpy(np.array(a)) for a in arrays),
                         DefaultConfig(quality=Quality(quality)))
    assert same_nodes(jbvh, tbvh)
    check_bvh_invariants(tbvh, len(arrays[0]))


def test_build_default_serial_overload(reference, xla_rounding):
    """parallel=False forces the serial path at any size: the sweep and
    reinsertion for HIGH."""
    from bvh_tpu_torch.build.reinsertion import optimize_reinsertion
    from bvh_tpu_torch.build.sweep import build_sweep

    arrays, _ = reference["sponza3000", "high"]
    ts = [torch.from_numpy(np.array(a)) for a in arrays]
    got = build_default(*ts, DefaultConfig(), parallel=False)
    want = optimize_reinsertion(build_sweep(*ts))
    assert got.node_count == want.node_count
    assert torch.equal(got.index, want.index)
    assert torch.equal(got.bounds, want.bounds)


def test_build_default_parallel_needs_float32_3d(monkeypatch):
    """The parallel path of other dims and dtypes: float32 2D boxes past
    parallel_threshold take the level-synchronous build_minitree and give
    bvh_tpu's tree bit for bit (XLA's FMA rounding, `fma_any`)."""
    from bvh_tpu_torch.core import utils
    from test_torch_flat import _boxes, fma_any

    monkeypatch.setattr(utils, "fast_mul_add", fma_any)
    arrays = _boxes(1100, 2, np.float32, seed=1)
    jbvh = j_build_default(*(jnp.asarray(a) for a in arrays),
                           JDefaultConfig(quality=JQuality.MEDIUM))
    tbvh = build_default(*(torch.from_numpy(a) for a in arrays),
                         DefaultConfig(quality=Quality.MEDIUM))
    assert tbvh.dim == 2 and tbvh.node_count > 1100
    assert same_nodes(jbvh, tbvh)
    check_bvh_invariants(tbvh, 1100)
