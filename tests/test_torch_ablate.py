"""T1 on the CPU: the ablation tool's chain table against the JAX tool's
(tools/ablate_kernel.py, loaded by file path), and kernel B1's plain
version on it against bvh_tpu's `_traverse_core`, called as
tests/test_torch_wide_kernels.py calls it; the ablation variants'
plain versions on the chain table and off it.
"""

import importlib.util
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bvh_tpu_torch.tools import ablate_kernel as ak
from bvh_tpu_torch.traverse import wide_treelet as twt
from test_torch_wide_kernels import _traverse_core_by_treelet, pairs  # noqa: F401
from test_torch_wide_treelet import scene  # noqa: F401 - shared fixture

P = 48
LANES = 128


@pytest.fixture(scope="module")
def jax_tool():
    path = pathlib.Path(__file__).parents[1] / "tools" / "ablate_kernel.py"
    spec = importlib.util.spec_from_file_location("jax_tool_ablate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("depth", [4, 32])
def test_chain_table_matches_tool(jax_tool, depth):
    want = np.asarray(jax_tool.make_chain_table(depth, P))
    got = ak.make_chain_table(depth, P)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("depth", [4, 32])
def test_chain_steps_match_traverse_core(depth):
    """Every lane runs `depth` steps and pops dry with no hit, in the
    plain version and in bvh_tpu's `_traverse_core`, and every other
    output row agrees (closest hit, fast form, the tool's stack of 24)."""
    table = ak.make_chain_table(depth, P)
    tid, rays = ak.chain_pairs(LANES, "cpu")
    out_f, out_i = twt.traverse_pairs_ref(torch.from_numpy(table), tid, rays,
                                          any_hit=False, robust=False,
                                          stack_depth=24)
    want = _traverse_core_by_treelet(SimpleNamespace(table=table), tid, rays,
                                     False, False, 24)
    assert (out_i[1] == depth).all()
    assert np.array_equal(out_i[1].numpy(), want[6].astype(np.int64))
    assert np.isinf(out_f[0].numpy()).all() and np.isinf(want[0]).all()
    assert (out_i[0] == -1).all() and (want[3] == -1).all()
    assert not out_i[2:].any() and not want[5].any()   # hwm 0, no overflow


@pytest.mark.parametrize("depth", [4, 32])
def test_variants_equal_full_on_chain(depth):
    """`check_chain` on the CPU: the dispatchers take the plain versions,
    every variant equals the full traversal on every lane."""
    table = torch.from_numpy(ak.make_chain_table(depth, P))
    tid, rays = ak.chain_pairs(LANES, "cpu")
    res = ak.check_chain(table, tid, rays, depth)
    assert (res["out"][1][1] == depth).all()


def test_variants_leave_out_their_code(scene, pairs):
    """Off the chain table each variant computes something else, by the
    code it leaves out: no quad tests means no hit; no pushes means no
    stack use; no sort changes the traversal order, so the steps."""
    tid, rays = pairs
    sd = 7 * scene["ttl"].wide_depth + 8
    table = scene["ttl"].table
    full = twt.traverse_pairs_ref(table, tid, rays, any_hit=False,
                                  robust=False, stack_depth=sd)
    out = {name: ak.traverse_pairs_ablate(table, tid, rays, variant=v,
                                          stack_depth=sd)
           for name, v in ak.VARIANTS.items()}
    assert torch.isfinite(full[0][0]).sum() > 50 and full[1][2].max() > 0
    assert not torch.isfinite(out["no quad MT"][0][0]).any()
    assert (out["no quad MT"][1][0] == -1).all()
    assert not out["no stack pushes"][1][2].any()
    assert not torch.equal(out["no sort8"][1][1], full[1][1])
    with pytest.raises(ValueError, match="unknown variant"):
        ak.traverse_pairs_ablate(table, tid, rays, variant=3, stack_depth=sd)
