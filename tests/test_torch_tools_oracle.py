"""The port's check_oracle, profile_pure and sweep_chain
(bvh_tpu_torch/tools/) on the CPU at small size, on one scene:
sponza_class(3000, 3), the scene of tests/test_torch_wide_treelet.py,
with 32x32 primary rays and the native library's quality-2 tree, which
check_oracle builds:

- the oracle tracer (tools/oracle_trace.cpp over native/bvh_c.cpp,
  built with g++ here) traces the rays through that tree, and the
  port's render of the same tree passes `compare`, fast and robust; a
  result with one changed hit is counted as one miss (the budget is at
  least one ray), with two it fails;
- the port's `compare` gives the JAX tool's verdicts and lines
  (tools/check_oracle.py, loaded from its path as it is) on synthetic
  cases: exact matches, ties, "ours closer" on the fast path and under
  the strict rule, and over the budget;
- profile_pure's and sweep_chain's renders of the tree give bvh_tpu's
  wavefront hits under the rule of tests/test_wide_treelet.py
  (`_hits_match`), and every sweep config the default's bit for bit;
  the TPU tiling keys are refused by name.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.cli.camera import primary_rays as j_primary_rays
from bvh_tpu.geom.tri import PrecomputedTri as JPre
from bvh_tpu.geom.tri import Tri as JTri
from bvh_tpu.io.scenes import scene_camera
from bvh_tpu.io.serialize import deserialize_from_bytes as j_from_bytes
from bvh_tpu.traverse.wavefront import intersect_tris as j_intersect_tris
from bvh_tpu_torch.io.serialize import serialize_to_bytes
from bvh_tpu_torch.tools import check_oracle, profile_pure, sweep_chain
from test_torch_wide_treelet import _hits_match

SIZE = dict(n=3000, side=32)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """At these sizes torch's intra-op threads gain nothing and contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oracle_run():
    return check_oracle.run(**SIZE, seed=3, device="cpu", threads=2)


@pytest.fixture(scope="module")
def jhit(oracle_run):
    """bvh_tpu's wavefront render of the same tree, (t, prim_id)."""
    sc = oracle_run["scene"]
    jbvh = j_from_bytes(serialize_to_bytes(sc.tree))
    tri = JTri(*(jnp.asarray(sc.tris[:, i]) for i in range(3)))
    eye, d, up = scene_camera(sc.tris)
    h = j_intersect_tris(jbvh, JPre.from_tri(tri).as_flat(),
                         j_primary_rays(eye, d, up, SIZE["side"],
                                        SIZE["side"]))
    return np.asarray(h.t), np.asarray(h.prim_id).astype(np.int64)


@pytest.fixture(scope="module")
def jax_compare():
    """tools/check_oracle.py's `compare`, the file loaded as it is."""
    spec = importlib.util.spec_from_file_location(
        "jax_check_oracle", os.path.join(ROOT, "tools", "check_oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.compare


def test_oracle_passes_and_one_changed_hit_counts(oracle_run):
    assert oracle_run["ok"]
    fast = oracle_run["variants"]["fast"]
    assert set(oracle_run["variants"]) == {"fast", "robust"}
    assert fast["hits"] == fast["oracle_hits"] > 50
    assert fast["exact"] + fast["ties"] + fast["ours_closer"] == 1024
    hit_rays = np.flatnonzero(fast["our_pos"] >= 0)
    pos, t = fast["our_pos"].copy(), fast["our_t"].copy()
    args = (fast["ref_pos"], fast["ref_t"])
    for k, name in enumerate(("one", "two")):
        i = hit_rays[k]  # another triangle, farther away
        pos[i], t[i] = (pos[i] + 1) % SIZE["n"], t[i] * 1.5
        res = check_oracle.compare(f"{name} changed", pos, t, *args)
        assert (res["our_misses"], res["budget"], res["ok"]) == (
            k + 1, 1, k == 0)


def test_profile_pure_and_sweep_hits_match_bvh_tpu(oracle_run, jhit):
    sc = oracle_run["scene"]
    pure = profile_pure.run(**SIZE, device="cpu", reps=1, scene=sc)
    assert pure["ok"] and pure["expect"] is None
    assert pure["x1"]["kernel_ms"] is None and pure["x4"]["ms"] > 0
    _hits_match(pure["fields"][0].numpy(), pure["fields"][3].numpy(), *jhit)
    sweep = sweep_chain.run(**SIZE, max_prims=128, reps=1, device="cpu",
                            configs="k=1;k=16;max_prims=256,k=2", scene=sc)
    assert sweep["ok"] and len(sweep["configs"]) == 3
    assert sweep["entry"]["equal"] and sweep["entry"]["ms"] > 0
    rows = [sweep["default"]] + sweep["configs"]
    assert [r["k"] for r in rows] == [4, 1, 16, 2]
    ids = sc.tree.prim_ids.numpy()
    for r in rows:  # fields: t, u, v and the prim position
        t, pos = r["fields"][0].numpy(), r["fields"][3].numpy()
        pid = np.where(np.isfinite(t), ids[np.minimum(pos, len(ids) - 1)],
                       0xFFFFFFFF)
        _hits_match(t, pid, *jhit)
    with pytest.raises(ValueError, match="tail_block, top_block"):
        sweep_chain.parse_configs("k=4;top_block=8,tail_block=128")


def _case(rng, R=2000):
    """A synthetic oracle result and port result equal on every ray."""
    ref_pos = rng.integers(0, 500, R).astype(np.uint32)
    ref_t = rng.uniform(1.0, 10.0, R).astype(np.float32)
    miss = rng.random(R) < 0.3
    ref_pos[miss] = 0xFFFFFFFF
    ref_t[miss] = np.finfo(np.float32).max
    our_pos = np.where(miss, -1, ref_pos.astype(np.int64))
    our_t = np.where(miss, np.inf, ref_t).astype(np.float32)
    return our_pos, our_t, ref_pos, ref_t


def _edit(case, kind, rays):
    our_pos, our_t, ref_pos, ref_t = (a.copy() for a in case)
    hit = np.flatnonzero(our_pos >= 0)[:rays]
    if kind == "tie":
        our_pos[hit] += 1
    elif kind == "closer":
        our_pos[hit] += 1
        our_t[hit] *= 0.5
    elif kind == "farther":
        our_pos[hit] += 1
        our_t[hit] *= 2.0
    elif kind == "new_hit":
        missed = np.flatnonzero(our_pos < 0)[:rays]
        our_pos[missed] = 7
        our_t[missed] = 3.0
    return our_pos, our_t, ref_pos, ref_t


@pytest.mark.parametrize("kind, rays", [
    ("exact", 0), ("tie", 5), ("closer", 5), ("farther", 1),
    ("farther", 2), ("new_hit", 3)])
@pytest.mark.parametrize("strict", [False, True])
def test_compare_equals_jax_tool(jax_compare, capsys, kind, rays, strict):
    case = _edit(_case(np.random.default_rng(rays)), kind, rays)
    want = jax_compare("case", *case, strict=strict)
    want_out = capsys.readouterr().out
    got = check_oracle.compare("case", *case, strict=strict)
    assert got["ok"] == want and capsys.readouterr().out == want_out
