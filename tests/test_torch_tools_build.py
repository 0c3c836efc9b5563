"""The port's build tools (bvh_tpu_torch/tools/: bench_build,
profile_mtf, profile_reinsertion, profile_build, check_mtf_parity) on
the CPU at small sizes, where the plain versions stand in for kernel B3:

- every tree a tool builds equals its entry point's tree;
- the staged mini-tree build and the staged reinsertion iteration equal
  the unstaged `build_minitree_fast` and `_one_iteration` bit for bit;
- each recorded stage of the iteration (the search, the greedy accept,
  the dirty refit) equals bvh_tpu.build.reinsertion's function on the
  same inputs, on the LBVH tree of sponza_class(1000, 1) of
  tests/test_torch_reinsertion.py with XLA's FMA rounding
  (`xla_rounding`, tests/test_torch_build.py);
- check_mtf_parity finds the two mini-tree builds equal and exits 1
  when they are not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvh_tpu.build import reinsertion as jrein
from bvh_tpu.build.lbvh import build_lbvh as j_build_lbvh
from bvh_tpu.io.scenes import sponza_class
from bvh_tpu_torch.build.binned import build_binned
from bvh_tpu_torch.build.minitree import MiniTreeConfig, build_minitree
from bvh_tpu_torch.build.lbvh import build_lbvh
from bvh_tpu_torch.build.minitree_fast import build_minitree_fast
from bvh_tpu_torch.build.reinsertion import _one_iteration, iteration_args, \
    optimize_reinsertion, ReinsertionConfig
from bvh_tpu_torch.tools import bench_build, check_mtf_parity, \
    profile_build, profile_mtf, profile_reinsertion
from bvh_tpu_torch.tools.timing import same
from test_torch_build import to_port, xla_rounding  # noqa: F401 - fixture

N = 1000


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """At these sizes torch's intra-op threads gain nothing and contend
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def boxes():
    return bench_build.scene_boxes(N, "cpu")


def test_bench_build_trees_equal_entry_points(boxes):
    res = bench_build.run(device="cpu", reps=0, boxes=boxes)
    assert list(res) == list(bench_build.BUILDERS)
    mtf = build_minitree_fast(*boxes)
    want = {"lbvh": build_lbvh(*boxes),
            "minitree": build_minitree(*boxes, MiniTreeConfig()),
            "binned": build_binned(*boxes), "mtf": mtf,
            "high": optimize_reinsertion(mtf)}
    for name, r in res.items():
        assert same(r["tree"], want[name]), name
        assert r["nodes"] == r["tree"].node_count and r["mprims_s"] > 0


def test_profile_mtf_staged_build_equals_build(boxes):
    res = profile_mtf.run(device="cpu", reps=1, boxes=boxes)
    assert same(res["tree"], build_minitree_fast(*boxes))
    assert set(res["stages"]) == set(profile_mtf.STAGES)
    assert res["stages"]["top_tree"] <= res["stages"]["assemble"]
    assert res["G"] >= 1 and res["P"] % 128 == 0


@pytest.fixture(scope="module")
def lbvh_sponza1000():
    """tests/test_torch_reinsertion.py's LBVH scene, built by bvh_tpu."""
    tris = sponza_class(1000, 1)
    return j_build_lbvh(*(jnp.asarray(a) for a in (
        tris.min(axis=1), tris.max(axis=1), tris.mean(axis=1))))


def test_profile_reinsertion_stages_match_bvh_tpu(lbvh_sponza1000,
                                                  xla_rounding):
    """The staged iteration equals `_one_iteration`; the search, the
    accept and the refit equal bvh_tpu's on their recorded inputs."""
    jbvh = lbvh_sponza1000
    tree = to_port(jbvh)
    res = profile_reinsertion.run(device="cpu", reps=1, tree=tree)
    want = _one_iteration(*iteration_args(tree, ReinsertionConfig()))
    assert same(res["out"], want)
    assert res["steps"] > 0 and res["accepted"] > 10
    assert set(res["stages"]) == set(profile_reinsertion.STAGES)
    assert sum(res["shares"].values()) == pytest.approx(1.0)
    assert res["syncs"] is None and res["iterations"] == 3
    assert res["full_refit_equal"]
    rec = res["record"]
    cap = tree.index.shape[0]
    idx_t = np.asarray(jbvh.index).dtype

    def j_index(t):
        return jnp.asarray(t.numpy().astype(idx_t))

    def j_i32(t):
        return jnp.asarray(t.numpy().astype(np.int32))

    parents = rec["parents"][2]
    assert np.array_equal(parents.numpy(), np.asarray(jrein.compute_parents(
        jbvh.index, jbvh.node_count, cap)))
    (bounds, index, _, cand, valid, depth), _, (to, diff, _) = rec["search"]
    # jitted, as `_one_iteration` runs them: XLA contracts a*b + c into
    # FMAs only inside compiled code
    jto, jdiff = jax.jit(jrein._find_reinsertion_batch, static_argnums=5)(
        jnp.asarray(bounds.numpy()), j_index(index), j_i32(parents),
        j_i32(cand), jnp.asarray(valid.numpy()), depth)
    assert np.array_equal(to.numpy(), np.asarray(jto))
    assert diff.numpy().tobytes() == np.asarray(jdiff).tobytes()
    (conflicts, ok, _), _, accepted = rec["accept"]
    jacc = jax.jit(jrein._greedy_accept, static_argnums=2)(
        j_i32(conflicts), jnp.asarray(ok.numpy()), cap)
    assert np.array_equal(accepted.numpy(), np.asarray(jacc))
    (bounds, index, parents, seeds), _, refit = rec["refit"]
    jref = jax.jit(jrein._refit_dirty)(
        jnp.asarray(bounds.numpy()), j_index(index), j_i32(parents),
        j_i32(seeds))
    assert refit.numpy().tobytes() == np.asarray(jref).tobytes()


@pytest.mark.parametrize("input_name", profile_reinsertion.INPUTS)
def test_profile_reinsertion_inputs(boxes, input_name):
    """Both inputs: the staged iteration equals the unstaged one (the
    tool raises otherwise) and the optimizer runs its iterations."""
    res = profile_reinsertion.run(input_name=input_name, device="cpu",
                                  reps=1, boxes=boxes)
    tree = profile_reinsertion.input_tree(input_name, boxes)
    assert res["n_nodes"] == tree.node_count
    assert len(res["optimize_steps"]) == res["iterations"]
    assert res["stages"]["search"] > 0


def test_profile_build_builds_equal_entry_points():
    res = profile_build.run(n=N, device="cpu", reps=1)
    assert len(res["ops"]) == 9 and all(v > 0 for v in res["ops"].values())
    assert set(res["rounds"]) == set(profile_build.ROUNDS)
    rng = np.random.default_rng(0)
    profile_build.primitive_ops(N, "cpu", rng)   # the tool's draws
    tris = rng.random((N, 3, 3), np.float32)
    b = tuple(torch.from_numpy(a) for a in (
        tris.min(axis=1), tris.max(axis=1), tris.mean(axis=1)))
    assert same(res["builds"]["build_binned"][2], build_binned(*b))
    assert same(res["builds"]["build_minitree"][2],
                build_minitree(*b, MiniTreeConfig()))


def test_check_mtf_parity(monkeypatch):
    res = check_mtf_parity.run(n=N, device="cpu")
    nc = res["fast"].node_count
    assert res["equal"] and res["nodes"] == (nc, nc)
    assert torch.equal(res["fast"].index[:nc], res["exact"].index[:nc])

    def off_by_one_box(*a):
        tree = build_minitree(*a)
        bounds = tree.bounds.clone()
        bounds[1, 0] = torch.nextafter(bounds[1, 0], bounds[1, 1])
        return tree._replace(bounds=bounds)

    monkeypatch.setattr(check_mtf_parity, "build_minitree", off_by_one_box)
    monkeypatch.setattr("sys.argv", ["check_mtf_parity", "--n", str(N),
                                     "--device", "cpu"])
    assert check_mtf_parity.main() == 1
