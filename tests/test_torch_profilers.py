"""The render profilers (T2-T4) on the CPU, on the fixture scene of
tests/test_torch_wide_treelet.py (sponza_class(3000, 3), MEDIUM tree,
32x32 primary rays, max_prims=256; two-level: max_prims=128,
super_prims=512):

- T2: the render run stage by stage through `StageTimer` gives
  `wide_treelet_intersect_tris`' hits bit for bit, closest and any-hit;
  `merge_round` on a hand-made round merges as the reference's
  first-j rule says; the trace summary's counts;
- T3: SIMT efficiency and the budget split on hand-made step arrays
  with hand-computed answers; round 1 recorded from the render;
- T4: the `.npz` loader on a tables file written from the fixture's
  bvh_tpu WideTreelets with tools/bench_sanmiguel.py's keys, and the
  whole tool on the two-level scene (phase A2 staged too).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from bvh_tpu_torch.tools import profile_occupancy as po
from bvh_tpu_torch.tools import profile_r3 as pr
from bvh_tpu_torch.tools import profile_sm as ps
from bvh_tpu_torch.traverse import wide_treelet as twt
from test_torch_wide_treelet import scene  # noqa: F401 - shared fixture


@pytest.mark.parametrize("any_hit", [False, True])
def test_staged_render_equals_render(scene, any_hit):
    res = pr.stage_profile(scene["ttl"], scene["trays"], "cpu",
                           any_hit=any_hit, reps=1)
    assert set(res["stages"]) == {"phase_a", "portal_sort", "ready",
                                  "round_pairs", "b1", "merge_round"}
    assert res["calls"]["b1"] == res["rounds"] >= 1
    assert res["calls"]["ready"] == res["rounds"] + 1
    assert res["stage_sum"] > 0 and res["hits"] > 50


def test_merge_round_first_j_rule():
    """k = 2 windows for 3 ready rays of 4. Closest hit: a later window
    wins only with a strictly smaller t (ray 0: 2.0 then an equal 2.0,
    the first kept; ray 2: 5.0 then 3.0); an invalid window is ignored
    (ray 3's second). Any-hit: the first hit wins."""
    inf = float("inf")
    rsel = torch.tensor([0, 2, 3])
    validk = torch.tensor([[True, True, True], [True, True, False]])
    pk = torch.tensor([0, 0, 0, 1, 1])
    pr_ = torch.tensor([0, 1, 2, 0, 1])
    out_f = torch.tensor([[2.0, 5.0, 7.0, 2.0, 3.0],
                          [0.1, 0.2, 0.3, 0.4, 0.5],
                          [0.6, 0.7, 0.8, 0.9, 1.0]])
    out_i = torch.tensor([[10, 11, 12, 13, 14], [1, 1, 1, 1, 1],
                          [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
                         dtype=torch.int32)

    def state():
        return ((torch.full((4,), inf), torch.zeros(4), torch.zeros(4),
                 torch.full((4,), -1, dtype=torch.int64)),
                torch.full((4,), 9.0), torch.zeros(4, dtype=torch.int64))

    best, tmax, cur = state()
    twt.merge_round(best, tmax, cur, rsel, validk, pk, pr_, out_f, out_i,
                    k=2, any_hit=False)
    assert best[0].tolist() == [2.0, inf, 3.0, 7.0]
    assert best[3].tolist() == [10, -1, 14, 12]
    assert best[1].tolist() == pytest.approx([0.1, 0.0, 0.5, 0.3])
    assert tmax.tolist() == [2.0, 9.0, 3.0, 7.0]
    assert cur.tolist() == [2, 0, 2, 2]
    best, tmax, cur = state()
    twt.merge_round(best, tmax, cur, rsel, validk, pk, pr_, out_f, out_i,
                    k=2, any_hit=True)
    assert best[3].tolist() == [10, -1, 11, 12]
    assert tmax.tolist() == [9.0] * 4


def test_trace_summary_counts():
    """Busy time is the union of the device intervals; syncs and copies
    are counted by name."""
    def ev(name, dev, a, b):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=a, end=b))

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [ev("aten::add", cpu, 0.0, 100.0),
              ev("cudaStreamSynchronize", cpu, 50.0, 60.0),
              ev("cudaStreamSynchronize", cpu, 70.0, 80.0),
              ev("kernel_a", cuda, 10.0, 30.0),
              ev("kernel_b", cuda, 20.0, 40.0),
              ev("Memcpy DtoH (Device -> Pageable)", cuda, 60.0, 70.0)]
    res = pr.summarize_events(events)
    assert res["device_ops"] == 3 and res["host_syncs"] == 2
    assert res["dtoh_copies"] == 1
    assert res["busy_ms"] == pytest.approx(0.04)     # 30 + 10 us
    assert res["busy_share"] == pytest.approx(0.4)
    assert pr.summarize_events([])["busy_share"] is None


def test_simt_efficiency_by_hand():
    # groups (1, 2) and (3, 4): cost 2 * (2 + 4) = 12 for 10 steps
    assert po.simt_efficiency(np.array([1, 2, 3, 4]), 2) == pytest.approx(
        10 / 12)
    # one pair in a warp of 4: 5 of 20 lane-steps
    assert po.simt_efficiency(np.array([5]), 4) == pytest.approx(0.25)
    assert po.simt_efficiency(np.array([3, 3, 3, 3]), 2) == 1.0


def test_budget_split_by_hand():
    """Steps (10, 2, 30, 1), pairs of 2, budget 8. Phase 1 runs
    (8, 2 | 8, 1): cost 8 + 8; 10 and 30 go on with 2 and 22 left. With
    2 phases the second runs them to the end: cost 22, 38 in all, for 43
    steps on 2 lanes. With 3 phases: 8, then 14 alone (padded): 38."""
    steps = np.array([10, 2, 30, 1])
    assert po.budget_split(steps, 2, 8, 2) == (38, pytest.approx(43 / 76))
    assert po.budget_split(steps, 2, 8, 3) == (38, pytest.approx(43 / 76))
    # one phase is the plain order
    cost, eff = po.budget_split(steps, 2, 8, 1)
    assert cost == 40 and eff == pytest.approx(po.simt_efficiency(steps, 2))


def test_round_one_record(scene):
    """Round 1 recorded from the render: its pairs are B1's inputs, each
    pair's steps are B1's, and every ordering is a permutation."""
    tl = scene["ttl"]
    r = po.round_one(tl, scene["trays"], "cpu")
    b1_args, _, (out_f, out_i) = r["b1"]
    assert np.array_equal(r["tid"], b1_args[1].numpy())
    assert np.array_equal(r["steps"], out_i[1].numpy()) and r["steps"].min() > 0
    assert r["launches"] == 1 and np.isfinite(r["entry"]).all()
    chord = po.chord_lengths(tl.table.numpy(), r["tid"], r["prays"])
    assert (chord >= 0).all() and (chord > 0).mean() > 0.9
    for order in po.orderings(r, chord).values():
        assert np.array_equal(np.sort(order), np.arange(r["tid"].size))
    res = po.analyse(r, tl.table.numpy())
    oracle = res["simt"]["steps desc, all pairs"]
    assert all(oracle[g] >= e[g] for e in res["simt"].values() for g in oracle)


def test_tables_npz_loader(scene, tmp_path):
    """tools/bench_sanmiguel.py's keys (:127-133), written from bvh_tpu's
    WideTreelets, load into the port's tables bit for bit."""
    jtl = scene["jtl"]
    path = tmp_path / "tables.npz"
    np.savez(path, top_node_t=np.asarray(jtl.top_node_t),
             top_root=jtl.top_root, table=np.asarray(jtl.table),
             n_prims=jtl.n_prims, n_wide=jtl.n_wide,
             top_depth=jtl.top_depth, wide_depth=jtl.wide_depth,
             sup_table=np.asarray(jtl.sup_table), sup_depth=jtl.sup_depth)
    tl = ps.load_tables(str(path), "cpu")
    ttl = scene["ttl"]
    for f in ("top_node_t", "table", "sup_table"):
        assert getattr(tl, f).numpy().tobytes() == \
            getattr(ttl, f).numpy().tobytes()
    for f in ("top_root", "n_prims", "top_depth", "wide_depth", "sup_depth"):
        assert getattr(tl, f) == getattr(ttl, f)
    assert np.array_equal(tl.n_wide, ttl.n_wide)


def test_profile_sm_on_two_level_scene(scene):
    """The whole T4 tool on a two-level cut: every staged and timed render
    equals the render (the tool raises otherwise), phase A2 is a stage."""
    tl = twt.build_wide_treelets(scene["tbvh"], torch.from_numpy(
        np.array(scene["jflat"])), max_prims=128, super_prims=512)
    assert tl.sup_table.shape[0] > 1
    res = ps.run(tl, scene["trays"], "cpu", reps=1)
    assert "phase_a2" in res["stage"]["stages"]
    assert res["rounds"] == len(res["pairs"]) >= 1
    assert res["pairs"][0] == max(res["pairs"])
