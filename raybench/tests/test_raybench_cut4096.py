"""The configuration boxgrid_10m_cut4096 and its cell: the harness finds
its files by name, it cuts at the library's own default treelet size,
and a run cut to the CPU tests' size is correct."""

from bvh_tpu_torch.traverse import wide_treelet as wt
from raybench import harness
from raybench.tests.conftest import tiny

CELL = "boxgrid_10m_cut4096.diffuse"


def test_files_found_by_name():
    manifest, wl, config, traffic = harness.cell(CELL)
    assert wl["config"] == config["name"] == "boxgrid_10m_cut4096"
    assert traffic["name"] == "diffuse" and not traffic["any_hit"]
    assert config["two_level"] and config["build_quality"] == "high"
    ten_m = harness.cell("boxgrid_10m.interior")[2]
    # the same scene as boxgrid_10m, only cut otherwise
    for key in ("geometry", "scene_seed", "n_tris", "precision",
                "build_quality", "reduced"):
        assert config[key] == ten_m[key], key


def test_cut_is_the_library_default():
    config = harness.cell(CELL)[2]
    assert config["max_prims"] == wt.wide_treelet_max_prims(
        config["n_tris"]) == 4096


def test_tiny_run_is_correct(one_thread):
    out = harness.run_cell(CELL, 3, 0.5, False, "cpu", cell_data=tiny(CELL))
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["check"]["wrong_hits"]["value"] == 0
