"""BENCHMARK.json against the benchmark's contract, and the files the
harness finds by name."""

import json
import os
import re

from raybench import harness
from raybench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_limits():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"][1:] == ["raybench/run.py"] and m["paths"] == [
        "raybench"]
    assert os.path.exists(os.path.join(ROOT, m["command"][1]))
    assert all(line(w) for w in m["command"])
    assert 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells at this length fits its 43,200 seconds
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_entries_names_units_and_keys():
    m = manifest()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["why"]) and line(c["source"])
        assert c["file"].startswith("raybench/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)
    metrics = m["end_to_end"] + m["per_layer"]
    for x in metrics:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert set(x) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(x["layer"])
        if x["name"].endswith("_roofline"):
            assert x["unit"] == "%"
    for group in ("configs", "workloads"):
        names = [e["name"] for e in m[group]]
        assert len(set(names)) == len(names)
    names = [x["name"] for x in metrics]
    assert len(set(names)) == len(names)
    assert "setup_s" in names


def test_every_cell_reports_its_metrics():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for w in m["workloads"]:
        mine = [x["name"] for x in harness.metrics_of(m, w["name"], False)]
        assert "setup_s" in mine and len(mine) >= 2
        assert harness.metrics_of(m, w["name"], True)
    for x in m["per_layer"]:
        moved = e2e[x["moves"]]
        for cell in x["workloads"]:
            assert cell in moved.get("workloads", [cell])


def test_files_found_by_name():
    m = manifest()
    configs = {c["name"]: c for c in m["configs"]}
    for w in m["workloads"]:
        _, wl, config, traffic = harness.cell(w["name"])
        assert config["name"] == w["config"] == configs[w["config"]]["name"]
        assert traffic["name"] == w["traffic"]
        assert traffic["kind"] in harness.LOOPS
        assert set(traffic["check"]["limits"]) >= {"wrong_hits", "late_hits",
                                                   "t_gap"}
    for c in configs.values():
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert set(c["reduced"]) <= set(cfg["reduced"])
        assert {"source", "assumed", "n_tris", "max_prims",
                "scene_seed"} <= set(cfg)
        assert cfg["build_quality"] in ("low", "medium", "high")
    for x in m["end_to_end"] + m["per_layer"]:
        assert callable(harness.reader(x["name"]))


def test_layers_are_perf_md_layers():
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for x in manifest()["per_layer"]:
        assert f"| {x['layer']} |" in perf, x["layer"]
