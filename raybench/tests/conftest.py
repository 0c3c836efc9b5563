"""Small cells for the CPU tests: the real cells of BENCHMARK.json with
the scene cut to 3,000 triangles and 32 x 32 rays, run on the CPU, where
the port's plain versions stand in for its kernels."""

import copy
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from raybench import harness  # noqa: E402


def tiny(workload: str):
    """(manifest, workload, configuration, traffic) of a cell, cut to a
    size the CPU runs in seconds."""
    return cut(*copy.deepcopy(harness.cell(workload)))


def tiny_cell(config: str, traffic: str):
    """`tiny` of a cell that BENCHMARK.json does not hold: the
    configuration and the traffic file found by name, under the
    workload name `<config>.<traffic>`, reporting only `setup_s`."""
    manifest = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = {c["name"]: c for c in manifest["configs"]}[config]
    wl = {"name": f"{config}.{traffic}", "config": config,
          "traffic": traffic, "chips": 1, "why": "a CPU test"}
    return cut(manifest, wl,
               harness.load_json(os.path.join(ROOT, entry["file"])),
               harness.load_json(os.path.join(ROOT, "raybench", "traffic",
                                              traffic + ".json")))


def cut(manifest, wl, config, traffic):
    """The cell's configuration and traffic cut, in place, to `tiny`'s
    size."""
    config.update(n_tris=3000, max_prims=128, two_level=False)
    for spec in (traffic.get("rays"), traffic["check"].get("rays")):
        if spec and spec["kind"] == "pinhole":
            spec.update(width=32, height=32, poses=min(spec["poses"], 4))
        elif spec:
            spec.update(count=1024, sets=4)
    traffic["check"]["frames"] = min(traffic["check"]["frames"], 2)
    traffic["trace"]["steps"] = 2
    if "plain_steps" in traffic["trace"]:
        traffic["trace"]["plain_steps"] = 2
    if "variants" in traffic:
        traffic["variants"] = 2
    if traffic["kind"] == "rebuild":     # one ray set a variant
        spec = traffic["rays"]
        spec["poses" if spec["kind"] == "pinhole" else "sets"] = 2
    return manifest, wl, config, traffic


@pytest.fixture
def one_thread():
    """The builders' many small CPU ops run far slower when test workers
    share the cores with torch's thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
