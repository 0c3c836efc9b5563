"""The port's examples (bvh_tpu_torch/examples/) as subprocesses on the
CPU: each exits 0 and prints the line that its bvh_tpu counterpart
(examples/*.py) prints, captured here in-process."""

import importlib
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(__file__)
ROOT = os.path.join(HERE, "..")


@pytest.mark.parametrize("name", ["simple_example", "serialize_roundtrip"])
def test_port_example_prints_bvh_tpu_line(name, capsys):
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        module = importlib.import_module(name)
    finally:
        sys.path.pop(0)
    assert module.main() == 0
    want = capsys.readouterr().out
    got = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bvh_tpu_torch", "examples",
                                      f"{name}.py"), "--device", "cpu"],
        capture_output=True, text=True, timeout=120, check=False)
    assert got.returncode == 0, got.stderr
    assert got.stdout == want
