"""What the benchmark may import and read: no JAX and no JAX package in
any of its modules, nothing of the program in its reference, and none of
the JAX package's benchmark files."""

import ast
import os
import sys

from raybench import harness
from raybench.tests.conftest import ROOT

HERE = os.path.join(ROOT, "raybench")


def modules(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    """Top-level names of every module `path` imports (relative imports
    resolve inside raybench)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("raybench" if node.level else
                      node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    for path in modules(HERE):
        bad = imported(path) & {"jax", "jaxlib", "flax", "bvh_tpu"}
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path in modules(os.path.join(HERE, "reference")):
        names = imported(path)
        assert "bvh_tpu_torch" not in names, path
        assert names <= {"torch", "__future__", "raybench"}, (path, names)
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                assert not node.module.startswith("raybench.") or \
                    node.module.startswith("raybench.reference"), path


def test_reads_no_jax_benchmark_files():
    for path in modules(HERE):
        if os.sep + "tests" + os.sep in path:
            continue
        with open(path) as f:
            text = f.read()
        for name in ("bench.py", "chip_smoke", "BENCH_r", "/tmp", "/dev/shm"):
            assert name not in text, (path, name)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "bvh_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.core", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "bvh_tpu.core", sys)
    assert harness.forbidden_modules() == ["bvh_tpu", "jax"]
