"""The port's renderer CLI against bvh_tpu's, on the CPU: the golden
Cornell box (tests/golden/cornell.obj, 36 triangles) at 64x64 from the
reference's test camera, for `-q high -p --robust-traversal`, `-q low`
and `-q med -m debug`. Both print the same node, intersection and
traversal counts and write byte-identical PPMs; an empty or missing OBJ
exits 1 with the reference's message.

bvh_tpu's CLI runs its wavefront on the CPU under XLA, which contracts
a*b+c into FMAs (ROADMAP C5); the port's runs are given that rounding
(`xla_rounding`), which makes their builds and hits bit-identical. Each
bvh_tpu run happens once per module (its first runs compile for tens of
seconds).
"""

import contextlib
import io
import os

import pytest

from bvh_tpu.cli import benchmark as jcli
from bvh_tpu_torch.cli import benchmark as tcli
from test_torch_build import xla_rounding  # noqa: F401 - fixture

OBJ = os.path.join(os.path.dirname(__file__), "golden", "cornell.obj")
CAMERA = ["--eye", "0", "1", "2", "--dir", "0", "0", "-1", "--up", "0", "1",
          "0", "-w", "64", "--height", "64"]
CASES = {
    "high_p_robust": ["-q", "high", "-p", "--robust-traversal"],
    "low": ["-q", "low"],
    "med_debug": ["-q", "med", "-m", "debug"],
}


def _counts(out: str) -> list[str]:
    """The printed lines with their timings cut off."""
    return [line.split(" in ")[0] for line in out.splitlines()
            if not line.startswith("Image saved")]


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """bvh_tpu's CLI on every case: (printed counts, PPM bytes)."""
    d = tmp_path_factory.mktemp("jcli")
    out = {}
    for name, flags in CASES.items():
        path = str(d / f"{name}.ppm")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jcli.main([OBJ, *CAMERA, *flags, "-o", path]) == 0
        with open(path, "rb") as f:
            out[name] = (_counts(buf.getvalue()), f.read())
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_matches_bvh_tpu(reference_runs, name, tmp_path, capsys,
                             xla_rounding):
    path = str(tmp_path / "port.ppm")
    assert tcli.main([OBJ, *CAMERA, *CASES[name], "-o", path,
                      "--device", "cpu"]) == 0
    counts = _counts(capsys.readouterr().out)
    want_counts, want_ppm = reference_runs[name]
    assert counts == want_counts
    assert counts[0] == "Loaded file with 36 triangle(s)"
    assert int(counts[2].split()[0]) > 1000  # intersections at 64x64
    with open(path, "rb") as f:
        assert f.read() == want_ppm


def test_cli_run_reports_the_cpu_path(tmp_path, capsys):
    """`run` takes the wavefront on the CPU and returns what it drew."""
    from bvh_tpu_torch.io.obj import load_obj

    args = tcli.parser().parse_args(
        [OBJ, *CAMERA, "-o", str(tmp_path / "a.ppm"), "--device", "cpu"])
    res = tcli.run(*load_obj(OBJ), args)
    assert res.path == "wavefront" and res.tl is None
    assert res.image.shape == (64, 64, 3)
    assert int(res.hit.hit.sum()) == int(
        capsys.readouterr().out.splitlines()[1].split()[0])


@pytest.mark.parametrize("content", [None, "# no faces\nv 0 0 0\n"])
def test_cli_empty_obj_exits_1(tmp_path, capsys, content):
    path = tmp_path / "scene.obj"
    if content is not None:
        path.write_text(content)
    for cli in (tcli, jcli):
        assert cli.main([str(path), "-o", str(tmp_path / "x.ppm")]) == 1
        err = capsys.readouterr().err
        assert err.strip() == "No triangle was found in input OBJ file"
