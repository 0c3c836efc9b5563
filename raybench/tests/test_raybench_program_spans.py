"""The metrics that read the program's own spans and counters
(`raybench/program_trace.py`), on hand-made traces and counter dicts,
with the cases where each has nothing to read."""

import sys

import pytest

from raybench import harness, program_trace, tracing
from raybench.tracing import Op, Trace

RENDER = ("wide_treelet.rerenders_per_frame",
          "wide_treelet.rounds_per_frame", "wide_treelet.pairs_per_round")
TWO_LEVEL = tuple(n + ".two_level" for n in RENDER) + (
    "wide_treelet.a2_rounds_per_frame.two_level",)


def frames(n: int) -> Trace:
    """`n` traced frames of 10 us with one device op each."""
    spans = {tracing.SPAN_FRAME: [Op(tracing.SPAN_FRAME, 20 * i, 20 * i + 10)
                                  for i in range(n)]}
    device = [Op("kernA", 20 * i + 1, 20 * i + 2) for i in range(n)]
    return Trace(spans, device, [])


def counts(calls=4, attempts=5, rounds=40, pairs=1000, a2_rounds=12):
    return {"wide_treelet.calls": calls, "wide_treelet.attempts": attempts,
            "wide_treelet.rounds": rounds, "wide_treelet.pairs": pairs,
            "wide_treelet.a2_rounds": a2_rounds}


@pytest.fixture
def program(monkeypatch):
    """Stand in for the program's counters: set `program.counts`."""
    state = {"counts": counts()}
    monkeypatch.setattr(program_trace, "counters", lambda: state["counts"])
    return state


def read_all(ctx, names=RENDER + TWO_LEVEL):
    return {n: harness.reader(n)(dict(ctx)) for n in names}


def test_counter_metrics(program):
    got = read_all(dict(kind="render", trace=frames(4)))
    assert got["wide_treelet.rerenders_per_frame"] == pytest.approx(0.25)
    assert got["wide_treelet.rounds_per_frame"] == pytest.approx(10.0)
    assert got["wide_treelet.pairs_per_round"] == pytest.approx(25.0)
    assert got["wide_treelet.a2_rounds_per_frame.two_level"] == \
        pytest.approx(3.0)
    for name in RENDER:
        assert got[name + ".two_level"] == got[name]
    # rounds x pairs a round = pairs a frame
    assert got["wide_treelet.rounds_per_frame"] * \
        got["wide_treelet.pairs_per_round"] == pytest.approx(1000 / 4)


@pytest.mark.parametrize("case", [
    "build kind", "no trace", "no device op", "no calls",
    "calls differ from frames", "no counters", "no program module"])
def test_counter_metrics_find_nothing(program, monkeypatch, case):
    ctx = dict(kind="render", trace=frames(4))
    if case == "build kind":
        ctx["kind"] = "build"
    elif case == "no trace":
        ctx.pop("trace")
    elif case == "no device op":
        ctx["trace"] = frames(4)._replace(device=[])
    elif case == "no calls":
        program["counts"] = counts(calls=0, attempts=0, rounds=0, pairs=0)
    elif case == "calls differ from frames":
        ctx["trace"] = frames(3)
    elif case == "no counters":
        program["counts"] = {}
    else:                        # a checkout whose program has no trace
        monkeypatch.undo()
        monkeypatch.setitem(sys.modules, "bvh_tpu_torch.core.trace", None)
        assert program_trace.counters() is None
    assert set(read_all(ctx).values()) == {None}


def test_pairs_per_round_without_rounds(program):
    program["counts"] = counts(rounds=0, pairs=0)
    got = read_all(dict(kind="render", trace=frames(4)))
    assert got["wide_treelet.pairs_per_round"] is None
    assert got["wide_treelet.rounds_per_frame"] == 0.0


def build_trace(device=True, reinsertion=True) -> Trace:
    """Two traced builds: build_default over [0, 100] and [200, 260] us,
    reinsertion [30, 90] and [220, 250] inside them, and one outside."""
    spans = {tracing.SPAN_SCENE: [Op(tracing.SPAN_SCENE, 0, 150),
                                  Op(tracing.SPAN_SCENE, 200, 300)],
             tracing.SPAN_TREE: [Op(tracing.SPAN_TREE, 0, 100),
                                 Op(tracing.SPAN_TREE, 200, 260)]}
    host = [Op("bvh.build_default", 1, 99), Op("aten::add", 5, 6),
            Op("bvh.reinsertion.iteration", 31, 50),
            Op("bvh.build_default", 201, 259)]
    if reinsertion:
        host += [Op("bvh.reinsertion", 30, 90),
                 Op("bvh.reinsertion", 220, 250),
                 Op("bvh.reinsertion", 400, 450)]    # outside every build
    ops = [Op("kernA", 10, 20)] if device else []
    return Trace(spans, ops, sorted(host, key=lambda o: o.start))


def test_reinsertion_share():
    read = harness.reader("build.reinsertion_share")
    assert read(dict(kind="build", trace=build_trace())) == \
        pytest.approx(100.0 * (60 + 30) / (100 + 60))
    assert read(dict(kind="render", trace=build_trace())) is None
    assert read(dict(kind="build")) is None
    assert read(dict(kind="build", trace=build_trace(device=False))) is None
    assert read(dict(kind="build",
                     trace=build_trace(reinsertion=False))) is None
