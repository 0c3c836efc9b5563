"""The arithmetic of the metrics on synthetic frame times and a
synthetic trace, and the roofline's counts from shapes."""

import statistics

import pytest

from raybench import counts, harness, summary, tracing
from raybench.tracing import Op, Trace


def test_rate_and_percentile():
    times = [0.010] * 95 + [0.050] * 5
    assert summary.rate(1_048_576 * 100, 2.0) == pytest.approx(52_428_800)
    assert summary.percentile(times, 95) == pytest.approx(
        statistics.quantiles(times, n=100, method="inclusive")[94])
    assert summary.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 50) == 3.0
    assert summary.percentile([7.0], 95) == 7.0


def synthetic():
    """Two frames of 10 us each; in each, two device ops and one host
    sync inside the render span; the profiler's mirror of a span on the
    device track is left out by `from_profiler`, so it is not here."""
    spans = {
        tracing.SPAN_FRAME: [Op(tracing.SPAN_FRAME, 0, 10),
                             Op(tracing.SPAN_FRAME, 20, 30)],
        tracing.SPAN_RENDER: [Op(tracing.SPAN_RENDER, 0, 9),
                              Op(tracing.SPAN_RENDER, 20, 29)],
    }
    device = [Op("kernA", 1, 3), Op("Memset (Device)", 2, 4),
              Op("kernA", 21, 23), Op("kernB", 22, 26),
              Op("kernC", 40, 41)]          # after the window
    host = [Op("aten::sort", 0, 8), Op("cudaStreamSynchronize", 5, 6),
            Op("cudaDeviceSynchronize", 9.5, 10),   # the harness's own
            Op("aten::nonzero", 20, 29), Op("cudaStreamSynchronize", 24, 25),
            Op("aten::add", 10, 20)]
    return Trace(spans, device, sorted(host, key=lambda o: o.start))


def test_trace_reduction():
    tr = synthetic()
    busy, window = tracing.busy_window(tr, tracing.SPAN_FRAME)
    assert window == pytest.approx(30e-6)
    assert busy == pytest.approx((3 + 5) * 1e-6)      # [1,4] and [21,26]
    assert len(tr.device_in(tracing.SPAN_FRAME)) == 4
    assert tr.host_in(tracing.SPAN_RENDER, tracing.SYNC_CALLS) == 2
    bd = tracing.breakdown(tr, tracing.SPAN_FRAME)
    assert bd["device_ops"][0] == ["kernA", pytest.approx(4e-6)]
    gaps = dict(bd["idle_gaps"])
    # [0,1], [4,21], [26,30] idle: the innermost host op at each middle
    assert gaps["aten::sort"] == pytest.approx(1e-6)
    assert gaps["aten::add"] == pytest.approx(17e-6)
    assert gaps["aten::nonzero"] == pytest.approx(4e-6)
    assert sum(gaps.values()) == pytest.approx(window - busy)


def test_short_kernel_names():
    assert tracing.short_name(
        "void at::native::sortKV<2, float>(at::TensorInfo<float, int>, bool)"
    ) == "at::native::sortKV<2, float>"
    assert tracing.short_name("(anonymous namespace)::collect_kernel("
                              "float const*, int)") == \
        "(anonymous namespace)::collect_kernel"
    assert tracing.short_name("Memcpy DtoD (Device -> Device)") == \
        "Memcpy DtoD (Device -> Device)"


def ctx_of(trace, **kw):
    return dict(kind="render", trace=trace, spans={},
                peak={"bytes_per_s": 3.35e12, "flops_per_s": 67e12},
                work=counts.render_work(1024, 3000, 4096), **kw)


def test_render_readers_on_a_synthetic_trace():
    ctx = ctx_of(synthetic())
    read = {n: harness.reader(n)(ctx) for n in (
        "wide_treelet.launches_per_frame", "wide_treelet.syncs_per_frame",
        "device.idle_share.render", "kernels.render_roofline",
        "device.idle_share.build", "build.tree_ms")}
    assert read["wide_treelet.launches_per_frame"] == 2.0
    assert read["wide_treelet.syncs_per_frame"] == 1.0
    assert read["device.idle_share.render"] == pytest.approx(
        100 * (1 - 8 / 30))
    least = counts.least_seconds(ctx["work"], ctx["peak"])
    kernel_s = (2 + 2 + 4) * 1e-6 / 2          # kernels, no memset
    assert read["kernels.render_roofline"] == pytest.approx(
        100 * least / kernel_s)
    assert read["device.idle_share.build"] is None
    assert read["build.tree_ms"] is None
    for name in ("wide_treelet.launches_per_frame",
                 "wide_treelet.syncs_per_frame", "device.idle_share.render"):
        assert harness.reader(name + ".two_level")(ctx) == read[name]
    assert harness.reader("kernels.two_level_render_roofline")(ctx) == \
        read["kernels.render_roofline"]


def test_readers_return_nothing_without_a_device_trace():
    empty = Trace({tracing.SPAN_FRAME: [Op(tracing.SPAN_FRAME, 0, 10)],
                   tracing.SPAN_RENDER: [Op(tracing.SPAN_RENDER, 0, 9)]},
                  [], [Op("aten::add", 0, 9)])
    ctx = ctx_of(empty)
    for n in ("wide_treelet.launches_per_frame",
              "wide_treelet.syncs_per_frame", "device.idle_share.render",
              "kernels.render_roofline"):
        assert harness.reader(n)(ctx) is None, n
    assert harness.reader("kernels.render_roofline")(
        dict(ctx_of(synthetic()), peak=None)) is None


def test_end_to_end_readers():
    ctx = dict(kind="render", window_s=2.0, setup_s=3.5,
               durations=[0.02] * 99 + [0.1], done=[1_048_576] * 100)
    assert harness.reader("mrays_s")(ctx) == pytest.approx(
        100 * 1_048_576 / 2.0 / 1e6)
    assert harness.reader("frame_ms_p95")(ctx) == pytest.approx(20.0)
    for name in ("mrays_s", "frame_ms_p95"):
        assert harness.reader(name + ".two_level")(ctx) == \
            harness.reader(name)(ctx)
    assert harness.reader("setup_s")(ctx) == 3.5
    assert harness.reader("scene_build_ms")(ctx) is None
    build = dict(kind="build", window_s=3.0, durations=[1.0] * 3,
                 spans={tracing.SPAN_TREE: [0.8, 0.9],
                        tracing.SPAN_CUT: [0.2, 0.1]}, trace=synthetic())
    assert harness.reader("scene_build_ms")(build) == pytest.approx(1000.0)
    assert harness.reader("build.tree_ms")(build) == pytest.approx(850.0)
    assert harness.reader("wide_treelet.cut_ms")(build) == pytest.approx(150.0)
    assert harness.reader("mrays_s")(build) is None


def test_roofline_counts_from_shapes():
    w = counts.render_work(1_048_576, 262_144, 43_745_280)
    assert w["bytes"] == 1_048_576 * 48 + 262_144 * 48 + 43_745_280
    assert w["flops"] == 1_048_576 * counts.TEST_FLOPS
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    assert peak == {"source": peak["source"], "bytes_per_s": 3.35e12,
                    "flops_per_s": 67e12}
    assert counts.least_seconds(w, peak) == pytest.approx(
        w["bytes"] / 3.35e12)                 # the bytes bound
    assert counts.peaks("cpu") is None


@pytest.mark.parametrize("plain", [0, 3])
def test_span_metrics_read_only_untraced_steps(monkeypatch, plain):
    """`build.tree_ms` and `wide_treelet.cut_ms` read the spans of the
    `plain_steps` that run before the profiler, never a profiled step's;
    without `plain_steps` only the profiled steps run."""
    profiling = {"on": False}

    def fake_profiled(fn):
        profiling["on"] = True
        try:
            return fn(), synthetic()
        finally:
            profiling["on"] = False

    def step(i, spans):
        seconds = 9.0 if profiling["on"] else 1.0
        spans[tracing.SPAN_TREE].append(seconds)
        spans[tracing.SPAN_CUT].append(seconds / 2)
        return 1, None

    monkeypatch.setattr(harness, "profiled", fake_profiled)
    traffic = {"trace": {"steps": 2, "plain_steps": plain}}
    ctx = {"kind": "build", "spans": {}}
    win = harness.Window(0, 0)
    harness.measure(step, win, traffic, 0.0, True, ctx)
    assert len(win.durations) == 2 and win.spans[tracing.SPAN_TREE] == [9.0] * 2
    tree_ms = harness.reader("build.tree_ms")(ctx)
    cut_ms = harness.reader("wide_treelet.cut_ms")(ctx)
    if plain:
        assert ctx["spans"][tracing.SPAN_TREE] == [1.0] * plain
        assert (tree_ms, cut_ms) == (1000.0, 500.0)
    else:
        assert (tree_ms, cut_ms) == (None, None)


def test_window_reservoir_keeps_a_seeded_sample():
    def run(seed):
        win = harness.Window(3, seed)
        for i in range(50):
            win.durations.append(0.0)
            win.offer(i)
        return win.kept

    assert run(5) == run(5) and len(run(5)) == 3
    assert run(5) != run(6)
