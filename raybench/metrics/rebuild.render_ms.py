"""Mean host-clock milliseconds of a rebuild frame's render call
(`wide_treelet_intersect_tris` on the tree built that frame, then a
synchronize) over the frames of a trace run's `plain_steps`, which run
before the profiler starts (none of the profiled frames)."""

from raybench import tracing


def read(ctx):
    spans = ctx["spans"].get(tracing.SPAN_FRAME)
    if ctx["kind"] != "rebuild" or not spans or ctx.get("trace") is None:
        return None
    return sum(spans) / len(spans) * 1e3
