"""Mean host-clock milliseconds of `build_wide_treelets` (with the
precomputed triangle rows it takes, synchronised) over the builds of a
trace run's `plain_steps`, which run before the profiler starts (none
of the profiled builds)."""

from raybench import tracing


def read(ctx):
    spans = ctx["spans"].get(tracing.SPAN_CUT)
    if ctx["kind"] != "build" or not spans or ctx.get("trace") is None:
        return None
    return sum(spans) / len(spans) * 1e3
