"""Mean host-clock milliseconds of `build_wide_treelets` (with the
precomputed triangle rows it takes, synchronised) over the rebuild
frames of a trace run's `plain_steps`, which run before the profiler
starts (none of the profiled frames)."""

from raybench import tracing


def read(ctx):
    spans = ctx["spans"].get(tracing.SPAN_CUT)
    if ctx["kind"] != "rebuild" or not spans or ctx.get("trace") is None:
        return None
    return sum(spans) / len(spans) * 1e3
