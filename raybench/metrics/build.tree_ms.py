"""Mean host-clock milliseconds of `build_default` (boxes, centres and
the quality-high build, synchronised) over the builds of a trace run's
`plain_steps`, which run before the profiler starts (none of the
profiled builds)."""

from raybench import tracing


def read(ctx):
    spans = ctx["spans"].get(tracing.SPAN_TREE)
    if ctx["kind"] != "build" or not spans or ctx.get("trace") is None:
        return None
    return sum(spans) / len(spans) * 1e3
