"""Reinsertion's share of `build_default` in the traced builds: the
summed time of the program's `bvh.reinsertion` spans over the summed
time of the benchmark's `raybench.build_default` spans, both from the
trace and on its one clock, in per cent."""

from raybench import program_trace, tracing


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "build" or tr is None or not tr.device:
        return None
    whole = sum(op.end - op.start
                for op in tr.spans.get(tracing.SPAN_TREE, [])) / 1e6
    part = program_trace.host_seconds(tr, "bvh.reinsertion",
                                      tracing.SPAN_TREE)
    if whole <= 0 or part <= 0:
        return None
    return 100.0 * part / whole
