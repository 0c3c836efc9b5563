"""(ray, treelet) pairs a pair round, the work of one B1 launch
(`wide_treelet.pairs` over `wide_treelet.rounds`, the program's
counters, over the traced frames)."""

from raybench import program_trace


def read(ctx):
    return program_trace.ratio(ctx, "wide_treelet.pairs",
                               "wide_treelet.rounds")
