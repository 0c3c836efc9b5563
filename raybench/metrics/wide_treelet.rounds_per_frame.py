"""Pair rounds of the render driver a traced frame, over every attempt
(`wide_treelet.rounds` over `wide_treelet.calls`, the program's
counters): each round is a ready check, a pair list, a B1 launch and a
merge."""

from raybench import program_trace


def read(ctx):
    return program_trace.ratio(ctx, "wide_treelet.rounds",
                               program_trace.CALLS)
