"""Render attempts beyond the first a traced frame: the renders that an
overflowed capacity threw away and ran again at raised caps
(`wide_treelet.attempts` less `wide_treelet.calls`, the program's
counters, over the calls)."""

from raybench import program_trace


def read(ctx):
    c = program_trace.frame_counts(ctx)
    if c is None:
        return None
    calls = c[program_trace.CALLS]
    return (c.get("wide_treelet.attempts", calls) - calls) / calls
