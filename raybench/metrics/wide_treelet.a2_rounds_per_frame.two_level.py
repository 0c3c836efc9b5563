"""Phase A2's rounds a traced frame in a two-level cut, over every
attempt (`wide_treelet.a2_rounds` over `wide_treelet.calls`, the
program's counters). On the card the entry point expands every ray's
supers in one launch of the super walk an attempt, and counts that
launch as one round; on the CPU, and in `render_at_caps`, a round is
one B4 launch over K2 supers of every ray with a super left, and a
merge of their portals."""

from raybench import program_trace


def read(ctx):
    return program_trace.ratio(ctx, "wide_treelet.a2_rounds",
                               program_trace.CALLS)
