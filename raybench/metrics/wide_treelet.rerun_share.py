"""Rays rendered again a traced frame, as a share of the frame's rays,
in %: `wide_treelet.rerun_rays` (the rays of every attempt after a
call's first; a re-run renders only the rays past a cap) over
`wide_treelet.rays`, the program's counters. A program that keeps no
such counters leaves nothing to read."""

from raybench import program_trace


def read(ctx):
    share = program_trace.ratio(ctx, "wide_treelet.rerun_rays",
                                "wide_treelet.rays")
    return None if share is None else 100.0 * share
