"""The 95th percentile of every frame's host-clock time in the window."""

from raybench import summary


def read(ctx):
    if ctx["kind"] != "render":
        return None
    return summary.percentile(ctx["durations"], 95) * 1e3
