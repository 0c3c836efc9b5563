"""The 95th percentile of every rebuild frame's host-clock time in the
window."""

from raybench import summary


def read(ctx):
    if ctx["kind"] != "rebuild":
        return None
    return summary.percentile(ctx["durations"], 95) * 1e3
