"""Rays traced in the window over the window's seconds, in millions."""

from raybench import summary


def read(ctx):
    if ctx["kind"] != "render":
        return None
    return summary.rate(sum(ctx["done"]), ctx["window_s"]) / 1e6
