"""The window's milliseconds over the scene builds in it."""


def read(ctx):
    if ctx["kind"] != "build":
        return None
    return ctx["window_s"] * 1e3 / len(ctx["durations"])
