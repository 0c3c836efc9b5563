"""The window's milliseconds over the rebuild frames in it."""


def read(ctx):
    if ctx["kind"] != "rebuild":
        return None
    return ctx["window_s"] * 1e3 / len(ctx["durations"])
