"""Seconds from the start of the run until the window opens."""


def read(ctx):
    return ctx["setup_s"]
