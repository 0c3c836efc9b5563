"""1 minus the union of the device's busy intervals over the traced
rebuild frames' window, in per cent."""

from raybench import tracing


def read(ctx):
    tr = ctx.get("trace")
    bw = tracing.busy_window(tr, tracing.SPAN_REBUILD) if tr else None
    if ctx["kind"] != "rebuild" or not bw or not tr.device:
        return None
    busy, window = bw
    return 100.0 * (1.0 - busy / window)
