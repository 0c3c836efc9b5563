"""Device operations (kernels, copies, sets) a traced frame."""

from raybench import tracing


def read(ctx):
    tr = ctx.get("trace")
    frames = len(tr.spans.get(tracing.SPAN_FRAME, [])) if tr else 0
    if ctx["kind"] != "render" or not frames or not tr.device:
        return None
    return len(tr.device_in(tracing.SPAN_FRAME)) / frames
