"""Host-blocking runtime calls (stream, device and event synchronize,
blocking copies) inside the render call of a traced frame; the
benchmark's own synchronize after the call is not counted."""

from raybench import tracing


def read(ctx):
    tr = ctx.get("trace")
    frames = len(tr.spans.get(tracing.SPAN_RENDER, [])) if tr else 0
    if ctx["kind"] != "render" or not frames or not tr.device:
        return None
    return tr.host_in(tracing.SPAN_RENDER, tracing.SYNC_CALLS) / frames
