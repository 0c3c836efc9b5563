"""The least time of a frame's work (`counts.render_work` over the
card's peaks) over the frame's summed kernel time on the device, in
per cent."""

from raybench import counts, tracing


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "render" or not tr or ctx.get("peak") is None:
        return None
    frames = len(tr.spans.get(tracing.SPAN_FRAME, []))
    kernel_us = sum(op.end - op.start for op in tr.device_in(tracing.SPAN_FRAME)
                    if tracing.is_kernel(op))
    if not frames or kernel_us <= 0:
        return None
    least = counts.least_seconds(ctx["work"], ctx["peak"])
    return 100.0 * least / (kernel_us / 1e6 / frames)
