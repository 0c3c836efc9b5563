"""The program's own spans and counters (`bvh_tpu_torch.core.trace`), as
the per-layer metrics read them from a trace run on the card.

The program records them while a torch profiler records, so in a trace
run they hold exactly the traced window. A program without them (a
checkout from before they were added) leaves nothing to read: each
function here then returns None and raises nothing.
"""

from __future__ import annotations

import importlib

from raybench import tracing

CALLS = "wide_treelet.calls"


def counters():
    """The program's counters, or None where it keeps none."""
    try:
        trace = importlib.import_module("bvh_tpu_torch.core.trace")
    except ImportError:
        return None
    return trace.counts()


def frame_counts(ctx):
    """The program's counters over a render trace run's traced frames, or
    None: outside a render trace run on the card (a CPU rehearsal reports
    no per-layer metric), where the program keeps no counters or counted
    no render call, and where its render calls differ from the traced
    frames, since then the counters do not hold the traced window."""
    tr = ctx.get("trace")
    if ctx["kind"] != "render" or tr is None or not tr.device:
        return None
    c = counters()
    if not c or not c.get(CALLS):
        return None
    if c[CALLS] != len(tr.spans.get(tracing.SPAN_FRAME, [])):
        return None
    return c


def ratio(ctx, num: str, den: str):
    """Counter `num` over counter `den` in a render trace run, or None
    where `frame_counts` finds nothing or `den` is 0."""
    c = frame_counts(ctx)
    if c is None or not c.get(den):
        return None
    return c.get(num, 0) / c[den]


def host_seconds(trace: tracing.Trace, name: str, within: str) -> float:
    """Summed seconds of the host events `name` (the program's spans are
    host events of the trace) that start inside one of the spans
    `within`."""
    spans = trace.spans.get(within, [])
    return sum(op.end - op.start for op in trace.host
               if op.name == name and any(s.start <= op.start <= s.end
                                          for s in spans)) / 1e6
