"""Reduction of a `torch.profiler` trace (CPU and CUDA activity) to the
numbers the per-layer metrics read.

The benchmark marks its own calls into the program with
`torch.profiler.record_function` spans (`SPAN_*` below). The program
records spans of its own inside those calls while a profiler records
(`bvh_tpu_torch/core/trace.py`); `program_trace.py` reads them. A
`Trace` holds the benchmark's spans by name, the device operations
(kernels, copies and sets), and the host's other events (the program's
spans among them), all on the profiler's one clock, in microseconds.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

SPAN_FRAME = "raybench.frame"          # one frame: the render, then a sync
SPAN_RENDER = "raybench.render"        # the render call alone
SPAN_SCENE = "raybench.scene_build"    # one scene build, synchronised
SPAN_TREE = "raybench.build_default"   # build_default, synchronised
SPAN_CUT = "raybench.build_wide_treelets"
SPAN_REBUILD = "raybench.rebuild_frame"  # a rebuild: build, cut, render
# host runtime calls that block until the device catches up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


# the profiler's own bookkeeping, on either track
NOT_OPS = ("Activity Buffer Request",)


class Op(NamedTuple):
    name: str
    start: float
    end: float


class Trace(NamedTuple):
    spans: dict          # name -> [Op], the benchmark's spans
    device: list         # [Op] device operations, by start
    host: list           # [Op] other host events (aten ops, runtime calls)

    def window(self, span: str):
        """(start, end) from the first `span` to the end of the last."""
        ops = self.spans.get(span, [])
        if not ops:
            return None
        return min(o.start for o in ops), max(o.end for o in ops)

    def device_in(self, span: str) -> list:
        """Device operations that start inside one of the `span`s."""
        spans = sorted(self.spans.get(span, []), key=lambda o: o.start)
        starts = [o.start for o in spans]
        out = []
        for op in self.device:
            i = bisect.bisect_right(starts, op.start) - 1
            if i >= 0 and op.start <= spans[i].end:
                out.append(op)
        return out

    def host_in(self, span: str, names) -> int:
        """Host events named in `names` that start inside one of the
        `span`s."""
        spans = sorted(self.spans.get(span, []), key=lambda o: o.start)
        starts = [o.start for o in spans]
        n = 0
        for op in self.host:
            if op.name not in names:
                continue
            i = bisect.bisect_right(starts, op.start) - 1
            if i >= 0 and op.start <= spans[i].end:
                n += 1
        return n


def from_profiler(prof) -> Trace:
    """A `Trace` of a finished `torch.profiler.profile`, read from its
    raw events (`prof.events()` would build PyTorch's event tree, which
    takes minutes for a traced build)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in events), default=0)
    spans = defaultdict(list)
    device, host = [], []
    for e in events:
        name = e.name()
        op = Op(name, (e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3)
        if e.device_type() == DeviceType.CUDA:
            # the profiler mirrors each span on the device's track as an
            # annotation; only operations count as device work
            if not (name.startswith("raybench.") or name in NOT_OPS):
                device.append(op)
        elif name.startswith("raybench."):
            spans[name].append(op)
        elif name not in NOT_OPS:
            host.append(op)
    device.sort(key=lambda o: o.start)
    host.sort(key=lambda o: o.start)
    return Trace(dict(spans), device, host)


def is_kernel(op: Op) -> bool:
    return "Memcpy" not in op.name and "Memset" not in op.name


def busy_intervals(ops, lo: float, hi: float) -> list:
    """The union of the ops' intervals, clipped to [lo, hi], as sorted
    disjoint (start, end) pairs."""
    out = []
    for op in sorted(ops, key=lambda o: o.start):
        s, e = max(op.start, lo), min(op.end, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_window(trace: Trace, span: str):
    """(busy_s, window_s) over the window of `span`s: the seconds in
    which any device operation ran, and the window's length."""
    w = trace.window(span)
    if w is None:
        return None
    busy = sum(e - s for s, e in busy_intervals(trace.device, *w))
    return busy / 1e6, (w[1] - w[0]) / 1e6


def _innermost(host, times) -> list:
    """For each of the ascending `times`, the name of the latest-starting
    host event that covers it (the innermost, where events nest), by one
    sweep over the events sorted by start."""
    names, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i].start <= t:
            while stack and stack[-1].end <= host[i].start:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        names.append(stack[-1].name if stack else "host (no traced op)")
    return names


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    if name.startswith("void "):
        name = name[5:]
    if "::" in name and name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, 0, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i]
    return name


def breakdown(trace: Trace, span: str, top: int = 10) -> dict:
    """{"device_ops": the device operations that took most time, summed
    by name; "idle_gaps": the device's idle time inside the window of
    `span`s, summed by the innermost host event running at each gap's
    middle}, each [[name, seconds], ...] of at most `top` entries."""
    w = trace.window(span)
    if w is None:
        return {"device_ops": [], "idle_gaps": []}
    by_op = defaultdict(float)
    for op in trace.device:
        if w[0] <= op.start <= w[1]:
            by_op[short_name(op.name)] += (op.end - op.start) / 1e6
    gaps, prev = [], w[0]
    for s, e in busy_intervals(trace.device, *w) + [(w[1], w[1])]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    by_host = defaultdict(float)
    names = _innermost(trace.host, [(s + e) / 2 for s, e in gaps])
    for name, (s, e) in zip(names, gaps):
        by_host[name] += (e - s) / 1e6

    def first(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"device_ops": first(by_op), "idle_gaps": first(by_host)}
