"""Timing, value guards and printing shared by the profiling tools.

On a CUDA device a time is taken with CUDA events, after a warm-up; on
the CPU with `time.perf_counter`. A `queued` time gives the stream a
head start (a spin of about a millisecond) before each call, so the
call's work waits in the queue and the events time the device alone,
not the host's launch overhead. Every timed loop hands its last
output to `guard`, which compares it by value with the verified output:
a loop that computed something else raises instead of reporting a time.
"""

from __future__ import annotations

import statistics
import subprocess
import time
import warnings

import torch

# the stream's head start before a queued call, in clock cycles (about
# 1.1 ms at the H100's 1.755 GHz boost clock)
HEAD_START_CYCLES = 2_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def device_line(device) -> str:
    """What a time was taken on: the card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    gives them, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bits(x: torch.Tensor) -> torch.Tensor:
    """Float tensors as their integer bits, so that equality is
    bitwise (-0.0 and NaN payloads count)."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.view(torch.int16)
    if x.dtype == torch.float64:
        return x.view(torch.int64)
    return x


def same(a, b) -> bool:
    """Bitwise equality of two tensors or (nested) tuples of tensors and
    plain values."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape
                and a.dtype == b.dtype and bool(torch.equal(bits(a), bits(b))))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def guard(name: str, out, ref) -> None:
    """Raise unless `out` equals the verified `ref` bit for bit."""
    if not same(out, ref):
        raise AssertionError(f"{name}: the timed output differs from the "
                             "verified one")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _one_call(fn, device, queued: bool = False) -> tuple[float, object]:
    """ms of one call of `fn`: CUDA events around it on a CUDA device
    (host gaps included; `queued` behind a head start when asked),
    perf_counter on the CPU."""
    if torch.device(device).type == "cuda":
        if queued:
            torch.cuda._sleep(HEAD_START_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def time_calls(fn, device, n: int = 5,
               queued: bool = False) -> tuple[float, object]:
    """Median ms of n calls of `fn` after one warm-up, each call timed on
    its own (CUDA events on a CUDA device, `queued` behind a head start
    when asked; perf_counter on the CPU). Returns (median ms, the last
    call's output)."""
    out = fn()
    sync(device)
    ts = []
    for _ in range(n):
        ms, out = _one_call(fn, device, queued)
        ts.append(ms)
    return statistics.median(ts), out


def first_then_median(name: str, fn, device,
                      reps: int) -> tuple[float, float, object]:
    """(ms of the first call, median ms of `reps` calls after it, the
    first call's output), each call timed on its own as `time_calls`
    does. The first call is reported apart: it holds the kernels' build
    and first use. Every later call's output is guarded against the
    first's."""
    sync(device)
    first_ms, ref = _one_call(fn, device)
    ts = []
    out = ref
    for _ in range(reps):
        ms, out = _one_call(fn, device)
        ts.append(ms)
    guard(name, out, ref)
    return first_ms, statistics.median(ts) if ts else first_ms, ref


def sm_clock_mhz(fn, ms_per_call: float, busy_ms: float = 400.0) -> float:
    """The SM clock (MHz) that nvidia-smi reads while the card runs
    `fn`: about `busy_ms` of calls are queued, the clock is read while
    they run, then the stream is drained."""
    n = max(1, int(busy_ms / max(ms_per_call, 1e-3)))
    torch.cuda.synchronize()
    for _ in range(n):
        fn()
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    torch.cuda.synchronize()
    return mhz


def timed(name: str, fn, ref, device, n: int = 5,
          queued: bool = False) -> float:
    """`time_calls`, with the last output guarded against `ref`."""
    ms, out = time_calls(fn, device, n, queued)
    guard(name, out, ref)
    return ms


class StageTimer:
    """A stage runner (`core.utils.run_stage`'s signature: the render,
    the mini-tree build, a reinsertion iteration) that times every call
    by stage name: CUDA events around
    the call on a CUDA device, so a stage's time is the stream's time
    from the call's start to its end, host waits included; perf_counter
    on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._marks: list[tuple[str, object, object]] = []

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def __call__(self, name, fn, *args, **kwargs):
        start = self._mark()
        out = fn(*args, **kwargs)
        self._marks.append((name, start, self._mark()))
        return out

    def totals(self) -> dict[str, tuple[float, int]]:
        """{stage: (ms summed over its calls, calls)}, in first-call
        order; clears the marks."""
        if self.cuda:
            torch.cuda.synchronize()
        out: dict[str, tuple[float, int]] = {}
        for name, a, b in self._marks:
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            t, c = out.get(name, (0.0, 0))
            out[name] = (t + ms, c + 1)
        self._marks.clear()
        return out


class SyncCounter:
    """A stage runner that counts each stage's host syncs by stage name:
    the calls that make the host wait for the card (a tensor read as a
    Python value, a copy to the host, `nonzero`, ...), as
    `torch.cuda.set_sync_debug_mode` reports them. A stage run inside
    another is counted apart from it. On the CPU nothing waits for a
    device and `counts` stays empty."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.counts: dict[str, int] = {}

    def __call__(self, name, fn, *args, **kwargs):
        if not self.cuda:
            return fn(*args, **kwargs)
        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        n = sum("synchroniz" in str(w.message) for w in seen)
        self.counts[name] = self.counts.get(name, 0) + n
        return out
