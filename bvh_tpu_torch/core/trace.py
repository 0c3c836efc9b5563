"""The program's spans and counters, on exactly while a torch profiler
records (`torch.profiler.profile`).

A span is a function-scope range (`_RecordFunctionFast`), so it lands in
the profiler's trace on the host's track and on the profiler's clock.
`torch.profiler.record_function` is not used: it opens a user range,
which the profiler mirrors onto the device's track as an annotation, so
a trace reader would take it for device work. A counter adds a host int
the program already holds; the counts live in memory, for the caller
to read when its trace ends. With no profiler recording, a span is one
shared null context and a counter does nothing: each costs one flag
test. Neither reads the device, synchronises or launches anything.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()
_counts: dict = {}
_lock = threading.Lock()


def on() -> bool:
    """Whether a torch profiler is recording: the only switch."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A context that records one span named `name` while `on()`."""
    return _RecordFunctionFast(name) if on() else _OFF


def spanned(name: str):
    """Decorate a function to run inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int) -> None:
    """Add the host int `n` to the counter `name` while `on()`."""
    if on():
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def counts() -> dict:
    """A copy of every counter: its sum over all the time `on()` held."""
    with _lock:
        return dict(_counts)
