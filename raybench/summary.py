"""The arithmetic of the end-to-end metrics, on plain lists of
host-clock seconds."""

from __future__ import annotations

import statistics


def rate(work: float, seconds: float) -> float:
    """Work a second over the whole window."""
    return work / seconds


def percentile(values, q: int) -> float:
    """The q-th percentile (1-99) by `statistics.quantiles`' inclusive
    method (linear between order statistics, the ends included)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]

