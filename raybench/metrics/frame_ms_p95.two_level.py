"""`frame_ms_p95` in the cells of a two-level cut, under a bound of its
own, set from those cells' runs (PERF.md section 2)."""

from raybench import harness

read = harness.reader("frame_ms_p95")
