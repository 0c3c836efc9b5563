"""`wide_treelet.rerun_share` in the cells of a two-level cut, where it
moves `frame_ms_p95.two_level`."""

from raybench import harness

read = harness.reader("wide_treelet.rerun_share")
