"""`wide_treelet.rounds_per_frame` in the cells of a two-level
cut, where it moves `mrays_s.two_level`."""

from raybench import harness

read = harness.reader("wide_treelet.rounds_per_frame")
