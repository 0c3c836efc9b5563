"""`mrays_s` in the cells of a two-level cut, under a bound of its
own: a two-level render is bound by the device and its runs spread far
less than the host-bound one-level cells', whose bound `mrays_s` keeps."""

from raybench import harness

read = harness.reader("mrays_s")
