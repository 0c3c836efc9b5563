"""`device.idle_share.render` in the cells of a two-level cut, where it
moves `mrays_s.two_level`."""

from raybench import harness

read = harness.reader("device.idle_share.render")
