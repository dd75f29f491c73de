"""Entries: the loops that drive a cell's measured window, one file each,
found by the `entry` name of the cell's traffic mix."""
