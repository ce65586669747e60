"""Crops of every step in the window, over its seconds; the window ends
when the last step's loss is read."""

from perfbench.harness.readers import rate as read  # noqa: F401
