"""Frames whose class maps completed in the window, over its seconds."""

from perfbench.harness.readers import rate as read  # noqa: F401
