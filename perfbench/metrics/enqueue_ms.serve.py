"""Host milliseconds from a call's start to its return, before the wait
for its map; the mean over the window's calls."""

from perfbench.harness.readers import mean_enqueue_ms as read  # noqa: F401
