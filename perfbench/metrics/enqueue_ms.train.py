"""Host milliseconds from a step's start to its return (the step does not
wait for the card); the mean over the window's steps."""

from perfbench.harness.readers import mean_enqueue_ms as read  # noqa: F401
