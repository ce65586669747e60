"""Device milliseconds a serving call launched inside the model's forward
(`serve.model`), from the program's spans beside the span pass's device trace
(harness/spans.py)."""

from perfbench.harness.spans import during_trace, ms_inside, per_root  # noqa: F401


def read(run):
    return per_root(run, "serve.call", lambda att: ms_inside(att["launched"], "serve.model"))
