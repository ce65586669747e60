"""Milliseconds a training step that the card sat idle while the calling
thread was inside `train.backward`: each gap of the span pass
(harness/spans.py) put down to the spans open on that thread at its
midpoint."""

from perfbench.harness.spans import during_trace, ms_inside, per_root  # noqa: F401


def read(run):
    return per_root(run, "train.step", lambda att: ms_inside(att["idle"], "train.backward"))
