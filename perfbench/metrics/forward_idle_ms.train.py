"""Milliseconds a training step that the card sat idle while the calling
thread was inside the model's forward, `train.forward`: each gap of the
span pass (harness/spans.py) put down to the spans open on that thread at
its midpoint. It is the host launching the forward's small ops, train-mode
BN's most of all, slower than the card runs them, and it holds the
spans' own host time there (PERF.md)."""

from perfbench.harness.spans import during_trace, ms_inside, per_root  # noqa: F401


def read(run):
    return per_root(run, "train.step", lambda att: ms_inside(att["idle"], "train.forward"))
