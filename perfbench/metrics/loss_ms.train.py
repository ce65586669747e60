"""Device milliseconds a training step launched inside the loss: its
forward (`train.loss`: K2, the OHEM sorts, the BCE and the boundary-aware
CE) and its backward (`train.loss.backward`: K3 and the rest), from the
program's spans beside the span pass's device trace (harness/spans.py)."""

from perfbench.harness.spans import during_trace, ms_inside, per_root  # noqa: F401


def read(run):
    return per_root(run, "train.step",
                    lambda att: ms_inside(att["launched"], "train.loss", "train.loss.backward"))
