"""Device milliseconds a training step launched inside the model's heads:
their forward (`model.head`: each head's 3x3 conv+BN+ReLU, its biased 1x1
conv and, in a model that upsamples inside, the resize to the input's
size) and their backward (`model.head.backward`), from the program's
spans beside the span pass's device trace (harness/spans.py). None where
nothing was launched inside either span, as in a program whose model
opens neither."""

from perfbench.harness.spans import attribution, during_trace, ms_inside, per_root  # noqa: F401

SPANS = frozenset({"model.head", "model.head.backward"})


def read(run):
    att = attribution(run)
    if att is None or not any(inside & SPANS for _, inside in att["launched"]):
        return None
    return per_root(run, "train.step", lambda a: ms_inside(a["launched"], *SPANS))
