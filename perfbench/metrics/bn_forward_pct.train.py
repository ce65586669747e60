"""100 x the device milliseconds launched inside the train-mode BNs'
forward (`bn`) over those launched inside `train.step`, in the span pass
(harness/spans.py). The BNs' backward, twice their forward's device time,
is not counted: it is no span of its own, since its ~440 autograd hooks a
step cost the host far more than the rest of the spans (PERF.md), so it
falls inside `train.backward`."""

from perfbench.harness.spans import attribution, during_trace, ms_inside  # noqa: F401


def read(run):
    att = attribution(run)
    if att is None:
        return None
    step = ms_inside(att["launched"], "train.step")
    if not step:
        return None
    return 100.0 * ms_inside(att["launched"], "bn") / step
