"""`heads_ms.train` on hand-built traces: the device ms launched inside the
heads' forward and backward spans, per step, and nothing where the model
opens neither span."""

import math
from types import SimpleNamespace

import pytest

from perfbench.harness import manifest
from perfbench.harness import spans as S
from perfbench.tests.test_perfbench_spans import (ENGINE, ENGINE_CALLS, MAIN, _launch, _run,
                                                  _span, _work)


def _read(run):
    return manifest.reader("heads_ms.train").read(run)


def _steps(heads: bool):
    """Two steps, 1000 us apart: the heads' forward (with a BN inside it)
    launches 30 + 10 us, and two of the heads' backward spans on the
    engine's thread launch 20 and 15 us, beside 40 us in the loss and 50 us
    elsewhere in the backward. Without `heads`, the same work in spans of
    other names."""
    spans, events = [], []
    fwd, bwd = ("model.head", "model.head.backward") if heads else ("model.other",
                                                                    "model.other.backward")
    for k in range(2):
        t, i, c = 1000 * k, 20 * k, 20 * k
        spans += [_span(i + 1, "train.step", None, MAIN, t, t + 900),
                  _span(i + 2, "train.forward", i + 1, MAIN, t, t + 300),
                  _span(i + 3, fwd, i + 2, MAIN, t + 200, t + 300),
                  _span(i + 4, "bn", i + 3, MAIN, t + 250, t + 280),
                  _span(i + 5, "train.backward", i + 1, MAIN, t + 400, t + 800),
                  _span(i + 6, "train.loss.backward", i + 5, ENGINE, t + 400, t + 450),
                  _span(i + 7, bwd, i + 5, ENGINE, t + 450, t + 500),
                  _span(i + 8, bwd, i + 7, ENGINE, t + 460, t + 520)]
        events += [_launch(c + 1, MAIN, t + 210), _work(c + 1, t + 210, 30),
                   _launch(c + 2, MAIN, t + 260), _work(c + 2, t + 260, 10),
                   _launch(c + 3, ENGINE_CALLS, t + 410), _work(c + 3, t + 410, 40),
                   _launch(c + 4, ENGINE_CALLS, t + 455), _work(c + 4, t + 455, 20),
                   _launch(c + 5, ENGINE_CALLS, t + 470), _work(c + 5, t + 480, 15),
                   _launch(c + 6, ENGINE_CALLS, t + 600), _work(c + 6, t + 600, 50)]
    return _run(spans, events)


def test_heads_ms_reads_the_heads_forward_and_backward_per_step():
    assert math.isclose(_read(_steps(heads=True)), (30 + 10 + 20 + 15) * 1e-3)


def test_heads_ms_reads_nothing_without_the_heads_spans():
    assert _read(_steps(heads=False)) is None


@pytest.mark.parametrize("counted", [{}, {S.KEY: {}}, {S.KEY: {"spans": [], "events": []}}])
def test_heads_ms_reads_nothing_without_spans(counted):
    assert _read(SimpleNamespace(counted=counted)) is None


def test_heads_ms_is_listed_for_the_bisenet_cell_only():
    (entry,) = [m for m in manifest.benchmark()["per_layer"] if m["name"] == "heads_ms.train"]
    assert entry["workloads"] == ["bisenetv1.train.b12"] and entry["moves"] == "train_card_ms"
