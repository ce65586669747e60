"""The readers of the program's spans (harness/spans.py and the
`program_span` metrics) on hand-built traces: device work put down to the
span its launch fell in, idle gaps to the calling thread's spans, and
nothing read where the program recorded no spans."""

import json
import math
from types import SimpleNamespace

import pytest
import torch

from perfbench.harness import manifest, trace
from perfbench.harness import spans as S

BASE = 1_790_000_000_000_000_000  # the trace's baseTimeNanoseconds
MAIN, ENGINE = 100, 200  # the calling thread and the autograd engine's device thread (OS ids)
IDENT = {MAIN: 0x7F3A_5E0F_D740, ENGINE: 0x7F39_2970_9000}  # their POSIX thread ids
ENGINE_CALLS = IDENT[ENGINE] & 0xFFFFFFFF
READERS = ("loss_ms.train", "bn_forward_pct.train", "backward_idle_ms.train",
           "forward_idle_ms.train", "model_ms.serve")


def _span(sid, name, parent, tid, t0_us, t1_us):
    return {"name": name, "id": sid, "parent": parent, "call": 1, "tid": tid,
            "ident": IDENT[tid], "t0_ns": BASE + t0_us * 1000, "t1_ns": BASE + t1_us * 1000}


def _launch(corr, tid, ts, name="cudaLaunchKernel", dur=2.0):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "tid": tid, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _work(corr, ts, dur, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _run(spans, events):
    return SimpleNamespace(counted={S.KEY: {"spans": spans, "events": events, "base_ns": BASE}})


def _step_run():
    """One train step (times in microseconds after BASE): the forward with
    one BN, the loss, and the backward, whose loss part runs on the
    engine's thread, and the update."""
    spans = [
        _span(1, "train.step", None, MAIN, 0, 1000),
        _span(2, "train.forward", 1, MAIN, 0, 300),
        _span(3, "bn", 2, MAIN, 50, 100),
        _span(4, "train.loss", 1, MAIN, 300, 400),
        _span(5, "train.backward", 1, MAIN, 400, 900),
        _span(6, "train.loss.backward", 5, ENGINE, 600, 700),
        _span(8, "train.update", 1, MAIN, 900, 1000),
        _span(9, "train.allreduce", 5, MAIN, 620, 640),  # the caller busy beside the engine
    ]
    events = [
        _launch(1, MAIN, 10), _work(1, 20, 30),  # train.forward
        _launch(2, MAIN, 60), _work(2, 60, 40),  # bn
        _launch(3, MAIN, 310), _work(3, 320, 50),  # train.loss
        _launch(4, MAIN, 350, "cudaMemcpyAsync"), _work(4, 380, 10, "gpu_memcpy"),  # train.loss
        # the engine's calls carry the low 32 bits of its POSIX thread id
        _launch(5, ENGINE_CALLS, 420), _work(5, 420, 20),  # outside its spans: train.backward
        _launch(6, ENGINE_CALLS, 500), _work(6, 500, 60),  # the same
        _launch(7, ENGINE_CALLS, 650), _work(7, 650, 30),  # train.loss.backward
        _launch(11, ENGINE_CALLS, 630), _work(11, 655, 5),  # the same, beside kernel 7
        _launch(10, MAIN, 660), _work(10, 690, 4),  # the caller's, beside the engine's span
        _launch(8, MAIN, 910), _work(8, 920, 50, "gpu_memset"),  # train.update
        _launch(9, MAIN, 975, "cudaDeviceSynchronize", 5.0),  # the window ends at 980
        _work(99, 930, 5),  # a launch the trace lacks: inside no span
    ]
    return _run(spans, events)


def _serve_run():
    """Two serving calls; the model launches 250 and 200 us of work."""
    spans = []
    for c, t in ((0, 0), (1, 600)):
        i = 10 * c
        spans += [_span(i + 1, "serve.call", None, MAIN, t, t + 500),
                  _span(i + 2, "serve.input", i + 1, MAIN, t, t + 50),
                  _span(i + 3, "serve.model", i + 1, MAIN, t + 50, t + 400),
                  _span(i + 4, "serve.classmap", i + 1, MAIN, t + 400, t + 500)]
    events = [_launch(1, MAIN, 10), _work(1, 10, 20),
              _launch(2, MAIN, 100), _work(2, 100, 100),
              _launch(3, MAIN, 200), _work(3, 200, 150),
              _launch(4, MAIN, 410), _work(4, 410, 30),
              _launch(5, MAIN, 700), _work(5, 700, 200),
              _launch(6, MAIN, 1010), _work(6, 1010, 20)]
    return _run(spans, events)


def _read(name, run):
    return manifest.reader(name).read(run)


def test_the_readers_on_a_hand_built_step():
    run = _step_run()
    assert math.isclose(_read("loss_ms.train", run), (50 + 10 + 30 + 5) * 1e-3)
    step_us = 30 + 40 + 50 + 10 + 20 + 60 + 30 + 5 + 4 + 50  # all but the untraced launch
    assert math.isclose(_read("bn_forward_pct.train", run), 100.0 * 40 / step_us)
    # the window opens at 10: gaps at 10-20, 50-60 and 100-320 fall inside train.forward
    assert math.isclose(_read("forward_idle_ms.train", run), (10 + 10 + 220) * 1e-3)
    # gaps at 390-420, 440-500, 560-650, 680-690 and 694-920 fall inside train.backward
    assert math.isclose(_read("backward_idle_ms.train", run), (30 + 60 + 90 + 10 + 226) * 1e-3)
    att = S.attribution(run)
    assert att["roots"] == {"train.step": 1}
    assert math.isclose(att["busy_ms"], (step_us - 5) * 1e-3)  # kernel 11 beside kernel 7
    assert math.isclose(S.ms_inside(att["idle"], "train.step"), 0.97 - att["busy_ms"])
    # each launch in its own thread's span: the caller's at 660 in train.backward, not the
    # engine's span; the engine's at 630 in its own span, not the caller's later one
    assert att["by_span"]["train.backward"] == {"k": pytest.approx(0.084)}
    assert att["by_span"]["train.loss.backward"] == {"k": pytest.approx(0.035)}
    assert att["by_span"]["(none)"] == {"k": pytest.approx(0.005)}
    # by the innermost span on any thread, the gaps at 560-650 and 680-690 are the engine's
    assert math.isclose(att["idle_by_span"]["train.loss.backward"], 0.1)
    assert math.isclose(att["idle_by_span"]["train.backward"], 0.316)
    assert _read("model_ms.serve", run) is None  # no serve.call in the pass


def test_model_ms_on_two_hand_built_calls():
    run = _serve_run()
    assert math.isclose(_read("model_ms.serve", run), (100 + 150 + 200) / 2 * 1e-3)
    assert S.attribution(run)["roots"] == {"serve.call": 2}
    for name in ("loss_ms.train", "bn_forward_pct.train", "forward_idle_ms.train"):
        assert _read(name, run) is None, name


@pytest.mark.parametrize("counted", [{}, {S.KEY: {}}, {S.KEY: {"spans": [], "events": []}}])
def test_every_reader_reads_none_without_spans(counted):
    run = SimpleNamespace(counted=counted)
    for name in READERS:
        assert _read(name, run) is None, name


def test_the_wrapped_events_are_the_originals(monkeypatch):
    """The other readers get the original's events of a pass without spans;
    the spans are recorded in a second pass of the same arguments, whose
    events are kept, and what another reader counted in it is taken out."""
    from pidnet_tpu_torch.utils import spans as program

    got, passes = [], [[{"ph": "X", "cat": "kernel"}], [{"ph": "X", "cat": "kernel"}]]

    def original(fn, count, host_ops):
        got.append((fn, count, host_ops))
        for i in range(count):
            fn(i)
        return passes[len(got) - 1]

    run = SimpleNamespace(counted={"k2": [], "other": {}}, device=torch.device("cpu"))
    seen, other = run.counted["k2"], run.counted["other"]  # as another reader's hook holds them

    def fn(i):
        with program.span("serve.call"):
            seen.append(i)
            other[i] = other.get(i, 0) + 1

    monkeypatch.setattr(trace, "events", original)
    with S.during_trace(run), S.during_trace(run):  # entered by two readers: one records
        assert trace.events(fn, 2, host_ops=False) is passes[0]
    assert trace.events is original and program.span("x") is program._NULL
    assert got == [(fn, 2, False), (fn, 2, False)]
    state = run.counted[S.KEY]
    assert state["events"] is passes[1]
    assert [s["name"] for s in state["spans"]] == ["serve.call", "serve.call"]  # not the warm-up's
    assert run.counted["k2"] is seen and seen == [0, 1]
    assert run.counted["other"] == {0: 1, 1: 1}


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """As on the parent commit, whose program has no utils/spans.py: the
    readers' hook leaves trace.events alone and every reader reads None."""
    import sys

    import pidnet_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "pidnet_tpu_torch.utils.spans", None)
    original = trace.events
    run = SimpleNamespace(counted={})
    with S.during_trace(run):
        assert trace.events is original
    for name in READERS:
        assert _read(name, run) is None, name


def test_the_base_time_is_the_traces(tmp_path):
    state, export = {}, torch.profiler.profile.export_chrome_trace
    with S._base_time(state):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            torch.ones(4).sum()
        prof.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        assert state["base_ns"] == int(json.load(f).get("baseTimeNanoseconds", 0))
    assert torch.profiler.profile.export_chrome_trace is export
