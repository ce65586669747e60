"""The program's spans (pidnet_tpu_torch/utils/spans.py): off they cost a
flag check and register nothing; on, one PIDNet-S train step, one
BiSeNetV1 train step and one serving call record the span tree the
benchmark's readers take, with results bit-identical to a step recorded
off, on the profiler's clock."""

import json
import statistics
import sys
import time

import numpy as np
import pytest
import torch

from pidnet_tpu_torch import engine
from pidnet_tpu_torch.convert.fold import fold_state_dict
from pidnet_tpu_torch.data.cityscapes import CLASS_WEIGHTS
from pidnet_tpu_torch.losses.criterion import FullLoss
from pidnet_tpu_torch.models import bisenet
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.tools import common
from pidnet_tpu_torch.tools import train as train_cli
from pidnet_tpu_torch.train.step import TrainState, make_train_step
from pidnet_tpu_torch.utils import spans

torch.set_num_threads(2)

SPEC = M.spec_for("pidnet_s", 19, augment=True)
BISENET = bisenet.spec_for("bisenet_adb_bag", 19, augment=True)
LOSS_KW = dict(ignore_label=255, class_weights=CLASS_WEIGHTS, ohem_thres=0.9, ohem_kept=4096)


@pytest.fixture(scope="module")
def weights():
    return M.init(SPEC, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(18)
    n, h, w = 2, 128, 128
    img = rng.standard_normal((n, h, w, 3), dtype=np.float32)
    lab = rng.integers(0, 19, (n, h, w)).astype(np.int32)
    lab[rng.random((n, h, w)) < 0.1] = 255
    edge = (rng.random((n, h, w)) < 0.1).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (img, lab, edge))


@pytest.fixture(scope="module")
def bisenet_weights():
    return M.init(BISENET, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def bisenet_batch():
    """4 samples: BiSeNet's BNs after its global pools normalise over the
    batch's pooled vectors, ill-conditioned at 2."""
    rng = np.random.default_rng(22)
    n, h, w = 4, 64, 128
    img = rng.standard_normal((n, h, w, 3), dtype=np.float32)
    lab = rng.integers(0, 19, (n, h, w)).astype(np.int32)
    edge = (rng.random((n, h, w)) < 0.1).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (img, lab, edge))


def _step(weights, spec=SPEC):
    ts = TrainState.create(M.build(spec, weights, device="cpu", train=True))
    loss_fn = FullLoss(num_outputs=len(M.balance_weights(spec)),
                       balance_weights=M.balance_weights(spec), **LOSS_KW)
    return ts, make_train_step(ts, loss_fn)


def _stepped(weights, batch, monkeypatch, record: bool, spec=SPEC):
    """One step from `weights`: (its gradients, the state after it, the
    recorder or None)."""
    ts, step = _step(weights, spec)
    grads = []
    original = torch.autograd.grad

    def keeping(*args, **kwargs):
        out = original(*args, **kwargs)
        grads.extend(g.detach().clone() for g in out if g is not None)
        return out

    monkeypatch.setattr(torch.autograd, "grad", keeping)
    rec = None
    if record:
        with spans.recording() as rec:
            step(*batch, 0.01)
    else:
        step(*batch, 0.01)
    monkeypatch.setattr(torch.autograd, "grad", original)
    state = {**dict(ts.model.named_parameters()), **dict(ts.model.named_buffers()),
             **{"momentum." + k: v for k, v in ts.momentum.items()}}
    return grads, {k: v.detach().clone() for k, v in state.items()}, rec


def _inside(child, parent):
    return parent["t0_ns"] <= child["t0_ns"] and child["t1_ns"] <= parent["t1_ns"]


def _watched_step(weights, batch, spec=SPEC) -> list[str]:
    """The functions of utils/spans.py called, and the autograd hooks
    registered, during one step from `weights` while nothing records."""
    ts, step = _step(weights, spec)
    called = []

    def watch(frame, event, arg):
        if event == "call" and frame.f_code.co_filename == spans.__file__:
            called.append(frame.f_code.co_name)
        elif event == "c_call" and getattr(arg, "__name__", "") in ("register_hook",
                                                                     "register_prehook"):
            called.append(arg.__name__)

    sys.setprofile(watch)
    try:
        step(*batch, 0.01)
    finally:
        sys.setprofile(None)
    return called


def test_off_returns_the_shared_null_context_and_registers_no_hook(weights, batch):
    assert spans.span("train.step") is spans.span("bn") is spans._NULL
    with spans.recording() as rec:
        pass
    called = _watched_step(weights, batch)
    assert rec.spans == []
    assert set(called) <= {"span", "backward_span"}, set(called)


def test_bisenet_off_registers_no_hook(bisenet_weights, bisenet_batch):
    """BiSeNet's spans and its heads' backward spans, off: flag checks."""
    called = _watched_step(bisenet_weights, bisenet_batch, BISENET)
    assert called.count("backward_span") == 4 + 1  # the heads' and the loss's
    assert set(called) <= {"span", "backward_span"}, set(called)


def test_one_train_step_records_the_step_tree(weights, batch, monkeypatch):
    _, _, rec = _stepped(weights, batch, monkeypatch, record=True)
    got = rec.spans
    assert all(s["t1_ns"] is not None for s in got)
    by_id = {s["id"]: s for s in got}
    (root,) = [s for s in got if s["parent"] is None]
    assert root["name"] == "train.step"
    assert {s["call"] for s in got} == {root["call"]}
    children = [s["name"] for s in got if s["parent"] == root["id"]]
    assert children == ["train.forward", "train.loss", "train.backward", "train.update"]
    for s in got:
        if s["parent"] is not None:
            assert _inside(s, by_id[s["parent"]]), (s["name"], by_id[s["parent"]]["name"])
    n_bn = sum(isinstance(m, M.BatchNorm) for m in M.build(SPEC, weights, device="cpu",
                                                           train=True).modules())
    names = [s["name"] for s in got]
    assert names.count("bn") == names.count("bn.backward") == n_bn
    (backward,) = [s for s in got if s["name"] == "train.backward"]
    assert all(_inside(s, backward) for s in got if s["name"] == "bn.backward")
    (loss_bwd,) = [s for s in got if s["name"] == "train.loss.backward"]
    assert loss_bwd["parent"] == backward["id"]
    (loss,) = [s for s in got if s["name"] == "train.loss"]
    assert sorted(s["name"] for s in got if s["parent"] == loss["id"]) == [
        "loss.boundary", "loss.ohem"]
    assert names.count("loss.ohem") == 2  # the final head's OHEM and the boundary-aware CE's
    (forward,) = [s for s in got if s["name"] == "train.forward"]
    parts = [s["name"] for s in got if s["parent"] == forward["id"] and s["name"] != "bn"]
    assert parts == ["model.pag", "model.pag", "model.ppm", "model.bag", "model.head"]


def _nodes(root, stop):
    """The autograd nodes reachable from `root` short of `stop`."""
    seen, todo = [], [root]
    while todo:
        node = todo.pop()
        if node is None or node is stop or any(node is n for n in seen):
            continue
        seen.append(node)
        todo.extend(n for n, _ in node.next_functions)
    return seen


class _OneRank:
    """A sync BN mesh of one rank: train-mode BN through its eager ops."""

    size = 1

    @staticmethod
    def pmean(t):
        return t


def test_a_modules_backward_span_is_contiguous():
    """Three conv + train-mode BN blocks, each BN's input also read by an
    operation before it: each block's backward span holds the start of
    every node its BN made and not that operation's, and the spans follow
    one another in falling order. The BNs take the sync path of one rank,
    whose eager ops make a backward of many nodes (the kernels' is one)."""
    gen = torch.Generator().manual_seed(3)
    convs = [torch.nn.Conv2d(4, 4, 3, padding=1) for _ in range(3)]
    bns = [M.BatchNorm(4).train() for _ in range(3)]
    for bn in bns:
        bn.load_state_dict({"weight": torch.rand(4, generator=gen) + 0.5,
                            "bias": torch.zeros(4), "running_mean": torch.zeros(4),
                            "running_var": torch.ones(4)})
        bn.sync = _OneRank()
    started, outside = [], []
    with spans.recording() as rec:
        h = torch.randn(2, 4, 8, 8, generator=gen)
        for i, (conv, bn) in enumerate(zip(convs, bns)):
            a = conv(h)
            skip = a * 0.5  # its backward runs after the BN's, before a's gradient is whole
            skip.grad_fn.register_prehook(lambda g: outside.append(time.time_ns()))
            y = bn(a)
            spans.backward_span(f"block{i}", y, [a])
            for node in _nodes(y.grad_fn, a.grad_fn):
                node.register_prehook(lambda g, i=i: started.append((i, time.time_ns())))
            h = torch.relu(y) + skip
        h.square().sum().backward()
    blocks = sorted((s for s in rec.spans if s["name"].startswith("block")),
                    key=lambda s: s["t0_ns"])
    assert [s["name"] for s in blocks] == ["block2", "block1", "block0"]
    assert all(a["t1_ns"] <= b["t0_ns"] for a, b in zip(blocks, blocks[1:]))
    by_name = {s["name"]: s for s in blocks}
    assert len(started) > 3 * 10
    for i, t in started:
        assert by_name[f"block{i}"]["t0_ns"] <= t <= by_name[f"block{i}"]["t1_ns"]
    assert len(outside) == 3
    assert not any(s["t0_ns"] <= t <= s["t1_ns"] for t in outside for s in blocks)


def test_bisenet_step_records_its_parts_and_heads_backward(bisenet_weights, bisenet_batch,
                                                           monkeypatch):
    """A BiSeNet train step, recorded: its five parts in order under
    `train.forward` (beside its BNs), and one `model.head.backward` per
    head inside `train.backward`, on the thread that runs the backward,
    each holding the BN backward spans of its head's own BN."""
    _, _, rec = _stepped(bisenet_weights, bisenet_batch, monkeypatch, record=True,
                         spec=BISENET)
    got = rec.spans
    assert all(s["t1_ns"] is not None for s in got)
    by_id = {s["id"]: s for s in got}
    (forward,) = [s for s in got if s["name"] == "train.forward"]
    parts = [s for s in got if s["parent"] == forward["id"] and s["name"] != "bn"]
    assert [s["name"] for s in parts] == ["model.context", "model.spatial", "model.bag",
                                          "model.ffm", "model.head"]
    assert all(_inside(s, forward) for s in parts)
    (backward,) = [s for s in got if s["name"] == "train.backward"]
    heads = [s for s in got if s["name"] == "model.head.backward"]
    assert len(heads) == 4
    assert all(_inside(s, backward) for s in heads)
    (loss_bwd,) = [s for s in got if s["name"] == "train.loss.backward"]
    assert all(loss_bwd["t1_ns"] <= s["t0_ns"] for s in heads)
    inner = [s for s in got if s["name"] == "bn.backward" and by_id[s["parent"]]["name"]
             == "model.head.backward"]
    assert len(inner) == 4  # each head's one BN, in its 3x3 conv+BN+ReLU


def test_bisenet_recording_leaves_the_step_bit_identical(bisenet_weights, bisenet_batch,
                                                         monkeypatch):
    g_off, s_off, _ = _stepped(bisenet_weights, bisenet_batch, monkeypatch, record=False,
                               spec=BISENET)
    g_on, s_on, _ = _stepped(bisenet_weights, bisenet_batch, monkeypatch, record=True,
                             spec=BISENET)
    assert len(g_off) == len(g_on) > 0
    for a, b in zip(g_off, g_on):
        assert torch.equal(a, b)
    assert set(s_off) == set(s_on)
    for k in s_off:
        assert torch.equal(s_off[k], s_on[k]), k


def test_recording_leaves_the_step_bit_identical(weights, batch, monkeypatch):
    g_off, s_off, _ = _stepped(weights, batch, monkeypatch, record=False)
    g_on, s_on, _ = _stepped(weights, batch, monkeypatch, record=True)
    assert len(g_off) == len(g_on) > 0
    for a, b in zip(g_off, g_on):
        assert torch.equal(a, b)
    assert set(s_off) == set(s_on)
    for k in s_off:
        assert torch.equal(s_off[k], s_on[k]), k


def test_one_serving_call_records_input_model_and_classmap(weights):
    spec = M.spec_for("pidnet_s", 19, augment=False)
    infer = engine.make_inference_classmap(engine.config(), spec,
                                           fold_state_dict(weights, spec), folded=True,
                                           device="cpu")
    x = torch.randn(1, 64, 128, 3, generator=torch.Generator().manual_seed(1))
    with spans.recording() as rec:
        out = infer(x)
    assert out.shape == (1, 64, 128)
    (call,) = [s for s in rec.spans if s["parent"] is None]
    assert call["name"] == "serve.call"
    assert [s["name"] for s in rec.spans if s["parent"] == call["id"]] == [
        "serve.input", "serve.model", "serve.classmap"]
    by_id = {s["id"]: s for s in rec.spans}
    assert all(_inside(s, by_id[s["parent"]]) for s in rec.spans if s["parent"] is not None)
    assert {s["call"] for s in rec.spans} == {call["call"]}


def test_spans_are_on_the_profilers_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof, spans.recording() as rec:
        for i in range(21):  # the first warms up
            with spans.span(f"clock.{i}"):
                for _ in range(20):
                    a = torch.tanh(a @ a)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    marks = {e["name"]: e for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation" and e["name"].startswith("clock.")}
    diffs = []
    for s in rec.spans[1:]:
        e = marks[s["name"]]
        t0, t1 = base + e["ts"] * 1e3, base + (e["ts"] + e["dur"]) * 1e3
        diffs += [abs(s["t0_ns"] - t0), abs(s["t1_ns"] - t1)]
    assert len(diffs) == 40
    assert statistics.median(diffs) < 0.2e6 and max(diffs) < 5e6, diffs


def test_recording_without_annotations():
    """`recording(annotate=False)` records the spans, each thread's ids
    asked once, and puts no `record_function` on the profiler's timeline."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            spans.recording(annotate=False) as rec:
        for _ in range(3):
            with spans.span("quiet"):
                torch.ones(4).sum()
    assert [s["name"] for s in rec.spans] == ["quiet"] * 3
    assert {(s["tid"], s["ident"]) for s in rec.spans} == {
        (threading.get_native_id(), threading.get_ident())}
    assert "quiet" not in {e.name for e in prof.events()}


def test_first_epoch_profile_shows_the_spans(tmp_path, weights, batch):
    ts, step = _step(weights)
    prof = common.ProfileTrace(str(tmp_path), train_cli.TRACE_FILE, torch.device("cpu"))
    step(*batch, 0.01)
    prof.stop()
    assert spans.span("train.step") is spans._NULL
    with open(tmp_path / train_cli.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"train.step", "train.forward", "train.loss", "train.backward",
            "train.loss.backward", "bn", "loss.ohem"} <= names
