"""Spans at the port's layer boundaries: the serving call, the training
and evaluation steps, the loss and the model's parts.

`with span(name):` marks a span. Off, the default, it checks one
module-level flag and returns one shared null context: no
`record_function`, no allocation, no CUDA call and no autograd hook.
Inside `with recording() as rec:` each span enters
`torch.profiler.record_function(name)`, so any profiler that records the
CPU shows it on its timeline (`recording(annotate=False)` leaves that out,
for a reader of `rec.spans` alone), and appends a record to `rec.spans`:

- `name`, `id` and `parent`, the id of the innermost span open on the
  same thread (where that thread has none open, the innermost open on any
  thread: the autograd engine's device thread runs a CUDA backward while
  the calling thread waits inside `train.backward`);
- `call`, one id shared by every span of one serving call or step (the
  span opened with no other open);
- `tid`, the OS id of the thread (`threading.get_native_id`), and
  `ident`, its POSIX thread id (`threading.get_ident`), whose low 32 bits
  a trace's CUDA calls carry as their `tid` where the profiler records no
  host operations;
- `t0_ns` and `t1_ns`, on the profiler's clock (`time.time_ns`, the clock
  of a Chrome trace's `ts` plus its `baseTimeNanoseconds`); `t1_ns` stays
  None for a span still open when recording ends.

Backward spans exist only while recording: `backward_span` opens one from
an autograd pre-hook on an output's `grad_fn` and closes it from the
post-hooks of the nodes that give its inputs their gradients, when the
last of them has run; the hooks change no gradient. The
engine runs a device's backward nodes on one thread in falling sequence
order, so the backward of a module whose forward ran with nothing
interleaved is contiguous there (tests/test_torch_spans.py).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

_recorder = None  # the Recorder of the open `recording()`, None when off
_NULL = contextlib.nullcontext()


class Recorder:
    """The spans of one `recording()`, in the order they opened."""

    def __init__(self, annotate: bool = True):
        self.annotate = annotate
        self.spans: list[dict] = []
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._stacks: dict[int, list[dict]] = {}  # tid -> its open spans, innermost last
        self._call = 0
        self._threads = threading.local()  # .ids: this thread's (tid, ident), asked once

    def open(self, name: str) -> dict:
        ids = getattr(self._threads, "ids", None)
        if ids is None:
            ids = self._threads.ids = (threading.get_native_id(), threading.get_ident())
        tid, ident = ids
        with self._lock:
            stack = self._stacks.setdefault(tid, [])
            if stack:
                parent = stack[-1]
            else:
                others = [s[-1] for s in self._stacks.values() if s]
                parent = max(others, key=lambda r: (r["t0_ns"], r["id"])) if others else None
            if parent is None:
                self._call += 1
            record = {"name": name, "id": next(self._ids),
                      "parent": None if parent is None else parent["id"],
                      "call": self._call if parent is None else parent["call"], "tid": tid,
                      "ident": ident, "t0_ns": time.time_ns(), "t1_ns": None}
            stack.append(record)
            self.spans.append(record)
        return record

    def close(self, record: dict) -> None:
        t1 = time.time_ns()
        with self._lock:
            record["t1_ns"] = t1
            stack = self._stacks.get(record["tid"], [])
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is record:
                    del stack[i]
                    break


class _Span:
    __slots__ = ("rec", "name", "record", "rf")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.record = self.rec.open(self.name)
        self.rf = torch.profiler.record_function(self.name) if self.rec.annotate else None
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec.close(self.record)
        return False


def span(name: str):
    """A context manager marking the span `name` while recording; the one
    shared null context otherwise."""
    rec = _recorder
    if rec is None:
        return _NULL
    return _Span(rec, name)


@contextlib.contextmanager
def recording(annotate: bool = True):
    """Inside, spans are recorded into the yielded Recorder (one at a
    time: nesting raises); with `annotate`, each also as a
    `record_function` for the profiler's timeline."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans are already being recorded")
    rec = _recorder = Recorder(annotate)
    try:
        yield rec
    finally:
        _recorder = None


def backward_span(name: str, output: torch.Tensor, inputs: list) -> None:
    """While recording, the span `name` over the backward from `output` to
    the tensors `inputs`: opened by a pre-hook on `output.grad_fn`, closed
    by the post-hook of the last node to run of those that give an input
    its gradient (found by walking the graph from `output` to the
    inputs)."""
    rec = _recorder
    if rec is None or output.grad_fn is None:
        return
    ends = {torch.autograd.graph.get_gradient_edge(t).node for t in inputs if t.requires_grad}
    last, seen, todo = [], set(), [output.grad_fn]
    while todo:
        node = todo.pop()
        if node in seen:
            continue
        seen.add(node)
        after = [n for n, _ in node.next_functions if n is not None]
        if any(n in ends for n in after):
            last.append(node)
        todo.extend(n for n in after if n not in ends)
    if not last:
        return
    state = {"span": None, "left": len(last)}

    def opened(grad_outputs):
        state["span"] = _Span(rec, name).__enter__()

    def ran(grad_inputs, grad_outputs):
        state["left"] -= 1
        if state["left"] == 0 and state["span"] is not None:
            state["span"].__exit__(None, None, None)

    output.grad_fn.register_prehook(opened)
    for node in last:
        node.register_hook(ran)
