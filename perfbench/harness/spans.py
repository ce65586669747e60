"""The program's spans (pidnet_tpu_torch/utils/spans.py) set beside the
device trace of a traced pass of their own, for the readers of `program_span`
metrics.

`during_trace(run)` is entered by each such reader; the first entry of a
run does the work, through `run.counted["spans"]`. While it is open
`trace.events` is wrapped as `readers.launches_of` wraps a kernel's
wrapper: the original runs with the same arguments, and its events are
returned unchanged, for the other readers. Then it runs once more, with
the same arguments, while the program records its spans
(`recording(annotate=False)`: the readers take `rec.spans`, not the
trace's annotations), and those events are kept, with the trace's
`baseTimeNanoseconds`. The spans get a pass of their own because
recording them costs the host time in the host-paced parts of a step,
which would read as the card's idle time in the other readers' pass; what
the other readers' hooks count during the span pass is taken back out of
`run.counted`. A small recorded warm-up comes first, so that the
recorder's first use falls outside the span pass; it runs nothing of the
program. A program without spans records nothing, and every reader then
returns None.

`attribution(run)` puts the card's work down to the spans. A kernel,
memcpy or memset leads by its `correlation` id to the CUDA call that
launched it; the call's time places it in the innermost span open then on
the call's thread (the call's `tid` is the span's `tid`, or the low 32
bits of its `ident` where the profiler records no host operations) or,
where that thread has none open (the autograd engine's device thread
outside `train.loss.backward`), in the innermost open then on any
thread. Its time counts for that span and every span around it. A gap in the card's activity counts for every span open on the
calling thread (the thread of the step's or call's root span) at the
gap's midpoint.
"""

from __future__ import annotations

import bisect
import contextlib
import copy
import re

import torch

from perfbench.harness import trace

LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
KEY = "spans"


@contextlib.contextmanager
def _base_time(state: dict):
    """Inside, each Chrome trace the profiler writes leaves its
    `baseTimeNanoseconds` (0 where it writes none: absolute times) in
    state["base_ns"]."""
    cls = torch.profiler.profile
    export = cls.export_chrome_trace

    def exporting(self, path):
        out = export(self, path)
        with open(path) as f:
            found = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', f.read())
        state["base_ns"] = int(found.group(1)) if found else 0
        return out

    cls.export_chrome_trace = exporting
    try:
        yield
    finally:
        cls.export_chrome_trace = export


def _first_use(program, device) -> None:
    """A span and a backward span on `device`, recorded and thrown away:
    the recorder's first use (`record_function`'s, the autograd hooks' on
    the engine's device thread) costs the host tens of ms once, which would
    otherwise fall inside the pass and read as the card's idle time."""
    x = torch.ones(8, device=device, requires_grad=True)
    with program.recording():
        with program.span("perfbench.warm"):
            y = (x * 2).sum()
        program.backward_span("perfbench.warm.backward", y, [x])
        torch.autograd.grad(y, [x])


def _restore(counted: dict, before: dict) -> None:
    """Put the other readers' entries of run.counted back as they were; a
    list in place, since a reader's hook holds it (`readers.launches_of`)."""
    for key in [k for k in counted if k != KEY and k not in before]:
        del counted[key]
    for key, value in before.items():
        if isinstance(counted[key], list):
            counted[key][:] = value
        else:
            counted[key] = value


@contextlib.contextmanager
def during_trace(run):
    if KEY in run.counted:
        yield
        return
    state = run.counted[KEY] = {}
    try:
        from pidnet_tpu_torch.utils import spans as program
    except ImportError:  # a program with no spans: nothing to read
        yield
        return
    original = trace.events

    def kept(*args, **kwargs):
        events = original(*args, **kwargs)
        counted = {k: copy.copy(v) for k, v in run.counted.items() if k != KEY}
        _first_use(program, run.device)
        with _base_time(state), program.recording(annotate=False) as rec:
            state["events"] = original(*args, **kwargs)
        state["spans"] = rec.spans
        _restore(run.counted, counted)
        return events

    trace.events = kept
    try:
        yield
    finally:
        trace.events = original


class _Open:
    """The innermost span open at a time: on one thread's nested spans, or
    over every thread (the latest opened of those open; of two opened in
    the same ns, the later, whose id is the higher)."""

    def __init__(self, spans: list[dict]):
        edges = sorted([(s["t0_ns"], 1, s["id"]) for s in spans]
                       + [(s["t1_ns"], 0, s["id"]) for s in spans])
        t0 = {s["id"]: s["t0_ns"] for s in spans}
        self.times, self.inner, live = [], [], set()
        for t, opening, sid in edges:
            (live.add if opening else live.discard)(sid)
            self.times.append(t)
            self.inner.append(max(live, key=lambda i: (t0[i], i)) if live else None)

    def at(self, t: float):
        i = bisect.bisect_right(self.times, t) - 1
        return self.inner[i] if i >= 0 else None


def attribution(run) -> dict | None:
    """None where the pass recorded no spans or no trace; else, over the
    whole traced pass: `launched`, (ms, names of the spans it was launched
    inside) of each kernel, memcpy and memset; `idle`, (ms, names of the
    spans open on the calling thread at its midpoint) of each gap in the
    card's activity inside the window of CUDA calls; `roots`, {name: the
    count of root spans}; `busy_ms`; `by_span`, {innermost span's name:
    {kernel's name: ms}}; `idle_by_span`, {innermost span's name on any
    thread at a gap's midpoint: ms}. Cached in run.counted."""
    state = run.counted.get(KEY) or {}
    if "result" in state:
        return state["result"]
    spans = [s for s in state.get("spans") or () if s["t1_ns"] is not None]
    events = state.get("events")
    if not spans or events is None:
        return None
    base = state.get("base_ns", 0)
    by_id = {s["id"]: s for s in spans}
    chains = {None: frozenset()}
    for s in spans:
        names, p = set(), s
        while p is not None:
            names.add(p["name"])
            p = by_id.get(p["parent"])
        chains[s["id"]] = frozenset(names)
    threads = {}
    for s in spans:
        for key in {s["tid"], s.get("ident", s["tid"]) & 0xFFFFFFFF}:
            threads.setdefault(key, []).append(s)
    open_on = {tid: _Open(ss) for tid, ss in threads.items()}
    open_any = _Open(spans)

    def name_of(sid):
        return by_id[sid]["name"] if sid is not None else "(none)"

    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (base + float(e["ts"]) * 1e3, e.get("tid"))
    launched, by_span, device = [], {}, []
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATS or e.get("ph") != "X":
            continue
        ms = float(e["dur"]) * 1e-3
        device.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        launch = launches.get(e.get("args", {}).get("correlation"))
        sid = None
        if launch is not None:
            t, tid = launch
            sid = open_on[tid].at(t) if tid in open_on else None
            if sid is None:
                sid = open_any.at(t)
        launched.append((ms, chains[sid]))
        kernels = by_span.setdefault(name_of(sid), {})
        kernels[e["name"]] = kernels.get(e["name"], 0.0) + ms
    roots = {}
    for s in spans:
        if s["parent"] is None:
            roots[s["name"]] = roots.get(s["name"], 0) + 1
    caller = open_on[next(s["tid"] for s in spans if s["parent"] is None)]
    calls = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "cuda_runtime"]
    idle, idle_by_span, busy = [], {}, 0.0
    if calls:
        w0, w1 = min(a for a, _ in calls), max(b for _, b in calls)
        union = trace._union([(max(a, w0), min(b, w1)) for a, b in device
                              if min(b, w1) > max(a, w0)])
        busy = sum(b - a for a, b in union) * 1e-3
        edges = [w0] + [t for iv in union for t in iv] + [w1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                mid = base + (a + b) / 2 * 1e3
                ms = (b - a) * 1e-3
                idle.append((ms, chains[caller.at(mid)]))
                label = name_of(open_any.at(mid))
                idle_by_span[label] = idle_by_span.get(label, 0.0) + ms
    state["result"] = {"launched": launched, "idle": idle, "roots": roots, "busy_ms": busy,
                       "by_span": by_span, "idle_by_span": idle_by_span}
    return state["result"]


def ms_inside(pairs, *names: str) -> float:
    """The ms of those (ms, span names) pairs that lie inside any of
    `names`, each once."""
    want = set(names)
    return sum(ms for ms, inside in pairs if inside & want)


def per_root(run, root: str, value) -> float | None:
    """`value(attribution)` over the number of `root` spans (steps or
    calls) in the pass; None where there are none."""
    att = attribution(run)
    if att is None or not att["roots"].get(root):
        return None
    return value(att) / att["roots"][root]
