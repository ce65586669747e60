"""A short steady sub-window under `torch.profiler`, read into the numbers
the per-layer metrics and the result's `breakdown` take.

The sub-window runs twice. The first pass records the card's activity
and the host's CUDA calls only, which costs the host little: the window
runs from the host's first CUDA call to the end of the synchronise that
closes it, device activity is every kernel, memcpy and memset on the card,
and `busy_s` is the length of their union inside the window; the kernels'
times and `device_ops` come from it too. The second pass records the
host's operations as well, which costs the host some 20 us an operation
and so widens the card's idle gaps; it only names them: each of its ten
longest gaps after the innermost host operation running at its middle,
or `host_idle` where none was.
"""

from __future__ import annotations

import json
import os
import tempfile

import torch

WINDOW = "perfbench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
TOP = 10


def events(fn, count: int, host_ops: bool) -> list:
    """The Chrome trace events of `fn(i)` for i < count under the
    profiler: the card's activity and the host's CUDA calls, and with
    `host_ops` the host's operations too."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            for i in range(count):
                fn(i)
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(events: list, window_from: str = "user_annotation") -> dict:
    """{busy_s, window_s, kernels: {name: [seconds, launches]}, device_ops,
    idle_gaps} of a Chrome trace's events (times in microseconds). The
    window is the `perfbench.window` range where the host's operations were
    recorded (`window_from="user_annotation"`), else the span of the host's
    CUDA calls (`"cuda_runtime"`)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if window_from == "user_annotation":
        window = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in spans
                  if e["name"] == WINDOW and e.get("cat") == window_from]
    else:
        window = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in spans
                  if e.get("cat") == window_from]
        window = [(min(a for a, _ in window), max(b for _, b in window))] if window else []
    if not window:
        raise RuntimeError(f"the trace holds no {window_from} events to bound its window")
    w0, w1 = window[0]
    device, kernels = [], {}
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        device.append((a, b))
        k = kernels.setdefault(e["name"], [0.0, 0])
        k[0] += (b - a) * 1e-6
        k[1] += 1
    busy = _union(device)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    host = [e for e in spans if e.get("cat") == "cpu_op"]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (a + b) / 2
        inside = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        name = min(inside, key=lambda e: float(e["dur"]))["name"] if inside else "host_idle"
        named.append([name, (b - a) * 1e-6])
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    short = lambda name: name.replace("void ", "").replace("at::native::", "")[:160]  # noqa: E731
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "kernels": kernels,
        "device_ops": [[short(name), v[0]] for name, v in ops],
        "idle_gaps": named,
    }


def kernel_seconds(reading: dict, part: str) -> tuple[float, int]:
    """(device seconds, launches) of the kernels whose name holds `part`."""
    hits = [v for name, v in reading["kernels"].items() if part in name]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)
