"""One run of one cell: set-up, the measured window, an optional traced
sub-window, the check against the reference, and the result line. Where an
end-to-end reader asks for the card's own time (`CARD_TRACE`), a run
without `--trace` traces the driver's steps after the window too, the
card's activity and the host's CUDA calls only.

`measure` does the work and returns the result; `main` adds what only a
run on the card does (the look for the card, the check that no JAX module
was loaded, the printing). The benchmark's own tests call `measure` on the
CPU at small sizes.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from contextlib import ExitStack
from types import SimpleNamespace

import torch

from perfbench.harness import manifest, trace
from perfbench.reference import float32

FORBIDDEN = {"jax", "jaxlib", "flax", "pidnet_tpu"}


def forbidden_modules() -> list[str]:
    """The JAX modules, and the JAX package, that this process holds,
    compared by whole top-level name."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def new_run(cell_name: str, seed: int, device, *, fault=None, bench=None, config=None,
            traffic=None, limits=None):
    """The run's context: the cell's entry, configuration, mix and limits,
    found by name unless given."""
    bench = bench or manifest.benchmark()
    entry = manifest.cell(cell_name, bench)
    return SimpleNamespace(
        name=cell_name, seed=int(seed), device=torch.device(device), fault=fault, bench=bench,
        entry=entry,
        config=config or manifest.config(entry["config"]),
        traffic=traffic or manifest.traffic(entry["traffic"]),
        limits=limits if limits is not None else manifest.limits(cell_name),
        obs={}, setup_s=None, trace=None, card=None, trace_count=0, counted={}, readings=None,
        control=None, control_readings=None, marks=[],
    )


def mark(run, label: str) -> None:
    """Note the end of a stage of set-up (printed on an earlier line)."""
    run.marks.append((label, time.perf_counter()))


def measure(run, seconds: float, traced: bool, t_start: float, control: bool = False) -> dict:
    """Set up, measure, trace if asked, judge; returns the result line.
    With `control` (perfbench/calibrate.py) the driver's control is read
    too, after the program's numbers, into run.control."""
    drv = manifest.driver(run.traffic["driver"])
    e2e, layer = manifest.metrics_of(run.name, run.bench)
    st = drv.setup(run)
    run.setup_s = time.perf_counter() - t_start
    run.obs = drv.window(run, st, seconds)
    cuda = run.device.type == "cuda"
    if cuda and not traced and any(getattr(manifest.reader(m["name"]), "CARD_TRACE", False)
                                   for m in e2e):
        # the card's own time for the driver's traced steps (an end-to-end
        # reader with CARD_TRACE reads it from run.card)
        fn, run.trace_count = drv.profile(run, st)
        run.card = trace.read(trace.events(fn, run.trace_count, host_ops=False),
                              window_from="cuda_runtime")
    if traced and cuda:
        fn, run.trace_count = drv.profile(run, st)
        with ExitStack() as stack:  # the readers' hooks see the first pass only
            for m in layer:
                r = manifest.reader(m["name"])
                if hasattr(r, "during_trace"):
                    stack.enter_context(r.during_trace(run))
            events = trace.events(fn, run.trace_count, host_ops=False)
        run.trace = trace.read(events, window_from="cuda_runtime")
        del events
        named = trace.read(trace.events(fn, run.trace_count, host_ops=True))
        run.trace["idle_gaps"] = named["idle_gaps"]
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    with float32():
        numbers = drv.judge(run, st)
        run.readings = st.get("readings", numbers)
        if control:
            run.control = drv.control(run, st)
            run.control_readings = st.get("readings", run.control)
    del st
    gc.collect()
    metrics = {}
    for m in (layer if traced else e2e):
        value = manifest.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {}
    for key, value in numbers.items():
        limit = (run.limits or {}).get(key)
        checks[key] = {"value": value, "limit": limit}
    correct = bool(run.obs["failed"] == 0 and checks and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    device = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
        "count": run.entry["chips"],
        "memory_peak_bytes": peak,
    }
    result = {"correct": correct, "attempted": run.obs["attempted"],
              "failed": run.obs["failed"], "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = checks
    return result


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip() or f"not read (nvidia-smi exit {out.returncode})"


def main(args, t_start: float) -> int:
    t_imported = time.perf_counter()  # python, torch and the harness
    bench = manifest.benchmark()
    entry = manifest.cell(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"perfbench: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run = new_run(args.workload, args.seed, "cuda:0", bench=bench)
    run.marks += [("torch", t_imported), ("cuda_found", time.perf_counter())]
    result = measure(run, args.seconds, bool(args.trace), t_start)
    print(f"perfbench: {args.workload} seed {args.seed} on {power_limit()}", flush=True)
    found = forbidden_modules()
    if found:
        print(f"perfbench: this process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    stages, t = [], t_start
    for label, at in run.marks:
        stages.append(f"{label} {at - t:.3f}")
        t = at
    print(f"perfbench: setup stages (s): {', '.join(stages)}", flush=True)
    print(f"perfbench: peak {result['device']['memory_peak_bytes']} bytes, setup "
          f"{run.setup_s:.3f} s, window {run.obs['window_s']:.3f} s, "
          f"{run.obs['attempted']} attempted", flush=True)
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
