"""Arithmetic that several metric readers share (perfbench/metrics/)."""

from __future__ import annotations

import contextlib
import statistics

from perfbench.harness import counts, trace


def rate(run) -> float:
    """Units (frames, crops) completed over the window's seconds."""
    return run.obs["units"] / run.obs["window_s"]


def mean_enqueue_ms(run) -> float:
    return statistics.fmean(run.obs["enqueue_s"]) * 1e3


def idle_pct(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def utilisation_pct(flops_per_call: float, calls: int, window_s: float) -> float:
    """The share of the card's dense bf16 peak that `calls` calls of
    `flops_per_call` each fill in `window_s` seconds."""
    return 100.0 * flops_per_call * calls / window_s / counts.BF16_FLOPS


def roofline_pct(run, kernel: str, bound_s: float):
    """Bound over the device time of the kernels named `kernel` in the
    traced window; None where none ran."""
    if run.trace is None:
        return None
    seconds, launches = trace.kernel_seconds(run.trace, kernel)
    if not launches or bound_s <= 0:
        return None
    return 100.0 * bound_s / seconds


@contextlib.contextmanager
def launches_of(run, key: str, module, attr: str, counted):
    """Inside, each call of `module.attr` (a kernel's wrapper) records its
    logits' shape and itemsize, its output size and `counted(args)`, a
    device count of the pixels its work depends on, in run.counted[key]."""
    original = getattr(module, attr)
    seen = run.counted.setdefault(key, [])

    def recording(logits, labels, *args, **kwargs):
        out = original(logits, labels, *args, **kwargs)
        seen.append((tuple(logits.shape), logits.element_size(), tuple(labels.shape[1:]),
                     counted(logits, labels, *args)))
        return out

    setattr(module, attr, recording)
    try:
        yield
    finally:
        setattr(module, attr, original)


def ce_roofline_pct(run, key: str, kernel: str, backward: bool):
    """K2's or K3's bound over the launches recorded in run.counted[key],
    over the device time of `kernel` in the traced window."""
    seen = run.counted.get(key)
    if not seen:
        return None
    bound = sum(counts.ce_bound_s(shape, out_hw, itemsize, int(n), backward)[0]
                for shape, itemsize, out_hw, n in seen)
    return roofline_pct(run, kernel, bound)
