"""Kernel timing on the card, and the card's name and power limit, for the
measuring tools (tools/conv_ab.py, chip_smoke.py)."""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


def card_line() -> str:
    """The card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, device="cuda", batches: int = 10, per_batch: int = 20) -> float:
    """Median over `batches` of the mean time of `per_batch` back-to-back
    calls of `fn`, after 3 warm-up calls: from CUDA events on a CUDA
    device, from the host clock otherwise."""
    device = torch.device(device)
    for _ in range(3):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times = []
    for _ in range(batches):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_batch):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / per_batch)
        else:
            t0 = time.perf_counter()
            for _ in range(per_batch):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / per_batch)
    return statistics.median(times)
