"""FPS micro-benchmark CLI — the reference speed protocol on the card
(counterpart of pidnet_tpu/tools/speed.py).

SwiftNet method: 10 warmup iterations, calibrate the iteration count by
doubling until the timed loop exceeds 1 s, then iterations = int(FPS * 6)
and a final timed loop between `torch.cuda.synchronize` fences. The model
runs the BN-folded path in bf16 unless --no-fold (unfolded fp32). Weights
are random (`init` from a seeded generator).

`--train` times the bf16 training step instead (train/step.py), as the JAX
tool does: PIDNet augment from seeded random weights, FullLoss with its
defaults (OHEM 0.9, kept 131072 scaled to the batch, no class weights), a
seeded device-resident batch of normal images, uniform random labels and
10% edge pixels; 5 warm-up steps, then 20 steps timed as one window
(ms/step, img/s), each step's time beside it, and the peak device memory.

`--aot ARTIFACT` times a serving program (`tools.convert --export-aot`)
under the same protocol instead of building a model: its input shape is
the export's, read from the program, and --a/--c/--r/--batch are ignored.
`--a` takes the PIDNet names and `ddrnet*`/`bisenet*`.

    python -m pidnet_tpu_torch.tools.speed --a pidnet-s --c 19 --r 1024 2048
    python -m pidnet_tpu_torch.tools.speed --train --batch 6 --r 1024 1024
    python -m pidnet_tpu_torch.tools.speed --aot out/pidnet_s_serve.pt2
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from pidnet_tpu_torch import resolve_device
from pidnet_tpu_torch.convert.fold import fold_state_dict
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.tools.common import spec_from_name


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Speed Measurement")
    parser.add_argument("--a", default="pidnet-s",
                        help="pidnet-s, pidnet-m, pidnet-l, ddrnet_23_adb_bag or bisenet_adb_bag")
    parser.add_argument("--c", type=int, default=19, help="number of classes")
    parser.add_argument("--r", type=int, nargs=2, default=[1024, 2048], help="H W")
    parser.add_argument("--no-fold", action="store_true", help="keep BN (fp32 path)")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--train", action="store_true",
                        help="time the bf16 training step (--batch is its batch; the "
                        "reference recipe is 6 at 1024x1024) instead of inference")
    parser.add_argument("--aot", metavar="ARTIFACT",
                        help="time a serving program (tools.convert --export-aot) instead of "
                        "building a model; its input shape rules")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--profile", type=int, default=0, metavar="STEPS",
                        help="also trace STEPS calls (or train steps, or calls of --aot's "
                        "program) with torch.profiler and print the device-busy time per call "
                        "and the kernels that take it")
    return parser.parse_args(argv)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_fps(fn, x, device, *, warmup: int = 10, calibrate_s: float = 1.0,
                run_s: float = 6.0) -> tuple[float, float]:
    """(latency_ms, fps) under the reference calibration protocol."""
    for _ in range(warmup):
        fn(x)
    iterations = 100
    elapsed = 0.0
    while elapsed < calibrate_s:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iterations):
            fn(x)
        _sync(device)
        elapsed = time.perf_counter() - t0
        iterations *= 2
    fps = (iterations / 2) / elapsed
    iterations = max(1, int(fps * run_s))
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iterations):
        fn(x)
    _sync(device)
    latency_ms = (time.perf_counter() - t0) / iterations * 1000.0
    return latency_ms, 1000.0 / latency_ms


def device_breakdown(fn, x, device, steps: int, top: int = 12):
    """(wall ms/call, device-busy ms/call, [(kernel, ms/call, launches/call)])
    over `steps` traced calls; busy time is the sum of the kernels' device
    time (one stream, so they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn(x)
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn(x)
        _sync(device)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
            for e in kernels[:top]]
    return wall / steps * 1e3, busy_us / 1e3 / steps, rows


def print_profile(fn, x, device, steps: int, unit: str) -> None:
    """`device_breakdown` of `steps` calls as lines: wall and device-busy
    ms per call, the idle share, and the kernels that take the time."""
    wall, busy, rows = device_breakdown(fn, x, device, steps)
    print(f"profile over {steps} {unit}s: wall {wall:.3f} ms/{unit}, device busy "
          f"{busy:.3f} ms/{unit} ({busy / wall:.1%}), idle {1 - busy / wall:.1%}")
    for key, ms, count in rows:
        print(f"  {ms:8.4f} ms/{unit}  {count:5.1f} launches/{unit}  {key[:160]}")


WARMUP_STEPS = 5
TIMED_STEPS = 20


def make_train_bench(arch: str, num_classes: int, hw, batch: int, device):
    """(step, batch): the bf16 train step of `arch` from seeded random
    weights with the reference loss (OHEM kept scaled to the batch; the
    family's balance weights, `M.balance_weights`), and a seeded synthetic
    batch on `device`."""
    from pidnet_tpu_torch.losses.criterion import FullLoss
    from pidnet_tpu_torch.train.step import TrainState, make_train_step

    h, w = hw
    spec = spec_from_name(arch, num_classes, augment=True)
    model = M.build(spec, M.init(spec, torch.Generator().manual_seed(0)), device=device,
                    train=True)
    balance = M.balance_weights(spec)
    loss_fn = FullLoss(num_outputs=len(balance), balance_weights=balance, ignore_label=255,
                       ohem_kept=max(1, 131072 * batch // 6))
    step = make_train_step(TrainState.create(model), loss_fn, compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    img = rng.standard_normal((batch, h, w, 3)).astype(np.float32)
    lab = rng.integers(0, num_classes, (batch, h, w)).astype(np.int32)
    edge = (rng.random((batch, h, w)) < 0.1).astype(np.float32)
    return step, tuple(torch.from_numpy(a).to(device) for a in (img, lab, edge))


def measure_train(step, placed, device) -> dict:
    """The JAX tool's protocol: WARMUP_STEPS steps, then TIMED_STEPS steps
    at lr 0.01 timed as one window on the host clock, which ends when the
    last loss is read ("ms_per_step" is the window over the steps, "img_s"
    follows from it). Beside it, the steps of the same window one by one
    ("step_median", "step_min", "step_max", ms): on a GPU from CUDA events
    recorded between steps, which do not wait for the device; on the CPU
    from the host clock."""
    for _ in range(WARMUP_STEPS):
        float(step(*placed, 0.01)["loss"])
    marks = []

    def mark():
        if device.type == "cuda":
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())

    _sync(device)
    t0 = time.perf_counter()
    mark()
    for _ in range(TIMED_STEPS):
        metrics = step(*placed, 0.01)
        mark()
    float(metrics["loss"])
    ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    if device.type == "cuda":
        steps = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        steps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return {"ms_per_step": ms, "img_s": placed[0].shape[0] * 1e3 / ms,
            "step_median": statistics.median(steps), "step_min": min(steps),
            "step_max": max(steps)}


def train_line(r: dict) -> str:
    """One line for measure_train's result."""
    return (f"{r['ms_per_step']:.2f} ms/step over a {TIMED_STEPS}-step window after "
            f"{WARMUP_STEPS} warm-up, {r['img_s']:.1f} img/s; per step median "
            f"{r['step_median']:.2f} ms (min {r['step_min']:.2f}, max {r['step_max']:.2f})")


def build_speed_model(arch: str, num_classes: int, *, fold: bool, device) -> tuple:
    """(model, compute dtype): the folded bf16 model, or with fold=False
    the unfolded fp32 one, on `device` in channels_last."""
    spec = spec_from_name(arch, num_classes, augment=False)
    sd = M.init(spec, torch.Generator().manual_seed(0))
    dtype = torch.bfloat16 if fold else torch.float32
    if fold:
        sd = fold_state_dict(sd, spec)
    model = M.build(spec, sd, folded=fold, device=device).to(dtype)
    return model.to(memory_format=torch.channels_last), dtype


def main_train(args, device) -> None:
    h, w = args.r
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    step, placed = make_train_bench(args.a, args.c, (h, w), args.batch, device)
    print("=========Train-Step Speed Testing=========")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    result = measure_train(step, placed, device)
    peak = (f", peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB allocated"
            if device.type == "cuda" else "")
    print(f"{args.a} train bf16 {h}x{w} batch={args.batch} on {name}: "
          f"{train_line(result)}{peak}")
    if args.profile:
        print_profile(lambda _: step(*placed, 0.01), None, device, args.profile, "step")


def main_aot(args, device) -> None:
    from pidnet_tpu_torch.convert.aot import load_serving

    serve = load_serving(args.aot, device)
    n, h, w, _ = serve.input_shape
    x = torch.zeros(serve.input_shape, dtype=torch.float32, device=device)
    print("=========AOT Artifact Speed Testing=========")
    latency, fps = measure_fps(serve, x, device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{args.aot} {h}x{w} batch={n} on {name}: {latency:.3f} ms, {fps * n:.1f} FPS "
          f"(f32 input -> full-res class map)")
    if args.profile:
        print_profile(serve, x, device, args.profile, "call")



def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.aot:
        return main_aot(args, device)
    if args.train:
        return main_train(args, device)
    h, w = args.r
    model, dtype = build_speed_model(args.a, args.c, fold=not args.no_fold, device=device)
    x = torch.zeros((args.batch, h, w, 3), dtype=dtype, device=device)

    print("=========Speed Testing=========")
    with torch.inference_mode():
        latency, fps = measure_fps(model, x, device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{args.a} {h}x{w} batch={args.batch} on {name}: {latency:.3f} ms, "
          f"{fps * args.batch:.1f} FPS")
    if args.profile:
        with torch.inference_mode():
            print_profile(model, x, device, args.profile, "call")


if __name__ == "__main__":
    main()
