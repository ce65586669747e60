"""Serving: a closed loop of calls into the program's class-map entry,
`engine.make_inference_classmap`, on the BN-folded model in the configured
dtype (convert/fold.py folds the harness's seeded weights, as a user folds
a checkpoint).

Each call takes one of the mix's pre-made batches of device-resident
NHWC float32 frames, in turn, and returns their (N,H,W) int32 class maps;
the loop waits for each map before the next call. A call's latency runs
from the host's call to its map's completion, stamped by CUDA events on
the card: the start event is recorded before the call on an idle card, so
the card stamps it within microseconds of the call. `traffic` keys: batch,
height, width, batches, warmup_calls, trace_calls, sampled_calls.

`correct` (`judge`): once the window has closed, the reference runs in
float32 over the frames of `sampled_calls` calls drawn from the seed among
those the window completed (reservoir sampling) and reads, at every pixel,
how far the reference's logit of the served class lies below its best
logit, in units of the frame's logit spread (the standard deviation of the
reference's logits). Two numbers are compared: `gap`, the widest such
reading, and `wrong8`, the most pixels of any 8x8 window of a frame whose
reading exceeds `TAU`: a wrong class map in one place (a tile's edge, a
border row, a band of columns) moves it where it may leave `gap` alone.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.harness import inputs
from perfbench.harness.cell import mark
from perfbench.harness.program import DTYPES, spec_of
from perfbench.reference.quant import float8

REF_BLOCK = 2  # frames the reference runs at once
WINDOW = 8  # the side of the windows `wrong8` counts in
TAU = 0.5  # the gap, in units of the frame's logit spread, that `wrong8` counts above
TAUS = (0.2, 0.3, 0.4, 0.5, 0.6, 0.8)  # the thresholds read beside it (calibrate.py)
PATCH = 8  # the side of the patch the `altered` fault shifts


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _faulty(infer, fault: str | None, classes: int):
    """The call with a planted fault (the benchmark's own tests)."""
    if fault is None:
        return infer
    if fault == "altered":
        def altered(x):  # one PATCH x PATCH patch of the first map, off the windows' grid
            out = infer(x).clone()
            y, x0 = out.shape[1] // 3, out.shape[2] // 3
            patch = out[0, y:y + PATCH, x0:x0 + PATCH]
            patch.copy_((patch + classes // 2) % classes)
            return out
        return altered
    if fault == "half_batch":
        def half(x):
            out = infer(x[: x.shape[0] // 2])
            return torch.cat([out, out])
        return half
    raise ValueError(f"serve has no fault {fault!r}")


def setup(run) -> dict:
    from pidnet_tpu_torch import engine
    from pidnet_tpu_torch.convert.fold import fold_state_dict

    cfg, serve = run.config, run.config["serve"]
    mark(run, "port_imports")
    spec = spec_of(cfg, augment=False)
    torch.empty(0, device=run.device)  # the CUDA context
    mark(run, "context")
    weights = inputs.weights(cfg, run.device, run.seed)
    mark(run, "weights")
    folded = fold_state_dict(weights, spec)
    ecfg = engine.config(align_corners=serve["align_corners"])
    infer = engine.make_inference_classmap(ecfg, spec, folded, folded=True,
                                           compute_dtype=DTYPES[serve["dtype"]],
                                           device=run.device)
    del folded
    mark(run, "program")
    frames = inputs.frames(run.traffic, run.device, run.seed)
    infer = _faulty(infer, run.fault, cfg["num_classes"])
    mark(run, "frames")
    for i in range(run.traffic["warmup_calls"]):
        infer(frames[i % len(frames)])
        _sync(run.device)
        mark(run, f"call{i}")
    return {"infer": infer, "weights": weights, "frames": frames, "kept": []}


def window(run, st: dict, seconds: float) -> dict:
    infer, frames, dev = st["infer"], st["frames"], run.device
    k = run.traffic["sampled_calls"]
    rng = np.random.default_rng(run.seed)
    cuda = dev.type == "cuda"
    marks, enqueue, kept = [], [], st["kept"]
    _sync(dev)
    t0 = time.perf_counter()
    calls = 0
    while True:
        b = calls % len(frames)
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t = time.perf_counter()
        out = infer(frames[b])
        enqueue.append(time.perf_counter() - t)
        if cuda:
            end.record()
            end.synchronize()
            marks.append((start, end))
        else:
            marks.append(time.perf_counter() - t)
        if calls < k:
            kept.append((b, out))
        else:
            j = int(rng.integers(0, calls + 1))
            if j < k:
                kept[j] = (b, out)
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    lat = [s.elapsed_time(e) for s, e in marks] if cuda else [m * 1e3 for m in marks]
    n = frames[0].shape[0]
    return {"window_s": window_s, "calls": calls, "units": calls * n, "latencies_ms": lat,
            "enqueue_s": enqueue, "attempted": calls, "failed": 0}


def profile(run, st: dict) -> tuple:
    """(the profiled callable, the number of calls)."""
    frames = st["frames"]
    return (lambda i: st["infer"](frames[i % len(frames)])), run.traffic["trace_calls"]


def _reference_maps(run, st, b: int, low: bool = False):
    """Yields (frame index, float32 logits (C,h,w)) of batch b: the
    reference's, or with `low` the control's (`float8`)."""
    x = st["frames"][b]
    for f0 in range(0, x.shape[0], REF_BLOCK):
        ref = inputs.reference(run.config)
        net = ref.Net(st["weights"])
        with torch.no_grad(), (float8() if low else contextlib.nullcontext()):
            z = ref.forward(net, x[f0:f0 + REF_BLOCK].permute(0, 3, 1, 2), {**run.config,
                                                                         "augment": False})
        for i in range(z.shape[0]):
            yield f0 + i, z[i]


def _windowed(mask: torch.Tensor) -> int:
    """The most set pixels of any WINDOW x WINDOW window of an (h,w) mask."""
    pooled = F.avg_pool2d(mask[None, None].float(), WINDOW, stride=1)
    return int(round(float(pooled.max()) * WINDOW * WINDOW))


def _gaps(run, st, maps_of) -> dict:
    """The readings over the sampled calls; `maps_of(b, out, f)` gives
    the class map judged of frame f of batch b (the program's, or the
    control's): `gap`, the widest gap; `wrong8`, the most pixels of a
    window whose gap exceeds TAU; and that count at each threshold of
    TAUS (`wrong8_at`)."""
    h, w = run.traffic["height"], run.traffic["width"]
    align = run.config["serve"]["align_corners"]
    widest = 0.0
    window = {t: 0 for t in TAUS}
    for b, out in st["kept"]:
        for f, z in _reference_maps(run, st, b):
            served = maps_of(b, out, f)
            up = F.interpolate(z[None], size=(h, w), mode="bilinear", align_corners=align)[0]
            gap = (up.max(0).values - up.gather(0, served[None].long())[0]) / z.std()
            widest = max(widest, float(gap.max()))
            for t in TAUS:
                window[t] = max(window[t], _windowed(gap > t))
            del up, gap
    return {"gap": widest, "wrong8": window[TAU],
            "wrong8_at": {str(t): v for t, v in window.items()}}


def compared(r: dict) -> dict:
    """The numbers `correct` holds to their limits (perfbench/limits/)."""
    return {"gap": r["gap"], "wrong8": r["wrong8"]}


def free(st: dict) -> None:
    st["infer"] = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def judge(run, st: dict) -> dict:
    free(st)
    st["readings"] = _gaps(run, st, lambda b, out, f: out[f])
    return compared(st["readings"])


def control(run, st: dict) -> dict:
    """The control's reading: the reference in float8 put in the
    program's place, on the frames of the calls `window` sampled."""
    free(st)
    h, w = run.traffic["height"], run.traffic["width"]
    align = run.config["serve"]["align_corners"]
    low = {}

    def maps_of(b, out, f):
        if (b, f) not in low:
            for i, z in _reference_maps(run, st, b, low=True):
                up = F.interpolate(z[None], size=(h, w), mode="bilinear", align_corners=align)
                low[(b, i)] = up[0].argmax(0)
        return low.pop((b, f))

    st["readings"] = _gaps(run, st, maps_of)
    return compared(st["readings"])
