#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. card and build: the card's name and power limit (nvidia-smi), then
   every kernel in pidnet_tpu_torch/csrc built with nvcc for sm_90a;
2. kernels: each kernel against its plain PyTorch version on seeded
   inputs, at every listed shape, in bf16 and fp32, both align_corners
   modes: the fused upsample+argmax (K1, at the serving and the training
   shapes among others), and the fused upsample+CE
   forward (K2: w exact, ignored pixels 0, nll within 1e-4) and backward
   (K3: cosine > 0.99999 against autograd of the plain forward, max-abs
   within 2^-7 of the largest value in bf16, 1e-5 in fp32); each one's
   time (CUDA events, median), the plain version's, a library call's,
   and its bound;
3. slice: PIDNet-S with the train2k weights, BN folded, serving the two
   sample frames at 1024x2048 in bf16 through
   engine.make_inference_classmap; the kernel's launch counter must rise
   by the number of requests; the class maps are gated against the frozen
   fp32 goldens and an fp32 reference (TF32 off); then timed requests;
4. train: PIDNet-S (augment) from seeded random weights trains for
   TRAIN_STEPS steps through engine.train_one_epoch on seeded block-label
   6x1024x1024 crops, with the reference recipe (bf16, OHEM 0.9/131072,
   Cityscapes class weights, SGD 0.9/5e-4, poly LR from 0.01). Gates: every
   loss finite; the mean of the last 5 losses at most 0.7x the mean of the
   first 3; per step exactly 1 K1, 2 K2 and 2 K3 launches; a checkpoint
   written and restored gives identical tensors; on one batch FullLoss
   through the kernels against FullLoss through the plain versions (loss
   rtol 1e-3; pixel accuracy equal but for pixels whose two best classes
   are within 1e-3; each segmentation head's logits-gradient cosine >
   0.9999). Then the train step's speed (tools/speed.py --train) and peak
   memory.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without CUDA, or run outside
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "runs", "train2k", "weights_f16.npz")
GOLDENS = os.path.join(ROOT, "tests", "goldens", "classmaps_train2k.npz")
SAMPLES = os.path.join(ROOT, "samples")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
# exp/log/reciprocal on the special-function units: 16 results per SM per
# clock (CUDA C++ Programming Guide, compute capability 9.0), 132 SMs, at the
# 1.98 GHz boost clock behind the 67 TFLOP/s fp32 figure
SFU_OPS_PER_S = 132 * 16 * 1.98e9

# (N, h, w, C) logits -> (oh, ow): the serving main path, the training main
# path (FullLoss's accuracy), a small batch, CamVid's 90x120 -> 720x960, and
# an identity size
KERNEL_CASES = [
    ((1, 128, 256, 19), (1024, 2048)),
    ((6, 128, 128, 19), (1024, 1024)),
    ((2, 16, 32, 19), (128, 256)),
    ((1, 90, 120, 11), (720, 960)),
    ((1, 128, 256, 19), (128, 256)),
]
MAIN_CASE = KERNEL_CASES[0]
TIMED_REQUESTS = 20

# (N, h, w, C) logits -> (oh, ow) for the loss front: the training main
# path (batch 6 of 1024x1024 crops), CamVid's 720x960, an identity size
CE_CASES = [
    ((6, 128, 128, 19), (1024, 1024)),
    ((2, 90, 120, 11), (720, 960)),
    ((1, 128, 128, 19), (128, 128)),
]
CE_MAIN = CE_CASES[0]

SEED = 304  # the reference's tools/train.py seed, as scripts/train_run_artifact.py
TRAIN_STEPS = 30
TRAIN_POOL = 24  # crops made once and cycled, 4 batches of 6
TRAIN_NUM_ITERS = 2000  # the poly schedule's length, as scripts/train_run_artifact.py


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, batches: int = 10, per_batch: int = 20) -> float:
    """Median over `batches` of the mean time of `per_batch` back-to-back
    calls, from CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def upsample_argmax_bound_ms(shape, out_hw, itemsize: int) -> tuple[float, str]:
    """Least time for the function on an H100: the larger of its bytes
    (logits read once, class map written once) over 3.35 TB/s and its
    fp32 operations over 67 TFLOP/s. Operations are counted for the
    separable form: a W-lerp (3 flops) per source row, output column and
    class, an H-lerp (3 flops) and a compare per output pixel and class."""
    n, h, w, c = shape
    oh, ow = out_hw
    nbytes = n * h * w * c * itemsize + n * oh * ow * 4
    ops = n * h * ow * c * 3 + n * oh * ow * c * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, ua) -> dict:
    """K1 against its plain version; returns its JSON entry (no launches yet)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    max_abs_err = 0.0
    for shape, out_hw in KERNEL_CASES:
        base = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 2).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            x = base.to(dtype)
            for align in (True, False):
                # the plain fp32 upsample decides which pixels must match exactly
                up = F.interpolate(x.permute(0, 3, 1, 2).float(), size=out_hw, mode="bilinear",
                                   align_corners=align)
                got = ua.upsample_argmax(x, out_hw, align)
                want = ua.upsample_argmax_plain(x, out_hw, align)
                torch.cuda.synchronize()
                check(got.shape == want.shape == (shape[0], *out_hw) and got.dtype == torch.int32,
                      f"kernel output {got.shape} {got.dtype}, plain {want.shape}")
                top2 = up.topk(2, dim=1).values
                margin = top2[:, 0] - top2[:, 1]
                same = got == want
                agree = same.float().mean().item()
                confident_miss = int((~same & (margin > 1e-3)).sum().item())
                # logit gap between the kernel's class and the plain version's
                gap = (up.gather(1, want.long()[:, None]) - up.gather(1, got.long()[:, None]))
                err = gap.abs().max().item()
                max_abs_err = max(max_abs_err, err)
                print(f"kernel upsample_argmax {tuple(shape)}->{out_hw} {str(dtype)[6:]} "
                      f"align_corners={align}: agreement {agree:.6f}, "
                      f"confident mismatches {confident_miss}, max logit gap {err:.3e}")
                check(agree >= 0.9999 and confident_miss == 0,
                      f"kernel disagrees with its plain version: {agree}, {confident_miss}")

    shape, out_hw = MAIN_CASE
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 2).cuda()
    x = x.to(torch.bfloat16)
    ms = time_ms(lambda: ua.upsample_argmax(x, out_hw, True))
    plain_ms = time_ms(lambda: ua.upsample_argmax_plain(x, out_hw, True))
    xn = x.permute(0, 3, 1, 2)
    library_ms = time_ms(lambda: torch.argmax(
        F.interpolate(xn, size=out_hw, mode="bilinear", align_corners=True), dim=1))
    bound_ms, bound_by = upsample_argmax_bound_ms(shape, out_hw, x.element_size())
    print(f"kernel upsample_argmax {shape}->{out_hw} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"F.interpolate+argmax {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / ms:.1%} of bound")
    return {
        "name": "upsample_argmax", "route": "cuda",
        "source": "pidnet_tpu_torch/csrc/upsample_argmax.cu",
        "replaces": "pidnet_tpu/ops/upsample_argmax.py:44",
        "launches": None, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def ce_bound_ms(shape, out_hw, itemsize: int, counted: int, backward: bool):
    """Least time for the loss front on an H100 on this run's data: the
    largest of its bytes (logits, labels and, backward, g read once; the
    fp32 maps or dL written once) over 3.35 TB/s, its fp32 operations over
    67 TFLOP/s, and its exp/log/reciprocal over the special-function rate.
    `counted` is the number of pixels that need the softmax: label in
    [0, C) and, backward, g != 0. Operations follow the separable form: a
    W-lerp (3 flops) per source row, output column and class, an H-lerp (3)
    per counted pixel and class; forward, the logsumexp (3 per class and
    one exp, one log per pixel); backward, the softmax and dz (4 per class
    and one exp, one reciprocal per pixel) and the two adjoint lerps (4 each)."""
    n, h, w, c = shape
    oh, ow = out_hw
    pixels = n * oh * ow
    logits = n * h * w * c * itemsize
    if backward:
        nbytes = logits + 2 * pixels * 4 + n * h * w * c * 4
        flops = 7 * n * h * ow * c + 11 * counted * c
    else:
        nbytes = logits + pixels * 4 + c * 4 + 2 * pixels * 4
        flops = 3 * n * h * ow * c + 6 * counted * c
    special = counted * (c + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_FLOPS, special / SFU_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ce_inputs(torch, rng, shape, out_hw):
    """Seeded logits, labels (about 1/10 ignore, a few outside [0, C)),
    class weights and an nll-map gradient with some zero rows, on the card."""
    n, _, _, c = shape
    logits = torch.from_numpy((rng.standard_normal(shape) * 2).astype(np.float32)).cuda()
    lab = rng.integers(0, c, (n, *out_hw))
    lab = np.where(rng.random((n, *out_hw)) < 0.1, 255, lab)
    lab[:, 0, :7] = c + 3
    labels = torch.from_numpy(lab.astype(np.int32)).cuda()
    cw = torch.from_numpy((0.8 + rng.random(c)).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.random((n, *out_hw)).astype(np.float32)).cuda()
    g[:, 1] = 0
    return logits, labels, cw, g


def phase_ce_front(torch, cf) -> tuple[dict, dict]:
    """K2 and K3 against their plain versions; returns their JSON entries."""
    import torch.nn.functional as F

    rng = np.random.default_rng(1)
    err_fwd = err_bwd = 0.0
    for shape, out_hw in CE_CASES:
        base, labels, cw, g = ce_inputs(torch, rng, shape, out_hw)
        ignored = labels == 255
        for dtype in (torch.bfloat16, torch.float32):
            x = base.to(dtype)
            for align in (True, False):
                nll, w = cf.ce_front_fwd(x, labels, cw, 255, out_hw, align)
                dl = cf.ce_front_bwd(x, labels, 255, out_hw, align, g)
                xr = x.detach().clone().requires_grad_()
                nll_p, w_p = cf.ce_front_fwd_plain(xr, labels, cw, 255, out_hw, align)
                (dl_p,) = torch.autograd.grad(nll_p, xr, g)
                torch.cuda.synchronize()
                check(nll.shape == w.shape == labels.shape and nll.dtype == w.dtype == torch.float32
                      and dl.shape == x.shape and dl.dtype == dtype,
                      f"ce_front outputs {nll.shape} {w.shape} {dl.shape} {dl.dtype}")
                e_f = (nll - nll_p).abs().max().item()
                a, b = dl.float().flatten(), dl_p.float().flatten()
                cos = (a @ b / (a.norm() * b.norm())).item()
                e_b = (a - b).abs().max().item()
                tol_b = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * b.abs().max().item()
                err_fwd, err_bwd = max(err_fwd, e_f), max(err_bwd, e_b)
                inert = not nll[ignored].any().item() and not w[ignored].any().item()
                print(f"kernel ce_front {shape}->{out_hw} {str(dtype)[6:]} align_corners={align}: "
                      f"w exact {torch.equal(w, w_p)}, ignored inert {inert}, nll max err "
                      f"{e_f:.3e}; dL cos {cos:.8f}, max err {e_b:.3e} (<= {tol_b:.3e})")
                check(torch.equal(w, w_p) and inert and e_f <= 1e-4,
                      "ce_front_fwd disagrees with its plain version")
                check(cos > 0.99999 and e_b <= tol_b,
                      "ce_front_bwd disagrees with autograd of the plain forward")

    shape, out_hw = CE_MAIN
    base, labels, cw, g = ce_inputs(torch, rng, shape, out_hw)
    x = base.to(torch.bfloat16)
    counted = (labels >= 0) & (labels < shape[3])
    n_fwd, n_bwd = int(counted.sum()), int((counted & (g != 0)).sum())
    xn = x.permute(0, 3, 1, 2)
    lab_long = torch.where(counted, labels, 255).long()  # F.cross_entropy asserts on the rest

    def library_fwd(inp):
        up = F.interpolate(inp, size=out_hw, mode="bilinear", align_corners=True)
        return F.cross_entropy(up.float(), lab_long, reduction="none", ignore_index=255)

    xr = xn.detach().clone().requires_grad_()
    loss_map = library_fwd(xr)
    entries = []
    for name, line, kernel, plain, library, n_counted, backward, err in (
        ("ce_front_fwd", 121, lambda: cf.ce_front_fwd(x, labels, cw, 255, out_hw, True),
         lambda: cf.ce_front_fwd_plain(x, labels, cw, 255, out_hw, True),
         lambda: library_fwd(xn), n_fwd, False, err_fwd),
        ("ce_front_bwd", 150, lambda: cf.ce_front_bwd(x, labels, 255, out_hw, True, g),
         lambda: cf.ce_front_bwd_plain(x, labels, 255, out_hw, True, g),
         lambda: torch.autograd.grad(loss_map, xr, g, retain_graph=True), n_bwd, True, err_bwd),
    ):
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, batches=5, per_batch=5)
        library_ms = time_ms(library, batches=5, per_batch=5)
        bound_ms, bound_by = ce_bound_ms(shape, out_hw, x.element_size(), n_counted, backward)
        print(f"kernel {name} {shape}->{out_hw} bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{n_counted} counted pixels), {bound_ms / ms:.1%} of bound")
        entries.append({
            "name": name, "route": "cuda", "source": "pidnet_tpu_torch/csrc/ce_front.cu",
            "replaces": f"pidnet_tpu/ops/ce_front.py:{line}", "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
        })
    return entries[0], entries[1]


def fp32_reference(torch, M, sd, x):
    """Unfolded fp32 PIDNet-S, output head 1 of augment=True, upsampled
    with align_corners=True: (class map, top-2 margin) on the card."""
    import torch.nn.functional as F

    spec = M.spec_for("pidnet_s", 19, augment=True)
    model = M.build(spec, sd, device="cuda").to(memory_format=torch.channels_last)
    with torch.inference_mode():
        logits = model(torch.from_numpy(x).cuda())[1]
        up = F.interpolate(logits.permute(0, 3, 1, 2), size=x.shape[1:3], mode="bilinear",
                           align_corners=True)
        top2 = up.topk(2, dim=1).values
        return up.argmax(dim=1).int().cpu().numpy(), (top2[:, 0] - top2[:, 1]).cpu().numpy()


def phase_slice(torch, card: str) -> int:
    """Serve the sample frames; returns the number of requests served."""
    from pidnet_tpu_torch import engine
    from pidnet_tpu_torch.convert.fold import fold_state_dict
    from pidnet_tpu_torch.convert.weights import load_npz
    from pidnet_tpu_torch.data.png import read_png
    from pidnet_tpu_torch.data.transforms import input_transform
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.ops import upsample_argmax as ua

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"slice: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    sd = load_npz(WEIGHTS)
    spec = M.spec_for("pidnet_s", 19, augment=False)
    folded = fold_state_dict(sd, spec)
    goldens = np.load(GOLDENS)
    frames = {name: input_transform(read_png(os.path.join(SAMPLES, name)), bgr_to_rgb=False)[None]
              for name in goldens.files}
    cfg = engine.config()
    serve = engine.make_inference_classmap(cfg, spec, folded, folded=True,
                                           compute_dtype=torch.bfloat16)
    serve32 = engine.make_inference_classmap(cfg, spec, folded, folded=True)

    ua.launches = 0  # the main path starts here
    requests = 0
    for name, x in frames.items():
        got = serve(x).cpu().numpy()[0]
        got32 = serve32(x).cpu().numpy()[0]
        requests += 2
        ref, margin = fp32_reference(torch, M, sd, x)
        ref, margin = ref[0], margin[0]
        check(got.shape == got32.shape == ref.shape == goldens[name].shape == (1024, 2048)
              and got.dtype == np.int32 and 0 <= got.min() and got.max() < 19,
              f"served map {got.shape} {got.dtype} [{got.min()}, {got.max()}]")
        golden = float((ref == goldens[name]).mean())
        pipeline = float((got32 == ref).mean())
        conf = margin > 1.0
        confident = float((got == ref)[conf].mean())
        print(f"slice {name}: fp32 vs goldens {golden:.6f} (>=0.995), folded fp32 vs fp32 "
              f"{pipeline:.6f} (>=0.9995), bf16 vs fp32 on margin>1.0 {confident:.6f} "
              f"(>=0.9999, {conf.mean():.3f} of pixels), bf16 vs fp32 all "
              f"{float((got == ref).mean()):.6f}")
        check(golden >= 0.995 and pipeline >= 0.9995 and confident >= 0.9999,
              f"{name}: a numerics gate failed")

    x = torch.from_numpy(next(iter(frames.values()))).cuda()
    for _ in range(5):
        serve(x)
    requests += 5
    times = []
    for _ in range(TIMED_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    requests += TIMED_REQUESTS
    mean = statistics.fmean(times)
    print(f"slice serve PIDNet-S bf16 folded 1x1024x2048 -> class map, device-resident fp32 "
          f"input, {TIMED_REQUESTS} requests: median {statistics.median(times):.3f} ms/img, "
          f"mean {mean:.3f} ms/img, {1e3 / mean:.1f} FPS [{card}]")
    check(ua.launches == requests,
          f"upsample_argmax launched {ua.launches} times for {requests} requests")
    print(f"slice: upsample_argmax launches {ua.launches} for {requests} requests")
    return requests


class _NoWriter:
    def add_scalar(self, tag, value, step):
        pass


@contextlib.contextmanager
def plain_versions(cf, ua, criterion):
    """FullLoss through the plain versions of K1-K3 on CUDA tensors, for
    the comparison only: the wrappers never fall back on their own."""
    saved = (cf.ce_front_fwd, cf.ce_front_bwd, criterion.upsample_argmax)
    cf.ce_front_fwd, cf.ce_front_bwd = cf.ce_front_fwd_plain, cf.ce_front_bwd_plain
    criterion.upsample_argmax = ua.upsample_argmax_plain
    try:
        yield
    finally:
        cf.ce_front_fwd, cf.ce_front_bwd, criterion.upsample_argmax = saved


def phase_train(torch, card: str) -> dict:
    """Train PIDNet-S through engine.train_one_epoch; returns the launch
    counts of that run by kernel."""
    import torch.nn.functional as F

    from pidnet_tpu_torch import engine
    from pidnet_tpu_torch.data.cityscapes import CLASS_WEIGHTS
    from pidnet_tpu_torch.data.synthetic import synthetic_epoch
    from pidnet_tpu_torch.losses import criterion
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.ops import ce_front as cf
    from pidnet_tpu_torch.ops import upsample_argmax as ua
    from pidnet_tpu_torch.tools import speed
    from pidnet_tpu_torch.train import checkpoint
    from pidnet_tpu_torch.train.step import TrainState, make_train_step

    dev = torch.device("cuda")
    spec = M.spec_for("pidnet_s", 19, augment=True)

    def fresh_state(seed: int) -> TrainState:
        sd = M.init(spec, torch.Generator().manual_seed(seed))
        return TrainState.create(M.build(spec, sd, device=dev, train=True))

    t0 = time.perf_counter()
    ts = fresh_state(SEED)
    loss_fn = criterion.FullLoss(ignore_label=255, class_weights=CLASS_WEIGHTS, use_ohem=True,
                                 ohem_thres=0.9, ohem_kept=131072, balance_weights=(0.4, 1.0),
                                 sb_weights=1.0)
    step = make_train_step(ts, loss_fn, momentum=0.9, weight_decay=5e-4,
                           compute_dtype=torch.bfloat16)
    images, labels, edges = synthetic_epoch(np.random.default_rng(SEED), TRAIN_POOL, 1024)
    pool = [tuple(torch.from_numpy(a[i:i + 6]).to(dev) for a in (images, labels, edges))
            for i in range(0, TRAIN_POOL, 6)]
    del images, labels, edges
    loader = [(*pool[i % len(pool)], None, None) for i in range(TRAIN_STEPS)]
    print(f"train: PIDNet-S augment, batch 6x1024x1024 bf16, {TRAIN_STEPS} steps over "
          f"{len(pool)} seeded block-label batches; set-up {time.perf_counter() - t0:.1f} s")

    history = []

    def recording_step(*args):
        metrics = step(*args)
        history.append(metrics)
        return metrics

    logging.basicConfig(level=logging.INFO, stream=sys.stdout, format="train: %(message)s")
    ua.launches = cf.fwd_launches = cf.bwd_launches = 0  # the main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, done = engine.train_one_epoch(engine.config(print_freq=10), 0, TRAIN_STEPS,
                                     TRAIN_NUM_ITERS, 0.01, loader, recording_step, ts,
                                     {"writer": _NoWriter(), "train_global_steps": 0})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"upsample_argmax": ua.launches, "ce_front_fwd": cf.fwd_launches,
              "ce_front_bwd": cf.bwd_launches}
    losses = [float(m["loss"]) for m in history]
    first, last = statistics.fmean(losses[:3]), statistics.fmean(losses[-5:])
    print(f"train: {done} steps in {wall:.2f} s ({wall / done * 1e3:.1f} ms/step with the "
          f"epoch loop); losses {[round(v, 4) for v in losses]}")
    print(f"train: mean of first 3 {first:.4f}, of last 5 {last:.4f} (ratio {last / first:.3f}, "
          f"<= 0.7); acc {float(history[0]['acc']):.4f} -> {float(history[-1]['acc']):.4f}; "
          f"launches {counts}")
    check(done == TRAIN_STEPS and all(np.isfinite(losses)), "a training loss is not finite")
    check(last <= 0.7 * first, "the training loss did not fall")
    check(counts == {"upsample_argmax": done, "ce_front_fwd": 2 * done,
                     "ce_front_bwd": 2 * done},
          f"launch counts {counts} for {done} steps, want 1/2/2 per step")

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT)
    try:
        checkpoint.save_train_checkpoint(out_dir, 0, 0.0, ts, it=done)
        restored = checkpoint.restore_train_state(fresh_state(SEED + 1),
                                                  checkpoint.load_train_checkpoint(out_dir))
    finally:
        shutil.rmtree(out_dir)
    same = all(torch.equal(a[k], b[k]) for a, b in ((restored.params(), ts.params()),
                                                     (restored.state(), ts.state()),
                                                     (restored.momentum, ts.momentum))
               for k in b)
    print(f"train: checkpoint round trip identical {same}")
    check(same, "a restored checkpoint differs from the state it saved")
    del restored

    x, lab, edge = pool[0]
    with torch.no_grad():
        heads = [h.detach() for h in ts.model(x.to(torch.bfloat16))]

    def full_loss():
        hs = [h.clone().requires_grad_() for h in heads]
        loss, metrics = loss_fn(hs, lab, edge)
        grads = torch.autograd.grad(loss, hs)
        return float(loss.detach()), float(metrics["acc"]), [g.float().flatten() for g in grads]

    loss_k, acc_k, grads_k = full_loss()
    with plain_versions(cf, ua, criterion):
        loss_p, acc_p, grads_p = full_loss()
    cos = [(a @ b / (a.norm() * b.norm())).item() for a, b in zip(grads_k, grads_p)]
    # the accuracy may differ only on pixels where the final head's two best
    # classes are within 1e-3 (the kernel phase's bound for K1)
    up =F.interpolate(heads[1].permute(0, 3, 1, 2).float(), size=tuple(lab.shape[1:]),
                       mode="bilinear", align_corners=True)
    top2 = up.topk(2, dim=1).values
    counted = lab >= 0
    near_ties = int(((top2[:, 0] - top2[:, 1] <= 1e-3) & counted).sum())
    n_counted = int(counted.sum())
    del up, top2
    print(f"train: FullLoss kernels {loss_k:.6f} vs plain {loss_p:.6f} (rtol "
          f"{abs(loss_k - loss_p) / abs(loss_p):.2e}, <= 1e-3); acc {acc_k:.8f} vs "
          f"{acc_p:.8f} ({abs(acc_k - acc_p) * n_counted:.1f} pixels apart, <= {near_ties} "
          f"near ties + 1); logits-gradient cos, p head {cos[0]:.8f}, final head "
          f"{cos[1]:.8f} (> 0.9999); boundary head {cos[2]:.8f} (no kernel on its gradient: "
          f"run-to-run noise of the bf16 bilinear backward, not gated)")
    check(abs(loss_k - loss_p) <= 1e-3 * abs(loss_p) and min(cos[:2]) > 0.9999
          and abs(acc_k - acc_p) <= (near_ties + 1) / n_counted,
          "FullLoss through the kernels disagrees with the plain versions")

    del ts, step, pool, loader, heads, history, grads_k, grads_p
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bench_step, placed = speed.make_train_bench("pidnet-s", 19, (1024, 1024), 6, dev)
    result = speed.measure_train(bench_step, placed, dev)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train speed PIDNet-S bf16 6x1024x1024 (tools/speed.py --train): "
          f"{speed.train_line(result)}, peak {peak:.2f} GiB allocated [{card}]")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pidnet_tpu_torch.ops import _build
    from pidnet_tpu_torch.ops import ce_front as cf
    from pidnet_tpu_torch.ops import upsample_argmax as ua

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build(_build.sources(), verbose=True)
    print(f"build: {_build.sources()} in {time.perf_counter() - t0:.1f} s")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    k1 = phase_kernels(torch, ua)
    k2, k3 = phase_ce_front(torch, cf)
    phase_slice(torch, card)
    served = ua.launches
    counts = phase_train(torch, card)
    k1["launches"] = served + counts["upsample_argmax"]
    k2["launches"] = counts["ce_front_fwd"]
    k3["launches"] = counts["ce_front_bwd"]
    print(f"launches on the main paths: upsample_argmax {served} serving + "
          f"{counts['upsample_argmax']} training, ce_front_fwd {k2['launches']}, "
          f"ce_front_bwd {k3['launches']}")

    print(card)
    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
