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
   within 2^-7 of the largest value in bf16, 1e-5 in fp32), each with two
   launches on the same inputs bit-identical and its plan at each shape
   (bands, tiles, blocks, shared memory, cross-checked against the
   kernel's own layout); each one's time (CUDA events, median), the plain
   version's, a library call's, and its bound; K1's, K2's and K3's device
   time under torch.profiler beside their event times, and K2's time at
   the eval shape;
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
   memory, and a profile of 5 steps: device busy per step and K2's and
   K3's device time in it;
5. conv: the fused 3x3 conv (K4) against its plain version at the three
   A/B shapes of tools/conv_ab.py and four small ones (W = 24, pixel tiles
   straddling the bottom and right edges, W = 200 among them), each with
   its tile plan, with every epilogue (none, bias, ReLU, bias+ReLU,
   statistics) and bf16 and fp32 outputs: y within one bf16 ulp (atol
   0.0079, rtol 0.01; fp32 within 1e-4 + 1e-4|y|), the statistics within
   2e-5 of the sums of the kernel's own fp32 output; then the A/B entry
   point (tools/conv_ab.run: K4 against cuDNN, three modes per shape),
   whose K4 launches must all be counted, and the plain version's time,
   the bound, and K4's device time under torch.profiler beside conv_ab's
   event window and the host's time to enqueue a call at each A/B shape;
6. eval: PIDNet-S augment with the train2k weights, unfolded, eval mode,
   on the two sample frames with the frozen fp32 goldens as labels (edges:
   a 4-neighbour label change of the goldens, a cv2-free stand-in for the
   dataset's Canny edges): engine.validate over batches [f0, f1], [f0]
   (the last padded and masked), in fp32 and bf16 through make_eval_step.
   Gates: each matrix totals the real labelled pixels exactly, final-head
   pixel accuracy >= 0.995 in fp32 and >= 0.98 in bf16, per batch 3 K1
   launches in bf16 and 1 in fp32, 2 K2 and 0 K3. Then engine.testval
   through the folded bf16 class-map closure, its mIoU and pixel accuracy
   equal to numpy's on the same maps; TTA (folded bf16) on one frame,
   single-scale, flip only, and TEST.SCALE_LIST + flip (windows above scale
   1): every value finite, and the class maps of flip and of 6 scales +
   flip each within 0.01 of the JAX package's recorded agreement with its
   single-scale map on this frame and these weights (0.863 and 0.811,
   docs/DESIGN.md round 5); and identity TTA in fp32 against
   engine.make_inference within 0.01 in clipped log-probability. A bf16
   val batch and a 6-scale + flip TTA frame are profiled (device busy and
   their largest kernels).

The line before the last is a JSON object with one entry per kernel, its
launches counted over every path that ran it; the last line is
{"ok": true, "device": {...}}. Without CUDA, or run outside
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import logging
import os
import shutil
import statistics
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
# path (batch 6 of 1024x1024 crops), the eval path (a val batch of two
# 1024x2048 frames), CamVid's 720x960, an identity size, 100 classes (four
# lanes a pixel)
CE_CASES = [
    ((6, 128, 128, 19), (1024, 1024)),
    ((2, 128, 256, 19), (1024, 2048)),
    ((2, 90, 120, 11), (720, 960)),
    ((1, 128, 128, 19), (128, 128)),
    ((1, 16, 16, 100), (128, 128)),
]
CE_MAIN, CE_EVAL = CE_CASES[0], CE_CASES[1]

# (N, H, W, C) of the fused 3x3 conv: the A/B shapes of tools/conv_ab.py,
# then a width that is no multiple of a tile, a small batch, pixel tiles
# that straddle both the bottom and the right edge, and a width above 128
CONV_CASES = [(8, 128, 128, 128), (8, 32, 32, 256), (8, 16, 16, 512), (1, 16, 24, 128),
              (2, 32, 32, 128), (3, 13, 40, 128), (1, 5, 200, 128)]
CONV_EPILOGUES = [dict(), dict(bias=True), dict(relu=True), dict(bias=True, relu=True),
                  dict(stats=True), dict(bias=True, relu=True, stats=True)]
BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores

SEED = 304  # the reference's tools/train.py seed, as scripts/train_run_artifact.py
TRAIN_STEPS = 30
TRAIN_POOL = 24  # crops made once and cycled, 4 batches of 6
TRAIN_NUM_ITERS = 2000  # the poly schedule's length, as scripts/train_run_artifact.py


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


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

    from pidnet_tpu_torch.utils.timing import time_ms

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
    k1_ms, call_ms = kernel_device_ms(torch, lambda: ua.upsample_argmax(x, out_hw, True),
                                      "upsample_argmax_kernel")
    print(f"upsample_argmax {shape}->{out_hw} bf16 on the device alone (torch.profiler, 20 "
          f"calls): kernel {k1_ms:.4f} ms, every kernel of the call {call_ms:.4f} ms, event "
          f"window {ms:.4f} ms ({ms / k1_ms - 1:+.1%})")
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

    from pidnet_tpu_torch.ops._build import library
    from pidnet_tpu_torch.utils.timing import time_ms

    rng = np.random.default_rng(1)
    err_fwd = err_bwd = 0.0
    smem_bytes = library("ce_front").ce_bwd_smem_bytes  # the kernels' own layouts
    smem_bytes.argtypes, smem_bytes.restype = [ctypes.c_int] * 6, ctypes.c_longlong
    fwd_smem_bytes = library("ce_front").ce_fwd_smem_bytes
    fwd_smem_bytes.argtypes, fwd_smem_bytes.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    for shape, out_hw in CE_CASES:
        base, labels, cw, g = ce_inputs(torch, rng, shape, out_hw)
        ignored = labels == 255
        for dtype in (torch.bfloat16, torch.float32):
            x = base.to(dtype)
            fp = cf.forward_plan(*shape, *out_hw, True, x.element_size())
            own = fwd_smem_bytes(shape[3], fp.window, fp.lpp, x.element_size())
            print(f"ce_front_fwd plan {shape}->{out_hw} {str(dtype)[6:]}: {len(fp.rows)} band(s) "
                  f"of {fp.band} output rows, {len(fp.cols)} tile(s) of {fp.tile} output columns, "
                  f"{fp.blocks} blocks of {fp.threads} threads ({fp.lpp} lane(s) a pixel), window "
                  f"of {fp.window} source pixels, shared memory {fp.smem} bytes a block (the "
                  f"kernel's layout: {own})")
            check(own == fp.smem, "the forward plan's shared memory differs from the kernel's")
            plan = cf.backward_plan(*shape, *out_hw, True, x.element_size())
            own = smem_bytes(shape[3], plan.band, plan.tile, plan.xw, plan.lpp, x.element_size())
            print(f"ce_front_bwd plan {shape}->{out_hw} {str(dtype)[6:]}: band {plan.band} rows, "
                  f"{len(plan.cols)} column tile(s) of {plan.tile}, {plan.blocks} blocks of "
                  f"{plan.threads} threads ({plan.lpp} lane(s) to each of up to {plan.xw} output "
                  f"columns), shared memory {plan.smem} bytes a block (the kernel's layout: {own})")
            check(own == plan.smem, "the plan's shared memory differs from the kernel's layout")
            for align in (True, False):
                nll, w = cf.ce_front_fwd(x, labels, cw, 255, out_hw, align)
                nll2, w2 = cf.ce_front_fwd(x, labels, cw, 255, out_hw, align)
                dl = cf.ce_front_bwd(x, labels, 255, out_hw, align, g)
                again = cf.ce_front_bwd(x, labels, 255, out_hw, align, g)
                xr = x.detach().clone().requires_grad_()
                nll_p, w_p = cf.ce_front_fwd_plain(xr, labels, cw, 255, out_hw, align)
                (dl_p,) = torch.autograd.grad(nll_p, xr, g)
                torch.cuda.synchronize()
                check(nll.shape == w.shape == labels.shape and nll.dtype == w.dtype == torch.float32
                      and dl.shape == x.shape and dl.dtype == dtype,
                      f"ce_front outputs {nll.shape} {w.shape} {dl.shape} {dl.dtype}")
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                same = torch.equal(dl.view(bits), again.view(bits))
                same_f = (torch.equal(nll.view(torch.int32), nll2.view(torch.int32))
                          and torch.equal(w.view(torch.int32), w2.view(torch.int32)))
                e_f = (nll - nll_p).abs().max().item()
                a, b = dl.float().flatten(), dl_p.float().flatten()
                cos = (a @ b / (a.norm() * b.norm())).item()
                e_b = (a - b).abs().max().item()
                tol_b = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * b.abs().max().item()
                err_fwd, err_bwd = max(err_fwd, e_f), max(err_bwd, e_b)
                inert = not nll[ignored].any().item() and not w[ignored].any().item()
                print(f"kernel ce_front {shape}->{out_hw} {str(dtype)[6:]} align_corners={align}: "
                      f"w exact {torch.equal(w, w_p)}, ignored inert {inert}, nll max err "
                      f"{e_f:.3e}, two launches bit-identical {same_f}; dL cos {cos:.8f}, max err "
                      f"{e_b:.3e} (<= {tol_b:.3e}), two launches bit-identical {same}")
                check(torch.equal(w, w_p) and inert and e_f <= 1e-4,
                      "ce_front_fwd disagrees with its plain version")
                check(same_f, "two ce_front_fwd launches on the same inputs differ")
                check(cos > 0.99999 and e_b <= tol_b,
                      "ce_front_bwd disagrees with autograd of the plain forward")
                check(same, "two ce_front_bwd launches on the same inputs differ")

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
    for entry, kernel, fn in (
        (entries[0], "ce_fwd_kernel", lambda: cf.ce_front_fwd(x, labels, cw, 255, out_hw, True)),
        (entries[1], "ce_bwd_kernel",
         lambda: cf.ce_front_bwd(x, labels, 255, out_hw, True, g)),
    ):
        k_ms, call_ms = kernel_device_ms(torch, fn, kernel)
        ms = entry["ms"]
        print(f"{entry['name']} {shape}->{out_hw} bf16 on the device alone (torch.profiler, 20 "
              f"calls): kernel {k_ms:.4f} ms, every kernel of the call {call_ms:.4f} ms, event "
              f"window {ms:.4f} ms ({ms / k_ms - 1:+.1%})")
        entry["deterministic"] = True  # checked bit for bit at every case above

    shape, out_hw = CE_EVAL  # K2 on the eval path
    base, labels, cw, _ = ce_inputs(torch, rng, shape, out_hw)
    x = base.to(torch.bfloat16)
    counted = (labels >= 0) & (labels < shape[3])
    ms = time_ms(lambda: cf.ce_front_fwd(x, labels, cw, 255, out_hw, True))
    bound_ms, bound_by = ce_bound_ms(shape, out_hw, x.element_size(), int(counted.sum()), False)
    print(f"kernel ce_front_fwd {shape}->{out_hw} bf16 (the eval shape): {ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound")
    return entries[0], entries[1]


def conv_bound_ms(shape) -> tuple[float, str]:
    """Least time for a C->C 3x3 conv on an H100: the larger of its
    2*N*H*W*9*C*C operations over 989 TFLOP/s bf16 and its bytes (x and y
    in bf16, w in bf16) over 3.35 TB/s."""
    n, h, w, c = shape
    t_ops = 2 * n * h * w * 9 * c * c / BF16_FLOPS * 1e3
    t_bytes = (2 * n * h * w * c * 2 + 9 * c * c * 2) / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_device_ms(torch, fn, kernel: str, calls: int = 20) -> tuple[float, float]:
    """(device ms per call of the kernels whose name holds `kernel`, device
    ms per call of every kernel the call launches) of `fn` over `calls`
    profiled calls (tools/speed.device_breakdown)."""
    from pidnet_tpu_torch.tools.speed import device_breakdown

    _, busy, rows = device_breakdown(lambda _: fn(), None, torch.device("cuda"), calls, top=None)
    return sum(ms for name, ms, _ in rows if kernel in name), busy


def host_ms(torch, fn, calls: int = 20, windows: int = 5) -> float:
    """Host ms per call of `fn`, median over `windows` windows of `calls`
    calls, each started on an idle card and read on the host clock before
    the sync: what enqueueing a call costs the host."""
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def phase_conv(torch, conv) -> dict:
    """K4 against its plain version, then its A/B entry point; returns its
    JSON entry with the launches that tools/conv_ab made."""
    from pidnet_tpu_torch.tools import conv_ab
    from pidnet_tpu_torch.utils.timing import time_ms

    rng = np.random.default_rng(2)
    max_abs_err = 0.0
    for shape in CONV_CASES:
        n, h, w, c = shape
        th, tw, bn, stages, grid = conv._plan(n, h, w, c, c)
        print(f"conv3x3 plan {shape}: TH {th}, TW {tw}, BN {bn}, STAGES {stages}, blocks "
              f"{grid[0]} x {grid[1]} = {grid[0] * grid[1]}, shared memory "
              f"{conv.smem_bytes(bn)} bytes per block")
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
        wt = torch.from_numpy(rng.standard_normal((3, 3, c, c), dtype=np.float32) * 0.02).cuda()
        b = torch.from_numpy(rng.standard_normal(c, dtype=np.float32)).cuda()
        for ep in CONV_EPILOGUES:
            kw = dict(b=b if ep.get("bias") else None, relu=ep.get("relu", False),
                      stats=ep.get("stats", False))
            for out_dtype in (torch.bfloat16, torch.float32):
                got = conv.conv3x3(x, wt, out_dtype=out_dtype, **kw)
                want = conv.conv3x3_plain(x, wt, out_dtype=out_dtype, **kw)
                line = ""
                if kw["stats"]:
                    (got, st), (want, st_p) = got, want
                    # the kernel's own fp32 output, summed in fp64
                    y32 = conv.conv3x3(x, wt, kw["b"], relu=kw["relu"],
                                       out_dtype=torch.float32).double().reshape(-1, c)
                    scale = torch.stack([y32.abs().sum(0), (y32 * y32).sum(0)])
                    own = torch.stack([y32.sum(0), (y32 * y32).sum(0)])
                    e_own = ((st.double() - own).abs() / scale.clamp(min=1e-30)).max().item()
                    e_plain = ((st - st_p).abs() / st_p.abs().clamp(min=1e-30)).max().item()
                    check(e_own <= 2e-5, f"conv3x3 {shape} {ep}: stats off their own sums "
                          f"by {e_own:.3e}")
                    line = (f", stats vs own fp32 sums {e_own:.2e} (<= 2e-5 of the sums of "
                            f"|y| and y^2), vs plain stats rel {e_plain:.2e} (not gated)")
                torch.cuda.synchronize()
                check(got.shape == want.shape == (n, h, w, c) and got.dtype == out_dtype,
                      f"conv3x3 output {got.shape} {got.dtype}")
                err = (got.float() - want.float()).abs()
                atol, rtol = (0.0079, 0.01) if out_dtype == torch.bfloat16 else (1e-4, 1e-4)
                bad = int((err > atol + rtol * want.float().abs()).sum())
                max_abs_err = max(max_abs_err, err.max().item())
                print(f"kernel conv3x3 {shape} {sorted(ep)} {str(out_dtype)[6:]}: max err "
                      f"{err.max().item():.3e}, outside atol {atol} rtol {rtol}: {bad}{line}")
                check(bad == 0, f"conv3x3 {shape} {ep} disagrees with its plain version")

    conv.launches = 0  # the A/B entry point, K4's path, starts here
    rows, calls = conv_ab.run("cuda")
    torch.cuda.synchronize()
    launches = conv.launches
    check(launches == calls > 0, f"conv3x3 launched {launches} times for {calls} calls")
    print(f"conv_ab: conv3x3 launches {launches} for {calls} calls through tools/conv_ab")
    plain_ms, device, host, bare = {}, {}, {}, {}
    for name, n, h, w, c in conv_ab.SHAPES:
        x, wt, b = conv_ab.inputs(n, h, w, c, "cuda")
        shape = (n, h, w, c)
        plain_ms[shape] = time_ms(lambda: conv.conv3x3_plain(x, wt), batches=5, per_batch=5)
        for mode in conv_ab.MODES:
            fn = conv_ab.kernel_fn(mode, x, wt, b)
            device[shape, mode] = kernel_device_ms(torch, fn, "conv3x3_kernel")
            host[shape, mode] = host_ms(torch, fn)
        # the library's launch function alone, on a preallocated output
        y = torch.empty((n, h, w, c), dtype=torch.bfloat16, device="cuda")
        th, tw, bn, stages, (gx, gy) = conv._plan(n, h, w, c, c)
        args = (0, x.data_ptr(), wt.data_ptr(), None, y.data_ptr(), None, n, h, w, c, c, 0, th,
                tw, bn, stages, gx, gy, torch.cuda.current_stream().cuda_stream)
        bare[shape] = host_ms(torch, lambda: conv._kernel_fn(torch.bfloat16)(*args))
    for row in rows:
        name, shape, mode, ms, library_ms, _, _ = row
        bound_ms, bound_by = conv_bound_ms(shape)
        k4_ms, call_ms = device[shape, mode]
        print(f"{conv_ab.format_row(row, torch.device('cuda'))}; plain version "
              f"{plain_ms[shape]:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), kernel at "
              f"{bound_ms / ms:.1%} of it, cuDNN at {bound_ms / library_ms:.1%}")
        print(f"conv3x3 {shape} {mode} on the device alone (torch.profiler, 20 calls): kernel "
              f"{k4_ms:.4f} ms, every kernel of the call {call_ms:.4f} ms, conv_ab's event window "
              f"{ms:.4f} ms ({ms / call_ms - 1:+.1%}"
              f"{', host-bound' if ms > 1.1 * call_ms else ''}); host per call "
              f"{host[shape, mode]:.4f} ms through conv3x3, {bare[shape]:.4f} ms through the "
              f"bare library call")
    print("conv3x3: no weight rearrangement per call, the kernel reads w (3,3,Cin,Cout) as it is")
    name, shape, mode, ms, library_ms, _, _ = rows[0]
    bound_ms, bound_by = conv_bound_ms(shape)
    return {
        "name": "conv3x3", "route": "cuda", "source": "pidnet_tpu_torch/csrc/conv3x3.cu",
        "replaces": "pidnet_tpu/ops/conv3x3.py:41", "launches": launches,
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms[shape],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


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
    wall, busy, rows = speed.device_breakdown(lambda _: bench_step(*placed, 0.01), None, dev, 5,
                                              top=None)
    k2 = sum(ms for name, ms, _ in rows if "ce_fwd_kernel" in name)
    k3 = sum(ms for name, ms, _ in rows if "ce_bwd_kernel" in name)
    print(f"train profile over 5 steps (torch.profiler): wall {wall:.2f} ms/step, device busy "
          f"{busy:.3f} ms/step ({busy / wall:.1%}); K3 ce_bwd_kernel {k3:.4f} ms/step "
          f"({k3 / busy:.2%} of busy), K2 ce_fwd_kernel {k2:.4f} ms/step [{card}]")
    return counts


def edges_of(labels: np.ndarray) -> np.ndarray:
    """1 where a pixel's label differs from one of its 4 neighbours: a
    cv2-free stand-in for the dataset's Canny edge labels."""
    e = np.zeros(labels.shape, bool)
    dv = labels[:, 1:] != labels[:, :-1]
    dh = labels[:, :, 1:] != labels[:, :, :-1]
    e[:, 1:] |= dv
    e[:, :-1] |= dv
    e[:, :, 1:] |= dh
    e[:, :, :-1] |= dh
    return e.astype(np.float32)


class _Loader:
    def __init__(self, batches, batch_size):
        self.batches, self.batch_size = batches, batch_size

    def __iter__(self):
        return iter(self.batches)


def numpy_scores(preds: list, labels: list) -> tuple[float, float]:
    """(mean IoU, pixel accuracy) of class maps against labels, from a
    numpy confusion matrix."""
    cm = np.zeros((19, 19), np.float64)
    for p, g in zip(preds, labels):
        cm += np.bincount((g.astype(np.int64) * 19 + p).reshape(-1),
                          minlength=361).reshape(19, 19)
    tp = np.diag(cm)
    iou = tp / np.maximum(1.0, cm.sum(1) + cm.sum(0) - tp)
    return float(iou.mean()), float(tp.sum() / max(cm.sum(), 1.0))


def profile(title: str, fn, x, card: str, steps: int = 3) -> None:
    """Print the wall and device-busy time per call of fn(x) under
    torch.profiler and its largest kernels (tools/speed.device_breakdown)."""
    import torch

    from pidnet_tpu_torch.tools.speed import device_breakdown

    wall, busy, rows = device_breakdown(fn, x, torch.device("cuda"), steps, top=8)
    print(f"{title}: profiled {wall:.1f} ms/call wall, device busy {busy:.1f} ms "
          f"({busy / wall:.1%}), idle {1 - busy / wall:.1%} [{card}]")
    for name, ms, count in rows:
        print(f"  {ms:8.3f} ms {count:6.1f}x  {name[:100]}")


def phase_eval(torch, card: str) -> dict:
    """Validate, testval and TTA on the sample frames; returns the launch
    counts of K1-K3 on these paths."""
    from pidnet_tpu_torch import engine
    from pidnet_tpu_torch.convert.fold import fold_state_dict
    from pidnet_tpu_torch.convert.weights import load_npz
    from pidnet_tpu_torch.data.cityscapes import CLASS_WEIGHTS
    from pidnet_tpu_torch.data.png import read_png
    from pidnet_tpu_torch.data.transforms import input_transform
    from pidnet_tpu_torch.losses.criterion import FullLoss
    from pidnet_tpu_torch.metrics import acc_from_cm, iou_from_cm
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.ops import ce_front as cf
    from pidnet_tpu_torch.ops import upsample_argmax as ua
    from pidnet_tpu_torch.train.step import make_eval_step

    sd = load_npz(WEIGHTS)
    goldens = np.load(GOLDENS)
    names = list(goldens.files)
    images = np.concatenate([input_transform(read_png(os.path.join(SAMPLES, k)),
                                             bgr_to_rgb=False)[None] for k in names])
    labels = np.stack([goldens[k].astype(np.int32) for k in names])
    edges = edges_of(labels)
    pixels = labels[0].size
    spec = M.spec_for("pidnet_s", 19, augment=True)
    model = M.build(spec, sd, device="cuda").to(memory_format=torch.channels_last)
    loss_fn = FullLoss(ignore_label=255, class_weights=CLASS_WEIGHTS, use_ohem=True,
                       ohem_thres=0.9, ohem_kept=131072, balance_weights=(0.4, 1.0),
                       sb_weights=1.0)
    cfg = engine.config(output_index=1, ignore_label=255)
    loader = _Loader([(images, labels, edges, None, None),
                      (images[:1], labels[:1], edges[:1], None, None)], 2)
    counts = {"upsample_argmax": 0, "ce_front_fwd": 0, "ce_front_bwd": 0}
    logging.getLogger("pidnet_tpu_torch").setLevel(logging.WARNING)  # the lines below say it
    runs = [(None, 1, 0.995)] * 2 + [(torch.bfloat16, 3, 0.98)] * 2  # the first of each warms up
    for dtype, k1_per_batch, gate in runs:
        step = make_eval_step(model, loss_fn, num_classes=19, compute_dtype=dtype)
        cms = []

        def recording_step(*batch):
            metrics, batch_cms = step(*batch)
            cms.append(batch_cms.cpu().numpy())
            return metrics, batch_cms

        ua.launches = cf.fwd_launches = cf.bwd_launches = 0  # the eval path starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ave_loss, miou, _ = engine.validate(cfg, loader, recording_step,
                                            {"writer": _NoWriter(), "valid_global_steps": 0})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"upsample_argmax": ua.launches, "ce_front_fwd": cf.fwd_launches,
               "ce_front_bwd": cf.bwd_launches}
        for k in counts:
            counts[k] += got[k]
        totals = [[int(c.sum()) for c in batch] for batch in cms]
        acc = acc_from_cm(sum(batch[-1] for batch in cms))[0]
        name = "fp32" if dtype is None else "bf16"
        print(f"eval validate {name}: batches [f0, f1], [f0] (padded, masked, from host arrays) "
              f"in {wall * 1e3:.1f} ms ({wall * 1e3 / len(cms):.1f} ms/batch) [{card}]; loss "
              f"{ave_loss:.6f}, final-head mIoU vs goldens {miou:.6f}, pixel acc "
              f"{acc:.6f} (>= {gate}), p-head mIoU {iou_from_cm(sum(b[0] for b in cms))[1]:.6f}; "
              f"matrix totals {totals}; launches {got}")
        check(totals == [[2 * pixels] * 2, [pixels] * 2], f"eval {name}: matrix totals {totals}")
        check(acc >= gate and np.isfinite(ave_loss), f"eval {name}: pixel accuracy {acc}")
        check(got == {"upsample_argmax": k1_per_batch * 2, "ce_front_fwd": 4, "ce_front_bwd": 0},
              f"eval {name}: launches {got}, want {k1_per_batch}/2/0 per batch")
    # where a bf16 val batch's time goes (launches here are outside the counts)
    step = make_eval_step(model, loss_fn, num_classes=19, compute_dtype=torch.bfloat16)
    batch = (images, labels, edges, np.ones(2, np.float32))
    profile("eval profile bf16 validate batch (2x1024x2048, host arrays)",
            lambda b: step(*b), batch, card)
    del model, step

    spec_s = M.spec_for("pidnet_s", 19, augment=False)
    folded = fold_state_dict(sd, spec_s)
    serve = engine.make_inference_classmap(cfg, spec_s, folded, folded=True,
                                           compute_dtype=torch.bfloat16)
    preds = []

    def recording_infer(x):
        out = serve(x)
        preds.append(out.cpu().numpy())
        return out

    frames = [(images[i:i + 1], labels[i:i + 1], None, None, [names[i]]) for i in range(2)]
    for attempt in range(2):
        preds.clear()
        before = ua.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        miou, _, pixel_acc, _ = engine.testval(cfg, None, frames, recording_infer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts["upsample_argmax"] += ua.launches - before
        want = numpy_scores([p[0] for p in preds], list(labels))
        check(ua.launches - before == 2, "testval: upsample_argmax launches")
        check((miou, pixel_acc) == want, f"testval: {(miou, pixel_acc)} != numpy {want}")
    print(f"eval testval folded bf16 class maps: {wall * 1e3 / 2:.1f} ms/frame (host input, "
          f"host matrix) [{card}]; mIoU vs goldens {miou:.6f}, pixel acc {pixel_acc:.6f}, equal "
          f"to numpy's on the same maps")

    # the JAX package's TTA on this frame with these weights (folded bf16, on
    # its TPU; scripts/tta_bench.py, docs/DESIGN.md round 5) changed 13.7% of
    # the single-scale class map with flip alone, 18.9% with 6 scales + flip
    x0 = torch.from_numpy(images[:1]).cuda()
    maps = {}
    for tag, kw, jax_agree in (("single-scale", {}, None), ("flip", dict(flip_test=True), 0.863),
                               ("6-scale+flip", dict(multi_scale=True, flip_test=True), 0.811)):
        cfg_tta = engine.config(ignore_label=255, **kw)
        tta = engine.make_ms_flip_inference(cfg_tta, spec_s, folded, folded=True,
                                            compute_dtype=torch.bfloat16)
        tta(x0)
        if cfg_tta.TEST.MULTI_SCALE:
            profile("eval profile TTA 6-scale+flip frame", tta, x0, card, steps=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = tta(x0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        finite = bool(torch.isfinite(probs).all())
        maps[tag] = probs.argmax(-1)[0].cpu().numpy()
        del probs
        goldens_agree = float((maps[tag] == labels[0]).mean())
        agree = float((maps[tag] == maps["single-scale"]).mean())
        scales = cfg_tta.TEST.SCALE_LIST if cfg_tta.TEST.MULTI_SCALE else [1.0]
        print(f"eval TTA folded bf16 {tag} (scales {scales}, crop {cfg_tta.TEST.IMAGE_SIZE}): "
              f"{wall * 1e3:.1f} ms/frame [{card}]; finite "
              f"{finite}, argmax vs goldens {goldens_agree:.6f}, vs single-scale {agree:.6f}"
              + ("" if jax_agree is None else f" (JAX package {jax_agree:.3f} +- 0.01)"))
        check(finite, f"TTA {tag}: non-finite values")
        if jax_agree is not None:
            check(abs(agree - jax_agree) <= 0.01,
                  f"TTA {tag}: agreement with single-scale {agree} not within 0.01 of {jax_agree}")

    cfg_id = engine.config(ignore_label=255)
    p_tta = engine.make_ms_flip_inference(cfg_id, spec_s, folded, folded=True)(x0)
    p_one = engine.make_inference(cfg_id, spec_s, folded, folded=True)(x0)
    lg = torch.log(p_tta.double().clamp(1e-30, 1e38))
    lw = torch.log(p_one.double().clamp(1e-30, 1e38))
    gap = (lg - lw).abs().max().item()
    print(f"eval identity TTA (scale 1, no flip) fp32 vs make_inference: max clipped "
          f"log-probability gap {gap:.3e} (<= 0.01)")
    check(gap <= 0.01, "identity TTA differs from make_inference")
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
    from pidnet_tpu_torch.ops import conv3x3 as conv
    from pidnet_tpu_torch.ops import upsample_argmax as ua
    from pidnet_tpu_torch.utils.timing import card_line

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
    k4 = phase_conv(torch, conv)
    torch.cuda.empty_cache()
    phase_slice(torch, card)
    served = ua.launches
    counts = phase_train(torch, card)
    evals = phase_eval(torch, card)
    k1["launches"] = served + counts["upsample_argmax"] + evals["upsample_argmax"]
    k2["launches"] = counts["ce_front_fwd"] + evals["ce_front_fwd"]
    k3["launches"] = counts["ce_front_bwd"] + evals["ce_front_bwd"]
    print(f"launches on the main paths: upsample_argmax {served} serving + "
          f"{counts['upsample_argmax']} training + {evals['upsample_argmax']} eval, "
          f"ce_front_fwd {counts['ce_front_fwd']} training + {evals['ce_front_fwd']} eval, "
          f"ce_front_bwd {counts['ce_front_bwd']} training + {evals['ce_front_bwd']} eval, "
          f"conv3x3 {k4['launches']} conv_ab")

    print(card)
    print(json.dumps({"kernels": [k1, k2, k3, k4]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
