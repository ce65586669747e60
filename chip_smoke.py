#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. card and build: the card's name and power limit (nvidia-smi), then
   every kernel in pidnet_tpu_torch/csrc built with nvcc for sm_90a;
2. kernels: each kernel against its plain PyTorch version on seeded
   inputs, at every listed shape, in bf16 and fp32, both align_corners
   modes: the fused upsample+argmax (K1: >= 0.9999 of pixels agree, none
   whose fp32 top-2 margin exceeds 1e-3 differs; at the serving, training
   and eval shapes among others, 100 classes and 1100, which take the
   direct kernel), and the fused upsample+CE
   forward (K2: w exact, ignored pixels 0, nll within 1e-4) and backward
   (K3: cosine > 0.99999 against autograd of the plain forward, max-abs
   within 2^-7 of the largest value in bf16, 1e-5 in fp32), each with two
   launches on the same inputs bit-identical and its plan at each shape
   (bands, tiles, blocks, shared memory, cross-checked against the
   kernel's own layout); each one's time (CUDA events, median), the plain
   version's, a library call's, and its bound; K2's and K3's device time
   under torch.profiler beside their event times, and K2's time at the
   eval shape; K1 at the serving, training and eval shapes four ways: its
   device time (torch.profiler), raw launches without the wrapper and the
   wrapper's calls (CUDA events), and the wrapper's host time a call;
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
6. data: a Cityscapes tree in a temporary directory of the checkout (the
   sample frames as leftImg8bit PNGs, the goldens mapped back to raw ids
   as greyscale labelIds PNGs; train.lst each frame three times, val.lst
   [f0, f1, f0]), configs/cityscapes/pidnet_small_cityscapes.yaml through
   the port's load_config, and datasets and Loaders as the JAX package's
   tools/train.py builds them on one process (batch 6 of 1024x1024
   multi-scale, flipped crops; val batch 2 at 1024x2048). Gates: the
   SHA-256 of a seeded gen_sample and of a full-resolution gen_edge_gt
   equal the bytes that cv2 gives (DATA_SHA256); engine.train_one_epoch for
   3 one-step epochs from the train2k weights with the loader's Canny
   edges and engine.validate over the val loader give finite losses,
   matrices that total the labelled pixels, and 1/2/2 K1/K2/K3 launches a
   step and 1/2/0 a val batch. Then the same epochs with DATASET.CACHE on,
   and the data layer's host times: read_png, gen_edge_gt and gen_sample
   per frame, the loader's ms a batch cold (6 workers and 1) and cached,
   and the loader-fed ms/step against tools/speed.py --train;
7. eval: PIDNet-S augment with the train2k weights, unfolded, eval mode,
   on the two sample frames with the frozen fp32 goldens as labels, from
   the val loader over the same tree (cached; its batches equal the frames,
   the goldens and their Canny edges): engine.validate over batches
   [f0, f1], [f0] (the last padded and masked), in fp32 and bf16 through
   make_eval_step.
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
   their largest kernels);
8. cli: the port's CLIs in-process over the same tree, outputs in it:
   tools.convert turns the train2k .npz into a port .pt and, with --fold, a
   folded .pt; tools.train (the PIDNet-S YAML, MODEL.PRETRAINED the .npz,
   END_EPOCH 2, WORKERS 1: one step of 6x1024x1024 bf16 and a validate of 3
   frames an epoch) writes checkpoint.pt, best.pt and final_state.pt, every
   logged loss finite, 1/2/2 K1/K2/K3 launches a step and 1/2/0 a val
   batch; the same command with TRAIN.RESUME true and END_EPOCH 3 runs
   exactly one more step (checkpoint epoch 3); tools.eval on the val list
   [f0, f1, f0] with the converted .pt unfolded in fp32 (pixel accuracy vs
   the goldens >= 0.995, no K1), with --fold-bn in bf16 (>= 0.98, one K1
   launch a frame) and with TEST.FLIP_TEST (finite), each with scores equal
   to engine.testval called directly with a closure built the same way;
   the folded .pt with --fold-bn gives the class maps of the second run
   bit for bit, and without it the CLI exits non-zero. Each run's host
   seconds, ms per step and ms per testval frame.

The line before the last is a JSON object with one entry per kernel, its
launches counted over every path that ran it; the last line is
{"ok": true, "device": {...}}. Without CUDA, or run outside
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
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
# path (FullLoss's accuracy), the eval path (a val batch's matrices), a
# small batch, CamVid's 90x120 -> 720x960, an identity size, 100 classes
# (four lanes a pixel) and 1100 (the direct kernel)
KERNEL_CASES = [
    ((1, 128, 256, 19), (1024, 2048)),
    ((6, 128, 128, 19), (1024, 1024)),
    ((2, 128, 256, 19), (1024, 2048)),
    ((2, 16, 32, 19), (128, 256)),
    ((1, 90, 120, 11), (720, 960)),
    ((1, 128, 256, 19), (128, 256)),
    ((1, 16, 16, 100), (128, 128)),
    ((1, 8, 8, 1100), (32, 32)),
]
MAIN_CASE = KERNEL_CASES[0]
K1_TIMED = {"serving": KERNEL_CASES[0], "train": KERNEL_CASES[1], "eval": KERNEL_CASES[2]}
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

# SHA-256 of the data layer's bytes on the repo's own inputs: the boundary
# target of the first sample frame's golden class map, and a seeded
# training sample (image, label, edge) of that frame at Cityscapes' recipe.
# tests/test_torch_data.py holds them against cv2 (5.0.0) and the JAX
# package; the data phase holds the numpy of the machine that drives the
# card to them.
DATA_SEED = 1  # draws rand_scale 1.3, a crop and a flip
DATA_SHA256 = {
    "gen_edge_gt": "80054035daafe0e2d30fd9f295a5c3493ad69ff1e3bf956b0e66c2b0be359647",
    "gen_sample": "1e835016bce04b56ee9b1c1d985b235560a92d22dccdc5437d140c0349b2e980",
}

SEED = 304  # the reference's tools/train.py seed, as scripts/train_run_artifact.py
TRAIN_STEPS = 30
TRAIN_POOL = 24  # crops made once and cycled, 4 batches of 6
TRAIN_NUM_ITERS = 2000  # the poly schedule's length, as scripts/train_run_artifact.py


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


def data_digests(transforms, image: np.ndarray, label: np.ndarray, bgr: bool = False) -> dict:
    """SHA-256 of `transforms.gen_edge_gt(label)` and of a gen_sample at
    DATA_SEED (crop 1024x1024, base 2048, scales 0.5-2.1, flip, ignore 255)
    of an RGB uint8 frame and its uint8 train-id map. `transforms` is
    pidnet_tpu_torch.data.transforms, or, with `bgr`, a module of the same
    functions that reads BGR frames."""
    edge = transforms.gen_edge_gt(label)
    sample = transforms.gen_sample(
        np.random.default_rng(DATA_SEED), image[:, :, ::-1].copy() if bgr else image, label,
        multi_scale=True, is_flip=True, base_size=2048, crop_size=(1024, 1024), scale_factor=16,
        ignore_label=255, bgr_to_rgb=bgr)
    digest = hashlib.sha256()
    for a in sample:
        digest.update(a.tobytes())
    return {"gen_edge_gt": hashlib.sha256(edge.tobytes()).hexdigest(),
            "gen_sample": digest.hexdigest()}


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

    from pidnet_tpu_torch.ops._build import library
    from pidnet_tpu_torch.utils.timing import time_ms

    smem_bytes = library("upsample_argmax").upsample_argmax_smem_bytes  # the kernel's layout
    smem_bytes.argtypes, smem_bytes.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    rng = np.random.default_rng(0)
    max_abs_err = 0.0
    for shape, out_hw in KERNEL_CASES:
        base = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 2).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            x = base.to(dtype)
            plan = ua.plan(*shape, *out_hw, True)
            if plan is None:
                print(f"upsample_argmax plan {shape}->{out_hw} {str(dtype)[6:]}: the direct "
                      f"kernel (one thread a pixel)")
            else:
                own = smem_bytes(shape[3], plan.window, plan.lpp)
                print(f"upsample_argmax plan {shape}->{out_hw} {str(dtype)[6:]}: "
                      f"{len(plan.rows)} band(s) of {plan.band} output rows, {len(plan.cols)} "
                      f"tile(s) of {plan.tile} output columns, {plan.blocks} blocks of "
                      f"{plan.threads} threads ({plan.lpp} lane(s) a pixel), window of "
                      f"{plan.window} source pixels, shared memory {plan.smem} bytes a block "
                      f"(the kernel's layout: {own})")
                check(own == plan.smem, "the K1 plan's shared memory differs from the kernel's")
            for align in (True, False):
                # the plain fp32 upsample decides which pixels must match exactly
                up = F.interpolate(x.permute(0, 3, 1, 2).float(), size=out_hw, mode="bilinear",
                                   align_corners=align)
                got = ua.upsample_argmax(x, out_hw, align)
                again = ua.upsample_argmax(x, out_hw, align)
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
                bits = torch.equal(got, again)
                print(f"kernel upsample_argmax {tuple(shape)}->{out_hw} {str(dtype)[6:]} "
                      f"align_corners={align}: agreement {agree:.6f}, "
                      f"confident mismatches {confident_miss}, max logit gap {err:.3e}, two "
                      f"launches bit-identical {bits}")
                check(agree >= 0.9999 and confident_miss == 0,
                      f"kernel disagrees with its plain version: {agree}, {confident_miss}")
                check(bits, "two upsample_argmax launches on the same inputs differ")
                del up, top2, margin, gap

    # K1's time at the three paths' shapes, four ways: the wrapper's event
    # window, the kernel's device time, raw launches without the wrapper,
    # and the wrapper's host time a call
    timed = {}
    for path, (shape, out_hw) in K1_TIMED.items():
        n, h, w, c = shape
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 2).cuda()
        x = x.to(torch.bfloat16)
        plan = ua.plan(n, h, w, c, *out_hw, True)
        out = torch.empty((n, *out_hw), dtype=torch.int32, device="cuda")
        args = (x.data_ptr(), out.data_ptr(), n, h, w, c, *out_hw, 1, plan.band, plan.tile,
                plan.lpp, plan.window, plan.threads, torch.cuda.current_stream().cuda_stream)
        raw = ua._kernel_fn("upsample_argmax_bf16")
        wrapper = lambda: ua.upsample_argmax(x, out_hw, True)  # noqa: E731
        ms = time_ms(wrapper)
        device_ms, call_ms = kernel_device_ms(torch, wrapper, "upsample_argmax_kernel")
        raw_ms = time_ms(lambda: raw(*args))
        host = host_ms(torch, wrapper)
        bound_ms, bound_by = upsample_argmax_bound_ms(shape, out_hw, x.element_size())
        timed[path] = (x, ms, device_ms, raw_ms, host, bound_ms, bound_by)
        print(f"kernel upsample_argmax {shape}->{out_hw} bf16 ({path}): device {device_ms:.4f} "
              f"ms (torch.profiler, 20 calls; every kernel of the call {call_ms:.4f}), raw "
              f"launches {raw_ms:.4f} ms (CUDA events, no wrapper), wrapper calls {ms:.4f} ms "
              f"(CUDA events), wrapper host {host:.4f} ms a call; bound {bound_ms:.4f} ms "
              f"({bound_by}), device time at {bound_ms / device_ms:.1%} of it")

    shape, out_hw = MAIN_CASE
    x, ms, device_ms, raw_ms, host, bound_ms, bound_by = timed["serving"]
    plain_ms = time_ms(lambda: ua.upsample_argmax_plain(x, out_hw, True))
    xn = x.permute(0, 3, 1, 2)
    library_ms = time_ms(lambda: torch.argmax(
        F.interpolate(xn, size=out_hw, mode="bilinear", align_corners=True), dim=1))
    print(f"kernel upsample_argmax {shape}->{out_hw} bf16: {ms:.4f} ms (wrapper window), "
          f"device {device_ms:.4f} ms, plain {plain_ms:.4f} ms, F.interpolate+argmax "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {
        "name": "upsample_argmax", "route": "cuda",
        "source": "pidnet_tpu_torch/csrc/upsample_argmax.cu",
        "replaces": "pidnet_tpu/ops/upsample_argmax.py:44",
        "launches": None, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "device_ms": device_ms, "raw_launch_ms": raw_ms, "host_ms": host,
        "deterministic": True,  # checked bit for bit at every case above
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
    return counts, result["ms_per_step"]


CITY_STEM = "_leftImg8bit.png"


def build_city_tree(base: str) -> str:
    """A Cityscapes tree under `base` from the repo's own files: the sample
    frames as leftImg8bit PNGs, and their golden class maps mapped back to
    raw ids through the inverse LUT as greyscale gtFine labelIds PNGs.
    list/cityscapes/train.lst holds each frame three times (one batch of
    6), val.lst the frames [f0, f1, f0] (two batches of 2, the last
    partial). Returns the DATASET.ROOT."""
    from pidnet_tpu_torch.data.cityscapes import _build_luts
    from pidnet_tpu_torch.data.png import write_png

    _, inverse = _build_luts(255)
    goldens = np.load(GOLDENS)
    lines = []
    for name in goldens.files:
        city = name.split("_")[0]
        image = f"leftImg8bit/val/{city}/{name}"
        label = f"gtFine/val/{city}/{name[:-len(CITY_STEM)]}_gtFine_labelIds.png"
        for rel in (image, label):
            os.makedirs(os.path.dirname(os.path.join(base, "cityscapes", rel)), exist_ok=True)
        shutil.copyfile(os.path.join(SAMPLES, name), os.path.join(base, "cityscapes", image))
        write_png(os.path.join(base, "cityscapes", label), inverse[goldens[name].astype(np.uint8)])
        lines.append(f"{image}\t{label}")
    os.makedirs(os.path.join(base, "list", "cityscapes"))
    with open(os.path.join(base, "list", "cityscapes", "train.lst"), "w") as f:
        f.write("\n".join(lines * 3))
    with open(os.path.join(base, "list", "cityscapes", "val.lst"), "w") as f:
        f.write("\n".join(lines + lines[:1]))
    return base


def data_config(root: str, *opts: str):
    """configs/cityscapes/pidnet_small_cityscapes.yaml through the port's
    load_config, DATASET.ROOT and the list files pointed at `root`."""
    from pidnet_tpu_torch.config import load_config

    return load_config(os.path.join(ROOT, "configs", "cityscapes", "pidnet_small_cityscapes.yaml"),
                       ["DATASET.ROOT", root, "DATASET.TRAIN_SET", "list/cityscapes/train.lst",
                        "DATASET.TEST_SET", "list/cityscapes/val.lst", *opts])


def build_loaders(cfg, val_cache: bool = False):
    """(train dataset, train loader, val loader): the train CLI's
    (tools/train.build_data), but for val batches of 2 from a val dataset
    whose decoded-sample cache is `val_cache`."""
    from pidnet_tpu_torch.data import Loader, build_dataset
    from pidnet_tpu_torch.tools.train import build_data

    train, train_loader, _ = build_data(cfg, cfg.SEED)
    val = build_dataset(cfg.DATASET.DATASET, root=cfg.DATASET.ROOT,
                        list_path=cfg.DATASET.TEST_SET, num_classes=cfg.DATASET.NUM_CLASSES,
                        multi_scale=False, flip=False, ignore_label=cfg.TRAIN.IGNORE_LABEL,
                        base_size=cfg.TEST.BASE_SIZE,
                        crop_size=(cfg.TEST.IMAGE_SIZE[1], cfg.TEST.IMAGE_SIZE[0]),
                        seed=cfg.SEED, cache=val_cache)
    val_loader = Loader(val, 2, shuffle=False, drop_last=False, num_workers=cfg.WORKERS)
    return train, TimedLoader(train_loader), TimedLoader(val_loader)


class TimedLoader:
    """A Loader that also records how long its consumer waited for each
    batch (host ms in `waits`); everything else is the Loader's."""

    def __init__(self, loader):
        self.loader = loader
        self.waits: list[float] = []

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        batches = iter(self.loader)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(batches)
                except StopIteration:
                    return
                self.waits.append((time.perf_counter() - t0) * 1e3)
                yield batch
        finally:
            batches.close()


def host_frame_ms(fn, repeats: int = 3) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_data(torch, card: str, tree: str, speed_ms: float) -> dict:
    """The YAML -> dataset -> loader -> train step and validate path over the
    Cityscapes tree; returns the launch counts of K1-K3 on it."""
    from pidnet_tpu_torch import engine
    from pidnet_tpu_torch.convert.weights import load_npz
    from pidnet_tpu_torch.data import transforms
    from pidnet_tpu_torch.data.png import read_png
    from pidnet_tpu_torch.losses.criterion import FullLoss
    from pidnet_tpu_torch.metrics import acc_from_cm
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.ops import ce_front as cf
    from pidnet_tpu_torch.ops import upsample_argmax as ua
    from pidnet_tpu_torch.train.step import TrainState, make_eval_step, make_train_step

    goldens = np.load(GOLDENS)
    name = goldens.files[0]
    frame_path = os.path.join(SAMPLES, name)
    label_path = os.path.join(tree, "cityscapes", "gtFine", "val", "frankfurt",
                              name[:-len(CITY_STEM)] + "_gtFine_labelIds.png")
    image, label = read_png(frame_path), goldens[name].astype(np.uint8)
    digests = data_digests(transforms, image, label)
    print(f"data: SHA-256 here {digests}, cv2's (DATA_SHA256) {DATA_SHA256}")
    check(digests == DATA_SHA256, "the data layer's bytes differ from cv2's")

    recipe = dict(multi_scale=True, is_flip=True, base_size=2048, crop_size=(1024, 1024),
                  scale_factor=16, ignore_label=255, bgr_to_rgb=False)
    edge = transforms.gen_edge_gt(label)
    times = {
        "read_png image": host_frame_ms(lambda: read_png(frame_path)),
        "read_png labelIds": host_frame_ms(lambda: read_png(label_path)),
        "gen_edge_gt": host_frame_ms(lambda: transforms.gen_edge_gt(label)),
        "gen_sample": host_frame_ms(lambda: transforms.gen_sample(
            np.random.default_rng(DATA_SEED), image, label, edge=edge, **recipe)),
    }
    print("data: host ms per 1024x2048 frame (median of 3, one thread): "
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
          + f" (gen_sample at DATA_SEED's scale 1.3, edge given) [{card}; host time]")

    cfg = data_config(tree)
    train_ds, train_loader, val_loader = build_loaders(cfg)
    dev = torch.device("cuda")
    spec = M.spec_for("pidnet_s", cfg.DATASET.NUM_CLASSES, augment=True)
    sd = load_npz(WEIGHTS)
    ts = TrainState.create(M.build(spec, sd, device=dev, train=True))
    loss_fn = FullLoss(num_outputs=cfg.MODEL.NUM_OUTPUTS, align_corners=cfg.MODEL.ALIGN_CORNERS,
                       ignore_label=cfg.TRAIN.IGNORE_LABEL, class_weights=train_ds.class_weights,
                       use_ohem=cfg.LOSS.USE_OHEM, ohem_thres=cfg.LOSS.OHEMTHRES,
                       ohem_kept=cfg.LOSS.OHEMKEEP, balance_weights=cfg.LOSS.BALANCE_WEIGHTS,
                       sb_weights=cfg.LOSS.SB_WEIGHTS)
    compute = torch.bfloat16 if cfg.XLA.BF16_TRAIN else None
    step = make_train_step(ts, loss_fn, momentum=cfg.TRAIN.MOMENTUM, weight_decay=cfg.TRAIN.WD,
                           nesterov=cfg.TRAIN.NESTEROV, compute_dtype=compute)
    epoch_iters = len(train_loader)
    num_iters = cfg.TRAIN.END_EPOCH * epoch_iters
    print(f"data: {cfg.DATASET.DATASET} from {cfg.DATASET.TRAIN_SET} ({len(train_ds)} samples, "
          f"batch {cfg.TRAIN.BATCH_SIZE_PER_GPU} of {cfg.TRAIN.IMAGE_SIZE[1]}x"
          f"{cfg.TRAIN.IMAGE_SIZE[0]} crops, scales 0.5-{0.5 + cfg.TRAIN.SCALE_FACTOR / 10}, flip, "
          f"{cfg.WORKERS} workers, cache {cfg.DATASET.CACHE}) and {cfg.DATASET.TEST_SET} (batch 2 "
          f"of {cfg.TEST.IMAGE_SIZE[1]}x{cfg.TEST.IMAGE_SIZE[0]}); PIDNet-S augment, train2k "
          f"weights, {'bf16' if compute else 'fp32'}, LR {cfg.TRAIN.LR} over {num_iters} iters")

    history = []

    def recording_step(*args):
        metrics = step(*args)
        history.append(metrics)
        return metrics

    writer = {"writer": _NoWriter(), "train_global_steps": 0, "valid_global_steps": 0}
    cms = []
    ua.launches = cf.fwd_launches = cf.bwd_launches = 0  # the data path starts here
    walls, done = [], 0
    for epoch in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, n = engine.train_one_epoch(cfg, epoch, epoch_iters, num_iters, cfg.TRAIN.LR,
                                      train_loader, recording_step, ts, writer)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        done += n
    eval_step = make_eval_step(ts.model.eval(), loss_fn, num_classes=cfg.DATASET.NUM_CLASSES)

    def recording_eval(*batch):
        metrics, batch_cms = eval_step(*batch)
        cms.append(batch_cms.cpu().numpy())
        return metrics, batch_cms

    logging.getLogger("pidnet_tpu_torch").setLevel(logging.WARNING)  # its IoU lines
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ave_loss, miou, _ = engine.validate(cfg, val_loader, recording_eval, writer)
    torch.cuda.synchronize()
    val_wall = (time.perf_counter() - t0) * 1e3
    counts = {"upsample_argmax": ua.launches, "ce_front_fwd": cf.fwd_launches,
              "ce_front_bwd": cf.bwd_launches}
    losses = [float(m["loss"]) for m in history]
    batches = len(cms)
    pixels = label.size
    totals = [[int(c.sum()) for c in batch] for batch in cms]
    acc = acc_from_cm(sum(batch[-1] for batch in cms))[0]
    print(f"data: train_one_epoch x 3 from the loader: {done} steps, losses "
          f"{[round(v, 4) for v in losses]}, acc {[round(float(m['acc']), 4) for m in history]}; "
          f"per epoch {[round(w, 1) for w in walls]} ms, of which waiting for the loader "
          f"{[round(w, 1) for w in train_loader.waits]} ms (cache off, every batch decoded) "
          f"[{card}]")
    print(f"data: validate the trained model (fp32) over {batches} val batches from the loader: "
          f"{val_wall:.1f} ms ({val_wall / batches:.1f} ms/batch), waiting for the loader "
          f"{[round(w, 1) for w in val_loader.waits]} ms; loss {ave_loss:.6f}, final-head pixel "
          f"acc vs goldens {acc:.6f}, mIoU {miou:.6f}; matrix totals {totals}; launches {counts}")
    check(done == 3 and len(losses) == 3 and all(np.isfinite(losses)) and np.isfinite(ave_loss),
          f"data path: losses {losses}, val loss {ave_loss}")
    check(totals == [[2 * pixels] * 2, [pixels] * 2], f"data path: matrix totals {totals}")
    want = {"upsample_argmax": done + batches, "ce_front_fwd": 2 * done + 2 * batches,
            "ce_front_bwd": 2 * done}
    check(counts == want, f"data path: launches {counts}, want {want} (1/2/2 a train step, "
          f"1/2/0 a val batch)")

    # the same path with DATASET.CACHE on: the first epoch decodes and fills
    # the cache, the next two augment cached frames
    cfg_c = data_config(tree, "DATASET.CACHE", "true")
    train_c, loader_c, _ = build_loaders(cfg_c)
    walls_c = []
    for epoch in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.train_one_epoch(cfg_c, epoch, epoch_iters, num_iters, cfg.TRAIN.LR, loader_c,
                               recording_step, ts, writer)
        torch.cuda.synchronize()
        walls_c.append((time.perf_counter() - t0) * 1e3)
    losses = [float(m["loss"]) for m in history[3:]]
    check(len(losses) == 3 and all(np.isfinite(losses)), f"data path, cached: losses {losses}")
    cold, cached = walls[1:], walls_c[1:]
    print(f"data: with DATASET.CACHE: per epoch {[round(w, 1) for w in walls_c]} ms, waiting for "
          f"the loader {[round(w, 1) for w in loader_c.waits]} ms (the first fills the cache: "
          f"{train_c._cache.stats()}); losses {[round(v, 4) for v in losses]}")
    print(f"data: loader-fed ms/step (epochs 2-3, one step each) cache off "
          f"{statistics.fmean(cold):.1f}, cache on {statistics.fmean(cached):.1f}, against "
          f"{speed_ms:.2f} ms/step on pre-built device batches (tools/speed.py --train): the "
          f"loader sets the pace {'in both' if min(cached) > 2 * speed_ms else 'cold only'} "
          f"[{card}]")
    # the same cold train batch from one worker: what the threads share
    _, single, _ = build_loaders(data_config(tree, "WORKERS", "1"))
    for _ in single:
        pass
    print(f"data: loader ms a batch: train (6x1024x1024) cold "
          f"{statistics.fmean(train_loader.waits[1:]):.1f} ({cfg.WORKERS} workers; "
          f"{single.waits[0]:.1f} from 1 worker), cached {statistics.fmean(loader_c.waits[1:]):.1f}; "
          f"val (2x1024x2048) cold {val_loader.waits[0]:.1f} [{card}; host time]")
    del ts, step, eval_step
    torch.cuda.empty_cache()
    return counts


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


def phase_eval(torch, card: str, tree: str) -> dict:
    """Validate over the val loader, then testval and TTA on the sample
    frames; returns the launch counts of K1-K3 on these paths."""
    from pidnet_tpu_torch import engine
    from pidnet_tpu_torch.convert.fold import fold_state_dict
    from pidnet_tpu_torch.convert.weights import load_npz
    from pidnet_tpu_torch.data.cityscapes import CLASS_WEIGHTS
    from pidnet_tpu_torch.data.png import read_png
    from pidnet_tpu_torch.data.transforms import gen_edge_gt, input_transform
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
    pixels = labels[0].size
    # the val loader over the tree (decoded-sample cache on: the runs below
    # decode each frame once); its batches are the frames as read here, the
    # goldens as labels and their Canny edges
    _, _, loader = build_loaders(data_config(tree), val_cache=True)
    edges = np.stack([gen_edge_gt(goldens[k].astype(np.uint8)).astype(np.float32) for k in names])
    order = [0, 1, 0]
    seen = [b[:3] for b in loader]
    want = [(images[order[i:i + 2]], labels[order[i:i + 2]], edges[order[i:i + 2]])
            for i in (0, 2)]
    same = len(seen) == 2 and all(np.array_equal(a, b) for got, exp in zip(seen, want)
                                  for a, b in zip(got, exp))
    print(f"eval: the val loader's batches [f0, f1], [f0] equal the frames, goldens and their "
          f"edges: {same}; first pass (decodes) {[round(w, 1) for w in loader.waits]} ms waiting")
    check(same, "the val loader's batches differ from the frames and goldens")
    del seen, want
    spec = M.spec_for("pidnet_s", 19, augment=True)
    model = M.build(spec, sd, device="cuda").to(memory_format=torch.channels_last)
    loss_fn = FullLoss(ignore_label=255, class_weights=CLASS_WEIGHTS, use_ohem=True,
                       ohem_thres=0.9, ohem_kept=131072, balance_weights=(0.4, 1.0),
                       sb_weights=1.0)
    cfg = engine.config(output_index=1, ignore_label=255)
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
        loader.waits.clear()
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
        print(f"eval validate {name}: batches [f0, f1], [f0] (padded, masked, from the cached "
              f"loader) in {wall * 1e3:.1f} ms ({wall * 1e3 / len(cms):.1f} ms/batch, of which "
              f"waiting for the loader {sum(loader.waits) / len(cms):.1f}) [{card}]; loss "
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


@contextlib.contextmanager
def timed_closures(torch, module, names, times: list, maps: list):
    """While active, every closure that one of the factories `module.<name>`
    makes records the host ms of each call (ending in a sync) in `times`,
    and a tensor result's class map (the argmax of probabilities) on the
    host in `maps`."""
    factories = {name: getattr(module, name) for name in names}

    def wrap(factory):
        def timed_factory(*args, **kwargs):
            fn = factory(*args, **kwargs)

            def timed(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                if torch.is_tensor(out):
                    maps.append((out if out.ndim == 3 else out.argmax(-1)).cpu().numpy())
                return out

            return timed

        return timed_factory

    for name, factory in factories.items():
        setattr(module, name, wrap(factory))
    try:
        yield
    finally:
        for name, factory in factories.items():
            setattr(module, name, factory)


def logged_losses(run_dir: str) -> list:
    """Every "Loss: x" in the train logs of a run directory."""
    losses = []
    for path in sorted(glob.glob(os.path.join(run_dir, "*_train.log"))):
        with open(path) as f:
            losses += [float(v.split(",")[0]) for v in f.read().split("Loss: ")[1:]]
    return losses


def phase_cli(torch, card: str, tree: str) -> dict:
    """The port's CLIs in-process over the Cityscapes tree: convert, train,
    resume and five evals; returns the launch counts of K1-K3 in the CLI
    runs (each counted from 0 just before the run)."""
    from pidnet_tpu_torch import engine
    from pidnet_tpu_torch.config import load_config
    from pidnet_tpu_torch.convert.fold import fold_state_dict
    from pidnet_tpu_torch.data import Loader, build_dataset
    from pidnet_tpu_torch.ops import ce_front as cf
    from pidnet_tpu_torch.ops import upsample_argmax as ua
    from pidnet_tpu_torch.tools import common, convert, train
    from pidnet_tpu_torch.tools import eval as eval_tool
    from pidnet_tpu_torch.train import checkpoint as ckpt

    work = os.path.join(tree, "cli")
    yaml = os.path.join(ROOT, "configs", "cityscapes", "pidnet_small_cityscapes.yaml")
    cfg_name = "pidnet_small_cityscapes"
    run_dir = os.path.join(work, "output", "cityscapes", cfg_name)
    base = ["DATASET.ROOT", tree, "DATASET.TRAIN_SET", "list/cityscapes/train.lst",
            "DATASET.TEST_SET", "list/cityscapes/val.lst", "OUTPUT_DIR",
            os.path.join(work, "output"), "LOG_DIR", os.path.join(work, "log")]
    counts = {"upsample_argmax": 0, "ce_front_fwd": 0, "ce_front_bwd": 0}

    def run(main, argv):
        """main(argv) with every kernel's count at 0 just before; returns
        (its result, its launches, host seconds)."""
        ua.launches = cf.fwd_launches = cf.bwd_launches = 0
        t0 = time.perf_counter()
        out = main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {"upsample_argmax": ua.launches, "ce_front_fwd": cf.fwd_launches,
               "ce_front_bwd": cf.bwd_launches}
        for k in counts:
            counts[k] += got[k]
        return out, got, secs

    port_pt = os.path.join(work, "train2k.pt")
    folded_pt = os.path.join(work, "train2k_folded.pt")
    t_phase = t0 = time.perf_counter()
    convert.main([WEIGHTS, port_pt])
    convert.main([WEIGHTS, folded_pt, "--fold"])
    print(f"cli convert: {WEIGHTS} -> port .pt and folded .pt in "
          f"{time.perf_counter() - t0:.2f} s (host)")
    check(not common.is_folded_checkpoint(port_pt) and common.is_folded_checkpoint(folded_pt),
          "convert: the folded tag")

    # train: one step an epoch (6 samples, batch 6), a validate of 3 frames
    # (val batch 1) each epoch; WORKERS 1: six loader threads decode a cold
    # batch 4.4x slower than one (PERF.md section 5)
    train_opts = [*base, "MODEL.PRETRAINED", WEIGHTS, "WORKERS", "1", "TRAIN.END_EPOCH", "2"]
    val_frames = 3
    for tag, extra, steps in (("train", [], 2), ("resume", ["TRAIN.RESUME", "true",
                                                            "TRAIN.END_EPOCH", "3"], 1)):
        step_ms = []
        with timed_closures(torch, train, ["make_train_step"], step_ms, []):
            _, got, secs = run(train.main, ["--cfg", yaml, *train_opts, *extra])
        payload = ckpt.load(os.path.join(run_dir, "checkpoint.pt"))
        losses = logged_losses(run_dir)
        print(f"cli {tag}: {len(step_ms)} steps of 6x1024x1024 bf16 and {steps} validations of "
              f"{val_frames} 1024x2048 frames in {secs:.1f} s host; ms/step "
              f"{[round(v, 1) for v in step_ms]} (host, ending in a sync); checkpoint epoch "
              f"{payload['epoch']} iter {payload['iter']}; logged losses {losses}; launches "
              f"{got} [{card}]")
        want = {"upsample_argmax": steps + steps * val_frames,
                "ce_front_fwd": 2 * steps + 2 * steps * val_frames, "ce_front_bwd": 2 * steps}
        check(got == want, f"cli {tag}: launches {got}, want {want} (1/2/2 a step, 1/2/0 a "
              f"val batch)")
        check(len(step_ms) == steps and payload["epoch"] == 2 + (tag == "resume")
              and payload["iter"] == 0, f"cli {tag}: {len(step_ms)} steps, checkpoint "
              f"{payload['epoch']}/{payload['iter']}")
        check(losses and all(np.isfinite(losses)), f"cli {tag}: logged losses {losses}")
        for name in ("checkpoint.pt", "best.pt", "final_state.pt"):
            check(os.path.isfile(os.path.join(run_dir, name)), f"cli {tag}: no {name}")

    # eval on the val list [f0, f1, f0], the goldens as labels
    eval_base = [*base, "MODEL.PRETRAINED", ""]
    cfg = load_config(yaml, eval_base)
    spec = common.build_spec(cfg)
    modes = [("unfolded fp32", [], [], port_pt, 0.995, 0),
             ("--fold-bn bf16", ["--fold-bn"], [], port_pt, 0.98, val_frames),
             ("TEST.FLIP_TEST", [], ["TEST.FLIP_TEST", "true"], port_pt, None, 0),
             ("folded .pt --fold-bn", ["--fold-bn"], [], folded_pt, 0.98, val_frames)]
    factories = ["make_inference", "make_inference_classmap", "make_ms_flip_inference"]
    maps_of = {}
    for tag, flags, opts, model_file, gate, k1 in modes:
        frame_ms, maps = [], []
        with timed_closures(torch, engine, factories, frame_ms, maps):
            scores, got, secs = run(eval_tool.main, ["--cfg", yaml, *flags, *eval_base,
                                                     "TEST.MODEL_FILE", model_file, *opts])
        maps_of[tag] = maps
        miou, iou, pixel_acc, mean_acc = scores
        print(f"cli eval {tag}: {len(frame_ms)} frames in {secs:.1f} s host; ms per testval "
              f"frame {[round(v, 1) for v in frame_ms]} (host, ending in a sync); mIoU "
              f"{miou:.6f}, pixel acc {pixel_acc:.6f}, mean acc {mean_acc:.6f}; launches {got} "
              f"[{card}]")
        check(got == {"upsample_argmax": k1, "ce_front_fwd": 0, "ce_front_bwd": 0},
              f"cli eval {tag}: launches {got}, want {k1}/0/0")
        check(all(np.isfinite(v) for v in (miou, pixel_acc, mean_acc)), f"cli eval {tag}: scores")
        if gate is not None:
            check(pixel_acc >= gate, f"cli eval {tag}: pixel accuracy {pixel_acc} < {gate}")
        if model_file == folded_pt:
            same = all(np.array_equal(a, b) for a, b in zip(maps, maps_of["--fold-bn bf16"]))
            print(f"cli eval {tag}: class maps equal to --fold-bn on the unfolded .pt: {same}")
            check(same and len(maps) == val_frames, "cli eval: the folded .pt's maps differ")
            continue
        # the CLI against engine.testval with a closure built the same way
        sd = common.load_weights(port_pt, common.init_model(cfg, spec))[0]
        if flags:
            sd = fold_state_dict(sd, spec)
        cfg_m = load_config(yaml, [*eval_base, *opts])
        make = (engine.make_ms_flip_inference if opts else
                engine.make_inference_classmap if flags else engine.make_inference)
        infer = make(cfg_m, spec, sd, folded=bool(flags),
                     compute_dtype=torch.bfloat16 if flags else None, device="cuda")
        ds = build_dataset("cityscapes", root=tree, list_path=cfg.DATASET.TEST_SET,
                           num_classes=19, multi_scale=False, flip=False, ignore_label=255,
                           base_size=cfg.TEST.BASE_SIZE,
                           crop_size=(cfg.TEST.IMAGE_SIZE[1], cfg.TEST.IMAGE_SIZE[0]))
        direct = engine.testval(cfg_m, ds, Loader(ds, 1, num_workers=0), infer)
        equal = (direct[0] == miou and direct[2:] == (pixel_acc, mean_acc)
                 and np.array_equal(direct[1], iou))
        print(f"cli eval {tag}: scores equal to engine.testval called directly: {equal}")
        check(equal, f"cli eval {tag}: {scores} != engine.testval's {direct}")
        del infer, sd

    try:
        eval_tool.main(["--cfg", yaml, *eval_base, "TEST.MODEL_FILE", folded_pt])
        code = 0
    except SystemExit as exc:
        code = exc.code
    print(f"cli eval folded .pt without --fold-bn: exits with {code!r}")
    check(code not in (0, None), "cli eval: a folded .pt without --fold-bn did not exit non-zero")
    print(f"cli: the phase took {time.perf_counter() - t_phase:.1f} s [{card}; host time]")
    logger = logging.getLogger("pidnet_tpu_torch")
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    logger.setLevel(logging.WARNING)
    torch.cuda.empty_cache()
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
    counts, speed_ms = phase_train(torch, card)
    tree = build_city_tree(tempfile.mkdtemp(prefix="chip_smoke_data_", dir=ROOT))
    try:
        loaded = phase_data(torch, card, tree, speed_ms)
        evals = phase_eval(torch, card, tree)
        clis = phase_cli(torch, card, tree)
    finally:
        shutil.rmtree(tree)
    paths = (counts, loaded, evals, clis)
    k1["launches"] = served + sum(c["upsample_argmax"] for c in paths)
    k2["launches"] = sum(c["ce_front_fwd"] for c in paths)
    k3["launches"] = sum(c["ce_front_bwd"] for c in paths)
    print(f"launches on the main paths: upsample_argmax {served} serving + "
          f"{counts['upsample_argmax']} training + {loaded['upsample_argmax']} data + "
          f"{evals['upsample_argmax']} eval + {clis['upsample_argmax']} cli, ce_front_fwd "
          f"{counts['ce_front_fwd']} training + {loaded['ce_front_fwd']} data + "
          f"{evals['ce_front_fwd']} eval + {clis['ce_front_fwd']} cli, ce_front_bwd "
          f"{counts['ce_front_bwd']} training + {loaded['ce_front_bwd']} data + "
          f"{evals['ce_front_bwd']} eval + {clis['ce_front_bwd']} cli, conv3x3 "
          f"{k4['launches']} conv_ab")

    print(card)
    print(json.dumps({"kernels": [k1, k2, k3, k4]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
