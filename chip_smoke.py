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
   direct kernel, and BiSeNet's scale-1 (1,1024,2048,19)), and the fused
   upsample+CE
   forward (K2: w exact, ignored pixels 0, nll within 1e-4) and backward
   (K3: cosine > 0.99999 against autograd of the plain forward, max-abs
   within 2^-7 of the largest value in bf16, 1e-5 in fp32), each with two
   launches on the same inputs bit-identical and its plan at each shape
   (bands, tiles, blocks, shared memory, cross-checked against the
   kernel's own layout; K2 and K3 also at BiSeNet's scale-1
   (6,1024,1024,19)); each one's time (CUDA events, median), the plain
   version's, a library call's, and its bound; K2's and K3's device time
   under torch.profiler beside their event times, K2's time at the eval
   shape and both at scale 1; K1 at the serving, training, eval and
   scale-1 shapes four ways: its
   device time (torch.profiler), raw launches without the wrapper and the
   wrapper's calls (CUDA events), and the wrapper's host time a call;
3. slice: PIDNet-S with the train2k weights, BN folded, serving the two
   sample frames at 1024x2048 in bf16 through
   engine.make_inference_classmap; the kernel's launch counter must rise
   by the number of requests; the class maps are gated against the frozen
   fp32 goldens and an fp32 reference (TF32 off); then timed requests;
   export: `python -m pidnet_tpu_torch.tools.convert --export-aot --r 1024
   2048` of the train2k weights into a temporary directory of the
   checkout; in a fresh process that imports only convert/aot.py,
   `load_serving` on the card serves both frames: the maps must equal the
   slice phase's bit for bit, K1's counter in that process must rise by
   exactly one a call, no model module may be imported; then timed
   requests beside the eager ms/img of the slice phase, `tools.speed --aot
   --profile 20` (its FPS line and device-busy share), the program and
   the eager closure in turns in another fresh process, and the eager
   closure profiled; last, a 1x256x512 export served with
   device="cpu" must equal the port's CPU class-map path;
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
   families: DDRNet-23 and BiSeNetV1 at their published widths from
   seeded weights, BN statistics settled on frame 0 (calibrate_bn), BN
   folded: both frames served at 1x1024x2048 in bf16 through
   engine.make_inference_classmap (K1 once a request; BiSeNet's logits
   arrive at the input's size, so its K1 runs at scale 1); gates: bf16
   against the unfolded fp32 model (TF32 off) >= 0.9999 where the fp32
   top-2 margin exceeds 1.0; the card's fp32 logits of every head at
   1x256x512 against the CPU's within the JAX tests' tolerances (DDRNet
   rtol 1e-4/atol 5e-4, BiSeNet 2e-4/1e-3); 3 steps of
   engine.train_one_epoch at 6x1024x1024 bf16 with the reference recipe
   (the balance weights of models.pidnet.balance_weights: 0.4 for each
   auxiliary segmentation head, 1.0 for the final one): finite losses, the first
   conv and every BN running mean moved, and the launches a step derived
   from FullLoss: K1 once (the final head's pixel accuracy), K2 once for
   the final head (its CE and its boundary-aware CE share the maps) and
   once for each other segmentation head, K3 once for each K2, so 1/2/2
   for DDRNet (one aux head) and 1/3/3 for BiSeNet (two; its K2/K3 run at
   scale 1); then each family's serving ms/img, train ms/step
   (tools/speed.py --train) and peak memory beside PIDNet-S's;
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
   batch_norm: train-mode BN's kernels (ops/batch_norm.py) against their
   plain versions at PIDNet-L's shapes and small ragged ones, bf16 and
   fp32 (the per-channel numbers within 1e-5 + 1e-4|v|, dbeta and dgamma
   within 1e-5 of their terms' magnitude, y and dx within one step of
   their dtype and 1e-5 of their largest value, the clamp's mask equal),
   two launches bit-identical; the forward's and backward's times at
   PIDNet-L's largest and a mid BN beside their byte bounds, the plain
   versions' and F.batch_norm's (yardstick only); the BN launches of one
   PIDNet-L and one PIDNet-S step (one each way a train-mode BN, 90 for
   PIDNet-L). The train and families phases gate the same per step;
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
   seconds, ms per step and ms per testval frame;
9. parallel: data parallelism (parallel/mesh.py) on the one card. (a) A
   world-1 NCCL process group: make_train_step over make_mesh at
   6x1024x1024 against the one-device step from the same seeded weights,
   in fp32 with TF32 off (first loss within rtol 1e-5, update cosine >
   0.9999) and in bf16 with the recipe (first loss within rtol 1e-5; the
   update cosine printed beside two one-device steps' own, since the bf16
   backward is nondeterministic), 1/2/2 K1/K2/K3 launches a step; both
   steps' ms/step in turns and the flat bucket's all-reduce time. (b) Two
   gloo ranks on cuda:0, spawned by parallel/launch.py, 6 of 12 crops each,
   against accum_steps=2 in this process on the same 12: in fp32 (TF32 off)
   at 512x512 the ranks' losses and updates identical, loss rtol 1e-4,
   update cosine > 0.9999, BN state rtol 1e-3 / atol 1e-5, 1/2/2 launches
   a rank a step and 2/4/4 under accumulation; then in bf16 at 1024x1024
   accumulation's ms/step beside the one-device step's, the two processes'
   ms/step sharing the card (not a scaling figure) and peak GiB a rank.
   (c) engine.make_inference_classmap over data_devices [cuda:0, cuda:0]
   gives the slice phase's maps bit for bit with one K1 launch a replica;
   the two ranks' fp32 eval step on one frame each, rank 1's masked, gives
   confusion matrices (int64 through gloo) equal to one process's frame by
   frame and the same global weight and loss. (d) tools.train --multihost
   in-process under a world-1 torchrun environment (TRAIN.ACCUM_STEPS 2,
   BATCH_SIZE_PER_GPU 3, END_EPOCH 1) on the data phase's tree: an NCCL
   process group, one step, 2/4/4 launches a step and 1/2/0 a val frame,
   and checkpoint.pt, best.pt and final_state.pt that load;
10. spatial: H-sharding (parallel/spatial.py) on the one card. (e) K1, K2
   and K3 over windows of output rows (every window of 2 spatial ranks,
   those that (a)-(c) launch, and of 4: both border shards and the
   interior, both align_corners, bf16 and fp32; K1 at serving's and
   training's shapes, K1-K3 at BiSeNet's scale 1, and K1 at scale 1 with
   1100 classes, which the direct kernel takes) against their windowed
   plain versions with the kernel phases' gates, and the whole image's
   window equal to the unwindowed launch.
   Two gloo ranks sharing cuda:0 as a (1, 2) mesh (parallel/launch.spawn):
   (a) the folded class-map closure (spatial_mesh=) on both frames at
   1x1024x2048, bf16 against the slice phase's maps (>= 0.9995) and fp32
   (TF32 off) against one device's fp32 maps (>= 0.9999), one K1 launch a
   call a rank; (b) one fp32 train step (TF32 off) at 6x1024x1024 against
   the one-device step on the same batch (loss rtol 1e-4, update cosine
   >= 0.9999, BN state within 1e-5 + 1e-3|x|), 1/2/2 launches a rank, and
   a bf16 step's cosine printed beside two one-device steps' own; (c) the
   fp32 eval step on both frames: matrices with the one-device totals,
   < 5e-3 of the pixels moved. Families, on the same ranks: DDRNet-23 and
   BiSeNetV1 at their published widths (seeded weights, BN settled on
   frame 0, as the families phase) against one device: (a) the folded
   class maps of both frames in bf16 (>= 0.9998 equal where one device's
   fp32 top-2 margin exceeds 1.0) and fp32 (>= 0.99995 of all pixels), one
   K1 launch a call (BiSeNet's windowed at scale 1); (b) one
   fp32 train step at 6x1024x1024 (loss rtol 1e-5, update cosine >
   0.9999, BN state < 0.5 of 1e-5 + 1e-3|x|), 1/2/2 launches (DDRNet) and
   1/3/3 (BiSeNet, scale 1), then bf16 steps timed; (c) the fp32 eval
   step: each matrix's total equal. Every launch of the ranks' paths over
   a window, as the wrappers' counts of windowed launches read it. Each
   rank's ms a call and a step, peak GiB, and the share of
   a call and of a step spent in collectives (timed between syncs). (d)
   The (1, 1) mesh over a world-1 NCCL group: class maps bit-equal to the
   slice phase's, the fp32 step's loss within rtol 1e-6 and update cosine
   >= 0.99999 of the one-device step whose BNs take the same sync path
   (over the world-1 group), and within (b)'s gates of the one-device
   step on the BN kernels, the eval matrices equal.

The line before the last is a JSON object with one entry per kernel, its
launches counted over every path that ran it; the last line is
{"ok": true, "device": {...}}. Without CUDA, or run outside
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import glob
import hashlib
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
# path (FullLoss's accuracy), the eval path (a val batch's matrices), a
# small batch, CamVid's 90x120 -> 720x960, an identity size, 100 classes
# (four lanes a pixel), 1100 (the direct kernel), and BiSeNet's serving
# path, whose logits arrive at the input's size (scale 1)
KERNEL_CASES = [
    ((1, 128, 256, 19), (1024, 2048)),
    ((6, 128, 128, 19), (1024, 1024)),
    ((2, 128, 256, 19), (1024, 2048)),
    ((2, 16, 32, 19), (128, 256)),
    ((1, 90, 120, 11), (720, 960)),
    ((1, 128, 256, 19), (128, 256)),
    ((1, 16, 16, 100), (128, 128)),
    ((1, 8, 8, 1100), (32, 32)),
    ((1, 1024, 2048, 19), (1024, 2048)),
]
MAIN_CASE = KERNEL_CASES[0]
K1_TIMED = {"serving": KERNEL_CASES[0], "train": KERNEL_CASES[1], "eval": KERNEL_CASES[2],
            "BiSeNet serving, scale 1": KERNEL_CASES[-1]}
WARM_REQUESTS = 5
TIMED_REQUESTS = 20

# (N, h, w, C) logits -> (oh, ow) for the loss front: the training main
# path (batch 6 of 1024x1024 crops), the eval path (a val batch of two
# 1024x2048 frames), CamVid's 720x960, an identity size, 100 classes (four
# lanes a pixel), and BiSeNet's training path, whose heads arrive at the
# labels' size (scale 1)
CE_CASES = [
    ((6, 128, 128, 19), (1024, 1024)),
    ((2, 128, 256, 19), (1024, 2048)),
    ((2, 90, 120, 11), (720, 960)),
    ((1, 128, 128, 19), (128, 128)),
    ((1, 16, 16, 100), (128, 128)),
    ((6, 1024, 1024, 19), (1024, 1024)),
]
CE_MAIN, CE_EVAL, CE_SCALE1 = CE_CASES[0], CE_CASES[1], CE_CASES[-1]

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
        args = (x.data_ptr(), out.data_ptr(), n, h, w, c, *out_hw, h, 0, out_hw[0], 0, 1,
                plan.band, plan.tile, plan.lpp, plan.window, plan.threads,
                torch.cuda.current_stream().cuda_stream)
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
    fp32 maps, or dL in the logits' dtype, written once) over 3.35 TB/s,
    its fp32 operations over 67 TFLOP/s, and its exp/log/reciprocal over
    the special-function rate.
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
        nbytes = 2 * logits + 2 * pixels * 4  # dL has the logits' dtype
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

    shape, out_hw = CE_SCALE1  # K2 and K3 on BiSeNet's training path
    base, labels, cw, g = ce_inputs(torch, rng, shape, out_hw)
    x = base.to(torch.bfloat16)
    counted = (labels >= 0) & (labels < shape[3])
    for name, kernel, fn, n_counted, backward in (
        ("ce_front_fwd", "ce_fwd_kernel",
         lambda: cf.ce_front_fwd(x, labels, cw, 255, out_hw, True), int(counted.sum()), False),
        ("ce_front_bwd", "ce_bwd_kernel",
         lambda: cf.ce_front_bwd(x, labels, 255, out_hw, True, g),
         int((counted & (g != 0)).sum()), True),
    ):
        ms = time_ms(fn)
        k_ms, _ = kernel_device_ms(torch, fn, kernel)
        bound_ms, bound_by = ce_bound_ms(shape, out_hw, x.element_size(), n_counted, backward)
        print(f"kernel {name} {shape}->{out_hw} bf16 (BiSeNet's training shape, scale 1): "
              f"{ms:.4f} ms (CUDA events), device {k_ms:.4f} ms (torch.profiler), bound "
              f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / k_ms:.1%} of bound")
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
    profiled calls (tools/speed.device_breakdown). A trace that recorded
    none of the kernel's launches (torch.profiler drops a cycle's device
    events now and then) is taken again, up to three times."""
    from pidnet_tpu_torch.tools.speed import device_breakdown

    for _ in range(3):
        _, busy, rows = device_breakdown(lambda _: fn(), None, torch.device("cuda"), calls,
                                         top=None)
        k_ms = sum(ms for name, ms, _ in rows if kernel in name)
        if k_ms > 0:
            return k_ms, busy
    raise RuntimeError(f"torch.profiler recorded no {kernel} launch in three traces")


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


# (N, C, H, W) of PIDNet-L's train-mode BNs at 12 x 1024^2 that the BN phase
# times: the largest (the stem's first, at 1/2 resolution) and the commonest
# (29 of the 90, at 1/8 resolution); then the other gated shapes: 1/64 of
# the largest, DAPPM's 560 channels, the last stage's 1024, pooled vectors,
# ragged rows, 96 and 19 channels (8- and 2-byte loads in bf16)
BN_TIMED = {"largest": (12, 64, 512, 512), "mid": (12, 128, 128, 128)}
BN_CASES = [*BN_TIMED.values(), (12, 64, 64, 64), (12, 560, 16, 16), (12, 1024, 32, 32),
            (4, 1024, 1, 1), (3, 96, 5, 7), (2, 19, 3, 5)]
# bytes the forward and the backward must move, in passes over x: the
# forward reads x for the sums, then reads x and writes y; the backward
# reads x and dy for the sums, then reads both again and writes dx
BN_PASSES = {"forward": 3, "backward": 5}


def bn_inputs(torch, shape, dtype, seed: int = 0):
    """Seeded channels_last x (mean 1, spread 3) and dy, fp32 gamma, beta,
    running mean and running variance, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=g, device="cuda") * 3 + 1
    dy = torch.randn(shape, generator=g, device="cuda")
    x, dy = (t.to(dtype).contiguous(memory_format=torch.channels_last) for t in (x, dy))
    gamma, beta, rm = (torch.randn(c, generator=g, device="cuda") for _ in range(3))
    return x, dy, gamma, beta, rm, torch.rand(c, generator=g, device="cuda") + 0.5


def bn_modules(model) -> int:
    """The train-mode BN calls of one forward of `model`: one a BatchNorm
    module in every family."""
    from pidnet_tpu_torch.models import pidnet as M

    return sum(isinstance(m, M.BatchNorm) for m in model.modules())


def phase_batch_norm(torch, bn) -> dict:
    """Train-mode BN's kernels against their plain versions at BN_CASES,
    bf16 and fp32 (tests/test_torch_cuda.py's gates), two launches
    bit-identical; at BN_TIMED in bf16 the forward's and the backward's
    times (CUDA events and the profiler's device time) beside their byte
    bounds, the plain versions' and F.batch_norm's (the yardstick only:
    the port never calls it), and the host's time a call; then the BN
    launches of one bf16 PIDNet-L and PIDNet-S training step. Returns the
    JSON entry of the kernels."""
    import torch.nn.functional as F

    from pidnet_tpu_torch.losses.criterion import FullLoss
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.train.step import TrainState, make_train_step
    from pidnet_tpu_torch.utils.timing import time_ms

    worst = {"y": 0.0, "dx": 0.0, "dgamma": 0.0, "dbeta": 0.0}
    for shape in BN_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x, dy, gamma, beta, rm, rv = bn_inputs(torch, shape, dtype)
            y, ws = bn.bn_forward(x, gamma, beta, rm, rv, 0.1)
            dx, dg, db = bn.bn_backward(x, dy, ws)
            again = [*bn.bn_forward(x, gamma, beta, rm, rv, 0.1)]
            again += bn.bn_backward(x, dy, again[1])
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip((y, ws, dx, dg, db), again))
            y_p, ws_p = bn.bn_forward_plain(x, gamma, beta, rm, rv, 0.1)
            dx_p, dg_p, db_p = bn.bn_backward_plain(x, dy, ws_p)
            stats = max(float(((ws[r] - ws_p[r]).abs() / (1e-5 + 1e-4 * ws_p[r].abs())).max())
                        for r in range(bn.VAR_MASK))
            xh = (x.float() - ws_p[bn.MEAN].view(1, -1, 1, 1)) * ws_p[bn.RSTD].view(1, -1, 1, 1)
            sums = {}
            for name, got, want, terms in (("dbeta", db, db_p, dy.float().abs()),
                                           ("dgamma", dg, dg_p, (dy.float() * xh).abs())):
                sums[name] = float(((got - want).abs() / terms.sum(dim=(0, 2, 3))).max())
            del xh
            step = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
            maps = {}
            for name, got, want in (("y", y, y_p), ("dx", dx, dx_p)):
                want = want.float()
                tol = step * want.abs() + 1e-5 * float(want.abs().max())
                maps[name] = float(((got.float() - want).abs() / tol).max())
            for k, v in (*sums.items(), *maps.items()):
                worst[k] = max(worst[k], v)
            print(f"kernel batch_norm {shape} {str(dtype)[6:]}: per-channel numbers "
                  f"{stats:.3f} of 1e-5 + 1e-4|v|, mask equal "
                  f"{torch.equal(ws[bn.VAR_MASK], ws_p[bn.VAR_MASK])}; dbeta {sums['dbeta']:.2e} "
                  f"and dgamma {sums['dgamma']:.2e} of their terms' magnitude (<= 1e-5); y "
                  f"{maps['y']:.3f} and dx {maps['dx']:.3f} of {step:.2g}|v| + 1e-5 max|v| "
                  f"(<= 1); two launches bit-identical {same}")
            check(same and stats <= 1 and torch.equal(ws[bn.VAR_MASK], ws_p[bn.VAR_MASK])
                  and max(sums.values()) <= 1e-5 and max(maps.values()) <= 1,
                  f"batch_norm {shape} {dtype}: the kernels disagree with their plain versions")
            del x, dy, y, dx, y_p, dx_p, again
    torch.cuda.empty_cache()

    timed = {}
    for label, shape in BN_TIMED.items():
        x, dy, gamma, beta, rm, rv = bn_inputs(torch, shape, torch.bfloat16, seed=1)
        ws = bn.bn_forward(x, gamma, beta, rm, rv, 0.1)[1]
        fns = {"forward": lambda: bn.bn_forward(x, gamma, beta, rm, rv, 0.1),
               "backward": lambda: bn.bn_backward(x, dy, ws)}
        plain = {"forward": lambda: bn.bn_forward_plain(x, gamma, beta, rm, rv, 0.1),
                 "backward": lambda: bn.bn_backward_plain(x, dy, ws)}
        xr, gr, br = (t.detach().clone().requires_grad_(True) for t in (x, gamma, beta))
        rm_l, rv_l = rm.clone(), rv.clone()

        def lib_forward():
            return F.batch_norm(xr, rm_l, rv_l, gr, br, training=True, momentum=0.1, eps=1e-5)

        def lib_both():
            return torch.autograd.grad(lib_forward(), (xr, gr, br), dy)

        lib_fwd = time_ms(lib_forward, batches=5, per_batch=5)
        library = {"forward": lib_fwd, "backward": time_ms(lib_both, batches=5, per_batch=5)
                   - lib_fwd}
        nbytes = x.numel() * x.element_size()
        for way, fn in fns.items():
            ms = time_ms(fn, batches=5, per_batch=10)
            device, every = kernel_device_ms(torch, fn, "bn_")
            bound = BN_PASSES[way] * nbytes / HBM_BYTES_PER_S * 1e3
            plain_ms = time_ms(plain[way], batches=3, per_batch=3)
            host = host_ms(torch, fn)
            timed[label, way] = (ms, device, bound, plain_ms, library[way])
            print(f"kernel batch_norm {label} {shape} bf16 {way}: {ms:.4f} ms (CUDA events), "
                  f"device {device:.4f} ms (torch.profiler; every kernel of the call "
                  f"{every:.4f}); bound {bound:.4f} ms ({BN_PASSES[way]} passes of "
                  f"{nbytes / 1e6:.1f} MB at 3.35 TB/s), kernels at {bound / device:.1%} of it; "
                  f"plain version {plain_ms:.4f} ms; F.batch_norm {library[way]:.4f} ms "
                  f"(library_ms, yardstick only); host {host:.4f} ms a call")
        del x, dy, ws, xr, fns, plain
        torch.cuda.empty_cache()

    dev = torch.device("cuda")
    steps = {}
    for name in ("pidnet_l", "pidnet_s"):
        spec = M.spec_for(name, 19, augment=True)
        ts = TrainState.create(M.build(spec, M.init(spec, torch.Generator().manual_seed(SEED)),
                                       device=dev, train=True))
        step = make_train_step(ts, FullLoss(ignore_label=255, ohem_kept=1000),
                               compute_dtype=torch.bfloat16)
        rng = np.random.default_rng(SEED)
        img = torch.from_numpy(rng.standard_normal((2, 256, 256, 3)).astype(np.float32)).to(dev)
        lab = torch.from_numpy(rng.integers(0, 19, (2, 256, 256)).astype(np.int32)).to(dev)
        edge = torch.from_numpy((rng.random((2, 256, 256)) < 0.1).astype(np.float32)).to(dev)
        before = bn.fwd_launches, bn.bwd_launches
        loss = float(step(img, lab, edge, 0.01)["loss"])
        got = (bn.fwd_launches - before[0], bn.bwd_launches - before[1])
        steps[name] = (got, bn_modules(ts.model))
        print(f"batch_norm: one bf16 {name} step (2x256x256) launched the BN forward {got[0]} "
              f"and backward {got[1]} times for its {steps[name][1]} train-mode BNs; loss "
              f"{loss:.4f}")
        check(np.isfinite(loss) and got == (steps[name][1],) * 2,
              f"batch_norm: {name} step launched {got}, want {steps[name][1]} each way")
        del ts, step
    check(steps["pidnet_l"][1] == 90, "PIDNet-L has 90 train-mode BNs")
    torch.cuda.empty_cache()
    ms, device, bound, plain_ms, library_ms = (
        f + b for f, b in zip(timed["largest", "forward"], timed["largest", "backward"]))
    return {
        "name": "batch_norm", "route": "cuda", "source": "pidnet_tpu_torch/csrc/batch_norm.cu",
        "replaces": None, "launches": None, "worst": worst, "ms": ms, "device_ms": device,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes", "library_ms": library_ms,
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


def timed_requests(torch, serve, x) -> list:
    """Host ms of each of TIMED_REQUESTS calls `serve(x)`, each ending in a
    sync, after WARM_REQUESTS warm-up calls."""
    for _ in range(WARM_REQUESTS):
        serve(x)
    times = []
    for _ in range(TIMED_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase_slice(torch, card: str) -> dict:
    """Serve the sample frames; returns the number of requests served
    ("requests"), the frames' normalised inputs ("frames") and bf16 class
    maps ("maps") in the goldens' order, and the timed requests' median
    and mean ms/img."""
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
    maps = []
    for name, x in frames.items():
        got = serve(x).cpu().numpy()[0]
        maps.append(got)
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

    times = timed_requests(torch, serve, torch.from_numpy(next(iter(frames.values()))).cuda())
    requests += WARM_REQUESTS + TIMED_REQUESTS
    mean = statistics.fmean(times)
    print(f"slice serve PIDNet-S bf16 folded 1x1024x2048 -> class map, device-resident fp32 "
          f"input, {TIMED_REQUESTS} requests: median {statistics.median(times):.3f} ms/img, "
          f"mean {mean:.3f} ms/img, {1e3 / mean:.1f} FPS [{card}]")
    check(ua.launches == requests,
          f"upsample_argmax launched {ua.launches} times for {requests} requests")
    print(f"slice: upsample_argmax launches {ua.launches} for {requests} requests")
    return {"requests": requests, "frames": list(frames.values()), "maps": maps,
            "median_ms": statistics.median(times), "mean_ms": mean}


AOT_HW = (1024, 2048)
AOT_CPU_HW = (256, 512)


def serve_artifact(work: str) -> None:
    """The export phase's fresh process on the card: load `work`/serve.pt2
    with `convert.aot.load_serving` alone, serve each `frame_<i>.npy`, hold
    the maps to `map_<i>.npy` and count K1's launches a call, then time
    requests; prints one JSON line."""
    import torch

    from pidnet_tpu_torch.convert.aot import load_serving
    from pidnet_tpu_torch.ops import upsample_argmax as ua

    serve = load_serving(os.path.join(work, "serve.pt2"))
    models = sorted(m for m in sys.modules if m.startswith("pidnet_tpu_torch.models"))
    frames = sorted(glob.glob(os.path.join(work, "frame_*.npy")))
    ua.launches = 0
    equal, launches = [], []
    for i, path in enumerate(frames):
        x = torch.from_numpy(np.load(path)).cuda()
        got = serve(x).cpu().numpy()
        want = np.load(os.path.join(work, f"map_{i}.npy"))
        equal.append(got.shape == want.shape and bool(np.array_equal(got, want)))
        launches.append(ua.launches)
    before = ua.launches
    times = timed_requests(torch, serve, x)
    print(json.dumps({"input_shape": serve.input_shape, "equal": equal, "launches": launches,
                      "timed_launches": ua.launches - before, "models_imported": models,
                      "median_ms": statistics.median(times), "mean_ms": statistics.fmean(times),
                      "total_launches": ua.launches}))


TURN_ROUNDS = 6


def turns_artifact(work: str) -> None:
    """The export phase's second fresh process on the card: the program
    (`work`/serve.pt2) and the eager closure of the same weights in turns,
    TURN_ROUNDS rounds of timed_requests each, the order flipped every
    round, from a process that has done nothing else (the main process's
    heap slows and spreads its host times); prints one JSON line with
    each round's median and the program graph's op counts."""
    import torch

    from pidnet_tpu_torch import engine
    from pidnet_tpu_torch.convert.aot import load_serving
    from pidnet_tpu_torch.convert.fold import fold_state_dict
    from pidnet_tpu_torch.convert.weights import load_npz
    from pidnet_tpu_torch.models import pidnet as M

    spec = M.spec_for("pidnet_s", 19, augment=False)
    eager = engine.make_inference_classmap(engine.config(), spec,
                                           fold_state_dict(load_npz(WEIGHTS), spec),
                                           folded=True, compute_dtype=torch.bfloat16)
    program = load_serving(os.path.join(work, "serve.pt2"))
    fns = {"eager": eager, "program": program}
    x = torch.from_numpy(np.load(os.path.join(work, "frame_0.npy"))).cuda()
    rounds = {name: [] for name in fns}
    for r in range(TURN_ROUNDS):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            rounds[name].append(statistics.median(timed_requests(torch, fns[name], x)))
    calls = collections.Counter(str(node.target) for node in program.program.graph.nodes
                                if node.op == "call_function")
    run = collections.Counter(str(node.target) for node in program._fn.graph.nodes
                              if node.op == "call_function")
    print(json.dumps({"rounds": rounds, "ops": calls.most_common(), "ops_run": sum(run.values())}))


def run_python(args, label: str) -> str:
    """`python args` in a fresh process from the checkout's root; its
    stdout, or a failed check with its output."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    print(f"export: {label} in a fresh process, {time.perf_counter() - t0:.1f} s host")
    check(proc.returncode == 0, f"{label} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
          f"{proc.stderr[-3000:]}")
    return proc.stdout


def phase_export(torch, card: str, served: dict) -> int:
    """The serving export: tools.convert --export-aot of the train2k
    weights at 1x1024x2048, the program served in a fresh process on the
    card against the slice phase's maps and timed, tools.speed --aot, and
    a 1x256x512 export served on the CPU against the port's CPU path.
    Returns K1's launches in the fresh process."""
    from pidnet_tpu_torch import engine
    from pidnet_tpu_torch.convert.aot import export_serving, load_serving
    from pidnet_tpu_torch.convert.fold import fold_state_dict
    from pidnet_tpu_torch.convert.weights import load_npz
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.tools import speed

    work = tempfile.mkdtemp(prefix="chip_smoke_aot_", dir=ROOT)
    try:
        artifact = os.path.join(work, "serve.pt2")
        out = run_python(["-m", "pidnet_tpu_torch.tools.convert", "--export-aot", "--r",
                          *map(str, AOT_HW), WEIGHTS, artifact], "tools.convert --export-aot")
        print(f"export: {out.strip().splitlines()[-1]}")
        for i, (x, m) in enumerate(zip(served["frames"], served["maps"])):
            np.save(os.path.join(work, f"frame_{i}.npy"), x)
            np.save(os.path.join(work, f"map_{i}.npy"), m[None])
        code = f"import chip_smoke; chip_smoke.serve_artifact({work!r})"
        child = json.loads(
            run_python(["-c", code], "load_serving").strip().splitlines()[-1])
        n = len(served["maps"])
        print(f"export: the program in a fresh process: input {child['input_shape']}, maps equal "
              f"to the slice phase's bit for bit {child['equal']}, K1 launches after each call "
              f"{child['launches']} (+{child['timed_launches']} over "
              f"{WARM_REQUESTS + TIMED_REQUESTS} timed calls), model modules imported "
              f"{child['models_imported']}")
        check(child["equal"] == [True] * n, "the program's class maps differ from the slice's")
        check(child["launches"] == list(range(1, n + 1))
              and child["timed_launches"] == WARM_REQUESTS + TIMED_REQUESTS,
              "K1 did not launch exactly once a call inside the program")
        check(not child["models_imported"], "loading the program imported model code")
        print(f"export serve PIDNet-S bf16 folded 1x1024x2048 -> class map through the program, "
              f"device-resident fp32 input, {TIMED_REQUESTS} requests: median "
              f"{child['median_ms']:.3f} ms/img, mean {child['mean_ms']:.3f} ms/img; eager "
              f"engine.make_inference_classmap in the slice phase: median "
              f"{served['median_ms']:.3f}, mean {served['mean_ms']:.3f} ms/img [{card}]")

        out = run_python(["-m", "pidnet_tpu_torch.tools.speed", "--aot", artifact,
                          "--profile", "20"], "tools.speed --aot --profile 20")
        line = [ln for ln in out.splitlines() if "FPS" in ln]
        check("AOT Artifact Speed Testing" in out and len(line) == 1,
              f"tools.speed --aot printed:\n{out}")
        print(f"export: tools.speed --aot: {line[0]} [{card}]")
        for ln in out.splitlines()[out.splitlines().index(line[0]) + 1:][:6]:
            print(f"export: tools.speed --aot {ln.strip()}")

        # the program against the eager closure in turns, in a fresh process
        code = f"import chip_smoke; chip_smoke.turns_artifact({work!r})"
        turns = json.loads(run_python(["-c", code], "turns").strip().splitlines()[-1])
        print(f"export: the program's graph calls {sum(n for _, n in turns['ops'])} ops a "
              f"request as exported ("
              + ", ".join(f"{n} {name}" for name, n in turns["ops"][:4])
              + f"), {turns['ops_run']} as loaded (no metadata asserts)")
        medians = {name: statistics.median(v) for name, v in turns["rounds"].items()}
        print(f"export: in turns in a fresh process ({TURN_ROUNDS} rounds of {TIMED_REQUESTS} "
              f"requests each, order flipped each round): "
              + ", ".join(f"{name} median {medians[name]:.3f} ms/img (rounds "
                          + " ".join(f"{t:.3f}" for t in v) + ")"
                          for name, v in turns["rounds"].items())
              + f"; program/eager {medians['program'] / medians['eager']:.3f} [{card}]")
        spec = M.spec_for("pidnet_s", 19, augment=False)
        sd = load_npz(WEIGHTS)
        eager = engine.make_inference_classmap(engine.config(), spec, fold_state_dict(sd, spec),
                                               folded=True, compute_dtype=torch.bfloat16)
        x = torch.from_numpy(served["frames"][0]).cuda()
        wall, busy, _ = speed.device_breakdown(eager, x, torch.device("cuda"), 20)
        print(f"export: eager engine.make_inference_classmap profiled over 20 calls: wall "
              f"{wall:.3f} ms/call, device busy {busy:.3f} ms/call ({busy / wall:.1%}) [{card}]")
        del eager

        # the two-device claim: a small export served on the CPU
        h, w = AOT_CPU_HW
        x = torch.from_numpy(np.ascontiguousarray(served["frames"][0][:, :h, :w]))
        t0 = time.perf_counter()
        cpu_serve = load_serving(export_serving(sd, spec, (h, w)), device="cpu")
        got = cpu_serve(x)
        want = engine.make_inference_classmap(engine.config(), spec, fold_state_dict(sd, spec),
                                              folded=True, compute_dtype=torch.bfloat16,
                                              device="cpu")(x)
        same = torch.equal(got, want)
        print(f"export: a 1x{h}x{w} program on the CPU against the port's CPU class-map path: "
              f"equal {same}, {got.shape} {got.dtype} ({time.perf_counter() - t0:.1f} s host)")
        check(same and got.device.type == "cpu", "the CPU program's maps differ")
    finally:
        shutil.rmtree(work)
    return child["total_launches"]


class _NoWriter:
    def add_scalar(self, tag, value, step):
        pass


@contextlib.contextmanager
def plain_versions(cf, ua, criterion):
    """FullLoss through the plain versions of K1-K3 on CUDA tensors, for
    the comparison only: the wrappers never fall back on their own."""
    saved = (cf.ce_front_fwd, cf.ce_front_bwd, criterion.upsample_argmax_rows)
    cf.ce_front_fwd, cf.ce_front_bwd = cf.ce_front_fwd_plain, cf.ce_front_bwd_plain
    criterion.upsample_argmax_rows = ua.upsample_argmax_plain
    try:
        yield
    finally:
        cf.ce_front_fwd, cf.ce_front_bwd, criterion.upsample_argmax_rows = saved


def phase_train(torch, card: str) -> tuple:
    """Train PIDNet-S through engine.train_one_epoch; returns the launch
    counts of that run by kernel, and tools/speed.py --train's ms/step and
    peak GiB."""
    import torch.nn.functional as F

    from pidnet_tpu_torch import engine
    from pidnet_tpu_torch.data.cityscapes import CLASS_WEIGHTS
    from pidnet_tpu_torch.data.synthetic import synthetic_epoch
    from pidnet_tpu_torch.losses import criterion
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.ops import batch_norm as bn
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
    bn_before = bn.fwd_launches, bn.bwd_launches
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
    bns = (bn.fwd_launches - bn_before[0], bn.bwd_launches - bn_before[1])
    print(f"train: batch_norm launches {bns[0]} forward, {bns[1]} backward "
          f"({bn_modules(ts.model)} train-mode BNs a step)")
    check(bns == (bn_modules(ts.model) * done,) * 2,
          f"batch_norm launched {bns} for {done} steps, want one each way a BN")

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
    return counts, result["ms_per_step"], peak


# name: the card-vs-CPU logits tolerance (rtol, atol) of the family's JAX test
FAMILIES = {
    "ddrnet_23_adb_bag": (1e-4, 5e-4),
    "bisenet_adb_bag": (2e-4, 1e-3),
}
FAMILY_STEPS = 3
FAMILY_CPU_HW = (256, 512)


def conv_gflop(torch, spec, shape) -> float:
    """GFLOP (2 per multiply-add) of every conv of `spec`'s network on an
    NHWC input of `shape`, counted by forward hooks on meta tensors (in
    eval mode: the BNs' mode changes no conv, and train-mode BN runs on the
    card or the CPU only)."""
    from pidnet_tpu_torch.models import pidnet as M

    total = 0

    def count(mod, inputs, out):
        nonlocal total
        total += 2 * out.numel() * mod.weight[0].numel()

    with torch.device("meta"):
        model = M.module_for(spec)(spec).eval()
        for mod in model.modules():
            if isinstance(mod, M.Conv2d):
                mod.register_forward_hook(count)
        model(torch.empty(shape))
    return total / 1e9


def fp32_final_head(torch, model, x):
    """(class map, top-2 margin) of the final head of an augment model's
    fp32 logits, upsampled to the input with align_corners=True."""
    import torch.nn.functional as F

    with torch.inference_mode():
        logits = model(x)[-2]
        up = F.interpolate(logits.permute(0, 3, 1, 2), size=tuple(x.shape[1:3]),
                           mode="bilinear", align_corners=True)
        top2 = up.topk(2, dim=1).values
        return up.argmax(dim=1).int(), top2[:, 0] - top2[:, 1]


def family_weights(torch, name: str, frame, dev) -> tuple:
    """(spec, unfolded state dict on the CPU) of a family at its published
    widths, augment: seeded weights whose BN statistics were settled on
    `frame` (convert.fold.calibrate_bn)."""
    from pidnet_tpu_torch.convert.fold import calibrate_bn
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.tools.common import spec_from_name

    spec = spec_from_name(name, 19, augment=True)
    sd = M.init(spec, torch.Generator().manual_seed(SEED))
    sd.update({k: v.cpu() for k, v in
               calibrate_bn(sd, spec, torch.from_numpy(frame).to(dev)).items()})
    return spec, sd


def phase_families(torch, card: str, frames: list, pidnet: dict) -> dict:
    """DDRNet-23 and BiSeNetV1 at their published widths from seeded
    weights whose BN statistics were settled on frame 0 (calibrate_bn):
    served folded bf16 at 1x1024x2048 against the fp32 model, the card's
    fp32 logits against the CPU's, and FAMILY_STEPS train steps at
    6x1024x1024 bf16 with the reference recipe; then each one's serving
    ms/img, train ms/step and peak memory beside PIDNet-S's (`pidnet`).
    Returns the launch counts of K1-K3 in the served and trained runs."""
    import dataclasses

    from pidnet_tpu_torch import engine
    from pidnet_tpu_torch.convert.fold import fold_state_dict
    from pidnet_tpu_torch.data.synthetic import synthetic_epoch
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.ops import batch_norm as bn
    from pidnet_tpu_torch.ops import ce_front as cf
    from pidnet_tpu_torch.ops import upsample_argmax as ua
    from pidnet_tpu_torch.tools import speed
    from pidnet_tpu_torch.tools.common import spec_from_name
    from pidnet_tpu_torch.train.step import TrainState, make_train_step

    dev = torch.device("cuda")
    counts = {"upsample_argmax": 0, "ce_front_fwd": 0, "ce_front_bwd": 0}
    images, labels, edges = synthetic_epoch(np.random.default_rng(SEED), 6, 1024)
    batch = tuple(torch.from_numpy(a).to(dev) for a in (images, labels, edges))
    rows = []
    for name, (rtol, atol) in FAMILIES.items():
        t_family = time.perf_counter()
        spec, sd = family_weights(torch, name, frames[0], dev)
        balance = M.balance_weights(spec)
        # K1 once a step (pixel accuracy); K2 and K3 once a segmentation head
        per_step = (1, len(balance), len(balance))
        spec1 = dataclasses.replace(spec, augment=False)
        serve = engine.make_inference_classmap(engine.config(), spec1, fold_state_dict(sd, spec1),
                                               folded=True, compute_dtype=torch.bfloat16)
        ref_model = M.build(spec, sd, device=dev).to(memory_format=torch.channels_last)

        ua.launches = 0  # the served path starts here
        requests = 0
        for i, frame in enumerate(frames):
            x = torch.from_numpy(frame).to(dev)
            got = serve(x)
            requests += 1
            ref, margin = fp32_final_head(torch, ref_model, x)
            conf = margin > 1.0
            confident = float((got == ref)[conf].float().mean())
            print(f"families {name} frame {i}: bf16 folded vs fp32 unfolded on margin>1.0 "
                  f"{confident:.6f} (>=0.9999, {float(conf.float().mean()):.3f} of pixels), "
                  f"all {float((got == ref).float().mean()):.6f}; classes used "
                  f"{int(got.unique().numel())}")
            check(got.shape == (1, *frame.shape[1:3]) and got.dtype == torch.int32,
                  f"{name}: served map {got.shape} {got.dtype}")
            check(confident >= 0.9999, f"{name}: bf16 disagrees with fp32 on confident pixels")
        times = timed_requests(torch, serve, x)
        requests += WARM_REQUESTS + TIMED_REQUESTS
        check(ua.launches == requests, f"{name}: K1 launched {ua.launches} times for "
              f"{requests} requests")
        counts["upsample_argmax"] += ua.launches
        serve_ms = statistics.median(times)
        del serve

        # the card's fp32 logits against the CPU's, every head
        h, w = FAMILY_CPU_HW
        xs = np.ascontiguousarray(frames[0][:, :h, :w])
        with torch.inference_mode():
            card_heads = [o.cpu().numpy() for o in ref_model(torch.from_numpy(xs).to(dev))]
            cpu_heads = [o.numpy() for o in
                         M.build(spec, sd, device="cpu")(torch.from_numpy(xs))]
        worst = max(float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b))))
                    for a, b in zip(card_heads, cpu_heads))
        print(f"families {name}: card fp32 vs CPU fp32 logits, {len(card_heads)} heads at "
              f"1x{h}x{w}: worst |diff| / (atol {atol} + rtol {rtol} |cpu|) = {worst:.3f} (<= 1)")
        check(worst <= 1.0, f"{name}: the card's fp32 logits differ from the CPU's")
        del ref_model, card_heads, cpu_heads

        # FAMILY_STEPS steps of the reference recipe through engine.train_one_epoch
        ts = TrainState.create(M.build(spec, sd, device=dev, train=True))
        first = next(k for k, _ in ts.model.named_parameters())
        w0 = ts.params()[first].clone()
        stats0 = {k: v.clone() for k, v in ts.state().items()}
        step = make_train_step(ts, recipe_loss(balance), momentum=0.9, weight_decay=5e-4,
                               compute_dtype=torch.bfloat16)
        history = []

        def recording_step(*args):
            history.append(step(*args))
            return history[-1]

        ua.launches = cf.fwd_launches = cf.bwd_launches = 0  # the trained path starts here
        bn_before = bn.fwd_launches, bn.bwd_launches
        engine.train_one_epoch(engine.config(print_freq=10), 0, FAMILY_STEPS, TRAIN_NUM_ITERS,
                               0.01, [(*batch, None, None)] * FAMILY_STEPS, recording_step, ts,
                               {"writer": _NoWriter(), "train_global_steps": 0})
        got = {"upsample_argmax": ua.launches, "ce_front_fwd": cf.fwd_launches,
               "ce_front_bwd": cf.bwd_launches}
        for k in counts:
            counts[k] += got[k]
        losses = [float(m["loss"]) for m in history]
        moved = not torch.equal(ts.params()[first], w0)
        stats_moved = all(not torch.equal(v, stats0[k]) for k, v in ts.state().items()
                          if k.endswith("running_mean"))
        want = dict(zip(got, (FAMILY_STEPS * n for n in per_step)))
        bns = (bn.fwd_launches - bn_before[0], bn.bwd_launches - bn_before[1])
        print(f"families {name}: {len(losses)} train steps 6x1024x1024 bf16, losses "
              f"{[round(v, 4) for v in losses]}, {first} moved {moved}, every BN running mean "
              f"moved {stats_moved}, launches {got} (want {want}: "
              f"{'/'.join(map(str, per_step))} a step); batch_norm {bns[0]} forward, {bns[1]} "
              f"backward ({bn_modules(ts.model)} train-mode BNs a step)")
        check(bns == (FAMILY_STEPS * bn_modules(ts.model),) * 2,
              f"{name}: batch_norm launched {bns}, want one each way a BN and step")
        check(len(losses) == FAMILY_STEPS and all(np.isfinite(losses)),
              f"{name}: a training loss is not finite")
        check(moved and stats_moved, f"{name}: the step moved no weights or no BN statistics")
        check(got == want, f"{name}: launches {got}, want {want}")
        del ts, step, history

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        bench_step, placed = speed.make_train_bench(name, 19, (1024, 1024), 6, dev)
        result = speed.measure_train(bench_step, placed, dev)
        peak = torch.cuda.max_memory_allocated() / 2**30
        del bench_step, placed
        torch.cuda.empty_cache()
        print(f"families {name}: train speed bf16 6x1024x1024 (tools/speed.py --train): "
              f"{speed.train_line(result)}, peak {peak:.2f} GiB allocated; the family took "
              f"{time.perf_counter() - t_family:.1f} s host [{card}]")
        rows.append((name, serve_ms, result["ms_per_step"], peak))
    rows.append(("pidnet_s", pidnet["serve_ms"], pidnet["train_ms"], pidnet["peak_gib"]))
    for name, serve_ms, train_ms, peak in rows:
        serve_gf = conv_gflop(torch, spec_from_name(name, 19, augment=False), (1, 1024, 2048, 3))
        train_gf = 3 * conv_gflop(torch, spec_from_name(name, 19, augment=True),
                                  (6, 1024, 1024, 3))
        print(f"families summary {name}: serve bf16 folded 1x1024x2048 median {serve_ms:.3f} "
              f"ms/img (convs {serve_gf:.1f} GFLOP, {serve_gf / BF16_FLOPS * 1e12:.3f} ms at "
              f"989 TFLOP/s); train bf16 6x1024x1024 {train_ms:.2f} ms/step (convs forward and "
              f"backward {train_gf:.1f} GFLOP, {train_gf / BF16_FLOPS * 1e12:.3f} ms), peak "
              f"{peak:.2f} GiB [{card}]")
    return counts


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


# the parallel phase: the crop of its fp32 gates, its timed steps a window
PARALLEL_GATE_HW = 512
PARALLEL_TIMED = 5
PARALLEL_WORLD = 2


def recipe_loss(balance=(0.4, 1.0)):
    """FullLoss of the reference recipe: OHEM 0.9/131072, Cityscapes class
    weights, `balance` weights (models.pidnet.balance_weights: PIDNet's and
    DDRNet's (0.4, 1.0), BiSeNet's (0.4, 0.4, 1.0))."""
    from pidnet_tpu_torch.data.cityscapes import CLASS_WEIGHTS
    from pidnet_tpu_torch.losses.criterion import FullLoss

    return FullLoss(num_outputs=len(balance), ignore_label=255, class_weights=CLASS_WEIGHTS,
                    use_ohem=True, ohem_thres=0.9, ohem_kept=131072, balance_weights=balance,
                    sb_weights=1.0)


def kernel_counts(reset: bool = False) -> dict:
    """K1-K3's launch counts, set to 0 first with `reset` (their counts of
    windowed launches too)."""
    from pidnet_tpu_torch.ops import ce_front as cf
    from pidnet_tpu_torch.ops import upsample_argmax as ua

    if reset:
        ua.launches = cf.fwd_launches = cf.bwd_launches = 0
        ua.window_launches = cf.fwd_window_launches = cf.bwd_window_launches = 0
    return {"upsample_argmax": ua.launches, "ce_front_fwd": cf.fwd_launches,
            "ce_front_bwd": cf.bwd_launches}


def window_counts() -> dict:
    """K1-K3's counts of launches over a window other than the whole image
    (H-sharding), set to 0 with `kernel_counts(reset=True)`."""
    from pidnet_tpu_torch.ops import ce_front as cf
    from pidnet_tpu_torch.ops import upsample_argmax as ua

    return {"upsample_argmax": ua.window_launches, "ce_front_fwd": cf.fwd_window_launches,
            "ce_front_bwd": cf.bwd_window_launches}


def per_step(k1: int, k2: int, k3: int, steps: int = 1) -> dict:
    return {"upsample_argmax": k1 * steps, "ce_front_fwd": k2 * steps, "ce_front_bwd": k3 * steps}


def timed_steps(torch, step, batch, n: int = PARALLEL_TIMED) -> list:
    """Host ms of `n` steps after one warm-up, each read to its loss and
    ending in a sync."""
    float(step(*batch, 0.01)["loss"])
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(*batch, 0.01)["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def seeded_state(torch, spec, dev):
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.train.step import TrainState

    sd = M.init(spec, torch.Generator().manual_seed(SEED))
    return TrainState.create(M.build(spec, sd, device=dev, train=True))


def flat_params(torch, ts):
    return torch.cat([p.detach().reshape(-1) for p in ts.params().values()])


def parallel_rank(rank: int, frames) -> dict:
    """One of the parallel phase's two gloo ranks, both on cuda:0 (run by
    parallel/launch.spawn): its 6 of 12 seeded crops at PARALLEL_GATE_HW
    through one fp32 step (TF32 off), PARALLEL_TIMED bf16 steps on its 6
    of 12 crops of 1024x1024, and the fp32 eval step of the train2k
    weights on sample frame `rank` of `frames` (images, labels, edges),
    rank 1's masked."""
    import torch

    from pidnet_tpu_torch.convert.weights import load_npz
    from pidnet_tpu_torch.data.synthetic import synthetic_epoch
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from pidnet_tpu_torch.train.step import make_eval_step, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_mesh(-1, dev)
    spec = M.spec_for("pidnet_s", 19, augment=True)
    share = slice(6 * rank, 6 * rank + 6)
    out = {"backend": mesh.backend, "size": mesh.size}

    gate = synthetic_epoch(np.random.default_rng(SEED), 12, PARALLEL_GATE_HW)
    ts = seeded_state(torch, spec, dev)
    p0 = flat_params(torch, ts)
    step = make_train_step(ts, recipe_loss(), mesh, momentum=0.9, weight_decay=5e-4)
    kernel_counts(reset=True)
    loss = float(step(*shard_batch(mesh, *(a[share] for a in gate)), 0.01)["loss"])
    update = flat_params(torch, ts) - p0
    out["gate"] = {"loss": loss, "launches": kernel_counts(),
                   "digest": hashlib.sha256(update.cpu().numpy().tobytes()).hexdigest(),
                   "update": update.cpu().numpy() if rank == 0 else None,
                   "state": {k: v.cpu().numpy() for k, v in ts.state().items()}}
    del ts, step, p0, update

    full = synthetic_epoch(np.random.default_rng(SEED + 1), 12, 1024)
    batch = shard_batch(mesh, *(a[share] for a in full))
    ts = seeded_state(torch, spec, dev)
    step = make_train_step(ts, recipe_loss(), mesh, momentum=0.9, weight_decay=5e-4,
                           compute_dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernel_counts(reset=True)
    times = timed_steps(torch, step, batch)
    out["bf16"] = {"ms": times, "launches": kernel_counts(),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del ts, step, batch

    model = M.build(spec, load_npz(WEIGHTS), device=dev).to(memory_format=torch.channels_last)
    evaluate = make_eval_step(model, recipe_loss(), mesh, num_classes=19)
    one = slice(rank, rank + 1)
    kernel_counts(reset=True)
    metrics, cms = evaluate(*(a[one] for a in frames), np.array([1.0 - rank], np.float32))
    out["eval"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                   "cms": cms.cpu().numpy(), "launches": kernel_counts()}
    return out


def phase_parallel(torch, card: str, tree: str, sliced: dict) -> dict:
    """Data parallelism on the card: (a) world 1 over NCCL at the full
    recipe against the one-device step; (b) two gloo ranks sharing cuda:0
    against accum_steps=2 in this process; (c) `_data_parallel_infer`
    over [cuda:0, cuda:0] against the slice phase's maps, and the two
    ranks' eval step against one process's; (d) tools.train --multihost
    under a world-1 torchrun environment. Returns the launch counts of
    K1-K3 on these paths."""
    import torch.distributed as dist

    from pidnet_tpu_torch import engine
    from pidnet_tpu_torch.convert.fold import fold_state_dict
    from pidnet_tpu_torch.convert.weights import load_npz
    from pidnet_tpu_torch.data.synthetic import synthetic_epoch
    from pidnet_tpu_torch.data.transforms import gen_edge_gt
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.parallel.launch import free_port, spawn
    from pidnet_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_microbatches
    from pidnet_tpu_torch.tools import train
    from pidnet_tpu_torch.train import checkpoint as ckpt
    from pidnet_tpu_torch.train.step import make_eval_step, make_train_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    spec = M.spec_for("pidnet_s", 19, augment=True)
    counts = per_step(0, 0, 0)

    def counted(want: dict, what: str) -> dict:
        got = kernel_counts()
        check(got == want, f"parallel {what}: launches {got}, want {want}")
        for k in counts:
            counts[k] += got[k]
        return got

    def cosine(a, b) -> float:
        a, b = a.double(), b.double()
        return float(a @ b / (a.norm() * b.norm()))

    sgd = dict(momentum=0.9, weight_decay=5e-4)

    # (a) world 1 over NCCL, the full recipe
    full = synthetic_epoch(np.random.default_rng(SEED + 1), 12, 1024)
    batch = tuple(torch.from_numpy(a[:6]).to(dev) for a in full)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(-1, dev)
        # the gates in fp32, TF32 off: the bf16 backward is nondeterministic
        # (the boundary head's bf16 resize backward adds with atomics)
        ts_mesh, ts_one = seeded_state(torch, spec, dev), seeded_state(torch, spec, dev)
        p0 = flat_params(torch, ts_one)
        kernel_counts(reset=True)
        l_mesh = float(make_train_step(ts_mesh, recipe_loss(), mesh, **sgd)(*batch, 0.01)["loss"])
        got = counted(per_step(1, 2, 2), "(a) fp32 step")
        l_one = float(make_train_step(ts_one, recipe_loss(), **sgd)(*batch, 0.01)["loss"])
        cos = cosine(flat_params(torch, ts_mesh) - p0, flat_params(torch, ts_one) - p0)
        print(f"parallel (a) fp32, TF32 off, 6x1024x1024: mesh of {mesh.size} over "
              f"{mesh.backend} on {mesh.device}; first loss {l_mesh:.7f} vs the one-device "
              f"step's {l_one:.7f} (rtol {abs(l_mesh - l_one) / abs(l_one):.2e}, <= 1e-5); "
              f"update cosine {cos:.8f} (> 0.9999); launches {got}")
        check(mesh.backend == "nccl" and abs(l_mesh - l_one) <= 1e-5 * abs(l_one)
              and cos > 0.9999, "parallel (a): the world-1 NCCL step differs from one device's")
        del ts_mesh, ts_one
        # bf16, the recipe: the first loss, and the update's cosine beside
        # that of two one-device steps (the backward's own noise)
        ts_mesh, ts_one, ts_two = (seeded_state(torch, spec, dev) for _ in range(3))
        step_mesh = make_train_step(ts_mesh, recipe_loss(), mesh, compute_dtype=torch.bfloat16,
                                    **sgd)
        step_one = make_train_step(ts_one, recipe_loss(), compute_dtype=torch.bfloat16, **sgd)
        kernel_counts(reset=True)
        l_mesh = float(step_mesh(*batch, 0.01)["loss"])
        got = counted(per_step(1, 2, 2), "(a) bf16 step")
        l_one = float(step_one(*batch, 0.01)["loss"])
        make_train_step(ts_two, recipe_loss(), compute_dtype=torch.bfloat16, **sgd)(*batch, 0.01)
        cos = cosine(flat_params(torch, ts_mesh) - p0, flat_params(torch, ts_one) - p0)
        rerun = cosine(flat_params(torch, ts_two) - p0, flat_params(torch, ts_one) - p0)
        print(f"parallel (a) bf16, the recipe: first loss {l_mesh:.7f} vs {l_one:.7f} (rtol "
              f"{abs(l_mesh - l_one) / abs(l_one):.2e}, <= 1e-5); update cosine {cos:.8f}, two "
              f"one-device steps' {rerun:.8f} (not gated: the bf16 backward's noise); launches "
              f"{got}")
        check(abs(l_mesh - l_one) <= 1e-5 * abs(l_one),
              "parallel (a): the bf16 world-1 NCCL step's loss differs from one device's")
        del ts_two
        t_mesh, t_one = [], []
        for _ in range(2):  # in turns: mesh, one, mesh, one
            kernel_counts(reset=True)
            t_mesh += timed_steps(torch, step_mesh, batch)
            counted(per_step(1, 2, 2, PARALLEL_TIMED + 1), "(a) timed steps")
            t_one += timed_steps(torch, step_one, batch)
        bucket = [torch.empty_like(p) for p in ts_mesh.params().values()]
        ar = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mesh.all_reduce_mean(bucket)
            torch.cuda.synchronize()
            ar.append((time.perf_counter() - t0) * 1e3)
        mb = sum(t.numel() for t in bucket) * 4 / 1e6
        print(f"parallel (a) PIDNet-S bf16 6x1024x1024: world-1 NCCL step median "
              f"{statistics.median(t_mesh):.2f} ms/step, one-device step "
              f"{statistics.median(t_one):.2f} ms/step ({2 * PARALLEL_TIMED} steps each, in "
              f"turns); the step's flat bucket ({mb:.1f} MB fp32: cat, NCCL all-reduce, scale) "
              f"median {statistics.median(ar):.3f} ms over 20 [{card}]")
        del ts_mesh, ts_one, step_mesh, step_one, bucket, p0
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # (b) this process: accum_steps=2 on the 12 crops, fp32 gate then bf16 time
    single = make_mesh(-1, dev)
    gate = synthetic_epoch(np.random.default_rng(SEED), 12, PARALLEL_GATE_HW)
    ts = seeded_state(torch, spec, dev)
    p0 = flat_params(torch, ts)
    step = make_train_step(ts, recipe_loss(), single, accum_steps=2, **sgd)
    kernel_counts(reset=True)
    l_acc = float(step(*shard_microbatches(single, 2, *gate), 0.01)["loss"])
    counted(per_step(2, 4, 4), "(b) accum_steps=2 fp32 step")
    upd_acc = flat_params(torch, ts) - p0
    state_acc = {k: v.cpu().numpy() for k, v in ts.state().items()}
    del ts, step, p0
    ts = seeded_state(torch, spec, dev)
    step = make_train_step(ts, recipe_loss(), single, accum_steps=2,
                           compute_dtype=torch.bfloat16, **sgd)
    micro = shard_microbatches(single, 2, *full)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernel_counts(reset=True)
    t_acc = timed_steps(torch, step, micro)
    counted(per_step(2, 4, 4, PARALLEL_TIMED + 1), "(b) accum_steps=2 bf16 steps")
    peak_acc = torch.cuda.max_memory_allocated() / 2**30
    del ts, step, micro, batch
    torch.cuda.empty_cache()

    goldens = np.load(GOLDENS)
    images = np.concatenate(sliced["frames"])
    labels = np.stack([goldens[k].astype(np.int32) for k in goldens.files])
    edges = np.stack([gen_edge_gt(goldens[k].astype(np.uint8)).astype(np.float32)
                      for k in goldens.files])
    frames = (images, labels, edges)
    t0 = time.perf_counter()
    ranks = spawn(parallel_rank, PARALLEL_WORLD, frames, backend="gloo", timeout=600)
    print(f"parallel (b): {PARALLEL_WORLD} gloo ranks on cuda:0 in "
          f"{time.perf_counter() - t0:.1f} s host, spawn and CUDA start included")
    r0, r1 = (r["gate"] for r in ranks)
    cos = cosine(torch.from_numpy(r0["update"]), upd_acc.cpu())
    worst = max(float(np.max(np.abs(r0["state"][k] - v) / (1e-5 + 1e-3 * np.abs(v))))
                for k, v in state_acc.items())
    print(f"parallel (b) fp32, TF32 off, 12x{PARALLEL_GATE_HW}x{PARALLEL_GATE_HW}: ranks' "
          f"losses {r0['loss']:.7f} and {r1['loss']:.7f}, ranks' updates equal "
          f"{r0['digest'] == r1['digest']}; accum_steps=2 in one process {l_acc:.7f} (rtol "
          f"{abs(r0['loss'] - l_acc) / abs(l_acc):.2e}, <= 1e-4); update cosine {cos:.8f} "
          f"(> 0.9999); BN state worst |d| / (1e-5 + 1e-3|x|) {worst:.3f} (<= 1); launches a "
          f"rank {r0['launches']}, {r1['launches']}")
    check(all(r["backend"] == "gloo" and r["size"] == PARALLEL_WORLD for r in ranks)
          and r0["loss"] == r1["loss"] and r0["digest"] == r1["digest"]
          and abs(r0["loss"] - l_acc) <= 1e-4 * abs(l_acc) and cos > 0.9999 and worst <= 1.0,
          "parallel (b): two ranks differ from accum_steps=2")
    for r in ranks:
        check(r["gate"]["launches"] == per_step(1, 2, 2), f"parallel (b): rank launches "
              f"{r['gate']['launches']}, want 1/2/2")
        check(r["bf16"]["launches"] == per_step(1, 2, 2, PARALLEL_TIMED + 1),
              f"parallel (b): rank bf16 launches {r['bf16']['launches']}")
        for part in ("gate", "bf16", "eval"):
            for k in counts:
                counts[k] += r[part]["launches"][k]
    acc_ms, one_ms = statistics.median(t_acc), statistics.median(t_one)
    print(f"parallel (b) PIDNet-S bf16, global batch 12 of 1024x1024: accum_steps=2 in one "
          f"process median {acc_ms:.2f} ms/step (one-device step of 6 {one_ms:.2f}: "
          f"{acc_ms / one_ms:.2f}x), "
          f"peak {peak_acc:.2f} GiB; two gloo processes sharing one card (not a scaling "
          f"figure), 6 crops each: median "
          + ", ".join(f"rank {i} {statistics.median(r['bf16']['ms']):.2f} ms/step peak "
                      f"{r['bf16']['peak_gib']:.2f} GiB" for i, r in enumerate(ranks))
          + f" [{card}]")

    # (c) data-parallel inference and the two ranks' eval step
    plain = M.spec_for("pidnet_s", 19, augment=False)
    dp = engine.make_inference_classmap(engine.config(), plain,
                                        fold_state_dict(load_npz(WEIGHTS), plain), folded=True,
                                        compute_dtype=torch.bfloat16, data_devices=[dev, dev])
    kernel_counts(reset=True)
    maps = dp(images).cpu().numpy()
    got = counted(per_step(2, 0, 0), "(c) _data_parallel_infer")
    same = [bool(np.array_equal(maps[i], m)) for i, m in enumerate(sliced["maps"])]
    print(f"parallel (c): _data_parallel_infer over [cuda:0, cuda:0], both frames in one call: "
          f"maps equal to the slice phase's bit for bit {same}; launches {got}")
    check(same == [True, True], "parallel (c): data-parallel maps differ from the slice phase's")
    del dp
    model = M.build(spec, load_npz(WEIGHTS), device=dev).to(memory_format=torch.channels_last)
    evaluate = make_eval_step(model, recipe_loss(), num_classes=19)
    sums, weight, cms1 = {}, 0.0, 0
    for i in range(2):  # world 1, a val batch a frame as the train CLI's, frame 1 masked
        m, c = evaluate(*(a[i:i + 1] for a in frames), np.array([1.0 - i], np.float32))
        weight += float(m["weight"])
        sums = {k: sums.get(k, 0.0) + float(v) * float(m["weight"]) for k, v in m.items()
                if k != "weight"}
        cms1 = cms1 + c.cpu().numpy()
    del model, evaluate
    e0, e1 = (r["eval"] for r in ranks)
    loss1 = sums["loss"] / max(weight, 1.0)
    print(f"parallel (c): the world-2 gloo eval step, frame 1 masked: matrices equal on both "
          f"ranks {np.array_equal(e0['cms'], e1['cms'])}, equal to world 1's "
          f"{np.array_equal(e0['cms'], cms1)} ({e0['cms'].dtype}, {int(e0['cms'][-1].sum())} "
          f"pixels); global weight {e0['metrics']['weight']}, {e1['metrics']['weight']}; loss "
          f"{e0['metrics']['loss']:.6f} vs world 1's {loss1:.6f}; launches a rank "
          f"{e0['launches']}")
    check(np.array_equal(e0["cms"], e1["cms"]) and np.array_equal(e0["cms"], cms1)
          and e0["metrics"] == e1["metrics"] and e0["metrics"]["weight"] == weight == 1.0
          and abs(e0["metrics"]["loss"] - loss1) <= 1e-6 * abs(loss1)
          and e0["launches"] == per_step(1, 2, 0), "parallel (c): the world-2 eval step differs")

    # (d) tools.train --multihost under a world-1 torchrun environment
    work = os.path.join(tree, "dp_cli")
    yaml = os.path.join(ROOT, "configs", "cityscapes", "pidnet_small_cityscapes.yaml")
    run_dir = os.path.join(work, "output", "cityscapes", "pidnet_small_cityscapes")
    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    seen, steps = {}, []
    make = train.make_train_step

    def recording_make(ts, loss_fn, mesh, **kw):
        seen.update(backend=mesh.backend, size=mesh.size, accum=kw["accum_steps"])
        step = make(ts, loss_fn, mesh, **kw)

        def counting(*args):
            steps.append(1)
            return step(*args)

        return counting

    os.environ.update(env)
    train.make_train_step = recording_make
    kernel_counts(reset=True)
    t0 = time.perf_counter()
    try:
        train.main(["--multihost", "--cfg", yaml, "DATASET.ROOT", tree, "DATASET.TRAIN_SET",
                    "list/cityscapes/train.lst", "DATASET.TEST_SET", "list/cityscapes/val.lst",
                    "OUTPUT_DIR", os.path.join(work, "output"), "LOG_DIR",
                    os.path.join(work, "log"), "MODEL.PRETRAINED", WEIGHTS, "WORKERS", "1",
                    "TRAIN.END_EPOCH", "1", "TRAIN.BATCH_SIZE_PER_GPU", "3",
                    "TRAIN.ACCUM_STEPS", "2"])
        torch.cuda.synchronize()
    finally:
        train.make_train_step = make
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
        logger = logging.getLogger("pidnet_tpu_torch")
        for handler in list(logger.handlers):
            logger.removeHandler(handler)
            handler.close()
        logger.setLevel(logging.WARNING)
    secs = time.perf_counter() - t0
    got = counted({"upsample_argmax": 2 + 3, "ce_front_fwd": 4 + 2 * 3, "ce_front_bwd": 4},
                  "(d) tools.train --multihost (2/4/4 a step, 1/2/0 a val frame)")
    payload = ckpt.load(os.path.join(run_dir, "checkpoint.pt"))
    loaded = [ckpt.load_model(os.path.join(run_dir, n)) for n in ("best.pt", "final_state.pt")]
    losses = logged_losses(run_dir)
    print(f"parallel (d): tools.train --multihost, world-1 torchrun environment: process group "
          f"{seen.get('backend')} of {seen.get('size')}, accum_steps {seen.get('accum')}, "
          f"{len(steps)} step of 2x3 crops of 1024x1024 and a validate of 3 frames in "
          f"{secs:.1f} s host; checkpoint epoch {payload['epoch']} iter {payload['iter']}, "
          f"best.pt and final_state.pt load ({len(loaded[1][0])} params); logged losses "
          f"{losses}; launches {got} [{card}]")
    check(seen == {"backend": "nccl", "size": 1, "accum": 2} and len(steps) == 1
          and payload["epoch"] == 1 and all(len(p) for p, _ in loaded)
          and losses and all(np.isfinite(losses)) and not dist.is_initialized(),
          "parallel (d): the --multihost CLI run")
    print(f"parallel: the phase took {time.perf_counter() - t_phase:.1f} s [{card}; host time]")
    torch.cuda.empty_cache()
    return counts


# the spatial phase: the windows of the kernel check, the ranks, the crop
SPATIAL_WORLD = 2
SPATIAL_TRAIN = (6, 1024)  # a batch of 6 crops of 1024x1024, the reference's crop
SPATIAL_CALLS = 10  # timed serving calls a rank
SPATIAL_TIMED = 3  # timed train steps a rank
# (logits, output): K1's main shapes (serving's, and training's accuracy)
# and K2/K3's, BiSeNet's at scale 1 (K1 serving, K2/K3 training), and K1 at
# scale 1 with 1100 classes, whose plan is None (the direct kernel over a
# window; 19 classes keep a plan at scale 1), each cut into the windows of
# the spatial phase's SPATIAL_WORLD ranks (the windows its paths launch) and
# of 4 (both border shards and two interior ones)
WINDOW_CASES = [(KERNEL_CASES[0], "upsample_argmax"), (CE_MAIN, "upsample_argmax"),
                (CE_MAIN, "ce_front"), (KERNEL_CASES[-1], "upsample_argmax"),
                (CE_SCALE1, "ce_front"), (((1, 64, 128, 1100), (64, 128)), "upsample_argmax")]
WINDOW_RANKS = (SPATIAL_WORLD, 4)


class _Row:
    """Rank s of S spatial ranks, as parallel/spatial.halo_for_resize reads it."""

    def __init__(self, ranks: int, s: int):
        self.n_spatial, self.spatial_index = ranks, s


def window_slice(torch, x, out_rows: int, align: bool, ranks: int, s: int):
    """Rank s's halo'd rows of NHWC `x` for its window of `out_rows` output
    rows (parallel/spatial.halo_rows's margin: zero rows beyond the image),
    the window (ops/resize.Rows), and its output rows."""
    from pidnet_tpu_torch.parallel import spatial as SP

    h = x.shape[1]
    top, bottom, rows = SP.halo_for_resize(h // ranks, out_rows // ranks, align, _Row(ranks, s),
                                           margin=1)
    padded = torch.nn.functional.pad(x, (0, 0, 0, 0, h, h))
    local = padded[:, h + rows.src_start:h + rows.src_start + h // ranks + top + bottom]
    return local.contiguous(), rows, slice(rows.out_start, rows.out_start + out_rows // ranks)


def phase_windows(torch) -> None:
    """(e) K1, K2 and K3 over windows of output rows against their windowed
    plain versions, at the main shapes, every window of each count of ranks
    in WINDOW_RANKS (both border shards and the interior ones, the windows
    of the spatial phase's paths among them), both align_corners, bf16 and
    fp32, with K1's and K2's gates of the kernel phases and K3's against
    autograd of the windowed plain forward; two launches bit-identical; the
    whole image's window gives the unwindowed launch bit for bit."""
    from pidnet_tpu_torch.ops import ce_front as cf
    from pidnet_tpu_torch.ops import upsample_argmax as ua
    from pidnet_tpu_torch.ops.resize import Rows

    rng = np.random.default_rng(13)
    worst = {"k1_agree": 1.0, "k2_err": 0.0, "k3_cos": 1.0, "k3_err_of_tol": 0.0}
    direct = 0  # windows that K1's direct kernel took (its plan None)
    for (shape, out_hw), kind in WINDOW_CASES:
        base, labels, cw, g = ce_inputs(torch, rng, shape, out_hw)
        for dtype in (torch.bfloat16, torch.float32):
            xw = base.to(dtype)
            for align in (True, False):
                whole = Rows.whole(shape[1], out_hw[0])
                if kind == "upsample_argmax":
                    same = torch.equal(ua.upsample_argmax_rows(xw, out_hw, align, whole),
                                       ua.upsample_argmax(xw, out_hw, align))
                else:
                    same = all(torch.equal(a, b) for a, b in zip(
                        cf.ce_front_fwd(xw, labels, cw, 255, out_hw, align, whole),
                        cf.ce_front_fwd(xw, labels, cw, 255, out_hw, align)))
                check(same, f"windowed {kind}: the whole image's window differs from the "
                            "unwindowed launch")
                for ranks, s in ((r, s) for r in WINDOW_RANKS for s in range(r)):
                    x, rows, oy = window_slice(torch, xw, out_hw[0], align, ranks, s)
                    hw = (out_hw[0] // ranks, out_hw[1])
                    where = (f"{kind} {tuple(shape)}->{out_hw} {str(dtype)[6:]} "
                             f"align_corners={align} window {s} of {ranks} {tuple(rows)}")
                    if kind == "upsample_argmax":
                        direct += ua.plan(*x.shape, *hw, align, rows) is None
                        got = ua.upsample_argmax_rows(x, hw, align, rows)
                        again = ua.upsample_argmax_rows(x, hw, align, rows)
                        want = ua.upsample_argmax_plain(x, hw, align, rows)
                        top2 = cf._z(x, hw, align, rows).topk(2, dim=-1).values
                        same = got == want
                        agree = same.float().mean().item()
                        confident = int((~same & (top2[..., 0] - top2[..., 1] > 1e-3)).sum())
                        worst["k1_agree"] = min(worst["k1_agree"], agree)
                        check(agree >= 0.9999 and confident == 0 and torch.equal(got, again),
                              f"windowed {where}: agreement {agree}, confident mismatches "
                              f"{confident}")
                        continue
                    lab, gw = labels[:, oy].contiguous(), g[:, oy].contiguous()
                    nll, w = cf.ce_front_fwd(x, lab, cw, 255, hw, align, rows)
                    nll2, _ = cf.ce_front_fwd(x, lab, cw, 255, hw, align, rows)
                    dl = cf.ce_front_bwd(x, lab, 255, hw, align, gw, rows)
                    dl2 = cf.ce_front_bwd(x, lab, 255, hw, align, gw, rows)
                    xr = x.detach().clone().requires_grad_()
                    nll_p, w_p = cf.ce_front_fwd_plain(xr, lab, cw, 255, hw, align, rows)
                    (dl_p,) = torch.autograd.grad(nll_p, xr, gw)
                    e_f = (nll - nll_p).abs().max().item()
                    a, b = dl.float().flatten(), dl_p.float().flatten()
                    cos = (a @ b / (a.norm() * b.norm())).item()
                    tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * b.abs().max().item()
                    e_b = (a - b).abs().max().item()
                    worst["k2_err"] = max(worst["k2_err"], e_f)
                    worst["k3_cos"] = min(worst["k3_cos"], cos)
                    worst["k3_err_of_tol"] = max(worst["k3_err_of_tol"], e_b / tol)
                    bits = torch.equal(nll, nll2) and torch.equal(dl.float(), dl2.float())
                    check(torch.equal(w, w_p) and e_f <= 1e-4 and cos > 0.99999 and e_b <= tol
                          and bits, f"windowed {where}: w exact {torch.equal(w, w_p)}, nll err "
                          f"{e_f:.3e}, dL cos {cos:.8f}, err {e_b:.3e} (<= {tol:.3e}), two "
                          f"launches bit-identical {bits}")
    check(direct > 0, "spatial (e): no window went to K1's direct kernel")
    print(f"spatial (e): windowed K1, K2, K3 at the main shapes and BiSeNet's scale 1 "
          f"({direct} K1 windows through the direct kernel), the windows of "
          f"{' and of '.join(map(str, WINDOW_RANKS))} ranks each (both border shards and the "
          f"interior), both align_corners, bf16 and fp32, against "
          f"their windowed plain versions: K1 agreement >= {worst['k1_agree']:.6f} (>= 0.9999, "
          f"no mismatch where the top-2 margin > 1e-3), K2 nll max err {worst['k2_err']:.3e} "
          f"(<= 1e-4, w exact), K3 cos >= {worst['k3_cos']:.8f} (> 0.99999), max err "
          f"{worst['k3_err_of_tol']:.3f} of its bound; two launches bit-identical; the whole "
          f"image's window equals the unwindowed launch bit for bit")


def collective_share(torch, fn) -> tuple[float, float]:
    """(host ms of one call of `fn`, the ms of it spent in collectives):
    every collective of the spatial path (parallel/spatial's all-gather and
    torch.distributed.all_reduce) is timed from a sync before it to a sync
    after it, for this call only."""
    import torch.distributed as dist

    from pidnet_tpu_torch.parallel import spatial as SP

    spent = [0.0]
    gather, reduce = SP._all_gather, dist.all_reduce

    def timed(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            return out

        return run

    SP._all_gather, dist.all_reduce = timed(gather), timed(reduce)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, spent[0] * 1e3
    finally:
        SP._all_gather, dist.all_reduce = gather, reduce


def host_window(torch, fn, n: int) -> list:
    """Host ms of `n` calls of `fn`, each ending in a sync, after one warm-up."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def spatial_run(torch, mesh, spec, serve_sd: dict, train_sd: dict, frames, batch,
                read) -> dict:
    """One family (`spec`, augment) on this rank of the (1, 2) mesh: (a)
    the folded class-map closure of `serve_sd` on both frames, bf16 and
    fp32, K1 launches a call, SPATIAL_CALLS bf16 calls' ms and peak and one
    call with its collectives timed; (b) one fp32 train step and one bf16
    step from `train_sd`, the next SPATIAL_TIMED bf16 steps' ms and peak
    and one with its collectives timed; (c) the fp32 eval step of
    `serve_sd` on the
    frames. `read()` returns the launches since the last reset and adds
    them to the rank's sums."""
    import dataclasses

    from pidnet_tpu_torch import engine
    from pidnet_tpu_torch.convert.fold import fold_state_dict
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.parallel import spatial as SP
    from pidnet_tpu_torch.train.step import (TrainState, make_spatial_eval_step,
                                             make_spatial_train_step)

    dev = mesh.device
    images, labels, edges = frames
    balance = M.balance_weights(spec)
    out = {}

    # (a) serving
    spec1 = dataclasses.replace(spec, augment=False)
    folded = fold_state_dict(serve_sd, spec1)
    serve = {dtype: engine.make_inference_classmap(engine.config(), spec1, folded, folded=True,
                                                   compute_dtype=dtype, spatial_mesh=mesh)
             for dtype in (torch.bfloat16, None)}
    maps, per_call = {}, []
    for dtype, fn in serve.items():
        maps[str(dtype)] = []
        for i in range(images.shape[0]):
            kernel_counts(reset=True)
            maps[str(dtype)].append(fn(images[i:i + 1]).cpu().numpy()[0])
            per_call.append(read()["upsample_argmax"])
    x = torch.from_numpy(images[:1]).to(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernel_counts(reset=True)
    times = host_window(torch, lambda: serve[torch.bfloat16](x), SPATIAL_CALLS)
    served = read()["upsample_argmax"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    kernel_counts(reset=True)
    call, spent = collective_share(torch, lambda: serve[torch.bfloat16](x))
    out["serve"] = {"maps": maps, "per_call": per_call, "timed_launches": served, "ms": times,
                    "peak_gib": peak, "timed_ms": call, "collective_ms": spent,
                    "collective_launches": read()["upsample_argmax"]}
    del serve

    # (b) training: an fp32 step (the gates), then bf16
    share = SP.shard_rows(mesh, *batch)
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        ts = TrainState.create(M.build(spec, train_sd, device=dev, train=True))
        p0 = flat_params(torch, ts)
        step = make_spatial_train_step(ts, recipe_loss(balance), mesh, compute_dtype=dtype,
                                       momentum=0.9, weight_decay=5e-4)
        kernel_counts(reset=True)
        loss = float(step(*share, 0.01)["loss"])
        update = flat_params(torch, ts) - p0
        got = {"loss": loss, "launches": read(),
               "digest": hashlib.sha256(update.cpu().numpy().tobytes()).hexdigest(),
               "update": update.cpu().numpy() if mesh.spatial_index == 0 else None,
               "state": {k: v.cpu().numpy() for k, v in ts.state().items()}}
        if name == "bf16":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernel_counts(reset=True)
            times = host_window(torch, lambda: float(step(*share, 0.01)["loss"]), SPATIAL_TIMED)
            got.update(timed_launches=read(), ms=times,
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            kernel_counts(reset=True)
            call, spent = collective_share(torch, lambda: float(step(*share, 0.01)["loss"]))
            got.update(timed_ms=call, collective_ms=spent, collective_launches=read())
        out[name] = got
        del ts, step, p0, update

    # (c) the eval step, fp32
    model = M.build(spec, serve_sd, device=dev).to(memory_format=torch.channels_last)
    evaluate = make_spatial_eval_step(model, recipe_loss(balance), mesh, num_classes=19)
    kernel_counts(reset=True)
    metrics, cms = evaluate(*SP.shard_rows(mesh, images, labels, edges,
                                           np.ones(images.shape[0], np.float32)))
    out["eval"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                   "cms": cms.cpu().numpy(), "launches": read()}
    del model, evaluate
    torch.cuda.empty_cache()
    return out


def spatial_rank(rank: int, frames, batch, families: dict) -> dict:
    """One of the spatial phase's two gloo ranks, both on cuda:0, a (1, 2)
    mesh (run by parallel/launch.spawn): `spatial_run` of PIDNet-S (served
    and evaluated with the train2k weights, trained from seeded weights),
    then of DDRNet-23 and BiSeNetV1 from `families`' weights. Launches
    are counted from 0 before each run and read after it; the rank's sums
    of them, and of its windowed launches, come back under "launches" and
    "windowed"."""
    import torch

    from pidnet_tpu_torch.convert.weights import load_npz
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.parallel import spatial as SP

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = SP.make_mesh_2d(1, SPATIAL_WORLD, dev)
    out = {"mesh": (mesh.size, mesh.spatial_index, mesh.backend)}
    tally = {"launches": per_step(0, 0, 0), "windowed": per_step(0, 0, 0)}

    def read() -> dict:
        """The launches since the last reset, added to the rank's sums."""
        got, windowed = kernel_counts(), window_counts()
        for k in got:
            tally["launches"][k] += got[k]
            tally["windowed"][k] += windowed[k]
        return got

    spec = M.spec_for("pidnet_s", 19, augment=True)
    seeded = M.init(spec, torch.Generator().manual_seed(SEED))
    out["pidnet"] = spatial_run(torch, mesh, spec, load_npz(WEIGHTS), seeded, frames, batch, read)
    out["families"] = {name: spatial_run(torch, mesh, fspec, sd, sd, frames, batch, read)
                       for name, (fspec, sd) in families.items()}
    out.update(tally)
    return out


# sharded vs one device: fp32 on every pixel; bf16 where one device's fp32
# top-2 margin exceeds FAMILY_MARGIN (the seeded weights leave half the
# pixels below it, where bf16's rounding alone flips the class: one
# device's bf16 against its fp32 agrees on 0.95-0.98 of all pixels)
FAMILY_MAP_GATES = {"torch.bfloat16": 0.9998, "None": 0.99995}
FAMILY_MARGIN = 1.0


def family_reference(torch, spec, sd: dict, frames, batch, dev) -> dict:
    """One device's side of `spatial_run` on `dev`: the folded class maps
    of the frames in bf16 and fp32, one fp32 train step on `batch` (loss,
    update, BN state) and the fp32 eval step's matrices on the frames."""
    import dataclasses

    from pidnet_tpu_torch import engine
    from pidnet_tpu_torch.convert.fold import fold_state_dict
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.train.step import TrainState, make_eval_step, make_train_step

    images = frames[0]
    balance = M.balance_weights(spec)
    spec1 = dataclasses.replace(spec, augment=False)
    folded = fold_state_dict(sd, spec1)
    maps = {}
    for dtype in (torch.bfloat16, None):
        serve = engine.make_inference_classmap(engine.config(), spec1, folded, folded=True,
                                               compute_dtype=dtype, device=dev)
        maps[str(dtype)] = [serve(images[i:i + 1]).cpu().numpy()[0]
                            for i in range(images.shape[0])]
    probs = engine.make_inference(engine.config(), spec1, folded, folded=True, device=dev)
    margins = []
    for i in range(images.shape[0]):
        top2 = torch.log(probs(images[i:i + 1])[0]).topk(2, dim=-1).values
        margins.append((top2[..., 0] - top2[..., 1]).cpu().numpy())
    del probs
    ts = TrainState.create(M.build(spec, sd, device=dev, train=True))
    p0 = flat_params(torch, ts)
    loss = float(make_train_step(ts, recipe_loss(balance), momentum=0.9, weight_decay=5e-4)(
        *(torch.from_numpy(a).to(dev) for a in batch), 0.01)["loss"])
    step = {"loss": loss, "update": (flat_params(torch, ts) - p0).cpu(),
            "state": {k: v.cpu().numpy() for k, v in ts.state().items()}}
    del ts, p0
    model = M.build(spec, sd, device=dev).to(memory_format=torch.channels_last)
    metrics, cms = make_eval_step(model, recipe_loss(balance), num_classes=19)(
        *frames, np.ones(images.shape[0], np.float32))
    del model
    torch.cuda.empty_cache()
    return {"maps": maps, "margins": margins, "fp32": step, "cms": cms.cpu().numpy(),
            "eval_loss": float(metrics["loss"])}


def check_family(name: str, heads: int, ranks: list, one: dict, card: str) -> None:
    """The gates of `spatial_run`'s runs on the ranks against one
    device's (`family_reference`): (a) class maps >= FAMILY_MAP_GATES of
    the pixels equal (bf16: of those whose fp32 top-2 margin exceeds
    FAMILY_MARGIN), the same on both ranks, one K1 launch a call; (b)
    the fp32 step's loss within rtol 1e-5, update cosine > 0.9999, BN state
    < 0.5 of 1e-5 + 1e-3|x|, the same on both ranks, 1/heads/heads
    launches a step; (c) each eval matrix's total equal, 1/heads/0
    launches. Prints each rank's ms a call and a bf16 step, peak and the
    collectives' share."""
    for s, r in enumerate(ranks):
        sv = r["serve"]
        agree = {k: [float((m == w).mean()) for m, w in zip(sv["maps"][k], one["maps"][k])]
                 for k in FAMILY_MAP_GATES}
        every = agree["torch.bfloat16"]
        agree["torch.bfloat16"] = [
            float((m == w)[c > FAMILY_MARGIN].mean())
            for m, w, c in zip(sv["maps"]["torch.bfloat16"], one["maps"]["torch.bfloat16"],
                               one["margins"])]
        share = [float((c > FAMILY_MARGIN).mean()) for c in one["margins"]]
        print(f"spatial families (a) {name} rank {s}: folded class maps of both frames at "
              f"1x1024x2048 over (1, {SPATIAL_WORLD}) vs one device: bf16 "
              f"{agree['torch.bfloat16']} (>= 0.9998) where the fp32 top-2 margin > "
              f"{FAMILY_MARGIN} ({share} of the pixels), {every} of all pixels; fp32 (TF32 off) "
              f"{agree['None']} (>= 0.99995); K1 launches a call {sv['per_call']}; "
              f"{len(sv['ms'])} bf16 calls "
              f"median {statistics.median(sv['ms']):.2f} ms, peak {sv['peak_gib']:.2f} GiB; a "
              f"call with its collectives timed {sv['timed_ms']:.2f} ms, of it collectives "
              f"{sv['collective_ms']:.2f} ms ({sv['collective_ms'] / sv['timed_ms']:.1%}) [{card}]")
        check(all(min(agree[k]) >= gate for k, gate in FAMILY_MAP_GATES.items()),
              f"spatial families (a) {name} rank {s}: sharded class maps disagree with one "
              "device's")
        check(sv["per_call"] == [1] * len(sv["per_call"])
              and sv["timed_launches"] == SPATIAL_CALLS + 1 and sv["collective_launches"] == 1,
              f"spatial families (a) {name} rank {s}: K1 launches {sv['per_call']}, "
              f"{sv['timed_launches']}, {sv['collective_launches']}")
    check(all(np.array_equal(a, b) for k in FAMILY_MAP_GATES
              for a, b in zip(ranks[0]["serve"]["maps"][k], ranks[1]["serve"]["maps"][k])),
          f"spatial families (a) {name}: the two ranks return different maps")

    r0, r1 = (r["fp32"] for r in ranks)
    ref = one["fp32"]
    a, b = np.asarray(r0["update"], np.float64), ref["update"].double().numpy()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    worst = max(float(np.max(np.abs(r0["state"][k] - v) / (1e-5 + 1e-3 * np.abs(v))))
                for k, v in ref["state"].items())
    rtol = abs(r0["loss"] - ref["loss"]) / abs(ref["loss"])
    print(f"spatial families (b) {name} fp32, TF32 off, {SPATIAL_TRAIN[0]}x{SPATIAL_TRAIN[1]}x"
          f"{SPATIAL_TRAIN[1]}: ranks' losses {r0['loss']:.7f}, {r1['loss']:.7f}, updates equal "
          f"{r0['digest'] == r1['digest']}; one device {ref['loss']:.7f} (rtol {rtol:.2e}, <= "
          f"1e-5); update cosine {cos:.8f} (> 0.9999); BN state worst |d| / (1e-5 + 1e-3|x|) "
          f"{worst:.3f} (< 0.5); launches a rank {r0['launches']}, {r1['launches']}")
    check(r0["loss"] == r1["loss"] and r0["digest"] == r1["digest"] and rtol <= 1e-5
          and cos > 0.9999 and worst < 0.5, f"spatial families (b) {name}: the sharded fp32 step "
          "differs from one device's")
    for s, r in enumerate(ranks):
        st = r["bf16"]
        check(r["fp32"]["launches"] == st["launches"] == per_step(1, heads, heads)
              and st["timed_launches"] == per_step(1, heads, heads, SPATIAL_TIMED + 1)
              and st["collective_launches"] == per_step(1, heads, heads),
              f"spatial families (b) {name} rank {s}: launches {r['fp32']['launches']}, "
              f"{st['launches']}, {st['timed_launches']}, {st['collective_launches']}, want "
              f"1/{heads}/{heads} a step")
        print(f"spatial families (b) {name} rank {s} bf16 {SPATIAL_TRAIN[0]}x{SPATIAL_TRAIN[1]}x"
              f"{SPATIAL_TRAIN[1]} over (1, {SPATIAL_WORLD}), two processes sharing one card: loss "
              f"{st['loss']:.7f}, median {statistics.median(st['ms']):.2f} ms/step "
              f"({SPATIAL_TIMED} steps), peak {st['peak_gib']:.2f} GiB; a step with its "
              f"collectives timed {st['timed_ms']:.2f} ms, of it collectives "
              f"{st['collective_ms']:.2f} ms ({st['collective_ms'] / st['timed_ms']:.1%}) [{card}]")

    e0, e1 = (r["eval"] for r in ranks)
    moved = [float(np.abs(a - b).sum() / b.sum()) for a, b in zip(e0["cms"], one["cms"])]
    print(f"spatial families (c) {name} fp32 eval step over (1, {SPATIAL_WORLD}), both frames: "
          f"{len(e0['cms'])} matrices, equal on both ranks {np.array_equal(e0['cms'], e1['cms'])}, "
          f"totals {[int(c.sum()) for c in e0['cms']]} vs one device's "
          f"{[int(c.sum()) for c in one['cms']]}, cells moved {[f'{m:.2e}' for m in moved]} of "
          f"the totals; loss {e0['metrics']['loss']:.6f} vs {one['eval_loss']:.6f}; launches a "
          f"rank {e0['launches']}")
    check(np.array_equal(e0["cms"], e1["cms"]) and len(e0["cms"]) == len(one["cms"]) == heads
          and all(int(a.sum()) == int(b.sum()) for a, b in zip(e0["cms"], one["cms"]))
          and e0["launches"] == per_step(1, heads, 0),
          f"spatial families (c) {name}: the sharded eval step differs")


def phase_spatial(torch, card: str, sliced: dict) -> dict:
    """H-sharding (parallel/spatial.py) on the card: (e) the windowed
    kernels; (a)-(c) two gloo ranks sharing cuda:0 as a (1, 2) mesh
    against one device; (d) the (1, 1) mesh over a world-1 NCCL group
    against one device. Returns the launch counts of K1-K3 on these paths."""
    import torch.distributed as dist

    from pidnet_tpu_torch import engine
    from pidnet_tpu_torch.convert.fold import fold_state_dict
    from pidnet_tpu_torch.convert.weights import load_npz
    from pidnet_tpu_torch.data.synthetic import synthetic_epoch
    from pidnet_tpu_torch.data.transforms import gen_edge_gt
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.parallel import spatial as SP
    from pidnet_tpu_torch.parallel.launch import free_port, spawn
    from pidnet_tpu_torch.train.step import (make_eval_step, make_spatial_eval_step,
                                             make_spatial_train_step, make_train_step)

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    counts = per_step(0, 0, 0)

    def add(got: dict) -> None:
        for k in counts:
            counts[k] += got[k]

    def cosine(a, b) -> float:
        a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
        return float(a @ b / (a.norm() * b.norm()))

    phase_windows(torch)

    # the one-device references
    sd = load_npz(WEIGHTS)
    plain = M.spec_for("pidnet_s", 19, augment=False)
    spec = M.spec_for("pidnet_s", 19, augment=True)
    folded = fold_state_dict(sd, plain)
    cfg = engine.config()
    goldens = np.load(GOLDENS)
    images = np.concatenate(sliced["frames"])
    labels = np.stack([goldens[k].astype(np.int32) for k in goldens.files])
    edges = np.stack([gen_edge_gt(goldens[k].astype(np.uint8)).astype(np.float32)
                      for k in goldens.files])
    frames = (images, labels, edges)
    one32 = engine.make_inference_classmap(cfg, plain, folded, folded=True)
    maps32 = [one32(images[i:i + 1]).cpu().numpy()[0] for i in range(images.shape[0])]
    batch = synthetic_epoch(np.random.default_rng(SEED + 2), *SPATIAL_TRAIN)
    sgd = dict(momentum=0.9, weight_decay=5e-4)
    one = {}
    for name, dtype, runs in (("fp32", None, 1), ("bf16", torch.bfloat16, 2)):
        for r in range(runs):
            ts = seeded_state(torch, spec, dev)
            p0 = flat_params(torch, ts)
            loss = float(make_train_step(ts, recipe_loss(), compute_dtype=dtype, **sgd)(
                *(torch.from_numpy(a).to(dev) for a in batch), 0.01)["loss"])
            one[name if r == 0 else "bf16 again"] = {
                "loss": loss, "update": (flat_params(torch, ts) - p0).cpu(),
                "state": {k: v.cpu().numpy() for k, v in ts.state().items()}}
            del ts, p0
    model = M.build(spec, sd, device=dev).to(memory_format=torch.channels_last)
    m_one, cms_one = make_eval_step(model, recipe_loss(), num_classes=19)(
        *frames, np.ones(images.shape[0], np.float32))
    m_one = {k: float(v) for k, v in m_one.items()}
    cms_one = cms_one.cpu().numpy()
    del model
    torch.cuda.empty_cache()
    families = {name: family_weights(torch, name, images[:1], dev) for name in FAMILIES}
    fam_one = {name: family_reference(torch, fspec, fsd, frames, batch, dev)
               for name, (fspec, fsd) in families.items()}

    # (a)-(c) two gloo ranks sharing cuda:0
    t0 = time.perf_counter()
    ranks = spawn(spatial_rank, SPATIAL_WORLD, frames, batch, families, backend="gloo",
                  timeout=900)
    print(f"spatial: {SPATIAL_WORLD} gloo ranks on cuda:0 as a (1, {SPATIAL_WORLD}) mesh in "
          f"{time.perf_counter() - t0:.1f} s host, spawn and CUDA start included")
    check([r["mesh"] for r in ranks] == [(SPATIAL_WORLD, s, "gloo") for s in range(SPATIAL_WORLD)],
          f"spatial: the ranks' meshes {[r['mesh'] for r in ranks]}")
    pid = [r["pidnet"] for r in ranks]
    for s, r in enumerate(pid):
        sv = r["serve"]
        agree = [float((m == w).mean()) for m, w in zip(sv["maps"]["torch.bfloat16"],
                                                         sliced["maps"])]
        agree32 = [float((m == w).mean()) for m, w in zip(sv["maps"]["None"], maps32)]
        print(f"spatial (a) rank {s}: folded class maps of both frames at 1x1024x2048 over "
              f"(1, {SPATIAL_WORLD}): bf16 vs the slice phase's one-device maps {agree} "
              f"(>= 0.9995), fp32 (TF32 off) vs one device's fp32 {agree32} (>= 0.9999); K1 "
              f"launches a call {sv['per_call']}; {len(sv['ms'])} bf16 calls median "
              f"{statistics.median(sv['ms']):.2f} ms ({sv['timed_launches']} K1 launches), peak "
              f"{sv['peak_gib']:.2f} GiB; a call with its collectives timed {sv['timed_ms']:.2f} "
              f"ms, of it collectives {sv['collective_ms']:.2f} ms "
              f"({sv['collective_ms'] / sv['timed_ms']:.1%}) [{card}]")
        check(min(agree) >= 0.9995 and min(agree32) >= 0.9999,
              f"spatial (a) rank {s}: sharded class maps disagree with one device's")
        check(sv["per_call"] == [1] * len(sv["per_call"])
              and sv["timed_launches"] == SPATIAL_CALLS + 1
              and sv["collective_launches"] == 1, f"spatial (a) rank {s}: K1 launches "
              f"{sv['per_call']}, {sv['timed_launches']}, {sv['collective_launches']}")
    check(all(np.array_equal(a, b) for a, b in zip(pid[0]["serve"]["maps"]["torch.bfloat16"],
                                                    pid[1]["serve"]["maps"]["torch.bfloat16"])),
          "spatial (a): the two ranks return different maps")

    r0, r1 = (r["fp32"] for r in pid)
    ref = one["fp32"]
    cos = cosine(r0["update"], ref["update"])
    worst = max(float(np.max(np.abs(r0["state"][k] - v) / (1e-5 + 1e-3 * np.abs(v))))
                for k, v in ref["state"].items())
    rtol = abs(r0["loss"] - ref["loss"]) / abs(ref["loss"])
    print(f"spatial (b) fp32, TF32 off, {SPATIAL_TRAIN[0]}x{SPATIAL_TRAIN[1]}x{SPATIAL_TRAIN[1]}: "
          f"ranks' losses {r0['loss']:.7f}, {r1['loss']:.7f}, updates equal "
          f"{r0['digest'] == r1['digest']}; one device {ref['loss']:.7f} (rtol {rtol:.2e}, <= "
          f"1e-4); update cosine {cos:.8f} (>= 0.9999); BN state worst |d| / (1e-5 + 1e-3|x|) "
          f"{worst:.3f} (<= 1); launches a rank {r0['launches']}, {r1['launches']}")
    check(r0["loss"] == r1["loss"] and r0["digest"] == r1["digest"] and rtol <= 1e-4
          and cos >= 0.9999 and worst <= 1.0, "spatial (b): the sharded fp32 step differs")
    b0, b1 = pid[0]["bf16"], one["bf16"]
    cos16 = cosine(b0["update"], b1["update"])
    floor = cosine(one["bf16 again"]["update"], b1["update"])
    print(f"spatial (b) bf16, the recipe: loss {b0['loss']:.7f} vs one device's "
          f"{b1['loss']:.7f} (rtol {abs(b0['loss'] - b1['loss']) / abs(b1['loss']):.2e}); update "
          f"cosine {cos16:.8f} beside two one-device steps' {floor:.8f} (the bf16 backward's "
          f"noise floor; not gated)")
    for s, r in enumerate(pid):
        for name in ("fp32", "bf16"):
            st = r[name]
            check(st["launches"] == per_step(1, 2, 2), f"spatial (b) rank {s} {name}: launches "
                  f"{st['launches']}, want 1/2/2")
        st = r["bf16"]
        check(st["timed_launches"] == per_step(1, 2, 2, SPATIAL_TIMED + 1)
              and st["collective_launches"] == per_step(1, 2, 2),
              f"spatial (b) rank {s}: timed launches {st['timed_launches']}, "
              f"{st['collective_launches']}")
        print(f"spatial (b) rank {s} PIDNet-S bf16 {SPATIAL_TRAIN[0]}x{SPATIAL_TRAIN[1]}x"
              f"{SPATIAL_TRAIN[1]} over (1, {SPATIAL_WORLD}), two processes sharing one card: "
              f"median {statistics.median(st['ms']):.2f} ms/step ({SPATIAL_TIMED} steps), peak "
              f"{st['peak_gib']:.2f} GiB; a step with its collectives timed {st['timed_ms']:.2f} "
              f"ms, of it collectives {st['collective_ms']:.2f} ms "
              f"({st['collective_ms'] / st['timed_ms']:.1%}) [{card}]")

    e0, e1 = (r["eval"] for r in pid)
    moved = float(np.abs(e0["cms"][-1] - cms_one[-1]).sum() / cms_one[-1].sum())
    print(f"spatial (c) fp32 eval step over (1, {SPATIAL_WORLD}), both frames: matrices equal on "
          f"both ranks {np.array_equal(e0['cms'], e1['cms'])}, totals {int(e0['cms'][-1].sum())} "
          f"vs one device's {int(cms_one[-1].sum())}, cells moved {moved:.2e} of the total (< "
          f"5e-3); loss {e0['metrics']['loss']:.6f} vs {m_one['loss']:.6f}, weight "
          f"{e0['metrics']['weight']}; launches a rank {e0['launches']}")
    check(np.array_equal(e0["cms"], e1["cms"])
          and all(int(a.sum()) == int(b.sum()) for a, b in zip(e0["cms"], cms_one))
          and all(float(np.abs(a - b).sum() / b.sum()) < 5e-3 for a, b in zip(e0["cms"], cms_one))
          and e0["metrics"]["weight"] == m_one["weight"] == images.shape[0]
          and e0["launches"] == per_step(1, 2, 0), "spatial (c): the sharded eval step differs")
    for name, (fspec, _) in families.items():
        check_family(name, M.module_for(fspec).seg_heads, [r["families"][name] for r in ranks],
                     fam_one[name], card)
    # every launch that a rank's paths made, as its counters read them
    for r in ranks:
        add(r["launches"])
    print(f"spatial: launches a rank {[r['launches'] for r in ranks]}, of them over a window "
          f"other than the whole image {[r['windowed'] for r in ranks]}")
    check(all(r["windowed"] == r["launches"] for r in ranks),
          f"spatial: a launch on a rank's path was not windowed: "
          f"{[(r['launches'], r['windowed']) for r in ranks]}")
    torch.cuda.empty_cache()

    # (d) the (1, 1) mesh over a world-1 NCCL group
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = SP.make_mesh_2d(1, 1, dev)
        serve = engine.make_inference_classmap(cfg, plain, folded, folded=True,
                                               compute_dtype=torch.bfloat16, spatial_mesh=mesh)
        kernel_counts(reset=True)
        maps = [serve(images[i:i + 1]).cpu().numpy()[0] for i in range(images.shape[0])]
        got = kernel_counts()
        check(got == per_step(images.shape[0], 0, 0), f"spatial (d): serving launches {got}")
        add(got)
        same = [bool(np.array_equal(m, w)) for m, w in zip(maps, sliced["maps"])]
        ts = seeded_state(torch, spec, dev)
        p0 = flat_params(torch, ts)
        kernel_counts(reset=True)
        loss = float(make_spatial_train_step(ts, recipe_loss(), mesh, **sgd)(
            *SP.shard_rows(mesh, *batch), 0.01)["loss"])
        got = kernel_counts()
        check(got == per_step(1, 2, 2), f"spatial (d): train launches {got}")
        add(got)
        update = (flat_params(torch, ts) - p0).cpu()
        # one device with the BN arithmetic of the mesh's: every BN under
        # H-sharding takes the sync path's eager ops, here sync BN over the
        # world-1 group, where one device alone takes the kernels
        # (one["fp32"], held at (b)'s gates beside it)
        ts = seeded_state(torch, spec, dev)
        loss_sync = float(make_train_step(ts, recipe_loss(), mesh.world, sync_bn=True, **sgd)(
            *(torch.from_numpy(a).to(dev) for a in batch), 0.01)["loss"])
        cos = cosine(update, (flat_params(torch, ts) - p0).cpu())
        rtol = abs(loss - loss_sync) / abs(loss_sync)
        cos_k = cosine(update, one["fp32"]["update"])
        rtol_k = abs(loss - one["fp32"]["loss"]) / abs(one["fp32"]["loss"])
        del ts, p0
        model = M.build(spec, sd, device=dev).to(memory_format=torch.channels_last)
        kernel_counts(reset=True)
        m11, cms11 = make_spatial_eval_step(model, recipe_loss(), mesh, num_classes=19)(
            *SP.shard_rows(mesh, *frames, np.ones(images.shape[0], np.float32)))
        got = kernel_counts()
        check(got == per_step(1, 2, 0), f"spatial (d): eval launches {got}")
        add(got)
        cms_equal = bool(np.array_equal(cms11.cpu().numpy(), cms_one))
        e_rtol = abs(float(m11["loss"]) - m_one["loss"]) / abs(m_one["loss"])
        print(f"spatial (d) the (1, 1) mesh over a world-1 NCCL group: bf16 class maps equal to "
              f"the slice phase's bit for bit {same}; fp32 step loss {loss:.7f} vs one device's "
              f"with sync-path BN {loss_sync:.7f} (rtol {rtol:.2e}, <= 1e-6), update cosine "
              f"{cos:.8f} (>= 0.99999); vs one device's on the BN kernels {one['fp32']['loss']:.7f} "
              f"(rtol {rtol_k:.2e}, <= 1e-4), update cosine {cos_k:.8f} (>= 0.9999); fp32 eval "
              f"step matrices equal {cms_equal}, loss rtol {e_rtol:.2e}")
        check(same == [True] * len(same) and rtol <= 1e-6 and cos >= 0.99999 and cms_equal
              and rtol_k <= 1e-4 and cos_k >= 0.9999,
              "spatial (d): the (1, 1) mesh differs from one device")
        del model
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"spatial: the phase took {time.perf_counter() - t_phase:.1f} s [{card}; host time]")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pidnet_tpu_torch.ops import _build
    from pidnet_tpu_torch.ops import batch_norm as bn
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
    kbn = phase_batch_norm(torch, bn)
    bn.fwd_launches = bn.bwd_launches = 0  # the main paths start here
    torch.cuda.empty_cache()
    sliced = phase_slice(torch, card)
    served = ua.launches
    exported = phase_export(torch, card, sliced)
    counts, speed_ms, peak = phase_train(torch, card)
    families = phase_families(torch, card, sliced["frames"], {
        "serve_ms": sliced["median_ms"], "train_ms": speed_ms, "peak_gib": peak})
    tree = build_city_tree(tempfile.mkdtemp(prefix="chip_smoke_data_", dir=ROOT))
    try:
        loaded = phase_data(torch, card, tree, speed_ms)
        evals = phase_eval(torch, card, tree)
        clis = phase_cli(torch, card, tree)
        parallel = phase_parallel(torch, card, tree, sliced)
    finally:
        shutil.rmtree(tree)
    spatial = phase_spatial(torch, card, sliced)
    paths = {"training": counts, "families": families, "data": loaded, "eval": evals,
             "cli": clis, "parallel": parallel, "spatial": spatial}
    k1["launches"] = served + exported + sum(c["upsample_argmax"] for c in paths.values())
    k2["launches"] = sum(c["ce_front_fwd"] for c in paths.values())
    k3["launches"] = sum(c["ce_front_bwd"] for c in paths.values())
    for name, extra in (("upsample_argmax", f"{served} serving + {exported} export + "),
                        ("ce_front_fwd", ""), ("ce_front_bwd", "")):
        print(f"launches on the main paths: {name} {extra}"
              + " + ".join(f"{c[name]} {path}" for path, c in paths.items()))
    print(f"launches on the main paths: conv3x3 {k4['launches']} conv_ab")
    kbn["launches"] = bn.fwd_launches + bn.bwd_launches
    print(f"launches on the main paths: batch_norm {bn.fwd_launches} forward + "
          f"{bn.bwd_launches} backward in this process (the spawned ranks' not counted)")

    print(card)
    print(json.dumps({"kernels": [k1, k2, k3, k4, kbn]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
