"""The training epoch and the inference closures (counterpart of
pidnet_tpu/engine.py's train_one_epoch and inference closures).

`train_one_epoch` drives a train step (train/step.py) over a loader.

`make_inference` returns probabilities at input size (model -> pick
TEST.OUTPUT_INDEX -> bilinear resize -> exp), `make_inference_classmap`
the (N,H,W) int32 class map (model -> pick TEST.OUTPUT_INDEX -> fused
upsample+argmax, ops/upsample_argmax.py). Both take NHWC float images
(numpy or tensor; H and W multiples of 64, as the network's 1/64 stage and
1/8 fusions need) and return tensors on the model's device.

`cfg` needs MODEL.NUM_OUTPUTS, MODEL.ALIGN_CORNERS and TEST.OUTPUT_INDEX
(and PRINT_FREQ, TRAIN.END_EPOCH for training); `config()` builds one with
the JAX package's defaults.
"""

from __future__ import annotations

import logging
import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from pidnet_tpu_torch import resolve_device
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.ops.resize import resize_bilinear
from pidnet_tpu_torch.ops.upsample_argmax import upsample_argmax
from pidnet_tpu_torch.train.lr import poly_lr
from pidnet_tpu_torch.utils.logging import AverageMeter

log = logging.getLogger("pidnet_tpu_torch")


def _tensor(a) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))


def _place_on(device):
    """`place_batch` that moves host arrays (or tensors) to `device`: images
    and edges float32, labels int32."""

    def place(images, labels, edges):
        return (_tensor(images).to(device, torch.float32),
                _tensor(labels).to(device, torch.int32),
                _tensor(edges).to(device, torch.float32))

    return place


def train_one_epoch(cfg, epoch: int, epoch_iters: int, num_iters: int, base_lr: float, loader,
                    step_fn, ts, writer_dict, place_batch=None, should_stop=None,
                    start_iter: int = 0):
    """One training epoch (reference utils/function.py:21-75); returns
    (ts, completed iterations).

    `loader` yields (images, labels, edges, _, _); `place_batch(images,
    labels, edges)` puts a batch where `step_fn(images, labels, edges, lr)`
    runs it, by default on the device of `ts.model`. The update at global
    iteration g uses poly(g-1), as the reference adjusts the LR after each
    step. One step's metrics stay in flight unsynced and are folded into
    the meters at the next step, and at once on PRINT_FREQ iterations; a
    non-finite loss raises FloatingPointError there. `should_stop()` is
    polled before each step. `start_iter` resumes mid-epoch: the loader
    skips that many batches (`skip_batches`)."""
    if place_batch is None:
        place_batch = _place_on(next(ts.model.parameters()).device)

    batch_time = AverageMeter()
    ave_loss = AverageMeter()
    ave_acc = AverageMeter()
    avg_sem_loss = AverageMeter()
    avg_bce_loss = AverageMeter()
    tic = time.time()
    cur_iters = epoch * epoch_iters

    def fold(it, metrics):
        m = {k: float(v) for k, v in metrics.items()}
        if not math.isfinite(m["loss"]):
            raise FloatingPointError(
                f"non-finite training loss {m['loss']} at epoch {epoch} iter {it} (global "
                f"iter {it + cur_iters}): diverged; resume from the last checkpoint with a "
                "lower TRAIN.LR")
        ave_loss.update(m["loss"])
        ave_acc.update(m["acc"])
        avg_sem_loss.update(m["sem_loss"])
        avg_bce_loss.update(m["bce_loss"])

    pending = None
    done = start_iter
    if hasattr(loader, "set_epoch"):
        loader.set_epoch(epoch + 1)
    if start_iter:
        if not hasattr(loader, "skip_batches"):
            raise ValueError(f"start_iter={start_iter} needs a loader with skip_batches()")
        loader.skip_batches(start_iter)
    for i_iter, (images, labels, edges, _, _) in enumerate(loader, start=start_iter):
        if should_stop is not None and should_stop():
            log.info("stop requested: ending epoch %d early at iter %d", epoch, i_iter)
            break
        g = i_iter + cur_iters
        lr = poly_lr(base_lr, num_iters, max(0, g - 1))
        metrics = step_fn(*place_batch(images, labels, edges), lr)
        done = i_iter + 1
        lr = poly_lr(base_lr, num_iters, g)  # what the reference logs

        if pending is not None:
            fold(*pending)
        pending = (i_iter, metrics)
        batch_time.update(time.time() - tic)
        tic = time.time()

        if i_iter % cfg.PRINT_FREQ == 0:
            fold(*pending)
            pending = None
            log.info(
                "Epoch: [%d/%d] Iter:[%d/%d], Time: %.2f, lr: [%s], Loss: %.6f, Acc:%.6f, "
                "Semantic loss: %.6f, BCE loss: %.6f, SB loss: %.6f",
                epoch, cfg.TRAIN.END_EPOCH, i_iter, epoch_iters, batch_time.average(),
                f"{lr:.6g}", ave_loss.average(), ave_acc.average(), avg_sem_loss.average(),
                avg_bce_loss.average(),
                ave_loss.average() - avg_sem_loss.average() - avg_bce_loss.average())

    if pending is not None:
        fold(*pending)

    if ave_loss.count:
        writer = writer_dict["writer"]
        writer.add_scalar("train_loss", ave_loss.average(), writer_dict["train_global_steps"])
        writer_dict["train_global_steps"] += 1
    return ts, done


def config(num_outputs: int = 2, align_corners: bool = True, output_index: int = -1,
           print_freq: int = 20, end_epoch: int = 484):
    """The inference and training-loop keys of the JAX package's config,
    with its defaults."""
    return SimpleNamespace(
        MODEL=SimpleNamespace(NUM_OUTPUTS=num_outputs, ALIGN_CORNERS=align_corners),
        TEST=SimpleNamespace(OUTPUT_INDEX=output_index),
        TRAIN=SimpleNamespace(END_EPOCH=end_epoch),
        PRINT_FREQ=print_freq,
    )


def _select_output(cfg, out):
    """Pick TEST.OUTPUT_INDEX from a multi-output model result.
    NUM_OUTPUTS==1 with a multi-output (augment=True) model is a
    misconfiguration; error rather than argmax the 1-channel boundary head."""
    if isinstance(out, (list, tuple)):
        if cfg.MODEL.NUM_OUTPUTS > 1:
            return out[cfg.TEST.OUTPUT_INDEX]
        raise ValueError(
            "model returned multiple outputs but MODEL.NUM_OUTPUTS==1; "
            "set MODEL.NUM_OUTPUTS and TEST.OUTPUT_INDEX consistently"
        )
    return out


def _prepare(spec, state_dict, folded, compute_dtype, device):
    """(model, device) for the closures: the model on `device` in
    channels_last. A folded model is cast to `compute_dtype` once here; an
    unfolded one keeps fp32 weights (its BN affines are formed in fp32)
    and casts them at each conv."""
    dev = resolve_device(device)
    model = M.build(spec, state_dict, folded=folded, device=dev)
    if folded and compute_dtype is not None:
        model = model.to(compute_dtype)
    return model.to(memory_format=torch.channels_last), dev


def _runner(cfg, model, dev, compute_dtype):
    def run(x):
        """NHWC image -> (selected NHWC logits, input (H, W))."""
        if x.ndim != 4 or x.shape[3] != 3 or x.shape[1] % 64 or x.shape[2] % 64:
            raise ValueError(f"expected (N,H,W,3) images with H and W multiples of 64, "
                             f"got {tuple(x.shape)}")
        x = (x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))).to(dev)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        return _select_output(cfg, model(x)), (x.shape[1], x.shape[2])

    return run


def make_inference(cfg, spec, state_dict, *, folded=False, compute_dtype=None, device=None):
    """Single-image inference closure: model -> TEST.OUTPUT_INDEX ->
    bilinear to input size (align_corners=cfg.MODEL.ALIGN_CORNERS) ->
    exp(), as (N,H,W,C) float32."""
    model, dev = _prepare(spec, state_dict, folded, compute_dtype, device)
    run = _runner(cfg, model, dev, compute_dtype)

    @torch.inference_mode()
    def infer(x):
        out, hw = run(x)
        pred = resize_bilinear(out, hw, cfg.MODEL.ALIGN_CORNERS)
        return torch.exp(pred.float())

    return infer


def make_inference_classmap(cfg, spec, state_dict, *, folded=False, compute_dtype=None,
                            device=None):
    """Class-map inference closure: model -> TEST.OUTPUT_INDEX -> fused
    bilinear-upsample+argmax -> (N,H,W) int32. Argmax-equivalent to
    `make_inference` (exp() is monotonic) while never materializing
    full-resolution logits; on CUDA the upsample+argmax is the hand-written
    kernel."""
    model, dev = _prepare(spec, state_dict, folded, compute_dtype, device)
    run = _runner(cfg, model, dev, compute_dtype)

    @torch.inference_mode()
    def infer(x):
        out, hw = run(x)
        return upsample_argmax(out.contiguous(), hw, cfg.MODEL.ALIGN_CORNERS)

    return infer
