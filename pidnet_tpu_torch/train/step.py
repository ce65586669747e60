"""The one-device training and evaluation steps (counterpart of
pidnet_tpu/train/step.py without its data parallelism, `accum_steps`,
`sync_bn` or batch padding).

The update is the JAX package's `_sgd`, torch.optim.SGD's semantics as the
reference configures it (tools/train.py:139-148): weight decay folded into
the gradient, a momentum buffer, optional Nesterov. Unlike the JAX step,
which returns a new TrainState, this one updates the model's parameters,
its BN buffers and the momentum buffers in place, which saves a copy of
each.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from pidnet_tpu_torch.metrics import confusion_matrix
from pidnet_tpu_torch.ops.resize import resize_bilinear
from pidnet_tpu_torch.ops.upsample_argmax import upsample_argmax


@dataclass
class TrainState:
    """A training-mode model (its parameters and BN buffers) and the SGD
    momentum buffers, keyed like its parameters (the JAX package's names)."""

    model: nn.Module
    momentum: dict

    @staticmethod
    def create(model: nn.Module) -> "TrainState":
        zeros = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
        return TrainState(model=model, momentum=zeros)

    def params(self) -> dict:
        return {k: p.detach() for k, p in self.model.named_parameters()}

    def state(self) -> dict:
        """The BN running statistics."""
        return {k: v for k, v in self.model.named_buffers()
                if k.endswith(("running_mean", "running_var"))}


@torch.no_grad()
def _sgd(params: list, grads: list, bufs: list, lr: float, momentum: float,
         weight_decay: float, nesterov: bool) -> None:
    """In place: d = g + wd*p; buf = momentum*buf + d; p -= lr * (d +
    momentum*buf if nesterov else buf)."""
    d = torch._foreach_add(grads, params, alpha=weight_decay)
    torch._foreach_mul_(bufs, momentum)
    torch._foreach_add_(bufs, d)
    step = torch._foreach_add(d, bufs, alpha=momentum) if nesterov else bufs
    torch._foreach_add_(params, step, alpha=-lr)


def make_train_step(ts: TrainState, loss_fn, *, momentum: float = 0.9,
                    weight_decay: float = 0.0005, nesterov: bool = False,
                    compute_dtype: torch.dtype | None = None):
    """`step(images, labels, edges, lr) -> metrics` on `ts`, in place.

    images NHWC float, labels (N,H,W) int, edges (N,H,W) float, all on the
    model's device. With `compute_dtype` the images are cast to it, so every
    conv runs in it on fp32 weights; the loss's reductions stay fp32.
    `metrics` holds `loss_fn`'s 0-dim tensors, detached and not synced."""
    names = [k for k, _ in ts.model.named_parameters()]
    params = [p for _, p in ts.model.named_parameters()]
    bufs = [ts.momentum[k] for k in names]

    def step(images, labels, edges, lr: float) -> dict:
        ts.model.train()
        x = images if compute_dtype is None else images.to(compute_dtype)
        loss, metrics = loss_fn(ts.model(x), labels, edges)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        _sgd(params, grads, bufs, lr, momentum, weight_decay, nesterov)
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_eval_step(model: nn.Module, loss_fn, *, num_classes: int,
                   compute_dtype: torch.dtype | None = None):
    """`step(images, labels, edges, sample_mask) -> (metrics, cms)`: the
    validation step of the JAX package's `make_eval_step` on one device.

    `model` is an unfolded eval-mode model (`build(..., train=False)`): BN
    uses its running statistics, and with `compute_dtype` the images are
    cast to it so every conv runs in it on fp32 weights. The inputs (host
    arrays or tensors; images NHWC, labels (N,H,W), edges (N,H,W),
    sample_mask (N,) in {0,1}) go to the model's device. FullLoss masks the
    padding samples; `metrics` holds its 0-dim tensors scaled by w /
    max(w, 1), as the JAX step's weighted mean over shards gives on one
    shard, and `metrics["weight"]` is w, the real-sample count. `cms` is
    (num_segmentation_outputs, C, C) int64, one confusion matrix per head
    but the boundary head, with the masked samples' labels set to ignore:
    through the fused upsample+argmax (ops/upsample_argmax.py, the CUDA
    kernel on the card) when `compute_dtype` is bf16, else through the fp32
    bilinear resize and argmax. It runs under `torch.inference_mode()`, so
    no backward kernel runs.

    Not ported: the mesh and its psums (data parallelism is a later slice)
    and the batch padding to a multiple of 8 (`pad_batch`), a TPU sublane
    fill that the port leaves out by design."""
    dev = next(model.parameters()).device
    ignore = loss_fn.ignore_label
    align = loss_fn.align_corners

    def tensor(a, dtype):
        a = a if torch.is_tensor(a) else torch.as_tensor(a)
        return a.to(dev, dtype)

    @torch.inference_mode()
    def step(images, labels, edges, sample_mask):
        model.eval()
        images, edges = tensor(images, torch.float32), tensor(edges, torch.float32)
        labels, mask = tensor(labels, torch.int32), tensor(sample_mask, torch.float32)
        x = images if compute_dtype is None else images.to(compute_dtype)
        outputs = model(x)
        _, metrics = loss_fn(outputs, labels, edges, sample_mask=mask)
        w = mask.sum()
        metrics = {k: v * w / torch.clamp(w, min=1.0) for k, v in metrics.items()}
        metrics["weight"] = w
        labels = torch.where(mask.reshape(-1, 1, 1) > 0, labels, ignore)
        hw = (labels.shape[1], labels.shape[2])
        cms = []
        for o in outputs[:-1]:
            if compute_dtype == torch.bfloat16:
                seg = upsample_argmax(o.contiguous(), hw, align)
            else:
                seg = resize_bilinear(o, hw, align)
            cms.append(confusion_matrix(seg, labels, num_classes, ignore))
        return metrics, torch.stack(cms)

    return step
