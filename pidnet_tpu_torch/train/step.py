"""The one-device training step (counterpart of pidnet_tpu/train/step.py
without its data parallelism, `accum_steps`, `sync_bn`, batch padding or
eval step).

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
