"""The training and evaluation steps (counterpart of
pidnet_tpu/train/step.py), on one device or over a data mesh
(parallel/mesh.py), with the JAX package's DataParallel semantics:

- each rank runs its own forward with per-replica BatchNorm statistics
  unless `sync_bn`, which takes the mesh's global batch statistics, and
  its own FullLoss with its own OHEM pool;
- the gradients, the metrics and the new BN running statistics are
  averaged across the ranks in one flat all-reduce (the JAX step's
  `loss / n_shards` and implicit psum, and its two pmeans; the BN update
  is the mean over replicas, not DataParallel's replica 0);
- `accum_steps = A` runs A microbatches one after another as virtual
  shards, each from the step's initial BN state, and averages them as the
  mesh does, so one device takes the global batch of A devices.

Over a (data, spatial) mesh (parallel/spatial.py) `make_spatial_train_step`
and `make_spatial_eval_step` run the JAX package's global-batch program on
each rank's H rows: the model under `models.pidnet.spatial_sharding`
(global BN statistics) and FullLoss over the mesh (global denominators and
OHEM pool). There a rank's loss is its contribution to the one global
loss, so the gradients, and the metrics, are SUMMED over the mesh in one
flat bucket (`Mesh.all_reduce_sums`), where the data step averages its
replicas', each rank's own mean loss (`Mesh.all_reduce_mean`).

Each train step is the span `train.step` (utils/spans.py) over
`train.forward`, `train.loss`, `train.backward` (which holds
`train.loss.backward`, the loss's own backward), `train.allreduce` over a
mesh, and `train.update`; each eval step is `eval.step` over
`eval.forward` and `eval.loss`.

The update is the JAX package's `_sgd`, torch.optim.SGD's semantics as the
reference configures it (tools/train.py:139-148): weight decay folded into
the gradient, a momentum buffer, optional Nesterov. Unlike the JAX step,
which returns a new TrainState, this one updates the model's parameters,
its BN buffers and the momentum buffers in place, which saves a copy of
each. It wraps the model in no DistributedDataParallel: DDP's reducer runs
from `.backward()` hooks, which `torch.autograd.grad` never fires, and it
broadcasts replica 0's buffers where the JAX step averages them. The JAX
step's batch padding to a multiple of 8 (`pad_batch`), a TPU sublane fill,
is left out by design.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from pidnet_tpu_torch.metrics import confusion_matrix
from pidnet_tpu_torch.models.pidnet import spatial_sharding, sync_batch_norm
from pidnet_tpu_torch.ops.resize import resize_bilinear, resize_rows
from pidnet_tpu_torch.ops.upsample_argmax import upsample_argmax, upsample_argmax_rows
from pidnet_tpu_torch.utils.spans import backward_span, span


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


def make_train_step(ts: TrainState, loss_fn, mesh=None, *, momentum: float = 0.9,
                    weight_decay: float = 0.0005, nesterov: bool = False,
                    compute_dtype: torch.dtype | None = None, sync_bn: bool = False,
                    accum_steps: int = 1):
    """`step(images, labels, edges, lr) -> metrics` on `ts`, in place.

    images NHWC float, labels (N,H,W) int, edges (N,H,W) float, all on the
    model's device: this rank's share of the global batch
    (`parallel.shard_batch`), or with `accum_steps = A > 1` its `(A, G,
    ...)` microbatch stacks (`parallel.shard_microbatches`). With
    `compute_dtype` the images are cast to it, so every conv runs in it on
    fp32 weights; the loss's reductions stay fp32. `metrics` holds
    `loss_fn`'s 0-dim tensors, detached and not synced: over a `mesh`
    (`parallel.make_mesh`) their mean across the ranks, over microbatches
    their mean.

    `sync_bn` takes BN statistics over the mesh's global batch (the same
    function as per-replica BN on one device); it does not compose with
    `accum_steps > 1`, whose microbatches run one after another."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if accum_steps > 1 and sync_bn:
        raise ValueError(
            "accum_steps > 1 does not compose with sync_bn: microbatches run sequentially and "
            "their BN statistics cannot be pmean'd together; use per-shard BN or more "
            "physical devices")
    names = [k for k, _ in ts.model.named_parameters()]
    params = [p for _, p in ts.model.named_parameters()]
    bufs = [ts.momentum[k] for k in names]
    stats = list(ts.state().values())
    sync = mesh if sync_bn else None

    def grads_of(images, labels, edges):
        x = images if compute_dtype is None else images.to(compute_dtype)
        with sync_batch_norm(ts.model, sync):
            with span("train.forward"):
                outputs = ts.model(x)
            with span("train.loss"):
                loss, metrics = loss_fn(outputs, labels, edges)
            with span("train.backward"):
                backward_span("train.loss.backward", loss, outputs)
                grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def accumulated(images, labels, edges):
        """The mean gradients, metrics and new BN statistics of the A
        microbatches, each run from the step's initial BN state."""
        start = [s.clone() for s in stats]
        g_sum = s_sum = m_sum = None
        for a in range(accum_steps):
            if a:
                torch._foreach_copy_(stats, start)
            grads, metrics = grads_of(images[a], labels[a], edges[a])
            if g_sum is None:
                g_sum, s_sum, m_sum = grads, [s.clone() for s in stats], metrics
            else:
                torch._foreach_add_(g_sum, grads)
                torch._foreach_add_(s_sum, stats)
                m_sum = {k: m_sum[k] + v for k, v in metrics.items()}
        torch._foreach_div_(g_sum, float(accum_steps))
        torch._foreach_div_(s_sum, float(accum_steps))
        torch._foreach_copy_(stats, s_sum)
        return g_sum, {k: v / accum_steps for k, v in m_sum.items()}

    def step(images, labels, edges, lr: float) -> dict:
        with span("train.step"):
            ts.model.train()
            if accum_steps == 1:
                grads, metrics = grads_of(images, labels, edges)
            else:
                grads, metrics = accumulated(images, labels, edges)
            if mesh is not None and mesh.group is not None:
                with span("train.allreduce"):
                    keys = list(metrics)
                    out = mesh.all_reduce_mean([*grads, *stats,
                                                *(metrics[k].float() for k in keys)])
                    grads = out[:len(grads)]
                    with torch.no_grad():
                        torch._foreach_copy_(stats, out[len(grads):len(grads) + len(stats)])
                    metrics = dict(zip(keys, out[len(grads) + len(stats):]))
            with span("train.update"):
                _sgd(params, grads, bufs, lr, momentum, weight_decay, nesterov)
            return metrics

    return step


def make_eval_step(model: nn.Module, loss_fn, mesh=None, *, num_classes: int,
                   compute_dtype: torch.dtype | None = None):
    """`step(images, labels, edges, sample_mask) -> (metrics, cms)`: the
    validation step of the JAX package's `make_eval_step`, on one device or
    on this rank's share of the batch over a `mesh`.

    `model` is an unfolded eval-mode model (`build(..., train=False)`): BN
    uses its running statistics, and with `compute_dtype` the images are
    cast to it so every conv runs in it on fp32 weights. The inputs (host
    arrays or tensors; images NHWC, labels (N,H,W), edges (N,H,W),
    sample_mask (N,) in {0,1}) go to the model's device. FullLoss masks the
    padding samples. `metrics` holds its 0-dim tensors weighted as the JAX
    step's psums weight them: each rank's value x its real-sample count w,
    summed over the mesh and divided by max(total w, 1); and
    `metrics["weight"]` is the total w, the global real-sample count, so
    that every rank reports the same average. `cms` is
    (num_segmentation_outputs, C, C) int64, summed over the mesh, one
    confusion matrix per head but the boundary head, with the masked
    samples' labels set to ignore:
    through the fused upsample+argmax (ops/upsample_argmax.py, the CUDA
    kernel on the card) when `compute_dtype` is bf16, else through the fp32
    bilinear resize and argmax. It runs under `torch.inference_mode()`, so
    no backward kernel runs."""
    dev = next(model.parameters()).device
    ignore = loss_fn.ignore_label
    align = loss_fn.align_corners

    def tensor(a, dtype):
        a = a if torch.is_tensor(a) else torch.as_tensor(a)
        return a.to(dev, dtype)

    @torch.inference_mode()
    def step(images, labels, edges, sample_mask):
        with span("eval.step"):
            model.eval()
            images, edges = tensor(images, torch.float32), tensor(edges, torch.float32)
            labels, mask = tensor(labels, torch.int32), tensor(sample_mask, torch.float32)
            x = images if compute_dtype is None else images.to(compute_dtype)
            with span("eval.forward"):
                outputs = model(x)
            with span("eval.loss"):
                _, metrics = loss_fn(outputs, labels, edges, sample_mask=mask)
            w = mask.sum()
            keys = list(metrics)
            sums = torch.stack([metrics[k].float() * w for k in keys] + [w])
            if mesh is not None:
                mesh.all_reduce_sum(sums)
            total = sums[-1]
            metrics = {k: sums[i] / torch.clamp(total, min=1.0) for i, k in enumerate(keys)}
            metrics["weight"] = total
            labels = torch.where(mask.reshape(-1, 1, 1) > 0, labels, ignore)
            hw = (labels.shape[1], labels.shape[2])
            cms = []
            for o in outputs[:-1]:
                if compute_dtype == torch.bfloat16:
                    seg = upsample_argmax(o.contiguous(), hw, align)
                else:
                    seg = resize_bilinear(o, hw, align)
                cms.append(confusion_matrix(seg, labels, num_classes, ignore))
            cms = torch.stack(cms)
            if mesh is not None:
                mesh.all_reduce_sum(cms)
            return metrics, cms

    return step


def make_spatial_train_step(ts: TrainState, loss_fn, mesh, *, momentum: float = 0.9,
                            weight_decay: float = 0.0005, nesterov: bool = False,
                            compute_dtype: torch.dtype | None = None):
    """`step(images, labels, edges, lr) -> metrics` on `ts`, in place, over
    a (data, spatial) mesh (`parallel.spatial.make_mesh_2d`): the JAX
    package's `make_spatial_train_step`.

    The inputs are this rank's rows of its data row's samples
    (`parallel.spatial.shard_rows`). The model runs under
    `spatial_sharding` (halo exchanges, global BN statistics, the 1/64
    stage on the gathered map) and `loss_fn` (FullLoss) over the mesh, so
    each rank's loss is its contribution to the global loss. One flat
    bucket sums the gradients and the metrics over the mesh (the metrics
    are then the global values); the BN running statistics come out the
    same on every rank. The update is `_sgd`. With `compute_dtype` the
    images are cast to it, as in `make_train_step`."""
    names = [k for k, _ in ts.model.named_parameters()]
    params = [p for _, p in ts.model.named_parameters()]
    bufs = [ts.momentum[k] for k in names]

    def step(images, labels, edges, lr: float) -> dict:
        with span("train.step"):
            ts.model.train()
            x = images if compute_dtype is None else images.to(compute_dtype)
            with spatial_sharding(ts.model, mesh):
                with span("train.forward"):
                    outputs = ts.model(x)
                with span("train.loss"):
                    loss, metrics = loss_fn(outputs, labels, edges, mesh=mesh)
                with span("train.backward"):
                    backward_span("train.loss.backward", loss, outputs)
                    grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            with span("train.allreduce"):
                keys = list(metrics)
                out = mesh.world.all_reduce_sums([*grads,
                                                  *(metrics[k].detach().float() for k in keys)])
            with span("train.update"):
                _sgd(params, out[:len(grads)], bufs, lr, momentum, weight_decay, nesterov)
            return dict(zip(keys, out[len(grads):]))

    return step


def make_spatial_eval_step(model: nn.Module, loss_fn, mesh, *, num_classes: int,
                           compute_dtype: torch.dtype | None = None):
    """`step(images, labels, edges, sample_mask) -> (metrics, cms)` over a
    (data, spatial) mesh: the JAX package's `make_spatial_eval_step`, the
    contract of `make_eval_step`. The inputs are this rank's rows of its
    data row's samples, the mask whole (`parallel.spatial.shard_rows`).

    The model runs under `spatial_sharding` and FullLoss over the mesh;
    `metrics` are the global batch's (the sums of the ranks'
    contributions), `metrics["weight"]` the global real-sample count. `cms`
    (num_segmentation_outputs, C, C) int64 is the sum over the mesh of each
    rank's matrices over its label rows, masked samples all-ignore; each
    head's class map over the rank's rows is the windowed K1
    (`upsample_argmax_rows`) when `compute_dtype` is bf16, else the
    windowed fp32 resize and argmax, as `make_eval_step` chooses. Runs
    under `torch.inference_mode()`."""
    dev = mesh.device
    ignore = loss_fn.ignore_label
    align = loss_fn.align_corners

    def tensor(a, dtype):
        a = a if torch.is_tensor(a) else torch.as_tensor(a)
        return a.to(dev, dtype)

    @torch.inference_mode()
    def step(images, labels, edges, sample_mask):
        with span("eval.step"):
            model.eval()
            images, edges = tensor(images, torch.float32), tensor(edges, torch.float32)
            labels, mask = tensor(labels, torch.int32), tensor(sample_mask, torch.float32)
            x = images if compute_dtype is None else images.to(compute_dtype)
            hw = (labels.shape[1], labels.shape[2])
            with span("eval.forward"), spatial_sharding(model, mesh):
                outputs = model(x)
            with span("eval.loss"):
                # the heads' halo rows, exchanged once for the loss and the matrices
                heads = loss_fn.halo_heads(outputs, hw[0], mesh)
                _, metrics = loss_fn(outputs, labels, edges, sample_mask=mask, mesh=mesh,
                                     heads=heads)
            labels = torch.where(mask.reshape(-1, 1, 1) > 0, labels, ignore)
            cms = []
            for o, (oh, rows) in zip(outputs[:-1], heads[:-1]):
                if compute_dtype == torch.bfloat16:
                    seg = upsample_argmax_rows(oh.contiguous(), hw, align, rows)
                elif rows is None:
                    seg = resize_bilinear(o, hw, align)
                else:
                    seg = resize_rows(oh.permute(0, 3, 1, 2), hw, align, rows).permute(0, 2, 3, 1)
                cms.append(confusion_matrix(seg, labels, num_classes, ignore))
            # the S ranks of a data row hold the same samples: one counts them
            w = mask.sum() if mesh.spatial_index == 0 else torch.zeros((), device=dev)
            keys = list(metrics)
            sums = torch.stack([metrics[k].float() for k in keys] + [w])
            mesh.world.all_reduce_sum(sums)
            metrics = {k: sums[i] for i, k in enumerate(keys)}
            metrics["weight"] = sums[-1]
            cms = torch.stack(cms)
            mesh.world.all_reduce_sum(cms)
            return metrics, cms

    return step
