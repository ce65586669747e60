"""Plain float32 training of the PIDNet recipe (the published code's
utils/utils.py FullModel, utils/criterion.py OhemCrossEntropy and
BondaryLoss, and torch.optim.SGD as tools/train.py configures it).

- `full_loss`: every head bilinearly upsampled to the labels' size
  (align_corners as configured); the auxiliary heads' weighted CE averaged
  over all pixels (the OHEM criterion's per-pixel losses, averaged by the
  trainer's `.mean()`), OHEM CE on the final head (keep valid pixels whose
  true-class probability is below max(thres, the min_kept-th smallest), the
  plain mean of their weighted losses), the class-balanced BCE of the
  boundary head times 20, and the OHEM CE of the final head on the pixels
  where sigmoid(boundary) > 0.8, times SB_WEIGHTS.
- `sgd_steps`: `steps` SGD steps from `weights` on one batch each (weight
  decay folded into the gradient, a momentum buffer, no Nesterov), BN in
  training mode over the whole batch.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

STAT_SUFFIXES = (".running_mean", ".running_var")


def _ohem(score, target, cw, ignore: int, thres: float, min_kept: int):
    pixel = F.cross_entropy(score, target, weight=cw, ignore_index=ignore, reduction="none")
    mask = target.reshape(-1) != ignore
    if not bool(mask.any()):
        return pixel.sum() * 0.0
    prob = F.softmax(score, dim=1).gather(1, torch.where(target == ignore, 0, target)[:, None])
    prob, order = prob.reshape(-1)[mask].sort()
    threshold = torch.clamp(prob[min(min_kept, prob.numel() - 1)], min=thres)
    kept = pixel.reshape(-1)[mask][order][prob < threshold]
    if kept.numel() == 0:
        return pixel.sum() * 0.0
    return kept.mean()


def _weighted_bce(logits, target):
    x, t = logits.reshape(1, -1), target.reshape(1, -1)
    pos, neg = t == 1, t == 0
    pos_num, neg_num = pos.sum(), neg.sum()
    total = (pos_num + neg_num).clamp(min=1)
    weight = torch.zeros_like(x)
    weight[pos] = (neg_num / total).to(x.dtype)
    weight[neg] = (pos_num / total).to(x.dtype)
    return F.binary_cross_entropy_with_logits(x, t, weight, reduction="mean")


def full_loss(outputs, labels, edges, recipe: dict):
    """The training objective of NCHW heads [aux..., final, boundary] on
    (N,H,W) int64 labels and (N,H,W) float edges."""
    h, w = labels.shape[1:]
    up = [F.interpolate(o, size=(h, w), mode="bilinear", align_corners=recipe["align_corners"])
          for o in outputs]
    ignore = recipe["ignore_label"]
    cw = torch.tensor(recipe["class_weights"], dtype=torch.float32, device=labels.device)
    thres, kept = recipe["ohem_thres"], recipe["min_kept"]
    *aux, final, boundary = up
    losses = []
    for bw, head in zip(recipe["balance_weights"][:-1], aux):
        ce = F.cross_entropy(head, labels, weight=cw, ignore_index=ignore, reduction="none")
        losses.append(bw * ce.mean())
    losses.append(recipe["balance_weights"][-1] * _ohem(final, labels, cw, ignore, thres, kept))
    losses.append(recipe["bd_coeff"] * _weighted_bce(boundary, edges))
    bd_label = torch.where(torch.sigmoid(boundary[:, 0]) > 0.8, labels, ignore)
    losses.append(recipe["sb_weights"] * _ohem(final, bd_label, cw, ignore, thres, kept))
    return sum(losses)


def sgd_steps(model, weights: dict, batches, spec: dict, recipe: dict, steps: int,
              precision=None):
    """`steps` SGD steps of `model` (a reference module: `Net`,
    `forward`) from `weights`, the model's forward computed under
    `precision` (a context manager, such as `quant.float8`) if given, step s on `batches[s]` = (NHWC
    float32 images, (N,H,W) labels, (N,H,W) edges). Returns {"losses":
    each step's, "grad1": {leaf: the first step's gradient norm}, "first":
    {leaf: the first step's update direction, g + wd*p, as the momentum
    buffer holds it}, "dir1": {leaf: its norm}, "change": {leaf: the norm of
    its change over the steps, parameters and BN running statistics
    alike}, "after": {leaf: its value after the steps}}."""
    params = {k: v.detach().clone().requires_grad_() for k, v in weights.items()
              if not k.endswith(STAT_SUFFIXES)}
    stats = {k: v.detach().clone() for k, v in weights.items() if k.endswith(STAT_SUFFIXES)}
    bufs = {k: torch.zeros_like(v) for k, v in params.items()}
    lr, mom, wd = recipe["lr"], recipe["momentum"], recipe["weight_decay"]
    losses, grad1, first = [], {}, {}
    for s in range(steps):
        images, labels, edges = batches[s]
        net = model.Net({**params, **stats}, train=True)
        with precision() if precision else contextlib.nullcontext():
            outputs = model.forward(net, images.permute(0, 3, 1, 2).float(), spec)
        loss = full_loss(outputs, labels.long(), edges.float(), recipe)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        with torch.no_grad():
            for k, g in zip(names, grads):
                g = torch.zeros_like(params[k]) if g is None else g
                d = g + wd * params[k]
                bufs[k].mul_(mom).add_(d)
                params[k].sub_(lr * bufs[k])
                if s == 0:
                    grad1[k], first[k] = float(g.norm()), d
            stats.update(net.new_stats)
        losses.append(float(loss.detach()))
        del outputs, loss, grads, net
    after = {k: v.detach() for k, v in {**params, **stats}.items()}
    change = {k: float((v - weights[k]).norm()) for k, v in after.items()}
    return {"losses": losses, "grad1": grad1, "first": first,
            "dir1": {k: float(d.norm()) for k, d in first.items()}, "change": change,
            "after": after}
